#!/usr/bin/env python3
"""Time the port's zamba2-2.7b prefill and training step, and the K6 and K2
kernels, on one NVIDIA GPU, for comparing two source trees in one run on
one card.

    python tools/time_paths.py [--src SRC] [--k2-inputs FILE]

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's); its kernels are built from that tree's sources into
``<SRC>/../build/time_paths``. The sizes are chip_smoke.py's: zamba2-2.7b
at full width and depth in bfloat16, random weights from seed 0. Prefill
is ``make_prefill_step`` on 4 prompts of 512 tokens, timed with a host
clock around each call up to ``torch.cuda.synchronize()``, after one
warm-up call. The steps are ``repro_torch.launch.train.train`` on the
launcher's Zipf token shards in a ``TieredStore`` (batch 4 x 512,
``TrainConfig(remat=True, compressed_grads=True)``), whose synchronised
``step_s`` are kept after the first, which warms up.

The kernels: K6 (``decode_attention_kernel``) on the serve loop's last
cache, q (4, 32, 80) and k/v (4, 546, 32, 80) bf16 from seed 0, at kv_len
64, 272 and 544; K2 (``weighted_entropy_features_kernel``, one bucket) on
the three dtype classes of the placement path's first feature pass (TPC-H
SF0.1, 440 queries, 500 rows per file, G-PART on the card, as chip_smoke.py
runs it). Those codes are made once by the tree that runs first and kept
in ``--k2-inputs`` (default ``build/time_paths_k2.npz`` in this
checkout), so every run reads the same inputs. Each kernel gets its mean
time per call between CUDA events over 50 back-to-back calls (wrapper
included) and its device time per call from torch.profiler over 20 calls.

Prints, as its last line, one JSON object: the tree, the card's name and
``nvidia-smi`` power limit, the prefill seconds, the step seconds and the
kernel times.

To compare a parent tree with a change, run parent, change, change, parent
in one command (each run is a process of its own), so that both see the
same card and host.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ARCH = "zamba2-2.7b"
BATCH, SEQ, SEED = 4, 512, 0
PREFILLS, STEPS = 10, 4             # timed calls, after one warm-up each
CACHE, KV_LENS = 546, (64, 272, 544)  # the serve loop's cache and its range
ROOT = Path(__file__).resolve().parents[1]


def k2_inputs(path: Path):
    """The three dtype classes of the placement path's first feature pass
    (codes, n_valid, n_rows, n_cols, lengths each), from ``path`` or made
    by this tree and kept there."""
    fields = ("codes", "n_valid", "n_rows", "n_cols", "lengths")
    if not path.exists():
        import dataclasses
        from repro_torch.core.engine import PartitionStage
        from repro_torch.core.scope import paper_variants
        from repro_torch.data import tpch
        from repro_torch.data.tables import DTYPE_CLASSES, encode_dtype_classes
        db = tpch.generate(scale_rows=600_000, seed=SEED)
        qs = tpch.generate_queries(db, n_per_template=20, seed=SEED + 1,
                                   rows_per_file=500)
        parts, rows = tpch.partitions_from_queries(db, qs, rows_per_file=500)
        cfg = dataclasses.replace(
            paper_variants(np.full(4, np.inf))["SCOPe (No capacity constraint)"],
            partition_backend="device", device="cuda")
        enc = encode_dtype_classes(PartitionStage(cfg)(parts, rows).tables)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **{f"{i}_{f}": getattr(enc[d], f)
                          for i, d in enumerate(DTYPE_CLASSES)
                          for f in fields})
    with np.load(path) as z:
        return [tuple(z[f"{i}_{f}"] for f in fields) for i in range(3)]


def kernel_times(torch, fn) -> dict:
    """{"ms": mean per call between CUDA events over 50 calls, "device_ms":
    device time per call from torch.profiler over 20 calls} (chip_smoke.py's
    timers)."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, device_ms
    return {"ms": cuda_ms(fn, torch, iters=50),
            "device_ms": device_ms(fn, torch)[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--k2-inputs", default=str(ROOT / "build"
                                               / "time_paths_k2.npz"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false")
    src = Path(args.src).resolve()
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(src.parent / "build"
                                              / "time_paths")
    sys.path.insert(0, str(src))
    from repro_torch.configs.registry import get_config
    from repro_torch.data.loader import TieredDataLoader, write_token_shards
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import entropy_features as ef
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as tr
    from repro_torch.serving.decode import make_prefill_step
    from repro_torch.storage.store import TieredStore
    from repro_torch.training import train_step as ts

    _build.build()
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)

    kernels = {}
    g = gen()
    q = torch.randn((BATCH, cfg.n_heads, cfg.head_dim), generator=g,
                    device=dev).bfloat16()
    k, v = (torch.randn((BATCH, CACHE, cfg.n_kv_heads, cfg.head_dim),
                        generator=g, device=dev).bfloat16() for _ in range(2))
    for L in KV_LENS:
        lens = torch.full((BATCH,), L, dtype=torch.int32, device=dev)
        kernels[f"K6 kv_len {L}"] = kernel_times(
            torch, lambda: da.decode_attention_kernel(q, k, v, lens))
    for i, a in enumerate(k2_inputs(Path(args.k2_inputs))):
        t = [torch.as_tensor(x, dtype=dt, device=dev).contiguous()
             for x, dt in zip(a, (torch.int32,) * 4 + (torch.float32,))]
        kernels[f"K2 class {i}"] = kernel_times(
            torch, lambda: ef.weighted_entropy_features_kernel(*t))

    params = tr.init_params(gen(), cfg, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(SEED + 1))
    prefill = make_prefill_step(cfg)
    prefill_s = []
    with torch.no_grad():
        for i in range(PREFILLS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, prompts)
            torch.cuda.synchronize()
            if i:                               # the first warms up
                prefill_s.append(time.perf_counter() - t0)
    del params
    torch.cuda.empty_cache()

    tcfg = ts.TrainConfig(remat=True, compressed_grads=True, microbatches=1)
    store = TieredStore()
    shards = write_token_shards(store, n_shards=16, rows=32, seq=SEQ,
                                vocab=cfg.vocab_size, seed=SEED)
    loader = TieredDataLoader(store, shards, batch=BATCH, seq=SEQ)
    state = ts.init_train_state(gen(), cfg, tcfg, device="cuda")
    res = train(cfg, tcfg, state, loader, STEPS + 1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"src": str(src), "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "prefill_s": prefill_s,
                      "step_s": res.step_s[1:], "kernels": kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

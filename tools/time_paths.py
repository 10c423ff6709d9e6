#!/usr/bin/env python3
"""Time the port's zamba2-2.7b prefill and training step, the K1, K2, K4,
K5 and K6 kernels, and the capacitated solver's dual ascent, on one NVIDIA
GPU, for comparing two source trees in one run on one card.

    python tools/time_paths.py [--src SRC] [--k2-inputs FILE]
        [--k1-inputs FILE] [--k4-inputs FILE] [--scan-inputs FILE]
        [--scan-only | --k6-only | --k5-only | --bits-only]

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
the three dtype classes of the placement path's first feature pass, and K1
(``fractional_overlap_matrix_kernel``) on its G-PART matrix (TPC-H SF0.1,
440 queries, 500 rows per file, G-PART on the card, as chip_smoke.py runs
it), and K1 on chip_smoke.py's scaling shape (4,096 families over 81,920
files); K4 (``byte_entropy_kernel``) on 1 MiB of random bytes and on the
first 4 MiB of the embedding's bf16 bytes after the training steps. The
placement inputs are made once by the tree that runs first and kept in
``--k2-inputs`` and ``--k1-inputs`` (default ``build/time_paths_k2.npz``
and ``build/time_paths_k1.npz`` in this checkout), the trained payload in
``--k4-inputs`` (``build/time_paths_k4.npy``), so every run reads the
same inputs. Each kernel gets its mean time per call between CUDA events
over 50 back-to-back calls (wrapper included) and its device time per
call from torch.profiler over 20 calls.

The dual ascent (``optassign._lagrangian_scan``, 200 float32 steps on the
card) runs on chip_smoke.py's capacitated scale instance: N 16,000 of
``bench_reoptimize``'s recipe on AWS + GCP + Azure, Azure capped at half
its uncapped footprint. Its arguments are caught from that tree's
``PlacementEngine.solve`` by the tree that runs first, before the host
finish, and kept in ``--scan-inputs`` (``build/time_paths_scan.npz``).
It gets its wall time per call (host clock to ``torch.cuda.synchronize()``,
5 calls after one warm-up) and its device time from torch.profiler (one
call), in all and for its usage-sum kernel (one launch a step).
``--scan-only`` times the dual ascent alone (no build, prefill, steps or
kernels), and ``--k6-only`` K6 alone (building only its library).
``--k5-only`` times K5 (``flash_attention_kernel``, wrapper included) at
every shape the zoo's and zamba2's main paths give it (:data:`K5_SHAPES`,
bf16 from seed 0), building only the attention libraries: the CUDA-event
mean over 50 calls, the profiler's device time, the route the wrapper
took, and ``scaled_dot_product_attention``'s device time where it computes
the same function (non-causal, or causal with Sq equal to Sk). A tree
whose ``flash_attention`` module has ``launch_route`` also gets the device
time of each route that takes the shape, so one run compares them.
``--bits-only`` prints the sha256 of the outputs of K7 at zamba2's prefill
shape (x (4, 512, 80, 64) bf16, n 64, chunk 128, from seed 0: y and the
state; and the same values in float32, K7's float32 route), of K2 on seeded codes at 1, 5 and 16 buckets, replicated and
distributed (V 15,005 and 400,000), and of the usage sum at T 1 x N 16,000,
L 12 and T 1,024 x N 239, L 4, with each call's time: two trees whose
hashes agree compute those calls bit for bit alike.

Prints, as its last line, one JSON object: the tree, the card's name and
``nvidia-smi`` power limit, the prefill seconds, the step seconds, the
kernel times and the dual ascent's times.

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
#: K5's calls on the main paths: (name, q, k, v shapes, causal); B 4, the
#: zoo's prefills at 512 tokens (whisper's decoder at its prompt of 128),
#: the cross-attention decode steps at Sq 1, and zamba2's prefill
K5_SHAPES = (
    ("zamba2 prefill", (4, 512, 32, 80), (4, 512, 32, 80), (4, 512, 32, 80),
     True),
    ("deepseek prefill", (4, 512, 16, 192), (4, 512, 16, 192),
     (4, 512, 16, 128), True),
    ("whisper encoder", (4, 1500, 12, 64), (4, 1500, 12, 64),
     (4, 1500, 12, 64), False),
    ("whisper decoder self", (4, 128, 12, 64), (4, 128, 12, 64),
     (4, 128, 12, 64), True),
    ("whisper cross prefill", (4, 128, 12, 64), (4, 1500, 12, 64),
     (4, 1500, 12, 64), False),
    ("whisper cross decode", (4, 1, 12, 64), (4, 1500, 12, 64),
     (4, 1500, 12, 64), False),
    ("llama4 prefill", (4, 512, 40, 128), (4, 512, 8, 128),
     (4, 512, 8, 128), True),
    ("vision prefill", (4, 512, 64, 128), (4, 512, 8, 128),
     (4, 512, 8, 128), True),
    ("vision cross prefill", (4, 512, 64, 128), (4, 4100, 8, 128),
     (4, 4100, 8, 128), False),
    ("vision cross decode", (4, 1, 64, 128), (4, 4100, 8, 128),
     (4, 4100, 8, 128), False),
)


def placement_inputs(k2_path: Path, k1_path: Path):
    """The placement path's inputs of K2 and K1: the three dtype classes of
    its first feature pass (codes, n_valid, n_rows, n_cols, lengths each)
    and the code rows, file sizes and spans of its G-PART matrix, from
    ``k2_path`` and ``k1_path`` or made by this tree and kept there."""
    fields = ("codes", "n_valid", "n_rows", "n_cols", "lengths")
    if not (k2_path.exists() and k1_path.exists()):
        import dataclasses
        from repro_torch.core.engine import PartitionStage
        from repro_torch.core.scope import paper_variants
        from repro_torch.data import tpch
        from repro_torch.data.tables import DTYPE_CLASSES, encode_dtype_classes
        from repro_torch.kernels import ops
        db = tpch.generate(scale_rows=600_000, seed=SEED)
        qs = tpch.generate_queries(db, n_per_template=20, seed=SEED + 1,
                                   rows_per_file=500)
        parts, rows = tpch.partitions_from_queries(db, qs, rows_per_file=500)
        cfg = dataclasses.replace(
            paper_variants(np.full(4, np.inf))["SCOPe (No capacity constraint)"],
            partition_backend="device", device="cuda")
        k1 = []
        orig = ops.fractional_overlap_matrix
        ops.fractional_overlap_matrix = \
            lambda *a, **k: k1.append(a) or orig(*a, **k)
        try:
            enc = encode_dtype_classes(PartitionStage(cfg)(parts, rows).tables)
        finally:
            ops.fractional_overlap_matrix = orig
        k2_path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(k2_path, **{f"{i}_{f}": getattr(enc[d], f)
                             for i, d in enumerate(DTYPE_CLASSES)
                             for f in fields})
        np.savez(k1_path, **dict(zip(("codes", "sizes", "spans"),
                                     map(np.asarray, k1[0]))))
    with np.load(k2_path) as z:
        k2 = [tuple(z[f"{i}_{f}"] for f in fields) for i in range(3)]
    with np.load(k1_path) as z:
        k1 = tuple(z[f] for f in ("codes", "sizes", "spans"))
    return k2, k1


def scan_inputs(path: Path) -> dict:
    """The dual ascent's arguments at chip_smoke.py's capacitated scale
    instance, caught from ``PlacementEngine.solve`` once and kept in
    ``path``."""
    names = ("masked", "stored", "cap", "g_of_t", "gcap", "step0", "iters")
    if not path.exists():
        sys.path.insert(0, str(ROOT))
        from chip_smoke import MC_SCHEMES, SCALE_N_CAP, _synthetic
        from repro_torch.core import engine as E
        from repro_torch.core import optassign
        from repro_torch.core.costs import big3_table

        class Caught(Exception):
            pass

        def catch(*a):
            raise Caught(a)
        big3 = big3_table()
        cfg = E.ScopeConfig(schemes=MC_SCHEMES, months=6.0, device="cuda")
        g = E.PlacementEngine(big3, cfg).solve(
            _synthetic(E, big3, cfg, SCALE_N_CAP, SCALE_N_CAP))
        az = big3.provider_names.index("azure")
        use = float(g.stored_gb[big3.provider_of_tier[g.assignment.tier]
                                == az].sum())
        tab = big3_table(azure_capacity_gb=0.5 * use)
        scan = optassign._lagrangian_scan
        optassign._lagrangian_scan = catch
        try:
            E.PlacementEngine(tab, cfg).solve(
                _synthetic(E, tab, cfg, SCALE_N_CAP, SCALE_N_CAP))
            raise SystemExit("FAIL: the scale instance never reached the "
                             "dual ascent")
        except Caught as e:
            args = e.args[0]
        finally:
            optassign._lagrangian_scan = scan
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **dict(zip(names, args[:7])))
    with np.load(path) as z:
        return {k: z[k] for k in names}


def scan_times(torch, a: dict) -> dict:
    """The dual ascent's wall ms per call and device ms (torch.profiler),
    and the device ms of its usage-sum kernel launches, in all and per
    launch (one a step)."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms
    from repro_torch.core import optassign
    dev = torch.device("cuda")
    fn = lambda: optassign._lagrangian_scan(
        a["masked"], a["stored"], a["cap"], a["g_of_t"], a["gcap"],
        float(a["step0"]), int(a["iters"]), dev)
    wall = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:                                   # the first warms up
            wall.append(1e3 * (time.perf_counter() - t0))
    dev_ms, by = device_ms(fn, torch, iters=1)
    usage = {k.replace("(anonymous namespace)::", "").split("(")[0]: v
             for k, v in by.items() if "usage" in k}
    iters = int(a["iters"])
    return {"N": int(a["masked"].shape[0]), "iters": iters, "wall_ms": wall,
            "device_ms": dev_ms, "usage_sum_device_ms": usage,
            "usage_sum_device_ms_per_launch": sum(usage.values()) / iters}


def kernel_times(torch, fn) -> dict:
    """{"ms": mean per call between CUDA events over 50 calls, "device_ms":
    device time per call from torch.profiler over 20 calls} (chip_smoke.py's
    timers)."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms, device_ms
    return {"ms": cuda_ms(fn, torch, iters=50),
            "device_ms": device_ms(fn, torch)[0]}


def k6_times(torch, cfg, da) -> dict:
    """K6 on the serve loop's last cache at each of KV_LENS."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((BATCH, cfg.n_heads, cfg.head_dim), generator=g,
                    device=dev).bfloat16()
    k, v = (torch.randn((BATCH, CACHE, cfg.n_kv_heads, cfg.head_dim),
                        generator=g, device=dev).bfloat16() for _ in range(2))
    out = {}
    for L in KV_LENS:
        lens = torch.full((BATCH,), L, dtype=torch.int32, device=dev)
        out[f"K6 kv_len {L}"] = kernel_times(
            torch, lambda: da.decode_attention_kernel(q, k, v, lens))
    return out


def k5_times(torch) -> dict:
    """K5 at each of :data:`K5_SHAPES` (see ``--k5-only``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms
    _build.build([n for n in ("flash_attention", "flash_attention_wgmma",
                              "decode_attention") if n in _build.SOURCES])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for name, qs, ks, vs, causal in K5_SHAPES:
        q, k, v = (torch.randn(s, generator=g, device=dev).bfloat16()
                   for s in (qs, ks, vs))
        call = lambda: fa.flash_attention_kernel(q, k, v, causal=causal)
        _build.reset_launch_counts()
        call()
        torch.cuda.synchronize()
        row = {"route": sorted(_build.route_counts), **kernel_times(torch, call)}
        for route in getattr(fa, "ROUTES_BF16", ()):
            if fa.route_takes(route, q, k, v):
                row[f"device_ms {route}"] = device_ms(
                    lambda: fa.launch_route(route, q, k, v, causal=causal),
                    torch)[0]
        if not causal or qs[1] == ks[1]:
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            row["sdpa_device_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=qs[2] != ks[2]),
                torch)[0]
        out[name] = row
        del q, k, v
    return out


def _sha(torch, *ts) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def bits_and_times(torch) -> dict:
    """{call: {"sha256": first 16 hex digits of its outputs' bytes, "ms",
    "device_ms"}} for the calls ``--bits-only`` names."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import entropy_features as ef
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import usage_sum as us
    _build.build(["ssd_scan", "entropy_features", "usage_sum"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}

    def record(name, fn):
        res = fn()
        torch.cuda.synchronize()
        res = res if isinstance(res, tuple) else (res,)
        out[name] = {"sha256": _sha(torch, *res), **kernel_times(torch, fn)}

    b, s, h, p, n = BATCH, SEQ, 80, 64, 64      # zamba2's prefill
    x = torch.randn((b, s, h, p), generator=g, device=dev).bfloat16()
    Bm, Cm = (torch.randn((b, s, 1, n), generator=g, device=dev)
              .mul(0.5).bfloat16() for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g,
                                                  device=dev)) * 0.5
    A = -torch.exp(torch.randn(h, generator=g, device=dev) * 0.3)
    D = torch.ones(h, device=dev)
    record("K7 zamba2 prefill", lambda: ssd.ssd_scan_kernel(
        x, dt, A, Bm, Cm, D, chunk=128))
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    record("K7 zamba2 prefill, float32", lambda: ssd.ssd_scan_kernel(
        xf, dt, A, Bf, Cf, D, chunk=128))

    rng = np.random.default_rng(SEED)
    for V, M in ((15_005, 200_000), (400_000, 300_000)):
        N = 3
        codes = np.minimum(rng.zipf(1.3, (N, M)) - 1, V - 1).astype(np.int32)
        n_valid = np.array([M, M // 2 + 1, 7], np.int32)
        n_cols = np.array([3, 1, 2], np.int32)
        args = [torch.as_tensor(a, device=dev) for a in
                (codes, n_valid, n_valid // n_cols, n_cols,
                 rng.integers(1, 12, (N, V)).astype(np.float32))]
        for nb in (1, 5, 16):
            record(f"K2 V {V} at {nb} buckets", lambda: (
                ef.weighted_entropy_features_kernel(*args, n_buckets=nb)))

    for T, N, L, K in ((1, 16_000, 12, 3), (1_024, 239, 4, 3)):
        idx = torch.as_tensor(rng.integers(0, L * K, (T, N)), device=dev)
        chosen = torch.as_tensor(np.exp(rng.uniform(-8, 8, (T, N)))
                                 .astype(np.float32), device=dev)
        record(f"usage_sum T {T} x N {N}, L {L}",
               lambda: us.usage_sum_kernel(idx, chosen, K, L))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--k2-inputs", default=str(ROOT / "build"
                                               / "time_paths_k2.npz"))
    ap.add_argument("--k1-inputs", default=str(ROOT / "build"
                                               / "time_paths_k1.npz"))
    ap.add_argument("--k4-inputs", default=str(ROOT / "build"
                                               / "time_paths_k4.npy"))
    ap.add_argument("--scan-inputs", default=str(ROOT / "build"
                                                 / "time_paths_scan.npz"))
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--scan-only", action="store_true")
    only.add_argument("--k6-only", action="store_true")
    only.add_argument("--k5-only", action="store_true")
    only.add_argument("--bits-only", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false")
    src = Path(args.src).resolve()
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(src.parent / "build"
                                              / "time_paths")
    sys.path.insert(0, str(src))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.bits_only:
        print(json.dumps({"src": str(src),
                          "device": torch.cuda.get_device_name(0),
                          "nvidia_smi": smi, "bits": bits_and_times(torch)}))
        return 0
    if args.k5_only:
        print(json.dumps({"src": str(src),
                          "device": torch.cuda.get_device_name(0),
                          "nvidia_smi": smi, "k5": k5_times(torch)}))
        return 0
    if args.k6_only:
        from repro_torch.configs.registry import get_config
        from repro_torch.kernels import _build
        from repro_torch.kernels import decode_attention as da
        _build.build(["decode_attention"])
        print(json.dumps({"src": str(src),
                          "device": torch.cuda.get_device_name(0),
                          "nvidia_smi": smi,
                          "kernels": k6_times(torch, get_config(ARCH), da)}))
        return 0
    scan = scan_times(torch, scan_inputs(Path(args.scan_inputs)))
    if args.scan_only:
        print(json.dumps({"src": str(src),
                          "device": torch.cuda.get_device_name(0),
                          "nvidia_smi": smi, "scan": scan}))
        return 0
    from repro_torch.configs.registry import get_config
    from repro_torch.data.loader import TieredDataLoader, write_token_shards
    from repro_torch.core import datapart as dp
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import entropy_features as ef
    from repro_torch.kernels import overlap as ov
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as tr
    from repro_torch.serving.decode import make_prefill_step
    from repro_torch.storage.store import TieredStore
    from repro_torch.training import train_step as ts

    _build.build()
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)

    kernels = k6_times(torch, cfg, da)
    k2, k1 = placement_inputs(Path(args.k2_inputs), Path(args.k1_inputs))
    for i, a in enumerate(k2):
        t = [torch.as_tensor(x, dtype=dt, device=dev).contiguous()
             for x, dt in zip(a, (torch.int32,) * 4 + (torch.float32,))]
        kernels[f"K2 class {i}"] = kernel_times(
            torch, lambda: ef.weighted_entropy_features_kernel(*t))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import gpart_instance
    big = dp.PartitionIndex.from_partitions(
        gpart_instance(dp, 4096, 4096 * 20)).padded_codes()
    for tag, a in (("main", k1), ("4096x81920", big)):
        t = [torch.as_tensor(x, dtype=dt, device=dev).contiguous()
             for x, dt in zip(a, (torch.int32, torch.float32, torch.float32))]
        kernels[f"K1 {tag}"] = kernel_times(
            torch, lambda: ov.fractional_overlap_matrix_kernel(*t))
    rnd = torch.randint(0, 256, (1 << 20,), dtype=torch.uint8, device=dev,
                        generator=gen())
    kernels["K4 1 MiB random"] = kernel_times(
        torch, lambda: ef.byte_entropy_kernel(rnd))

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
    k4_path = Path(args.k4_inputs)
    if not k4_path.exists():
        k4_path.parent.mkdir(parents=True, exist_ok=True)
        np.save(k4_path, state["params"]["embed"].reshape(-1)
                .view(torch.uint8)[:4 << 20].cpu().numpy())
    del state
    torch.cuda.empty_cache()
    shard = torch.as_tensor(np.load(k4_path), device=dev)
    kernels["K4 4 MiB of trained bf16 params"] = kernel_times(
        torch, lambda: ef.byte_entropy_kernel(shard))
    print(json.dumps({"src": str(src), "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "prefill_s": prefill_s,
                      "step_s": res.step_s[1:], "kernels": kernels,
                      "scan": scan}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

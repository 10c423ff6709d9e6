#!/usr/bin/env python3
"""Time the port's zamba2-2.7b prefill and training step on one NVIDIA GPU,
for comparing two source trees in one run on one card.

    python tools/time_paths.py [--src SRC]

``--src`` is the ``src`` directory of the tree to time (default: this
checkout's); its kernels are built from that tree's sources into
``<SRC>/../build/time_paths``. The sizes are chip_smoke.py's: zamba2-2.7b
at full width and depth in bfloat16, random weights from seed 0. Prefill
is ``make_prefill_step`` on 4 prompts of 512 tokens, timed with a host
clock around each call up to ``torch.cuda.synchronize()``, after one
warm-up call. The steps are ``repro_torch.launch.train.train`` on the
launcher's Zipf token shards in a ``TieredStore`` (batch 4 x 512,
``TrainConfig(remat=True, compressed_grads=True)``), whose synchronised
``step_s`` are kept after the first, which warms up. Prints, as its last
line, one JSON object: the tree, the card's name and ``nvidia-smi`` power
limit, the prefill seconds and the step seconds.

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

ARCH = "zamba2-2.7b"
BATCH, SEQ, SEED = 4, 512, 0
PREFILLS, STEPS = 10, 4             # timed calls, after one warm-up each


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
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
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as tr
    from repro_torch.serving.decode import make_prefill_step
    from repro_torch.storage.store import TieredStore
    from repro_torch.training import train_step as ts

    _build.build()
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)

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
                      "step_s": res.step_s[1:]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training launcher: tiered data -> train step -> AdamW, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --smoke --steps 4 --batch 4 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --steps 5 --batch 4 --seq 512 --compressed-grads

Port of ``repro.launch.train`` without the mesh: the same synthetic Zipf
token shards in a :class:`~repro_torch.storage.store.TieredStore` (16
shards of 32 rows), the same :class:`~repro_torch.data.loader.TieredDataLoader`
order, random weights from seed 0 and ``TrainConfig(remat=not smoke)``, on
``--device`` (default ``cuda``). ``--data-mesh`` and ``--model-mesh`` take
only 1 (one card). ``--compressed-grads`` turns on the int8 error-feedback
gradient mean (the K3 kernel on the card). Checkpointing (``--ckpt-every``,
``--resume``) is not ported yet and raises. Prints the loss and seconds per
step every 5 steps and at the last, as the JAX launcher does, with the
training tokens per second beside them.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Callable, List, Optional

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.loader import TieredDataLoader, write_token_shards
from repro_torch.device import describe, resolve
from repro_torch.models.config import ModelConfig
from repro_torch.storage.store import TieredStore
from repro_torch.training import train_step as ts

LOG_EVERY = 5               # steps between progress lines, as in JAX's loop


@dataclasses.dataclass
class TrainResult:
    state: dict
    losses: List[float]           # loss of each step
    step_s: List[float]           # host seconds of each step (synchronised)
    tokens: int                   # training tokens per step (batch x seq)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens * len(self.step_s) / sum(self.step_s)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(cfg: ModelConfig, tcfg: ts.TrainConfig, state, loader, steps: int,
          *, on_step: Optional[Callable[[int, dict], None]] = None,
          ) -> TrainResult:
    """Run ``steps`` train steps from ``loader``'s batches (epoch ``i`` at
    step ``i``, as the JAX launcher walks them). ``on_step(i, metrics)``
    is called after step ``i`` (1-based), once the device is idle."""
    step_fn = ts.make_train_step(cfg, tcfg)
    dev = state["opt"].step.device
    losses, secs = [], []
    tokens = loader.batch * loader.seq
    i = 0
    while i < steps:
        for batch in loader.batches(epoch=i):
            if i >= steps:
                break
            _sync(dev)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            loss = float(m["loss"])
            _sync(dev)
            secs.append(time.perf_counter() - t0)
            losses.append(loss)
            i += 1
            if on_step is not None:
                on_step(i, m)
            if i % LOG_EVERY == 0 or i == steps:
                print(f"step {i} loss {loss:.4f} "
                      f"({sum(secs) / i:.2f}s/step, "
                      f"{tokens * i / sum(secs):.1f} tokens/s)", flush=True)
    return TrainResult(state, losses, secs, tokens)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data-mesh", type=int, default=1,
                    help="data-parallel width; only 1 (one card)")
    ap.add_argument("--model-mesh", type=int, default=1,
                    help="tensor-parallel width; only 1 (one card)")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compressed-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    if args.data_mesh != 1 or args.model_mesh != 1:
        raise NotImplementedError("repro_torch trains on one device: "
                                  "--data-mesh and --model-mesh take only 1 "
                                  "(distributed/ is not ported, ROADMAP.md "
                                  "queue 1 item 8)")
    if args.ckpt_every or args.resume:
        raise NotImplementedError("checkpointing (checkpoint/manager.py) is "
                                  "not ported yet (ROADMAP.md queue 1 item 8)")
    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve(args.device)
    tcfg = ts.TrainConfig(remat=not args.smoke,
                          microbatches=args.microbatches,
                          compressed_grads=args.compressed_grads)
    store = TieredStore()
    shards = write_token_shards(store, n_shards=16, rows=32, seq=args.seq,
                                vocab=cfg.vocab_size)
    loader = TieredDataLoader(store, shards, batch=args.batch, seq=args.seq)
    state = ts.init_train_state(torch.Generator(device=dev).manual_seed(0),
                                cfg, tcfg, device=dev)
    res = train(cfg, tcfg, state, loader, args.steps)
    if not all(math.isfinite(x) for x in res.losses):
        raise RuntimeError(f"non-finite loss: {res.losses}")
    print(f"done at step {len(res.losses)} on {describe(dev)['kind']}: "
          f"{res.tokens_per_s:.1f} training tokens/s")


if __name__ == "__main__":
    main()

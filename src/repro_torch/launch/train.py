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
gradient mean (the K3 kernel on the card). ``--ckpt-every k`` saves the
state every k steps through a
:class:`~repro_torch.checkpoint.manager.CheckpointManager` on the data's
store (greedy tier and codec choice on ``--device``), waits for the last
write and prints the store's bill (``ckpt bill:``). ``--resume`` restores
the latest checkpoint of that manager and continues from its step. As in
the JAX launcher, the store is a fresh one in memory and the manager exists
only with ``--ckpt-every``, so ``--resume`` in a new process finds nothing
and starts at step 0. Prints the loss and seconds per step every 5 steps
and at the last, as the JAX launcher does, with the training tokens per
second beside them.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Callable, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
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
          *, start: int = 0,
          on_step: Optional[Callable[[int, dict, dict], None]] = None,
          ) -> TrainResult:
    """Run train steps ``start + 1`` to ``steps`` from ``loader``'s batches
    (epoch ``i`` at step ``i``, as the JAX launcher walks them, a resumed
    run included). ``on_step(i, state, metrics)`` is called after step
    ``i`` (1-based), once the device is idle."""
    step_fn = ts.make_train_step(cfg, tcfg)
    dev = state["opt"].step.device
    losses, secs = [], []
    tokens = loader.batch * loader.seq
    i = start
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
                on_step(i, state, m)
            if i % LOG_EVERY == 0 or i == steps:
                print(f"step {i} loss {loss:.4f} "
                      f"({sum(secs) / len(secs):.2f}s/step, "
                      f"{tokens * len(secs) / sum(secs):.1f} tokens/s)",
                      flush=True)
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
    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve(args.device)
    tcfg = ts.TrainConfig(remat=not args.smoke,
                          microbatches=args.microbatches,
                          compressed_grads=args.compressed_grads)
    store = TieredStore()
    shards = write_token_shards(store, n_shards=16, rows=32, seq=args.seq,
                                vocab=cfg.vocab_size)
    loader = TieredDataLoader(store, shards, batch=args.batch, seq=args.seq)
    mgr = (CheckpointManager(store, device=dev) if args.ckpt_every
           else None)
    state = ts.init_train_state(torch.Generator(device=dev).manual_seed(0),
                                cfg, tcfg, device=dev)
    start = 0
    if args.resume and mgr and mgr.latest_step() is not None:
        state, start = mgr.restore(state, device=dev)

    def save(i, state, _):
        if i % args.ckpt_every == 0:
            mgr.save(i, state)

    res = train(cfg, tcfg, state, loader, args.steps, start=start,
                on_step=save if mgr else None)
    if not all(math.isfinite(x) for x in res.losses):
        raise RuntimeError(f"non-finite loss: {res.losses}")
    if mgr:
        mgr.wait()
        print("ckpt bill:", {k: round(v, 6) for k, v in
                             store.meter.as_dict().items() if v})
    print(f"done at step {start + len(res.losses)} on "
          f"{describe(dev)['kind']}: {res.tokens_per_s:.1f} training "
          f"tokens/s")


if __name__ == "__main__":
    main()

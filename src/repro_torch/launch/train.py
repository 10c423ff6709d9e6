"""Training launcher: tiered data -> train step -> AdamW, on one device or
data-parallel over a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --smoke --steps 4 --batch 4 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \\
        --steps 5 --batch 4 --seq 512 --compressed-grads
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen3-4b --smoke --steps 4 --batch 8 --data-mesh 2 \\
        --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch zamba2-2.7b --smoke --steps 4 --batch 4 --model-mesh 2 \\
        --device cpu

Port of ``repro.launch.train``: the same synthetic Zipf
token shards in a :class:`~repro_torch.storage.store.TieredStore` (16
shards of 32 rows), the same :class:`~repro_torch.data.loader.TieredDataLoader`
order, random weights from seed 0 and ``TrainConfig(remat=not smoke)``, on
``--device`` (default ``cuda``). ``--data-mesh N`` trains data-parallel
over N ranks and ``--model-mesh M`` tensor-parallel over M
(``launch.mesh.launch_mesh``: under ``torchrun`` the world size must be N
x M; every rank reads the same global batches and takes its rows, holds
its shards of the weights by ``param_specs`` and, at N above 1, its
ZeRO-1 slices of the optimizer state, ``training.train_step``); each rank
prints its parameter and optimizer bytes beside the reckoning from the
specs. ``--data-mesh 0``, the production mesh, is refused.
``--compressed-grads`` turns on the int8 error-feedback gradient mean (the
K3 kernel on the card). ``--ckpt-every k`` saves the
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
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data.loader import TieredDataLoader, write_token_shards
from repro_torch.device import describe
from repro_torch.launch.mesh import launch_mesh
from repro_torch.launch.shapes import rank_bytes
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
          mesh=None) -> TrainResult:
    """Run train steps ``start + 1`` to ``steps`` from ``loader``'s batches
    (epoch ``i`` at step ``i``, as the JAX launcher walks them, a resumed
    run included), data-parallel over ``mesh`` when one is given.
    ``on_step(i, state, metrics)`` is called after step ``i`` (1-based),
    once the device is idle. The progress lines are printed by the one
    process, or by rank 0 of a mesh."""
    step_fn = ts.make_train_step(cfg, tcfg, mesh)
    log = mesh is None or dist.get_rank() == 0
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
            if log and (i % LOG_EVERY == 0 or i == steps):
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
                    help="data-parallel ranks (0, the production mesh, is "
                         "refused: one card)")
    ap.add_argument("--model-mesh", type=int, default=1,
                    help="tensor-parallel ranks")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compressed-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    mesh, dev = launch_mesh(args.data_mesh, args.model_mesh, args.device)
    lead = mesh is None or dist.get_rank() == 0
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
                                cfg, tcfg, args.model_mesh, mesh, device=dev)
    if mesh is not None:
        b = rank_bytes(cfg, mesh, state["params"], state["opt"])
        print(f"rank {dist.get_rank()}: parameters {b['params']:,} bytes "
              f"(reckoned from param_specs: {b['params_reckoned']:,}), "
              f"optimizer {b['opt']:,} bytes (reckoned from zero1_specs: "
              f"{b['opt_reckoned']:,})", flush=True)
    start = 0
    if args.resume and mgr and mgr.latest_step() is not None:
        state, start = mgr.restore(state, device=dev)

    def save(i, state, _):
        if i % args.ckpt_every == 0:
            mgr.save(i, state)

    res = train(cfg, tcfg, state, loader, args.steps, start=start,
                on_step=save if mgr else None, mesh=mesh)
    if not all(math.isfinite(x) for x in res.losses):
        raise RuntimeError(f"non-finite loss: {res.losses}")
    if mgr:
        mgr.wait()
        if lead:
            print("ckpt bill:", {k: round(v, 6) for k, v in
                                 store.meter.as_dict().items() if v})
    if lead:
        where = describe(dev)["kind"]
        if mesh is not None:
            where += f", mesh {args.data_mesh} x {args.model_mesh}"
        print(f"done at step {start + len(res.losses)} on {where}: "
              f"{res.tokens_per_s:.1f} training tokens/s")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

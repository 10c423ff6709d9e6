"""Training: one closed-loop job. The program's ``make_train_step`` is fed
by its ``TieredDataLoader`` over Zipf token shards in its ``TieredStore``.

Set-up builds one training state from the seed and drives it through its
first ``check.steps`` steps through the window's own call and feed; those
are the warm-up too. The window then runs steps until ``seconds`` have
passed, each synchronised by reading its loss. After it (and after the
traced segment, with ``trace``) the program's state is freed, and the
reference follows the first steps from the same weights and rows.

The check compares each check step's loss (relative gap, the widest);
the norm of each leaf's first gradient as AdamW takes it, worked out from
the first moment after one step (``|m| / (1 - b1)``); the norm of each
leaf's change of its float32 master weights over the check steps. A leaf's gap is the gap between the
program's and the reference's norms over the larger of the reference's
norm of that leaf and of the median leaf; the change leaves out leaves
whose reference gradient is under a thousandth of the median leaf's.
Each norm is compared by its worst leaf (``grad_gap``, ``change_gap``:
a leaf unmoved or moved twice, a batch half left out), and the gradient
also by its median leaf (``grad_gap_median``: the precision the step
computes in, which the worst leaf's gap cannot tell from the noise of a
few small leaves).
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from perfbench import reference, trace as tracing, traffic, weights, work
from perfbench.drivers import common

#: leaves whose reference gradient is under this share of the median
#: leaf's move by round-off alone, and stay out of the change
QUIET_LEAF = 1e-3
CHECKS = ("loss_gap", "grad_gap", "change_gap", "grad_gap_median")


def data(mix: Dict, vocab: int, seed: int):
    """(rows (n, seq + 1) int32, the program's loader over them as
    shards in its store, cycling epochs)."""
    from repro_torch.data import loader as ld
    from repro_torch.storage.store import TieredStore
    rows = traffic.train_rows(mix, vocab, seed)
    store = TieredStore()
    per = mix["rows_per_shard"]
    keys = []
    for i in range(mix["shards"]):
        key = f"data/{i:05d}"
        store.put(key, rows[i * per:(i + 1) * per].tobytes(), tier=1,
                  codec=ld.DEFAULT_SHARD_CODEC)
        keys.append(key)
    loader = ld.TieredDataLoader(store, keys, mix["batch"], mix["seq"],
                                 seed=seed)

    def feed() -> Iterator[Dict[str, np.ndarray]]:
        epoch = 0
        while True:
            yield from loader.batches(epoch=epoch)
            epoch += 1
    return rows, feed()


def row_ids(rows: np.ndarray, batch: Dict[str, np.ndarray]
            ) -> Optional[List[int]]:
    """Which of ``rows`` the batch holds (tokens and the last label), or
    None where one is none of them."""
    index = {r.tobytes(): i for i, r in enumerate(rows)}
    full = np.concatenate([batch["tokens"], batch["labels"][:, -1:]], axis=1)
    ids = [index.get(np.ascontiguousarray(r, dtype=np.int32).tobytes())
           for r in full]
    return None if None in ids else ids


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: List[str]) -> List[float]:
    """|prog - ref| / max(ref, the median leaf's ref) of each leaf of
    ``keys``."""
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float],
                 n: int = 3) -> str:
    """The ``n`` leaves of largest gap and the median leaf's gap, for the
    progress lines."""
    gaps = dict(zip(ref, leaf_gaps(prog, ref, list(ref))))
    top = sorted(gaps, key=gaps.get, reverse=True)[:n]
    return (", ".join(f"{k} {gaps[k]:.3g} (ref {ref[k]:.3g})" for k in top)
            + f"; median leaf {statistics.median(gaps.values()):.3g}")


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The check's numbers for a run ``prog`` against the reference."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]) or not losses:
        return dict.fromkeys(CHECKS, float("inf"))
    keys = list(ref["grad"])
    med = statistics.median(ref["grad"].values())
    moving = [k for k in keys if ref["grad"][k] >= QUIET_LEAF * med]
    grad = leaf_gaps(prog["grad"], ref["grad"], keys)
    change = leaf_gaps(prog["change"], ref["change"], moving)
    return {"loss_gap": max(losses),
            "grad_gap": max(grad), "change_gap": max(change),
            "grad_gap_median": statistics.median(grad)}


def run(port: Dict, mix: Dict, check: Dict, seed: int, seconds: float,
        trace: bool, dev: torch.device, t_start: float) -> common.Outcome:
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    cfg = common.program_config(port)
    flat, params = common.program_params(port, cfg, seed, dev)
    names = list(flat)
    adamw = opt.AdamWConfig(**mix["adamw"])
    tcfg = ts.TrainConfig(adamw=adamw, remat=mix["remat"],
                          compressed_grads=mix["compressed_grads"])
    state = {"params": params, "opt": opt.init_state(params, adamw)}
    rows, feed = data(mix, port["vocab_size"], seed)
    step = ts.make_train_step(cfg, tcfg)

    # the first steps: warm-up, and what the reference follows
    init = {k: v.clone() for k, v in flat.items()}
    prog: Dict = {"loss": [], "grad": {}, "change": {}}
    seen: List[Optional[List[int]]] = []
    for i in range(check["steps"]):
        batch = next(feed)
        seen.append(row_ids(rows, batch))
        state, m = step(state, batch)
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            prog["grad"] = {k: float(torch.linalg.vector_norm(t.float()))
                            / (1 - adamw.b1) for k, t in
                            zip(names, tr.tree_leaves(state["opt"].m))}
    prog["change"] = {k: float(torch.linalg.vector_norm(
        t.float() - init[k].float())) for k, t in
        zip(names, tr.tree_leaves(state["opt"].master))}
    del init, m
    common.free(dev)
    common.sync(dev)
    setup_s = common.now() - t_start

    B, S = mix["batch"], mix["seq"]
    common.reset_peak(dev)
    ends, t0 = [], common.now()
    while not ends or ends[-1] - t0 < seconds:
        state, m = step(state, next(feed))
        float(m["loss"])
        ends.append(common.now())
    steps, window_s = len(ends), ends[-1] - t0
    common.say(f"setup {setup_s:.1f} s; window {window_s:.1f} s, {steps} "
               f"steps of {common.spread(np.diff([t0] + ends))} s")
    window = {"seconds": window_s, "step_s": window_s,
              "tokens": steps * B * S, "steps": steps,
              "model_flops": steps * work.train_flops(port, B, S),
              "peak_bytes": common.peak_bytes(dev)}

    traced = None
    if trace:
        def steps_of(n):
            def go():
                nonlocal state
                for _ in range(n):
                    state, mm = step(state, next(feed))
                    float(mm["loss"])
            return go
        traced = tracing.traced(steps_of(mix["trace_steps"]), steps_of(1),
                                ops, lambda: common.sync(dev))

    del state, params, flat, m, step
    common.free(dev)
    t_check = common.now()
    if any(s is None for s in seen):
        checks = dict.fromkeys(CHECKS, float("inf"))
    else:
        ref = reference.train(weights.make_flat(port, seed, dev), port,
                              [rows[ids] for ids in seen], mix["adamw"],
                              mix["compressed_grads"])
        checks = compare(prog, ref)
        common.say(f"losses {prog['loss']} reference {ref['loss']}")
        common.say(f"grad: {worst_leaves(prog['grad'], ref['grad'])}")
        common.say(f"change: {worst_leaves(prog['change'], ref['change'])}")
    common.say(f"check {common.now() - t_check:.1f} s")
    return common.Outcome("train", port, setup_s, window, traced, checks,
                          attempted=steps, failed=0)

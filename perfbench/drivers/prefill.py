"""Prefill serving, open loop: requests arrive on the mix's schedule
whether or not earlier ones have finished (:class:`perfbench.traffic.
Arrivals`), wait in one queue, and are served in arrival order by
the program's ``make_prefill_step``, one prompt a step; a request is
answered when its greedy tokens are synchronised.

Each prompt is padded on the right to a multiple of ``bucket`` tokens.
Causal attention, the Mamba2 scan and a MoE that drops no pair leave its
logits untouched by the padding after it. Set-up warms every padded
length the mix can give. (Batches padded to their longest prompt doubled
the tokens computed at this mix's lengths, and made the queue's tail hang
on which prompts a batch caught.)

The window admits the requests that arrive within ``seconds`` and serves
until each of them is answered. A request's time to first token runs
from its arrival to its answer. After the window the program's weights
are freed; the check draws from the seed ``check.requests`` of the
answered requests, the longest among them, and the reference reads, at
every position of each, the gap by which the program's greedy token's
logit lies below the reference's best: the widest (``argmax_gap``) and,
of each request, the mean over its positions (``argmax_gap_mean``, the
largest of the requests').
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import reference, trace as tracing, traffic, weights, work
from perfbench.drivers import common


def padded(length: int, mix: Dict) -> int:
    b = mix["bucket"]
    return -(-length // b) * b


def lengths(mix: Dict) -> List[int]:
    """Every padded length the mix can give."""
    return list(range(mix["bucket"], padded(mix["length_max"], mix) + 1,
                      mix["bucket"]))


class Server:
    """The program's prefill step over the benchmark's weights."""

    def __init__(self, port: Dict, mix: Dict, seed: int, dev: torch.device):
        from repro_torch.serving import decode
        self.mix, self.dev = mix, dev
        cfg = common.program_config(port)
        _, self.params = common.program_params(port, cfg, seed, dev)
        self.step = decode.make_prefill_step(cfg)

    def serve(self, tokens: np.ndarray) -> torch.Tensor:
        top = self.step(self.params, tokens).argmax(dim=-1)
        common.sync(self.dev)
        return top

    def warm(self, plan: traffic.Arrivals) -> None:
        for L in lengths(self.mix):
            self.serve(plan.prompts(1, L))

    def window(self, reqs: List[traffic.Request]) -> Dict:
        """Serve ``reqs`` (ascending arrivals, seconds from now) in
        arrival order, each once it has arrived and the one before it is
        answered; every request answered, with its time to first token."""
        done, t0 = [], common.now()
        padded_tokens, step_s = 0, 0.0
        for r in reqs:
            time.sleep(max(0.0, r.arrival - (common.now() - t0)))
            tokens = np.zeros((1, padded(r.length, self.mix)), dtype=np.int32)
            tokens[0, :r.length] = r.tokens
            start = common.now()
            top = self.serve(tokens)
            step_s += common.now() - start
            padded_tokens += tokens.size
            done.append({"req": r, "top": top[0, :r.length],
                         "ttft_s": common.now() - t0 - r.arrival})
        return {"done": done, "seconds": common.now() - t0, "step_s": step_s,
                "padded_tokens": padded_tokens}


def sample(done: List[Dict], n: int, seed: int) -> List[Dict]:
    """``n`` of the answered requests drawn from the seed, the first of
    them one of the longest."""
    r = traffic.rng(seed, 5)
    longest = max(d["req"].length for d in done)
    first = [i for i, d in enumerate(done) if d["req"].length == longest]
    pick = [int(r.choice(first))]
    rest = [i for i in range(len(done)) if i != pick[0]]
    pick += [int(i) for i in r.choice(rest, size=min(n - 1, len(rest)),
                                      replace=False)]
    return [done[i] for i in pick]


def check(flat: Dict[str, torch.Tensor], port: Dict,
          picked: List[Dict]) -> Dict[str, float]:
    """The check's numbers for answered requests ``picked``."""
    out = {"argmax_gap": 0.0, "argmax_gap_mean": 0.0}
    for d in picked:
        ((widest, mean),), _ = reference.prefill(
            flat, port, d["req"].tokens[None], [d["top"][None]])
        out = {"argmax_gap": max(out["argmax_gap"], widest),
               "argmax_gap_mean": max(out["argmax_gap_mean"], mean)}
    return out


def run(port: Dict, mix: Dict, spec: Dict, seed: int, seconds: float,
        trace: bool, dev: torch.device, t_start: float) -> common.Outcome:
    from repro_torch.kernels import ops

    server = Server(port, mix, seed, dev)
    plan = traffic.Arrivals(mix, port["vocab_size"], seed)
    server.warm(plan)
    common.free(dev)
    setup_s = common.now() - t_start

    common.reset_peak(dev)
    out = server.window(plan.until(seconds))
    done = out["done"]
    ttft = [d["ttft_s"] for d in done]
    tokens = sum(d["req"].length for d in done)
    common.say(f"setup {setup_s:.1f} s; window {out['seconds']:.2f} s, "
               f"{len(done)} requests, "
               f"{tokens} tokens ({out['padded_tokens']} padded), steps "
               f"{out['step_s']:.2f} s; time to "
               f"first token {common.spread(ttft)} s")
    window = {"seconds": out["seconds"], "step_s": out["step_s"],
              "tokens": tokens,
              "ttft_s": ttft,
              "model_flops": sum(work.forward_flops(port, 1, d["req"].length)
                                 for d in done),
              "peak_bytes": common.peak_bytes(dev)}

    traced = None
    if trace:
        run_for = lambda s: lambda: server.window(plan.until(s))
        traced = tracing.traced(run_for(mix["trace_seconds"]),
                                run_for(1.0), ops, lambda: common.sync(dev))

    del server
    common.free(dev)
    t_check = common.now()
    flat = weights.make_flat(port, seed, dev)
    checks = check(flat, port, sample(done, spec["requests"], seed))
    common.say(f"check {common.now() - t_check:.1f} s")
    return common.Outcome("prefill", port, setup_s, window, traced, checks,
                          attempted=len(done), failed=0)

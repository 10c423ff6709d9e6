"""The readings a cell's limits are set from, in one process on the card:

    python3 perfbench/control.py --workload <name> --program-seeds 1,2,... \
        --control-seeds 7,8,9 --harness-seeds 7 --seconds <s> [--out <file>]

For each program seed, one sound run of the program through the harness
(a short window, ``--seconds``) and its check's numbers: the lower
readings. For each control seed, the reference put in the program's place
and compared directly:

- ``control``: computed with every product in float8 e4m3, the precision
  below the configurations' bfloat16 (:data:`perfbench.reference.FP8`);
- the faults the cell's kind can have, planted in the reference. Training:
  half of each batch left out, the mean taken over the rest
  (``half_batch``); a step that returns its state unchanged
  (``unchanged``) reads 1 by the norms' measure and needs no run.
  Prefill: a request answered with
  token 0 at every position (``unanswered``) and one answer of a request
  altered where it is produced (``altered``, a token drawn from the seed).

For each harness seed, a whole run of the harness with the float8
reference put in the program's place (:func:`substituted`): its
``correct`` has to come out false. The benchmark's own runs do not run
this. It prints one JSON object.
"""

import argparse
import contextlib
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def _flat_of(tree):
    from perfbench import weights
    from repro_torch.models import transformer as tr
    return dict(zip(weights.paths(tree), tr.tree_leaves(tree)))


def reference_prefill_step(port, P):
    """A stand-in for ``decode.make_prefill_step``: the reference's logits
    in precision ``P`` from the weights it is handed."""
    from perfbench import reference

    def make(cfg, mesh=None):
        return lambda params, tokens, context=None: reference.forward(
            _flat_of(params), port, tokens, P)
    return make


def reference_train_step(port, mix, P):
    """A stand-in for ``train_step.make_train_step``: one AdamW step of
    the reference in precision ``P`` a call, from the weights of the first
    state it is handed, its moments and master weights in the program's
    layout."""
    import numpy as np
    import torch
    from perfbench import reference, weights

    def make(cfg, tcfg, mesh=None):
        box = {}

        def step(state, batch):
            if "t" not in box:
                box["t"] = reference.Trainer(
                    _flat_of(state["params"]), port, mix["adamw"],
                    mix["compressed_grads"], P)
            tr = box["t"]
            rows = np.concatenate([batch["tokens"], batch["labels"][:, -1:]],
                                  axis=1)
            loss = tr.step(rows)
            opt = types.SimpleNamespace(m=weights.tree(port, tr.m),
                                        master=weights.tree(port, tr.master),
                                        step=tr.t)
            return ({"params": state["params"], "opt": opt},
                    {"loss": torch.tensor(loss), "step": tr.t})
        return step
    return make


@contextlib.contextmanager
def substituted(kind, port, mix, P):
    """Within ``with``: the program's step for cells of ``kind`` is the
    reference in precision ``P``."""
    if kind == "prefill":
        from repro_torch.serving import decode as mod
        name, make = "make_prefill_step", reference_prefill_step(port, P)
    else:
        from repro_torch.training import train_step as mod
        name, make = "make_train_step", reference_train_step(port, mix, P)
    saved = getattr(mod, name)
    setattr(mod, name, make)
    try:
        yield
    finally:
        setattr(mod, name, saved)


def train_controls(port, mix, spec, seed, dev):
    from perfbench import reference, weights
    from perfbench.drivers import train as dtrain
    rows, feed = dtrain.data(mix, port["vocab_size"], seed)
    batches = [rows[dtrain.row_ids(rows, next(feed))]
               for _ in range(spec["steps"])]
    flat = weights.make_flat(port, seed, dev)
    run = lambda bs, P: reference.train(flat, port, bs, mix["adamw"],
                                        mix["compressed_grads"], P)
    ref = run(batches, reference.F32)
    low = run(batches, reference.FP8)
    for part in ("grad", "change"):
        print(f"control {part}: {dtrain.worst_leaves(low[part], ref[part])}",
              file=sys.stderr, flush=True)
    half = run([b[:len(b) // 2] for b in batches], reference.F32)
    return {"control": dtrain.compare(low, ref),
            "half_batch": dtrain.compare(half, ref),
            "unchanged": {"grad_gap": 1.0, "change_gap": 1.0}}


def prefill_controls(port, mix, spec, seed, dev):
    import torch
    from perfbench import reference, traffic, weights
    from perfbench.drivers import prefill as dprefill
    plan = traffic.Arrivals(mix, port["vocab_size"], seed)
    done = [{"req": r} for r in plan.until(mix["per_cycle"] / plan.rate)]
    flat = weights.make_flat(port, seed, dev)
    r = traffic.rng(seed, 6)
    out = {}
    for d in dprefill.sample(done, spec["requests"], seed):
        tokens = d["req"].tokens[None]
        _, low = reference.prefill(flat, port, tokens, [], reference.FP8)
        (ctl, none), top = reference.prefill(flat, port, tokens,
                                             [low, torch.zeros_like(low)])
        altered = top.clone()
        altered[0, int(r.integers(0, top.shape[1]))] = int(
            r.integers(0, port["vocab_size"]))
        (alt,), _ = reference.prefill(flat, port, tokens, [altered])
        for name, (widest, mean) in (("control", ctl), ("unanswered", none),
                                     ("altered", alt)):
            was = out.get(name, {"argmax_gap": 0.0, "argmax_gap_mean": 0.0})
            out[name] = {"argmax_gap": max(was["argmax_gap"], widest),
                         "argmax_gap_mean": max(was["argmax_gap_mean"], mean)}
        del low, top
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--harness-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    from perfbench import bench as bn, harness, modelcfg, reference
    from perfbench.drivers import common
    if not torch.cuda.is_available():
        print("perfbench: no card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    bench = bn.load_bench(ROOT)
    cell = bn.workload(bench, args.workload)
    port = modelcfg.port_of(bn.config_file(bench, cell["config"], ROOT))
    mix = bn.traffic_file(cell["traffic"])
    spec = bn.cell_file(args.workload)["check"]
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(),
           "program": {}, "controls": {}, "harness": {}}

    def through_harness(seed):
        t0 = time.perf_counter()
        res = harness.run(args.workload, seed, args.seconds, False,
                          device="cuda", t_start=t0)
        common.free(dev)
        return dict({k: c["value"] for k, c in res["checks"].items()},
                    correct=res["correct"], run_s=time.perf_counter() - t0)

    for seed in args.program_seeds:
        out["program"][seed] = through_harness(seed)
        print(json.dumps({"program": seed, **out["program"][seed]}),
              file=sys.stderr, flush=True)
    kinds = {"train": train_controls, "prefill": prefill_controls}
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        out["controls"][seed] = kinds[mix["kind"]](port, mix, spec, seed, dev)
        out["controls"][seed]["run_s"] = time.perf_counter() - t0
        print(json.dumps({"control": seed, **out["controls"][seed]},
                         default=float), file=sys.stderr, flush=True)
        common.free(dev)
    for seed in args.harness_seeds:
        with substituted(mix["kind"], port, mix, reference.FP8):
            out["harness"][seed] = through_harness(seed)
        print(json.dumps({"harness": seed, **out["harness"][seed]}),
              file=sys.stderr, flush=True)
    text = json.dumps(out, indent=1, default=float)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

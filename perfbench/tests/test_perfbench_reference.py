"""The reference agrees with the port's CPU path at smoke size, and the
control (the reference in float8) reads well apart from the program."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import modelcfg, reference, traffic, weights
from perfbench.drivers import common
from perfbench.drivers import train as dtrain

DATA = Path(__file__).resolve().parent / "data"
TRAIN_MIX = json.loads((DATA / "traffic" / "train_smoke.json").read_text())
PREFILL_MIX = json.loads((DATA / "traffic" / "prefill_smoke.json").read_text())


def smoke(name: str, dtype: str = "float32"):
    port = modelcfg.port_of(json.loads(
        (DATA / "configs" / f"{name}.json").read_text()))
    served = dict(port, dtype="bfloat16")
    flat = weights.make_flat(served, 7, "cpu")
    port = dict(port, dtype=dtype)
    return port, flat


def test_ssd_matches_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 2, 70, 3, 4, 5
    x = torch.randn(b, s, h, p, generator=g, dtype=torch.float64)
    dt = torch.rand(b, s, h, generator=g, dtype=torch.float64) * 0.2
    A = -torch.rand(h, generator=g, dtype=torch.float64) * 2
    Bm = torch.randn(b, s, n, generator=g, dtype=torch.float64)
    Cm = torch.randn(b, s, n, generator=g, dtype=torch.float64)
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    want = []
    for t in range(s):
        state = (torch.exp(dt[:, t] * A)[..., None, None] * state
                 + (dt[:, t, :, None, None] * x[:, t, :, :, None]
                    * Bm[:, t, None, None, :]))
        want.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t]))
    got = reference.ssd(x, dt, A, Bm, Cm, L=16)
    assert torch.allclose(got, torch.stack(want, 1), atol=1e-10)


@pytest.mark.parametrize("name", ["mamba2-smoke", "mla-moe-smoke"])
def test_prefill_agrees_with_the_port(name):
    from repro_torch.serving import decode
    port, flat = smoke(name)
    flat32 = {k: v.float() for k, v in flat.items()}
    cfg = common.program_config(port)
    tokens = traffic.Arrivals(PREFILL_MIX, port["vocab_size"], 3).prompts(
        3, 150)
    got = decode.make_prefill_step(cfg)(weights.tree(port, flat32), tokens)
    (gap,), top = reference.prefill(flat32, port, tokens,
                                    [got.argmax(-1)])
    with reference.exact_float32():
        W = reference.Weights(flat32)
        x = reference.hidden(W, port, torch.as_tensor(tokens).long(),
                             reference.F32)
        want = reference.logits(x, W, port, reference.F32)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    assert gap[0] < 1e-4
    assert torch.equal(top, want.argmax(-1))


def test_training_agrees_with_the_port():
    from repro_torch.models import transformer as tr
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    port, flat = smoke("mamba2-smoke")
    flat32 = {k: v.float() for k, v in flat.items()}
    adamw = opt.AdamWConfig(**TRAIN_MIX["adamw"])
    params = weights.tree(port, {k: v.clone() for k, v in flat32.items()})
    state = {"params": params, "opt": opt.init_state(params, adamw)}
    step = ts.make_train_step(common.program_config(port), ts.TrainConfig(
        adamw=adamw, remat=True, compressed_grads=True))
    rows, feed = dtrain.data(TRAIN_MIX, port["vocab_size"], 5)
    names = list(flat32)
    prog = {"loss": [], "grad": {}, "change": {}}
    seen = []
    for i in range(3):
        batch = next(feed)
        seen.append(dtrain.row_ids(rows, batch))
        state, m = step(state, batch)
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            prog["grad"] = {k: float(t.norm()) / (1 - adamw.b1) for k, t in
                            zip(names, tr.tree_leaves(state["opt"].m))}
    prog["change"] = {k: float((t - flat32[k]).norm()) for k, t in
                      zip(names, tr.tree_leaves(state["opt"].master))}
    assert len({i for ids in seen for i in ids}) == 12   # rows all differ
    ref = reference.train(flat, port, [rows[ids] for ids in seen],
                          TRAIN_MIX["adamw"], True)
    gaps = dtrain.compare(prog, ref)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3


def test_quantised_matches_the_port():
    from repro_torch.training.grad_compression import _quant_leaf
    g = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    e = torch.randn(1000, generator=torch.Generator().manual_seed(2)) * 1e-3
    want = _quant_leaf(g, e)
    got = reference.quantised(g, e)
    assert torch.equal(got[0], want[0]) and torch.allclose(got[1], want[1])


def test_control_reads_apart_from_the_program_at_smoke_size():
    """bf16 program against the control (the reference in e4m3): the
    control's mean argmax gap is at least three times the program's."""
    from perfbench import control
    from repro_torch.serving import decode
    port, flat = smoke("mla-moe-smoke", "bfloat16")
    mix = dict(PREFILL_MIX, per_cycle=1, length_min=64, length_max=64)
    plan = traffic.Arrivals(mix, port["vocab_size"], 9)
    tokens = plan.until(1.0)[0].tokens[None]
    top = decode.make_prefill_step(common.program_config(port))(
        weights.tree(port, flat), tokens).argmax(-1)
    (prog,), _ = reference.prefill(flat, port, tokens, [top])
    out = control.prefill_controls(port, mix, {"requests": 1}, 9,
                                   torch.device("cpu"))
    assert out["control"]["argmax_gap_mean"] > 3 * prog[1]
    assert out["altered"]["argmax_gap"] > 3 * prog[0]


def test_training_control_reads_apart_from_the_program_at_smoke_size(
        smoke_bench):
    """The bf16 program's median-leaf gradient gap against the control's
    (the reference in e4m3) and against half of each batch left out."""
    import time
    from perfbench import control, harness
    seed = 41
    out = harness.run("mamba2-smoke-train", seed, 0.1, False, device="cpu",
                      t_start=time.perf_counter(), bench=smoke_bench,
                      root=DATA, data=DATA)
    port, _ = smoke("mamba2-smoke", "bfloat16")
    low = control.train_controls(port, TRAIN_MIX, {"steps": 3}, seed,
                                 torch.device("cpu"))
    prog = out["checks"]["grad_gap_median"]["value"]
    assert low["control"]["grad_gap_median"] > 3 * prog
    assert low["half_batch"]["grad_gap"] > 10 * out["checks"]["grad_gap"][
        "value"]

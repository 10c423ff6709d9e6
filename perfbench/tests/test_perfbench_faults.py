"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, each fault a cell of its kind can
have planted in the program, and the control (the reference in float8)
put in the program's place, at smoke size on the CPU. The smoke cells'
limits (``data/cells``) were set from CPU readings of 8 sound seeds and
3 control seeds at that size, as the real cells' are on the card."""

import time
from pathlib import Path

import pytest
import torch

from perfbench import harness

DATA = Path(__file__).resolve().parent / "data"
SEED = 2 ** 33 + 17


def run(bench, cell):
    return harness.run(cell, SEED, 0.2, False, device="cpu",
                       t_start=time.perf_counter(), bench=bench, root=DATA,
                       data=DATA)


def unchanged_state(ts, tr, make):
    def broken(cfg, tcfg, mesh=None):
        def step(state, batch):
            with torch.no_grad():
                loss = ts._loss(state["params"], ts._on_device(
                    batch, tr.tree_leaves(state["params"])[0].device), cfg)
            return state, {"loss": loss, "step": state["opt"].step}
        return step
    return broken


def half_batch(ts, tr, make):
    def broken(cfg, tcfg, mesh=None):
        real = make(cfg, tcfg, mesh)
        return lambda state, batch: real(
            state, {k: v[:len(v) // 2] for k, v in batch.items()})
    return broken


def altered_answer(make):
    def broken(cfg, mesh=None):
        real = make(cfg, mesh)

        def step(params, tokens, context=None):
            logits = real(params, tokens, context)
            logits[:, 1, 3] = logits.max() + 1.0
            return logits
        return step
    return broken


def half_answers(make):
    def broken(cfg, mesh=None):
        real = make(cfg, mesh)

        def step(params, tokens, context=None):
            logits = real(params, tokens, context)
            logits[len(logits) // 2:] = 0.0
            return logits
        return step
    return broken


CELLS = ["mamba2-smoke-train", "mla-moe-smoke-prefill"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(smoke_bench, cell):
    out = run(smoke_bench, cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("fault", [unchanged_state, half_batch])
def test_training_faults_are_caught(smoke_bench, monkeypatch, fault):
    from repro_torch.models import transformer as tr
    from repro_torch.training import train_step as ts
    monkeypatch.setattr(ts, "make_train_step",
                        fault(ts, tr, ts.make_train_step))
    out = run(smoke_bench, "mamba2-smoke-train")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [altered_answer, half_answers])
def test_prefill_faults_are_caught(smoke_bench, monkeypatch, fault):
    from repro_torch.serving import decode
    monkeypatch.setattr(decode, "make_prefill_step",
                        fault(decode.make_prefill_step))
    out = run(smoke_bench, "mla-moe-smoke-prefill")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
@pytest.mark.parametrize("cell", CELLS)
def test_control_in_the_programs_place_is_not_correct(smoke_bench, cell,
                                                      seed):
    """The reference in float8 put in the program's place: the harness's
    own decision, at the cell's limits, reads it as not correct."""
    from perfbench import bench as bn, control, modelcfg, reference
    w = bn.workload(smoke_bench, cell)
    port = modelcfg.port_of(bn.config_file(smoke_bench, w["config"], DATA))
    mix = bn.traffic_file(w["traffic"], DATA)
    with control.substituted(mix["kind"], port, mix, reference.FP8):
        out = harness.run(cell, seed, 0.2, False, device="cpu",
                          t_start=time.perf_counter(), bench=smoke_bench,
                          root=DATA, data=DATA)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_smoke_cells_run_on_the_card(smoke_bench, cell):
    """The same drivers with the program's CUDA kernels at smoke size:
    every number finite, the device the card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = harness.run(cell, SEED, 0.5, True, device="cuda",
                      t_start=time.perf_counter(), bench=smoke_bench,
                      root=DATA, data=DATA)
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert all(c["value"] < float("inf") for c in out["checks"].values())

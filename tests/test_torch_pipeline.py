"""The PyTorch port's placement pipeline as a whole.

* End to end: the port's ``PlacementEngine`` on the CPU with the device
  backends against ``repro``'s with the Pallas kernels in interpret mode,
  with one fitted predictor carried across (never two truth-mode runs,
  whose decompression times are wall-clock): identical tiers and schemes,
  cents within rel 1e-6, for the Default, greedy SCOPe and capacitated
  SCOPe variants. The predictor is fitted on seeded decompression labels
  (``_seeded_measure``) in place of wall-clock ones, so what it predicts,
  and so whether tight capacities are feasible, does not depend on how
  loaded the machine is.
* The copied data generator gives the same tables, queries and partitions.
* No jax: every ``repro_torch`` module imports with ``jax`` and ``repro``
  blocked.
* No fallback: asking for CUDA where there is none raises.
"""

import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _torch_parity import predictor_arrays

import repro_torch
from repro.core import compredict as jcp
from repro.core import scope as jscope
from repro.core.costs import azure_table as j_azure
from repro.data import tpch as jtpch
from repro_torch import convert
from repro_torch.core import compredict as tcp
from repro_torch.core import datapart as tdp
from repro_torch.core import engine as tengine
from repro_torch.core import ml as tml
from repro_torch.core import optassign as topt
from repro_torch.core import scope as tscope
from repro_torch.core.costs import azure_table as t_azure
from repro_torch.data import tpch as ttpch
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ("Default (store on premium)", "SCOPe (No capacity constraint)",
            "SCOPe (Total cost focused)")


# decompression seconds per GB around which the seeded labels lie, by
# codec (medians of one CPU's wall-clock measurements of these samples)
DSPEED_S_PER_GB = {"zlib-1": 9.4, "zlib-6": 9.2, "zstd-3": 5.2, "zstd-19": 5.6,
                   "lzma-1": 38.2, "quant8": 3.8}


def _seeded_measure(seed=0):
    """``repro``'s codec ``measure`` with its wall-clock decompression time
    replaced by a seeded label: the codec's typical speed times a factor
    drawn uniformly from [0.7, 1.4], one draw per call in call order. The
    ratio is measured as before (it does not depend on time)."""
    rng = np.random.default_rng(seed)
    measure = jcp.measure

    def seeded(codec, raw, repeats=1):
        m = measure(codec, raw, repeats)
        label = DSPEED_S_PER_GB.get(codec.name, 10.0) * rng.uniform(0.7, 1.4)
        return dataclasses.replace(
            m, decompress_sec_per_gb=0.0 if codec.name == "none" else label)

    return seeded


@pytest.fixture(scope="module")
def inputs():
    jdb = jtpch.generate(scale_rows=900, seed=0)
    jqs = jtpch.generate_queries(jdb, n_per_template=3, seed=1)
    jparts, jrows = jtpch.partitions_from_queries(jdb, jqs)
    tdb = ttpch.generate(scale_rows=900, seed=0)
    tqs = ttpch.generate_queries(tdb, n_per_template=3, seed=1)
    tparts, trows = ttpch.partitions_from_queries(tdb, tqs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcp, "measure", _seeded_measure())
        jpred = jcp.CompressionPredictor(model_name="SVR").fit(
            jcp.query_samples(jqs, jdb.tables, max_rows=6000)[:40],
            layouts=("col",))
    tpred = convert.predictor_from_arrays(predictor_arrays(jpred))
    total = sum(p.span for p in jparts) / 1e9
    return dict(jdb=jdb, jqs=jqs, jparts=jparts, jrows=jrows, tdb=tdb,
                tqs=tqs, tparts=tparts, trows=trows, jpred=jpred,
                tpred=tpred, total=total)


def _configs(inputs, name, cap_mult):
    cap = np.array([0.163, 0.326, 0.4891, np.inf]) * inputs["total"] * cap_mult
    jcfg = dataclasses.replace(
        jscope.paper_variants(cap)[name], predictor=inputs["jpred"],
        partition_backend="interpret", feature_backend="pallas")
    tcfg = dataclasses.replace(
        tscope.paper_variants(cap)[name], predictor=inputs["tpred"],
        partition_backend="device", feature_backend="device", device="cpu")
    return jcfg, tcfg


@pytest.mark.parametrize("name,cap_mult", [
    (VARIANTS[0], 3.0), (VARIANTS[1], 3.0), (VARIANTS[2], 3.0),
    (VARIANTS[2], 1.2)])
def test_engine_matches_repro_end_to_end(inputs, name, cap_mult):
    jcfg, tcfg = _configs(inputs, name, cap_mult)
    jplan = jscope.PlacementEngine(j_azure(), jcfg).run(
        inputs["jparts"], inputs["jrows"])
    tplan = tscope.PlacementEngine(t_azure(), tcfg).run(
        inputs["tparts"], inputs["trows"])
    jr, tr = jplan.report, tplan.report
    assert tr.n_partitions == jr.n_partitions
    np.testing.assert_array_equal(tplan.problem.spans_gb,
                                  jplan.problem.spans_gb)
    np.testing.assert_allclose(tplan.problem.R, jplan.problem.R, rtol=1e-5)
    np.testing.assert_array_equal(tplan.assignment.tier, jplan.assignment.tier)
    np.testing.assert_array_equal(tplan.assignment.scheme,
                                  jplan.assignment.scheme)
    assert tr.tiering_scheme == jr.tiering_scheme
    assert tr.total_cents == pytest.approx(jr.total_cents, rel=1e-6)


def test_tight_capacity_case_runs_the_dual_ascent(inputs, monkeypatch):
    calls = []
    scan = topt._lagrangian_scan
    monkeypatch.setattr(topt, "_lagrangian_scan",
                        lambda *a: calls.append(1) or scan(*a))
    _, tcfg = _configs(inputs, VARIANTS[2], 1.2)
    rep = tscope.run_pipeline(inputs["tparts"], inputs["trows"], t_azure(),
                              tcfg)
    assert calls and rep.assignment.feasible


def test_device_backends_reach_the_ops(inputs, monkeypatch):
    seen = []
    for fn in ("fractional_overlap_matrix", "weighted_entropy_features"):
        orig = getattr(ops, fn)
        monkeypatch.setattr(ops, fn, lambda *a, _o=orig, _n=fn, **k:
                            seen.append(_n) or _o(*a, **k))
    _, tcfg = _configs(inputs, VARIANTS[1], 3.0)
    tscope.run_pipeline(inputs["tparts"], inputs["trows"], t_azure(), tcfg)
    assert seen.count("fractional_overlap_matrix") == 1
    assert seen.count("weighted_entropy_features") == 3   # one per class


def test_tpch_copy_generates_identical_inputs(inputs):
    jdb, tdb = inputs["jdb"], inputs["tdb"]
    assert sorted(jdb.tables) == sorted(tdb.tables)
    for name, jt in jdb.tables.items():
        tt = tdb.tables[name]
        assert list(jt.columns) == list(tt.columns)
        for c in jt.columns:
            np.testing.assert_array_equal(tt.columns[c], jt.columns[c])
    assert [(q.template_id, q.table, q.files) for q in inputs["tqs"]] == \
        [(q.template_id, q.table, q.files) for q in inputs["jqs"]]
    assert [(p.files, p.rho, p.span) for p in inputs["tparts"]] == \
        [(p.files, p.rho, p.span) for p in inputs["jparts"]]
    assert sorted(inputs["trows"]) == sorted(inputs["jrows"])
    for f, (t, idx) in inputs["jrows"].items():
        np.testing.assert_array_equal(inputs["trows"][f][1], idx)
        assert inputs["trows"][f][0].name == t.name


def test_scope_config_defaults_match_repro():
    j, t = jscope.ScopeConfig(), tscope.ScopeConfig()
    for f in dataclasses.fields(t):
        if f.name == "device":
            assert t.device == "cuda"
            continue
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            tv, jv = dataclasses.asdict(tv), dataclasses.asdict(jv)
        assert tv == jv, f.name


def test_every_module_imports_without_jax_or_repro():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            f"import importlib\nfor n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
            "assert not bad, bad\nprint('ok', len(sys.argv))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(names) >= 15


def _no_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_POINTS = {
    "resolve": lambda: repro_torch.device.resolve("cuda"),
    "engine": lambda: tscope.PlacementEngine(t_azure(), tscope.ScopeConfig()),
    "run_pipeline": lambda: tscope.run_pipeline([], {}, t_azure(),
                                                tscope.ScopeConfig()),
    "greedy_assign": lambda: topt.greedy_assign(np.ones((2, 2, 2)),
                                                np.ones((2, 2, 2), bool)),
    "capacitated_assign": lambda: topt.capacitated_assign(
        np.ones((2, 2, 2)), np.ones((2, 2, 2), bool), np.ones((2, 2, 2)),
        np.ones(2)),
    "extract_features_batch": lambda: tcp.extract_features_batch(
        [], "col", "weighted_entropy", "device"),
    "g_part": lambda: tdp.g_part([], 1.0, backend="device"),
    "ops.fractional_overlap_matrix": lambda: ops.fractional_overlap_matrix(
        np.zeros((1, 1), np.int32), np.ones(1), np.ones(1)),
    "ops.weighted_entropy_features": lambda: ops.weighted_entropy_features(
        np.zeros((1, 1), np.int32), [1], [1], [1], np.ones(1)),
    "budgeted_moves": lambda: topt.budgeted_moves(
        np.ones(20), np.ones(20), 3.0, method="greedy"),
    "MLP": lambda: tml.MLP(),
    "train_eval": lambda: tcp.train_eval(
        tcp.LabeledSet(np.ones((4, 2)), np.ones(4), np.ones(4), "zlib-6",
                       "col", "weighted_entropy"), "Averaging", "ratio"),
    "compredict_rd_fn": lambda: tengine.compredict_rd_fn(None, {}),
    "model_from_arrays NeuralNetwork": lambda: convert.model_from_arrays(
        {"model": "NeuralNetwork", "hidden": (4,), "task": "reg",
         "n_classes": 2, "params": [], "mu": 0.0, "sd": 1.0, "ymu": 0.0,
         "ysd": 1.0}),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_cuda_request_without_cuda_raises(entry, monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[entry]()


def test_chip_smoke_refuses_to_run_without_a_card():
    """Where PyTorch sees no card the script fails before printing a
    result line."""
    code = ("import sys, torch\ntorch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\nimport runpy\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

"""The harness finds every cell's files by name from BENCHMARK.json, and
the files keep the shape BENCHMARK.json's readers expect."""

import json
import math
import re
from pathlib import Path

import pytest
import torch

from perfbench import bench as bn
from perfbench import modelcfg, weights

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
BENCH = bn.load_bench(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CATALOG = {"mla-moe-16b": {
    "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
    "moe_intermediate_size": 1408, "n_routed_experts": 64,
    "n_shared_experts": 2, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27,
    "num_key_value_heads": 16, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "vocab_size": 102400,
    "first_k_dense_replace": 1, "rope_theta": 10000, "rms_norm_eps": 1e-06,
    "norm_topk_prob": False, "rope_scaling": {
        "beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "type": "yarn"}}}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    w = bn.workload(BENCH, cell)
    port = modelcfg.port_of(bn.config_file(BENCH, w["config"], ROOT))
    mix = bn.traffic_file(w["traffic"])
    spec = bn.cell_file(cell)
    assert (bn.HERE / "drivers" / f"{mix['kind']}.py").exists()
    assert set(spec["limits"]) and spec["check"]
    e2e = bn.metrics_for(BENCH, cell, trace=False)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2
    layer = bn.metrics_for(BENCH, cell, trace=True)
    assert layer
    for m in e2e + layer:
        assert callable(bn.reader(m["name"]))
    assert port["d_model"] > 0


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[key]}) == len(BENCH[key])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


def config(name: str) -> dict:
    """A configuration file under ``perfbench/configs``, whether or not a
    cell of BENCHMARK.json uses it yet."""
    return bn.load_json(bn.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", sorted(CATALOG))
def test_catalog_numbers_kept(name):
    f = config(name)
    for k, v in CATALOG[name].items():
        assert f[k] == v, k
    assert not any(k.endswith(("_dim", "_rank")) for k in f["runs"])


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_reduced_names_every_setting_changed(entry):
    f = bn.config_file(BENCH, entry["name"], ROOT)
    assert set(f.get("runs", {})) == set(entry["reduced"])
    assert not any(k.endswith(("_dim", "_rank")) for k in entry["reduced"])


@pytest.mark.parametrize("name", ["mamba2-780m", "mla-moe-16b"])
def test_weights_laid_out_as_the_program_draws_them(name):
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import MetaGenerator
    from perfbench.drivers import common
    port = modelcfg.port_of(config(name))
    cfg = common.program_config(port)
    meta = tr.init_params(MetaGenerator(), cfg, device="meta")
    want = [(p, tuple(t.shape), t.dtype) for p, t in
            zip(weights.paths(meta), tr.tree_leaves(meta))]
    got = [(p, tuple(s), d) for p, s, d, _, _ in weights.leaf_specs(port)]
    assert got == want


def test_parameter_counts():
    """mamba2-780m: 48 blocks of 14,644,112 (published widths: in_proj
    1536 x (2 * 3072 + 2 * 128 + 48), conv, A_log, D, dt_bias, the gated
    norm, out_proj, the block's norm) and the tied embedding of 50,304
    rows; the released checkpoint's 50,288 rows are 16 fewer."""
    count = lambda name: sum(math.prod(s) for _, s, _, _, _ in
                             weights.leaf_specs(modelcfg.port_of(
                                 config(name))))
    block = (1536 * (2 * 3072 + 256 + 48) + 4 * (3072 + 256) + 3072 + 256
             + 3 * 48 + 3072 + 3072 * 1536 + 1536)
    assert count("mamba2-780m") == 48 * block + 50304 * 1536 + 1536
    assert count("mla-moe-16b") == 15_706_484_224


@pytest.mark.parametrize("name", ["mamba2-780m", "mla-moe-16b"])
def test_port_refuses_settings_it_does_not_run(name):
    f = config(name)
    width = "hidden_size" if "hidden_size" in f else "d_model"
    depth = "num_hidden_layers" if "num_hidden_layers" in f else "n_layer"
    with pytest.raises(ValueError):
        modelcfg.port_of(dict(f, **{width: 4096}))
    with pytest.raises(ValueError):
        modelcfg.port_of(dict(f, **{depth: f[depth] - 1}))
    with pytest.raises(ValueError):
        modelcfg.port_of(dict(f, runs={}))


def test_same_seed_same_weights():
    port = modelcfg.port_of(bn.load_json(DATA / "configs" /
                                         "mla-moe-smoke.json"))
    a = weights.make_flat(port, 2 ** 40 + 3, "cpu")
    b = weights.make_flat(port, 2 ** 40 + 3, "cpu")
    c = weights.make_flat(port, 2 ** 40 + 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])

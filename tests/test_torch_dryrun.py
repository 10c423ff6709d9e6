"""The port's dry run (``analysis/``, ``launch/dryrun.py``) against the JAX
package's.

* ``model_flops``, ``active_params`` and ``count_params`` of all ten
  configs at full size: the port's meta-device trees against
  ``jax.eval_shape`` of the reference's;
* a rank's parameter, ZeRO-1 and cache bytes at both production meshes
  (``dryrun.rank_state`` over a fake process group of 256 or 512 ranks,
  in a subprocess) against the reference's per-device shard bytes, from
  its spec trees and ``NamedSharding.shard_shape``;
* ``op_stats``: a matrix product's FLOPs and bytes, a pointwise op adding
  no bytes, collectives counted by kind (over a fake group, in a
  subprocess);
* the mini dry run of ``tests/test_distributed.py``
  (``test_mini_dryrun_multipod_mesh``: qwen3-4b smoke, train, a (2, 2, 2)
  mesh) gives collective bytes and FLOPs a device within 5% of the
  reference's ``hlo_stats`` on its compiled HLO;
* the CLI on one cell writes its record.

No process group starts in the pytest process; fake ones start in
subprocesses (``_torch_dist.run_py``), each with a timeout.
"""

import json
import math
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_dist import ROOT, _env, run_jax, run_py
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.analysis import roofline as jrl
from repro.configs.registry import get_config as j_config
from repro.distributed import sharding as jsh
from repro.launch import shapes as jshapes
from repro_torch.analysis import op_stats
from repro_torch.analysis import roofline as trl
from repro_torch.configs.registry import arch_names, get_config as t_config
from repro_torch.launch import shapes as tshapes

ARCHS = arch_names()
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_match_the_reference(arch):
    jc, tc = j_config(arch), t_config(arch)
    jtotal = jrl.count_params(jshapes.param_structs(jc, 16))
    ttotal = trl.count_params(tshapes.param_structs(tc, 16))
    assert ttotal == jtotal > 0
    assert trl.active_params(tc, ttotal) == jrl.active_params(jc, jtotal)
    active = trl.active_params(tc, ttotal)
    for name, sc in tshapes.SHAPES.items():
        assert trl.model_flops(tc, sc.kind, sc.batch, sc.seq, ttotal,
                               active) == jrl.model_flops(
            jc, sc.kind, sc.batch, sc.seq, jtotal, active), name


RANK_BYTES = """
import json
from repro_torch.configs.registry import arch_names, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import applicable
mesh = dryrun.production_mesh({multi_pod})
out = {{}}
for arch in arch_names():
    cfg = get_config(arch)
    state, _ = dryrun.rank_state(cfg, "train_4k", mesh)
    rec = dryrun.rank_bytes(state)
    for shape in ("decode_32k", "long_500k"):
        if applicable(cfg, shape)[0]:
            state, _ = dryrun.rank_state(cfg, shape, mesh)
            rec[shape] = dryrun.rank_bytes(state)["cache"]
    out[arch] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def rank_bytes():
    """{mesh name: {arch: the port's rank-0 bytes}}, one fake group a mesh."""
    return {name: json.loads(run_py(RANK_BYTES.format(
        multi_pod=name == "pod2x16x16"), timeout=300).splitlines()[-1])
        for name in MESHES}


def _shard_bytes(structs, specs, amesh) -> int:
    """Bytes of one device's shards of ``structs`` under ``specs``."""
    sizes = jax.tree.leaves(jax.tree.map(
        lambda s, p: math.prod(NamedSharding(amesh, p).shard_shape(s.shape))
        * np.dtype(s.dtype).itemsize, structs, specs,
        is_leaf=lambda x: isinstance(x, P)))
    return int(sum(sizes))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_equal_the_reference_shards(rank_bytes, arch, mesh_name):
    """Rank 0's parameter, ZeRO-1 (master, m, v over 'data') and cache
    bytes equal one device's shards of the reference's trees."""
    shape, names = MESHES[mesh_name]
    amesh = AbstractMesh(shape, names)
    cfg = j_config(arch)
    structs = jshapes.param_structs(cfg, 16)
    specs = jsh.param_specs(structs, cfg, 16)
    got = rank_bytes[mesh_name][arch]
    assert got["params"] == _shard_bytes(structs, specs, amesh) > 0
    f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, np.float32),
                       structs)
    z = jsh.zero1_specs(specs, structs, "data", 16)
    assert got["opt"] == 3 * _shard_bytes(f32, z, amesh) > 0
    for name in ("decode_32k", "long_500k"):
        if not jshapes.applicable(cfg, name)[0]:
            assert name not in got
            continue
        sc = jshapes.SHAPES[name]
        cache = jshapes.input_specs(cfg, name, 16)["cache"]
        cspecs = jsh.cache_specs(cfg, amesh, batch=sc.batch)
        assert got[name] == _shard_bytes(cache, cspecs, amesh) > 0, name


# ------------------------------------------------------------- op_stats
def test_matmul_counts_its_flops_and_bytes():
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, dtype=torch.float32, device="meta")
    st = op_stats.analyze(torch.matmul, a, b)
    assert st.flops == 2 * 64 * 32 * 16
    assert st.hbm_bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert st.coll_bytes == 0 and st.n_collectives == 0


def test_pointwise_ops_add_no_bytes_and_reductions_do():
    x = torch.empty(128, 256, dtype=torch.bfloat16, device="meta")
    st = op_stats.analyze(lambda t: (t * 2 + 1).exp().relu(), x)
    assert st.flops == 0 and st.hbm_bytes == 0
    st = op_stats.analyze(lambda t: t.sum(-1), x)
    assert st.hbm_bytes == 2 * (128 * 256 + 128)
    st = op_stats.analyze(lambda t: t[:, :64], x)     # a window: read + write
    assert st.hbm_bytes == 2 * 2 * 128 * 64


COLLECTIVES = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.analysis import op_stats
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)

def step():
    x = torch.empty(8, 4, device="meta")
    dist.all_reduce(x)
    dist.all_gather([torch.empty(8, 4, device="meta") for _ in range(4)], x)
    dist.all_gather_into_tensor(torch.empty(32, 4, device="meta"), x)
    dist.reduce_scatter_tensor(torch.empty(2, 4, device="meta"), x)
    dist.all_to_all_single(torch.empty(8, 4, device="meta"), x)
    dist.send(x, dst=1)

st = op_stats.analyze(step)
print(json.dumps(st.__dict__))
dist.destroy_process_group()
"""


def test_collectives_are_counted_by_kind_over_a_fake_group():
    st = json.loads(run_py(COLLECTIVES, timeout=120).splitlines()[-1])
    assert st["coll_by_kind"] == {"all-reduce": 128.0, "all-gather": 256.0,
                                  "reduce-scatter": 128.0,
                                  "all-to-all": 128.0,
                                  "collective-permute": 128.0}
    assert st["n_collectives"] == 6 and st["coll_bytes"] == 768.0
    assert st["hbm_bytes"] == 2 * 768.0 and st["flops"] == 0.0


# ------------------------------------------------------ the mini dry run
# tests/test_distributed.py's mini dry run takes a batch of 8 x 64. The
# reference's CPU attention (repro/kernels/ref.py flash_attention_ref)
# pads the keys to its 512-key chunk, so at 64 its HLO holds eight times
# the attention's work; at 512 tokens both count the same work.
MINI_BATCH = (8, 512)

MINI_PORT = f"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.analysis import op_stats, roofline as rl
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.layers import MetaGenerator
from repro_torch.training import train_step as ts
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_test_mesh(data=2, model=2, pod=2)
cfg = get_config("qwen3-4b", smoke=True)
tcfg = ts.TrainConfig(remat=True)
state = ts.init_train_state(MetaGenerator(), cfg, tcfg, 2, mesh,
                            device="meta")
batch = {{k: torch.empty({MINI_BATCH}, dtype=torch.int32, device="meta")
         for k in ("tokens", "labels")}}
st = op_stats.analyze(ts.train_step, state, batch, cfg, tcfg, mesh)
roof = rl.roofline_terms(st, mesh.size(), 1e9)
print(json.dumps({{"coll": rl.collective_bytes(st), "flops": roof.flops,
                  "dominant": roof.dominant}}))
dist.destroy_process_group()
"""

MINI_JAX = f"""
import jax, jax.numpy as jnp, functools, json
from jax.sharding import PartitionSpec as P
from repro.analysis import hlo_stats
from repro.configs.registry import get_config
from repro.distributed import ctx
from repro.distributed.sharding import batch_specs, param_specs, to_named
from repro.launch.mesh import make_test_mesh
from repro.training import train_step as ts
from repro.training.optimizer import AdamWState

cfg = get_config("qwen3-4b", smoke=True)
mesh = make_test_mesh(data=2, model=2, pod=2)
tcfg = ts.TrainConfig(remat=True)
state = jax.eval_shape(lambda k: ts.init_train_state(k, cfg, tcfg, 2),
                       jax.random.PRNGKey(0))
batch = {{k: jax.ShapeDtypeStruct({MINI_BATCH}, jnp.int32)
         for k in ("tokens", "labels")}}
p_specs = param_specs(state["params"], cfg, 2)
s_specs = {{"params": p_specs,
           "opt": AdamWState(step=P(), master=p_specs, m=p_specs, v=p_specs,
                             err=None)}}
with ctx.activate(mesh):
    fn = functools.partial(ts.train_step, cfg=cfg, tcfg=tcfg)
    lowered = jax.jit(fn, in_shardings=(to_named(s_specs, mesh),
                                        to_named(batch_specs(cfg, mesh),
                                                 mesh))).lower(state, batch)
print(json.dumps({{"flops": hlo_stats.analyze(lowered.compile().as_text())
                  .flops}}))
"""


def test_mini_dryrun_matches_the_reference_flops():
    port = json.loads(run_py(MINI_PORT, timeout=300).splitlines()[-1])
    ref = json.loads(run_jax(MINI_JAX, timeout=600).splitlines()[-1])
    assert port["coll"]["total"] > 0 and port["coll"]["count"] > 0
    assert port["coll"]["all-reduce"] > 0 and port["coll"]["all-gather"] > 0
    assert port["dominant"] in ("compute", "memory", "collective")
    assert abs(port["flops"] - ref["flops"]) <= 0.05 * ref["flops"], \
        (port["flops"], ref["flops"])


def test_cli_writes_one_cell(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-small", "--shape", "decode_32k", "--multi-pod", "single",
         "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=300, env=_env(), cwd=str(ROOT))
    assert res.returncode == 0, res.stdout + res.stderr
    rec = json.loads((tmp_path / "whisper-small__decode_32k__pod16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256, rec
    assert set(rec["rank_bytes"]) == {"params", "opt", "cache"}
    assert rec["rank_bytes"]["cache"] > 0 and rec["rank_bytes"]["opt"] == 0
    assert rec["params_total"] == rec["params_active"] > 0
    roof = rec["roofline"]
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert roof["flops"] > 0 and roof["collective_s"] > 0
    assert rec["collective_bytes"]["total"] == roof["coll_bytes"] > 0
    assert "temporary" in rec["memory_note"]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-4b", "--shape", "long_500k", "--multi-pod", "multi",
         "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=300, env=_env(), cwd=str(ROOT))
    assert res.returncode == 0, res.stdout + res.stderr
    rec = json.loads((tmp_path / "qwen3-4b__long_500k__pod2x16x16.json")
                     .read_text())
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]

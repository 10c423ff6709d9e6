"""The port's meshes and sharding rules against the JAX package's.

The spec trees are metadata: ``param_specs``, ``cache_specs``,
``batch_specs`` and ``zero1_specs`` of ``repro_torch.distributed.sharding``
equal ``repro.distributed.sharding``'s leaf for leaf, for all ten configs
at tp 1, 2 and 16, parameters from ``jax.eval_shape`` of the reference's
``init_params`` on one side and the port's meta-device ``init_params`` on
the other, caches and batches given one stand-in mesh (``axis_names`` and
``shape`` are all either package reads). No process group is needed for
them. The meshes themselves need one: the production shapes (256 and 512
ranks) exist here only over a fake process group, started in a
subprocess, never in the pytest process.
"""

import json

import jax
import pytest
import torch
from _torch_dist import run_py
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs.registry import get_config as j_config
from repro.distributed import sharding as jsh
from repro.models import transformer as jtr
from repro_torch.configs.registry import arch_names, get_config as t_config
from repro_torch.distributed import ctx
from repro_torch.distributed import sharding as tsh
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import MetaGenerator

ARCHS = arch_names()


class StandIn:
    """What both packages read of a mesh: axis names and sizes."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


def _pairs(j, t, path=""):
    """(path, reference leaf, port leaf) of two trees walked together."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), path
        for k in j:
            yield from _pairs(j[k], t[k], f"{path}/{k}")
    elif j is None or t is None:
        assert j is None and t is None, path
    elif isinstance(j, (tuple, list)) and not isinstance(j, tsh.Spec) \
            and not isinstance(t, tsh.Spec):
        assert isinstance(t, (tuple, list)) and len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, j, t


def _same_specs(j_tree, t_tree):
    n = 0
    for path, a, b in _pairs(j_tree, t_tree):
        assert isinstance(a, P) and isinstance(b, tsh.Spec), path
        assert tuple(a) == tuple(b), (path, a, b)
        n += 1
    return n


def _params(arch, tp):
    jc, tc = j_config(arch), t_config(arch)
    jp = jax.eval_shape(lambda k: jtr.init_params(k, jc, tp),
                        jax.random.PRNGKey(0))
    tp_ = ttr.init_params(MetaGenerator(), tc, tp, device="meta")
    for path, a, b in _pairs(jp, tp_):
        assert tuple(a.shape) == tuple(b.shape), (path, a.shape, b.shape)
    return jc, tc, jp, tp_


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match_the_reference(arch):
    for tp in (1, 2, 16):
        jc, tc, jp, tp_ = _params(arch, tp)
        js, ts = jsh.param_specs(jp, jc, tp), tsh.param_specs(tp_, tc, tp)
        n = _same_specs(js, ts)
        assert n == len(jax.tree.leaves(jp)) == len(ttr.tree_leaves(tp_))
        for dp in (2, 16):
            _same_specs(jsh.zero1_specs(js, jp, "data", dp),
                        tsh.zero1_specs(ts, tp_, "data", dp))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_the_reference(arch):
    jc, tc = j_config(arch), t_config(arch)
    for tp in (1, 2, 16):
        for mesh in (StandIn(data=16, model=tp),
                     StandIn(pod=2, data=16, model=tp)):
            for batch in (None, 1, 32, 128):
                _same_specs(jsh.cache_specs(jc, mesh, batch),
                            tsh.cache_specs(tc, mesh, batch))
                for kind in ("train", "decode"):
                    _same_specs(jsh.batch_specs(jc, mesh, kind, batch),
                                tsh.batch_specs(tc, mesh, kind, batch))
                assert jsh._dp(mesh, batch) == tsh._dp(mesh, batch)


def test_cache_spec_tree_mirrors_the_cache():
    """``cache_specs`` has one spec per cache tensor, of its rank."""
    for arch in ARCHS:
        cfg = t_config(arch)
        cache = ttr.init_cache(cfg, 4, 64, device="meta")
        specs = tsh.cache_specs(cfg, StandIn(data=2, model=2))
        for path, s, t in _pairs(specs, cache):
            assert len(s) == t.dim(), (arch, path, s, t.shape)


def test_placements_name_each_mesh_dimension():
    mesh = StandIn(pod=2, data=16, model=16)
    from torch.distributed.tensor import Replicate, Shard
    assert tsh.placements(tsh.Spec(("pod", "data"), None, "model"), mesh) \
        == (Shard(0), Shard(0), Shard(2))
    assert tsh.placements(tsh.Spec(None, None), mesh) == (Replicate(),) * 3
    tree = tsh.to_named({"a": tsh.Spec("model"), "b": None}, mesh)
    assert tree == {"a": (Replicate(), Replicate(), Shard(0)), "b": None}


def test_ctx_without_a_mesh_is_one_device():
    assert ctx.mesh() is None and ctx.dp_axes() is None
    assert ctx.model_axis_size() == 1 and ctx.model_rank() == 0
    assert ctx.dp_size() == 1 and ctx.dp_rows(5) == slice(0, 5)
    x = torch.ones(2, 3, 4)
    assert ctx.constrain(x, tsh.Spec(None, "model", None)) is x
    assert ctx.constrain_sp(x) is x
    assert not ctx.batch_is_split()


PRODUCTION = """
import json
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as lm
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import MetaGenerator

world = {world}
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
mesh = lm.make_production_mesh(multi_pod=world == 512, device_type="cpu")
out = {{"names": mesh.mesh_dim_names, "shape": list(mesh.shape),
        "dp": lm.dp_axes(mesh), "tp": lm.tp_size(mesh)}}
try:
    lm.make_test_mesh(data=2, model=2)
except ValueError as e:
    out["refused"] = str(e)
cfg = get_config("{arch}")
params = ttr.init_params(MetaGenerator(), cfg, 16, device="meta")
named = tsh.to_named(tsh.param_specs(params, cfg, 16), mesh)
local = {{}}
def walk(p, n, path):
    if isinstance(p, dict):
        for k in p:
            walk(p[k], n[k], path + "/" + k)
    elif isinstance(p, (tuple, list)):
        for i, (a, b) in enumerate(zip(p, n)):
            walk(a, b, path + "/" + str(i))
    else:
        d = distribute_tensor(p, mesh, list(n))
        local[path] = list(d.to_local().shape)
walk(params, named, "")
out["local"] = local
print(json.dumps(out))
"""


@pytest.mark.parametrize("world,shape,names", [
    (256, [16, 16], ["data", "model"]),
    (512, [2, 16, 16], ["pod", "data", "model"])])
def test_production_meshes_over_a_fake_group(world, shape, names):
    """``make_production_mesh`` over fake groups of 256 and 512 ranks: the
    reference's shapes and axis names, a test mesh of the wrong size
    refused, and every yi-9b parameter's per-rank shape under
    ``to_named``'s placements (DTensor) equal to what the reference's
    ``NamedSharding`` gives a shard of it."""
    arch = "yi-9b"
    out = json.loads(run_py(PRODUCTION.format(world=world, arch=arch),
                            timeout=300).splitlines()[-1])
    assert out["shape"] == shape and out["names"] == names
    assert out["dp"] == [a for a in names if a != "model"] and out["tp"] == 16
    assert "4 ranks" in out["refused"] and str(world) in out["refused"]
    cfg = j_config(arch)
    jp = jax.eval_shape(lambda k: jtr.init_params(k, cfg, 16),
                        jax.random.PRNGKey(0))
    amesh = AbstractMesh(tuple(shape), tuple(names))
    specs = jsh.param_specs(jp, cfg, 16)
    n = 0
    for path, leaf, spec in _pairs(jp, specs):
        if isinstance(leaf, P):
            continue
        want = NamedSharding(amesh, spec).shard_shape(leaf.shape)
        assert out["local"][path] == list(want), path
        n += 1
    assert n == len(out["local"]) > 0


MESH_FROM_ENV = """
import torch.distributed as dist
from repro_torch.launch import mesh as lm
mesh, dev = lm.launch_mesh({data}, {model}, "cpu")
print(None if mesh is None else (dist.get_backend(), dist.get_world_size(),
      mesh.mesh_dim_names, tuple(mesh.shape)), dev)
"""


def test_launch_mesh_starts_groups_from_the_environment(tmp_path):
    """Outside torchrun a 1 x 1 mesh is one device with no group and a
    wider one is refused; under torchrun's variables (a world of one, its
    store on a port the OS picks) the group is gloo on the CPU and a mesh
    wider than the world is refused; without them
    ``init_process_group_from_env`` starts a group of one; --data-mesh 0
    is refused."""
    out = run_py(MESH_FROM_ENV.format(data=1, model=1))
    assert out.split() == ["None", "cpu"]
    with pytest.raises(AssertionError, match="needs 2 ranks: start them "
                                             "with torchrun"):
        run_py(MESH_FROM_ENV.format(data=1, model=2))
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT="0")
    out = run_py(MESH_FROM_ENV.format(data=1, model=1), **env)
    assert "('gloo', 1, ('data', 'model'), (1, 1)) cpu" in out
    with pytest.raises(AssertionError, match="needs 2 ranks; the process "
                                             "group has 1"):
        run_py(MESH_FROM_ENV.format(data=2, model=1), **env)
    out = run_py("""
        import torch.distributed as dist
        from repro_torch.launch import mesh as lm
        print(lm.init_process_group_from_env("cpu"), dist.get_backend(),
              dist.get_world_size(), lm.make_test_mesh().mesh_dim_names)
    """)
    assert out.split() == ["cpu", "gloo", "1", "('data',", "'model')"]
    with pytest.raises(AssertionError, match="production 16 x 16"):
        run_py(MESH_FROM_ENV.format(data=0, model=1))

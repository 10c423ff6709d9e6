"""The placement system over a mesh: G-PART's overlap matrix in row slabs,
the fleet scan's tenant axis and checkpoint restore onto a mesh, held
against the port on one device and against the JAX package on 8 host
devices.

The port's side runs as four gloo ranks (``_torch_dist.run_ranks``, one
call for the module), over meshes whose first dimension has 4, 2 and 1
ranks; the reference's in one JAX subprocess (``run_jax``). Both read
inputs made here and write their results beside them. Checks:

* the sharded overlap matrix equals the unsharded one bit for bit (N not
  dividing the ranks included, and through ``PartitionStage`` under an
  active mesh), is within 1e-6 of the reference's sharded matrix (as
  ``tests/test_distributed.py`` holds that one), and ``g_part`` over the
  mesh gives the reference's partitions;
* the sharded fleet scan's cells equal the unsharded scan's bit for bit
  with binding group and shared caps and T padded to the ranks, and with
  finite group caps on the first rank's tenants only, and so do the
  plans; on the uncoupled fleet of ROADMAP queue 3 the cells equal
  the reference's sharded scan at all 200 steps and the plans after the
  host finish are the reference's;
* ``FleetEngine(mesh=)`` plans as ``FleetEngine()`` does;
* each rank's pieces from ``restore(mesh=, shardings=)`` equal
  ``shard_leaf`` of the whole restore and the reference's addressable
  shards of ``restore(mesh=, shardings=)``; refusals raise ``ValueError``.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch
from _torch_dist import run_jax, run_ranks
from test_torch_fleet import (ENGINE_CASES, _cols, _fleet, _fleet_use,
                              _problems, _scan_args, _two_providers)

from repro_torch.checkpoint import manager as tman
from repro_torch.configs.registry import get_config as t_config
from repro_torch.core import costs as tcosts
from repro_torch.core import datapart as tdp
from repro_torch.core import engine as teng
from repro_torch.core import fleet as tfleet
from repro_torch.core import optassign as topt
from repro_torch.models import transformer as ttr
from repro_torch.storage.store import TieredStore as TStore
from repro_torch.training import optimizer as topt_state

#: mesh name -> (data, model): first dimensions of 4, 2 and 1 ranks
MESHES = {"4": (4, 1), "2x2": (2, 2), "1x4": (1, 4)}
#: the graphs also run through the reference ("wide" only holds the port's
#: slabs to its whole matrix)
REF_GRAPHS = ("random", "windows")
RESTORE_MESH = "2x2"


# ------------------------------------------------------------------ inputs
def _graphs():
    """Three G-PART instances: ``tests/test_distributed.py``'s recipe,
    contiguous windows over a shared file universe, and 217 partitions
    over 1,732 files with sizes spread over decades, where one BLAS product
    of every row would add some pairs' sizes in another order than a
    slab's product does."""
    out = {}
    rng = np.random.default_rng(0)
    files = [f"t/{i}" for i in range(50)]
    sizes = {f: float(rng.random() * 3 + 0.2) for f in files}
    qf = [(tuple(rng.choice(files, size=int(rng.integers(2, 7)),
                            replace=False)), float(rng.random() * 5 + 0.5))
          for _ in range(30)]
    out["random"] = (qf, sizes)
    rng = np.random.default_rng(3)
    sizes = {f"s{i}": float(rng.uniform(0.5, 2.0)) for i in range(90)}
    w = rng.integers(2, 9, 39)
    lo = rng.integers(0, 90 - 9, 39)
    out["windows"] = ([(tuple(f"s{j}" for j in range(lo[k], lo[k] + w[k])),
                        float(rng.uniform(0.5, 8.0))) for k in range(39)],
                      sizes)
    rng = np.random.default_rng(5)
    files = [f"w{i}" for i in range(1732)]
    sizes = {f: float(rng.lognormal(0, 3)) for f in files}
    out["wide"] = ([(tuple(rng.choice(files, size=int(rng.integers(2, 40)),
                                      replace=False)),
                     float(rng.uniform(0.5, 8.0))) for _ in range(217)],
                   sizes)
    return out


def _canon(parts):
    return sorted((tuple(sorted(p.files)), round(p.rho, 9)) for p in parts)


def _coupled_fleet():
    """T 11 (no mesh here divides it) with group rows and a binding shared
    cap: the (fleet, solver keywords)."""
    fleet = _fleet(8, (12, 30, 17, 24, 6, 40, 22, 9, 15, 7, 11),
                   binding=True)
    unc = topt.capacitated_assign_batch(*_cols(fleet), device="cpu")
    use = _fleet_use(fleet, unc.assignments)
    scap = np.full(4, np.inf)
    scap[use.argmax()] = 0.7 * use.max()
    tot = [0.4 * s[:, :2].max(2).sum() for _, _, s, _ in fleet]
    return fleet, dict(shared_tier_groups=np.arange(4),
                       shared_capacity_gb=scap,
                       tier_groups=np.array([0, 0, 1, 1]),
                       group_capacity_gb=[np.array([g, np.inf])
                                          for g in tot])


def _grouped_fleet():
    """T 5 with group rows whose caps are finite for the first two tenants
    only and no shared cap: over 4 ranks (and 2) the ranks past the first
    hold only tenants or dummies with unbounded group caps."""
    fleet = _fleet(8, (12, 30, 17, 24, 6), binding=True)
    tot = [0.4 * s[:, :2].max(2).sum() for _, _, s, _ in fleet]
    return fleet, dict(tier_groups=np.array([0, 0, 1, 1]),
                       group_capacity_gb=[
                           np.array([g if t < 2 else np.inf, np.inf])
                           for t, g in enumerate(tot)])


def _uncoupled_fleet():
    """ROADMAP queue 3's uncoupled test fleet (``tests/test_torch_fleet.py``
    ``test_fleet_scan_parts_from_the_reference_only_by_its_sum_order``)."""
    return _fleet(8, (12, 30, 17, 24, 6, 40, 22, 9), binding=True), {}


def _engine_fleets():
    """FleetEngine cases: capacitated, and provider caps shared across the
    fleet that bind: {case: (table, cfg, fleet keywords, problems)}."""
    out = {}
    table_fn, cfg_kw, Ns, seed, K = ENGINE_CASES["capacitated"]
    cfg = teng.ScopeConfig(device="cpu", **cfg_kw)
    table = table_fn(tcosts)
    out["capacitated"] = (table, cfg, {},
                          _problems(teng, table, cfg, Ns, seed, K))
    table = _two_providers(tcosts)
    cfg = teng.ScopeConfig(device="cpu", schemes=("none", "lz4"))
    probs = _problems(teng, table, cfg, (5, 8, 6, 7, 3), 8, 2)
    plan = tfleet.FleetEngine(table, cfg).solve(probs)
    prov = np.asarray(table.provider_of_tier, int)
    use_p = np.zeros(2)
    for p in plan.plans:
        np.add.at(use_p, prov[p.assignment.tier.astype(int)], p.stored_gb)
    big = int(use_p.argmax())
    out["provider_caps"] = (table, cfg, dict(fleet_provider_capacity_gb={
        table.provider_names[big]: 0.7 * use_p[big]}), probs)
    return out


def _checkpoint():
    """A qwen3-4b smoke training state (weights at tp 2, AdamW state with
    random moments) saved through the port's manager in 16 KiB shards:
    (the tree, the store's objects as plain dicts)."""
    cfg = t_config("qwen3-4b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    params = ttr.init_params(gen, cfg, 2, device="cpu")
    st = topt_state.init_state(params, topt_state.AdamWConfig())
    rnd = lambda t: torch.randn(t.shape, generator=gen)
    tree = {"params": params,
            "opt": st._replace(m=ttr.tree_map(rnd, st.m),
                               v=ttr.tree_map(rnd, st.v))}
    store = TStore()
    keep = tman.SHARD_BYTES
    tman.SHARD_BYTES = 16 << 10
    try:
        tman.CheckpointManager(store, device="cpu").save(1, tree,
                                                         blocking=True)
    finally:
        tman.SHARD_BYTES = keep
    objs = {k: dataclasses.asdict(o) for k, o in store._objs.items()}
    return tree, objs


# --------------------------------------------------------------- the runs
RANKS = r"""
import dataclasses, hashlib, pickle
import torch
from repro_torch.checkpoint import manager as tman
from repro_torch.configs.registry import get_config
from repro_torch.core import datapart as dp
from repro_torch.core import engine as eng
from repro_torch.core import fleet as fl
from repro_torch.core import optassign as opt
from repro_torch.distributed import ctx, sharding
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.storage import store as st
from repro_torch.training.optimizer import zero1_tree_specs

inp = pickle.load(open(TMP + "/inputs.pkl", "rb"))
meshes = {k: make_test_mesh(d, m) for k, (d, m) in inp["meshes"].items()}
out = {"overlap": {}, "gpart": {}, "stage": {}, "cells": {}, "plans": {},
       "engine": {}}
for g, (qf, sizes) in inp["graphs"].items():
    parts = dp.make_partitions(qf, sizes)
    idx = dp.PartitionIndex.from_partitions(parts)
    for k, m in meshes.items():
        out["overlap"][g, k] = idx.overlap_matrix("cpu", mesh=m)
        out["gpart"][g, k] = dp.g_part(parts, s_thresh=inp["s_thresh"][g],
                                       backend="device", device="cpu",
                                       mesh=m)
    # the stage's G-PART under an active mesh (tables left out: no rows)
    stage = eng.PartitionStage(eng.ScopeConfig(device="cpu",
                                               partition_backend="device"))
    stage._partition_tables = lambda merged, rows: []
    alone = stage(parts, {}).partitions
    ctx.collectives.clear()
    with ctx.activate(meshes["4"]):
        got = stage(parts, {}).partitions
    out["stage"][g] = (got, alone, dict(ctx.collectives))
for f, (args, fleet, kw) in inp["fleets"].items():
    for k, m in meshes.items():
        out["cells"][f, k] = opt._run_fleet_scan(m, *args)
        out["plans"][f, k] = opt.capacitated_assign_batch(
            *fleet, mesh=m, device="cpu", **kw)
for c, (table, cfg, kw, probs) in inp["engines"].items():
    out["engine"][c] = fl.FleetEngine(table, cfg, mesh=meshes["4"],
                                      **kw).solve(probs).fleet

# restore onto the 2 x 2 mesh, this rank's pieces
store = st.TieredStore()
store._objs = {k: st._Obj(**o) for k, o in inp["objs"].items()}
mesh = meshes[inp["restore_mesh"]]
like = inp["like"]
p_specs = sharding.param_specs(like["params"], get_config("qwen3-4b",
                                                          smoke=True), 2)
z = zero1_tree_specs(p_specs, like["params"], mesh)
specs = {"params": p_specs,
         "opt": like["opt"]._replace(step=sharding.Spec(), master=z, m=z,
                                     v=z)}
mgr = tman.CheckpointManager(store, device="cpu")
whole, _ = mgr.restore(like, device="cpu")
mine, step = mgr.restore(like, device="cpu", mesh=mesh, shardings=specs)
pieces, equal = {}, True
for (path, a), (_, w), (_, s) in zip(tman._leaf_paths(mine),
                                     tman._leaf_paths(whole),
                                     tman._leaf_paths(specs)):
    pieces[path] = hashlib.sha256(a.contiguous().numpy().tobytes()
                                  ).hexdigest()
    equal &= torch.equal(a, sharding.shard_leaf(w, s, mesh))
refused = []
odd = {"w": torch.zeros(3, 4)}
small = tman.CheckpointManager(st.TieredStore(), device="cpu")
small.save(1, odd, blocking=True)
for kw in (dict(mesh=mesh), dict(shardings={"w": sharding.Spec()}),
           dict(mesh=mesh, shardings={"w": sharding.Spec("data")})):
    try:
        small.restore(odd, device="cpu", **kw)
    except ValueError as e:
        refused.append(str(e))
out["restore"] = dict(pieces=pieces, equal=equal, step=step,
                      bytes=sharding.local_bytes(mine), refused=refused,
                      coords=[mesh.get_local_rank(a) for a in ("data",
                                                               "model")])
if RANK != 0:
    out = {"restore": out["restore"]}
pickle.dump(out, open(TMP + f"/rank{RANK}.pkl", "wb"))
"""

JAX = r"""
import hashlib, pickle, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
sys.path.insert(0, "tests")
from repro.checkpoint import manager as jman
from repro.configs.registry import get_config
from repro.core import datapart as dp
from repro.core import optassign as opt
from repro.distributed import sharding as jsh
from repro.launch.mesh import make_test_mesh
from repro_torch.storage import store as st

TMP = sys.argv[1]
inp = pickle.load(open(TMP + "/inputs.pkl", "rb"))
out = {"overlap": {}, "gpart": {}}
m4 = make_test_mesh(data=4)
for g in inp["ref_graphs"]:
    qf, sizes = inp["graphs"][g]
    parts = dp.make_partitions(qf, sizes)
    idx = dp.PartitionIndex.from_partitions(parts)
    out["overlap"][g] = np.asarray(idx.overlap_matrix("ref", mesh=m4))
    out["gpart"][g] = sorted(
        (tuple(sorted(p.files)), round(p.rho, 9)) for p in dp.g_part(
            parts, s_thresh=inp["s_thresh"][g], backend="jnp", mesh=m4))
m8 = make_test_mesh(data=8)
(m, s, cap, g_of_t, gcap, sg, scap, step, sstep, iters, _), fleet, kw = \
    inp["fleets"]["uncoupled"]
out["cells"] = np.asarray(opt._run_fleet_scan(
    m8, m, s, cap, gcap, g_of_t, sg, scap, sstep, step, iters))
plan = opt.capacitated_assign_batch(*fleet, mesh=m8, **kw)
out["plans"] = [(a.tier, a.scheme, a.feasible) for a in plan.assignments]

store = st.TieredStore()
store._objs = {k: st._Obj(**o) for k, o in inp["objs"].items()}
d, mo = inp["meshes"][inp["restore_mesh"]]
mesh = make_test_mesh(data=d, model=mo)
like = inp["like"]
p_specs = jsh.param_specs(like["params"], get_config("qwen3-4b",
                                                     smoke=True), 2)
z = jsh.zero1_specs(p_specs, like["params"], "data", d)
named = lambda t: jsh.to_named(t, mesh)
specs = {"params": named(p_specs),
         "opt": like["opt"]._replace(step=NamedSharding(mesh, P()),
                                     master=named(z), m=named(z),
                                     v=named(z))}
tree, _ = jman.CheckpointManager(store).restore(like, mesh=mesh,
                                                 shardings=specs)
shards = {}
for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
    shards[jax.tree_util.keystr(path)] = sorted(
        {hashlib.sha256(np.asarray(sh.data).tobytes()).hexdigest()
         for sh in a.addressable_shards})
out["restore"] = shards
pickle.dump(out, open(TMP + "/jax.pkl", "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs, the port unsharded here, the port's four ranks and the
    reference on 8 host devices."""
    tmp = tmp_path_factory.mktemp("placement_mesh")
    graphs = _graphs()
    s_thresh = {}
    for g, (qf, sizes) in graphs.items():
        parts = tdp.make_partitions(qf, sizes)
        s_thresh[g] = 2.5 * float(np.median([p.span for p in parts]))
    fleets = {}
    for name, (fleet, kw) in (("coupled", _coupled_fleet()),
                              ("grouped", _grouped_fleet()),
                              ("uncoupled", _uncoupled_fleet())):
        fleets[name] = (_scan_args(fleet, **kw), _cols(fleet), kw)
    engines = _engine_fleets()
    tree, objs = _checkpoint()
    host = lambda t: ttr.tree_map(lambda x: x.numpy(), t)
    like = {"params": host(tree["params"]),
            "opt": tree["opt"]._make(host(x) for x in tree["opt"])}
    inputs = dict(meshes=MESHES, graphs=graphs, ref_graphs=REF_GRAPHS,
                  s_thresh=s_thresh,
                  fleets=fleets, engines=engines, objs=objs, like=like,
                  restore_mesh=RESTORE_MESH)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    run_ranks(RANKS, 4, tmp, timeout=300)
    run_jax(JAX.replace("TMP = sys.argv[1]", f"TMP = {str(tmp)!r}"),
            timeout=600)
    ranks = [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(4)]
    ref = pickle.load(open(tmp / "jax.pkl", "rb"))
    one = {"overlap": {}, "gpart": {}, "cells": {}, "plans": {},
           "engine": {}}
    for g, (qf, sizes) in graphs.items():
        parts = tdp.make_partitions(qf, sizes)
        idx = tdp.PartitionIndex.from_partitions(parts)
        one["overlap"][g] = idx.overlap_matrix("cpu")
        one["gpart"][g] = tdp.g_part(parts, s_thresh=s_thresh[g],
                                     backend="device", device="cpu")
    for f, (args, fleet, kw) in fleets.items():
        one["cells"][f] = topt._fleet_scan(*args)
        one["plans"][f] = topt.capacitated_assign_batch(*fleet, device="cpu",
                                                        **kw)
    for c, (table, cfg, kw, probs) in engines.items():
        one["engine"][c] = tfleet.FleetEngine(table, cfg,
                                              **kw).solve(probs).fleet
    return dict(graphs=graphs, fleets=fleets, ranks=ranks, ref=ref, one=one,
                tree=tree)


def _identical(a, b):
    assert a.feasible == b.feasible and a.cost == b.cost
    assert len(a.assignments) == len(b.assignments)
    for x, y in zip(a.assignments, b.assignments):
        np.testing.assert_array_equal(x.tier, y.tier)
        np.testing.assert_array_equal(x.scheme, y.scheme)
        assert x.cost == y.cost and x.feasible == y.feasible
    if a.shared_use_gb is not None:
        np.testing.assert_array_equal(a.shared_use_gb, b.shared_use_gb)


# ------------------------------------------------------------------ G-PART
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("graph", ["random", "windows", "wide"])
def test_sharded_overlap_matrix_is_the_unsharded_one(runs, graph, mesh):
    """Bit for bit, at first dimensions of 4, 2 and 1 ranks (N 30, 39 and
    217: none divides by 4, 39 and 217 not by 2), and so are g_part's
    partitions."""
    got = runs["ranks"][0]["overlap"][graph, mesh]
    want = runs["one"]["overlap"][graph]
    n = len(tdp.make_partitions(*runs["graphs"][graph]))
    assert got.shape == want.shape == (n, n) and n % 4
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert _canon(runs["ranks"][0]["gpart"][graph, mesh]) == \
        _canon(runs["one"]["gpart"][graph])


@pytest.mark.parametrize("graph", REF_GRAPHS)
def test_sharded_overlap_matches_the_reference(runs, graph):
    """Within 1e-6 of the reference's matrix sharded over data 4, and
    g_part over the mesh gives the reference's partitions (its 'jnp'
    backend over the same mesh)."""
    got = runs["ranks"][0]["overlap"][graph, "4"]
    np.testing.assert_allclose(got, runs["ref"]["overlap"][graph],
                               rtol=1e-6, atol=1e-6)
    assert _canon(runs["ranks"][0]["gpart"][graph, "4"]) == \
        runs["ref"]["gpart"][graph]


@pytest.mark.parametrize("graph", ["random", "windows", "wide"])
def test_partition_stage_reads_the_active_mesh(runs, graph):
    """Under ``ctx.activate(mesh)`` the engine's PartitionStage spreads the
    overlap matrix over the mesh (one all-gather of its slabs) and merges
    the partitions it merges without one."""
    stage, alone, calls = runs["ranks"][0]["stage"][graph]
    assert calls == {"all_gather": 1}
    assert _canon(stage) == _canon(alone) and len(alone) < len(
        runs["one"]["overlap"][graph])


# ------------------------------------------------------------------- fleet
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_fleet_cells_and_plans_equal_one_device(runs, mesh):
    """Group rows and a binding shared cap, T 11 padded to the ranks: the
    sharded scan's cells are the unsharded scan's at every step, and the
    plans are the same."""
    got = runs["ranks"][0]["cells"]["coupled", mesh]
    want = runs["one"]["cells"]["coupled"]
    assert got.shape == want.shape and want.shape[1] == 11
    np.testing.assert_array_equal(got, want)
    plan = runs["ranks"][0]["plans"]["coupled", mesh]
    _identical(plan, runs["one"]["plans"]["coupled"])
    assert plan.feasible and plan.shared_use_gb is not None


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fleet_with_group_caps_on_some_ranks_equals_one_device(runs, mesh):
    """Finite group caps on the first rank's tenants only and no shared
    cap: every rank takes the same collectives (the ranks do not hang on
    each other), and the cells and plans are the unsharded ones."""
    args = runs["fleets"]["grouped"][0]
    gcap, scap = args[4], args[6]
    assert args[0].shape[0] == 5 and not np.isfinite(scap).any()
    assert np.isfinite(gcap[:2]).any() and not np.isfinite(gcap[2:]).any()
    np.testing.assert_array_equal(runs["ranks"][0]["cells"]["grouped", mesh],
                                  runs["one"]["cells"]["grouped"])
    plan = runs["ranks"][0]["plans"]["grouped", mesh]
    _identical(plan, runs["one"]["plans"]["grouped"])
    assert plan.feasible


def test_uncoupled_fleet_equals_the_reference_over_a_mesh(runs):
    """Queue 3's uncoupled fleet: the port's cells over 4 ranks (and 2)
    equal the reference's scan sharded over 8 host devices at all 200
    steps, and the plans after the host finish are the reference's."""
    want = runs["ref"]["cells"]
    assert want.shape[0] == 200
    for mesh in ("4", "2x2"):
        np.testing.assert_array_equal(
            runs["ranks"][0]["cells"]["uncoupled", mesh], want)
        plan = runs["ranks"][0]["plans"]["uncoupled", mesh]
        _identical(plan, runs["one"]["plans"]["uncoupled"])
        for a, (tier, scheme, feasible) in zip(plan.assignments,
                                               runs["ref"]["plans"]):
            np.testing.assert_array_equal(a.tier, tier)
            np.testing.assert_array_equal(a.scheme, scheme)
            assert a.feasible == feasible


@pytest.mark.parametrize("case", ["capacitated", "provider_caps"])
def test_fleet_engine_over_a_mesh_equals_one_device(runs, case):
    _identical(runs["ranks"][0]["engine"][case], runs["one"]["engine"][case])


# ----------------------------------------------------------------- restore
def test_restore_pieces_are_the_shards_and_the_references(runs):
    """Each rank's pieces equal ``shard_leaf`` of the whole restore; the
    four ranks' pieces of each leaf are the reference's addressable
    shards of the same restore; together they hold the whole state once
    over 'model' and, for the ZeRO-1 moments, once over 'data' too."""
    rs = [r["restore"] for r in runs["ranks"]]
    assert all(r["equal"] and r["step"] == 1 for r in rs)
    assert sorted(tuple(r["coords"]) for r in rs) == [(0, 0), (0, 1), (1, 0),
                                                      (1, 1)]
    ref = runs["ref"]["restore"]
    assert set(ref) == set(rs[0]["pieces"])
    for path, shas in ref.items():
        assert sorted({r["pieces"][path] for r in rs}) == shas, path
    whole = sum(t.numel() * t.element_size()
                for _, t in tman._leaf_paths(runs["tree"]))
    assert all(r["bytes"] < whole / 2 for r in rs), \
        ([r["bytes"] for r in rs], whole)


def test_restore_refuses_half_a_mesh_and_specs_that_do_not_divide(runs):
    for r in runs["ranks"]:
        refused = r["restore"]["refused"]
        assert len(refused) == 3
        assert all("mesh and shardings go together" in e
                   for e in refused[:2])
        assert "does not divide" in refused[2]

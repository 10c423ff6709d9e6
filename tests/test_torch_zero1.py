"""The train step at data 2 x model 4: tensor-parallel weights and ZeRO-1
optimizer state, against the JAX package's train step on the same mesh of
8 host devices (``tests/test_distributed.py``'s
``test_train_step_shards_and_matches_single_device`` case: qwen3-4b smoke
at tp 4, the state placed by ``param_specs`` and ``zero1_specs``), with
and without the int8 compressed mean; and every rank's parameter and
optimizer bytes against the reckoning from the specs and the reference's
per-device shards.

As in ``test_torch_distributed_train.py``, two steps run without the
global-norm clip (ROADMAP's hazards: JAX's jitted float32 global norm is
off by 1.9e-3 on a smoke model) at ``tests/test_distributed.py``'s
tolerances (loss rtol 2e-4, parameters within 5e-3); the port's global
norm over sharded leaves is held against the unsharded one separately.
The pytest process starts no process group.
"""

import pickle

import numpy as np
import pytest
from _torch_dist import run_jax, run_ranks

ARCH, BATCH, SEQ, STEPS, DATA, MODEL = "qwen3-4b", 8, 17, 2, 2, 4
COMP = [False, True]

JAX = """
import functools, math, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.registry import get_config
from repro.distributed import ctx
from repro.distributed.sharding import (batch_specs, param_specs, to_named,
                                        zero1_specs)
from repro.launch.mesh import make_test_mesh
from repro.training import optimizer as opt
from repro.training import train_step as ts

cfg = get_config("{arch}", smoke=True)
tok = jax.random.randint(jax.random.PRNGKey(1), ({batch}, {seq}), 0,
                         cfg.vocab_size)
labels = np.array(tok[:, 1:])
labels[:2, :6] = -1
batch = {{"tokens": tok[:, :-1], "labels": jnp.asarray(labels)}}
f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
nbytes = lambda t: sum(a.addressable_shards[0].data.nbytes
                       for a in jax.tree.leaves(t))
out = {{"batch": {{k: np.asarray(v) for k, v in batch.items()}}}}
mesh = make_test_mesh(data={data}, model={model})
for comp in {comps}:
    tcfg = ts.TrainConfig(remat=True, compressed_grads=comp,
                          adamw=opt.AdamWConfig(grad_clip=math.inf))
    state = ts.init_train_state(jax.random.PRNGKey(0), cfg, tcfg, tp={model})
    o = state["opt"]
    init = {{"params": f32(state["params"]),
            "opt": {{"step": int(o.step), "master": f32(o.master),
                    "m": f32(o.m), "v": f32(o.v), "err": None}}}}
    p_specs = param_specs(state["params"], cfg, {model})
    z = zero1_specs(p_specs, state["params"], "data", {data})
    s_specs = {{"params": p_specs,
               "opt": opt.AdamWState(step=P(), master=z, m=z, v=z, err=None)}}
    fn = functools.partial(ts.train_step, cfg=cfg, tcfg=tcfg,
                           mesh=mesh if comp else None)
    losses = []
    with ctx.activate(mesh):
        placed = jax.device_put(state, to_named(s_specs, mesh))
        shard_bytes = (nbytes(placed["params"]),
                       sum(nbytes(t) for t in (placed["opt"].master,
                                               placed["opt"].m,
                                               placed["opt"].v)))
        for i in range({steps}):
            s_specs["opt"] = s_specs["opt"]._replace(
                err=None if state["opt"].err is None else z)
            sh = (to_named(s_specs, mesh),
                  to_named(batch_specs(cfg, mesh), mesh))
            state, m = jax.jit(fn, in_shardings=sh)(
                jax.device_put(state, sh[0]), jax.device_put(batch, sh[1]))
            losses.append(float(m["loss"]))
    out[comp] = dict(init=init, losses=losses, params=f32(state["params"]),
                     shard_bytes=shard_bytes)
pickle.dump(out, open("{tmp}/zero_ref.pkl", "wb"))
print("OK")
"""

PORT = """
import math, pickle
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.distributed import ctx, sharding
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.shapes import rank_bytes
from repro_torch.models import transformer as tr
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

ref = pickle.load(open(TMP + "/zero_ref.pkl", "rb"))
cfg = get_config("{arch}", smoke=True)
mesh = make_test_mesh(data={data}, model={model})
out = {{}}
for comp in {comps}:
    tcfg = ts.TrainConfig(remat=True, compressed_grads=comp,
                          adamw=opt.AdamWConfig(grad_clip=math.inf))
    state = convert.train_state_from_arrays(ref[comp]["init"], cfg,
                                            device="cpu", mesh=mesh)
    init = ts.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                               {model}, mesh, device="cpu")
    got = dict(bytes=rank_bytes(cfg, mesh, state["params"], state["opt"]),
               init_bytes=rank_bytes(cfg, mesh, init["params"], init["opt"]),
               master_narrower=sum(
                   a.numel() < b.numel() for a, b in zip(
                       tr.tree_leaves(state["opt"].master),
                       tr.tree_leaves(state["params"]))))
    if not comp:        # the global norm of sharded leaves, counted once
        whole = convert.model_params_from_arrays(ref[comp]["init"]["params"],
                                                 cfg, device="cpu")
        batch = ts._on_device(ref["batch"], torch.device("cpu"))
        _, g1 = ts._value_and_grad(whole, batch, cfg, True)
        with ctx.activate(mesh):
            _, gm = ts._value_and_grad(state["params"], batch, cfg, True)
        specs = sharding.param_specs(state["params"], cfg, {model})
        got["norms"] = (float(opt.global_norm(tr.tree_leaves(g1))),
                        float(opt.global_norm(tr.tree_leaves(gm), specs,
                                              mesh)))
    step = ts.make_train_step(cfg, tcfg, mesh)
    losses = []
    for i in range({steps}):
        state, m = step(state, ref["batch"])
        losses.append(float(m["loss"]))
    want = convert.model_params_from_arrays(ref[comp]["params"], cfg,
                                            device="cpu", mesh=mesh)
    got.update(losses=losses, worst=max(
        float((a.float() - b.float()).abs().max()) for a, b in
        zip(tr.tree_leaves(state["params"]), tr.tree_leaves(want))),
        err_whole=None if state["opt"].err is None else all(
            e.shape == p.shape for e, p in zip(
                tr.tree_leaves(state["opt"].err),
                tr.tree_leaves(convert.model_params_from_arrays(
                    ref[comp]["params"], cfg, device="cpu")))))
    out[comp] = got
pickle.dump(out, open(TMP + f"/zero{{RANK}}.pkl", "wb"))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero1")
    fmt = dict(arch=ARCH, data=DATA, model=MODEL, steps=STEPS, comps=COMP)
    run_jax(JAX.format(batch=BATCH, seq=SEQ, tmp=tmp, **fmt))
    run_ranks(PORT.format(**fmt), DATA * MODEL, tmp, timeout=400)
    with open(tmp / "zero_ref.pkl", "rb") as f:
        ref = pickle.load(f)
    port = []
    for r in range(DATA * MODEL):
        with open(tmp / f"zero{r}.pkl", "rb") as f:
            port.append(pickle.load(f))
    return ref, port


@pytest.mark.parametrize("comp", COMP)
def test_train_step_at_data_2_model_4_with_zero1_matches_the_reference(
        results, comp):
    """Two steps on every rank: the losses within rtol 2e-4 and the rank's
    shards of the parameters within 5e-3 of the reference mesh's; with
    ``compressed_grads`` each sharded leaf gathered over 'model' for K3,
    the residual kept whole."""
    ref, port = results
    for got in port:
        g = got[comp]
        np.testing.assert_allclose(g["losses"], ref[comp]["losses"],
                                   rtol=2e-4)
        assert g["worst"] < 5e-3, f"param divergence {g['worst']}"
        assert g["master_narrower"] > 0        # ZeRO-1 slices over 'data'
        if comp:
            assert g["err_whole"] is True


@pytest.mark.parametrize("comp", COMP)
def test_rank_param_and_zero1_bytes_are_the_specs_and_the_references(
        results, comp):
    """Every rank's parameter bytes equal the reckoning from
    ``param_specs`` and the reference's per-device shard; its master,
    m and v bytes the reckoning from ``zero1_specs`` and the reference's
    per-device shards of its ZeRO-1 state; both for the reference's state
    carried over and for ``init_train_state(..., mesh=)``'s."""
    ref, port = results
    p_ref, o_ref = ref[comp]["shard_bytes"]
    for got in port:
        for b in (got[comp]["bytes"], got[comp]["init_bytes"]):
            assert b["params"] == b["params_reckoned"] == p_ref
            assert b["opt"] == b["opt_reckoned"] == o_ref


def test_global_norm_counts_replicated_leaves_once(results):
    """The global norm of a rank's sharded gradients (model-sharded
    leaves' squares summed over 'model', replicated leaves once) equals
    the unsharded gradient's, within rtol 1e-5."""
    _, port = results
    for got in port:
        whole, sharded = got[False]["norms"]
        assert sharded == pytest.approx(whole, rel=1e-5)

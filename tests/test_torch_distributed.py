"""The port's collectives over gloo ranks, against the JAX package on a
mesh of 8 host devices: the sequence-sharded decode, the int8 compressed
mean over the data axes, the GPipe pipeline and MoE routing per
data-parallel group.

Each test runs the reference in a JAX subprocess (``_torch_dist.run_jax``,
the pattern of ``tests/test_distributed.py``) and the port as gloo ranks
that meet through a file in ``tmp_path`` (``_torch_dist.run_ranks``);
both write their results there, and the comparison runs here at
``tests/test_distributed.py``'s tolerances. The pytest process starts no
process group.
"""

import pickle

import numpy as np
import pytest
import torch
from _torch_dist import run_jax, run_ranks

from repro_torch.kernels import quant_pack as tqp

ARCHS = ["yi-9b", "deepseek-v2-lite-16b"]
B, S, STEPS = 2, 32, 4

JAX_DECODE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import get_config
from repro.distributed import ctx
from repro.distributed.sharding import cache_specs, param_specs, to_named
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as tr

f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
out = {{}}
for arch in {archs}:
    cfg = get_config(arch, smoke=True)
    params = tr.init_params(jax.random.PRNGKey(0), cfg, tp=4)
    cache = tr.init_cache(cfg, {B}, max_seq={S}, tp=4)
    toks = jax.random.randint(jax.random.PRNGKey(1), ({B}, {STEPS}), 0,
                              cfg.vocab_size)
    step = jax.jit(lambda p, c, t, q: tr.decode_step(p, c, t, q, cfg))
    c, outs = cache, []
    for i in range({STEPS}):
        lg, c = step(params, c, toks[:, i:i+1], jnp.full(({B},), i, jnp.int32))
        outs.append(np.asarray(lg))
    mesh = make_test_mesh(data=2, model=4)
    p_sh = to_named(param_specs(params, cfg, 4), mesh)
    c_sh = to_named(cache_specs(cfg, mesh), mesh)
    t_sh = NamedSharding(mesh, P("data", None))
    q_sh = NamedSharding(mesh, P("data"))
    with ctx.activate(mesh):
        sstep = jax.jit(lambda p, c, t, q: tr.decode_step(p, c, t, q, cfg),
                        in_shardings=(p_sh, c_sh, t_sh, q_sh),
                        out_shardings=(None, c_sh))
        c2, outs2 = jax.device_put(cache, c_sh), []
        params_d = jax.device_put(params, p_sh)
        for i in range({STEPS}):
            lg, c2 = sstep(params_d, c2, jax.device_put(toks[:, i:i+1], t_sh),
                           jax.device_put(jnp.full(({B},), i, jnp.int32), q_sh))
            outs2.append(np.asarray(lg))
    out[arch] = dict(params=f32(params), toks=np.asarray(toks),
                     logits=np.stack(outs), mesh_logits=np.stack(outs2),
                     cache=f32(c))
pickle.dump(out, open("{tmp}/ref.pkl", "wb"))
print("OK")
"""

PORT_DECODE = """
import pickle
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.distributed import ctx
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer as tr
from repro_torch.serving import decode

ref = pickle.load(open(TMP + "/ref.pkl", "rb"))
mesh = make_test_mesh(data=2, model=4)
out = {{}}
for arch, r in ref.items():
    cfg = get_config(arch, smoke=True)
    params = convert.model_params_from_arrays(r["params"], cfg, device="cpu",
                                              mesh=mesh)
    cache = decode.init_cache(cfg, {B}, {S}, tp=4, mesh=mesh, device="cpu")
    step = decode.make_decode_step(cfg, mesh)
    ctx.reduced_on.clear()
    logits = []
    for i in range({STEPS}):
        lg, cache = step(params, cache, r["toks"][:, i:i + 1],
                         np.full(({B},), i, np.int32))
        logits.append(lg.numpy())
    want = decode.shard_cache(convert.model_params_from_arrays(
        r["cache"], cfg, device="cpu"), cfg, mesh)
    out[arch] = dict(
        logits=np.stack(logits), reduced=dict(ctx.reduced_on),
        local_cache=[t.numpy() for t in tr.tree_leaves(cache)],
        want_cache=[t.numpy() for t in tr.tree_leaves(want)])
pickle.dump(out, open(TMP + f"/port{{RANK}}.pkl", "wb"))
"""


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_sharded_decode_matches_the_reference(tmp_path):
    """Data 2 x model 4: each rank holds one row and 8 of the 32 slots of
    every cache, and its shards of the weights (``param_specs``); four
    decode steps of yi-9b (GQA) and deepseek-v2-lite (MLA's latent cache,
    MoE routed per data group) give the reference's logits, sharded and
    unsharded, within 2e-3 on every rank, and each rank's cache is its
    slice of the reference's cache."""
    run_jax(JAX_DECODE.format(archs=ARCHS, B=B, S=S, STEPS=STEPS,
                              tmp=tmp_path))
    run_ranks(PORT_DECODE.format(B=B, S=S, STEPS=STEPS), 8, tmp_path)
    ref = _load(tmp_path / "ref.pkl")
    for rank in range(8):
        port = _load(tmp_path / f"port{rank}.pkl")
        for arch in ARCHS:
            got, r = port[arch], ref[arch]
            assert got["logits"].shape == r["logits"].shape
            np.testing.assert_allclose(got["logits"], r["mesh_logits"],
                                       rtol=2e-3, atol=2e-3)
            np.testing.assert_allclose(got["logits"], r["logits"],
                                       rtol=2e-3, atol=2e-3)
            # every attention layer merged over the model axis, and the
            # logits gathered over the data axis
            assert got["reduced"]["cpu"] >= 2 * STEPS
            for a, b in zip(got["local_cache"], got["want_cache"]):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


JAX_MEAN = """
import jax, jax.numpy as jnp, numpy as np
from repro.distributed import ctx
from repro.launch.mesh import make_test_mesh
from repro.training.grad_compression import compressed_mean
mesh = make_test_mesh(data=4, model=2)
g = {{"w": jnp.asarray(np.load("{tmp}/g.npy"))}}
with ctx.mesh_context(mesh):
    red, err = compressed_mean(g, None, mesh, ("data",))
np.save("{tmp}/red_ref.npy", np.asarray(red["w"]))
np.save("{tmp}/err_ref.npy", np.asarray(err["w"]))
print("OK")
"""

PORT_MEAN = """
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.training.grad_compression import compressed_mean
mesh = make_test_mesh(data=4, model=2)
g = torch.as_tensor(np.load(TMP + "/g.npy"))
red, err = compressed_mean({"w": g}, None, mesh, ("data",))
# and gradients that differ by data rank: the mean of their dequantised
coord = mesh.get_local_rank("data")
g2 = {"w": g * (1 + coord)}
red2, err2 = compressed_mean(g2, None, mesh)
np.savez(TMP + f"/mean{RANK}.npz", red=red["w"].numpy(), err=err["w"].numpy(),
         red2=red2["w"].numpy(), err2=err2["w"].numpy())
"""


def test_compressed_mean_over_the_data_axes(tmp_path):
    """Data 4 x model 2, the same gradient on every rank (the reference's
    case: its psum runs over identical values): the mean is within
    |g|max / 127 of g, error feedback holds the residual (err + red == g),
    and it equals the reference's. With gradients that differ by data
    rank it is the mean of their dequantised values."""
    g = (np.random.default_rng(0).standard_normal((8, 256)) * 3.0
         ).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    run_jax(JAX_MEAN.format(tmp=tmp_path))
    run_ranks(PORT_MEAN, 8, tmp_path)
    red_ref = np.load(tmp_path / "red_ref.npy")
    err_ref = np.load(tmp_path / "err_ref.npy")
    deq = lambda x: tqp.quant_unpack(*tqp.quant_pack_plain(
        torch.as_tensor(x).reshape(-1))).reshape(x.shape).numpy()
    mean2 = np.mean([deq(g * (1 + c)) for c in range(4)], axis=0)
    for rank in range(8):
        out = np.load(tmp_path / f"mean{rank}.npz")
        red, err = out["red"], out["err"]
        assert np.abs(red - g).max() <= np.abs(g).max() / 127.0 + 1e-6
        np.testing.assert_allclose(err + red, g, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(red, red_ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(err, err_ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["red2"], mean2, rtol=1e-6, atol=1e-6)
        c = (rank // 2) + 1
        np.testing.assert_allclose(out["err2"] + deq(g * c), g * c,
                                   rtol=1e-5, atol=1e-5)


JAX_PIPE = """
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import pipeline_apply
from repro.launch.mesh import make_test_mesh
mesh = make_test_mesh(data=2, model=1, pod=4)
a = np.load("{tmp}/pipe.npz")
params = {{"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])}}
def stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])
out = pipeline_apply(stage, params, jnp.asarray(a["x"]), mesh=mesh,
                     axis="pod", microbatches=8)
np.save("{tmp}/pipe_ref.npy", np.asarray(out))
print("OK")
"""

PORT_PIPE = """
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch.mesh import make_test_mesh
mesh = make_test_mesh(data=2, model=1, pod=4)
a = np.load(TMP + "/pipe.npz")
s = mesh.get_local_rank("pod")
params = {"w": torch.as_tensor(a["w"][s]), "b": torch.as_tensor(a["b"][s])}
def stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])
out = pipeline_apply(stage, params, torch.as_tensor(a["x"]), mesh=mesh,
                     axis="pod", microbatches=8)
np.save(TMP + f"/pipe{RANK}.npy", out.numpy())
"""


def test_pipeline_matches_the_reference_and_sequential_stages(tmp_path):
    """GPipe over 4 stages (the 'pod' axis of a 4 x 2 x 1 mesh) and 8
    microbatches: every rank returns the reference pipeline's output and
    the four stages applied in turn, within 1e-5."""
    S, d = 4, 16
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, d, d)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((S, d)) * 0.1).astype(np.float32)
    x = rng.standard_normal((16, d)).astype(np.float32)
    np.savez(tmp_path / "pipe.npz", w=w, b=b, x=x)
    run_jax(JAX_PIPE.format(tmp=tmp_path))
    run_ranks(PORT_PIPE, 8, tmp_path)
    seq = x
    for s in range(S):
        seq = np.tanh(seq @ w[s] + b[s])
    ref = np.load(tmp_path / "pipe_ref.npy")
    for rank in range(8):
        out = np.load(tmp_path / f"pipe{rank}.npy")
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out, seq, rtol=1e-5, atol=1e-5)


BLK = 8
MOE_CFG = """
import dataclasses
cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b", smoke=True),
                          moe_block_tokens={blk}, capacity_factor=0.5)
"""

JAX_MOE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import get_config
from repro.distributed import ctx
from repro.launch.mesh import make_test_mesh
from repro.models import moe
""" + MOE_CFG + """
mesh = make_test_mesh(data=2, model=1)
p = moe.moe_init(jax.random.PRNGKey(0), cfg)
out = {{"params": jax.tree.map(np.asarray, p)}}
for shape in {shapes}:
    x = jax.random.normal(jax.random.PRNGKey(sum(shape)), shape + (cfg.d_model,))
    one = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg))(p, x)
    with ctx.activate(mesh):
        f = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg),
                    in_shardings=(jax.tree.map(
                        lambda _: NamedSharding(mesh, P()), p),
                        NamedSharding(mesh, P("data", None, None))))
        y = f(p, x)
    out[shape] = dict(x=np.asarray(x), mesh=np.asarray(y),
                      one=np.asarray(one))
pickle.dump(out, open("{tmp}/moe_ref.pkl", "wb"))
print("OK")
"""

PORT_MOE = """
import pickle
from repro_torch.configs.registry import get_config
from repro_torch.distributed import ctx
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe
""" + MOE_CFG + """
ref = pickle.load(open(TMP + "/moe_ref.pkl", "rb"))
p = {{k: (torch.as_tensor(v) if not isinstance(v, dict)
         else {{kk: torch.as_tensor(vv) for kk, vv in v.items()}})
     for k, v in ref["params"].items()}}
mesh = make_test_mesh(data=2, model=1)
out = {{}}
for shape in {shapes}:
    x = torch.as_tensor(ref[shape]["x"])
    with ctx.activate(mesh), ctx.split_batch(True):
        rows = ctx.dp_rows(shape[0])
        ctx.reduced_on.clear()
        y = moe.moe_apply(p, x[rows], cfg)
        out[shape] = dict(y=y.numpy(), rows=(rows.start, rows.stop),
                          gathered=ctx.reduced_on["cpu"])
pickle.dump(out, open(TMP + f"/moe{{RANK}}.pkl", "wb"))
"""


def test_moe_routes_per_data_group_as_the_reference_mesh(tmp_path):
    """Data 2, blocks of 8 tokens, capacity factor 0.5 (so capacity drops
    tokens). At T = 2 blk dp (4 x 8) each rank routes its own whole
    blocks, with no collective, and the reference's mesh forward is its
    single-device one. At T = 3 blk (2 x 12) the reference routes the
    whole global batch as one block on the mesh, which is not its single
    device's blocked routing: the ranks gather the tokens and give the
    mesh's output, within 1e-5."""
    shapes = [(4, 8), (2, 12)]
    run_jax(JAX_MOE.format(blk=BLK, shapes=shapes, tmp=tmp_path))
    run_ranks(PORT_MOE.format(blk=BLK, shapes=shapes), 2, tmp_path)
    ref = _load(tmp_path / "moe_ref.pkl")
    np.testing.assert_allclose(ref[(4, 8)]["mesh"], ref[(4, 8)]["one"],
                               rtol=1e-5, atol=1e-5)
    assert np.abs(ref[(2, 12)]["mesh"] - ref[(2, 12)]["one"]).max() > 1e-3
    for rank in range(2):
        port = _load(tmp_path / f"moe{rank}.pkl")
        for shape in shapes:
            got = port[shape]
            lo, hi = got["rows"]
            assert hi - lo == shape[0] // 2
            np.testing.assert_allclose(got["y"], ref[shape]["mesh"][lo:hi],
                                       rtol=1e-5, atol=1e-5)
        assert port[(4, 8)]["gathered"] == 0
        assert port[(2, 12)]["gathered"] > 0

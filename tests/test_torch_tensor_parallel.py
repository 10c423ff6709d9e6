"""Tensor-parallel weights (``param_specs``) over gloo ranks, against the
JAX package's mesh runs on 8 host devices: forward logits and four decode
steps of all ten smoke configs at data 1 x model 2; yi-9b and
deepseek-v2-lite at data 2 x model 4 (the reference's own
``test_decode_sharded_matches_single_device`` cases); qwen3-4b at model 4,
where its 2 KV heads do not divide and ``_rules`` replicates wk/wv; and
every rank's parameter bytes against the reckoning from the specs and the
reference's per-device shard bytes.

The reference runs once (``_torch_dist.run_jax``); the port runs as one
gloo group per mesh size (``_torch_dist.run_ranks``), each rank holding
its shards of the reference's weights (``convert.model_params_from_arrays
(..., mesh=)``) and its part of the cache (``serving.decode.init_cache``).
The pytest process starts no process group.
"""

import pickle

import numpy as np
import pytest
from _torch_dist import run_jax, run_ranks

ARCHS = ["gemma2-9b", "qwen3-4b", "qwen2-7b", "yi-9b", "zamba2-2.7b",
         "llama4-scout-17b-a16e", "deepseek-v2-lite-16b",
         "llama-3.2-vision-90b", "whisper-small", "mamba2-780m"]
# (arch, data, model)
CASES = [(a, 1, 2) for a in ARCHS] + [
    ("yi-9b", 2, 4), ("deepseek-v2-lite-16b", 2, 4), ("qwen3-4b", 1, 4)]
B, S, STEPS, MAX_SEQ = 2, 8, 4, 16
TOL = 2e-3

JAX = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.distributed import ctx
from repro.distributed.sharding import cache_specs, param_specs, to_named
from repro.launch.mesh import make_test_mesh
from repro.models import transformer as tr

f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
out = {{}}
for arch, data, model in {cases}:
    cfg = get_config(arch, smoke=True)
    params = tr.init_params(jax.random.PRNGKey(0), cfg, tp=model)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, ({B}, {S}))
    inputs = {{"tokens": toks}}
    if cfg.cross_context:
        inputs["context"] = rng.standard_normal(
            ({B}, cfg.cross_context, cfg.d_model)).astype(np.float32)
    if cfg.encoder_stages is not None:
        inputs["frames"] = rng.standard_normal(
            ({B}, cfg.encoder_context, cfg.d_model)).astype(np.float32)
    mesh = make_test_mesh(data=data, model=model)
    p_sh = to_named(param_specs(params, cfg, model), mesh)
    c_sh = to_named(cache_specs(cfg, mesh), mesh)
    with ctx.activate(mesh):
        pd = jax.device_put(params, p_sh)
        cx = inputs.get("context")
        if cfg.encoder_stages is not None:
            cx = jax.jit(lambda p, f: tr.encode(p, f, cfg))(
                pd, jnp.asarray(inputs["frames"]))
        cx = None if cx is None else jnp.asarray(cx)
        fwd = jax.jit(lambda p, t, c: tr.forward(p, t, cfg, context=c))(
            pd, jnp.asarray(toks), cx)
        step = jax.jit(lambda p, c, t, q, x: tr.decode_step(
            p, c, t, q, cfg, context=x), out_shardings=(None, c_sh))
        cache = jax.device_put(tr.init_cache(cfg, {B}, max_seq={max_seq},
                                             tp=model), c_sh)
        logits = []
        for i in range({steps}):
            lg, cache = step(pd, cache, jnp.asarray(toks[:, i:i + 1]),
                             jnp.full(({B},), i, jnp.int32), cx)
            logits.append(np.asarray(lg))
    nbytes = sum(a.addressable_shards[0].data.nbytes
                 for a in jax.tree.leaves(pd))
    out[(arch, data, model)] = dict(
        params=f32(params), inputs=inputs, forward=np.asarray(fwd),
        decode=np.stack(logits), shard_bytes=nbytes)
pickle.dump(out, open("{tmp}/ref.pkl", "wb"))
print("OK")
"""

PORT = """
import pickle
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.distributed import ctx, sharding
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.shapes import rank_bytes
from repro_torch.models import transformer as tr
from repro_torch.serving import decode

ref = pickle.load(open(TMP + "/ref.pkl", "rb"))
out = {{}}
for (arch, data, model), r in ref.items():
    if data * model != WORLD:
        continue
    cfg = get_config(arch, smoke=True)
    mesh = make_test_mesh(data=data, model=model)
    params = convert.model_params_from_arrays(r["params"], cfg,
                                              device="cpu", mesh=mesh)
    inputs = r["inputs"]
    toks = inputs["tokens"]
    ctx.reduced_on.clear()
    cx = inputs.get("context", inputs.get("frames"))
    fwd = decode.make_prefill_step(cfg, mesh)(params, toks, cx)
    if cfg.encoder_stages is not None:
        with ctx.activate(mesh):
            cx = tr.encode(params, torch.as_tensor(cx), cfg)
    cache = decode.init_cache(cfg, {B}, {max_seq}, mesh=mesh, device="cpu")
    step = decode.make_decode_step(cfg, mesh)
    logits = []
    for i in range({steps}):
        lg, cache = step(params, cache, toks[:, i:i + 1],
                         np.full(({B},), i, np.int32), cx)
        logits.append(lg.numpy())
    # init_params on the mesh: each block cut as it is drawn, the same
    # numbers as the whole draw's shards, each leaf in storage of its own
    gen = lambda: torch.Generator().manual_seed(3)
    whole = tr.init_params(gen(), cfg, model, device="cpu")
    cut = sharding.shard_tree(whole, sharding.param_specs(whole, cfg, model),
                              mesh)
    drawn = tr.init_params(gen(), cfg, model, mesh, device="cpu")
    a, b = tr.tree_leaves(drawn), tr.tree_leaves(cut)
    init_same = len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        and x.untyped_storage().nbytes() == x.numel() * x.element_size()
        for x, y in zip(a, b))
    del whole, cut, drawn, a, b
    out[(arch, data, model)] = dict(
        init_same=init_same, forward=fwd.numpy(), decode=np.stack(logits),
        reduced=dict(ctx.reduced_on), bytes=rank_bytes(cfg, mesh, params),
        cache_bytes=sharding.local_bytes(cache),
        cache_reckoned=sharding.reckoned_bytes(
            tr.init_cache(cfg, {B}, {max_seq}, tp=model, device="meta"),
            sharding.cache_specs(cfg, mesh, {B}), mesh))
pickle.dump(out, open(TMP + f"/port{{WORLD}}_{{RANK}}.pkl", "wb"))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    run_jax(JAX.format(cases=CASES, B=B, S=S, steps=STEPS, max_seq=MAX_SEQ,
                       tmp=tmp))
    code = PORT.format(B=B, steps=STEPS, max_seq=MAX_SEQ)
    for world in sorted({d * m for _, d, m in CASES}):
        run_ranks(code, world, tmp, timeout=400)
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    port = {}
    for world in sorted({d * m for _, d, m in CASES}):
        for r in range(world):
            with open(tmp / f"port{world}_{r}.pkl", "rb") as f:
                for case, got in pickle.load(f).items():
                    port.setdefault(case, []).append(got)
    return ref, port


def _ids(case):
    arch, data, model = case
    return f"{arch}-{data}x{model}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_and_decode_match_the_reference_mesh(results, case):
    """On every rank: the prefill's logits and four decode steps' logits
    within 2e-3 of the reference's mesh run, the layers' collectives run
    on the CPU tensors the ranks hold."""
    ref, port = results
    arch, data, model = case
    ranks = port[case]
    assert len(ranks) == data * model
    for got in ranks:
        np.testing.assert_allclose(got["forward"], ref[case]["forward"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["decode"], ref[case]["decode"],
                                   rtol=TOL, atol=TOL)
        assert set(got["reduced"]) == {"cpu"} and got["reduced"]["cpu"] > 0


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_rank_bytes_are_the_specs_and_the_references_shards(results, case):
    """A rank's parameter bytes equal the reckoning from ``param_specs``
    and the reference's per-device shard bytes (``addressable_shards[0]``
    after ``device_put`` by ``to_named``); its cache bytes equal the
    reckoning from ``cache_specs``."""
    ref, port = results
    for got in port[case]:
        b = got["bytes"]
        assert b["params"] == b["params_reckoned"]
        assert b["params"] == ref[case]["shard_bytes"]
        assert got["cache_bytes"] == got["cache_reckoned"]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_init_params_on_a_mesh_draws_each_ranks_shards(results, case):
    """``init_params(..., mesh=)``, which cuts each block to the rank's
    shards as it is drawn, gives every rank the same tensors as the
    shards of the whole seeded draw, each in storage of its own (no view
    keeps a whole leaf alive)."""
    _, port = results
    for got in port[case]:
        assert got["init_same"]

"""Every leaf's gradient under tensor parallelism, against ``jax.grad`` of
the JAX package's loss: the port's ranks hold their shards of the
reference's weights and compute the loss's gradient with remat, and each
rank's gradient of every leaf is held, normwise within 2e-4, against its
shard of the reference's whole gradient.

The cases cover every block kind and every replicated leaf that meets a
sharded region: at model 2 zamba2 (Mamba2 with B/C and its conv
replicated, the shared attention block), deepseek-v2-lite (MLA with
w_dkv and kv_norm replicated, MoE with its router and shared experts),
whisper (the encoder, cross-attention into it), llama-3.2-vision
(cross-attention into patch embeddings) and gemma2 (post-norms, softcaps,
a local window, tied embeddings); at model 4 qwen3 and llama4 (2 KV heads
over 4 ranks: wk/wv replicated; q_norm, k_norm; llama4's MoE) and a
Mamba2 whose 6 heads do not divide by 4 (the scan runs whole on every
rank). MoE cases replay the routing of an unsharded run of the port
(``moe.route``), so the ranks' sums in another order cannot flip a
near-tie. The pytest process starts no process group.
"""

import pickle

import pytest
from _torch_dist import run_jax, run_ranks

# (arch, model axis); "mamba-6-heads" is mamba2-780m (smoke) with
# mamba_expand 3 and mamba_headdim 64: d_inner 384, 6 heads
CASES = [("zamba2-2.7b", 2), ("deepseek-v2-lite-16b", 2),
         ("whisper-small", 2), ("llama-3.2-vision-90b", 2),
         ("gemma2-9b", 2), ("qwen3-4b", 4), ("llama4-scout-17b-a16e", 4),
         ("mamba-6-heads", 4)]
TOL = 2e-4

CFG = """
def config(name):
    if name == "mamba-6-heads":
        return get_config("mamba2-780m", smoke=True).scaled(
            mamba_expand=3, mamba_headdim=64)
    return get_config(name, smoke=True)
"""

JAX = """
import functools, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.models import transformer as tr
from repro.training import train_step as ts
""" + CFG + """
f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
out = {{}}
for name, model in {cases}:
    cfg = config(name)
    params = tr.init_params(jax.random.PRNGKey(0), cfg, tp=model)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 9))
    batch = {{"tokens": toks[:, :-1], "labels": toks[:, 1:]}}
    if cfg.cross_context:
        batch["context"] = rng.standard_normal(
            (2, cfg.cross_context, cfg.d_model)).astype(np.float32)
    if cfg.encoder_stages is not None:
        batch["frames"] = rng.standard_normal(
            (2, cfg.encoder_context, cfg.d_model)).astype(np.float32)
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        ts._loss, cfg=cfg)))(params, {{k: jnp.asarray(v)
                                      for k, v in batch.items()}})
    out[(name, model)] = dict(params=f32(params), batch=batch,
                              loss=float(loss), grads=f32(grads))
pickle.dump(out, open("{tmp}/grads_ref.pkl", "wb"))
print("OK")
"""

PORT = """
import pickle
from repro_torch import convert
from repro_torch.configs.registry import get_config
from repro_torch.distributed import ctx, sharding
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tr
from repro_torch.training import train_step as ts
""" + CFG + """
ref = pickle.load(open(TMP + "/grads_ref.pkl", "rb"))
route = moe.route
out = {}
for (name, model), r in ref.items():
    if model != WORLD:
        continue
    cfg = config(name)
    mesh = make_test_mesh(data=1, model=model)
    whole = convert.model_params_from_arrays(r["params"], cfg, device="cpu")
    specs = sharding.param_specs(whole, cfg, model)
    mine = tr.tree_map(lambda t: t.clone(),
                       sharding.shard_tree(whole, specs, mesh))
    batch = ts._on_device(r["batch"], torch.device("cpu"))
    seen = []
    if cfg.n_experts:
        def recording(logits, k):
            v, i = route(logits, k)
            seen.append(i)
            return v, i
        moe.route = recording           # with remat, as the sharded run
        ts._value_and_grad(whole, batch, cfg, True)
        it = iter(seen)
        moe.route = lambda logits, k: (lambda i: (logits.gather(-1, i), i))(
            next(it))
    ctx.reduced_on.clear()
    with ctx.activate(mesh):
        loss, grads = ts._value_and_grad(mine, batch, cfg, True)
    moe.route = route
    want = sharding.shard_tree(convert.model_params_from_arrays(
        r["grads"], cfg.scaled(dtype="float32"), device="cpu"), specs, mesh)
    errs = []
    for i, (g, w) in enumerate(zip(tr.tree_leaves(grads),
                                   tr.tree_leaves(want))):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        d = float((g.float() - w).norm() / w.norm().clamp_min(1e-30))
        errs.append((d, i, float(w.norm())))
    out[(name, model)] = dict(loss=float(loss), errs=errs,
                              replayed=len(seen),
                              reduced=dict(ctx.reduced_on))
pickle.dump(out, open(TMP + f"/grads{WORLD}_{RANK}.pkl", "wb"))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_grads")
    run_jax(JAX.format(cases=CASES, tmp=tmp))
    worlds = sorted({m for _, m in CASES})
    for world in worlds:
        run_ranks(PORT, world, tmp, timeout=400)
    with open(tmp / "grads_ref.pkl", "rb") as f:
        ref = pickle.load(f)
    port = {}
    for world in worlds:
        for r in range(world):
            with open(tmp / f"grads{world}_{r}.pkl", "rb") as f:
                for case, got in pickle.load(f).items():
                    port.setdefault(case, []).append(got)
    return ref, port


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-model{c[1]}")
def test_every_leaf_gradient_matches_jax_grad(results, case):
    """On every rank: the loss within rel 2e-5 of the reference's, and
    every leaf's gradient, sharded or replicated, normwise within 2e-4 of
    the rank's shard of ``jax.grad``'s (a replicated leaf whose ranks'
    partial gradients were not summed would be off by about half or
    three quarters)."""
    ref, port = results
    name, model = case
    assert len(port[case]) == model
    for got in port[case]:
        assert got["loss"] == pytest.approx(ref[case]["loss"], rel=2e-5)
        worst = max(got["errs"])
        assert worst[0] <= TOL, f"leaf {worst[1]}: normwise {worst[0]:.3e}"
        # most leaves have a gradient (an expert no token reached has none,
        # in both packages: its error above is then its norm over 1e-30)
        assert sum(n > 0 for _, _, n in got["errs"]) > len(got["errs"]) // 2
        assert got["reduced"]["cpu"] > 0
        if "deepseek" in name or "llama4" in name:
            assert got["replayed"] > 0

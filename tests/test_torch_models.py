"""PyTorch port of the model zoo's serving path, held against ``repro``:
layers, GQA and Mamba2 blocks, and ``forward`` plus four ``decode_step``s
(logits and caches) for all ten configs, the encoder, and ``forward`` and
``decode_step`` with a cross-attention context, with ``repro``'s weights
carried over by ``convert.model_params_from_arrays``. Inputs come from
numpy seeds; tolerance rel/abs 1e-4 (float32; the sums run in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import leaf_shapes, model_param_arrays

from repro.configs.registry import get_config as j_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs.registry import get_config as t_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import transformer as ttr

TOL = dict(rtol=1e-4, atol=1e-4)
COVERED = ("zamba2-2.7b", "mamba2-780m", "qwen3-4b", "qwen2-7b", "yi-9b",
           "gemma2-9b", "llama4-scout-17b-a16e", "deepseek-v2-lite-16b",
           "llama-3.2-vision-90b", "whisper-small")


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL)


def _convert(tree, cfg):
    return convert.model_params_from_arrays(model_param_arrays(tree), cfg,
                                            device="cpu")


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(plus_one):
    x, w = _x(0, 3, 5, 64), _x(1, 64)
    _close(tlayers.rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-6,
                            plus_one=plus_one),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                            plus_one=plus_one))


@pytest.mark.parametrize("theta,hd", [(10000.0, 32), (1e6, 80)])
def test_apply_rope(theta, hd):
    x = _x(2, 2, 9, 3, hd)
    pos = np.random.default_rng(3).integers(0, 600, (2, 9))
    _close(tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_apply(act):
    p = jlayers.mlp_init(jax.random.PRNGKey(0), 48, 96, act, jnp.float32)
    x = _x(4, 2, 7, 48)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    _close(tlayers.mlp_apply(tp, torch.as_tensor(x), act),
           jlayers.mlp_apply(p, jnp.asarray(x), act))


# ----------------------------------------------------------------- blocks
@pytest.mark.parametrize("name,window", [("qwen3-4b", None),
                                         ("qwen2-7b", None),
                                         ("gemma2-9b", 6),
                                         ("zamba2-2.7b", None)])
def test_gqa_apply(name, window):
    cfg = j_config(name, smoke=True)
    p = jattn.gqa_init(jax.random.PRNGKey(1), cfg)
    x = _x(5, 2, 11, cfg.d_model)
    pos = np.tile(np.arange(11), (2, 1))
    out_j = jattn.gqa_apply(p, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
                            window=window)
    out_t = tattn.gqa_apply(_convert(p, cfg), torch.as_tensor(x),
                            t_config(name, smoke=True),
                            positions=torch.as_tensor(pos), window=window)
    _close(out_t, out_j)


@pytest.mark.parametrize("name", ["qwen3-4b", "gemma2-9b", "zamba2-2.7b"])
def test_gqa_decode_writes_the_cache_in_place(name):
    cfg = j_config(name, smoke=True)
    tcfg = t_config(name, smoke=True)
    p = jattn.gqa_init(jax.random.PRNGKey(2), cfg)
    tp = _convert(p, cfg)
    B, S_max = 3, 7
    hkv = jattn.head_counts(cfg, 1)[1]
    ck_j = jnp.zeros((B, S_max, hkv, cfg.head_dim))
    cv_j = jnp.zeros_like(ck_j)
    ck_t = torch.zeros(B, S_max, hkv, cfg.head_dim)
    cv_t = torch.zeros_like(ck_t)
    start = np.array([0, 2, 4])
    for i in range(5):       # the third sequence wraps its ring buffer
        x = _x(10 + i, B, 1, cfg.d_model)
        pos = start + i
        y_j, ck_j, cv_j = jattn.gqa_decode(p, jnp.asarray(x), cfg,
                                           cache_k=ck_j, cache_v=cv_j,
                                           pos=jnp.asarray(pos))
        y_t, ck_out, _ = tattn.gqa_decode(tp, torch.as_tensor(x), tcfg,
                                          cache_k=ck_t, cache_v=cv_t,
                                          pos=torch.as_tensor(pos))
        assert ck_out is ck_t
        _close(y_t, y_j)
    _close(ck_t, ck_j)
    _close(cv_t, cv_j)


@pytest.mark.parametrize("name,S", [("zamba2-2.7b", 21), ("mamba2-780m", 9)])
def test_mamba_apply(name, S):
    cfg = j_config(name, smoke=True)
    p = jmamba.mamba_init(jax.random.PRNGKey(3), cfg)
    x = _x(6, 2, S, cfg.d_model)
    _close(tmamba.mamba_apply(_convert(p, cfg), torch.as_tensor(x),
                              t_config(name, smoke=True)),
           jmamba.mamba_apply(p, jnp.asarray(x), cfg))


def test_mamba_decode_matches_jax_and_the_full_sequence():
    cfg = j_config("zamba2-2.7b", smoke=True)
    tcfg = t_config("zamba2-2.7b", smoke=True)
    p = jmamba.mamba_init(jax.random.PRNGKey(4), cfg)
    tp = _convert(p, cfg)
    B, S = 2, 6
    x = _x(7, B, S, cfg.d_model)
    cache_j = jmamba.mamba_cache_init(cfg, B, jnp.float32)
    cache_t = tmamba.mamba_cache_init(tcfg, B, torch.float32, "cpu")
    ys = []
    for t in range(S):
        y_j, *cache_j = jmamba.mamba_decode(
            p, jnp.asarray(x[:, t:t + 1]), cfg, conv_x=cache_j[0],
            conv_bc=cache_j[1], ssm_state=cache_j[2])
        y_t, *out = tmamba.mamba_decode(
            tp, torch.as_tensor(x[:, t:t + 1]), tcfg, conv_x=cache_t[0],
            conv_bc=cache_t[1], ssm_state=cache_t[2])
        assert all(a is b for a, b in zip(out, cache_t))
        _close(y_t, y_j)
        ys.append(y_t)
    for a, b in zip(cache_t, cache_j):
        _close(a, b)
    _close(torch.cat(ys, 1), tmamba.mamba_apply(tp, torch.as_tensor(x), tcfg))


# ------------------------------------------------------------ whole models
@pytest.mark.parametrize("name", COVERED)
def test_param_tree_round_trip(name):
    """JAX params -> float32 numpy -> port tensors keep every leaf's path
    and shape, match the port's own ``init_params``, and keep the Mamba2
    float32 leaves (and the MoE router) in float32."""
    cfg = j_config(name, smoke=True)
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg)
    arrays = model_param_arrays(jp)
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(arrays))
    tcfg = t_config(name, smoke=True).scaled(dtype="bfloat16")
    tp = convert.model_params_from_arrays(arrays, tcfg, device="cpu")
    own = ttr.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert leaf_shapes(tp) == leaf_shapes(jp) == leaf_shapes(own)
    assert ttr.param_count(tp) == jtr.param_count(jp)
    for path, t in _named(tp):
        leaf = path.rsplit("/", 1)[-1]
        want = torch.float32 if leaf in convert.FLOAT32_PARAMS \
            else torch.bfloat16
        assert t.dtype == want, path
    for path, t in _named(own):
        assert t.dtype == dict(_named(tp))[path].dtype, path


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, f"{prefix}/{k}")]
    if isinstance(tree, tuple):
        return [x for i, v in enumerate(tree) for x in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _context(cfg, B, seed=9):
    """The cross-attention input of a config at smoke size: vision's patch
    embeddings (cross_context rows), whisper's frames (encoder_context
    rows, encoded by each package); None for the others."""
    if cfg.cross_context:
        return _x(seed, B, cfg.cross_context, cfg.d_model)
    if cfg.encoder_stages is not None:
        return _x(seed, B, cfg.encoder_context, cfg.d_model)
    return None


@pytest.mark.parametrize("name", COVERED)
def test_forward_and_decode_match_jax(name):
    """``forward`` and four ``decode_step``s, logits and every cache
    leaf; vision and whisper with their context (whisper's frames encoded
    first, by each package's ``encode``)."""
    cfg = j_config(name, smoke=True)
    tcfg = t_config(name, smoke=True)
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg)
    tp = _convert(jp, cfg)
    B, S, steps = 2, 10, 4
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    ctx = _context(cfg, B)
    ctx_j = ctx_t = None
    if ctx is not None:
        ctx_j, ctx_t = jnp.asarray(ctx), torch.as_tensor(ctx)
        if cfg.encoder_stages is not None:
            ctx_j, ctx_t = jtr.encode(jp, ctx_j, cfg), ttr.encode(tp, ctx_t,
                                                                  tcfg)
            _close(ctx_t, ctx_j)
    _close(ttr.forward(tp, toks, tcfg, context=ctx_t),
           jtr.forward(jp, jnp.asarray(toks), cfg, context=ctx_j))

    cache_j = jtr.init_cache(cfg, B, 8)
    cache_t = ttr.init_cache(tcfg, B, 8, device="cpu")
    step = jax.jit(lambda p, c, t, q, x: jtr.decode_step(p, c, t, q, cfg,
                                                         context=x))
    for i in range(steps):
        pos = np.full((B,), i, np.int32)
        l_j, cache_j = step(jp, cache_j, jnp.asarray(toks[:, i:i + 1]),
                            jnp.asarray(pos), ctx_j)
        l_t, cache_t = ttr.decode_step(tp, cache_t, toks[:, i:i + 1], pos,
                                       tcfg, context=ctx_t)
        assert l_t.shape == (B, 1, ttr.padded_vocab(tcfg))
        _close(l_t, l_j)
    leaves_j = jax.tree.leaves(cache_j)
    leaves_t = ttr.tree_leaves(cache_t)
    assert len(leaves_t) == len(leaves_j)
    for a, b in zip(leaves_j, leaves_t):
        _close(b, a)


@pytest.mark.parametrize("name,remat", [("whisper-small", False),
                                        ("whisper-small", True)])
def test_encode_matches_jax(name, remat):
    """Whisper's encoder: non-causal attention blocks over 32 frames, with
    and without per-repeat remat (same values)."""
    cfg = j_config(name, smoke=True)
    tcfg = t_config(name, smoke=True)
    jp = jtr.init_params(jax.random.PRNGKey(3), cfg)
    tp = _convert(jp, cfg)
    frames = _x(11, 3, cfg.encoder_context, cfg.d_model)
    out = ttr.encode(tp, torch.as_tensor(frames), tcfg, remat=remat)
    assert out.shape == (3, cfg.encoder_context, cfg.d_model)
    _close(out, jtr.encode(jp, jnp.asarray(frames), cfg))


@pytest.mark.parametrize("name", ["llama-3.2-vision-90b", "whisper-small"])
def test_context_changes_the_logits_and_prefill_matches_decode(name):
    """The context reaches the logits (another context moves them), and
    with it the decode steps give the prefill's logits position by
    position (the prefill step encodes whisper's frames first)."""
    from repro_torch.serving.decode import make_decode_step, make_prefill_step
    tcfg = t_config(name, smoke=True)
    tp = ttr.init_params(torch.Generator().manual_seed(1), tcfg, device="cpu")
    B, S = 2, 6
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (B, S)))
    ctx = torch.as_tensor(_context(tcfg, B, seed=12))
    full = make_prefill_step(tcfg)(tp, toks, ctx)
    other = make_prefill_step(tcfg)(tp, toks, ctx * 2.0 + 1.0)
    assert float((full - other).abs().max()) > 1e-3
    dec_ctx = ttr.encode(tp, ctx, tcfg) if tcfg.encoder_stages else ctx
    cache = ttr.init_cache(tcfg, B, S, device="cpu")
    step = make_decode_step(tcfg)
    for i in range(S):
        logits, cache = step(tp, cache, toks[:, i:i + 1],
                             torch.full((B,), i), dec_ctx)
        _close(logits[:, 0], full[:, i].numpy())


def test_tree_helpers_pass_none_through():
    tree = ({"a": torch.ones(2)}, None, (torch.zeros(3), None))
    assert ttr.tree_leaves(tree)[1].shape == (3,)
    assert len(ttr.tree_leaves(tree)) == 2
    doubled = ttr.tree_map(lambda t: t + 1, tree)
    assert doubled[1] is None and doubled[2][1] is None
    assert ttr.param_count(tree) == 5


def test_cache_tree_with_cross_entries_converts():
    """A JAX cache after two decode steps of the vision model (its cross
    blocks' entries are None) converts through
    ``model_params_from_arrays``: the Nones stay, every other leaf keeps its
    values, and the port decodes on from it as JAX does."""
    name = "llama-3.2-vision-90b"
    cfg, tcfg = j_config(name, smoke=True), t_config(name, smoke=True)
    jp = jtr.init_params(jax.random.PRNGKey(2), cfg)
    tp = _convert(jp, cfg)
    B = 2
    ctx = _x(13, B, cfg.cross_context, cfg.d_model)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, 3))
    cache_j = jtr.init_cache(cfg, B, 8)
    for i in range(2):
        _, cache_j = jtr.decode_step(jp, cache_j, jnp.asarray(toks[:, i:i + 1]),
                                     jnp.full((B,), i), cfg,
                                     context=jnp.asarray(ctx))
    cache_t = convert.model_params_from_arrays(model_param_arrays(cache_j),
                                               tcfg, device="cpu")
    assert cache_t[0][4] is None and cache_j[0][4] is None
    for a, b in zip(jax.tree.leaves(cache_j), ttr.tree_leaves(cache_t)):
        _close(b, a)
    l_j, _ = jtr.decode_step(jp, cache_j, jnp.asarray(toks[:, 2:3]),
                             jnp.full((B,), 2), cfg, context=jnp.asarray(ctx))
    l_t, _ = ttr.decode_step(tp, cache_t, toks[:, 2:3], np.full((B,), 2),
                             tcfg, context=torch.as_tensor(ctx))
    _close(l_t, l_j)

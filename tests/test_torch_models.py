"""PyTorch port of the model zoo's serving path, held against ``repro``:
layers, GQA and Mamba2 blocks, and ``forward`` plus four ``decode_step``s
for the six configs the slice covers, with ``repro``'s weights carried
over by ``convert.model_params_from_arrays``. Inputs come from numpy
seeds; tolerance rel/abs 1e-4 (float32; the sums run in another order).
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
           "gemma2-9b")
NOT_COVERED = ("llama4-scout-17b-a16e", "deepseek-v2-lite-16b",
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
    float32 leaves in float32."""
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
        want = torch.float32 if leaf in tmamba.FLOAT32_PARAMS \
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


@pytest.mark.parametrize("name", COVERED)
def test_forward_and_decode_match_jax(name):
    cfg = j_config(name, smoke=True)
    tcfg = t_config(name, smoke=True)
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg)
    tp = _convert(jp, cfg)
    B, S, steps = 2, 10, 4
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    _close(ttr.forward(tp, toks, tcfg), jtr.forward(jp, jnp.asarray(toks), cfg))

    cache_j = jtr.init_cache(cfg, B, 8)
    cache_t = ttr.init_cache(tcfg, B, 8, device="cpu")
    step = jax.jit(lambda p, c, t, q: jtr.decode_step(p, c, t, q, cfg))
    for i in range(steps):
        pos = np.full((B,), i, np.int32)
        l_j, cache_j = step(jp, cache_j, jnp.asarray(toks[:, i:i + 1]),
                            jnp.asarray(pos))
        l_t, cache_t = ttr.decode_step(tp, cache_t, toks[:, i:i + 1], pos,
                                       tcfg)
        assert l_t.shape == (B, 1, ttr.padded_vocab(tcfg))
        _close(l_t, l_j)
    for a, b in zip(jax.tree.leaves(cache_j), ttr.tree_leaves(cache_t)):
        _close(b, a)


@pytest.mark.parametrize("name", NOT_COVERED)
def test_unported_blocks_raise(name):
    cfg = t_config(name, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttr.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttr.init_cache(cfg, 1, 4, device="cpu")

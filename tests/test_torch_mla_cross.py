"""MLA (DeepSeek's multi-head latent attention) and cross-attention in the
port, held against ``repro.models.attention`` on smoke-size configs in
float32 with ``repro``'s weights carried over; inputs from numpy seeds;
rel/abs 1e-4 (the sums run in another order).

* ``mla_apply`` (prefill: the latent expanded, K5 at D = nope + rope,
  Dv = v_head_dim);
* four ``mla_decode`` steps (absorbed decode: K6 with one latent KV head
  and v the cache's first r columns), outputs and the latent cache, which
  the port writes in place at ``pos``;
* ``cross_apply`` at Sq != Sk and at Sq 1 (every decode step);
* K6's split algorithm (``decode_attention_split``) with v read inside k,
  as the kernel reads it, against ``decode_attention_plain`` at D 576 and
  Dv 512 (deepseek-v2-lite's latent head) within 2e-5, the JAX suite's
  float32 tolerance, and against the Pallas kernel in interpret mode.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import model_param_arrays

from repro.configs.registry import get_config as j_config
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.models import attention as jattn
from repro_torch import convert
from repro_torch.configs.registry import get_config as t_config
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn

TOL = dict(rtol=1e-4, atol=1e-4)
MLA = "deepseek-v2-lite-16b"


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _convert(tree, cfg):
    return convert.model_params_from_arrays(model_param_arrays(tree), cfg,
                                            device="cpu")


@pytest.mark.parametrize("B,S", [(2, 11), (1, 33)])
def test_mla_apply_matches_jax(B, S):
    cfg, tcfg = j_config(MLA, smoke=True), t_config(MLA, smoke=True)
    p = jattn.mla_init(jax.random.PRNGKey(1), cfg)
    x = _x(1, B, S, cfg.d_model)
    pos = np.tile(np.arange(S), (B, 1))
    _close(tattn.mla_apply(_convert(p, cfg), torch.as_tensor(x), tcfg,
                           positions=torch.as_tensor(pos)),
           jattn.mla_apply(p, jnp.asarray(x), cfg,
                           positions=jnp.asarray(pos)))


def test_mla_decode_matches_jax_and_writes_the_latent_cache_in_place():
    cfg, tcfg = j_config(MLA, smoke=True), t_config(MLA, smoke=True)
    p = jattn.mla_init(jax.random.PRNGKey(2), cfg)
    tp = _convert(p, cfg)
    B, S_max = 3, 9
    width = cfg.kv_lora_rank + cfg.qk_rope_dim
    c_j = jnp.zeros((B, S_max, width))
    c_t = torch.zeros(B, S_max, width)
    start = np.array([0, 2, 4])
    for i in range(4):
        x = _x(10 + i, B, 1, cfg.d_model)
        pos = start + i
        y_j, c_j = jattn.mla_decode(p, jnp.asarray(x), cfg, cache_ckv=c_j,
                                    pos=jnp.asarray(pos))
        y_t, out = tattn.mla_decode(tp, torch.as_tensor(x), tcfg,
                                    cache_ckv=c_t, pos=torch.as_tensor(pos))
        assert out is c_t
        _close(y_t, y_j)
        _close(c_t, c_j)


def test_mla_decode_is_its_prefill_up_to_the_softmax_scale(monkeypatch):
    """The reference's absorbed decode scales the scores by 1/sqrt(r +
    rope) (the latent query's width, 576 for v2-lite) where its prefill
    scales by 1/sqrt(nope + rope) (192); the port keeps both. With the
    query scaled by sqrt((r + rope) / (nope + rope)) the decode steps give
    the expanded prefill's outputs position by position; without it only
    position 0, where one key is visible, agrees."""
    tcfg = t_config(MLA, smoke=True)
    p = tattn.mla_init(torch.Generator().manual_seed(3), tcfg)
    B, S = 2, 6
    x = torch.as_tensor(_x(20, B, S, tcfg.d_model))
    full = tattn.mla_apply(p, x, tcfg,
                           positions=torch.arange(S).expand(B, S))
    width = tcfg.kv_lora_rank + tcfg.qk_rope_dim
    ratio = math.sqrt(width / (tcfg.qk_nope_dim + tcfg.qk_rope_dim))

    def decode_all():
        cache = torch.zeros(B, S, width)
        return torch.cat([tattn.mla_decode(
            p, x[:, i:i + 1], tcfg, cache_ckv=cache,
            pos=torch.full((B,), i))[0] for i in range(S)], 1)

    as_is = decode_all()
    _close(as_is[:, 0], full[:, 0].numpy())
    assert float((as_is[:, 1:] - full[:, 1:]).abs().max()) > 1e-2
    plain = ops.decode_attention
    monkeypatch.setattr(ops, "decode_attention",
                        lambda q, *a, **kw: plain(q * ratio, *a, **kw))
    _close(decode_all(), full.numpy())


@pytest.mark.parametrize("name,Sq,Sk", [
    ("llama-3.2-vision-90b", 7, 16),     # prefill: Sq != Sk, rep 2
    ("llama-3.2-vision-90b", 1, 16),     # a decode step
    ("whisper-small", 5, 32),            # MHA into the encoder's output
    ("whisper-small", 1, 32),
])
def test_cross_apply_matches_jax(name, Sq, Sk):
    cfg, tcfg = j_config(name, smoke=True), t_config(name, smoke=True)
    p = jattn.cross_init(jax.random.PRNGKey(4), cfg)
    x, ctx = _x(5, 2, Sq, cfg.d_model), _x(6, 2, Sk, cfg.d_model)
    _close(tattn.cross_apply(_convert(p, cfg), torch.as_tensor(x),
                             torch.as_tensor(ctx), tcfg),
           jattn.cross_apply(p, jnp.asarray(x), jnp.asarray(ctx), cfg))


@pytest.mark.parametrize("S,kv_len,split", [
    (161, [160, 1, 0, 37], 64),      # the zoo's serve loop at B 4
    (300, [300, 129, 64, 2], 128),   # splits wholly outside kv_len
])
def test_split_with_v_inside_k_at_the_latent_width(S, kv_len, split):
    """deepseek-v2-lite's latent head: 16 query heads of 576 against one
    KV head, v = k[..., :512] (a view: the split algorithm takes it from
    k's padded splits, as the kernel takes it from its K tile)."""
    B, Hq, r, rope = len(kv_len), 16, 512, 64
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, Hq, r + rope)).astype(np.float32)
    cache = rng.standard_normal((B, S, r + rope)).astype(np.float32)
    lens = np.asarray(kv_len, np.int32)
    k = torch.as_tensor(cache)[:, :, None, :]
    v = k[..., :r]
    assert tda.v_in_k(k, v) and not tda.v_in_k(k, v.contiguous())
    out = tda.decode_attention_split(torch.as_tensor(q), k, v,
                                     torch.as_tensor(lens), split=split)
    assert out.shape == (B, Hq, r)
    want = tda.decode_attention_plain(torch.as_tensor(q), k, v,
                                      torch.as_tensor(lens))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    assert not out[torch.as_tensor(lens) == 0].any()
    # ops.decode_attention on the CPU (the plain version) agrees too
    np.testing.assert_allclose(
        ops.decode_attention(torch.as_tensor(q), k, v,
                             torch.as_tensor(lens)).numpy(),
        want.numpy(), rtol=1e-6, atol=1e-6)
    seen = lens > 0
    kv = jnp.asarray(cache)[:, :, None, :]
    want_j = np.asarray(j_decode(jnp.asarray(q), kv, kv[..., :r],
                                 jnp.asarray(lens), block_k=64,
                                 interpret=True))
    np.testing.assert_allclose(out.numpy()[seen], want_j[seen], rtol=2e-5,
                               atol=2e-5)


def test_latent_split_uses_a_wide_group():
    """The kernel takes at most 4 query heads a block when Dv is above
    256 (64 accumulators a lane); the split rule sizes the grid with that
    group: B 4 and one KV head give 16 blocks a split, so a 4,096-key
    cache takes 64 splits of 64 keys."""
    assert tda.group_size(16, 512) == tda.WIDE_GROUP == 4
    assert tda.group_size(16, 128) == tda.MAX_GROUP
    assert tda.decode_split(4, 4096, 16, 1, 512) == 64
    assert tda.decode_split(4, 161, 16, 1, 512) == 64

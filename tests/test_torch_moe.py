"""The port's MoE (``repro_torch.models.moe``) held against ``repro``'s, on
smoke-size configs in float32 with ``repro``'s weights carried over by
``convert.model_params_from_arrays``; inputs from numpy seeds; rel/abs
1e-4 (the sums run in another order).

Cases: one token block; the blocked path (``moe_block_tokens`` small
enough that the tokens divide into several blocks, each with its own
capacity and slots); capacity overflow, where tokens past an expert's
capacity are dropped exactly as ``repro`` drops them; shared experts;
the load-balancing auxiliary loss; and the router kept in float32 in a
bfloat16 config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import model_param_arrays

from repro.configs.registry import get_config as j_config
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch import convert
from repro_torch.configs.registry import get_config as t_config
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import mlp_apply
from repro_torch.models import transformer as ttr

TOL = dict(rtol=1e-4, atol=1e-4)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(name, **kw):
    cfg = j_config(name, smoke=True).scaled(**kw)
    tcfg = t_config(name, smoke=True).scaled(**kw)
    p = jmoe.moe_init(jax.random.PRNGKey(7), cfg)
    tp = convert.model_params_from_arrays(model_param_arrays(p), tcfg,
                                          device="cpu")
    return cfg, tcfg, p, tp


def _kept(cfg, p, x):
    """repro's routing of one block: (top-k experts (T, k), kept mask)."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    logits = xt @ p["router"]
    _, topi = jax.lax.top_k(logits, cfg.top_k)
    onehot = jax.nn.one_hot(topi, cfg.n_experts)
    flat = onehot.reshape(-1, cfg.n_experts)
    pos = ((jnp.cumsum(flat, 0) - flat).reshape(onehot.shape) * onehot).sum(-1)
    return np.asarray(topi), np.asarray(pos < tmoe.capacity(xt.shape[0], cfg))


@pytest.mark.parametrize("name,B,S,kw", [
    # deepseek's routing (top-2 of 4 at smoke size) and 1 shared expert
    ("deepseek-v2-lite-16b", 2, 9, {}),
    # llama4's top-1 routing with its shared expert
    ("llama4-scout-17b-a16e", 3, 5, {}),
    # without shared experts
    ("deepseek-v2-lite-16b", 2, 7, {"n_shared_experts": 0}),
])
def test_moe_apply_one_block_matches_jax(name, B, S, kw):
    cfg, tcfg, p, tp = _pair(name, **kw)
    assert ("shared" in tp) == (cfg.n_shared_experts > 0)
    x = _x(1, B, S, cfg.d_model)
    assert not (B * S % cfg.moe_block_tokens == 0
                and B * S > cfg.moe_block_tokens)
    np.testing.assert_allclose(
        tmoe.moe_apply(tp, torch.as_tensor(x), tcfg).numpy(),
        np.asarray(jmoe.moe_apply(p, jnp.asarray(x), cfg)), **TOL)


@pytest.mark.parametrize("name,blk,cf", [("deepseek-v2-lite-16b", 8, 1.25),
                                         ("llama4-scout-17b-a16e", 4, 0.5)])
def test_moe_apply_blocked_matches_jax(name, blk, cf):
    """T = 24 tokens in blocks of 8 or 4: capacity and slots are per
    block, so the result differs from one block's and equals repro's."""
    cfg, tcfg, p, tp = _pair(name, moe_block_tokens=blk, capacity_factor=cf)
    x = _x(2, 4, 6, cfg.d_model)
    got = tmoe.moe_apply(tp, torch.as_tensor(x), tcfg).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jmoe.moe_apply(p, jnp.asarray(x), cfg)), **TOL)
    one = tmoe.moe_apply(tp, torch.as_tensor(x),
                         tcfg.scaled(moe_block_tokens=4096)).numpy()
    assert np.abs(got - one).max() > 1e-3


@pytest.mark.parametrize("cf", [0.25, 0.5])
def test_moe_capacity_overflow_drops_as_jax(cf):
    """A capacity factor below 1 overflows the experts: the choices past
    an expert's capacity go to the overflow bin and add nothing. The
    dropped choices are repro's, and so is the output."""
    cfg, tcfg, p, tp = _pair("deepseek-v2-lite-16b", capacity_factor=cf,
                             n_shared_experts=0)
    x = _x(3, 2, 12, cfg.d_model)
    topi, kept = _kept(cfg, p, x)
    assert (~kept).sum() > 0
    got = tmoe.moe_apply(tp, torch.as_tensor(x), tcfg).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jmoe.moe_apply(p, jnp.asarray(x), cfg)), **TOL)
    # a token whose every choice was dropped gets exactly 0
    dropped = ~kept.any(-1)
    if dropped.any():
        assert not got.reshape(-1, cfg.d_model)[dropped].any()


def test_moe_shared_experts_add_the_mlp():
    """With shared experts the output is the routed part plus
    ``mlp_apply`` of the shared MLP, as in repro."""
    cfg, tcfg, p, tp = _pair("llama4-scout-17b-a16e")
    x = _x(4, 2, 5, cfg.d_model)
    xt = torch.as_tensor(x)
    routed = tmoe.moe_apply({k: v for k, v in tp.items() if k != "shared"},
                            xt, tcfg)
    np.testing.assert_allclose(
        tmoe.moe_apply(tp, xt, tcfg).numpy(),
        (routed + mlp_apply(tp["shared"], xt, tcfg.mlp_act)).numpy(),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tmoe.moe_apply(tp, xt, tcfg).numpy(),
        np.asarray(jmoe.moe_apply(p, jnp.asarray(x), cfg)), **TOL)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "llama4-scout-17b-a16e"])
def test_moe_aux_loss_matches_jax(name):
    cfg, tcfg, p, tp = _pair(name)
    x = _x(5, 3, 7, cfg.d_model)
    got = float(tmoe.moe_aux_loss(tp, torch.as_tensor(x), tcfg))
    assert got == pytest.approx(
        float(jmoe.moe_aux_loss(p, jnp.asarray(x), cfg)), rel=1e-5)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "llama4-scout-17b-a16e"])
def test_router_stays_float32_in_bfloat16(name):
    """The router is float32 in every config: repro initialises it so, the
    port's own init does too, and converted weights keep its float32
    values bit for bit (routing would drift if it were rounded)."""
    cfg = j_config(name, smoke=True).scaled(dtype="bfloat16")
    tcfg = t_config(name, smoke=True).scaled(dtype="bfloat16")
    jp = jtr.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.model_params_from_arrays(model_param_arrays(jp), tcfg,
                                          device="cpu")
    own = ttr.init_params(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    for tree in (tp, own):
        for unit in tree["stages"][-1]:
            moe = unit["moe"]
            assert moe["router"].dtype == torch.float32
            assert moe["experts_up"].dtype == torch.bfloat16
    j_router = np.asarray(jp["stages"][-1][0]["moe"]["router"])
    assert j_router.dtype == np.float32
    assert np.array_equal(tp["stages"][-1][0]["moe"]["router"].numpy(),
                          j_router)

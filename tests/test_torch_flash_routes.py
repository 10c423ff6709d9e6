"""K5's two bfloat16 routes for the zoo's shapes, their algorithms on the
CPU, held against ``repro``'s flash attention (the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it).

* ``split`` (one query): K5 at Sq 1 is K6's split-KV algorithm
  (``decode_attention_split``) with kv_len Sk for every sequence, the
  wrapper's split length, and the window only where the call is causal.
  Query Sk - 1 sees every key, and with a window the keys above
  Sk - 1 - window, which is K6's rule. Held within 1e-5 in float32 at
  rep 1, 5 and 8, D 64 and 128, D 192 with Dv 128, Sk off 64's grid,
  causal with and without a window, non-causal with a window (ignored, as
  the Pallas kernel ignores it) and a softcap.
* ``wgmma`` (more queries): ``flash_attention_tiled``, the kernel's tiling
  in tensor ops (query tiles of 128 rows, key tiles of its widths, an
  online rescale per tile, P rounded to bf16 once a tile when asked),
  within 1e-5 with the rounding off, and with it on within 2^-8 max|v|: P
  rounded to 8 bits is off by at most 2^-9 of itself, and o is a convex
  sum of v's rows weighted by P / l.
* The shape rule (``choose_route``) and the wgmma kernel's plan (keys a
  tile, stages, shared memory a block within 227 KB, slices of Dv).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa

TOL = dict(rtol=1e-5, atol=1e-5)
MAX_SMEM = 232448


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D, Dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D), np.float32),
            rng.standard_normal((B, Sk, Hkv, D), np.float32),
            rng.standard_normal((B, Sk, Hkv, Dv), np.float32))


def _pallas(q, k, v, **kw):
    return np.asarray(j_flash(*(jnp.asarray(a) for a in (q, k, v)),
                              block_q=128, block_k=64, interpret=True, **kw))


def _split_route(q, k, v, *, causal, window, softcap):
    """What the ``split`` route hands K6's kernel, in K6's tensor-op
    algorithm: one query a sequence, kv_len Sk, the wrapper's split
    length, the window only for a causal call."""
    B, _, Hq, D = q.shape
    _, Sk, Hkv, Dv = (*k.shape[:3], v.shape[-1])
    lens = torch.full((B,), Sk, dtype=torch.int32)
    out = tda.decode_attention_split(
        q[:, 0], k, v, lens, split=tda.decode_split(B, Sk, Hq, Hkv, Dv),
        window=window if causal else None, softcap=softcap)
    return out[:, None]


@pytest.mark.parametrize("B,Sk,Hq,Hkv,D,Dv,causal,window,softcap", [
    (2, 1500, 4, 4, 64, 64, False, None, None),     # rep 1, whisper's width
    (1, 777, 10, 2, 128, 128, False, None, None),   # rep 5, Sk off 64's grid
    (1, 1100, 16, 2, 128, 128, False, None, None),  # rep 8
    (2, 300, 4, 4, 192, 128, True, None, None),     # D 192, Dv 128 (MLA)
    (2, 500, 8, 1, 64, 64, True, 100, None),        # causal with a window
    (1, 400, 8, 8, 128, 128, False, 50, None),      # non-causal: ignored
    (2, 333, 8, 2, 64, 64, True, None, 30.0),       # softcap
])
def test_split_route_is_k5_at_one_query(B, Sk, Hq, Hkv, D, Dv, causal, window,
                                        softcap):
    q, k, v = _qkv(51, B, 1, Sk, Hq, Hkv, D, Dv)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _split_route(*(torch.as_tensor(a) for a in (q, k, v)), **kw)
    assert got.shape == (B, 1, Hq, Dv)
    np.testing.assert_allclose(got.numpy(), _pallas(q, k, v, **kw), **TOL)
    plain = tfa.flash_attention_plain(*(torch.as_tensor(a) for a in (q, k, v)),
                                      **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


WGMMA_CASES = [
    # B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, softcap
    (1, 300, 300, 4, 2, 64, 64, True, None, None),     # ragged query tile
    (1, 130, 1500, 2, 1, 64, 64, False, None, None),   # Sk 1,500: a tail
    (2, 200, 200, 2, 2, 80, 80, True, None, None),     # zamba2's D 80
    (1, 257, 260, 2, 2, 192, 128, True, None, None),   # D 192: tiles of 128
    (1, 150, 150, 2, 2, 256, 256, True, 70, 30.0),     # D 256: tiles of 64
    (1, 130, 700, 4, 2, 128, 64, True, 100, None),     # fully masked tiles
    (1, 64, 200, 10, 2, 128, 128, False, 30, None),    # rep 5, window unused
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,Dv,causal,window,softcap",
                         WGMMA_CASES)
def test_wgmma_tiling_matches_pallas(B, Sq, Sk, Hq, Hkv, D, Dv, causal,
                                     window, softcap):
    q, k, v = _qkv(52, B, Sq, Sk, Hq, Hkv, D, Dv)
    kw = dict(causal=causal, window=window, softcap=softcap)
    t = [torch.as_tensor(a) for a in (q, k, v)]
    want = _pallas(q, k, v, **kw)
    got = tfa.flash_attention_tiled(*t, **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    rounded = tfa.flash_attention_tiled(*t, round_p=True, **kw).numpy()
    bound = 2.0 ** -8 * float(np.abs(v).max())
    assert float(np.abs(rounded - want).max()) <= bound


@pytest.mark.parametrize("block_k", [64, 128])
def test_wgmma_key_tile_does_not_change_the_result(block_k):
    """Either key tile gives the one-pass result within the tolerance."""
    q, k, v = _qkv(53, 1, 200, 333, 4, 2, 64, 64)
    t = [torch.as_tensor(a) for a in (q, k, v)]
    kw = dict(causal=True, window=150, softcap=None)
    np.testing.assert_allclose(
        tfa.flash_attention_tiled(*t, block_k=block_k, **kw).numpy(),
        tfa.flash_attention_plain(*t, **kw).numpy(), **TOL)


def _operands(dtype, Sq, D, Dv, Sk=64, skew=None):
    q = torch.zeros((2, Sq, 4, D), dtype=dtype)
    k = torch.zeros((2, Sk, 2, D), dtype=dtype)
    v = torch.zeros((2, Sk, 2, Dv), dtype=dtype)
    if skew is not None:                     # a base off the 16-byte grid
        buf = torch.zeros(q.numel() + 1, dtype=dtype)
        q = buf[1:].view(q.shape)
    return q, k, v


@pytest.mark.parametrize("dtype,Sq,D,Dv,skew,route", [
    (torch.bfloat16, 1, 64, 64, None, "split"),
    (torch.bfloat16, 1, 320, 288, None, "split"),     # K6 takes D up to 576
    (torch.bfloat16, 1, 640, 512, None, "wide"),      # K6 does not: wide
    (torch.bfloat16, 512, 64, 64, None, "wgmma"),
    (torch.bfloat16, 512, 80, 80, None, "wgmma"),
    (torch.bfloat16, 2, 192, 128, None, "wgmma"),
    (torch.bfloat16, 64, 256, 256, None, "wgmma"),
    (torch.bfloat16, 64, 32, 32, None, "wgmma"),
    (torch.bfloat16, 64, 40, 24, None, "bf16_tc"),    # Dv narrower than 32
    (torch.bfloat16, 64, 20, 20, None, "bf16_tc"),    # off the 8-column grid
    (torch.bfloat16, 64, 64, 64, "q", "bf16_tc"),     # off the 16-byte grid
    (torch.bfloat16, 64, 320, 288, None, "wide"),
    (torch.float32, 1, 64, 64, None, "f32"),
    (torch.float32, 64, 128, 128, None, "f32"),
    (torch.float32, 64, 320, 288, None, "wide"),
])
def test_choose_route(dtype, Sq, D, Dv, skew, route):
    q, k, v = _operands(dtype, Sq, D, Dv, skew=skew)
    assert tfa.choose_route(q, k, v) == route
    assert tfa.route_takes(route, q, k, v)
    # the wgmma kernel takes partial panels too, when asked by name
    assert tfa.route_takes("wgmma", q, k, v) == (
        dtype == torch.bfloat16 and D % 8 == 0 and Dv % 8 == 0
        and max(D, Dv) <= 256 and skew is None)


@pytest.mark.parametrize("D", range(8, 257, 8))
def test_wgmma_plan_fits(D):
    """Every width the kernel takes fits a block's 227 KB with a ring of 2
    to 4 stages; 128 keys a tile up to Dv 64, else 64; Dv above 128 in two
    launches; the zoo's widths at four stages."""
    for Dv in range(8, 257, 8):
        bk, stages, smem, launches = tfa.wgmma_plan(D, Dv)
        assert smem <= MAX_SMEM and 2 <= stages <= tfa.WGMMA_MAX_STAGES
        assert bk == (128 if Dv <= 64 else 64)
        assert launches == (1 if Dv <= 128 else 2)
    assert tfa.wgmma_plan(64, 64) == (128, 4, 148_584, 1)
    assert tfa.wgmma_plan(192, 128) == (64, 4, 214_120, 1)
    assert tfa.wgmma_plan(256, 256) == (64, 3, 214_096, 2)

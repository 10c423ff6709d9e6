"""The split-KV algorithm of K6's CUDA kernel, on the CPU.

``repro_torch.kernels.decode_attention.decode_attention_split`` computes
decode attention as ``csrc/decode_attention.cu`` does: the cache cut into
splits of ``split`` keys, each split's softmax state (m, l, acc) in
float32, and the log-sum-exp merge of the splits that hold a visible key,
in split order. It is held against ``repro.kernels.decode_attention`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
against ``decode_attention_plain`` within 2e-5 in float32, the JAX suite's
tolerance, with splits wholly outside the visible range, a window that cuts
through a split, a cache whose length is not a multiple of the split, and
1, 4 and 8 query heads per KV head, with and without a softcap.

A sequence with ``kv_len = 0`` has no visible key: the split algorithm and
``decode_attention_plain`` give o = 0 there, and they are compared on every
row. The Pallas kernel averages the cache over an all-masked row (and its
reference over another padding), so it is compared where ``kv_len >= 1``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as j_decode
from repro_torch.kernels import decode_attention as tda

TOL = 2e-5


def _inputs(seed, B, S, Hq, Hkv, D, Dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, D), np.float32),
            rng.standard_normal((B, S, Hkv, D), np.float32),
            rng.standard_normal((B, S, Hkv, Dv), np.float32))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv,window,softcap,split,kv_len", [
    # S not a multiple of the split; splits 1-3 of row 1 hold no visible key
    (3, 200, 4, 4, 32, 32, None, None, 64, [200, 37, 130]),
    # kv_len = 0 beside a full row
    (2, 150, 2, 2, 16, 16, None, None, 64, [0, 150]),
    # a window of 50 cuts through splits; the splits below it are empty
    (2, 200, 4, 4, 32, 32, 50, None, 64, [200, 100]),
    # GQA 4:1 with a softcap, splits of 32
    (2, 96, 8, 2, 32, 32, None, 30.0, 32, [96, 51]),
    # 8 query heads per KV head, softcap and window
    (2, 160, 16, 2, 16, 16, 70, 50.0, 64, [160, 90]),
    # one split covers the whole cache
    (2, 40, 4, 1, 24, 24, None, None, 64, [40, 13]),
    # Dv != D, a split of one 64-key unit at a zamba2-width head
    (1, 130, 2, 2, 80, 48, None, None, 64, [129]),
])
def test_split_matches_pallas_and_plain(B, S, Hq, Hkv, D, Dv, window, softcap,
                                        split, kv_len):
    q, k, v = _inputs(21, B, S, Hq, Hkv, D, Dv)
    lens = np.asarray(kv_len, np.int32)
    out = tda.decode_attention_split(
        *(torch.as_tensor(a) for a in (q, k, v, lens)), split=split,
        window=window, softcap=softcap).numpy()
    assert out.shape == (B, Hq, Dv) and out.dtype == np.float32
    want_j = np.asarray(j_decode(*(jnp.asarray(a) for a in (q, k, v, lens)),
                                 window=window, softcap=softcap, block_k=64,
                                 interpret=True))
    want_p = tda.decode_attention_plain(
        *(torch.as_tensor(a) for a in (q, k, v, lens)), window=window,
        softcap=softcap).numpy()
    seen = lens > 0
    _close(out[seen], want_j[seen])
    _close(out, want_p)
    assert not out[~seen].any()


@pytest.mark.parametrize("split", [32, 64, 96, 256])
def test_split_length_does_not_change_the_result(split):
    """Any split length gives the one-split result within the tolerance
    (only the order of the float32 sums differs)."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(22, 2, 250, 8, 2, 32, 32))
    lens = torch.tensor([250, 77], dtype=torch.int32)
    one = tda.decode_attention_split(q, k, v, lens, split=256, softcap=20.0)
    _close(tda.decode_attention_split(q, k, v, lens, split=split,
                                      softcap=20.0).numpy(), one.numpy())


def test_split_in_bfloat16_matches_plain():
    q, k, v = (torch.as_tensor(a).bfloat16()
               for a in _inputs(23, 2, 120, 4, 4, 32, 32))
    lens = torch.tensor([120, 61], dtype=torch.int32)
    out = tda.decode_attention_split(q, k, v, lens, split=64)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(),
        tda.decode_attention_plain(q, k, v, lens).float().numpy(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("B,S,Hq,Hkv,want", [
    (4, 546, 32, 32, 64),       # zamba2's serve loop: 9 splits x 128 heads
    (1, 8192, 32, 8, 64),       # a long GQA cache: 128 splits
    (64, 546, 32, 32, 576),     # a large batch fills the card: one split
    (1, 100, 4, 4, 64),         # a short cache: two splits
])
def test_split_length_rule(B, S, Hq, Hkv, want):
    split = tda.decode_split(B, S, Hq, Hkv)
    assert split == want and split % tda.SPLIT_UNIT == 0
    rep = Hq // Hkv
    groups = -(-rep // min(rep, tda.MAX_GROUP))
    blocks = B * Hkv * groups * -(-S // split)
    # as many splits as fill the card, or one split of the whole cache
    assert blocks >= min(tda.TARGET_BLOCKS, B * Hkv * groups * -(-S // 64))
    assert blocks < tda.TARGET_BLOCKS + B * Hkv * groups


def _plain_before(q, k, v, kv_len, *, window=None, softcap=None):
    """``decode_attention_plain`` as it was before rows with no visible key
    were set to 0: the softmax over an all-masked row averages the cache."""
    import math
    B, Hq, D = q.shape
    _, S, Hkv, Dv = (*k.shape[:3], v.shape[-1])
    rep = Hq // Hkv
    qr = q.float().reshape(B, Hkv, rep, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhrd,bkhd->bhrk", qr, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    k_pos = torch.arange(S, device=q.device)[None, :]
    lens = kv_len.to(device=q.device, dtype=torch.int64)[:, None]
    mask = k_pos < lens
    if window is not None:
        mask &= k_pos > lens - 1 - window
    s = s.masked_fill(~mask[:, None, None, :], tda.NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrk,bkhd->bhrd", p, v.float())
    return o.reshape(B, Hq, Dv).to(q.dtype)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap,kv_len,empty", [
    # kv_len 0 beside a full and a partial row
    (3, 50, 4, 4, 16, None, None, [0, 50, 17], [True, False, False]),
    # a window of 10 past the cache's end leaves no key; kv_len 0 too
    (3, 50, 4, 2, 16, 10, None, [70, 30, 0], [True, False, True]),
    # a window of 0 leaves no key; GQA 4:1 with a softcap
    (2, 40, 8, 2, 32, 0, 30.0, [25, 40], [True, True]),
    (2, 40, 8, 2, 32, 7, 30.0, [25, 40], [False, False]),
])
def test_plain_is_zero_without_a_visible_key_and_unchanged_elsewhere(
        B, S, Hq, Hkv, D, window, softcap, kv_len, empty):
    """``decode_attention_plain`` gives exactly 0 on a row with no visible
    key, the bits of the old expression on every other row, and still
    matches the Pallas kernel within 2e-5 there."""
    q, k, v = _inputs(24, B, S, Hq, Hkv, D, D)
    lens = np.asarray(kv_len, np.int32)
    kw = dict(window=window, softcap=softcap)
    tq, tk, tv, tl = (torch.as_tensor(a) for a in (q, k, v, lens))
    out = tda.decode_attention_plain(tq, tk, tv, tl, **kw)
    empty = torch.as_tensor(empty)
    assert torch.equal(out[empty], torch.zeros_like(out[empty]))
    seen = ~empty
    assert torch.equal(out[seen], _plain_before(tq, tk, tv, tl, **kw)[seen])
    if seen.any():
        s = seen.numpy()
        want = np.asarray(j_decode(*(jnp.asarray(a[s]) for a in (q, k, v, lens)),
                                   block_k=64, interpret=True, **kw))
        _close(out[seen].numpy(), want)

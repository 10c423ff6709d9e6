"""K6's partials mode, the sequence-sharded decode's per-rank arithmetic:
the port's plain ``decode_attention_partials_plain`` against
``repro/kernels/ref.py`` ``decode_attention_partials`` on the same inputs.

One slice of a sequence-sharded cache: key j of the slice stands at
global position ``offset + j``, ``local_len`` keys of it hold entries and
a window is measured from the global length. Each row that sees a key has
(acc, m, l) within 1e-5 of the reference's. A row that sees none has m =
-1e30 in both packages; there the port's l and acc are 0, while the
reference's hold its padded chunk (l = 1024 and acc the sum of the
slice's v: exp(-1e30 - -1e30) is 1), the kv_len-0 quirk of ROADMAP's
hazards. Either weighs exp(-1e30 - m*) = 0 in the ranks' merge, which the
tests hold against the reference's too, and against the unsharded decode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, S, Hq, Hkv, D, Dv, latent=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = (k[..., :Dv] if latent
         else rng.standard_normal((B, S, Hkv, Dv)).astype(np.float32))
    return q, k, v


def _port(q, k, v, local, **kw):
    kt = torch.as_tensor(k)
    vt = kt[..., :v.shape[-1]] if v.base is k else torch.as_tensor(v)
    if kw.get("global_len") is not None:
        kw["global_len"] = torch.as_tensor(kw["global_len"])
    return [t.numpy() for t in ops.decode_attention_partials(
        torch.as_tensor(q), kt, vt, torch.as_tensor(local), **kw)]


def _ref(q, k, v, local, **kw):
    if kw.get("global_len") is not None:
        kw["global_len"] = jnp.asarray(kw["global_len"])
    return [np.asarray(t) for t in jref.decode_attention_partials(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(local),
        **kw)]


def _merge(parts):
    m_star = np.max([m for _, m, _ in parts], axis=0)
    w = [np.exp(m - m_star) for _, m, _ in parts]
    L = sum(l * c for (_, _, l), c in zip(parts, w))
    A = sum(a * c[..., None] for (a, _, _), c in zip(parts, w))
    return A / np.maximum(L, 1e-30)[..., None]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv,offset,glen,window,softcap,latent", [
    (3, 48, 8, 8, 16, 16, 48, [96, 58, 49], None, None, False),   # MHA
    (3, 48, 8, 2, 32, 32, 32, [70, 50, 80], 40, None, False),     # window
    #                                 starts before the slice (rows 0, 1)
    (2, 64, 6, 2, 24, 24, 0, [64, 40], 20, None, False),          # window
    #                                 inside the slice, 3 heads a group
    (2, 40, 4, 2, 16, 8, 80, [120, 95], None, 30.0, False),       # softcap
    (2, 32, 4, 1, 72, 64, 32, [64, 33], 16, None, True),          # latent
    (3, 32, 4, 4, 16, 16, 64, [64, 70, 96], None, None, False),   # row 0
    #                                 sees no key of this slice
])
def test_partials_match_the_reference(B, S, Hq, Hkv, D, Dv, offset, glen,
                                      window, softcap, latent):
    q, k, v = _inputs(S + offset, B, S, Hq, Hkv, D, Dv, latent)
    glen = np.asarray(glen, np.int32)
    local = np.clip(glen - offset, 0, S).astype(np.int32)
    kw = dict(offset=offset, global_len=glen, window=window, softcap=softcap)
    acc, m, l = _port(q, k, v, local, **kw)
    acc_r, m_r, l_r = _ref(q, k, v, local, **kw)
    assert acc.dtype == m.dtype == l.dtype == np.float32
    assert acc.shape == (B, Hq, Dv) and m.shape == l.shape == (B, Hq)
    pos = offset + np.arange(S)
    vis = (pos[None] < glen[:, None]) & (np.arange(S)[None] < local[:, None])
    if window is not None:
        vis &= pos[None] > glen[:, None] - 1 - window
    seen = vis.any(1)
    neg = np.float32(-1e30)
    assert (m[~seen] == neg).all() and (m_r[~seen] == neg).all()
    assert not l[~seen].any() and not acc[~seen].any()
    np.testing.assert_allclose(m[seen], m_r[seen], **TOL)
    np.testing.assert_allclose(l[seen], l_r[seen], **TOL)
    np.testing.assert_allclose(acc[seen], acc_r[seen], **TOL)


def test_an_empty_slice_weighs_nothing_in_the_merge():
    """kv_len 20 in slots of 32 over two ranks: rank 1's slice sees no key.
    Its partials differ from the reference's only in l and acc (the
    reference's padded chunk), and both merges equal the reference's
    unsharded decode."""
    B, S, Hq, Hkv, D = 2, 32, 4, 2, 16
    q, k, v = _inputs(5, B, 2 * S, Hq, Hkv, D, D)
    glen = np.array([20, 9], np.int32)
    parts, parts_r = [], []
    for r in range(2):
        sl = slice(r * S, (r + 1) * S)
        local = np.clip(glen - r * S, 0, S).astype(np.int32)
        kw = dict(offset=r * S, global_len=glen)
        parts.append(_port(q, k[:, sl], v[:, sl], local, **kw))
        parts_r.append(_ref(q, k[:, sl], v[:, sl], local, **kw))
    (acc, m, l), (acc_r, m_r, l_r) = parts[1], parts_r[1]
    np.testing.assert_array_equal(m, m_r)
    assert (m == np.float32(-1e30)).all() and not l.any() and not acc.any()
    assert (l_r == 1024).all()                   # the reference's quirk
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(glen)))
    np.testing.assert_allclose(_merge(parts), want, **TOL)
    np.testing.assert_allclose(_merge(parts_r), want, **TOL)


@pytest.mark.parametrize("slices", [2, 4])
@pytest.mark.parametrize("latent", [False, True])
def test_merged_partials_are_the_unsharded_decode(slices, latent):
    """The cache cut into 2 or 4 slices, the port's partials of each,
    merged with the ranks' log-sum-exp rule: the reference's unsharded
    decode, and the port's (its split kernel's plain twin), within 1e-5."""
    B, S, Hq = 4, 96, 8
    Hkv, D, Dv = (1, 40, 32) if latent else (2, 24, 24)
    q, k, v = _inputs(slices, B, S, Hq, Hkv, D, Dv, latent)
    glen = np.array([96, 1, 50, 73], np.int32)
    n = S // slices
    parts = []
    for r in range(slices):
        sl = slice(r * n, (r + 1) * n)
        vs = k[:, sl][..., :Dv] if latent else v[:, sl]
        parts.append(_port(q, k[:, sl], vs, np.clip(glen - r * n, 0, n)
                           .astype(np.int32), offset=r * n, global_len=glen))
    got = _merge(parts)
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(glen)))
    np.testing.assert_allclose(got, want, **TOL)
    kt = torch.as_tensor(k)
    split = tda.decode_attention_split(
        torch.as_tensor(q), kt, kt[..., :Dv] if latent else torch.as_tensor(v),
        torch.as_tensor(glen), split=64)
    np.testing.assert_allclose(got, split.numpy(), **TOL)

"""K5, K6 and K7 at widths above the port's narrow kernels, held against
``repro``: the plain torch versions (which the wide routes are held
against on the card, ``test_torch_cuda.py``) against the Pallas kernels
in interpret mode, as ``tests/test_kernels.py`` runs them, at 1e-5 in
float32. The Pallas kernels take any width; on the card these calls take
``csrc/attention_wide.cu`` (K5 above D or Dv 256, K6 above D 576 or Dv
512) and K7's CUDA-core kernel reading bfloat16 (n above 256)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.ssd_scan import ssd_scan as j_ssd
from repro_torch.kernels import ops

TOL = 1e-5


def _randn(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,causal,window,softcap", [
    (32, 32, 4, 2, True, None, None),
    (24, 40, 2, 2, True, 16, 30.0),      # queries at the end, window, cap
    (32, 32, 4, 1, False, None, None),
])
def test_flash_at_d_320_dv_288_matches_pallas(Sq, Sk, Hq, Hkv, causal, window,
                                              softcap):
    q, k, v = _randn(1, (2, Sq, Hq, 320), (2, Sk, Hkv, 320),
                     (2, Sk, Hkv, 288))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window, softcap=softcap, block_q=8,
                   block_k=8, interpret=True)
    got = ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), causal=causal,
                              window=window, softcap=softcap)
    assert got.shape == (2, Sq, Hq, 288)
    _close(got, want)


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,D,Dv,causal,window,softcap", [
    (37, 37, 4, 2, 320, 288, True, None, None),    # Sq not a block's multiple
    (24, 70, 4, 2, 320, 288, True, None, None),    # Sq < Sk
    (70, 70, 2, 2, 320, 320, True, 20, None),      # window across blocks
    (40, 40, 4, 4, 288, 288, True, None, 30.0),    # softcap
    (32, 32, 8, 2, 320, 320, True, None, None),    # GQA 4:1
    (32, 32, 4, 1, 320, 256, True, None, None),    # MQA
    (24, 24, 4, 2, 128, 300, True, None, None),    # Dv 300 with D 128
    (20, 20, 2, 1, 640, 512, True, None, None),    # D 640, Dv 512
    (40, 100, 4, 1, 640, 300, True, 30, 30.0),     # every edge at once
    (33, 50, 2, 1, 330, 290, True, 25, None),      # D, Dv not 8's multiples
])
def test_flash_wide_shapes_match_pallas(Sq, Sk, Hq, Hkv, D, Dv, causal,
                                        window, softcap):
    """The shapes that K5's bfloat16 wide route is held to on the card
    (``test_torch_cuda.py``), at small size: the plain version against the
    Pallas kernel in interpret mode."""
    q, k, v = _randn(5, (1, Sq, Hq, D), (1, Sk, Hkv, D), (1, Sk, Hkv, Dv))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window, softcap=softcap, block_q=16,
                   block_k=32, interpret=True)
    got = ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                              torch.as_tensor(v), causal=causal,
                              window=window, softcap=softcap)
    assert got.shape == (1, Sq, Hq, Dv)
    _close(got, want)


@pytest.mark.parametrize("Hq,Hkv,latent,window,softcap", [
    (8, 2, False, None, None),
    (4, 4, False, 20, 25.0),
    (16, 1, True, None, None),           # v the latent cache's first 576
])
def test_decode_at_d_640_dv_576_matches_pallas(Hq, Hkv, latent, window,
                                               softcap):
    B, S = 3, 48
    q, k, v = _randn(2, (B, Hq, 640), (B, S, Hkv, 640), (B, S, Hkv, 576))
    if latent:
        v = k[..., :576]
    lens = np.array([48, 21, 1], np.int32)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(lens), window=window, softcap=softcap,
                    block_k=16, interpret=True)
    kt = torch.as_tensor(k)
    vt = kt[..., :576] if latent else torch.as_tensor(v)
    got = ops.decode_attention(torch.as_tensor(q), kt, vt,
                               torch.as_tensor(lens), window=window,
                               softcap=softcap)
    _close(got, want)


@pytest.mark.parametrize("offset,window", [(0, None), (24, 30), (24, None)])
def test_decode_partials_at_d_640_dv_576_match_the_reference(offset, window):
    """K6's partials mode at the wide widths, v inside k (the latent
    cache): (acc, m, l) of a 24-key slice against ``ref.py``'s on every
    row with a visible key. A row without one has m = -1e30 in both, so
    it weighs nothing in the ranks' merge; there ``ref.py`` leaves l and
    acc at the sums of e^0 over masked keys, the port at 0."""
    B, Hq, n = 3, 16, 24
    q, cache = _randn(3, (B, Hq, 640), (B, n, 1, 640))
    glen = np.array([48, offset + 5, 3], np.int32)
    local = np.clip(glen - offset, 0, n).astype(np.int32)
    want = R.decode_attention_partials(
        jnp.asarray(q), jnp.asarray(cache), jnp.asarray(cache[..., :576]),
        jnp.asarray(local), offset=offset, global_len=jnp.asarray(glen),
        window=window)
    kt = torch.as_tensor(cache)
    got = ops.decode_attention_partials(
        torch.as_tensor(q), kt, kt[..., :576], torch.as_tensor(local),
        offset=offset, global_len=torch.as_tensor(glen), window=window)
    seen = got[2] > 0
    assert seen.any()
    for g, w in zip(got, want):
        _close(g[seen], np.asarray(w)[seen.numpy()])
    assert (got[1][~seen] == -1e30).all()
    assert (np.asarray(want[1])[~seen.numpy()] == np.float32(-1e30)).all()


@pytest.mark.parametrize("s,chunk", [(48, 16), (40, 32)])
def test_ssd_at_n_320_matches_pallas(s, chunk):
    b, h, p, g, n = 2, 4, 16, 1, 320
    rng = np.random.default_rng(4)
    x, B, C = _randn(4, (b, s, h, p), (b, s, g, n), (b, s, g, n), scale=0.3)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    D = np.ones(h, np.float32)
    jy, jst = j_ssd(*map(jnp.asarray, (x, dt, A, B, C, D)), chunk=chunk,
                    interpret=True)
    ty, tst = ops.ssd_scan(*map(torch.as_tensor, (x, dt, A, B, C, D)),
                           chunk=chunk)
    _close(ty, jy)
    _close(tst, jst)

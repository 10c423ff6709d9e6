"""The chunk-parallel SSD scan of K7's tensor-core route, on the CPU.

``repro_torch.kernels.ssd_scan.ssd_scan_chunked`` computes the scan as the
``bf16_tc`` CUDA route does (chunk pass, state pass, scan pass), and with
``split_bf16`` it rounds each float32 operand that route forms itself
(``w o X``, ``W``, ``state_in``) to a bfloat16 hi/lo pair, as its tensor
cores take them. It is held against ``repro.kernels.ssd_scan`` (the Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
against ``ssd_scan_plain``, at the JAX suite's shapes and at one
zamba2-width head (s 512, p 64, n 64, chunk 128):

* float32: y and the final state within 1e-5;
* the emulated splits, on inputs rounded to bfloat16 (the route's x, B
  and C are bfloat16): the state within 1e-4 and y within 2e-2, the bars
  the card's bf16 route is held to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as j_ssd
from repro_torch.kernels import ssd_scan as tssd

SHAPES = [
    # b, s, h, p, g, n, chunk
    (1, 64, 2, 8, 1, 16, 16),
    (2, 48, 4, 16, 2, 8, 16),     # grouped B/C, non-multiple seq
    (1, 100, 3, 8, 1, 8, 32),     # ragged tail chunk
    (1, 512, 1, 64, 1, 64, 128),  # one zamba2 head: p 64, n 64, chunk 128
]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
SPLIT_TOL = {"y": dict(rtol=2e-2, atol=2e-2),
             "state": dict(rtol=1e-4, atol=1e-4)}


def _inputs(seed, b, s, h, p, g, n, bf16_operands):
    """x, dt (softplus * 0.5), A < 0, B, C, D as float32 numpy; x, B and C
    rounded to bfloat16 values when ``bf16_operands``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    D = np.ones(h, np.float32)
    if bf16_operands:
        x, B, C = (torch.as_tensor(v).bfloat16().float().numpy()
                   for v in (x, B, C))
    return x, dt, A, B, C, D


@pytest.mark.parametrize("split", [False, True], ids=["f32", "bf16_split"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES)
def test_chunked_matches_pallas_and_plain(b, s, h, p, g, n, chunk, split):
    a = _inputs(6, b, s, h, p, g, n, bf16_operands=split)
    tens = [torch.as_tensor(v) for v in a]
    y, st = tssd.ssd_scan_chunked(*tens, chunk=chunk, split_bf16=split)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, p, n)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    y_j, st_j = j_ssd(*(jnp.asarray(v) for v in a), chunk=chunk,
                      interpret=True)
    y_p, st_p = tssd.ssd_scan_plain(*tens, chunk=chunk)
    tol_y = SPLIT_TOL["y"] if split else F32_TOL
    tol_st = SPLIT_TOL["state"] if split else F32_TOL
    for want_y, want_st in ((np.asarray(y_j), np.asarray(st_j)),
                            (y_p.numpy(), st_p.numpy())):
        np.testing.assert_allclose(y.numpy(), want_y, **tol_y)
        np.testing.assert_allclose(st.numpy(), want_st, **tol_st)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SHAPES[:3])
def test_chunked_without_skip_and_in_bf16(b, s, h, p, g, n, chunk):
    """No skip D, and bfloat16 x, B, C (y comes back in bfloat16, the
    state in float32), against the plain version on the same inputs."""
    x, dt, A, B, C, _ = (torch.as_tensor(v) for v in
                         _inputs(7, b, s, h, p, g, n, bf16_operands=True))
    xb, Bb, Cb = x.bfloat16(), B.bfloat16(), C.bfloat16()
    y, st = tssd.ssd_scan_chunked(xb, dt, A, Bb, Cb, None, chunk=chunk,
                                  split_bf16=True)
    y_p, st_p = tssd.ssd_scan_plain(xb, dt, A, Bb, Cb, None, chunk=chunk)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), y_p.float().numpy(),
                               **SPLIT_TOL["y"])
    np.testing.assert_allclose(st.numpy(), st_p.numpy(),
                               **SPLIT_TOL["state"])

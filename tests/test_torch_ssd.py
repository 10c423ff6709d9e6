"""PyTorch port of the Mamba2 SSD scan (K7) and its decode step, held
against ``repro``: the plain torch scan against the Pallas kernel in
interpret mode on the sweep of ``tests/test_kernels.py`` (plain, grouped
B/C, ragged tail chunk) plus zamba2's head width, and the step against
``ssd_step_ref``, at the JAX suite's tolerance (1e-4). The CUDA kernel is
held against the plain version in ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.ssd_scan import ssd_scan as j_ssd
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tssd

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, b, s, h, p, g, n):
    """x, dt (softplus * 0.5), A < 0, B, C, D as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5
          ).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    D = np.ones(h, np.float32)
    return x, dt, A, B, C, D


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [
    (1, 64, 2, 8, 1, 16, 16),
    (2, 48, 4, 16, 2, 8, 16),     # grouped B/C, non-multiple seq
    (1, 100, 3, 8, 1, 8, 32),     # ragged tail chunk
    (2, 40, 2, 64, 1, 16, 16),    # zamba2's head width p = 64
])
def test_ssd_plain_matches_pallas(b, s, h, p, g, n, chunk):
    a = _inputs(6, b, s, h, p, g, n)
    y_j, st_j = j_ssd(*(jnp.asarray(x) for x in a), chunk=chunk,
                      interpret=True)
    y_t, st_t = tssd.ssd_scan_plain(*(torch.as_tensor(x) for x in a),
                                    chunk=chunk)
    assert y_t.shape == (b, s, h, p) and st_t.shape == (b, h, p, n)
    assert st_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), **TOL)


def test_ssd_plain_without_skip_and_bf16_output():
    x, dt, A, B, C, _ = _inputs(7, 1, 40, 2, 8, 1, 8)
    y_j, st_j = R.ssd_scan_ref(*(jnp.asarray(v) for v in (x, dt, A, B, C)),
                               None, chunk=16)
    y_t, st_t = tssd.ssd_scan_plain(*(torch.as_tensor(v) for v in
                                      (x, dt, A, B, C)), None, chunk=16)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), **TOL)
    xb = torch.as_tensor(x).bfloat16()
    y_b, _ = tssd.ssd_scan_plain(xb, *(torch.as_tensor(v) for v in
                                       (dt, A, B, C)), None, chunk=16)
    assert y_b.dtype == torch.bfloat16


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_step_matches_ref_and_scan(g):
    b, s, h, p, n = 2, 12, 4, 8, 8
    x, dt, A, B, C, D = _inputs(8, b, s, h, p, g, n)
    state_j = jnp.zeros((b, h, p, n))
    state_t = torch.zeros(b, h, p, n)
    ys = []
    for t in range(s):
        y_j, state_j = R.ssd_step_ref(state_j, x[:, t], dt[:, t], A, B[:, t],
                                      C[:, t], D)
        y_t, state_t = ops.ssd_step(state_t, *(torch.as_tensor(v) for v in
                                               (x[:, t], dt[:, t], A, B[:, t],
                                                C[:, t], D)))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
        ys.append(y_t)
    np.testing.assert_allclose(state_t.numpy(), np.asarray(state_j), **TOL)
    y_scan, st_scan = ops.ssd_scan(*(torch.as_tensor(v) for v in
                                     (x, dt, A, B, C, D)), chunk=8)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_scan.numpy(),
                               **TOL)
    np.testing.assert_allclose(state_t.numpy(), st_scan.numpy(), **TOL)


def test_ops_ssd_scan_runs_plain_on_cpu_and_kernel_refuses_cpu():
    a = [torch.as_tensor(v) for v in _inputs(9, 1, 20, 2, 8, 1, 8)]
    ops.reset_launch_counts()
    y, st = ops.ssd_scan(*a, chunk=8)
    y_p, st_p = tssd.ssd_scan_plain(*a, chunk=8)
    assert torch.equal(y, y_p) and torch.equal(st, st_p)
    assert sum(ops.launch_counts.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_kernel(*a, chunk=8)

"""The autograd Functions that give K5 (flash attention) and K7 (the SSD
scan) a gradient on the card, checked on the CPU: the same Function runs
with the plain forward standing in for the CUDA kernel, and
``torch.autograd.gradcheck`` (float64, its default tolerances) compares
its backward, the plain version recomputed under autograd, with finite
differences of its forward. Also: on CPU tensors ``ops`` dispatches to the
plain versions, so their gradients equal the Function's."""

import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tssd


def _t(rng, shape, scale=1.0, low=None):
    a = rng.standard_normal(shape) * scale
    if low is not None:
        a = np.abs(a) + low
    return torch.as_tensor(a, dtype=torch.float64).requires_grad_()


@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,D,Dv,causal,window,softcap", [
    (5, 5, 4, 2, 3, 3, True, None, None),      # GQA, causal
    (4, 6, 2, 2, 3, 2, True, None, None),      # queries at the end, Dv != D
    (6, 6, 3, 1, 2, 2, True, 3, None),         # MQA + window
    (5, 5, 2, 1, 3, 3, True, None, 1.5),       # softcap
    (4, 5, 2, 2, 2, 3, False, None, None),     # non-causal
])
def test_flash_attention_function_gradcheck(Sq, Sk, Hq, Hkv, D, Dv, causal,
                                            window, softcap):
    rng = np.random.default_rng(Sq * 31 + Sk)
    q, k, v = _t(rng, (2, Sq, Hq, D)), _t(rng, (2, Sk, Hkv, D)), \
        _t(rng, (2, Sk, Hkv, Dv))
    kw = dict(causal=causal, window=window, softcap=softcap)
    fn = lambda q, k, v: tfa.flash_attention_grad(
        q, k, v, forward=tfa.flash_attention_plain, **kw)
    assert torch.autograd.gradcheck(fn, (q, k, v))
    # what ops runs on the CPU has the same gradient
    g_fn = torch.autograd.grad(fn(q, k, v).sum(), (q, k, v))
    g_ops = torch.autograd.grad(ops.flash_attention(q, k, v, **kw).sum(),
                                (q, k, v))
    for a, b in zip(g_fn, g_ops):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("s,h,g,chunk", [(6, 2, 1, 4), (8, 4, 2, 4)])
def test_ssd_scan_function_gradcheck(skip, s, h, g, chunk):
    rng = np.random.default_rng(s * 7 + h)
    p, n = 2, 3
    x = _t(rng, (1, s, h, p))
    dt = _t(rng, (1, s, h), 0.3, low=0.05)
    A = (-_t(rng, (h,), 0.5, low=0.2)).detach().requires_grad_()
    B, C = _t(rng, (1, s, g, n)), _t(rng, (1, s, g, n))
    ins = (x, dt, A, B, C) + ((_t(rng, (h,)),) if skip else ())
    fn = lambda *a: tssd.ssd_scan_grad(
        *a, *(() if skip else (None,)), chunk=chunk,
        forward=tssd.ssd_scan_plain)
    assert torch.autograd.gradcheck(fn, ins)                  # y and state
    assert torch.autograd.gradcheck(lambda *a: fn(*a)[0], ins)   # y alone
    y, st = ops.ssd_scan(*ins, chunk=chunk) if skip else \
        ops.ssd_scan(*ins, None, chunk=chunk)
    g_ops = torch.autograd.grad(y.sum() + st.sum(), ins)
    y2, st2 = fn(*ins)
    g_fn = torch.autograd.grad(y2.sum() + st2.sum(), ins)
    for a, b in zip(g_fn, g_ops):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ssd_scan_plain_gradient_is_finite_where_exp_overflows():
    """Decays of hundreds of nats per chunk: exp(cum_i - cum_j) overflows
    above the diagonal, which the plain version masks before the exp, so
    the recomputed backward stays finite."""
    rng = np.random.default_rng(0)
    x = _t(rng, (1, 64, 2, 2))
    dt = _t(rng, (1, 64, 2), 1.0, low=2.0)
    A = torch.tensor([-16.0, -8.0], dtype=torch.float64, requires_grad=True)
    B, C = _t(rng, (1, 64, 1, 3)), _t(rng, (1, 64, 1, 3))
    y, st = tssd.ssd_scan_grad(x.float(), dt.float(), A.float(), B.float(),
                               C.float(), None, chunk=64,
                               forward=tssd.ssd_scan_plain)
    grads = torch.autograd.grad(y.sum(), (x, dt, A, B, C))
    assert all(bool(torch.isfinite(t).all()) for t in grads)

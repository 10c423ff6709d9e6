"""Flash attention for prefill: CUDA kernel wrapper + plain version.

Port of ``repro/kernels/flash_attention.py``. For q (B, Sq, Hq, D),
k (B, Sk, Hkv, D) and v (B, Sk, Hkv, Dv), with Hq a multiple of Hkv (GQA),
it computes softmax attention in float32 and returns (B, Sq, Hq, Dv) in
q's dtype. Queries sit at the end of the keys (query i has position
i + Sk - Sq); q is scaled by 1/sqrt(D) before the product, the logit
softcap comes after the scale and before the mask, and with ``causal`` a
``window`` keeps the last ``window`` positions.

* :func:`flash_attention_kernel` launches ``csrc/flash_attention.cu`` on
  CUDA tensors (it raises for anything else): bfloat16 takes the
  tensor-core route (``bf16_tc``: mma.sync, cp.async), float32 the
  CUDA-core kernel (``f32``); heads wider than :data:`MAX_HEAD_DIM` take
  the wide route (``wide``, :mod:`repro_torch.kernels.attention_wide`:
  ``csrc/attention_wide_tc.cu`` in bfloat16, ``csrc/attention_wide.cu`` in
  float32);
* :func:`flash_attention_plain` is the same function in tensor ops, with
  the (B, Hkv, rep, Sq, Sk) scores materialised, used for CPU tensors and
  as the kernel's yardstick on the card;
* :class:`FlashAttentionFn` gives the kernel a gradient: its forward
  launches the kernel, its backward recomputes the plain version under
  autograd. The TPU kernel has no backward kernel (the JAX package has no
  ``custom_vjp``; JAX differentiates its reference), so a plain backward
  is the faithful port; a backward kernel is later work (ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional

import torch

from repro_torch.kernels import _build, attention_wide

NEG_INF = -1e30
#: the widest D and Dv of ``csrc/flash_attention.cu``; wider heads take
#: the wide route
MAX_HEAD_DIM = 256


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = (*k.shape[:3], v.shape[-1])
    rep = Hq // Hkv
    acc = torch.promote_types(q.dtype, torch.float32)   # float64 stays
    qr = q.to(acc).reshape(B, Sq, Hkv, rep, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhrd,bkhd->bhrqk", qr, k.to(acc))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        k_pos = torch.arange(Sk, device=q.device)[None, :]
        mask = k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrqk,bkhd->bqhrd", p, v.to(acc))
    return o.reshape(B, Sq, Hq, Dv).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, o; B, Sq, Sk, Hq, Hkv, D, Dv, causal, window; softcap,
        # scale; dtype; stream
        lib.flash_attention_launch.argtypes = [p, p, p, p] + [i] * 9 \
            + [f, f, i, p]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [i, i, i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def check_operands(names, tensors, ndims, device: torch.device,
                   dtype: torch.dtype) -> None:
    """Raise unless each tensor is contiguous, of ``dtype`` (one of the
    kernels' float types) and rank, on ``device``."""
    if dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{names[0]}: dtype {dtype} is not one of "
                         f"{sorted(map(str, _build.DTYPE_CODES))}")
    for name, t, nd in zip(names, tensors, ndims):
        if t.device != device or t.dtype != dtype or t.dim() != nd \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {nd}-D {dtype} "
                             f"tensor on {device}, got {t.dim()}-D {t.dtype} "
                             f"on {t.device} (contiguous={t.is_contiguous()})")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu``: (B, Sq, Hq, Dv) in q's dtype.

    q, k, v contiguous, of one float dtype, on one CUDA device; Hq a
    multiple of Hkv. D or Dv above :data:`MAX_HEAD_DIM` launches the wide
    route (:mod:`repro_torch.kernels.attention_wide`) instead.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash attention kernel needs CUDA tensors, got {dev}")
    check_operands(("q", "k", "v"), (q, k, v), (4, 4, 4), dev, q.dtype)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = (*k.shape[:3], v.shape[-1])
    if k.shape != (B, Sk, Hkv, D) or v.shape[:3] != (B, Sk, Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit together")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv}")
    if D < 1 or Dv < 1:
        raise ValueError(f"head dims D={D}, Dv={Dv} must be positive")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if window is not None and not window > 0:
        raise ValueError(f"window must be positive, got {window}")
    if D > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        return attention_wide.prefill(q, k, v, causal=causal, window=window,
                                      softcap=softcap)
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        Hq, Hkv, D, Dv, int(causal), int(window or 0), float(softcap or 0.0),
        1.0 / math.sqrt(D), _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(rc).decode()}")
    _build.launch_counts["flash_attention"] += 1
    _build.route_counts[f"flash_attention.{_build.ROUTES[q.dtype]}"] += 1
    return out


def flash_attention_smem_bytes(D: int, Dv: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the kernel takes for head widths D, Dv
    in ``dtype``'s route (CUDA build needed)."""
    return int(_lib().flash_attention_smem_bytes(D, Dv,
                                                 _build.DTYPE_CODES[dtype]))


class FlashAttentionFn(torch.autograd.Function):
    """Attention through ``forward`` (the kernel on the card) with the plain
    version's gradient: the backward recomputes :func:`flash_attention_plain`
    from the saved q, k, v under autograd. ``forward`` is an argument so
    that a CPU test can run this Function with the plain forward standing
    in for the kernel."""

    @staticmethod
    def forward(ctx, forward: Callable, q, k, v, causal, window, softcap):
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v)
        return forward(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, grad_out):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = flash_attention_plain(*ins, **ctx.opts)
        dq, dk, dv = torch.autograd.grad(out, ins, grad_out)
        return None, dq, dk, dv, None, None, None


def flash_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         forward: Callable = flash_attention_kernel,
                         ) -> torch.Tensor:
    """:func:`flash_attention_kernel` (or ``forward``) with a gradient."""
    return FlashAttentionFn.apply(forward, q, k, v, causal, window, softcap)

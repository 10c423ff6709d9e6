"""Kernel API with dispatch by device.

The placement and payload kernels (:func:`fractional_overlap_matrix`,
:func:`weighted_entropy_features`, :func:`byte_entropy`) take numpy arrays
or tensors and move them to ``device`` (the card unless the caller passes
``device="cpu"``). The model and training kernels
(:func:`flash_attention`, :func:`decode_attention`, :func:`ssd_scan`,
:func:`quant_pack`) take tensors and run where the tensors lie. Either way
a CUDA device runs the hand-written CUDA kernel and the CPU runs the
kernel's plain tensor-op version. Asking for CUDA where there is none
raises (:func:`repro_torch.device.resolve`); a CUDA launch that fails
raises too. There is no fallback from one to the other.

On the card, :func:`flash_attention` (K5) and :func:`ssd_scan` (K7) go
through an ``autograd.Function`` whose forward launches the kernel and
whose backward recomputes the kernel's plain version under autograd: the
TPU kernels have no backward kernel (JAX differentiates their reference),
so training's backward is the plain version on every device. On the CPU
autograd runs through the plain versions directly.

:func:`ssd_step` and :func:`quant_unpack` are plain tensor ops on every
device, as in the JAX package.

``launch_counts`` (re-exported from :mod:`repro_torch.kernels._build`)
counts kernel launches by name: ``"overlap"`` (K1),
``"entropy_features"`` (K2), ``"quant_pack"`` (K3), ``"byte_entropy"``
(K4), ``"flash_attention"`` (K5), ``"decode_attention"`` (K6) and
``"ssd_scan"`` (K7). ``route_counts`` counts the calls of K5 and K7 by
the route their dtype chose: ``"<name>.bf16_tc"`` (bfloat16, the
tensor-core kernels) or ``"<name>.f32"`` (float32, the CUDA-core kernels).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import entropy_features as _ef
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import overlap as _ov
from repro_torch.kernels import quant_pack as _qp
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels._build import (launch_counts, reset_launch_counts,
                                        route_counts)

__all__ = ["fractional_overlap_matrix", "weighted_entropy_features",
           "byte_entropy", "quant_pack", "quant_unpack", "flash_attention",
           "decode_attention", "ssd_scan", "ssd_step", "launch_counts",
           "route_counts", "reset_launch_counts"]


def _on(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=dev).contiguous()


def fractional_overlap_matrix(codes, sizes, spans, *, codes_b=None,
                              spans_b=None, device: DeviceLike = "cuda",
                              ) -> torch.Tensor:
    """(NA, NB) float32 fractional-overlap matrix on ``device`` (see
    :mod:`repro_torch.kernels.overlap`). Code rows given on the host
    (numpy, or tensors on the CPU) are checked against the kernel's
    contract (:func:`~repro_torch.kernels.overlap.check_codes`) before
    they move; rows already on the card are taken as they are, since a
    check there would wait for the card."""
    dev = resolve(device)
    n_files = len(sizes)
    for name, c in (("codes", codes), ("codes_b", codes_b)):
        if c is not None and not (isinstance(c, torch.Tensor) and c.is_cuda):
            _ov.check_codes(c, n_files, name)
    args = (_on(codes, torch.int32, dev), _on(sizes, torch.float32, dev),
            _on(spans, torch.float32, dev))
    kw = {}
    if codes_b is not None:
        kw = dict(codes_b=_on(codes_b, torch.int32, dev),
                  spans_b=_on(spans_b, torch.float32, dev))
    if dev.type == "cuda":
        return _ov.fractional_overlap_matrix_kernel(*args, **kw)
    return _ov.fractional_overlap_matrix_plain(*args, **kw)


def weighted_entropy_features(codes, n_valid, n_rows, n_cols, lengths, *,
                              n_buckets: int = 1,
                              device: DeviceLike = "cuda",
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(summary (N, 4), bucket_H (N, n_buckets))`` float32 on ``device``
    (see :mod:`repro_torch.kernels.entropy_features`)."""
    dev = resolve(device)
    args = (_on(codes, torch.int32, dev), _on(n_valid, torch.int32, dev),
            _on(n_rows, torch.int32, dev), _on(n_cols, torch.int32, dev),
            _on(lengths, torch.float32, dev))
    if dev.type == "cuda":
        return _ef.weighted_entropy_features_kernel(*args, n_buckets=n_buckets)
    return _ef.weighted_entropy_features_plain(*args, n_buckets=n_buckets)


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (the
    plain version runs); anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensors must be on 'cuda' or 'cpu', got {t.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """(B, Sq, Hq, Dv) attention of q (B, Sq, Hq, D) over k/v (B, Sk, Hkv,
    D/Dv) (see :mod:`repro_torch.kernels.flash_attention`). Differentiable
    on every device (on the card through
    :class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`)."""
    if _on_card(q):
        return _fa.flash_attention_grad(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, softcap=softcap)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """(B, Hq, Dv) attention of one query per sequence over its cache
    prefix of ``kv_len`` rows (see
    :mod:`repro_torch.kernels.decode_attention`)."""
    if _on_card(q):
        return _da.decode_attention_kernel(
            q.contiguous(), k.contiguous(), v.contiguous(),
            kv_len.to(torch.int32).contiguous(), window=window,
            softcap=softcap)
    return _da.decode_attention_plain(q, k, v, kv_len, window=window,
                                      softcap=softcap)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             D: Optional[torch.Tensor] = None, *, chunk: int = 128,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan: (y (b, s, h, p), final state (b, h, p, n) float32)
    (see :mod:`repro_torch.kernels.ssd_scan`). Differentiable on every
    device (on the card through :class:`~repro_torch.kernels.ssd_scan.SSDScanFn`)."""
    if _on_card(x):
        f32 = lambda t: t.float().contiguous()
        return _ssd.ssd_scan_grad(
            x.contiguous(), f32(dt), f32(A), B.contiguous(), C.contiguous(),
            None if D is None else f32(D), chunk=chunk)
    return _ssd.ssd_scan_plain(x, dt, A, B, C, D, chunk=chunk)


def ssd_step(state, x_t, dt_t, A, B_t, C_t, D=None):
    """One Mamba2 decode step (plain tensor ops on every device)."""
    return _ssd.ssd_step(state, x_t, dt_t, A, B_t, C_t, D)


def quant_pack(x: torch.Tensor, *, block: int = 256,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 block quantisation: (q int8 of x's shape, scale (size / block,)
    float32) (see :mod:`repro_torch.kernels.quant_pack`). On the card x is
    made a contiguous float32 tensor first; the kernel takes block 256."""
    if _on_card(x):
        return _qp.quant_pack_kernel(x.float().contiguous(), block=block)
    return _qp.quant_pack_plain(x, block=block)


def quant_unpack(q: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` per block, in ``dtype`` (plain tensor ops)."""
    return _qp.quant_unpack(q, scale, dtype)


def byte_entropy(data, *, device: DeviceLike = "cuda",
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hist (256,) int32, entropy () float32 in bits per byte)`` of a
    (n,) uint8 payload on ``device`` (see
    :mod:`repro_torch.kernels.entropy_features`)."""
    dev = resolve(device)
    d = _on(data, torch.uint8, dev)
    if dev.type == "cuda":
        return _ef.byte_entropy_kernel(d)
    return _ef.byte_entropy_plain(d)

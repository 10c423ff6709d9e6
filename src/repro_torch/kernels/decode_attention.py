"""Flash-decoding (one query token against a KV cache): CUDA kernel
wrapper + plain version.

Port of ``repro/kernels/decode_attention.py``. For q (B, Hq, D), caches
k (B, S, Hkv, D) and v (B, S, Hkv, Dv) and per-sequence lengths kv_len
(B,) it computes softmax attention over the visible cache rows in float32
and returns (B, Hq, Dv) in q's dtype. Row j of sequence b is visible when
``j < kv_len[b]`` and, with a ``window``, ``j > kv_len[b] - 1 - window``.

* :func:`decode_attention_kernel` launches ``csrc/decode_attention.cu`` on
  CUDA tensors (it raises for anything else);
* :func:`decode_attention_plain` is the same function in tensor ops, used
  for CPU tensors and as the kernel's yardstick on the card.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM, NEG_INF,
                                                 check_operands)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
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
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhrk,bkhd->bhrd", p, v.float())
    return o.reshape(B, Hq, Dv).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, kv_len, o; B, S, Hq, Hkv, D, Dv, window; softcap, scale;
        # dtype; stream
        lib.decode_attention_launch.argtypes = [p] * 5 + [i] * 7 \
            + [f, f, i, p]
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def decode_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_len: torch.Tensor, *,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """Launch ``csrc/decode_attention.cu``: (B, Hq, Dv) in q's dtype.

    q, k, v contiguous, of one float dtype, on one CUDA device; kv_len
    int32 (B,) on the same device; D and Dv at most 256; Hq a multiple of
    Hkv.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode attention kernel needs CUDA tensors, got {dev}")
    check_operands(("q", "k", "v"), (q, k, v), (3, 4, 4), dev, q.dtype)
    B, Hq, D = q.shape
    _, S, Hkv, Dv = (*k.shape[:3], v.shape[-1])
    if k.shape != (B, S, Hkv, D) or v.shape[:3] != (B, S, Hkv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit together")
    if kv_len.shape != (B,) or kv_len.dtype != torch.int32 \
            or kv_len.device != dev or not kv_len.is_contiguous():
        raise ValueError(f"kv_len: expected contiguous int32 ({B},) on {dev}, "
                         f"got {kv_len.dtype} {tuple(kv_len.shape)} on "
                         f"{kv_len.device}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv}")
    if not (1 <= D <= MAX_HEAD_DIM and 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims D={D}, Dv={Dv} must be 1..{MAX_HEAD_DIM}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if window is not None and not window > 0:
        raise ValueError(f"window must be positive, got {window}")
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    rc = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), B, S, Hq, Hkv, D, Dv, int(window or 0),
        float(softcap or 0.0), 1.0 / math.sqrt(D),
        _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: "
                           f"{lib.decode_attention_error_string(rc).decode()}")
    _build.launch_counts["decode_attention"] += 1
    return out

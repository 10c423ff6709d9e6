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
  for CPU tensors and as the kernel's yardstick on the card;
* :func:`decode_attention_split` is the kernel's algorithm in tensor ops:
  the cache axis cut into splits, each split's softmax state (m, l, acc),
  and the log-sum-exp merge of the visible splits in split order
  (``tests/test_torch_decode_split.py`` holds it against the JAX package).

The kernel cuts the cache into splits of :func:`decode_split` keys, a
length chosen from the cache capacity S and the grid, never from kv_len
(which lives on the card): enough splits that the blocks fill the card's
132 SMs about eight times over, each a multiple of 64 keys (two warps of
32-key tiles). A sequence with no visible key (kv_len 0, or a window that
leaves none) gets o = 0 from all three.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM, NEG_INF,
                                                 check_operands)

SPLIT_UNIT = 64          # kTile x kWarps in csrc/decode_attention.cu
TARGET_BLOCKS = 132 * 8  # blocks that fill an H100's SMs eight times over
MAX_GROUP = 8            # query heads a block takes of one KV head


@functools.lru_cache(maxsize=None)
def decode_split(B: int, S: int, Hq: int, Hkv: int) -> int:
    """Keys per split of the kernel for a (B, S, Hkv) cache and Hq query
    heads: the fewest keys, in multiples of 64, that still give at most
    about ``TARGET_BLOCKS`` blocks."""
    rep = Hq // Hkv
    hb = 1 if rep == 1 else 2 if rep == 2 else 4 if rep <= 4 else MAX_GROUP
    base = max(B * Hkv * -(-rep // hb), 1)
    units = -(-S // SPLIT_UNIT)
    nsplit = min(units, -(-TARGET_BLOCKS // base))
    return -(-units // nsplit) * SPLIT_UNIT


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
    # no visible key (kv_len 0, or a window that leaves none): o = 0, as
    # the kernel and decode_attention_split give
    o = torch.where(mask.any(-1)[:, None, None, None], o,
                    torch.zeros((), device=q.device))
    return o.reshape(B, Hq, Dv).to(q.dtype)


def decode_attention_split(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len: torch.Tensor, *,
                           split: int, window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """The kernel's split-and-merge in tensor ops: the cache cut into
    splits of ``split`` keys, each visible split's (m, l, acc) in float32,
    then o = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30) over
    the splits that hold a visible key, M their largest m, in split order.
    A split without a visible key is left out (m = -1e30, l = 0 adds
    nothing), so a sequence with none gets o = 0."""
    B, Hq, D = q.shape
    _, S, Hkv, Dv = (*k.shape[:3], v.shape[-1])
    rep = Hq // Hkv
    ns = -(-S // split)
    pad = ns * split - S
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    qr = q.float().reshape(B, Hkv, rep, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhrd,bnjhd->bhrnj", qr,
                     kf.reshape(B, ns, split, Hkv, D))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(ns * split, device=q.device).reshape(ns, split)
    lens = kv_len.to(device=q.device, dtype=torch.int64)[:, None, None]
    vis = pos[None] < torch.clamp(lens, max=S)
    if window is not None:
        vis &= pos[None] >= lens - window
    vis = vis[:, None, None]                               # (B, 1, 1, ns, j)
    s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(-1)                                         # (B, Hkv, rep, ns)
    p = torch.where(vis, torch.exp(s - m[..., None]), torch.zeros((), device=q.device))
    l = p.sum(-1)
    acc = torch.einsum("bhrnj,bnjhd->bhrnd", p,
                       vf.reshape(B, ns, split, Hkv, Dv))
    used = vis.any(-1)                                     # (B, 1, 1, ns)
    m = torch.where(used, m, torch.full((), NEG_INF, device=q.device))
    M = m.amax(-1, keepdim=True)
    c = torch.where(used, torch.exp(m - M), torch.zeros((), device=q.device))
    L = (l * c).sum(-1)
    A = (acc * c[..., None]).sum(-2)
    o = A / torch.clamp_min(L, 1e-30)[..., None]
    return o.reshape(B, Hq, Dv).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, kv_len, o, part; B, S, Hq, Hkv, D, Dv, window; softcap,
        # scale; split, dtype; stream
        lib.decode_attention_launch.argtypes = [p] * 6 + [i] * 7 \
            + [f, f, i, i, p]
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_info.argtypes = [i] * 7 + [p]
        lib.decode_attention_info.restype = ctypes.c_int
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
    if S == 0:
        return out.zero_()
    split = decode_split(B, S, Hq, Hkv)
    ns = -(-S // split)
    # the splits' (m, l, acc), float32; freed to PyTorch's stream-ordered
    # allocator on return, after the launches on this stream
    part = (torch.empty(B * Hq * ns * (Dv + 2), dtype=torch.float32,
                        device=dev) if ns > 1 else None)
    lib = _lib()
    rc = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), B, S, Hq,
        Hkv, D, Dv, int(window or 0), float(softcap or 0.0),
        1.0 / math.sqrt(D), split, _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: "
                           f"{lib.decode_attention_error_string(rc).decode()}")
    _build.launch_counts["decode_attention"] += 1
    return out


def decode_attention_info(S: int, Hq: int, Hkv: int, D: int, Dv: int,
                          dtype: torch.dtype, B: int = 1) -> dict:
    """The split kernel's registers, shared memory per block and stages
    (two tiles in flight per warp, or one) at a shape, from the built
    library (it launches nothing), with the split length the wrapper
    takes there."""
    split = decode_split(B, S, Hq, Hkv)
    attr = (ctypes.c_int * 3)()
    lib = _lib()
    rc = lib.decode_attention_info(S, Hq, Hkv, D, Dv, split,
                                   _build.DTYPE_CODES[dtype], attr)
    if rc != 0:
        raise RuntimeError(f"decode attention info failed: "
                           f"{lib.decode_attention_error_string(rc).decode()}")
    return {"registers": attr[0], "smem_bytes": attr[1], "stages": attr[2],
            "split": split, "splits": -(-S // split)}

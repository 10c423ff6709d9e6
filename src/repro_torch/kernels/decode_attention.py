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

For a sequence-sharded cache (``repro_torch.serving.decode``) each rank
computes the partials of its slice instead of o: the unnormalised softmax
state acc (B, Hq, Dv) and m, l (B, Hq) in float32 over the slice's first
``local_len`` keys, key j at global position ``offset + j`` and a window
measured from ``global_len`` (``repro/kernels/ref.py``
``decode_attention_partials``).
:func:`decode_attention_partials_kernel` runs the kernel's two launches in
that mode (the merge writes (m, l, acc) in place of o; the mode is a
template parameter, built from ``csrc/decode_attention_partials.cu``, so
the ordinary launches carry none of its branches), and
:func:`decode_attention_partials_plain` is its plain version. A slice with
no visible key gives m = -1e30, l = 0 and acc = 0, so it weighs nothing in
the ranks' merge.

The kernel cuts the cache into splits of :func:`decode_split` keys, a
length chosen from the cache capacity S and the grid, never from kv_len
(which lives on the card): enough splits that the blocks fill the card's
132 SMs about eight times over, each a multiple of 64 keys (two warps of
32-key tiles). A sequence with no visible key (kv_len 0, or a window that
leaves none) gets o = 0 from all three.

Heads go up to D 576 and Dv 512, MLA's absorbed decode
(``repro_torch.models.attention.mla_decode``): one latent KV head of 576
columns whose value is its first 512. There v is a view of k
(:func:`v_in_k`); the kernel then reads V from the K tile it has staged
and never copies v, and :func:`decode_attention_split` takes v from k's
columns in the same way. Wider heads, and float32 heads whose one stage
does not fit the shared memory (:func:`split_fits`), take the wide route
in both modes (``wide`` and ``partials_wide``, the Pallas kernel's any
width, :mod:`repro_torch.kernels.attention_wide`): bfloat16 on the tensor
cores (``csrc/decode_attention_wide_tc.cu``, split over keys like this
kernel), float32 on the CUDA cores (``csrc/attention_wide.cu``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, attention_wide
from repro_torch.kernels.flash_attention import NEG_INF, check_operands

SPLIT_UNIT = 64          # kTile x kWarps in csrc/decode_attention.cu
TARGET_BLOCKS = 132 * 8  # blocks that fill an H100's SMs eight times over
MAX_GROUP = 8            # query heads a block takes of one KV head
WIDE_GROUP = 4           # ... when Dv is above NARROW_DV
NARROW_DV = 256
MAX_D, MAX_DV = 576, 512  # MLA's latent head: kv_lora_rank 512 + rope 64
MAX_SMEM = 232448         # a block's shared memory on Hopper (227 KB)


def v_in_k(k: torch.Tensor, v: torch.Tensor) -> bool:
    """True when v is k's first ``v.shape[-1]`` columns: the same storage,
    offset and strides (``k[..., :Dv]``)."""
    return (v.shape[:-1] == k.shape[:-1] and v.shape[-1] <= k.shape[-1]
            and v.device == k.device and v.dtype == k.dtype
            and v.untyped_storage().data_ptr()
            == k.untyped_storage().data_ptr()
            and v.storage_offset() == k.storage_offset()
            and v.stride() == k.stride())


def group_size(rep: int, Dv: int) -> int:
    """Query heads one block of the kernel takes of a KV head."""
    hb = 1 if rep == 1 else 2 if rep == 2 else 4 if rep <= 4 else MAX_GROUP
    return min(hb, WIDE_GROUP) if Dv > NARROW_DV else hb


@functools.lru_cache(maxsize=None)
def split_fits(Hq: int, Hkv: int, D: int, Dv: int, dtype: torch.dtype,
               aliased: bool) -> bool:
    """True when ``csrc/decode_attention.cu`` takes these heads: D at most
    576, Dv at most 512, and one stage of its tiles within the shared
    memory (``geometry`` there; a float32 v of more than 256 columns apart
    from k does not fit). Else the call takes the wide route."""
    if not (D <= MAX_D and Dv <= MAX_DV and (not aliased or Dv <= D)):
        return False
    el = torch.empty((), dtype=dtype).element_size()
    per = 16 // el
    ku, kv = -(-D // per), -(-Dv // per)
    hb = group_size(Hq // Hkv, Dv)
    stage_off = 4 * hb * ku * per + 4 * 2 * hb * (Dv + 2)
    stage_off = -(-stage_off // 16) * 16
    ld = (ku | 1) * per + (0 if aliased else kv * per)
    return stage_off + el * SPLIT_UNIT * ld <= MAX_SMEM


@functools.lru_cache(maxsize=None)
def decode_split(B: int, S: int, Hq: int, Hkv: int, Dv: int = 0) -> int:
    """Keys per split of the kernel for a (B, S, Hkv) cache, Hq query
    heads and values of Dv (0: at most 256): the fewest keys, in multiples
    of 64, that still give at most about ``TARGET_BLOCKS`` blocks."""
    rep = Hq // Hkv
    hb = group_size(rep, Dv)
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
    nothing), so a sequence with none gets o = 0. Where v is a view of k's
    first columns (:func:`v_in_k`), V is read from k's staged split, as
    the kernel reads it from its K tile."""
    B, Hq, D = q.shape
    _, S, Hkv, Dv = (*k.shape[:3], v.shape[-1])
    rep = Hq // Hkv
    ns = -(-S // split)
    pad = ns * split - S
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = (kf[..., :Dv] if v_in_k(k, v)
          else torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad)))
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


def decode_attention_partials_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        local_len: torch.Tensor, *, offset: int = 0,
        global_len: Optional[torch.Tensor] = None,
        window: Optional[int] = None, softcap: Optional[float] = None):
    """(acc (B, Hq, Dv), m (B, Hq), l (B, Hq)), float32: the softmax state
    of one query per sequence over the slice k/v (B, S, Hkv, D/Dv) of a
    sequence-sharded cache. Key j is visible when ``j < local_len[b]``
    and, with a ``window`` and ``global_len``, ``offset + j >
    global_len[b] - 1 - window``; m is the largest visible score (-1e30
    where none is), l the sum of e^(s - m) and acc of e^(s - m) v over
    the visible keys."""
    B, Hq, D = q.shape
    _, S, Hkv, Dv = (*k.shape[:3], v.shape[-1])
    rep = Hq // Hkv
    qr = q.float().reshape(B, Hkv, rep, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhrd,bkhd->bhrk", qr, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    j = torch.arange(S, device=q.device)[None, :]
    mask = j < local_len.to(device=q.device, dtype=torch.int64)[:, None]
    if window is not None and global_len is not None:
        g = global_len.to(device=q.device, dtype=torch.int64)[:, None]
        mask &= j + offset > g - 1 - window
    mask = mask[:, None, None, :]
    s = s.masked_fill(~mask, NEG_INF)
    m = (s.amax(-1) if S else torch.full((B, Hkv, rep), NEG_INF,
                                         device=q.device))
    p = torch.where(mask, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    acc = torch.einsum("bhrk,bkhd->bhrd", p, v.float())
    return (acc.reshape(B, Hq, Dv), m.reshape(B, Hq),
            p.sum(-1).reshape(B, Hq))


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, kv_len, o, part; B, S, Hq, Hkv, D, Dv, window; softcap,
        # scale; split, v_in_k, dtype; stream
        lib.decode_attention_launch.argtypes = [p] * 6 + [i] * 7 \
            + [f, f, i, i, i, p]
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_info.argtypes = [i] * 8 + [p]
        lib.decode_attention_info.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _partials_lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention_partials")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, local_len, glen; offset; acc, m, l, part; B, S, Hq, Hkv,
        # D, Dv, window; softcap, scale; split, v_in_k, dtype; stream
        lib.decode_attention_partials_launch.argtypes = [p] * 5 + [i] \
            + [p] * 4 + [i] * 7 + [f, f, i, i, i, p]
        lib.decode_attention_partials_launch.restype = ctypes.c_int
        lib.decode_attention_partials_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_partials_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def decode_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_len: torch.Tensor, *,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None) -> torch.Tensor:
    """Launch ``csrc/decode_attention.cu``: (B, Hq, Dv) in q's dtype.

    q and k contiguous, of one float dtype, on one CUDA device; v
    contiguous too, or k's first Dv columns (:func:`v_in_k`, read from k's
    tiles without a copy); kv_len int32 (B,) on the same device; Hq a
    multiple of Hkv. Heads that ``csrc/decode_attention.cu`` does not take
    (:func:`split_fits`) launch the wide route instead.
    """
    dev = q.device
    aliased = _check(q, k, v, kv_len, window, softcap)
    B, Hq, D = q.shape
    _, S, Hkv, Dv = (*k.shape[:3], v.shape[-1])
    if not split_fits(Hq, Hkv, D, Dv, q.dtype, aliased):
        return attention_wide.decode(q, k, v, kv_len, window=window,
                                     softcap=softcap)
    out = torch.empty((B, Hq, Dv), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    if S == 0:
        return out.zero_()
    split, part = _split_and_scratch(B, S, Hq, Hkv, Dv, dev)
    lib = _lib()
    rc = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), B, S, Hq,
        Hkv, D, Dv, int(window or 0), float(softcap or 0.0),
        1.0 / math.sqrt(D), split, int(aliased), _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: "
                           f"{lib.decode_attention_error_string(rc).decode()}")
    _build.launch_counts["decode_attention"] += 1
    return out


def _split_and_scratch(B: int, S: int, Hq: int, Hkv: int, Dv: int,
                       dev: torch.device):
    """The split length the kernel takes at this shape, and the splits'
    (m, l, acc) scratch (None for one split), float32; the scratch goes
    back to PyTorch's stream-ordered allocator on return, after the
    launches on this stream."""
    split = decode_split(B, S, Hq, Hkv, Dv)
    ns = -(-S // split)
    part = (torch.empty(B * Hq * ns * (Dv + 2), dtype=torch.float32,
                        device=dev) if ns > 1 else None)
    return split, part


def decode_attention_partials_kernel(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        local_len: torch.Tensor, *, offset: int = 0,
        global_len: Optional[torch.Tensor] = None,
        window: Optional[int] = None, softcap: Optional[float] = None):
    """Launch ``csrc/decode_attention_partials.cu``, K6 in its partials
    mode: (acc (B, Hq, Dv), m (B, Hq), l (B, Hq)) float32 over the slice
    k/v, with the operands of :func:`decode_attention_kernel` (``local_len``
    in place of kv_len) and ``global_len`` int32 (B,) on the same device, or None
    (then no window applies, as in the plain version)."""
    dev = q.device
    aliased = _check(q, k, v, local_len, window, softcap)
    if global_len is not None and (
            global_len.shape != local_len.shape
            or global_len.dtype != torch.int32 or global_len.device != dev
            or not global_len.is_contiguous()):
        raise ValueError(f"global_len: expected contiguous int32 "
                         f"{tuple(local_len.shape)} on {dev}")
    B, Hq, D = q.shape
    _, S, Hkv, Dv = (*k.shape[:3], v.shape[-1])
    acc = torch.zeros((B, Hq, Dv), dtype=torch.float32, device=dev)
    m = torch.full((B, Hq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hq), dtype=torch.float32, device=dev)
    if not split_fits(Hq, Hkv, D, Dv, q.dtype, aliased):
        attention_wide.partials(q, k, v, local_len, acc, m, l, offset=offset,
                                global_len=global_len, window=window,
                                softcap=softcap)
        return acc, m, l
    if acc.numel() == 0 or S == 0:
        return acc, m, l
    split, part = _split_and_scratch(B, S, Hq, Hkv, Dv, dev)
    lib = _partials_lib()
    rc = lib.decode_attention_partials_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), local_len.data_ptr(),
        None if global_len is None else global_len.data_ptr(), int(offset),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        None if part is None else part.data_ptr(), B, S, Hq, Hkv, D, Dv,
        int(window or 0), float(softcap or 0.0), 1.0 / math.sqrt(D), split,
        int(aliased), _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode attention partials launch failed: "
                           f"{lib.decode_attention_partials_error_string(rc).decode()}")
    _build.launch_counts["decode_attention"] += 1
    _build.route_counts["decode_attention.partials"] += 1
    return acc, m, l


def _check(q, k, v, kv_len, window, softcap) -> bool:
    """Raise unless the operands fit the kernel (see
    :func:`decode_attention_kernel`); True when v is read inside k."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode attention kernel needs CUDA tensors, got {dev}")
    aliased = v.dim() == 4 and v_in_k(k, v)
    check_operands(("q", "k", "v"), (q, k, k if aliased else v), (3, 4, 4),
                   dev, q.dtype)
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
    if D < 1 or Dv < 1:
        raise ValueError(f"head dims D={D}, Dv={Dv} must be positive")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    if window is not None and not window > 0:
        raise ValueError(f"window must be positive, got {window}")
    return aliased


def decode_attention_info(S: int, Hq: int, Hkv: int, D: int, Dv: int,
                          dtype: torch.dtype, B: int = 1,
                          aliased: bool = False) -> dict:
    """The split kernel's registers, shared memory per block and stages
    (two tiles in flight per warp, or one) at a shape, with v read inside
    k when ``aliased``, from the built library (it launches nothing), with
    the split length and head group the wrapper takes there."""
    split = decode_split(B, S, Hq, Hkv, Dv)
    attr = (ctypes.c_int * 3)()
    lib = _lib()
    rc = lib.decode_attention_info(S, Hq, Hkv, D, Dv, split, int(aliased),
                                   _build.DTYPE_CODES[dtype], attr)
    if rc != 0:
        raise RuntimeError(f"decode attention info failed: "
                           f"{lib.decode_attention_error_string(rc).decode()}")
    return {"registers": attr[0], "smem_bytes": attr[1], "stages": attr[2],
            "split": split, "splits": -(-S // split),
            "group": group_size(Hq // Hkv, Dv)}

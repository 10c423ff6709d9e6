"""The wide route of K5 and K6: ``csrc/attention_wide_tc.cu``,
``csrc/decode_attention_wide_tc.cu`` and ``csrc/attention_wide.cu``.

The Pallas kernels take heads of any width; the port's prefill kernel
(``csrc/flash_attention.cu``) takes D and Dv up to 256 and its decode
kernel (``csrc/decode_attention.cu``) D up to 576 and Dv up to 512, within
its shared memory. :func:`flash_attention_kernel` and
:func:`decode_attention_kernel` (and its partials mode) send a call here
only above those limits: a route chosen by shape between hand-written
kernels; no config's path reaches it.

* K5 in bfloat16 launches ``attention_wide_tc.cu``: flash attention on the
  tensor cores with D cut into chunks and Dv into slices of at most 128
  columns, so it takes any width;
* K6 in bfloat16, in both modes, launches ``decode_attention_wide_tc.cu``:
  the heads of a KV group as the rows of an m16 tile on the tensor cores,
  D in chunks and Dv in slices of at most 128 columns, the cache split
  over blocks by key ranges (:func:`decode_wide_split`) and the splits
  merged by ``decode_attention.cuh``'s merge launch;
* float32 K5 and K6 (both modes) launch ``attention_wide.cu``'s
  ``wide_kernel``, the float32 check route: the simplest correct kernel
  (one block per query row and head, the online softmax in float32 over
  the visible keys, looping over D for the scores and over Dv for the
  output).

The wrappers here take operands their callers have checked
(``flash_attention.check_operands`` and ``decode_attention._check``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention_wide")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, o, kv_len, glen; offset; acc, m, l; B, Sq, Sk, Hq, Hkv,
        # D, Dv, ldv, causal, window; softcap, scale; dtype; stream
        lib.attention_wide_launch.argtypes = [p] * 6 + [i] + [p] * 3 \
            + [i] * 10 + [f, f, i, p]
        lib.attention_wide_launch.restype = ctypes.c_int
        lib.attention_wide_smem_bytes.argtypes = [i, i]
        lib.attention_wide_smem_bytes.restype = ctypes.c_longlong
        lib.attention_wide_error_string.argtypes = [ctypes.c_int]
        lib.attention_wide_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _tc_lib() -> ctypes.CDLL:
    lib = _build.load("attention_wide_tc")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, o; B, Sq, Sk, Hq, Hkv, D, Dv, causal, window; softcap,
        # scale; stream
        lib.attention_wide_tc_launch.argtypes = [p] * 4 + [i] * 9 \
            + [f, f, p]
        lib.attention_wide_tc_launch.restype = ctypes.c_int
        lib.attention_wide_tc_smem_bytes.argtypes = []
        lib.attention_wide_tc_smem_bytes.restype = ctypes.c_longlong
        lib.attention_wide_tc_error_string.argtypes = [ctypes.c_int]
        lib.attention_wide_tc_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _dec_tc_lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention_wide_tc")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, kv_len, o, glen; offset; acc, m, l, part; B, S, Hq, Hkv,
        # D, Dv, ldv, window; softcap, scale; split; stream
        lib.decode_wide_tc_launch.argtypes = [p] * 6 + [i] + [p] * 4 \
            + [i] * 8 + [f, f, i, p]
        lib.decode_wide_tc_launch.restype = ctypes.c_int
        lib.decode_wide_tc_smem_bytes.argtypes = []
        lib.decode_wide_tc_smem_bytes.restype = ctypes.c_longlong
        lib.decode_wide_tc_error_string.argtypes = [ctypes.c_int]
        lib.decode_wide_tc_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


#: keys a tile of the bf16 K6 wide kernel, the unit of its splits (kBK)
DECODE_TILE = 64
#: query heads one block of it takes (kRows: an m16 tile)
DECODE_ROWS = 16
#: columns of the widest Dv slice (kVS)
V_SLICE = 128
#: blocks of it an SM holds at once (65,280 bytes of shared memory a
#: block): a split aims at this many blocks for each SM of the card
DECODE_BLOCKS_PER_SM = 3


def v_slices(Dv: int) -> int:
    """Dv slices of the bf16 K6 (and K5) wide kernels: the fewest of at
    most :data:`V_SLICE` columns, of equal widths rounded up to 16."""
    fewest = -(-Dv // V_SLICE)
    width = -(-Dv // fewest)
    width = -(-width // 16) * 16
    return -(-Dv // width)


@functools.lru_cache(maxsize=None)
def decode_wide_split(B: int, S: int, Hq: int, Hkv: int, Dv: int,
                      sms: int) -> int:
    """Keys a split of the bf16 K6 wide kernel for a (B, S, Hkv) cache, Hq
    query heads and values of Dv on a card of ``sms`` SMs: the fewest, in
    multiples of :data:`DECODE_TILE`, that still give at most about
    :data:`DECODE_BLOCKS_PER_SM` blocks an SM."""
    tiles = -(-(Hq // Hkv) // DECODE_ROWS)
    base = max(B * Hkv * tiles * v_slices(Dv), 1)
    units = max(-(-S // DECODE_TILE), 1)
    nsplit = min(units, -(-DECODE_BLOCKS_PER_SM * sms // base))
    return -(-units // nsplit) * DECODE_TILE


def _launch_decode_tc(q, k, v, o, kv_len, *, glen=None, offset=0, acc=None,
                      m=None, l=None, window, softcap):
    B, Hq, D = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    split = decode_wide_split(B, S, Hq, Hkv, Dv,
                              _build.sm_count(q.device.index))
    nsplit = -(-S // split)
    # the splits' (acc, m, l); freed to PyTorch's stream-ordered allocator
    # on return, after the launches on this stream
    part = (torch.empty(B * Hq * nsplit * (Dv + 2), dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    lib = _dec_tc_lib()
    rc = lib.decode_wide_tc_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), _ptr(o),
        _ptr(glen), int(offset), _ptr(acc), _ptr(m), _ptr(l), _ptr(part), B,
        S, Hq, Hkv, D, Dv, v.stride(-2), int(window or 0),
        float(softcap or 0.0), 1.0 / math.sqrt(D), split,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wide decode kernel launch failed: "
                           f"{lib.decode_wide_tc_error_string(rc).decode()}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(q, k, v, o, *, kv_len=None, glen=None, offset=0, acc=None,
            m=None, l=None, Sq, causal=False, window=None, softcap=None):
    B, Hq, D = q.shape[0], q.shape[-2], q.shape[-1]
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    lib = _lib()
    rc = lib.attention_wide_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(o), _ptr(kv_len),
        _ptr(glen), int(offset), _ptr(acc), _ptr(m), _ptr(l), B, Sq, Sk, Hq,
        Hkv, D, Dv, v.stride(-2), int(causal), int(window or 0),
        float(softcap or 0.0), 1.0 / math.sqrt(D),
        _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wide attention kernel launch failed: "
                           f"{lib.attention_wide_error_string(rc).decode()}")


def _launch_tc(q, k, v, o, *, causal, window, softcap):
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    lib = _tc_lib()
    rc = lib.attention_wide_tc_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk,
        Hq, Hkv, D, Dv, int(causal), int(window or 0), float(softcap or 0.0),
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wide attention kernel launch failed: "
                           f"{lib.attention_wide_tc_error_string(rc).decode()}")


def prefill(q, k, v, *, causal, window, softcap) -> torch.Tensor:
    """K5's function: (B, Sq, Hq, Dv) in q's dtype; bfloat16 on the tensor
    cores (``attention_wide_tc.cu``), float32 on the CUDA cores."""
    B, Sq, Hq, _ = q.shape
    out = torch.empty((B, Sq, Hq, v.shape[-1]), dtype=q.dtype,
                      device=q.device)
    if out.numel():
        if q.dtype == torch.bfloat16:
            _launch_tc(q, k, v, out, causal=causal, window=window,
                       softcap=softcap)
        else:
            _launch(q, k, v, out, Sq=Sq, causal=causal, window=window,
                    softcap=softcap)
        _build.launch_counts["flash_attention"] += 1
        _build.route_counts["flash_attention.wide"] += 1
    return out


def decode(q, k, v, kv_len, *, window, softcap) -> torch.Tensor:
    """K6's function: (B, Hq, Dv) in q's dtype; v may be k's first
    columns (its row stride is k's). bfloat16 on the tensor cores
    (``decode_attention_wide_tc.cu``), float32 on the CUDA cores."""
    B, Hq, _ = q.shape
    out = torch.empty((B, Hq, v.shape[-1]), dtype=q.dtype, device=q.device)
    if out.numel():
        if q.dtype != torch.bfloat16:
            _launch(q, k, v, out, kv_len=kv_len, Sq=1, window=window,
                    softcap=softcap)
        elif k.shape[1] == 0:
            return out.zero_()               # no key: o = 0, no launch
        else:
            _launch_decode_tc(q, k, v, out, kv_len, window=window,
                              softcap=softcap)
        _build.launch_counts["decode_attention"] += 1
        _build.route_counts["decode_attention.wide"] += 1
    return out


def partials(q, k, v, local_len, acc, m, l, *, offset, global_len, window,
             softcap) -> None:
    """K6's partials mode into ``acc``, ``m``, ``l`` (filled in place;
    they arrive as 0, -1e30 and 0, what a slice with no key keeps)."""
    if acc.numel():
        window = window if global_len is not None else None
        if q.dtype != torch.bfloat16:
            _launch(q, k, v, None, kv_len=local_len, glen=global_len,
                    offset=offset, acc=acc, m=m, l=l, Sq=1, window=window,
                    softcap=softcap)
        elif k.shape[1] == 0:
            return                           # no key, no launch
        else:
            _launch_decode_tc(q, k, v, None, local_len, glen=global_len,
                              offset=offset, acc=acc, m=m, l=l,
                              window=window, softcap=softcap)
        _build.launch_counts["decode_attention"] += 1
        _build.route_counts["decode_attention.partials_wide"] += 1


def smem_bytes(D: int, Dv: int) -> int:
    """Shared memory one block of ``wide_kernel`` takes at head widths D and
    Dv (CUDA build needed)."""
    return int(_lib().attention_wide_smem_bytes(D, Dv))


def tc_smem_bytes() -> int:
    """Shared memory one block of K5's bfloat16 wide route takes, the same
    at every width (CUDA build needed)."""
    return int(_tc_lib().attention_wide_tc_smem_bytes())


def decode_tc_smem_bytes() -> int:
    """Shared memory one block of K6's bfloat16 wide route takes, the same
    at every width (CUDA build needed)."""
    return int(_dec_tc_lib().decode_wide_tc_smem_bytes())

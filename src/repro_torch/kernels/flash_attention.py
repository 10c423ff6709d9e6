"""Flash attention for prefill: CUDA kernel wrapper + plain version.

Port of ``repro/kernels/flash_attention.py``. For q (B, Sq, Hq, D),
k (B, Sk, Hkv, D) and v (B, Sk, Hkv, Dv), with Hq a multiple of Hkv (GQA),
it computes softmax attention in float32 and returns (B, Sq, Hq, Dv) in
q's dtype. Queries sit at the end of the keys (query i has position
i + Sk - Sq); q is scaled by 1/sqrt(D) before the product, the logit
softcap comes after the scale and before the mask, and with ``causal`` a
``window`` keeps the last ``window`` positions.

* :func:`flash_attention_kernel` launches a CUDA kernel on CUDA tensors
  (it raises for anything else), on the route :func:`choose_route` picks
  by dtype and shape before the launch (no route falls back to another:
  a failed build or launch raises):

  - ``split`` (bfloat16, one query, D at most 576 and Dv at most 512):
    K6's split-KV kernels (``csrc/decode_attention.cu``, its split kernel
    and merge launch) with kv_len Sk for every sequence. Query Sk - 1
    sees every key, and with a causal window the keys above
    Sk - 1 - window: K6's rule, so the two compute the same function. A
    non-causal call ignores its window, so the window goes to K6 only
    when the call is causal. The keys are split until the blocks fill the
    card, and a block takes up to 8 query heads of a KV group
    (:func:`~repro_torch.kernels.decode_attention.decode_split`,
    :func:`~repro_torch.kernels.decode_attention.group_size`); heads that
    K6's kernel does not take (its ``split_fits``) stay on the routes
    below;
  - ``wgmma`` (bfloat16, more than one query, D and Dv multiples of 8 from
    :data:`WGMMA_MIN_WIDTH` to 256, q, k and v on 16-byte bases):
    ``csrc/flash_attention_wgmma.cu``, warpgroup products fed by TMA;
  - ``bf16_tc`` (the other bfloat16 calls: heads narrower than
    :data:`WGMMA_MIN_WIDTH`, and widths off the 8-column grid and bases off
    the 16-byte grid, which TMA cannot address):
    ``csrc/flash_attention.cu``'s mma.sync kernel with cp.async;
  - ``f32`` (float32): ``csrc/flash_attention.cu``'s CUDA-core kernel;
  - ``wide`` (D or Dv above :data:`MAX_HEAD_DIM`, but for ``split``):
    :mod:`repro_torch.kernels.attention_wide` (``csrc/attention_wide_tc.cu``
    in bfloat16, ``csrc/attention_wide.cu`` in float32);

* :func:`launch_route` launches a named route without the choice, for
  comparing routes at one shape;
* :func:`flash_attention_plain` is the same function in tensor ops, with
  the (B, Hkv, rep, Sq, Sk) scores materialised, used for CPU tensors and
  as the kernel's yardstick on the card;
* :func:`flash_attention_tiled` is the ``wgmma`` route's tiling in tensor
  ops (query tiles of its rows, key tiles of its widths, P rounded to
  bfloat16 once a tile, an online rescale per tile), for the tests;
* :class:`FlashAttentionFn` gives the kernel a gradient: its forward
  launches the kernel, its backward recomputes the plain version under
  autograd. The TPU kernel has no backward kernel (the JAX package has no
  ``custom_vjp``; JAX differentiates its reference), so a plain backward
  is the faithful port; a backward kernel is later work (ROADMAP.md).

Each call adds one to ``launch_counts["flash_attention"]`` and to
``route_counts["flash_attention.<route>"]``, whatever the route launches
(``split`` makes K6's two CUDA launches and counts nothing under
``decode_attention``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import _build, attention_wide

NEG_INF = -1e30
#: the widest D and Dv of ``csrc/flash_attention.cu``; wider heads take
#: the wide route
MAX_HEAD_DIM = 256
#: columns of one of the ``wgmma`` route's shared-memory panels (128
#: bytes), and the V columns of one of its launches (two panels)
WGMMA_PANEL, WGMMA_SLICE = 64, 128
#: the narrowest D and Dv :func:`choose_route` sends the ``wgmma`` route
WGMMA_MIN_WIDTH = 32
#: query rows a block of the ``wgmma`` route (two warpgroups of 64)
WGMMA_ROWS = 128
#: stages of the ``wgmma`` route's TMA ring at most
WGMMA_MAX_STAGES = 4
_MAX_SMEM = 232448       # a block's shared memory on Hopper (227 KB)
#: the bfloat16 routes, in the order :func:`choose_route` tries them
ROUTES_BF16 = ("split", "wgmma", "bf16_tc")


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


def wgmma_plan(D: int, Dv: int) -> Tuple[int, int, int, int]:
    """(keys a tile, stages of the ring, dynamic shared memory a block,
    launches a call) of the ``wgmma`` route at widths D, Dv, as
    ``csrc/flash_attention_wgmma.cu`` lays them out for its first slice
    of Dv: Dv in slices of :data:`WGMMA_SLICE` columns, a launch each; Q's
    128 rows and the stages of K and V tiles, each as panels of 64 columns
    x 128 bytes, and three barriers a stage; 128 keys a tile where the
    slice is one panel, else 64; as many stages as fit in 227 KB, up to
    :data:`WGMMA_MAX_STAGES`."""
    kd = -(-D // WGMMA_PANEL)
    nv = min(-(-Dv // WGMMA_PANEL), WGMMA_SLICE // WGMMA_PANEL)
    smem = lambda bk, st: 1024 + 128 * WGMMA_ROWS * kd \
        + st * 128 * bk * (kd + nv) + 8 * (1 + 3 * st)
    bk = 128 if nv == 1 else 64
    st = 2
    while st < WGMMA_MAX_STAGES and smem(bk, st + 1) <= _MAX_SMEM:
        st += 1
    return bk, st, smem(bk, st), -(-Dv // WGMMA_SLICE)


def flash_attention_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          round_p: bool = False,
                          block_k: Optional[int] = None) -> torch.Tensor:
    """The ``wgmma`` route's algorithm in float32 tensor ops: queries in
    tiles of :data:`WGMMA_ROWS`; for each, the key tiles of ``block_k``
    (default :func:`wgmma_plan`'s) that some query of the tile sees, in
    order (tiles wholly before the window or after the causal edge are
    skipped); per tile the scores in log2 units (x 1/sqrt(D) log2(e), or
    the softcap's tanh), -1e30 where masked, the row's running max m, the
    rescale ex2(m_old - m_new) of l and O, P = ex2(s - m), l summed from P
    in float32, and O += P . V with P rounded to bfloat16 when ``round_p``
    (the kernel's A operand); o = O / max(l, 1e-30)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = (*k.shape[:3], v.shape[-1])
    rep = Hq // Hkv
    bk = block_k or wgmma_plan(D, Dv)[0]
    f = torch.float32
    qf = q.to(f).reshape(B, Sq, Hkv, rep, D).permute(0, 2, 3, 1, 4)
    kf, vf = k.to(f).transpose(1, 2), v.to(f).transpose(1, 2)
    scale, log2e = 1.0 / math.sqrt(D), 1.0 / math.log(2.0)
    out = torch.zeros((B, Hkv, rep, Sq, Dv), dtype=f, device=q.device)
    offset = Sk - Sq
    for q0 in range(0, Sq, WGMMA_ROWS):
        q1 = min(q0 + WGMMA_ROWS, Sq)
        qpos = torch.arange(q0, q1, device=q.device)[:, None] + offset
        k_lo, k_hi = 0, Sk
        if causal:
            k_hi = min(Sk, q1 + offset)
            if window is not None:
                k_lo = max(0, q0 + offset - window + 1)
        m = torch.full((B, Hkv, rep, q1 - q0), NEG_INF, dtype=f,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, rep, q1 - q0, Dv), dtype=f,
                          device=q.device)
        for k0 in range(k_lo // bk * bk, max(k_hi, 0), bk):
            kt, vt = kf[:, :, None, k0:k0 + bk], vf[:, :, None, k0:k0 + bk]
            s = qf[..., q0:q1, :] @ kt.transpose(-1, -2)
            if softcap is not None:
                x = softcap * torch.tanh(s * scale / softcap) * log2e
            else:
                x = s * (scale * log2e)
            if causal:
                kpos = torch.arange(k0, k0 + kt.shape[-2],
                                    device=q.device)[None, :]
                ok = kpos <= qpos
                if window is not None:
                    ok &= kpos > qpos - window
                x = x.masked_fill(~ok, NEG_INF)
            mx = torch.maximum(m, x.amax(-1))
            c = torch.exp2(m - mx)
            p = torch.exp2(x - mx[..., None])
            l = l * c + p.sum(-1)
            if round_p:
                p = p.to(torch.bfloat16).to(f)
            acc = acc * c[..., None] + p @ vt
            m = mx
        out[..., q0:q1, :] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dv).to(q.dtype)


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


def _wgmma_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_wgmma")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # q, k, v, o; B, Sq, Sk, Hq, Hkv, D, Dv, causal, window; softcap,
        # scale; stream
        lib.flash_attention_wgmma_launch.argtypes = [p, p, p, p] + [i] * 9 \
            + [f, f, p]
        lib.flash_attention_wgmma_launch.restype = ctypes.c_int
        lib.flash_attention_wgmma_info.argtypes = [i, i, p]
        lib.flash_attention_wgmma_info.restype = ctypes.c_int
        lib.flash_attention_wgmma_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_wgmma_error_string.restype = ctypes.c_char_p
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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], softcap: Optional[float]) -> None:
    """Raise unless q, k, v fit the kernels (see
    :func:`flash_attention_kernel`)."""
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


def route_takes(route: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> bool:
    """True when ``route`` can compute attention of these operands (its
    dtype, widths and, for ``wgmma``, the 16-byte bases TMA needs),
    whatever :func:`choose_route` would pick."""
    D, Dv = q.shape[-1], v.shape[-1]
    bf16 = q.dtype == torch.bfloat16
    narrow = D <= MAX_HEAD_DIM and Dv <= MAX_HEAD_DIM
    if route == "split":
        from repro_torch.kernels import decode_attention as da
        return (bf16 and q.shape[1] == 1
                and da.split_fits(q.shape[2], k.shape[2], D, Dv, q.dtype,
                                  False))
    if route == "wgmma":
        return (bf16 and narrow and D % 8 == 0 and Dv % 8 == 0
                and (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0)
    if route in ("bf16_tc", "f32"):
        return narrow and _build.ROUTES[q.dtype] == route
    return route == "wide" and not narrow


def choose_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route :func:`flash_attention_kernel` launches: ``split`` for one
    bfloat16 query where K6's kernel takes the heads; ``wgmma`` for more
    queries where TMA can address the tiles and D and Dv are at least
    :data:`WGMMA_MIN_WIDTH`; else ``bf16_tc`` (bfloat16), ``f32``
    (float32) or, above :data:`MAX_HEAD_DIM`, ``wide``. Narrower heads
    would leave more than half of ``wgmma``'s 64-column panels as zeros
    that it computes over; none of the zoo's is that narrow."""
    if q.dtype == torch.bfloat16:
        if q.shape[1] == 1 and route_takes("split", q, k, v):
            return "split"
        if (q.shape[1] > 1
                and min(q.shape[-1], v.shape[-1]) >= WGMMA_MIN_WIDTH
                and route_takes("wgmma", q, k, v)):
            return "wgmma"
    if max(q.shape[-1], v.shape[-1]) > MAX_HEAD_DIM:
        return "wide"
    return _build.ROUTES[q.dtype]


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Launch K5 on the route :func:`choose_route` picks: (B, Sq, Hq, Dv)
    in q's dtype.

    q, k, v contiguous, of one float dtype, on one CUDA device; Hq a
    multiple of Hkv.
    """
    _check(q, k, v, window, softcap)
    return _launch(choose_route(q, k, v), q, k, v, causal, window, softcap)


def launch_route(route: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *, causal: bool = True,
                 window: Optional[int] = None,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """K5 on ``route`` (one of :data:`ROUTES_BF16`, ``f32`` or ``wide``),
    whatever :func:`choose_route` would pick; raises where the route
    cannot take the operands (:func:`route_takes`)."""
    _check(q, k, v, window, softcap)
    if not route_takes(route, q, k, v):
        raise ValueError(f"route {route!r} does not take q {tuple(q.shape)} "
                         f"{q.dtype}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    return _launch(route, q, k, v, causal, window, softcap)


@functools.lru_cache(maxsize=64)
def _full_lengths(B: int, Sk: int, device: torch.device) -> torch.Tensor:
    """kv_len = Sk for each of B sequences, int32 on ``device``: the
    ``split`` route's lengths, made once per shape."""
    return torch.full((B,), Sk, dtype=torch.int32, device=device)


def _launch(route, q, k, v, causal, window, softcap) -> torch.Tensor:
    if route == "wide":
        return attention_wide.prefill(q, k, v, causal=causal, window=window,
                                      softcap=softcap)
    dev = q.device
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = (*k.shape[:3], v.shape[-1])
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "split":
        from repro_torch.kernels import decode_attention as da
        if Sk == 0:
            return out.zero_()
        split, part = da._split_and_scratch(B, Sk, Hq, Hkv, Dv, dev)
        lib = da._lib()
        rc = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _full_lengths(B, Sk, dev).data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), B, Sk, Hq, Hkv, D, Dv,
            int(window or 0) if causal else 0, float(softcap or 0.0),
            1.0 / math.sqrt(D), split, 0, _build.DTYPE_CODES[q.dtype],
            stream)
        err = lib.decode_attention_error_string
    elif route == "wgmma":
        lib = _wgmma_lib()
        rc = lib.flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, Hq, Hkv, D, Dv, int(causal), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(D), stream)
        err = lib.flash_attention_wgmma_error_string
    else:
        lib = _lib()
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, Hq, Hkv, D, Dv, int(causal), int(window or 0),
            float(softcap or 0.0), 1.0 / math.sqrt(D),
            _build.DTYPE_CODES[q.dtype], stream)
        err = lib.flash_attention_error_string
    if rc != 0:
        raise RuntimeError(f"flash attention kernel ({route}) launch failed: "
                           f"{err(rc).decode()}")
    _build.launch_counts["flash_attention"] += 1
    _build.route_counts[f"flash_attention.{route}"] += 1
    return out


def flash_attention_smem_bytes(D: int, Dv: int, dtype: torch.dtype) -> int:
    """Shared memory one block of the kernel takes for head widths D, Dv
    in ``dtype``'s route (CUDA build needed)."""
    return int(_lib().flash_attention_smem_bytes(D, Dv,
                                                 _build.DTYPE_CODES[dtype]))


def flash_attention_wgmma_info(D: int, Dv: int) -> dict:
    """The ``wgmma`` kernel at widths D, Dv (of its first slice of Dv): its
    registers, spilled bytes a thread, dynamic shared memory a block, keys
    a tile, stages of the ring and launches a call, from the built library
    (it launches nothing)."""
    attr = (ctypes.c_int * 6)()
    lib = _wgmma_lib()
    rc = lib.flash_attention_wgmma_info(D, Dv, attr)
    if rc != 0:
        msg = lib.flash_attention_wgmma_error_string(rc).decode()
        raise RuntimeError(f"flash attention wgmma info failed: {msg}")
    return {"registers": attr[0], "smem_bytes": attr[1],
            "block_k": attr[2], "spill_bytes": attr[3], "stages": attr[4],
            "launches": attr[5]}


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

"""Mamba2 SSD chunked scan: CUDA kernel wrapper + plain version, and the
single-step recurrence that decode uses.

Port of ``repro/kernels/ssd_scan.py`` and of ``ssd_scan_ref`` /
``ssd_step_ref`` in ``repro/kernels/ref.py``. Shapes:

    x  (b, s, h, p)   per-head inputs             (model dtype)
    dt (b, s, h)      softplus-ed step sizes > 0  (float32)
    A  (h,)           negative decay rates        (float32)
    B  (b, s, g, n)   input maps, head h reads group h // (h / g)
    C  (b, s, g, n)   output maps
    D  (h,) or None   skip connection             (float32)

and the scan returns (y (b, s, h, p) in x's dtype, final state
(b, h, p, n) float32); D is added before the cast.

* :func:`ssd_scan_kernel` launches ``csrc/ssd_scan.cu`` on CUDA tensors
  (it raises for anything else): bfloat16 takes the tensor-core route
  (``bf16_tc``: a chunk pass, a state pass and a scan pass; above n
  :data:`WHOLE_STATE` B, C and the state in slabs of :data:`SLAB`
  columns), float32 the CUDA-core kernel (``f32``, the float32 check
  route: every operand through 32 x 32 tiles, so it takes every chunk, p
  and n); :func:`ssd_scan_plan` gives the tiles and shared memory of
  either;
* :func:`ssd_scan_plain` is the chunked algorithm in tensor ops, used for
  CPU tensors and as the kernel's yardstick on the card;
* :func:`ssd_scan_chunked` is the ``bf16_tc`` route's three passes in
  tensor ops, in its slabs of n, optionally with its bfloat16 hi/lo splits
  emulated, for the tests (nothing on the main path calls it);
* :class:`SSDScanFn` gives the kernel a gradient: its forward launches
  the kernel, its backward recomputes :func:`ssd_scan_plain` under
  autograd. The TPU kernel has no backward kernel (the JAX package
  differentiates its reference), so a plain backward is the faithful
  port; a backward kernel is later work (ROADMAP.md);
* :func:`ssd_step` is one decode step, plain tensor ops on any device (the
  JAX package has no kernel for it either).
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check_operands

_MAX_SMEM = 227 * 1024          # per-block shared memory on Hopper
#: the widest state the tensor-core route stages whole (``kMaxState``)
WHOLE_STATE = 256
#: columns of n a slab of the tensor-core route above it (``kSlab``)
SLAB = 128
#: rows, columns, p and n of a tile of the float32 route (``f32::kT``)
F32_TILE = 32


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   D: Optional[torch.Tensor] = None, *, chunk: int = 128,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    if pad:     # zero steps (dt = 0) neither decay nor feed the state
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    S = x.shape[1]
    nc = S // chunk
    acc = torch.promote_types(x.dtype, torch.float32)   # float64 stays
    xq = x.reshape(b, nc, chunk, h, p).to(acc)
    dtq = dt.reshape(b, nc, chunk, h).to(acc)
    Bq = B.reshape(b, nc, chunk, g, n).to(acc).repeat_interleave(rep, dim=3)
    Cq = C.reshape(b, nc, chunk, g, n).to(acc).repeat_interleave(rep, dim=3)
    A32 = A.to(acc)
    above = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).triu(1)[None, :, :, None]
    state = torch.zeros(b, h, p, n, dtype=acc, device=x.device)
    ys = []
    for c in range(nc):
        xb, dtb, Bh, Ch = xq[:, c], dtq[:, c], Bq[:, c], Cq[:, c]
        cum = torch.cumsum(dtb * A32, dim=1)                  # (b,q,h)
        li = cum[:, :, None, :] - cum[:, None, :, :]          # (b,q,q,h)
        # li > 0 above the diagonal, where exp overflows; masking before
        # the exp keeps the forward and its gradient finite (inf x 0 = NaN)
        Lmat = torch.exp(li.masked_fill(above, float("-inf")))
        cb = torch.einsum("bihn,bjhn->bijh", Ch, Bh)
        w = cb * Lmat * dtb[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", w, xb)
        y = y + torch.einsum("bihn,bhpn->bihp", Ch, state) * torch.exp(cum)[..., None]
        decay = torch.exp(cum[:, -1:, :] - cum)              # (b,q,h)
        contrib = torch.einsum("bjh,bjhp,bjhn->bhpn", decay * dtb, xb, Bh)
        state = torch.exp(cum[:, -1, :])[..., None, None] * state + contrib
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, S, h, p)[:, :s]
    if D is not None:
        y = y + x[:, :s].to(acc) * D.to(acc)[None, None, :, None]
    return y.to(x.dtype), state


def _split_bf16(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = bf16(v)`` and ``lo = bf16(v - hi)``, back in
    v's dtype: the kernel's two-term bfloat16 split of a float32 operand."""
    hi = v.to(torch.bfloat16).to(v.dtype)
    return hi, (v - hi).to(torch.bfloat16).to(v.dtype)


def _pieces(total: int, width: int) -> List[Tuple[int, int]]:
    """``(start, length)`` of consecutive pieces of at most ``width`` that
    cover ``[0, total)`` once."""
    return [(s, min(width, total - s)) for s in range(0, total, width)]


def _bf16_smem(chunk: int, p: int, n: int) -> int:
    """Shared memory a block of the ``bf16_tc`` route takes at a chunk,
    head width p and state n: the larger of its chunk and scan passes."""
    up16 = lambda v: -(-v // 16) * 16
    q, pp, nn = up16(chunk), up16(p), up16(n)
    if n <= WHOLE_STATE:
        pass1 = 2 * (q * (max(pp, nn) + 8) + q * (nn + 8))
        pass3 = 2 * (q * (pp + 8) + q * (nn + 8)) + 4 * pp * (nn + 4)
    else:
        pass1 = 2 * (q * (max(pp, SLAB) + 8) + q * (SLAB + 8))
        pass3 = 2 * (q * (pp + 8) + 64 * (SLAB + 8)) \
            + 4 * min(pp, 128) * (SLAB + 4)
    cum = 4 * (2 * q + 32)                  # cum, dt and 32 warp totals
    return max(pass1, pass3) + cum


def ssd_scan_plan(chunk: int, p: int, n: int, dtype: torch.dtype) -> dict:
    """The kernel's tiles at a chunk, head width p and state n, as
    ``csrc/ssd_scan.cu`` lays them out: ``smem_bytes`` a block takes (its
    ``ssd_scan_smem_bytes`` at the slab's p), ``p_slices`` (the columns of
    p each block takes), ``n_slabs`` (the columns of n staged at once) and
    ``p_slabs`` (the columns of p the wrapper runs as calls of their own).
    float32: blocks of 32 columns of p and 32 x 32 tiles, the same 21,120
    bytes at every shape, one p slab. bfloat16: one block a head; n whole
    up to :data:`WHOLE_STATE`, else in slabs of :data:`SLAB`; its bytes
    grow with the chunk and p, so where the whole p would pass 227 KB the
    columns of p go in the fewest equal slabs (multiples of 16 but the
    last) that fit: each column of y and of the state depends on its own
    column of x alone. A chunk too long for even 16 columns leaves
    ``smem_bytes`` above 227 KB (the wrapper raises)."""
    if dtype == torch.float32:
        t = F32_TILE
        return {"smem_bytes": 4 * 5 * t * (t + 1), "p_slices": _pieces(p, t),
                "n_slabs": _pieces(n, t), "p_slabs": [(0, p)]}
    up16 = lambda v: -(-v // 16) * 16
    for parts in range(1, -(-p // 16) + 1):
        width = up16(-(-p // parts))
        if _bf16_smem(chunk, width, n) <= _MAX_SMEM:
            break
    slabs = _pieces(n, SLAB) if n > WHOLE_STATE else [(0, n)]
    return {"smem_bytes": _bf16_smem(chunk, width, n), "p_slices": [(0, p)],
            "n_slabs": slabs, "p_slabs": _pieces(p, width)}


def ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor,
                     D: Optional[torch.Tensor] = None, *, chunk: int = 128,
                     split_bf16: bool = False,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan in the ``bf16_tc`` route's chunk-parallel form.

    1. chunk pass: per chunk, ``w_j = exp(cum_last - cum_j) dt_j`` and the
       chunk's own state ``S_loc = (w o X)^T B``;
    2. state pass: ``state_c = exp(cum_last_c) state_{c-1} + S_loc_c``,
       keeping the state entering each chunk;
    3. scan pass: ``y = exp(cum_i) C_i . state_in^T + W . X + D x`` with
       ``W = (C B^T) o exp(cum_i - cum_j) o dt_j`` for ``j <= i``.

    Above n :data:`WHOLE_STATE`, ``C B^T`` and ``C_i . state_in^T`` are
    sums of their slabs' products over n in slab order
    (:func:`ssd_scan_plan`), as the route's slab kernels add them
    (``S_loc``'s columns need no sum across slabs).

    With ``split_bf16`` each float32 operand the kernel forms itself (``w o
    X``, ``W``, ``state_in``) enters its products as ``hi . Y + lo . Y``
    (:func:`_split_bf16`), as the kernel's tensor cores take it; x, B and C
    are used as given (the kernel's are bfloat16, exact on the tensor
    cores). Returns (y in x's dtype, final state float32).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-s) % chunk
    if pad:     # zero steps (dt = 0) neither decay nor feed the state
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk
    acc = torch.promote_types(x.dtype, torch.float32)
    xq = x.reshape(b, nc, chunk, h, p).to(acc)
    dtq = dt.reshape(b, nc, chunk, h).to(acc)
    Bq = B.reshape(b, nc, chunk, g, n).to(acc).repeat_interleave(rep, dim=3)
    Cq = C.reshape(b, nc, chunk, g, n).to(acc).repeat_interleave(rep, dim=3)

    def product(eq, v, other):
        if not split_bf16:
            return torch.einsum(eq, v, other)
        hi, lo = _split_bf16(v)
        return torch.einsum(eq, hi, other) + torch.einsum(eq, lo, other)

    # 1. chunk pass
    cum = torch.cumsum(dtq * A.to(acc), dim=2)                # (b,nc,q,h)
    last = cum[:, :, -1:, :]
    w = torch.exp(last - cum) * dtq
    s_loc = product("bcjhp,bcjhn->bchpn", w[..., None] * xq, Bq)
    # 2. state pass
    state = torch.zeros(b, h, p, n, dtype=acc, device=x.device)
    state_in = []
    for c in range(nc):
        state_in.append(state)
        state = torch.exp(last[:, c, 0])[..., None, None] * state + s_loc[:, c]
    state_in = torch.stack(state_in, dim=1)                   # (b,nc,h,p,n)
    # 3. scan pass
    slabs = ssd_scan_plan(chunk, p, n, torch.bfloat16)["n_slabs"]

    def over_slabs(eq, u, v, split):         # sum over n, slab after slab
        out = 0
        for n0, nw in slabs:
            u_s, v_s = u[..., n0:n0 + nw], v[..., n0:n0 + nw]
            out = out + (product(eq, u_s, v_s) if split
                         else torch.einsum(eq, u_s, v_s))
        return out

    y = over_slabs("bchpn,bcihn->bcihp", state_in, Cq, True) \
        * torch.exp(cum)[..., None]
    above = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).triu(1)[:, :, None]
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (b,nc,i,j,h)
    W = over_slabs("bcihn,bcjhn->bcijh", Cq, Bq, False) \
        * torch.exp(li.masked_fill(above, float("-inf"))) * dtq[:, :, None]
    y = y + product("bcijh,bcjhp->bcihp", W, xq)
    y = y.reshape(b, nc * chunk, h, p)[:, :s]
    if D is not None:
        y = y + x[:, :s].to(acc) * D.to(acc)[None, None, :, None]
    return y.to(x.dtype), state


def _scratch_shapes(b: int, s: int, h: int, p: int, g: int, n: int,
                    chunk: int):
    """Shapes of the ``bf16_tc`` route's float32 scratch: the chunks'
    states (b, nc, h, p, n), their total decays (b, nc, h) and C . B^T per
    chunk and group (b, nc, g, Q16, Q16), Q16 the chunk rounded up to 16."""
    nc, q16 = -(-s // chunk), -(-chunk // 16) * 16
    return (b, nc, h, p, n), (b, nc, h), (b, nc, g, q16, q16)


def ssd_scan_scratch_bytes(b: int, s: int, h: int, p: int, g: int, n: int,
                           chunk: int) -> int:
    """Bytes of float32 scratch the ``bf16_tc`` route takes."""
    return sum(4 * math.prod(shape)
               for shape in _scratch_shapes(b, s, h, p, g, n, chunk))


def ssd_scan_smem_bytes(chunk: int, p: int, n: int,
                        dtype: torch.dtype) -> int:
    """Shared memory one block of the kernel takes (the larger of the
    chunk and scan passes in the bf16 route), from the built library
    (CUDA build needed); :func:`ssd_scan_plan` computes the same on the
    host."""
    return int(_lib().ssd_scan_smem_bytes(chunk, p, n,
                                          _build.DTYPE_CODES[dtype]))


def ssd_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor,
             D: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. state (b, h, p, n) float32; x_t (b, h, p);
    dt_t (b, h); B_t, C_t (b, g, n). Returns (y_t (b, h, p) in x_t's dtype,
    new state)."""
    h = state.shape[1]
    rep = h // B_t.shape[1]
    Bh = B_t.float().repeat_interleave(rep, dim=1)            # (b,h,n)
    Ch = C_t.float().repeat_interleave(rep, dim=1)
    dA = torch.exp(dt_t.float() * A.float()[None, :])
    state_new = state * dA[..., None, None] + \
        (dt_t.float()[..., None, None] * x_t.float()[..., None]
         * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state_new, Ch)
    if D is not None:
        y = y + x_t.float() * D.float()[None, :, None]
    return y.to(x_t.dtype), state_new


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        # x, dt, A, B, C, D, y, state, s_loc, decay, cbuf, scr; b, s, h,
        # p, g, n, chunk, dtype; stream
        lib.ssd_scan_launch.argtypes = [p] * 12 + [i] * 8 + [p]
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [i, i, i, i]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def ssd_scan_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor,
                    D: Optional[torch.Tensor] = None, *, chunk: int = 128,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/ssd_scan.cu``: (y (b, s, h, p) in x's dtype, final
    state (b, h, p, n) float32).

    x, B, C contiguous and of one float dtype; dt, A, D contiguous
    float32; all on one CUDA device; h a multiple of g. bfloat16 takes the
    tensor-core route at any n, with :func:`ssd_scan_scratch_bytes` of
    float32 scratch; where its blocks' shared memory (set by the chunk and
    p) would pass 227 KB it runs slabs of p as launches of their own
    (:func:`ssd_scan_plan`'s ``p_slabs``, :func:`over_p_slabs`), counted
    as one call; float32 takes the CUDA-core route at
    every shape, with 3 min(chunk, s) floats of scratch a block (a chunk
    longer than s runs as a chunk of s, the same scan).
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"SSD scan kernel needs CUDA tensors, got {dev}")
    check_operands(("x", "B", "C"), (x, B, C), (4, 4, 4), dev, x.dtype)
    f32 = [("dt", dt, 3), ("A", A, 1)] + ([("D", D, 1)] if D is not None else [])
    check_operands(*zip(*f32), dev, torch.float32)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, g, n) \
            or C.shape != B.shape or (D is not None and D.shape != (h,)):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not fit together")
    if g == 0 or h % g:
        raise ValueError(f"{h} heads are not a multiple of {g} groups")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if x.dtype == torch.float32 and s:
        # a chunk longer than the sequence is one chunk of the sequence
        # (the steps past it are zeros): the same scan, in less scratch
        chunk = min(chunk, s)
    plan = ssd_scan_plan(chunk, p, n, x.dtype)
    if plan["smem_bytes"] > _MAX_SMEM:
        raise ValueError(f"chunk {chunk} needs {plan['smem_bytes']} bytes of "
                         f"shared memory in the bf16 route at 16 columns of "
                         f"p, more than {_MAX_SMEM}")
    if b * h == 0:
        return torch.empty_like(x), torch.empty(
            (b, h, p, n), dtype=torch.float32, device=dev)
    run = lambda xs: _launch(xs, dt, A, B, C, D, chunk, plan)
    y, state = (run(x) if len(plan["p_slabs"]) == 1
                else over_p_slabs(run, x, plan["p_slabs"]))
    _build.launch_counts["ssd_scan"] += 1
    _build.route_counts[f"ssd_scan.{_build.ROUTES[x.dtype]}"] += 1
    return y, state


def over_p_slabs(run: Callable, x: torch.Tensor,
                 slabs: List[Tuple[int, int]],
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, state) of an SSD scan over x (b, s, h, p) from ``run`` on each
    slab of p columns (``(start, width)``, :func:`ssd_scan_plan`'s
    ``p_slabs``), each slab's x copied contiguous: y and the state of a
    column depend on that column of x alone (D is per head), so the slabs'
    y and states side by side are the whole scan's."""
    b, s, h, p = x.shape
    y = torch.empty_like(x)
    state = None
    for p0, w in slabs:
        y_s, st_s = run(x[..., p0:p0 + w].contiguous())
        if state is None:
            state = torch.empty(st_s.shape[:2] + (p,) + st_s.shape[3:],
                                dtype=st_s.dtype, device=st_s.device)
        y[..., p0:p0 + w] = y_s
        state[:, :, p0:p0 + w] = st_s
    return y, state


def _launch(x, dt, A, B, C, D, chunk, plan):
    """One launch of ``csrc/ssd_scan.cu`` over x's columns: (y, state)."""
    dev = x.device
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    scratch = [None] * 4                     # s_loc, decay, cbuf, scr
    if x.dtype == torch.bfloat16:
        scratch[:3] = [torch.empty(shape, dtype=torch.float32, device=dev)
                       for shape in _scratch_shapes(b, s, h, p, g, n, chunk)]
    elif s > 0:
        blocks = b * h * len(plan["p_slices"])
        scratch[3] = torch.empty(blocks * 3 * chunk, dtype=torch.float32,
                                 device=dev)
    lib = _lib()
    ptr = lambda t: t.data_ptr() if t is not None else None
    rc = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        ptr(D), y.data_ptr(), state.data_ptr(), *map(ptr, scratch), b, s, h,
        p, g, n, chunk, _build.DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"SSD scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(rc).decode()}")
    return y, state


class SSDScanFn(torch.autograd.Function):
    """The SSD scan through ``forward`` (the kernel on the card) with the
    plain version's gradient: the backward recomputes :func:`ssd_scan_plain`
    from the saved inputs under autograd, for whichever of y and the final
    state received a gradient. ``forward`` is an argument so that a CPU
    test can run this Function with the plain forward standing in."""

    @staticmethod
    def forward(ctx, forward: Callable, x, dt, A, B, C, D, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, D)
        return forward(x, dt, A, B, C, D, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_()
                   for t in saved]
            y, state = ssd_scan_plain(*ins, chunk=ctx.chunk)
        pairs = [(o, g) for o, g in ((y, grad_y), (state, grad_state))
                 if g is not None]
        live = [t for t in ins if t is not None]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], live,
                                         [g for _, g in pairs],
                                         allow_unused=True)
                     if pairs else [None] * len(live))
        return (None, *(None if t is None else next(grads) for t in ins),
                None)


def ssd_scan_grad(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor,
                  D: Optional[torch.Tensor] = None, *, chunk: int = 128,
                  forward: Callable = ssd_scan_kernel,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan_kernel` (or ``forward``) with a gradient."""
    return SSDScanFn.apply(forward, x, dt, A, B, C, D, chunk)

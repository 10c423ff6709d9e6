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
  (``bf16_tc``: a chunk pass, a state pass and a scan pass), float32 the
  CUDA-core kernel (``f32``);
* :func:`ssd_scan_plain` is the chunked algorithm in tensor ops, used for
  CPU tensors and as the kernel's yardstick on the card;
* :func:`ssd_scan_chunked` is the ``bf16_tc`` route's three passes in
  tensor ops, optionally with its bfloat16 hi/lo splits emulated, for the
  tests (nothing on the main path calls it);
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
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check_operands

_MAX_SMEM = 227 * 1024          # per-block shared memory on Hopper


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
    y = product("bchpn,bcihn->bcihp", state_in, Cq) \
        * torch.exp(cum)[..., None]
    above = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).triu(1)[:, :, None]
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (b,nc,i,j,h)
    W = torch.einsum("bcihn,bcjhn->bcijh", Cq, Bq) \
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
    chunk and scan passes in the bf16 route; CUDA build needed)."""
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
        # x, dt, A, B, C, D, y, state, s_loc, decay, cbuf; b, s, h, p, g,
        # n, chunk, dtype; stream
        lib.ssd_scan_launch.argtypes = [p] * 11 + [i] * 8 + [p]
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
    tensor-core route, which also takes :func:`ssd_scan_scratch_bytes` of
    float32 scratch and n up to 256 (the C entry refuses a wider state).
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
    lib = _lib()
    code = _build.DTYPE_CODES[x.dtype]
    smem = lib.ssd_scan_smem_bytes(chunk, p, n, code)
    if smem > _MAX_SMEM:
        raise ValueError(f"chunk {chunk}, p {p}, n {n} need {smem} bytes of "
                         f"shared memory, more than {_MAX_SMEM}")
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if b * h == 0:
        return y, state
    scratch = [None] * 3                     # s_loc, decay, cbuf
    if x.dtype == torch.bfloat16:
        scratch = [torch.empty(shape, dtype=torch.float32, device=dev)
                   for shape in _scratch_shapes(b, s, h, p, g, n, chunk)]
    ptr = lambda t: t.data_ptr() if t is not None else None
    rc = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        ptr(D), y.data_ptr(), state.data_ptr(), *map(ptr, scratch), b, s, h,
        p, g, n, chunk, code, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"SSD scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(rc).decode()}")
    _build.launch_counts["ssd_scan"] += 1
    _build.route_counts[f"ssd_scan.{_build.ROUTES[x.dtype]}"] += 1
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

"""G-PART fractional-overlap matrix: CUDA kernel wrapper + plain version.

Port of ``repro/kernels/overlap.py``. For ``-1``-padded code rows
(NA, M) and (NB, M) of distinct file codes, file sizes (F,) and spans, the
(NA, NB) float32 matrix

    inter[i, j] = sum(sizes[c] for c in codes_i & codes_j)
    w[i, j]     = inter / max(span_i + span_j - inter, 1e-12), exactly 0
                  wherever inter == 0

* :func:`fractional_overlap_matrix_kernel` launches ``csrc/overlap.cu`` on
  CUDA tensors (it raises for anything else);
* :func:`fractional_overlap_matrix_plain` is the same function in tensor
  ops (one-hot rows and one float32 matrix product), used for CPU tensors
  and as the kernel's yardstick on the card.

``codes_b``/``spans_b`` default to the first operand (square sweep).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_INT32_MAX = torch.iinfo(torch.int32).max
_MAX_NB = 65535 * 128           # grid.y limit times the block width
_MAX_SMEM = 227 * 1024          # per-block shared memory on Hopper


def fractional_overlap_matrix_plain(codes: torch.Tensor, sizes: torch.Tensor,
                                    spans: torch.Tensor, *,
                                    codes_b: Optional[torch.Tensor] = None,
                                    spans_b: Optional[torch.Tensor] = None,
                                    ) -> torch.Tensor:
    """Tensor-op version: size-weighted one-hot rows of A times indicator
    rows of B, in ``sizes.dtype``."""
    if codes_b is None:
        codes_b, spans_b = codes, spans
    F = sizes.shape[0]

    def one_hot(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        valid = c >= 0
        safe = torch.where(valid, c, 0).long()
        vals = torch.where(valid, w[safe], torch.zeros((), dtype=w.dtype,
                                                       device=w.device))
        return torch.zeros(c.shape[0], F, dtype=w.dtype,
                           device=w.device).scatter_add_(1, safe, vals)

    inter = one_hot(codes, sizes) @ one_hot(codes_b, torch.ones_like(sizes)).T
    den = spans[:, None] + spans_b[None, :] - inter
    return torch.where(inter > 0.0, inter / torch.clamp_min(den, 1e-12),
                       torch.zeros((), dtype=inter.dtype, device=inter.device))


def _lib() -> ctypes.CDLL:
    lib = _build.load("overlap")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.overlap_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, p, p]
        lib.overlap_launch.restype = ctypes.c_int
        lib.overlap_error_string.argtypes = [ctypes.c_int]
        lib.overlap_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _sorted_rows(codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows ascending with pads last, and the count of valid codes."""
    key = torch.where(codes >= 0, codes,
                      torch.full((), _INT32_MAX, dtype=codes.dtype,
                                 device=codes.device))
    lens = (codes >= 0).sum(1, dtype=torch.int32)
    return key.sort(dim=1).values.contiguous(), lens


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-D {dtype} "
                         f"tensor on {device}, got {t.dim()}-D {t.dtype} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")


def fractional_overlap_matrix_kernel(codes: torch.Tensor, sizes: torch.Tensor,
                                     spans: torch.Tensor, *,
                                     codes_b: Optional[torch.Tensor] = None,
                                     spans_b: Optional[torch.Tensor] = None,
                                     ) -> torch.Tensor:
    """Launch ``csrc/overlap.cu``: (NA, NB) float32 on ``codes.device``.

    codes / codes_b int32 (N, M), -1 padded; sizes float32 (F,); spans /
    spans_b float32 (N,); all contiguous on one CUDA device.
    """
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"overlap kernel needs CUDA tensors, got {dev}")
    if codes_b is None:
        codes_b, spans_b = codes, spans
    for name, t, dt, nd in (("codes", codes, torch.int32, 2),
                            ("codes_b", codes_b, torch.int32, 2),
                            ("sizes", sizes, torch.float32, 1),
                            ("spans", spans, torch.float32, 1),
                            ("spans_b", spans_b, torch.float32, 1)):
        _check(name, t, dt, nd, dev)
    na, nb = codes.shape[0], codes_b.shape[0]
    if spans.shape != (na,) or spans_b.shape != (nb,):
        raise ValueError("spans must have one entry per code row")
    ma = codes.shape[1]
    if ma * 8 > _MAX_SMEM:
        raise ValueError(f"rows of {ma} codes exceed the kernel's shared "
                         f"memory ({_MAX_SMEM // 8} codes)")
    if nb > _MAX_NB:
        raise ValueError(f"at most {_MAX_NB} B rows, got {nb}")
    F = sizes.shape[0]
    hi = max(int(codes.max()) if codes.numel() else -1,
             int(codes_b.max()) if codes_b.numel() else -1)
    if hi >= F:
        raise ValueError(f"code {hi} out of range for {F} file sizes")
    out = torch.empty((na, nb), dtype=torch.float32, device=dev)
    if na == 0 or nb == 0:
        return out
    # The temporaries below return to PyTorch's stream-ordered allocator when
    # this function returns; work queued later on this stream runs after the
    # kernel, so their memory is not reused while the kernel reads it.
    a_sorted, lens_a = _sorted_rows(codes)
    b_sorted, lens_b = _sorted_rows(codes_b)
    b_t = b_sorted.T.contiguous()
    lib = _lib()
    rc = lib.overlap_launch(
        a_sorted.data_ptr(), lens_a.data_ptr(), spans.data_ptr(),
        b_t.data_ptr(), lens_b.data_ptr(), spans_b.data_ptr(),
        sizes.data_ptr(), na, nb, ma, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"overlap kernel launch failed: "
                           f"{lib.overlap_error_string(rc).decode()}")
    _build.launch_counts["overlap"] += 1
    return out

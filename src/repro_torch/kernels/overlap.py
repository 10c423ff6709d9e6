"""G-PART fractional-overlap matrix: CUDA kernel wrapper, plain version and
the kernel's algorithm in tensor ops.

Port of ``repro/kernels/overlap.py``. For ``-1``-padded code rows
(NA, MA) and (NB, MB), file sizes (F,) and spans, the (NA, NB) float32
matrix

    inter[i, j] = sum(sizes[c] for c in codes_i & codes_j)
    w[i, j]     = inter / max(span_i + span_j - inter, 1e-12), exactly 0
                  wherever inter == 0

Contract: each row holds distinct codes in ascending order, then its -1
pads (``PartitionIndex.padded_codes`` gives that). :func:`check_codes`
tests it on the host, where the codes still are (``ops`` calls it);
nothing sorts the rows again. The kernel ends a row at its first code
outside [0, F), so codes that break the contract on the card give a wrong
matrix, never a read out of bounds.

* :func:`fractional_overlap_matrix_kernel` launches ``csrc/overlap.cu`` on
  CUDA tensors (it raises for anything else), with the plan
  :func:`plan` picks from the shapes: ``bitmap`` (rows of A as bitmaps
  over windows of at most ``WINDOW_WORDS * 32`` files in shared memory, a
  warp broadcasting each code of a row of B) or ``merge`` (rows of at
  most ``MERGE_MAX`` codes over more files than one window: rows of B in
  registers and in a hash set that rules out most rows of A at once,
  coalesced output);
* :func:`fractional_overlap_matrix_plain` is the same function in tensor
  ops (one-hot rows and one float32 matrix product), used for CPU tensors
  and as the kernel's yardstick on the card;
* :func:`fractional_overlap_matrix_ordered` is the kernel's summation in
  tensor ops: the sizes of the shared codes added in ascending code order
  in float32, so it gives the kernel's bits on either device
  (``tests/test_torch_overlap_ordered.py`` holds it against the JAX
  package).

``codes_b``/``spans_b`` default to the first operand (square sweep).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build

WINDOW_WORDS = 256      # bitmap plan: 32-bit words of files per window
MERGE_MAX = 8           # merge plan: the longest row (kMergeMax)
ROWS_A = 32             # bitmap plan: rows of A per block (kRowsA)
WARPS = 8               # bitmap plan: rows of B per block, one a warp
MERGE_ROWS_A = 256      # merge plan: rows of A per block (kMergeRowsA)


@dataclasses.dataclass(frozen=True)
class Plan:
    kind: str               # "bitmap" or "merge"
    window_words: int       # bitmap: words of files per window
    blocks: int

    @property
    def code(self) -> tuple:
        """(plan, param) as ``overlap_launch`` takes them."""
        return (0, self.window_words) if self.kind == "bitmap" else (1, 0)


def plan(na: int, nb: int, ma: int, mb: int, n_files: int) -> Plan:
    """The kernel's plan for (na, ma) and (nb, mb) code rows over
    ``n_files`` files: ``merge`` where the rows hold at most ``MERGE_MAX``
    codes and the files exceed one window, else ``bitmap``."""
    words = max(-(-n_files // 32), 1)
    if words > WINDOW_WORDS and max(ma, mb) <= MERGE_MAX:
        return Plan("merge", 0, -(-na // MERGE_ROWS_A) * -(-nb // 32))
    return Plan("bitmap", min(words, WINDOW_WORDS),
                -(-na // ROWS_A) * -(-nb // WARPS))


def check_codes(codes, n_files: int, name: str = "codes") -> None:
    """Raise ``ValueError`` unless every row of ``codes`` (numpy or a CPU
    tensor) holds distinct codes in [0, n_files) in ascending order, then
    -1 pads."""
    if isinstance(codes, torch.Tensor):
        codes = codes.numpy()
    c = np.asarray(codes)
    if c.ndim != 2:
        raise ValueError(f"{name}: expected a 2-D array, got {c.ndim}-D")
    if c.size == 0:
        return
    if int(c.min()) < -1 or int(c.max()) >= n_files:
        raise ValueError(f"{name}: codes must lie in [0, {n_files}), "
                         f"padded with -1; got [{int(c.min())}, "
                         f"{int(c.max())}]")
    valid = c >= 0
    if (valid[:, 1:] & ~valid[:, :-1]).any():
        raise ValueError(f"{name}: a code follows a -1 pad; pads come last")
    if ((c[:, 1:] <= c[:, :-1]) & valid[:, 1:]).any():
        raise ValueError(f"{name}: each row's codes must be distinct and "
                         f"ascending")


def _finish(inter: torch.Tensor, spans: torch.Tensor,
            spans_b: torch.Tensor) -> torch.Tensor:
    den = spans[:, None] + spans_b[None, :] - inter
    return torch.where(inter > 0.0, inter / torch.clamp_min(den, 1e-12),
                       torch.zeros((), dtype=inter.dtype, device=inter.device))


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
    return _finish(inter, spans, spans_b)


def _row_prefix(codes: torch.Tensor, n_files: int) -> torch.Tensor:
    """Where each row's codes are used: up to its first code outside
    [0, n_files), as the kernel reads a row."""
    ok = (codes >= 0) & (codes < n_files)
    return ok.to(torch.int32).cumprod(1).bool()


def fractional_overlap_matrix_ordered(codes: torch.Tensor,
                                      sizes: torch.Tensor,
                                      spans: torch.Tensor, *,
                                      codes_b: Optional[torch.Tensor] = None,
                                      spans_b: Optional[torch.Tensor] = None,
                                      ) -> torch.Tensor:
    """The kernel's sums in tensor ops: for each code position t of B's
    rows in turn, ``inter += member(i, c_jt) * sizes[c_jt]`` in float32
    (membership by a search in A's ascending rows), then the kernel's
    ``den`` and division. Adding 0.0 leaves a float32 sum unchanged, so
    this adds the shared codes' sizes in ascending code order, as both of
    the kernel's plans do, and gives their bits."""
    if codes_b is None:
        codes_b, spans_b = codes, spans
    F = sizes.shape[0]
    na, ma = codes.shape
    nb, mb = codes_b.shape
    inter = torch.zeros((na, nb), dtype=torch.float32, device=codes.device)
    used_a = _row_prefix(codes, F)
    used_b = _row_prefix(codes_b, F)
    if ma > 0:
        key = torch.where(used_a, codes, torch.iinfo(codes.dtype).max)
        zero = torch.zeros((), dtype=torch.float32, device=codes.device)
        for t in range(mb):
            use = used_b[:, t]
            c = torch.where(use, codes_b[:, t], 0)
            size = torch.where(use, sizes[c.long()], zero)
            vals = c[None, :].expand(na, nb).contiguous()
            at = torch.searchsorted(key, vals).clamp_max_(ma - 1)
            member = (key.gather(1, at) == vals) & use[None, :]
            inter = inter + torch.where(member, size[None, :], zero)
    return _finish(inter, spans, spans_b)


def _lib() -> ctypes.CDLL:
    lib = _build.load("overlap")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        # plan, param; codes_a, ma, spans_a, na; codes_b, mb, spans_b, nb;
        # sizes, F, out, stream
        lib.overlap_launch.argtypes = [i, i, p, i, p, i, p, i, p, i, p, i,
                                       p, p]
        lib.overlap_launch.restype = ctypes.c_int
        lib.overlap_error_string.argtypes = [ctypes.c_int]
        lib.overlap_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


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
    """Launch ``csrc/overlap.cu``: (NA, NB) float32 on ``codes.device``,
    one CUDA launch and no host synchronisation.

    codes / codes_b int32 (N, M), rows ascending and -1 padded (the
    module's contract; see :func:`check_codes`); sizes float32 (F,); spans
    / spans_b float32 (N,); all contiguous on one CUDA device.
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
    F = sizes.shape[0]
    if F >= 2 ** 31:
        raise ValueError(f"{F} file sizes exceed the kernel's int32 codes")
    out = torch.empty((na, nb), dtype=torch.float32, device=dev)
    if na == 0 or nb == 0:
        return out
    p = plan(na, nb, codes.shape[1], codes_b.shape[1], F)
    if p.blocks >= 2 ** 31:
        raise ValueError(f"({na}, {nb}) needs {p.blocks} blocks, beyond the "
                         f"grid's 2^31 - 1")
    lib = _lib()
    rc = lib.overlap_launch(
        *p.code, codes.data_ptr(), codes.shape[1], spans.data_ptr(), na,
        codes_b.data_ptr(), codes_b.shape[1], spans_b.data_ptr(), nb,
        sizes.data_ptr(), F, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"overlap kernel launch failed: "
                           f"{lib.overlap_error_string(rc).decode()}")
    _build.launch_counts["overlap"] += 1
    return out

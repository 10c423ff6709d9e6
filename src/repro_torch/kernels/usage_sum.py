"""The fleet dual ascent's per-tier usage, summed in float32 row after
row: CUDA kernel wrapper and plain version.

For the chosen flat cells ``idx`` (T, N) of a padded tenant batch (tier
``idx // K``) and their stored bytes ``chosen`` (T, N) float32, it
returns ``use`` (T, L) float32 with ``use[t, l]`` the sum of
``chosen[t, n]`` over the rows whose tier is ``l``, added one at a time in
row order, each addition rounded to float32. That is the order of the JAX
package's scatter-add on the CPU (``repro/core/optassign.py``,
``.at[t_idx, idx // K].add(chosen)``), so the port's scan steps with the
reference's multipliers.

* :func:`usage_sum_kernel` launches ``csrc/usage_sum.cu`` on CUDA tensors
  (it raises for anything else): each tile of a tenant's rows is compacted
  by tier in shared memory, stably, and one thread per (tenant, tier)
  walks only its tier's list, in order (a block a tenant and window of
  :data:`WINDOW` tiers, :func:`tier_windows`, above :data:`WARP_MAX_N`
  rows or 32 tiers, else a warp a tenant), at any number of tiers;
* :func:`usage_sum_plain` is ``np.add.at`` in float32 on the host, which
  adds in index order; the kernel gives the same bits.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

WINDOW = 128                # kMaxTiers: tiers a block of the block route
WARP_MAX_N = 1024           # kWarpMaxN: the most rows of the warp route
MAX_WINDOWS = 65535         # kMaxWindows: the grid's second dimension


def tier_windows(L: int) -> List[Tuple[int, int]]:
    """``(first tier, tiers)`` of the block route's windows over L tiers:
    one block a tenant and window, each summing only its own tiers."""
    return [(l0, min(WINDOW, L - l0)) for l0 in range(0, L, WINDOW)]


def usage_sum_plain(idx: torch.Tensor, chosen: torch.Tensor, K: int,
                    L: int) -> torch.Tensor:
    T, N = idx.shape
    use = np.zeros((T, L), np.float32)
    rows = np.repeat(np.arange(T), N)
    tier = (idx.cpu().numpy() // K).reshape(-1)
    np.add.at(use, (rows, tier),
              chosen.detach().cpu().numpy().astype(np.float32).reshape(-1))
    return torch.from_numpy(use).to(idx.device)


def _lib() -> ctypes.CDLL:
    lib = _build.load("usage_sum")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.usage_sum_launch.argtypes = [p, p, p, i, i, i, i, p]
        lib.usage_sum_launch.restype = ctypes.c_int
        lib.usage_sum_error_string.argtypes = [ctypes.c_int]
        lib.usage_sum_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def usage_sum_kernel(idx: torch.Tensor, chosen: torch.Tensor, K: int,
                     L: int) -> torch.Tensor:
    """Launch ``csrc/usage_sum.cu``: (T, L) float32. ``idx`` contiguous
    int64 (T, N) with cells in [0, L K), ``chosen`` contiguous float32
    (T, N), both on one CUDA device; any L up to 65,535 windows of 128."""
    dev = idx.device
    if dev.type != "cuda" or chosen.device != dev:
        raise ValueError(f"usage sum kernel needs CUDA tensors on one "
                         f"device, got {dev} and {chosen.device}")
    if idx.dtype != torch.int64 or chosen.dtype != torch.float32 \
            or idx.dim() != 2 or chosen.shape != idx.shape \
            or not (idx.is_contiguous() and chosen.is_contiguous()):
        raise ValueError(f"expected contiguous int64 idx and float32 chosen "
                         f"of one (T, N) shape, got {idx.dtype} "
                         f"{tuple(idx.shape)} and {chosen.dtype} "
                         f"{tuple(chosen.shape)}")
    T, N = idx.shape
    if not 1 <= L <= MAX_WINDOWS * WINDOW:
        raise ValueError(f"the kernel takes 1 to {MAX_WINDOWS * WINDOW} "
                         f"tiers, got {L}")
    use = torch.empty((T, L), dtype=torch.float32, device=dev)
    if use.numel() == 0:
        return use
    lib = _lib()
    rc = lib.usage_sum_launch(idx.data_ptr(), chosen.data_ptr(),
                              use.data_ptr(), T, N, L, K,
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"usage sum kernel launch failed: "
                           f"{lib.usage_sum_error_string(rc).decode()}")
    _build.launch_counts["usage_sum"] += 1
    return use

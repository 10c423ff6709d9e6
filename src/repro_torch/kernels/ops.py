"""Kernel API with dispatch by device.

Each function takes numpy arrays or tensors, moves them to ``device`` (the
card unless the caller passes ``device="cpu"``), and runs the hand-written
CUDA kernel when that device is CUDA, or the kernel's plain tensor-op
version when it is the CPU. Asking for CUDA where there is none raises
(:func:`repro_torch.device.resolve`); a CUDA launch that fails raises too.
There is no fallback from one to the other.

``launch_counts`` (re-exported from :mod:`repro_torch.kernels._build`)
counts kernel launches by name: ``"overlap"`` and ``"entropy_features"``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels import entropy_features as _ef
from repro_torch.kernels import overlap as _ov
from repro_torch.kernels._build import launch_counts, reset_launch_counts

__all__ = ["fractional_overlap_matrix", "weighted_entropy_features",
           "launch_counts", "reset_launch_counts"]


def _on(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=dev).contiguous()


def fractional_overlap_matrix(codes, sizes, spans, *, codes_b=None,
                              spans_b=None, device: DeviceLike = "cuda",
                              ) -> torch.Tensor:
    """(NA, NB) float32 fractional-overlap matrix on ``device`` (see
    :mod:`repro_torch.kernels.overlap`)."""
    dev = resolve(device)
    args = (_on(codes, torch.int32, dev), _on(sizes, torch.float32, dev),
            _on(spans, torch.float32, dev))
    kw = {}
    if codes_b is not None:
        kw = dict(codes_b=_on(codes_b, torch.int32, dev),
                  spans_b=_on(spans_b, torch.float32, dev))
    if dev.type == "cuda":
        return _ov.fractional_overlap_matrix_kernel(*args, **kw)
    return _ov.fractional_overlap_matrix_plain(*args, **kw)


def weighted_entropy_features(codes, n_valid, n_rows, n_cols, lengths, *,
                              n_buckets: int = 1,
                              device: DeviceLike = "cuda",
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(summary (N, 4), bucket_H (N, n_buckets))`` float32 on ``device``
    (see :mod:`repro_torch.kernels.entropy_features`)."""
    dev = resolve(device)
    args = (_on(codes, torch.int32, dev), _on(n_valid, torch.int32, dev),
            _on(n_rows, torch.int32, dev), _on(n_cols, torch.int32, dev),
            _on(lengths, torch.float32, dev))
    if dev.type == "cuda":
        return _ef.weighted_entropy_features_kernel(*args, n_buckets=n_buckets)
    return _ef.weighted_entropy_features_plain(*args, n_buckets=n_buckets)

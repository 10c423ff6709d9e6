"""COMPREDICT batched weighted-entropy features: CUDA kernel + plain version.

Port of ``repro/kernels/entropy_features.py`` ``weighted_entropy_features``.
Inputs come from :func:`repro_torch.data.tables.encode_dtype_classes`:
codes (N, M) int32 (-1 padded, row-major within a partition), n_valid /
n_rows / n_cols (N,) int32, and lengths, either (N, Vmax) per-partition
vocabularies or a (V,) vocabulary shared by every partition. Returns
``(summary (N, 4), bucket_H (N, n_buckets))``: summary columns are
[weighted entropy H(P,d), plain entropy, distinct fraction, mean value
length] in natural log, and ``bucket_H[:, b]`` is the weighted entropy of
the b-th 1/n_buckets of rows.

* :func:`weighted_entropy_features_kernel` launches
  ``csrc/entropy_features.cu`` on CUDA tensors (it raises for anything else);
* :func:`weighted_entropy_features_plain` is the same function in tensor
  ops, in any float ``dtype`` (float64 gives the reference the kernel's
  float32 sums are measured against).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_BUCKETS = 16        # kMaxBuckets in csrc/entropy_features.cu


def _batched_lengths(lengths: torch.Tensor, n: int) -> torch.Tensor:
    return lengths if lengths.dim() == 2 else lengths[None, :].expand(n, -1)


def weighted_entropy_features_plain(codes: torch.Tensor, n_valid: torch.Tensor,
                                    n_rows: torch.Tensor, n_cols: torch.Tensor,
                                    lengths: torch.Tensor, *,
                                    n_buckets: int = 1,
                                    dtype: torch.dtype = torch.float32,
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor-op version: exact integer histogram (``bincount``), then the
    entropy reductions in ``dtype``."""
    N, M = codes.shape
    dev = codes.device
    lens = _batched_lengths(lengths, N).to(dtype)
    V = lens.shape[1]
    c = codes.long()
    pos = torch.arange(M, device=dev)
    valid = (pos[None, :] < n_valid.long()[:, None]) & (c >= 0) & (c < V)
    bucket = torch.zeros((N, M), dtype=torch.long, device=dev)
    if n_buckets > 1:
        row = pos[None, :] // torch.clamp_min(n_cols.long(), 1)[:, None]
        for e in range(1, n_buckets):
            edge = (e * n_rows.long()) // n_buckets
            bucket += row >= edge[:, None]
    part = torch.arange(N, device=dev)[:, None]
    flat = ((part * n_buckets + bucket) * V + c)[valid]
    hist_b = torch.bincount(flat, minlength=N * n_buckets * V).reshape(
        N, n_buckets, V).to(dtype)
    hist = hist_b.sum(1)
    zero = torch.zeros((), dtype=dtype, device=dev)

    def plogp(p):
        return torch.where(p > 0, p * torch.log(torch.clamp_min(p, 1e-30)),
                           zero)

    total = torch.clamp_min(n_valid.to(dtype), 1.0)
    p = hist / total[:, None]
    pl = plogp(p)
    summary = torch.stack([-(lens * pl).sum(1), -pl.sum(1),
                           (hist > 0).to(dtype).sum(1) / total,
                           (lens * p).sum(1)], dim=1)
    pb = hist_b / torch.clamp_min(hist_b.sum(2, keepdim=True), 1.0)
    return summary, -(lens[:, None, :] * plogp(pb)).sum(2)


def _lib() -> ctypes.CDLL:
    lib = _build.load("entropy_features")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wef_launch.argtypes = [p, p, p, p, p, ctypes.c_longlong,
                                   i, i, i, i, p, p, p, p]
        lib.wef_launch.restype = ctypes.c_int
        lib.wef_error_string.argtypes = [ctypes.c_int]
        lib.wef_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def weighted_entropy_features_kernel(codes: torch.Tensor, n_valid: torch.Tensor,
                                     n_rows: torch.Tensor, n_cols: torch.Tensor,
                                     lengths: torch.Tensor, *,
                                     n_buckets: int = 1,
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/entropy_features.cu`` (histogram, then reduction).

    codes int32 (N, M); n_valid / n_rows / n_cols int32 (N,); lengths
    float32 (N, V) or (V,); all contiguous on one CUDA device. Returns
    float32 ``(summary (N, 4), bucket_H (N, n_buckets))``.
    """
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"entropy-features kernel needs CUDA tensors, "
                         f"got {dev}")
    if codes.dim() != 2:
        raise ValueError(f"codes must be 2-D, got {codes.dim()}-D")
    N, M = codes.shape
    for name, t, dt in (("codes", codes, torch.int32),
                        ("n_valid", n_valid, torch.int32),
                        ("n_rows", n_rows, torch.int32),
                        ("n_cols", n_cols, torch.int32),
                        ("lengths", lengths, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    for name, t in (("n_valid", n_valid), ("n_rows", n_rows),
                    ("n_cols", n_cols)):
        if t.shape != (N,):
            raise ValueError(f"{name} must have shape ({N},), got "
                             f"{tuple(t.shape)}")
    if lengths.dim() == 2 and lengths.shape[0] == N:
        V, stride = lengths.shape[1], lengths.shape[1]
    elif lengths.dim() == 1:
        V, stride = lengths.shape[0], 0
    else:
        raise ValueError(f"lengths must be (N, V) or (V,), got "
                         f"{tuple(lengths.shape)}")
    if not 1 <= n_buckets <= MAX_BUCKETS:
        raise ValueError(f"n_buckets must lie in [1, {MAX_BUCKETS}]")
    if V < 1 or N > 65535:
        raise ValueError(f"need V >= 1 and at most 65535 partitions, got "
                         f"V={V}, N={N}")
    if N and (n_buckets - 1) * int(n_rows.max()) >= 2 ** 31:
        raise ValueError("bucket edges b*n_rows overflow int32")
    summary = torch.empty((N, 4), dtype=torch.float32, device=dev)
    bucket_h = torch.empty((N, n_buckets), dtype=torch.float32, device=dev)
    if N == 0:
        return summary, bucket_h
    # scratch histogram, zeroed inside the launch; freed to PyTorch's
    # stream-ordered allocator on return, after the kernels on this stream
    hist = torch.empty((N, n_buckets, V), dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.wef_launch(
        codes.data_ptr(), n_valid.data_ptr(), n_rows.data_ptr(),
        n_cols.data_ptr(), lengths.data_ptr(), stride, N, M, V, n_buckets,
        hist.data_ptr(), summary.data_ptr(), bucket_h.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"entropy-features kernel launch failed: "
                           f"{lib.wef_error_string(rc).decode()}")
    _build.launch_counts["entropy_features"] += 1
    return summary, bucket_h

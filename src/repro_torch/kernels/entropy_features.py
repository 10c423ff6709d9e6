"""COMPREDICT entropy features: CUDA kernels + plain versions.

Port of ``repro/kernels/entropy_features.py``: ``weighted_entropy_features``
(below) and ``byte_entropy`` (at the end of the module).

``weighted_entropy_features``:
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
  float32 sums are measured against);
* :func:`weighted_entropy_features_sliced` is the kernel's reduction in
  tensor ops: the vocabulary cut into consecutive ranges of ``width``
  values (one per block of the kernel), each range's float32 terms summed
  in float64, the ranges' sums added in order
  (``tests/test_torch_entropy_sliced.py`` holds it against the JAX
  package).

The kernel keeps each partition's histogram on chip in a cluster of 8
blocks (:func:`_plan` chooses how): replicated in every block where the
(n_buckets, V) bins fit one block's shared memory, else spread over the
cluster's blocks, in vocabulary slices where 8 blocks do not hold them.

``byte_entropy``: for a (n,) uint8 payload, its 256-bin histogram (int32)
and Shannon entropy in bits per byte (float32 scalar),
``-sum p log2 p`` with ``p = hist / max(n, 1)``.

* :func:`byte_entropy_kernel` launches ``csrc/byte_entropy.cu`` on a CUDA
  tensor (it raises for anything else): one launch, each warp counting
  into its own shared-memory histogram, the last block to finish reading
  the blocks' totals and adding the entropy;
* :func:`byte_entropy_plain` is the same function in tensor ops
  (``bincount``), used for CPU tensors and as the kernel's yardstick.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

MAX_BUCKETS = 16        # kMaxBuckets in csrc/entropy_features.cu
CLUSTER = 8             # kCluster: blocks per cluster
MAX_BINS = 49152        # kMaxBins: int32 bins one block holds


#: codes of the largest partition one block of a distributed plan should
#: take: more slices spread a large partition over more clusters
CODES_PER_BLOCK = 1 << 16


def _plan(V: int, n_buckets: int, M: int = 0) -> Tuple[bool, int, int]:
    """``(replicated, slices, span)`` of the kernel for a vocabulary of V
    values and partitions of at most M codes: the vocabulary is cut into
    ``slices`` slices of ``span`` values, one cluster each. Replicated
    (one slice) when a block holds all (n_buckets, V) bins, else the bins
    spread over the cluster's blocks in as many slices as they need, or
    as give each block at most ``CODES_PER_BLOCK`` of the largest
    partition's codes to add (each slice's cluster reads all the codes
    and adds those of its slice), but no more slices than blocks have
    values."""
    if n_buckets * V <= MAX_BINS:
        return True, 1, V
    slices = max(-(-n_buckets * V // (CLUSTER * MAX_BINS)),
                 min(-(-M // (CLUSTER * CODES_PER_BLOCK)), -(-V // CLUSTER)))
    return False, slices, CLUSTER * -(-V // (CLUSTER * slices))


def _batched_lengths(lengths: torch.Tensor, n: int) -> torch.Tensor:
    return lengths if lengths.dim() == 2 else lengths[None, :].expand(n, -1)


def _histogram(codes, n_valid, n_rows, n_cols, V: int,
               n_buckets: int) -> torch.Tensor:
    """(N, n_buckets, V) int64 counts of the codes in [0, V) at positions
    < n_valid, by bucket of rows."""
    N, M = codes.shape
    dev = codes.device
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
    return torch.bincount(flat, minlength=N * n_buckets * V).reshape(
        N, n_buckets, V)


def _plogp(p: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    return torch.where(p > 0, p * torch.log(torch.clamp_min(p, 1e-30)), zero)


def weighted_entropy_features_plain(codes: torch.Tensor, n_valid: torch.Tensor,
                                    n_rows: torch.Tensor, n_cols: torch.Tensor,
                                    lengths: torch.Tensor, *,
                                    n_buckets: int = 1,
                                    dtype: torch.dtype = torch.float32,
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor-op version: exact integer histogram (``bincount``), then the
    entropy reductions in ``dtype``."""
    N, M = codes.shape
    lens = _batched_lengths(lengths, N).to(dtype)
    V = lens.shape[1]
    hist_b = _histogram(codes, n_valid, n_rows, n_cols, V, n_buckets).to(
        dtype)
    hist = hist_b.sum(1)
    total = torch.clamp_min(n_valid.to(dtype), 1.0)
    p = hist / total[:, None]
    pl = _plogp(p)
    summary = torch.stack([-(lens * pl).sum(1), -pl.sum(1),
                           (hist > 0).to(dtype).sum(1) / total,
                           (lens * p).sum(1)], dim=1)
    pb = hist_b / torch.clamp_min(hist_b.sum(2, keepdim=True), 1.0)
    return summary, -(lens[:, None, :] * _plogp(pb)).sum(2)


def weighted_entropy_features_sliced(codes: torch.Tensor,
                                     n_valid: torch.Tensor,
                                     n_rows: torch.Tensor,
                                     n_cols: torch.Tensor,
                                     lengths: torch.Tensor, *,
                                     n_buckets: int = 1, width: int,
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's reduction in tensor ops: the exact integer histogram,
    the terms in float32, then for each slice of ``width`` consecutive
    values (what one cluster of the kernel covers) and each of its
    ``CLUSTER`` blocks (the values of the slice whose offset is the block's
    rank modulo ``CLUSTER``) the terms' sums in float64, added in (slice,
    block) order in float64; float32 out."""
    N, M = codes.shape
    dev = codes.device
    lens = _batched_lengths(lengths, N).float()
    V = lens.shape[1]
    hist_b = _histogram(codes, n_valid, n_rows, n_cols, V, n_buckets)
    hist = hist_b.sum(1)
    total = torch.clamp_min(n_valid.float(), 1.0)[:, None]
    tot_b = torch.clamp_min(hist_b.sum(2).float(), 1.0)[:, :, None]
    p = hist.float() / total
    pl = _plogp(p)
    terms = [(lens * pl).double(), pl.double(), (lens * p).double(),
             (hist > 0).double()]
    terms += list((lens[:, None, :] * _plogp(hist_b.float() / tot_b))
                  .double().unbind(1))
    sums = torch.zeros((N, len(terms)), dtype=torch.float64, device=dev)
    for x0 in range(0, V, width):
        for r in range(CLUSTER):
            own = slice(x0 + r, min(x0 + width, V), CLUSTER)
            sums += torch.stack([t[:, own].sum(1) for t in terms], 1)
    summary = torch.stack([(-sums[:, 0]).float(), (-sums[:, 1]).float(),
                           sums[:, 3].float() / total[:, 0],
                           sums[:, 2].float()], dim=1)
    return summary, (-sums[:, 4:]).float()


def _lib() -> ctypes.CDLL:
    lib = _build.load("entropy_features")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wef_launch.argtypes = [p, p, p, p, p, ctypes.c_longlong,
                                   i, i, i, i, i, i, i, p, p, p, p]
        lib.wef_launch.restype = ctypes.c_int
        lib.wef_info.argtypes = [i] * 5 + [p]
        lib.wef_info.restype = ctypes.c_int
        lib.wef_error_string.argtypes = [ctypes.c_int]
        lib.wef_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def weighted_entropy_features_kernel(codes: torch.Tensor, n_valid: torch.Tensor,
                                     n_rows: torch.Tensor, n_cols: torch.Tensor,
                                     lengths: torch.Tensor, *,
                                     n_buckets: int = 1,
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/entropy_features.cu`` (cluster histogram and reduction,
    then the partials' combine).

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
    # (read on the host only where there are edges: it synchronises)
    if N and n_buckets > 1 and (n_buckets - 1) * int(n_rows.max()) >= 2 ** 31:
        raise ValueError("bucket edges b*n_rows overflow int32")
    summary = torch.empty((N, 4), dtype=torch.float32, device=dev)
    bucket_h = torch.empty((N, n_buckets), dtype=torch.float32, device=dev)
    if N == 0:
        return summary, bucket_h
    repl, slices, span = _plan(V, n_buckets, M)
    # each block's 4 + n_buckets float64 sums; freed to PyTorch's
    # stream-ordered allocator on return, after the kernels on this stream
    partials = torch.empty(N * slices * CLUSTER * (4 + n_buckets),
                           dtype=torch.float64, device=dev)
    lib = _lib()
    rc = lib.wef_launch(
        codes.data_ptr(), n_valid.data_ptr(), n_rows.data_ptr(),
        n_cols.data_ptr(), lengths.data_ptr(), stride, N, M, V, n_buckets,
        int(repl), slices, span, partials.data_ptr(), summary.data_ptr(),
        bucket_h.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"entropy-features kernel launch failed: "
                           f"{lib.wef_error_string(rc).decode()}")
    _build.launch_counts["entropy_features"] += 1
    return summary, bucket_h


def weighted_entropy_features_info(V: int, n_buckets: int = 1,
                                   M: int = 0) -> dict:
    """The kernel's plan at a vocabulary of V values and partitions of at
    most M codes (replicated or distributed, slices, values a slice holds)
    with its registers, shared
    memory per block, cluster size and the clusters that fit on the card
    at once (``cudaOccupancyMaxActiveClusters``), from the built library;
    it launches nothing."""
    repl, slices, span = _plan(V, n_buckets, M)
    attr = (ctypes.c_int * 4)()
    lib = _lib()
    rc = lib.wef_info(V, n_buckets, int(repl), slices, span, attr)
    if rc != 0:
        raise RuntimeError(f"entropy-features info failed: "
                           f"{lib.wef_error_string(rc).decode()}")
    return {"replicated": repl, "slices": slices, "span": span,
            "registers": attr[0], "smem_bytes": attr[1], "cluster": attr[2],
            "max_active_clusters": attr[3]}


# ------------------------------------------------------------ byte entropy
def _check_bytes(data: torch.Tensor) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"data: expected a 1-D uint8 tensor, got "
                         f"{data.dim()}-D {data.dtype}")


def byte_entropy_plain(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_bytes(data)
    hist = torch.bincount(data.long(), minlength=256).to(torch.int32)
    # n as a tensor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal
    n = torch.tensor(float(max(data.numel(), 1)), device=data.device)
    p = hist.float() / n
    zero = torch.zeros((), device=data.device)
    ent = -torch.where(p > 0, p * torch.log2(torch.clamp_min(p, 1e-30)),
                       zero).sum()
    return hist, ent


#: threads per block of csrc/byte_entropy.cu (kThreads)
BYTE_THREADS = 256
#: bytes a thread should take at least before the grid grows
BYTES_PER_THREAD = 32

_byte_totals: Dict[Tuple[int, int], torch.Tensor] = {}


def byte_entropy_blocks(n: int, sms: int) -> int:
    """Blocks of the byte-entropy kernel for ``n`` bytes on a card of
    ``sms`` SMs: one per SM at most (more only add to the totals' atomics),
    and fewer where each thread would take under ``BYTES_PER_THREAD``
    bytes."""
    return max(1, min(sms, -(-n // (BYTE_THREADS * BYTES_PER_THREAD))))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _byte_totals_for(dev: torch.device, stream: int) -> torch.Tensor:
    """The kernel's 256 bin totals and completion counter for ``stream`` on
    ``dev``: zeroed once when made, and left at 0 by every launch."""
    key = (dev.index, stream)
    acc = _byte_totals.get(key)
    if acc is None:
        acc = _byte_totals[key] = torch.zeros(257, dtype=torch.int32,
                                              device=dev)
    return acc


def _byte_lib() -> ctypes.CDLL:
    lib = _build.load("byte_entropy")
    if not getattr(lib, "_typed", False):
        p = ctypes.c_void_p
        # data, n, blocks, acc, hist, entropy, stream
        lib.byte_entropy_launch.argtypes = [p, ctypes.c_longlong,
                                            ctypes.c_int, p, p, p, p]
        lib.byte_entropy_launch.restype = ctypes.c_int
        lib.byte_entropy_error_string.argtypes = [ctypes.c_int]
        lib.byte_entropy_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def byte_entropy_kernel(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/byte_entropy.cu``: (hist (256,) int32, entropy ()
    float32). data a contiguous 1-D uint8 CUDA tensor of fewer than 2^31
    bytes (the bins are int32). One CUDA launch, no memset and no host
    synchronisation: the outputs come from ``torch.empty``, and the bin
    totals and completion counter the blocks meet in are kept per device and
    stream (zeroed once, left at 0 by each launch)."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"byte-entropy kernel needs a CUDA tensor, got {dev}")
    _check_bytes(data)
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    n = data.numel()
    if n >= 2 ** 31:
        raise ValueError(f"{n} bytes overflow the int32 bins")
    stream = torch.cuda.current_stream(dev).cuda_stream
    blocks = byte_entropy_blocks(n, _sm_count(dev.index))
    acc = _byte_totals_for(dev, stream)
    hist = torch.empty(256, dtype=torch.int32, device=dev)
    ent = torch.empty((), dtype=torch.float32, device=dev)
    lib = _byte_lib()
    rc = lib.byte_entropy_launch(data.data_ptr(), n, blocks, acc.data_ptr(),
                                 hist.data_ptr(), ent.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"byte-entropy kernel launch failed: "
                           f"{lib.byte_entropy_error_string(rc).decode()}")
    _build.launch_counts["byte_entropy"] += 1
    return hist, ent

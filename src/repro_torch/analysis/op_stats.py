"""FLOPs, device-memory bytes and collective bytes of one eager call.

The port's counterpart of ``repro/analysis/hlo_stats.py``, which parses
the optimized XLA HLO of a compiled program. A torch program has no HLO:
:func:`analyze` runs the function itself, usually on meta tensors (shapes
and dtypes, no data, no time), and counts what the dispatcher sees:

* FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products, convolutions and attention, the forward and the backward),
  as the reference counts only its dot ops;
* device-memory bytes from a ``TorchDispatchMode``, operand plus result
  bytes of the op kinds the reference counts (its ``_BYTE_OPS``): matrix
  products and convolutions, reductions and softmax, gather, scatter and
  index ops, sort and top-k. Window ops (slice, select, narrow, pad, and
  a copy into a view, the reference's ``_WINDOW_OPS``) count twice the
  window they move. Pointwise and layout ops count as fused away, as the
  reference treats them on the TPU;
* collectives: the ``c10d`` ops seen under the mode, each counted once
  with its operand bytes under one of the reference's five kinds, and
  twice those bytes as device-memory traffic.

Eager execution runs every layer of every stage, so nothing here needs
the reference's while-loop trip counts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: c10d op -> (kind, index of the operand argument): what
#: ``all_reduce``, ``all_gather``, ``all_gather_into_tensor``,
#: ``reduce_scatter_tensor``, ``all_to_all_single`` and ``send`` (a
#: pipeline's ``batch_isend_irecv``) dispatch
_COLL_OPS = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}

#: op kinds whose operands and result count (the reference's _BYTE_OPS)
_BYTE_OPS = frozenset({
    # matrix products and convolutions
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
    "convolution", "convolution_backward",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_flash_attention_for_cpu",
    # reductions and softmax
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "norm", "linalg_vector_norm", "logsumexp",
    "argmax", "argmin", "any", "all", "cumsum", "cumprod", "logcumsumexp",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data",
    # gather, scatter and index ops
    "gather", "scatter", "scatter_add", "scatter_reduce", "index",
    "index_select", "index_put", "_index_put_impl", "index_add",
    "index_copy", "embedding", "embedding_dense_backward", "take",
    # sort
    "sort", "topk", "argsort", "kthvalue", "searchsorted",
})

#: window ops: twice the bytes of the window they move (the result)
_WINDOW_OPS = frozenset({"slice", "select", "narrow", "constant_pad_nd",
                         "slice_scatter", "select_scatter"})


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


@dataclasses.dataclass
class OpStats:
    """The fields of the reference's ``HloStats``, for one rank."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    n_collectives: int = 0


class _ByteCounter(TorchDispatchMode):
    def __init__(self, stats: OpStats):
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__.removesuffix("_") \
            if func.namespace == "aten" else func.overloadpacket.__name__
        st = self.stats
        if func.namespace == "c10d":
            if name in _COLL_OPS:
                kind, i = _COLL_OPS[name]
                b = _nbytes(args[i])
                st.coll_bytes += b
                st.coll_by_kind[kind] += b
                st.n_collectives += 1
                st.hbm_bytes += 2 * b
        elif name in _BYTE_OPS:
            st.hbm_bytes += _nbytes(args) + _nbytes(list(kwargs.values())) \
                + _nbytes(out)
        elif name in _WINDOW_OPS:
            st.hbm_bytes += 2 * _nbytes(out)
        elif name == "copy" and isinstance(args[0], torch.Tensor) \
                and args[0]._base is not None:
            st.hbm_bytes += 2 * _nbytes(args[1])     # a write into a window
        return out


def analyze(fn, *args, **kwargs) -> OpStats:
    """Run ``fn(*args, **kwargs)`` and count its FLOPs, device-memory
    bytes and collectives (see the module docstring)."""
    stats = OpStats()
    with FlopCounterMode(display=False) as flops, _ByteCounter(stats):
        fn(*args, **kwargs)
    stats.flops = float(flops.get_total_flops())
    return stats

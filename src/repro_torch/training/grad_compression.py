"""Int8 error-feedback gradient mean (QSGD / 1-bit-Adam style), on K3.

Port of ``repro.training.grad_compression``. Per leaf, flattened and
padded to a multiple of 256:

  1. g' = g + err                     (error feedback carry-in)
  2. q, s = quant8(g')                (int8 + one float32 scale per 256
                                       values: ``ops.quant_pack``, the K3
                                       CUDA kernel on the card)
  3. mean over the data-parallel group of dequant(q, s)
  4. err' = g' - dequant(q, s)        (carry-out)

With a ``mesh``, step 3 all-reduces the dequantised gradients (one
float32 buffer for all leaves) over the flattened data-parallel axes,
('pod', 'data') or the ``dp_axes`` given, and divides by their size, as
JAX's ``psum(.) / n`` does; the int8 wire format is what a runtime that
ships bytes would send. Without one the group has size 1
and the mean is the identity, exactly as ``psum(.) / n`` is on a 1x1
mesh. The quantisation error is not lost: it is carried into the next
step. The residual is written into ``err``'s tensors in place.

Under tensor parallelism (``specs``, the parameters' ``param_specs``, and
a mesh whose model axis is above 1) the gradients are this rank's shards.
The reference runs ``compressed_mean`` under ``shard_map`` with ``P()`` in
and out (``repro/training/grad_compression.py:74-77``): it quantises each
whole leaf in 256-value blocks of the leaf's own flattening and keeps
``err`` whole. A rank's column shard flattens into other blocks with other
absmax scales, so each sharded leaf is gathered over 'model' first, K3
runs on the whole leaf with the whole ``err``, and the rank keeps its
shard of the mean.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import leaves, shard_leaf, spec_dim
from repro_torch.kernels import ops
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.transformer import tree_leaves, tree_map

_BLOCK = 256


def _quant_leaf(g: torch.Tensor, e: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dequantised g + e, new residual), both float32 of g's shape."""
    flat = g.float().reshape(-1)
    n = flat.numel()
    pad = (-n) % _BLOCK
    fp = F.pad(flat, (0, pad))
    fe = F.pad(e.float().reshape(-1), (0, pad))
    carried = fp + fe
    q, s = ops.quant_pack(carried, block=_BLOCK)
    deq = ops.quant_unpack(q, s)
    new_err = (carried - deq)[:n].reshape(g.shape)
    return deq[:n].reshape(g.shape), new_err


def group_sum(leaves: Sequence[torch.Tensor], mesh,
              axes: Sequence[str]) -> list:
    """Each leaf summed over the ranks of ``axes`` of ``mesh``, in float32:
    one all-reduce of all leaves packed into one buffer."""
    flat = torch.cat([t.float().reshape(-1) for t in leaves])
    ctx.all_reduce(flat, dist.ReduceOp.SUM, ctx.axes_group(mesh, tuple(axes)))
    return [c.reshape(t.shape) for c, t in
            zip(flat.split([t.numel() for t in leaves]), leaves)]


def compressed_mean(grads, err: Optional[Any] = None, mesh=None,
                    dp_axes: Optional[Sequence[str]] = None, specs=None,
                    ) -> Tuple[Any, Any]:
    """Mean of ``grads`` over the data-parallel group with int8 error
    feedback: over ``dp_axes`` of ``mesh`` (default its 'pod' and 'data'
    axes), or a group of one without a mesh. ``err`` (None means zeros)
    is a float32 tree shaped like the whole ``grads``; its tensors receive
    the new residual in place. With ``specs`` the gradients are this
    rank's tensor-parallel shards (see the module docstring). Returns
    (float32 gradients, err)."""
    g_leaves = tree_leaves(grads)
    dims = [None] * len(g_leaves)
    if specs is not None and mesh is not None \
            and axis_sizes(mesh)["model"] > 1:
        spec_list = leaves(specs)
        dims = [spec_dim(sp, "model") for sp in spec_list]
        group = mesh.get_group("model")
        whole = [g if d is None else ctx.all_gather(g.float(), d, group)
                 for g, d in zip(g_leaves, dims)]
    else:
        spec_list, whole = [None] * len(g_leaves), g_leaves
    if err is None:
        it = iter([torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                   for g in whole])
        err = tree_map(lambda _: next(it), grads)
    out = []
    for g, e in zip(whole, tree_leaves(err)):
        deq, new_e = _quant_leaf(g, e)
        e.copy_(new_e)
        out.append(deq)
    if mesh is not None:
        if dp_axes is None:
            dp_axes = tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))
        sizes = axis_sizes(mesh)
        # an IEEE division by the group's size, as JAX's psum(.) / n
        n = torch.tensor(float(math.prod(sizes[a] for a in dp_axes)),
                         device=out[0].device)
        out = [t / n for t in group_sum(out, mesh, dp_axes)]
    out = [t if d is None else shard_leaf(t, sp, mesh).contiguous()
           for t, d, sp in zip(out, dims, spec_list)]
    it = iter(out)
    return tree_map(lambda _: next(it), grads), err

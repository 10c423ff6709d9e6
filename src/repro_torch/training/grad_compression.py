"""Int8 error-feedback gradient mean (QSGD / 1-bit-Adam style), on K3.

Port of ``repro.training.grad_compression``. Per leaf, flattened and
padded to a multiple of 256:

  1. g' = g + err                     (error feedback carry-in)
  2. q, s = quant8(g')                (int8 + one float32 scale per 256
                                       values: ``ops.quant_pack``, the K3
                                       CUDA kernel on the card)
  3. mean over the data-parallel group of dequant(q, s)
  4. err' = g' - dequant(q, s)        (carry-out)

The port runs on one card, so the data-parallel group has size 1 and the
mean of step 3 is the identity, exactly as JAX's ``psum(.) / n`` is on a
1x1 mesh. The quantisation error is not lost: it is carried into the next
step. The residual is written into ``err``'s tensors in place.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
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


def compressed_mean(grads, err: Optional[Any] = None) -> Tuple[Any, Any]:
    """Mean of ``grads`` over the data-parallel group (size 1) with int8
    error feedback. ``err`` (None means zeros) is a float32 tree shaped
    like ``grads``; its tensors receive the new residual in place. Returns
    (float32 gradients, err)."""
    if err is None:
        err = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                             device=g.device), grads)
    out = []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        deq, new_e = _quant_leaf(g, e)
        e.copy_(new_e)
        out.append(deq)             # the mean over a group of one
    it = iter(out)
    return tree_map(lambda _: next(it), grads), err

"""The train step: loss -> gradients -> (int8 error-feedback mean) ->
AdamW, with per-unit remat and microbatch gradient accumulation.

Port of ``repro.training.train_step``. PyTorch runs eagerly, so there is
no jit and no donation; instead the optimizer state and the parameters
are updated in place (:mod:`repro_torch.training.optimizer`).

With a ``mesh`` the step is data-parallel: every rank takes its rows of
the global batch (``batch_specs``: its block
of rows when the batch divides the data axes, all of them otherwise). Its
gradient is of its tokens' share of the global mean: each rank's mean
weighted by its count of loss tokens over the global count, so ranks that
hold different numbers of loss tokens still give the reference's mean.
One all-reduce over the data axes (all leaves in one float32 buffer) then
gives every rank the global gradient, which is what GSPMD inserts in the
reference, and the reported loss is the global one. Only then, with
``compressed_grads``, comes ``compressed_mean``, as the reference calls
it at ``repro/training/train_step.py:83-86``: the reference quantises the
already-reduced gradient, so its psum runs over identical values. That is
a quirk of the reference, kept: quantising each rank's local gradient
would give a different result.

With a model axis above 1 the step is also tensor-parallel: the weights
are this rank's shards (``sharding.param_specs``), the layers join their
products with ``distributed.ctx``'s collectives, and every replicated leaf
used on the rank's shards (q_norm and k_norm, replicated wk/wv, in_bc and
conv_bc, the MoE router) meets the ranks' partial gradients at a
``ctx.copy_to_model``, so its gradient is the whole one on every rank.
The compressed mean gathers each sharded leaf over 'model' before K3
(``grad_compression``). With a data axis above 1 the optimizer state may
be ZeRO-1's (``init_train_state(..., mesh=)``,
``convert.train_state_from_arrays(..., mesh=)``): each rank updates its
slice over 'data' and all-gathers the new parameters
(``optimizer.apply_updates``).

JAX compresses the gradient mean only ``if tcfg.compressed_grads and mesh
is not None``. Without a mesh, the port's ``compressed_grads=True`` runs
the int8 error-feedback mean over a data-parallel group of size 1, which
is what JAX computes on a 1x1 mesh (quantise, dequantise, carry the
error).

Encoder models (whisper) encode ``batch["frames"]`` into
``batch["context"]`` before the loss, as JAX's ``_loss`` does; a vision
batch carries its ``context``. MoE's load-balancing loss is not added:
the JAX ``loss_fn`` takes ``aux_weight`` and does not use it, and neither
does the port's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.device import DeviceLike
from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import param_specs
from repro_torch.launch.mesh import tp_size
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt
from repro_torch.training.grad_compression import compressed_mean, group_sum


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)
    remat: bool = True
    microbatches: int = 1
    compressed_grads: bool = False


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     tcfg: TrainConfig, tp: int = 1, mesh=None, *,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    """{'params': compute-dtype params, 'opt': AdamWState}; random weights
    from ``gen``, which must live on ``device``. With a ``mesh`` (its
    model axis ``tp``): this rank's shards of the weights and ZeRO-1
    slices of the optimizer state."""
    if mesh is None:
        params = tr.init_params(gen, cfg, tp, device=device)
        return {"params": params, "opt": opt.init_state(params, tcfg.adamw)}
    params = tr.init_params(gen, cfg, tp, mesh, device=device)
    return {"params": params, "opt": opt.init_state(
        params, tcfg.adamw, param_specs(params, cfg, tp), mesh)}


def _loss(params, batch, cfg: ModelConfig, remat: bool = False):
    """``tr.loss_fn``, after encoding ``batch["frames"]`` into
    ``batch["context"]`` for an encoder-decoder model."""
    batch = dict(batch)
    if cfg.encoder_stages is not None:
        batch["context"] = tr.encode(params, batch.pop("frames"), cfg,
                                     remat=remat)
    return tr.loss_fn(params, batch, cfg, remat=remat)


def _value_and_grad(params, batch, cfg: ModelConfig, remat: bool,
                    weight=None):
    """(loss, gradients shaped like ``params``, each in its leaf's dtype),
    of the loss times ``weight`` when one is given."""
    p = tr.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tr.tree_leaves(p)
    loss = _loss(p, batch, cfg, remat=remat)
    if weight is not None:
        loss = loss * weight
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, grads))
    return loss.detach(), tr.tree_map(lambda _: next(it), params)


#: batch entries that hold embeddings (float), not token ids
FLOAT_INPUTS = ("context", "frames")


def _on_device(batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    """Token ids as int64 tensors on ``dev``; ``context`` and ``frames``
    keep their float dtype. numpy batches are copied: the loader's arrays
    are read-only views."""
    out = {}
    for k, v in batch.items():
        if k in FLOAT_INPUTS:
            out[k] = torch.as_tensor(np.array(v) if isinstance(
                v, np.ndarray) else v, device=dev)
        else:
            out[k] = torch.as_tensor(np.array(v, np.int64) if isinstance(
                v, np.ndarray) else v, device=dev).long()
    return out


def _grads(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    """Loss and gradient of the global batch, the mean over
    ``microbatches`` equal slices of it. On a data-parallel mesh (the
    active one) each rank takes its rows of every slice, weighted by its
    share of the slice's loss tokens, and one all-reduce over the data
    axes sums all leaves and the loss. Without a mesh, or when a slice
    does not split over the data axes, a rank takes whole slices with
    weight 1/mb and no collective runs. One slice gives its gradients
    in the leaves' dtype, more than one accumulate in float32."""
    B = batch["tokens"].shape[0]
    mb = max(tcfg.microbatches, 1)
    dev = tr.tree_leaves(params)[0].device
    per = B // mb
    split = ctx.dp_sharded(per)
    rows = ctx.dp_rows(per)
    chunks = [{k: v[i * per:(i + 1) * per][rows] for k, v in batch.items()}
              for i in range(mb)]
    if split:
        counts = torch.stack([(c["labels"] >= 0).sum()
                              for c in chunks]).float()
        total = ctx.all_reduce(counts.clone(), dist.ReduceOp.SUM,
                               ctx.dp_group())
        weights = counts / torch.clamp_min(total, 1.0) / mb
    else:
        weights = torch.ones(mb, device=dev) / mb
    with ctx.split_batch(split):
        parts = (_value_and_grad(params, c, cfg, tcfg.remat, weight=w)
                 for c, w in zip(chunks, weights))
        if mb == 1:
            loss, grads = next(parts)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tr.tree_map(lambda t: torch.zeros(
                t.shape, dtype=torch.float32, device=t.device), params)
            for l, g in parts:
                loss = loss + l
                for a, b in zip(tr.tree_leaves(grads), tr.tree_leaves(g)):
                    a.add_(b)
    if not split:           # every rank computed the whole batch
        return loss, grads
    summed = group_sum(tr.tree_leaves(grads) + [loss], ctx.mesh(),
                       ctx.dp_axes())
    it = iter(summed[:-1])
    return summed[-1], tr.tree_map(lambda _: next(it), grads)


def train_step(state, batch, cfg: ModelConfig, tcfg: TrainConfig,
               mesh=None) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """state: {'params', 'opt'}; batch: {'tokens', 'labels'} (numpy or
    tensors), with 'context' (vision) or 'frames' (whisper): the global
    batch, on every rank when ``mesh`` is given (data- and tensor-parallel,
    see the module docstring). Returns (state, {'loss', 'step'}); the parameters
    and the optimizer's tensors are updated in place."""
    params = state["params"]
    batch = _on_device(batch, tr.tree_leaves(params)[0].device)
    err = state["opt"].err
    specs = None if mesh is None else param_specs(params, cfg,
                                                  tp_size(mesh))
    with ctx.activate(mesh):
        loss, grads = _grads(params, batch, cfg, tcfg)
        if tcfg.compressed_grads:
            grads, err = compressed_mean(grads, err, mesh, specs=specs)
    new_opt = opt.apply_updates(
        state["opt"]._replace(err=err), grads, tcfg.adamw, params,
        compute_dtype=tr.tree_leaves(params)[0].dtype, specs=specs,
        mesh=mesh)
    return {"params": params, "opt": new_opt}, {"loss": loss,
                                                "step": new_opt.step}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """``train_step`` with the configs and the mesh bound (JAX jits and
    donates here)."""
    return functools.partial(train_step, cfg=cfg, tcfg=tcfg, mesh=mesh)

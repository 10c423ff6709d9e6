"""The train step: loss -> gradients -> (int8 error-feedback mean) ->
AdamW, with per-unit remat and microbatch gradient accumulation.

Port of ``repro.training.train_step`` on one device. PyTorch runs eagerly,
so there is no jit and no donation; instead the optimizer state and the
parameters are updated in place (:mod:`repro_torch.training.optimizer`).

JAX compresses the gradient mean only ``if tcfg.compressed_grads and mesh
is not None``. The port has no mesh: ``compressed_grads=True`` runs the
int8 error-feedback mean over a data-parallel group of size 1, which is
what JAX computes on a 1x1 mesh (quantise, dequantise, carry the error).

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

from repro_torch.device import DeviceLike
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt
from repro_torch.training.grad_compression import compressed_mean


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)
    remat: bool = True
    microbatches: int = 1
    compressed_grads: bool = False


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     tcfg: TrainConfig, tp: int = 1, *,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    """{'params': compute-dtype params, 'opt': AdamWState}; random weights
    from ``gen``, which must live on ``device``."""
    params = tr.init_params(gen, cfg, tp, device=device)
    return {"params": params, "opt": opt.init_state(params, tcfg.adamw)}


def _loss(params, batch, cfg: ModelConfig, remat: bool = False):
    """``tr.loss_fn``, after encoding ``batch["frames"]`` into
    ``batch["context"]`` for an encoder-decoder model."""
    batch = dict(batch)
    if cfg.encoder_stages is not None:
        batch["context"] = tr.encode(params, batch.pop("frames"), cfg,
                                     remat=remat)
    return tr.loss_fn(params, batch, cfg, remat=remat)


def _value_and_grad(params, batch, cfg: ModelConfig, remat: bool):
    """(loss, gradients shaped like ``params``, each in its leaf's dtype)."""
    p = tr.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tr.tree_leaves(p)
    loss = _loss(p, batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, grads))
    return loss.detach(), tr.tree_map(lambda _: next(it), params)


def _grads(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    """Loss and gradients of the batch; with ``microbatches`` > 1 the mean
    over that many equal slices of the batch, accumulated in float32."""
    remat = tcfg.remat
    if tcfg.microbatches <= 1:
        return _value_and_grad(params, batch, cfg, remat)
    mb = tcfg.microbatches
    split = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    dev = tr.tree_leaves(params)[0].device
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    grad_acc = tr.tree_map(lambda t: torch.zeros(
        t.shape, dtype=torch.float32, device=t.device), params)
    for i in range(mb):
        loss, g = _value_and_grad(params, {k: v[i] for k, v in split.items()},
                                  cfg, remat)
        loss_acc = loss_acc + loss / mb
        for a, b in zip(tr.tree_leaves(grad_acc), tr.tree_leaves(g)):
            a.add_(b / mb)
    return loss_acc, grad_acc


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


def train_step(state, batch, cfg: ModelConfig, tcfg: TrainConfig,
               ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """state: {'params', 'opt'}; batch: {'tokens', 'labels'} (numpy or
    tensors), with 'context' (vision) or 'frames' (whisper). Returns (state, {'loss', 'step'}); the parameters and the
    optimizer's tensors are updated in place."""
    params = state["params"]
    batch = _on_device(batch, tr.tree_leaves(params)[0].device)
    loss, grads = _grads(params, batch, cfg, tcfg)
    err = state["opt"].err
    if tcfg.compressed_grads:
        grads, err = compressed_mean(grads, err)
    new_opt = opt.apply_updates(
        state["opt"]._replace(err=err), grads, tcfg.adamw, params,
        compute_dtype=tr.tree_leaves(params)[0].dtype)
    return {"params": params, "opt": new_opt}, {"loss": loss,
                                                "step": new_opt.step}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """``train_step`` with the configs bound (JAX jits and donates here)."""
    return functools.partial(train_step, cfg=cfg, tcfg=tcfg)

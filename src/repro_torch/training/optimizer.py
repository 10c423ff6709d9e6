"""AdamW written by hand, with bf16-compute / float32-master discipline.

Port of ``repro.training.optimizer``, step for step: a linear warmup of
the learning rate, a global-norm clip of the gradients, bias-corrected
moments, ``sqrt(vh) + eps`` in the denominator and the weight decay
applied inside the step (``mp - lr * (mh / (sqrt(vh) + eps) + wd * mp)``).
``torch.optim.AdamW`` decays the weights before the step, so it rounds
differently, and is not used.

The master weights and both moments are float32 trees shaped like the
parameters. Unlike JAX's functional update, :func:`apply_updates` updates
``master``, ``m`` and ``v`` IN PLACE and writes the new compute-dtype
parameters into the existing parameter tensors, which at zamba2-2.7b's
size saves a second copy of the state (about 33 GB) and of the bf16
parameters (4.7 GB). Every master leaf is rounded through the compute
dtype (the first parameter leaf's, as JAX takes it), also for the leaves
that stay float32 tensors here (Mamba2's ``A_log``, ``D``, ``dt_bias``):
JAX casts them to the compute dtype, so their values match.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.transformer import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, on the parameters' device
    master: Any                 # float32 copy of the parameters
    m: Any
    v: Any
    err: Optional[Any]          # error-feedback residual (compression only)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    error_feedback: bool = False


def init_state(params, cfg: AdamWConfig) -> AdamWState:
    """Master weights (a float32 copy, never aliasing the parameters),
    zero moments, and a zero residual when ``cfg.error_feedback``."""
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    zeros = lambda: tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    err = zeros() if cfg.error_feedback else None
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), master,
                      zeros(), zeros(), err)


def _f32(x: float, dev: torch.device) -> torch.Tensor:
    """A float32 scalar on ``dev``. Dividing by it is an IEEE division on
    every device; PyTorch's CUDA division by a Python scalar multiplies by
    the reciprocal instead."""
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max(step.float() / _f32(max(cfg.warmup_steps, 1),
                                                step.device), 1.0)
    return cfg.lr * warm


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 dot with itself."""
    return torch.sqrt(sum(torch.dot(g.reshape(-1).float(), g.reshape(-1).float())
                          for g in leaves))


@torch.no_grad()
def apply_updates(state: AdamWState, grads, cfg: AdamWConfig, params,
                  compute_dtype: torch.dtype = torch.bfloat16) -> AdamWState:
    """One AdamW step from ``grads`` (any float dtype; used in float32).
    Updates ``state.master``, ``state.m``, ``state.v`` and ``params`` in
    place (``params`` gets the new master weights rounded to
    ``compute_dtype``) and returns the state with the step advanced."""
    step = state.step + 1
    dev = step.device
    lr = _schedule(cfg, step)
    g_leaves = tree_leaves(grads)
    gnorm = global_norm(g_leaves)
    scale = torch.clamp_max(_f32(cfg.grad_clip, dev) / (gnorm + 1e-9), 1.0)
    t = step.float()
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), t)
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), t)
    for mp, g, m, v, p in zip(tree_leaves(state.master), g_leaves,
                              tree_leaves(state.m), tree_leaves(state.v),
                              tree_leaves(params)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        mp.sub_(lr * (mh / (torch.sqrt(vh) + cfg.eps)
                      + cfg.weight_decay * mp))
        p.copy_(mp.to(compute_dtype))
    return AdamWState(step, state.master, state.m, state.v, state.err)

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

On a mesh (``specs``, the parameters' ``param_specs``, and ``mesh``) the
parameters and gradients are this rank's tensor-parallel shards, and the
optimizer state is ZeRO-1's (:func:`zero1_tree_specs`, the reference's
``zero1_specs`` over 'data'): ``master``, ``m`` and ``v`` hold this rank's
slice over 'data' of its shard, along the first dimension that divides.
Each rank updates its slice and all-gathers the new parameters over
'data'; AdamW is elementwise, so this is the replicated update. The
global norm sums the squares of the model-sharded leaves over 'model' and
counts the replicated ones once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import (Spec, leaves, map_specs,
                                              shard_leaf, spec_dim,
                                              zero1_specs)
from repro_torch.launch.mesh import axis_sizes
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


def zero1_tree_specs(p_specs, params, mesh):
    """The optimizer state's specs on ``mesh``: ``zero1_specs`` over
    'data' (its size), or the parameters' own where 'data' is 1."""
    dp = axis_sizes(mesh).get("data", 1)
    return p_specs if dp == 1 else zero1_specs(p_specs, params, "data", dp)


def init_state(params, cfg: AdamWConfig, specs=None,
               mesh=None) -> AdamWState:
    """Master weights (a float32 copy, never aliasing the parameters),
    zero moments, and a zero residual when ``cfg.error_feedback``. With
    ``specs`` and ``mesh`` the parameters are this rank's shards, and
    master and the moments its ZeRO-1 slices of them; the residual, whole
    leaves as the reference keeps it, is then made by the first
    ``compressed_mean``."""
    opt_params = params
    if mesh is not None:                # the 'data' entries of ZeRO-1's
        z = zero1_tree_specs(specs, params, mesh)
        opt_params = map_specs(
            lambda s, p: shard_leaf(p, Spec(*(e if e == "data" else None
                                              for e in s)), mesh), z, params)
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      opt_params)
    zeros = lambda tree: tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), tree)
    err = zeros(params) if cfg.error_feedback and mesh is None else None
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), master,
                      zeros(opt_params), zeros(opt_params), err)


def _f32(x: float, dev: torch.device) -> torch.Tensor:
    """A float32 scalar on ``dev``. Dividing by it is an IEEE division on
    every device; PyTorch's CUDA division by a Python scalar multiplies by
    the reciprocal instead."""
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max(step.float() / _f32(max(cfg.warmup_steps, 1),
                                                step.device), 1.0)
    return cfg.lr * warm


def _sq(g: torch.Tensor) -> torch.Tensor:
    return torch.dot(g.reshape(-1).float(), g.reshape(-1).float())


def global_norm(grads, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 dot with itself.
    With ``specs`` and a ``mesh`` whose model axis is above 1 the leaves
    are this rank's shards: the squares of the model-sharded leaves are
    summed over 'model', the replicated leaves counted once."""
    if mesh is None or axis_sizes(mesh)["model"] == 1:
        return torch.sqrt(sum(_sq(g) for g in grads))
    parts = torch.zeros(2, dtype=torch.float32, device=grads[0].device)
    for g, spec in zip(grads, leaves(specs)):
        parts[int(spec_dim(spec, "model") is None)] += _sq(g)
    ctx.all_reduce(parts[:1], dist.ReduceOp.SUM, mesh.get_group("model"))
    return torch.sqrt(parts.sum())


@torch.no_grad()
def apply_updates(state: AdamWState, grads, cfg: AdamWConfig, params,
                  compute_dtype: torch.dtype = torch.bfloat16, specs=None,
                  mesh=None) -> AdamWState:
    """One AdamW step from ``grads`` (any float dtype; used in float32).
    Updates ``state.master``, ``state.m``, ``state.v`` and ``params`` in
    place (``params`` gets the new master weights rounded to
    ``compute_dtype``) and returns the state with the step advanced. With
    ``specs`` (the parameters' ``param_specs``) and ``mesh``: this rank's
    shards, and ZeRO-1 slices where a master leaf is narrower than its
    parameter (see the module docstring); a whole state takes the
    replicated update."""
    step = state.step + 1
    dev = step.device
    lr = _schedule(cfg, step)
    g_leaves = tree_leaves(grads)
    gnorm = global_norm(g_leaves, specs, mesh)
    scale = torch.clamp_max(_f32(cfg.grad_clip, dev) / (gnorm + 1e-9), 1.0)
    t = step.float()
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), t)
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), t)
    for mp, g, m, v, p in zip(tree_leaves(state.master), g_leaves,
                              tree_leaves(state.m), tree_leaves(state.v),
                              tree_leaves(params)):
        # a ZeRO-1 slice is narrower than the parameter in one dimension
        d = next((i for i, (a, b) in enumerate(zip(mp.shape, p.shape))
                  if a != b), None)
        if d is not None:
            group, r = mesh.get_group("data"), mesh.get_local_rank("data")
            g = g.narrow(d, r * mp.shape[d], mp.shape[d])
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        mp.sub_(lr * (mh / (torch.sqrt(vh) + cfg.eps)
                      + cfg.weight_decay * mp))
        new = mp.to(compute_dtype)
        p.copy_(new if d is None else ctx.all_gather(new, d, group))
    return AdamWState(step, state.master, state.m, state.v, state.err)

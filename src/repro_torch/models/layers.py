"""Shared building blocks: norms, RoPE, MLPs, initializers.

Port of ``repro.models.layers``. Functional style: every module is
``init(gen, cfg) -> params`` and ``apply(params, x)``, with parameters as
plain dicts of tensors so stages can stack them on a leading repeats axis
(transformer.py). Initializers draw from an explicit ``torch.Generator``
on the generator's device; the numbers differ from ``jax.random``'s for
the same seed, so parity tests carry weights over with
:func:`repro_torch.convert.model_params_from_arrays`.

Under a mesh whose model axis is above 1 (:mod:`repro_torch.distributed.ctx`)
the parameters are this rank's shards (``sharding.param_specs``): the MLP
is column-parallel in ``gate``/``up`` and row-parallel in ``down``, the
embedding vocab-parallel, and :func:`rms_norm` with ``sharded=True``
normalises over a feature axis split across the ranks.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ------------------------------------------------------------------- helpers
class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device, which has
    none: the initializers given it make tensors of the right shape and
    dtype without storage (``transformer.init_params(MetaGenerator(), cfg,
    tp, device="meta")``, what ``jax.eval_shape`` of ``init_params``
    gives in the JAX package)."""
    device = torch.device("meta")


def normal(gen: torch.Generator, shape, scale: float = 1.0) -> torch.Tensor:
    """float32 standard normals on ``gen``'s device, times ``scale``."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * scale


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    return normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    # 1/sqrt(dim) keeps tied-head logits at unit scale (CE ~ ln V at init)
    return (normal(gen, (vocab, dim)) / math.sqrt(dim)).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False, sharded: bool = False) -> torch.Tensor:
    """RMS norm computed in float32 and cast back to ``x.dtype``. With
    ``sharded`` the last axis of ``x`` and ``weight`` is this rank's shard
    of a feature axis split over the model axis: the sum of squares is
    summed over the ranks in float32, so the norm is over the whole axis
    (Mamba2's ``gate_norm`` over ``d_inner``)."""
    x32 = x.float()
    if sharded and ctx.model_axis_size() > 1:
        ss = ctx.sum_over_model((x32 * x32).sum(dim=-1, keepdim=True))
        var = ss / (x.shape[-1] * ctx.model_axis_size())
    else:
        var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:                      # gemma-style (1 + w) scaling
        w = 1.0 + w
    return (y * w).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Rotates the
    two halves of the head (not interleaved pairs), with float32 angles."""
    head_dim = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions[..., :, None, None].float() * freqs   # (...,s,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- MLP
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    p = {}
    if act in ("swiglu", "geglu"):
        p["gate"] = dense_init(gen, d_model, d_ff, dtype)
    p["down"] = dense_init(gen, d_ff, d_model, dtype)
    p["up"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with ``w`` row-parallel: each rank's product over its rows
    of ``w``, in ``x``'s dtype, summed over the model axis."""
    return ctx.reduce_from_model(x @ w)


def mlp_partial(p: Dict[str, torch.Tensor], x: torch.Tensor,
                act: str) -> torch.Tensor:
    """The MLP on this rank's ``d_ff`` columns: under tensor parallelism
    its share of the output, which the ranks sum (``x`` is the input after
    ``ctx.copy_to_model``); the whole output on one rank."""
    if act == "swiglu":
        h = F.silu(x @ p["gate"]) * (x @ p["up"])
    elif act == "geglu":
        h = gelu(x @ p["gate"]) * (x @ p["up"])
    else:
        h = gelu(x @ p["up"])
    return h @ p["down"]


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              act: str) -> torch.Tensor:
    """``gate``/``up`` column-parallel, ``down`` row-parallel and summed
    over the model axis."""
    return ctx.reduce_from_model(mlp_partial(p, ctx.copy_to_model(x), act))


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of an embedding table that is vocab-sharded over the
    model axis: this rank looks up the ids in its block of rows, zeros for
    the others, and the ranks' rows are summed (exact: one rank holds each
    id)."""
    if ctx.model_axis_size() == 1:
        return table[ids]
    rows = table.shape[0]
    local = ids - ctx.model_rank() * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)] * mine[..., None].to(table.dtype)
    return ctx.reduce_from_model(x)

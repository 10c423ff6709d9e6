"""Mamba2 (SSD) mixer block — arXiv:2405.21060.

Port of ``repro.models.mamba2``. Inputs project to (z, x, B, C, dt);
(x | B,C) pass through short causal depthwise convs; the SSD chunked scan
(kernels/ops.ssd_scan, a CUDA kernel on the card) computes the sequence
mix; a gated RMSNorm and output projection close the block. The input
projection is split into in_z/in_x/in_bc/in_dt and the conv into its x and
B/C parts, as in the JAX package, so converted weights map one to one.

Decode carries (conv_x, conv_bc, ssm_state), O(1) in context length; the
port updates them in place.

Under a mesh whose model axis is above 1 (:mod:`repro_torch.distributed.ctx`)
the weights are this rank's shards (``sharding.param_specs``): in_z,
in_x, conv_x_* and out_proj by channels, and A_log, D, dt_bias and in_dt
by heads when the heads divide. The scan (K7) and the decode step then run
on the rank's heads, with B and C (in_bc, conv_bc_*, replicated) entering
through ``ctx.copy_to_model``; gate_norm normalises over the whole
``d_inner`` (a sum of squares over the ranks), and out_proj is
row-parallel. Where the heads do not divide, the rank's channels of x are
gathered and the scan runs whole on every rank, as ``_rules`` replicates
the head vectors, before each rank keeps its channels. The decode states
follow ``cache_specs``: conv_x by channels, conv_bc whole, the SSM state by
heads when they divide.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, dtype_of, normal,
                                       rms_norm, row_parallel)

N_GROUPS = 1  # B/C groups (mamba2 default)
#: parameters kept in float32 whatever the model's dtype
FLOAT32_PARAMS = ("A_log", "D", "dt_bias")

Params = Dict[str, torch.Tensor]


def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = dtype_of(cfg.dtype)
    dev = gen.device
    d = cfg.d_model
    di = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.mamba_heads
    bc = 2 * N_GROUPS * n
    dt_init = np.log(np.expm1(np.linspace(1e-3, 0.1, h)))  # softplus^-1
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return {
        "in_z": dense_init(gen, d, di, dt),
        "in_x": dense_init(gen, d, di, dt),
        "in_bc": dense_init(gen, d, bc, dt),
        "in_dt": dense_init(gen, d, h, dt),
        "conv_x_w": normal(gen, (cfg.conv_width, di),
                           1.0 / cfg.conv_width).to(dt),
        "conv_x_b": torch.zeros(di, dtype=dt, device=dev),
        "conv_bc_w": normal(gen, (cfg.conv_width, bc),
                            1.0 / cfg.conv_width).to(dt),
        "conv_bc_b": torch.zeros(bc, dtype=dt, device=dev),
        "A_log": f32(np.log(np.linspace(1.0, 16.0, h))),
        "D": torch.ones(h, dtype=torch.float32, device=dev),
        "dt_bias": f32(dt_init),
        "gate_norm": torch.ones(di, dtype=dt, device=dev),
        "out_proj": dense_init(gen, di, d, dt),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv over seq. u: (B,S,C); w: (W,C)."""
    W = w.shape[0]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = pad[:, 0:u.shape[1], :] * w[0][None, None, :]
    for i in range(1, W):
        out = out + pad[:, i:i + u.shape[1], :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def _gate(y: torch.Tensor, z: torch.Tensor, p: Params, cfg: ModelConfig):
    return rms_norm(y * F.silu(z.float()).to(y.dtype), p["gate_norm"],
                    cfg.norm_eps, sharded=True)


def heads_split(cfg: ModelConfig) -> bool:
    """True when the scan runs on this rank's heads: no model axis above
    1, or heads that divide by it (``_rules`` shards the head vectors)."""
    return cfg.mamba_heads % ctx.model_axis_size() == 0


def _channels(y: torch.Tensor) -> torch.Tensor:
    """This rank's block of the last axis of ``y`` (every channel)."""
    return y[..., ctx.model_shard(y.shape[-1])]


def mamba_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence SSD. x: (B, S, d) -> (B, S, d)."""
    Bsz, S, _ = x.shape
    n, hd = cfg.ssm_state, cfg.mamba_headdim
    split = heads_split(cfg)
    xc = ctx.copy_to_model(x)
    z = xc @ p["in_z"]
    xi = _causal_conv(xc @ p["in_x"], p["conv_x_w"], p["conv_x_b"])
    bc = _causal_conv(x @ p["in_bc"], p["conv_bc_w"], p["conv_bc_b"])
    if split:
        bc = ctx.copy_to_model(bc)
        dt_raw = xc @ p["in_dt"]
    else:
        xi = ctx.gather_from_model(xi, -1)
        dt_raw = x @ p["in_dt"]
    xs = xi.reshape(Bsz, S, -1, hd)
    Bm = bc[..., :N_GROUPS * n].reshape(Bsz, S, N_GROUPS, n)
    Cm = bc[..., N_GROUPS * n:].reshape(Bsz, S, N_GROUPS, n)
    dt_v = softplus(dt_raw.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    y, _ = ops.ssd_scan(xs, dt_v, A, Bm, Cm, p["D"])
    y = y.reshape(Bsz, S, -1)
    if not split:
        y = _channels(ctx.copy_to_model(y))
    return row_parallel(_gate(y, z, p, cfg), p["out_proj"])


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device, lead: Tuple[int, ...] = (),
                     ) -> Tuple[torch.Tensor, ...]:
    """(conv_x, conv_bc, ssm_state) zeros, each with leading dims ``lead``
    (the stage's repeats axis)."""
    bc = 2 * N_GROUPS * cfg.ssm_state
    zeros = lambda *shape, dt=dtype: torch.zeros(lead + (batch,) + shape,
                                                 dtype=dt, device=device)
    return (zeros(cfg.conv_width - 1, cfg.d_inner),
            zeros(cfg.conv_width - 1, bc),
            zeros(cfg.mamba_heads, cfg.mamba_headdim, cfg.ssm_state,
                  dt=torch.float32))


def _conv_step(state: torch.Tensor, u_t: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """state: (B,W-1,C), shifted IN PLACE to hold the last W-1 inputs;
    u_t: (B,C). Returns out (B,C), computed in float32."""
    window = torch.cat([state, u_t[:, None]], dim=1)
    out = torch.einsum("bwc,wc->bc", window.float(), w.float())
    state.copy_(window[:, 1:])
    return F.silu(out + b.float()).to(u_t.dtype)


def mamba_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 conv_x: torch.Tensor, conv_bc: torch.Tensor,
                 ssm_state: torch.Tensor):
    """Single-token step. x: (B,1,d). Returns (y, conv_x, conv_bc, ssm),
    the three states updated in place (this rank's channels of conv_x and,
    when the heads divide, its heads of the SSM state)."""
    Bsz = x.shape[0]
    n, hd = cfg.ssm_state, cfg.mamba_headdim
    z = x @ p["in_z"]
    xi_t = _conv_step(conv_x, (x @ p["in_x"])[:, 0], p["conv_x_w"],
                      p["conv_x_b"])
    bc_t = _conv_step(conv_bc, (x @ p["in_bc"])[:, 0], p["conv_bc_w"],
                      p["conv_bc_b"])
    split = heads_split(cfg)
    if not split:
        xi_t = ctx.gather_from_model(xi_t, -1)
    dt_raw = (x @ p["in_dt"])[:, 0]
    xs = xi_t.reshape(Bsz, -1, hd)
    Bm = bc_t[:, :N_GROUPS * n].reshape(Bsz, N_GROUPS, n)
    Cm = bc_t[:, N_GROUPS * n:].reshape(Bsz, N_GROUPS, n)
    dt_v = softplus(dt_raw.float() + p["dt_bias"][None, :])
    A = -torch.exp(p["A_log"])
    y_t, new_state = ops.ssd_step(ssm_state, xs, dt_v, A, Bm, Cm, p["D"])
    ssm_state.copy_(new_state)
    y_t = y_t.reshape(Bsz, 1, -1)
    y = _gate(y_t if split else _channels(y_t), z, p, cfg)
    return row_parallel(y, p["out_proj"]), conv_x, conv_bc, ssm_state

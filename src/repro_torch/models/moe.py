"""Mixture-of-Experts MLP with capacity-based dispatch (Shazeer-style).

Port of ``repro.models.moe``. Expert weights are stacked on
a leading expert axis, as in the JAX package. The JAX package computes
MoE outside any Pallas kernel, so the port does too: a float32 router,
top-k, a float32 cumulative sum for the slot ids, gathers into (E, C)
expert buffers, batched products over the experts and a gather back. The
reference's rules are kept exactly: capacity ``max(min(ceil(T k / E cf),
T), 1)`` in Python float, slots past the capacity sent to an overflow bin
E and dropped, gates a softmax over the top-k logits, and shared experts
through ``mlp_apply``.

Routing per data-parallel group (``repro/models/moe.py`` ``moe_apply``):
with dp data-parallel ranks and blocks of ``blk = moe_block_tokens``, the
reference routes consecutive blocks of blk tokens of the flattened global
batch when T divides by blk * dp and T > blk, and the whole global batch
as one block (capacity over all T) otherwise. A rank that holds its rows
of the batch (``ctx.batch_is_split()``) holds whole blocks in the first
case and routes them alone; in the second it all-gathers the tokens over
the data axes, routes the whole batch and keeps its own rows. So at T = 3
blk and dp 2 the mesh's routing is not the single device's, in both
packages.

Expert parallelism over a model axis above 1 (``experts_*`` are
``P("model", None, None)``): every rank routes the same tokens with the
whole router (the same top-k on every rank), runs its E / tp experts on
the tokens sent to them, and adds its share of the combine; the shared
experts are column- and row-parallel as the MLP, and the ranks' shares
are summed (``ctx.reduce_from_model``). The tokens and the router's
logits enter the rank's experts through ``ctx.copy_to_model``, so their
gradients, and the router's, are summed over the ranks.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (dense_init, dtype_of, mlp_init,
                                       mlp_partial, normal)

Params = Dict[str, torch.Tensor]

#: leaves kept in float32 whatever ``cfg.dtype`` is: routing (top-k over
#: the router's logits) would drift from the reference if it were rounded
FLOAT32_PARAMS = ("router",)


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = dtype_of(cfg.dtype)
    E, dff, d = cfg.n_experts, cfg.expert_d_ff, cfg.d_model
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": dense_init(gen, d, E, torch.float32),
        "experts_gate": normal(gen, (E, d, dff), scale).to(dt),
        "experts_up": normal(gen, (E, d, dff), scale).to(dt),
        "experts_down": normal(gen, (E, dff, d), 1.0 / math.sqrt(dff)).to(dt),
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = mlp_init(gen, d, cfg.n_shared_experts * dff,
                               cfg.mlp_act, dt)
    return p


def route(logits: torch.Tensor, k: int):
    """(top-k router logits, their experts), each (T, k): the routing
    choice. A module function, so a caller can observe or replay the
    choices (``chip_smoke.py`` holds a bf16 model's kernels against their
    plain versions at the same routing)."""
    return torch.topk(logits, k, dim=-1)


def capacity(T: int, cfg: ModelConfig) -> int:
    """Slots per expert for a block of T tokens."""
    c = int(math.ceil(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(min(c, T), 1)


def _moe_block(p: Params, xt: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Capacity dispatch for one token block. xt: (T, d) -> (T, d): the
    experts this rank holds, which are all of them on one rank."""
    T, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = ctx.copy_to_model(xt.float() @ p["router"])     # (T, E)
    xt = ctx.copy_to_model(xt)
    topv, topi = route(logits, k)                            # (T, k)
    gates = torch.softmax(topv, dim=-1)                      # normalize over k
    C = capacity(T, cfg)

    # position of each (token, choice) within its expert's buffer
    onehot = F.one_hot(topi, E).float()                      # (T, k, E)
    flat = onehot.reshape(T * k, E)
    pos = torch.cumsum(flat, dim=0) - flat                   # (T*k, E)
    pos = (pos.reshape(T, k, E) * onehot).sum(-1)            # (T, k) slot ids
    kept = pos < C

    # token ids into (E + 1, C) expert buffers; row E is the overflow bin
    tok_ids = torch.arange(T, device=xt.device)[:, None].expand(T, k)
    e_idx = torch.where(kept, topi, E).reshape(-1)
    c_idx = pos.clamp(0, C - 1).long()
    slot_tok = torch.zeros((E + 1, C), dtype=torch.long, device=xt.device)
    slot_tok[e_idx, c_idx.reshape(-1)] = tok_ids.reshape(-1)
    slot_valid = torch.zeros((E + 1, C), dtype=torch.bool, device=xt.device)
    slot_valid[e_idx, c_idx.reshape(-1)] = True
    # this rank's experts [e0, e0 + El)
    El = p["experts_gate"].shape[0]
    e0 = ctx.model_rank() * El if El < E else 0
    xe = xt[slot_tok[e0:e0 + El].reshape(-1)].reshape(El, C, d)
    xe = xe * slot_valid[e0:e0 + El, :, None].to(xe.dtype)   # (El, C, d)

    h = F.silu(torch.bmm(xe, p["experts_gate"])) * torch.bmm(xe, p["experts_up"])
    ye = torch.bmm(h, p["experts_down"])                     # (El, C, d)

    # gather back: y_t = sum_k gate * ye[e_tk, c_tk] over this rank's
    # experts (the others' choices weigh 0 here)
    local = topi - e0
    mine = (local >= 0) & (local < El)
    flat_idx = local.clamp(0, El - 1) * C + c_idx            # (T, k)
    y_k = ye.reshape(El * C, d)[flat_idx.reshape(-1)].reshape(T, k, d)
    w = (gates * (kept & mine)).to(y_k.dtype)
    return torch.einsum("tk,tkd->td", w, y_k).to(xt.dtype)


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Top-k capacity routing, in blocks of
    ``moe_block_tokens`` tokens (capacity and slots per block) when the
    global batch's tokens divide into blocks over every data-parallel
    rank, else as one block of the whole global batch (see the module
    docstring)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    blk = cfg.moe_block_tokens
    dp = ctx.dp_size()
    split = ctx.batch_is_split()
    T_all = T * dp if split else T
    if T_all % (blk * dp) == 0 and T_all > blk:
        y = torch.cat([_moe_block(p, xb, cfg) for xb in xt.split(blk)])
    elif split:
        # the whole global batch is one block: gather the others' tokens
        # (no gradient reaches them: a token's output depends on its own
        # input once routed), route all, keep this rank's rows
        r = ctx.dp_rank()
        parts = list(ctx.all_gather_rows(xt.detach(), ctx.dp_group())
                     .split(T))
        parts[r] = xt
        y = _moe_block(p, torch.cat(parts), cfg)[r * T:(r + 1) * T]
    else:
        y = _moe_block(p, xt, cfg)
    if "shared" in p:
        y = y + mlp_partial(p["shared"], ctx.copy_to_model(xt), cfg.mlp_act)
    return ctx.reduce_from_model(y).reshape(B, S, d).to(x.dtype)


def moe_aux_loss(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e."""
    xt = x.reshape(-1, x.shape[-1])
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top1 = logits.argmax(-1)
    frac = F.one_hot(top1, cfg.n_experts).float().mean(0)
    return cfg.n_experts * (frac * probs.mean(0)).sum()

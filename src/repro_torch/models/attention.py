"""Attention blocks: GQA (qk-norm / bias / softcap / sliding window),
MLA (DeepSeek's compressed KV) and cross-attention.

Port of ``repro.models.attention``. Parameter names follow the JAX
package: wq/wk/wv/wo (+bq/bk/bv), q_norm/k_norm; MLA's w_dkv, kv_norm,
w_uk, w_uv. Head counts are padded to a multiple of ``tp`` as there, so
converted weights keep their shapes.

Under a mesh whose model axis is above 1 (:mod:`repro_torch.distributed.ctx`)
the weights are this rank's shards (``sharding.param_specs``), and the
blocks read their local head counts from their local shapes: wq (and
MLA's w_uk, w_uv) hold the rank's query heads, wk/wv its KV heads, or
every KV head where ``_rules`` replicates them (KV heads that do not
divide and are not MHA; the rank then keeps the KV heads its query heads
map to), and wo is row-parallel, summed over the ranks. A decode cache is
then this rank's slice of the sequence, every KV head of it
(``cache_specs``): a step gathers the new k/v over heads (MLA's latent is
whole on every rank) and writes them only on the rank that holds the slot
(:func:`cache_write`), as GSPMD routes the JAX package's ``.at[pos].set``;
it gathers the query heads, runs the decode attention for all heads over
its own slots and merges the ranks' partials, and keeps its own heads for
wo. Replicated leaves used on the rank's heads (q_norm, k_norm, replicated
wk/wv and their biases) pass through ``ctx.copy_to_model``, so their
gradients are summed over the ranks.
Full-sequence attention (prefill, training, the encoder, cross-attention
at every step) runs K5 (:func:`repro_torch.kernels.ops.flash_attention`);
one-token decode against a cache runs K6
(:func:`repro_torch.kernels.ops.decode_attention`), MLA's with v read
inside its latent cache.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import ctx
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, dtype_of,
                                       rms_norm, row_parallel)

Params = Dict[str, torch.Tensor]


def pad_heads(n: int, tp: int) -> int:
    return ((n + tp - 1) // tp) * tp if tp > 1 else n


def head_counts(cfg: ModelConfig, tp: int) -> Tuple[int, int]:
    """(padded q heads, padded kv heads). MHA pads kv with q; GQA keeps kv."""
    hq = pad_heads(cfg.n_heads, tp)
    if cfg.n_kv_heads == cfg.n_heads:
        return hq, hq
    assert hq % cfg.n_kv_heads == 0, (cfg.name, hq, cfg.n_kv_heads)
    return hq, cfg.n_kv_heads


def cache_write(cache: torch.Tensor, slot: torch.Tensor,
                val: torch.Tensor) -> None:
    """``cache[b, slot[b]] = val[b]`` IN PLACE for a cache (B, S, ...)
    and global slots (B,). Under a sequence-sharded mesh ``cache`` holds
    this rank's S slots from ``model_rank * S`` on, and only the rows whose
    slot lies there are written (a select, so the card is not waited
    for)."""
    bidx = torch.arange(cache.shape[0], device=cache.device)
    val = val.to(cache.dtype)
    if ctx.model_axis_size() == 1:
        cache[bidx, slot] = val
        return
    s_loc = cache.shape[1]
    local = slot - ctx.model_rank() * s_loc
    mine = ((local >= 0) & (local < s_loc)).reshape(
        (-1,) + (1,) * (val.dim() - 1))
    local = local.clamp(0, s_loc - 1)
    cache[bidx, local] = torch.where(mine, val, cache[bidx, local])


def cache_length(cache: torch.Tensor) -> int:
    """Slots of a decode cache (B, S, ...) over all model ranks."""
    return cache.shape[1] * ctx.model_axis_size()


# ------------------------------------------------------------------ GQA init
def gqa_init(gen: torch.Generator, cfg: ModelConfig, tp: int = 1,
             d_in: Optional[int] = None) -> Params:
    dt = dtype_of(cfg.dtype)
    d = d_in or cfg.d_model
    hq, hkv = head_counts(cfg, tp)
    hd = cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, d, hq * hd, dt),
        "wk": dense_init(gen, d, hkv * hd, dt),
        "wv": dense_init(gen, d, hkv * hd, dt),
        "wo": dense_init(gen, hq * hd, cfg.d_model, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(hq * hd, dtype=dt, device=dev)
        p["bk"] = torch.zeros(hkv * hd, dtype=dt, device=dev)
        p["bv"] = torch.zeros(hkv * hd, dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dt, device=dev)
        p["k_norm"] = torch.ones(hd, dtype=dt, device=dev)
    return p


def kv_replicated(cfg: ModelConfig) -> bool:
    """True when the active mesh's model axis is above 1 and ``_rules``
    holds wk/wv whole on every rank (KV heads that do not divide by it
    and are not MHA's)."""
    tp = ctx.model_axis_size()
    return tp > 1 and not (cfg.n_kv_heads % tp == 0
                           or cfg.n_kv_heads == cfg.n_heads)


def _copied(p: Params, name: str, replicated: bool) -> torch.Tensor:
    """``p[name]``, through ``ctx.copy_to_model`` when it is held whole and
    used on the rank's heads."""
    return ctx.copy_to_model(p[name]) if replicated else p[name]


def rank_kv(k: torch.Tensor, hq_loc: int) -> torch.Tensor:
    """Of k/v (B, S, Hkv, hd) holding every KV head, the heads this rank's
    ``hq_loc`` query heads map to: a contiguous block when they map in
    equal groups (GQA), else one KV head per query head."""
    hkv = k.shape[2]
    rep = hq_loc * ctx.model_axis_size() // hkv
    first = ctx.model_rank() * hq_loc
    idx = [(first + i) // rep for i in range(hq_loc)]
    used = sorted(set(idx))
    if hq_loc % len(used) == 0 and idx == [
            u for u in used for _ in range(hq_loc // len(used))]:
        return k[:, :, used[0]:used[-1] + 1]
    return k[:, :, idx]


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """q (B, S, the rank's query heads, hd), and k, v with the rank's KV
    heads, or every KV head where they are replicated."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    rep_kv = kv_replicated(cfg)
    sharded = ctx.model_axis_size() > 1
    q = x @ p["wq"]
    k = x @ _copied(p, "wk", rep_kv)
    v = x @ _copied(p, "wv", rep_kv)
    if "bq" in p:
        q = q + p["bq"]
        k = k + _copied(p, "bk", rep_kv)
        v = v + _copied(p, "bv", rep_kv)
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if "q_norm" in p:
        q = rms_norm(q, _copied(p, "q_norm", sharded), cfg.norm_eps)
        k = rms_norm(k, _copied(p, "k_norm", sharded), cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(p: Params, o: torch.Tensor) -> torch.Tensor:
    """``wo`` over the rank's heads of o (B, S, heads, dv), summed over
    the model axis."""
    B, S = o.shape[:2]
    return row_parallel(o.reshape(B, S, -1), p["wo"])


def gqa_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence self attention (prefill) on the rank's heads."""
    q, k, v = _project_qkv(p, ctx.copy_to_model(x), cfg, positions)
    if kv_replicated(cfg):
        k, v = rank_kv(k, q.shape[2]), rank_kv(v, q.shape[2])
    o = ops.flash_attention(q, k, v, causal=causal, window=window,
                            softcap=cfg.attn_softcap)
    return _out(p, o)


def _all_heads(t: torch.Tensor, whole: bool) -> torch.Tensor:
    """t (..., heads, hd) with every head: gathered over the model axis
    unless the rank holds them all already."""
    return t if whole else ctx.gather_from_model(t, -2)


def _own_heads(o: torch.Tensor, hq_loc: int) -> torch.Tensor:
    """The rank's ``hq_loc`` heads of o (B, every head, dv)."""
    r = ctx.model_rank()
    return o[:, r * hq_loc:(r + 1) * hq_loc]


def gqa_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               cache_k: torch.Tensor, cache_v: torch.Tensor,
               pos: torch.Tensor, window: Optional[int] = None):
    """Single-token decode. x: (B, 1, d); cache_*: (B, S_max, Hkv, hd);
    pos: (B,) current length (the token goes at index pos). Returns
    (y: (B, 1, d), cache_k, cache_v).

    The caches are written IN PLACE (the JAX version's ``.at[].set``
    returns new arrays); the same tensors are returned so callers read
    alike. Sliding-window layers use ring-buffer caches sized to the
    window (init_cache): writes go to ``pos % cache_len`` and the whole
    buffer is attended, which is exact because softmax is
    permutation-invariant over cached entries and keys are stored after
    RoPE. So ``window`` is not passed to the kernel, as in JAX.
    """
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    hq_loc = q.shape[2]
    rep_kv = kv_replicated(cfg)
    k, v = _all_heads(k, rep_kv), _all_heads(v, rep_kv)
    cache_len = cache_length(cache_k)
    slot = pos % cache_len                      # ring write (no-op when full)
    cache_write(cache_k, slot, k[:, 0])
    cache_write(cache_v, slot, v[:, 0])
    kv_len = torch.clamp(pos + 1, max=cache_len)
    o = ops.decode_attention(_all_heads(q[:, 0], False), cache_k, cache_v,
                             kv_len, softcap=cfg.attn_softcap)
    y = _out(p, _own_heads(o, hq_loc)[:, None])
    return y, cache_k, cache_v


# ------------------------------------------------------------ cross-attention
def cross_init(gen: torch.Generator, cfg: ModelConfig, tp: int = 1,
               ctx_dim: Optional[int] = None) -> Params:
    dt = dtype_of(cfg.dtype)
    hq, hkv = head_counts(cfg, tp)
    hd = cfg.head_dim
    dctx = ctx_dim or cfg.d_model
    return {
        "wq": dense_init(gen, cfg.d_model, hq * hd, dt),
        "wk": dense_init(gen, dctx, hkv * hd, dt),
        "wv": dense_init(gen, dctx, hkv * hd, dt),
        "wo": dense_init(gen, hq * hd, cfg.d_model, dt),
    }


def cross_apply(p: Params, x: torch.Tensor, context: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d); context: (B, Sc, dctx). Non-causal attention into the
    context (its k and v are recomputed at every call, decode steps
    included, as in the JAX package). The context is taken in the
    weights' dtype."""
    B, S, _ = x.shape
    Sc = context.shape[1]
    hd = cfg.head_dim
    rep_kv = kv_replicated(cfg)
    context = ctx.copy_to_model(context.to(p["wk"].dtype))
    q = (ctx.copy_to_model(x) @ p["wq"]).reshape(B, S, -1, hd)
    k = (context @ _copied(p, "wk", rep_kv)).reshape(B, Sc, -1, hd)
    v = (context @ _copied(p, "wv", rep_kv)).reshape(B, Sc, -1, hd)
    if rep_kv:
        k, v = rank_kv(k, q.shape[2]), rank_kv(v, q.shape[2])
    o = ops.flash_attention(q, k, v, causal=False, softcap=cfg.attn_softcap)
    return _out(p, o)


# ----------------------------------------------------------------------- MLA
def mla_init(gen: torch.Generator, cfg: ModelConfig, tp: int = 1) -> Params:
    """DeepSeek-V2(-lite) multi-head latent attention. No q-LoRA (lite)."""
    dt = dtype_of(cfg.dtype)
    hq = pad_heads(cfg.n_heads, tp)
    r = cfg.kv_lora_rank
    return {
        "wq": dense_init(gen, cfg.d_model,
                         hq * (cfg.qk_nope_dim + cfg.qk_rope_dim), dt),
        "w_dkv": dense_init(gen, cfg.d_model, r + cfg.qk_rope_dim, dt),
        "kv_norm": torch.ones(r, dtype=dt, device=gen.device),
        "w_uk": dense_init(gen, r, hq * cfg.qk_nope_dim, dt),
        "w_uv": dense_init(gen, r, hq * cfg.v_head_dim, dt),
        "wo": dense_init(gen, hq * cfg.v_head_dim, cfg.d_model, dt),
    }


def _mla_q(p: Params, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor, hq: int):
    B, S, _ = x.shape
    dq = cfg.qk_nope_dim + cfg.qk_rope_dim
    q = (x @ p["wq"]).reshape(B, S, hq, dq)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latent(p: Params, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor):
    """(c_kv (B, S, r) normed, k_rope (B, S, 1, rope) rotated): the
    compressed KV of each token, with the rope key's head axis of 1."""
    r = cfg.kv_lora_rank
    dkv = x @ p["w_dkv"]
    c_kv = rms_norm(dkv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(dkv[..., None, r:], positions, cfg.rope_theta)
    return c_kv, k_rope


def mla_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor) -> torch.Tensor:
    """Training/prefill path: expand the latent and run causal attention
    (K5 with D = nope + rope, Dv = v_head_dim) on the rank's heads; the
    latent (w_dkv, kv_norm) is computed whole on every rank and enters the
    rank's heads through ``ctx.copy_to_model``."""
    B, S, _ = x.shape
    hq = p["wo"].shape[0] // cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, ctx.copy_to_model(x), cfg, positions, hq)
    c_kv, k_rope = _latent(p, x, cfg, positions)
    c_kv, k_rope = ctx.copy_to_model(c_kv), ctx.copy_to_model(k_rope)
    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, hq, cfg.qk_nope_dim)
    v = (c_kv @ p["w_uv"]).reshape(B, S, hq, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(B, S, hq, cfg.qk_rope_dim)], -1)
    o = ops.flash_attention(q, k, v, causal=True)
    return _out(p, o)


def mla_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               cache_ckv: torch.Tensor, pos: torch.Tensor):
    """Absorbed decode: the cache holds only (c_kv || k_rope) per token
    (r + rope = 576 columns for v2), MLA's compressed KV. Attention
    becomes MQA with one latent KV head:
      score_h = (q_nope_h @ W_uk_h) . c_kv + q_rope_h . k_rope
      out_h   = (sum_t p_t c_kv_t) @ W_uv_h
    so K6 runs with D = r + rope and v = the cache's first r columns, a
    view that the kernel reads inside k's tiles. x: (B, 1, d); cache_ckv:
    (B, S_max, r + rope), written IN PLACE at ``pos`` (no ring buffer, as
    in JAX). Returns (y (B, 1, d), cache_ckv)."""
    r = cfg.kv_lora_rank
    hq = p["wo"].shape[0] // cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, pos[:, None], hq)
    c_kv, k_rope = _latent(p, x, cfg, pos[:, None])
    entry = torch.cat([c_kv, k_rope[:, :, 0]], -1)            # (B, 1, r+rope)
    cache_write(cache_ckv, pos, entry[:, 0])
    # absorb W_uk into q: (B, hq, nope) x (r, hq, nope) -> (B, hq, r)
    w_uk = p["w_uk"].reshape(r, hq, cfg.qk_nope_dim)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)
    q_full = torch.cat([q_lat, q_rope[:, 0]], -1)             # (B, hq, r+rope)
    kv = cache_ckv[:, :, None, :]                             # (B, S, 1, r+rope)
    lat = ops.decode_attention(_all_heads(q_full, False), kv, kv[..., :r],
                               pos + 1)                       # (B, Hq, r)
    w_uv = p["w_uv"].reshape(r, hq, cfg.v_head_dim)
    o = torch.einsum("bhr,rhd->bhd", _own_heads(lat, hq), w_uv)
    return _out(p, o[:, None]), cache_ckv

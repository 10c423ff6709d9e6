"""Attention blocks: GQA (qk-norm / bias / softcap / sliding window).

Port of the GQA part of ``repro.models.attention``; MLA and
cross-attention are not ported yet (ROADMAP.md, queue 1 item 8).
Parameter names follow the JAX package: wq/wk/wv/wo (+bq/bk/bv),
q_norm/k_norm. Head counts are padded to a multiple of ``tp`` as there, so
converted weights keep their shapes; the port runs on one device (tp 1).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, dtype_of, rms_norm

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


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence self attention (prefill)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = ops.flash_attention(q, k, v, causal=causal, window=window,
                            softcap=cfg.attn_softcap)
    return o.reshape(B, S, -1) @ p["wo"]


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
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, pos[:, None])
    bidx = torch.arange(B, device=x.device)
    cache_len = cache_k.shape[1]
    slot = pos % cache_len                      # ring write (no-op when full)
    cache_k[bidx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot] = v[:, 0].to(cache_v.dtype)
    kv_len = torch.clamp(pos + 1, max=cache_len)
    o = ops.decode_attention(q[:, 0], cache_k, cache_v, kv_len,
                             softcap=cfg.attn_softcap)
    y = o.reshape(B, 1, -1) @ p["wo"]
    return y, cache_k, cache_v

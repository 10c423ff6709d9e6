"""Stage-based model assembly: init / forward / decode / loss.

Port of ``repro.models.transformer`` for the block kinds the serving and
training slices cover: attn, attn_local, shared_attn and mamba (zamba2,
mamba2, qwen3, qwen2, yi, gemma2). A model is a tuple of stages; each
stage runs a repeating unit of blocks ``repeats`` times, with parameters
stacked on the leading (repeats) axis as in the JAX package, so converted
weights keep their layout. JAX scans over that axis; here a Python loop
indexes it. Weight-tied blocks ('shared_attn', zamba2) keep their
parameters at ``params['shared']``; each use still has its own KV cache.
With ``remat`` each repeat of the unit is one activation checkpoint, as
JAX's ``jax.checkpoint`` of the scan body.

Block kinds moe, mla_dense, mla_moe, cross and decoder, and the encoder,
are not ported yet and raise NotImplementedError (ROADMAP.md, queue 1
item 8).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.config import ModelConfig, Stage
from repro_torch.models.layers import (dense_init, dtype_of, embed_init,
                                       mlp_apply, mlp_init, rms_norm, softcap)

PORTED_KINDS = ("attn", "attn_local", "shared_attn", "mamba")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, queue 1 "
        f"item 8); ported block kinds: {', '.join(PORTED_KINDS)}")


def padded_vocab(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + 127) // 128) * 128


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ------------------------------------------------------------------- blocks
def block_init(gen: torch.Generator, kind: str, cfg: ModelConfig, tp: int):
    dt = dtype_of(cfg.dtype)
    fill = torch.zeros if cfg.use_post_norm else torch.ones
    nw = lambda: fill(cfg.d_model, dtype=dt, device=gen.device)
    if kind in ("attn", "attn_local"):
        p = {"ln1": nw(), "attn": attn.gqa_init(gen, cfg, tp),
             "ln2": nw(), "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff,
                                          cfg.mlp_act, dt)}
        if cfg.use_post_norm:
            p["post_ln1"] = nw()
            p["post_ln2"] = nw()
        return p
    if kind == "mamba":
        return {"ln1": nw(), "mamba": mamba2.mamba_init(gen, cfg)}
    if kind == "shared_attn":
        return {}                      # weights live at params['shared']
    raise _not_ported(f"block kind {kind!r}")


def _pre(x, w, cfg):
    return rms_norm(x, w, cfg.norm_eps, plus_one=cfg.use_post_norm)


def _attn_block(p, x, a, cfg):
    """Residual, MLP and the optional gemma2 post-norms around an attention
    output ``a``."""
    post = cfg.use_post_norm
    if post and "post_ln1" in p:
        a = _pre(a, p["post_ln1"], cfg)
    x = x + a
    m = mlp_apply(p["mlp"], _pre(x, p["ln2"], cfg), cfg.mlp_act)
    if post and "post_ln2" in p:
        m = _pre(m, p["post_ln2"], cfg)
    return x + m


def block_apply(p, kind: str, x, cfg: ModelConfig, *, positions,
                shared=None, causal=True):
    if kind == "shared_attn":
        p, kind = shared, "attn"
    if kind in ("attn", "attn_local"):
        window = cfg.sliding_window if kind == "attn_local" else None
        a = attn.gqa_apply(p["attn"], _pre(x, p["ln1"], cfg), cfg,
                           positions=positions, causal=causal, window=window)
        return _attn_block(p, x, a, cfg)
    if kind == "mamba":
        return x + mamba2.mamba_apply(p["mamba"], _pre(x, p["ln1"], cfg), cfg)
    raise _not_ported(f"block kind {kind!r}")


# ------------------------------------------------------------------- stages
def stage_init(gen: torch.Generator, stage: Stage, cfg: ModelConfig,
               tp: int):
    unit_params = []
    for kind in stage.unit:
        if kind == "shared_attn":
            unit_params.append({})
            continue
        unit_params.append(_stack([block_init(gen, kind, cfg, tp)
                                   for _ in range(stage.repeats)]))
    return tuple(unit_params)


def _stack(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([l[k] for l in layers]) for k in first}
    return torch.stack(layers)


def layer_params(sp, r: int):
    """Repeat ``r``'s parameters of a stacked unit entry (views)."""
    return tree_map(lambda t: t[r], sp)


def _unit_apply(x, sp, r: int, stage: Stage, cfg: ModelConfig, positions,
                shared, causal):
    """Repeat ``r`` of the stage's unit of blocks."""
    for j, kind in enumerate(stage.unit):
        x = block_apply(layer_params(sp[j], r), kind, x, cfg,
                        positions=positions, shared=shared, causal=causal)
    return x


def stage_apply(sp, stage: Stage, x, cfg: ModelConfig, *, positions,
                shared=None, causal=True, remat=False):
    """The unit ``stage.repeats`` times. With ``remat`` each repeat is one
    checkpoint: the backward keeps only the residual entering each repeat
    and recomputes the rest (so a kernel of the unit runs twice per
    training step)."""
    for r in range(stage.repeats):
        args = (x, sp, r, stage, cfg, positions, shared, causal)
        x = (checkpoint(_unit_apply, *args, use_reentrant=False) if remat
             else _unit_apply(*args))
    return x


# -------------------------------------------------------------- model init
def _check_ported(cfg: ModelConfig) -> None:
    if cfg.encoder_stages is not None:
        raise _not_ported("the encoder (encoder_stages)")
    for s in cfg.stages:
        for kind in s.unit:
            if kind not in PORTED_KINDS:
                raise _not_ported(f"block kind {kind!r}")


def init_params(gen: torch.Generator, cfg: ModelConfig, tp: int = 1, *,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Random weights from ``gen``, which must live on ``device``."""
    dev = resolve(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, weights asked on {dev}")
    _check_ported(cfg)
    dt = dtype_of(cfg.dtype)
    V = padded_vocab(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, V, cfg.d_model, dt),
        "final_norm": torch.ones(cfg.d_model, dtype=dt, device=gen.device),
        "stages": tuple(stage_init(gen, s, cfg, tp) for s in cfg.stages),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, V, dt)
    if any("shared_attn" in s.unit for s in cfg.stages):
        params["shared"] = block_init(gen, "attn", cfg, tp)
    return params


# ----------------------------------------------------------------- forward
def _embed(params, tokens, cfg: ModelConfig):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _head(params, x, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap((x @ head).float(), cfg.final_softcap)


def forward(params, tokens, cfg: ModelConfig, *, context=None,
            positions=None, remat=False) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, padded_vocab) float32, on the
    device of the parameters. ``remat`` checkpoints each repeat of each
    stage's unit (see :func:`stage_apply`)."""
    if context is not None:
        raise _not_ported("cross-attention context")
    _check_ported(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    x = _embed(params, tokens, cfg)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=dev).expand(
            tokens.shape)
    for sp, s in zip(params["stages"], cfg.stages):
        x = stage_apply(sp, s, x, cfg, positions=positions,
                        shared=params.get("shared"), remat=remat)
    return _head(params, x, cfg)


def loss_fn(params, batch, cfg: ModelConfig, *, remat=False) -> torch.Tensor:
    """Mean next-token NLL over the positions with ``labels >= 0``, from
    float32 logits. batch: {'tokens': (B, S), 'labels': (B, S)}; a
    'context' raises as :func:`forward` does."""
    logits = forward(params, batch["tokens"], cfg,
                     context=batch.get("context"), remat=remat)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    logp = F.log_softmax(logits, dim=-1)
    mask = (labels >= 0).float()
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


# ------------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               tp: int = 1, *, device: DeviceLike = "cuda") -> Tuple:
    """Cache tree mirroring stage structure. Per unit element:
      attn-like -> (k, v): (repeats, B, S, hkv, hd); attn_local rings hold
                   min(max_seq, sliding_window) slots
      mamba     -> (conv_x, conv_bc, ssm_state) stacked on repeats
    """
    _check_ported(cfg)
    dev = resolve(device)
    dt = dtype or dtype_of(cfg.dtype)
    has_attn = any(k != "mamba" for st in cfg.stages for k in st.unit)
    hkv = attn.head_counts(cfg, tp)[1] if has_attn else 0
    caches = []
    for s in cfg.stages:
        unit_caches = []
        for kind in s.unit:
            if kind in ("attn", "attn_local", "shared_attn"):
                length = max_seq
                if kind == "attn_local" and cfg.sliding_window:
                    length = min(max_seq, cfg.sliding_window)  # ring buffer
                shape = (s.repeats, batch, length, hkv, cfg.head_dim)
                unit_caches.append((torch.zeros(shape, dtype=dt, device=dev),
                                    torch.zeros(shape, dtype=dt, device=dev)))
            else:  # mamba
                unit_caches.append(mamba2.mamba_cache_init(
                    cfg, batch, dt, dev, lead=(s.repeats,)))
        caches.append(tuple(unit_caches))
    return tuple(caches)


def _block_decode(p, kind, x, cache, cfg, *, pos, shared):
    """One block for one token; ``cache`` (this repeat's views) is updated
    in place."""
    if kind == "shared_attn":
        p, kind = shared, "attn"
    if kind in ("attn", "attn_local"):
        window = cfg.sliding_window if kind == "attn_local" else None
        ck, cv = cache
        a, _, _ = attn.gqa_decode(p["attn"], _pre(x, p["ln1"], cfg), cfg,
                                  cache_k=ck, cache_v=cv, pos=pos,
                                  window=window)
        return _attn_block(p, x, a, cfg)
    if kind == "mamba":
        cx, cbc, ssm = cache
        y, _, _, _ = mamba2.mamba_decode(p["mamba"], _pre(x, p["ln1"], cfg),
                                         cfg, conv_x=cx, conv_bc=cbc,
                                         ssm_state=ssm)
        return x + y
    raise _not_ported(f"block kind {kind!r}")


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, *,
                context=None):
    """One token for every sequence. tokens: (B,1) int; pos: (B,) lengths.
    Returns (logits (B,1,V) float32, cache). The cache is updated IN PLACE
    and returned (JAX's version returns a new cache)."""
    if context is not None:
        raise _not_ported("cross-attention context")
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.as_tensor(pos, device=dev).long()
    x = _embed(params, tokens, cfg)
    for sp, s, sc in zip(params["stages"], cfg.stages, cache):
        for r in range(s.repeats):
            for j, kind in enumerate(s.unit):
                x = _block_decode(layer_params(sp[j], r), kind, x,
                                  tuple(c[r] for c in sc[j]), cfg, pos=pos,
                                  shared=params.get("shared"))
    return _head(params, x, cfg), cache


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))

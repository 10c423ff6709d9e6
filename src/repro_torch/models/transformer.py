"""Stage-based model assembly: init / forward / decode / loss.

Port of ``repro.models.transformer`` for every block kind of the zoo:
attn, attn_local, shared_attn, moe, mla_dense, mla_moe, cross, decoder and
mamba, and the non-causal encoder (whisper). A model is a tuple of
stages; each stage runs a repeating unit of blocks ``repeats`` times, with
parameters stacked on the leading (repeats) axis as in the JAX package, so
converted weights keep their layout. JAX scans over that axis; here a
Python loop indexes it. Weight-tied blocks ('shared_attn', zamba2) keep
their parameters at ``params['shared']``; each use still has its own KV
cache. With ``remat`` each repeat of the unit is one activation
checkpoint, as JAX's ``jax.checkpoint`` of the scan body.

``context`` feeds the cross-attention of 'cross' and 'decoder' blocks:
the encoder's output (whisper, :func:`encode`) or patch embeddings
(vision), recomputed into k and v at every step as in JAX. Trees of
parameters and caches are nested dicts, tuples and lists of tensors;
``None`` (a cross block's cache) passes through :func:`tree_map`,
:func:`tree_leaves` and :func:`param_count` as through a JAX pytree.

Under a mesh whose model axis is above 1 (:mod:`repro_torch.distributed.ctx`)
the parameters are this rank's shards (:func:`init_params` with ``mesh``,
or ``sharding.shard_tree`` of whole ones): the embedding is looked up
vocab-parallel, and ``lm_head`` (or ``embed.T`` when tied) gives this
rank's block of the vocabulary, gathered over the ranks before the
softcap, the loss and the argmax. Each block's collectives are in its
module.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import ctx, sharding
from repro_torch.launch.mesh import tp_size
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig, Stage
from repro_torch.models.layers import (dense_init, dtype_of, embed_init,
                                       embed_lookup, mlp_apply, mlp_init,
                                       rms_norm, softcap)

#: block kinds with a self-attention KV cache (k, v)
GQA_KINDS = ("attn", "attn_local", "moe", "decoder", "shared_attn")
MLA_KINDS = ("mla_dense", "mla_moe")
MOE_KINDS = ("moe", "mla_moe")


def padded_vocab(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + 127) // 128) * 128


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a tree of dicts, tuples and lists;
    ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree, in order; ``None`` holds none."""
    if tree is None:
        return []
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
    mlp = lambda: mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dt)
    if kind in ("attn", "attn_local"):
        p = {"ln1": nw(), "attn": attn.gqa_init(gen, cfg, tp),
             "ln2": nw(), "mlp": mlp()}
        if cfg.use_post_norm:
            p["post_ln1"] = nw()
            p["post_ln2"] = nw()
        return p
    if kind == "moe":
        return {"ln1": nw(), "attn": attn.gqa_init(gen, cfg, tp),
                "ln2": nw(), "moe": moe_mod.moe_init(gen, cfg)}
    if kind == "mla_dense":
        return {"ln1": nw(), "attn": attn.mla_init(gen, cfg, tp),
                "ln2": nw(), "mlp": mlp()}
    if kind == "mla_moe":
        return {"ln1": nw(), "attn": attn.mla_init(gen, cfg, tp),
                "ln2": nw(), "moe": moe_mod.moe_init(gen, cfg)}
    if kind == "cross":
        return {"ln1": nw(), "cross": attn.cross_init(gen, cfg, tp),
                "ln2": nw(), "mlp": mlp()}
    if kind == "decoder":
        return {"ln1": nw(), "attn": attn.gqa_init(gen, cfg, tp),
                "lnc": nw(), "cross": attn.cross_init(gen, cfg, tp),
                "ln2": nw(), "mlp": mlp()}
    if kind == "mamba":
        return {"ln1": nw(), "mamba": mamba2.mamba_init(gen, cfg)}
    if kind == "shared_attn":
        return {}                      # weights live at params['shared']
    raise ValueError(kind)


def _pre(x, w, cfg):
    return rms_norm(x, w, cfg.norm_eps, plus_one=cfg.use_post_norm)


def _attn_block(p, kind, x, a, cfg, context):
    """Residual, the decoder's cross-attention into ``context``, the MLP
    (the MoE for moe kinds) and the optional gemma2 post-norms around a
    self-attention output ``a``."""
    post = cfg.use_post_norm
    if post and "post_ln1" in p:
        a = _pre(a, p["post_ln1"], cfg)
    x = x + a
    if kind == "decoder":
        x = x + attn.cross_apply(p["cross"], _pre(x, p["lnc"], cfg),
                                 context, cfg)
    h = _pre(x, p["ln2"], cfg)
    m = (moe_mod.moe_apply(p["moe"], h, cfg) if kind in MOE_KINDS
         else mlp_apply(p["mlp"], h, cfg.mlp_act))
    if post and "post_ln2" in p:
        m = _pre(m, p["post_ln2"], cfg)
    return x + m


def block_apply(p, kind: str, x, cfg: ModelConfig, *, positions,
                context=None, shared=None, causal=True):
    if kind == "shared_attn":
        p, kind = shared, "attn"
    if kind in MLA_KINDS:
        a = attn.mla_apply(p["attn"], _pre(x, p["ln1"], cfg), cfg,
                           positions=positions)
        return _attn_block(p, kind, x, a, cfg, context)
    if kind in ("attn", "attn_local", "moe", "decoder"):
        window = cfg.sliding_window if kind == "attn_local" else None
        a = attn.gqa_apply(p["attn"], _pre(x, p["ln1"], cfg), cfg,
                           positions=positions,
                           causal=causal or kind == "decoder", window=window)
        return _attn_block(p, kind, x, a, cfg, context)
    if kind == "cross":
        x = x + attn.cross_apply(p["cross"], _pre(x, p["ln1"], cfg),
                                 context, cfg)
        return x + mlp_apply(p["mlp"], _pre(x, p["ln2"], cfg), cfg.mlp_act)
    if kind == "mamba":
        return x + mamba2.mamba_apply(p["mamba"], _pre(x, p["ln1"], cfg), cfg)
    raise ValueError(kind)


def _whole(tree):
    return tree


# ------------------------------------------------------------------- stages
def stage_init(gen: torch.Generator, stage: Stage, cfg: ModelConfig,
               tp: int, keep=_whole):
    """Each unit entry's blocks drawn repeat by repeat, passed through
    ``keep`` (this rank's shards under tensor parallelism) and copied into
    tensors stacked on the repeats axis, allocated at the first repeat:
    the stage never exists twice (eight of llama4-scout's MoE blocks hold
    35 GB in bfloat16)."""
    unit_params = []
    for kind in stage.unit:
        if kind == "shared_attn":
            unit_params.append({})
            continue
        stacked = None
        for r in range(stage.repeats):
            layer = keep(block_init(gen, kind, cfg, tp))
            if stacked is None:
                stacked = tree_map(lambda t: t.new_empty(
                    (stage.repeats,) + tuple(t.shape)), layer)
            for dst, src in zip(tree_leaves(stacked), tree_leaves(layer)):
                dst[r].copy_(src)
            del layer
        unit_params.append(stacked)
    return tuple(unit_params)


def layer_params(sp, r: int):
    """Repeat ``r``'s parameters of a stacked unit entry (views)."""
    return tree_map(lambda t: t[r], sp)


def _unit_apply(x, sp, r: int, stage: Stage, cfg: ModelConfig, positions,
                context, shared, causal):
    """Repeat ``r`` of the stage's unit of blocks."""
    for j, kind in enumerate(stage.unit):
        x = block_apply(layer_params(sp[j], r), kind, x, cfg,
                        positions=positions, context=context, shared=shared,
                        causal=causal)
    return x


def stage_apply(sp, stage: Stage, x, cfg: ModelConfig, *, positions,
                context=None, shared=None, causal=True, remat=False):
    """The unit ``stage.repeats`` times. With ``remat`` each repeat is one
    checkpoint: the backward keeps only the residual entering each repeat
    and recomputes the rest (so a kernel of the unit runs twice per
    training step)."""
    for r in range(stage.repeats):
        args = (x, sp, r, stage, cfg, positions, context, shared, causal)
        x = (checkpoint(_unit_apply, *args, use_reentrant=False) if remat
             else _unit_apply(*args))
    return x


# -------------------------------------------------------------- model init
def init_params(gen: torch.Generator, cfg: ModelConfig, tp: int = 1,
                mesh=None, *, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Random weights from ``gen``, which must live on ``device``; with
    ``device="meta"`` and a :class:`~repro_torch.models.layers.MetaGenerator`,
    their shapes and dtypes without storage. With a ``mesh`` whose model
    axis is ``tp`` they are this rank's shards by ``sharding.param_specs``:
    every rank draws the same numbers in the same order, and each block
    (and each leaf outside the blocks) is cut to this rank's shards as soon
    as it is drawn, so a rank holds at most one whole block beside its
    shards."""
    keep = _whole
    if mesh is not None:
        if tp_size(mesh) != tp:
            raise ValueError(f"tp {tp} is not the mesh's model axis, "
                             f"{tp_size(mesh)}")
        keep = lambda tree: tree_map(lambda t: t.clone(), sharding.shard_tree(
            tree, sharding.param_specs(tree, cfg, tp), mesh))
    dev = torch.device("meta") if str(device) == "meta" else resolve(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, weights asked on {dev}")
    dt = dtype_of(cfg.dtype)
    V = padded_vocab(cfg)
    params: Dict[str, Any] = keep({
        "embed": embed_init(gen, V, cfg.d_model, dt),
        "final_norm": torch.ones(cfg.d_model, dtype=dt, device=gen.device)})
    params["stages"] = tuple(stage_init(gen, s, cfg, tp, keep)
                             for s in cfg.stages)
    if not cfg.tie_embeddings:
        params.update(keep({"lm_head": dense_init(gen, cfg.d_model, V, dt)}))
    if any("shared_attn" in s.unit for s in cfg.stages):
        params["shared"] = keep(block_init(gen, "attn", cfg, tp))
    if cfg.encoder_stages is not None:
        params["encoder"] = {
            "stages": tuple(stage_init(gen, s, cfg, tp, keep)
                            for s in cfg.encoder_stages),
            "final_norm": torch.ones(cfg.d_model, dtype=dt,
                                     device=gen.device),
        }
    return params


# ----------------------------------------------------------------- forward
def _check_shards(params, cfg: ModelConfig) -> None:
    """Under a model axis above 1 the parameters must be this rank's
    shards: the vocabulary split over the ranks."""
    tp = ctx.model_axis_size()
    if params["embed"].shape[0] * tp != padded_vocab(cfg):
        raise ValueError(
            f"embed holds {params['embed'].shape[0]} of {padded_vocab(cfg)} "
            f"rows under a model axis of {tp}: give this rank's shards "
            f"(init_params(..., mesh=), convert.model_params_from_arrays"
            f"(..., mesh=) or sharding.shard_tree)")


def _embed(params, tokens, cfg: ModelConfig):
    _check_shards(params, cfg)
    x = embed_lookup(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _head(params, x, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (ctx.copy_to_model(x) @ head).float()
    return softcap(ctx.gather_from_model(logits, -1), cfg.final_softcap)


def _on(params, t):
    """``t`` (a tensor or an array; None stays None) on the parameters'
    device."""
    return None if t is None else torch.as_tensor(
        t, device=params["embed"].device)


def encode(params, frames, cfg: ModelConfig, *, remat=False) -> torch.Tensor:
    """Encoder over precomputed frame/patch embeddings (B, S, d) (the
    modality frontend is a stub, as in JAX): non-causal self-attention
    blocks at positions ``arange(S)``, then the encoder's final norm."""
    x = _on(params, frames).to(dtype_of(cfg.dtype))
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    for sp, s in zip(params["encoder"]["stages"], cfg.encoder_stages):
        x = stage_apply(sp, s, x, cfg, positions=pos, causal=False,
                        remat=remat)
    return rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def forward(params, tokens, cfg: ModelConfig, *, context=None,
            positions=None, remat=False) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, padded_vocab) float32, on the
    device of the parameters. ``context`` (B, Sc, d) feeds the 'cross' and
    'decoder' blocks: the encoder's output (whisper) or patch embeddings
    (vision). ``remat`` checkpoints each repeat of each stage's unit (see
    :func:`stage_apply`)."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    context = _on(params, context)
    x = _embed(params, tokens, cfg)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=dev).expand(
            tokens.shape)
    for sp, s in zip(params["stages"], cfg.stages):
        x = stage_apply(sp, s, x, cfg, positions=positions, context=context,
                        shared=params.get("shared"), remat=remat)
    return _head(params, x, cfg)


def loss_fn(params, batch, cfg: ModelConfig, *, aux_weight=0.01,
            remat=False) -> torch.Tensor:
    """Mean next-token NLL over the positions with ``labels >= 0``, from
    float32 logits. batch: {'tokens': (B, S), 'labels': (B, S),
    'context'?: (B, Sc, d)}. ``aux_weight`` is taken and not used, as in
    the JAX package: MoE's load-balancing loss
    (:func:`repro_torch.models.moe.moe_aux_loss`) is not added."""
    logits = forward(params, batch["tokens"], cfg,
                     context=batch.get("context"), remat=remat)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    logp = F.log_softmax(logits, dim=-1)
    mask = (labels >= 0).float()
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


# ------------------------------------------------------------------- decode
@dataclasses.dataclass
class CacheSpec:
    max_seq: int
    batch: int
    dtype: Any


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               tp: int = 1, *, device: DeviceLike = "cuda") -> Tuple:
    """Cache tree mirroring stage structure. Per unit element:
      attn-like -> (k, v): (repeats, B, S, hkv, hd); attn_local rings hold
                   min(max_seq, sliding_window) slots
      mla       -> ckv:    (repeats, B, S, r + rope)
      mamba     -> (conv_x, conv_bc, ssm_state) stacked on repeats
      decoder   -> (k, v) self-cache (cross k/v recomputed from context)
      cross     -> None
    ``device="meta"`` gives shapes and dtypes without storage
    (:func:`repro_torch.launch.shapes.input_specs`).
    """
    dev = torch.device("meta") if str(device) == "meta" else resolve(device)
    dt = dtype or dtype_of(cfg.dtype)
    has_attn = any(k != "mamba" for st in cfg.stages for k in st.unit)
    hkv = attn.head_counts(cfg, tp)[1] if has_attn else 0
    zeros = lambda shape: torch.zeros(shape, dtype=dt, device=dev)
    caches = []
    for s in cfg.stages:
        unit_caches = []
        for kind in s.unit:
            if kind in GQA_KINDS:
                length = max_seq
                if kind == "attn_local" and cfg.sliding_window:
                    length = min(max_seq, cfg.sliding_window)  # ring buffer
                shape = (s.repeats, batch, length, hkv, cfg.head_dim)
                unit_caches.append((zeros(shape), zeros(shape)))
            elif kind in MLA_KINDS:
                unit_caches.append(zeros((s.repeats, batch, max_seq,
                                          cfg.kv_lora_rank + cfg.qk_rope_dim)))
            elif kind == "mamba":
                unit_caches.append(mamba2.mamba_cache_init(
                    cfg, batch, dt, dev, lead=(s.repeats,)))
            else:  # cross
                unit_caches.append(None)
        caches.append(tuple(unit_caches))
    return tuple(caches)


def _block_decode(p, kind, x, cache, cfg, *, pos, context, shared):
    """One block for one token; ``cache`` (this repeat's views, None for a
    cross block) is updated in place."""
    if kind == "shared_attn":
        p, kind = shared, "attn"
    if kind in ("attn", "attn_local", "moe", "decoder"):
        window = cfg.sliding_window if kind == "attn_local" else None
        ck, cv = cache
        a, _, _ = attn.gqa_decode(p["attn"], _pre(x, p["ln1"], cfg), cfg,
                                  cache_k=ck, cache_v=cv, pos=pos,
                                  window=window)
        return _attn_block(p, kind, x, a, cfg, context)
    if kind in MLA_KINDS:
        a, _ = attn.mla_decode(p["attn"], _pre(x, p["ln1"], cfg), cfg,
                               cache_ckv=cache, pos=pos)
        return _attn_block(p, kind, x, a, cfg, context)
    if kind == "cross":
        x = x + attn.cross_apply(p["cross"], _pre(x, p["ln1"], cfg),
                                 context, cfg)
        return x + mlp_apply(p["mlp"], _pre(x, p["ln2"], cfg), cfg.mlp_act)
    if kind == "mamba":
        cx, cbc, ssm = cache
        y, _, _, _ = mamba2.mamba_decode(p["mamba"], _pre(x, p["ln1"], cfg),
                                         cfg, conv_x=cx, conv_bc=cbc,
                                         ssm_state=ssm)
        return x + y
    raise ValueError(kind)


def decode_step(params, cache, tokens, pos, cfg: ModelConfig, *,
                context=None):
    """One token for every sequence. tokens: (B,1) int; pos: (B,) lengths;
    ``context`` as for :func:`forward` (whisper's: the encoded frames).
    Returns (logits (B,1,V) float32, cache). The cache is updated IN PLACE
    and returned (JAX's version returns a new cache)."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.as_tensor(pos, device=dev).long()
    context = _on(params, context)
    x = _embed(params, tokens, cfg)
    for sp, s, sc in zip(params["stages"], cfg.stages, cache):
        for r in range(s.repeats):
            for j, kind in enumerate(s.unit):
                x = _block_decode(layer_params(sp[j], r), kind, x,
                                  tree_map(lambda c: c[r], sc[j]), cfg,
                                  pos=pos, context=context,
                                  shared=params.get("shared"))
    return _head(params, x, cfg), cache


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))

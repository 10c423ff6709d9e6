"""Serving: prefill and batched decode, on one device or over a mesh, with
the sequence-sharded decode attention.

Port of ``repro.serving.decode``. ``make_prefill_step`` runs
:func:`~repro_torch.models.transformer.forward` (flash attention and the
SSD scan on the card), after :func:`~repro_torch.models.transformer.encode`
of the frames for an encoder-decoder model, and returns logits only;
``make_decode_step`` runs one
:func:`~repro_torch.models.transformer.decode_step` (decode attention),
updating the cache in place.

With a ``mesh`` (``launch.mesh.make_test_mesh``) each step activates it
(:mod:`repro_torch.distributed.ctx`) and lays the work out as
``distributed.sharding`` says:

* the weights are this rank's shards by ``param_specs`` (tensor parallel
  over 'model': ``transformer.init_params(..., mesh=)`` or
  ``convert.model_params_from_arrays(..., mesh=)``), the layers joining
  their products with the collectives of ``distributed.ctx``;

* the batch over the data axes when it divides them, else replicated:
  a step takes the global tokens and positions, runs on this rank's rows
  and all-gathers the logits over the data axes, so every rank returns the
  global (B, 1, V);
* the decode cache by ``cache_specs`` (:func:`init_cache`,
  :func:`shard_cache`): the self-attention and MLA caches' sequence over
  'model' (each rank holds S / tp slots of every KV head), Mamba's conv_x
  by channels and its SSM state by heads when they divide (conv_bc
  whole). A step gathers the new k/v over heads and writes them only on
  the rank that holds the slot (``models.attention.cache_write``), gathers
  the query heads, and the attention is :func:`sharded_decode_attention`
  (flash-decoding across ranks):

    1. every model rank computes the unnormalised (acc, m, l) of its slice
       (K6 in its partials mode on the card);
    2. the ranks merge them with a log-sum-exp all-reduce:
       m* = max m;  l* = sum l e^(m - m*);  o = sum acc e^(m - m*) / l*.

  The cache bandwidth, the decode bottleneck, is split tp ways; q and o
  cross ranks (B x Hq x hd per layer), and each rank keeps its own heads
  of o for its rows of wo.

A rank's bytes are then the reference's per device: ``sharding.local_bytes``
of its weights and cache equals ``sharding.reckoned_bytes`` of the specs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import ctx, sharding
from repro_torch.kernels import ops
from repro_torch.launch.mesh import tp_size
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig


def sharded_decode_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, kv_len: torch.Tensor, *,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, D) on every model rank; k/v (B, S/tp, Hkv, D/Dv) this
    rank's slice of the sequence, global slots ``model_rank * S/tp`` on;
    kv_len (B,) global lengths. Returns (B, Hq, Dv) in q's dtype on every
    model rank."""
    s_loc = k.shape[1]
    start = ctx.model_rank() * s_loc
    kv_len = kv_len.to(torch.int32)
    local_len = torch.clamp(kv_len - start, 0, s_loc)
    acc, m, l = ops.decode_attention_partials(
        q, k, v, local_len, offset=start, global_len=kv_len, window=window,
        softcap=softcap)
    group = ctx.model_group()
    m_star = ctx.all_reduce(m.clone(), dist.ReduceOp.MAX, group)
    w = torch.exp(m - m_star)
    both = ctx.all_reduce(torch.cat([acc * w[..., None], (l * w)[..., None]],
                                    dim=-1), dist.ReduceOp.SUM, group)
    o = both[..., :-1] / torch.clamp_min(both[..., -1:], 1e-30)
    return o.to(q.dtype)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               tp: int = 1, *, mesh=None, device: DeviceLike = "cuda"):
    """``transformer.init_cache`` (``mesh`` None), or this rank's part of
    it on ``mesh`` by ``cache_specs``: its rows of the batch (when it
    divides the data axes), 1/tp of the self-attention and MLA slots,
    1/tp of Mamba's conv_x channels and, when the heads divide, of its SSM
    state's heads, tp the model axis (the heads are padded at that tp, as
    the weights are). A cache whose slots (``max_seq``, or a sliding
    window's ring) do not divide by tp is refused, as the JAX package's
    ``device_put`` refuses a sharding that does not divide."""
    if mesh is None:
        return tr.init_cache(cfg, batch, max_seq, dtype, tp, device=device)
    dev = torch.device("meta") if str(device) == "meta" else resolve(device)
    full = tr.init_cache(cfg, batch, max_seq, dtype, tp_size(mesh),
                         device="meta")
    return tr.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                             device=dev),
                       shard_cache(full, cfg, mesh))


def shard_cache(cache, cfg: ModelConfig, mesh):
    """This rank's part of a global cache (views) by ``cache_specs``:
    what :func:`init_cache` allocates on ``mesh``, taken from ``cache``."""
    B = tr.tree_leaves(cache)[0].shape[1]
    return sharding.shard_tree(cache, sharding.cache_specs(cfg, mesh, B),
                               mesh)


def _rows_of(x, rows: slice, dev: torch.device):
    return None if x is None else torch.as_tensor(x, device=dev)[rows]


def make_decode_step(cfg: ModelConfig, mesh=None):
    """Serve step: (params, cache, tokens (B,1), pos (B,), context?) ->
    (logits (B,1,V) float32, cache). With ``mesh``: the cache is this
    rank's (:func:`init_cache` on ``mesh``), the inputs and the logits are
    global (see the module docstring)."""

    @torch.no_grad()
    def step(params, cache, tokens, pos, context=None):
        if mesh is None:
            return tr.decode_step(params, cache, tokens, pos, cfg,
                                  context=context)
        dev = params["embed"].device
        B = len(tokens)
        with ctx.activate(mesh):
            rows, split = ctx.dp_rows(B), ctx.dp_sharded(B)
            with ctx.split_batch(split):
                logits, cache = tr.decode_step(
                    params, cache, _rows_of(tokens, rows, dev),
                    _rows_of(pos, rows, dev), cfg,
                    context=_rows_of(context, rows, dev))
            if split:
                logits = ctx.all_gather_rows(logits, ctx.dp_group())
        return logits, cache

    return step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """Prefill: (params, tokens (B,S), context?) -> logits (B,S,V)
    float32. With ``cfg.encoder_stages`` (whisper) ``context`` holds the
    frame embeddings, which are encoded first. With ``mesh`` each rank
    runs its rows of the batch and the logits are all-gathered over the
    data axes."""

    @torch.no_grad()
    def run(params, tokens, context=None):
        if cfg.encoder_stages is not None:
            context = tr.encode(params, context, cfg)
        return tr.forward(params, tokens, cfg, context=context)

    @torch.no_grad()
    def step(params, tokens, context=None):
        if mesh is None:
            return run(params, tokens, context)
        dev = params["embed"].device
        B = len(tokens)
        with ctx.activate(mesh):
            rows, split = ctx.dp_rows(B), ctx.dp_sharded(B)
            with ctx.split_batch(split):
                logits = run(params, _rows_of(tokens, rows, dev),
                             _rows_of(context, rows, dev))
            if split:
                logits = ctx.all_gather_rows(logits, ctx.dp_group())
        return logits

    return step

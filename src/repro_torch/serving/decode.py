"""Serving steps on one device: prefill and batched decode.

Port of ``repro.serving.decode`` without the mesh: ``make_prefill_step``
runs :func:`~repro_torch.models.transformer.forward` (flash attention and
the SSD scan on the card), after :func:`~repro_torch.models.transformer.encode`
of the frames for an encoder-decoder model, and returns logits only, and
``make_decode_step`` runs one
:func:`~repro_torch.models.transformer.decode_step` (decode attention),
updating the cache in place. The sequence-sharded
``sharded_decode_attention`` waits for the port of ``distributed/``.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig


def make_decode_step(cfg: ModelConfig):
    """Serve step: (params, cache, tokens (B,1), pos (B,), context?) ->
    (logits (B,1,V) float32, cache)."""

    @torch.no_grad()
    def step(params, cache, tokens, pos, context=None):
        return tr.decode_step(params, cache, tokens, pos, cfg,
                              context=context)

    return step


def make_prefill_step(cfg: ModelConfig):
    """Prefill: (params, tokens (B,S), context?) -> logits (B,S,V)
    float32. With ``cfg.encoder_stages`` (whisper) ``context`` holds the
    frame embeddings, which are encoded first."""

    @torch.no_grad()
    def step(params, tokens, context=None):
        if cfg.encoder_stages is not None:
            context = tr.encode(params, context, cfg)
        return tr.forward(params, tokens, cfg, context=context)

    return step

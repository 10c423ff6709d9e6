"""Model configuration schema for the architecture zoo (the port's copy of
``repro.models.config``).

A model is a sequence of **stages**; each stage is a repeating **unit** of
layer kinds (run ``repeats`` times, with parameters stacked on a leading
repeats axis as in the JAX package). Layer kinds:

  'attn'         self-attention (GQA; flags select qk_norm/bias/softcap/window)
  'attn_local'   self-attention with sliding window (gemma2 local layers)
  'attn_shared'  weight-tied shared attention block (zamba2)
  'cross'        cross-attention to an encoder/vision context
  'mlp'          dense SwiGLU/GeLU MLP
  'moe'          mixture-of-experts MLP
  'mamba'        Mamba2 SSD mixer

A 'transformer block' in a unit is expressed as ['attn', 'mlp'] etc.; fused
pre-norms are part of each layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Stage:
    unit: Tuple[str, ...]     # layer kinds executed per repeat
    repeats: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    stages: Tuple[Stage, ...]
    # attention options
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None      # gemma2: 50.0
    final_softcap: Optional[float] = None     # gemma2: 30.0
    sliding_window: Optional[int] = None      # used by 'attn_local'
    # MLA (deepseek) — if kv_lora_rank is set, attention layers use MLA
    kv_lora_rank: Optional[int] = None
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # MoE
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_block_tokens: int = 4096   # dispatch in token blocks (EXPERIMENTS §Perf it.2)
    # Mamba2
    ssm_state: int = 0
    mamba_headdim: int = 64
    mamba_expand: int = 2
    conv_width: int = 4
    # encoder-decoder (whisper): encoder stages; None = decoder-only
    encoder_stages: Optional[Tuple[Stage, ...]] = None
    encoder_context: int = 1500               # cross-attn source length
    # vlm: cross-attn context comes from input_specs (patch embeddings)
    cross_context: int = 0                    # >0 => model takes extra input
    # embedding / head
    tie_embeddings: bool = True
    mlp_act: str = "swiglu"                   # 'swiglu' | 'gelu'
    norm_eps: float = 1e-6
    use_post_norm: bool = False               # gemma2 sandwich norms
    embed_scale: bool = False                 # gemma2 sqrt(d_model) embed scale
    # numerics
    dtype: str = "bfloat16"
    # bookkeeping
    family: str = "dense"                     # dense|moe|ssm|hybrid|vlm|audio
    sub_quadratic: bool = False               # may run long_500k

    @property
    def n_layers(self) -> int:
        return sum(len(s.unit) * s.repeats for s in self.stages)

    @property
    def d_inner(self) -> int:                 # mamba2 inner width
        return self.mamba_expand * self.d_model

    @property
    def mamba_heads(self) -> int:
        return self.d_inner // self.mamba_headdim

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
    stages = tuple(Stage(s.unit, min(s.repeats, 2)) for s in cfg.stages)
    enc = None
    if cfg.encoder_stages is not None:
        enc = tuple(Stage(s.unit, min(s.repeats, 2)) for s in cfg.encoder_stages)
    return cfg.scaled(
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        stages=stages,
        encoder_stages=enc,
        encoder_context=32,
        cross_context=16 if cfg.cross_context else 0,
        n_experts=min(cfg.n_experts, 4),
        expert_d_ff=64 if cfg.expert_d_ff else 0,
        top_k=min(cfg.top_k, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        kv_lora_rank=64 if cfg.kv_lora_rank else None,
        qk_rope_dim=16 if cfg.kv_lora_rank else cfg.qk_rope_dim,
        qk_nope_dim=32 if cfg.kv_lora_rank else cfg.qk_nope_dim,
        v_head_dim=32 if cfg.kv_lora_rank else cfg.v_head_dim,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        mamba_headdim=16 if cfg.ssm_state else cfg.mamba_headdim,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else None,
        dtype="float32",
    )

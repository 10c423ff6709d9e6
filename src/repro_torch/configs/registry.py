"""Architecture registry: the 10 assigned configs (+ smoke reductions),
the port's copy of ``repro.configs.registry``.

Sources are the public configs cited in the assignment; every entry lists
the exact published hyper-parameters. Whisper/vision modality frontends are
stubs — input_specs() (launch/shapes.py) feeds precomputed frame/patch
embeddings to cross-attention / encoder stages.
"""

from __future__ import annotations

from typing import List

from repro_torch.models.config import ModelConfig, Stage, reduced_for_smoke


def gemma2_9b() -> ModelConfig:
    # arXiv:2408.00118 — local(4096)+global alternating, logit softcaps,
    # GeGLU, sandwich norms, sqrt(d) embedding scale.
    return ModelConfig(
        name="gemma2-9b", family="dense", vocab_size=256000, d_model=3584,
        n_heads=16, n_kv_heads=8, head_dim=256, d_ff=14336,
        stages=(Stage(("attn_local", "attn"), 21),),
        sliding_window=4096, attn_softcap=50.0, final_softcap=30.0,
        use_post_norm=True, embed_scale=True, mlp_act="geglu",
        rope_theta=10000.0, tie_embeddings=True)


def qwen3_4b() -> ModelConfig:
    # hf:Qwen/Qwen3-4B — GQA kv=8, per-head q/k RMS norm, SwiGLU.
    return ModelConfig(
        name="qwen3-4b", family="dense", vocab_size=151936, d_model=2560,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=9728,
        stages=(Stage(("attn",), 36),),
        qk_norm=True, rope_theta=1e6, tie_embeddings=True)


def qwen2_7b() -> ModelConfig:
    # arXiv:2407.10671 — GQA kv=4, QKV bias. 28 q-heads pad to 32 under TP.
    return ModelConfig(
        name="qwen2-7b", family="dense", vocab_size=152064, d_model=3584,
        n_heads=28, n_kv_heads=4, head_dim=128, d_ff=18944,
        stages=(Stage(("attn",), 28),),
        qkv_bias=True, rope_theta=1e6, tie_embeddings=False)


def yi_9b() -> ModelConfig:
    # arXiv:2403.04652 — llama-arch GQA kv=4.
    return ModelConfig(
        name="yi-9b", family="dense", vocab_size=64000, d_model=4096,
        n_heads=32, n_kv_heads=4, head_dim=128, d_ff=11008,
        stages=(Stage(("attn",), 48),),
        rope_theta=5e6, tie_embeddings=False)


def zamba2_2p7b() -> ModelConfig:
    # arXiv:2411.15242 — 54 Mamba2 layers with a weight-shared attention
    # block applied every 6 layers (single shared block here; the released
    # model alternates two shared blocks with per-use LoRA — DESIGN.md §8).
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", vocab_size=32000, d_model=2560,
        n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240,
        stages=(Stage(("mamba",) * 6 + ("shared_attn",), 9),),
        ssm_state=64, mamba_headdim=64, mamba_expand=2,
        rope_theta=10000.0, tie_embeddings=True, sub_quadratic=True)


def llama4_scout_17b() -> ModelConfig:
    # hf:meta-llama/Llama-4-Scout-17B-16E — MoE 16 routed top-1 + 1 shared
    # expert per layer; iRoPE NoPE layers approximated as RoPE (DESIGN.md §8).
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe", vocab_size=202048,
        d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
        stages=(Stage(("moe",), 48),),
        n_experts=16, top_k=1, n_shared_experts=1, expert_d_ff=8192,
        moe_block_tokens=16384,   # §Perf it.4: fewer blocks -> fewer expert-
        rope_theta=500000.0,      # weight re-reads (16 experts are few+fat)
        tie_embeddings=False)


def deepseek_v2_lite() -> ModelConfig:
    # arXiv:2405.04434 — MLA kv_lora=512 (+64 rope), 27 layers: 1 dense MLP
    # then 26 MoE layers of 64 routed (top-6) + 2 shared experts, d_ff=1408.
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", vocab_size=102400,
        d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128, d_ff=10944,
        stages=(Stage(("mla_dense",), 1), Stage(("mla_moe",), 26)),
        kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
        n_experts=64, top_k=6, n_shared_experts=2, expert_d_ff=1408,
        rope_theta=10000.0, tie_embeddings=False)


def llama32_vision_90b() -> ModelConfig:
    # hf:meta-llama/Llama-3.2-90B-Vision — backbone only: 100 layers as
    # 20 x (4 self-attn + 1 cross-attn to patch embeddings). Vision tower
    # is a stub (input_specs supplies (B, 4100, d) patch embeddings).
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm", vocab_size=128256,
        d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128, d_ff=28672,
        stages=(Stage(("attn", "attn", "attn", "attn", "cross"), 20),),
        cross_context=4100, rope_theta=500000.0, tie_embeddings=False)


def whisper_small() -> ModelConfig:
    # arXiv:2212.04356 — enc-dec, 12+12 layers, MHA, GeLU. Conv frontend is
    # a stub: encoder consumes precomputed 1500-frame embeddings. RoPE is
    # used in place of learned/sinusoidal positions (DESIGN.md §8). Vocab
    # 51865 pads to 51968 (x128) for TP.
    return ModelConfig(
        name="whisper-small", family="audio", vocab_size=51865, d_model=768,
        n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072,
        stages=(Stage(("decoder",), 12),),
        encoder_stages=(Stage(("attn",), 12),), encoder_context=1500,
        mlp_act="gelu", tie_embeddings=True)


def mamba2_780m() -> ModelConfig:
    # arXiv:2405.21060 — pure SSD, 48 layers, d_state=128, headdim=64.
    return ModelConfig(
        name="mamba2-780m", family="ssm", vocab_size=50280, d_model=1536,
        n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0,
        stages=(Stage(("mamba",), 48),),
        ssm_state=128, mamba_headdim=64, mamba_expand=2,
        tie_embeddings=True, sub_quadratic=True)


_FACTORIES = {
    "gemma2-9b": gemma2_9b,
    "qwen3-4b": qwen3_4b,
    "qwen2-7b": qwen2_7b,
    "yi-9b": yi_9b,
    "zamba2-2.7b": zamba2_2p7b,
    "llama4-scout-17b-a16e": llama4_scout_17b,
    "deepseek-v2-lite-16b": deepseek_v2_lite,
    "llama-3.2-vision-90b": llama32_vision_90b,
    "whisper-small": whisper_small,
    "mamba2-780m": mamba2_780m,
}


def arch_names() -> List[str]:
    return list(_FACTORIES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    cfg = _FACTORIES[name]()
    return reduced_for_smoke(cfg) if smoke else cfg

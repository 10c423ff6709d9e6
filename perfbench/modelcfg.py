"""A configuration file: the source's own settings at the top level,
under its own keys, ``port``, the program's ``ModelConfig`` as it is run,
and ``runs``, the value run of each published setting that the run
changes (each listed in the configuration's ``reduced``).
:func:`port_of` checks that every published number the port also states
is the one run, and that every published setting whose meaning the
program fixes is either the program's or changed openly in ``runs``, so
the top level cannot drift from what runs.

Plain data and no program import: the reference reads ``port`` too.
"""

from __future__ import annotations

from typing import Dict

#: published key -> ``port`` key, where the two state the same number
SAME = {
    "hidden_size": "d_model",
    "d_model": "d_model",
    "vocab_size": "vocab_size",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff",
    "ffn_hidden_size": "d_ff",
    "kv_lora_rank": "kv_lora_rank",
    "qk_rope_head_dim": "qk_rope_dim",
    "qk_nope_head_dim": "qk_nope_dim",
    "v_head_dim": "v_head_dim",
    "n_routed_experts": "n_experts",
    "num_experts_per_tok": "top_k",
    "n_shared_experts": "n_shared_experts",
    "moe_intermediate_size": "expert_d_ff",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "tie_embeddings": "tie_embeddings",
    "mamba_d_state": "ssm_state",
    "mamba_headdim": "mamba_headdim",
    "mamba_expand": "mamba_expand",
    "mamba_d_conv": "conv_width",
    "d_state": "ssm_state",
    "headdim": "mamba_headdim",
    "expand": "mamba_expand",
    "d_conv": "conv_width",
    "norm_epsilon": "norm_eps",
}

#: published settings whose meaning the program fixes, at the program's
#: value: the gates a softmax over the chosen experts' logits, plain RoPE,
#: the vocabulary held in rows of a multiple of 128, one B/C group, the
#: residual stream in the compute type, SiLU gates
FIXED = {"norm_topk_prob": True, "rope_scaling": None, "scoring_func": "softmax",
         "topk_method": "greedy", "n_group": 1, "topk_group": 1,
         "q_lora_rank": None, "hidden_act": "silu",
         "pad_vocab_size_multiple": 128, "residual_in_fp32": False,
         "ngroups": 1, "mamba_ngroups": 1, "rmsnorm": True,
         "norm_before_gate": False, "D_has_hdim": False}

#: what the reference computes; a ``port`` that asks for more is refused
PLAIN = {"qk_norm": False, "qkv_bias": False, "attn_softcap": None,
         "final_softcap": None, "sliding_window": None, "use_post_norm": False,
         "embed_scale": False, "mlp_act": "swiglu", "encoder_stages": None,
         "cross_context": 0}

KINDS = ("mamba", "mla_dense", "mla_moe")


def layers(port: Dict) -> Dict[str, int]:
    """Blocks of each kind, over all stages."""
    out: Dict[str, int] = {}
    for st in port["stages"]:
        for kind in st["unit"]:
            out[kind] = out.get(kind, 0) + st["repeats"]
    return out


def port_of(cfg_file: Dict) -> Dict:
    """The file's ``port``, checked against its published settings."""
    port = dict(cfg_file["port"])
    runs = cfg_file.get("runs", {})
    for k, v in FIXED.items():
        if k in cfg_file and runs.get(k, cfg_file[k]) != v:
            raise ValueError(f"{k} = {runs.get(k, cfg_file[k])!r}, but the "
                             f"program runs {v!r}")
    if "n_routed_experts" in cfg_file and \
            port["capacity_factor"] * port["top_k"] < port["n_experts"]:
        raise ValueError("capacity_factor drops (token, choice) pairs past "
                         "an expert's buffer; the published model drops none")
    for k, v in PLAIN.items():
        if port.get(k, v) != v:
            raise ValueError(f"port.{k} = {port[k]!r}: the reference takes "
                             f"only {v!r}")
        port[k] = v
    for st in port["stages"]:
        for kind in st["unit"]:
            if kind not in KINDS:
                raise ValueError(f"block kind {kind!r} has no reference")
    for pub, run in SAME.items():
        if pub in cfg_file and run in port and cfg_file[pub] != port[run]:
            raise ValueError(f"{pub} = {cfg_file[pub]!r} but the port runs "
                             f"{run} = {port[run]!r}")
    for key in ("num_hidden_layers", "n_layer"):
        if key in cfg_file:
            counted = layers(port)
            n = counted.get("mamba", 0) + counted.get("mla_dense", 0) \
                + counted.get("mla_moe", 0)
            if n != cfg_file[key]:
                raise ValueError(f"{key} = {cfg_file[key]} but the port "
                                 f"runs {n}")
    return port


def padded_vocab(port: Dict) -> int:
    """The vocabulary rows the program holds: a multiple of 128."""
    return -(-port["vocab_size"] // 128) * 128


def mamba_heads(port: Dict) -> int:
    return port["mamba_expand"] * port["d_model"] // port["mamba_headdim"]

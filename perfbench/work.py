"""The yardstick's arithmetic: the table of peaks, each kernel's
operations and bytes reckoned from its call's arguments, and a model's
FLOPs from its configuration's shapes.

A kernel's bound is the larger of its bytes over the memory bandwidth and
its operations over the peak for its dtype (NVIDIA's H100 SXM data sheet,
dense rates). Each input is counted read once and each output written
once, whatever the kernel reads again; operations are what the inputs
need (attention over its causal pairs, the SSD scan as its recurrence).
These are copies of ``chip_smoke.py``'s ``bound_ms`` and its byte counts,
which reproduce the bounds in ``PERF.md``.

A model's FLOPs count the products of one forward pass at B x S tokens:
the weight-shared attention block once per use, an MoE layer by the
experts each token is routed to (top-k routed and the shared ones, never
the capacity's slots), attention by its causal pairs. Training is three
times the forward.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np

from perfbench import modelcfg

HBM_BYTES_PER_S = 3.35e12
#: dense peak operations a second by the dtype of a call's inputs
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
#: the peak a model's FLOPs are held to (the configurations' bfloat16)
MODEL_PEAK = PEAK_OPS["bfloat16"]

Work = Tuple[float, float, str]          # (operations, bytes, dtype)


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _bytes(t) -> int:
    return math.prod(t.shape) * t.element_size()


def bound_s(work: Work) -> float:
    ops, nbytes, dtype = work
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype])


@functools.lru_cache(maxsize=None)
def causal_pairs(sq: int, sk: int, window: Optional[int] = None) -> int:
    """(query, key) pairs a causal mask keeps, queries aligned to the last
    ``sq`` of ``sk`` keys; within ``window`` keys when one is given."""
    last = np.arange(sq, dtype=np.int64) + (sk - sq)   # newest key seen
    first = (np.zeros_like(last) if window is None
             else np.maximum(0, last - window + 1))
    return int(np.clip(np.minimum(last, sk - 1) - first + 1, 0, None).sum())


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, softcap=None) -> Work:
    """K5: q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv) read,
    o (B, Sq, Hq, Dv) written; two products over the pairs."""
    B, Sq, Hq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    pairs = causal_pairs(Sq, Sk, window) if causal else Sq * Sk
    ops = 2.0 * B * Hq * pairs * (D + Dv)
    out = B * Sq * Hq * Dv * q.element_size()
    return ops, float(_bytes(q) + _bytes(k) + _bytes(v) + out), _dtype(q)


def ssd_scan(x, dt, A, B, C, D=None, *, chunk: int = 128) -> Work:
    """K7: x (b, s, h, p), dt, A, B, C (b, s, g, n), D read; y (x's shape
    and dtype) and the final state (b, h, p, n) float32 written. The
    recurrence's state update and read-out, 4 h p n a step, and the D
    skip."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    ops = b * s * h * (4.0 * p * n + 2.0 * p)
    read = sum(_bytes(t) for t in (x, dt, A, B, C) + (() if D is None else (D,)))
    written = _bytes(x) + b * h * p * n * 4
    return ops, float(read + written), _dtype(x)


def quant_pack(x, *, block: int = 256) -> Work:
    """K3: x read; int8 q (x's size) and a float32 scale per block
    written; absmax, divide and round, three operations a value."""
    n = math.prod(x.shape)
    return 3.0 * n, float(_bytes(x) + n + 4 * (n // block)), "float32"


#: the work of each op of ``repro_torch.kernels.ops`` the benchmark spans
KERNELS = {"flash_attention": flash_attention, "ssd_scan": ssd_scan,
           "quant_pack": quant_pack}


# ------------------------------------------------------------- models
def _attn_products(B: int, S: int, heads: int, dqk: int, dv: int) -> float:
    return 2.0 * B * heads * causal_pairs(S, S) * (dqk + dv)


def block_flops(kind: str, port: Dict, B: int, S: int) -> float:
    """FLOPs of one block's forward at B x S tokens."""
    d, T = port["d_model"], B * S
    swiglu = lambda width: 6.0 * d * width
    if kind == "mamba":
        di = port["mamba_expand"] * d
        n, p = port["ssm_state"], port["mamba_headdim"]
        h = modelcfg.mamba_heads(port)
        proj = 2.0 * d * (2 * di + 2 * n + h) + 2.0 * di * d
        conv = 2.0 * port["conv_width"] * (di + 2 * n)
        return T * (proj + conv + h * (4.0 * p * n + 2.0 * p))
    if kind in ("mla_dense", "mla_moe"):
        H, r = port["n_heads"], port["kv_lora_rank"]
        nope, rp, dv = port["qk_nope_dim"], port["qk_rope_dim"], port["v_head_dim"]
        per_token = (2.0 * d * H * (nope + rp) + 2.0 * d * (r + rp)
                     + 2.0 * r * H * (nope + dv) + 2.0 * H * dv * d)
        if kind == "mla_dense":
            per_token += swiglu(port["d_ff"])
        else:
            per_token += (2.0 * d * port["n_experts"]
                          + swiglu(port["expert_d_ff"])
                          * (port["top_k"] + port.get("n_shared_experts", 0)))
        return T * per_token + _attn_products(B, S, H, nope + rp, dv)
    raise ValueError(kind)


def forward_flops(port: Dict, B: int, S: int) -> float:
    """One forward pass at B x S tokens, the output head at every
    position."""
    total = sum(block_flops(kind, port, B, S) * n
                for kind, n in modelcfg.layers(port).items())
    return total + 2.0 * B * S * port["d_model"] * port["vocab_size"]


def train_flops(port: Dict, B: int, S: int) -> float:
    """A training step: the forward and a backward of twice its FLOPs
    (recomputation under remat not counted)."""
    return 3.0 * forward_flops(port, B, S)

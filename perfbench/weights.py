"""Random weights from the seed, in the program's layout, made by the
benchmark and handed to both sides: the program takes the tree, the
reference the same numbers drawn again from the same seed.

They are drawn on the device in a few large calls, in the type they are
served in: every bfloat16 matrix from one stream of normals, cut into
leaves and scaled in place; the float32 matrices (the MoE routers) from
another. Scales are the program's initialisers' (1/sqrt(fan-in), the
embedding's 1/sqrt(d), a conv's 1/width), and norms, biases and Mamba2's
A_log, D and dt_bias take the program's fixed values. The tree is
``{"embed", "final_norm", "stages", "lm_head"?}`` with each
stage a tuple of unit entries whose leaves are stacked on a leading
repeats axis, as ``repro_torch.models.transformer.init_params`` lays it
out. Plain torch: the reference imports this module.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import modelcfg

#: normals drawn per call
CHUNK = 1 << 30

Spec = Tuple[str, Tuple[int, ...], torch.dtype, str, float]


def _mlp(prefix: str, d: int, dff: int, bf16) -> List[Spec]:
    return [(f"{prefix}.gate", (d, dff), bf16, "normal", d ** -0.5),
            (f"{prefix}.down", (dff, d), bf16, "normal", dff ** -0.5),
            (f"{prefix}.up", (d, dff), bf16, "normal", d ** -0.5)]


def _block(kind: str, port: Dict, prefix: str) -> List[Spec]:
    bf = torch.bfloat16
    f32 = torch.float32
    d = port["d_model"]
    if kind == "mamba":
        di = port["mamba_expand"] * d
        n = port["ssm_state"]
        h = modelcfg.mamba_heads(port)
        w = port["conv_width"]
        m = f"{prefix}.mamba"
        return [(f"{prefix}.ln1", (d,), bf, "ones", 0.0),
                (f"{m}.in_z", (d, di), bf, "normal", d ** -0.5),
                (f"{m}.in_x", (d, di), bf, "normal", d ** -0.5),
                (f"{m}.in_bc", (d, 2 * n), bf, "normal", d ** -0.5),
                (f"{m}.in_dt", (d, h), bf, "normal", d ** -0.5),
                (f"{m}.conv_x_w", (w, di), bf, "normal", 1.0 / w),
                (f"{m}.conv_x_b", (di,), bf, "zeros", 0.0),
                (f"{m}.conv_bc_w", (w, 2 * n), bf, "normal", 1.0 / w),
                (f"{m}.conv_bc_b", (2 * n,), bf, "zeros", 0.0),
                (f"{m}.A_log", (h,), f32, "A_log", 0.0),
                (f"{m}.D", (h,), f32, "ones", 0.0),
                (f"{m}.dt_bias", (h,), f32, "dt_bias", 0.0),
                (f"{m}.gate_norm", (di,), bf, "ones", 0.0),
                (f"{m}.out_proj", (di, d), bf, "normal", di ** -0.5)]
    if kind in ("mla_dense", "mla_moe"):
        H = port["n_heads"]
        r, rope = port["kv_lora_rank"], port["qk_rope_dim"]
        nope, dv = port["qk_nope_dim"], port["v_head_dim"]
        a = f"{prefix}.attn"
        out = [(f"{prefix}.ln1", (d,), bf, "ones", 0.0),
               (f"{a}.wq", (d, H * (nope + rope)), bf, "normal", d ** -0.5),
               (f"{a}.w_dkv", (d, r + rope), bf, "normal", d ** -0.5),
               (f"{a}.kv_norm", (r,), bf, "ones", 0.0),
               (f"{a}.w_uk", (r, H * nope), bf, "normal", r ** -0.5),
               (f"{a}.w_uv", (r, H * dv), bf, "normal", r ** -0.5),
               (f"{a}.wo", (H * dv, d), bf, "normal", (H * dv) ** -0.5),
               (f"{prefix}.ln2", (d,), bf, "ones", 0.0)]
        if kind == "mla_dense":
            return out + _mlp(f"{prefix}.mlp", d, port["d_ff"], bf)
        E, dff = port["n_experts"], port["expert_d_ff"]
        mo = f"{prefix}.moe"
        out += [(f"{mo}.router", (d, E), f32, "normal", d ** -0.5),
                (f"{mo}.experts_gate", (E, d, dff), bf, "normal", d ** -0.5),
                (f"{mo}.experts_up", (E, d, dff), bf, "normal", d ** -0.5),
                (f"{mo}.experts_down", (E, dff, d), bf, "normal",
                 dff ** -0.5)]
        if port.get("n_shared_experts", 0) > 0:
            out += _mlp(f"{mo}.shared", d, port["n_shared_experts"] * dff, bf)
        return out
    raise ValueError(kind)


def leaf_specs(port: Dict) -> List[Spec]:
    """(path, shape, dtype, init, scale) of every leaf, in the tree's
    order; a stacked leaf's shape leads with its stage's repeats."""
    bf = torch.bfloat16
    d = port["d_model"]
    V = modelcfg.padded_vocab(port)
    specs: List[Spec] = [("embed", (V, d), bf, "normal", d ** -0.5),
                         ("final_norm", (d,), bf, "ones", 0.0)]
    for s, st in enumerate(port["stages"]):
        for j, kind in enumerate(st["unit"]):
            for path, shape, dt, init, scale in _block(kind, port,
                                                       f"stages.{s}.{j}"):
                specs.append((path, (st["repeats"],) + shape, dt, init, scale))
    if not port["tie_embeddings"]:
        specs.append(("lm_head", (d, V), bf, "normal", d ** -0.5))
    return specs


def _fixed(init: str, shape, dtype, dev) -> torch.Tensor:
    h = shape[-1]
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if init == "A_log":
        row = np.log(np.linspace(1.0, 16.0, h))
    elif init == "dt_bias":
        row = np.log(np.expm1(np.linspace(1e-3, 0.1, h)))
    else:
        raise ValueError(init)
    return torch.as_tensor(row, dtype=dtype, device=dev).expand(shape).clone()


def _normals(n: int, dtype, gen: torch.Generator, dev) -> torch.Tensor:
    out = torch.empty(n, dtype=dtype, device=dev)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        out[s:e] = torch.randn(e - s, dtype=dtype, generator=gen, device=dev)
    return out


def generator(seed: int, dev) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed % (1 << 64))
    return g


def make_flat(port: Dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    """{path: tensor} of every leaf, drawn from ``seed`` on ``dev``."""
    dev = torch.device(dev)
    specs = leaf_specs(port)
    gen = generator(seed, dev)
    pools = {}
    for dt in (torch.bfloat16, torch.float32):
        n = sum(math.prod(sh) for _, sh, d, init, _ in specs
                if init == "normal" and d == dt)
        pools[dt] = [_normals(n, dt, gen, dev), 0]
    flat: Dict[str, torch.Tensor] = {}
    for path, shape, dt, init, scale in specs:
        if init == "normal":
            pool = pools[dt]
            n = math.prod(shape)
            flat[path] = pool[0][pool[1]:pool[1] + n].view(shape).mul_(scale)
            pool[1] += n
        else:
            flat[path] = _fixed(init, shape, dt, dev)
    return flat


def tree(port: Dict, flat: Dict[str, torch.Tensor]) -> Dict:
    """The program's nested layout of ``flat`` (the same tensors)."""
    def group(prefix: str) -> Dict:
        out: Dict = {}
        for path, t in flat.items():
            if not path.startswith(prefix + "."):
                continue
            node = out
            parts = path[len(prefix) + 1:].split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
        return out

    out = {"embed": flat["embed"], "final_norm": flat["final_norm"],
           "stages": tuple(tuple(group(f"stages.{s}.{j}")
                                 for j in range(len(st["unit"])))
                           for s, st in enumerate(port["stages"]))}
    if "lm_head" in flat:
        out["lm_head"] = flat["lm_head"]
    return out


def paths(node, prefix: str = "") -> List[str]:
    """Leaf paths of a tree of dicts and tuples, in its order."""
    if isinstance(node, dict):
        return [p for k, v in node.items()
                for p in paths(v, f"{prefix}{k}.")]
    if isinstance(node, (tuple, list)):
        return [p for i, v in enumerate(node)
                for p in paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]

"""The assigned input-shape sets, with meta-device tensors as stand-ins
(no storage): the port's ``repro.launch.shapes``.

Per-arch shape grid (assignment):
  train_4k     seq 4096,    global_batch 256   (train_step)
  prefill_32k  seq 32768,   global_batch 32    (prefill forward)
  decode_32k   seq 32768,   global_batch 128   (serve_step, KV cache = seq)
  long_500k    seq 524288,  global_batch 1     (serve_step; SSM/hybrid only)

``long_500k`` is skipped (reported as such) for full-attention archs;
whisper's decode uses its fixed 1500-frame encoder context as the cross
input. Where JAX returns ``jax.ShapeDtypeStruct``s, :func:`input_specs`
returns tensors on the ``meta`` device: each has the shape and dtype and
no data, and so do :func:`param_structs` and :func:`train_state_structs`
(the whole weights and training state at ``tp``, for the dry run,
``launch/dryrun.py``); :func:`rank_bytes` reckons a rank's parameter and
ZeRO-1 bytes from the specs on meta tensors, for the launchers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.launch.mesh import tp_size
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MetaGenerator
from repro_torch.training.optimizer import zero1_tree_specs


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """(runs?, reason). long_500k only for sub-quadratic archs."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention architecture: 500k-token cache decode "
                       "is not sub-quadratic-capable; documented skip")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _context(cfg: ModelConfig, batch: int):
    """The cross-attention input: vision's patch embeddings, whisper's
    encoded frames; None for a model without one."""
    if cfg.cross_context:
        return _meta((batch, cfg.cross_context, cfg.d_model), torch.bfloat16)
    if cfg.encoder_stages is not None:
        return _meta((batch, cfg.encoder_context, cfg.d_model),
                     torch.bfloat16)
    return None


def input_specs(cfg: ModelConfig, shape_name: str,
                tp: int = 16) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input of this cell.

    train   -> {'batch': {tokens, labels[, context|frames]}}
    prefill -> {'tokens'[, 'context']}
    decode  -> {'tokens', 'pos', 'cache'[, 'context']}
    """
    sc = SHAPES[shape_name]
    B, S = sc.batch, sc.seq
    if sc.kind == "train":
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        if cfg.cross_context:
            batch["context"] = _context(cfg, B)
        if cfg.encoder_stages is not None:
            batch["frames"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        return {"batch": batch}
    out: Dict[str, Any] = {}
    if sc.kind == "prefill":
        out["tokens"] = _meta((B, S), torch.int32)
    else:  # decode: the cache sized to the context length
        out["tokens"] = _meta((B, 1), torch.int32)
        out["pos"] = _meta((B,), torch.int32)
        out["cache"] = tr.init_cache(cfg, B, max_seq=S, tp=tp, device="meta")
    ctx = _context(cfg, B)
    if ctx is not None:
        out["context"] = ctx
    return out


def param_structs(cfg: ModelConfig, tp: int = 16):
    """The whole weights at ``tp`` as meta tensors."""
    return tr.init_params(MetaGenerator(), cfg, tp, device="meta")


def train_state_structs(cfg: ModelConfig, tcfg, tp: int = 16):
    """The whole training state ({'params', 'opt'}) at ``tp`` as meta
    tensors."""
    from repro_torch.training import train_step as ts
    return ts.init_train_state(MetaGenerator(), cfg, tcfg, tp, device="meta")


def rank_bytes(cfg: ModelConfig, mesh, params, opt=None) -> Dict[str, int]:
    """This rank's bytes of ``params`` (and of the optimizer state
    ``opt``'s master weights and moments) beside the reckoning from the
    specs of the whole weights on the meta device: ``param_specs`` for the
    parameters, ``zero1_specs`` over 'data' for the float32 state."""
    tp = tp_size(mesh)
    structs = param_structs(cfg, tp)
    specs = sharding.param_specs(structs, cfg, tp)
    out = {"params": sharding.local_bytes(params),
           "params_reckoned": sharding.reckoned_bytes(structs, specs, mesh)}
    if opt is not None:
        f32 = tr.tree_map(lambda t: t.float(), structs)
        z = zero1_tree_specs(specs, structs, mesh)
        out["opt"] = sum(sharding.local_bytes(t)
                         for t in (opt.master, opt.m, opt.v))
        out["opt_reckoned"] = 3 * sharding.reckoned_bytes(f32, z, mesh)
    return out

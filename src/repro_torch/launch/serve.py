"""Serving launcher: prompt fed token by token, then batched greedy decode,
on one device or over a mesh.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --smoke --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch zamba2-2.7b --model-mesh 2

Port of ``repro.launch.serve``: the same loop (each prompt token through
``decode_step``, then ``--tokens`` greedy tokens, the first from the
prompt's last logits) with random weights from seed 0 and random prompts
from seed 1, on ``--device`` (default ``cuda``). Prints the tokens per
second of the whole loop, as the JAX launcher does.

``--data-mesh`` and ``--model-mesh`` lay the ranks out as ``--data-mesh``
x ``--model-mesh`` (``launch.mesh.launch_mesh``; under ``torchrun`` the
world size must be their product): the batch over 'data', the weights
tensor-parallel over 'model' (each rank draws the whole weights from seed
0 and keeps its shards, ``sharding.param_specs``) and the decode cache's
sequence over 'model' (``serving.decode``: the sequence-sharded decode).
The cache's slots are rounded up to a multiple of ``--model-mesh`` (slots
past a sequence's length are never attended). Ranks that share a card run
over gloo. Each rank prints its parameter bytes beside the reckoning from
the specs; rank 0 prints the rate.

Like the JAX launcher, the command line feeds no cross-attention context.
A config that needs one (``cross_context``: vision; ``encoder_stages``:
whisper, whose decoder attends to the encoded frames) is refused with a
``ValueError``; drive it through ``serve(..., context=...)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.device import describe
from repro_torch.launch.mesh import launch_mesh
from repro_torch.launch.shapes import rank_bytes
from repro_torch.models import transformer as tr
from repro_torch.serving.decode import init_cache, make_decode_step


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, n_tokens) generated, int64
    prompt_logits: torch.Tensor   # (B, 1, V) logits of the last prompt step
    prompt_s: float               # host seconds of the prompt steps
    decode_s: float               # host seconds of the generation steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(step, params, cache, prompts: torch.Tensor, n_tokens: int,
          context=None) -> ServeResult:
    """Feed ``prompts`` (B, P) one token per step, then generate
    ``n_tokens`` greedily: P + n_tokens - 1 calls of ``step``, each given
    ``context`` (B, Sc, d) for the cross-attention blocks, if any: the
    patch embeddings of a vision model, the encoded frames
    (``transformer.encode``) of whisper."""
    dev = params["embed"].device
    prompts = torch.as_tensor(prompts, device=dev).long()
    B, P = prompts.shape
    at = lambda i: torch.full((B,), i, dtype=torch.int32, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for i in range(P):
        logits, cache = step(params, cache, prompts[:, i:i + 1], at(i),
                             context)
    prompt_logits = logits
    tok = logits[:, -1:].argmax(-1)
    out = [tok]
    _sync(dev)
    t1 = time.perf_counter()
    for j in range(n_tokens - 1):
        logits, cache = step(params, cache, tok, at(P + j), context)
        tok = logits[:, -1:].argmax(-1)
        out.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    return ServeResult(torch.cat(out, dim=1), prompt_logits, t1 - t0, t2 - t1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--data-mesh", type=int, default=1,
                    help="data-parallel ranks (0, the production mesh, is "
                         "refused: one card)")
    ap.add_argument("--model-mesh", type=int, default=1,
                    help="ranks the decode cache's sequence is sharded over")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.cross_context or cfg.encoder_stages is not None:
        raise ValueError(
            f"{cfg.name} attends to a cross-attention context, which this "
            f"command line does not feed (nor does repro.launch.serve); call "
            f"serve(..., context=...) with the context "
            f"(repro_torch.launch.shapes.input_specs gives its shape)")
    mesh, dev = launch_mesh(args.data_mesh, args.model_mesh, args.device)
    B = args.batch
    n = args.model_mesh
    max_seq = -(-(args.prompt_len + args.tokens + 1) // n) * n
    params = tr.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            n, mesh, device=dev)
    if mesh is not None:
        b = rank_bytes(cfg, mesh, params)
        print(f"rank {dist.get_rank()}: parameters {b['params']:,} bytes "
              f"(reckoned from param_specs: {b['params_reckoned']:,})",
              flush=True)
    cache = init_cache(cfg, B, max_seq=max_seq, mesh=mesh, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    res = serve(make_decode_step(cfg, mesh), params, cache, prompts,
                args.tokens)
    dt = res.prompt_s + res.decode_s
    if mesh is None or dist.get_rank() == 0:
        where = describe(dev)["kind"]
        if mesh is not None:
            where += f", mesh {args.data_mesh} x {args.model_mesh}"
        print(f"{cfg.name}: {B * args.tokens} tokens in {dt:.2f}s "
              f"({B * args.tokens / dt:.1f} tok/s) on {where}")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

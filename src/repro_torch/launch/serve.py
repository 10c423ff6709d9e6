"""Serving launcher: prompt fed token by token, then batched greedy decode,
on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --smoke --device cpu

Port of ``repro.launch.serve`` without the mesh flags: the same loop (each
prompt token through ``decode_step``, then ``--tokens`` greedy tokens, the
first from the prompt's last logits) with random weights from seed 0 and
random prompts from seed 1, on ``--device`` (default ``cuda``). Prints the
tokens per second of the whole loop, as the JAX launcher does.

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

from repro_torch.configs.registry import get_config
from repro_torch.device import describe, resolve
from repro_torch.models import transformer as tr
from repro_torch.serving.decode import make_decode_step


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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.cross_context or cfg.encoder_stages is not None:
        raise ValueError(
            f"{cfg.name} attends to a cross-attention context, which this "
            f"command line does not feed (nor does repro.launch.serve); call "
            f"serve(..., context=...) with the context "
            f"(repro_torch.launch.shapes.input_specs gives its shape)")
    dev = resolve(args.device)
    B = args.batch
    max_seq = args.prompt_len + args.tokens + 1
    params = tr.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
    cache = tr.init_cache(cfg, B, max_seq=max_seq, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    res = serve(make_decode_step(cfg), params, cache, prompts, args.tokens)
    dt = res.prompt_s + res.decode_s
    print(f"{cfg.name}: {B * args.tokens} tokens in {dt:.2f}s "
          f"({B * args.tokens / dt:.1f} tok/s) on {describe(dev)['kind']}")


if __name__ == "__main__":
    main()

"""The serving slice as a whole, held against ``repro``: zamba2 (smoke
size, float32) with ``repro``'s weights serves a batch of 2 prompts of 8
tokens and generates 6 more through the port's serve loop
(``repro_torch.launch.serve.serve``) and through the loop of
``repro/launch/serve.py`` (one jitted ``decode_step`` per token, here on
one CPU device). The greedy tokens must be identical, and the port's
``make_prefill_step`` logits at the last prompt position must match its
decode path's to 1e-4. The same for deepseek-v2-lite (MLA and MoE),
llama-3.2-vision (patch embeddings as the context of every step) and
whisper (the frames encoded once, then the context of every step); and
the command line refuses a model that needs a context, which it does not
feed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import model_param_arrays

from repro.configs.registry import get_config as j_config
from repro.models import transformer as jtr
from repro.serving.decode import make_decode_step as j_decode_step
from repro_torch import convert
from repro_torch.configs.registry import get_config as t_config
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttr
from repro_torch.serving.decode import make_decode_step, make_prefill_step

ARCH, B, PROMPT, NEW = "zamba2-2.7b", 2, 8, 6


def _jax_serve(params, cfg, prompts, context=None):
    """``repro/launch/serve.py``'s loop without the mesh, with a context
    given to every step."""
    step = j_decode_step(cfg)
    cache = jtr.init_cache(cfg, B, max_seq=PROMPT + NEW + 1)
    logits = None
    for i in range(PROMPT):
        logits, cache = step(params, cache, jnp.asarray(prompts[:, i:i + 1]),
                             jnp.full((B,), i, jnp.int32), context)
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    out = [tok]
    for j in range(NEW - 1):
        logits, cache = step(params, cache, tok,
                             jnp.full((B,), PROMPT + j, jnp.int32), context)
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], axis=1)


def test_zamba2_serving_matches_repro():
    jcfg, tcfg = j_config(ARCH, smoke=True), t_config(ARCH, smoke=True)
    jp = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.model_params_from_arrays(model_param_arrays(jp), tcfg,
                                          device="cpu")
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                                (B, PROMPT))
    want = _jax_serve(jp, jcfg, prompts)

    cache = ttr.init_cache(tcfg, B, max_seq=PROMPT + NEW + 1, device="cpu")
    res = tserve.serve(make_decode_step(tcfg), tp, cache,
                       torch.as_tensor(prompts), NEW)
    assert res.tokens.shape == (B, NEW)
    np.testing.assert_array_equal(res.tokens.numpy(), want)

    logits = make_prefill_step(tcfg)(tp, torch.as_tensor(prompts))
    assert logits.shape == (B, PROMPT, ttr.padded_vocab(tcfg))
    np.testing.assert_allclose(logits[:, -1].numpy(),
                               res.prompt_logits[:, 0].numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "llama-3.2-vision-90b", "whisper-small"])
def test_zoo_serving_with_context_matches_repro(arch):
    cfg, tcfg = j_config(arch, smoke=True), t_config(arch, smoke=True)
    jp = jtr.init_params(jax.random.PRNGKey(1), cfg)
    tp = convert.model_params_from_arrays(model_param_arrays(jp), tcfg,
                                          device="cpu")
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    ctx_j = ctx_t = None
    rows = cfg.cross_context or (cfg.encoder_context
                                 if cfg.encoder_stages else 0)
    if rows:
        raw = rng.standard_normal((B, rows, cfg.d_model)).astype(np.float32)
        ctx_j, ctx_t = jnp.asarray(raw), torch.as_tensor(raw)
        if cfg.encoder_stages is not None:
            ctx_j = jtr.encode(jp, ctx_j, cfg)
            ctx_t = ttr.encode(tp, ctx_t, tcfg)
    want = _jax_serve(jp, cfg, prompts, ctx_j)
    cache = ttr.init_cache(tcfg, B, max_seq=PROMPT + NEW + 1, device="cpu")
    res = tserve.serve(make_decode_step(tcfg), tp, cache,
                       torch.as_tensor(prompts), NEW, context=ctx_t)
    np.testing.assert_array_equal(res.tokens.numpy(), want)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-small"])
def test_serve_cli_refuses_a_model_that_needs_a_context(arch, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--smoke",
                                     "--device", "cpu"])
    with pytest.raises(ValueError, match=r"serve\(\.\.\., context=\.\.\.\)"):
        tserve.main()

"""The serving slice as a whole, held against ``repro``: zamba2 (smoke
size, float32) with ``repro``'s weights serves a batch of 2 prompts of 8
tokens and generates 6 more through the port's serve loop
(``repro_torch.launch.serve.serve``) and through the loop of
``repro/launch/serve.py`` (one jitted ``decode_step`` per token, here on
one CPU device). The greedy tokens must be identical, and the port's
``make_prefill_step`` logits at the last prompt position must match its
decode path's to 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
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


def _jax_serve(params, cfg, prompts):
    """``repro/launch/serve.py``'s loop without the mesh."""
    step = j_decode_step(cfg)
    cache = jtr.init_cache(cfg, B, max_seq=PROMPT + NEW + 1)
    logits = None
    for i in range(PROMPT):
        logits, cache = step(params, cache, jnp.asarray(prompts[:, i:i + 1]),
                             jnp.full((B,), i, jnp.int32))
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    out = [tok]
    for j in range(NEW - 1):
        logits, cache = step(params, cache, tok,
                             jnp.full((B,), PROMPT + j, jnp.int32))
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

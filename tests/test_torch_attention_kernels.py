"""PyTorch port of flash attention (K5) and decode attention (K6), held
against ``repro``: the plain torch versions against the Pallas kernels in
interpret mode, on the sweeps of ``tests/test_kernels.py`` plus 80-wide
heads (zamba2), at the JAX suite's tolerances (2e-5 in float32, 2e-2 in
bfloat16). The CUDA kernels are held against the plain versions in
``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention as j_flash
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(a, dtype):
    """The same numbers as a jax array and a CPU tensor of ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.as_tensor(a).to(tdt)


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D, Dv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D), np.float32),
            rng.standard_normal((B, Sk, Hkv, D), np.float32),
            rng.standard_normal((B, Sk, Hkv, Dv or D), np.float32))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window,softcap", [
    (1, 128, 4, 4, 64, None, None),      # MHA
    (2, 96, 8, 2, 32, None, None),       # GQA, non-multiple seq
    (1, 256, 4, 1, 64, 64, None),        # MQA + sliding window
    (1, 128, 2, 2, 64, None, 50.0),      # logit softcap (gemma2)
    (2, 72, 4, 4, 80, None, None),       # zamba2's 80-wide heads
    (1, 100, 4, 2, 80, 24, 30.0),        # 80 wide, GQA, window, softcap
])
def test_flash_plain_matches_pallas(B, S, Hq, Hkv, D, window, softcap, dtype):
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in
                                    _qkv(2, B, S, S, Hq, Hkv, D))
    out_j = j_flash(qj, kj, vj, causal=True, window=window, softcap=softcap,
                    block_q=64, block_k=64, interpret=True)
    out_t = tfa.flash_attention_plain(qt, kt, vt, causal=True, window=window,
                                      softcap=softcap)
    assert out_t.dtype == qt.dtype and out_t.shape == (B, S, Hq, D)
    _close(out_t, out_j, DTYPES[dtype][2])


@pytest.mark.parametrize("D,Dv", [(48, 32), (80, 80)])
def test_flash_plain_noncausal_and_dv(D, Dv):
    """Cross-attention shape: non-causal, Dv != D (and 80 = 80)."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(3, 2, 64, 64, 4, 2, D, Dv))
    out_j = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=False, block_q=32, block_k=32, interpret=True)
    _close(tfa.flash_attention_plain(q, k, v, causal=False), out_j, 2e-5)


def test_flash_plain_queries_at_the_end():
    """Sq < Sk: the queries are the last Sq positions of the keys."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(4, 1, 32, 96, 4, 2, 32))
    out_j = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, window=40, block_q=32, block_k=32,
                    interpret=True)
    _close(tfa.flash_attention_plain(q, k, v, causal=True, window=40),
           out_j, 2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [
    (2, 256, 8, 2, 64, None),
    (1, 512, 4, 1, 128, None),           # MQA long cache
    (3, 200, 8, 8, 32, 64),              # MHA + window, ragged lengths
    (4, 160, 4, 4, 80, None),            # zamba2's 80-wide heads
])
def test_decode_plain_matches_pallas(B, S, Hq, Hkv, D, window, dtype):
    rng = np.random.default_rng(4)
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(rng.standard_normal(shape, np.float32), dtype)
        for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    kv_len = rng.integers(window or 2, S + 1, B).astype(np.int32)
    out_j = j_decode(qj, kj, vj, jnp.asarray(kv_len), window=window,
                     block_k=64, interpret=True)
    out_t = tda.decode_attention_plain(qt, kt, vt, torch.as_tensor(kv_len),
                                       window=window)
    assert out_t.dtype == qt.dtype and out_t.shape == (B, Hq, D)
    _close(out_t, out_j, DTYPES[dtype][2])


def test_decode_plain_softcap():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s, np.float32) * 3
               for s in ((2, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)))
    kv_len = np.array([64, 9], np.int32)
    out_j = j_decode(*(jnp.asarray(a) for a in (q, k, v, kv_len)),
                     softcap=50.0, block_k=32, interpret=True)
    out_t = tda.decode_attention_plain(*(torch.as_tensor(a) for a in
                                         (q, k, v, kv_len)), softcap=50.0)
    _close(out_t, out_j, 2e-5)


def test_ops_run_the_plain_versions_on_cpu_tensors():
    q, k, v = (torch.as_tensor(a) for a in _qkv(6, 1, 40, 40, 4, 2, 16))
    ops.reset_launch_counts()
    np.testing.assert_array_equal(
        ops.flash_attention(q, k, v, window=8).numpy(),
        tfa.flash_attention_plain(q, k, v, window=8).numpy())
    kv_len = torch.tensor([17], dtype=torch.int32)
    np.testing.assert_array_equal(
        ops.decode_attention(q[:, -1], k, v, kv_len).numpy(),
        tda.decode_attention_plain(q[:, -1], k, v, kv_len).numpy())
    assert sum(ops.launch_counts.values()) == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v = (torch.as_tensor(a) for a in _qkv(7, 1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_kernel(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention_kernel(q[:, 0], k, v,
                                    torch.tensor([4], dtype=torch.int32))

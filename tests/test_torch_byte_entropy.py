"""K4, the byte histogram and entropy of the PyTorch port, held against
``repro``'s Pallas kernel in interpret mode (and ``byte_entropy_ref``) on
the cases of ``tests/test_kernels.py``: the histogram identical, the
entropy within rel 1e-5 (the JAX suite's tolerance). Both the plain
version and ``ops.byte_entropy(device="cpu")`` are checked."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from repro.kernels import ref as jref
from repro.kernels.entropy_features import byte_entropy as j_byte_entropy
from repro_torch.kernels import entropy_features as tef
from repro_torch.kernels import ops


def _check(data: np.ndarray, block: int):
    hj, ej = j_byte_entropy(jnp.asarray(data), block=block, interpret=True)
    hr, er = jref.byte_entropy_ref(jnp.asarray(data))
    np.testing.assert_array_equal(np.asarray(hj), np.asarray(hr))
    for h, e in (tef.byte_entropy_plain(torch.as_tensor(data)),
                 ops.byte_entropy(data, device="cpu")):
        assert h.dtype == torch.int32 and h.shape == (256,)
        assert e.dtype == torch.float32 and e.shape == ()
        np.testing.assert_array_equal(h.numpy(), np.asarray(hr))
        np.testing.assert_allclose(float(e), float(er), rtol=1e-5)
        np.testing.assert_allclose(float(e), float(ej), rtol=1e-5)
    return float(e)


@pytest.mark.parametrize("n,block", [
    (1000, 256), (8192, 1024), (37, 64),      # test_entropy_kernel_vs_ref
    (4096, 1024),     # n % block == 0
    (4097, 1024),     # one byte past a block
    (5000, 1024),     # n not a multiple of the block
    (100, 1024),      # n < block
    (1, 64),          # a single byte
])
def test_byte_entropy_matches_jax(n, block):
    data = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    _check(data, block)


def test_byte_entropy_constant_payload_is_zero():
    data = np.full(3000, 7, np.uint8)
    assert _check(data, 512) == 0.0
    h, _ = ops.byte_entropy(data, device="cpu")
    assert int(h[7]) == 3000 and int(h.sum()) == 3000


@pytest.mark.parametrize("n_symbols,bits", [(2, 1.0), (4, 2.0), (256, 8.0)])
def test_byte_entropy_uniform_alphabets(n_symbols, bits):
    data = np.tile(np.arange(n_symbols, dtype=np.uint8), 16)
    assert _check(data, 128) == pytest.approx(bits, abs=1e-5)


def test_byte_entropy_empty_payload_and_bad_input():
    h, e = ops.byte_entropy(np.zeros(0, np.uint8), device="cpu")
    hr, er = jref.byte_entropy_ref(jnp.zeros(0, jnp.uint8))
    np.testing.assert_array_equal(h.numpy(), np.asarray(hr))
    assert float(e) == float(er) == 0.0
    with pytest.raises(ValueError, match="uint8"):
        tef.byte_entropy_plain(torch.zeros((2, 3), dtype=torch.uint8))

"""K3, int8 block quantisation, and the int8 error-feedback gradient mean
of the PyTorch port, held against ``repro``: ``quant_pack_plain`` (what
``ops.quant_pack`` runs on the CPU) against the Pallas kernel in interpret
mode and against ``quant_pack_ref`` (int8 identical, scales within rel
1e-6, the JAX suite's tolerance), round half to even, the round-trip bound,
and ``_quant_leaf`` / ``compressed_mean`` against ``repro``'s on a 1x1
mesh (outputs and residual within 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401

from repro.distributed import ctx
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quant_pack import quant_pack as j_quant_pack
from repro.launch.mesh import make_test_mesh
from repro.training import grad_compression as jgc
from repro_torch.kernels import ops
from repro_torch.kernels import quant_pack as tqp
from repro_torch.training import grad_compression as tgc


def _x(seed, shape, scale=5.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 256), (1024,), (3, 2, 512),
                                   (300, 256)])
def test_quant_pack_plain_matches_jax(shape):
    x = _x(sum(shape), shape)
    q, s = tqp.quant_pack_plain(torch.as_tensor(x))
    for qj, sj in (j_quant_pack(jnp.asarray(x), interpret=True),
                   jref.quant_pack_ref(jnp.asarray(x))):
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-6)
    q2, s2 = ops.quant_pack(torch.as_tensor(x))
    assert torch.equal(q2, q) and torch.equal(s2, s)
    assert q.dtype == torch.int8 and q.shape == shape
    assert s.shape == (x.size // 256,) and s.dtype == torch.float32


def test_quant_pack_rounds_half_to_even():
    """A block of absmax 127 has scale 1, so x / scale is x: the ties
    0.5, 1.5, 2.5, -2.5 go to 0, 2, 2, -2 (jnp.round and torch.round both
    round half to even)."""
    x = np.zeros(256, np.float32)
    x[:5] = [127.0, 0.5, 1.5, 2.5, -2.5]
    q, s = ops.quant_pack(torch.as_tensor(x))
    assert float(s[0]) == 1.0
    assert q[:5].tolist() == [127, 0, 2, 2, -2]
    qj, _ = j_quant_pack(jnp.asarray(x), interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))


def test_quant_pack_zero_block_and_bad_size():
    x = np.zeros((2, 256), np.float32)
    x[1, 3] = -4.0
    q, s = ops.quant_pack(torch.as_tensor(x))
    assert float(s[0]) == np.float32(np.float32(1e-12) / np.float32(127.0))
    assert not q[0].any() and int(q[1, 3]) == -127
    with pytest.raises(ValueError, match="multiple"):
        ops.quant_pack(torch.zeros(300))


@pytest.mark.parametrize("shape", [(4, 256), (3, 2, 512)])
def test_quant_round_trip_bound(shape):
    x = torch.as_tensor(_x(7, shape))
    q, s = ops.quant_pack(x)
    back = ops.quant_unpack(q, s)
    assert float((back - x).abs().max()) <= float(x.abs().max()) / 127 + 1e-6
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jops.quant_unpack(jnp.asarray(q.numpy()),
                                                   jnp.asarray(s.numpy()))))


def _tree(seed):
    """Leaves whose sizes are and are not multiples of 256 (padded)."""
    return {"w": _x(seed, (8, 256), 3.0), "b": _x(seed + 1, (37,), 0.1),
            "k": {"c": _x(seed + 2, (3, 5, 7), 20.0)}}


@pytest.mark.parametrize("with_err", [False, True])
def test_quant_leaf_matches_jax(with_err):
    g = _x(3, (5, 77), 2.0)
    e = _x(4, (5, 77), 0.01) if with_err else np.zeros((5, 77), np.float32)
    deq_j, err_j = jgc._quant_leaf(jnp.asarray(g), jnp.asarray(e))
    deq_t, err_t = tgc._quant_leaf(torch.as_tensor(g), torch.as_tensor(e))
    np.testing.assert_allclose(deq_t.numpy(), np.asarray(deq_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=1e-6,
                               atol=1e-6)
    # the residual carries exactly what quantisation dropped
    np.testing.assert_allclose((deq_t + err_t).numpy(), g + e, rtol=1e-6,
                               atol=1e-6)


def test_compressed_mean_matches_jax_on_one_device_mesh():
    """Two rounds of the error-feedback mean, the second carrying the
    first's residual, against ``repro``'s on a 1x1 mesh."""
    mesh = make_test_mesh(1, 1)
    grads = [_tree(10), _tree(20)]
    err_j, err_t = None, None
    for g in grads:
        with ctx.mesh_context(mesh):
            red_j, err_j = jgc.compressed_mean(
                jax.tree.map(jnp.asarray, g), err_j, mesh, ("data",))
        red_t, err_t = tgc.compressed_mean(
            {"w": torch.as_tensor(g["w"]), "b": torch.as_tensor(g["b"]),
             "k": {"c": torch.as_tensor(g["k"]["c"])}}, err_t)
        for path in (("w",), ("b",), ("k", "c")):
            rt, et, rj, ej = red_t, err_t, red_j, err_j
            for key in path:
                rt, et, rj, ej = rt[key], et[key], rj[key], ej[key]
            np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-6,
                                       atol=1e-6)
            assert rt.dtype == et.dtype == torch.float32

"""PyTorch port of the fractional-overlap matrix and G-PART, held against
``repro``: the plain torch version against the Pallas kernel (interpret
mode) and the jnp oracle to 1e-5, the matrix's properties, and G-PART
partitions identical to ``repro``'s. The CUDA kernel is held against the
plain version in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.core import datapart as jdp
from repro.kernels import overlap as jov
from repro_torch.core import datapart as tdp
from repro_torch.kernels import ops
from repro_torch.kernels import overlap as tov

TOL = 1e-5


def _query_files(seed, n_parts=18, n_files=40):
    rng = np.random.default_rng(seed)
    files = [f"t/{i}" for i in range(n_files)]
    sizes = {f: float(rng.random() * 4 + 0.25) for f in files}
    qf = []
    for _ in range(n_parts):
        k = int(rng.integers(1, 7))
        fs = tuple(rng.choice(files, size=k, replace=False))
        qf.append((fs, float(rng.random() * 9 + 0.5)))
    return qf, sizes


def _layout(seed, **kw):
    qf, sizes = _query_files(seed, **kw)
    idx = jdp.PartitionIndex.from_partitions(jdp.make_partitions(qf, sizes))
    return idx.padded_codes()


def _plain(codes, sizes, spans, **kw):
    return ops.fractional_overlap_matrix(codes, sizes, spans, device="cpu",
                                         **kw).numpy()


def _canon(parts):
    return sorted((tuple(sorted(p.files)), round(p.rho, 9)) for p in parts)


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000))
def test_plain_matches_pallas_interpret_and_jnp_ref(seed):
    codes, sizes, spans = _layout(seed)
    w = _plain(codes, sizes, spans)
    w_int = np.asarray(jov.fractional_overlap_matrix(codes, sizes, spans,
                                                     interpret=True))
    w_ref = np.asarray(jov.fractional_overlap_matrix_ref(codes, sizes, spans))
    assert w.shape == w_int.shape == (codes.shape[0],) * 2
    assert np.abs(w - w_int).max() <= TOL
    assert np.abs(w - w_ref).max() <= TOL
    np.testing.assert_array_equal(w > 0, w_ref > 0)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_plain_symmetry_range_and_unit_diagonal(seed):
    codes, sizes, spans = _layout(seed)
    w = _plain(codes, sizes, spans)
    assert np.allclose(w, w.T, atol=0)
    assert (w >= 0.0).all() and (w <= 1.0 + 1e-6).all()
    assert np.allclose(np.diag(w), 1.0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_disjoint_rows_are_exact_zero(seed):
    rng = np.random.default_rng(seed)
    sizes = {f"t/{i}": float(rng.random() * 3 + 0.1) for i in range(60)}
    fs = jdp.FileSizes(sizes)
    parts = [jdp.Partition(frozenset(f"t/{j}" for j in range(10 * i, 10 * i + 10)),
                           1.0 + i, fs) for i in range(6)]
    codes, sz, spans = jdp.PartitionIndex.from_partitions(parts).padded_codes()
    w = _plain(codes, sz, spans)
    assert (w[~np.eye(len(parts), dtype=bool)] == 0.0).all()


def test_plain_rectangular_codes_b_matches_square_and_pallas():
    codes, sizes, spans = _layout(123, n_parts=12)
    full = _plain(codes, sizes, spans)
    blk = _plain(codes[:5], sizes, spans[:5], codes_b=codes, spans_b=spans)
    assert np.abs(full[:5] - blk).max() <= 1e-6
    blk_int = np.asarray(jov.fractional_overlap_matrix(
        codes[:5], sizes, spans[:5], codes_b=codes, spans_b=spans,
        interpret=True))
    assert np.abs(blk - blk_int).max() <= TOL


def test_index_overlap_matrix_matches_repro_numpy_sweep():
    qf, sizes = _query_files(7)
    idx = tdp.PartitionIndex.from_partitions(tdp.make_partitions(qf, sizes))
    w_dev = idx.overlap_matrix(device="cpu")
    w_np = jdp.PartitionIndex.from_partitions(
        jdp.make_partitions(qf, sizes)).overlap_matrix("numpy")
    assert np.abs(w_dev - w_np).max() <= TOL
    np.testing.assert_array_equal(w_dev > 0, w_np > 0)


@pytest.mark.parametrize("seed", [0, 3, 11, 42])
def test_g_part_device_matches_repro_interpret_and_numpy(seed):
    qf, sizes = _query_files(seed, n_parts=30, n_files=60)
    jparts = jdp.make_partitions(qf, sizes)
    tparts = tdp.make_partitions(qf, sizes)
    s = 2.5 * float(np.median([p.span for p in jparts]))
    want_int = _canon(jdp.g_part(list(jparts), s, backend="interpret"))
    want_np = _canon(jdp.g_part(list(jparts), s, backend="numpy"))
    got = _canon(tdp.g_part(list(tparts), s, backend="device", device="cpu"))
    assert got == want_int == want_np
    assert _canon(tdp.g_part(list(tparts), s, backend="numpy",
                             device="cpu")) == want_np
    assert _canon(tdp.g_part(list(tparts), s, backend="ref",
                             device="cpu")) == _canon(
        jdp.g_part_ref(list(jparts), s))


def test_kernel_wrapper_refuses_cpu_tensors():
    codes, sizes, spans = _layout(1)
    with pytest.raises(ValueError, match="CUDA"):
        tov.fractional_overlap_matrix_kernel(torch.as_tensor(codes),
                                             torch.as_tensor(sizes),
                                             torch.as_tensor(spans))

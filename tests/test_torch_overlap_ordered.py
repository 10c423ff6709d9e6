"""The algorithm of K1's CUDA kernel, on the CPU.

``repro_torch.kernels.overlap.fractional_overlap_matrix_ordered`` computes
the fractional-overlap matrix as ``csrc/overlap.cu`` does: the sizes of the
codes two rows share added in ascending code order in float32, then the
kernel's denominator and division. It is held against
``repro.kernels.overlap`` (the Pallas kernel in interpret mode, as
``tests/test_torch_overlap.py`` runs it, and ``fractional_overlap_matrix_ref``)
within 1e-5 with an identical ``w > 0`` pattern, on skewed rows, rows of one
code, disjoint rows, a rectangular ``codes_b`` and a file axis wider than
the bitmap plan's window; and against a sequential float32 sum, bit for
bit. Also: the plan chooser at ``chip_smoke.py``'s two shapes, and the host
check of the kernel's contract (codes in range, rows ascending, pads last),
which refuses bad rows before any kernel or plain version runs.
"""

import numpy as np
import pytest
import torch

from repro.kernels import overlap as jov
from repro_torch.kernels import ops
from repro_torch.kernels import overlap as tov

TOL = 1e-5


def _pad(rows, M=None):
    M = M or max(max((len(r) for r in rows), default=1), 1)
    codes = np.full((len(rows), M), -1, np.int32)
    for i, r in enumerate(rows):
        codes[i, :len(r)] = r
    return codes


def _layout(rows, F, rng):
    sizes = rng.uniform(0.1, 3.0, F).astype(np.float32)
    spans = np.array([sizes[r].sum() for r in rows], np.float32)
    return _pad(rows), sizes, spans


def _skewed(rng):
    F = 1200
    lens = rng.integers(1, 11, 30)
    lens[4] = 1000                         # one long row among short ones
    rows = [np.sort(rng.choice(F, int(k), replace=False)) for k in lens]
    return _layout(rows, F, rng) + (None, None)


def _one_code(rng):
    F = 12                                 # few files: many rows share one
    rows = [np.array([c]) for c in rng.integers(0, F, 25)]
    return _layout(rows, F, rng) + (None, None)


def _disjoint(rng):
    rows = [np.arange(10 * i, 10 * i + 10) for i in range(8)]
    return _layout(rows, 80, rng) + (None, None)


def _rectangular(rng):
    F = 150
    rows = [np.sort(rng.choice(F, int(k), replace=False))
            for k in rng.integers(1, 40, 29)]
    codes, sizes, spans = _layout(rows, F, rng)
    pick = rng.choice(29, 13, replace=False)
    return codes[pick], sizes, spans[pick], codes, spans


def _wide_file_axis(rng):
    # windows of 2-8 neighbouring files over more files than the bitmap
    # plan's window, as in the G-PART scaling benchmark
    F = tov.WINDOW_WORDS * 32 + 1000
    lo = rng.integers(0, 200, 40)
    rows = [np.arange(a, a + int(w)) for a, w in zip(lo, rng.integers(2, 9, 40))]
    return _layout(rows, F, rng) + (None, None)


CASES = {"skewed rows": _skewed, "rows of one code": _one_code,
         "disjoint rows": _disjoint, "rectangular codes_b": _rectangular,
         "file axis beyond one window": _wide_file_axis}


def _case(name):
    return CASES[name](np.random.default_rng(sorted(CASES).index(name)))


def _kw(codes_b, spans_b):
    return {} if codes_b is None else dict(codes_b=codes_b, spans_b=spans_b)


def _twin(codes, sizes, spans, codes_b, spans_b):
    kw = {} if codes_b is None else dict(codes_b=torch.as_tensor(codes_b),
                                         spans_b=torch.as_tensor(spans_b))
    return tov.fractional_overlap_matrix_ordered(
        *(torch.as_tensor(a) for a in (codes, sizes, spans)), **kw).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_ordered_matches_pallas_interpret_and_ref(name):
    codes, sizes, spans, codes_b, spans_b = _case(name)
    w = _twin(codes, sizes, spans, codes_b, spans_b)
    kw = _kw(codes_b, spans_b)
    w_int = np.asarray(jov.fractional_overlap_matrix(
        codes, sizes, spans, block_f=4096, interpret=True, **kw))
    w_ref = np.asarray(jov.fractional_overlap_matrix_ref(codes, sizes, spans,
                                                         **kw))
    nb = codes.shape[0] if codes_b is None else codes_b.shape[0]
    assert w.shape == w_int.shape == w_ref.shape == (codes.shape[0], nb)
    assert w.dtype == np.float32
    assert np.abs(w - w_int).max() <= TOL
    assert np.abs(w - w_ref).max() <= TOL
    np.testing.assert_array_equal(w > 0, w_ref > 0)
    np.testing.assert_array_equal(w > 0, w_int > 0)
    if name == "disjoint rows":
        assert (w[~np.eye(len(w), dtype=bool)] == 0.0).all()


@pytest.mark.parametrize("name", ["skewed rows", "rows of one code",
                                  "rectangular codes_b"])
def test_ordered_adds_shared_sizes_in_ascending_code_order(name):
    """Bit for bit the kernel's float32 arithmetic: the shared codes'
    sizes added one at a time in ascending order, then (span_i + span_j) -
    inter and one division."""
    codes, sizes, spans, codes_b, spans_b = _case(name)
    if codes_b is None:
        codes_b, spans_b = codes, spans
    w = _twin(codes, sizes, spans, codes_b, spans_b)
    one = np.float32(1e-12)
    for i, ra in enumerate(codes):
        sa = set(ra[ra >= 0].tolist())
        for j, rb in enumerate(codes_b):
            acc = np.float32(0.0)
            for c in rb[rb >= 0]:
                if int(c) in sa:
                    acc = np.float32(acc + sizes[c])
            den = np.float32(np.float32(spans[i] + spans_b[j]) - acc)
            want = np.float32(acc / max(den, one)) if acc > 0 else 0.0
            assert w[i, j] == want, (i, j)


@pytest.mark.parametrize("na,nb,m,F,kind,blocks,param", [
    (217, 217, 1200, 1732, "bitmap", 196, (0, 55)),     # main path
    (4096, 4096, 8, 81920, "merge", 2048, (1, 0)),      # scaling shape
    (300, 300, 9, 9000, "bitmap", 380, (0, 256)),       # rows too long to merge
    (4096, 4096, 8, 1732, "bitmap", 65536, (0, 55)),    # one window suffices
])
def test_plan_at_chip_smoke_shapes(na, nb, m, F, kind, blocks, param):
    p = tov.plan(na, nb, m, m, F)
    assert (p.kind, p.blocks, p.code) == (kind, blocks, param)


def _bad(kind):
    codes = np.array([[0, 3, 5], [1, 2, -1]], np.int32)
    if kind == "code beyond the sizes":
        codes[0, 2] = 6
    elif kind == "pad other than -1":
        codes[1, 2] = -2
    elif kind == "descending row":
        codes[0] = [3, 0, 5]
    elif kind == "repeated code":
        codes[0] = [3, 3, 5]
    elif kind == "code after a pad":
        codes[1] = [1, -1, 2]
    return codes


@pytest.mark.parametrize("kind", ["code beyond the sizes", "pad other than -1",
                                  "descending row", "repeated code",
                                  "code after a pad"])
@pytest.mark.parametrize("side", ["codes", "codes_b"])
def test_contract_check_refuses_bad_rows_before_any_kernel(kind, side,
                                                           monkeypatch):
    good = np.array([[0, 3, 5], [1, 2, -1]], np.int32)
    sizes, spans = np.ones(6, np.float32), np.full(2, 3.0, np.float32)

    def never(*a, **k):
        raise AssertionError("reached a kernel")
    monkeypatch.setattr(tov, "fractional_overlap_matrix_plain", never)
    monkeypatch.setattr(tov, "fractional_overlap_matrix_kernel", never)
    kw = dict(codes_b=_bad(kind), spans_b=spans) if side == "codes_b" else {}
    a = _bad(kind) if side == "codes" else good
    with pytest.raises(ValueError, match=side):
        ops.fractional_overlap_matrix(a, sizes, spans, device="cpu", **kw)
    with pytest.raises(ValueError):
        tov.check_codes(torch.as_tensor(_bad(kind)), 6)
    tov.check_codes(good, 6)
    tov.check_codes(np.full((3, 2), -1, np.int32), 0)

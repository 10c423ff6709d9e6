"""The port's streaming G-PART (``repro_torch.core.stream``) against
``repro``'s, batch by batch on the same seeded query families.

Each case feeds both packages the same stream, each to its own
partitioner, and checks the partitions in order (file sets and rho,
bit for bit) and the lifecycle counters; then the contract
``tests/test_stream.py`` pins for the reference, on the port:

* one batch with an empty prior state is Algorithm 1 (``g_part``);
* compacting after every batch is batch ``g_part`` on the concatenated
  log, bit for bit with float sizes;
* a repeated family routes its rho to the partition that owns it;
* decay ages all rho; a window retires expired batches and, compacted,
  equals batch ``g_part`` on the suffix;
* the drift threshold gates compaction; empty families and batches are
  ignored; invalid parameters are rejected.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import datapart as jdp
from repro.core import stream as jst
from repro_torch.core import datapart as tdp
from repro_torch.core import stream as tst

PKGS = {"j": (jdp, jst), "t": (tdp, tst)}


def _sizes(rng, n_files=12):
    return {f"f{i}": float(rng.uniform(0.5, 2.0)) for i in range(n_files)}


def _batch(rng, n_fams=8, n_files=12, max_k=4):
    out = []
    for _ in range(n_fams):
        k = int(rng.integers(1, max_k + 1))
        files = tuple(f"f{j}" for j in rng.choice(n_files, k, replace=False))
        out.append((files, float(rng.uniform(0.5, 8.0))))
    return out


def _canon(parts):
    return sorted((tuple(sorted(p.files)), round(p.rho, 9)) for p in parts)


def _exact(parts):
    """Partitions in order, files and rho bit for bit."""
    return [(tuple(sorted(p.files)), p.rho) for p in parts]


def _stream(batches, sizes, compact="gated", **kw):
    """Run ``batches`` through each package's partitioner; return
    ``{pkg: (partitioner, [partitions after each batch])}``."""
    out = {}
    for k, (_, st) in PKGS.items():
        sp = st.StreamingPartitioner(dict(sizes), **kw)
        seen = []
        for b in batches:
            sp.ingest(b)
            if compact == "force":
                assert sp.compact(force=True)
            elif compact == "gated":
                sp.compact()
            seen.append(_exact(sp.partitions))
        out[k] = (sp, seen)
    return out


def _same(runs):
    (sj, pj), (st_, pt) = runs["j"], runs["t"]
    assert pt == pj
    assert dataclasses.asdict(st_.stats) == dataclasses.asdict(sj.stats)
    assert st_.total_rho() == sj.total_rho()
    assert st_.drift() == sj.drift()
    assert (st_.n_partitions, st_.n_families) == (sj.n_partitions,
                                                 sj.n_families)


@pytest.mark.parametrize("seed", range(4))
def test_single_batch_ingest_equals_gpart(seed):
    rng = np.random.default_rng(seed)
    sizes = _sizes(rng)
    batch = _batch(rng, 12)
    s_thresh = float(rng.uniform(3, 25))
    runs = _stream([batch], sizes, compact=None, s_thresh=s_thresh)
    _same(runs)
    ref = tdp.g_part(tdp.make_partitions(batch, sizes), s_thresh=s_thresh,
                     device="cpu")
    assert _canon(runs["t"][0].partitions) == _canon(ref)


@pytest.mark.parametrize("seed", range(4))
def test_compact_every_batch_equals_batch_gpart(seed):
    rng = np.random.default_rng(100 + seed)
    sizes = _sizes(rng, 30)
    batches = [_batch(rng, int(rng.integers(3, 10)), 30) for _ in range(4)]
    s_thresh = float(rng.uniform(3, 25))
    runs = _stream(batches, sizes, compact="force", s_thresh=s_thresh)
    _same(runs)
    concat = [qf for b in batches for qf in b]
    ref = tdp.g_part(tdp.make_partitions(concat, sizes), s_thresh=s_thresh,
                     device="cpu")
    assert _canon(runs["t"][0].partitions) == _canon(ref)


@pytest.mark.parametrize("seed", [0, 7, 123, 4567])
def test_gated_stream_matches_repro_and_tracks_batch(seed):
    """Threshold-gated compaction: every batch's partitions and counters
    equal the reference's; rho is conserved and the read-cost objective
    stays within the reference suite's bound of batch ``g_part``."""
    rng = np.random.default_rng(seed)
    sizes = _sizes(rng)
    batches = [_batch(rng) for _ in range(3)]
    runs = _stream(batches, sizes, s_thresh=10.0, drift_threshold=0.35)
    _same(runs)
    sp = runs["t"][0]
    concat = [qf for b in batches for qf in b]
    ref = tdp.g_part(tdp.make_partitions(concat, sizes), s_thresh=10.0,
                     device="cpu")
    assert sp.total_rho() == pytest.approx(sum(r for _, r in concat))
    a, c = tdp.read_cost(sp.partitions), tdp.read_cost(ref)
    assert abs(a - c) <= 0.7 * max(a, c)


def test_repeated_family_routes_rho_to_owner():
    sizes = {"a": 1.0, "b": 1.0, "x": 1.0}
    batches = [[(("a", "b"), 2.0), (("x",), 1.0)], [(("a", "b"), 3.0)]]
    runs = _stream(batches, sizes, compact=None, s_thresh=100.0)
    _same(runs)
    sp, seen = runs["t"]
    assert len(seen[1]) == len(seen[0])
    owner = [p for p in sp.partitions if p.files == frozenset({"a", "b"})]
    assert len(owner) == 1 and owner[0].rho == pytest.approx(5.0)


def test_decay_ages_all_rho():
    sizes = {"a": 1.0, "b": 1.0}
    batches = [[(("a",), 8.0)], [(("b",), 1.0)], []]
    runs = _stream(batches, sizes, compact=None, s_thresh=100.0, decay=0.5)
    _same(runs)
    by_files = {tuple(sorted(p.files)): p.rho
                for p in runs["t"][0].partitions}
    assert by_files == {("a",): 2.0, ("b",): 0.5}


def test_rolling_window_retires_expired_batches():
    sizes = {f"f{i}": 1.0 for i in range(4)}
    batches = [[(("f0",), 1.0)], [(("f1",), 2.0)], [(("f2",), 4.0)]]
    runs = _stream(batches, sizes, compact=None, s_thresh=100.0, window=2,
                   rho_c=np.inf, rho_c_abs=np.inf)
    _same(runs)
    assert runs["t"][0].total_rho() == pytest.approx(6.0)
    for k in PKGS:
        runs[k][0].compact(force=True)
    assert _exact(runs["t"][0].partitions) == _exact(runs["j"][0].partitions)
    cov = set().union(*[p.files for p in runs["t"][0].partitions])
    assert cov == {"f1", "f2"}


@pytest.mark.parametrize("window", [1, 2, 3])
def test_window_equals_batch_on_suffix(window):
    rng = np.random.default_rng(7)
    sizes = _sizes(rng, 20)
    batches = [_batch(rng, 6, 20) for _ in range(5)]
    runs = _stream(batches, sizes, compact=None, s_thresh=12.0,
                   window=window)
    _same(runs)
    for k in PKGS:
        runs[k][0].compact(force=True)
    sp = runs["t"][0]
    assert _exact(sp.partitions) == _exact(runs["j"][0].partitions)
    suffix = [qf for b in batches[-window:] for qf in b]
    ref = tdp.g_part(tdp.make_partitions(suffix, sizes), s_thresh=12.0,
                     device="cpu")
    assert sp.total_rho() == pytest.approx(sum(r for _, r in suffix))
    assert tdp.read_cost(sp.partitions) == pytest.approx(
        tdp.read_cost(ref), rel=1e-9)


def test_compact_gated_by_drift_threshold():
    sizes = {f"f{i}": 1.0 for i in range(8)}
    sps = {k: st.StreamingPartitioner(sizes, s_thresh=100.0,
                                      drift_threshold=0.5)
           for k, (_, st) in PKGS.items()}
    steps = [([((f"f{i}",), 4.0) for i in range(4)], True),
             ([(("f4",), 1.0)], False), ([(("f5",), 40.0)], False)]
    for batch, force in steps:
        ran = {}
        for k, sp in sps.items():
            sp.ingest(batch)
            ran[k] = (sp.drift(), sp.compact(force=force))
        assert ran["t"] == ran["j"]
    assert sps["t"].stats.n_compactions == 2
    assert _exact(sps["t"].partitions) == _exact(sps["j"].partitions)


def test_empty_families_and_batches_are_ignored():
    batches = [[((), 5.0)], [], [(("a",), 1.0)]]
    runs = _stream(batches, {"a": 1.0}, compact=None, s_thresh=10.0)
    _same(runs)
    assert [len(s) for s in runs["t"][1]] == [0, 0, 1]


@pytest.mark.parametrize("kw", [dict(decay=0.0), dict(decay=1.5),
                                dict(window=0)])
def test_invalid_params_rejected(kw):
    for _, st in PKGS.values():
        with pytest.raises(ValueError):
            st.StreamingPartitioner({"a": 1.0}, s_thresh=1.0, **kw)


def test_compact_equals_batch_bitwise_float_sizes():
    rng = np.random.default_rng(17)
    files = [f"t/{i}" for i in range(60)]
    sizes = {f: float(rng.random() * 5 + 0.1) for f in files}
    log, batches = [], []
    for _ in range(5):
        batch = [(tuple(rng.choice(files, size=int(rng.integers(2, 6)),
                                   replace=False)),
                  float(rng.random() * 9 + 0.5)) for _ in range(10)]
        batches.append(batch)
        log.extend(batch)
    spans = [tdp.FileSizes(sizes).span(frozenset(f)) for f, _ in log]
    s_thresh = 3.0 * float(np.median(spans))
    runs = _stream(batches, sizes, compact="force", s_thresh=s_thresh)
    _same(runs)
    ref = tdp.g_part(tdp.make_partitions(log, sizes), s_thresh=s_thresh,
                     device="cpu")
    assert sorted(_exact(runs["t"][0].partitions)) == sorted(_exact(ref))


def test_occurrence_keys_match_repro():
    """Duplicated file sets get occurrence indices in plan order."""
    sizes = {"a": 1.0, "b": 2.0, "c": 3.0}
    fams = [(("a", "b"), 1.0), (("c",), 2.0), (("a", "b"), 3.0),
            (("b", "a"), 4.0)]
    keys = {k: st.occurrence_keys([dp.Partition(frozenset(f), r,
                                                dp.FileSizes(sizes))
                                   for f, r in fams])
            for k, (dp, st) in PKGS.items()}
    assert keys["t"] == keys["j"]
    assert [c for _, c in keys["t"]] == [0, 0, 1, 2]

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SCOPe once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its lines; any failure raises and the script exits
non-zero (with no result line):

1. device   the card's name and count, and ``nvidia-smi``'s name and power
            limit; no card is a failure.
2. build    both kernels from ``src/repro_torch/kernels/csrc`` with nvcc
            (``-Xptxas -v`` register/shared-memory lines, build seconds).
3. main     TPC-H SF0.1 (600,000 lineitem rows, 440 queries, 500 rows per
            file), an SVR COMPREDICT predictor fitted on 80 query samples,
            and three ``paper_variants`` rows on ``device="cuda"`` with
            ``partition_backend="device"`` and ``feature_backend="device"``:
            Default, SCOPe without capacities (greedy solver) and SCOPe
            total-cost focused (capacitated solver). Launch counts are zeroed
            just before and read just after; both kernels must have run.
4. cpu      the same path with ``device="cpu"`` (plain tensor versions):
            identical G-PART partitions, identical Default and greedy plans,
            capacitated cents within rel 1e-6; a second CUDA run of the
            capacitated plan identical to the first; the capacitated solver
            again with capacities that bind, on the card and on the CPU.
5. kernels  each kernel against its plain version on the card, at the
            shapes the main path gave it (recorded during phase 3) plus
            edge cases: K1 abs error <= 1e-5 and an identical ``w > 0``
            pattern; K2 normwise relative error against a float64 plain
            evaluation <= 1e-5 and at most twice the float32 plain version's
            (floored at float32's epsilon, 1.2e-7). Then each kernel's time
            (CUDA events, warm-up first), the plain version's time and the
            bound (bytes at 3.35 TB/s against float32 operations at 67
            TFLOP/s, the H100 SXM data-sheet rates). The bytes are those the
            function needs: the valid codes, not the rows' padding, each
            length or size that is used, and the outputs; each count is
            printed beside its bound.

The script takes no arguments: the size is fixed at SF0.1. The last three
lines are the kernel JSON line, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SCALE_ROWS = 600_000               # TPC-H SF0.1 lineitem rows (SF1 = 6,000,000)
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_OPS_PER_S = 67e12              # H100 SXM float32, outside tensor cores
VARIANTS = ("Default (store on premium)", "SCOPe (No capacity constraint)",
            "SCOPe (Total cost focused)")
CARD = "cuda"                      # the device the main path runs on
SOURCES = {"overlap": ("src/repro_torch/kernels/csrc/overlap.cu",
                       "src/repro/kernels/overlap.py:137"),
           "entropy_features": ("src/repro_torch/kernels/csrc/entropy_features.cu",
                                "src/repro/kernels/entropy_features.py:183")}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ------------------------------------------------------------------ helpers
def cuda_ms(fn, torch, warmup: int = 3, iters: int = 20) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls,
    between two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def canon(parts):
    return sorted((tuple(sorted(p.files)), round(p.rho, 9)) for p in parts)


def gpart_instance(dp, n_fams: int, n_files: int, seed: int = 0):
    """Contiguous-window query families over a shared file universe (the
    generator of the repository's G-PART scaling benchmark)."""
    rng = np.random.default_rng(seed)
    sizes = {f"s{i}": float(rng.uniform(0.5, 2.0)) for i in range(n_files)}
    w = rng.integers(2, 9, n_fams)
    lo = rng.integers(0, n_files - 9, n_fams)
    qf = [(tuple(f"s{j}" for j in range(lo[k], lo[k] + w[k])),
           float(rng.uniform(0.5, 8.0))) for k in range(n_fams)]
    return dp.make_partitions(qf, sizes)


# ------------------------------------------------------------------- phases
def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import describe
    device = describe(CARD)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    say("device", f"{device['kind']} x{device['count']} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | nvidia-smi: "
        f"{smi_line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device, smi_line


def phase_build(build):
    t0 = time.perf_counter()
    secs = build.build()
    for name in build.SOURCES:
        for line in build.build_log.get(name, "").splitlines():
            if "ptxas info" in line and ("registers" in line
                                         or "Compiling" in line):
                say("build", f"{name}: {line.strip()}")
        say("build", f"{name}: nvcc {secs[name]:.1f} s")
    say("build", f"both kernels built in {time.perf_counter() - t0:.1f} s "
        f"(parallel nvcc)")


def make_inputs():
    from repro_torch.core.compredict import CompressionPredictor, query_samples
    from repro_torch.data import tpch
    t0 = time.perf_counter()
    db = tpch.generate(scale_rows=SCALE_ROWS, seed=SEED)
    qs = tpch.generate_queries(db, n_per_template=20, seed=SEED + 1,
                               rows_per_file=500)
    parts, rows = tpch.partitions_from_queries(db, qs, rows_per_file=500)
    t1 = time.perf_counter()
    pred = CompressionPredictor(model_name="SVR").fit(
        query_samples(qs, db.tables, max_rows=6000)[:80], layouts=("col",))
    t2 = time.perf_counter()
    total_gb = sum(p.span for p in parts) / 1e9
    say("main", f"TPC-H scale_rows={SCALE_ROWS:,}: {len(qs)} queries, "
        f"{len(parts)} query-family partitions over {len(rows):,} files, "
        f"{total_gb:.4f} GB of family spans; data {t1 - t0:.1f} s, "
        f"predictor fit {t2 - t1:.1f} s")
    return parts, rows, pred, total_gb


def run_variant(engine_cls, table, cfg, parts, rows, torch):
    """One engine run, stage by stage, each stage timed on the host clock
    ending in ``torch.cuda.synchronize()``."""
    eng = engine_cls(table, cfg)
    secs = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    data = timed("partition", eng.partition, parts, rows)
    problem = timed("compress", eng.compress, data, table)
    assignment = timed("assign", eng.assign, problem)
    report = timed("billing", eng.billing, problem, assignment)
    return problem, assignment, report, secs


def plan_line(name, problem, report, secs):
    stage = " ".join(f"{k} {v:.2f}s" for k, v in secs.items())
    return (f"{name}: {report.n_partitions} partitions "
            f"({problem.spans_gb.sum() * 1e3:.1f} MB serialised), tiers "
            f"{report.tiering_scheme}, total {report.total_cents!r} cents, "
            f"feasible {report.assignment.feasible} | {stage}")


def phase_main(torch, parts, rows, pred, total_gb, recorded):
    from repro_torch.core import optassign
    from repro_torch.core.costs import azure_table
    from repro_torch.core.engine import PlacementEngine
    from repro_torch.core.scope import paper_variants
    from repro_torch.kernels import ops

    cap = np.array([0.163, 0.326, 0.4891, np.inf]) * total_gb * 3.0
    table = azure_table()
    variants = paper_variants(cap)
    cfgs = {n: dataclasses.replace(variants[n], predictor=pred,
                                   partition_backend="device",
                                   feature_backend="device", device=CARD)
            for n in VARIANTS}
    scans = []
    scan = optassign._lagrangian_scan
    optassign._lagrangian_scan = lambda *a: scans.append(1) or scan(*a)
    orig = {n: getattr(ops, n) for n in ("fractional_overlap_matrix",
                                         "weighted_entropy_features")}

    def recorder(name):
        def wrapped(*a, **k):
            recorded.setdefault(name, []).append((a, k))
            return orig[name](*a, **k)
        return wrapped

    for n in orig:
        setattr(ops, n, recorder(n))
    ops.reset_launch_counts()
    cuda_runs = {}
    try:
        for n in VARIANTS:
            cuda_runs[n] = run_variant(PlacementEngine, table, cfgs[n], parts,
                                       rows, torch)
        launches = dict(ops.launch_counts)
    finally:
        for n, fn in orig.items():
            setattr(ops, n, fn)
        optassign._lagrangian_scan = scan
    for n in VARIANTS:
        say("main", "cuda " + plan_line(n, *cuda_runs[n][::2],
                                        cuda_runs[n][3]))
    saving = 1.0 - (cuda_runs[VARIANTS[2]][2].total_cents
                    / cuda_runs[VARIANTS[0]][2].total_cents)
    say("main", f"SCOPe (total cost focused) saves {100 * saving:.2f}% "
        f"against Default; capacitated dual ascent ran {len(scans)} time(s) "
        f"(0 when the unconstrained optimum already fits)")
    say("main", f"launches in the main path: {launches}")
    for k in SOURCES:
        check(launches.get(k, 0) > 0, f"kernel {k} was not launched by the "
              f"main path")
    return table, cfgs, cuda_runs, launches


def phase_cpu(torch, parts, rows, table, cfgs, cuda_runs):
    from repro_torch.core import optassign
    from repro_torch.core.engine import AssignStage, PlacementEngine

    cpu_runs = {}
    for n in VARIANTS:
        cfg = dataclasses.replace(cfgs[n], device="cpu")
        cpu_runs[n] = run_variant(PlacementEngine, table, cfg, parts, rows,
                                  torch)
        say("cpu", "cpu  " + plan_line(n, *cpu_runs[n][::2], cpu_runs[n][3]))
    for n in VARIANTS[1:]:
        check(canon(cuda_runs[n][0].partitions)
              == canon(cpu_runs[n][0].partitions),
              f"{n}: G-PART partitions differ between cuda and cpu")
    for n in VARIANTS[:2]:
        a, b = cuda_runs[n][1], cpu_runs[n][1]
        check(np.array_equal(a.tier, b.tier)
              and np.array_equal(a.scheme, b.scheme),
              f"{n}: cuda and cpu plans differ")
    ca, cb = cuda_runs[VARIANTS[2]][2], cpu_runs[VARIANTS[2]][2]
    rel = abs(ca.total_cents - cb.total_cents) / abs(cb.total_cents)
    check(rel <= 1e-6, f"capacitated cents differ by rel {rel}")
    again = run_variant(PlacementEngine, table, cfgs[VARIANTS[2]], parts,
                        rows, torch)
    a, b = cuda_runs[VARIANTS[2]][1], again[1]
    check(np.array_equal(a.tier, b.tier) and np.array_equal(a.scheme, b.scheme)
          and again[2].total_cents == ca.total_cents,
          "second cuda run of the capacitated plan differs from the first")
    say("cpu", f"partitions identical; Default and greedy plans identical; "
        f"capacitated cents rel diff {rel:.3e}; second cuda run identical")

    # capacities that bind: 85% of what the unconstrained optimum uses
    problem = cuda_runs[VARIANTS[2]][0]
    g = optassign.greedy_assign(*AssignStage(table, cfgs[VARIANTS[2]])
                                .cost_and_feasibility(problem), device=CARD)
    use = optassign._chosen_usage(problem.stored_matrix(), g.tier, g.scheme)
    cap = np.asarray(cfgs[VARIANTS[2]].capacity_gb, float)
    tight = np.where(np.isfinite(cap) & (use > 0), 0.85 * use, cap)
    scans = []
    scan = optassign._lagrangian_scan
    optassign._lagrangian_scan = lambda *a: scans.append(1) or scan(*a)
    try:
        out = {d: AssignStage(table, dataclasses.replace(
            cfgs[VARIANTS[2]], capacity_gb=tight, device=d))(problem)
            for d in (CARD, "cpu")}
    finally:
        optassign._lagrangian_scan = scan
    check(len(scans) == 2, "the binding capacities did not reach the scan")
    rel = abs(out[CARD].cost - out["cpu"].cost) / abs(out["cpu"].cost)
    check(out[CARD].feasible == out["cpu"].feasible and rel <= 1e-6,
          f"binding-capacity solve differs: rel {rel}")
    say("cpu", f"binding capacities {np.round(tight, 6).tolist()} GB: dual "
        f"ascent on cuda and cpu, feasible {out[CARD].feasible}, "
        f"objective rel diff {rel:.3e}")


def _normwise(x, ref) -> float:
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _counts(need) -> str:
    return (f"{sum(need.values()):,} = "
            + " + ".join(f"{k} {v:,}" for k, v in need.items()))


def _k2_needed(t, n_buckets: int):
    """Bytes the weighted-entropy function needs for inputs ``t`` (the
    codes inside ``n_valid``, the length of each value that occurs, the
    three per-partition counts and the outputs), and the number of
    (partition, value) pairs that occur (of values, for a shared
    vocabulary)."""
    import torch
    codes, n_valid, _, _, lengths = t
    N, M = codes.shape
    V = lengths.shape[-1]
    nv = n_valid.clamp(0, M).tolist()
    rows = [codes[i, :n] for i, n in enumerate(nv)]
    rows = [r[(r >= 0) & (r < V)] for r in rows]
    if lengths.dim() == 2:
        distinct = sum(int(torch.unique(r).numel()) for r in rows)
    else:
        distinct = int(torch.unique(torch.cat(rows)).numel())
    need = {"codes": 4 * sum(nv), "lengths": 4 * distinct,
            "counts": 3 * 4 * N, "outputs": 4 * N * (4 + n_buckets)}
    return need, distinct


def phase_kernels(torch, recorded, launches):
    from repro_torch.core import datapart as dp
    from repro_torch.kernels import entropy_features as ef
    from repro_torch.kernels import overlap as ov

    dev = torch.device(CARD)
    rows = []

    # ---- K1: the main path's matrix, then the scaling benchmark's shape
    (args, kw), = recorded["fractional_overlap_matrix"][:1]
    codes, sizes, spans = (np.asarray(a) for a in args)
    big = dp.PartitionIndex.from_partitions(
        gpart_instance(dp, 4096, 4096 * 20)).padded_codes()
    k1 = {}
    for tag, (c, s, sp) in (("main", (codes, sizes, spans)), ("4096x81920", big)):
        t = [torch.as_tensor(c, dtype=torch.int32, device=dev),
             torch.as_tensor(s, dtype=torch.float32, device=dev),
             torch.as_tensor(sp, dtype=torch.float32, device=dev)]
        w_k = ov.fractional_overlap_matrix_kernel(*t)
        w_p = ov.fractional_overlap_matrix_plain(*t)
        torch.cuda.synchronize()
        err = float((w_k - w_p).abs().max())
        rel = float(((w_k - w_p).abs() / w_p.abs().clamp_min(1e-30))
                    [w_p > 0].max()) if bool((w_p > 0).any()) else 0.0
        same = bool(torch.equal(w_k > 0, w_p > 0))
        check(err <= 1e-5 and same, f"K1 {tag}: max abs err {err}, "
              f"identical w>0 pattern {same}")
        ms = cuda_ms(lambda: ov.fractional_overlap_matrix_kernel(*t), torch)
        plain = cuda_ms(lambda: ov.fractional_overlap_matrix_plain(*t), torch)
        # the wrapper's work around the launch: range check and row sort
        glue = cuda_ms(lambda: (int(t[0].max()), ov._sorted_rows(t[0]),
                                ov._sorted_rows(t[0])[0].T.contiguous()),
                       torch)
        n = int(c.shape[0])
        per_code = np.bincount(c[c >= 0], minlength=s.shape[0]).astype(float)
        n_ops = float((per_code ** 2).sum()) + 4.0 * n * n
        # bytes the function needs: the valid codes (A and B are one
        # input), every file size, the spans and the (N, N) output
        need = {"codes": 4 * int((c >= 0).sum()), "sizes": s.nbytes,
                "spans": sp.nbytes, "output": 4 * n * n}
        n_bytes = float(sum(need.values()))
        b, by = bound_ms(n_bytes, n_ops)
        say("kernels", f"K1 overlap {tag}: codes {tuple(c.shape)}, F="
            f"{s.shape[0]}: max abs err {err:.3e}, max rel err {rel:.3e}, "
            f"w>0 identical; kernel {ms:.4f} ms (of which wrapper glue "
            f"{glue:.4f} ms), plain {plain:.4f} ms, bound {b:.5f} ms ({by}; "
            f"{_counts(need)} bytes, {n_ops:.0f} ops)")
        k1[tag] = (err, ms, plain, b, by)

    # ---- K2: the main path's three dtype classes, then edge cases
    # the first feature pass of the main path: one call per dtype class
    main_calls = recorded["weighted_entropy_features"][:3]
    rng = np.random.default_rng(7)
    ragged = np.full((3, 50), -1, np.int32)
    nv = np.array([50, 17, 3], np.int32)
    for i in range(3):
        ragged[i, :nv[i]] = rng.integers(0, 11, nv[i])
    edge = {
        "ragged": (ragged, nv, nv // np.array([2, 1, 3]),
                   np.array([2, 1, 3], np.int32),
                   rng.integers(1, 9, (3, 11)).astype(np.float32)),
        "empty class": (np.full((2, 1), -1, np.int32), np.zeros(2, np.int32),
                        np.array([9, 4], np.int32), np.zeros(2, np.int32),
                        np.zeros((2, 1), np.float32)),
        "constant": (np.zeros((2, 40), np.int32), np.array([40, 12], np.int32),
                     np.array([20, 6], np.int32), np.array([2, 2], np.int32),
                     np.full((2, 1), 3.0, np.float32)),
    }
    cases = [(f"main class {i}", a) for i, (a, _) in enumerate(main_calls)]
    cases += list(edge.items())
    k2_err, k2_ms, k2_plain, k2_bytes, k2_ops = 0.0, 0.0, 0.0, 0.0, 0.0
    for tag, a in cases:
        t = [torch.as_tensor(np.asarray(x), dtype=dt, device=dev).contiguous()
             for x, dt in zip(a, (torch.int32,) * 4 + (torch.float32,))]
        for nb in (1, 5):
            s_k, b_k = ef.weighted_entropy_features_kernel(*t, n_buckets=nb)
            s_p, b_p = ef.weighted_entropy_features_plain(*t, n_buckets=nb)
            s_d, b_d = ef.weighted_entropy_features_plain(
                *t, n_buckets=nb, dtype=torch.float64)
            torch.cuda.synchronize()
            worst = []
            for x, p, r in ((s_k, s_p, s_d), (b_k, b_p, b_d)):
                kr, pr = _normwise(x.double(), r), _normwise(p.double(), r)
                worst.append((kr, pr, float((x.double() - r).abs().max())))
                check(kr <= 1e-5 and kr <= max(2 * pr, 1.2e-7),
                      f"K2 {tag} nb={nb}: kernel rel err {kr:.3e}, f32 plain "
                      f"rel err {pr:.3e}")
            kr = max(w[0] for w in worst)
            pr = max(w[1] for w in worst)
            err = max(w[2] for w in worst)
            line = (f"K2 entropy {tag} nb={nb}: codes {tuple(t[0].shape)}, "
                    f"V={t[4].shape[-1]}: max abs err {err:.3e}, rel err "
                    f"{kr:.3e} (f32 plain {pr:.3e})")
            if tag.startswith("main") and nb == 1:
                k2_err = max(k2_err, err)
                ms = cuda_ms(lambda: ef.weighted_entropy_features_kernel(
                    *t, n_buckets=1), torch, iters=10)
                plain = cuda_ms(lambda: ef.weighted_entropy_features_plain(
                    *t, n_buckets=1), torch, iters=5)
                need, distinct = _k2_needed(t, n_buckets=1)
                n_bytes = float(sum(need.values()))
                # ~21 float32 operations per distinct value (summary and
                # bucket terms, the log counted as one)
                n_ops = 21.0 * distinct
                b, by = bound_ms(n_bytes, n_ops)
                k2_ms, k2_plain = k2_ms + ms, k2_plain + plain
                k2_bytes, k2_ops = k2_bytes + n_bytes, k2_ops + n_ops
                line += (f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                         f"{b:.5f} ms ({by}; {_counts(need)} bytes, "
                         f"{n_ops:.0f} ops)")
            say("kernels", line)
    b2, by2 = bound_ms(k2_bytes, k2_ops)
    say("kernels", f"K2 over the three classes of one feature pass: kernel "
        f"{k2_ms:.4f} ms, plain {k2_plain:.4f} ms, bound {b2:.5f} ms ({by2}; "
        f"{k2_bytes:.0f} bytes, {k2_ops:.0f} ops)")
    err1, ms1, plain1, b1, by1 = k1["main"]
    for name, err, ms, plain, b, by in (
            ("overlap", err1, ms1, plain1, b1, by1),
            ("entropy_features", k2_err, k2_ms, k2_plain, b2, by2)):
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCES[name][0], "replaces": SOURCES[name][1],
                     "launches": int(launches.get(name, 0)),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by, "library_ms": None})
    return rows


def main() -> int:
    import torch
    device, smi_line = phase_device(torch)
    # always build from the sources: a fresh build directory
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "chip_smoke")
    shutil.rmtree(os.environ["REPRO_TORCH_BUILD_DIR"], ignore_errors=True)
    from repro_torch.kernels import _build
    phase_build(_build)

    say("main", f"reduced: scale_rows 6,000,000 -> {SCALE_ROWS:,} "
        f"(host-side string encoding time)")
    parts, rows, pred, total_gb = make_inputs()
    recorded = {}
    table, cfgs, cuda_runs, launches = phase_main(
        torch, parts, rows, pred, total_gb, recorded)
    phase_cpu(torch, parts, rows, table, cfgs, cuda_runs)
    kernels = phase_kernels(torch, recorded, launches)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

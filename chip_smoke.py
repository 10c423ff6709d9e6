#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU: SCOPe's placement
path and its re-optimization under drift, zamba2-2.7b serving and
zamba2-2.7b training.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its lines; any failure raises and the script exits
non-zero (with no result line):

1. device   the card's name and count, and ``nvidia-smi``'s name and power
            limit; no card is a failure.
2. build    all seven kernels from ``src/repro_torch/kernels/csrc``, one
            nvcc per source, all started together (``-Xptxas -v``
            register/shared-memory lines, build seconds); K6's split kernel
            at the serve loop's cache (registers, shared memory, stages,
            splits) and K2's cluster kernel at a replicated and a
            distributed plan (registers, shared memory, cluster size and
            the clusters that fit on the card at once).
3. main     TPC-H SF0.1 (600,000 lineitem rows, 440 queries, 500 rows per
            file), an SVR COMPREDICT predictor fitted on 80 query samples,
            and three ``paper_variants`` rows on ``device="cuda"`` with
            ``partition_backend="device"`` and ``feature_backend="device"``:
            Default, SCOPe without capacities (greedy solver) and SCOPe
            total-cost focused (capacitated solver). Launch counts are zeroed
            just before and read just after; K1 and K2 must have run.
4. cpu      the same path with ``device="cpu"`` (plain tensor versions):
            identical G-PART partitions, identical Default and greedy plans,
            capacitated cents within rel 1e-6; a second CUDA run of the
            capacitated plan identical to the first; the capacitated solver
            again with capacities that bind, on the card and on the CPU.
8. reopt    runs after phase 4, on its plans. (1) Phase main's greedy and
            capacitated plans drift (``benchmarks/bench_reoptimize.py``'s
            recipe, seed 0: 10% of partitions x20-100, 10% /20-100);
            ``compredict_rd_fn`` re-predicts the drifted partitions on
            the card (K2 must launch: counts zeroed before, read after;
            ratios equal the plan's within rel 1e-5), then
            ``reoptimize(months_held=0.25)`` on cuda and cpu from the same
            problem: identical moves, tiers and schemes, cents within rel
            1e-6. The greedy migration is mirrored into the port's
            ``TieredStore`` (the moved partitions and the smallest unmoved
            one, real payloads, the plan's ratios set to the stored bytes):
            metered transfer and early delete equal the plan's within rel
            1e-9. (2) ``budgeted_moves`` (greedy path) on those candidates
            at half their spend, and on 100,000 seeded synthetic
            candidates with a cents cap and a GB cap that both bind:
            identical masks on cuda and cpu, each timed. (3) AWS + GCP +
            Azure (``big3_table``, 12 tiers, schemes none/lz4/zstd), N
            2,000 (the recipe's largest): uncapped, Azure capped at half its
            uncapped footprint (provider group rows in the dual ascent),
            each provider alone (the cross-provider plan never costlier),
            a drift, and 3 copies for the hottest 10% (every copy on its
            own provider), each on cuda and cpu: identical tiers, schemes,
            ``provider_scheme`` and copies, cents within rel 1e-6; 120
            partitions of real payloads at a 0.5 c/GB interconnect
            mirrored into the store: metered egress equals the plan's. (4)
            On the card only: a capacitated cross-provider solve and a
            ``reoptimize`` at N 16,000 (the host's 1-swap local search grows
            as N squared: N 100,000 would take tens of minutes), then a
            greedy cross-provider solve and ``reoptimize`` at N 100,000;
            seconds per stage, the dual ascent's device time
            (torch.profiler), peak device memory. (5) ``MLP(hidden=(64,
            64), epochs=500)`` on the 80 labelled samples of phase main
            (zlib-6 ratios), from one initial parameter set on cuda and
            cpu: predictions within rel 1e-4 of the largest (the bar of
            ``tests/test_torch_ml.py``); the fit time on the card. Its
            lines end with the card's name and power limit.
6. serve    zamba2-2.7b at full width and depth (54 Mamba2 layers, one
            shared attention block used 9 times), bfloat16, random weights
            from ``torch.Generator(device="cuda").manual_seed(0)``, 4 random
            prompts of 512 tokens. Prefill (``make_prefill_step``) must
            launch K5 exactly 9 and K7 exactly 54 times, all through their
            tensor-core route (``bf16_tc``). The serve loop of
            ``repro_torch.launch.serve`` feeds the 512 prompt tokens one per
            step and takes 32 greedy steps (33 tokens out): K6 must launch
            9 x 544 times. torch.profiler then reads the card's busy
            share over 4 decode steps and one prefill. Checks, each with
            its tolerance printed: in float32 (the same weights cast), the
            prefill with the kernels against the prefill with their plain
            versions, and 64 decode steps against the prefill's first 64
            positions, both within 1e-3; in bfloat16, the prefill's
            last-position logits against the decode loop's at the same
            position and the kernel prefill against the plain one, within
            0.15 (bf16 noise over 63 blocks; see TOL_BF16); greedy tokens
            of kernel and plain prefills identical except where the plain
            logits of the two picks lie within twice the logits' error.
            This phase runs before phase 5, which uses the shapes it saw.
7. train    zamba2-2.7b at full width and depth, bfloat16, random weights
            from seed 0, ``TrainConfig(remat=True, compressed_grads=True)``
            with default AdamW; 16 Zipf token shards of 32 x 513 in the
            port's ``TieredStore``, ``TieredDataLoader`` batch 4 x 512; 5
            steps through ``repro_torch.launch.train.train``, counts zeroed
            before and read after each: K5 exactly 18, K7 exactly 108
            (forward and remat's recompute, all through ``bf16_tc``) and K3
            exactly 95 (one per leaf) per step, every loss finite. Then
            torch.profiler over one step (busy share, device time in K3, K5, K7); every gradient
            finite and non-zero for each leaf reached only through K5 or
            K7; a step with K3 held against its plain version on every
            leaf (identical int8 and scales) and error feedback
            ``deq + err_new`` against ``g + err_old`` (1e-6); in float32
            with the stages cut to one repeat unit, the loss and gradients
            through the kernels against those through the plain versions
            (rel 1e-4 and normwise 1e-3). Runs after phase 6, before 5.
5. kernels  each kernel against its plain version on the card, at the
            shapes the main and serve paths gave it (recorded during phases
            3 and 6) plus edge cases, K5 and K7 through both routes
            (float32: ``f32``, bfloat16: ``bf16_tc``, each call's route
            counted): K1 abs error <= 1e-5 and an identical
            ``w > 0`` pattern, bit-identical to its twin
            ``fractional_overlap_matrix_ordered`` on the card and to a
            second call, at the main path's matrix and at 4,096 families
            over 81,920 files, one CUDA launch a call and no host sync; K2 normwise relative error against a float64
            plain evaluation <= 1e-5 and at most twice the float32 plain
            version's (floored at float32's epsilon, 1.2e-7); K5 and K6 the
            JAX suite's tolerances (2e-5 in float32, 2e-2 in bfloat16), K7
            1e-4 in float32 (2e-2 for bfloat16 outputs). Then each kernel's
            time (CUDA events, warm-up first), the plain version's time, one
            PyTorch library call's time where one computes the same function
            (``scaled_dot_product_attention`` for K5 and K6); for K5 and K7
            also their device time from torch.profiler (without the host's
            time between calls), the share of the bound reached and K5's
            ratio to the library call; the same for K6 (and its library
            call) at the last serve step (kv_len 544) and at kv_len 64 and
            272 in that cache, and K2's device time per main-path class; K2 and
            K6 give identical bits on a second call, K6 exactly 0 where
            kv_len is 0 and within tolerance of the plain version on every
            row; K1, K3 and K4 also their device time, K1 and K4 their
            host time per call (the wrapper and its launch); and the bound:
            the bytes the function needs at 3.35 TB/s against its operations
            at the H100 SXM data-sheet rate for the inputs' type (67 TFLOP/s
            float32, 989 TFLOP/s bfloat16); each count is printed beside its
            bound. K3 at the training step's largest leaf and at
            1024 x 1024, plus the JAX suite's shapes, a zero block and .5
            ties (identical int8 and scales); K4 at 1 and 4 MiB of random
            bytes and a 4 MiB slice of the trained parameters, plus n = 1,
            n < block, ragged n, an unaligned start, a constant payload
            (exactly 0.0) and 2-, 4- and 256-symbol alphabets (identical
            histograms, entropy within rel 1e-5, identical bits on a second
            call), one CUDA launch a call and no host sync.

The script takes no arguments: the sizes are fixed. The last three lines
are the kernel JSON line, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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
BF16_OPS_PER_S = 989e12            # H100 SXM bfloat16 tensor cores, dense
ARCH = "zamba2-2.7b"
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 512, 32   # 33 tokens out
VARIANTS = ("Default (store on premium)", "SCOPe (No capacity constraint)",
            "SCOPe (Total cost focused)")
CARD = "cuda"                      # the device the main path runs on
SOURCES = {"overlap": ("src/repro_torch/kernels/csrc/overlap.cu",
                       "src/repro/kernels/overlap.py:137"),
           "entropy_features": ("src/repro_torch/kernels/csrc/entropy_features.cu",
                                "src/repro/kernels/entropy_features.py:183"),
           "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:103"),
           "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:84"),
           "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan.py:97"),
           "quant_pack": ("src/repro_torch/kernels/csrc/quant_pack.cu",
                          "src/repro/kernels/quant_pack.py:39"),
           "byte_entropy": ("src/repro_torch/kernels/csrc/byte_entropy.cu",
                            "src/repro/kernels/entropy_features.py:73")}


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


def device_ms(fn, torch, iters: int = 20):
    """(milliseconds of device time per call of ``fn``, {device operation:
    ms per call}) from torch.profiler over ``iters`` calls after one
    warm-up: the kernels alone, without the host's time between them;
    (None, {}) when the trace holds no device time. Each operation's time
    is its mean over the records the trace holds, times the records per
    call (at least one): a long run can lose records, and that mean does
    not move with them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total[e.name] = total.get(e.name, 0.0) + e.device_time_total / 1e3
            count[e.name] = count.get(e.name, 0) + 1
    by = {k: total[k] / count[k] * max(1, round(count[k] / iters))
          for k in total}
    return (sum(by.values()) if by else None), by


#: the host's CUDA runtime calls that put an operation on the card
LAUNCH_CALLS = ("cudaLaunch", "cudaMemset", "cudaMemcpy")


def launches_per_call(fn, torch, iters: int = 5) -> float:
    """Operations on the card (kernels, memsets, copies) per call of
    ``fn``, from torch.profiler over ``iters`` calls after one warm-up: the
    larger of the device records and the host's launch, memset and copy
    calls (a long run can lose device records)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    on_card = sum(e.device_type == torch.autograd.DeviceType.CUDA
                  for e in prof.events())
    calls = sum(e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith(LAUNCH_CALLS) for e in prof.events())
    return max(on_card, calls) / iters


def host_ms(fn, torch, iters: int = 200) -> float:
    """Milliseconds of host time per call of ``fn`` to enqueue its work
    (the wrapper and its launches), over ``iters`` calls back to back that
    do not wait for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return t


def no_sync(fn, torch):
    """``fn()`` with torch's sync debug mode at "error": it raises if the
    call makes the host wait for the card."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _short(by) -> str:
    return "; ".join(f"{k.split('(')[0].replace('void ', '')} {v:.4f} ms"
                     for k, v in by.items())


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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
        # one line per kernel: its registers and spills (-Xptxas -v)
        fn, spill = None, ""
        for line in build.build_log.get(name, "").splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn, spill = m.group(1), ""
            if "spill" in line:
                spill = line.strip()
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                say("build", f"{name}: {fn}: {m.group(1)} registers; {spill}")
                fn = None
        say("build", f"{name}: nvcc {secs[name]:.1f} s")
    say("build", f"{len(build.SOURCES)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s (parallel nvcc)")
    # K6 at the serve loop's cache (phase serve), K2 at one vocabulary of
    # each plan: its registers, shared memory and cluster, from the library
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import entropy_features as ef
    cfg = get_config(ARCH)
    S = SERVE_PROMPT + SERVE_STEPS + 2
    i6 = da.decode_attention_info(S, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, cfg.head_dim,
                                  torch.bfloat16, B=SERVE_BATCH)
    say("build", f"decode_attention split kernel at the serve cache (B "
        f"{SERVE_BATCH}, S {S}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, bf16): {i6['registers']} registers, "
        f"{i6['smem_bytes']:,} bytes of shared memory per block, "
        f"{i6['stages']} stage(s) a warp; splits of {i6['split']} keys, "
        f"{i6['splits']} splits, plus one merge launch")
    # the main path's class 2 and class 1 shapes (V values, M codes)
    for V, M in ((15_005, 1_200_000), (583_182, 1_800_000)):
        i2 = ef.weighted_entropy_features_info(V, M=M)
        say("build", f"entropy_features at V {V:,}, M {M:,}, one bucket: "
            f"{'replicated' if i2['replicated'] else 'distributed'} plan, "
            f"{i2['slices']} slice(s) of {i2['span']:,} values; cluster of "
            f"{i2['cluster']} blocks ({i2['max_active_clusters']} such "
            f"clusters fit on the card at once), {i2['registers']} registers, "
            f"{i2['smem_bytes']:,} bytes of shared memory per block")


def make_inputs():
    from repro_torch.core.compredict import CompressionPredictor, query_samples
    from repro_torch.data import tpch
    t0 = time.perf_counter()
    db = tpch.generate(scale_rows=SCALE_ROWS, seed=SEED)
    qs = tpch.generate_queries(db, n_per_template=20, seed=SEED + 1,
                               rows_per_file=500)
    parts, rows = tpch.partitions_from_queries(db, qs, rows_per_file=500)
    t1 = time.perf_counter()
    samples = query_samples(qs, db.tables, max_rows=6000)[:80]
    pred = CompressionPredictor(model_name="SVR").fit(samples,
                                                      layouts=("col",))
    t2 = time.perf_counter()
    total_gb = sum(p.span for p in parts) / 1e9
    say("main", f"TPC-H scale_rows={SCALE_ROWS:,}: {len(qs)} queries, "
        f"{len(parts)} query-family partitions over {len(rows):,} files, "
        f"{total_gb:.4f} GB of family spans; data {t1 - t0:.1f} s, "
        f"predictor fit {t2 - t1:.1f} s")
    return parts, rows, pred, total_gb, samples


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
    for k in ("overlap", "entropy_features"):
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
        call = lambda: ov.fractional_overlap_matrix_kernel(*t)
        w_k = no_sync(call, torch)
        w_2 = call()
        w_t = ov.fractional_overlap_matrix_ordered(*t)
        w_p = ov.fractional_overlap_matrix_plain(*t)
        torch.cuda.synchronize()
        err = float((w_k - w_p).abs().max())
        rel = float(((w_k - w_p).abs() / w_p.abs().clamp_min(1e-30))
                    [w_p > 0].max()) if bool((w_p > 0).any()) else 0.0
        same = bool(torch.equal(w_k > 0, w_p > 0))
        check(err <= 1e-5 and same, f"K1 {tag}: max abs err {err}, "
              f"identical w>0 pattern {same}")
        check(torch.equal(w_k, w_t) and torch.equal(w_k, w_2),
              f"K1 {tag}: not bit-identical to its twin "
              f"{torch.equal(w_k, w_t)} or to a second call "
              f"{torch.equal(w_k, w_2)}")
        ms = cuda_ms(call, torch)
        dev_ms, by_dev = device_ms(call, torch)
        n_launch = launches_per_call(call, torch)
        check(n_launch == 1, f"K1 {tag}: {n_launch} CUDA launches a call")
        glue = host_ms(call, torch)
        plain = cuda_ms(lambda: ov.fractional_overlap_matrix_plain(*t), torch)
        n = int(c.shape[0])
        per_code = np.bincount(c[c >= 0], minlength=s.shape[0]).astype(float)
        n_ops = float((per_code ** 2).sum()) + 4.0 * n * n
        # bytes the function needs: the valid codes (A and B are one
        # input), every file size, the spans and the (N, N) output
        need = {"codes": 4 * int((c >= 0).sum()), "sizes": s.nbytes,
                "spans": sp.nbytes, "output": 4 * n * n}
        n_bytes = float(sum(need.values()))
        b, by = bound_ms(n_bytes, n_ops)
        p = ov.plan(n, n, c.shape[1], c.shape[1], s.shape[0])
        say("kernels", f"K1 overlap {tag}: codes {tuple(c.shape)}, F="
            f"{s.shape[0]}, {p.kind} plan ({p.blocks:,} blocks): max abs err "
            f"{err:.3e}, max rel err {rel:.3e}, w>0 identical, bit-identical "
            f"to fractional_overlap_matrix_ordered on the card and to a "
            f"second call, no host sync, {n_launch:g} CUDA launch a call; "
            f"kernel {ms:.4f} ms a call (device "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'} ms; "
            f"host {glue:.4f} ms a call to enqueue it, wrapper and launch), "
            f"plain {plain:.4f} ms, bound {b:.5f} ms ({by}; {_counts(need)} "
            f"bytes, {n_ops:.0f} ops), "
            f"{'not measured' if dev_ms is None else f'{100 * b / dev_ms:.2f}%'}"
            f" of it reached in device time")
        k1[tag] = (err, ms, plain, b, by, dev_ms, glue)

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
    k2_dev = 0.0
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
            s_2, b_2 = ef.weighted_entropy_features_kernel(*t, n_buckets=nb)
            check(torch.equal(s_k, s_2) and torch.equal(b_k, b_2),
                  f"K2 {tag} nb={nb}: two calls differ")
            if tag.startswith("main") and nb == 1:
                k2_err = max(k2_err, err)
                call = lambda: ef.weighted_entropy_features_kernel(
                    *t, n_buckets=1)
                ms = cuda_ms(call, torch, iters=10)
                dev_ms, by_dev = device_ms(call, torch, iters=10)
                plain = cuda_ms(lambda: ef.weighted_entropy_features_plain(
                    *t, n_buckets=1), torch, iters=5)
                need, distinct = _k2_needed(t, n_buckets=1)
                n_bytes = float(sum(need.values()))
                # ~21 float32 operations per distinct value (summary and
                # bucket terms, the log counted as one)
                n_ops = 21.0 * distinct
                b, by = bound_ms(n_bytes, n_ops)
                k2_ms, k2_plain = k2_ms + ms, k2_plain + plain
                k2_dev = (None if dev_ms is None or k2_dev is None
                          else k2_dev + dev_ms)
                k2_bytes, k2_ops = k2_bytes + n_bytes, k2_ops + n_ops
                plan = ef.weighted_entropy_features_info(
                    t[4].shape[-1], M=t[0].shape[1])
                line += (f"; {'replicated' if plan['replicated'] else 'distributed'}"
                         f" plan, {plan['slices']} slice(s) of "
                         f"{plan['span']:,} values; kernel {ms:.4f} ms "
                         f"(device {dev_ms if dev_ms is None else f'{dev_ms:.4f}'}"
                         f" ms: {_short(by_dev)}), plain {plain:.4f} ms, bound "
                         f"{b:.5f} ms ({by}; {_counts(need)} bytes, "
                         f"{n_ops:.0f} ops)")
            say("kernels", line + "; identical on a second call")
    b2, by2 = bound_ms(k2_bytes, k2_ops)
    say("kernels", f"K2 over the three classes of one feature pass: kernel "
        f"{k2_ms:.4f} ms (device "
        f"{k2_dev if k2_dev is None else f'{k2_dev:.4f}'} ms), plain "
        f"{k2_plain:.4f} ms, bound {b2:.5f} ms ({by2}; {k2_bytes:.0f} bytes, "
        f"{k2_ops:.0f} ops), {100 * b2 / k2_ms:.2f}% of the bound reached "
        f"({'not measured' if k2_dev is None else f'{100 * b2 / k2_dev:.2f}%'}"
        f" in device time)")
    err1, ms1, plain1, b1, by1, dev1, glue1 = k1["main"]
    for name, err, ms, plain, b, by in (
            ("overlap", err1, ms1, plain1, b1, by1),
            ("entropy_features", k2_err, k2_ms, k2_plain, b2, by2)):
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCES[name][0], "replaces": SOURCES[name][1],
                     "launches": int(launches.get(name, 0)),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by, "library_ms": None})
    rows[0].update(device_ms=dev1, host_ms=glue1)
    # K2's row: the three classes of one pass (one launch each)
    rows[-1].update(bound_share=b2 / k2_ms, device_ms=k2_dev)
    return rows


# ------------------------------------------------------------- reopt phase
MC_SCHEMES = ("none", "lz4", "zstd")     # labels: R and D are synthetic
MC_N = 2_000                  # bench_reoptimize's largest N
SCALE_N_CAP = 16_000          # capacitated cross-provider solve (PERF.md)
SCALE_N = 100_000             # greedy cross-provider solve and reoptimize
KNAPSACK_N = 100_000
MONTHS_HELD = 0.25


def _drift(rho, seed):
    """``benchmarks/bench_reoptimize.py``'s drift: 10% of partitions go hot
    (x20-100), another 10% go cold (/20-100), from a seeded generator."""
    rng = np.random.default_rng(seed)
    new = np.array(rho, np.float64)
    hot = rng.random(new.size) < 0.10
    cold = ~hot & (rng.random(new.size) < 0.10)
    new[hot] *= rng.uniform(20.0, 100.0, int(hot.sum()))
    new[cold] /= rng.uniform(20.0, 100.0, int(cold.sum()))
    return new


def _synthetic(E, table, cfg, N, seed):
    """``bench_reoptimize._problem``'s recipe: lognormal spans, gamma access
    counts, ratios 1.2-6 and decompression seconds per GB 0.01-2."""
    rng = np.random.default_rng(seed)
    K = len(cfg.schemes)
    spans = rng.lognormal(0.0, 1.2, N) * 2.0
    rho = rng.gamma(0.7, 25.0, N)
    R = np.concatenate([np.ones((N, 1)), rng.uniform(1.2, 6.0, (N, K - 1))], 1)
    D = np.concatenate([np.zeros((N, 1)),
                        rng.uniform(0.01, 2.0, (N, K - 1)) * spans[:, None]],
                       1)
    return E.PlacementProblem(spans_gb=spans, rho=rho,
                              current_tier=np.full(N, -1), R=R, D=D,
                              schemes=cfg.schemes, table=table, cfg=cfg)


def _same_plan(a, b, what):
    check(np.array_equal(a.assignment.tier, b.assignment.tier)
          and np.array_equal(a.assignment.scheme, b.assignment.scheme),
          f"{what}: cuda and cpu tiers or schemes differ")
    check(a.report.provider_scheme == b.report.provider_scheme,
          f"{what}: provider_scheme differs")
    rel = abs(a.report.total_cents - b.report.total_cents) \
        / abs(b.report.total_cents)
    check(rel <= 1e-6, f"{what}: cents differ by rel {rel}")
    return rel


def _same_migration(a, b, what):
    for f in ("moved", "new_tier", "new_scheme"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{what}: cuda and cpu migrations differ in {f}")
    rel = 0.0
    for f in ("migration_cents", "penalty_cents", "egress_cents"):
        x, y = getattr(a, f), getattr(b, f)
        r = abs(x - y) / abs(y) if y else abs(x)
        check(r <= 1e-6, f"{what}: {f} differs by rel {r}")
        rel = max(rel, r)
    _same_plan(a.plan, b.plan, what)
    return rel


def _timed_stages(torch, eng, optassign, secs, scans):
    """Wrap ``eng``'s stages and the solver's pieces so each call adds its
    host seconds (ending in ``torch.cuda.synchronize()``) to ``secs``; the
    dual ascent's arguments are kept in ``scans`` (its device time is read
    by re-running it under torch.profiler, outside the stage times).
    Returns the function that undoes the wrapping."""

    def wrap(obj, name, key, keep=None):
        fn = getattr(obj, name)

        def timed(*a, **k):
            if keep is not None:
                keep.append(a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            secs[key] = secs.get(key, 0.0) + time.perf_counter() - t0
            return out
        setattr(obj, name, timed)
        return lambda: setattr(obj, name, fn)

    undo = [wrap(eng.assign, "cost_and_feasibility", "cost+feasibility"),
            wrap(optassign, "_lagrangian_scan", "dual ascent", scans),
            wrap(optassign, "_best_from_candidates", "repair+local search"),
            wrap(eng, "_migration_terms", "migration terms"),
            wrap(eng, "_finalize_migration", "finalize (with its billing)"),
            wrap(eng, "billing", "billing")]
    return lambda: [u() for u in undo[::-1]]


def _stage_line(secs):
    return ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())


def _mirror_into_store(E, eng, plan, new_rho, moved):
    """Mirror the drifted partitions' migration into the port's
    ``TieredStore``: the moved partitions and the smallest unmoved one,
    with their real payloads. ``apply_plan`` puts them with their codecs;
    the plan's ratio for each chosen cell is then set to what the store
    holds (the SVR predicted it), and re-optimized until every cell the
    migration picks has its measured ratio, so the plan prices the bytes
    the store moves. Returns (migration, keys, meter lines moved)."""
    from repro_torch.core.optassign import Assignment
    from repro_torch.storage.codecs import codec_by_name
    from repro_torch.storage.store import TieredStore
    prob = plan.problem
    still = np.setdiff1d(np.arange(prob.n), moved)
    rows = np.sort(np.concatenate(
        [moved, still[np.argsort(prob.spans_gb[still])[:1]]])).astype(int)
    raws = [prob.raw_bytes[i] for i in rows]
    sub = dataclasses.replace(
        prob, spans_gb=prob.spans_gb[rows].copy(), rho=prob.rho[rows].copy(),
        current_tier=np.full(rows.size, -1), R=prob.R[rows].copy(),
        D=prob.D[rows].copy(), partitions=[prob.partitions[i] for i in rows],
        raw_bytes=raws, sla_ms=None)
    asg = Assignment(plan.assignment.tier[rows].copy(),
                     plan.assignment.scheme[rows].copy(), float("nan"), True)
    sub_plan = E.PlacementPlan(sub, asg, eng.billing(sub, asg))
    store = TieredStore(plan.problem.table)
    keys = store.apply_plan(sub_plan)
    known = set()
    for j, key in enumerate(keys):
        k0 = int(asg.scheme[j])
        sub.R[j, k0] = sub.spans_gb[j] / store.stored_gb(key)
        known.add((j, k0))
    for _ in range(4):
        mig = eng.reoptimize(sub_plan, new_rho[rows], months_held=MONTHS_HELD)
        need = {(int(j), int(mig.new_scheme[j]))
                for j in np.flatnonzero(mig.moved)} - known
        if not need:
            break
        for j, k in need:
            n_bytes = len(codec_by_name(sub.schemes[k]).compress(raws[j]))
            sub.R[j, k] = sub.spans_gb[j] / (n_bytes / 1e9)
            known.add((j, k))
    else:
        raise AssertionError("store mirror: measured ratios did not settle "
                             "in 4 re-optimizations")
    store.advance_months(MONTHS_HELD)
    before = dataclasses.asdict(store.meter)
    store.migrate(mig, keys)
    after = dataclasses.asdict(store.meter)
    delta = {f: after[f] - before[f] for f in
             ("read_cents", "write_cents", "egress_cents", "penalty_cents")}
    for n in np.flatnonzero(mig.moved):
        check(store.tier_of(keys[n]) == mig.new_tier[n]
              and store.codec_of(keys[n]) == sub.schemes[mig.new_scheme[n]],
              "store mirror: an object is not where the plan put it")
    return mig, rows, delta


def _knapsack_both(optassign, s, c, bc, **kw):
    """``budgeted_moves`` on the card and on the CPU: (mask, {device: s})."""
    out, secs = {}, {}
    for dev in (CARD, "cpu"):
        optassign.budgeted_moves(s, c, bc, device=dev, **kw)     # warm-up
        t0 = time.perf_counter()
        out[dev] = optassign.budgeted_moves(s, c, bc, device=dev, **kw)
        secs[dev] = time.perf_counter() - t0
    check(np.array_equal(out[CARD], out["cpu"]),
          "budgeted_moves: cuda and cpu masks differ")
    return out[CARD], secs


def phase_reopt(torch, rows, pred, samples, table, cfgs, cuda_runs,
                smi_line):
    """Re-optimization under drift, the budget knapsack, multi-cloud
    placement, placement at scale and the MLP (phase 8)."""
    from repro_torch.core import engine as E
    from repro_torch.core import ml, optassign
    from repro_torch.core.compredict import build_dataset
    from repro_torch.core.costs import big3_table
    from repro_torch.kernels import ops
    from repro_torch.storage.codecs import codec_by_name
    card = f"| {smi_line}"
    t_phase = time.perf_counter()

    # 1. drift phase main's greedy and capacitated plans and re-optimize
    greedy, capac = VARIANTS[1], VARIANTS[2]
    prob0 = cuda_runs[greedy][0]
    new_rho = _drift(prob0.rho, SEED)
    drifted = np.flatnonzero(new_rho != prob0.rho)
    say("reopt", f"drift (bench_reoptimize's recipe, seed {SEED}): "
        f"{drifted.size} of {prob0.n} partitions, rho x "
        f"{np.round(new_rho[drifted] / prob0.rho[drifted], 4).tolist()}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rd_fn = E.compredict_rd_fn(pred, rows, feature_backend="device",
                               device=CARD)
    R_d, _ = rd_fn([prob0.partitions[i] for i in drifted], prob0.schemes)
    torch.cuda.synchronize()
    t_rd = time.perf_counter() - t0
    check(np.allclose(R_d, prob0.R[drifted], rtol=1e-5, atol=0),
          "compredict_rd_fn's ratios differ from the plan's")
    migs, secs = {}, {}
    for n in (greedy, capac):
        problem, assignment, report, _ = cuda_runs[n]
        plan = E.PlacementPlan(problem, assignment, report)
        for dev in (CARD, "cpu"):
            eng = E.PlacementEngine(table, dataclasses.replace(cfgs[n],
                                                               device=dev))
            t0 = time.perf_counter()
            migs[n, dev] = eng.reoptimize(plan, new_rho,
                                          months_held=MONTHS_HELD)
            torch.cuda.synchronize()
            secs[n, dev] = time.perf_counter() - t0
        rel = _same_migration(migs[n, CARD], migs[n, "cpu"], n)
        m = migs[n, CARD]
        say("reopt", f"{n}: reoptimize(months_held={MONTHS_HELD}) moves "
            f"{m.n_moved} of {m.plan.problem.n} (tiers {m.plan.report.tiering_scheme}), "
            f"migration {m.migration_cents!r} cents, early delete "
            f"{m.penalty_cents!r} cents, steady {m.plan.report.total_cents!r} "
            f"cents; cuda {secs[n, CARD]:.4f} s, cpu {secs[n, 'cpu']:.4f} s; "
            f"cuda and cpu identical moves, tiers and schemes, cents rel "
            f"{rel:.3e} {card}")
    check(migs[greedy, CARD].n_moved > 0, "the drift moved nothing")
    launches = dict(ops.launch_counts)
    say("reopt", f"launches in the re-optimization path (compredict_rd_fn "
        f"on the {drifted.size} drifted partitions, {t_rd:.2f} s, then "
        f"the four reoptimize calls): {launches}")
    check(launches.get("entropy_features", 0) > 0,
          "kernel entropy_features was not launched by the reopt path")
    eng = E.PlacementEngine(table, cfgs[greedy])
    t0 = time.perf_counter()
    m_st, st_rows, delta = _mirror_into_store(
        E, eng, E.PlacementPlan(*cuda_runs[greedy][:3]), new_rho,
        np.flatnonzero(migs[greedy, CARD].moved))
    transfer = float(delta["read_cents"] + delta["write_cents"]
                     + delta["egress_cents"])
    r_t = abs(transfer - m_st.migration_cents) / max(m_st.migration_cents,
                                                     1e-300)
    r_p = abs(delta["penalty_cents"] - m_st.penalty_cents) \
        / max(m_st.penalty_cents, 1e-300)
    check(m_st.n_moved > 0 and r_t <= 1e-9
          and (r_p <= 1e-9 or abs(delta["penalty_cents"]
                                  - m_st.penalty_cents) <= 1e-15),
          f"store meter differs from the plan: transfer rel {r_t}, early "
          f"delete rel {r_p}")
    say("reopt", f"TieredStore mirror of partitions {st_rows.tolist()} "
        f"(apply_plan, advance_months({MONTHS_HELD}), migrate; ratios "
        f"measured on the payloads): {m_st.n_moved} moves, metered transfer "
        f"{transfer!r} vs plan {m_st.migration_cents!r} cents (rel "
        f"{r_t:.2e}), early delete {float(delta['penalty_cents'])!r} vs "
        f"{m_st.penalty_cents!r} (rel {r_p:.2e}); {time.perf_counter() - t0:.2f} s")

    # 2. the budget knapsack
    m = migs[greedy, CARD]
    sav = m.steady_savings_cents()
    spend = m.move_transfer_cents + m.move_egress_cents + m.move_penalty_cents
    cand = m.candidate
    bc = float(0.5 * spend[cand].sum())
    bg = float(0.5 * m.old_stored_gb[cand].sum())
    keep, ks = _knapsack_both(optassign, sav, spend, bc, candidates=cand,
                              move_gb=m.old_stored_gb, budget_gb=bg,
                              method="greedy")
    sel = m.select(keep)
    check(sel.total_move_cents <= bc + 1e-9
          and m.old_stored_gb[keep].sum() <= bg + 1e-9,
          "budgeted selection exceeds a cap")
    say("reopt", f"budgeted_moves on the {int(cand.sum())} candidates at "
        f"half their spend ({bc!r} cents, {bg!r} GB): keeps "
        f"{int(keep.sum())}, spends {float(sel.total_move_cents)!r} cents; cuda "
        f"{ks[CARD] * 1e3:.3f} ms, cpu {ks['cpu'] * 1e3:.3f} ms, identical")
    rng = np.random.default_rng(SEED + 7)
    n = KNAPSACK_N
    s = rng.gamma(1.0, 5.0, n) - 1.0
    c = rng.uniform(0.0, 3.0, n)
    c[rng.random(n) < 0.05] = 0.0
    g = rng.uniform(0.0, 2.0, n)
    cand = rng.random(n) < 0.8
    kw = dict(candidates=cand, move_gb=g, method="greedy")
    # the cents cap at a tenth of the candidates' spend; the GB cap just
    # under what that selection moves, so that each cap stops some items
    bc = 0.1 * c[cand].sum()
    only_c = optassign.budgeted_moves(s, c, bc, device=CARD, **kw)
    bg = 0.9995 * g[only_c].sum()
    keep, ks = _knapsack_both(optassign, s, c, bc, budget_gb=bg, **kw)
    only_g = optassign.budgeted_moves(s, c, np.inf, budget_gb=bg,
                                      device=CARD, **kw)
    check(not np.array_equal(keep, only_c)
          and not np.array_equal(keep, only_g),
          "the synthetic knapsack's caps do not both bind")
    check(c[keep].sum() <= bc + 1e-9 and g[keep].sum() <= bg + 1e-9,
          "budgeted_moves exceeds a cap")
    say("reopt", f"budgeted_moves, {n:,} synthetic candidates (seed "
        f"{SEED + 7}), caps {bc:.4f} cents and {bg:.4f} GB, both binding "
        f"({int((keep != only_c).sum())} and {int((keep != only_g).sum())} "
        f"rows differ from the cents-only and GB-only selections): keeps "
        f"{int(keep.sum()):,}; cuda "
        f"{ks[CARD] * 1e3:.2f} ms (device argsort, host float32 walk), "
        f"cpu {ks['cpu'] * 1e3:.2f} ms, masks identical {card}")

    # 3. placement across three clouds
    def engines(tab, **kw):
        return {dev: E.PlacementEngine(tab, E.ScopeConfig(
            schemes=MC_SCHEMES, months=6.0, device=dev, **kw))
            for dev in (CARD, "cpu")}

    def solve_both(tab, what, **kw):
        engs = engines(tab, **kw)
        plans, t = {}, {}
        for dev, e in engs.items():
            t0 = time.perf_counter()
            plans[dev] = e.solve(_synthetic(E, tab, e.cfg, MC_N, MC_N))
            torch.cuda.synchronize()
            t[dev] = time.perf_counter() - t0
        _same_plan(plans[CARD], plans["cpu"], what)
        return engs, plans, t

    big3 = big3_table()
    engs, plans, t = solve_both(big3, "big3 uncapped")
    plan = plans[CARD]
    cross = plan.report.total_cents
    az = big3.provider_names.index("azure")
    az_use = float(plan.stored_gb[big3.provider_of_tier[plan.assignment.tier]
                                  == az].sum())
    say("reopt", f"big3 ({big3.num_tiers} tiers, providers "
        f"{big3.provider_names}), N {MC_N:,}, schemes {MC_SCHEMES}: "
        f"uncapped {cross!r} cents, providers {plan.report.provider_scheme}; "
        f"cuda {t[CARD]:.3f} s, cpu {t['cpu']:.3f} s, identical")
    scans = []
    scan = optassign._lagrangian_scan
    optassign._lagrangian_scan = lambda *a: scans.append(1) or scan(*a)
    try:
        capped = big3_table(azure_capacity_gb=0.5 * az_use)
        _, cplans, t = solve_both(capped, "big3 azure capped")
    finally:
        optassign._lagrangian_scan = scan
    cp = cplans[CARD]
    used = float(cp.stored_gb[capped.provider_of_tier[cp.assignment.tier]
                              == az].sum())
    check(len(scans) == 2 and cp.assignment.feasible
          and used <= 0.5 * az_use + 1e-6,
          "the azure cap did not reach the dual ascent, or was not kept")
    say("reopt", f"azure capped at half its footprint ({0.5 * az_use:.4f} "
        f"of {az_use:.4f} GB; provider group rows, dual ascent on both "
        f"devices): {cp.report.total_cents!r} cents, providers "
        f"{cp.report.provider_scheme}, azure holds {used:.4f} GB; cuda "
        f"{t[CARD]:.3f} s, cpu {t['cpu']:.3f} s, identical")
    singles = {}
    for p in big3.provider_names:
        _, sp, _ = solve_both(big3, f"{p} only", provider_whitelist=(p,))
        singles[p] = sp[CARD].report.total_cents
    check(cross <= min(singles.values()) + 1e-9,
          "the cross-provider plan costs more than a single provider's")
    say("reopt", "single-provider plans (provider_whitelist): "
        + ", ".join(f"{p} {v!r}" for p, v in singles.items())
        + f" cents; cross-provider saves "
        f"{100 * (1 - cross / min(singles.values())):.3f}% against the best")
    mc_rho = _drift(plan.problem.rho, SEED + 1)
    mm = {dev: engs[dev].reoptimize(plans[dev], mc_rho,
                                    months_held=MONTHS_HELD)
          for dev in engs}
    _same_migration(mm[CARD], mm["cpu"], "big3 reoptimize")
    crossed = int(((big3.provider_of_tier[mm[CARD].new_tier]
                    != big3.provider_of_tier[mm[CARD].old_tier])
                   & mm[CARD].moved).sum())
    say("reopt", f"big3 drift: {mm[CARD].n_moved} moves, {crossed} across "
        f"providers, migration {mm[CARD].migration_cents!r} cents (egress "
        f"{mm[CARD].egress_cents!r}), early delete "
        f"{mm[CARD].penalty_cents!r}; identical on cuda and cpu")
    hot = plan.problem.rho >= np.quantile(plan.problem.rho, 0.9)
    reps = {dev: engs[dev].plan_replicas(plans[dev], np.where(hot, 3, 1))
            for dev in engs}
    a, b = reps[CARD], reps["cpu"]
    check(all(np.array_equal(getattr(a, f), getattr(b, f))
              for f in ("copies", "replica_tier", "replica_scheme"))
          and abs(a.replica_cents - b.replica_cents)
          <= 1e-6 * abs(b.replica_cents),
          "plan_replicas differs between cuda and cpu")
    prov = big3.provider_of_tier
    for i in np.flatnonzero(a.copies > 1):
        ps = [prov[plan.assignment.tier[i]]] + [prov[l] for l in
                                                a.replica_tier[i] if l >= 0]
        check(len(ps) == len(set(ps)) == a.copies[i],
              f"partition {i}: two copies on one provider")
    say("reopt", f"plan_replicas, 3 copies for the hottest 10% "
        f"({int(hot.sum())}): {a.n_replicated} replicated, copies "
        f"{np.bincount(a.copies).tolist()} by count, replica "
        f"{a.replica_cents!r} cents, read rebate {a.read_rebate_cents!r}; "
        f"every copy on its own provider; identical on cuda and cpu")
    # a small instance with real payloads, priced at a 0.5 c/GB
    # interconnect so that moves cross providers (the example's recipe)
    from repro_torch.storage.store import TieredStore
    inter = np.full((3, 3), 0.5)
    np.fill_diagonal(inter, 0.0)
    disc = dataclasses.replace(big3, egress_cents_gb=inter)
    cfg = E.ScopeConfig(schemes=("none",), months=6.0, device=CARD)
    rng = np.random.default_rng(7)
    raws = [b"\xa5" * max(int(x * 1e9), 1)
            for x in rng.lognormal(0.0, 1.3, 120) * 2e-5]
    small = E.PlacementProblem(
        spans_gb=np.array([len(r) / 1e9 for r in raws]),
        rho=rng.gamma(0.6, 30.0, 120), current_tier=np.full(120, -1),
        R=np.ones((120, 1)), D=np.zeros((120, 1)), schemes=("none",),
        table=disc, cfg=cfg, raw_bytes=raws)
    e_d = E.PlacementEngine(disc, cfg)
    p_d = e_d.solve(small)
    store = TieredStore(disc)
    keys = store.apply_plan(p_d)
    store.advance_months(0.5)
    flip = np.random.default_rng(11).random(120) < 0.2
    rho_d = small.rho.copy()
    rho_d[flip] *= np.random.default_rng(12).choice([1e-3, 200.0],
                                                    int(flip.sum()))
    m_d = e_d.reoptimize(p_d, rho_d, months_held=0.5)
    e0 = store.meter.egress_cents
    store.migrate(m_d, keys)
    eg = float(store.meter.egress_cents - e0)
    check(m_d.egress_cents > 0
          and abs(eg - m_d.egress_cents) <= 1e-9 * m_d.egress_cents,
          f"store egress {eg} differs from the plan's {m_d.egress_cents}")
    say("reopt", f"TieredStore mirror, 120 partitions of real payloads at a "
        f"0.5 c/GB interconnect: {m_d.n_moved} moves, metered egress "
        f"{eg!r} cents, plan {m_d.egress_cents!r}")

    # 4. scale, on the card only
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for N, capped_run in ((SCALE_N_CAP, True), (SCALE_N, False)):
        cfg = E.ScopeConfig(schemes=MC_SCHEMES, months=6.0, device=CARD)
        tab = big3
        if capped_run:
            g = E.PlacementEngine(big3, cfg).solve(
                _synthetic(E, big3, cfg, N, N))
            use = float(g.stored_gb[big3.provider_of_tier[g.assignment.tier]
                                    == az].sum())
            tab = big3_table(azure_capacity_gb=0.5 * use)
        e = E.PlacementEngine(tab, cfg)
        prob = _synthetic(E, tab, cfg, N, N)
        secs = {"solve": {}, "reoptimize": {}}
        scans = {"solve": [], "reoptimize": []}
        t = {}
        for step in ("solve", "reoptimize"):
            undo = _timed_stages(torch, e, optassign, secs[step], scans[step])
            try:
                t0 = time.perf_counter()
                if step == "solve":
                    plan_s = e.solve(prob)
                else:
                    mig_s = e.reoptimize(plan_s, _drift(prob.rho, N + 1),
                                         months_held=MONTHS_HELD)
                torch.cuda.synchronize()
                t[step] = time.perf_counter() - t0
            finally:
                undo()
        check(plan_s.assignment.feasible and mig_s.plan.assignment.feasible,
              f"N {N:,}: infeasible plan")
        what = ("azure capped at half its footprint, capacitated"
                if capped_run else "uncapped, greedy")
        for step in ("solve", "reoptimize"):
            dual = [device_ms(lambda: optassign._lagrangian_scan(*a), torch,
                              iters=1)[0] for a in scans[step]]
            dual_txt = (", ".join("not measured (no device records)"
                                  if d is None else f"{d:.3f} ms"
                                  for d in dual)
                        if dual else "none (the unconstrained optimum "
                        "fits the capacities)")
            say("reopt", f"scale N {N:,} on big3 ({what}): {step} "
                f"{t[step]:.3f} s ({_stage_line(secs[step])}); dual ascent "
                f"device time {dual_txt}"
                + (f"; {mig_s.n_moved:,} moves" if step == "reoptimize"
                   else "") + f" {card}")
    say("reopt", f"peak device memory of the scale runs "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB {card}")

    # 5. the MLP on COMPREDICT's labelled set (phase main's 80 samples)
    ds = build_dataset(samples, codec_by_name("zlib-6"), "col")
    init = ml._mlp_init((ds.X.shape[1], 64, 64, 1), seed=SEED)
    fits, t = {}, {}
    for dev in (CARD, "cpu"):
        t0 = time.perf_counter()
        fits[dev] = ml.MLP(hidden=(64, 64), epochs=500, init_params=init,
                           device=dev).fit(ds.X, ds.ratio)
        torch.cuda.synchronize()
        t[dev] = time.perf_counter() - t0
    check(all(p.device.type == "cuda" for p in fits[CARD].net.parameters()),
          "the MLP did not train on the card")
    pa, pb = fits[CARD].predict(ds.X), fits["cpu"].predict(ds.X)
    err = float(np.abs(pa - pb).max() / np.abs(pb).max())
    dp = max(float(np.abs(a[k] - b[k]).max()) for a, b in
             zip(fits[CARD].params, fits["cpu"].params) for k in ("w", "b"))
    check(err <= 1e-4, f"MLP on cuda and cpu differ by rel {err} (bar 1e-4, "
          f"tests/test_torch_ml.py)")
    say("reopt", f"MLP(hidden=(64, 64), epochs=500) on {len(ds.X)} samples x "
        f"{ds.X.shape[1]} features (zlib-6 ratios): fit {t[CARD]:.3f} s on "
        f"the card, {t['cpu']:.3f} s on the CPU; predictions rel {err:.3e} "
        f"(bar 1e-4), parameters {dp:.3e} apart {card}")
    say("reopt", f"phase reopt took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------- serve phase
# bf16 keeps 8 significant bits; over 63 blocks two bf16 evaluations that
# round in other places give logits up to ~7% apart (7.2e-2 between prefill
# and decode in the first full run), so the bf16 checks catch gross faults
# only. The float32 checks, where only the order of sums differs, are tight.
TOL_BF16 = 0.15
TOL_F32 = 1e-3
N_DECODE_F32 = 64           # prompt tokens decoded in float32 for the check
N_PROFILED = 4              # decode steps under torch.profiler


def _swap(ops, fns):
    """Replace functions of ``ops`` by ``fns``; returns the originals."""
    orig = {k: getattr(ops, k) for k in fns}
    for k, fn in fns.items():
        setattr(ops, k, fn)
    return orig


def _near_ties(got, ref):
    """Positions whose argmax differs between logits ``got`` and ``ref``
    (..., V), each with the gap between the two picks in ``ref`` and the
    largest |got - ref| at that position."""
    a_g, a_r = got.argmax(-1), ref.argmax(-1)
    out = []
    for ix in (a_g != a_r).nonzero().tolist():
        g, r = got[tuple(ix)], ref[tuple(ix)]
        gap = float(r[a_r[tuple(ix)]] - r[a_g[tuple(ix)]])
        out.append((tuple(ix), gap, float((g - r).abs().max())))
    return out


def _check_ties(ties, what):
    for ix, gap, err in ties:
        check(gap <= 2 * err, f"{what}: greedy token at {ix} differs by a "
              f"logit gap {gap:.3e}, beyond twice the error {err:.3e} there")


def _busy_share(torch, fn):
    """(device busy share, device operations: kernels, copies and fills,
    {operation name: device seconds}) of ``fn`` under torch.profiler;
    (None, None, {}) when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's entry also carries the time of
    # the kernels it launched, which would count them twice
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev) * 1e-6
    if busy <= 0:
        return None, None, {}
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total * 1e-6
    return busy / wall, len(dev), by_name


def phase_serve(torch, recorded):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import dtype_of
    from repro_torch.serving.decode import make_decode_step, make_prefill_step

    dev = torch.device(CARD)
    cfg = get_config(ARCH)
    B, P, T = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS + 1
    steps = P + T - 1
    per_kind = lambda kinds: sum(s.repeats * sum(k in kinds for k in s.unit)
                                 for s in cfg.stages)
    n_attn = per_kind(("attn", "attn_local", "shared_attn"))   # 9 for zamba2
    n_mamba = per_kind(("mamba",))                             # 54
    t0 = time.perf_counter()
    params = tr.init_params(torch.Generator(device=dev).manual_seed(SEED),
                            cfg, device=CARD)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(SEED + 1))
    torch.cuda.synchronize()
    leaves = tr.tree_leaves(params)
    say("serve", f"{cfg.name}: {tr.param_count(params):,} parameters, "
        f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} GB "
        f"in {cfg.dtype}, {n_mamba + n_attn} blocks ({n_mamba} mamba, "
        f"{n_attn} attention), d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"of {cfg.head_dim}; random weights from seed {SEED} in "
        f"{time.perf_counter() - t0:.1f} s; batch {B}, prompt {P}")
    prefill = make_prefill_step(cfg)
    prefill(params, prompts[:, :128])      # warm-up: library handles, loads
    torch.cuda.synchronize()

    def recorder(name, keep_first):
        def wrapped(*a, **k):
            if not keep_first or name not in recorded:
                recorded[name] = (a, k)
            return orig[name](*a, **k)
        return wrapped

    names = ("flash_attention", "ssd_scan", "decode_attention")
    orig = _swap(ops, {n: recorder(n, n != "decode_attention") for n in names})
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = prefill(params, prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = dict(ops.launch_counts)
        prefill_routes = dict(ops.route_counts)
        cache = tr.init_cache(cfg, B, max_seq=P + T + 1, device=CARD)
        ops.reset_launch_counts()
        res = serve(make_decode_step(cfg), params, cache, prompts, T)
        serve_launches = dict(ops.launch_counts)
    finally:
        _swap(ops, orig)
    peak = torch.cuda.max_memory_allocated() / 1e9
    V = tr.padded_vocab(cfg)
    check(tuple(logits.shape) == (B, P, V) and bool(logits.isfinite().all()),
          f"prefill logits {tuple(logits.shape)} not finite of ({B}, {P}, {V})")
    check(tuple(res.tokens.shape) == (B, T)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          f"serve tokens {tuple(res.tokens.shape)} out of range")
    say("serve", f"prefill (make_prefill_step): {prefill_s:.4f} s, "
        f"{B * P / prefill_s:.1f} tokens/s; launches {prefill_launches}")
    check(prefill_launches == {"flash_attention": n_attn, "ssd_scan": n_mamba},
          f"prefill launches {prefill_launches}, want flash_attention "
          f"{n_attn} and ssd_scan {n_mamba}")
    want_routes = {"flash_attention.bf16_tc": n_attn,
                   "ssd_scan.bf16_tc": n_mamba}
    check(prefill_routes == want_routes,
          f"bf16 prefill routes {prefill_routes}, want {want_routes}")
    say("serve", f"prefill routes: {want_routes} (the tensor-core route)")
    loop_s = res.prompt_s + res.decode_s
    step_ms = loop_s / steps * 1e3
    say("serve", f"serve loop: {steps} decode steps ({P} prompt + {T - 1} "
        f"generation) in {loop_s:.3f} s, {step_ms:.3f} ms per step; prompt "
        f"steps {B * P / res.prompt_s:.1f} tokens/s, generation "
        f"{B * (T - 1) / res.decode_s:.1f} tokens/s, whole loop "
        f"{B * T / loop_s:.1f} tokens/s as launch/serve.py counts "
        f"({B * T} tokens out); launches {serve_launches}; peak device "
        f"memory {peak:.3f} GB")
    check(serve_launches == {"decode_attention": n_attn * steps},
          f"serve launches {serve_launches}, want decode_attention "
          f"{n_attn * steps}")

    # where a decode step's time goes: the card's busy share over a few
    # steps (a fresh small cache; the profiler's own cost lowers the share)
    step = make_decode_step(cfg)
    small = tr.init_cache(cfg, B, max_seq=N_PROFILED + 1, device=CARD)

    def few_steps():
        for i in range(N_PROFILED):
            step(params, small, prompts[:, i:i + 1],
                 torch.full((B,), i, dtype=torch.int32, device=dev))

    few_steps()
    busy, n_kern, _ = _busy_share(torch, few_steps)
    pbusy, p_kern, _ = _busy_share(torch, lambda: prefill(params, prompts))
    say("serve", "torch.profiler: decode steps keep the card busy "
        + (f"{100 * busy:.2f}% of the time, {n_kern / N_PROFILED:.0f} device "
           f"operations per step" if busy is not None else "not measured (no device "
                                                 "time in the trace)")
        + "; prefill keeps it busy "
        + (f"{100 * pbusy:.2f}% ({p_kern} device operations)"
           if pbusy is not None
           else "not measured"))
    del small

    # the same prefill with the kernels' plain versions on the card
    plain = {"flash_attention": fa.flash_attention_plain,
             "ssd_scan": lambda *a, **k: ssd.ssd_scan_plain(*a, **k)}

    def run(p, c, use_plain):
        orig_p = _swap(ops, plain) if use_plain else None
        try:
            ops.reset_launch_counts()
            out = make_prefill_step(c)(p, prompts)
            torch.cuda.synchronize()
            n = sum(ops.launch_counts.values())
            route = _build.ROUTES[dtype_of(c.dtype)]
            check(use_plain or dict(ops.route_counts) == {
                f"flash_attention.{route}": n_attn,
                f"ssd_scan.{route}": n_mamba},
                  f"{c.dtype} prefill routes {dict(ops.route_counts)}")
        finally:
            if orig_p:
                _swap(ops, orig_p)
        check(n == (0 if use_plain else n_attn + n_mamba), f"{n} launches "
              f"in a {'plain' if use_plain else 'kernel'} prefill")
        return out

    logits_p = run(params, cfg, True)
    e_bf = _normwise(logits, logits_p)
    ties = _near_ties(logits, logits_p)
    del logits_p

    # float32: the same weights cast; kernels vs plain, prefill vs decode
    cfg32 = cfg.scaled(dtype="float32")
    params32 = tr.tree_map(lambda t: t.float(), params)
    l32_k = run(params32, cfg32, False)
    l32_p = run(params32, cfg32, True)
    e_32 = _normwise(l32_k, l32_p)
    ties32 = _near_ties(l32_k, l32_p)
    del l32_p
    step32 = make_decode_step(cfg32)
    cache32 = tr.init_cache(cfg32, B, max_seq=N_DECODE_F32 + 1, device=CARD)
    dec32 = torch.cat([step32(params32, cache32, prompts[:, i:i + 1],
                              torch.full((B,), i, dtype=torch.int32,
                                         device=dev))[0]
                       for i in range(N_DECODE_F32)], dim=1)
    del params32, cache32
    e_pd32 = _normwise(dec32, l32_k[:, :N_DECODE_F32])

    lp, ld = logits[:, -1], res.prompt_logits[:, 0]
    e_pd = _normwise(ld, lp)
    e_pre = _normwise(lp, l32_k[:, -1])
    e_dec = _normwise(ld, l32_k[:, -1])
    same_next = int((lp.argmax(-1) == ld.argmax(-1)).sum())
    agree = float((logits.argmax(-1) == l32_k.argmax(-1)).float().mean())
    say("serve", f"float32 (weights cast): prefill with kernels vs plain "
        f"versions normwise err {e_32:.3e}, greedy tokens differ at "
        f"{len(ties32)} of {B * P} positions; decode steps vs prefill over "
        f"the first {N_DECODE_F32} positions {e_pd32:.3e} (tolerance "
        f"{TOL_F32} each: only the order of float32 sums differs)")
    check(e_32 <= TOL_F32, f"f32 kernel vs plain err {e_32:.3e}")
    _check_ties(ties32, "f32 kernel vs plain")
    check(e_pd32 <= TOL_F32, f"f32 prefill vs decode err {e_pd32:.3e}")
    say("serve", f"bfloat16: prefill vs decode loop at position {P - 1} "
        f"normwise err {e_pd:.3e}, greedy next token equal for "
        f"{same_next}/{B}; against the float32 prefill the bfloat16 prefill "
        f"is off by {e_pre:.3e} and the decode loop by {e_dec:.3e}; prefill "
        f"with kernels vs plain versions {e_bf:.3e}, greedy next tokens "
        f"differ at {len(ties)} of {B * P} positions"
        + (" (" + ", ".join(f"{ix} gap {g:.2e} vs err {e:.2e}"
                            for ix, g, e in ties[:6]) + ")" if ties else "")
        + f"; bfloat16 greedy tokens agree with float32 at "
        f"{100 * agree:.2f}% of positions (tolerance {TOL_BF16}: see "
        f"TOL_BF16)")
    check(e_pd <= TOL_BF16, f"bf16 prefill vs decode err {e_pd:.3e}")
    check(e_bf <= TOL_BF16, f"bf16 kernel vs plain err {e_bf:.3e}")
    _check_ties(ties, "bf16 kernel vs plain")
    if ties:
        say("serve", "each differing position is a near-tie: the plain "
            "logits of the two picks lie within twice the bf16 error there")
    return {"prefill": prefill_launches, "serve": serve_launches,
            "prefill_s": prefill_s, "step_ms": step_ms, "n_attn": n_attn}


# ------------------------------------------------------ model kernels (5)
def _allclose(torch, got, want, tol) -> float:
    """max |got - want|, after checking |got - want| <= tol (1 + |want|)."""
    d = (got.float() - want.float()).abs()
    ok = bool((d <= tol * (1 + want.float().abs())).all())
    err = float(d.max()) if d.numel() else 0.0
    check(ok, f"max abs err {err:.3e} beyond tolerance {tol}")
    return err


def _rate(torch, dtype):
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S


def _flash_pairs(Sq, Sk, causal, window) -> int:
    """Visible (query, key) pairs of one head."""
    if not causal:
        return Sq * Sk
    n = 0
    for i in range(Sq):
        pos = i + Sk - Sq
        lo = 0 if window is None else max(0, pos - window + 1)
        n += max(0, min(pos, Sk - 1) - lo + 1)
    return n


def phase_model_kernels(torch, recorded, launches):
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    dev = torch.device(CARD)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rnd = lambda *shape, dtype=torch.float32, scale=1.0: (
        torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
    attn_tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

    def routed(name, fn, dtype):
        """fn() after zeroing the counts; the call must have taken
        ``dtype``'s route of kernel ``name``, once."""
        ops.reset_launch_counts()
        out = fn()
        route = f"{name}.{_build.ROUTES[dtype]}"
        check(dict(ops.launch_counts) == {name: 1}
              and dict(ops.route_counts) == {route: 1},
              f"{name} in {dtype}: counts {dict(ops.launch_counts)}, routes "
              f"{dict(ops.route_counts)}, want one launch through {route}")
        return out

    # ---- edge cases, float32 and bfloat16
    n_edge = 0
    for dt in (torch.float32, torch.bfloat16):
        for B, Sq, Sk, Hq, Hkv, D, Dv, causal, window, cap in (
                (2, 96, 96, 8, 2, 32, 32, True, None, None),
                (1, 256, 256, 4, 1, 64, 64, True, 64, None),
                (1, 128, 128, 2, 2, 64, 64, True, None, 50.0),
                (2, 64, 64, 4, 2, 48, 32, False, None, None),
                (1, 40, 150, 4, 2, 80, 80, True, 70, 30.0),
                (1, 64, 64, 2, 1, 256, 256, True, None, None),
                (1, 64, 64, 4, 2, 40, 24, True, None, None),
                (1, 96, 96, 2, 2, 20, 20, True, None, None),
                (2, 70, 70, 4, 4, 64, 64, True, None, None),
                (1, 128, 128, 8, 2, 128, 128, True, None, None)):
            q, k, v = rnd(B, Sq, Hq, D, dtype=dt), rnd(B, Sk, Hkv, D, dtype=dt), \
                rnd(B, Sk, Hkv, Dv, dtype=dt)
            kw = dict(causal=causal, window=window, softcap=cap)
            out = routed("flash_attention",
                         lambda: fa.flash_attention_kernel(q, k, v, **kw), dt)
            _allclose(torch, out, fa.flash_attention_plain(q, k, v, **kw),
                      attn_tol[dt])
            n_edge += 1
        for B, S, Hq, Hkv, D, window, cap in (
                (2, 256, 8, 2, 64, None, None), (1, 512, 4, 1, 128, None, None),
                (3, 200, 8, 8, 32, 64, None), (2, 100, 12, 2, 80, 30, 50.0),
                (3, 300, 4, 4, 64, 50, None), (1, 4100, 8, 1, 128, None, None),
                (3, 97, 16, 2, 32, 40, 30.0), (3, 130, 4, 2, 20, None, None)):
            q, k, v = rnd(B, Hq, D, dtype=dt), rnd(B, S, Hkv, D, dtype=dt), \
                rnd(B, S, Hkv, D, dtype=dt)
            lens = torch.randint(window or 1, S + 1, (B,), generator=g,
                                 device=dev, dtype=torch.int32)
            lens[0] = S
            if B > 2:
                lens[-1] = 0             # no visible key: o = 0
            kw = dict(window=window, softcap=cap)
            out = da.decode_attention_kernel(q, k, v, lens, **kw)
            seen = lens > 0
            _allclose(torch, out, da.decode_attention_plain(q, k, v, lens,
                                                            **kw),
                      attn_tol[dt])
            check(not bool(out[~seen].float().any())
                  and torch.equal(out, da.decode_attention_kernel(
                      q, k, v, lens, **kw)),
                  f"K6 edge {B, S, Hq, Hkv, D}: kv_len 0 gives non-zero "
                  f"output, or two calls differ")
            n_edge += 1
        for b, s, h, p, grp, n, chunk, skip in (
                (2, 48, 4, 16, 2, 8, 16, True), (1, 100, 3, 8, 1, 8, 32, True),
                (2, 300, 4, 64, 1, 64, 128, True),
                (1, 256, 2, 64, 1, 128, 128, False),
                (1, 64, 2, 8, 1, 8, 16, True),
                (1, 256, 80, 64, 1, 64, 128, True)):
            x = rnd(b, s, h, p, dtype=dt)
            Bm, Cm = rnd(b, s, grp, n, dtype=dt, scale=0.5), \
                rnd(b, s, grp, n, dtype=dt, scale=0.5)
            dtv = F.softplus(rnd(b, s, h)) * 0.5
            A = -torch.exp(rnd(h, scale=0.3))
            Dk = torch.ones(h, device=dev) if skip else None
            y_k, st_k = routed("ssd_scan", lambda: ssd.ssd_scan_kernel(
                x, dtv, A, Bm, Cm, Dk, chunk=chunk), dt)
            y_p, st_p = ssd.ssd_scan_plain(x, dtv, A, Bm, Cm, Dk, chunk=chunk)
            _allclose(torch, y_k, y_p, 1e-4 if dt == torch.float32 else 2e-2)
            _allclose(torch, st_k, st_p, 1e-4)
            n_edge += 1
    torch.cuda.synchronize()
    say("kernels", f"K5/K6/K7 edge cases: {n_edge} shapes (GQA 4:1 and MQA, "
        f"windows, softcaps, Dv != D, D 40/Dv 24, D 20 (plain loads), heads "
        f"of 80, 128 and 256, a ragged query tile, Sq < Sk, ragged kv_len, "
        f"K6: kv_len 0 (exactly 0), a window inside a split, 65 splits, 8 "
        f"query heads a KV head, identical on a second call, "
        f"grouped B/C, tail chunks, p = n = 8 at chunk 16, 80 heads on one "
        f"group, n = 128, no skip) in float32 (f32 route) and bfloat16 "
        f"(bf16_tc route), all within tolerance of the plain versions")

    rows = []
    # ---- K5 at the prefill's shape
    (q, k, v), kw = recorded["flash_attention"]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    out = fa.flash_attention_kernel(q, k, v, **kw)
    err = _allclose(torch, out, fa.flash_attention_plain(q, k, v, **kw),
                    attn_tol[q.dtype])
    ms = cuda_ms(lambda: fa.flash_attention_kernel(q, k, v, **kw), torch)
    plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), torch)
    lib = None
    if kw.get("window") is None and kw.get("softcap") is None and Sq == Sk:
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=kw.get("causal", True),
            enable_gqa=Hq != Hkv)
        _allclose(torch, sdpa().transpose(1, 2), out, attn_tol[q.dtype])
        lib = cuda_ms(sdpa, torch)
    el = q.element_size()
    need = {"q": q.numel() * el, "k": k.numel() * el, "v": v.numel() * el,
            "o": out.numel() * el}
    pairs = _flash_pairs(Sq, Sk, kw.get("causal", True), kw.get("window"))
    n_ops = float(B * Hq * pairs * (2 * D + 2 * Dv))
    b5, by5 = bound_ms(float(sum(need.values())), n_ops, _rate(torch, q.dtype))
    dev5, by_dev5 = device_ms(lambda: fa.flash_attention_kernel(q, k, v, **kw),
                              torch)
    dev_lib = device_ms(sdpa, torch) if lib is not None else (None, {})
    say("kernels", f"K5 shared memory per block "
        f"{fa.flash_attention_smem_bytes(D, Dv, q.dtype):,} bytes; device "
        f"time (torch.profiler, no host gaps): kernel "
        f"{dev5 if dev5 is None else f'{dev5:.4f}'} ms ({_short(by_dev5)}); "
        f"scaled_dot_product_attention "
        f"{dev_lib[0] if dev_lib[0] is None else f'{dev_lib[0]:.4f}'} ms "
        f"({_short(dev_lib[1])})")
    f32 = [t.float() for t in (q, k, v)]
    err32 = _allclose(torch, routed("flash_attention", lambda: fa.flash_attention_kernel(
        *f32, **kw), torch.float32), fa.flash_attention_plain(*f32, **kw),
        attn_tol[torch.float32])
    say("kernels", f"K5 flash_attention at the prefill's shape q "
        f"{tuple(q.shape)} k/v {tuple(k.shape)} {str(q.dtype)[6:]} {kw}: max "
        f"abs err {err:.3e} ({_build.ROUTES[q.dtype]} route; f32 route on the "
        f"same values cast {err32:.3e}); kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, scaled_dot_product_attention "
        f"{lib if lib is None else f'{lib:.4f}'} ms"
        + (f" (kernel / library {ms / lib:.3f})" if lib else "")
        + f", bound {b5:.5f} ms ({by5}; {_counts(need)} bytes, {n_ops:.0f} "
        f"ops), {100 * b5 / ms:.2f}% of the bound reached")
    rows.append(("flash_attention", err, ms, plain, b5, by5, lib))
    device = {"flash_attention": (dev5, dev_lib[0])}

    # ---- K6 at the last decode step's shape
    (q, k, v, kv_len), kw = recorded["decode_attention"]
    lens = kv_len.to(torch.int32).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, Hq, D = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    out = da.decode_attention_kernel(q, k, v, lens, **kw)
    err = _allclose(torch, out, da.decode_attention_plain(q, k, v, lens, **kw),
                    attn_tol[q.dtype])
    check(torch.equal(out, da.decode_attention_kernel(q, k, v, lens, **kw)),
          "K6: two calls on the same input differ")
    el = q.element_size()
    sweep = {}
    # the last step's kv_len (544), then the loop's range in the same cache
    for L in [None, 64, 272]:
        ln = lens if L is None else torch.full_like(lens, L)
        call = lambda: da.decode_attention_kernel(q, k, v, ln, **kw)
        o_l = call()
        _allclose(torch, o_l, da.decode_attention_plain(q, k, v, ln, **kw),
                  attn_tol[q.dtype])
        ms = cuda_ms(call, torch)
        dev_l, by_l = device_ms(call, torch)
        visible = int(ln.clamp(0, S).sum())
        need = {"q": q.numel() * el,
                "k/v rows": visible * Hkv * (D + Dv) * el,
                "kv_len": 4 * B, "o": o_l.numel() * el}
        n_ops = float(visible * Hq * (2 * D + 2 * Dv))
        b_l, by_b = bound_ms(float(sum(need.values())), n_ops,
                             _rate(torch, q.dtype))
        lib = lib_dev = None
        if kw.get("window") is None and kw.get("softcap") is None:
            mask = (torch.arange(S, device=dev)[None, :]
                    < ln[:, None].long())[:, None, None, :]
            qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv)
            _allclose(torch, sdpa()[:, :, 0], o_l, attn_tol[q.dtype])
            lib = cuda_ms(sdpa, torch)
            lib_dev = device_ms(sdpa, torch)[0]
        sweep[L] = (ms, dev_l, b_l, by_b, lib, lib_dev, need, n_ops)
        fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
        say("kernels", f"K6 at kv_len "
            f"{lens.tolist() if L is None else L} (cache {tuple(k.shape)}): "
            f"kernel {ms:.4f} ms, device {fmt(dev_l)} ({_short(by_l)}); "
            f"scaled_dot_product_attention with a kv_len mask {fmt(lib)}, "
            f"device {fmt(lib_dev)}; bound {b_l:.5f} ms ({by_b}; "
            f"{_counts(need)} bytes, {n_ops:.0f} ops), "
            f"{100 * b_l / ms:.2f}% of the bound reached"
            + (f" ({100 * b_l / dev_l:.2f}% in device time)" if dev_l else ""))
    ms, dev6, b6, by6, lib, lib_dev6, need, n_ops = sweep[None]
    plain = cuda_ms(lambda: da.decode_attention_plain(q, k, v, lens, **kw),
                    torch)
    say("kernels", f"K6 decode_attention at the last serve step's shape q "
        f"{tuple(q.shape)} cache {tuple(k.shape)} kv_len {lens.tolist()}: max "
        f"abs err {err:.3e}, identical on a second call; kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, scaled_dot_product_attention with a kv_len "
        f"mask {lib if lib is None else f'{lib:.4f}'} ms, bound {b6:.5f} ms "
        f"({by6}; {_counts(need)} bytes, {n_ops:.0f} ops)")
    rows.append(("decode_attention", err, ms, plain, b6, by6, lib))
    device["decode_attention"] = (dev6, lib_dev6)

    # ---- K7 at the prefill's shape
    (x, dtv, A, Bm, Cm, Dk), kw = recorded["ssd_scan"]
    f32 = lambda t: t.float().contiguous()
    x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dtv, A, Dk = f32(dtv), f32(A), f32(Dk)
    chunk = kw.get("chunk", 128)
    y_k, st_k = ssd.ssd_scan_kernel(x, dtv, A, Bm, Cm, Dk, chunk=chunk)
    y_p, st_p = ssd.ssd_scan_plain(x, dtv, A, Bm, Cm, Dk, chunk=chunk)
    err = _allclose(torch, y_k, y_p, 2e-2 if x.dtype == torch.bfloat16
                    else 1e-4)
    err_st = _allclose(torch, st_k, st_p, 1e-4)
    ms = cuda_ms(lambda: ssd.ssd_scan_kernel(x, dtv, A, Bm, Cm, Dk,
                                             chunk=chunk), torch)
    plain = cuda_ms(lambda: ssd.ssd_scan_plain(x, dtv, A, Bm, Cm, Dk,
                                               chunk=chunk), torch, iters=5)
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    el = x.element_size()
    need = {"x": x.numel() * el, "dt": dtv.numel() * 4, "A, D": 8 * h,
            "B, C": 2 * Bm.numel() * el, "y": y_k.numel() * el,
            "state": st_k.numel() * 4}
    n_ops = 0.0
    for c0 in range(0, s, chunk):
        L = min(chunk, s - c0)
        tri = L * (L + 1) // 2
        n_ops += tri * 2 * n + tri * 2 * p + L * p * 2 * n + L * p * n * 2
    n_ops *= b * h
    b7, by7 = bound_ms(float(sum(need.values())), n_ops, _rate(torch, x.dtype))
    dev7, by_dev7 = device_ms(lambda: ssd.ssd_scan_kernel(
        x, dtv, A, Bm, Cm, Dk, chunk=chunk), torch)
    say("kernels", f"K7 shared memory per block (the larger pass) "
        f"{ssd.ssd_scan_smem_bytes(chunk, p, n, x.dtype):,} bytes; device "
        f"time (torch.profiler, no host gaps): "
        f"{dev7 if dev7 is None else f'{dev7:.4f}'} ms ({_short(by_dev7)})")
    f32 = [t.float() for t in (x, dtv, A, Bm, Cm, Dk)]
    y32, st32 = routed("ssd_scan", lambda: ssd.ssd_scan_kernel(
        *f32, chunk=chunk), torch.float32)
    y32p, st32p = ssd.ssd_scan_plain(*f32, chunk=chunk)
    err32 = (_allclose(torch, y32, y32p, 1e-4), _allclose(torch, st32, st32p,
                                                          1e-4))
    scratch = (ssd.ssd_scan_scratch_bytes(b, s, h, p, Bm.shape[2], n, chunk)
               if x.dtype == torch.bfloat16 else 0)
    say("kernels", f"K7 ssd_scan at the prefill's shape x {tuple(x.shape)} "
        f"B/C {tuple(Bm.shape)} chunk {chunk}: max abs err y {err:.3e}, "
        f"state {err_st:.3e} ({_build.ROUTES[x.dtype]} route; f32 route on the "
        f"same values cast: y {err32[0]:.3e}, state {err32[1]:.3e}); kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, no single PyTorch call computes "
        f"it; bound {b7:.5f} ms ({by7}; {_counts(need)} bytes, {n_ops:.0f} "
        f"ops; the route's own float32 scratch, not counted in the bound: "
        f"{scratch:,} bytes written and read back), {100 * b7 / ms:.2f}% of "
        f"the bound reached")
    rows.append(("ssd_scan", err, ms, plain, b7, by7, None))
    device["ssd_scan"] = (dev7, None)

    k5, k6, k7 = (r[2] for r in rows)
    pre = (launches["prefill"]["flash_attention"] * k5
           + launches["prefill"]["ssd_scan"] * k7) * 1e-3
    say("kernels", f"shares: K5 and K7 take {pre:.4f} s of the "
        f"{launches['prefill_s']:.4f} s prefill "
        f"({100 * pre / launches['prefill_s']:.1f}%); K6 takes "
        f"{launches['n_attn'] * k6:.4f} ms of a {launches['step_ms']:.3f} "
        f"ms decode step at its last, longest cache "
        f"({100 * launches['n_attn'] * k6 / launches['step_ms']:.2f}%)")
    out_rows = []
    for name, err, ms, plain, b, by, lib in rows:
        n = launches["prefill" if name != "decode_attention" else "serve"]
        row = {"name": name, "route": "cuda", "source": SOURCES[name][0],
               "replaces": SOURCES[name][1], "launches": int(n.get(name, 0)),
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": b, "bound_by": by, "library_ms": lib}
        if name in device:
            row["bound_share"] = b / ms
            row["device_ms"], lib_dev = device[name]
            if lib:
                row["library_ratio"] = ms / lib
                row["library_device_ms"] = lib_dev
        out_rows.append(row)
    return out_rows


# ------------------------------------------------------------- train phase
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 5
TOL_LOSS_F32 = 1e-4         # kernel vs plain loss, float32, relative
TOL_GRAD_F32 = 1e-3         # kernel vs plain gradients, float32, normwise
TOL_EF = 1e-6               # deq + err_new against g + err_old, normwise
#: leaves that reach the loss only through K5 (shared attention) or K7
GRAD_VIA_K5 = ("wq", "wk", "wv")
GRAD_VIA_K7 = ("in_x", "in_bc", "in_dt", "dt_bias", "A_log", "D",
               "conv_x_w", "conv_x_b", "conv_bc_w", "conv_bc_b")


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _one_unit(tr, params, cfg, torch):
    """The model cut to one repeat of each stage's unit, in float32."""
    from repro_torch.models.config import Stage
    cut = dataclasses.replace(
        cfg, dtype="float32",
        stages=tuple(Stage(s.unit, 1) for s in cfg.stages))
    f32 = lambda t: t.detach().float()
    p = {k: tr.tree_map(f32, v) for k, v in params.items() if k != "stages"}
    p["stages"] = tr.tree_map(lambda t: t[:1].detach().float(),
                              params["stages"])
    return cut, p


def phase_train(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.data.loader import TieredDataLoader, write_token_shards
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as tr
    from repro_torch.storage.store import TieredStore
    from repro_torch.training import grad_compression as gc
    from repro_torch.training import train_step as ts

    dev = torch.device(CARD)
    cfg = get_config(ARCH)
    tcfg = ts.TrainConfig(remat=True, compressed_grads=True, microbatches=1)
    per_kind = lambda kinds: sum(s.repeats * sum(k in kinds for k in s.unit)
                                 for s in cfg.stages)
    n_attn = per_kind(("attn", "attn_local", "shared_attn"))
    n_mamba = per_kind(("mamba",))
    say("train", f"reduced: sequence {TRAIN_SEQ} against {cfg.name}'s 4096-"
        f"token context (keeps K5 and K7 at the serve phase's shapes); "
        f"the float32 kernel-vs-plain check cuts the stages to 1 repeat "
        f"unit ({len(cfg.stages[0].unit)} blocks, full width)")
    t0 = time.perf_counter()
    store = TieredStore()
    shards = write_token_shards(store, n_shards=16, rows=32, seq=TRAIN_SEQ,
                                vocab=cfg.vocab_size, seed=SEED)
    loader = TieredDataLoader(store, shards, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_train_state(torch.Generator(device=dev).manual_seed(SEED),
                                cfg, tcfg, device=CARD)
    torch.cuda.synchronize()
    leaves = tr.tree_leaves(state["params"])
    n_leaves = len(leaves)
    gb = lambda ts_: sum(t.numel() * t.element_size() for t in ts_) / 1e9
    say("train", f"{cfg.name}: {tr.param_count(state['params']):,} "
        f"parameters in {n_leaves} leaves ({gb(leaves):.3f} GB {cfg.dtype}); "
        f"float32 master, m, v {3 * gb(tr.tree_leaves(state['opt'].master)):.3f}"
        f" GB; TrainConfig(remat=True, compressed_grads=True, microbatches="
        f"1), AdamW defaults; 16 Zipf token shards of 32 x {TRAIN_SEQ + 1} "
        f"in a TieredStore, batch {TRAIN_BATCH}; set-up "
        f"{time.perf_counter() - t0:.1f} s")

    per_step = []

    def on_step(i, m):
        per_step.append((dict(ops.launch_counts), dict(ops.route_counts)))
        ops.reset_launch_counts()

    ops.reset_launch_counts()
    res = train(cfg, tcfg, state, loader, TRAIN_STEPS, on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 1e9
    state = res.state
    want = {"flash_attention": 2 * n_attn, "ssd_scan": 2 * n_mamba,
            "quant_pack": n_leaves}
    want_routes = {"flash_attention.bf16_tc": 2 * n_attn,
                   "ssd_scan.bf16_tc": 2 * n_mamba}
    for i, (loss, sec, (counts, routes)) in enumerate(
            zip(res.losses, res.step_s, per_step), 1):
        say("train", f"step {i}: loss {loss!r}, {sec:.4f} s, "
            f"{res.tokens / sec:.1f} tokens/s, launches {counts}, routes "
            f"{routes}")
        check(math.isfinite(loss), f"step {i}: loss {loss} not finite")
        check(counts == want and routes == want_routes,
              f"step {i}: launches {counts}, routes {routes}, want {want} "
              f"and {want_routes} (K5 and K7 twice per forward under remat, "
              f"through the tensor-core route, K3 once per leaf)")
    steady = res.step_s[1:]
    say("train", f"{TRAIN_STEPS} steps: mean {sum(res.step_s) / TRAIN_STEPS:.4f}"
        f" s per step, {res.tokens_per_s:.1f} training tokens/s; steps 2-"
        f"{TRAIN_STEPS} (after the first, which warms up) "
        f"{sum(steady) / len(steady):.4f} s, "
        f"{res.tokens * len(steady) / sum(steady):.1f} tokens/s; peak device "
        f"memory {peak:.3f} GB")

    batches = loader.batches(epoch=0)
    batch = next(batches)
    step = ts.make_train_step(cfg, tcfg)
    stepped = []
    busy, n_ops, by_name = _busy_share(
        torch, lambda: stepped.append(step(state, batch)))
    state = stepped[0][0]
    # by kernel name: cuBLAS's Hopper GEMMs are nvjet_* or sm90_xmma_*;
    # PyTorch's strided elementwise_kernel<128, ...> does the copies and
    # casts of non-contiguous tensors, vectorized_elementwise_kernel the
    # contiguous elementwise math
    groups = {"K3": ("quant_pack",), "K5": ("flash",),
              "K7": ("ssd_kernel", "chunk_state_kernel", "state_pass_kernel",
                     "chunk_scan_kernel"),
              "matmuls": ("nvjet", "gemm", "xmma", "cutlass", "cublas"),
              "reductions": ("reduce", "softmax", "norm", "scan"),
              "copies and casts": ("copy", "elementwise_kernel<128",
                                   "CatArray", "Memcpy", "Memset", "fill"),
              }
    by_group = dict.fromkeys(list(groups) + ["other elementwise"], 0.0)
    for name, sec in by_name.items():
        g = next((g for g, keys in groups.items()
                  if any(k in name for k in keys)), "other elementwise")
        by_group[g] += sec
    total = sum(by_name.values())
    say("train", "torch.profiler over one step: "
        + (f"device time {total:.4f} s in {n_ops} device operations, the "
           f"card busy {100 * busy:.2f}% of the profiled step (the "
           f"profiler's own cost lengthens it), {100 * total / (sum(steady) / len(steady)):.2f}"
           f"% of an unprofiled step of {sum(steady) / len(steady):.4f} s; "
           + "; ".join(f"{g} {v * 1e3:.2f} ms" for g, v in by_group.items())
           + "; largest: " + "; ".join(
               f"{k[:70]} {v * 1e3:.2f} ms" for k, v in
               sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
           if busy is not None else "not measured (no device time in the "
           "trace)"))
    k3_s = by_group["K3"]

    # gradients arrive at every leaf, also those behind K5 and K7 only
    loss, grads = ts._grads(state["params"], ts._on_device(batch, dev), cfg,
                            tcfg)
    named = _named_leaves(grads)
    bad = [n for n, g in named if not bool(torch.isfinite(g).all())]
    check(not bad, f"non-finite gradients: {bad}")
    behind = [(n, float(g.float().norm())) for n, g in named
              if n.rsplit("/", 1)[-1] in GRAD_VIA_K7
              or (n.startswith("/shared/attn/")
                  and n.rsplit("/", 1)[-1] in GRAD_VIA_K5)]
    zero = [n for n, v in behind if not v > 0]
    check(len(behind) == 3 + len(GRAD_VIA_K7) * len(
        [k for k in cfg.stages[0].unit if k == "mamba"]) and not zero,
        f"leaves behind K5/K7 with zero gradient: {zero}")
    say("train", f"gradients: all {len(named)} leaves finite; the "
        f"{len(behind)} leaves that reach the loss only through K5 or K7 "
        f"have non-zero norms (smallest {min(v for _, v in behind):.3e} at "
        f"{min(behind, key=lambda x: x[1])[0]})")
    del grads, named, behind

    # K3 on this step's leaves: kernel against plain, and error feedback
    k3 = {"calls": 0, "largest": None, "ef": 0.0}
    orig_leaf, orig_pack = gc._quant_leaf, ops.quant_pack

    def pack(x, **kw):
        q, s = orig_pack(x, **kw)
        q_p, s_p = qp.quant_pack_plain(x)
        check(torch.equal(q, q_p) and torch.equal(s, s_p),
              f"K3 on a {tuple(x.shape)} leaf differs from its plain version")
        k3["calls"] += 1
        if k3["largest"] is None or x.numel() > k3["largest"].numel():
            k3["largest"] = x.detach().clone()
        return q, s

    def leaf(g, e):
        before = g.float() + e
        deq, new_e = orig_leaf(g, e)
        k3["ef"] = max(k3["ef"], _normwise(deq + new_e, before))
        return deq, new_e

    gc._quant_leaf, ops.quant_pack = leaf, pack
    try:
        state, _ = step(state, next(batches))
        torch.cuda.synchronize()
    finally:
        gc._quant_leaf, ops.quant_pack = orig_leaf, orig_pack
    check(k3["calls"] == n_leaves, f"K3 ran {k3['calls']} times in a step")
    check(k3["ef"] <= TOL_EF, f"deq + err_new vs g + err_old {k3['ef']:.3e}")
    say("train", f"K3 on all {n_leaves} leaves of a step: int8 values and "
        f"scales identical to quant_pack_plain on the card; error feedback "
        f"deq + err_new against g + err_old normwise {k3['ef']:.3e} "
        f"(tolerance {TOL_EF})")

    shard = state["params"]["embed"].reshape(-1).view(torch.uint8)[:4 << 20] \
        .clone()
    out = {"launches": {k: sum(c.get(k, 0) for c, _ in per_step)
                        for k in want},
           "per_step": want, "step_s": sum(steady) / len(steady),
           "k3_s": k3_s, "largest": k3["largest"], "shard": shard}
    # float32, one repeat unit: the loss and gradients through the kernels
    # against the same with the plain versions swapped in
    cut, p32 = _one_unit(tr, state["params"], cfg, torch)
    del state, res
    torch.cuda.empty_cache()
    b = ts._on_device(batch, dev)
    ops.reset_launch_counts()
    l_k, g_k = ts._grads(p32, b, cut, tcfg)
    torch.cuda.synchronize()
    n_k, r_k = dict(ops.launch_counts), dict(ops.route_counts)
    orig = _swap(ops, {"flash_attention": fa.flash_attention_plain,
                       "ssd_scan": lambda *a, **k: ssd.ssd_scan_plain(*a, **k)})
    try:
        l_p, g_p = ts._grads(p32, b, cut, tcfg)
    finally:
        _swap(ops, orig)
    u_attn = sum(k in ("attn", "attn_local", "shared_attn")
                 for k in cut.stages[0].unit)
    u_mamba = sum(k == "mamba" for k in cut.stages[0].unit)
    check(n_k == {"flash_attention": 2 * u_attn, "ssd_scan": 2 * u_mamba}
          and r_k == {"flash_attention.f32": 2 * u_attn,
                      "ssd_scan.f32": 2 * u_mamba},
          f"float32 check launches {n_k}, routes {r_k}")
    e_loss = abs(float(l_k) - float(l_p)) / abs(float(l_p))
    e_grad = max((_normwise(a, b_), n) for (n, a), (_, b_) in
                 zip(_named_leaves(g_k), _named_leaves(g_p)))
    say("train", f"float32, 1 repeat unit: loss through the kernels "
        f"{float(l_k)!r} against the plain versions {float(l_p)!r}, rel "
        f"{e_loss:.3e} (tolerance {TOL_LOSS_F32}); gradients normwise at "
        f"most {e_grad[0]:.3e} at {e_grad[1]} (tolerance {TOL_GRAD_F32}); "
        f"the backward of K5 and K7 is their plain version in both")
    check(e_loss <= TOL_LOSS_F32, f"f32 loss kernel vs plain {e_loss:.3e}")
    check(e_grad[0] <= TOL_GRAD_F32, f"f32 grads kernel vs plain {e_grad}")
    del p32, g_k, g_p
    torch.cuda.empty_cache()
    return out


def phase_train_kernels(torch, trained):
    """K3 and K4 against their plain versions, at the shapes of the
    training step and of ``benchmarks/bench_kernels.py``, and edge cases;
    then their times and bounds."""
    from repro_torch.kernels import entropy_features as ef
    from repro_torch.kernels import quant_pack as qp

    dev = torch.device(CARD)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows = []

    # ---- K3: edge cases, then the largest leaf and the benchmark's shape
    ties = torch.zeros(256, device=dev)
    ties[:5] = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5])
    edge = {f"{shape}": torch.randn(shape, generator=g, device=dev) * 5.0
            for shape in ((4, 256), (1024,), (3, 2, 512))}
    edge["zero block"] = torch.zeros((2, 256), device=dev)
    edge["ties"] = ties
    for tag, x in edge.items():
        q, s = qp.quant_pack_kernel(x)
        q_p, s_p = qp.quant_pack_plain(x)
        check(torch.equal(q, q_p) and torch.equal(s, s_p),
              f"K3 {tag}: kernel and plain differ")
    check(qp.quant_pack_kernel(ties)[0][:5].tolist() == [127, 0, 2, 2, -2],
          "K3 does not round half to even")
    check(float(qp.quant_pack_kernel(edge["zero block"])[1][0])
          == float(np.float32(1e-12) / np.float32(127.0)),
          "K3 zero block scale")
    say("kernels", f"K3 edge cases {list(edge)}: int8 and scales identical "
        f"to the plain version; ties 0.5, 1.5, 2.5, -2.5 at scale 1 -> 0, 2, "
        f"2, -2; a zero block gets scale 1e-12/127 and q = 0")
    k3 = {}
    for tag, x in (("largest leaf", trained["largest"]),
                   ("1024x1024", torch.randn((1024, 1024), generator=g,
                                             device=dev))):
        q, s = qp.quant_pack_kernel(x)
        q_p, s_p = qp.quant_pack_plain(x)
        check(torch.equal(q, q_p) and torch.equal(s, s_p),
              f"K3 {tag}: kernel and plain differ")
        err = float((qp.quant_unpack(q, s) - qp.quant_unpack(q_p, s_p))
                    .abs().max())
        ms = cuda_ms(lambda: qp.quant_pack_kernel(x), torch)
        dev_ms = device_ms(lambda: qp.quant_pack_kernel(x), torch)[0]
        plain = cuda_ms(lambda: qp.quant_pack_plain(x), torch, iters=5)
        n = x.numel()
        need = {"x": 4 * n, "q": n, "scale": 4 * (n // 256)}
        n_ops = 6.0 * n     # |x|, max, divide, round, two clamps per value
        b, by = bound_ms(float(sum(need.values())), n_ops)
        say("kernels", f"K3 quant_pack {tag} {tuple(x.shape)}: int8 and "
            f"scales identical to the plain version; kernel {ms:.4f} ms "
            f"(device {'not measured' if dev_ms is None else f'{dev_ms:.4f}'}"
            f" ms), plain {plain:.4f} ms, no single PyTorch call computes "
            f"it; bound {b:.5f} ms ({by}; {_counts(need)} bytes, "
            f"{n_ops:.0f} ops)")
        k3[tag] = (err, ms, plain, b, by, dev_ms)
    err, ms, plain, b, by, dev_ms = k3["largest leaf"]
    rows.append({"name": "quant_pack", "route": "cuda",
                 "source": SOURCES["quant_pack"][0],
                 "replaces": SOURCES["quant_pack"][1],
                 "launches": int(trained["launches"]["quant_pack"]),
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b, "bound_by": by, "library_ms": None,
                 "device_ms": dev_ms})

    # ---- K4: edge cases, then 1 MiB of random bytes and a 4 MiB shard
    rnd = lambda n: torch.randint(0, 256, (n,), generator=g, device=dev,
                                  dtype=torch.uint8)
    buf = rnd(6000)
    cases = {"n=1": rnd(1), "n=100 (< block)": rnd(100),
             "n=5000 (not a multiple)": rnd(5000),
             "offset 3, n=4097": buf[3:4100],
             "constant": torch.full((3000,), 7, dtype=torch.uint8, device=dev)}
    for k in (2, 4, 256):
        cases[f"{k} symbols"] = torch.arange(k, dtype=torch.uint8,
                                             device=dev).repeat(4096 // k)
    expect = {"constant": 0.0, "2 symbols": 1.0, "4 symbols": 2.0,
              "256 symbols": 8.0}
    for tag, d in cases.items():
        h, e = ef.byte_entropy_kernel(d)
        h_p, e_p = ef.byte_entropy_plain(d)
        rel = abs(float(e) - float(e_p)) / max(abs(float(e_p)), 1e-30)
        check(torch.equal(h, h_p) and (rel <= 1e-5 or float(e) == float(e_p)),
              f"K4 {tag}: histogram equal {torch.equal(h, h_p)}, entropy "
              f"rel {rel:.3e}")
        h_2, e_2 = ef.byte_entropy_kernel(d)
        check(torch.equal(h, h_2) and torch.equal(e, e_2),
              f"K4 {tag}: a second call differs")
        if tag in expect:
            check(abs(float(e) - expect[tag]) <= 1e-5 * max(expect[tag], 1),
                  f"K4 {tag}: {float(e)} bits, want {expect[tag]}")
    check(float(ef.byte_entropy_kernel(cases["constant"])[1]) == 0.0,
          "K4: a constant payload must give exactly 0.0")
    say("kernels", f"K4 edge cases {list(cases)}: histograms identical, "
        f"entropy within rel 1e-5; constant payload exactly 0.0, uniform "
        f"2/4/256-symbol alphabets 1, 2 and 8 bits")
    k4 = {}
    # 4 MiB of random bytes beside the trained payload: what the bins that
    # a warp's lanes share cost (the bf16 weights' high bytes take a
    # handful of values)
    for tag, d in (("1 MiB random", rnd(1 << 20)), ("4 MiB random", rnd(4 << 20)),
                   ("4 MiB of trained bf16 params", trained["shard"])):
        h, e = ef.byte_entropy_kernel(d)
        h_p, e_p = ef.byte_entropy_plain(d)
        rel = abs(float(e) - float(e_p)) / abs(float(e_p))
        check(torch.equal(h, h_p) and rel <= 1e-5,
              f"K4 {tag}: entropy rel {rel:.3e}")
        call = lambda: ef.byte_entropy_kernel(d)
        h_2, e_2 = no_sync(call, torch)
        check(torch.equal(h, h_2) and torch.equal(e, e_2),
              f"K4 {tag}: a second call differs")
        n_launch = launches_per_call(call, torch)
        check(n_launch == 1, f"K4 {tag}: {n_launch} CUDA launches a call")
        ms = cuda_ms(call, torch)
        dev_ms = device_ms(call, torch)[0]
        glue = host_ms(call, torch)
        plain = cuda_ms(lambda: ef.byte_entropy_plain(d), torch)
        binc = cuda_ms(lambda: torch.bincount(d, minlength=256), torch)
        n = d.numel()
        need = {"data": n, "hist": 4 * 256, "entropy": 4}
        n_ops = float(n)        # one count per byte
        b, by = bound_ms(float(sum(need.values())), n_ops)
        say("kernels", f"K4 byte_entropy {tag} ({n:,} bytes, "
            f"{ef.byte_entropy_blocks(n, ef._sm_count(dev.index))} blocks): "
            f"{float(e):.6f} bits/byte, histogram identical, entropy rel "
            f"{rel:.3e}, identical on a second call, no host sync, "
            f"{n_launch:g} CUDA launch a call; kernel {ms:.4f} ms a call "
            f"(device {'not measured' if dev_ms is None else f'{dev_ms:.4f}'}"
            f" ms; host {glue:.4f} ms a call to enqueue it), plain "
            f"{plain:.4f} ms, no single PyTorch call computes it "
            f"(torch.bincount, the histogram alone: {binc:.4f} ms); bound "
            f"{b:.5f} ms ({by}; {_counts(need)} bytes, {n_ops:.0f} ops), "
            f"{'not measured' if dev_ms is None else f'{100 * b / dev_ms:.2f}%'}"
            f" of it reached in device time")
        k4[tag] = (abs(float(e) - float(e_p)), ms, plain, b, by, dev_ms, glue)
    err, ms, plain, b, by, dev_ms, glue = k4["4 MiB of trained bf16 params"]
    rows.append({"name": "byte_entropy", "route": "cuda",
                 "source": SOURCES["byte_entropy"][0],
                 "replaces": SOURCES["byte_entropy"][1],
                 "launches": 0, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain, "bound_ms": b, "bound_by": by,
                 "library_ms": None, "device_ms": dev_ms, "host_ms": glue})
    k3_step = trained["launches"]["quant_pack"] // TRAIN_STEPS
    say("kernels", f"launches in the training run: K3 {k3_step} per step "
        f"({trained['launches']['quant_pack']} in {TRAIN_STEPS} steps), "
        f"{trained['k3_s'] * 1e3:.3f} ms of device time per step in the "
        f"profiled step, {100 * trained['k3_s'] / trained['step_s']:.3f}% "
        f"of a {trained['step_s']:.4f} s step; K4 is reached by no path "
        f"(ops.byte_entropy is its entry), so 0")
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
    parts, rows, pred, total_gb, samples = make_inputs()
    recorded = {}
    table, cfgs, cuda_runs, launches = phase_main(
        torch, parts, rows, pred, total_gb, recorded)
    phase_cpu(torch, parts, rows, table, cfgs, cuda_runs)
    phase_reopt(torch, rows, pred, samples, table, cfgs, cuda_runs, smi_line)
    served = {}
    serve_launches = phase_serve(torch, served)
    trained = phase_train(torch)
    kernels = phase_kernels(torch, recorded, launches)
    kernels += phase_model_kernels(torch, served, serve_launches)
    kernels += phase_train_kernels(torch, trained)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

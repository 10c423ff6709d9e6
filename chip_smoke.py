#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU: SCOPe's placement
path, its re-optimization under drift, streaming placement, access
forecasting and the multi-tenant fleet solver, the re-optimization daemon
with its async migrator under injected faults, zamba2-2.7b serving, the
model zoo's MLA, MoE, cross-attention and encoder models serving
(deepseek-v2-lite-16b at full size), zamba2-2.7b served and trained by
two ranks that share the card, tensor parallel with its decode cache
sharded over them, zamba2-2.7b training with SCOPe-managed
checkpoints, and the placement system over two ranks (G-PART's overlap
matrix in row slabs, the fleet's tenant axis, restore onto a mesh) with
one cell of the production-mesh dry run.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its lines; any failure raises and the script exits
non-zero (with no result line):

1. device   the card's name and count, and ``nvidia-smi``'s name and power
            limit; no card is a failure.
2. build    all thirteen sources from ``src/repro_torch/kernels/csrc``
            (the seven TPU kernels, K5's wgmma kernel, K6's partials
            mode, the three wide attention sources and the fleet scan's
            usage sum), one nvcc per source, all started together
            (``-Xptxas -v`` register/shared-memory lines, build seconds);
            K6's split kernel at the serve loop's cache (registers, shared
            memory, stages, splits), K5's wgmma kernel at the zoo's and
            zamba2's widths (registers, spilled bytes, shared memory, keys
            a tile) and K2's cluster kernel at a replicated and a
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
            From phase 3 to the end of phase 9's TPC-H stream the host's
            string renderings of numeric columns and K2's class encodings
            are memoised by the columns' exact contents
            (``shared_renderings``): a later run that builds the same
            tables reuses them (the same arrays), so its stage seconds
            leave that host work out; K1, K2 and the solvers run on each
            device in every run.
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
            (torch.profiler), peak device memory; the capacitated solve
            must launch the ``usage_sum`` kernel once per dual-ascent step
            (counts zeroed before, read after), and at its first step's
            cells (T 1 x N 16,000, L 12) the kernel's sums equal the
            host's ``np.add.at`` bit for bit, with its time and device
            time, the plain version's, ``index_add_``'s and its bound.
            (5) ``MLP(hidden=(64,
            64), epochs=500)`` on the 80 labelled samples of phase main
            (zlib-6 ratios), from one initial parameter set on cuda and
            cpu: predictions within rel 1e-4 of the largest (the bar of
            ``tests/test_torch_ml.py``); the fit time on the card. Its
            lines end with the card's name and power limit.
9. stream   runs after phase 8, on phase main's inputs; each part on cuda
            and on cpu, its lines ending with the card's name and power
            limit. (1) ``benchmarks/bench_stream.py``'s large trace (760
            datasets, 18 months, seed 7) month by month through
            ``StreamingEngine`` (uncompressed, drift threshold 0.5):
            identical step counts, tiers and schemes, cents within rel
            1e-6; ms a month, compactions, fold merges, moves, steady
            cents. (2) Phase main's 217 query families as a compressed
            stream (the first half, then all of them with every other
            family's rho x3, then x0.3), file sizes from the file rows,
            re-predicted by ``compredict_rd_fn`` with device features and
            a RandomForest predictor (phase main's measured sample ratios;
            each codec's median decompression speed): K2 must launch
            (counts zeroed before, read after), cuda and cpu identical
            with the same predicted R and D (rel 1e-5), some scheme past
            "none"; seconds per batch split into partitioner,
            re-prediction and solve. Phase main's SVR predicts a ratio of
            1 (its floor) for every partition, whose sizes lie far beyond
            its samples, so no scheme could beat "none" under it. (3)
            ``train_tier_predictor`` on ``bench_access_predict.py``'s
            trace and an ``AccessForecaster`` fitted at month 15 of
            ``bench_forecast.py``'s enterprise trace, ``forecast_rho`` for
            months 15-29: identical labels, predicted tiers and forecasts
            (float64, exact); F1, ECE, seconds. (4) ``bench_fleet.py``'s
            fleets at T 8, 64 and 256 (mean N 24), its pinned
            shared-capacity fleet and one whose shared cap binds (T 256),
            ``FleetEngine.solve`` and ``reoptimize`` at T 128 against a
            per-tenant ``PlacementEngine`` loop, and T 1,024 at mean N
            120 (reduced from 200: the host finish grows as N squared):
            identical plans on cuda and cpu (at T 1,024 the scan's
            cells) and, uncoupled, to the per-tenant solves; the scan's
            device time (torch.profiler, outside the timed run), its
            operations on the card, the host finish, peak device memory.
            The T 1,024 solve must launch the ``usage_sum`` kernel once
            per scan step (counts zeroed before, read after); at its
            first step's cells the kernel's float32 row-order sums equal
            the host's ``np.add.at`` bit for bit, with its time, the
            plain version's, ``index_add_``'s and its bound.
10. daemon  runs after phase 9; each part on cuda and on cpu, its lines
            ending with the card's name and power limit, then its seconds.
            (1) ``benchmarks/bench_daemon.py``'s batch section (N 500,
            Azure, tiers 0-3, schemes none/lz4, 6 drift cycles and 4
            quiet), unbudgeted and at the bench's cap: identical reports
            and plans on cuda and cpu (cents within rel 1e-6), the capped
            spend at or under its cap every cycle. (2) The bench's large
            stream (760 datasets, 18 months, seed 7, uncompressed, drift
            threshold 0.5, ``rho_abs_tol`` 1.0) unbudgeted, at its
            ``tight`` and ``below_max_move`` caps: ms a cycle, cumulative
            cents against unbudgeted, moves, deferrals; cuda and cpu
            identical. (3) A fleet daemon over bench_fleet's engine tenants
            at T 64 (mean N 24), one shared knapsack at 40% of the
            unbudgeted peak, which binds. (4) ``bench_migrator.py``'s 96
            partitions (R from the payloads, D fixed per codec), its plan
            solved on cuda and on cpu (identical moves): zero faults give
            the store ``store.migrate`` gives; ``ChaosStore(seed=3)`` at
            ``p_transient`` 0.05, 0.2 and 0.4 with ``max_attempts`` 5 and no
            sleeping commits every move, its bill the fault-free bill plus
            the retry cents; the replan loop under ``p_permanent=1.0,
            seed=5`` converges (cycles, failed cents).
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
12. mesh   runs after phase 6, before 11. K6's partials mode at zamba2's
            shape (B 4, 32 heads of 80, a cache of 544 cut in two) and
            deepseek's latent shape (16 heads of 576, v inside k, 4,096
            cut in two), each slice at four (offset, window) settings
            against its plain version (m within 1e-5, l 1e-4, acc / l
            2e-2; rows without a visible key exact; the same bits
            twice), and 2 and 4 slices merged against unsharded K6 (2e-2,
            bf16); a rank's slice timed against its bound. Then two ranks
            (``torch.multiprocessing``, spawn) share the card:
            ``launch_mesh(1, 2)`` under torchrun's variables starts gloo
            (nccl refuses two ranks on one card), and each serves
            zamba2-2.7b at full width from seed 0, B 4, a prompt of 8 fed
            one token a step and 8 greedy tokens (reduced from a prompt of
            32: each tensor-parallel step makes 173 collectives through
            gloo), its decode cache's sequence sharded over 'model' (9 of
            18 slots a rank) and its
            shards of the weights (tensor parallel, ``param_specs``): the
            prefill through the mesh (K5 9, K7 54 launches), the serve
            loop (counts zeroed before, read after: K6 launched 9 times a
            step, every one in its partials mode; the all-reduces and
            all-gathers of a tensor-parallel step, ``_tp_collectives``,
            every tensor on cuda). Rank 0 runs the same prefill and loop
            unsharded on the whole weights (fed the sharded run's
            tokens): bf16 logits (prefill and loop) within 0.15
            normwise, as in phases serve and zoo, and greedy picks equal
            except at near-ties; the first 8 steps
            again in float32 (weights cast), within 1e-3. Both ranks'
            tokens equal; ms a step sharded and unsharded; the phase's
            seconds. The K6 entry of the kernel JSON line carries the
            partials rows under "partials", each with the launches at its
            shape: zamba2's 272-key slice those of phase 13's bf16 decode
            steps, deepseek's latent slice 0 (no path here decodes
            deepseek's latent cache at 2,048 of 4,096).
13. tp     runs after phase 12, before 11: two ranks share the card
            again (gloo), each cutting its shards by ``param_specs`` from
            the same seeded zamba2-2.7b (full width and depth, bf16):
            each rank's weight bytes, ``torch.cuda.memory_allocated`` for
            them (within 1%) and the reckoning from the specs (equal),
            and the peak ``torch.cuda.max_memory_allocated`` while they
            were drawn (each block cut as it is drawn: at most three of
            the largest block above the shards);
            prefill B 4 x 512 (K5 9, K7 54 launches, every collective
            counted); 4 decode steps from position 512 on the serve
            phase's 544-slot cache (272 a rank, filled at random) in bf16
            and on the weights cast to float32 (K6 partials 9 a step and
            the step's all-reduces and all-gathers exactly, all on cuda);
            one float32 train step at model 2 cut to one repeat unit (7
            blocks, batch 4 x 512; the trained shards gathered); rank 0
            runs each on the whole weights: bf16 logits within 0.15
            normwise with greedy picks equal except at near-ties,
            float32 within 1e-3, the loss within rel 2e-4 and the
            parameters within 5e-3. Then deepseek-v2-lite-16b at full
            width cut to 2 layers (reduced): MLA with the query heads
            gathered, expert-parallel MoE; prefill B 4 x 512 and 4 decode
            steps on a 544-slot latent cache against the whole weights at
            the sharded run's routing, replayed (0.15). Times a step
            sharded and unsharded; the phase's seconds.
11. zoo    runs after phase 13, before 7: deepseek-v2-lite-16b (full width
            and depth: 27 layers, MLA, 64 experts top-6 + 2 shared),
            whisper-small (full: 12 encoder + 12 decoder layers),
            llama4-scout-17b-a16e (full width, 8 of 48 layers) and
            llama-3.2-vision-90b (full width, 2 of 20 repeats: 10 layers),
            one after another in bfloat16, each from seed 0 on the card and
            freed before the next; contexts (4,100 patch embeddings,
            1,500 frames) from ``launch/shapes.py``'s shapes, seeded. Per
            config: a prefill of B 4 x 512 (whisper 128), K5 launched once
            per attention block (twice per decoder block, plus the
            encoder's); the serve loop (B 4, prompt 128, 32 new tokens:
            159 decode steps, whisper's with its encoded frames), K5 and K6
            counted at every step (K6 once per self-attention block, K5
            once per cross-attention, on ``flash_attention.split``; every
            prefill's K5 calls on ``flash_attention.wgmma``); logits
            finite, the bf16 prefill
            within 0.15 of the same prefill through the plain versions and
            greedy tokens equal except at near-ties; for deepseek one more
            decode step with K6's latent mode (v read inside k) against
            the plain version (0.15 on the logits, 2e-2 on K6's call, the
            same bits twice); prefill seconds, ms a step, peak memory and
            the card's busy share. Phase kernels then times K5 and K6 at
            every shape the zoo gave them, and K6's latent mode at kv_len
            4,096 too, against their bounds and SDPA (K5's rows with their
            route, the profiler's device time, mma.sync's (``bf16_tc``)
            device time at the same call and SDPA's); the kernel JSON line
            carries these rows under "zoo", and a row of each of K5's two
            zoo routes (``flash_attention.wgmma``, ``flash_attention.split``)
            at its largest shape, its launches summed over the zoo.
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
            (rel 1e-4 and normwise 1e-3). After the five steps, a
            checkpoint step: a cut of the trained state (the first repeat
            unit's leaves of the parameters and of AdamW's state up to
            750 MB; the full state's bytes printed beside it) saved
            through ``CheckpointManager(device="cuda")`` and restored onto
            the card bit for bit, every shard's sha256 checked (shards by
            (tier, codec), metered cents, save and restore seconds); the
            greedy (tier, codec) choice on cuda and on cpu from one
            measurement, identical; the lifecycle over three saves under
            Azure's prices (nothing moves: Archive is past the 120 s SLA)
            and ten under GCS's (older checkpoints move cooler, identically
            on cuda and cpu). Last, ``repro_torch.launch.train --smoke
            --ckpt-every 2 --steps 4`` on the card exits 0 with a
            ``ckpt bill:`` line. Runs after phase 6, before 14.
14. placement_mesh  runs after phase 7, before 5: the placement system
            over two ranks that share the card (gloo, spawned as phase
            mesh's). (1) G-PART's overlap matrix in row slabs over 'data'
            of a 2 x 1 mesh (``g_part(mesh=)``: each rank K1's rectangular
            sweep of its slab against every row, one launch, then one
            all-gather), on phase main's 217 families over 1,732 files and
            on phase kernels' 4,076 rows over 18,114 files: bit-identical
            to the unsharded matrix on the card, G-PART's partitions
            identical. (2) Phase stream's T 256 fleet whose shared cap
            binds, less its last tenant (T 255: rank 1 holds one dummy),
            through ``capacitated_assign_batch(mesh=)``: usage_sum launched
            once a step on each rank, one float64 all-reduce of the shared
            rows a step and one all-gather of the cells, all on cuda; the
            cells equal to the unsharded scan's at every step, the plans
            identical. (3) Phase train's checkpoint cut restored onto
            'model' of a 1 x 2 mesh (``restore(mesh=, shardings=)`` by
            ``param_specs`` and ZeRO-1's specs): each rank's pieces equal
            the slices of the unsharded restore, its device bytes (no more
            than its pieces: no whole sharded leaf on the card). (4) One
            dry-run cell (``repro_torch.launch.dryrun``, zamba2-2.7b
            decode_32k on pod16x16) in a subprocess on the host meanwhile:
            the rank's bytes and the three roofline terms. K1's row in the
            kernel JSON line carries the slabs' launches as
            ``mesh_launches``.
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
            call), one CUDA launch a call and no host sync. Last, the
            wide routes (on no config's path: 0 launches): K5 at D 320 /
            Dv 288 (bfloat16 through ``attention_wide_tc.cu``'s tensor
            cores, float32 through ``attention_wide.cu``; in bfloat16 also
            at Sq 100 of Sk 612, window 70, softcap 30, one KV head, D 640,
            Dv 300, which crosses every tile edge) and K6 at D 640 / Dv 576
            with v inside k (and its partials mode; bfloat16 through
            ``decode_attention_wide_tc.cu``'s tensor cores, float32
            through ``attention_wide.cu``), K7 at n 320 at chunk 64 and
            128 (bfloat16 on the tensor-core route in slabs of n, float32
            on the CUDA-core route), each in float32 and bfloat16 against
            its plain version (K5/K6: 2e-5 and 2e-2; K7 1e-4 and 2e-2),
            timed in bfloat16 beside the plain version, with its device
            time, registers, spills and shared memory a block and, for K5
            and K6, ``scaled_dot_product_attention`` and
            ``attention_wide.cu`` in bfloat16. Then shapes past the kernels'
            former limits: K2 over 70,000 partitions (two launches) and
            at 24 buckets against its float64 plain version, and
            ``usage_sum`` at 200 tiers bit for bit against ``np.add.at``.

The script takes no arguments: the sizes are fixed. The last three lines
are the kernel JSON line (K1-K7, K5's wgmma and split routes,
``usage_sum`` with its T 1 x N 16,000 row of phase reopt under
``scale_solve``, and the three wide routes), the
``nvidia-smi`` line and ``{"ok": true, "device": {...}}``.
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
#: K5's route at zamba2's bf16 prefill and training step (32 heads of 80:
#: TMA addresses it, the wgmma kernel takes it)
ZAMBA2_K5_ROUTE = "flash_attention.wgmma"
VARIANTS = ("Default (store on premium)", "SCOPe (No capacity constraint)",
            "SCOPe (Total cost focused)")
CARD = "cuda"                      # the device the main path runs on
SOURCES = {"overlap": ("src/repro_torch/kernels/csrc/overlap.cu",
                       "src/repro/kernels/overlap.py:137"),
           "entropy_features": ("src/repro_torch/kernels/csrc/entropy_features.cu",
                                "src/repro/kernels/entropy_features.py:183"),
           "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:103"),
           "flash_attention_wgmma": (
               "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
               "src/repro/kernels/flash_attention.py:103"),
           "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                "src/repro/kernels/decode_attention.py:84"),
           "attention_wide": ("src/repro_torch/kernels/csrc/attention_wide.cu",
                              "src/repro/kernels/flash_attention.py:103"),
           "attention_wide_tc": ("src/repro_torch/kernels/csrc/attention_wide_tc.cu",
                                 "src/repro/kernels/flash_attention.py:103"),
           "decode_attention_wide_tc": (
               "src/repro_torch/kernels/csrc/decode_attention_wide_tc.cu",
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


#: cycles of the sleep kernel that holds the card while the host enqueues
#: the calls :func:`fenced_ms` times (about 50 ms at the H100's clock)
FENCE_CYCLES = 100_000_000
#: the key of :func:`device_ms`'s breakdown when it fell back to
#: :func:`fenced_ms`
FENCED = "(CUDA events behind a queued sleep)"


def fenced_ms(fn, torch, iters: int = 20) -> float:
    """Milliseconds per call of ``fn`` between CUDA events around ``iters``
    calls queued behind a sleep kernel: the host enqueues every call while
    the card sleeps, so no host time lies between them (for an ``fn`` that
    does not wait for the card)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(FENCE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, torch, iters: int = 20, tries: int = 3):
    """(milliseconds of device time per call of ``fn``, {device operation:
    ms per call}) from torch.profiler over ``iters`` calls after one
    warm-up: the kernels alone, without the host's time between them. Each
    operation's time is its mean over the records the trace holds, times
    the records per call (at least one): a long run can lose records, and
    that mean does not move with them. A trace can also come back with no
    device record at all (seen late in a long run); then a fresh profiler
    tries again, up to ``tries`` in all, and if none holds a device record
    the time is :func:`fenced_ms`'s, under the key :data:`FENCED`."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = {}, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                total[e.name] = (total.get(e.name, 0.0)
                                 + e.device_time_total / 1e3)
                count[e.name] = count.get(e.name, 0) + 1
        if total:
            by = {k: total[k] / count[k] * max(1, round(count[k] / iters))
                  for k in total}
            return sum(by.values()), by
    ms = fenced_ms(fn, torch, iters)
    return ms, {FENCED: ms}


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


def shared_renderings():
    """Memoise the host work that serialisation and K2's dictionary
    encoding do on a table's values, by the exact contents of its columns
    (dtype, shape and bytes, checked equal on a hit): ``Table._col_str``
    (a numeric column's string rendering) and ``encode_dtype_classes`` (the
    sorted vocabulary of a batch of partition tables). The cuda and cpu
    runs of a path build the same tables, so the later runs reuse the first
    run's strings and codes (identical arrays) and their stage seconds
    leave that host work out; every device-dependent step (K1, K2, the
    solvers) still runs on both devices. Returns (counts, undo)."""
    import hashlib
    from repro_torch.core import compredict
    from repro_torch.data.tables import Table
    col_str, encode = Table._col_str, compredict.encode_dtype_classes
    memo, counts = {}, {"made": 0, "reused": 0}

    def key(arrays):
        h = hashlib.blake2b(digest_size=16)
        for a in arrays:
            h.update(f"{a.dtype.str}{a.shape}".encode())
            h.update(a.tobytes())
        return h.digest()

    def cached(kind, arrays, make):
        raw = [np.ascontiguousarray(a) for a in arrays]
        k = (kind, key(raw))
        hit = memo.get(k)
        if hit is not None and len(hit[0]) == len(raw) and all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(hit[0], raw)):
            counts["reused"] += 1
            return hit[1]
        counts["made"] += 1
        out = make()
        memo[k] = ([a.copy() for a in raw], out)
        return out

    def memo_col_str(self, v):
        if v.dtype.kind not in "iuf":
            return col_str(self, v)
        return cached("col", [v], lambda: col_str(self, v))

    def memo_encode(tables):
        cols = [c for t in tables for c in t.columns.values()]
        if any(c.dtype.kind == "O" for c in cols):
            return encode(tables)
        shapes = np.array([[t.num_rows, len(t.columns)] for t in tables])
        return cached("encode", [shapes, *cols], lambda: encode(tables))
    Table._col_str = memo_col_str
    compredict.encode_dtype_classes = memo_encode

    def undo():
        Table._col_str = col_str
        compredict.encode_dtype_classes = encode
        memo.clear()
    return counts, undo


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


def ptxas_report(build, name):
    """[(kernel, registers, spill line)] of source ``name`` from nvcc's
    ``-Xptxas -v`` output in this process's build."""
    out, fn, spill = [], None, ""
    for line in build.build_log.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), ""
        if "spill" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), spill))
            fn = None
    return out


def _ptxas_line(build, name, *parts) -> str:
    """The registers and spills of the kernels of ``name`` whose mangled
    names hold every one of ``parts``."""
    rows = [f"{r} registers ({sp})" for fn, r, sp in ptxas_report(build, name)
            if all(p in fn for p in parts)]
    return "; ".join(rows) if rows else "not in this build's log"


def phase_build(build):
    t0 = time.perf_counter()
    secs = build.build()
    for name in build.SOURCES:
        # one line per kernel: its registers and spills (-Xptxas -v)
        for fn, regs, spill in ptxas_report(build, name):
            say("build", f"{name}: {fn}: {regs} registers; {spill}")
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
    # K6's latent mode: deepseek-v2-lite's absorbed decode (phase zoo)
    il = da.decode_attention_info(ZOO_PROMPT + ZOO_NEW + 1, 16, 1, 576, 512,
                                  torch.bfloat16, B=ZOO_BATCH, aliased=True)
    say("build", f"decode_attention split kernel in its latent mode (B "
        f"{ZOO_BATCH}, S {ZOO_PROMPT + ZOO_NEW + 1}, 16 query heads of 576 "
        f"on one KV head, v = its first 512 columns, bf16): "
        f"{il['registers']} registers, {il['smem_bytes']:,} bytes of shared "
        f"memory per block, {il['stages']} stage(s) a warp, {il['group']} "
        f"query heads a block; splits of {il['split']} keys, "
        f"{il['splits']} splits")
    # K5's wgmma kernel at the widths the zoo and zamba2 give it
    from repro_torch.kernels import flash_attention as fa
    for D, Dv in ((64, 64), (80, 80), (128, 128), (192, 128), (256, 256)):
        i5 = fa.flash_attention_wgmma_info(D, Dv)
        say("build", f"flash_attention_wgmma at D {D}, Dv {Dv}: "
            f"{i5['registers']} registers, {i5['spill_bytes']} bytes spilled "
            f"a thread, {i5['smem_bytes']:,} bytes of shared memory a block, "
            f"{i5['block_k']} keys a tile")
    # the main path's class 2 and class 1 shapes (V values, M codes)
    for V, M in ((15_005, 1_200_000), (583_182, 1_800_000)):
        i2 = ef.weighted_entropy_features_info(V, M=M)
        say("build", f"entropy_features at V {V:,}, M {M:,}, one bucket: "
            f"{'replicated' if i2['replicated'] else 'distributed'} plan, "
            f"{i2['slices']} slice(s) of {i2['span']:,} values; cluster of "
            f"{i2['cluster']} blocks ({i2['max_active_clusters']} such "
            f"clusters fit on the card at once), {i2['registers']} registers, "
            f"{i2['smem_bytes']:,} bytes of shared memory per block")


def _fitted(pred, dsets, dspeed=None):
    """``pred`` fitted as ``CompressionPredictor.fit`` fits it, on the
    labelled sets ``dsets`` (one per codec, measured once); ``dspeed``, where
    given, replaces each set's measured decompression speeds by one value
    per codec."""
    from repro_torch.core.compredict import MODELS
    for ds in dsets:
        y_d = (ds.dspeed if dspeed is None
               else np.full_like(ds.dspeed, dspeed[ds.scheme]))
        for target, y in (("ratio", ds.ratio), ("dspeed", y_d)):
            m = MODELS[pred.model_name](pred.device)
            m.fit(ds.X, y)
            pred.models[(ds.scheme, ds.layout, target)] = m
    return pred


def make_inputs():
    """Phase main's TPC-H data, its 80 query samples, the SVR predictor
    fitted on them and the stream's forest (phase 9), both from one
    measurement of the samples under every codec."""
    from repro_torch.core.compredict import (CompressionPredictor,
                                             build_dataset, query_samples)
    from repro_torch.data import tpch
    from repro_torch.storage.codecs import available_schemes, default_codecs
    t0 = time.perf_counter()
    db = tpch.generate(scale_rows=SCALE_ROWS, seed=SEED)
    qs = tpch.generate_queries(db, n_per_template=20, seed=SEED + 1,
                               rows_per_file=500)
    parts, rows = tpch.partitions_from_queries(db, qs, rows_per_file=500)
    t1 = time.perf_counter()
    samples = query_samples(qs, db.tables, max_rows=6000)[:80]
    dsets = [build_dataset(samples, c, "col") for c in default_codecs()
             if c.name != "none"]
    pred = _fitted(CompressionPredictor(model_name="SVR"), dsets)
    # the stream's forest, for the schemes its config takes: the measured
    # ratios, and each codec's median decompression speed, so that no
    # timing noise reaches its splits
    forest = _fitted(CompressionPredictor(model_name="RandomForest"),
                     [ds for ds in dsets if ds.scheme in available_schemes()],
                     {ds.scheme: float(np.median(ds.dspeed))
                      for ds in dsets})
    t2 = time.perf_counter()
    total_gb = sum(p.span for p in parts) / 1e9
    say("main", f"TPC-H scale_rows={SCALE_ROWS:,}: {len(qs)} queries, "
        f"{len(parts)} query-family partitions over {len(rows):,} files, "
        f"{total_gb:.4f} GB of family spans; data {t1 - t0:.1f} s, "
        f"predictors (measurement and fits) {t2 - t1:.1f} s")
    return parts, rows, pred, total_gb, samples, forest


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
            wrap(optassign, "_batch_candidate_finish", "repair+local search"),
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
        t, n_usage = {}, {}
        for step in ("solve", "reoptimize"):
            undo = _timed_stages(torch, e, optassign, secs[step], scans[step])
            try:
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                if step == "solve":
                    plan_s = e.solve(prob)
                else:
                    mig_s = e.reoptimize(plan_s, _drift(prob.rho, N + 1),
                                         months_held=MONTHS_HELD)
                torch.cuda.synchronize()
                t[step] = time.perf_counter() - t0
                n_usage[step] = ops.launch_counts["usage_sum"]
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
        if capped_run:
            steps = sum(int(a[6]) for a in scans["solve"])
            check(steps > 0 and n_usage["solve"] == steps,
                  f"N {N:,} capped: {n_usage['solve']} usage_sum launches "
                  f"in {steps} dual-ascent steps of the solve")
            a = scans["solve"][0]
            usage = _usage_row(torch, a[0][None], a[1][None],
                               n_usage["solve"], card, "reopt",
                               f"the capacitated scale solve (N {N:,})")
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
    return usage


# ------------------------------------------------------------- stream phase
STREAM_TRACE = (760, 18, 7)          # bench_stream's "large" trace
PREDICT_TRACE = (760, 24, 7)         # bench_access_predict's trace
FORECAST_TRACE = (150, 30, 11)       # bench_forecast's "enterprise" trace
FORECAST_PATTERNS = {"decreasing": 0.2, "constant": 0.1, "periodic": 0.35,
                     "spike": 0.15, "cold": 0.2}
FORECAST_FIT_MONTH = 15
# the TPC-H stream's batches after the first: every other family's rho
# times each factor (three of the four batches the first design had: each
# batch re-renders every partition's values on the host, ~15 s a device)
TPCH_STREAM_RHO = (3.0, 0.3)
FLEET_T = (8, 64, 256)               # bench_fleet's fleets, mean N 24
FLEET_MEAN_N = 24
ENGINE_T = 128
# the scale point: T 1,024 at mean N 120, reduced from 200, where the host
# finish (the lockstep 1-swap search, N squared) took 105.5 s on the host
# of an NVIDIA H100 80GB HBM3 (700.00 W) machine
SCALE_T, SCALE_MEAN_N = 1_024, 120


def _same_stream(a, b, what):
    """Two ``StreamingEngine`` runs: identical step counts, tiers and
    schemes in every batch, cents within rel 1e-6. Returns the largest
    relative cents difference."""
    check(len(a) == len(b), f"{what}: {len(a)} and {len(b)} batches")
    worst = 0.0
    for i, ((ra, ma), (rb, mb)) in enumerate(zip(a, b)):
        for f in ("n_partitions", "n_new", "n_moved", "compacted",
                  "n_deferred"):
            check(getattr(ra, f) == getattr(rb, f),
                  f"{what}, batch {i}: {f} differs between cuda and cpu")
        check(np.array_equal(ma.plan.assignment.tier, mb.plan.assignment.tier)
              and np.array_equal(ma.plan.assignment.scheme,
                                 mb.plan.assignment.scheme),
              f"{what}, batch {i}: cuda and cpu tiers or schemes differ")
        for f in ("steady_cents", "migration_cents", "penalty_cents"):
            x, y = getattr(ra, f), getattr(rb, f)
            r = abs(x - y) / abs(y) if y else abs(x)
            check(r <= 1e-6, f"{what}, batch {i}: {f} differs by rel {r}")
            worst = max(worst, r)
    return worst


def _stream_run(torch, E, stream_mod, table, cfg, sizes, batches,
                rd_fn=None):
    """One ``StreamingEngine`` over ``batches``: [(report, migration)],
    the engine, and the host seconds of each batch split into partitioner
    (ingest and compact), re-prediction (``rd_fn``) and the rest (the
    solve, with its billing and bookkeeping)."""
    secs = []
    part = {"s": 0.0}
    cls = stream_mod.StreamingPartitioner
    orig = {n: getattr(cls, n) for n in ("ingest", "compact")}

    def timed(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            part["s"] += time.perf_counter() - t0
            return out
        return run

    rd = {"s": 0.0}
    if rd_fn is not None:
        inner = rd_fn

        def rd_fn(parts, schemes):
            t0 = time.perf_counter()
            out = inner(parts, schemes)
            torch.cuda.synchronize()
            rd["s"] += time.perf_counter() - t0
            return out
    eng = E.StreamingEngine(table, cfg, sizes, drift_threshold=0.5,
                            rd_fn=rd_fn)
    out = []
    for n, fn in orig.items():
        setattr(cls, n, timed(fn))
    try:
        for batch in batches:
            part["s"] = rd["s"] = 0.0
            t0 = time.perf_counter()
            mig = eng.ingest_and_reoptimize(batch, months=1.0)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            out.append((eng.history[-1], mig))
            secs.append({"partitioner": part["s"], "re-prediction": rd["s"],
                         "solve": total - part["s"] - rd["s"],
                         "total": total})
    finally:
        for n, fn in orig.items():
            setattr(cls, n, fn)
    return out, eng, secs


def _bench_fleet(T, mean_n, seed, K=3):
    """``benchmarks/bench_fleet.py``'s ``_fleet``: T ragged Azure tenants
    (N uniform in [mean_n / 2, 2 mean_n)), K 3, each with its hottest
    greedy tier capped at 90% of its greedy use."""
    from repro_torch.core.costs import (Weights, azure_table, cost_tensor,
                                        latency_feasible)
    rng = np.random.default_rng(seed)
    table = azure_table()
    out = []
    for _ in range(T):
        N = int(rng.integers(max(1, mean_n // 2), 2 * mean_n))
        spans = rng.uniform(0.5, 50.0, N)
        rho = rng.gamma(1.0, 20.0, N)
        cur = rng.integers(-1, table.num_tiers, N)
        R = np.concatenate([np.ones((N, 1)),
                            rng.uniform(1.2, 6.0, (N, K - 1))], 1)
        D = np.concatenate([np.zeros((N, 1)),
                            rng.uniform(0.01, 3.0, (N, K - 1))], 1)
        lat = rng.choice([0.1, 1.0, 5.0, np.inf], N)
        cost = cost_tensor(spans, rho, cur, R, D, table, Weights(), months=6)
        feas = latency_feasible(D, lat, table)
        stored = np.repeat((spans[:, None] / R)[:, None, :],
                           table.num_tiers, 1)
        flat = np.where(feas, cost, np.inf).reshape(N, -1)
        t, s = flat.argmin(1) // K, flat.argmin(1) % K
        use = np.zeros(table.num_tiers)
        np.add.at(use, t, stored[np.arange(N), t, s])
        cap = np.full(table.num_tiers, np.inf)
        cap[use.argmax()] = 0.9 * use.max()
        out.append((cost, feas, stored, cap))
    return out


def _same_fleet(a, b, what):
    """Two fleet solves: identical feasibility, tiers and schemes for each
    tenant, cents within rel 1e-6."""
    check(a.feasible == b.feasible, f"{what}: feasibility differs")
    for t, (x, y) in enumerate(zip(a.assignments, b.assignments)):
        check(np.array_equal(x.tier, y.tier)
              and np.array_equal(x.scheme, y.scheme),
              f"{what}: tenant {t}'s tiers or schemes differ")
        r = (abs(x.cost - y.cost) / max(abs(y.cost), 1e-300)
             if np.isfinite(y.cost) else float(np.isfinite(x.cost)))
        check(r <= 1e-6, f"{what}: tenant {t}'s cents differ by rel {r}")


def _fleet_solve(torch, optassign, cols, dev, **kw):
    """``capacitated_assign_batch`` on ``dev``: (fleet, seconds, scan
    seconds, the scan's arguments or None)."""
    box = {"s": 0.0, "args": None}
    scan = optassign._fleet_scan

    def timed(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scan(*a)
        torch.cuda.synchronize()
        box["s"] += time.perf_counter() - t0
        box["args"] = a
        return out
    optassign._fleet_scan = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fl = optassign.capacitated_assign_batch(*cols, device=dev, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
    finally:
        optassign._fleet_scan = scan
    return fl, t, box["s"], box["args"]


def _scan_numbers(torch, optassign, args, top=0):
    """The scan's device ms (torch.profiler, outside the timed run), with
    its ``top`` costliest device operations, and its operations on the
    card per call."""
    fn = lambda: optassign._fleet_scan(*args)
    ms, by = device_ms(fn, torch, iters=1)
    n = launches_per_call(fn, torch, iters=1)
    if ms is None:
        return "not measured (no device records)", n
    most = dict(sorted(by.items(), key=lambda kv: -kv[1])[:top])
    return f"{ms:.3f} ms" + (f" ({_short(most)})" if most else ""), n


def _engine_problems(E, T, mean_n, table, cfg, seed=1, K=2):
    """``bench_fleet._problems``: T ragged tenants, lognormal spans."""
    rng = np.random.default_rng(seed)
    probs = []
    for _ in range(T):
        N = int(rng.integers(max(1, mean_n // 2), 2 * mean_n))
        spans = rng.lognormal(0.0, 1.2, N) * 50.0
        rho = rng.gamma(0.7, 25.0, N)
        R = np.concatenate([np.ones((N, 1)),
                            rng.uniform(1.2, 6.0, (N, K - 1))], 1)
        D = np.concatenate([np.zeros((N, 1)),
                            rng.uniform(0.01, 2.0, (N, K - 1))
                            * spans[:, None]], 1)
        probs.append(E.PlacementProblem(
            spans_gb=spans, rho=rho, current_tier=np.full(N, -1), R=R, D=D,
            schemes=cfg.schemes, table=table, cfg=cfg))
    return probs


def phase_stream(torch, parts, rows, forest, smi_line, renders):
    """Streaming placement, access forecasting and the multi-tenant fleet
    solver (phase 9); ``forest`` re-predicts the TPC-H stream. ``renders``
    is :func:`shared_renderings`'s (counts, undo): its memo ends with the
    TPC-H stream, the last host work the cuda and cpu runs share."""
    from repro_torch.core import access_predict as ap
    from repro_torch.core import engine as E
    from repro_torch.core import forecast as fcm
    from repro_torch.core import optassign, stream
    from repro_torch.core.costs import azure_table
    from repro_torch.core.fleet import FleetEngine
    from repro_torch.data import workloads as wl
    from repro_torch.kernels import ops
    card = f"| {smi_line}"
    t_phase = time.perf_counter()
    table = azure_table()

    # 1. the enterprise access-log stream, month by month
    n_ds, n_mo, seed = STREAM_TRACE
    w = wl.generate_workload(n_datasets=n_ds, n_months=n_mo, seed=seed)
    sizes = wl.dataset_file_sizes(w)
    batches = [b for b in wl.stream_query_log(w, np.random.default_rng(seed))
               if b]
    runs = {}
    for dev in (CARD, "cpu"):
        cfg = E.ScopeConfig(use_compression=False, months=1.0, device=dev)
        runs[dev] = _stream_run(torch, E, stream, table, cfg, sizes, batches)
    rel = _same_stream(runs[CARD][0], runs["cpu"][0], "enterprise stream")
    eng = runs[CARD][1]
    st = eng.partitioner.stats
    hist = eng.history
    per = {d: 1e3 * sum(s["total"] for s in runs[d][2]) / len(batches)
           for d in runs}
    say("stream", f"enterprise stream (bench_stream's large trace: "
        f"{n_ds} datasets, {n_mo} months, seed {seed}; {len(sizes):,} files, "
        f"{eng.partitioner.n_families:,} families): {len(batches)} months, "
        f"{hist[-1].n_partitions} partitions at the end, "
        f"{st.n_compactions} compactions, {st.n_fold_merges} fold merges, "
        f"{sum(r.n_new for r in hist)} new, {sum(r.n_moved for r in hist)} "
        f"moves, migration {sum(m.total_move_cents for _, m in runs[CARD][0])!r}"
        f" cents, steady {hist[-1].steady_cents!r} cents; "
        f"{per[CARD]:.2f} ms/month on cuda, {per['cpu']:.2f} on cpu; "
        f"cuda and cpu identical steps, tiers and schemes, cents rel "
        f"{rel:.3e} {card}")
    for dev in (CARD, "cpu"):
        say("stream", f"enterprise stream, {dev} ms/month by stage: "
            + ", ".join(f"{k} {1e3 * sum(s[k] for s in runs[dev][2]) / len(batches):.2f}"
                        for k in ("partitioner", "solve")))

    # 2. a compressed TPC-H stream: COMPREDICT re-predicts on the card
    fams = [(tuple(sorted(p.files)), p.rho) for p in parts]
    t0 = time.perf_counter()
    fsizes = {f: rows[f][0].select(rows[f][1]).nbytes("col") / 1e9
              for f in sorted({f for p in parts for f in p.files})}
    t_sizes = time.perf_counter() - t0
    tb = [fams[:len(fams) // 2]] + [
        [(f, r * (mult if i % 2 else 1.0)) for i, (f, r) in enumerate(fams)]
        for mult in TPCH_STREAM_RHO]
    runs = {}
    for dev in (CARD, "cpu"):
        # phase main's billing window (the paper's 5.5 months) and schemes
        cfg = E.ScopeConfig(device=dev)
        rd = E.compredict_rd_fn(forest, rows, feature_backend="device",
                                device=dev)
        if dev == CARD:
            ops.reset_launch_counts()
        runs[dev] = _stream_run(torch, E, stream, table, cfg, fsizes, tb, rd)
        if dev == CARD:
            launches = dict(ops.launch_counts)
    rel = _same_stream(runs[CARD][0], runs["cpu"][0], "TPC-H stream")
    say("stream", f"launches in the compressed TPC-H stream (cuda run): "
        f"{launches}")
    check(launches.get("entropy_features", 0) > 0,
          "kernel entropy_features was not launched by the stream path")
    # the predicted ratios and decompression times, K2's features on the
    # card against the plain version's on the CPU (the kernel tolerance)
    last = runs[CARD][0][-1][1].plan
    ref = runs["cpu"][0][-1][1].plan.problem
    check(np.allclose(last.problem.R, ref.R, rtol=1e-5, atol=0)
          and np.allclose(last.problem.D, ref.D, rtol=1e-5, atol=1e-12),
          "TPC-H stream: the re-predicted R or D differ between cuda and cpu")
    schemes = last.problem.schemes
    used = np.bincount(last.assignment.scheme, minlength=len(schemes))
    check(used[1:].sum() > 0, "TPC-H stream: no partition compressed")
    R = last.problem.R[:, 1:]
    say("stream", f"TPC-H stream, last batch: predicted ratios "
        f"{float(R.min())!r} to {float(R.max())!r} over {R.shape[0]} "
        f"partitions x {R.shape[1]} codecs (RandomForest; the ratios "
        f"measured on phase main's samples, each codec's median "
        f"decompression speed)")
    say("stream", f"TPC-H SF0.1 stream ({len(fams)} query families over "
        f"{len(fsizes):,} files, file sizes {t_sizes:.1f} s): batches of "
        f"{[len(b) for b in tb]} families (the first half, then all with "
        f"every other rho x{', x'.join(map(str, TPCH_STREAM_RHO))}); "
        f"partitions "
        f"{[r.n_partitions for r, _ in runs[CARD][0]]}, moves "
        f"{[r.n_moved for r, _ in runs[CARD][0]]}, compacted "
        f"{[r.compacted for r, _ in runs[CARD][0]]}, steady "
        f"{[r.steady_cents for r, _ in runs[CARD][0]]} cents; schemes of "
        f"the last plan {dict(zip(schemes, used.tolist()))}; cuda and cpu "
        f"identical, cents rel {rel:.3e} {card}")
    for dev in (CARD, "cpu"):
        say("stream", f"TPC-H stream on {dev}, seconds per batch: "
            + "; ".join(f"batch {i}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in s.items())
                for i, s in enumerate(runs[dev][2])))
    counts, undo = renders
    undo()
    say("stream", f"column renderings and class encodings in phases main "
        f"to stream: {counts['made']:,} made, {counts['reused']:,} reused "
        f"(the same arrays; the later runs' partition, compress and "
        f"re-prediction seconds leave that host work out)")

    # 3. access forecasting
    n_ds, n_mo, seed = PREDICT_TRACE
    w = wl.generate_workload(n_datasets=n_ds, n_months=n_mo, seed=seed,
                             size_lognorm=(4.5, 2.0))
    out, t = {}, {}
    for dev in (CARD, "cpu"):
        t0 = time.perf_counter()
        clf, rep = ap.train_tier_predictor(w, table, train_month=12,
                                           horizon=2, device=dev)
        torch.cuda.synchronize()
        t[dev] = time.perf_counter() - t0
        labels = [ap.optimal_tiers(w, table, lo, lo + 2, (1, 2), device=dev)
                  for lo in (12, 14)]
        out[dev] = (rep, labels, ap.predicted_tiers(clf, w, 14))
    (ra, la, pa), (rb, lb, pb) = out[CARD], out["cpu"]
    check(all(np.array_equal(x, y) for x, y in zip(la, lb))
          and np.array_equal(pa, pb)
          and np.array_equal(ra.confusion, rb.confusion) and ra.f1 == rb.f1,
          "train_tier_predictor: cuda and cpu labels or predictions differ")
    say("stream", f"train_tier_predictor (bench_access_predict's trace: "
        f"{n_ds} datasets, {n_mo} months, seed {seed}, train month 12, "
        f"horizon 2): F1 {ra.f1!r}, accuracy {ra.accuracy!r}, confusion "
        f"{ra.confusion.tolist()}; {t[CARD]:.3f} s on cuda, {t['cpu']:.3f} s "
        f"on cpu; labels and predicted tiers identical {card}")
    n_ds, n_mo, seed = FORECAST_TRACE
    w = wl.generate_workload(n_datasets=n_ds, n_months=n_mo, seed=seed,
                             pattern_probs=FORECAST_PATTERNS)
    obs = lambda m: np.array([float(d.reads[m]) for d in w.datasets])
    out, t = {}, {}
    for dev in (CARD, "cpu"):
        fc = fcm.AccessForecaster(table, tiers=(1, 2), horizon=2, history=4,
                                  n_trees=24, refit_every=4, seed=0,
                                  device=dev)
        t0 = time.perf_counter()
        rep = fc.fit(w, fit_month=FORECAST_FIT_MONTH)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        fc.bind(month0=FORECAST_FIT_MONTH - 1)
        preds, steps = [], []
        for m in range(FORECAST_FIT_MONTH, n_mo):
            window = [obs(j) for j in range(max(FORECAST_FIT_MONTH - 1,
                                                m - 12), m)]
            t0 = time.perf_counter()
            preds.append(fc.forecast_rho(window))
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        out[dev] = (rep, preds, list(fc.refits_))
        t[dev] = (t_fit, steps)
    (ra, pa, fa), (rb, pb, fb) = out[CARD], out["cpu"]
    check(dataclasses.asdict(ra) == dataclasses.asdict(rb) and fa == fb
          and all(np.array_equal(x, y) for x, y in zip(pa, pb)),
          "AccessForecaster: cuda and cpu fits or forecasts differ")
    say("stream", f"AccessForecaster (bench_forecast's enterprise trace: "
        f"{n_ds} datasets, {n_mo} months, seed {seed}; 24 trees, refit "
        f"every 4) fit at month {FORECAST_FIT_MONTH}: {ra.n_rows} rows, "
        f"calibrated {ra.calibrated}, accuracy {ra.accuracy!r}, ECE raw "
        f"{ra.ece_raw!r}, calibrated {ra.ece_cal!r}, hot rho {ra.hot_rho!r}; "
        f"forecasts for months {FORECAST_FIT_MONTH}-{n_mo - 1} (refits at "
        f"{fa}) identical on cuda and cpu (float64, exact) {card}")
    say("stream", f"AccessForecaster seconds: fit {t[CARD][0]:.3f} cuda, "
        f"{t['cpu'][0]:.3f} cpu; forecast_rho per month (cuda) "
        f"{[round(x, 4) for x in t[CARD][1]]}")

    # 4. the fleet solver
    for T in FLEET_T:
        fleet = _bench_fleet(T, FLEET_MEAN_N, T)
        cols = [[x[i] for x in fleet] for i in range(4)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk, tk, sk, args = _fleet_solve(torch, optassign, cols, CARD)
        peak = torch.cuda.max_memory_allocated()
        fc_, tc_, _, _ = _fleet_solve(torch, optassign, cols, "cpu")
        _same_fleet(fk, fc_, f"fleet T {T}")
        t0 = time.perf_counter()
        singles = [optassign.capacitated_assign(c, f, s, cap, device=CARD)
                   for c, f, s, cap in fleet]
        torch.cuda.synchronize()
        t_loop = time.perf_counter() - t0
        check(all(np.array_equal(a.tier, b.tier)
                  and np.array_equal(a.scheme, b.scheme) and a.cost == b.cost
                  for a, b in zip(singles, fk.assignments)),
              f"fleet T {T}: the batch differs from the per-tenant solves")
        dev_ms, n_ops = _scan_numbers(torch, optassign, args)
        n_max = max(c.shape[0] for c in cols[0])
        say("stream", f"fleet T {T} (bench_fleet's recipe, seed {T}, mean N "
            f"{FLEET_MEAN_N}, N_max {n_max}): feasible {fk.feasible}, "
            f"{fk.cost!r} cents; batch {tk:.3f} s on cuda (scan {sk:.3f} s, "
            f"host finish {tk - sk:.3f} s), {tc_:.3f} s on cpu; per-tenant "
            f"loop on cuda {t_loop:.3f} s; scan device time {dev_ms}, "
            f"{n_ops:.0f} operations on the card per scan; peak device "
            f"memory {peak / 1e6:.2f} MB; identical to cpu and to the "
            f"per-tenant solves {card}")

    # the shared-capacity fleets at the largest T: the benchmark's (each
    # tenant's partition 0 pinned to tier 0, the pool at 1.15x the pinned
    # demand) and one whose shared cap binds the greedy plan (the most
    # used tier at 70% of its greedy use, tenants' own caps lifted)
    T = FLEET_T[-1]
    L = table.num_tiers
    pinned_fleet, pinned = [], 0.0
    for c, f, s, _ in _bench_fleet(T, FLEET_MEAN_N, 2):
        f = f.copy()
        f[0, :, :] = False
        f[0, 0, 0] = True
        pinned += s[0, 0, 0]
        pinned_fleet.append((c, f, s, np.full(L, np.inf)))
    scap0 = np.full(L, np.inf)
    scap0[0] = 1.15 * pinned
    fleet = _bench_fleet(T, FLEET_MEAN_N, T)
    use = np.zeros(L)
    for c, f, s, _ in fleet:
        cell = np.where(f, c, optassign.BIG).reshape(c.shape[0], -1).argmin(1)
        use += optassign._chosen_usage(s, cell // 3, cell % 3)
    scap1 = np.full(L, np.inf)
    scap1[use.argmax()] = 0.7 * use.max()
    lifted = [(c, f, s, np.full(L, np.inf)) for c, f, s, _ in fleet]
    for tag, fl, scap in (("pinned pool (bench_fleet)", pinned_fleet, scap0),
                          ("binding 70% cap", lifted, scap1)):
        cols = [[x[i] for x in fl] for i in range(4)]
        kw = dict(shared_tier_groups=np.arange(L), shared_capacity_gb=scap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk, tk, sk, args = _fleet_solve(torch, optassign, cols, CARD, **kw)
        peak = torch.cuda.max_memory_allocated()
        fc_, tc_, _, _ = _fleet_solve(torch, optassign, cols, "cpu", **kw)
        _same_fleet(fk, fc_, f"shared fleet T {T}, {tag}")
        check(np.allclose(fk.shared_use_gb, fc_.shared_use_gb, rtol=1e-9)
              and fk.feasible, f"shared fleet T {T}, {tag}: infeasible or "
              f"its shared use differs")
        scan_txt = "the greedy plan fits: no scan"
        if args is not None:
            dev_ms, n_ops = _scan_numbers(torch, optassign, args)
            scan_txt = (f"scan {sk:.3f} s, device time {dev_ms}, {n_ops:.0f} "
                        f"operations on the card")
        say("stream", f"shared-capacity fleet T {T}, {tag}: cap "
            f"{scap[np.isfinite(scap)].tolist()} GB, fleet use "
            f"{fk.shared_use_gb[np.isfinite(scap)].tolist()} GB, feasible "
            f"{fk.feasible}, {fk.cost!r} cents; {tk:.3f} s on cuda "
            f"({scan_txt}), {tc_:.3f} s on cpu; peak device memory "
            f"{peak / 1e6:.2f} MB; identical on cuda and cpu {card}")

    # FleetEngine against a per-tenant PlacementEngine loop
    caps = np.array([150.0, 300.0, 2500.0, np.inf])
    plans, migs, t = {}, {}, {}
    for dev in (CARD, "cpu"):
        cfg = E.ScopeConfig(schemes=("none", "lz4"), capacity_gb=caps,
                            device=dev)
        probs = _engine_problems(E, ENGINE_T, FLEET_MEAN_N, table, cfg)
        fe = FleetEngine(table, cfg)
        t0 = time.perf_counter()
        plans[dev] = fe.solve(probs)
        torch.cuda.synchronize()
        t[dev, "solve"] = time.perf_counter() - t0
        rhos = [_drift(p.rho, i) for i, p in enumerate(probs)]
        t0 = time.perf_counter()
        migs[dev] = fe.reoptimize(plans[dev].plans, rhos,
                                  months_held=MONTHS_HELD)[0]
        torch.cuda.synchronize()
        t[dev, "reoptimize"] = time.perf_counter() - t0
        if dev == CARD:
            pe = E.PlacementEngine(table, cfg)
            t0 = time.perf_counter()
            loop = [pe.solve(p) for p in probs]
            torch.cuda.synchronize()
            t["loop", "solve"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            loop_m = [pe.reoptimize(pl, r, months_held=MONTHS_HELD)
                      for pl, r in zip(loop, rhos)]
            torch.cuda.synchronize()
            t["loop", "reoptimize"] = time.perf_counter() - t0
            for a, b in zip(loop, plans[dev].plans):
                _same_plan(a, b, "FleetEngine.solve against the loop")
            for a, b in zip(loop_m, migs[dev]):
                _same_migration(a, b, "FleetEngine.reoptimize against the "
                                "loop")
    for a, b in zip(plans[CARD].plans, plans["cpu"].plans):
        _same_plan(a, b, "FleetEngine.solve")
    for a, b in zip(migs[CARD], migs["cpu"]):
        _same_migration(a, b, "FleetEngine.reoptimize")
    say("stream", f"FleetEngine, T {ENGINE_T} (bench_fleet's engine "
        f"problems, caps {caps.tolist()} GB): solve {t[CARD, 'solve']:.3f} s "
        f"on cuda, {t['cpu', 'solve']:.3f} s on cpu, PlacementEngine loop "
        f"{t['loop', 'solve']:.3f} s; {plans[CARD].total_cents!r} cents; "
        f"reoptimize (bench_reoptimize's drift) {t[CARD, 'reoptimize']:.3f} s "
        f"on cuda, {t['cpu', 'reoptimize']:.3f} s on cpu, loop "
        f"{t['loop', 'reoptimize']:.3f} s, "
        f"{sum(m.n_moved for m in migs[CARD])} moves; identical to cpu and "
        f"to the loop {card}")

    # the scale point
    say("stream", f"reduced: the scale point's mean N 200 -> {SCALE_MEAN_N} "
        f"(its host finish grows as N squared)")
    fleet = _bench_fleet(SCALE_T, SCALE_MEAN_N, SCALE_T)
    cols = [[x[i] for x in fleet] for i in range(4)]
    n_max = max(c.shape[0] for c in cols[0])
    mb = 2 * SCALE_T * n_max * L * 3 * 4 / 1e6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    fk, tk, sk, args = _fleet_solve(torch, optassign, cols, CARD)
    n_usage = ops.launch_counts["usage_sum"]
    peak = torch.cuda.max_memory_allocated()
    check(fk.feasible, f"fleet T {SCALE_T}: infeasible")
    check(n_usage == args[9], f"fleet T {SCALE_T}: the usage-sum kernel "
          f"launched {n_usage} times in {args[9]} scan steps")
    t0 = time.perf_counter()
    cells_cpu = optassign._fleet_scan(*args[:-1], torch.device("cpu"))
    t_cpu_scan = time.perf_counter() - t0
    check(np.array_equal(optassign._fleet_scan(*args), cells_cpu),
          f"fleet T {SCALE_T}: the scan's cells differ between cuda and cpu")
    dev_ms, n_ops = _scan_numbers(torch, optassign, args, top=4)
    say("stream", f"fleet T {SCALE_T:,}, mean N {SCALE_MEAN_N} (N_max "
        f"{n_max}, {mb:.1f} MB of float32 cost and stored on the card): "
        f"feasible, {fk.cost!r} cents; {tk:.3f} s on cuda (scan {sk:.3f} s, "
        f"host finish {tk - sk:.3f} s); scan device time {dev_ms}, "
        f"{n_ops:.0f} operations on the card per scan; peak device memory "
        f"{peak / 1e6:.2f} MB; the scan's cells identical on the cpu "
        f"({t_cpu_scan:.3f} s there), so the host finish gives the same "
        f"plans {card}")
    usage = _usage_row(torch, args[0], args[1], n_usage, card, "stream",
                       "the scale fleet")
    say("stream", f"phase stream took {time.perf_counter() - t_phase:.1f} s")
    return usage


def _usage_row(torch, m, s, launches, card, phase, what):
    """The fleet scan's usage-sum kernel at a scan's first step (the cells
    of zero multipliers) of ``m``, ``s`` (T, N, L, K): bit for bit the
    host's float32 sums in row order, its time (CUDA events and device
    time), the plain version's, ``index_add_``'s (the same sums in no fixed
    order) and its bound."""
    from repro_torch.kernels import usage_sum as us
    T, N, L, K = m.shape
    dev = torch.device(CARD)
    idx = torch.as_tensor(m.reshape(T, N, L * K), dtype=torch.float32,
                          device=dev).argmin(2)
    chosen = torch.as_tensor(s.reshape(T, N, L * K), dtype=torch.float32,
                             device=dev).gather(2, idx[..., None])[..., 0]
    chosen = chosen.contiguous()
    got = us.usage_sum_kernel(idx, chosen, K, L)
    check(torch.equal(got, us.usage_sum_plain(idx, chosen, K, L))
          and torch.equal(got, us.usage_sum_kernel(idx, chosen, K, L)),
          f"usage_sum at {what}: the kernel's sums are not the host's float32 "
          f"sums in row order, or two calls differ")
    ms = cuda_ms(lambda: us.usage_sum_kernel(idx, chosen, K, L), torch)
    dev_ms, _ = device_ms(lambda: us.usage_sum_kernel(idx, chosen, K, L),
                          torch)
    plain = cuda_ms(lambda: us.usage_sum_plain(idx, chosen, K, L), torch,
                    iters=5)
    flat = (torch.arange(T, device=dev)[:, None] * L + idx // K).reshape(-1)
    lib = cuda_ms(lambda: torch.zeros(T * L, device=dev).index_add_(
        0, flat, chosen.reshape(-1)), torch)
    need = {"idx": 8 * T * N, "chosen": 4 * T * N, "use": 4 * T * L}
    n_ops = float(T * N)            # one addition per row
    b, by = bound_ms(float(sum(need.values())), n_ops)
    rows = np.bincount((idx // K).cpu().numpy().ravel(), minlength=L)
    route = "warp" if L <= 32 and N <= us.WARP_MAX_N else "block"
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    say(phase, f"usage_sum at {what} (T {T:,}, N_max {N:,}, L {L}, K {K}; "
        f"the {route} route; rows a tier {rows.tolist()}): sums identical to "
        f"the host's float32 sums in row order and on a second call; "
        f"{launches} launches in the solve (one per scan step); kernel "
        f"{ms:.4f} ms (device {dev_txt}), plain (host np.add.at, with the "
        f"copies) {plain:.4f} ms, index_add_ (no fixed order) {lib:.4f} ms; "
        f"bound {b:.5f} ms ({by}; {_counts(need)} bytes, {n_ops:.0f} ops) "
        f"{card}")
    return {"name": "usage_sum", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/usage_sum.cu",
            "replaces": "src/repro/core/optassign.py:713", "launches": launches,
            "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain, "bound_ms": b, "bound_by": by,
            "library_ms": lib, "shape": [T, N, L, K]}


# ------------------------------------------------------------- daemon phase
DAEMON_BATCH_N = 500                 # bench_daemon's batch section
DAEMON_TRACE = (760, 18, 7)          # bench_daemon's "large" trace
DAEMON_FLEET_T, DAEMON_FLEET_MEAN_N = 64, 24    # bench_fleet's T 64 fleet
MIGRATOR_N = 96                      # bench_migrator's partitions
MIGRATOR_P = (0.05, 0.2, 0.4)        # bench_migrator's transient rates
# faults per (op, key): the bench's 3 lets a re-encode (a get, then a
# replace) fail 6 times, past max_attempts 5; at 2 every move must commit
MIGRATOR_MAX_FAULTS = 2
MIGRATOR_SCHEMES = ("none", "zlib-1", "lzma-1")
# decompression seconds per GB, fixed per codec: a truth-mode solve times
# decompression on the wall clock, so two devices would see other D
MIGRATOR_DSPEED = {"zlib-1": 2.0, "lzma-1": 12.0}
REPLAN_CYCLES = 8
REPORT_COUNTS = ("n_partitions", "n_candidates", "n_selected", "n_deferred",
                 "max_deferral_age", "n_tenants", "n_failed")
REPORT_CENTS = ("spent_cents", "steady_cents", "migration_cents",
                "egress_cents", "penalty_cents", "moved_gb",
                "installment_cents", "prepaid_used_cents", "retry_cents",
                "failed_cents", "attempted_cents")


def _same_reports(a, b, what):
    """Two daemons' cycle reports: identical counts, cents within rel 1e-6.
    Returns the largest relative cents difference."""
    check(len(a) == len(b), f"{what}: {len(a)} and {len(b)} cycles")
    worst = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        for f in REPORT_COUNTS:
            check(getattr(x, f) == getattr(y, f),
                  f"{what}, cycle {i}: {f} {getattr(x, f)} against "
                  f"{getattr(y, f)} between cuda and cpu")
        for f in REPORT_CENTS:
            u, v = getattr(x, f), getattr(y, f)
            r = abs(u - v) / abs(v) if v else abs(u)
            check(r <= 1e-6, f"{what}, cycle {i}: {f} differs by rel {r}")
            worst = max(worst, r)
    return worst


def _charges(mig):
    return (mig.move_transfer_cents + mig.move_egress_cents
            + mig.move_penalty_cents)


def _cum(reps):
    return sum(r.steady_cents + r.spent_cents for r in reps)


def _daemon_batch(torch, E, dm, table, dev):
    """``bench_daemon.py``'s batch section on ``dev``: the plan, its cycles,
    the bench's cap, and the unbudgeted and capped daemons with their
    seconds."""
    N = DAEMON_BATCH_N
    cfg = E.ScopeConfig(tier_whitelist=(0, 1, 2, 3), schemes=("none", "lz4"),
                        device=dev)
    rng = np.random.default_rng(N)
    spans = rng.lognormal(0.0, 1.2, N) * 2.0
    rho = rng.gamma(0.7, 25.0, N)
    R = np.concatenate([np.ones((N, 1)), rng.uniform(1.2, 6.0, (N, 1))], 1)
    D = np.concatenate([np.zeros((N, 1)),
                        rng.uniform(0.01, 2.0, (N, 1)) * spans[:, None]], 1)
    eng = E.PlacementEngine(table, cfg)
    plan0 = eng.solve(E.PlacementProblem(
        spans_gb=spans, rho=rho, current_tier=np.full(N, -1), R=R, D=D,
        schemes=cfg.schemes, table=table, cfg=cfg))
    rng = np.random.default_rng(N + 1)
    cycles, r = [], plan0.problem.rho.copy()
    for _ in range(6):
        r = r.copy()
        hot = rng.random(N) < 0.05
        cold = ~hot & (rng.random(N) < 0.05)
        r[hot] *= rng.uniform(20.0, 100.0, int(hot.sum()))
        r[cold] /= rng.uniform(20.0, 100.0, int(cold.sum()))
        cycles.append(r.copy())
    cycles += [cycles[-1]] * 4          # quiet tail: deferred moves drain
    cur, held = plan0, np.zeros(N)
    per_move, per_cycle = [0.0], [0.0]
    for rho in cycles:
        mig = eng.reoptimize(cur, rho, months_held=held + 1.0)
        held = np.where(mig.moved, 0.0, held + 1.0)
        cur = mig.plan
        per_move.append(float(_charges(mig).max()))
        per_cycle.append(mig.total_move_cents)
    cap = max(1.05 * max(per_move), 0.35 * max(per_cycle))
    out = {}
    for name, budget in (("unbudgeted", dm.MigrationBudget()),
                         ("capped", dm.MigrationBudget(cents_per_cycle=cap))):
        d = dm.ReoptimizationDaemon(eng, plan=plan0, budget=budget)
        t0 = time.perf_counter()
        d.run(cycles, months=1.0)
        torch.cuda.synchronize()
        out[name] = (d, time.perf_counter() - t0)
    return out, cap, len(cycles)


def _daemon_stream(torch, E, dm, table, sizes, batches, dev, budget,
                   collect=False):
    """``bench_daemon.py``'s ``_stream_run`` on ``dev``: the daemon, its
    seconds and (``collect``: the unbudgeted run, read through the engine as
    the bench reads it) the dearest single move's charge."""
    cfg = E.ScopeConfig(use_compression=False, months=1.0, device=dev)
    eng = E.StreamingEngine(table, cfg, sizes, drift_threshold=0.5,
                            rho_abs_tol=1.0)
    d = dm.ReoptimizationDaemon(eng, budget=budget)
    per_move = 0.0
    t0 = time.perf_counter()
    for b in batches:
        if collect:
            mig = eng.ingest_and_reoptimize(b, months=1.0)
            d._report(mig, mig.deferred, 0)
            if mig.n_candidates:
                per_move = max(per_move, float(_charges(mig).max()))
        else:
            d.step(b, months=1.0)
    torch.cuda.synchronize()
    return d, time.perf_counter() - t0, per_move


def _migrator_plan(E, table, dev):
    """``bench_migrator.py``'s ``_drifted`` on ``dev``, with R from the
    payloads' true ratios and D fixed per codec."""
    from repro_torch.storage.codecs import codec_by_name
    N = MIGRATOR_N
    rng = np.random.default_rng(11)
    raws = [bytes([65 + i % 26]) * int(60_000 + 40_000 * rng.random())
            for i in range(N)]
    rho = 10.0 ** rng.uniform(-2, 3, N)
    K = len(MIGRATOR_SCHEMES)
    R, D = np.ones((N, K)), np.zeros((N, K))
    for i, b in enumerate(raws):
        for k, s in enumerate(MIGRATOR_SCHEMES[1:], 1):
            R[i, k] = len(b) / len(codec_by_name(s).compress(b))
            D[i, k] = MIGRATOR_DSPEED[s] * len(b) / 1e9
    cfg = E.ScopeConfig(tier_whitelist=(0, 1, 2), months=2.0,
                        schemes=MIGRATOR_SCHEMES, device=dev)
    eng = E.PlacementEngine(table, cfg)
    plan = eng.solve(E.PlacementProblem(
        spans_gb=np.array([len(b) / 1e9 for b in raws]), rho=rho,
        current_tier=np.full(N, -1), R=R, D=D,
        schemes=list(MIGRATOR_SCHEMES), table=table, cfg=cfg,
        partitions=[None] * N, raw_bytes=raws))
    rho2 = plan.problem.rho * 10.0 ** rng.uniform(-3, 3, N)
    return eng, plan, eng.reoptimize(plan, rho2, months_held=2.0)


def _migrator_runs(torch, dm, eng, plan, mig):
    """The three runs of ``bench_migrator.py`` on one plan: zero faults
    against ``migrate`` (and four workers), transient faults at each rate,
    the replan loop under permanent faults. Returns what they printed and
    checked, for the cuda/cpu comparison."""
    from repro_torch.core.migrator import AsyncMigrator, _meter_cents
    from repro_torch.storage.chaos import ChaosStore
    from repro_torch.storage.store import TieredStore

    fields = ("storage_cents", "read_cents", "write_cents", "penalty_cents",
              "egress_cents", "n_reads", "n_writes")
    sig = lambda s: tuple(getattr(s.meter, f) for f in fields)
    state = lambda s: {k: (o.payload, o.tier, o.codec, o.stored_gb,
                           o.moved_month) for k, o in s._objs.items()}

    def fresh():
        s = TieredStore(eng.table)
        keys = s.apply_plan(plan)
        s.advance_months(2.0)
        return s, keys

    out = {"moves": mig.n_moved}
    ref, keys = fresh()
    t0 = time.perf_counter()
    ref.migrate(mig, keys)
    out["us_sync"] = (time.perf_counter() - t0) * 1e6 / max(mig.n_moved, 1)
    for w in (1, 4):
        s, keys = fresh()
        t0 = time.perf_counter()
        rep = AsyncMigrator(s, workers=w, sleep_fn=None).execute(mig, keys)
        out[f"us_w{w}"] = (time.perf_counter() - t0) * 1e6 / max(
            mig.n_moved, 1)
        check(rep.n_committed == mig.n_moved and rep.n_failed == 0,
              f"zero faults, {w} workers: {rep.n_committed} of "
              f"{mig.n_moved} moves committed")
        if w == 1:
            check(sig(s) == sig(ref) and state(s) == state(ref),
                  "zero faults, one worker: the store differs from "
                  "store.migrate's")
        else:
            for f, a, b in zip(fields, sig(s), sig(ref)):
                check(abs(a - b) <= 1e-9 * abs(b), f"four workers: {f} "
                      f"{a!r} against migrate's {b!r}")
    fault_free = _meter_cents(ref.meter)
    out["chaos"] = []
    for p in MIGRATOR_P:
        s, keys = fresh()
        ch = ChaosStore(s, seed=3, p_transient=p,
                        max_faults_per_op=MIGRATOR_MAX_FAULTS)
        t0 = time.perf_counter()
        rep = AsyncMigrator(ch, max_attempts=5, sleep_fn=None).execute(
            mig, keys)
        us = (time.perf_counter() - t0) * 1e6 / max(mig.n_moved, 1)
        bill = _meter_cents(s.meter)
        check(rep.n_committed == mig.n_moved and rep.n_failed == 0,
              f"p_transient {p}: {rep.n_committed} of {mig.n_moved} moves "
              f"committed")
        check(abs(bill - (fault_free + rep.retry_cents)) <= 1e-12,
              f"p_transient {p}: bill {bill!r} against fault-free "
              f"{fault_free!r} + retry {rep.retry_cents!r}")
        out["chaos"].append((p, rep.n_attempts, ch.stats.n_faults,
                             rep.retry_cents, float(bill), us))
    s, keys = fresh()
    ch = ChaosStore(s, seed=5, p_permanent=1.0, max_faults_per_op=1)
    d = dm.ReoptimizationDaemon(
        eng, plan=plan, store_keys=keys,
        migrator=AsyncMigrator(ch, sleep_fn=None),
        budget=dm.MigrationBudget(cents_per_cycle=np.inf))
    rho2 = mig.plan.problem.rho
    t0 = time.perf_counter()
    for _ in range(REPLAN_CYCLES):
        rep = d.step(rho2, months=1.0)
        if rep.n_failed == 0 and rep.n_selected == 0:
            break
    out["replan_s"] = time.perf_counter() - t0
    check(rep.n_failed == 0 and rep.n_selected == 0,
          f"replan: not converged after {REPLAN_CYCLES} cycles")
    out["replan"] = d.history
    out["replan_state"] = state(s)
    return out


def phase_daemon(torch, smi_line):
    """The re-optimization daemon in its three modes, the async migrator
    and chaos injection (phase 10), each part on cuda and on cpu."""
    from repro_torch.core import daemon as dm
    from repro_torch.core import engine as E
    from repro_torch.core.costs import azure_table
    from repro_torch.core.fleet import FleetEngine
    from repro_torch.data import workloads as wl
    card = f"| {smi_line}"
    t_phase = time.perf_counter()
    table = azure_table()

    # 1. bench_daemon's batch section
    t_part = time.perf_counter()
    runs = {dev: _daemon_batch(torch, E, dm, table, dev)
            for dev in (CARD, "cpu")}
    (res, cap, n_cyc), (res_cpu, cap_cpu, _) = runs[CARD], runs["cpu"]
    check(cap == cap_cpu, f"batch cap {cap!r} on cuda, {cap_cpu!r} on cpu")
    for name in res:
        rel = _same_reports(res[name][0].history, res_cpu[name][0].history,
                            f"batch daemon, {name}")
        _same_plan(res[name][0].plan, res_cpu[name][0].plan,
                   f"batch daemon, {name}")
        h = res[name][0].history
        if name == "capped":
            worst = max(r.spent_cents for r in h)
            check(all(r.spent_cents <= cap + 1e-9 for r in h),
                  f"batch daemon: spend {worst!r} over the cap {cap!r}")
        say("daemon", f"batch (bench_daemon's batch section: N "
            f"{DAEMON_BATCH_N}, Azure, tiers 0-3, none/lz4, 6 drift cycles "
            f"and 4 quiet) {name}"
            + (f", cap {cap!r} cents a cycle, most spent {worst!r}"
               if name == "capped" else "")
            + f": {1e3 * res[name][1] / n_cyc:.2f} ms/cycle on cuda, "
            f"{1e3 * res_cpu[name][1] / n_cyc:.2f} on cpu; cumulative "
            f"{_cum(h)!r} cents ("
            + (f"{100 * (_cum(h) / _cum(res['unbudgeted'][0].history) - 1):+.3f}"
               f"% against unbudgeted, " if name == "capped" else "")
            + f"{sum(r.n_selected for r in h)} moves, "
            f"{sum(r.n_deferred for r in h)} deferrals); cuda and cpu "
            f"identical reports and plans, cents rel {rel:.3e} {card}")
    say("daemon", f"part 1 (batch) took {time.perf_counter() - t_part:.1f} s")

    # 2. bench_daemon's large stream at three budgets
    t_part = time.perf_counter()
    n_ds, n_mo, seed = DAEMON_TRACE
    w = wl.generate_workload(n_datasets=n_ds, n_months=n_mo, seed=seed)
    sizes = wl.dataset_file_sizes(w)
    batches = [b for b in wl.stream_query_log(w, np.random.default_rng(seed))
               if b]
    unb = {dev: _daemon_stream(torch, E, dm, table, sizes, batches, dev,
                               dm.MigrationBudget(), collect=True)
           for dev in (CARD, "cpu")}
    per_move = unb[CARD][2]
    check(per_move == unb["cpu"][2], "stream: the dearest move differs")
    max_spend = max(r.spent_cents for r in unb[CARD][0].history)
    cum_unb = _cum(unb[CARD][0].history)
    caps = {"unbudgeted": None,
            "tight": min(1.05 * per_move, 0.999 * max_spend),
            "below_max_move": 0.5 * per_move}
    for name, c in caps.items():
        got = unb if c is None else {
            dev: _daemon_stream(torch, E, dm, table, sizes, batches, dev,
                                dm.MigrationBudget(cents_per_cycle=c))
            for dev in (CARD, "cpu")}
        rel = _same_reports(got[CARD][0].history, got["cpu"][0].history,
                            f"stream daemon, {name}")
        h = got[CARD][0].history
        worst = max(r.spent_cents for r in h)
        if c is not None:
            check(worst <= c + 1e-9,
                  f"stream daemon, {name}: spend {worst!r} over {c!r}")
        say("daemon", f"stream (bench_daemon's large trace: {n_ds} datasets, "
            f"{n_mo} months, seed {seed}; uncompressed, drift threshold 0.5, "
            f"rho_abs_tol 1.0) {name}"
            + (f" (cap {c!r} cents)" if c is not None else "")
            + f": {len(h)} cycles, {1e3 * got[CARD][1] / len(h):.2f} ms/cycle "
            f"on cuda, {1e3 * got['cpu'][1] / len(h):.2f} on cpu; "
            f"cumulative {_cum(h)!r} cents "
            f"({100 * (_cum(h) / cum_unb - 1):+.3f}% against unbudgeted), "
            f"{sum(r.n_selected for r in h)} moves, "
            f"{sum(r.n_deferred for r in h)} deferrals, oldest "
            f"{max(r.max_deferral_age for r in h)} cycles, most spent "
            f"{worst!r}; cuda and cpu identical, cents rel {rel:.3e} {card}")
    say("daemon", f"part 2 (stream) took {time.perf_counter() - t_part:.1f} s")

    # 3. a fleet daemon with a shared budget that binds
    t_part = time.perf_counter()
    T, mean_n = DAEMON_FLEET_T, DAEMON_FLEET_MEAN_N
    rng = np.random.default_rng(T + 1)
    fleets = {}
    for dev in (CARD, "cpu"):
        cfg = E.ScopeConfig(schemes=("none", "lz4"), device=dev)
        fe = FleetEngine(table, cfg)
        fleets[dev] = (fe, fe.solve(_engine_problems(E, T, mean_n, table,
                                                     cfg, seed=T)).plans)
    rhos = [p.problem.rho for p in fleets[CARD][1]]
    cycles = []
    for _ in range(6):
        rhos = [r * rng.choice([0.02, 1.0, 1.0, 40.0], r.shape[0])
                for r in rhos]
        cycles.append(rhos)
    cycles += [cycles[-1]] * 2
    fe, plans = fleets[CARD]
    d = dm.ReoptimizationDaemon(fe, plans=plans)
    d.run(cycles, months=1.0)
    fcap = 0.4 * max(r.spent_cents for r in d.history)
    got = {}
    for dev, (fe, plans) in fleets.items():
        d = dm.ReoptimizationDaemon(
            fe, plans=plans, budget=dm.MigrationBudget(cents_per_cycle=fcap))
        t0 = time.perf_counter()
        d.run(cycles, months=1.0)
        torch.cuda.synchronize()
        got[dev] = (d, time.perf_counter() - t0)
    rel = _same_reports(got[CARD][0].history, got["cpu"][0].history,
                        "fleet daemon")
    for a, b in zip(got[CARD][0].plans, got["cpu"][0].plans):
        _same_plan(a, b, "fleet daemon")
    h = got[CARD][0].history
    worst = max(r.spent_cents for r in h)
    check(worst <= fcap + 1e-9 and any(r.n_deferred for r in h),
          f"fleet daemon: spend {worst!r} against the shared cap {fcap!r}, "
          f"{sum(r.n_deferred for r in h)} deferrals (the cap must bind)")
    say("daemon", f"fleet T {T} (bench_fleet's engine tenants, mean N "
        f"{mean_n}, {h[0].n_partitions:,} partitions; 6 drift cycles, 2 "
        f"quiet), one shared knapsack, cap {fcap!r} cents a cycle (40% of "
        f"the unbudgeted peak): {1e3 * got[CARD][1] / len(h):.2f} ms/cycle "
        f"on cuda, {1e3 * got['cpu'][1] / len(h):.2f} on cpu; "
        f"{sum(r.n_selected for r in h)} moves, "
        f"{sum(r.n_deferred for r in h)} deferrals, most spent {worst!r}; "
        f"cuda and cpu identical, cents rel {rel:.3e} {card}")
    say("daemon", f"part 3 (fleet) took {time.perf_counter() - t_part:.1f} s")

    # 4. bench_migrator's 96 partitions: zero faults, chaos, replan
    t_part = time.perf_counter()
    outs = {}
    for dev in (CARD, "cpu"):
        eng, plan, mig = _migrator_plan(E, table, dev)
        outs[dev] = (mig, _migrator_runs(torch, dm, eng, plan, mig))
    (mc, oc), (mp, op_) = outs[CARD], outs["cpu"]
    _same_migration(mc, mp, "migrator plan")
    check([c[:5] for c in oc["chaos"]] == [c[:5] for c in op_["chaos"]],
          "migrator chaos runs differ between cuda's and cpu's plans")
    rel = _same_reports(oc["replan"], op_["replan"], "replan daemon")
    check(oc["replan_state"] == op_["replan_state"],
          "replan: the stores differ between cuda's and cpu's plans")
    n = oc["moves"]
    say("daemon", f"migrator (bench_migrator's {MIGRATOR_N} partitions, R "
        f"from the payloads, D fixed per codec {MIGRATOR_DSPEED}): {n} "
        f"moves; zero faults: store and meter identical to store.migrate; "
        f"us/move migrate {oc['us_sync']:.1f}, async 1 worker "
        f"{oc['us_w1']:.1f}, 4 workers {oc['us_w4']:.1f} (cuda's plan; "
        f"cpu's {op_['us_sync']:.1f} / {op_['us_w1']:.1f} / "
        f"{op_['us_w4']:.1f}) {card}")
    for p, att, faults, retry, bill, us in oc["chaos"]:
        say("daemon", f"migrator, ChaosStore(seed=3, p_transient={p}, "
            f"max_faults_per_op={MIGRATOR_MAX_FAULTS}), max_attempts 5, no "
            f"sleeping: all {n} moves committed in {att} "
            f"attempts ({att / n:.3f} a move), {faults} faults; bill "
            f"{bill!r} cents = fault-free + retry {retry!r}; {us:.1f} us/move "
            f"{card}")
    h = oc["replan"]
    say("daemon", f"migrator, replan under ChaosStore(p_permanent=1.0, "
        f"seed=5, one fault per op): converged in {len(h)} cycles "
        f"({[r.n_failed for r in h]} failed moves a cycle), failed "
        f"{sum(r.failed_cents for r in h)!r} cents, attempted "
        f"{sum(r.attempted_cents for r in h)!r} cents, "
        f"{1e3 * oc['replan_s'] / len(h):.2f} ms/cycle; cuda's and cpu's "
        f"plans give identical reports and stores, cents rel {rel:.3e} "
        f"{card}")
    say("daemon", f"part 4 (migrator) took {time.perf_counter() - t_part:.1f} s")
    say("daemon", f"phase daemon took {time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------- serve phase
# bf16 keeps 8 significant bits; over 63 blocks two bf16 evaluations that
# round in other places give logits up to ~7% apart (7.2e-2 between prefill
# and decode in the first full run), so the bf16 checks catch gross faults
# only. The float32 checks, where only the order of sums differs, are tight.
# The bf16 checks are normwise (max |a - b| / max |b|): elementwise, against
# 1 + |b|, a tensor-parallel run and the unsharded one part by about 0.3 at
# zamba2's full depth however the ranks' products are rounded, as far as the
# unsharded bf16 run lies from its float32 answer (tools/tp_bf16_gap.py).
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


def _gap(got, want):
    """(normwise error, max |got - want|, max |got - want| / (1 + |want|))
    of logits ``got`` against ``want``: TOL_BF16 bounds the first, as in
    phases serve and zoo, TOL_F32 the last."""
    d = (got.float() - want.float()).abs()
    return (float(d.max() / want.float().abs().max().clamp_min(1e-30)),
            float(d.max()), float((d / (1 + want.float().abs())).max()))


def _gap_line(g) -> str:
    return (f"normwise err {g[0]:.3e} (max abs diff {g[1]:.3e}, "
            f"elementwise relative {g[2]:.3e})")


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
    want_routes = {ZAMBA2_K5_ROUTE: n_attn, "ssd_scan.bf16_tc": n_mamba}
    check(prefill_routes == want_routes,
          f"bf16 prefill routes {prefill_routes}, want {want_routes}")
    say("serve", f"prefill routes: {want_routes} (the tensor-core routes)")
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
            k5 = (ZAMBA2_K5_ROUTE if route == "bf16_tc"
                  else f"flash_attention.{route}")
            check(use_plain or dict(ops.route_counts) == {
                k5: n_attn, f"ssd_scan.{route}": n_mamba},
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


# -------------------------------------------------------------- mesh phase
MESH_PROMPT, MESH_NEW = 8, 8         # the two-rank serve loop: 15 steps
MESH_F32_STEPS = 8                   # of them replayed in float32
MESH_TIMEOUT = 300                   # seconds the two ranks may take


def _partials_case(torch, latent, S):
    """q, the global cache and global lengths at zamba2's shared attention
    block (B 4, 32 heads of 80) or deepseek's absorbed decode (16 heads of
    576 on one latent head, v its first 512 columns), bf16, seeded."""
    dev = torch.device(CARD)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev).to(
        torch.bfloat16)
    B = SERVE_BATCH
    if latent:
        q, cache = r(B, 16, 576), r(B, S, 576)
        k = cache[:, :, None, :]
        v = k[..., :512]
    else:
        q, k, v = r(B, 32, 80), r(B, S, 32, 80), r(B, S, 32, 80)
    lens = torch.tensor([S, S // 2 + 3, 5, S - 40], dtype=torch.int32,
                        device=dev)
    return q, k, v, lens


def _slice(k, v, latent, a, n):
    """A rank's own slice [a, a + n) of the cache (contiguous, v inside k
    for the latent cache, as ``serving.decode.init_cache`` allocates it)."""
    ks = k[:, a:a + n].contiguous()
    return ks, (ks[..., :512] if latent else v[:, a:a + n].contiguous())


def _partials_rows(torch, smi_line):
    """K6's partials mode on the card: each slice configuration against
    the plain version, the merge of 2 and 4 slices against unsharded K6,
    and the time, plain time and bound of a rank's slice at the sharded
    decode's shapes (half of zamba2's serve cache, half of deepseek's
    latent cache at kv_len 4,096)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    tol = 2e-2                       # K6's bf16 tolerance (its card tests)
    rows = []
    for what, latent, S in (("zamba2 (B 4, 32 heads of 80)", False,
                             SERVE_PROMPT + SERVE_STEPS),
                            ("deepseek latent (B 4, 16 heads of 576, v in "
                             "k)", True, ZOO_LATENT_KV)):
        q, k, v, lens = _partials_case(torch, latent, S)
        n = S // 2
        errs = []
        for a, window in ((n, None), (n, 3 * S // 4), (0, S // 4),
                          (3 * S // 4, S // 8)):
            w = n if a < 3 * S // 4 else S // 4
            ks, vs = _slice(k, v, latent, a, w)
            local = torch.clamp(lens - a, 0, w).to(torch.int32)
            kw = dict(offset=a, global_len=lens, window=window)
            acc, m, l = da.decode_attention_partials_kernel(q, ks, vs, local,
                                                            **kw)
            again = da.decode_attention_partials_kernel(q, ks, vs, local, **kw)
            check(all(torch.equal(x, y) for x, y in zip((acc, m, l), again)),
                  f"K6 partials {what}: two calls differ")
            acc_p, m_p, l_p = da.decode_attention_partials_plain(
                q, ks, vs, local, **kw)
            seen = l_p > 0
            check(torch.equal(seen, l > 0) and torch.equal(m[~seen], m_p[~seen])
                  and not acc[~seen].any(), f"K6 partials {what} at offset "
                  f"{a}, window {window}: rows without a visible key differ")
            if seen.any():
                errs.append(_allclose(torch, m[seen], m_p[seen], 1e-5))
                errs.append(_allclose(torch, l[seen], l_p[seen], 1e-4))
                errs.append(_allclose(
                    torch, acc[seen] / l[seen][:, None],
                    acc_p[seen] / l_p[seen][:, None], tol))
        merged = {}
        want = ops.decode_attention(q, k, v, lens)
        for slices in (2, 4):
            w = S // slices
            parts = []
            for r in range(slices):
                ks, vs = _slice(k, v, latent, r * w, w)
                parts.append(da.decode_attention_partials_kernel(
                    q, ks, vs, torch.clamp(lens - r * w, 0, w).to(torch.int32),
                    offset=r * w, global_len=lens))
            m_star = torch.stack([p[1] for p in parts]).amax(0)
            c = [torch.exp(p[1] - m_star) for p in parts]
            L = sum(p[2] * x for p, x in zip(parts, c))
            A = sum(p[0] * x[..., None] for p, x in zip(parts, c))
            got = (A / torch.clamp_min(L, 1e-30)[..., None]).to(q.dtype)
            merged[slices] = _allclose(torch, got, want, tol)
        # the sharded decode's rank-1 slice, every row at full occupancy
        ks, vs = _slice(k, v, latent, n, n)
        full = torch.full_like(lens, S)
        local = torch.full_like(lens, n)
        call = lambda: da.decode_attention_partials_kernel(
            q, ks, vs, local, offset=n, global_len=full)
        acc, m, l = call()
        acc_p, m_p, l_p = da.decode_attention_partials_plain(
            q, ks, vs, local, offset=n, global_len=full)
        err = _allclose(torch, acc / l[..., None], acc_p / l_p[..., None], tol)
        ms = cuda_ms(call, torch)
        plain = cuda_ms(lambda: da.decode_attention_partials_plain(
            q, ks, vs, local, offset=n, global_len=full), torch, iters=5)
        B, Hq, D = q.shape
        Hkv, Dv = ks.shape[2], vs.shape[-1]
        el = q.element_size()
        need = {"q": q.numel() * el,
                "slice rows": B * n * Hkv * (D if latent else D + Dv) * el,
                "lengths": 8 * B, "acc, m, l": 4 * B * Hq * (Dv + 2)}
        n_ops = float(B * n * Hq * (2 * D + 2 * Dv))
        b, by = bound_ms(float(sum(need.values())), n_ops,
                         _rate(torch, q.dtype))
        say("mesh", f"K6 partials, {what}: 4 slice configurations (offset "
            f"and window: (S/2, none), (S/2, starting before the slice), (0, "
            f"inside it), (3S/4, a quarter slice)) against the plain version, "
            f"largest error {max(errs):.3e} (m within 1e-5, l 1e-4, acc / l "
            f"{tol}), rows with no visible key exact, the same bits twice; 2 "
            f"and 4 slices merged against unsharded K6: {merged[2]:.3e}, "
            f"{merged[4]:.3e} (tolerance {tol}, bf16). A rank's slice (S "
            f"{S} over 2: {n} keys): kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, no single PyTorch call gives (acc, m, l); bound {b:.5f} ms "
            f"({by}; {_counts(need)} bytes, {n_ops:.0f} ops) | {smi_line}")
        rows.append({"shape": f"{what}, slice {n} of {S}", "max_abs_err": err,
                     "ms": ms, "plain_ms": plain, "bound_ms": b,
                     "bound_by": by, "library_ms": None})
    return rows


def _tp_collectives(n_mamba: int, n_attn: int, decode: bool):
    """(all-reduces, all-gathers) of one zamba2-like forward at model 2,
    data 1: the embedding's sum and the logits' gather; per Mamba2 block
    the gate norm's sum of squares and out_proj's sum; per attention block
    wo's and the MLP's sums, and in a decode step also the new k and v and
    the query heads gathered and the two all-reduces of the partials'
    merge."""
    if decode:
        return 1 + 2 * n_mamba + 4 * n_attn, 1 + 3 * n_attn
    return 1 + 2 * n_mamba + 2 * n_attn, 1


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_rank(rank, out_dir, port):
    """One of two ranks sharing the card: ``launch_mesh(1, 2)`` under
    torchrun's variables (gloo, since both ranks are on one card), then
    zamba2-2.7b at full width served over 'model', each rank holding its
    shards of the weights (tensor parallel) and the decode cache's sequence
    sharded: the prefill through the mesh and the serve loop, counts zeroed
    before each; rank 0 then runs the same prefill and loop unsharded on
    the whole weights (the loop fed the sharded run's tokens)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import ctx, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import launch_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tr
    from repro_torch.serving import decode
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh, dev = launch_mesh(1, 2, CARD)
    out = {"backend": dist.get_backend(), "device": str(dev)}
    cfg = get_config(ARCH)
    B, P, N = SERVE_BATCH, MESH_PROMPT, MESH_NEW
    max_seq = -(-(P + N + 1) // 2) * 2
    params = tr.init_params(torch.Generator(device=dev).manual_seed(SEED),
                            cfg, device=dev)
    specs = sharding.param_specs(params, cfg, 2)
    mine = tr.tree_map(lambda t: t.clone(),
                       sharding.shard_tree(params, specs, mesh))
    prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(SEED + 1))
    prefill = decode.make_prefill_step(cfg, mesh)
    prefill(mine, prompts[:, :8])                          # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ctx.reduced_on.clear()
    t0 = time.perf_counter()
    pre = prefill(mine, prompts)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t0
    out["prefill_launches"] = dict(ops.launch_counts)
    out["prefill_reduced"] = dict(ctx.reduced_on)
    fed = []

    def recording(step):
        def wrapped(p, cache, tokens, pos, context=None):
            logits, cache = step(p, cache, tokens, pos, context)
            fed.append((tokens.clone(), pos.clone(), logits.float().cpu()))
            return logits, cache
        return wrapped

    cache = decode.init_cache(cfg, B, max_seq, mesh=mesh, device=dev)
    out["slots"] = [c[0].shape[2] for st, sc in zip(cfg.stages, cache)
                    for kind, c in zip(st.unit, sc) if kind == "shared_attn"]
    ops.reset_launch_counts()
    ctx.reduced_on.clear()
    res = serve(recording(decode.make_decode_step(cfg, mesh)), mine, cache,
                prompts, N)
    out.update(launches=dict(ops.launch_counts),
               routes=dict(ops.route_counts), reduced=dict(ctx.reduced_on),
               tokens=res.tokens.cpu(), steps=len(fed),
               step_ms=1e3 * (res.prompt_s + res.decode_s) / len(fed))
    # float32, the same weights cast: the first steps' tokens again, through
    # the sharded step and (rank 0) the unsharded one
    cfg32 = cfg.scaled(dtype="float32")
    f32 = lambda tree: tr.tree_map(lambda t: t.float(), tree)
    steps32 = {"sharded": (decode.make_decode_step(cfg32, mesh), f32(mine),
                           decode.init_cache(cfg32, B, max_seq, mesh=mesh,
                                             device=dev))}
    if rank == 0:
        steps32["unsharded"] = (decode.make_decode_step(cfg32), f32(params),
                                decode.init_cache(cfg32, B, max_seq,
                                                  device=dev))
    for name, (step, p, cache) in steps32.items():
        lg = [step(p, cache, tokens, pos)[0].cpu()
              for tokens, pos, _ in fed[:MESH_F32_STEPS]]
        out[f"f32_{name}"] = torch.stack(lg)
    del steps32
    if rank == 0:
        pre1 = decode.make_prefill_step(cfg)(params, prompts)
        cache1 = decode.init_cache(cfg, B, max_seq, device=dev)
        step1 = decode.make_decode_step(cfg)
        logits1 = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tokens, pos, _ in fed:
            lg, cache1 = step1(params, cache1, tokens, pos)
            logits1.append(lg.float().cpu())
        torch.cuda.synchronize()
        out.update(unsharded_step_ms=1e3 * (time.perf_counter() - t0)
                   / len(fed),
                   prefill=pre.float().cpu(), prefill1=pre1.float().cpu(),
                   logits=torch.stack([lg for _, _, lg in fed]),
                   logits1=torch.stack(logits1))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def phase_mesh(torch, smi_line):
    """K6's partials on the card, then zamba2-2.7b served over two ranks
    that share the card, its cache's sequence sharded over 'model'."""
    import tempfile
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rows = _partials_rows(torch, smi_line)

    out_dir = tempfile.mkdtemp(dir=str(ROOT / "build"))
    pc = mp.start_processes(_mesh_rank, args=(out_dir, _free_port()),
                            nprocs=2, join=False, start_method="spawn")
    deadline = time.perf_counter() + MESH_TIMEOUT
    try:
        while not pc.join(timeout=5):
            check(time.perf_counter() < deadline,
                  f"the two mesh ranks outlasted {MESH_TIMEOUT} s")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
                p.join()
    got = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in (0, 1)]
    shutil.rmtree(out_dir, ignore_errors=True)
    from repro_torch.configs.registry import get_config
    cfg = get_config(ARCH)
    n_attn = sum(s.repeats * s.unit.count("shared_attn") for s in cfg.stages)
    n_mamba = sum(s.repeats * s.unit.count("mamba") for s in cfg.stages)
    steps = MESH_PROMPT + MESH_NEW - 1
    per_step = sum(_tp_collectives(n_mamba, n_attn, True))
    per_prefill = sum(_tp_collectives(n_mamba, n_attn, False))
    for r, o in enumerate(got):
        check(o["backend"] == "gloo" and o["device"] == "cuda:0",
              f"rank {r}: {o['backend']} on {o['device']}, want gloo on cuda:0")
        half = -(-(MESH_PROMPT + MESH_NEW + 1) // 2)
        check(o["steps"] == steps and o["slots"]
              and all(n == half for n in o["slots"]),
              f"rank {r}: {o['steps']} steps, cache slots {o['slots']}, "
              f"want {half} a rank")
        check(o["prefill_launches"] == {"flash_attention": n_attn,
                                        "ssd_scan": n_mamba},
              f"rank {r}: prefill launches {o['prefill_launches']}")
        check(o["launches"] == {"decode_attention": n_attn * steps}
              and o["routes"] == {"decode_attention.partials": n_attn * steps},
              f"rank {r}: serve launches {o['launches']}, routes "
              f"{o['routes']}; want every decode attention through K6's "
              f"partials, {n_attn * steps}")
        check(o["reduced"] == {"cuda": per_step * steps}
              and o["prefill_reduced"] == {"cuda": per_prefill},
              f"rank {r}: reduced tensors {o['reduced']} in the loop and "
              f"{o['prefill_reduced']} in the prefill, want "
              f"{per_step * steps} and {per_prefill}, all on cuda")
    check(torch.equal(got[0]["tokens"], got[1]["tokens"]),
          "the two ranks generated different tokens")
    r0 = got[0]
    g_pre = _gap(r0["prefill"], r0["prefill1"])
    g_loop = _gap(r0["logits"], r0["logits1"])
    g_32 = _gap(r0["f32_sharded"], r0["f32_unsharded"])
    check(g_pre[0] <= TOL_BF16 and g_loop[0] <= TOL_BF16,
          f"mesh bf16 logits against the unsharded run: prefill "
          f"{_gap_line(g_pre)}, loop {_gap_line(g_loop)}, beyond {TOL_BF16}")
    check(g_32[2] <= TOL_F32, f"mesh float32 logits against the unsharded "
          f"run: {_gap_line(g_32)}, beyond {TOL_F32}")
    check(torch.equal(got[0]["f32_sharded"], got[1]["f32_sharded"]),
          "the two ranks' float32 logits differ")
    ties = _near_ties(r0["logits"], r0["logits1"])
    _check_ties(ties, "mesh serve loop")
    check(bool(r0["logits"].isfinite().all()), "mesh logits not finite")
    say("mesh", f"{cfg.name} at full width over two ranks on one card "
        f"(launch_mesh(1, 2) under torchrun's variables: gloo, both on "
        f"cuda:0), B {SERVE_BATCH}, prompt {MESH_PROMPT} fed one token a "
        f"step, then {MESH_NEW} greedy tokens ({steps} steps), each rank "
        f"holding {r0['slots'][0]} of the shared attention block's "
        f"{2 * r0['slots'][0]} cache slots and its shards of the weights: "
        f"K6 launched {r0['launches']['decode_attention']} times a rank, "
        f"all in its partials mode; {r0['reduced']['cuda']} all-reduces and "
        f"all-gathers a rank ({per_step} a step), every tensor on cuda; the "
        f"prefill through the mesh launched {r0['prefill_launches']}")
    say("mesh", f"against the same weights unsharded (rank 0, the loop fed "
        f"the sharded run's tokens), bf16: prefill logits {_gap_line(g_pre)}"
        f", every step's logits {_gap_line(g_loop)} (tolerance {TOL_BF16}); "
        f"{len(ties)} greedy picks differ, each at a near-tie; in float32 "
        f"(the weights cast) {MESH_F32_STEPS} steps {_gap_line(g_32)} "
        f"(tolerance {TOL_F32}, elementwise: only the order of float32 sums "
        f"differs); "
        f"the two ranks' tokens identical; {r0['step_ms']:.2f} ms a step "
        f"sharded, {r0['unsharded_step_ms']:.2f} unsharded; prefill through "
        f"the mesh {1e3 * r0['prefill_s']:.1f} ms")
    say("mesh", f"phase mesh took {time.perf_counter() - t_phase:.1f} s "
        f"| {smi_line}")
    return rows


# ----------------------------------------------------------------- tp phase
TP_STEPS, TP_AT = 4, 512          # decode steps on the serve phase's cache
TP_TIMEOUT = 300                  # seconds the two ranks may take
TP_DEEPSEEK_KEEP = 1              # deepseek's repeats kept per stage: 2 layers
TOL_LOSS_TP = 2e-4                # train step sharded vs whole, relative
TOL_PARAM_TP = 5e-3               # ... parameters, max abs


def _largest_block(tr, cfg) -> int:
    """Bytes of the largest piece ``init_params`` draws whole before it
    cuts a rank's shards from it: a block of a stage, the shared block or a
    leaf outside the blocks (reckoned on the meta device)."""
    from repro_torch.distributed.sharding import local_bytes
    from repro_torch.models.layers import MetaGenerator
    meta = tr.init_params(MetaGenerator(), cfg, 2, device="meta")
    stages = list(zip(cfg.stages, meta["stages"]))
    if cfg.encoder_stages is not None:
        stages += zip(cfg.encoder_stages, meta["encoder"]["stages"])
    pieces = [local_bytes(meta[k]) for k in ("embed", "lm_head", "shared")
              if k in meta]
    pieces += [local_bytes(entry) // st.repeats for st, sp in stages
               for entry in sp]
    return max(pieces)


def _tp_rank(rank, out_dir, port):
    """One of two ranks sharing the card (``launch_mesh(1, 2)``, gloo):
    zamba2-2.7b at full width and depth, tensor parallel over 'model' (each
    rank its shards of the weights, cut from the same seeded draw), then
    deepseek-v2-lite cut to 2 layers. Every sharded run has its counts
    zeroed just before it and read just after; rank 0 runs each again on
    the whole weights and reports the differences."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import ctx, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import launch_mesh
    from repro_torch.launch.shapes import rank_bytes
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tr
    from repro_torch.serving import decode
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts
    torch.backends.cuda.matmul.allow_tf32 = False
    t_rank = time.perf_counter()
    mesh, dev = launch_mesh(1, 2, CARD)
    one = rank == 0
    out = {"backend": dist.get_backend(), "device": str(dev)}
    sync = torch.cuda.synchronize
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    f32 = lambda tree: None if tree is None else tr.tree_map(
        lambda t: t.float(), tree)

    def counted(fn):
        """(fn(), its counts and host milliseconds): every count zeroed just
        before the call and read just after."""
        ops.reset_launch_counts()
        ctx.reduced_on.clear()
        ctx.collectives.clear()
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, {"ms": 1e3 * (time.perf_counter() - t0),
                     "launches": dict(ops.launch_counts),
                     "routes": dict(ops.route_counts),
                     "reduced": dict(ctx.reduced_on),
                     "collectives": dict(ctx.collectives)}

    def init(c):
        """This rank's shards of ``c``'s seeded weights, with the bytes
        they take, the peak allocated while they were drawn and the
        largest whole block a rank may hold while drawing."""
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        a0 = torch.cuda.memory_allocated(dev)
        p = tr.init_params(gen(SEED), c, 2, mesh, device=dev)
        sync()
        return p, {"alloc": torch.cuda.memory_allocated(dev) - a0,
                   "peak": torch.cuda.max_memory_allocated(dev) - a0,
                   "block": _largest_block(tr, c)}

    # zamba2-2.7b: this rank's shards, and (rank 0) the whole weights
    cfg = get_config(ARCH)
    mine, out["init"] = init(cfg)
    out["bytes"] = rank_bytes(cfg, mesh, mine)
    whole = tr.init_params(gen(SEED), cfg, device=dev) if one else None
    cfg32 = cfg.scaled(dtype="float32")
    w32 = f32(whole)
    if one:
        out["whole_bytes"] = sharding.local_bytes(whole)
    B = SERVE_BATCH
    prompts = torch.randint(0, cfg.vocab_size, (B, SERVE_PROMPT),
                            generator=gen(SEED + 1), device=dev)
    prefill = decode.make_prefill_step(cfg, mesh)
    prefill(mine, prompts[:, :8])                           # warm-up
    pre, out["prefill"] = counted(lambda: prefill(mine, prompts))
    if one:
        pre1, c1 = counted(lambda: decode.make_prefill_step(cfg)(whole,
                                                                 prompts))
        out["prefill1_ms"] = c1["ms"]
        out["prefill_gap"] = _gap(pre, pre1)
        out["prefill_ties"] = _near_ties(pre, pre1)
        del pre1
    del pre
    # four steps on the serve phase's 544-slot cache (272 slots a rank),
    # filled at random from a seed, in bf16 and on the weights cast to
    # float32; rank 0 runs them unsharded on a copy of the same cache
    S_full = SERVE_PROMPT + SERVE_STEPS
    g = gen(SEED + 7)
    full = decode.init_cache(cfg, B, S_full, device=dev)
    for t in tr.tree_leaves(full):
        t.copy_(torch.randn(t.shape, generator=g, device=dev))
    toks = torch.randint(0, cfg.vocab_size, (TP_STEPS, B, 1), generator=g,
                         device=dev)
    logits = {}
    for name, c, pm, pw in (("bf16", cfg, mine, whole),
                            ("f32", cfg32, f32(mine), w32)):
        glob = tr.tree_map(lambda t: t.to(pm["embed"].dtype, copy=True),
                           full)
        local = tr.tree_map(lambda t: t.clone(),
                            decode.shard_cache(glob, c, mesh))
        out["slots"] = [cc[0].shape[2] for st, sc in zip(cfg.stages, local)
                        for kind, cc in zip(st.unit, sc)
                        if kind == "shared_attn"]
        out["cache_bytes"] = (sharding.local_bytes(local),
                              sharding.local_bytes(glob))
        step = decode.make_decode_step(c, mesh)
        lg, counts = [], []
        for i in range(TP_STEPS):
            at = torch.full((B,), TP_AT + i, dtype=torch.int32, device=dev)
            l, cnt = counted(lambda: step(pm, local, toks[i], at)[0].float())
            lg.append(l)
            counts.append(cnt)
        out[f"decode_{name}"] = counts
        if one:
            step1 = decode.make_decode_step(c)
            lg1, ms1 = [], []
            for i in range(TP_STEPS):
                at = torch.full((B,), TP_AT + i, dtype=torch.int32,
                                device=dev)
                l, cnt = counted(lambda: step1(pw, glob, toks[i],
                                               at)[0].float())
                lg1.append(l)
                ms1.append(cnt["ms"])
            out[f"decode1_{name}_ms"] = ms1
            logits[name] = (torch.stack(lg), torch.stack(lg1))
            out[f"decode_{name}_finite"] = bool(torch.stack(lg).isfinite()
                                                .all())
        del glob, local, pm, pw
    if one:
        out["decode_bf16_gap"] = _gap(*logits["bf16"])
        out["decode_bf16_ties"] = _near_ties(*logits["bf16"])
        out["decode_f32_gap"] = _gap(*logits["f32"])
    del full, logits, w32
    torch.cuda.empty_cache()
    # one train step at model 2, float32, cut to one repeat unit (7
    # blocks), against the same step on the whole cut (rank 0); the trained
    # shards gathered over 'model' for the comparison
    cut, p_cut = _one_unit(tr, mine, cfg, torch)
    specs = sharding.param_specs(p_cut, cut, 2)
    tcfg = ts.TrainConfig(remat=True)
    state = {"params": p_cut,
             "opt": opt.init_state(p_cut, tcfg.adamw, specs, mesh)}
    t = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                      generator=gen(SEED + 8), device=dev)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    step = ts.make_train_step(cut, tcfg, mesh)
    (state, m), out["train"] = counted(lambda: step(state, batch))
    out["train_loss"] = float(m["loss"])
    group = mesh.get_group("model")
    trained = [t if sharding.spec_dim(sp, "model") is None else
               ctx.all_gather(t, sharding.spec_dim(sp, "model"), group)
               for t, sp in zip(tr.tree_leaves(state["params"]),
                                sharding.leaves(specs))]
    del state
    if one:
        cut1, p1 = _one_unit(tr, whole, cfg, torch)
        state1 = {"params": p1, "opt": opt.init_state(p1, tcfg.adamw)}
        (state1, m1), c1 = counted(lambda: ts.make_train_step(
            cut1, tcfg)(state1, batch))
        out["train1_ms"] = c1["ms"]
        out["train_loss1"] = float(m1["loss"])
        out["train_param_err"] = max(
            float((a - b).abs().max()) for a, b in
            zip(trained, tr.tree_leaves(state1["params"])))
        del state1, p1
    del trained, mine, whole, p_cut
    torch.cuda.empty_cache()
    # deepseek-v2-lite at full width, 2 layers: MLA with the query heads
    # gathered, expert-parallel MoE; the sharded runs' routing recorded and
    # replayed in rank 0's runs on the whole weights
    dcfg = _zoo_cfg("deepseek-v2-lite-16b", TP_DEEPSEEK_KEEP)
    dm, out["ds_init"] = init(dcfg)
    out["ds_bytes"] = rank_bytes(dcfg, mesh, dm)
    dw = tr.init_params(gen(SEED), dcfg, device=dev) if one else None
    route = moe_mod.route
    dprompts = torch.randint(0, dcfg.vocab_size, (B, SERVE_PROMPT),
                             generator=gen(SEED + 9), device=dev)
    seen = []
    moe_mod.route = _route_recorder(moe_mod, seen)
    dpre, out["ds_prefill"] = counted(lambda: decode.make_prefill_step(
        dcfg, mesh)(dm, dprompts))
    if one:
        moe_mod.route = _route_replay([(None, i) for _, i in seen])
        dpre1, c1 = counted(lambda: decode.make_prefill_step(dcfg)(dw,
                                                                   dprompts))
        out["ds_prefill1_ms"] = c1["ms"]
        out["ds_prefill_gap"] = _gap(dpre, dpre1)
        out["ds_prefill_ties"] = _near_ties(dpre, dpre1)
        del dpre1
    del dpre
    g = gen(SEED + 10)
    dfull = decode.init_cache(dcfg, B, S_full, device=dev)
    for t in tr.tree_leaves(dfull):
        t.copy_(torch.randn(t.shape, generator=g, device=dev))
    dtoks = torch.randint(0, dcfg.vocab_size, (TP_STEPS, B, 1), generator=g,
                          device=dev)
    dlocal = tr.tree_map(lambda t: t.clone(),
                         decode.shard_cache(dfull, dcfg, mesh))
    dstep = decode.make_decode_step(dcfg, mesh)
    seen = []
    moe_mod.route = route
    moe_mod.route = _route_recorder(moe_mod, seen)
    lg, counts = [], []
    for i in range(TP_STEPS):
        at = torch.full((B,), TP_AT + i, dtype=torch.int32, device=dev)
        l, cnt = counted(lambda: dstep(dm, dlocal, dtoks[i], at)[0].float())
        lg.append(l)
        counts.append(cnt)
    out["ds_decode"] = counts
    if one:                 # the same steps on the whole weights
        moe_mod.route = _route_replay([(None, i) for _, i in seen])
        dstep1 = decode.make_decode_step(dcfg)
        lg1 = [dstep1(dw, dfull, dtoks[i],
                      torch.full((B,), TP_AT + i, dtype=torch.int32,
                                 device=dev))[0].float()
               for i in range(TP_STEPS)]
        out["ds_decode_gap"] = _gap(torch.stack(lg), torch.stack(lg1))
        out["ds_decode_ties"] = _near_ties(torch.stack(lg), torch.stack(lg1))
    moe_mod.route = route
    out["rank_s"] = time.perf_counter() - t_rank
    torch.save(out, os.path.join(out_dir, f"tp{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def phase_tp(torch, smi_line):
    """Tensor-parallel weights on the card: two ranks share it over gloo
    (zamba2-2.7b at full width and depth: the bytes each rank holds, the
    prefill, four decode steps on the serve phase's cache in bf16 and in
    float32, one float32 train step cut to one repeat unit; deepseek-v2-lite
    at full width cut to 2 layers: prefill and four decode steps), each
    against the same run on the whole weights."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.configs.registry import get_config
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(dir=str(ROOT / "build"))
    pc = mp.start_processes(_tp_rank, args=(out_dir, _free_port()),
                            nprocs=2, join=False, start_method="spawn")
    deadline = time.perf_counter() + TP_TIMEOUT
    try:
        while not pc.join(timeout=2):
            check(time.perf_counter() < deadline,
                  f"the two tp ranks outlasted {TP_TIMEOUT} s")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
                p.join()
    got = [torch.load(os.path.join(out_dir, f"tp{r}.pt")) for r in (0, 1)]
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = get_config(ARCH)
    n_attn = sum(s.repeats * s.unit.count("shared_attn") for s in cfg.stages)
    n_mamba = sum(s.repeats * s.unit.count("mamba") for s in cfg.stages)
    coll = lambda decode: dict(zip(("all_reduce", "all_gather"),
                                   _tp_collectives(n_mamba, n_attn, decode)))
    dcfg = _zoo_cfg("deepseek-v2-lite-16b", TP_DEEPSEEK_KEEP)
    n_mla = sum(s.repeats * len(s.unit) for s in dcfg.stages)
    gb = lambda n: f"{n / 1e9:.3f} GB"
    for r, o in enumerate(got):
        check(o["backend"] == "gloo" and o["device"] == "cuda:0",
              f"tp rank {r}: {o['backend']} on {o['device']}")
        for what, b, m in (("zamba2", o["bytes"], o["init"]),
                           ("deepseek", o["ds_bytes"], o["ds_init"])):
            check(b["params"] == b["params_reckoned"]
                  and abs(m["alloc"] - b["params"]) <= 0.01 * b["params"],
                  f"tp rank {r}, {what}: {b['params']:,} bytes of shards, "
                  f"{m['alloc']:,} allocated, reckoned "
                  f"{b['params_reckoned']:,}")
            # drawing a block whole, its largest leaf in float32 and the
            # cut shard beside it: at most three blocks above the shards
            check(m["peak"] <= b["params"] + 3 * m["block"],
                  f"tp rank {r}, {what}: peak {m['peak']:,} bytes while "
                  f"drawing {b['params']:,} of shards, above them by more "
                  f"than three of its largest block ({m['block']:,})")
        check(o["slots"] and all(n == (SERVE_PROMPT + SERVE_STEPS) // 2
                                 for n in o["slots"]),
              f"tp rank {r}: cache slots {o['slots']}")
        pre = o["prefill"]
        check(pre["launches"] == {"flash_attention": n_attn,
                                  "ssd_scan": n_mamba}
              and pre["routes"] == {ZAMBA2_K5_ROUTE: n_attn,
                                    "ssd_scan.bf16_tc": n_mamba}
              and pre["collectives"] == coll(False)
              and pre["reduced"] == {"cuda": sum(coll(False).values())},
              f"tp rank {r}: prefill counts {pre}")
        for name in ("bf16", "f32"):
            for i, c in enumerate(o[f"decode_{name}"]):
                check(c["launches"] == {"decode_attention": n_attn}
                      and c["routes"] == {"decode_attention.partials": n_attn}
                      and c["collectives"] == coll(True)
                      and c["reduced"] == {"cuda": sum(coll(True).values())},
                      f"tp rank {r}, {name} decode step {i}: counts {c}")
        tr_c = o["train"]
        check(tr_c["launches"].get("flash_attention", 0) > 0
              and tr_c["launches"].get("ssd_scan", 0) > 0
              and set(tr_c["reduced"]) == {"cuda"},
              f"tp rank {r}: train step counts {tr_c}")
        check(o["ds_prefill"]["launches"] == {"flash_attention": n_mla}
              and set(o["ds_prefill"]["reduced"]) == {"cuda"},
              f"tp rank {r}: deepseek prefill counts {o['ds_prefill']}")
        for i, c in enumerate(o["ds_decode"]):
            check(c["routes"] == {"decode_attention.partials": n_mla}
                  and set(c["reduced"]) == {"cuda"},
                  f"tp rank {r}: deepseek decode step {i} counts {c}")
        check(o["train_loss"] == got[0]["train_loss"],
              "the two tp ranks report different losses")
    r0 = got[0]
    for key, what in (("prefill", "zamba2 prefill"),
                      ("decode_bf16", "zamba2 decode, bf16"),
                      ("ds_prefill", "deepseek prefill"),
                      ("ds_decode", "deepseek decode")):
        check(r0[key + "_gap"][0] <= TOL_BF16, f"tp {what} against the "
              f"unsharded run: {_gap_line(r0[key + '_gap'])}, beyond "
              f"{TOL_BF16}")
        _check_ties(r0[key + "_ties"], f"tp {what}")
    check(r0["decode_f32_gap"][2] <= TOL_F32, f"tp zamba2 decode, float32, "
          f"against the unsharded run: {_gap_line(r0['decode_f32_gap'])}, "
          f"beyond {TOL_F32}")
    check(r0["decode_bf16_finite"] and r0["decode_f32_finite"],
          "tp decode logits not finite")
    loss_rel = abs(r0["train_loss"] - r0["train_loss1"]) / abs(
        r0["train_loss1"])
    check(loss_rel <= TOL_LOSS_TP and r0["train_param_err"] <= TOL_PARAM_TP,
          f"tp train step: loss rel {loss_rel:.3e}, parameters "
          f"{r0['train_param_err']:.3e}")
    b = r0["bytes"]
    say("tp", f"{cfg.name} at full width and depth over two ranks on one "
        f"card (launch_mesh(1, 2), gloo, both on cuda:0), bf16, seed "
        f"{SEED}: each rank holds {gb(b['params'])} of weights "
        f"(torch.cuda.memory_allocated {gb(r0['init']['alloc'])} and "
        f"{gb(got[1]['init']['alloc'])}; reckoned from param_specs "
        f"{gb(b['params_reckoned'])}) against {gb(r0['whole_bytes'])} whole; "
        f"peak while drawing them {gb(r0['init']['peak'])} and "
        f"{gb(got[1]['init']['peak'])} (torch.cuda.max_memory_allocated; "
        f"the largest block drawn whole {gb(r0['init']['block'])}); "
        f"its cache on the serve phase's {SERVE_PROMPT + SERVE_STEPS} slots "
        f"{gb(r0['cache_bytes'][0])} of {gb(r0['cache_bytes'][1])} (bf16)")
    say("tp", f"prefill B {SERVE_BATCH} x {SERVE_PROMPT}: K5 "
        f"{r0['prefill']['launches']['flash_attention']} and K7 "
        f"{r0['prefill']['launches']['ssd_scan']} launches a rank, "
        f"{r0['prefill']['collectives']} a rank, every tensor on cuda; "
        f"{r0['prefill']['ms']:.1f} ms sharded, {r0['prefill1_ms']:.1f} "
        f"unsharded; bf16 logits against the unsharded run's "
        f"{_gap_line(r0['prefill_gap'])} (tolerance {TOL_BF16}, normwise), "
        f"{len(r0['prefill_ties'])} greedy picks differ, each at a near-tie")
    for name in ("bf16", "f32"):
        cs = r0[f"decode_{name}"]
        err = (f"{_gap_line(r0[f'decode_{name}_gap'])} from the unsharded "
               + (f"step (tolerance {TOL_BF16}, normwise; "
                  f"{len(r0['decode_bf16_ties'])} greedy picks differ, each "
                  f"at a near-tie)" if name == "bf16" else
                  f"step (tolerance {TOL_F32}, elementwise)"))
        say("tp", f"decode, {name}, {TP_STEPS} steps from position {TP_AT} "
            f"on {r0['slots'][0]} of {2 * r0['slots'][0]} slots a rank: "
            f"per step K6 partials {cs[0]['routes']}, "
            f"{cs[0]['collectives']}, all on cuda; step ms sharded "
            f"{[round(c['ms'], 2) for c in cs]}, unsharded "
            f"{[round(x, 2) for x in r0[f'decode1_{name}_ms']]}; logits "
            f"{err}")
    say("tp", f"train step, float32, cut to one repeat unit (7 blocks), "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}: loss {r0['train_loss']:.6f} "
        f"sharded, {r0['train_loss1']:.6f} whole (rel {loss_rel:.3e}, "
        f"tolerance {TOL_LOSS_TP}); parameters after the step max abs diff "
        f"{r0['train_param_err']:.3e} (tolerance {TOL_PARAM_TP}); "
        f"{r0['train']['collectives']} a rank, K5 "
        f"{r0['train']['launches'].get('flash_attention', 0)} and K7 "
        f"{r0['train']['launches'].get('ssd_scan', 0)} launches; "
        f"{r0['train']['ms']:.1f} ms sharded, {r0['train1_ms']:.1f} whole")
    db = r0["ds_bytes"]
    say("tp", f"deepseek-v2-lite-16b at full width, reduced: "
        f"{n_mla} of 27 layers ({TP_DEEPSEEK_KEEP} repeat a stage): each "
        f"rank holds {gb(db['params'])} (allocated "
        f"{gb(r0['ds_init']['alloc'])}, reckoned "
        f"{gb(db['params_reckoned'])}, peak while drawing "
        f"{gb(r0['ds_init']['peak'])}); prefill B {SERVE_BATCH} x "
        f"{SERVE_PROMPT} {r0['ds_prefill']['collectives']} a rank, logits "
        f"{_gap_line(r0['ds_prefill_gap'])}; {TP_STEPS} decode steps, per "
        f"step {r0['ds_decode'][0]['routes']} and "
        f"{r0['ds_decode'][0]['collectives']}, logits "
        f"{_gap_line(r0['ds_decode_gap'])} from the unsharded runs "
        f"(tolerance {TOL_BF16}, normwise; greedy picks differing "
        f"{len(r0['ds_prefill_ties'])} and {len(r0['ds_decode_ties'])}, "
        f"each at a near-tie; the sharded run's routing replayed in them)")
    say("tp", f"phase tp took {time.perf_counter() - t_phase:.1f} s (ranks "
        f"{got[0]['rank_s']:.1f} and {got[1]['rank_s']:.1f} s) | {smi_line}")
    # K6's partials at a rank's 272 of the 544 slots: the bf16 steps
    return sum(c["routes"].get("decode_attention.partials", 0)
               for c in r0["decode_bf16"])


# --------------------------------------------------- placement_mesh phase
PM_TIMEOUT = 240                 # seconds the two placement ranks may take
PM_FLEET_T = 255                 # phase stream's binding T 256 fleet, less
                                 # its last tenant: no rank count divides it
PM_ALLOC_SLACK = 1 << 20         # bytes the caching allocator may add to
                                 # an allocation (it keeps a block whole
                                 # when less than 1 MiB would be left)


def _placement_rank(rank, out_dir, port):
    """One of two ranks sharing the card over gloo: G-PART's overlap matrix
    in row slabs (K1's rectangular sweep) and the fleet's tenant axis over
    'data' of a 2 x 1 mesh, then phase train's checkpoint cut restored onto
    'model' of a 1 x 2 mesh; rank 0 also runs each unsharded."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    sys.path.insert(0, str(ROOT / "src"))
    import pickle

    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import manager as cm
    from repro_torch.configs.registry import get_config
    from repro_torch.core import datapart as dp
    from repro_torch.core import optassign
    from repro_torch.core.engine import ScopeConfig
    from repro_torch.distributed import ctx, sharding
    from repro_torch.kernels import ops
    from repro_torch.kernels import overlap as ov
    from repro_torch.launch.mesh import launch_mesh, make_test_mesh
    from repro_torch.storage.store import TieredStore
    from repro_torch.training.optimizer import zero1_tree_specs
    t_rank = time.perf_counter()
    m12, dev = launch_mesh(1, 2, CARD)
    m21 = make_test_mesh(2, 1, device_type=dev.type)
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {"backend": dist.get_backend(), "device": str(dev), "k1": {}}
    sync = torch.cuda.synchronize

    # 1. K1's row slabs and G-PART over 'data'
    scfg = ScopeConfig(device=CARD)
    for tag, parts in inp["graphs"].items():
        idx = dp.PartitionIndex.from_partitions(parts)
        codes, sizes, _ = idx.padded_codes()
        med = float(np.median([p.span for p in parts]))
        kw = dict(s_thresh=scfg.s_thresh_mult * med, rho_c=scfg.rho_c,
                  rho_c_abs=scfg.rho_c_abs, backend="device", device=dev)
        ops.reset_launch_counts()
        ctx.collectives.clear()
        sync()
        t0 = time.perf_counter()
        w = idx.overlap_matrix(dev, mesh=m21)
        sync()
        rec = {"n": idx.n, "F": len(sizes), "ms": 1e3 * (time.perf_counter()
                                                          - t0),
               "launches": dict(ops.launch_counts),
               "collectives": dict(ctx.collectives),
               "plans": (ov.plan(-(-idx.n // 2), idx.n, codes.shape[1],
                                 codes.shape[1], len(sizes)).kind,
                         ov.plan(idx.n, idx.n, codes.shape[1],
                                 codes.shape[1], len(sizes)).kind)}
        merged = dp.g_part(parts, mesh=m21, **kw)
        rec["parts"] = canon(merged)
        if rank == 0:
            sync()
            t0 = time.perf_counter()
            w1 = idx.overlap_matrix(dev)
            sync()
            rec.update(ms1=1e3 * (time.perf_counter() - t0),
                       equal=bool(np.array_equal(w, w1)) and w.shape == w1.shape,
                       edges=int((np.triu(w1, 1) > 0).sum()),
                       parts1=canon(dp.g_part(parts, **kw)))
        out["k1"][tag] = rec

    # 2. the fleet's tenant axis over 'data'
    cols, kw = inp["fleet"]
    seen = []
    run = optassign._run_fleet_scan

    def keep(*a):
        cells = run(*a)
        seen.append(cells)
        return cells
    optassign._run_fleet_scan = keep
    try:
        ops.reset_launch_counts()
        ctx.collectives.clear()
        ctx.reduced_on.clear()
        sync()
        t0 = time.perf_counter()
        fl = optassign.capacitated_assign_batch(*cols, mesh=m21, device=dev,
                                                **kw)
        sync()
        out["fleet"] = dict(s=time.perf_counter() - t0,
                            launches=dict(ops.launch_counts),
                            collectives=dict(ctx.collectives),
                            reduced=dict(ctx.reduced_on),
                            plans=[(a.tier, a.scheme, a.cost, a.feasible)
                                   for a in fl.assignments],
                            cost=fl.cost, feasible=fl.feasible,
                            shared=fl.shared_use_gb)
        if rank == 0:
            sync()
            t0 = time.perf_counter()
            fl1 = optassign.capacitated_assign_batch(*cols, device=dev, **kw)
            sync()
            out["fleet"].update(
                s1=time.perf_counter() - t0,
                plans1=[(a.tier, a.scheme, a.cost, a.feasible)
                        for a in fl1.assignments], cost1=fl1.cost,
                cells_equal=bool(np.array_equal(seen[0], seen[1])),
                steps=seen[0].shape[0], T=seen[0].shape[1])
    finally:
        optassign._run_fleet_scan = run

    # 3. phase train's checkpoint cut restored onto 'model'
    store = TieredStore()
    store._objs = inp["ckpt"]["objs"]
    like = inp["ckpt"]["like"]
    cfg = get_config(ARCH)
    # each leaf's param_specs rule, by its name's last part (the cut's
    # keys are _named_leaves paths), padded to the leaf's rank
    p_specs = {n: sharding.param_specs({n.rsplit("/", 1)[-1]: t}, cfg, 2)
               .popitem()[1] for n, t in like["params"].items()}
    z = zero1_tree_specs(p_specs, like["params"], m12)
    opt = like["opt"]
    specs = {"params": p_specs,
             "opt": opt._replace(step=sharding.Spec(), master=z, m=z, v=z,
                                 err=None if opt.err is None else p_specs)}
    mgr = cm.CheckpointManager(store, device=dev)
    sync()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    mine, step = mgr.restore(like, device=dev, mesh=m12, shardings=specs)
    sync()
    t_restore = time.perf_counter() - t0
    held = torch.cuda.memory_allocated(dev) - base
    peak = torch.cuda.max_memory_allocated(dev) - base
    whole, _ = mgr.restore(like, device="cpu")
    bad, largest, sharded, gap = [], 0, 0, float("inf")
    for (p, a), (_, w), (_, s) in zip(cm._leaf_paths(mine),
                                      cm._leaf_paths(whole),
                                      cm._leaf_paths(specs)):
        if a.device != dev or not torch.equal(
                _bits(torch, a.cpu()),
                _bits(torch, sharding.shard_leaf(w, s, m12))):
            bad.append(p)
        if any(e is not None for e in s):
            sharded += 1
            nb = w.numel() * w.element_size()
            largest = max(largest, nb)
            # what a whole leaf would hold on the card beyond its piece
            gap = min(gap, nb - a.numel() * a.element_size())
    out["restore"] = dict(step=step, bad=bad, s=t_restore, held=held,
                          peak=peak, bytes=sharding.local_bytes(mine),
                          whole=sharding.local_bytes(whole),
                          largest=largest, sharded=sharded, gap=gap,
                          leaves=len(cm._leaf_paths(mine)))
    out["rank_s"] = time.perf_counter() - t_rank
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _placement_fleet():
    """Phase stream's T 256 fleet whose shared cap binds (the most used
    tier at 70% of its greedy use, the tenants' own caps lifted), less its
    last tenant: (columns, solver keywords)."""
    from repro_torch.core import optassign
    fleet = _bench_fleet(PM_FLEET_T + 1, FLEET_MEAN_N, PM_FLEET_T + 1)
    fleet = fleet[:PM_FLEET_T]
    L = fleet[0][0].shape[1]
    use = np.zeros(L)
    for c, f, s, _ in fleet:
        cell = np.where(f, c, optassign.BIG).reshape(c.shape[0], -1).argmin(1)
        use += optassign._chosen_usage(s, cell // 3, cell % 3)
    scap = np.full(L, np.inf)
    scap[use.argmax()] = 0.7 * use.max()
    cols = [[x[i] for x in fleet] for i in range(3)]
    cols.append([np.full(L, np.inf)] * len(fleet))
    return cols, dict(shared_tier_groups=np.arange(L),
                      shared_capacity_gb=scap)


def phase_placement_mesh(torch, parts, ckpt, smi_line):
    """The placement system over two ranks that share the card (gloo): K1's
    row slabs for G-PART's candidate graph, the fleet scan's tenant axis,
    phase train's checkpoint cut restored onto 'model'; each held to the
    unsharded run. Then one dry-run cell in a subprocess on the host."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp
    from repro_torch.core import datapart as dp
    t_phase = time.perf_counter()
    card = f"| {smi_line}"
    out_dir = tempfile.mkdtemp(dir=str(ROOT / "build"))
    # the dry run's cell runs on the host meanwhile (meta tensors)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", "decode_32k", "--multi-pod", "single", "--out",
         out_dir], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        big = gpart_instance(dp, 4096, 4096 * 20)
        inputs = {"graphs": {"main": parts, "4096x81920": big},
                  "fleet": _placement_fleet(), "ckpt": ckpt}
        with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        torch.cuda.empty_cache()
        pc = mp.start_processes(_placement_rank,
                                args=(out_dir, _free_port()), nprocs=2,
                                join=False, start_method="spawn")
        deadline = time.perf_counter() + PM_TIMEOUT
        try:
            while not pc.join(timeout=1):
                check(time.perf_counter() < deadline,
                      f"the two placement ranks outlasted {PM_TIMEOUT} s")
        finally:
            for p in pc.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        got = []
        for r in (0, 1):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                got.append(pickle.load(f))
        dry_out, _ = dry.communicate(timeout=PM_TIMEOUT)
        check(dry.returncode == 0, f"the dry run exited {dry.returncode}: "
              f"{dry_out[-2000:]}")
        with open(os.path.join(out_dir,
                               f"{ARCH}__decode_32k__pod16x16.json")) as f:
            cell = json.load(f)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        shutil.rmtree(out_dir, ignore_errors=True)

    for r, o in enumerate(got):
        check(o["backend"] == "gloo" and o["device"] == "cuda:0",
              f"rank {r}: {o['backend']} on {o['device']}, want gloo on "
              f"cuda:0")
    # K1's slabs
    k1_launches = 0
    for tag, rec in got[0]["k1"].items():
        other = got[1]["k1"][tag]
        check(rec["equal"], f"K1 {tag}: the slabs' matrix is not the "
              f"unsharded matrix's bits")
        check(rec["parts"] == rec["parts1"] == other["parts"],
              f"K1 {tag}: G-PART's partitions over the mesh differ")
        for r, x in enumerate((rec, other)):
            check(x["launches"] == {"overlap": 1}
                  and x["collectives"] == {"all_gather": 1},
                  f"K1 {tag}, rank {r}: launches {x['launches']}, "
                  f"collectives {x['collectives']}")
        k1_launches += rec["launches"]["overlap"]
        say("placement_mesh", f"K1 {tag}: {rec['n']} rows over {rec['F']:,} "
            f"files, a slab of {-(-rec['n'] // 2)} rows a rank against all "
            f"{rec['n']} (plan {rec['plans'][0]}; the whole matrix's "
            f"{rec['plans'][1]}), one launch and one all-gather a rank: "
            f"bit-identical to the unsharded matrix on the card "
            f"({rec['edges']:,} edges); G-PART's {len(rec['parts'])} "
            f"partitions identical on both ranks and unsharded; "
            f"{rec['ms']:.2f} ms sharded (gather included), "
            f"{rec['ms1']:.2f} unsharded {card}")
    check(got[0]["k1"]["main"]["n"] == 217,
          f"phase main's graph has {got[0]['k1']['main']['n']} rows, want 217")
    # the fleet
    f0, f1 = got[0]["fleet"], got[1]["fleet"]
    check(f0["cells_equal"] and f0["T"] == PM_FLEET_T,
          f"fleet T {PM_FLEET_T}: the sharded scan's cells differ from the "
          f"unsharded scan's")
    same = lambda a, b: all(
        np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        and x[2] == y[2] and x[3] == y[3] for x, y in zip(a, b))
    check(same(f0["plans"], f0["plans1"]) and same(f0["plans"], f1["plans"])
          and f0["cost"] == f0["cost1"] == f1["cost"] and f0["feasible"],
          f"fleet T {PM_FLEET_T}: the plans over the mesh differ from the "
          f"unsharded plans (or between the ranks), or are infeasible")
    steps = f0["steps"]
    for r, f in enumerate((f0, f1)):
        check(f["launches"] == {"usage_sum": steps}
              and f["collectives"] == {"all_reduce": steps, "all_gather": 1}
              and f["reduced"] == {"cuda": steps + 1},
              f"fleet, rank {r}: launches {f['launches']}, collectives "
              f"{f['collectives']} on {f['reduced']}; want usage_sum and "
              f"one all-reduce a step, one all-gather, all on cuda")
    scap = _placement_fleet()[1]["shared_capacity_gb"]
    fin = np.isfinite(scap)
    say("placement_mesh", f"fleet T {PM_FLEET_T} (phase stream's binding "
        f"T 256 fleet less its last tenant, mean N {FLEET_MEAN_N}): "
        f"{-(-PM_FLEET_T // 2)} tenants a rank (one dummy pads rank 1), "
        f"{steps} scan steps, each rank's usage_sum launched once a step "
        f"and the shared rows' float64 sums all-reduced once a step (cells "
        f"gathered once), all on cuda; the cells identical to the "
        f"unsharded scan's at every step and the plans identical (shared "
        f"cap {scap[fin].tolist()} GB, use "
        f"{np.asarray(f0['shared'])[fin].tolist()} GB, {f0['cost']!r} "
        f"cents); {f0['s']:.3f} s over the mesh, {f0['s1']:.3f} s "
        f"unsharded {card}")
    # the restore
    rs = [o["restore"] for o in got]
    for r, x in enumerate(rs):
        check(x["step"] == 1 and not x["bad"],
              f"restore, rank {r}: step {x['step']}, pieces that are not "
              f"the unsharded restore's slices: {x['bad'][:5]}")
        check(x["held"] <= x["bytes"] + PM_ALLOC_SLACK * x["leaves"]
              and x["peak"] - x["held"] < x["gap"]
              and x["bytes"] < x["whole"],
              f"restore, rank {r}: {x['held']:,} bytes held and {x['peak']:,}"
              f" at the peak for {x['bytes']:,} of pieces ({x['whole']:,} "
              f"whole; a whole sharded leaf would add at least "
              f"{x['gap']:,})")
    say("placement_mesh", f"phase train's checkpoint cut ({rs[0]['leaves']} "
        f"leaves, {rs[0]['whole']:,} bytes) restored onto 'model' of a 1 x 2 "
        f"mesh: {rs[0]['sharded']} leaves sharded by param_specs (ZeRO-1 "
        f"specs for AdamW's state: data 1), each rank's pieces equal to the "
        f"slices of the unsharded restore; device bytes a rank "
        f"{[x['bytes'] for x in rs]} (memory_allocated "
        f"{[x['held'] for x in rs]}, peak {[x['peak'] for x in rs]}: the "
        f"peak never above what is held, where a whole sharded leaf would "
        f"add at least {rs[0]['gap']:,} bytes, the largest "
        f"{rs[0]['largest']:,} whole); {[round(x['s'], 2) for x in rs]} s "
        f"{card}")
    roof = cell["roofline"]
    check(cell["status"] == "ok" and cell["chips"] == 256,
          f"dry run: {cell.get('status')} {cell.get('error', '')}")
    say("placement_mesh", f"dry run (on the host, under this torch): "
        f"{ARCH} decode_32k on pod16x16 as rank 0 of a fake group of 256: "
        f"rank bytes {cell['rank_bytes']}; terms for an H100 (989 TFLOP/s "
        f"bf16, 3.35 TB/s, NVLink 450 GB/s a direction): compute "
        f"{roof['compute_s']:.6f} s, memory {roof['memory_s']:.6f} s, "
        f"collective {roof['collective_s']:.6f} s, {roof['dominant']} "
        f"dominant; {cell['run_s']} s")
    say("placement_mesh", f"phase placement_mesh took "
        f"{time.perf_counter() - t_phase:.1f} s (ranks "
        f"{got[0]['rank_s']:.1f} and {got[1]['rank_s']:.1f} s) {card}")
    return k1_launches


# --------------------------------------------------------------- zoo phase
#: the four configs served after zamba2, one after another, each at full
#: width: (arch, repeats kept per stage or None for full depth, prefill
#: prompt length)
ZOO = (("deepseek-v2-lite-16b", None, 512),
       ("whisper-small", None, 128),          # its decoder publishes 448
       ("llama4-scout-17b-a16e", 8, 512),     # 8 of 48 layers
       ("llama-3.2-vision-90b", 2, 512))      # 2 of 20 repeats: 10 layers
ZOO_BATCH, ZOO_PROMPT, ZOO_NEW = 4, 128, 32   # the serve loop: 159 steps
ZOO_LATENT_KV = 4096        # K6's latent mode also timed at this kv_len
#: K5 launches per block in a prefill, and K5 and K6 per block in a decode
#: step, by block kind
PREFILL_K5 = {"attn": 1, "attn_local": 1, "shared_attn": 1, "moe": 1,
              "mla_dense": 1, "mla_moe": 1, "cross": 1, "decoder": 2}
STEP_K5 = {"cross": 1, "decoder": 1}
STEP_K6 = {"attn": 1, "attn_local": 1, "shared_attn": 1, "moe": 1,
           "mla_dense": 1, "mla_moe": 1, "decoder": 1}


def _route_recorder(moe_mod, seen):
    """A ``moe.route`` that records each call's (router logits, experts)."""
    route = moe_mod.route

    def recording(logits, k):
        v, i = route(logits, k)
        seen.append((logits, i))
        return v, i
    return recording


def _route_replay(seen):
    """A ``moe.route`` that takes each call's experts from ``seen``, in
    order: another run's routing, gated by this run's logits."""
    it = iter(seen)

    def replaying(logits, k):
        _, i = next(it)
        return logits.gather(-1, i), i
    return replaying


def _flips(a, b):
    """(routing choices taken in run ``a`` and not in run ``b``, all
    choices, the largest router-logit difference at a token whose choices
    differ) over two runs' records. A choice can flip only where the
    difference reaches the gap between the k-th and (k+1)-th logits."""
    import torch
    n = total = 0
    worst = 0.0
    for (la, ia), (lb, ib) in zip(a, b):
        sa = torch.zeros_like(la, dtype=torch.bool).scatter_(-1, ia, True)
        sb = torch.zeros_like(lb, dtype=torch.bool).scatter_(-1, ib, True)
        n += int((sa & ~sb).sum())
        total += ia.numel()
        tok = (sa != sb).any(-1)
        if bool(tok.any()):
            worst = max(worst, float((la - lb).abs()[tok].max()))
    return n, total, worst


def _zoo_cfg(arch, keep):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import Stage
    cfg = get_config(arch)
    if keep is not None:
        cfg = cfg.scaled(stages=tuple(Stage(s.unit, min(s.repeats, keep))
                                      for s in cfg.stages))
    return cfg


def _per_block(stages, table):
    return sum(s.repeats * sum(table.get(k, 0) for k in s.unit)
               for s in stages or ())


def _zoo_one(torch, arch, keep, P, smi_line, recorded):
    """One config of phase zoo: weights from the seed, prefill (kernels
    against plain versions), the serve loop with per-step launch counts,
    busy shares; returns its numbers. The weights are freed by the
    caller."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import shapes
    from repro_torch.launch.serve import serve
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tr
    from repro_torch.serving.decode import make_decode_step, make_prefill_step

    dev = torch.device(CARD)
    cfg = _zoo_cfg(arch, keep)
    full = _zoo_cfg(arch, None)
    B, T = ZOO_BATCH, ZOO_NEW
    g = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tr.init_params(g, cfg, device=CARD)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_par = tr.param_count(params)
    gb = sum(t.numel() * t.element_size() for t in tr.tree_leaves(params)) / 1e9
    spec = shapes.input_specs(cfg, "prefill_32k").get("context")
    ctx = None
    if spec is not None:            # patch embeddings, or whisper's frames
        ctx = torch.randn((B,) + tuple(spec.shape[1:]), generator=g,
                          device=dev).to(spec.dtype)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(SEED + 1))
    n_k5 = _per_block(cfg.stages, PREFILL_K5) + _per_block(
        cfg.encoder_stages, PREFILL_K5)
    step_k5, step_k6 = (_per_block(cfg.stages, STEP_K5),
                        _per_block(cfg.stages, STEP_K6))
    cut = (f"{cfg.n_layers} of {full.n_layers} layers" if keep else
           f"full depth, {cfg.n_layers} layers"
           + (f" + {_per_block(cfg.encoder_stages, {'attn': 1})} encoder"
              if cfg.encoder_stages else ""))
    say("zoo", f"{cfg.name}: {n_par:,} parameters, {gb:.3f} GB in "
        f"{cfg.dtype} ({cut}; d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}"
        + (f", MLA latent {cfg.kv_lora_rank} + {cfg.qk_rope_dim}"
           if cfg.kv_lora_rank else "")
        + (f", {cfg.n_experts} experts top-{cfg.top_k} + "
           f"{cfg.n_shared_experts} shared" if cfg.n_experts else "")
        + (f", context {tuple(ctx.shape)} {str(ctx.dtype)[6:]}"
           if ctx is not None else "")
        + f"); random weights from seed {SEED} in {init_s:.1f} s")

    def record(name, keep_first):
        """``name`` recording its calls by shape (the first or the last
        call of each) and counting them"""
        def wrapped(*a, **k):
            q, kk = a[0], a[1]
            key = (name, tuple(q.shape), tuple(kk.shape), k.get("causal"))
            if not keep_first or key not in recorded:
                recorded[key] = (cfg.name, a, k)
            calls[key] = calls.get(key, 0) + 1
            return orig[name](*a, **k)
        return wrapped

    calls = {}

    prefill = make_prefill_step(cfg)
    prefill(params, prompts[:, :64], ctx)       # warm-up: library handles
    torch.cuda.synchronize()
    orig = _swap(ops, {"flash_attention": record("flash_attention", True),
                       "decode_attention": record("decode_attention", False)})
    seen_k, seen_p = [], []         # MoE routing of the kernel prefill, plain
    try:
        ops.reset_launch_counts()
        orig_r = _swap(moe_mod, {"route": _route_recorder(moe_mod, seen_k)})
        try:
            t0 = time.perf_counter()
            logits = prefill(params, prompts, ctx)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        finally:
            _swap(moe_mod, orig_r)
        pre_counts = dict(ops.launch_counts)
        check(pre_counts == {"flash_attention": n_k5},
              f"{cfg.name} prefill launches {pre_counts}, want "
              f"flash_attention {n_k5}")
        # every zoo head is whole 64-column panels on 16-byte bases
        pre_routes = dict(ops.route_counts)
        check(pre_routes == {"flash_attention.wgmma": n_k5},
              f"{cfg.name} prefill routes {pre_routes}, want "
              f"flash_attention.wgmma {n_k5}")
        # the serve loop: K5 and K6 counted step by step
        enc = ctx
        if cfg.encoder_stages is not None:
            with torch.no_grad():
                enc = tr.encode(params, ctx, cfg)
        step = make_decode_step(cfg)
        per_step = []

        def counted(*a):
            ops.reset_launch_counts()
            out = step(*a)
            per_step.append((dict(ops.launch_counts), dict(ops.route_counts)))
            return out

        cache = tr.init_cache(cfg, B, max_seq=ZOO_PROMPT + T + 1, device=CARD)
        res = serve(counted, params, cache, prompts[:, :ZOO_PROMPT], T,
                    context=enc)
    finally:
        _swap(ops, orig)
    want_step = {k: v for k, v in (("flash_attention", step_k5),
                                   ("decode_attention", step_k6)) if v}
    # a cross-attention block's K5 call at one query: K6's split kernel
    want_routes = {"flash_attention.split": step_k5} if step_k5 else {}
    bad = [i for i, c in enumerate(per_step) if c != (want_step, want_routes)]
    steps = ZOO_PROMPT + T - 1
    check(len(per_step) == steps and not bad,
          f"{cfg.name}: {len(per_step)} decode steps, steps {bad[:5]} "
          f"launched {[per_step[i] for i in bad[:5]]}, want {want_step} "
          f"on {want_routes}")
    V = tr.padded_vocab(cfg)
    check(tuple(logits.shape) == (B, P, V) and bool(logits.isfinite().all()),
          f"{cfg.name} prefill logits not finite of ({B}, {P}, {V})")
    check(bool(res.prompt_logits.isfinite().all())
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          f"{cfg.name} serve loop: logits not finite or tokens out of range")
    loop_s = res.prompt_s + res.decode_s
    step_ms = loop_s / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9

    # kernels against their plain versions: the same prefill. MoE routing
    # is a discrete choice: a bf16 difference in the attention can flip a
    # top-k pick, and the capacity then moves other tokens' slots, a jump
    # that no tolerance on the kernels bounds. So an MoE model is compared
    # free running (reported, with its flipped choices) and checked with
    # the kernel run's routing replayed in the plain run.
    def plain_prefill(route):
        orig_p = _swap(ops, {"flash_attention": fa.flash_attention_plain})
        orig_r = _swap(moe_mod, {"route": route})
        try:
            ops.reset_launch_counts()
            out = prefill(params, prompts, ctx)
            torch.cuda.synchronize()
            check(not ops.launch_counts, f"{cfg.name}: a plain prefill "
                  f"launched {dict(ops.launch_counts)}")
        finally:
            _swap(ops, orig_p)
            _swap(moe_mod, orig_r)
        return out

    plain = plain_prefill(_route_recorder(moe_mod, seen_p))
    err_free = _normwise(logits, plain)
    free = None
    if seen_k:
        free = (err_free, len(_near_ties(logits, plain))) + _flips(seen_k,
                                                                    seen_p)
        del plain
        plain = plain_prefill(_route_replay(seen_k))
    err = _normwise(logits, plain)
    ties = _near_ties(logits, plain)
    del plain, seen_p
    check(err <= TOL_BF16, f"{cfg.name} bf16 kernel vs plain prefill err "
          f"{err:.3e}" + (" (routing replayed)" if free else ""))
    _check_ties(ties, f"{cfg.name} bf16 kernel vs plain prefill")
    del logits

    # deepseek: one decode step through K6's latent mode against its
    # plain version (the step's logits, and K6's own call)
    latent = None
    if cfg.kv_lora_rank:
        pos = torch.full((B,), steps, dtype=torch.int32, device=dev)
        tok = res.tokens[:, -1:]
        seen = []
        with torch.no_grad():
            orig_r = _swap(moe_mod, {"route": _route_recorder(moe_mod, seen)})
            try:
                l_k, _ = step(params, cache, tok, pos, enc)
            finally:
                _swap(moe_mod, orig_r)
            orig_d = _swap(ops, {"decode_attention":
                                 da.decode_attention_plain})
            orig_r = _swap(moe_mod, {"route": _route_replay(seen)})
            try:
                l_p, _ = step(params, cache, tok, pos, enc)
            finally:
                _swap(ops, orig_d)
                _swap(moe_mod, orig_r)
        e_step = _normwise(l_k, l_p)
        check(e_step <= TOL_BF16, f"deepseek decode step K6 vs plain "
              f"{e_step:.3e}")
        (_, (q, k, v, lens), _), = [
            rec for key, rec in recorded.items()
            if key[0] == "decode_attention" and rec[0] == cfg.name]
        check(da.v_in_k(k, v), "deepseek's K6 call does not read v inside k")
        lens = lens.to(torch.int32)
        o1 = da.decode_attention_kernel(q, k, v, lens)
        o2 = da.decode_attention_kernel(q, k, v, lens)
        e_k6 = _allclose(torch, o1, da.decode_attention_plain(q, k, v, lens),
                         2e-2)
        check(torch.equal(o1, o2), "K6 latent: two calls differ")
        latent = (e_step, e_k6, lens.tolist())
        del l_k, l_p, o1, o2

    # busy share: a few decode steps on a fresh small cache, and a prefill
    small = tr.init_cache(cfg, B, max_seq=N_PROFILED + 1, device=CARD)

    def few_steps():
        for i in range(N_PROFILED):
            step(params, small, prompts[:, i:i + 1],
                 torch.full((B,), i, dtype=torch.int32, device=dev), enc)

    few_steps()
    busy, n_ops, _ = _busy_share(torch, few_steps)
    pbusy, _, _ = _busy_share(torch, lambda: prefill(params, prompts, ctx))
    del small, cache, params
    share = lambda b: "not measured" if b is None else f"{100 * b:.2f}%"
    say("zoo", f"{cfg.name}: prefill B {B} x {P} in {prefill_s:.4f} s "
        f"({B * P / prefill_s:.1f} tokens/s), K5 {n_k5} launches; serve loop "
        f"B {B}, prompt {ZOO_PROMPT} + {T} new tokens, {steps} decode steps "
        f"in {loop_s:.3f} s, {step_ms:.3f} ms a step, every step K5 "
        f"{step_k5} and K6 {step_k6} launches"
        + (" (K5 on flash_attention.split)" if step_k5 else "")
        + f", the prefill's K5 on flash_attention.wgmma; peak device memory "
        f"{peak:.3f} GB; the card busy {share(busy)} of a decode step"
        + (f" ({n_ops / N_PROFILED:.0f} device operations a step)"
           if busy is not None else "")
        + f", {share(pbusy)} of the prefill {smi_line}")
    if free:
        say("zoo", f"{cfg.name}: bf16 prefill, kernels vs plain versions "
            f"free running: {free[0]:.3e}, greedy tokens differ at "
            f"{free[1]} of {B * P} positions; {free[2]} of {free[3]} MoE "
            f"routing choices differ between the two runs (a token's router "
            f"logits differ by up to {free[4]:.3e} where its choices differ)")
    say("zoo", f"{cfg.name}: bf16 prefill with the kernels vs their plain "
        f"versions" + (" at the kernel run's routing" if free else "")
        + f": {err:.3e} (tolerance {TOL_BF16}), greedy tokens differ "
        f"at {len(ties)} of {B * P} positions, each a near-tie"
        + (f"; one decode step at kv_len {steps + 1} with K6's latent mode "
           f"vs plain (same routing) {latent[0]:.3e}, K6's call at kv_len {latent[2]} "
           f"max abs err {latent[1]:.3e} (tolerance 2e-2), v read inside "
           f"k, identical bits on a second call" if latent else ""))
    return {"name": cfg.name, "prefill": n_k5, "step_k5": step_k5,
            "step_k6": step_k6, "steps": steps, "prefill_s": prefill_s,
            "step_ms": step_ms, "peak_gb": peak, "busy": busy,
            "prefill_busy": pbusy, "params": n_par, "gb": gb, "calls": calls,
            "err": err, "free": free}


def phase_zoo(torch, smi_line):
    """The four configs that MLA, MoE, cross-attention and the encoder
    bring to the port, served one after another on the card; returns
    their numbers and the K5/K6 calls they made (by shape)."""
    t_phase = time.perf_counter()
    say("zoo", "reduced: llama4-scout-17b-a16e to 8 of 48 layers (all 48: "
        "216 GB in bf16), llama-3.2-vision-90b to 2 of 20 repeats (10 of "
        "100 layers; all: 175 GB); deepseek-v2-lite-16b and whisper-small "
        "at full width and depth")
    recorded, runs = {}, []
    for arch, keep, P in ZOO:
        t0 = time.perf_counter()
        runs.append(_zoo_one(torch, arch, keep, P, smi_line, recorded))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        say("zoo", f"{arch} took {time.perf_counter() - t0:.1f} s")
    say("zoo", f"phase zoo took {time.perf_counter() - t_phase:.1f} s")
    return {"runs": runs, "recorded": recorded}


def _k6_row(torch, da, F, q, k, v, lens, what):
    """K6 at one call: max error against the plain version (identical on
    a second call), kernel, plain and SDPA ms, bound."""
    dev = q.device
    out = da.decode_attention_kernel(q, k, v, lens)
    err = _allclose(torch, out, da.decode_attention_plain(q, k, v, lens), 2e-2)
    check(torch.equal(out, da.decode_attention_kernel(q, k, v, lens)),
          f"K6 {what}: two calls differ")
    B, Hq, D = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    ms = cuda_ms(lambda: da.decode_attention_kernel(q, k, v, lens), torch)
    plain = cuda_ms(lambda: da.decode_attention_plain(q, k, v, lens), torch,
                    iters=5)
    mask = (torch.arange(S, device=dev)[None, :]
            < lens[:, None].long())[:, None, None, :]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv)
    _allclose(torch, sdpa()[:, :, 0], out, 2e-2)
    lib = cuda_ms(sdpa, torch)
    aliased = da.v_in_k(k, v)
    visible = int(lens.clamp(0, S).sum())
    el = q.element_size()
    need = {"q": q.numel() * el,
            "cache rows": visible * Hkv * (D if aliased else D + Dv) * el,
            "kv_len": 4 * B, "o": out.numel() * el}
    n_ops = float(visible * Hq * (2 * D + 2 * Dv))
    b, by = bound_ms(float(sum(need.values())), n_ops, _rate(torch, q.dtype))
    return {"shape": what, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "need": need, "ops": n_ops}


def phase_zoo_kernels(torch, zoo):
    """K5 and K6 at the zoo's shapes, from the calls phase zoo recorded
    (the first call of each K5 shape, the last K6 call of each config),
    plus K6's latent mode at kv_len 4,096: error against the plain
    version, kernel, plain and library ms, bound. Returns
    {kernel name: [rows]} for the kernel JSON line."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    runs = {r["name"]: r for r in zoo["runs"]}
    rows = {"flash_attention": [], "decode_attention": []}
    for key, (arch, a, kw) in zoo["recorded"].items():
        name = key[0]
        launches = runs[arch]["calls"][key]
        if name == "decode_attention":
            q, k, v, lens = a
            lens = lens.to(torch.int32).contiguous()
            q, k = q.contiguous(), k.contiguous()
            v = v if da.v_in_k(k, v) else v.contiguous()
            what = (f"{arch} last serve step: q {tuple(q.shape)} cache "
                    f"{tuple(k.shape)}" + (" v inside k" if da.v_in_k(k, v)
                                            else "")
                    + f" kv_len {lens.tolist()}")
            row = _k6_row(torch, da, F, q, k, v, lens, what)
        else:
            q, k, v = (t.contiguous() for t in a)
            causal = kw.get("causal", True)
            route = fa.choose_route(q, k, v)
            ops.reset_launch_counts()
            out = fa.flash_attention_kernel(q, k, v, **kw)
            check(dict(ops.route_counts) == {f"flash_attention.{route}": 1},
                  f"K5 {key}: routes {dict(ops.route_counts)}, want {route}")
            err = _allclose(torch, out, fa.flash_attention_plain(q, k, v, **kw),
                            2e-2)
            ms = cuda_ms(lambda: fa.flash_attention_kernel(q, k, v, **kw), torch)
            dev = device_ms(lambda: fa.flash_attention_kernel(q, k, v, **kw),
                            torch)[0]
            # mma.sync (the route these shapes took before) in the same run
            tc_dev = device_ms(lambda: fa.launch_route("bf16_tc", q, k, v,
                                                       **kw), torch)[0]
            plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                            torch, iters=5)
            B, Sq, Hq, D = q.shape
            Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            sdpa = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal and Sq == Sk,
                enable_gqa=Hq != Hkv)
            lib = lib_dev = None
            if not causal or Sq == Sk:
                _allclose(torch, sdpa().transpose(1, 2), out, 2e-2)
                lib = cuda_ms(sdpa, torch)
                lib_dev = device_ms(sdpa, torch)[0]
            el = q.element_size()
            need = {"q": q.numel() * el, "k": k.numel() * el,
                    "v": v.numel() * el, "o": out.numel() * el}
            n_ops = float(B * Hq * _flash_pairs(Sq, Sk, causal,
                                                kw.get("window"))
                          * (2 * D + 2 * Dv))
            b, by = bound_ms(float(sum(need.values())), n_ops,
                             _rate(torch, q.dtype))
            what = (f"{arch} {'prefill' if Sq > 1 else 'decode step'}: q "
                    f"{tuple(q.shape)} k {tuple(k.shape)} v "
                    f"{tuple(v.shape)} causal {causal}")
            row = {"shape": what, "route": f"flash_attention.{route}",
                   "max_abs_err": err, "ms": ms, "device_ms": dev,
                   "bf16_tc_device_ms": tc_dev, "plain_ms": plain,
                   "bound_ms": b, "bound_by": by, "library_ms": lib,
                   "library_device_ms": lib_dev, "need": need, "ops": n_ops}
        row["launches"] = launches
        rows[name].append(row)
    # K6's latent mode on a long cache: B 4, one KV head, kv_len 4,096
    g = torch.Generator(device=CARD).manual_seed(SEED + 3)
    B = ZOO_BATCH
    q = torch.randn((B, 16, 576), generator=g, device=CARD).bfloat16()
    cache = torch.randn((B, ZOO_LATENT_KV, 576), generator=g,
                        device=CARD).bfloat16()
    k = cache[:, :, None, :]
    lens = torch.full((B,), ZOO_LATENT_KV, dtype=torch.int32, device=CARD)
    row = _k6_row(torch, da, F, q, k, k[..., :512], lens,
                  f"MLA latent, B {B}, q {tuple(q.shape)} cache "
                  f"{tuple(k.shape)} v inside k, kv_len {ZOO_LATENT_KV}")
    row["launches"] = 0
    rows["decode_attention"].append(row)
    info = da.decode_attention_info(ZOO_LATENT_KV, 16, 1, 576, 512,
                                    torch.bfloat16, B=B, aliased=True)
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    for name, rs in rows.items():
        for r in rs:
            k5 = name == "flash_attention"
            say("kernels", f"{'K5' if k5 else 'K6'} "
                f"at {r['shape']}: {r['launches']} launches in phase zoo"
                + (f" on {r['route']}" if k5 else "") + f"; max "
                f"abs err {r['max_abs_err']:.3e}; "
                f"kernel {r['ms']:.4f} ms"
                + (f" (device {fmt(r['device_ms'])}; mma.sync, bf16_tc, "
                   f"device {fmt(r['bf16_tc_device_ms'])})" if k5 else "")
                + f", plain {r['plain_ms']:.4f} ms, "
                f"scaled_dot_product_attention "
                + ("not comparable (causal with Sq < Sk)" if r["library_ms"]
                   is None else f"{r['library_ms']:.4f} ms"
                   + (f" (device {fmt(r['library_device_ms'])})" if k5
                      else ""))
                + f", bound {r['bound_ms']:.5f} ms ({r['bound_by']}; "
                f"{_counts(r.pop('need'))} bytes, {r.pop('ops'):.0f} ops), "
                f"{100 * r['bound_ms'] / r['ms']:.2f}% of the bound reached"
                + (f" ({100 * r['bound_ms'] / r['device_ms']:.2f}% in device "
                   f"time)" if k5 and r["device_ms"] else ""))
    say("kernels", f"K6 latent mode at kv_len {ZOO_LATENT_KV}: "
        f"{info['registers']} registers, {info['smem_bytes']:,} bytes of "
        f"shared memory per block, {info['stages']} stage(s) a warp, "
        f"{info['group']} query heads a block, splits of {info['split']} "
        f"keys ({info['splits']} splits) plus one merge launch")
    return rows


def _k5_route_rows(rows):
    """The kernel JSON line's rows of K5's two routes for the zoo's shapes:
    each at its zoo row of the largest bound (the most work), its launches
    summed over the zoo's prefills and serve loops, its error the largest
    of its rows'."""
    out = []
    for route, src in (("flash_attention.wgmma", "flash_attention_wgmma"),
                       ("flash_attention.split", "decode_attention")):
        mine = [r for r in rows if r["route"] == route]
        check(bool(mine), f"no call of the zoo took {route}")
        top = max(mine, key=lambda r: r["bound_ms"])
        out.append({"name": route, "route": "cuda",
                    "source": SOURCES[src][0],
                    "replaces": SOURCES["flash_attention"][1],
                    "launches": sum(r["launches"] for r in mine),
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    **{k: top[k] for k in (
                        "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "library_device_ms",
                        "bf16_tc_device_ms", "shape")}})
    return out


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


def _k5_route(bf16: bool, Sq: int, D: int, Dv: int) -> str:
    """K5's route for contiguous operands on fresh (aligned) allocations
    with heads up to 256: bfloat16 at one query on K6's split kernel, at
    more on the wgmma kernel where D and Dv are multiples of 8 of at least
    32, else on mma.sync; float32 on the CUDA cores."""
    if not bf16:
        return "f32"
    if Sq == 1:
        return "split"
    return "wgmma" if D % 8 == 0 and Dv % 8 == 0 and min(D, Dv) >= 32 \
        else "bf16_tc"


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

    def routed(name, fn, dtype, route=None):
        """fn() after zeroing the counts; the call must have taken
        ``route`` (default: ``dtype``'s route) of kernel ``name``, once."""
        ops.reset_launch_counts()
        out = fn()
        route = f"{name}.{route or _build.ROUTES[dtype]}"
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
                         lambda: fa.flash_attention_kernel(q, k, v, **kw), dt,
                         _k5_route(dt == torch.bfloat16, Sq, D, Dv))
            want = fa.flash_attention_plain(q, k, v, **kw)
            _allclose(torch, out, want, attn_tol[dt])
            if dt == torch.bfloat16:     # mma.sync at every edge case too
                _allclose(torch, routed("flash_attention",
                                        lambda: fa.launch_route(
                                            "bf16_tc", q, k, v, **kw),
                                        dt, "bf16_tc"), want, attn_tol[dt])
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
        f"(K5 on wgmma where its heads are 8-column multiples of at least "
        f"32, else on bf16_tc, and on bf16_tc by name at every case; K7 on "
        f"bf16_tc), all within tolerance of the plain versions")

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
        f"abs err {err:.3e} ({fa.choose_route(q, k, v)} route; f32 route on the "
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


def phase_wide_kernels(torch):
    """The wide routes (on no config's path, so 0 launches on the main
    path): K5 above D/Dv 256 (bf16 ``csrc/attention_wide_tc.cu``) and K6
    above D 576 / Dv 512 (bf16 ``csrc/decode_attention_wide_tc.cu``), both
    float32 on ``csrc/attention_wide.cu``; K7 above n 256 (bf16 on the
    tensor-core route in slabs of n, float32 on the CUDA-core route). Each
    against its plain version in bf16 and in float32, timed in bf16 beside
    the plain version and, for K5 and K6, scaled_dot_product_attention.
    Then shapes past K2's and ``usage_sum``'s former limits: K2 over
    65,535 partitions and at 24 buckets, ``usage_sum`` at 200 tiers."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import attention_wide as aw
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    dev = torch.device(CARD)
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    rnd = lambda *shape, dtype=torch.float32, scale=1.0: (
        torch.randn(shape, generator=g, device=dev) * scale).to(dtype)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    rows = []

    def one_route(route, fn):
        ops.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        check(set(ops.route_counts) == {route},
              f"wide routes: {dict(ops.route_counts)}, want {route}")
        return res

    # K5: B 2, S 512, 8 query heads on 2 KV heads of D 320, Dv 288, causal;
    # bfloat16 takes attention_wide_tc.cu, float32 attention_wide.cu
    B, S, Hq, Hkv, D, Dv = 2, 512, 8, 2, 320, 288
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = rnd(B, S, Hq, D, dtype=dt), rnd(B, S, Hkv, D, dtype=dt), \
            rnd(B, S, Hkv, Dv, dtype=dt)
        out = one_route("flash_attention.wide",
                        lambda: fa.flash_attention_kernel(q, k, v))
        errs[dt] = _allclose(torch, out, fa.flash_attention_plain(q, k, v),
                             tol[dt])
    # every tile edge at once: Sq 100 of Sk 612 (queries at the end, ragged
    # query and key tiles), a window of 70 across key tiles, softcap 30,
    # one KV head, D 640 in five chunks, Dv 300 in slices of 112, 112, 76
    kw = dict(window=70, softcap=30.0)
    qe, ke, ve = rnd(1, 100, 4, 640, dtype=torch.bfloat16), \
        rnd(1, 612, 1, 640, dtype=torch.bfloat16), \
        rnd(1, 612, 1, 300, dtype=torch.bfloat16)
    edge = _allclose(torch, one_route(
        "flash_attention.wide", lambda: fa.flash_attention_kernel(
            qe, ke, ve, **kw)), fa.flash_attention_plain(qe, ke, ve, **kw),
        tol[torch.bfloat16])
    ms = cuda_ms(lambda: fa.flash_attention_kernel(q, k, v), torch)
    dev_ms, _ = device_ms(lambda: fa.flash_attention_kernel(q, k, v), torch)

    def wide_kernel():              # the bf16 call on attention_wide.cu
        o = torch.empty_like(out)
        aw._launch(q, k, v, o, Sq=S, causal=True)
        return o
    _allclose(torch, wide_kernel(), out, tol[q.dtype])
    before = cuda_ms(wide_kernel, torch)
    plain = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), torch,
                    iters=5)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    _allclose(torch, sdpa().transpose(1, 2), out, tol[q.dtype])
    lib = cuda_ms(sdpa, torch)
    el = q.element_size()
    need = {"q": q.numel() * el, "k": k.numel() * el, "v": v.numel() * el,
            "o": out.numel() * el}
    n_ops = float(B * Hq * _flash_pairs(S, S, True, None) * (2 * D + 2 * Dv))
    b, by = bound_ms(float(sum(need.values())), n_ops, _rate(torch, q.dtype))
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    say("kernels", f"K5 wide route at q {tuple(q.shape)} k {tuple(k.shape)} "
        f"v {tuple(v.shape)}, causal: max abs err {errs[torch.float32]:.3e} "
        f"(float32, attention_wide.cu), {errs[torch.bfloat16]:.3e} (bf16, "
        f"attention_wide_tc.cu: {aw.tc_smem_bytes():,} bytes of shared "
        f"memory a block), {edge:.3e} at q {tuple(qe.shape)} k "
        f"{tuple(ke.shape)} v {tuple(ve.shape)} with {kw} (bf16); bf16 "
        f"kernel {ms:.4f} ms (device {dev_txt}), attention_wide.cu in bf16 "
        f"{before:.4f} ms, plain {plain:.4f} ms, "
        f"scaled_dot_product_attention {lib:.4f} ms ({ms / lib:.3f} of it); "
        f"bound {b:.5f} ms ({by}; {_counts(need)} bytes, {n_ops:.0f} ops), "
        f"{100 * b / ms:.2f}% of the bound reached; on no config's path")
    rows.append({"name": "flash_attention.wide", "route": "cuda",
                 "source": SOURCES["attention_wide_tc"][0],
                 "replaces": SOURCES["flash_attention"][1], "launches": 0,
                 "max_abs_err": errs[torch.bfloat16], "ms": ms,
                 "device_ms": dev_ms, "plain_ms": plain, "bound_ms": b,
                 "bound_by": by, "library_ms": lib})

    # K6: B 4, a latent cache of 1,024 slots, 16 query heads of 640 on one
    # KV head, v its first 576 columns; and its partials mode on a slice.
    # bfloat16 takes decode_attention_wide_tc.cu, float32 attention_wide.cu
    B, S, Hq, D, Dv = 4, 1024, 16, 640, 576
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        q, cache = rnd(B, Hq, D, dtype=dt), rnd(B, S, D, dtype=dt)
        k = cache[:, :, None, :]
        v = k[..., :Dv]
        lens = torch.tensor([S, S // 2 + 3, 1, S - 40], dtype=torch.int32,
                            device=dev)
        out = one_route("decode_attention.wide",
                        lambda: da.decode_attention_kernel(q, k, v, lens))
        errs[dt] = _allclose(torch, out, da.decode_attention_plain(q, k, v,
                                                                   lens),
                             tol[dt])
        n = S // 2
        ks = cache[:, n:, None, :].contiguous()
        local = torch.clamp(lens - n, 0, n).to(torch.int32)
        acc, m, l = one_route("decode_attention.partials_wide",
                              lambda: da.decode_attention_partials_kernel(
                                  q, ks, ks[..., :Dv], local, offset=n,
                                  global_len=lens, window=300))
        acc_p, m_p, l_p = da.decode_attention_partials_plain(
            q, ks, ks[..., :Dv], local, offset=n, global_len=lens, window=300)
        seen = l_p > 0
        check(torch.equal(seen, l > 0) and not acc[~seen].any()
              and torch.equal(m[~seen], m_p[~seen]),
              "K6 wide partials: rows without a visible key differ")
        _allclose(torch, acc[seen] / l[seen][:, None],
                  acc_p[seen] / l_p[seen][:, None], tol[dt])
        _allclose(torch, m[seen], m_p[seen], 1e-5)
    ms = cuda_ms(lambda: da.decode_attention_kernel(q, k, v, lens), torch)
    dev_ms, by_op = device_ms(lambda: da.decode_attention_kernel(q, k, v,
                                                                 lens), torch)
    fenced = fenced_ms(lambda: da.decode_attention_kernel(q, k, v, lens),
                       torch)
    enq = host_ms(lambda: da.decode_attention_kernel(q, k, v, lens), torch,
                  iters=50)

    def cuda_core():                 # the bf16 call on attention_wide.cu
        o = torch.empty_like(out)
        aw._launch(q, k, v, o, kv_len=lens, Sq=1)
        return o
    _allclose(torch, cuda_core(), out, tol[q.dtype])
    before = cuda_ms(cuda_core, torch)
    plain = cuda_ms(lambda: da.decode_attention_plain(q, k, v, lens), torch,
                    iters=5)
    mask = (torch.arange(S, device=dev)[None, :]
            < lens[:, None].long())[:, None, None, :]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
    _allclose(torch, sdpa()[:, :, 0], out, tol[q.dtype])
    lib = cuda_ms(sdpa, torch)
    el = q.element_size()
    visible = int(lens.sum())
    need = {"q": q.numel() * el, "visible rows": visible * D * el,
            "lengths": 4 * B, "o": out.numel() * el}
    n_ops = float(visible * Hq * (2 * D + 2 * Dv))
    b, by = bound_ms(float(sum(need.values())), n_ops, _rate(torch, q.dtype))
    split = aw.decode_wide_split(B, S, Hq, 1, Dv,
                                _build.sm_count(dev.index))
    dev_txt = "not measured" if dev_ms is None else \
        f"{dev_ms:.4f} ms ({_short(by_op)})"
    say("kernels", f"K6 wide route at q {tuple(q.shape)}, a latent cache "
        f"{tuple(k.shape)} with v its first {Dv} columns, kv_len "
        f"{lens.tolist()}: max abs err {errs[torch.float32]:.3e} (float32, "
        f"attention_wide.cu), {errs[torch.bfloat16]:.3e} (bf16, "
        f"decode_attention_wide_tc.cu: {aw.decode_tc_smem_bytes():,} bytes "
        f"of shared memory a block, {_ptxas_line(_build, 'decode_attention_wide_tc', 'decode_tc_kernel')}; "
        f"splits of {split} keys, {-(-S // split)} splits x "
        f"{aw.v_slices(Dv)} Dv slices a sequence, plus the merge launch), "
        f"its partials mode on the second half with a window within "
        f"tolerance in both; bf16 kernel {ms:.4f} ms (device {dev_txt}; "
        f"{fenced:.4f} ms between events behind a queued sleep; "
        f"host {enq:.4f} ms to enqueue), "
        f"attention_wide.cu in bf16 {before:.4f} ms, plain {plain:.4f} ms, "
        f"scaled_dot_product_attention with a kv_len mask {lib:.4f} ms "
        f"({ms / lib:.3f} of it); bound {b:.5f} ms ({by}; {_counts(need)} "
        f"bytes, {n_ops:.0f} ops), {100 * b / ms:.2f}% of the bound "
        f"reached; on no config's path")
    rows.append({"name": "decode_attention.wide", "route": "cuda",
                 "source": SOURCES["decode_attention_wide_tc"][0],
                 "replaces": SOURCES["decode_attention"][1], "launches": 0,
                 "max_abs_err": errs[torch.bfloat16], "ms": ms,
                 "device_ms": dev_ms, "fenced_ms": fenced,
                 "cuda_core_ms": before,
                 "plain_ms": plain, "bound_ms": b, "bound_by": by,
                 "library_ms": lib})

    # K7: b 2, s 512, 8 heads of 64, state n 320 (three 128-column slabs),
    # chunk 64, and at chunk 128 (where the float32 CUDA-core kernel's
    # shared memory once ran out)
    b_, s, h, p, n = 2, 512, 8, 64, 320
    errs, routes = {}, {}
    for chunk in (128, 64):
        for dt in (torch.float32, torch.bfloat16):
            route = f"ssd_scan.{_build.ROUTES[dt]}"
            x = rnd(b_, s, h, p, dtype=dt)
            Bm, Cm = rnd(b_, s, 1, n, dtype=dt, scale=0.3), \
                rnd(b_, s, 1, n, dtype=dt, scale=0.3)
            dtv = F.softplus(rnd(b_, s, h)) * 0.5
            A = -torch.exp(rnd(h, scale=0.3))
            Dk = torch.ones(h, device=dev)
            y_k, st_k = one_route(route, lambda: ssd.ssd_scan_kernel(
                x, dtv, A, Bm, Cm, Dk, chunk=chunk))
            routes[(chunk, dt)] = route
            y_p, st_p = ssd.ssd_scan_plain(x, dtv, A, Bm, Cm, Dk, chunk=chunk)
            errs[(chunk, dt)] = (
                _allclose(torch, y_k, y_p, 1e-4 if dt == torch.float32
                          else 2e-2), _allclose(torch, st_k, st_p, 1e-4))
        kern = lambda: ssd.ssd_scan_kernel(x, dtv, A, Bm, Cm, Dk, chunk=chunk)
        ms = cuda_ms(kern, torch)
        dev_ms, by_op = device_ms(kern, torch)
        fenced = fenced_ms(kern, torch)
        enq = host_ms(kern, torch, iters=50)
        plain = cuda_ms(lambda: ssd.ssd_scan_plain(x, dtv, A, Bm, Cm, Dk,
                                                   chunk=chunk), torch,
                        iters=5)
        el = x.element_size()
        need = {"x": x.numel() * el, "dt": dtv.numel() * 4, "A, D": 8 * h,
                "B, C": 2 * Bm.numel() * el, "y": y_k.numel() * el,
                "state": st_k.numel() * 4}
        n_ops = 0.0
        for c0 in range(0, s, chunk):
            L = min(chunk, s - c0)
            tri = L * (L + 1) // 2
            n_ops += tri * 2 * n + tri * 2 * p + L * p * 2 * n + L * p * n * 2
        n_ops *= b_ * h
        b, by = bound_ms(float(sum(need.values())), n_ops,
                         _rate(torch, x.dtype))
        dev_txt = "not measured" if dev_ms is None else \
            f"{dev_ms:.4f} ms ({_short(by_op)})"
        say("kernels", f"K7 at n {n} (bf16: {routes[(chunk, torch.bfloat16)]} "
            f"in {len(ssd.ssd_scan_plan(chunk, p, n, x.dtype)['n_slabs'])} "
            f"slabs of n; float32: {routes[(chunk, torch.float32)]}) at x "
            f"{tuple(x.shape)} B/C {tuple(Bm.shape)} chunk {chunk}: max abs "
            f"err y, state {errs[(chunk, torch.bfloat16)][0]:.3e}, "
            f"{errs[(chunk, torch.bfloat16)][1]:.3e} (float32 route at the "
            f"same shape: {errs[(chunk, torch.float32)][0]:.3e}, "
            f"{errs[(chunk, torch.float32)][1]:.3e}); shared memory "
            f"{ssd.ssd_scan_smem_bytes(chunk, p, n, x.dtype):,} bytes a block "
            f"(bf16), {ssd.ssd_scan_smem_bytes(chunk, p, n, torch.float32):,}"
            f" (float32); bf16 kernel {ms:.4f} ms (device {dev_txt}; "
            f"{fenced:.4f} ms between events behind a queued sleep; host "
            f"{enq:.4f} ms to enqueue), plain "
            f"{plain:.4f} ms, no single PyTorch call computes it; bound "
            f"{b:.5f} ms ({by}; {_counts(need)} bytes, {n_ops:.0f} ops), "
            f"{100 * b / ms:.2f}% of the bound reached; on no config's path")
        if chunk == 64:                 # the row's shape, as before
            row = {"name": "ssd_scan.wide_state", "route": "cuda",
                   "source": SOURCES["ssd_scan"][0],
                   "replaces": SOURCES["ssd_scan"][1], "launches": 0,
                   "routes": {"bf16": routes[(64, torch.bfloat16)],
                              "float32": routes[(64, torch.float32)]},
                   "max_abs_err": errs[(64, torch.bfloat16)][0], "ms": ms,
                   "device_ms": dev_ms, "fenced_ms": fenced,
                   "plain_ms": plain, "bound_ms": b, "bound_by": by,
                   "library_ms": None, "chunk_128": rows_k7_128}
            rows.append(row)
        else:
            rows_k7_128 = {"ms": ms, "device_ms": dev_ms,
                           "fenced_ms": fenced}
    say("kernels", "K7 slab kernels: chunk_state_wide_kernel "
        f"{_ptxas_line(_build, 'ssd_scan', 'chunk_state_wide_kernel')}; "
        f"chunk_scan_wide_kernel (p tiles of 64) "
        f"{_ptxas_line(_build, 'ssd_scan', 'chunk_scan_wide_kernelILi8')}; "
        f"float32 ssd_kernel {_ptxas_line(_build, 'ssd_scan', 'f3210ssd_kernel')}")
    _repaired_shapes(torch, dev)
    return rows


def _repaired_shapes(torch, dev):
    """K2 over 65,535 partitions and at 24 buckets, ``usage_sum`` at 200
    tiers: shapes past their kernels' former limits, each held to its
    plain version (K2 within 1e-5 normwise of float64 and, where the order
    of its sums is the same, bit for bit; ``usage_sum`` bit for bit to
    ``np.add.at`` in float32). It adds no kernel row: the rows of K2 and
    ``usage_sum`` are their main paths'."""
    from repro_torch.kernels import entropy_features as ef
    from repro_torch.kernels import ops
    from repro_torch.kernels import usage_sum as us
    rng = np.random.default_rng(SEED + 26)
    # K2: 70,000 partitions of 8 codes over a shared vocabulary of 23
    N, V, M = 70_000, 23, 8
    n_cols = rng.integers(1, 3, N).astype(np.int32)
    n_valid = (M // n_cols * n_cols).astype(np.int32)
    codes = rng.integers(-1, V, (N, M)).astype(np.int32)
    codes[np.arange(M)[None, :] >= n_valid[:, None]] = -1
    t = [torch.as_tensor(a, device=dev) for a in
         (codes, n_valid, n_valid // n_cols, n_cols,
          rng.integers(1, 12, V).astype(np.float32))]
    ops.reset_launch_counts()
    s_k, b_k = ef.weighted_entropy_features_kernel(*t, n_buckets=3)
    halves = [ef.weighted_entropy_features_kernel(
        *[a[sl] for a in t[:4]], t[4], n_buckets=3)
        for sl in (slice(0, N // 2), slice(N // 2, None))]
    torch.cuda.synchronize()
    check(ops.launch_counts["entropy_features"] == 3,
          f"K2 launches {dict(ops.launch_counts)}")
    check(torch.equal(s_k, torch.cat([x[0] for x in halves]))
          and torch.equal(b_k, torch.cat([x[1] for x in halves])),
          "K2 over 65,535 partitions: bits differ from the halves'")
    s_d, b_d = ef.weighted_entropy_features_plain(*t, n_buckets=3,
                                                  dtype=torch.float64)
    e_many = max(_normwise(s_k.double(), s_d), _normwise(b_k.double(), b_d))
    check(e_many <= 1e-5, f"K2 over 65,535 partitions: {e_many:.3e}")
    ms_many = cuda_ms(lambda: ef.weighted_entropy_features_kernel(
        *t, n_buckets=3), torch, iters=5)
    # K2 at 24 buckets: 5 partitions of up to 12,000 codes, V 23
    N, M = 5, 12_000
    n_cols = np.array([3, 1, 2, 4, 1], np.int32)
    n_valid = np.array([M, 7_001, 9_998, 0, 5], np.int32)
    codes = rng.integers(-1, V, (N, M)).astype(np.int32)
    codes[np.arange(M)[None, :] >= n_valid[:, None]] = -1
    t = [torch.as_tensor(a, device=dev) for a in
         (codes, n_valid, n_valid // n_cols, n_cols,
          rng.integers(1, 12, (N, V)).astype(np.float32))]
    s24, b24 = ef.weighted_entropy_features_kernel(*t, n_buckets=24)
    s1, _ = ef.weighted_entropy_features_kernel(*t, n_buckets=1)
    s_d, b_d = ef.weighted_entropy_features_plain(*t, n_buckets=24,
                                                  dtype=torch.float64)
    e24 = max(_normwise(s24.double(), s_d), _normwise(b24.double(), b_d))
    check(e24 <= 1e-5 and torch.equal(s24, s1),
          f"K2 at 24 buckets: {e24:.3e}, summary bits "
          f"{'equal' if torch.equal(s24, s1) else 'differ'}")
    info = ef.weighted_entropy_features_info(V, 24, M)
    say("kernels", f"K2 at 70,000 partitions of {8} codes (past the 65,535 "
        f"of a grid's second dimension): within {e_many:.3e} normwise of "
        f"float64, each partition's bits the halves'; {ms_many:.4f} ms a "
        f"call. At 24 buckets (5 x {M:,} codes): {e24:.3e} normwise, the "
        f"summary's bits those of one bucket; plan "
        f"{'replicated' if info['replicated'] else 'distributed'}, "
        f"{info['passes']} pass(es), {info['smem_bytes']:,} bytes of shared "
        f"memory a block, {info['registers']} registers")
    # usage_sum at 200 tiers: two windows of the block route
    T, N, L, K = 3, 6_000, 200, 3
    idx = torch.as_tensor(rng.integers(0, L * K, (T, N)), device=dev)
    chosen_np = np.exp(rng.uniform(-8, 8, (T, N))).astype(np.float32)
    chosen = torch.as_tensor(chosen_np, device=dev)
    ops.reset_launch_counts()
    use = us.usage_sum_kernel(idx, chosen, K, L)
    torch.cuda.synchronize()
    want = np.zeros((T, L), np.float32)
    np.add.at(want, (np.repeat(np.arange(T), N),
                     (idx.cpu().numpy() // K).ravel()), chosen_np.ravel())
    check(ops.launch_counts["usage_sum"] == 1
          and np.array_equal(use.cpu().numpy().view(np.int32),
                             want.view(np.int32)),
          "usage_sum at 200 tiers: bits differ from np.add.at's")
    ms_us = cuda_ms(lambda: us.usage_sum_kernel(idx, chosen, K, L), torch)
    say("kernels", f"usage_sum at T {T} x N {N:,}, L {L} "
        f"({len(us.tier_windows(L))} windows of at most {us.WINDOW} tiers): "
        f"np.add.at's bits in float32; {ms_us:.4f} ms a call")


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


# the checkpoint step of phase train: a cut of the trained state (the
# first repeat unit's leaves, whole, in order) until this many bytes. The
# whole unit is about 1/9 of the state, and the host's zlib-1 writes
# ~0.02 GB/s on the host of an NVIDIA H100 80GB HBM3 machine, so the
# whole unit would take minutes to save where the save and restore
# together should take under a minute
CKPT_CUT_BYTES = 750_000_000
CKPT_SMALL_BYTES = 4 << 20        # the later saves: 4 MiB of trained bf16
CKPT_GCS_SAVES = 10               # saves under GCS prices (lifecycle moves)


def _bits(torch, t):
    """``t`` as integers of its width, for bit-exact comparison."""
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}.get(
        t.element_size(), torch.uint8)) if t.is_floating_point() else t


def _ckpt_cut(state, limit):
    """The first repeat unit's leaves of the parameters and of the AdamW
    state (master, m, v, err), whole leaves in order until ``limit``
    bytes: ``(tree, bytes, leaves)``."""
    from repro_torch.training.optimizer import AdamWState
    opt = state["opt"]
    parts = {"params": state["params"], "master": opt.master, "m": opt.m,
             "v": opt.v}
    if opt.err is not None:
        parts["err"] = opt.err
    named = {k: dict(_named_leaves(v["stages"])) for k, v in parts.items()}
    cut = {k: {} for k in parts}
    total = 0
    for name in named["params"]:
        leaves = {k: named[k][name][0] for k in parts}
        n = sum(t.numel() * t.element_size() for t in leaves.values())
        if total and total + n > limit:
            break
        for k, t in leaves.items():
            cut[k][name] = t
        total += n
    tree = {"params": cut["params"],
            "opt": AdamWState(step=opt.step, master=cut["master"],
                              m=cut["m"], v=cut["v"], err=cut.get("err"))}
    return tree, total, len(cut["params"])


def _meta_tree(tree):
    """``tree`` (dicts and NamedTuples of tensors) as meta tensors."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tree._make(_meta_tree(v) for v in tree)
    return tree.to("meta")


def _lifecycle_tiers(mgr):
    """Mean stored tier of each retained checkpoint, oldest first."""
    return [float(np.mean([mgr.store.tier_of(m["key"])
                           for m in mgr._manifests[s]["shards"]]))
            for s in sorted(mgr._manifests)]


def _train_checkpoint(torch, tr, state, smi_line):
    """Phase train's checkpoint step: save a full-width cut of the trained
    state through ``CheckpointManager`` on the card, restore it bit for
    bit, the greedy choice on cuda against cpu, the lifecycle."""
    from collections import Counter

    from repro_torch.checkpoint import manager as cm
    from repro_torch.core import costs
    from repro_torch.storage.store import TieredStore
    card = f"| {smi_line}"
    opt = state["opt"]
    full = sum(t.numel() * t.element_size() for t in tr.tree_leaves(
        [state["params"], opt.master, opt.m, opt.v,
         {} if opt.err is None else opt.err]))
    cut, nbytes, n_leaves = _ckpt_cut(state, CKPT_CUT_BYTES)
    say("train", f"checkpoint: reduced: the first repeat unit's first "
        f"{n_leaves} leaves of the parameters and of AdamW's master, m, v "
        f"and err ({nbytes:,} bytes) of the full state's {full:,} (the "
        f"whole unit, 1/9 of it, would take minutes of host zlib); shards "
        f"of {cm.SHARD_BYTES >> 20} MiB, {cm.SAMPLE_BYTES >> 10} KiB "
        f"samples, codecs {cm.CANDIDATE_CODECS}")
    store = TieredStore()
    mgr = cm.CheckpointManager(store, device=CARD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, cut)
    t_taken = time.perf_counter() - t0
    mgr.wait()
    t_save = time.perf_counter() - t0
    shards = mgr._manifests[1]["shards"]
    stored = sum(store.stored_gb(s["key"]) for s in shards)
    cells = Counter((s["tier"], s["codec"]) for s in shards)
    say("train", f"checkpoint save: {len(shards)} shards, by (tier, codec) "
        f"{dict(sorted(cells.items()))}; {stored:.6f} GB stored of "
        f"{nbytes / 1e9:.6f} raw; metered "
        f"{ {k: float(v) for k, v in store.meter.as_dict().items() if v} }; "
        f"{t_save:.2f} s ({nbytes / 1e9 / t_save:.4f} GB/s), of which "
        f"{t_taken:.2f} s before save() returned (copy to the host, samples, "
        f"greedy choice on the card) {card}")

    reads = store.meter.n_reads
    t0 = time.perf_counter()
    out, step = mgr.restore(cut, device=CARD)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    check(step == 1 and store.meter.n_reads - reads == len(shards),
          f"restore read {store.meter.n_reads - reads} of {len(shards)} "
          f"shards")
    pairs = list(zip(cm._leaf_paths(cut), cm._leaf_paths(out)))
    bad = [p for (p, a), (q, b) in pairs
           if p != q or a.dtype != b.dtype or a.shape != b.shape
           or b.device.type != torch.device(CARD).type
           or not torch.equal(_bits(torch, a), _bits(torch, b))]
    check(not bad, f"restored leaves differ: {bad[:5]}")
    # the cut's objects and shapes, for phase placement_mesh's restore
    ckpt = {"objs": {k: dataclasses.replace(o) for k, o in store._objs.items()
                     if k.startswith("ckpt/1/")},
            "like": _meta_tree(cut)}
    say("train", f"checkpoint restore onto cuda: {len(pairs)} leaves "
        f"bit-identical to the trained state, each of the {len(shards)} "
        f"shards' sha256 verified; {t_restore:.2f} s "
        f"({nbytes / 1e9 / t_restore:.4f} GB/s); save and restore "
        f"{t_save + t_restore:.2f} s {card}")
    del out, pairs

    _, blobs = cm.shard_tree(cut)
    t0 = time.perf_counter()
    spans, R, D = cm.CheckpointManager.measure_shards([b for _, _, b in blobs])
    t_meas = time.perf_counter() - t0
    rho = cm._restore_rate(0)
    got = {}
    for dev in (CARD, "cpu"):
        m = cm.CheckpointManager(TieredStore(), device=dev)
        t0 = time.perf_counter()
        got[dev] = m.assign_shards(spans, R, D, rho)
        torch.cuda.synchronize()
        got[dev] += (time.perf_counter() - t0,)
    check(np.array_equal(got[CARD][0], got["cpu"][0])
          and got[CARD][1] == got["cpu"][1],
          "the greedy (tier, codec) choice differs between cuda and cpu")
    say("train", f"checkpoint greedy choice: {len(blobs)} shards measured "
        f"once ({t_meas:.2f} s), the (tier, codec) of each identical on "
        f"cuda ({1e3 * got[CARD][2]:.2f} ms) and cpu "
        f"({1e3 * got['cpu'][2]:.2f} ms) {card}")
    del blobs

    small = {"embed": state["params"]["embed"].reshape(-1)[
        :CKPT_SMALL_BYTES // state["params"]["embed"].element_size()]}
    for s in (2, 3):
        mgr.save(s, small, blocking=True)
    az = _lifecycle_tiers(mgr)
    check(all(a >= b for a, b in zip(az, az[1:])),
          f"the lifecycle left an older checkpoint hotter: {az}")
    gcs = {}
    for dev in (CARD, "cpu"):
        table = costs.multi_cloud_table([costs.gcp_gcs_provider()])
        m = cm.CheckpointManager(TieredStore(table), device=dev, keep=12,
                                 tier_whitelist=tuple(range(table.num_tiers)))
        for s in range(CKPT_GCS_SAVES):
            m.save(s, small, blocking=True)
        gcs[dev] = _lifecycle_tiers(m)
    g = gcs[CARD]
    check(g == gcs["cpu"], f"lifecycle tiers differ: cuda {g}, cpu "
          f"{gcs['cpu']}")
    check(all(a >= b for a, b in zip(g, g[1:])) and g[0] > g[-1],
          f"GCS lifecycle: older checkpoints not cooler: {g}")
    say("train", f"checkpoint lifecycle: three saves under Azure (the cut, "
        f"then 2 x {CKPT_SMALL_BYTES >> 20} MiB), mean tier oldest first "
        f"{az}: nothing moves (Archive's first byte takes hours against the "
        f"120 s SLA, and Cool is cheapest at every restore rate up to 4); "
        f"{CKPT_GCS_SAVES} saves under GCS's prices, mean tier oldest first "
        f"{g}: older checkpoints moved cooler, identically on cuda and cpu "
        f"{card}")
    return ckpt


def _train_launcher(smi_line):
    """``repro_torch.launch.train --ckpt-every 2 --steps 4`` on the card."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--smoke", "--ckpt-every", "2", "--steps", "4", "--batch", "4",
           "--seq", "64"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=600)
    secs = time.perf_counter() - t0
    check(out.returncode == 0, f"{' '.join(cmd[1:])} exited "
          f"{out.returncode}: {out.stderr[-3000:]}")
    bill = re.search(r"^ckpt bill: (\{.*\})$", out.stdout, re.M)
    cents = dict(re.findall(r"'(\w+)': (?:np\.float64\()?([-\d.e]+)",
                            bill.group(1))) if bill else {}
    check(float(cents.get("write_cents", 0)) > 0,
          f"no ckpt bill with write cents: {out.stdout[-2000:]}")
    check("done at step 4 on" in out.stdout, out.stdout[-2000:])
    say("train", f"launcher: {' '.join(cmd[2:])} on the card exited 0 in "
        f"{secs:.1f} s; {bill.group(0)} | {smi_line}")


def phase_train(torch, smi_line):
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

    def on_step(i, _, m):
        per_step.append((dict(ops.launch_counts), dict(ops.route_counts)))
        ops.reset_launch_counts()

    ops.reset_launch_counts()
    res = train(cfg, tcfg, state, loader, TRAIN_STEPS, on_step=on_step)
    peak = torch.cuda.max_memory_allocated() / 1e9
    state = res.state
    want = {"flash_attention": 2 * n_attn, "ssd_scan": 2 * n_mamba,
            "quant_pack": n_leaves}
    want_routes = {ZAMBA2_K5_ROUTE: 2 * n_attn,
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
    t0 = time.perf_counter()
    ckpt = _train_checkpoint(torch, tr, state, smi_line)
    say("train", f"checkpoint step took {time.perf_counter() - t0:.1f} s")

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
           "k3_s": k3_s, "largest": k3["largest"], "shard": shard,
           "ckpt": ckpt}
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
    _train_launcher(smi_line)
    return out


def phase_train_kernels(torch, trained):
    """K3 and K4 against their plain versions, at the shapes of the
    training step and of ``benchmarks/bench_kernels.py``, and edge cases;
    then their times and bounds."""
    from repro_torch.kernels import _build
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
            f"{ef.byte_entropy_blocks(n, _build.sm_count(dev.index))} blocks): "
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
    parts, rows, pred, total_gb, samples, forest = make_inputs()
    recorded = {}
    renders = shared_renderings()
    table, cfgs, cuda_runs, launches = phase_main(
        torch, parts, rows, pred, total_gb, recorded)
    phase_cpu(torch, parts, rows, table, cfgs, cuda_runs)
    usage_scale = phase_reopt(torch, rows, pred, samples, table, cfgs,
                              cuda_runs, smi_line)
    usage = phase_stream(torch, parts, rows, forest, smi_line, renders)
    usage["scale_solve"] = usage_scale  # T 1 x N 16,000 in phase reopt
    phase_daemon(torch, smi_line)
    served = {}
    serve_launches = phase_serve(torch, served)
    partials = phase_mesh(torch, smi_line)
    zamba_row, latent_row = partials
    # K6's partials at each row's shape: zamba2's slice of 272 keys in
    # phase tp's bf16 steps; no path here decodes the latent 2,048 of 4,096
    zamba_row["launches"] = phase_tp(torch, smi_line)
    latent_row["launches"] = 0
    zoo = phase_zoo(torch, smi_line)
    trained = phase_train(torch, smi_line)
    slabs = phase_placement_mesh(torch, parts, trained.pop("ckpt"), smi_line)
    kernels = phase_kernels(torch, recorded, launches)
    kernels += phase_model_kernels(torch, served, serve_launches)
    kernels += phase_train_kernels(torch, trained)
    kernels += phase_wide_kernels(torch)
    zoo_rows = phase_zoo_kernels(torch, zoo)
    kernels += _k5_route_rows(zoo_rows["flash_attention"])
    for row in kernels:                 # K5 and K6 at the zoo's shapes
        if row["name"] == "overlap":    # K1's row slabs over two ranks
            row["mesh_launches"] = slabs
        if row["name"] in zoo_rows:
            row["zoo"] = zoo_rows[row["name"]]
        if row["name"] == "decode_attention":
            row["partials"] = partials  # K6 in the sharded decode
    kernels.append(usage)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Production-mesh dry run: every (arch x shape x mesh) cell as one rank of
a 256- or 512-rank mesh, on meta tensors; a rank's bytes, its operation
counts and the roofline terms.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell for 512 placeholder devices and reads XLA's analyses. Here one
process is rank 0 of a fake process group
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once and move nothing) of 256 ranks (``pod16x16``) or 512
(``pod2x16x16``), over which ``make_production_mesh`` builds the mesh.
The rank holds, as meta tensors (shapes and dtypes, no storage), its
shards of the weights by ``param_specs``, for a train cell its ZeRO-1
optimizer state by ``zero1_specs``, and for a decode cell its part of the
cache by ``cache_specs``; then it runs the train step, the prefill or the
decode step once under :func:`repro_torch.analysis.op_stats.analyze`.
The kernels' plain versions work out the shapes on meta tensors, as the
reference's CPU dry run lowers its jnp versions.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both]
Results land in benchmarks/results/dryrun_torch/<arch>__<shape>__<mesh>.json
(``--out`` to put them elsewhere).

Where the reference records XLA's ``memory_analysis``, a record here has
``rank_bytes``: the bytes of the parameters, optimizer state and cache a
rank holds. No compiler reports temporary bytes here, so what a step
allocates while it runs is not counted.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.analysis import op_stats
from repro_torch.analysis import roofline as rl
from repro_torch.configs.registry import arch_names, get_config
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_production_mesh, tp_size
from repro_torch.launch.shapes import (SHAPES, applicable, input_specs,
                                       param_structs)
from repro_torch.models.layers import MetaGenerator
from repro_torch.serving import decode
from repro_torch.training import train_step as ts

RESULTS = pathlib.Path(__file__).resolve().parents[3] / \
    "benchmarks" / "results" / "dryrun_torch"
MESHES = {False: ("pod16x16", 256), True: ("pod2x16x16", 512)}
MEMORY_NOTE = ("rank_bytes are the tensors a rank holds (its parameter "
               "shards, ZeRO-1 optimizer state and cache); no compiler "
               "reports temporary bytes, so what a step allocates while it "
               "runs is not counted")


def production_mesh(multi_pod: bool):
    """The production mesh over a fake process group of its size, rank 0;
    a group of another size is replaced (a process's world size is fixed
    for the life of its group)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = MESHES[multi_pod][1]
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def rank_state(cfg, shape_name: str, mesh, microbatches: int = 1):
    """This rank's meta tensors for the cell: {'params'}, with 'opt' for a
    train cell (ZeRO-1 over 'data') and 'cache' for a decode cell; and the
    train config."""
    sc = SHAPES[shape_name]
    tp = tp_size(mesh)
    tcfg = ts.TrainConfig(remat=True, microbatches=microbatches)
    if sc.kind == "train":
        return ts.init_train_state(MetaGenerator(), cfg, tcfg, tp, mesh,
                                   device="meta"), tcfg
    from repro_torch.models import transformer as tr
    state = {"params": tr.init_params(MetaGenerator(), cfg, tp, mesh,
                                      device="meta")}
    if sc.kind == "decode":
        state["cache"] = decode.init_cache(cfg, sc.batch, sc.seq, mesh=mesh,
                                           device="meta")
    return state, tcfg


def rank_bytes(state) -> dict:
    opt = state.get("opt")
    return {"params": sharding.local_bytes(state["params"]),
            "opt": 0 if opt is None else sharding.local_bytes(
                [opt.master, opt.m, opt.v, opt.err]),
            "cache": sharding.local_bytes(state.get("cache"))}


def run_step(cfg, shape_name: str, mesh, state, tcfg):
    """One train step, prefill or decode step of the cell on this rank, as
    the launchers run them (the global batch's meta stand-ins)."""
    sc = SHAPES[shape_name]
    specs = input_specs(cfg, shape_name, tp_size(mesh))
    if sc.kind == "train":
        ts.train_step(state, specs["batch"], cfg, tcfg, mesh)
    elif sc.kind == "prefill":
        decode.make_prefill_step(cfg, mesh)(state["params"], specs["tokens"],
                                            specs.get("context"))
    else:
        decode.make_decode_step(cfg, mesh)(
            state["params"], state["cache"], specs["tokens"], specs["pos"],
            specs.get("context"))


def analyze_cell(arch: str, shape_name: str, multi_pod: bool,
                 microbatches: int = 1):
    """(config, mesh, rank bytes, op stats) of one cell."""
    cfg = get_config(arch)
    mesh = production_mesh(multi_pod)
    state, tcfg = rank_state(cfg, shape_name, mesh, microbatches)
    stats = op_stats.analyze(run_step, cfg, shape_name, mesh, state, tcfg)
    return cfg, mesh, rank_bytes(state), stats


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path, microbatches: int = 1) -> dict:
    mesh_name = MESHES[multi_pod][0]
    suffix = f"__mb{microbatches}" if microbatches > 1 else ""
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    cfg = get_config(arch)
    ok, reason = applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[dryrun] SKIP {arch} {shape_name} {mesh_name}: {reason}")
        return rec
    try:
        t0 = time.time()
        cfg, mesh, held, stats = analyze_cell(arch, shape_name, multi_pod,
                                              microbatches)
        chips = mesh.size()
        total = rl.count_params(param_structs(cfg, tp_size(mesh)))
        active = rl.active_params(cfg, total)
        sc = SHAPES[shape_name]
        mflops = rl.model_flops(cfg, sc.kind, sc.batch, sc.seq, total,
                                active)
        roof = rl.roofline_terms(stats, chips, mflops)
        rec.update({
            "status": "ok",
            "run_s": round(time.time() - t0, 1),
            "chips": chips,
            "params_total": total,
            "params_active": active,
            "rank_bytes": held,
            "memory_note": MEMORY_NOTE,
            "collective_bytes": rl.collective_bytes(stats),
            "roofline": roof.as_dict(),
        })
        print(f"[dryrun] OK  {arch} {shape_name} {mesh_name} "
              f"dominant={roof.dominant} (c={roof.compute_s:.4f}s "
              f"m={roof.memory_s:.4f}s x={roof.collective_s:.4f}s) "
              f"rank bytes {held}")
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] ERR {arch} {shape_name} {mesh_name}: {rec['error']}")
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args()
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.set_num_threads(1)

    archs = arch_names() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]
    # mesh outermost: each mesh's group is started once
    for mp in pods:
        for arch in archs:
            for shape in shapes:
                path = out_dir / f"{arch}__{shape}__{MESHES[mp][0]}.json"
                if args.skip_existing and path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        continue
                run_cell(arch, shape, mp, out_dir, args.microbatches)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

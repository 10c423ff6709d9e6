#!/usr/bin/env python3
"""How far apart two bfloat16 evaluations of zamba2-2.7b lie when they
round in different places: the port's tensor-parallel run at model 2
against its unsharded run, on one NVIDIA GPU shared by two gloo ranks.

    python tools/tp_bf16_gap.py [--seeds 0 1 2]

For each seed, zamba2-2.7b at full width and depth in bfloat16 (random
weights from the seed, as chip_smoke.py draws them) runs a prefill of 4
prompts of 512 tokens and 4 decode steps from position 512 on a cache of
544 slots filled at random (272 a rank when sharded), as chip_smoke.py's
phase tp does. The logits of these runs are compared with those of the
unsharded bfloat16 run on the same weights:

* ``tp``: the port at data 1 x model 2, each rank its shards, each
  row-parallel product taken in bfloat16 and the ranks' products summed
  in float32 (``layers.row_parallel``);
* ``tp f32 shares``: the same, each row-parallel product taken in float32
  from the bfloat16 operands, so the ranks' shares are summed before the
  one rounding the unsharded product makes;
* ``split``: one process, the whole weights, each row-parallel product
  taken as two bfloat16 halves summed in float32 (the rounding of ``tp``
  without a process group);
* ``float32``: the unsharded run on the weights cast to float32 (the
  distance of the unsharded bfloat16 run from its float32 answer).

Each comparison prints the normwise error (max |a - b| / max |b|, the
measure of chip_smoke.py's bf16 checks), the largest absolute difference
and the largest elementwise relative difference |a - b| / (1 + |b|).
"""

import argparse
import os
import socket
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

B, S, CACHE, AT, STEPS = 4, 512, 544, 512, 4


def gaps(a, b):
    """(normwise, max abs, max elementwise relative) of ``a`` against
    ``b``."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    return (float(d.max() / b.abs().max()), float(d.max()),
            float((d / (1 + b.abs())).max()))


def _rank(rank, seeds, out_dir, port):
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import ctx
    from repro_torch.launch.mesh import launch_mesh
    from repro_torch.models import attention, layers, mamba2
    from repro_torch.models import transformer as tr
    from repro_torch.serving import decode
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh, dev = launch_mesh(1, 2, "cuda")
    cfg = get_config("zamba2-2.7b")
    cfg32 = cfg.scaled(dtype="float32")
    port_fns = (layers.row_parallel, layers.mlp_apply)

    def hidden(p, x, act):
        if act == "swiglu":
            return F.silu(x @ p["gate"]) * (x @ p["up"])
        return layers.gelu(x @ p["gate"]) * (x @ p["up"])

    def row_f32(x, w):
        return ctx.reduce_from_model(x.float() @ w.float()).to(x.dtype)

    def mlp_f32(p, x, act):
        return row_f32(hidden(p, ctx.copy_to_model(x), act), p["down"])

    def row_split(x, w):
        k = w.shape[0] // 2
        return ((x[..., :k] @ w[:k]).float()
                + (x[..., k:] @ w[k:]).float()).to(x.dtype)

    def mlp_split(p, x, act):
        return row_split(hidden(p, x, act), p["down"])

    def use(row, mlp):
        mamba2.row_parallel = attention.row_parallel = row
        tr.mlp_apply = mlp

    def steps(step, p, cache, toks):
        return torch.stack([step(p, cache, toks[i], torch.full(
            (B,), AT + i, dtype=torch.int32, device=dev))[0].float().cpu()
            for i in range(STEPS)])

    res = {}
    for seed in seeds:
        gen = lambda s: torch.Generator(device=dev).manual_seed(s)
        mine = tr.init_params(gen(seed), cfg, 2, mesh, device=dev)
        prompts = torch.randint(0, cfg.vocab_size, (B, S),
                                generator=gen(seed + 1), device=dev)
        g = gen(seed + 7)
        full = decode.init_cache(cfg, B, CACHE, device=dev)
        for t in tr.tree_leaves(full):
            t.copy_(torch.randn(t.shape, generator=g, device=dev))
        toks = torch.randint(0, cfg.vocab_size, (STEPS, B, 1), generator=g,
                             device=dev)
        for name, fns in (("tp", port_fns), ("tp f32 shares",
                                             (row_f32, mlp_f32))):
            use(*fns)
            local = tr.tree_map(lambda t: t.clone(),
                                decode.shard_cache(full, cfg, mesh))
            res[seed, name] = (
                decode.make_prefill_step(cfg, mesh)(mine, prompts)
                .float().cpu(),
                steps(decode.make_decode_step(cfg, mesh), mine, local, toks))
            use(*port_fns)
            del local
        del mine
        if rank == 0:
            whole = tr.init_params(gen(seed), cfg, device=dev)
            w32 = tr.tree_map(lambda t: t.float(), whole)
            for name, c, p, fns in (
                    ("unsharded", cfg, whole, port_fns),
                    ("split", cfg, whole, (row_split, mlp_split)),
                    ("float32", cfg32, w32, port_fns)):
                use(*fns)
                cache = tr.tree_map(
                    lambda t: t.to(p["embed"].dtype, copy=True), full)
                res[seed, name] = (
                    decode.make_prefill_step(c)(p, prompts).float().cpu(),
                    steps(decode.make_decode_step(c), p, cache, toks))
                use(*port_fns)
                del cache
            del whole, w32
        del full
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "gaps.pt"))
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    import subprocess
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as out_dir:
        mp.start_processes(_rank, args=(args.seeds, out_dir, port),
                           nprocs=2, join=True, start_method="spawn")
        res = torch.load(os.path.join(out_dir, "gaps.pt"))
    print(f"zamba2-2.7b, bf16, prefill {B} x {S} and {STEPS} decode steps "
          f"from {AT} on {CACHE} slots; against the unsharded bf16 run: "
          f"normwise / max abs / elementwise relative | {smi}")
    for seed in args.seeds:
        want = res[seed, "unsharded"]
        for name in ("tp", "tp f32 shares", "split", "float32"):
            got = res[seed, name]
            a, b = (want, got) if name == "float32" else (got, want)
            pre, dec = gaps(a[0], b[0]), gaps(a[1], b[1])
            print(f"seed {seed} {name:>14}: prefill " + " / ".join(
                f"{x:.4f}" for x in pre) + "; decode " + " / ".join(
                f"{x:.4f}" for x in dec))
    print(f"took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""GPipe-style pipeline parallelism over a mesh axis.

Port of ``repro.distributed.pipeline``. Each rank of the pipe axis holds
its own stage's parameters and runs its stage; microbatch activations hop
stage to stage with point-to-point sends (``batch_isend_irecv``). The
schedule is the classic GPipe loop: with S stages and M microbatches the
pipe runs S + M - 1 ticks, and stage s computes on ticks s .. s + M - 1
(bubble fraction (S - 1) / (S + M - 1)). At the end the last stage's
outputs are broadcast to every stage, as the reference's psum of masked
outputs gives every device.

Where the reference computes every stage at every tick and masks the
inactive ones, a rank here computes and sends only on its active ticks,
and a stage receives only what its predecessor sent: the same values. The
wrapper is forward only (the reference differentiates through ``ppermute``
under ``jax.grad``; autograd does not pass point-to-point sends).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import ctx


@torch.no_grad()
def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, axis: str = "pod",
                   microbatches: Optional[int] = None) -> torch.Tensor:
    """Run ``stage_fn(params, x) -> x`` through the S stages of ``axis``.

    stage_params: this rank's stage's parameters (the reference's stacked
    parameters at this rank's index of ``axis``). x: (B, ...) the global
    batch, the same on every rank; split into ``microbatches`` (default S)
    of B / M rows. Returns the pipeline's output (B, ...) on every rank.
    Every stage's output must have its input's shape and dtype.
    """
    S = dict(zip(mesh.mesh_dim_names, mesh.shape))[axis]
    M = microbatches or S
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    mb = x.reshape(M, B // M, *x.shape[1:])
    group = ctx.axes_group(mesh, (axis,))
    s = mesh.get_local_rank(axis)
    peer = lambda i: dist.get_global_rank(group, i)
    active = lambda stage, t: stage <= t < stage + M
    buf = torch.zeros_like(mb[0])
    outs = torch.zeros_like(mb)
    for t in range(S + M - 1):
        y = None
        if active(s, t):
            y = stage_fn(stage_params, mb[t] if s == 0 else buf)
            if s == S - 1:
                outs[t - (S - 1)] = y
        ops = []
        if s < S - 1 and y is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), peer(s + 1),
                                  group))
        if s > 0 and active(s - 1, t):
            buf = torch.empty_like(mb[0])
            ops.append(dist.P2POp(dist.irecv, buf, peer(s - 1), group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    dist.broadcast(outs, src=peer(S - 1), group=group)
    return outs.reshape(B, *x.shape[1:])

"""The distributed context: the mesh a launcher activates, read by the few
distribution-aware ops.

Port of ``repro.distributed.ctx``. Model code stays mesh-agnostic; a
launcher (or ``serving.decode.make_decode_step(cfg, mesh)``,
``training.train_step.make_train_step(cfg, tcfg, mesh)``) activates a
:class:`~torch.distributed.device_mesh.DeviceMesh` here, and these ops
consult it:

* ``kernels.ops.decode_attention`` -> the sequence-sharded decode
  (``serving.decode.sharded_decode_attention``) when the model axis is
  above 1;
* ``models.moe.moe_apply`` -> routing per data-parallel group;
* ``training`` -> the data-parallel gradient mean;
* the model's layers -> tensor parallelism over 'model' when its size is
  above 1: each rank then holds its shards of the weights
  (``sharding.param_specs``), and the layers join their column- and
  row-parallel products with the collectives below.

Tensor parallelism is Megatron's, written out: the counterpart of what
GSPMD inserts for the reference's ``param_specs``. Four collectives over
the model axis are ``torch.autograd.Function`` subclasses, each the
identity when the axis is 1:

* :func:`copy_to_model`: identity forward, all-reduce SUM backward. It
  marks where a tensor that every rank holds whole enters a computation
  each rank does on its own shards (a column-parallel product, the rank's
  heads or experts), so the ranks' partial gradients meet there;
* :func:`reduce_from_model`: all-reduce SUM forward, identity backward:
  the end of a row-parallel product, whose output every rank then holds
  whole;
* :func:`gather_from_model`: all-gather forward along a dimension, this
  rank's slice backward (vocab-sharded logits, q heads gathered for the
  sequence-sharded decode);
* :func:`sum_over_model`: all-reduce SUM both ways, for a sum whose
  result each rank uses on its own shard (the sum of squares of an RMS
  norm over a sharded feature axis).

Sums run in float32 and every rank receives the same bits, so the
computations every rank repeats (norms, the MoE router and its top-k)
stay identical across ranks.

Each rank runs the same eager program on its own tensors, and the
collectives are explicit calls on the mesh's process groups
(:func:`model_group`, :func:`dp_group`). There is no compiler that places
shardings, so :func:`constrain` and :func:`constrain_sp`, which are
``with_sharding_constraint`` in the JAX package, return ``x`` unchanged:
a sharding constraint changes where an array lives, never its values, so
the reference's call site (``repro/models/transformer.py:139``) is a
numeric identity in both packages.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

_LOW = (torch.bfloat16, torch.float16)

_MESH = None
_SPLIT = False

#: device type -> tensors reduced or gathered by :func:`all_reduce` and
#: :func:`all_gather_rows` since the last clear
reduced_on: "collections.Counter[str]" = collections.Counter()
#: "all_reduce" / "all_gather" -> calls since the last clear
collectives: "collections.Counter[str]" = collections.Counter()


@contextlib.contextmanager
def activate(mesh):
    """Make ``mesh`` (a DeviceMesh, or None) the active mesh inside the
    block."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def mesh():
    return _MESH


@contextlib.contextmanager
def split_batch(split: bool):
    """Inside the block, the batch a rank computes on is its own rows of
    the global batch (``split``), or the whole batch. A step that slices
    its rows (:func:`dp_rows`) says so here; ``models.moe`` routes by it."""
    global _SPLIT
    prev = _SPLIT
    _SPLIT = split
    try:
        yield
    finally:
        _SPLIT = prev


def batch_is_split() -> bool:
    return _SPLIT


def _sizes():
    return dict(zip(_MESH.mesh_dim_names, _MESH.shape))


def dp_axes() -> Optional[Tuple[str, ...]]:
    if _MESH is None:
        return None
    return tuple(a for a in _MESH.mesh_dim_names if a in ("pod", "data"))


def model_axis_size() -> int:
    if _MESH is None or "model" not in _MESH.mesh_dim_names:
        return 1
    return _sizes()["model"]


def model_rank() -> int:
    """This rank's coordinate on the model axis (0 without a mesh)."""
    if model_axis_size() == 1:
        return 0
    return _MESH.get_local_rank("model")


def model_group():
    """The process group of this rank's model axis."""
    return _MESH.get_group("model")


def model_shard(n: int) -> slice:
    """This rank's block of ``n`` entries sharded over the model axis
    (``torch.chunk``'s piece: ``n`` must divide)."""
    tp = model_axis_size()
    if n % tp:
        raise ValueError(f"{n} does not divide over {tp} model ranks")
    per = n // tp
    r = model_rank()
    return slice(r * per, (r + 1) * per)


def dp_size() -> int:
    """Ranks along the data-parallel axes, ('pod', 'data') flattened."""
    if _MESH is None:
        return 1
    sizes = _sizes()
    n = 1
    for a in dp_axes():
        n *= sizes[a]
    return n


def dp_rank() -> int:
    """This rank's index along the flattened data-parallel axes (pod
    major), the order in which ``P(('pod', 'data'))`` splits a batch."""
    if _MESH is None:
        return 0
    sizes = _sizes()
    r = 0
    for a in dp_axes():
        r = r * sizes[a] + _MESH.get_local_rank(a)
    return r


def axes_group(mesh, axes: Tuple[str, ...]):
    """The process group over this rank's ``axes`` of ``mesh``: one axis's
    group, or the axes flattened into one group, first axis major (made
    once per mesh and axes, by every rank together)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    made = mesh.__dict__.setdefault("_repro_groups", {})
    if axes not in made:
        made[axes] = mesh[axes]._flatten("_".join(axes)).get_group()
    return made[axes]


def first_axis(mesh):
    """(process group, size, this rank's index) along ``mesh``'s first
    dimension, over which the placement system spreads its rows and
    tenants, as the reference's ``mesh.axis_names[0]``."""
    name = mesh.mesh_dim_names[0]
    return mesh.get_group(name), mesh.shape[0], mesh.get_local_rank(name)


def dp_group():
    """The process group over this rank's data-parallel axes: the 'data'
    axis's group, or pod x data flattened."""
    return axes_group(_MESH, dp_axes())


def dp_rows(batch: int) -> slice:
    """The rows of a global batch of ``batch`` that this rank holds: its
    block of ``batch / dp_size()`` rows when the batch divides the
    data-parallel size, else all of them (replicated, as
    ``sharding._dp`` gives)."""
    n = dp_size()
    if n == 1 or batch % n:
        return slice(0, batch)
    per = batch // n
    r = dp_rank()
    return slice(r * per, (r + 1) * per)


def dp_sharded(batch: int) -> bool:
    """True when a global batch of ``batch`` rows is split over the
    data-parallel ranks (it divides their number, which is above 1)."""
    n = dp_size()
    return n > 1 and batch % n == 0


def constrain(x, spec=None):
    """Identity: see the module docstring."""
    return x


def constrain_sp(x):
    """Identity: the reference's sequence-parallel residual constraint
    moves no value (see the module docstring)."""
    return x


def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``dist.all_reduce`` of ``x`` in place over ``group``, counted in
    :data:`reduced_on` by ``x``'s device type."""
    reduced_on[x.device.type] += 1
    collectives["all_reduce"] += 1
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) of ``group`` concatenated along
    dim 0, in rank order; counted in :data:`reduced_on`."""
    reduced_on[x.device.type] += 1
    collectives["all_gather"] += 1
    parts = [x.new_empty(x.shape) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) of ``group`` concatenated along
    ``dim``, in rank order; counted in :data:`reduced_on`."""
    return all_gather_rows(x.movedim(dim, 0), group).movedim(0, dim)


def _model_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model axis, in float32 for a 16-bit ``x``,
    returned in ``x``'s dtype (a new tensor)."""
    y = x.float() if x.dtype in _LOW else x.clone()
    all_reduce(y, dist.ReduceOp.SUM, model_group())
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return _model_sum(g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x):
        return _model_sum(x)

    @staticmethod
    def backward(fctx, g):
        return g


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x):
        return _model_sum(x)

    @staticmethod
    def backward(fctx, g):
        return _model_sum(g)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim):
        fctx.dim, fctx.n = dim, x.shape[dim]
        return all_gather(x, dim, model_group())

    @staticmethod
    def backward(fctx, g):
        r = model_rank()
        return g.narrow(fctx.dim, r * fctx.n, fctx.n), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the gradient summed over the model axis."""
    return x if model_axis_size() == 1 else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model axis; the gradient passed through."""
    return x if model_axis_size() == 1 else _ReduceFromModel.apply(x)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model axis, and its gradient too."""
    return x if model_axis_size() == 1 else _SumOverModel.apply(x)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim``; the gradient is
    this rank's slice of it."""
    return x if model_axis_size() == 1 else _GatherFromModel.apply(x, dim)

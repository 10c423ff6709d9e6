"""Device meshes over a ``torch.distributed`` process group.

Port of ``repro.launch.mesh``. A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` built by
``init_device_mesh`` over the process group that already exists, with the
reference's axis names: ``("data", "model")``, or ``("pod", "data",
"model")`` with a leading pod axis. "data" carries data parallelism (the
batch), "model" the sequence-sharded decode (and, later, tensor
parallelism); the ranks are laid out row-major, so the last axis varies
fastest, as in ``jax.make_mesh``.

A mesh needs a process group. :func:`init_process_group_from_env` starts
the one the launchers share: under ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) it starts the group that
environment describes, over nccl when each rank has a card of its own and
over gloo on the CPU or when ranks share a card (nccl refuses two ranks on
one device; gloo reduces CUDA tensors too); without that environment it
starts a group of one, in memory.

The production shapes, 16 x 16 and 2 x 16 x 16, need 256 and 512 ranks:
on one card they exist only over a fake process group
(``torch.testing._internal.distributed.fake_pg``), which is how the tests
build them.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve

#: the environment ``torchrun`` gives each rank
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
          device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one first "
                           "(init_process_group_from_env, or "
                           "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"): 256 or 512 ranks."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_test_mesh(data: int = 1, model: int = 1, pod: int = 0, *,
                   device_type: str = "cpu") -> DeviceMesh:
    """(data, model), or (pod, data, model) when ``pod`` is set, over the
    existing group, whose world size must be the product of the axes."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of any object with the
    reference mesh's ``axis_names`` and ``shape`` (a dict), which is all
    the sharding rules read."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def dp_axes(mesh) -> tuple:
    """Axes that carry the batch: ('pod', 'data') on multi-pod meshes."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def tp_size(mesh) -> int:
    return axis_sizes(mesh)["model"]


def init_process_group_from_env(device: DeviceLike = "cuda",
                                ) -> torch.device:
    """Start the default process group and return the device this rank
    runs on: under ``torchrun`` (:data:`TORCHRUN_ENV` set) the group it
    describes, with ``LOCAL_RANK``'s card when ``device`` is a card,
    over nccl when each local rank has a card of its own and over gloo
    otherwise; without that environment a gloo group of one in memory."""
    dev = resolve(device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already started")
    env = os.environ
    if not all(k in env for k in TORCHRUN_ENV):
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        return dev
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    backend = "gloo"
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        local = int(env.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % n)
        torch.cuda.set_device(dev)
        if int(env.get("LOCAL_WORLD_SIZE", world)) <= n:
            backend = "nccl"
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return dev


def launch_mesh(data: int, model: int, device: DeviceLike = "cuda"):
    """The launchers' ``--data-mesh`` / ``--model-mesh``: (mesh or None,
    this rank's device). Outside ``torchrun`` a 1 x 1 mesh is one device,
    with no process group (None), and a wider one is refused before any
    group starts. Under ``torchrun`` the group starts from its environment
    (:func:`init_process_group_from_env`) and its world size must be data
    x model. ``--data-mesh 0``, the JAX launchers' production 16 x 16
    mesh, is refused: it needs 256 cards."""
    if data == 0:
        raise ValueError("--data-mesh 0 asks for the production 16 x 16 "
                         "mesh, 256 ranks, and this machine has one card: "
                         "give the mesh's widths (for example --data-mesh 1 "
                         "--model-mesh 2 under torchrun --nproc-per-node 2)")
    if data < 1 or model < 1:
        raise ValueError(f"mesh widths must be positive, got data {data} "
                         f"and model {model}")
    if not all(k in os.environ for k in TORCHRUN_ENV):
        if data * model > 1:
            raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                             f"ranks: start them with torchrun "
                             f"--nproc-per-node {data * model}")
        return None, resolve(device)
    dev = init_process_group_from_env(device)
    return make_test_mesh(data, model, device_type=dev.type), dev

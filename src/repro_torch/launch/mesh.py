"""Mesh construction, from the reference's ``repro.launch.mesh``.

The training meshes (``make_host_mesh``, ``make_production_mesh``) are
``torch.distributed`` ``DeviceMesh`` meshes over the ranks of the
initialised process group (started by ``torchrun``, or by
``dist.spmd.run_ranks`` over a ``FileStore``), one rank a device:
``cuda`` under NCCL, ``cpu`` under gloo.  The reference's meshes are
one process driving every device; here each rank is a process of its
own.

The replica mesh of the serving engine is a record of axis names, a
shape and one ``torch.device`` a position: one controller dispatches
each replica's row block to its device, with no process group and no
collective (``dist.sharding.shard_program``).  A mesh may repeat a
device (two replicas on one card), and ``make_data_mesh(device="cpu")``
makes N CPU replicas, the counterpart of XLA's forced host devices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axis_names`` and ``shape`` (one size an axis), and ``devices``,
    one ``torch.device`` a position in row-major order."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh axes {self.axis_names} and shape "
                             f"{self.shape} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} repeat a name")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh of shape {self.shape} needs "
                             f"{math.prod(self.shape)} devices, got "
                             f"{len(self.devices)}")

    def along(self, axis: str) -> tuple[torch.device, ...]:
        """The devices at each position of ``axis``, every other axis at
        position 0."""
        i = self.axis_names.index(axis)
        stride = math.prod(self.shape[i + 1:])
        return tuple(self.devices[j * stride] for j in range(self.shape[i]))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Sequence | None = None) -> Mesh:
    """A mesh of ``shape`` over ``axes``; ``devices`` (row-major, may
    repeat a device) defaults to the first ``prod(shape)`` GPUs."""
    shape = tuple(int(s) for s in shape)
    if devices is None:
        devices = _gpus(math.prod(shape))
    return Mesh(tuple(axes), shape,
                tuple(torch.device(d) for d in devices))


def _gpus(n: int) -> list[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise ValueError(f"a mesh of {n} GPUs: this machine has {have}")
    return [torch.device("cuda", i) for i in range(n)]


def make_data_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """1-D ``('data',)`` replica mesh: over ``n_devices`` GPUs (default
    every GPU present; asking for more raises), or with ``device="cpu"``
    over ``n_devices`` CPU replicas (default 1) — what the sharded
    serving engine spreads request batches over."""
    kind = torch.device(device).type
    if kind == "cpu":
        n = n_devices or 1
        devs = [torch.device("cpu")] * n
    elif kind == "cuda":
        n = n_devices or (torch.cuda.device_count()
                          if torch.cuda.is_available() else 0)
        if n < 1:
            raise ValueError("make_data_mesh: no CUDA device")
        devs = _gpus(n)
    else:
        raise ValueError(f"make_data_mesh: device {device!r} is neither "
                         f"'cuda' nor 'cpu'")
    return Mesh(("data",), (n,), tuple(devs))


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_mesh(shape: tuple, axes: tuple, what: str,
                 device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the process group's
    ranks, on the devices its backend drives (``device_type`` where
    given: gloo carries CUDA tensors too)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what}: a training mesh spans the ranks of a process group; "
            f"start one first (torchrun, or dist.spmd.run_ranks)")
    kind = device_type or ("cuda" if dist.get_backend() == "nccl"
                           else "cpu")
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: one pod of 16 data x 16 model =
    256 ranks; ``multi_pod`` adds a leading ``pod`` axis of 2 (512).
    Raises ``ValueError`` unless the process group has exactly that
    many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, world = math.prod(shape), _world()
    if world != need:
        raise ValueError(
            f"make_production_mesh{'(multi_pod=True)' if multi_pod else ''}"
            f": the mesh {dict(zip(axes, shape))} needs a world of {need} "
            f"ranks; this one has {world}")
    return _device_mesh(shape, axes, "make_production_mesh")


def make_host_mesh(model_parallel: int = 1, device_type: str | None = None):
    """Best-effort ``("data", "model")`` mesh over every rank of the
    process group: ``model`` is ``model_parallel``, lowered until it
    divides the world size, as the reference's.  ``device_type``: the
    devices the ranks compute on (by default ``cuda`` under NCCL,
    ``cpu`` under gloo; ``cuda`` under gloo puts several ranks on one
    card)."""
    n = _world()
    mp = max(1, min(model_parallel, n))
    while n % mp:
        mp -= 1
    return _device_mesh((n // mp, mp), ("data", "model"), "make_host_mesh",
                        device_type)

"""Mesh construction, from the reference's ``repro.launch.mesh``.

The reference's replica mesh is one process driving N devices through
``jax.make_mesh``.  Its counterpart here is a record of axis names, a
shape and one ``torch.device`` a position: one controller dispatches
each replica's row block to its device, with no process group and no
collective (``dist.sharding.shard_program``).  A mesh may repeat a
device (two replicas on one card), and ``make_data_mesh(device="cpu")``
makes N CPU replicas, the counterpart of XLA's forced host devices.

The production meshes (``make_production_mesh``) and the best-effort
host mesh for sharded training (``make_host_mesh``) need a
``torch.distributed`` ``DeviceMesh``: they come with the port's SPMD
slice and raise until then.
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


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh (16 data x 16 model, a leading
    ``pod`` axis for two pods) needs a ``torch.distributed`` device mesh
    over many hosts: the port's SPMD slice brings it."""
    raise NotImplementedError(
        "make_production_mesh: the production meshes come with the "
        "port's SPMD slice of dist (ROADMAP.md)")


def make_host_mesh(model_parallel: int = 1):
    """The reference's best-effort (data, model) mesh for sharded
    training: the port's SPMD slice brings it."""
    raise NotImplementedError(
        "make_host_mesh: the (data, model) training mesh comes with the "
        "port's SPMD slice of dist (ROADMAP.md)")

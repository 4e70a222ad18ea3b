"""The replica side of the reference's ``repro.dist.sharding``: its mesh
helpers (``mesh_axis_sizes``, ``dp_axes``, ``axis_product``,
``mesh_fingerprint``) and ``shard_program``.

The reference ``shard_map``s a batched program over contiguous row
blocks of the global batch, one block a replica of the ``data`` axis,
with no communication (requests are independent).  Here one controller
does the same by hand: ``ShardedProgram`` cuts the batch into
``n_replicas`` contiguous row blocks and runs block j with replica j's
program (the same plan and kernels, bound to replica j's device, with
graphs of its own), then joins the blocks' outputs in order on the
program's device.  On the card each block is one CUDA graph replay of
the batched K1 launches; on the CPU K1's plain version runs request by
request, so a row's result never depends on its block.

The FSDP and tensor-parallel builders (``param_pspecs``, ``opt_pspecs``,
``batch_pspecs``, ``cache_pspecs``) come with the port's SPMD slice.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..core.codegen import BatchedProgram


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}``."""
    return dict(zip(mesh.axis_names, mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes present in ``mesh`` (``pod`` and/or
    ``data``), in mesh order."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_product(mesh, axes: Sequence[str]) -> int:
    sizes = mesh_axis_sizes(mesh)
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


def mesh_fingerprint(mesh) -> str:
    """Stable content key of a mesh (a program-cache component: the same
    plan spread over different meshes is a different program).  Keys on
    the device identities, not just the topology: two ('data', 4)
    meshes over different devices never share a program."""
    return repr((tuple(mesh_axis_sizes(mesh).items()),
                 tuple(str(d) for d in mesh.devices)))


@dataclasses.dataclass
class ShardedProgram:
    """A ``BatchedProgram`` spread over the replicas of a mesh axis
    (module docstring).  Called as the batched program is; the global
    batch must be a multiple of ``n_replicas``.  A block bound for
    another device than the one its rows lie on is copied there, into a
    fresh tensor each call, so that replica replays a graph only where
    the allocator hands back the same address; a replica on the rows'
    own device reads its block in place."""

    base: BatchedProgram
    replicas: tuple[BatchedProgram, ...]
    axis: str
    #: the replicas keep the graphs (``replica_runners``)
    replays = None

    @property
    def graph(self):
        return self.base.graph

    @property
    def plan(self):
        return self.base.plan

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def group_fns(self):
        return self.base.group_fns

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    def replica_runners(self) -> list:
        return [r.replays for r in self.replicas if r.replays is not None]

    def prepare(self, **inputs) -> list[torch.Tensor]:
        return self.base.prepare(**inputs)

    def run(self, *tensors: torch.Tensor) -> tuple:
        """The program on positional batched tensors: row block j on
        replica j, the outputs joined in order on ``device``."""
        nb = tensors[0].shape[0]
        R = self.n_replicas
        if nb % R:
            raise ValueError(f"a batch of {nb} rows does not split over "
                             f"{R} replicas")
        per = nb // R
        blocks = []
        for j, rep in enumerate(self.replicas):
            part = [t[j * per:(j + 1) * per].to(rep.device)
                    for t in tensors]
            blocks.append(rep.run(*part))
        return tuple(torch.cat([b[k].to(self.device) for b in blocks])
                     for k in range(len(blocks[0])))

    def __call__(self, **inputs):
        outs = self.run(*self.prepare(**inputs))
        return outs[0] if len(outs) == 1 else outs


def shard_program(prog: BatchedProgram, mesh, axis: str = "data"):
    """Spread ``prog`` (from ``FusionCompiler.compile_batched``) over the
    ``axis`` replicas of ``mesh``: a ``ShardedProgram`` whose replica j
    runs on ``mesh.along(axis)[j]``.  Returns ``prog`` unchanged when the
    axis has size 1.  Raises ``ValueError`` when ``mesh`` lacks
    ``axis``."""
    sizes = mesh_axis_sizes(mesh)
    if axis not in sizes:
        raise ValueError(f"mesh {tuple(sizes)} has no {axis!r} axis")
    if sizes[axis] == 1:
        return prog
    replicas = tuple(dataclasses.replace(prog, device=d, replays=None)
                     for d in mesh.along(axis))
    return ShardedProgram(base=prog, replicas=replicas, axis=axis)

"""What every kernel wrapper (the generated K1 groups and the hand
kernels K2-K7) does around its ``ctypes`` call: check the tensors it is
given, make their device current, count the launch in ``LAUNCHES``,
raise on a non-zero ``cudaError_t``."""
from __future__ import annotations

import collections
import contextlib
import ctypes

import torch


class CudaLaunchError(RuntimeError):
    """A kernel launch, or a C query ahead of one, was refused or failed
    (non-zero ``cudaError_t``)."""


class LaunchCounter:
    """Kernel launches, by kernel name.  ``launch`` adds to it where it
    launches a kernel, and the replay of a CUDA graph adds the kernels
    the graph holds (``core.graphs``).  While a graph is being captured,
    ``launch`` records the kernel's name for the graph instead: the
    capture runs nothing."""

    def __init__(self):
        self.by_kernel: collections.Counter = collections.Counter()
        self._captured: list[str] | None = None

    @property
    def total(self) -> int:
        return sum(self.by_kernel.values())

    def add(self, name: str):
        if self._captured is not None:
            self._captured.append(name)
        else:
            self.by_kernel[name] += 1

    @contextlib.contextmanager
    def capturing(self):
        """Within the block, launches are recorded in the list it yields
        (the kernels of a graph being captured), not counted."""
        prev, self._captured = self._captured, []
        try:
            yield self._captured
        finally:
            self._captured = prev

    def reset(self):
        self.by_kernel.clear()


LAUNCHES = LaunchCounter()


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def check(kernel: str, name: str, t: torch.Tensor, shape: tuple,
          dtypes=(torch.float32,), device: torch.device | None = None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``shape`` and one
    of ``dtypes`` (``shape`` entries of None match any extent), on
    ``device`` where one is given."""
    if not isinstance(t, torch.Tensor) or not _on_cuda(t):
        where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"{kernel}: {name} is on {where}; the kernel "
                         f"launches on CUDA tensors only")
    if device is not None and t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, the other "
                         f"tensors on {device}; the kernel runs on one device")
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, the kernel "
                        f"takes {', '.join(map(str, dtypes))}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{kernel}: {name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _current(device: torch.device):
    """A context making ``device`` the current CUDA device (a no-op for
    any other device)."""
    return torch.cuda.device(device.index if device.type == "cuda" else -1)


def launch(kernel: str, fn, *args, device: torch.device):
    """Call the C launcher ``fn(*args, stream)`` on ``device``'s current
    stream, with ``device`` current, and count the launch under
    ``kernel``."""
    LAUNCHES.add(kernel)
    with _current(device):
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise CudaLaunchError(f"{kernel}: launch failed with cudaError_t "
                              f"{status}")


_grids: dict = {}


def grid_query(kernel: str, fn, *args: int, device: torch.device,
               count: int = 2) -> tuple[int, ...]:
    """The ``count`` ints that the C query ``fn(*args, &a, &b, ...)`` of
    ``kernel`` returns for ``device`` (a grid sized from the kernel's
    occupancy on that card: K2's and K3 ``_k1``'s (row ranges, column
    strips); K5's split configuration; K4's path), cached per device and
    arguments."""
    key = (kernel, device.index, *args)
    if key not in _grids:
        outs = [ctypes.c_int(0) for _ in range(count)]
        with _current(device):
            status = fn(*args, *map(ctypes.byref, outs))
        if status != 0:
            raise CudaLaunchError(f"{kernel}: occupancy query failed with "
                                  f"cudaError_t {status}")
        _grids[key] = tuple(o.value for o in outs)
    return _grids[key]


def device_scalar(a, device: torch.device) -> torch.Tensor:
    """A scalar as a 0-d float32 tensor on ``device``, made there (no
    host round trip) when it is a Python number."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(a), dtype=torch.float32, device=device)

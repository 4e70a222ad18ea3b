"""Checkpointing with an integrity manifest and asynchronous writes, from
the reference's ``repro.ckpt.checkpoint``, with its on-disk format:

* one ``step_%08d`` directory a checkpoint, one ``.npy`` file a leaf,
  named by the sha1 of the leaf's key (its tree path, ``/``-joined:
  ``params/layers.0.wq``, ``params_c/embed``, ``opt/m/layers.0.wq/q``,
  ``opt/step``);
* ``manifest.json`` with ``step``, ``leaves`` (each leaf's ``file``,
  ``shape``, ``dtype`` and the ``sha256`` of its file) and ``extra``;
* written to a ``.tmp-<step>`` sibling of the checkpoint directory
  first, then moved into place by ``os.replace``; ``restore`` checks
  every leaf's sha256 and raises ``IOError`` on a mismatch;
* ``save`` writes, and ``restore`` reads, up to ``IO_THREADS`` leaves at
  once, each thread hashing while it writes or reads.

A tree is nested dicts whose leaves are tensors, and ``nn.Module``\\ s
whose leaves are their parameters by name (the train state's
``params_c``, an ``LM``).  bfloat16 has no numpy dtype: its
leaves are saved as their raw 16 bits (``uint16``) with ``"bfloat16"``
in the manifest, as the reference's manifest names it, and viewed back
on load.

``restore`` writes into the tensors of ``tree_like`` in place, on their
own devices, and returns that tree: the train state keeps its identity
(a captured step's addresses, the compute copy's ``requires_grad``
leaves).

A sharded train state (``train.steps.shard_train_state``) is saved and
restored with its ``shardings`` (``dist.spmd.StateShardings``): ``save``
gathers each leaf from every rank's piece (every rank takes part) and
only rank 0 writes, the files and the manifest byte for byte those of
an unsharded save of the same state; ``restore`` reads each global
leaf and keeps this rank's piece of it, so a checkpoint restores onto
whatever mesh the restarted run has, or with no process group at all
into an unsharded state.

``AsyncCheckpointer.save`` takes a snapshot on the caller's thread
before it returns: the port's train step updates the state in place,
and on the CPU ``.numpy()`` is a view of the live tensor, so a snapshot
that were not a copy would hold a later step.  A CUDA leaf is copied
into pinned host memory on the current stream (the next step's kernels
queue behind the copies), and the writer thread waits for the copies'
event before it writes.
"""
from __future__ import annotations

import collections
import concurrent.futures
import hashlib
import json
import os
import pathlib
import queue
import shutil
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(key, leaf) of ``tree``: dicts in sorted key order (as the
    reference's tree paths), a module's parameters in its order."""
    if isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name, p
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree
    else:
        raise TypeError(f"checkpoint leaf {prefix[:-1]!r}: "
                        f"{type(tree).__name__} is not a tensor")


def _host(t: torch.Tensor) -> np.ndarray:
    """A leaf as a host numpy array (a view of a CPU tensor; bfloat16 as
    its raw 16 bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    return t.numpy()


def _lookup(shardings, key: str):
    """The ``Layout`` of a leaf's key in a ``StateShardings``' tree."""
    node = shardings.tree
    for part in key.split("/"):
        node = node[part]
    return node


def _local(t: torch.Tensor) -> torch.Tensor:
    """A leaf's piece on this rank (a DTensor's local tensor)."""
    return t.to_local() if hasattr(t, "to_local") else t


def _leaves(tree, shardings=None) -> Iterator[tuple[str, Any]]:
    """(key, leaf) of ``tree``; with ``shardings`` each leaf gathered from
    every rank's piece (a collective: every rank iterates)."""
    for key, leaf in _flatten(tree):
        if shardings is not None:
            leaf = _lookup(shardings, key).gather(leaf, shardings.spmd)
        yield key, leaf


#: leaves read or written at once: each thread hashes while it reads or
#: writes (one thread moves ~0.8 GB/s on an H100 machine's host)
IO_THREADS = min(8, os.cpu_count() or 1)


def _in_order(fn, items) -> Iterator:
    """``fn(item)`` for every item, on ``IO_THREADS`` threads, the results
    in the items' order; items are drawn (on the caller's thread) at most
    twice as many ahead as the threads, so memory stays bounded."""
    with concurrent.futures.ThreadPoolExecutor(IO_THREADS) as pool:
        pending: collections.deque = collections.deque()
        for item in items:
            pending.append(pool.submit(fn, item))
            if len(pending) >= 2 * IO_THREADS:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier(shardings):
    if shardings is not None:
        import torch.distributed as dist
        dist.barrier()


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


class _HashingWriter:
    """A file that hashes what ``np.save`` writes through it, so the
    sha256 costs no second read of the file."""

    def __init__(self, f):
        self._f = f
        self.sha = hashlib.sha256()

    def write(self, data):
        self.sha.update(data)
        return self._f.write(data)


def _save_leaf(path: pathlib.Path, arr: np.ndarray) -> str:
    with open(path, "wb") as f:
        w = _HashingWriter(f)
        np.save(w, arr)
    return w.sha.hexdigest()


def save(ckpt_dir: str | os.PathLike, step: int, tree: Any,
         extra: dict | None = None, shardings=None) -> pathlib.Path:
    """Blocking save of one checkpoint of ``tree`` at ``step``; returns
    its ``step_%08d`` directory.  ``shardings``: ``tree`` is a sharded
    state, gathered leaf by leaf and written by rank 0 (every rank
    calls ``save``; it returns after the write)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    if shardings is not None and _rank() != 0:
        for _ in _leaves(tree, shardings):
            pass
        _barrier(shardings)
        return final
    tmp = ckpt_dir.with_name(ckpt_dir.name + f".tmp-{step}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": int(step), "leaves": {}, "extra": extra or {}}

    def write(item):
        key, leaf = item
        arr = _host(leaf)
        fname = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
        return key, {"file": fname, "shape": list(arr.shape),
                     "dtype": _dtype_name(leaf),
                     "sha256": _save_leaf(tmp / fname, arr)}

    for key, meta in _in_order(write, _leaves(tree, shardings)):
        manifest["leaves"][key] = meta
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    final.parent.mkdir(parents=True, exist_ok=True)
    os.replace(tmp, final)
    _barrier(shardings)
    return final


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    """The newest complete checkpoint's step under ``ckpt_dir``, or
    None."""
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


_HEADERS = {(1, 0): np.lib.format.read_array_header_1_0,
            (2, 0): np.lib.format.read_array_header_2_0}


def _read_verified(path: pathlib.Path, key: str, meta: dict) -> np.ndarray:
    """The leaf's array, read once into memory of its own while the
    file's sha256 is taken; ``IOError`` where the digest, shape or dtype
    is not the manifest's."""
    sha = hashlib.sha256()
    with open(path, "rb") as f:
        try:
            header = _HEADERS.get(np.lib.format.read_magic(f))
            if header is None:
                raise ValueError("an .npy version this reader lacks")
            shape, fortran, dtype = header(f)
        except ValueError as e:
            raise IOError(f"checkpoint corruption in {key} "
                          f"({meta['file']}): {e}") from None
        offset = f.tell()
        f.seek(0)
        sha.update(f.read(offset))
        arr = np.empty(shape, dtype, order="F" if fortran else "C")
        view = memoryview(arr.reshape(-1, order="A").view(np.uint8))
        chunk = 1 << 26
        for i in range(0, len(view), chunk):
            part = view[i:i + chunk]
            if f.readinto(part) != len(part):
                raise IOError(f"checkpoint corruption in {key} "
                              f"({meta['file']}): truncated")
            sha.update(part)
        sha.update(f.read())
    if sha.hexdigest() != meta["sha256"]:
        raise IOError(f"checkpoint corruption in {key} ({meta['file']})")
    if list(arr.shape) != list(meta["shape"]):
        raise IOError(f"checkpoint leaf {key}: shape {list(arr.shape)}, "
                      f"the manifest {meta['shape']}")
    return arr


def restore(ckpt_dir: str | os.PathLike, tree_like: Any,
            step: int | None = None, shardings=None):
    """Restore the checkpoint at ``step`` (the newest where None) into
    the tensors of ``tree_like``, in place under ``no_grad`` on their
    own devices.  Returns (tree_like, step, extra).  ``shardings``:
    ``tree_like`` is a sharded state (``dist.spmd.StateShardings``) and
    each rank keeps its piece of every global leaf, whatever mesh wrote
    the checkpoint.  Raises ``FileNotFoundError`` without a checkpoint,
    ``KeyError`` for a leaf the checkpoint lacks, ``IOError`` where a
    file's sha256 is not the manifest's and ``ValueError`` where a
    leaf's shape or dtype differs from ``tree_like``'s."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    items = []
    for key, proto in _flatten(tree_like):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        want = _dtype_name(proto)
        lay = _lookup(shardings, key) if shardings is not None else None
        shape = list(lay.shape) if lay is not None else list(proto.shape)
        if meta["dtype"] != want or list(meta["shape"]) != shape:
            raise ValueError(f"checkpoint leaf {key}: {meta['dtype']} "
                             f"{meta['shape']}, the tree's {want} {shape}")
        items.append((key, proto, meta, lay))

    def read(item):
        key, _, meta, _ = item
        return _read_verified(d / meta["file"], key, meta)

    for (key, proto, meta, lay), arr in zip(items, _in_order(read, items)):
        src = torch.from_numpy(arr)
        if proto.dtype == torch.bfloat16:
            src = src.view(torch.bfloat16)
        if lay is not None:
            src = lay.local(src, shardings.spmd)
        with torch.no_grad():
            _local(proto).copy_(src)
    return tree_like, step, manifest.get("extra", {})


class _Snapshot:
    """A tree's host copy: CPU leaves cloned, CUDA leaves copied into
    pinned host memory on their devices' current streams, behind an
    event the writer waits for."""

    def __init__(self, tree, shardings=None):
        self.leaves: dict[str, torch.Tensor] = {}
        self._events = []
        devices = set()
        for key, leaf in _leaves(tree, shardings):
            leaf = leaf.detach()
            if leaf.device.type == "cuda":
                host = torch.empty(leaf.shape, dtype=leaf.dtype,
                                   pin_memory=True)
                with torch.cuda.device(leaf.device):
                    host.copy_(leaf, non_blocking=True)
                devices.add(leaf.device)
            else:
                host = leaf.clone()
            self.leaves[key] = host
        for dev in devices:
            ev = torch.cuda.Event()
            with torch.cuda.device(dev):
                ev.record()
            self._events.append(ev)

    def ready(self) -> dict:
        for ev in self._events:
            ev.synchronize()
        return self.leaves


class AsyncCheckpointer:
    """Background-thread writer: ``save`` returns once the snapshot is
    taken (module docstring) and a thread writes it (``save``, then
    garbage collection down to the newest ``keep`` checkpoints).  At
    most 2 snapshots wait in the queue, each a full host copy of the
    tree; a third ``save`` blocks until the writer takes one.

    ``wait`` returns when every queued snapshot is written, ``close``
    when the writer thread has finished (no timeout: a large state takes
    as long as it takes).  An exception of the writer is raised again at
    every later ``save``, ``wait`` and ``close``.  ``timings[step]``
    holds the writer's seconds for each written step: waiting for the
    snapshot's copies (``snapshot_s``) and writing it (``write_s``).

    ``shardings``: the trees saved are a sharded state; every rank calls
    ``save`` (the gather of each leaf is a collective) and only rank 0
    snapshots and writes; ``close`` ends with a barrier, so that every
    rank returns once the last checkpoint is on disk."""

    def __init__(self, ckpt_dir: str | os.PathLike, keep: int = 3,
                 shardings=None):
        self.dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self.shardings = shardings
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: BaseException | None = None
        self._closed = False
        self.timings: dict[int, dict] = {}
        self._t = threading.Thread(target=self._worker, daemon=True,
                                   name="AsyncCheckpointer")
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, snap, extra = item
                if self._err is None:
                    t0 = time.perf_counter()
                    tree = snap.ready()
                    t1 = time.perf_counter()
                    save(self.dir, step, tree, extra)
                    self.timings[step] = {
                        "snapshot_s": t1 - t0,
                        "write_s": time.perf_counter() - t1}
                    self._gc()
            except Exception as e:  # noqa: BLE001 — raised on the caller
                self._err = e
            finally:
                del item
                self._q.task_done()

    def _gc(self):
        steps = sorted(self.dir.glob("step_*"))
        for p in steps[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)

    def _check(self):
        if self._err is not None:
            raise self._err

    def save(self, step: int, tree: Any, extra: dict | None = None):
        """Snapshot ``tree`` and queue its write at ``step``."""
        self._check()
        if self._closed:
            raise RuntimeError("AsyncCheckpointer.save after close")
        if self.shardings is not None and _rank() != 0:
            for _ in _leaves(tree, self.shardings):
                pass
            return
        self._q.put((step, _Snapshot(tree, self.shardings), extra))

    def wait(self):
        """Return when every queued snapshot is written."""
        self._q.join()
        self._check()

    def close(self):
        """Write what is queued, stop the writer and wait for it."""
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._t.join()
            _barrier(self.shardings)
        self._check()

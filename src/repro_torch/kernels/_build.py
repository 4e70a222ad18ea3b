"""Build and load of the CUDA sources: K1's generated ones and the hand
kernels in ``csrc/``.

Every source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so one build takes seconds, not minutes.  Libraries are
cached on disk under the build directory (``build/kernels`` at the root
of the checkout, or ``$REPRO_TORCH_BUILD_DIR``) as ``<name>_<hash>.so``:
``name`` says which kernel it is (``k1`` for generated plans, the source's
stem for a hand kernel) and the hash covers the source, the headers of
``csrc/`` it includes and the flags.  Loaded libraries are also cached in
memory per process.  Builds are safe to run from several threads or
processes at once: each publishes its library with an atomic rename.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

#: ``-Xptxas -v`` reports each kernel's registers, shared memory and
#: spills; the report is kept in a ``.log`` beside the library
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    """nvcc is missing or refused a generated source."""


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    # src/repro_torch/kernels/_build.py -> the root of the checkout
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise BuildError("nvcc not found: the cuda backend builds its kernels "
                         "with the CUDA toolkit (add it to PATH)")
    return nvcc


def included_headers(source: str) -> list[pathlib.Path]:
    """The headers of ``csrc/`` that ``source`` includes, directly or
    through another header, in a fixed order."""
    found: list[pathlib.Path] = []
    todo = [source]
    while todo:
        for name in _INCLUDE.findall(todo.pop()):
            path = CSRC / name
            if path.exists() and path not in found:
                found.append(path)
                todo.append(path.read_text())
    return found


def source_key(source: str) -> str:
    h = hashlib.sha256()
    for path in included_headers(source):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(source.encode())
    return h.hexdigest()[:24]


def library_path(source: str, name: str = "k1") -> pathlib.Path:
    return build_dir() / f"{name}_{source_key(source)}.so"


def build(source: str, name: str = "k1") -> pathlib.Path:
    """Compile ``source`` into the build directory as kernel ``name`` (a
    no-op when a library for the same source is already there); returns
    its path."""
    out = library_path(source, name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        src = pathlib.Path(tmp) / (out.stem + ".cu")
        src.write_text(source)
        lib = pathlib.Path(tmp) / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise BuildError(f"nvcc failed ({res.returncode}) on {out.stem}.cu:"
                             f"\n{res.stderr[-4000:]}")
        # keep the source and the compiler's messages beside the library
        os.replace(src, out.with_suffix(".cu"))
        if res.stderr.strip():
            out.with_suffix(".log").write_text(res.stderr)
        os.replace(lib, out)
    return out


def load(source: str, name: str = "k1") -> ctypes.CDLL:
    """Build if needed, then load ``source``'s library (once per process)."""
    key = f"{name}_{source_key(source)}"
    with _lock:
        lib = _loaded.get(key)
    if lib is not None:
        return lib
    path = build(source, name)
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = _loaded[key] = ctypes.CDLL(str(path))
    return lib


def load_csrc(filename: str) -> ctypes.CDLL:
    """Build if needed, then load the hand kernel ``csrc/<filename>``,
    named after its stem."""
    path = CSRC / filename
    return load(path.read_text(), path.stem)


def c_function(lib: ctypes.CDLL, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``lib.symbol`` with its argument types set; it returns a
    ``cudaError_t`` as an int."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn

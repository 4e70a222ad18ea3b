"""Where K5's split kernel spends its time, on one NVIDIA GPU.

    python3 tools/k5_ablation.py        # from the root of a checkout

Builds three versions of ``src/repro_torch/csrc/decode_attention.cu``
and times each one's split kernel as device time (``core.timing.device_ms``)
at the shapes ``chip_smoke.py`` times K5 at:

* ``kernel``: the source as it is;
* ``copies``: the same with the work on each tile cut out, so that only
  the stream of K and V into shared memory, the pipeline's waits and the
  end-of-chunk merge are left;
* ``compute``: the same with the copies and their waits cut out, so
  that the work runs on whatever shared memory holds.

``kernel`` against the larger of ``copies`` and ``compute`` says how
much of the work the stream hides.  The cuts are text edits of the
source at the comments that mark each kernel's phases; the script fails
if a mark is missing.  Prints one JSON line a (version, shape, dtype),
the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: (start, end) of the work on a tile, cut out for ``copies``
WORK = (("    // batches of RB rows", '  asm volatile("cp.async.wait_all'),
        ("    // scores: n-tile n holds rows",
         "  // the warps' (m, l, acc) into shared"))
#: the copies and their waits, cut out for ``compute``
COPIES = ("    cp_async_wait_stage(stages);",
          "    issue(i + stages - 1);",
          "  for (int i = 0; i < stages - 1; ++i) issue(i);",
          "    mbar_wait(bars + 8 * st, (it / stages) & 1);",
          "    issue(it + stages - 1);",
          "  for (int it = 0; it < stages - 1; ++it) issue(it);")
SHAPES = (((8, 32, 8, 8192, 128), "bfloat16"), ((8, 32, 8, 8192, 128),
                                                "float32"),
          ((1, 1, 1, 131072, 48), "float32"))


def versions(src: str) -> dict[str, str]:
    copies = src
    for start, end in WORK:
        i, j = copies.index(start), copies.index(end)
        copies = copies[:i] + "  }\n\n" + copies[j:]
    compute = src
    for line in COPIES:
        i = compute.index(line)
        compute = compute[:i] + compute[compute.index("\n", i) + 1:]
    return {"kernel": src, "copies": copies, "compute": compute}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("k5_ablation: needs an NVIDIA GPU")
    from repro_torch.core.timing import device_ms
    from repro_torch.kernels import _build, _launch
    from repro_torch.kernels import decode_attention as k5
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    src = (_build.CSRC / "decode_attention.cu").read_text()
    ptr, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, text in versions(src).items():
        lib = _build.load(text, f"k5{name}")
        libs[name] = (
            _build.c_function(lib, "decode_attention_split_launch",
                              [ptr] * 6 + [i] * 8 + [ctypes.c_float, i,
                                                     ptr, ptr]),
            _build.c_function(lib, "decode_attention_combine_launch",
                              [ptr] * 4 + [i] * 6 + [ptr]),
            _build.c_function(lib, "decode_attention_config",
                              [i] * 3 + [ctypes.POINTER(i)]
                              * len(k5.CONFIG_FIELDS)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, dt in SHAPES:
        B, Hq, Hkv, S, d = shape
        tdt = getattr(torch, dt)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(tdt)
                   for s in ((B, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d)))
        for name, fns in libs.items():
            k5._fns = fns
            _launch._grids.clear()
            ms = device_ms(lambda: k5.split(q, k, v))
            print(json.dumps({"version": name, "shape": list(shape),
                              "dtype": dt, "split_ms": ms,
                              **k5.config(Hq // Hkv, d, tdt, q.device)}),
                  flush=True)
    k5._fns = None
    _launch._grids.clear()


if __name__ == "__main__":
    main()

"""Quickstart: the kernel-fusion compiler on a BLAS sequence.

The paper's core flow on the BiCGK sequence (q = Ap, s = Aᵀr): trace the
script, search the fusion space, compare the compiler's fused program
against the unfused (one kernel per call) baseline, and validate against
numpy.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.blas import REGISTRY, make_inputs
from repro_torch.core import FusionCompiler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    ap.add_argument("--n", type=int, default=2048)
    args = ap.parse_args(argv)
    n = args.n
    seq = REGISTRY["BiCGK"]
    cc = FusionCompiler(device=args.device)

    prog, report = cc.compile(seq.script, seq.shapes(n), report=True)
    print(f"fusions considered: {report.n_fusions}, implementations: "
          f"{report.n_impls}, combinations: {report.n_combinations}")
    print(f"predicted speedup vs unfused: {report.predicted_speedup:.2f}x")
    for impl in report.best.impls:
        print("  kernel:", impl.describe())

    inputs = make_inputs(seq, n)
    q, s = prog(**inputs)
    qr, sr = seq.reference(**inputs)
    np.testing.assert_allclose(q.cpu().numpy(), qr, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(s.cpu().numpy(), sr, rtol=1e-4, atol=1e-3)
    print("matches numpy oracle ✓")

    unfused = cc.compile(seq.script, seq.shapes(n), mode="unfused")
    for name, p in [("fused", prog), ("unfused", unfused)]:
        ins = p.prepare(**inputs)
        p.run(*ins)
        p.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            p.run(*ins)
        p.synchronize()
        print(f"{name} ({p.device}): "
              f"{(time.perf_counter() - t0) / 10 * 1e6:.0f} us/call")

    # the same plan on the plain torch backend
    dense = cc.compile(seq.script, seq.shapes(n), backend="torch")
    qd, sd = dense(**inputs)
    np.testing.assert_allclose(qd.cpu().numpy(), qr, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(sd.cpu().numpy(), sr, rtol=1e-4, atol=1e-3)
    print("torch backend matches ✓")


if __name__ == "__main__":
    main()

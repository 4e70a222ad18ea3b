"""Using the fusion compiler on a user-defined (non-BLAS) sequence — the
paper's 'fusion-equipped library' use case (§1).

One Jacobi-ish update y = x + omega*(b - x*diag) with a convergence check
r = max|y - x|, out of elementary maps and a reduce, which the compiler
fuses into a single kernel:

    PYTHONPATH=src python -m repro_torch.examples.custom_sequence
    PYTHONPATH=src python -m repro_torch.examples.custom_sequence --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import FusionCompiler, Monoid
from repro_torch.core.elementary import make_map, make_reduce

step = make_map("jacobi_step",
                lambda omega, x, b, d: x + omega * (b - x * d),
                arity=4, scalar_args=(0,), flops_per_point=4,
                cuda="{1} + {0} * ({2} - {1} * {3})")
diff = make_map("absdiff", lambda a, c: torch.abs(a - c), arity=2,
                cuda="fabsf({0} - {1})")
rmax = make_reduce("rmax", Monoid.MAX)


def script(g, x, b, d, omega):
    y = g.apply(step, omega, x, b, d, name="y")
    e = g.apply(diff, y, x)
    r = g.apply(rmax, e, name="r")
    return y, r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    ap.add_argument("--n", type=int, default=1 << 16)
    args = ap.parse_args(argv)
    n = args.n
    cc = FusionCompiler(device=args.device)
    prog, rep = cc.compile(
        script, {"x": (n,), "b": (n,), "d": (n,), "omega": ()}, report=True)
    print(f"combinations: {rep.n_combinations}; predicted speedup "
          f"{rep.predicted_speedup:.2f}x; kernels in best: "
          f"{len(rep.best.impls)}")
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    d = rng.uniform(0.5, 1.5, n).astype(np.float32)
    y, r = prog(x=x, b=b, d=d, omega=np.float32(0.6))
    want_y = x + np.float32(0.6) * (b - x * d)
    np.testing.assert_allclose(y.cpu().numpy(), want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(r), np.max(np.abs(want_y - x)),
                               rtol=1e-5)
    print("custom fused sequence matches oracle ✓")


if __name__ == "__main__":
    main()

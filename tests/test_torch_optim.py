"""The port's AdamW through the fusion compiler
(``repro_torch.optim.fused``) against the JAX reference's
``repro.optim.fused_adamw_update`` and the plain ``ref.adamw``.

The inputs and tolerance are ``tests/test_kernels.py::
test_fused_adamw_matches_pallas_and_ref``'s: n = 1024, step 7, rtol
1e-5 and atol 1e-6 (float32, the same terms in the same order up to the
rounding of the bias corrections).  On the CPU the ``cuda`` backend runs
K1's plain tiled version, and the ``torch`` backend plain tensor code.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.optim import fused_adamw_update as ref_fused_adamw_update
from repro_torch.kernels import ref
from repro_torch.optim import fused_adamw_update, make_fused_adamw

N = 1024
KW = dict(lr=2e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
          step=7)


def _inputs(seed=42):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(N).astype(np.float32)
    g = rng.standard_normal(N).astype(np.float32)
    m = np.zeros(N, np.float32)
    v = np.zeros(N, np.float32) + np.float32(0.05)
    return p, g, m, v


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("mode", ["best", "unfused"])
def test_fused_adamw_matches_reference_and_ref(backend, mode):
    arrs = _inputs()
    got = fused_adamw_update(*map(torch.from_numpy, arrs), backend=backend,
                             mode=mode, **KW)
    want_fused = ref_fused_adamw_update(*map(jnp.asarray, arrs), **KW)
    want_ref = jref.adamw(*map(jnp.asarray, arrs), **KW)
    want_plain = ref.adamw(*map(torch.from_numpy, arrs), **KW)
    assert len(got) == 3
    for o, a, b, c in zip(got, want_fused, want_ref, want_plain):
        assert o.dtype == torch.float32 and o.shape == (N,)
        _close(o.numpy(), a)
        _close(o.numpy(), b)
        _close(o.numpy(), c.numpy())


def test_scalars_stay_on_the_device_as_tensors(monkeypatch):
    """lr and step may be tensors (a schedule); the bias corrections are
    computed as 0-d float32 tensors on the parameters' device, without
    reading any value back to the host."""
    arrs = [torch.from_numpy(a) for a in _inputs(3)]
    want = fused_adamw_update(*arrs, backend="torch", **KW)

    def no_item(self):
        raise AssertionError("a value was read back to the host")
    monkeypatch.setattr(torch.Tensor, "item", no_item)
    monkeypatch.setattr(torch.Tensor, "__float__", no_item)
    kw = {**KW, "lr": torch.tensor(KW["lr"]), "step": torch.tensor(7)}
    got = fused_adamw_update(*arrs, backend="torch", **kw)
    for o, w in zip(got, want):
        torch.testing.assert_close(o, w, rtol=1e-6, atol=1e-7)


def test_compiled_program_is_cached_and_fused():
    a = make_fused_adamw(N, "torch", "best", torch.device("cpu"))
    assert make_fused_adamw(N, "torch", "best", torch.device("cpu")) is a
    assert a.n_groups == 1
    u = make_fused_adamw(N, "torch", "unfused", torch.device("cpu"))
    assert u.n_groups == 4


def test_default_device_is_the_card():
    """The entry point runs on CUDA unless the caller asks for the CPU:
    without a card, the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        make_fused_adamw.__wrapped__(N)

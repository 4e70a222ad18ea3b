"""The port's closed-form cost model (``repro_torch.launch.costmodel``)
against the reference's: the same flops, bytes and notes for every
architecture at every supported shape (plain arithmetic on the config,
so equal to float64 rounding, 1e-12 relative), and the card's constants
in the roofline terms."""
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import costmodel as ref_costmodel
from repro_torch.configs import ARCHS, SHAPES, get_config, supported_cells
from repro_torch.launch import costmodel
from torch_threads import capped_torch_threads  # noqa: F401

CELLS = [(a, s) for a in ARCHS for s in supported_cells(a)]


def close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1.0)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_estimate_equals_reference(arch, shape):
    got = costmodel.estimate(get_config(arch), SHAPES[shape])
    want = ref_costmodel.estimate(ref_get_config(arch), REF_SHAPES[shape])
    for k in ("model_flops", "impl_flops", "hbm_bytes", "params_bytes"):
        assert close(getattr(got, k), getattr(want, k)), k
    assert got.notes.keys() == want.notes.keys()
    for k in want.notes:
        assert close(got.notes[k], want.notes[k]), k


def test_terms_use_the_cards_constants():
    assert (costmodel.PEAK_FLOPS_BF16, costmodel.HBM_BW, costmodel.LINK_BW,
            costmodel.HBM_PER_CARD) == (989e12, 3.35e12, 450e9, 80e9)
    est = costmodel.estimate(get_config("llama3_8b"), SHAPES["decode_32k"])
    t = est.terms(1)
    assert close(t["t_compute_s"], est.impl_flops / 989e12)
    assert close(t["t_memory_s"], est.hbm_bytes / 3.35e12)
    assert t["dominant"] == "memory"
    assert t["step_lower_bound_s"] == t["t_memory_s"]
    four = est.terms(4, collective_wire_bytes_per_dev=450e9)
    assert close(four["t_memory_s"], t["t_memory_s"] / 4)
    assert close(four["t_collective_s"], 1.0)
    assert four["dominant"] == "collective"

"""K1's slices: how the generator cuts reduce axes across CTAs.

A CUDA kernel cannot run on the CPU, so this file checks the
decomposition the generated kernels follow (``GroupLayout``, the same
numbers the emitter writes into the source) for all 15 programs and
every impl the scheduler enumerates:

* the (tile, slice) ranges of every phase cover each axis exactly once,
  the ragged tail included, and the items are exactly their products;
* the slice counts are powers of two fixed by the plan alone: equal for
  a plan and its JSON round trip on a fresh trace, and written into the
  source as constants (the grid appears only in grid-stride steps);
* at the ``chip_smoke.py`` sizes, the groups that ran on one to 128 CTAs
  now reach ``TARGET_UNITS`` units x slices, and the small groups stay
  whole (LM_RMSNORM's 4096-element sum).

That the generator still emits every enumerated impl, with one grid
barrier per phase boundary and one per cut phase, is checked in
``tests/test_torch_fused_group.py``; the kernels themselves on the card
in ``tests/test_torch_gpu.py`` (against ``tiled_reference``, and two
launches bitwise equal).
"""
import math
import re

import pytest

from repro_torch.core import V5E, ExecutionPlan, FusionCompiler, PlanCache
from repro_torch.core import trace
from repro_torch.core.cuda_codegen import (MIN_SLICE_POINTS, SPLIT_BELOW,
                                           SPLIT_MIN_POINTS, TARGET_UNITS,
                                           GroupLayout, group_source)
from repro_torch.core.scheduler import build_space
from repro_torch.programs import REGISTRY
from torch_threads import capped_torch_threads  # noqa: F401

#: programs over long vectors, sized 2**24 in ``chip_smoke.py``
BLAS1 = ("AXPYDOT", "VADD", "WAXPBY", "SSCAL", "FUSED_ADAMW")
#: the sizes of the tests and of ``chip_smoke.py``, and sizes that no
#: tile, lane chunk or slice divides (3000, 100_003, 1_000_003)
SIZES = [(name, n) for name in sorted(REGISTRY) for n in (256, 3000, 4096)] \
    + [(name, n) for name in BLAS1 for n in (1_000_003, 1 << 24)] \
    + [("LM_DECODE_ATTN", n) for n in (100_003, 131072)]


def _smoke_size(name):
    if name == "LM_DECODE_ATTN":
        return 131072
    return 1 << 24 if name in BLAS1 else 4096


def _impls(name, n):
    g = trace(REGISTRY[name].script, REGISTRY[name].shapes(n))
    space = build_space(g)
    return g, [im for f in space.fusions
               for im in space.impls_by_fusion[f.key]]


def _check_cover(ranges, n):
    """The non-empty ranges, in order, run from 0 to n with no gap and no
    overlap; empty ones lie past their span's end."""
    at = 0
    for c0, c1 in ranges:
        if c1 <= c0:
            continue
        assert c0 == at, (ranges, n)
        at = c1
    assert at == n, (ranges, n)


@pytest.mark.parametrize("name,n", SIZES)
def test_slices_cover_every_axis_once(name, n):
    g, impls = _impls(name, n)
    assert impls
    for im in impls:
        lay = GroupLayout(g, im)
        for p, ph in enumerate(lay.phases):
            assert set(ph.slices) == ph.serial | ph.tiled
            per_axis = []
            for r in lay.order:
                ranges = lay.axis_ranges(p, r)
                _check_cover(ranges, lay.sizes[r])
                per_axis.append(len(ranges))
            assert math.prod(per_axis) == ph.items
            for s in ph.slices.values():
                assert s & (s - 1) == 0
            if ph.S > 1:
                assert ph.units < SPLIT_BELOW
                assert math.prod(ph.span.values()) >= SPLIT_MIN_POINTS
                assert math.prod(ph.chunk.values()) >= MIN_SLICE_POINTS
            for red in ph.reds:
                assert red.cut == math.prod(ph.slices[a] for a in red.rr)
        for shape, red in zip(lay.workspace()[len(lay.consumed):],
                              lay.cut_reds):
            assert shape == (red.cut, red.size)


def test_slice_counts_depend_on_the_plan_alone():
    cc = FusionCompiler(backend="cuda", device="cpu", cache=PlanCache())
    cut = 0
    for name in sorted(REGISTRY):
        n = _smoke_size(name)
        for mode in ("best", "unfused"):
            cp = cc.compile(REGISTRY[name].script, REGISTRY[name].shapes(n),
                            mode=mode)
            g = trace(REGISTRY[name].script, REGISTRY[name].shapes(n))
            again = ExecutionPlan.from_json(cp.plan.to_json()).bind(g, V5E)
            for im, im2 in zip(cp.group_impls, again):
                a, b = GroupLayout(cp.graph, im), GroupLayout(g, im2)
                assert [ph.slices for ph in a.phases] == \
                    [ph.slices for ph in b.phases]
                src = group_source(cp.graph, im, "k1_x")
                assert src == group_source(g, im2, "k1_x")
                for line in src.splitlines():
                    if "gridDim" in line:
                        assert re.search(r"\+= (\(long long\))?gridDim\.x",
                                         line), line
                for ph in a.phases:
                    for r in ph.cut_axes:
                        c = a.coord[r]
                        assert f"s_{c} = rest % {ph.slices[r]}LL" in src
                        assert f"s_{c} * {ph.chunk[r]}LL;" in src
                cut += any(ph.S > 1 for ph in a.phases)
    assert cut >= 9


#: the groups that ran on one to 128 CTAs at the ``chip_smoke.py`` sizes:
#: (units, slices) per phase.  ATAX's ``gemv`` phase and the softmax's
#: ``div_by`` phase already have 512 units of 256 threads and stay whole
FEW_UNIT_GROUPS = {
    "LM_DECODE_ATTN/best/g2[attn_out]": ([2], [512]),
    "AXPYDOT/unfused/g2[sum_reduce]": ([1], [1024]),
    "AXPYDOT/best/g0[axmy+ew_mul+sum_reduce]": ([1], [1024]),
    "BiCGK/best/g0[gemv+gemtv]": ([1], [1024]),
    "SGEMVT/best/g0[gemtv]": ([128], [8]),
    "GEMVER/best/g0[rank2_update+gemtv]": ([128], [8]),
    "ATAX/best/g0[gemv+gemtv]": ([512, 128], [1, 8]),
    "LM_DECODE_ATTN/best/g1[scal+max_reduce+exp_sub+sum_reduce+div_by]":
        ([1, 1, 512], [1024, 1024, 1]),
    "LM_DECODE_ATTN/unfused/g2[max_reduce]": ([1], [1024]),
    "LM_DECODE_ATTN/unfused/g4[sum_reduce]": ([1], [1024]),
}


def _smoke_groups():
    cc = FusionCompiler(backend="cuda", device="cpu", cache=PlanCache())
    out = {}
    for name in sorted(REGISTRY):
        for mode in ("best", "unfused"):
            cp = cc.compile(REGISTRY[name].script,
                            REGISTRY[name].shapes(_smoke_size(name)),
                            mode=mode, label=f"{name}/{mode}")
            out.update((fn.name, fn.layout) for fn in cp.group_fns)
    return out


def test_few_unit_groups_reach_target_units_at_smoke_sizes():
    groups = _smoke_groups()
    for name, (units, slices) in FEW_UNIT_GROUPS.items():
        lay = groups[name]
        assert [ph.units for ph in lay.phases] == units, name
        assert [ph.S for ph in lay.phases] == slices, name
        for ph in lay.phases:
            assert ph.items >= TARGET_UNITS or ph.units >= SPLIT_BELOW, name
    # BiCGK's group reads each 128 x 128 tile of A once, for both sums
    bicgk = groups["BiCGK/best/g0[gemv+gemtv]"].phases[0]
    assert sorted(bicgk.slices.values()) == [32, 32]
    assert sorted(bicgk.chunk.values()) == [128, 128]
    # every group: a phase short of units is cut unless its walk is short
    for name, lay in groups.items():
        for ph in lay.phases:
            walk = math.prod(ph.span.values())
            if (ph.units < SPLIT_BELOW and walk >= SPLIT_MIN_POINTS
                    and ph.serial | ph.tiled):
                assert ph.items >= TARGET_UNITS, name


def test_small_groups_stay_whole():
    """What already filled the card, or costs less than a barrier, emits
    what it emitted before: map groups, the 512-unit ``gemv`` strips,
    LM_RMSNORM's and LM_BLOCK's groups (a 4096-element sum on one CTA)."""
    groups = _smoke_groups()
    for name, lay in groups.items():
        maps = all(not (ph.serial | ph.tiled) for ph in lay.phases)
        if maps or name.startswith(("LM_RMSNORM/", "LM_BLOCK/")) or \
                name.endswith("[gemv]") or "[gemv+gemv]" in name:
            assert [ph.S for ph in lay.phases] == [1] * lay.n_phases, name
            assert lay.cooperative == (lay.n_phases > 1), name
            assert not lay.cut_reds, name
    rms = groups["LM_RMSNORM/unfused/g1[sum_reduce]"].phases[0]
    assert (rms.units, rms.S, math.prod(rms.span.values())) == (1, 1, 4096)

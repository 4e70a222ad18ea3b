"""Kernel K1: one generated CUDA kernel per fused plan group.

Replaces the reference's generic fused-group Pallas kernel
(``repro/core/codegen.py:96`` ``_group_pallas_fn``).  Like the paper's
compiler, this is a source-to-source generator: it glues the per-point
CUDA C expressions of a group's elementaries (``Elementary.cuda``) into
one ``__global__`` function, emits one ``.cu`` per plan holding all its
groups, and builds it with ``nvcc`` for ``sm_90a`` (``kernels._build``).

Bound and design.  Every BLAS group moves O(1) bytes per flop, far below
the H100's ridge point (about 20 f32 flops per byte against 67 TFLOP/s
and 3.35 TB/s), so the bound is the bytes: each input read once, each
output written once.  The design keeps each group one pass over its
operands: map intermediates stay in registers, reductions combine in
registers and shared memory, and only group outputs (and the consumed
reductions of multi-phase groups) touch device memory.

The plan's ``order``, ``blocks`` and ``grid`` (``Impl``) are the
semantics; the TPU ran its grid in order on one core, a CUDA grid runs
in parallel and in no order, so the generator maps them as follows:

* **Work units.**  Per phase, the axes that the phase's ``acc`` outputs
  and consumed reductions reduce over (an innermost suffix of the order)
  are *serial*: a unit spans their whole range, which replaces the
  reference's revisited output block.  Axes that the phase's ``partial``
  outputs reduce over are *tiled*: a unit spans one plan tile, and the
  output keeps one partial per plan tile, combined after the kernel.
  All other axes are *free* — nothing reduces over them — and are
  re-tiled for the card (split or merged), which changes no result.
* **Slices.**  A phase whose units would leave the card idle (fewer than
  ``SPLIT_BELOW``) and whose unit walks at least ``SPLIT_MIN_POINTS``
  points has its serial and tiled spans cut into slices: a power of two
  of them in all, so that units x slices reaches ``TARGET_UNITS``, none
  under ``MIN_SLICE_POINTS`` points.  The count is fixed here, from the
  plan's shapes, order and tiles alone (never from the grid or the
  occupancy), so the order of every sum depends on the plan alone.  An
  *item* is one (unit, slice); CTAs take items grid-stride.  A group with
  both axes serial (BiCGK's ``gemv+gemtv``) gets 2-D slices, each reading
  its tile of A once and writing a row and a column partial, as hand K2
  does.
* **Combine.**  A reduction whose reduce axes were cut writes one partial
  per slice into a workspace; after a grid barrier every CTA folds them,
  one warp an output element: lane l takes slices l, l + 32, ... in
  order, then a fixed shuffle tree.  No float atomics, so the results are
  bitwise equal from run to run.  The barrier, and not a last-CTA
  combine with an arrival counter, because multi-phase groups already
  launch cooperatively; because the workspace can then come from
  ``torch.empty`` (a counter would have to stay zeroed between launches,
  which two streams could race on); and because every CTA shares the
  combine, where a last CTA would fold all of BiCGK's 2 x 4096 partial
  sums alone.  A split group is therefore one cooperative launch too.
* **Phases.**  A group that consumes a finished reduction
  (``call_phases`` > 1) is one cooperative launch with a grid barrier
  between phases; its grid is sized by occupancy so every CTA is
  co-resident.  Consumed reductions live in a device workspace the
  wrapper allocates, written (after the combine, if cut) before the
  barrier; map values are recomputed per phase.
* **Reductions inside an item.**  With 256 threads as 8 rows x 32 lanes
  (lanes along the contiguous axis), a reduction over the lane axis is a
  warp shuffle per sub-tile into a per-row shared accumulator; a
  reduction over the row axis accumulates per thread in shared memory
  and the 8 rows are combined at the end of the item; a full reduction
  accumulates in registers and ends in a block reduction.  The order is
  fixed, so results do not change from run to run.
* **No host synchronisation.**  Scalars — inputs and finished
  reductions alike — travel as one-element device tensors.
* **Batches.**  Every kernel takes ``nb`` requests laid out one after
  another in each buffer; its items are (request, unit, slice), taken
  grid-stride, and the slice counts stay those of one request, so a
  request's sums fold in the same order batched or alone.  Two
  instances are built: one request (``kBatched`` false: the offsets fold
  to 0) and a batch; a batched launch gives the bits of single ones.
* **Types and depth.**  Buffers are float32 or float16 (``__half``,
  converted on load, rounded once on store); every map and reduction
  computes in float32, and the slices' partials stay float32.  Past
  depth 2 the extra axes have a thread extent of 1.
* **Launch.**  A cooperative group launches through
  ``cudaLaunchKernelExC`` with ``cudaLaunchAttributeCooperative``, which
  CUDA stream capture records, so a plan's launches replay as one CUDA
  graph (``core.graphs``).

Beside the kernel: ``tiled_reference``, the plain torch version that
walks the plan's tiles with the reference's schedule, and ``LAUNCHES``,
the launch counter (``kernels._launch``, shared with the hand
kernels).  A ``GroupKernel`` takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
import math

import numpy as np
import torch

from ..kernels import _build, _launch
from .diagnostics import UnsupportedGroupError
from .fusion import call_phases, consumed_reductions
from .graph import Graph, Var
from .predictor import Impl, accumulable, reduce_roots_of

#: threads per CTA: 8 rows x 32 lanes for depth-2 groups, 256 lanes at depth 1
NT = 256
ROWS, LANES = 8, 32
#: work units wanted per phase before free axes stop being merged, and
#: the units x slices a cut phase is brought to (four per SM of an H100)
TARGET_UNITS = 4 * 132
#: a phase with fewer units than this is cut into slices: below two CTAs
#: an SM the card idles, while a 512-unit phase would buy no CTAs worth a
#: grid barrier and a combine
SPLIT_BELOW = TARGET_UNITS // 2
#: ... if one unit walks at least this many points; a shorter walk (such
#: as LM_RMSNORM's 4096-element sum, 2.2 us on one CTA) costs less than
#: the barrier
SPLIT_MIN_POINTS = 1 << 16
#: no slice holds fewer points than this: half a CTA's threads
MIN_SLICE_POINTS = NT // 2
#: merged free chunks stay within this many sub-tiles per axis
MAX_MERGE = 16
#: shared-memory ceiling for one CTA's accumulators (of 227 KB)
SMEM_LIMIT = 200 * 1024

_MONOID_CUDA = {"sum": "k1::Sum", "max": "k1::Max", "min": "k1::Min"}
#: element types the generated kernels load and store; every map and
#: reduction computes in float32 (float16 is converted on load and
#: rounded once on store)
CTYPES = {np.dtype(np.float32): "float", np.dtype(np.float16): "__half"}


# ---------------------------------------------------------------------------
# group analysis (shared by the generator and the plain version)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Red:
    """One reduction with a side effect in its phase."""

    call: object                  # CallNode
    rr: tuple[int, ...]           # reduce roots, fusion axis order
    consumed: bool                # carried to later phases in the workspace
    out_mode: str | None          # "acc" | "partial" | None (not an output)
    cut: int = 1                  # slices along rr: partials to combine
    size: int = 0                 # elements it writes (partial: lead x out)
    pt: int | None = None         # its partials' workspace, when cut > 1


@dataclasses.dataclass
class _Phase:
    reds: list[_Red]
    serial: set                   # reduce axes a unit spans whole
    tiled: set                    # reduce axes a unit spans a plan tile of
    span: dict                    # root -> a unit's extent along it
    unit_axes: tuple              # non-serial roots, plan order
    units: int
    slices: dict                  # serial or tiled root -> slices of a span
    chunk: dict                   # root -> an item's extent along it

    @property
    def S(self) -> int:
        return math.prod(self.slices.values())

    @property
    def items(self) -> int:
        return self.units * self.S

    @property
    def cut_axes(self) -> list:
        """The axes cut into slices, in the order the kernel decomposes
        an item index (fastest first)."""
        return sorted((r for r, s in self.slices.items() if s > 1))


def _group_names(f) -> str:
    return "+".join(c.elem.name for c in f.calls)


class GroupLayout:
    """What K1 needs to know about one group: phases, output modes,
    work units.  Raises ``UnsupportedGroupError`` (RPL214) for a group
    the backend cannot emit."""

    def __init__(self, g: Graph, impl: Impl):
        f = impl.fusion
        self.g, self.impl, self.f = g, impl, f
        names = _group_names(f)
        self.names = names
        loc = f"plan.group[{names}]"
        self.sizes = dict(zip(f.axis_roots, f.axis_sizes))
        self.order = impl.order
        self.blk = dict(zip(impl.order, impl.blocks))
        self.grid = dict(zip(impl.order, impl.grid))
        self.phase_of, self.n_phases = call_phases(f, g)
        self.consumed = {c.idx for c in consumed_reductions(f, g)}
        self.outputs = list(f.outputs)

        for v in list(f.external_inputs) + list(f.outputs):
            if np.dtype(v.dtype) not in CTYPES:
                raise UnsupportedGroupError.single(
                    "RPL214", loc, f"cuda backend cannot emit group "
                    f"[{names}]: {v.name} has dtype {np.dtype(v.dtype)}, "
                    f"the generated kernels take float32 and float16")
        for c in consumed_reductions(f, g):
            if not accumulable(c.out, f, g, self.order):
                raise UnsupportedGroupError.single(
                    "RPL214", loc,
                    f"cuda backend cannot emit group [{names}]: reduction "
                    f"'{c.elem.name}' is consumed in-kernel but its reduce "
                    f"axes are not the innermost suffix of grid order "
                    f"{self.order}, so no phase can finish it before its "
                    f"consumers run; use an accumulable order or split "
                    f"the group")
        resolvable = set(f.external_inputs)
        for c in f.calls:
            bad = sorted({a.producer.elem.name for a in c.args
                          if a not in resolvable and a.producer is not None})
            if bad:
                raise UnsupportedGroupError.single(
                    "RPL214", loc, f"cuda backend cannot emit group "
                    f"[{names}]: call '{c.elem.name}' consumes the output "
                    f"of {bad}, which never becomes visible inside the "
                    f"kernel")
            if not c.elem.is_reduction or c.idx in self.consumed:
                resolvable.add(c.out)

        # thread extent per axis; the lane axis is the contiguous one.
        # Past depth 2 the lane and row axes are the last two of the
        # first highest-rank operand, and every other ("extra") axis
        # has extent 1: its free tiles become items, its serial range a
        # loop inside the item
        self.extras: tuple = ()
        if f.depth >= 2:
            vs = list(f.external_inputs) + list(f.outputs) + list(
                f.internal_vars)
            rank = 2 if f.depth == 2 else max(len(v.shape) for v in vs)
            mats = [v for v in vs if len(v.shape) == rank]
            if f.depth == 2:
                self.lane = (g.axis_root(mats[0].axis_ids[-1]) if mats
                             else f.axis_roots[-1])
                self.row = next(r for r in f.axis_roots if r != self.lane)
            else:
                self.lane = g.axis_root(mats[0].axis_ids[-1])
                self.row = g.axis_root(mats[0].axis_ids[-2])
                self.extras = tuple(r for r in f.axis_roots
                                    if r not in (self.lane, self.row))
            self.coord = {self.row: "ci", self.lane: "cj"}
            self.extent = {self.row: ROWS, self.lane: LANES}
            for k, r in enumerate(self.extras):
                self.coord[r], self.extent[r] = f"ck{k}", 1
        else:
            self.lane, self.row = f.axis_roots[0], None
            self.coord = {self.lane: "ca"}
            self.extent = {self.lane: NT}

        self.out_mode = {}
        for v in self.outputs:
            if v.producer.elem.is_reduction:
                self.out_mode[v] = ("acc" if accumulable(v, f, g, self.order)
                                    else "partial")
            else:
                self.out_mode[v] = "map"
        self.phases = [self._phase(p, loc) for p in range(self.n_phases)]
        for k, r in enumerate(self.cut_reds):
            r.pt = k

    def roots_of(self, v: Var) -> tuple[int, ...]:
        return tuple(self.g.axis_root(a) for a in v.axis_ids)

    def lead_shape(self, v: Var) -> tuple[int, ...]:
        """Leading partial axes of a ``partial`` output: one per plan
        tile along its reduce axes (the reference's ``lead``)."""
        return tuple(self.grid[r] for r in reduce_roots_of(v, self.f, self.g))

    def _phase(self, p: int, loc: str) -> _Phase:
        f, g = self.f, self.g
        reds = []
        for c in f.calls:
            if not c.elem.is_reduction or self.phase_of[c.idx] != p:
                continue
            consumed = c.idx in self.consumed
            mode = self.out_mode.get(c.out)
            if consumed or mode is not None:
                reds.append(_Red(c, reduce_roots_of(c.out, f, g), consumed,
                                 mode))
        serial, tiled = set(), set()
        for r in reds:
            if r.consumed or r.out_mode == "acc":
                serial |= set(r.rr)
        for r in reds:
            if r.out_mode == "partial" and not r.consumed:
                if set(r.rr) & serial:
                    raise UnsupportedGroupError.single(
                        "RPL214", loc, f"cuda backend cannot emit group "
                        f"[{self.names}]: partial output "
                        f"{r.call.out.name} reduces over an axis that "
                        f"another reduction of its phase walks serially")
                tiled |= set(r.rr)
        walked = serial | tiled
        for r in reds:
            kept = set(f.axis_roots) - set(r.rr)
            if self.extras and (kept & set(self.extras) & walked
                                or {self.row, self.lane} <= kept):
                raise UnsupportedGroupError.single(
                    "RPL214", loc, f"cuda backend cannot emit group "
                    f"[{self.names}]: reduction {r.call.out.name} keeps "
                    f"an axis that its phase walks, or reduces over extra "
                    f"axes alone")
        span = {}
        for r in self.order:
            if r in serial:
                span[r] = self.sizes[r]
            elif r in tiled:
                span[r] = self.blk[r]
            else:
                span[r] = min(self.extent[r], self.sizes[r])
        unit_axes = tuple(r for r in self.order if r not in serial)

        def units_of(sp):
            return math.prod(-(-self.sizes[r] // sp[r]) for r in unit_axes)

        # merge free tiles while enough units remain to fill the card
        free = [r for r in (self.lane, self.row) if r is not None
                and r not in serial and r not in tiled]
        for r in free:
            while (span[r] < self.sizes[r]
                   and span[r] * 2 <= self.extent[r] * MAX_MERGE
                   and units_of({**span, r: span[r] * 2}) >= TARGET_UNITS):
                span[r] *= 2
        units = units_of(span)
        slices, chunk = self._slices(units, span, serial | tiled)
        for r in reds:
            r.cut = math.prod(slices[a] for a in r.rr)
            r.size = math.prod(r.call.out.shape) * (
                math.prod(self.lead_shape(r.call.out))
                if r.out_mode == "partial" else 1)
        return _Phase(reds=reds, serial=serial, tiled=tiled, span=span,
                      unit_axes=unit_axes, units=units, slices=slices,
                      chunk=chunk)

    def _slices(self, units: int, span: dict, cut: set):
        """(slices, chunk): how many slices each serial or tiled span is
        cut into, and the extent of an item along every axis.  Cuts the
        longest slice in two (rows first on a tie) until units x slices
        reaches ``TARGET_UNITS``; a slice stays a multiple of its axis's
        sub-tile (``LANES`` along the contiguous axis, so a warp's loads
        stay aligned, ``ROWS`` along the other) and holds at least
        ``MIN_SLICE_POINTS`` points.  Depends on the plan alone."""
        slices, chunk = {r: 1 for r in cut}, dict(span)
        if units >= SPLIT_BELOW or math.prod(span.values()) < SPLIT_MIN_POINTS:
            return slices, chunk
        while units * math.prod(slices.values()) < TARGET_UNITS:
            best = None
            for r in sorted(cut, key=self.order.index):
                step = LANES if r == self.lane else ROWS
                n = -(-span[r] // (2 * slices[r]))
                n = -(-n // step) * step
                if (n < chunk[r] and math.prod({**chunk, r: n}.values())
                        >= MIN_SLICE_POINTS
                        and (best is None or (chunk[r], r == self.row)
                             > (chunk[best[0]], best[0] == self.row))):
                    best = (r, n)
            if best is None:
                break
            r, n = best
            slices[r] *= 2
            chunk[r] = n
        return slices, chunk

    def axis_ranges(self, p: int, r: int) -> list[tuple[int, int]]:
        """The [c0, c1) of axis ``r`` for each of its (tile, slice)
        indices in phase ``p``, by the arithmetic the kernel does (empty
        where a rounded slice runs past its span's end)."""
        ph, n = self.phases[p], self.sizes[r]
        s, ch, sp = ph.slices.get(r, 1), ph.chunk[r], ph.span[r]
        tiles = 1 if r in ph.serial else -(-n // sp)
        out = []
        for t in range(tiles):
            end = min(t * sp + sp, n)
            for k in range(s):
                c0 = t * sp + k * ch
                out.append((c0, min(c0 + ch, end)))
        return out

    @property
    def items(self) -> int:
        """CTAs the widest phase can use: units x slices."""
        return max(ph.items for ph in self.phases)

    @property
    def cooperative(self) -> bool:
        """Launched cooperatively: a grid barrier between phases or
        before a combine."""
        return self.n_phases > 1 or any(ph.S > 1 for ph in self.phases)

    @property
    def cut_reds(self) -> list[_Red]:
        return [r for ph in self.phases for r in ph.reds if r.cut > 1]

    def workspace(self) -> list[tuple[int, ...]]:
        """Shapes of the kernel's workspace buffers: each consumed
        reduction, then each cut reduction's partials (slices x
        elements)."""
        return ([tuple(c.out.shape) for c in self.f.calls
                 if c.idx in self.consumed]
                + [(r.cut, r.size) for r in self.cut_reds])

    def workspace_dtypes(self) -> list[np.dtype]:
        """Their dtypes: a consumed reduction's own (as the reference's
        scratch), float32 for the slices' partials."""
        return ([np.dtype(c.out.dtype) for c in self.f.calls
                 if c.idx in self.consumed]
                + [np.dtype(np.float32)] * len(self.cut_reds))

    def raw_shape(self, v: Var) -> tuple[int, ...]:
        """Shape the kernel writes output ``v`` in: ``partial`` outputs
        keep one partial per plan tile along their reduce axes."""
        lead = self.lead_shape(v) if self.out_mode[v] == "partial" else ()
        return lead + tuple(v.shape)

    def red_kind(self, red: _Red) -> str:
        kept = set(self.f.axis_roots) - set(red.rr) - set(self.extras)
        if not kept:
            return "scalar"
        return "rowsum" if kept == {self.row} else "colsum"


# ---------------------------------------------------------------------------
# source generation
# ---------------------------------------------------------------------------

def _offset(lay: GroupLayout, v: Var, coord: dict) -> str:
    """Row-major element offset of ``v`` at the given coordinates."""
    terms, stride = [], 1
    for r, n in zip(reversed(lay.roots_of(v)), reversed(v.shape)):
        terms.append(coord[r] if stride == 1 else f"{coord[r]} * {stride}LL")
        stride *= n
    return " + ".join(reversed(terms)) if terms else "0"


def _ctype(v: Var) -> str:
    return CTYPES[np.dtype(v.dtype)]


class _Emitter:
    """The source of one group's kernel.  Every buffer is batched: the
    kernel takes ``nb`` requests laid out one after another in each
    buffer, and an item is one (request, unit, slice); a request's
    items do exactly what a one-request launch does, so a batched
    launch gives the same bits as ``nb`` single ones."""

    def __init__(self, lay: GroupLayout, name: str):
        self.lay, self.name = lay, name
        f = lay.f
        self.ins = {v: k for k, v in enumerate(f.external_inputs)}
        self.outs = {v: k for k, v in enumerate(lay.outputs)}
        self.ws = {c.idx: k for k, c in enumerate(
            c for c in f.calls if c.idx in lay.consumed)}
        self.ws_var = {self.ws[c.idx]: c.out for c in f.calls
                       if c.idx in lay.consumed}
        self.lines: list[str] = []
        self.smem_floats = 0

    def emit(self, s: str = "", ind: int = 0):
        self.lines.append("  " * ind + s if s else "")

    # -- buffers: (name, element type, elements a request, const) ------------
    def buffers(self):
        lay = self.lay
        out = [(f"in{k}", _ctype(v), math.prod(v.shape), True)
               for v, k in self.ins.items()]
        out += [(f"out{k}", _ctype(v), math.prod(lay.raw_shape(v)), False)
                for v, k in self.outs.items()]
        out += [(f"ws{k}", _ctype(v), math.prod(v.shape), False)
                for k, v in self.ws_var.items()]
        out += [(f"pt{r.pt}", "float", r.cut * r.size, False)
                for r in lay.cut_reds]
        return out

    def bind_batch(self, ind: int, names=None):
        """The offset of request ``bi``'s part of every buffer.  Every
        access indexes the kernel's ``__restrict__`` parameter itself
        (``at``): a local pointer derived from it would lose the
        no-alias promise, and with it the read-only loads."""
        for nm, _, n, _ in self.buffers():
            if names is None or nm in names:
                self.emit(f"const long long o_{nm} = bi * {n}LL;", ind)

    @staticmethod
    def at(nm: str, index: str) -> str:
        """Element ``index`` of buffer ``nm`` for request ``bi``."""
        return f"g_{nm}[o_{nm} + {index}]"

    def store(self, v: Var, dst: str, val: str) -> str:
        return f"{dst} = k1::st<{_ctype(v)}>({val});"

    # -- per-point value of an argument --------------------------------------
    def arg(self, a: Var) -> str:
        if a in self.ins:
            k = self.ins[a]
            return f"s{k}" if a.shape == () else f"x{k}"
        return f"v{a.producer.idx}"

    def needed(self, p: int, ph: _Phase):
        """Calls evaluated per point in phase ``p``: the phase's side
        effects and, transitively, the maps they read; finished consumed
        reductions of earlier phases are read from the workspace."""
        lay = self.lay
        need, stack = set(), []
        for c in lay.f.calls:
            if lay.phase_of[c.idx] != p:
                continue
            if (c.elem.is_reduction and any(r.call is c for r in ph.reds)) or \
                    (not c.elem.is_reduction and c.out in self.outs):
                stack.append(c)
        while stack:
            c = stack.pop()
            if c.idx in need:
                continue
            need.add(c.idx)
            if c.elem.is_reduction and lay.phase_of[c.idx] < p:
                continue                      # workspace read, no args
            for a in c.args:
                if a.producer is not None and a not in self.ins:
                    stack.append(a.producer)
        return [c for c in lay.f.calls if c.idx in need]

    # -- one phase -------------------------------------------------------------
    def phase(self, p: int, ph: _Phase):
        lay, e = self.lay, self.emit
        calls = self.needed(p, ph)
        kinds = {id(r): lay.red_kind(r) for r in ph.reds}

        # shared-memory accumulators
        base, acc_at = 0, {}
        for r in ph.reds:
            kind = kinds[id(r)]
            if kind == "rowsum":
                acc_at[id(r)] = (base, ph.chunk[lay.row])
                base += ph.chunk[lay.row]
            elif kind == "colsum":
                acc_at[id(r)] = (base, ph.chunk[lay.lane])
                base += ROWS * ph.chunk[lay.lane]
        red_at = base
        if any(kinds[id(r)] == "scalar" for r in ph.reds):
            base += NT // 32
        self.smem_floats = max(self.smem_floats, base)

        e(f"// phase {p}: {ph.units} work unit(s) x {ph.S} slice(s); serial "
          f"axes {sorted(lay.f.axis_roots.index(r) for r in ph.serial)}", 1)
        e(f"for (long long u = blockIdx.x; u < (kBatched ? nb : 1LL) * "
          f"{ph.items}LL; u += gridDim.x) {{", 1)
        e(f"const long long bi = kBatched ? u / {ph.items}LL : 0LL;", 2)
        e(f"long long rest = kBatched ? u % {ph.items}LL : u;", 2)
        self.bind_batch(2)
        for v, k in self.ins.items():
            if v.shape == ():
                e(f"const float s{k} = k1::ld({self.at(f'in{k}', '0')});", 2)
        for r in ph.cut_axes:                 # slices vary fastest
            s = ph.slices[r]
            e(f"const long long s_{lay.coord[r]} = rest % {s}LL; "
              f"rest /= {s}LL;", 2)
        # the same arithmetic as GroupLayout.axis_ranges
        for r in reversed(ph.unit_axes):
            n, sp, ch = lay.sizes[r], ph.span[r], ph.chunk[r]
            cnt = -(-n // sp)
            c = lay.coord[r]
            e(f"const long long t_{c} = rest % {cnt}LL; rest /= {cnt}LL;", 2)
            if ph.slices.get(r, 1) > 1:       # a plan tile cut into slices
                e(f"const long long {c}0 = t_{c} * {sp}LL + s_{c} * {ch}LL;",
                  2)
                e(f"const long long {c}1 = min({c}0 + {ch}LL, "
                  f"min(t_{c} * {sp}LL + {sp}LL, {n}LL));", 2)
            else:
                e(f"const long long {c}0 = t_{c} * {sp}LL;", 2)
                e(f"const long long {c}1 = min({c}0 + {sp}LL, {n}LL);", 2)
        for r in sorted(ph.serial, key=lay.order.index):
            n, c = lay.sizes[r], lay.coord[r]
            if ph.slices[r] > 1:
                ch = ph.chunk[r]
                e(f"const long long {c}0 = s_{c} * {ch}LL;", 2)
                e(f"const long long {c}1 = min({c}0 + {ch}LL, {n}LL);", 2)
            else:
                e(f"const long long {c}0 = 0, {c}1 = {n}LL;", 2)
        for r in ph.reds:
            kind, mon = kinds[id(r)], _MONOID_CUDA[r.call.elem.monoid.value]
            k = r.call.idx
            if kind == "scalar":
                e(f"float reg{k} = {mon}::id();", 2)
            else:
                off, n = acc_at[id(r)]
                size = n if kind == "rowsum" else ROWS * n
                e(f"for (int k = tid; k < {size}; k += {NT}) "
                  f"smem[{off} + k] = {mon}::id();", 2)
        e("__syncthreads();", 2)

        # the sub-tile loops, in plan order
        if lay.row is not None:
            ind = 2
            for r in lay.order:
                c = lay.coord[r]
                if r == lay.row:
                    e(f"for (long long rb = ci0; rb < ci1; rb += {ROWS}) {{",
                      ind)
                elif r == lay.lane:
                    e(f"for (long long cb = cj0; cb < cj1; cb += {LANES}) {{",
                      ind)
                else:                         # an extra axis, extent 1
                    e(f"for (long long {c} = {c}0; {c} < {c}1; ++{c}) {{",
                      ind)
                ind += 1
            e("const long long ci = rb + ti, cj = cb + tj;", ind)
            e("const bool ok = ci < ci1 && cj < cj1;", ind)
        else:
            e("for (long long ab = ca0; ab < ca1; ab += 256) {", 2)
            ind = 3
            e("const long long ca = ab + tid;", ind)
            e("const bool ok = ca < ca1;", ind)
        self.body(p, ph, calls, kinds, acc_at, ind)
        for k in range(ind - 2):
            e("}", ind - 1 - k)
        e("__syncthreads();", 2)
        for r in lay.extras if ph.reds else ():   # free: one index an item
            if r not in ph.serial and r not in ph.tiled:
                e(f"const long long {lay.coord[r]} = {lay.coord[r]}0;", 2)
        for r in ph.reds:
            self.finalize(r, kinds[id(r)], acc_at, red_at, ph)
        e("__syncthreads();", 2)
        e("}", 1)
        self.combine(p, ph)

    def combine(self, p: int, ph: _Phase):
        """After a grid barrier, fold the slices' partials of every cut
        reduction of the phase: one warp an output element, lane l taking
        slices l, l + 32, ... in order, then the shuffle tree."""
        e = self.emit
        cut = [r for r in ph.reds if r.cut > 1]
        if not cut:
            return
        warps = NT // 32
        total = sum(r.size for r in cut)
        e("k1::grid_barrier();", 1)
        e(f"// phase {p}: fold the partials of {len(cut)} cut reduction(s)", 1)
        e(f"for (long long w = (long long)blockIdx.x * {warps} + (tid >> 5); "
          f"w < (kBatched ? nb : 1LL) * {total}LL; "
          f"w += (long long)gridDim.x * {warps}) {{", 1)
        e("const int ln = tid & 31;", 2)
        e(f"const long long bi = kBatched ? w / {total}LL : 0LL;", 2)
        e(f"const long long wi = kBatched ? w % {total}LL : w;", 2)
        names = ({f"pt{r.pt}" for r in cut}
                 | {f"ws{self.ws[r.call.idx]}" for r in cut if r.consumed}
                 | {f"out{self.outs[r.call.out]}" for r in cut
                    if r.out_mode is not None})
        self.bind_batch(2, names)
        base = 0
        for k, r in enumerate(cut):
            mon = _MONOID_CUDA[r.call.elem.monoid.value]
            e(f"{'if' if k == 0 else '} else if'} (wi < {base + r.size}LL) {{",
              2)
            e(f"const long long e = wi - {base}LL;", 3)
            e(f"float val = {mon}::id();", 3)
            e(f"for (int q = ln; q < {r.cut}; q += 32) val = {mon}::op(val, "
              f"{self.at(f'pt{r.pt}', f'q * {r.size}LL + e')});", 3)
            e(f"val = k1::warp_reduce<{mon}>(val);", 3)
            e("if (ln == 0) {", 3)
            if r.consumed:
                e(self.store(r.call.out,
                             self.at(f"ws{self.ws[r.call.idx]}", "e"), "val"),
                  4)
            if r.out_mode is not None:
                e(self.store(r.call.out,
                             self.at(f"out{self.outs[r.call.out]}", "e"),
                             "val"), 4)
            e("}", 3)
            base += r.size
        e("}", 2)
        e("}", 1)

    def body(self, p, ph, calls, kinds, acc_at, ind):
        lay, e = self.lay, self.emit
        reds = {r.call.idx: r for r in ph.reds}
        for c in calls:
            if c.elem.is_reduction and c.idx in reds:
                mon = _MONOID_CUDA[c.elem.monoid.value]
                e(f"float p{c.idx} = {mon}::id();", ind)
            else:
                e(f"float v{c.idx} = 0.0f;", ind)
        e("if (ok) {", ind)
        loaded = set()
        for c in calls:
            if c.elem.is_reduction and lay.phase_of[c.idx] < p:
                w = self.ws[c.idx]
                e(f"v{c.idx} = k1::ld("
                  f"{self.at(f'ws{w}', _offset(lay, c.out, lay.coord))});",
                  ind + 1)
                continue
            for a in c.args:
                if a in self.ins and a.shape != () and a not in loaded:
                    loaded.add(a)
                    k = self.ins[a]
                    e(f"const float x{k} = k1::ld("
                      f"{self.at(f'in{k}', _offset(lay, a, lay.coord))});",
                      ind + 1)
            expr = c.elem.cuda_expr(*(self.arg(a) for a in c.args))
            if c.elem.is_reduction:
                e(f"p{c.idx} = {expr};", ind + 1)
            else:
                e(f"v{c.idx} = {expr};", ind + 1)
                if c.out in self.outs and lay.phase_of[c.idx] == p:
                    o = self.outs[c.out]
                    e(self.store(c.out, self.at(
                        f"out{o}", _offset(lay, c.out, lay.coord)),
                        f"v{c.idx}"), ind + 1)
        e("}", ind)
        for r in ph.reds:
            kind, k = kinds[id(r)], r.call.idx
            mon = _MONOID_CUDA[r.call.elem.monoid.value]
            if kind == "scalar":
                e(f"reg{k} = {mon}::op(reg{k}, p{k});", ind)
            elif kind == "rowsum":
                off, _ = acc_at[id(r)]
                e(f"{{ const float w = k1::warp_reduce<{mon}>(p{k});", ind)
                e(f"  if (tj == 0 && ci < ci1) smem[{off} + (ci - ci0)] = "
                  f"{mon}::op(smem[{off} + (ci - ci0)], w); }}", ind)
            else:
                off, n = acc_at[id(r)]
                at = f"smem[{off} + ti * {n} + (cj - cj0)]"
                e(f"if (ok) {at} = {mon}::op({at}, p{k});", ind)

    def finalize(self, r: _Red, kind, acc_at, red_at, ph):
        lay, e = self.lay, self.emit
        v, mon = r.call.out, _MONOID_CUDA[r.call.elem.monoid.value]
        k = r.call.idx

        def writes(ind):
            off = _offset(lay, v, lay.coord)
            if r.out_mode == "partial":       # behind one lead per plan tile
                lead, stride = [], 1
                for rt in reversed(r.rr):
                    lead.append(f"t_{lay.coord[rt]} * {stride}LL")
                    stride *= lay.grid[rt]
                off = (f"({' + '.join(lead)}) * {math.prod(v.shape)}LL + "
                       f"{off}")
            if r.cut > 1:                     # one partial per slice
                q, stride = [], 1
                for rt in reversed(r.rr):
                    if ph.slices[rt] > 1:
                        q.append(f"s_{lay.coord[rt]} * {stride}LL")
                        stride *= ph.slices[rt]
                idx = f"({' + '.join(q)}) * {r.size}LL + {off}"
                e(f"{self.at(f'pt{r.pt}', idx)} = val;", ind)
                return
            if r.consumed:
                e(self.store(v, self.at(f"ws{self.ws[k]}", off), "val"), ind)
            if r.out_mode is not None:
                e(self.store(v, self.at(f"out{self.outs[v]}", off), "val"),
                  ind)

        if kind == "scalar":
            e(f"{{ const float val = k1::block_reduce<{mon}, {NT}>("
              f"reg{k}, smem + {red_at});", 2)
            e("  if (tid == 0) {", 2)
            writes(4)
            e("  } }", 2)
        elif kind == "rowsum":
            off, _ = acc_at[id(r)]
            e(f"for (long long k = tid; k < ci1 - ci0; k += {NT}) {{", 2)
            e(f"const float val = smem[{off} + k]; const long long ci = ci0 + k;",
              3)
            writes(3)
            e("}", 2)
        else:
            off, n = acc_at[id(r)]
            e(f"for (long long k = tid; k < cj1 - cj0; k += {NT}) {{", 2)
            e(f"float val = {mon}::id();", 3)
            e(f"for (int t = 0; t < {ROWS}; ++t) "
              f"val = {mon}::op(val, smem[{off} + t * {n} + k]);", 3)
            e("const long long cj = cj0 + k;", 3)
            writes(3)
            e("}", 2)

    # -- the kernel and its launcher ---------------------------------------------
    def kernel_body(self) -> "_Emitter":
        """The kernel's body: every phase, grid barriers between them."""
        body = _Emitter(self.lay, self.name)
        for p, ph in enumerate(self.lay.phases):
            if p:
                body.emit("k1::grid_barrier();", 1)
            body.phase(p, ph)
        return body

    def source(self) -> str:
        lay, e = self.lay, self.emit
        bufs = self.buffers()
        params = [f"{'const ' if const else ''}{ct}* __restrict__ g_{nm}"
                  for nm, ct, _, const in bufs] + ["const long long nb"]
        body = self.kernel_body()
        smem = body.smem_floats * 4
        if smem > SMEM_LIMIT:
            raise UnsupportedGroupError.single(
                "RPL215", f"plan.group[{lay.names}]",
                smem_message(lay, smem, SMEM_LIMIT))
        e(f"// group [{lay.names}]: order {self.order_desc()}, blocks "
          f"{lay.impl.blocks}, grid {lay.impl.grid}, {lay.n_phases} phase(s), "
          f"slices {[ph.S for ph in lay.phases]}")
        # two instances: kBatched = false for one request, whose offsets
        # fold to 0 (no registers spent on them), and true for a batch;
        # a request's items run the same code in both, so a batched
        # launch gives the bits of single ones
        e("template <bool kBatched>")
        e(f"__global__ void __launch_bounds__({NT}) {self.name}(")
        e("    " + ",\n    ".join(params) + ") {")
        e("extern __shared__ float smem[];", 1)
        e("const int tid = threadIdx.x;", 1)
        if lay.row is not None:
            e("const int ti = tid >> 5, tj = tid & 31;", 1)
        self.lines += body.lines
        e("}")
        e()
        n = len(bufs)
        args = ", ".join(f"void* p{k}" for k in range(n))
        e(f"extern \"C\" int {self.name}_launch({args}, long long nb, "
          f"void* stream) {{")
        e("static long long caps[2] = {0, 0};", 1)
        e(f"const int smem = {smem};", 1)
        e("if (nb < 1) return (int)cudaErrorInvalidValue;", 1)
        e("const bool batched = nb > 1;", 1)
        e(f"const void* kernel = batched ? (const void*){self.name}<true> : "
          f"(const void*){self.name}<false>;", 1)
        e("long long& cap = caps[batched];", 1)
        e("if (cap == 0) {", 1)
        e("cudaError_t err;", 2)
        e("if (smem > 48 * 1024) {", 2)
        e("err = cudaFuncSetAttribute(kernel, "
          "cudaFuncAttributeMaxDynamicSharedMemorySize, smem);", 3)
        e("if (err != cudaSuccess) return (int)err;", 3)
        e("}", 2)
        e("int dev = 0, sms = 0, per_sm = 0;", 2)
        e("if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;", 2)
        e("if ((err = cudaDeviceGetAttribute(&sms, "
          "cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;",
          2)
        e(f"if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, "
          f"kernel, {NT}, smem)) != cudaSuccess) return (int)err;", 2)
        e("if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;", 2)
        e("cap = (long long)per_sm * sms;", 2)
        e("}", 1)
        e(f"const long long items = nb * {lay.items}LL;", 1)
        e("const int grid = (int)(items < cap ? items : cap);", 1)
        names = []
        for k, (nm, ct, _, const) in enumerate(bufs):
            q = "const " if const else ""
            e(f"{q}{ct}* g_{nm} = ({q}{ct}*)p{k};", 1)
            names.append(f"g_{nm}")
        names.append("nb")
        e("cudaStream_t s = (cudaStream_t)stream;", 1)
        if lay.cooperative:
            # cudaLaunchKernelExC with the cooperative attribute: every CTA
            # co-resident (the grid is capped by occupancy above), and a
            # launch that stream capture records as one graph node
            e("void* args[] = {" + ", ".join(f"(void*)&{a}" for a in names)
              + "};", 1)
            e("cudaLaunchAttribute attr[1];", 1)
            e("attr[0].id = cudaLaunchAttributeCooperative;", 1)
            e("attr[0].val.cooperative = 1;", 1)
            e("// grid, block, dynamic shared memory, stream, attributes", 1)
            e(f"cudaLaunchConfig_t cfg = {{dim3(grid), dim3({NT}), "
              f"(size_t)smem, s, attr, 1}};", 1)
            e("cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);", 1)
            e("if (err != cudaSuccess) return (int)err;", 1)
        else:
            call = f"<<<grid, {NT}, smem, s>>>({', '.join(names)});"
            e(f"if (batched) {self.name}<true>{call}", 1)
            e(f"else {self.name}<false>{call}", 1)
        e("return (int)cudaGetLastError();", 1)
        e("}")
        return "\n".join(self.lines) + "\n"

    def order_desc(self) -> str:
        return str(tuple(self.lay.f.axis_roots.index(r) for r in self.lay.order))


def smem_bytes(lay: GroupLayout) -> int:
    """Shared memory one CTA of the group's kernel takes for its
    accumulators, as the generator lays them out."""
    return _Emitter(lay, kernel_name(0)).kernel_body().smem_floats * 4


def smem_message(lay: GroupLayout, smem: int, budget: int) -> str:
    return (f"cuda backend cannot emit group [{lay.names}]: its "
            f"accumulators need {smem} bytes of shared memory, more "
            f"than {budget}")


def group_source(g: Graph, impl: Impl, name: str) -> str:
    """CUDA source of one group's kernel ``name`` and its C launcher
    ``name_launch(pointers..., stream) -> cudaError_t``."""
    return _Emitter(GroupLayout(g, impl), name).source()


def kernel_name(gi: int) -> str:
    return f"k1_g{gi}"


def plan_source(g: Graph, impls) -> str:
    """One translation unit holding every group of a plan."""
    parts = ["// Generated by repro_torch.core.cuda_codegen (kernel K1).",
             '#include "fused_group.cuh"', ""]
    for gi, im in enumerate(impls):
        parts.append(group_source(g, im, kernel_name(gi)))
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# the plain tiled version
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64,
                 np.dtype(np.float16): torch.float16,
                 np.dtype(np.int32): torch.int32}


def torch_dtype(dtype) -> torch.dtype:
    return _TORCH_DTYPES[np.dtype(dtype)]


def _index(lay_roots, sl: dict):
    idx = tuple(sl.get(r, slice(None)) for r in lay_roots)
    return idx if idx else ...


def tiled_reference(g: Graph, impl: Impl, *ext_vals: torch.Tensor):
    """Plain torch version of K1 for one group, on the plan's schedule.

    Walks the tiles of the axes the phase's reductions reduce over in
    plan order, the other axes whole: ``acc`` outputs start at the first
    tile along their reduce axes and combine in tile order, ``partial``
    outputs write one partial per plan tile (combined at the end, as the
    reference does), consumed reductions accumulate into a full-size
    scratch read back by later phases, and phases run in turn.  Accepts
    any dtype (it is the reference the kernel is held against).  A
    16-bit group computes as the kernel does: in float32, rounded to the
    group's dtype where the kernel stores (outputs, each plan tile's
    ``partial``, consumed reductions before a later phase reads them)."""
    f = impl.fusion
    phase_of, n_phases = call_phases(f, g)
    consumed = {c.idx for c in consumed_reductions(f, g)}
    sizes = dict(zip(f.axis_roots, f.axis_sizes))
    blk = dict(zip(impl.order, impl.blocks))
    grid = dict(zip(impl.order, impl.grid))
    dev = ext_vals[0].device if ext_vals else torch.device("cpu")

    def roots(v):
        return tuple(g.axis_root(a) for a in v.axis_ids)

    def wide(dt):
        """The dtype the kernel computes ``dt`` in."""
        return torch.float32 if dt in (torch.float16, torch.bfloat16) else dt

    ext = {a: x.to(wide(x.dtype)) for a, x in zip(f.external_inputs, ext_vals)}
    mode, out = {}, {}
    for v in f.outputs:
        dt = torch_dtype(v.dtype)
        if not v.producer.elem.is_reduction:
            mode[v] = "map"
            out[v] = torch.empty(v.shape, dtype=wide(dt), device=dev)
        elif accumulable(v, f, g, impl.order):
            mode[v] = "acc"
            out[v] = torch.empty(v.shape, dtype=wide(dt), device=dev)
        else:
            mode[v] = "partial"
            lead = tuple(grid[r] for r in reduce_roots_of(v, f, g))
            out[v] = torch.empty(lead + v.shape, dtype=dt, device=dev)
    scratch = {c.idx: torch.empty(c.out.shape,
                                  dtype=wide(torch_dtype(c.out.dtype)),
                                  device=dev)
               for c in f.calls if c.idx in consumed}

    for p in range(n_phases):
        reds = [c for c in f.calls if c.elem.is_reduction
                and phase_of[c.idx] == p
                and (c.idx in consumed or c.out in mode)]
        loop_set = {r for c in reds for r in reduce_roots_of(c.out, f, g)}
        loop_axes = [r for r in impl.order if r in loop_set]
        for tiles in itertools.product(*(range(grid[r]) for r in loop_axes)):
            tile = dict(zip(loop_axes, tiles))
            sl = {r: slice(t * blk[r], min((t + 1) * blk[r], sizes[r]))
                  for r, t in tile.items()}
            env = {}

            def val(a):
                if a in ext:
                    x = ext[a]
                    return x if a.shape == () else x[_index(roots(a), sl)]
                return env[a]

            for c in f.calls:
                if phase_of[c.idx] > p:
                    continue
                if c.elem.is_reduction and phase_of[c.idx] < p:
                    if c.idx in consumed:
                        env[c.out] = scratch[c.idx][_index(roots(c.out), sl)]
                    continue
                v = c.elem.fn(*[val(a) for a in c.args])
                if not c.elem.is_reduction:
                    env[c.out] = v
                    if mode.get(c.out) == "map" and phase_of[c.idx] == p:
                        out[c.out][_index(roots(c.out), sl)] = v
                    continue
                rr = reduce_roots_of(c.out, f, g)
                first = all(tile[r] == 0 for r in rr)
                at = _index(roots(c.out), sl)
                m = c.elem.monoid
                if c.idx in consumed:
                    s = scratch[c.idx]
                    s[at] = v if first else m.combine(s[at], v)
                if mode.get(c.out) == "acc":
                    o = out[c.out]
                    o[at] = v if first else m.combine(o[at], v)
                elif mode.get(c.out) == "partial":
                    lead = tuple(tile[r] for r in rr)
                    out[c.out][lead + (at if at is not ... else ())] = v
        for c in reds:                  # the kernel's workspace dtype
            if c.idx in consumed:
                s = scratch[c.idx]
                s.copy_(s.to(torch_dtype(c.out.dtype)))
    res = []
    for v in f.outputs:
        r = out[v]
        if mode[v] == "partial":
            lead = len(reduce_roots_of(v, f, g))
            r = v.producer.elem.monoid.reduce(r, dims=range(lead))
        res.append(r.to(torch_dtype(v.dtype)))
    return tuple(res)


# ---------------------------------------------------------------------------
# plan module and group wrappers
# ---------------------------------------------------------------------------

class PlanModule:
    """The generated source of one plan (all its groups) and, once
    built, its loaded library."""

    def __init__(self, g: Graph, impls):
        self.g = g
        self.layouts = [GroupLayout(g, im) for im in impls]
        self.source = plan_source(g, impls)
        self._lib = None

    def build(self):
        return _build.build(self.source)

    def function(self, gi: int):
        """The C launcher of group ``gi``, ``(pointers..., nb, stream)``
        (builds and loads on first use; a failed build raises
        ``BuildError``)."""
        if self._lib is None:
            self._lib = _build.load(self.source)
        lay = self.layouts[gi]
        n = (len(lay.f.external_inputs) + len(lay.outputs)
             + len(lay.workspace()))
        return _build.c_function(
            self._lib, kernel_name(gi) + "_launch",
            [ctypes.c_void_p] * n + [ctypes.c_longlong, ctypes.c_void_p])


def fold_partials(monoid, raw: torch.Tensor, n_lead: int,
                  start: int = 0) -> torch.Tensor:
    """Combine the per-tile partials of a ``partial`` output: the
    ``n_lead`` dims of ``raw`` from ``start`` on, folded one tile after
    another with elementwise ``monoid.combine``.  Each element sees the
    same operations in the same order whatever the leading (batch)
    dims, so a batched fold gives the bits of the single ones; one tile
    is a view, no launch."""
    lead = raw.shape[start:start + n_lead]
    r = raw.reshape(raw.shape[:start] + (math.prod(lead),)
                    + raw.shape[start + n_lead:])
    out = r.select(start, 0)
    for t in range(1, r.shape[start]):
        out = monoid.combine(out, r.select(start, t))
    return out


class GroupKernel:
    """The ``cuda`` backend's function for one plan group.

    Tensors on the CPU run the plain tiled version; tensors on a CUDA
    device launch the generated kernel, and anything that stops the
    launch (a build failure, a refused launch, a wrong device, dtype,
    shape or layout) raises — there is no fallback.  ``batched`` runs a
    batch of requests (every input and output with a leading batch
    axis) as one launch."""

    def __init__(self, module: PlanModule, gi: int, label: str = ""):
        self.module, self.gi = module, gi
        self.layout = module.layouts[gi]
        self._fn = None                  # the C launcher, once loaded
        self.name = f"{label or 'plan'}/g{gi}[{self.layout.names}]"

    def __call__(self, *ext_vals: torch.Tensor):
        if ext_vals and all(t.device.type == "cpu" for t in ext_vals):
            return tiled_reference(self.layout.g, self.layout.impl, *ext_vals)
        return self.launch(*ext_vals)

    def batched(self, *ext_vals: torch.Tensor):
        """One batch of requests: on the CPU the plain version request by
        request, on CUDA one launch over the whole batch."""
        if ext_vals and all(t.device.type == "cpu" for t in ext_vals):
            per = [tiled_reference(self.layout.g, self.layout.impl,
                                   *(t[b] for t in ext_vals))
                   for b in range(ext_vals[0].shape[0])]
            return tuple(torch.stack(o) for o in zip(*per))
        nb = ext_vals[0].shape[0] if ext_vals else 0
        self._check(ext_vals, (nb,))
        return self._launch(ext_vals, nb)

    def _check(self, ext_vals, batch: tuple = ()):
        lay = self.layout
        if len(ext_vals) != len(lay.f.external_inputs):
            raise TypeError(f"{self.name}: expects "
                            f"{len(lay.f.external_inputs)} inputs, got "
                            f"{len(ext_vals)}")
        for v, t in zip(lay.f.external_inputs, ext_vals):
            _launch.check(self.name, f"input {v.name}", t,
                          batch + tuple(v.shape),
                          dtypes=(torch_dtype(v.dtype),),
                          device=ext_vals[0].device)

    def launch(self, *ext_vals: torch.Tensor):
        self._check(ext_vals)
        return self._launch(ext_vals)

    def buffers(self, dev: torch.device, nb: int | None = None):
        """The kernel's raw outputs (``partial`` outputs with their lead
        axes) and its workspace (consumed reductions, then the slices'
        partials), allocated on ``dev`` (with a leading batch axis of
        ``nb`` when given); the kernel writes every element before it
        reads it."""
        lay = self.layout
        batch = () if nb is None else (nb,)
        raw = [torch.empty(batch + lay.raw_shape(v),
                           dtype=torch_dtype(v.dtype), device=dev)
               for v in lay.outputs]
        ws = [torch.empty(batch + shape, dtype=torch_dtype(dt), device=dev)
              for shape, dt in zip(lay.workspace(), lay.workspace_dtypes())]
        return raw, ws

    def launch_into(self, ext_vals, raw, ws, nb: int = 1):
        """Launch the kernel on checked inputs into buffers from
        ``buffers``; the ``partial`` outputs are left uncombined."""
        if self._fn is None:
            self._fn = self.module.function(self.gi)
        ptrs = [t.data_ptr() for t in list(ext_vals) + raw + ws]
        _launch.launch(self.name, self._fn, *ptrs, nb,
                       device=ext_vals[0].device)

    def _launch(self, ext_vals, nb: int | None = None):
        lay = self.layout
        raw, ws = self.buffers(ext_vals[0].device, nb)
        self.launch_into(ext_vals, raw, ws, 1 if nb is None else nb)
        outs = []
        for v, r in zip(lay.outputs, raw):
            if lay.out_mode[v] == "partial":
                r = fold_partials(v.producer.elem.monoid, r,
                                  len(lay.lead_shape(v)),
                                  start=0 if nb is None else 1)
            outs.append(r)
        return tuple(outs)

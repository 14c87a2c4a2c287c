"""Temporal-blocked packed pass at depth 2: two Yee steps per call.

Replaces the Pallas TPU kernel
``fdtd3d_tpu/ops/pallas_packed_tb.py::make_packed_tb_step`` (builder
:520, kernel body :900, ``pallas_call`` :1320; scope ``_reject_reason``
:214, host step :1809-1955) for unsharded 3D float32 and bf16 storage
runs at k = 2,
with the hand-written CUDA C++ kernel ``fdtd3d_torch/csrc/packed_tb.cu``
(``sm_90a``, built by nvcc at first use, bound with ctypes). CUDA C++
rather than Triton: a marching stencil with shared-memory plane rings fed
by cp.async, per-column register state and CPML slab branches.

What one pass computes: E(t+1), H(t+1), E(t+2), H(t+2) from E(t), H(t),
with the slab CPML of every axis run twice, electric Drude J, material
grids, PEC walls, and the sources added into the accumulator at each
generation (the reference tb's form): TFSF through the record table of
``ops/packed_ds.py`` with this pass's two rows of f32 plane terms
(``tfsf.record_terms``), the point source as ``ps_amp * waveform(t+g-1)``
for g = 1, 2. Generation t+1 never reaches device memory.

bf16 storage: E and H are stored in bf16 and everything else in f32;
both generations compute in f32 and only generation 2 is rounded to
bf16, where it is stored (the reference's tb kernel rounds at g == k,
pallas_packed_tb.py:1200, :1258): generation 1, and the E(2) that H(2)
reads, never leave the kernel.

Design: the kernel reads the carry and writes a second buffer set of
the same shapes, because a block reads halo cells that a neighbour
writes (csrc/packed_tb.cu). The step keeps that spare set and swaps it
with the carry's E, H, psi and J every pass, so the carry always holds
the live fields and the spare costs one more copy of them in memory. The
incident line advances on the host side of the pass in thin torch ops,
twice per pass, in the reference's order: ``advance_einc(t+g-1)``, the
records' terms of generation g, ``advance_hinc``.

The kernel's work plan is made here, once per prepared operand set and
card (``plan_items``, as a small int32 device tensor): (y, z) tiles over
x segments, cut along each axis's CPML bands, classed by what their
cells touch (a slab, a record's plane or the point source, nothing) and
put in the sections of SECTIONS, each run by its own kernel, heaviest
items first. ``material`` finds the box outside which the coefficient
grids hold their background value, so that only the items inside it run
the kernels that read grids. The plan depends on geometry (and that box)
only, so every lane of a batch runs a solo call's items. The CPU tests
check it (tests/test_torch_tb_plan.py).

The step advances two steps per call (``steps_per_call``); its
``tail_step`` is the packed single step (``ops/packed.py``), which shares
the carry layout, ``pack``/``unpack`` and ``prepare``, and runs in place
on whichever buffer is live for an odd remainder.

Lanes (the reference's ``batch=B`` build of this kernel): with
``batch=B`` the carry and its spare have a leading lane axis (see
``ops/packed.py``), and one call advances all B lanes by two steps.
The record table is geometry and serves every lane; the record terms
are (2, B, total), one row per generation and lane, from the
lane-stacked incident line in the same six ops as a solo run; the
point source's drive is a (B, 2) device tensor, ``ps_amp`` of each lane
times ``waveform(t+g-1)``. A solo run (``batch=0``) is one lane, and a
launch of one lane takes its drive as two host floats (kernel
parameters), as the solo pass did before lanes existed: the one-lane
build of the kernel is then the solo pass's code (csrc/packed_tb.cu).

Beside the kernel wrapper ``tb_pass`` stands its plain PyTorch version
``tb_pass_plain`` with the same signature, on the solo and the
lane-stacked layouts; the wrapper takes it only for CPU tensors, and on
a CUDA tensor launches the kernel or raises. ``tb_pass.launches`` counts
the kernel's calls (one per call, whatever the number of lanes; a call
launches one kernel for each non-empty section of the plan).
"""

from __future__ import annotations

import ctypes
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fdtd3d_torch.ops import build, packed, tfsf
from fdtd3d_torch.ops.packed_ds import Record, family_records
from fdtd3d_torch.ops.sources import waveform
from fdtd3d_torch.solver import slab_axes

DEPTH = 2             # steps per pass; the only depth of this kernel
MAX_REC = 16          # records per family; mirrors csrc/packed_tb.cu
PLAN_COLS = 8         # ints a plan row; mirrors csrc/packed_tb.cu
MAX_PLANES = 512      # owned x planes of an item at most; mirrors it too
TILE = (12, 28)       # owned (y, z) cells of a tile at the source's BY, BZ
_LIB = "packed_tb"


# --------------------------------------------------------------------------
# scope
# --------------------------------------------------------------------------

def sources_interior(static) -> bool:
    """True iff every TFSF E-correction plane and the point source sit,
    with a one-plane guard for the H-correction curls, strictly inside
    the region where both CPML profile sets are identity (planes
    [npml, n-2-npml]). A copy of the reference's
    ``pallas_packed._sources_interior``."""
    lo: List[Optional[int]] = [None, None, None]
    hi: List[Optional[int]] = [None, None, None]

    def grow(a, v):
        lo[a] = v if lo[a] is None else min(lo[a], v)
        hi[a] = v if hi[a] is None else max(hi[a], v)

    setup = static.tfsf_setup
    if setup is not None:
        for corr in setup.corrections:
            if corr.field != "E":
                continue
            grow(corr.axis, corr.plane)
            for b in range(3):
                if b != corr.axis and b in static.mode.active_axes:
                    grow(b, setup.lo[b])
                    grow(b, setup.hi[b])
    if static.cfg.point_source.enabled:
        for a in range(3):
            grow(a, static.cfg.point_source.position[a])
    for a in static.mode.active_axes:
        if lo[a] is None:
            continue
        npml = static.cfg.pml.size[a] if a in static.pml_axes else 0
        n = static.grid_shape[a]
        if lo[a] - 1 < npml or hi[a] + 1 > n - 2 - npml:
            return False
    return True


def reject_reason(static) -> Optional[str]:
    """Why a configuration is outside this pass's scope, or None.

    The reference's ``_reject_reason`` tokens where the reason is the
    same (``paired_complex`` first, ``ds_fields``, ``packed_ineligible``
    (also native complex fields), ``compensated``, ``magnetic_drude``,
    ``source_in_absorber``), and the port's own for what this slice
    leaves out: ``dtype`` (float64), ``sharded``, and ``depth``
    (``FDTD3D_TB_DEPTH`` pinned to anything but 2)."""
    cfg = static.cfg
    if static.paired_complex:
        return "paired_complex"
    if cfg.ds_fields:
        return "ds_fields"
    if static.mode.name != "3D" or cfg.complex_fields:
        return "packed_ineligible"
    if cfg.dtype not in ("float32", "bfloat16"):
        return "dtype"
    if tuple(static.topology) != (1, 1, 1):
        return "sharded"
    if set(static.pml_axes) != set(slab_axes(static)) \
            or (cfg.compensated and static.use_drude_m):
        return "packed_ineligible"
    if cfg.compensated:
        return "compensated"
    if static.use_drude_m:
        return "magnetic_drude"
    if (static.tfsf_setup is not None or cfg.point_source.enabled) \
            and not sources_interior(static):
        return "source_in_absorber"
    pin = os.environ.get("FDTD3D_TB_DEPTH")
    if pin and int(pin) != DEPTH:
        return "depth"
    return None


# --------------------------------------------------------------------------
# the host part of a pass: the incident line and the per-generation sources
# --------------------------------------------------------------------------

def tfsf_records(static) -> Dict[str, List[Record]]:
    """The TFSF records of each family (the point source is passed
    apart, after the Drude current, as the reference orders it)."""
    return {fam: [r for r in family_records(static, fam)
                  if r.corr is not None] for fam in ("E", "H")}


def generation_terms(static, tb: Dict[str, Any], inc, t: int):
    """The host part of the pass starting at step t: (the incident line
    after both generations, the records' plane terms (2, total) or
    (2, B, total) or None, the point source's drive or None: a (B, 2)
    device tensor for several lanes, two host floats for one).

    Generation g: ``advance_einc(t+g-1)``, the plane terms (E records
    sample Hinc at t+g-1/2, H records Einc at t+g), ``advance_hinc``;
    the point source's drive is ``ps_amp * waveform(t+g-1)`` per lane.
    The ops do not grow with the number of lanes."""
    setup = static.tfsf_setup
    terms = None
    if setup is not None:
        coeffs, plan = tb["coeffs"], tb["plan"]
        if plan is not None:
            lanes = (tb["batch"],) if tb["batch"] else ()
            terms = torch.empty((DEPTH,) + lanes + (plan.total,),
                                dtype=torch.float32, device=plan.w.device)
        for g in range(DEPTH):
            inc = tfsf.advance_einc(inc, coeffs, t + g, static.dt,
                                    static.omega, setup)
            if terms is not None:
                tfsf.record_terms(plan, inc, out=terms[g])
            inc = tfsf.advance_hinc(inc, coeffs, setup)
    drive = None
    ps = static.cfg.point_source
    if ps.enabled:
        wfs = [waveform(ps.waveform, t + g, 0.5, static.omega, static.dt,
                        static.real_dtype) for g in range(DEPTH)]
        amp = tb["amp"]
        if isinstance(amp, torch.Tensor):
            drive = torch.empty((amp.shape[0], DEPTH), dtype=torch.float32,
                                device=amp.device)
            for g, wf in enumerate(wfs):
                torch.mul(amp, float(wf), out=drive[:, g])
        else:
            drive = [float(amp * wf) for wf in wfs]
    return inc, terms, drive


def prepare(static, cc: Dict[str, Any], records,
            batch: int = 0) -> Dict[str, Any]:
    """The pass's operands on top of the packed step's prepared ``cc``:
    the per-family operands, the record tables and the record plan (all
    lanes share them), and the point source's cell and amplitude
    ``amp``: a (B,) device tensor for several lanes, an f32 host value
    for one (read back once here)."""
    coeffs = cc["coeffs"]
    plan = tfsf.build_record_plan(static, coeffs, records)
    ps = static.cfg.point_source
    tb: Dict[str, Any] = {
        "coeffs": coeffs, "E": cc["E"], "H": cc["H"], "plan": plan,
        "shape": tuple(static.grid_shape), "point": None, "batch": batch}
    for fam in ("E", "H"):
        if len(records[fam]) > MAX_REC:
            raise ValueError(f"{len(records[fam])} TFSF records in the "
                             f"{fam} family; the kernel takes at most "
                             f"{MAX_REC}")
        tb[f"rec_{fam}"] = [(rec.comp, rec.axis, rec.plane,
                             plan.offsets[(fam, r)])
                            for r, rec in enumerate(records[fam])]
    if ps.enabled:
        tb["point"] = (static.mode.e_components.index(ps.component),
                       tuple(ps.position))
        amp = torch.as_tensor(coeffs["ps_amp"]).reshape(-1)
        tb["amp"] = amp.to(device=coeffs["gx"].device, dtype=torch.float32
                           ).expand(batch).contiguous() if batch > 1 \
            else np.float32(amp[0].item())
    return tb


# --------------------------------------------------------------------------
# the kernel's work plan (host side; csrc/packed_tb.cu runs it)
# --------------------------------------------------------------------------

PLAIN, SOURCE, SLAB = 0, 1, 2   # item classes, lightest first
# the kernel's sections, in launch order (csrc/packed_tb.cu, kKernels):
# the edge kernels (the SLAB items: reading coefficient grids, touching
# the slab of x only, of y only, of z only, of several axes), then the
# inner kernel (the other items: reading grids, not)
SECTIONS = ("edge_grid", "edge_x", "edge_y", "edge_z", "edge", "inner_grid",
            "inner")
# relative cost of one plane of an item, by class: the order of a
# section's items, heaviest first (SLAB items run in the edge kernels,
# the others in the inner one)
CLASS_COST = {PLAIN: 1.0, SOURCE: 1.2, SLAB: 1.7}
HALO_PLANES = 3      # planes a segment marches beyond its own
# x segment lengths, the first that gives every SM four items: on the
# card 48 planes beat 16, 24, 32 and 64 at 256^3 and 512^3
# (scripts/tb_variants.py, seg_N); shorter ones keep a small grid's SMs
# busy
SEGMENTS = (48, 32, 24, 16)


def _pieces(a: int, b: int, k: int) -> List[Tuple[int, int]]:
    """[a, b) in k near-equal pieces (fewer if it is shorter than k)."""
    n = b - a
    k = max(1, min(k, n))
    cuts = [a + (n * q) // k for q in range(k + 1)]
    return list(zip(cuts[:-1], cuts[1:])) if n > 0 else []


def _bands(n: int, m: int) -> Tuple[int, int]:
    """Widths of the low and high CPML bands of an axis with an m-plane
    slab: an owned range computes generation 1 one cell below it and two
    above it (E1 reaches both, H1 one above), so an owned range clear of
    the slab starts at m + 1 and ends by n - m - 2."""
    if m <= 0:
        return 0, 0
    lo, hi = m + 1, m + 2
    return (n, 0) if lo + hi >= n else (lo, hi)


def _aligned(a: int, b: int, size: int, align: int) -> List[Tuple[int, int]]:
    """[a, b) in pieces of at most ``size`` whose inner cuts fall on
    multiples of ``align``, each as long as that allows."""
    out: List[Tuple[int, int]] = []
    while b - a > size:
        cut = (a + size) // align * align
        cut = cut if cut > a else a + size
        out.append((a, cut))
        a = cut
    return out + [(a, b)]


def _axis_cuts(n: int, m: int, size: int,
               align: int = 1) -> List[Tuple[int, int, bool]]:
    """Owned ranges of a y or z axis: each CPML band and the interior
    between them, cut into the fewest near-equal pieces of at most
    ``size`` (the interior, with ``align`` > 1, at multiples of it);
    each with whether it lies in a band."""
    lo, hi = _bands(n, m)
    out: List[Tuple[int, int, bool]] = []
    for a, b, band in ((0, lo, True), (lo, n - hi, False),
                       (n - hi, n, True)):
        if b > a and align > 1 and not band:
            out += [(u, v, band) for u, v in _aligned(a, b, size, align)]
        elif b > a:
            out += [(u, v, band)
                    for u, v in _pieces(a, b, -(-(b - a) // size))]
    return out


def _x_cuts(n: int, m: int, seg: int) -> List[Tuple[int, int, bool]]:
    """x segments: each CPML band whole, the interior in near-equal
    segments of at most ``seg`` planes (and none above MAX_PLANES); each
    with whether it lies in a band."""
    lo, hi = _bands(n, m)
    out: List[Tuple[int, int, bool]] = []
    for a, b, size, band in ((0, lo, lo, True), (lo, n - hi, seg, False),
                             (n - hi, n, hi, True)):
        if b > a:
            size = min(max(size, 1), MAX_PLANES)
            out += [(u, v, band)
                    for u, v in _pieces(a, b, -(-(b - a) // size))]
    return out


def item_class(shape, m, records, point, item) -> int:
    """SLAB if a cell the item computes (``computed_box``) lies in a CPML
    slab; else SOURCE if such a cell lies on a record's plane or is the
    point source's cell; else PLAIN. ``item`` = (j0, k0, ny, nz, x0,
    x1)."""
    if item_axes(shape, m, item):
        return SLAB
    box = computed_box(item, shape)
    if any(box[axis][0] <= plane <= box[axis][1]
           for axis, plane in records):
        return SOURCE
    if point is not None and all(box[a][0] <= point[a] <= box[a][1]
                                 for a in range(3)):
        return SOURCE
    return PLAIN


def item_axes(shape, m, item) -> int:
    """The axes whose CPML slab holds a cell the item computes (bit a for
    axis a)."""
    box = computed_box(item, shape)
    return sum(1 << a for a in range(3)
               if m[a] > 0 and (box[a][0] < m[a]
                                or box[a][1] >= shape[a] - m[a]))


def section(shape, m, grids, row) -> int:
    """The section of SECTIONS that runs an item (a plan row)."""
    grid = reads_grid(row, shape, grids)
    if row[6] != SLAB:
        return 5 if grid else 6
    if grid:
        return 0
    return {1: 1, 2: 2, 4: 3}.get(item_axes(shape, m, row), 4)


def item_cost(row) -> float:
    """The plan's estimate of an item's time: planes marched times its
    class's cost."""
    return (row[5] - row[4] + HALO_PLANES) * CLASS_COST[row[6]]


def transposed_tile(tile) -> Tuple[int, int]:
    """Owned (y, z) cells of a tile in the transposed layout (the block's
    threads as half as many columns along z, twice as many rows along
    y) of ``tile``'s block."""
    return 2 * (tile[0] + 4) - 4, (tile[1] + 4) // 2 - 4


def computed_box(item, shape) -> Tuple[Tuple[int, int], ...]:
    """The cells an item computes (inclusive bounds per axis): its owned
    box grown by one cell below and two above on every axis (the
    generation-1 halo), inside the grid. ``item`` = (j0, k0, ny, nz, x0,
    x1)."""
    j0, k0, ny, nz, x0, x1 = item[:6]
    return ((max(x0 - 1, 0), min(x1 + 1, shape[0] - 1)),
            (max(j0 - 1, 0), min(j0 + ny + 1, shape[1] - 1)),
            (max(k0 - 1, 0), min(k0 + nz + 1, shape[2] - 1)))


def reads_grid(item, shape, grids) -> bool:
    """Whether an item's cells read a coefficient grid: ``grids`` is
    None (no grid), "all" (everywhere), or the box (inclusive bounds per
    axis, or () when empty) outside which every grid holds its
    background value."""
    if grids is None or grids == ():
        return False
    if grids == "all":
        return True
    box = computed_box(item, shape)
    return all(box[a][0] <= grids[a][1] and grids[a][0] <= box[a][1]
               for a in range(3))


def _tilings(shape, m, tile, zband: bool, zalign: int):
    """The (y, z) tiles of an x segment in a CPML band and of one in the
    interior: (j0, ny, k0, nz, layout) each. z-band columns narrow enough
    take the transposed layout; the interior tiles of the interior
    segments are ``zalign``-aligned along z (``_axis_cuts``), so their
    rows of owned cells start and end on whole 32-byte sectors when
    ``zalign`` is 8; the others keep ``tile``'s width."""
    n2, n3 = shape[1:]
    wide = transposed_tile(tile)
    ycuts = {0: _axis_cuts(n2, m[1], tile[0]),
             1: _axis_cuts(n2, m[1], wide[0])}
    zcuts = _axis_cuts(n3, m[2], tile[1])
    zaligned = [c for c in _axis_cuts(n3, m[2], tile[1], zalign) if not c[2]]
    band_tiles, inner_tiles = [], []
    for k0, k1, zb in zcuts:
        layout = 1 if zband and zb and k1 - k0 <= wide[1] else 0
        for j0, j1, yb in ycuts[layout]:
            band_tiles.append((j0, j1 - j0, k0, k1 - k0, layout))
            if zb or yb:
                inner_tiles.append(band_tiles[-1])
    for j0, j1, yb in ycuts[0]:
        if not yb:
            inner_tiles += [(j0, j1 - j0, k0, k1 - k0, 0)
                            for k0, k1, _ in zaligned]
    return band_tiles, inner_tiles


def plan_items(shape, m, records=(), point=None, tile=TILE, sms=132,
               zband=True, grids=None, zalign=8,
               segments=SEGMENTS) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """The kernel's work items: (rows, counts).

    ``rows`` is (n, PLAN_COLS) int32: j0, k0, ny, nz, x0, x1, class,
    layout (an owned box of at most ``tile`` (y, z) cells, or of
    ``transposed_tile(tile)`` with layout 1, over x planes [x0, x1)), in
    the sections of SECTIONS (``counts`` items each, the kernel's
    launches in order; ``section``): SLAB items that read a coefficient
    grid (``reads_grid``), SLAB items whose cells touch the slab of x
    only, y only, z only (``item_axes``), the other SLAB items, the
    other classes' items that read a grid, the rest. Each axis is cut
    into its CPML bands
    and the interior (``_axis_cuts``, ``_x_cuts``), so the owned boxes
    tile the grid exactly once; with ``zband``, a z-band piece narrow
    enough for the transposed layout takes it, with y pieces of its
    height; the interior tiles of the interior x segments are aligned
    along z (``_tilings``: their owned rows, written out by the kernel,
    start and end on 32-byte sectors). The x segments are the first of
    ``segments`` long that gives the card's ``sms`` SMs four items each
    (else the last); each section's items run heaviest first
    (``item_cost``), ties in the order of their x segments.
    ``m``: slab planes per axis (0: no CPML); ``records``: (normal axis,
    plane) of every record; ``point``: the point source's cell or None.
    The plan depends on geometry only (and the grids' box, the same for
    every lane): every lane of a batch runs the items of a solo call."""
    n1 = shape[0]
    m = tuple(m)
    records = [tuple(r) for r in records]
    tilings = _tilings(shape, m, tile, zband, zalign)
    for seg in segments:
        rows = []
        for x0, x1, xb in _x_cuts(n1, m[0], seg):
            for j0, ny, k0, nz, layout in tilings[0 if xb else 1]:
                item = (j0, k0, ny, nz, x0, x1)
                rows.append(item + (item_class(shape, m, records, point,
                                               item), layout))
        if len(rows) >= 4 * sms:
            break
    sections = [[] for _ in SECTIONS]
    for r in rows:
        sections[section(shape, m, grids, r)].append(r)
    for sec in sections:
        sec.sort(key=item_cost, reverse=True)
    rows = np.array([r for sec in sections for r in sec],
                    dtype=np.int32).reshape(-1, PLAN_COLS)
    return rows, tuple(len(sec) for sec in sections)


def material(tb) -> Tuple[Any, Dict[Tuple[str, int], float]]:
    """Where a prepared pass's coefficient grids differ from their
    background: (``grids`` as ``plan_items`` takes it, the background
    value of each E grid by (key, component)), the E family's by
    ``packed.material``'s rule (a grid's background is its value at cell
    (0, 0, 0), the same on every lane); Drude J or K and grids of the H
    family read everywhere ("all")."""
    fe, fh = tb["E"], tb["H"]
    if fe["kj"] is not None or fh["kj"] is not None \
            or any(isinstance(v, torch.Tensor)
                   for key in ("a", "b") for v in fh[key]):
        return "all", {}
    return packed.material(fe)


def plan_geometry(tb) -> Tuple[Tuple[int, int, int], Tuple[Tuple[int, int],
                                                          ...], Any]:
    """(m per axis, records as (axis, plane), the point source's cell or
    None) of a prepared pass, as ``plan_items`` takes them."""
    m = tuple(tb["E"]["m"].get(a, 0) for a in range(3))
    records = tuple((axis, plane) for fam in ("E", "H")
                    for _, axis, plane, _ in tb[f"rec_{fam}"])
    point = None if tb["point"] is None else tuple(tb["point"][1])
    return m, records, point


# --------------------------------------------------------------------------
# plain version (the kernel's arithmetic in torch; CPU tensors and tests)
# --------------------------------------------------------------------------

def _record_adder(tb, fam: str, row):
    """records(c, acc) for ``packed._family_plain``: each record of
    component c adds its plane term at its plane."""
    shape = tb["shape"]

    def add(c, acc):
        for comp, axis, plane, off in tb[f"rec_{fam}"]:
            if comp != c:
                continue
            ps = tfsf.plane_shape(shape, axis)
            term = row.narrow(0, off, int(np.prod(ps))).reshape(ps)
            acc.narrow(axis, plane, 1).add_(term)
        return acc

    return add


def _point_adder(tb, value):
    comp, (i, j, k) = tb["point"]

    def add(c, acc):
        if c == comp:
            acc[i:i + 1, j:j + 1, k:k + 1] += value
        return acc

    return add


def _generations(dst, tb, terms, drive) -> None:
    """The two generations of one lane, in place on its solo-layout
    views: ``terms`` (2, total) or None, ``drive`` two values or None."""
    for g in range(DEPTH):
        rec_e = rec_h = point = None
        if terms is not None:
            rec_e = _record_adder(tb, "E", terms[g])
            rec_h = _record_adder(tb, "H", terms[g])
        if drive is not None:
            point = _point_adder(tb, drive[g])
        packed._family_plain(dst["E"], dst["H"], dst.get("J"), dst["psE"],
                             tb["E"], True, rec_e, point)
        packed._family_plain(dst["H"], dst["E"], None, dst["psH"], tb["H"],
                             False, rec_h)


def _lane_carry(carry, lane: int) -> Dict[str, Any]:
    """The pass's buffers of one lane of a lane-stacked carry (views)."""
    out = {"E": carry["E"][lane], "H": carry["H"][lane],
           "psE": {a: v[lane] for a, v in carry["psE"].items()},
           "psH": {a: v[lane] for a, v in carry["psH"].items()}}
    if "J" in carry:
        out["J"] = carry["J"][lane]
    return out


def tb_pass_plain(src, dst, tb, terms, drive) -> None:
    """Two generations from the carry ``src`` into ``dst`` (the same
    keys and shapes; ``src`` is not modified): the whole volume per
    generation, with the records added into the accumulator after the
    curl and the point source after the Drude current; on a
    lane-stacked carry, one lane after the other. bf16 fields: both
    generations run on float32 copies of E and H, rounded to bf16 only
    where generation 2 is stored (generation 1 never leaves the kernel,
    and H(2) reads the unrounded E(2), as in the reference's tb kernel)."""
    for a, b in zip(packed.carry_buffers(dst), packed.carry_buffers(src)):
        a.copy_(b)
    work = dst
    if dst["E"].dtype != torch.float32:
        work = dict(dst, E=dst["E"].float(), H=dst["H"].float())
    if work["E"].dim() == 4:
        _generations(work, tb, terms, drive)
    else:
        for lane in range(work["E"].shape[0]):
            lane_tb = dict(tb, E=packed.lane_fc(tb["E"], lane),
                           H=packed.lane_fc(tb["H"], lane))
            _generations(_lane_carry(work, lane), lane_tb,
                         None if terms is None else terms[:, lane],
                         drive if drive is None or isinstance(drive, list)
                         else drive[lane])
    if work is not dst:
        dst["E"].copy_(work["E"])
        dst["H"].copy_(work["H"])


# --------------------------------------------------------------------------
# the CUDA kernel wrapper
# --------------------------------------------------------------------------

class _Rec(ctypes.Structure):
    """Mirror of ``struct Rec`` in csrc/packed_tb.cu."""
    _fields_ = [("off", ctypes.c_longlong), ("comp", ctypes.c_int),
                ("axis", ctypes.c_int), ("plane", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _Family(ctypes.Structure):
    """Mirror of ``struct Family`` in csrc/packed_tb.cu."""
    _fields_ = [("a", packed._Coef * 3), ("b", packed._Coef * 3),
                ("prof", ctypes.c_void_p * 3), ("rec", _Rec * MAX_REC),
                ("n_rec", ctypes.c_int)]


class _Params(ctypes.Structure):
    """Mirror of ``struct Params`` in csrc/packed_tb.cu."""
    _fields_ = [("E0", ctypes.c_void_p), ("H0", ctypes.c_void_p),
                ("J0", ctypes.c_void_p), ("E2", ctypes.c_void_p),
                ("H2", ctypes.c_void_p), ("J2", ctypes.c_void_p),
                ("psE0", ctypes.c_void_p * 3), ("psH0", ctypes.c_void_p * 3),
                ("psE2", ctypes.c_void_p * 3), ("psH2", ctypes.c_void_p * 3),
                ("terms", ctypes.c_void_p), ("total", ctypes.c_longlong),
                ("field_lane", ctypes.c_longlong),
                ("psi_lane", ctypes.c_longlong * 3),
                ("lane_drive", ctypes.c_void_p),
                ("plan", ctypes.c_void_p),
                ("fe", _Family), ("fh", _Family),
                ("kj", packed._Coef * 3), ("bj", packed._Coef * 3),
                ("m", ctypes.c_int * 3),
                ("pc", ctypes.c_int), ("pi", ctypes.c_int),
                ("pj", ctypes.c_int), ("pk", ctypes.c_int),
                ("drive", ctypes.c_float * 2),
                ("n1", ctypes.c_int), ("n2", ctypes.c_int),
                ("n3", ctypes.c_int), ("lanes", ctypes.c_int),
                ("n_item", ctypes.c_int * len(SECTIONS)),
                ("inv_dx", ctypes.c_float), ("bf16", ctypes.c_int)]


def _library() -> ctypes.CDLL:
    lib = build.load(_LIB)
    if not getattr(lib, "_fdtd_bound", False):
        lib.fdtd_tb_pass.argtypes = [ctypes.POINTER(_Params),
                                     ctypes.c_void_p]
        lib.fdtd_tb_pass.restype = ctypes.c_int
        lib.fdtd_tb_params_size.restype = ctypes.c_int
        lib.fdtd_tb_error_string.argtypes = [ctypes.c_int]
        lib.fdtd_tb_error_string.restype = ctypes.c_char_p
        lib.fdtd_tb_tile.argtypes = [ctypes.c_void_p]
        lib.fdtd_tb_tile.restype = ctypes.c_int
        lib.fdtd_tb_occupancy.argtypes = [ctypes.c_void_p]
        lib.fdtd_tb_occupancy.restype = ctypes.c_int
        if lib.fdtd_tb_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"{_LIB}: struct Params is {lib.fdtd_tb_params_size()} "
                f"bytes in CUDA and {ctypes.sizeof(_Params)} in ctypes")
        lib._fdtd_bound = True
    return lib


def _material(tb):
    """``material(tb)``, computed once per prepared operand set."""
    if "_material" not in tb:
        tb["_material"] = material(tb)
    return tb["_material"]


def _device_plan(tb, device, lib) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """The plan of a prepared pass on ``device`` for the geometry the
    library was built with (its tile, item length and z-band layout), the
    card's SM count and the grids' box, built once: (rows, counts)."""
    geo = (ctypes.c_int * 4)()
    lib.fdtd_tb_tile(ctypes.addressof(geo))
    key = (device, tuple(geo))
    cached = tb.get("_plan")
    if cached is not None and cached[0] == key:
        return cached[1]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    m, records, point = plan_geometry(tb)
    rows, counts = plan_items(tb["shape"], m, records, point,
                              tile=(geo[0], geo[1]), sms=sms,
                              zband=bool(geo[3]),
                              grids=_material(tb)[0])
    if int((rows[:, 5] - rows[:, 4]).max()) > geo[2]:
        raise ValueError("plan_items made an item longer than the kernel's "
                         f"{geo[2]} planes")
    plan = (torch.from_numpy(rows).to(device), counts)
    tb["_plan"] = (key, plan)
    return plan


def occupancy() -> Dict[str, Dict[str, int]]:
    """Registers and local (spill) bytes a thread, resident blocks an SM
    and static shared bytes of each tb kernel, as the CUDA runtime
    reports them for the card: each section's kernel (SECTIONS), solo
    and lane-capable (``*_lanes``), float32 and bf16 (``*_bf16``); the
    grid sections' at their larger shared memory."""
    lib = _library()
    out = (ctypes.c_int * (16 * len(SECTIONS)))()
    err = lib.fdtd_tb_occupancy(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fdtd_tb_occupancy failed: CUDA error {err} "
                           f"({lib.fdtd_tb_error_string(err).decode()})")
    names = tuple(n + lane + dt for dt in ("", "_bf16") for n in SECTIONS
                  for lane in ("", "_lanes"))
    keys = ("registers", "local_bytes", "blocks_per_sm", "static_smem")
    return {n: {k: out[4 * q + i] for i, k in enumerate(keys)}
            for q, n in enumerate(names)}


def _family_struct(fc, table, device, lanes: int) -> _Family:
    shape = fc["shape"]
    f = _Family()
    for c in range(3):
        f.a[c] = packed._coef_struct(fc["a"][c], f"a[{c}]", shape, device,
                                     lanes)
        f.b[c] = packed._coef_struct(fc["b"][c], f"b[{c}]", shape, device,
                                     lanes)
    for a, m in fc["m"].items():
        f.prof[a] = packed._check(fc["prof"][a], f"prof[{a}]", (3, 2 * m),
                                  device)
    for r, (comp, axis, plane, off) in enumerate(table):
        f.rec[r].comp, f.rec[r].axis = comp, axis
        f.rec[r].plane, f.rec[r].off = plane, off
    f.n_rec = len(table)
    return f


def _base_params(tb, device, lanes: int) -> _Params:
    """The static part of the parameter block (coefficients, profiles,
    record tables, the point source's cell, the lane strides), built and
    checked once per prepared operand set, device and lane count."""
    base = tb.get("_params")
    if base is not None and base[0] == (device, lanes):
        return base[1]
    fe, shape = tb["E"], tb["shape"]
    prm = _Params()
    prm.fe = _family_struct(fe, tb["rec_E"], device, lanes)
    # the items that read no grid take each E grid's background value
    for (key, c), value in _material(tb)[1].items():
        getattr(prm.fe, key)[c].val = value
    prm.fh = _family_struct(tb["H"], tb["rec_H"], device, lanes)
    if fe["kj"] is not None:
        for c in range(3):
            prm.kj[c] = packed._coef_struct(fe["kj"][c], f"kj[{c}]", shape,
                                            device, lanes)
            prm.bj[c] = packed._coef_struct(fe["bj"][c], f"bj[{c}]", shape,
                                            device, lanes)
    for a, m in fe["m"].items():
        prm.m[a] = m
        prm.psi_lane[a] = int(np.prod(packed.psi_shape(shape, a, m)))
    prm.pc = -1
    if tb["point"] is not None:
        prm.pc, (prm.pi, prm.pj, prm.pk) = tb["point"]
    prm.n1, prm.n2, prm.n3 = shape
    prm.lanes = lanes
    prm.field_lane = 3 * shape[0] * shape[1] * shape[2]
    prm.inv_dx = fe["inv_dx"]
    tb["_params"] = ((device, lanes), prm)
    return prm


def _params(src, dst, tb, terms, drive, lib) -> _Params:
    device = src["E"].device
    shape = tb["shape"]
    lanes, lead = packed.carry_lanes(src["E"])
    prm = _Params.from_buffer_copy(_base_params(tb, device, lanes))
    plan, counts = _device_plan(tb, device, lib)
    prm.plan = plan.data_ptr()
    for q, n in enumerate(counts):
        prm.n_item[q] = n
    full = lead + (3,) + tuple(shape)
    fd = packed.field_dtype(src["E"])
    prm.E0 = packed._check(src["E"], "E", full, device, fd)
    prm.H0 = packed._check(src["H"], "H", full, device, fd)
    prm.E2 = packed._check(dst["E"], "E (destination)", full, device, fd)
    prm.H2 = packed._check(dst["H"], "H (destination)", full, device, fd)
    prm.bf16 = int(fd == torch.bfloat16)
    if tb["E"]["kj"] is not None:
        prm.J0 = packed._check(src["J"], "J", full, device)
        prm.J2 = packed._check(dst["J"], "J (destination)", full, device)
    for a, m in tb["E"]["m"].items():
        ps = packed.psi_shape(shape, a, m, lead)
        if int(np.prod(packed.psi_shape(shape, a, m))) >= 2 ** 31:
            raise ValueError(f"psi[{a}] of {shape} exceeds the kernel's "
                             "32-bit psi offsets")
        prm.psE0[a] = packed._check(src["psE"][a], f"psE[{a}]", ps, device)
        prm.psH0[a] = packed._check(src["psH"][a], f"psH[{a}]", ps, device)
        prm.psE2[a] = packed._check(dst["psE"][a], f"psE[{a}] (dst)", ps,
                                    device)
        prm.psH2[a] = packed._check(dst["psH"][a], f"psH[{a}] (dst)", ps,
                                    device)
    if {t.data_ptr() for t in packed.carry_buffers(src)} \
            & {t.data_ptr() for t in packed.carry_buffers(dst)}:
        raise ValueError("tb_pass writes out of place: the destination "
                         "shares a buffer with the source")
    if tb["plan"] is not None:
        prm.terms = packed._check(terms, "terms",
                                  (DEPTH,) + lead + (tb["plan"].total,),
                                  device)
        prm.total = tb["plan"].total
    if tb["point"] is not None and lanes == 1:
        prm.drive[0], prm.drive[1] = drive
    elif tb["point"] is not None:
        prm.lane_drive = packed._check(drive, "drive", (lanes, DEPTH),
                                       device)
    return prm


def tb_pass(src, dst, tb, terms, drive) -> None:
    """Two generations from ``src`` into ``dst``, every lane of a
    lane-stacked carry in one call: the CUDA kernel on CUDA tensors, its
    plain version on CPU tensors."""
    if not src["E"].is_cuda:
        tb_pass_plain(src, dst, tb, terms, drive)
        return
    lib = _library()
    prm = _params(src, dst, tb, terms, drive, lib)
    stream = torch.cuda.current_stream(src["E"].device).cuda_stream
    err = lib.fdtd_tb_pass(ctypes.byref(prm), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fdtd_tb_pass launch failed: CUDA error {err} "
                           f"({lib.fdtd_tb_error_string(err).decode()})")
    tb_pass.launches += 1


tb_pass.launches = 0


# --------------------------------------------------------------------------
# the temporal-blocked step
# --------------------------------------------------------------------------

def make_packed_tb_step(static, device, plain: bool = False,
                        batch: int = 0):
    """The depth-2 temporal-blocked step over the packed carry.

    Each call advances two steps (``steps_per_call``); ``tail_step`` is
    the packed single step. On a CUDA ``device`` the pass launches the
    kernel (kind ``packed_tb_cuda``); on the CPU it runs the plain
    version (kind ``packed_tb_plain``). ``plain=True`` runs the plain
    versions on any device: the yardstick chip_smoke.py holds the
    kernel against. ``batch=B`` builds the lane-capable pass (and tail)
    over a carry with B lanes."""
    reason = reject_reason(static)
    if reason is not None:
        raise NotImplementedError(
            f"this configuration is outside the temporal-blocked pass's "
            f"scope ({reason}); the packed step runs it")
    tail = packed.make_packed_step(static, device, plain=plain, batch=batch)
    records = tfsf_records(static)
    fn = tb_pass_plain if plain else tb_pass
    spare: Dict[str, Any] = {}

    def prepare_tb(coeffs) -> Dict[str, Any]:
        cc = tail.prepare(coeffs)
        cc["tb"] = prepare(static, cc, records, batch)
        return cc

    def step(ps: Dict[str, Any], cc: Dict[str, Any]) -> Dict[str, Any]:
        t = ps["t"]
        inc, terms, drive = generation_terms(static, cc["tb"],
                                             ps.get("inc"), t)
        if not spare:
            spare.update(packed.alloc_like(ps))
        fn(ps, spare, cc["tb"], terms, drive)
        packed.swap_buffers(ps, spare)
        if inc is not None:
            ps["inc"] = inc
        ps["t"] = t + DEPTH
        return ps

    step.prepare = prepare_tb
    step.pack = tail.pack
    step.unpack = tail.unpack
    step.packed = True
    step.steps_per_call = DEPTH
    step.tail_step = tail
    step.diag = {"temporal_block": DEPTH}
    on_cuda = torch.device(device).type == "cuda"
    step.kind = "packed_tb_cuda" if on_cuda and not plain \
        else "packed_tb_plain"
    return step

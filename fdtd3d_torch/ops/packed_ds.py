"""Packed double-single (float32x2) step: at most three CUDA launches a
step, and no PyTorch op between them.

Replaces the Pallas TPU kernel
``fdtd3d_tpu/ops/pallas_packed_ds.py::make_packed_ds_step`` (factory
:193, kernel :364 with body :429, ``pallas_call`` :936) for 3D
float32x2 runs, unsharded and decomposed (its pair ghosts :1198-1211
and hi-edge H fix :1237-1280: ``make_sharded_packed_ds_step`` below),
and the reference step's host part around it (the ds
incident line and the TFSF record terms), with the hand-written CUDA
C++ kernels of ``fdtd3d_torch/csrc/packed_ds.cu`` (``sm_90a``, built by
nvcc with ``--fmad=false`` at first use, bound with ctypes). CUDA C++
rather than Triton: every error-free transform needs its exact rounding
sequence, which the source states op by op with explicitly rounded
intrinsics, and the pass is a marching stencil with shared-memory plane
rings fed by cp.async.

What one step computes: the reference kernel's arithmetic on hi+lo f32
pairs. The ds incident line advances (Einc with its hard-source pair,
then Hinc). Per E component: the EFT curl of the H pair times 1/dx as a
pair, the y/z/x slab CPML as pair recursions (term = ik*d + psi'), each
source record's plane term added into the accumulator pair at its plane
before the ca/cb pair multiply, Drude J in plain f32, PEC walls; then H
the same from the new E, with magnetic Drude K in plain f32 (``K' = km K
+ bm H_hi`` on the hi word of the old H, added to the accumulator pair
after the records, as the reference's lagged H phase adds it). The
source records are the reference's: every
TFSF face correction whose polarisation projection does not vanish,
grouped by normal axis, with the point source as a pseudo-record at the
end of the axis-0 group (E only). A record's plane term interpolates
the line at the record's fixed geometry (``build_term_plan``: index,
weight pairs, the sign*pol/dx pair, the transverse gate); E records
sample Hinc before the line's advance, H records Einc after it.

The CUDA step (kind ``packed_ds_cuda``), in launch order:

1. ``line_advance`` (``ds_line``, one block): the line from the carry's
   buffer into a second one, Einc then Hinc, op for op the torch ds ops
   of ``tfsf.advance_einc``/``advance_hinc``; the hard source's pair
   (``sources.DsSourceTable``) is a kernel argument. Skipped without
   TFSF.
2. and 3. ``ds_pass`` (``ds_section``, the edge kernel then the inner
   one, which may overlap it): E and H of every cell in one x-marching
   pass, out of place (source buffers in the carry, destination buffers
   in the step's spare set), with the record terms computed in the
   kernel at the record planes from the two line buffers (Hinc from the
   first, Einc from the second) and the point source's pair as a
   kernel argument. The host's work plan (``plan_items``) tiles the grid
   into (y, z) tiles over x segments; the items that reach into a CPML
   slab run in the edge kernel, the others in the inner one.

The step then swaps the carry's E, H, psi, J, K and line with the
spare set: the carry always holds the live state.

Beside each kernel wrapper stands its plain PyTorch version with the
same signature (``line_advance_plain``, ``ds_pass_plain``: the same
schedule, double buffer and out of place, with the record terms of
``plan_terms``, the kernel's per-cell formula ``record_term_cell``); a
wrapper takes it only for CPU tensors, and on a CUDA tensor launches
the kernel or raises. ``line_advance.launches`` and ``ds_pass.launches``
count kernel calls; ``ds_pass.kernels`` the section kernels those
calls launched (one a non-empty plan section).
``make_packed_ds_step(..., plain=True)`` is the yardstick the card
holds the kernels against: the reference's own schedule in torch ops
(the line advance, ``record_terms``, ``e_update_plain`` and
``h_update_plain`` in place). The test-only probes ``eft_probe`` and
``device_terms`` run the kernel's own EFTs and record-term function.

A decomposed run (``make_sharded_packed_ds_step``) gives each shard its
own records (``shard_records``), runs the sharded builds of the pass
(``ds_pass_sharded``: the lower neighbours' last planes of old H as
pair ghosts, walls on the global edges only) and then, on each shard
with an upper neighbour, ``hi_edge_h``: H, psi_H and K of its hi-edge
planes computed again, whole, from the source buffers and the upper
neighbours' first planes of new E. Their plain versions
(``ds_pass_plain`` with ``ghost``, ``hi_edge_h_plain``) follow the same
schedule; ``ds_pass_sharded.launches`` (``.kernels``) and
``hi_edge_h.launches`` count kernel calls.

What bounds it on the card: a step must move E and H once each (96
B/cell) plus the psi slabs, and do ~1,000 f32 operations a cell, which
``--fmad=false`` issues at the card's non-FMA rate: bytes and
operations take about the same time (csrc/packed_ds.cu).

Layout (the reference's): ``E``, ``H`` (6, n1, n2, n3) with rows [0,3)
the hi words and [3,6) the lo words; ``psE[a]``/``psH[a]`` (4, ...)
with dim 1+a of 2m planes, rows = the two components with a curl term
along a (hi, then the same two lo); ``J`` (3, ...) with Drude and ``K``
(3, ...) with magnetic Drude, plain f32 beside the pairs; ``inc`` the
ds line with ``*_lo`` words. km/bm are read inside the box where their
grids differ from the background (``packed.material``'s rule; outside
it the background scalar), as the f32 twin reads its grids.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fdtd3d_torch.layout import component_axis
from fdtd3d_torch.ops import build, ds, packed, tfsf
from fdtd3d_torch.ops.packed import psi_row
from fdtd3d_torch.ops.sources import DsSourceTable
from fdtd3d_torch.solver import (_bcast1d, _shift, coef_pair, ds_diff,
                                 slab_axes)

AXES = "xyz"
_LIB = "packed_ds"
MAX_REC = 16          # records per family; mirrors csrc/packed_ds.cu
LINE_KEYS = ("Einc", "Einc_lo", "Hinc", "Hinc_lo")


def eligible(static) -> bool:
    """Packed-ds scope: 3D float32x2, every CPML axis with slab-compact
    psi (on a topology: on each shard; ``make_sharded_packed_ds_step``
    runs it there)."""
    return (static.cfg.ds_fields and not static.cfg.complex_fields
            and static.mode.name == "3D"
            and set(static.pml_axes) == set(slab_axes(static)))


# --------------------------------------------------------------------------
# source records
# --------------------------------------------------------------------------

class Record(NamedTuple):
    """One source record of a family: ``corr`` is the TFSF correction,
    or None for the point-source pseudo-record."""
    comp: int
    axis: int
    plane: int
    corr: Optional[tfsf.Correction]


def _corr_records(static, family: str) -> List[tfsf.Correction]:
    """The family's TFSF corrections with a non-vanishing projection and
    a plane inside the grid (the reference's ``_corr_records``)."""
    setup = static.tfsf_setup
    if setup is None:
        return []
    out = []
    for corr in setup.corrections:
        if corr.field != family:
            continue
        if abs(tfsf.corr_polarization(corr, setup)) < tfsf.POL_EPS:
            continue
        if not 0 <= corr.plane < static.grid_shape[corr.axis]:
            continue
        out.append(corr)
    return out


def family_records(static, family: str) -> List[Record]:
    """The family's records in the order the kernel adds them: grouped
    by normal axis 0, 1, 2, the point source last in the axis-0 group."""
    mode = static.mode
    comps = list(mode.e_components if family == "E" else mode.h_components)
    groups: Dict[int, List[Record]] = {0: [], 1: [], 2: []}
    for corr in _corr_records(static, family):
        groups[corr.axis].append(
            Record(comps.index(corr.comp), corr.axis, corr.plane, corr))
    ps = static.cfg.point_source
    if family == "E" and ps.enabled and ps.component in comps:
        groups[0].append(Record(comps.index(ps.component), 0,
                                ps.position[0], None))
    return groups[0] + groups[1] + groups[2]


def shard_records(static, mesh, r: int) -> Dict[str, List[Record]]:
    """Shard r's records of both families: the global records
    (``family_records``) whose plane lies in the shard's box, in their
    order, each with its plane made shard-local; the correction keeps
    its global geometry, and the term plan of the shard's coefficients
    (its pieces of the cell index vectors ``gx``/``gy``/``gz``) gives
    each record the global line coordinates of the shard's columns.
    The point source is a record of its owner shard only. The
    reference's traced shard-local plane indices with ownership folded
    into the terms (``pallas_packed_ds.py:288-293``, ``:331-405``),
    made static per shard on the host."""
    off, n = mesh.offset(r), mesh.local_shape
    owner = mesh.owner(static.cfg.point_source.position)[0]
    out: Dict[str, List[Record]] = {}
    for fam in ("E", "H"):
        out[fam] = [rec._replace(plane=rec.plane - off[rec.axis])
                    for rec in family_records(static, fam)
                    if 0 <= rec.plane - off[rec.axis] < n[rec.axis]
                    and (rec.corr is not None or owner == r)]
    return out


class TermPlan(NamedTuple):
    """Fixed geometry of every TFSF record of both families, flattened
    into one vector of plane cells: E records, then H records."""
    offsets: Dict[Any, int]       # (family, record index) -> offset
    total: int
    i0: torch.Tensor              # index into cat(Einc, Hinc)
    w: ds.Pair
    ow: ds.Pair
    scale: ds.Pair
    gate: torch.Tensor


def build_term_plan(static, coeffs, records) -> Optional[TermPlan]:
    """Per record: the ds line coordinate's interpolation index and
    weight pairs, the sign*pol/dx pair and the transverse gate, each
    broadcast to the record's plane and flattened (C order over the two
    transverse axes)."""
    setup = static.tfsf_setup
    gs = (coeffs["gx"], coeffs["gy"], coeffs["gz"])
    n = setup.n_inc if setup is not None else 0
    parts: Dict[str, list] = {k: [] for k in ("i0", "wh", "wl", "owh",
                                              "owl", "sh", "sl", "gate")}
    offsets: Dict[Any, int] = {}
    total = 0
    for fam, r, corr, pshape in tfsf.record_planes(static, records):
        i0, w, ow = tfsf.interp_weights_ds(
            n, tfsf.record_coord_ds(corr, setup, gs,
                                    static.mode.active_axes))
        if corr.src[0] == "H":
            i0 = i0 + n                 # the Hinc half of the line
        gate = tfsf.corr_gate_transverse(corr, setup, gs,
                                         static.mode.active_axes,
                                         torch.float32)
        if gate is None:
            gate = torch.ones((), device=gs[0].device)
        sc = tfsf.record_scale_ds(corr, setup, static.dx)
        size = int(np.prod(pshape))
        for key, v in (("i0", i0), ("wh", w[0]), ("wl", w[1]),
                       ("owh", ow[0]), ("owl", ow[1]),
                       ("sh", ds.f32(sc[0], gs[0])),
                       ("sl", ds.f32(sc[1], gs[0])), ("gate", gate)):
            parts[key].append(v.expand(pshape).reshape(size))
        offsets[(fam, r)] = total
        total += size
    if total == 0:
        return None
    cat = {k: torch.cat(v).contiguous() for k, v in parts.items()}
    return TermPlan(offsets, total, cat["i0"], (cat["wh"], cat["wl"]),
                    (cat["owh"], cat["owl"]), (cat["sh"], cat["sl"]),
                    cat["gate"])


def record_terms(plan: Optional[TermPlan], inc) -> Optional[torch.Tensor]:
    """This step's plane terms of every record, (2, total): hi then lo.
    Samples Hinc for E records and Einc for H records, so it runs after
    the Einc advance and before the Hinc advance."""
    if plan is None:
        return None
    lh = torch.cat([inc["Einc"], inc["Hinc"]])
    ll = torch.cat([inc["Einc_lo"], inc["Hinc_lo"]])
    i1 = plan.i0 + 1
    v0 = (lh.index_select(0, plan.i0), ll.index_select(0, plan.i0))
    v1 = (lh.index_select(0, i1), ll.index_select(0, i1))
    vh, vl = ds.add_ff(*ds.mul_ff(*v0, *plan.ow), *ds.mul_ff(*v1, *plan.w))
    th, tl = ds.mul_ff(vh, vl, *plan.scale)
    return torch.stack([th * plan.gate, tl * plan.gate])


def record_term_cell(v0, v1, w, ow, scale, gate):
    """One record cell's plane term from its two line samples v0, v1
    (pairs) and its geometry (the weight pairs w and 1 - w, the
    sign*pol/dx pair, the 0/1 gate): the formula the kernel evaluates at
    a record cell (csrc/packed_ds.cu ``record_term``), op for op, as
    ``record_terms`` (the yardstick) evaluates it for all cells at once.
    Elementwise: the operands may be scalars or vectors of cells."""
    vh, vl = ds.add_ff(*ds.mul_ff(*v0, *ow), *ds.mul_ff(*v1, *w))
    th, tl = ds.mul_ff(vh, vl, *scale)
    return th * gate, tl * gate


def kernel_geometry(plan: Optional[TermPlan], n: int):
    """The plan's fixed geometry as the kernel reads it: (geo, i0, the
    first H record's cell). ``geo`` is (7, total) float32, rows w hi, w
    lo, 1-w hi, 1-w lo, scale hi, scale lo, gate; ``i0`` (total,) int32
    indexes the line half the record samples (Hinc for E records, Einc
    for H records), so the plan's index into cat(Einc, Hinc) loses n
    for E records."""
    if plan is None:
        return None, None, 0
    geo = torch.stack([plan.w[0], plan.w[1], plan.ow[0], plan.ow[1],
                       plan.scale[0], plan.scale[1], plan.gate]).contiguous()
    i0 = torch.where(plan.i0 >= n, plan.i0 - n, plan.i0).to(torch.int32)
    h_first = min([off for (fam, _), off in plan.offsets.items()
                   if fam == "H"] or [plan.total])
    return geo, i0.contiguous(), h_first


def plan_terms(cc, line_src, line_dst) -> Optional[torch.Tensor]:
    """The record terms (2, total) as the kernel computes them from the
    double-buffered line: E records sample ``line_src``'s Hinc (before
    the advance), H records ``line_dst``'s Einc (after it), each cell by
    ``record_term_cell``. Equal to ``record_terms`` of the line between
    the two advances, bit for bit (tests/test_torch_ds_kernel.py)."""
    if cc["plan"] is None:
        return None
    geo, h = cc["geo"], cc["h_first"]
    i0 = cc["geo_i0"].long()
    samples = []
    for shift in (0, 1):
        idx_e, idx_h = i0[:h] + shift, i0[h:] + shift
        samples.append(tuple(
            torch.cat([line_src[f"Hinc{lo}"][idx_e],
                       line_dst[f"Einc{lo}"][idx_h]]) for lo in ("", "_lo")))
    th, tl = record_term_cell(samples[0], samples[1], (geo[0], geo[1]),
                              (geo[2], geo[3]), (geo[4], geo[5]), geo[6])
    return torch.stack([th, tl])


def line_advance_plain(src, dst, cc, pair) -> None:
    """The ds incident line from ``src`` into ``dst`` (dicts of
    LINE_KEYS; ``src`` is not modified): ``tfsf.advance_einc`` with the
    hard source's ``pair`` (host floats), then ``tfsf.advance_hinc``."""
    static = cc["static"]
    inc = tfsf.advance_einc(dict(src), cc["coeffs"], 0, static.dt,
                            static.omega, static.tfsf_setup,
                            source=lambda _t: pair)
    inc = tfsf.advance_hinc(inc, cc["coeffs"], static.tfsf_setup)
    for key in LINE_KEYS:
        dst[key].copy_(inc[key])


# --------------------------------------------------------------------------
# the pass's work plan (host side; csrc/packed_ds.cu runs it)
# --------------------------------------------------------------------------

PLAIN, SLAB = 0, 1    # item classes
# the kernel's sections, in launch order (csrc/packed_ds.cu, kKernels):
# the SLAB items in the edge kernel, the PLAIN ones in the inner kernel
SECTIONS = ("edge", "inner")
PLAN_COLS = 8         # ints a plan row; mirrors csrc/packed_ds.cu
TILE = (30, 30)       # owned (y, z) cells of a tile at the source's BY, BZ
# relative cost of one plane of an item, by class: the order of a
# section's items, heaviest first
CLASS_COST = {PLAIN: 1.0, SLAB: 1.7}
# x segment lengths, the first that gives every SM four items (else the
# last): on the card 16 planes beat 6-12 at 256^3, and 10 tie 6 and beat
# 8, 12 and 16 at 128^3, where 16 leave 200 items on 132 SMs
# (scripts/ds_variants.py, seg_N)
SEGMENTS = (16, 10)


def _pieces(a: int, b: int, k: int) -> List[Tuple[int, int]]:
    """[a, b) in k near-equal pieces (fewer if it is shorter than k)."""
    n = b - a
    k = max(1, min(k, n))
    cuts = [a + (n * q) // k for q in range(k + 1)]
    return list(zip(cuts[:-1], cuts[1:])) if n > 0 else []


def _bands(n: int, m: int) -> Tuple[int, int]:
    """Widths of the low and high CPML bands of an axis with an m-plane
    slab: an owned range computes E one cell above it (H reads it), so
    an owned range clear of the slab starts at m and ends by n - m - 1."""
    if m <= 0:
        return 0, 0
    lo, hi = m, m + 1
    return (n, 0) if lo + hi >= n else (lo, hi)


def _axis_cuts(n: int, m: int, size: int, align: int = 1,
               bands: bool = False) -> List[Tuple[int, int]]:
    """Owned ranges of an axis: the whole axis (or, with ``bands``, each
    CPML band and the interior between them) cut into the fewest
    near-equal pieces of at most ``size`` (the interior, with ``align`` >
    1, at multiples of it)."""
    lo, hi = _bands(n, m) if bands else (0, 0)
    out: List[Tuple[int, int]] = []
    for a, b, band in ((0, lo, True), (lo, n - hi, False),
                       (n - hi, n, True)):
        if b <= a:
            continue
        if align > 1 and not band:
            while b - a > size:
                cut = (a + size) // align * align
                cut = cut if cut > a else a + size
                out.append((a, cut))
                a = cut
            out.append((a, b))
        else:
            out += _pieces(a, b, -(-(b - a) // size))
    return out


def computed_box(item, shape) -> Tuple[Tuple[int, int], ...]:
    """The cells an item computes (inclusive bounds per axis): E on its
    owned box grown by one cell above on every axis (H reads it), H on
    the owned box, inside the grid. ``item`` = (j0, k0, ny, nz, x0,
    x1)."""
    j0, k0, ny, nz, x0, x1 = item[:6]
    return ((x0, min(x1, shape[0] - 1)), (j0, min(j0 + ny, shape[1] - 1)),
            (k0, min(k0 + nz, shape[2] - 1)))


def item_class(shape, m, item) -> int:
    """SLAB if a cell the item computes lies in a CPML slab, else
    PLAIN."""
    box = computed_box(item, shape)
    return SLAB if any(m[a] > 0 and (box[a][0] < m[a]
                                     or box[a][1] >= shape[a] - m[a])
                       for a in range(3)) else PLAIN


def item_cost(row) -> float:
    """The plan's estimate of an item's time: planes marched (the halo
    plane included) times its class's cost."""
    return (row[5] - row[4] + 1) * CLASS_COST[row[6]]


def plan_items(shape, m, tile=TILE, sms=132, zalign=1, segments=SEGMENTS,
               bands=False) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """The pass's work items: (rows, counts).

    ``rows`` is (n, PLAN_COLS) int32: j0, k0, ny, nz, x0, x1, class, 0
    (an owned box of at most ``tile`` (y, z) cells over x planes [x0,
    x1)), the SLAB items (the edge kernel) then the PLAIN ones (the
    inner kernel), ``counts`` items each, heaviest first within each
    (``item_cost``), ties in the order of their x segments. Each axis is
    cut as a whole into near-equal pieces (``_axis_cuts``; with ``bands``,
    band by band, which leaves narrow band tiles: slower on the card at
    128^3 and 256^3), so the owned boxes tile the grid exactly once; an
    item is SLAB if any cell it computes lies in a slab; with ``zalign``
    > 1 the interior z pieces are cut at its multiples. The x segments
    are the first of ``segments`` long that gives the card's ``sms`` SMs
    four items each (else the last). ``m``: slab planes per axis (0: no
    CPML)."""
    m = tuple(m)
    ycuts = _axis_cuts(shape[1], m[1], tile[0], bands=bands)
    zcuts = _axis_cuts(shape[2], m[2], tile[1], zalign, bands)
    for seg in segments:
        rows = []
        for x0, x1 in _axis_cuts(shape[0], m[0], seg, bands=bands):
            for j0, j1 in ycuts:
                for k0, k1 in zcuts:
                    item = (j0, k0, j1 - j0, k1 - k0, x0, x1)
                    rows.append(item + (item_class(shape, m, item), 0))
        if len(rows) >= 4 * sms:
            break
    sections = [[r for r in rows if r[6] == SLAB],
                [r for r in rows if r[6] == PLAIN]]
    for sec in sections:
        sec.sort(key=item_cost, reverse=True)
    rows = np.array([r for sec in sections for r in sec],
                    dtype=np.int32).reshape(-1, PLAN_COLS)
    return rows, tuple(len(sec) for sec in sections)


# --------------------------------------------------------------------------
# pack / unpack
# --------------------------------------------------------------------------

def pack(state: Dict[str, Any], static) -> Dict[str, Any]:
    """Dict-form ds state -> packed carry (new tensors)."""
    mode = static.mode
    ec, hc = mode.e_components, mode.h_components
    p: Dict[str, Any] = {
        "E": torch.stack([state["E"][c] for c in ec]
                         + [state["loE"][c] for c in ec]),
        "H": torch.stack([state["H"][c] for c in hc]
                         + [state["loH"][c] for c in hc]),
        "t": int(state["t"]), "psE": {}, "psH": {}}
    for a in slab_axes(static):
        for fam, grp, comps in (("psE", "E", ec), ("psH", "H", hc)):
            keys = [f"{c}_{AXES[a]}" for c in comps
                    if component_axis(c) != a]
            p[fam][a] = torch.stack(
                [state[f"psi_{grp}"][k] for k in keys]
                + [state[f"lopsi_{grp}"][k] for k in keys])
    if static.use_drude:
        p["J"] = torch.stack([state["J"][c] for c in ec])
    if static.use_drude_m:
        p["K"] = torch.stack([state["K"][c] for c in hc])
    if static.tfsf_setup is not None:
        p["inc"] = {k: v.clone() for k, v in state["inc"].items()}
    return p


def unpack(p: Dict[str, Any], static) -> Dict[str, Any]:
    """Packed carry -> dict-form ds state (views into the carry)."""
    mode = static.mode
    ec, hc = mode.e_components, mode.h_components
    state: Dict[str, Any] = {
        "E": {c: p["E"][j] for j, c in enumerate(ec)},
        "loE": {c: p["E"][3 + j] for j, c in enumerate(ec)},
        "H": {c: p["H"][j] for j, c in enumerate(hc)},
        "loH": {c: p["H"][3 + j] for j, c in enumerate(hc)},
        "t": p["t"]}
    if p["psE"]:
        for key in ("psi_E", "psi_H", "lopsi_E", "lopsi_H"):
            state[key] = {}
        for a in p["psE"]:
            for fam, grp, comps in (("psE", "E", ec), ("psH", "H", hc)):
                keys = [f"{c}_{AXES[a]}" for c in comps
                        if component_axis(c) != a]
                for r, k in enumerate(keys):
                    state[f"psi_{grp}"][k] = p[fam][a][r]
                    state[f"lopsi_{grp}"][k] = p[fam][a][2 + r]
    if "J" in p:
        state["J"] = {c: p["J"][j] for j, c in enumerate(ec)}
    if "K" in p:
        state["K"] = {c: p["K"][j] for j, c in enumerate(hc)}
    if "inc" in p:
        state["inc"] = dict(p["inc"])
    return state


def prepare_family(static, coeffs, family: str, records: List[Record],
                   plan: Optional[TermPlan],
                   point_pos=None) -> Dict[str, Any]:
    """Per-family operands: ca/cb (E) or da/db (H) as hi/lo pairs of
    tensors (0-d scalars or grids), the ADE current's coefficients in
    plain f32 under ``kj``/``bj`` (E: Drude kj/bj; H: magnetic Drude
    km/bm, with ``box``, where their grids differ from their
    background, ``bg``, as ``packed.material`` finds it), the slab CPML
    profile packs (6, 2m) per axis (b, c, ik hi then lo), the walls, the
    1/dx pair, and the record table with each record's term offset
    (the point source's cell in ``point_pos``: the configuration's, or
    a shard's local cell)."""
    mode = static.mode
    like = coeffs["gx"]
    comps = mode.e_components if family == "E" else mode.h_components
    tag = "e" if family == "E" else "h"
    pa, pb = ("ca", "cb") if family == "E" else ("da", "db")
    fc: Dict[str, Any] = {
        "family": family, "shape": tuple(static.grid_shape),
        "iv": ds.pair_tensors(1.0 / np.float64(static.dx), like),
        "a": [coef_pair(coeffs, f"{pa}_{c}", like) for c in comps],
        "b": [coef_pair(coeffs, f"{pb}_{c}", like) for c in comps],
        "kj": None, "bj": None, "m": dict(slab_axes(static)), "prof": {},
        "wall": [coeffs[f"wall_{ax}"] for ax in AXES],
        "records": records,
        "offsets": [None if rec.corr is None else plan.offsets[(family, r)]
                    for r, rec in enumerate(records)],
        "point_pos": tuple(point_pos if point_pos is not None
                           else static.cfg.point_source.position)}
    if family == "E" and static.use_drude:
        fc["kj"] = [ds.as_f32(coeffs[f"kj_{c}"], like) for c in comps]
        fc["bj"] = [ds.as_f32(coeffs[f"bj_{c}"], like) for c in comps]
    if family == "H" and static.use_drude_m:
        fc["kj"] = [ds.as_f32(coeffs[f"km_{c}"], like) for c in comps]
        fc["bj"] = [ds.as_f32(coeffs[f"bm_{c}"], like) for c in comps]
        fc["box"], fc["bg"] = packed.material(
            {"shape": fc["shape"], "a": None, "b": None,
             "kj": [v if v.dim() else None for v in fc["kj"]],
             "bj": [v if v.dim() else None for v in fc["bj"]]})
    for a in fc["m"]:
        fc["prof"][a] = torch.stack(
            [coeffs[f"pml_slab_{v}{tag}_{AXES[a]}"] for v in ("b", "c", "ik")]
            + [coeffs[f"pml_slab_{v}{tag}lo_{AXES[a]}"]
               for v in ("b", "c", "ik")]).contiguous()
    if len(records) > MAX_REC:
        raise ValueError(f"{len(records)} source records in the {family} "
                         f"family; the kernel takes at most {MAX_REC}")
    return fc


# --------------------------------------------------------------------------
# plain versions (the kernel's arithmetic in torch; CPU tensors and tests)
# --------------------------------------------------------------------------

def _slab_term(a: int, dfa, P, row: int, prof, m: int):
    """The pair curl term with the slab CPML of axis a: ik*d + psi' on
    the 2m slab planes (psi' = b*psi + c*d, written into the psi stack
    P in place), d elsewhere."""
    n = dfa[0].shape[a]
    th, tl = dfa[0].clone(), dfa[1].clone()
    for d0, p0 in ((0, 0), (n - m, m)):
        dp = (dfa[0].narrow(a, d0, m), dfa[1].narrow(a, d0, m))
        ps_h, ps_l = P[row].narrow(a, p0, m), P[2 + row].narrow(a, p0, m)

        def pr(r, p0=p0):
            return _bcast1d(prof[r].narrow(0, p0, m), a)

        pn = ds.add_ff(*ds.mul_ff(pr(0), pr(3), ps_h, ps_l),
                       *ds.mul_ff(pr(1), pr(4), *dp))
        tt = ds.add_ff(*ds.mul_ff(pr(2), pr(5), *dp), *pn)
        ps_h.copy_(pn[0])
        ps_l.copy_(pn[1])
        th.narrow(a, d0, m).copy_(tt[0])
        tl.narrow(a, d0, m).copy_(tt[1])
    return th, tl


def _add_records(acc, c: int, fc, terms, point) -> None:
    """The records of component c added into the accumulator pair at
    their planes, in place (elsewhere a record's term is zero, and a
    pair plus a zero pair is the pair itself)."""
    ah, al = acc
    shape = fc["shape"]
    for rec, off in zip(fc["records"], fc["offsets"]):
        if rec.comp != c:
            continue
        if rec.corr is None:
            if point is None:
                continue
            _, j, k = fc["point_pos"]
            sl = (slice(rec.plane, rec.plane + 1), slice(j, j + 1),
                  slice(k, k + 1))
            nh, nl = ds.add_ff(ah[sl], al[sl], ds.f32(point[0], ah),
                               ds.f32(point[1], ah))
        else:
            ps = tfsf.plane_shape(shape, rec.axis)
            size = int(np.prod(ps))
            th = terms[0].narrow(0, off, size).reshape(ps)
            tl = terms[1].narrow(0, off, size).reshape(ps)
            sl = tuple(slice(rec.plane, rec.plane + 1) if b == rec.axis
                       else slice(None) for b in range(3))
            nh, nl = ds.add_ff(ah[sl], al[sl], th, tl)
        ah[sl] = nh
        al[sl] = nl


def _shift_pair(f, a: int, backward: bool, ghost, d: int):
    """The pair ``f`` of component d shifted along axis a (``_shift``),
    with ``ghost`` (axis -> a (6, plane) pair plane) in place of the PEC
    zero beyond the edge where it has one: rows d (hi) and 3 + d (lo)."""
    g = (_shift(f[0], a, backward), _shift(f[1], a, backward))
    plane = None if ghost is None else ghost.get(a)
    if plane is not None:
        edge = 0 if backward else f[0].shape[a] - 1
        for q, row in enumerate((d, 3 + d)):
            g[q].narrow(a, edge, 1).copy_(plane[row].unsqueeze(a))
    return g


def _family_plain(F, S, J, psi, fc, terms, point, backward: bool,
                  ghost=None) -> None:
    iv = fc["iv"]
    for c in range(3):
        acc = None
        for t in range(2):
            a, d = (c + 1 + t) % 3, (c + 2 - t) % 3
            f = (S[d], S[3 + d])
            g = _shift_pair(f, a, backward, ghost, d)
            term = ds_diff(f, g, iv) if backward else ds_diff(g, f, iv)
            if a in fc["m"]:
                term = _slab_term(a, term, psi[a], psi_row(c, a),
                                  fc["prof"][a], fc["m"][a])
            if t == 1:
                term = ds.neg(*term)
            acc = term if acc is None else ds.add_ff(*acc, *term)
        _add_records(acc, c, fc, terms, point)
        old = (F[c], F[3 + c])
        if backward:
            if J is not None:
                j_new = fc["kj"][c] * J[c] + fc["bj"][c] * old[0]
                acc = ds.add_f(*acc, -j_new)
                J[c].copy_(j_new)
            vh, vl = ds.add_ff(*ds.mul_ff(*old, *fc["a"][c]),
                               *ds.mul_ff(*acc, *fc["b"][c]))
            for w in range(3):
                if w != c:
                    wall = _bcast1d(fc["wall"][w], w)
                    vh, vl = vh * wall, vl * wall
        else:
            if J is not None:        # K: the dual current, added
                k_new = fc["kj"][c] * J[c] + fc["bj"][c] * old[0]
                acc = ds.add_f(*acc, k_new)
                J[c].copy_(k_new)
            vh, vl = ds.sub_ff(*ds.mul_ff(*old, *fc["a"][c]),
                               *ds.mul_ff(*acc, *fc["b"][c]))
        F[c].copy_(vh)
        F[3 + c].copy_(vl)


def e_update_plain(E, H, J, psi, fc, terms, point, ghost=None) -> None:
    """E pairs (and J, psi_E pairs) in place from backward ds
    differences of the H pairs, with the E records and the point
    source's pair ``point`` (or None). ``ghost`` (a shard of a
    decomposed run): axis -> its lower neighbour's last plane of H
    pairs, (6, plane)."""
    _family_plain(E, H, J, psi, fc, terms, point, True, ghost)


def h_update_plain(H, E, psi, fc, terms, K=None, ghost=None) -> None:
    """H pairs (and psi_H pairs, and K with magnetic Drude) in place from
    forward ds differences of the E pairs, with the H records.
    ``ghost``: axis -> the upper neighbour's first plane of E pairs."""
    _family_plain(H, E, K, psi, fc, terms, None, False, ghost)


# --------------------------------------------------------------------------
# plain versions of the CUDA path (CPU tensors and tests)
# --------------------------------------------------------------------------

def ds_pass_plain(src, dst, cc, line_src, line_dst, point,
                  ghost=None) -> None:
    """One step of E and H from the carry ``src`` into ``dst`` (the same
    keys and shapes; ``src`` is not modified), the kernel's schedule:
    the record terms of ``plan_terms`` from the two line buffers, then
    the E and H updates of the whole volume with the point source's
    ``point`` pair (or None). A shard's pass (the sharded kernel's
    schedule): E reads the lower neighbours' H planes ``ghost`` (axis ->
    (6, plane)); H keeps the zero ghost at the hi edges, which
    ``hi_edge_h_plain`` then computes again."""
    terms = plan_terms(cc, line_src, line_dst)
    for a, b in zip(packed.carry_buffers(dst), packed.carry_buffers(src)):
        a.copy_(b)
    e_update_plain(dst["E"], dst["H"], dst.get("J"), dst["psE"], cc["E"],
                   terms, point, ghost)
    h_update_plain(dst["H"], dst["E"], dst["psH"], cc["H"], terms,
                   dst.get("K"))


def hi_edge_cells(cc):
    """The hi-edge planes of a shard: [(axis, index)] of each axis where
    an upper neighbour lies beyond (``cc["open"]``)."""
    shape = cc["shape"]
    return [(b, shape[b] - 1) for b in range(3) if cc["open"][b][1]]


def hi_edge_h_plain(src, dst, cc, line_src, line_dst, ghost) -> None:
    """A shard's hi-edge H (the plain version of ``hi_edge_h``): H, psi_H
    and K of every cell on the shard's hi-edge planes, computed again
    from the source buffers ``src``, the new E in ``dst`` and the upper
    neighbours' first planes of new E ``ghost`` (axis -> (6, plane)),
    and written into ``dst`` there. The whole H update runs into
    scratch copies, and only the hi-edge cells are kept."""
    terms = plan_terms(cc, line_src, line_dst)
    H = src["H"].clone()
    psH = {a: v.clone() for a, v in src["psH"].items()}
    K = src["K"].clone() if "K" in src else None
    h_update_plain(H, dst["E"], psH, cc["H"], terms, K, ghost)
    m = cc["H"]["m"]
    for b, i in hi_edge_cells(cc):
        dst["H"].narrow(1 + b, i, 1).copy_(H.narrow(1 + b, i, 1))
        if K is not None:
            dst["K"].narrow(1 + b, i, 1).copy_(K.narrow(1 + b, i, 1))
        for a, v in psH.items():
            q = 2 * m[a] - 1 if a == b else i
            dst["psH"][a].narrow(1 + b, q, 1).copy_(v.narrow(1 + b, q, 1))


# --------------------------------------------------------------------------
# the CUDA kernel wrappers
# --------------------------------------------------------------------------

class _PairCoef(ctypes.Structure):
    """Mirror of ``struct PairCoef`` in csrc/packed_ds.cu."""
    _fields_ = [("hi", ctypes.c_void_p), ("lo", ctypes.c_void_p),
                ("vh", ctypes.c_float), ("vl", ctypes.c_float)]


class _Coef(ctypes.Structure):
    _fields_ = [("grid", ctypes.c_void_p), ("val", ctypes.c_float)]


class _BoxCoef(ctypes.Structure):
    """Mirror of ``struct BoxCoef`` in csrc/packed_ds.cu."""
    _fields_ = [("grid", ctypes.c_void_p), ("val", ctypes.c_float),
                ("lo", ctypes.c_int * 3), ("hi", ctypes.c_int * 3)]


class _Rec(ctypes.Structure):
    """Mirror of ``struct Rec`` in csrc/packed_ds.cu."""
    _fields_ = [("off", ctypes.c_int), ("comp", ctypes.c_int),
                ("axis", ctypes.c_int), ("plane", ctypes.c_int),
                ("point", ctypes.c_int), ("pad", ctypes.c_int)]


class _Family(ctypes.Structure):
    """Mirror of ``struct Family`` in csrc/packed_ds.cu."""
    _fields_ = [("a", _PairCoef * 3), ("b", _PairCoef * 3),
                ("prof", ctypes.c_void_p * 3),
                ("line_h", ctypes.c_void_p), ("line_l", ctypes.c_void_p),
                ("rec", _Rec * MAX_REC), ("n_rec", ctypes.c_int)]


class _Params(ctypes.Structure):
    """Mirror of ``struct Params`` in csrc/packed_ds.cu."""
    _fields_ = [("E0", ctypes.c_void_p), ("H0", ctypes.c_void_p),
                ("J0", ctypes.c_void_p), ("E2", ctypes.c_void_p),
                ("H2", ctypes.c_void_p), ("J2", ctypes.c_void_p),
                ("K0", ctypes.c_void_p), ("K2", ctypes.c_void_p),
                ("psE0", ctypes.c_void_p * 3), ("psH0", ctypes.c_void_p * 3),
                ("psE2", ctypes.c_void_p * 3), ("psH2", ctypes.c_void_p * 3),
                ("geo", ctypes.c_void_p), ("geo_i0", ctypes.c_void_p),
                ("total", ctypes.c_longlong), ("plan", ctypes.c_void_p),
                ("fe", _Family), ("fh", _Family),
                ("kj", _Coef * 3), ("bj", _Coef * 3),
                ("km", _BoxCoef * 3), ("bm", _BoxCoef * 3),
                ("m", ctypes.c_int * 3), ("pj", ctypes.c_int),
                ("pk", ctypes.c_int), ("n1", ctypes.c_int),
                ("n2", ctypes.c_int), ("n3", ctypes.c_int),
                ("n_item", ctypes.c_int * len(SECTIONS)),
                ("iv_h", ctypes.c_float), ("iv_l", ctypes.c_float),
                ("pt_h", ctypes.c_float), ("pt_l", ctypes.c_float),
                ("glo", ctypes.c_void_p * 3), ("ghi", ctypes.c_void_p * 3),
                ("open_lo", ctypes.c_int * 3), ("open_hi", ctypes.c_int * 3)]


class _Line(ctypes.Structure):
    """Mirror of ``struct Line`` in csrc/packed_ds.cu."""
    _fields_ = [("src", ctypes.c_void_p * 4), ("dst", ctypes.c_void_p * 4),
                ("co", ctypes.c_void_p * 8), ("n", ctypes.c_int),
                ("sh", ctypes.c_float), ("sl", ctypes.c_float)]


def _library() -> ctypes.CDLL:
    lib = build.load(_LIB)
    if not getattr(lib, "_fdtd_bound", False):
        for fn in ("fdtd_ds_pass", "fdtd_ds_hi_edge"):
            getattr(lib, fn).argtypes = [ctypes.POINTER(_Params),
                                         ctypes.c_void_p]
        lib.fdtd_ds_line.argtypes = [ctypes.POINTER(_Line), ctypes.c_void_p]
        lib.fdtd_ds_terms.argtypes = [ctypes.POINTER(_Params), ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p]
        lib.fdtd_ds_eft_probe.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_void_p]
        for fn in ("fdtd_ds_tile", "fdtd_ds_occupancy"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        for fn in ("fdtd_ds_pass", "fdtd_ds_hi_edge", "fdtd_ds_line",
                   "fdtd_ds_terms",
                   "fdtd_ds_eft_probe", "fdtd_ds_tile", "fdtd_ds_occupancy",
                   "fdtd_ds_params_size", "fdtd_ds_line_size"):
            getattr(lib, fn).restype = ctypes.c_int
        lib.fdtd_ds_error_string.argtypes = [ctypes.c_int]
        lib.fdtd_ds_error_string.restype = ctypes.c_char_p
        for name, struct in (("params", _Params), ("line", _Line)):
            size = getattr(lib, f"fdtd_ds_{name}_size")()
            if size != ctypes.sizeof(struct):
                raise RuntimeError(
                    f"{_LIB}: struct {struct.__name__[1:]} is {size} bytes "
                    f"in CUDA and {ctypes.sizeof(struct)} in ctypes")
        lib._fdtd_bound = True
    return lib


def _raise_on(lib, fn: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {err} "
                           f"({lib.fdtd_ds_error_string(err).decode()})")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check(t: torch.Tensor, name: str, shape, device,
           dtype=torch.float32) -> int:
    if t.device != device or t.dtype != dtype \
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {tuple(t.shape)} "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    return t.data_ptr()


def _pair_struct(p, name, shape, device) -> _PairCoef:
    if p[0].dim() == 0:
        return _PairCoef(None, None, float(p[0]), float(p[1]))
    return _PairCoef(_check(p[0], name, shape, device),
                     _check(p[1], name + "_lo", shape, device), 0.0, 0.0)


def _coef_struct(v: torch.Tensor, name, shape, device) -> _Coef:
    if v.dim() == 0:
        return _Coef(None, float(v))
    return _Coef(_check(v, name, shape, device), 0.0)


def _box_struct(fc, key: str, c: int, device) -> _BoxCoef:
    """km (``key`` "kj" of the H family) or bm ("bj") of component c: a
    scalar, or a grid read inside the family's box with its background
    value outside it (a grid equal to its background everywhere is read
    nowhere)."""
    v = fc[key][c]
    out = _BoxCoef()
    if v.dim() == 0:
        out.val = float(v)
        return out
    out.val = fc["bg"][(key, c)]
    box = fc["box"]
    if box:
        out.grid = _check(v, f"{key}[{c}]", fc["shape"], device)
        for a, (lo, hi) in enumerate(box):
            out.lo[a], out.hi[a] = lo, hi
    return out


def _family_struct(fc, device) -> _Family:
    shape = fc["shape"]
    f = _Family()
    for c in range(3):
        f.a[c] = _pair_struct(fc["a"][c], f"a[{c}]", shape, device)
        f.b[c] = _pair_struct(fc["b"][c], f"b[{c}]", shape, device)
    for a, m in fc["m"].items():
        f.prof[a] = _check(fc["prof"][a], f"prof[{a}]", (6, 2 * m), device)
    for r, (rec, off) in enumerate(zip(fc["records"], fc["offsets"])):
        f.rec[r].comp, f.rec[r].axis = rec.comp, rec.axis
        f.rec[r].plane = rec.plane
        f.rec[r].point = int(rec.corr is None)
        f.rec[r].off = 0 if off is None else off
    f.n_rec = len(fc["records"])
    return f


def _device_plan(cc, device, lib):
    """The pass's plan on ``device`` for the tile the library was built
    with and the card's SM count, built once: (rows, counts)."""
    geo = (ctypes.c_int * 2)()
    lib.fdtd_ds_tile(ctypes.addressof(geo))
    key = (device, tuple(geo))
    cached = cc.get("_plan")
    if cached is not None and cached[0] == key:
        return cached[1]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    m = tuple(cc["E"]["m"].get(a, 0) for a in range(3))
    rows, counts = plan_items(cc["shape"], m, tile=(geo[0], geo[1]),
                              sms=sms)
    plan = (torch.from_numpy(rows).to(device), counts)
    cc["_plan"] = (key, plan)
    return plan


def _base_params(cc, device, lib) -> _Params:
    """The static part of the parameter block (coefficients, profiles,
    record tables and geometry, the plan), built and checked once per
    prepared operand set and device."""
    base = cc.get("_params")
    if base is not None and base[0] == device:
        return base[1]
    fe, shape = cc["E"], cc["shape"]
    prm = _Params()
    prm.fe = _family_struct(fe, device)
    prm.fh = _family_struct(cc["H"], device)
    if fe["kj"] is not None:
        for c in range(3):
            prm.kj[c] = _coef_struct(fe["kj"][c], f"kj[{c}]", shape, device)
            prm.bj[c] = _coef_struct(fe["bj"][c], f"bj[{c}]", shape, device)
    if cc["H"]["kj"] is not None:
        for c in range(3):
            prm.km[c] = _box_struct(cc["H"], "kj", c, device)
            prm.bm[c] = _box_struct(cc["H"], "bj", c, device)
    for a, m in fe["m"].items():
        prm.m[a] = m
        if int(np.prod(packed.psi_shape(shape, a, m))) * 2 >= 2 ** 31:
            raise ValueError(f"psi[{a}] of {shape} exceeds the kernel's "
                             "32-bit psi offsets")
    if cc["plan"] is not None:
        total = cc["plan"].total
        if total >= 2 ** 31:
            raise ValueError("the record geometry exceeds the kernel's "
                             "32-bit offsets")
        prm.geo = _check(cc["geo"], "geo", (7, total), device)
        prm.geo_i0 = _check(cc["geo_i0"], "geo_i0", (total,), device,
                            torch.int32)
        prm.total = total
    _, prm.pj, prm.pk = fe["point_pos"]
    prm.n1, prm.n2, prm.n3 = shape
    prm.iv_h, prm.iv_l = (float(v) for v in fe["iv"])
    rows, counts = _device_plan(cc, device, lib)
    prm.plan = rows.data_ptr()
    for q, n in enumerate(counts):
        prm.n_item[q] = n
    cc["_params"] = (device, prm)
    return prm


def _line_pointers(prm: _Params, cc, line_src, line_dst, device) -> None:
    """The record geometry's line halves: E records sample the Hinc of
    ``line_src``, H records the Einc of ``line_dst``."""
    if cc["plan"] is None:
        return
    n = (cc["n_inc"],)
    prm.fe.line_h = _check(line_src["Hinc"], "Hinc", n, device)
    prm.fe.line_l = _check(line_src["Hinc_lo"], "Hinc_lo", n, device)
    prm.fh.line_h = _check(line_dst["Einc"], "Einc (advanced)", n, device)
    prm.fh.line_l = _check(line_dst["Einc_lo"], "Einc_lo (advanced)", n,
                           device)


def ghost_shape(shape, a: int) -> Tuple[int, ...]:
    """Shape of a ghost pair plane of axis a: (6, the grid without a)."""
    out = [6] + list(shape)
    del out[1 + a]
    return tuple(out)


def _shard_params(prm: _Params, cc, device, lo=None, hi=None) -> None:
    """A shard's part of the parameter block: its open sides and its
    ghost pair planes, ``lo`` (old H from below, the pass) and ``hi``
    (new E from above, the hi-edge launch), axis -> (6, plane)."""
    for a, (below, above) in enumerate(cc["open"]):
        prm.open_lo[a], prm.open_hi[a] = int(below), int(above)
    for field, ghosts in (("glo", lo), ("ghi", hi)):
        for a, g in (ghosts or {}).items():
            getattr(prm, field)[a] = _check(g, f"{field}[{a}]",
                                            ghost_shape(cc["shape"], a),
                                            device)


def _pass_params(src, dst, cc, line_src, line_dst, point, lib) -> _Params:
    device = src["E"].device
    shape = cc["shape"]
    prm = _Params.from_buffer_copy(_base_params(cc, device, lib))
    full = (6,) + tuple(shape)
    prm.E0 = _check(src["E"], "E", full, device)
    prm.H0 = _check(src["H"], "H", full, device)
    prm.E2 = _check(dst["E"], "E (destination)", full, device)
    prm.H2 = _check(dst["H"], "H (destination)", full, device)
    jshape = (3,) + tuple(shape)
    if cc["E"]["kj"] is not None:
        prm.J0 = _check(src["J"], "J", jshape, device)
        prm.J2 = _check(dst["J"], "J (destination)", jshape, device)
    if cc["H"]["kj"] is not None:
        prm.K0 = _check(src["K"], "K", jshape, device)
        prm.K2 = _check(dst["K"], "K (destination)", jshape, device)
    for a, m in cc["E"]["m"].items():
        ps = [4] + list(shape)
        ps[1 + a] = 2 * m
        prm.psE0[a] = _check(src["psE"][a], f"psE[{a}]", ps, device)
        prm.psH0[a] = _check(src["psH"][a], f"psH[{a}]", ps, device)
        prm.psE2[a] = _check(dst["psE"][a], f"psE[{a}] (dst)", ps, device)
        prm.psH2[a] = _check(dst["psH"][a], f"psH[{a}] (dst)", ps, device)
    if {t.data_ptr() for t in packed.carry_buffers(src)} \
            & {t.data_ptr() for t in packed.carry_buffers(dst)}:
        raise ValueError("ds_pass writes out of place: the destination "
                         "shares a buffer with the source")
    _line_pointers(prm, cc, line_src, line_dst, device)
    if cc["has_point"]:
        if point is None:
            raise ValueError("the point source's record needs its pair")
        prm.pt_h, prm.pt_l = point
    return prm


def line_advance(src, dst, cc, pair) -> None:
    """The ds incident line from ``src`` into ``dst``: the CUDA kernel
    on CUDA tensors, its plain version on CPU tensors."""
    if not src["Einc"].is_cuda:
        line_advance_plain(src, dst, cc, pair)
        return
    lib = _library()
    device = src["Einc"].device
    n = (cc["n_inc"],)
    line = _Line()
    for q, key in enumerate(LINE_KEYS):
        line.src[q] = _check(src[key], key, n, device)
        line.dst[q] = _check(dst[key], f"{key} (destination)", n, device)
        if line.src[q] == line.dst[q]:
            raise ValueError("line_advance writes out of place")
    coeffs = cc["coeffs"]
    for q, key in enumerate(("inc_ae", "inc_ae_lo", "inc_be", "inc_be_lo",
                             "inc_ah", "inc_ah_lo", "inc_bh", "inc_bh_lo")):
        line.co[q] = _check(coeffs[key], key, n, device)
    line.n = cc["n_inc"]
    line.sh, line.sl = pair
    _raise_on(lib, "fdtd_ds_line",
              lib.fdtd_ds_line(ctypes.byref(line), _stream(device)))
    line_advance.launches += 1


def ds_pass(src, dst, cc, line_src, line_dst, point) -> None:
    """One step of E and H from ``src`` into ``dst``: the CUDA kernels on
    CUDA tensors, their plain version on CPU tensors."""
    if not src["E"].is_cuda:
        ds_pass_plain(src, dst, cc, line_src, line_dst, point)
        return
    lib = _library()
    prm = _pass_params(src, dst, cc, line_src, line_dst, point, lib)
    _raise_on(lib, "fdtd_ds_pass",
              lib.fdtd_ds_pass(ctypes.byref(prm), _stream(src["E"].device)))
    ds_pass.launches += 1
    ds_pass.kernels += sum(n > 0 for n in prm.n_item)


line_advance.launches = 0
ds_pass.launches = 0
ds_pass.kernels = 0     # section kernels launched by those calls


def ds_pass_sharded(src, dst, cc, line_src, line_dst, point,
                    ghost=None) -> None:
    """One shard's pass (the sharded variant of ``ds_pass``): the sharded
    builds of the section kernels, with the shard's open sides
    (``cc["open"]``) and its lo ghost pair planes ``ghost``, on CUDA
    tensors; the plain version on CPU tensors.
    ``ds_pass_sharded.launches`` counts its calls, ``.kernels`` the
    section kernels they launched."""
    if not src["E"].is_cuda:
        ds_pass_plain(src, dst, cc, line_src, line_dst, point, ghost)
        return
    lib = _library()
    prm = _pass_params(src, dst, cc, line_src, line_dst, point, lib)
    _shard_params(prm, cc, src["E"].device, lo=ghost)
    _raise_on(lib, "fdtd_ds_pass",
              lib.fdtd_ds_pass(ctypes.byref(prm), _stream(src["E"].device)))
    ds_pass_sharded.launches += 1
    ds_pass_sharded.kernels += sum(n > 0 for n in prm.n_item)


def hi_edge_h(src, dst, cc, line_src, line_dst, ghost) -> None:
    """A shard's hi-edge H (csrc/packed_ds.cu ``ds_hi_edge``): H, psi_H
    and K of the cells on the shard's hi-edge planes computed again into
    ``dst`` from the source buffers, the new E in ``dst`` and the upper
    neighbours' first planes of new E ``ghost``; the kernel on CUDA
    tensors, ``hi_edge_h_plain`` on CPU tensors. Call it only for a
    shard with an upper neighbour; ``hi_edge_h.launches`` counts its
    launches."""
    if not hi_edge_cells(cc):
        raise ValueError("hi_edge_h: the shard has no upper neighbour")
    if not src["E"].is_cuda:
        hi_edge_h_plain(src, dst, cc, line_src, line_dst, ghost)
        return
    lib = _library()
    # the H launch reads no point source (an E record): any pair will do
    prm = _pass_params(src, dst, cc, line_src, line_dst, (0.0, 0.0), lib)
    _shard_params(prm, cc, src["E"].device, hi=ghost)
    _raise_on(lib, "fdtd_ds_hi_edge",
              lib.fdtd_ds_hi_edge(ctypes.byref(prm),
                                  _stream(src["E"].device)))
    hi_edge_h.launches += 1


ds_pass_sharded.launches = 0
ds_pass_sharded.kernels = 0
hi_edge_h.launches = 0


def device_terms(cc, line_src, line_dst) -> torch.Tensor:
    """The record terms (2, total) by the kernel's own record-term
    device function from two CUDA line buffers (a test-only probe)."""
    lib = _library()
    device = line_src["Hinc"].device
    prm = _Params.from_buffer_copy(_base_params(cc, device, lib))
    _line_pointers(prm, cc, line_src, line_dst, device)
    out = torch.empty((2, cc["plan"].total), dtype=torch.float32,
                      device=device)
    _raise_on(lib, "fdtd_ds_terms", lib.fdtd_ds_terms(
        ctypes.byref(prm), cc["h_first"], ctypes.c_void_p(out.data_ptr()),
        _stream(device)))
    return out


def occupancy() -> Dict[str, Dict[str, int]]:
    """Registers and local (spill) bytes a thread, resident blocks an SM
    and static shared bytes of each pass kernel (SECTIONS, and their
    builds with coefficient grids and Drude J, ``*_grid``; the sharded
    builds ``*_sharded``), as the CUDA runtime reports them for the
    card."""
    lib = _library()
    names = tuple(f"{n}{g}{sh}" for sh in ("", "_sharded")
                  for g in ("", "_grid") for n in SECTIONS)
    out = (ctypes.c_int * (4 * len(names)))()
    _raise_on(lib, "fdtd_ds_occupancy",
              lib.fdtd_ds_occupancy(ctypes.addressof(out)))
    keys = ("registers", "local_bytes", "blocks_per_sm", "static_smem")
    return {n: {k: out[4 * q + i] for i, k in enumerate(keys)}
            for q, n in enumerate(names)}


def eft_probe(a: torch.Tensor, b: torch.Tensor):
    """The kernel's own ``two_sum`` and ``two_prod`` device functions on
    two CUDA float32 tensors of one shape: (s, e, p, pe)."""
    if not a.is_cuda or a.shape != b.shape:
        raise ValueError("eft_probe takes two CUDA tensors of one shape")
    a, b = a.contiguous(), b.contiguous()
    outs = [torch.empty_like(a) for _ in range(4)]
    lib = _library()
    _raise_on(lib, "fdtd_ds_eft_probe", lib.fdtd_ds_eft_probe(
        *(ctypes.c_void_p(t.data_ptr()) for t in (a, b, *outs)),
        ctypes.c_int(a.numel()), _stream(a.device)))
    return tuple(outs)


# --------------------------------------------------------------------------
# the packed-ds step
# --------------------------------------------------------------------------

def make_packed_ds_step(static, device, plain: bool = False):
    """The packed float32x2 step over the packed carry.

    On a CUDA ``device`` it launches the kernels (kind
    ``packed_ds_cuda``): ``line_advance`` (with TFSF) and ``ds_pass``,
    into the step's spare buffers, then swaps them with the carry's; on
    the CPU the same schedule runs their plain versions (kind
    ``packed_ds_plain``). ``plain=True`` runs the reference's own
    schedule in place on any device (torch line ops, ``record_terms``,
    ``e_update_plain``, ``h_update_plain``): the yardstick chip_smoke.py
    holds the kernels against."""
    if not eligible(static):
        raise ValueError(
            "this float32x2 configuration (a 1D/2D mode, or a PML too "
            "thick for slab psi storage) is outside the packed-ds step's "
            "scope: the dispatch runs the plain ds step there, as the "
            "reference runs its jnp-ds step (packed_ds.eligible)")
    if max(static.topology) > 1:
        raise ValueError(f"a static setup on the sharded topology "
                         f"{static.topology} takes "
                         f"make_sharded_packed_ds_step")
    setup = static.tfsf_setup
    ps = static.cfg.point_source
    records = {"E": family_records(static, "E"),
               "H": family_records(static, "H")}
    line_src = tfsf.line_source(setup, static.omega, static.dt) \
        if setup is not None else None
    has_point = any(r.corr is None for r in records["E"])
    point_src = DsSourceTable(ps.waveform, 0.5, static.omega, static.dt,
                              ps.amplitude) if has_point else None
    spare: Dict[str, Any] = {}

    def prepare(coeffs) -> Dict[str, Any]:
        plan = build_term_plan(static, coeffs, records)
        n_inc = setup.n_inc if setup is not None else 0
        cc = {"coeffs": coeffs, "plan": plan, "static": static,
              "shape": tuple(static.grid_shape), "n_inc": n_inc,
              "has_point": has_point}
        for fam in ("E", "H"):
            cc[fam] = prepare_family(static, coeffs, fam, records[fam],
                                     plan)
        cc["geo"], cc["geo_i0"], cc["h_first"] = kernel_geometry(plan,
                                                                 n_inc)
        return cc

    def step(pst: Dict[str, Any], cc: Dict[str, Any]) -> Dict[str, Any]:
        t = pst["t"]
        if not spare:
            spare.update(packed.alloc_like(pst))
            if "inc" in pst:
                spare["inc"] = {k: torch.empty_like(v)
                                for k, v in pst["inc"].items()}
        if setup is not None:
            line_advance(pst["inc"], spare["inc"], cc, line_src(t))
        point = point_src(t) if point_src is not None else None
        ds_pass(pst, spare, cc, pst.get("inc"), spare.get("inc"), point)
        packed.swap_buffers(pst, spare)
        if "inc" in pst:
            pst["inc"], spare["inc"] = spare["inc"], pst["inc"]
        pst["t"] = t + 1
        return pst

    def plain_step(pst: Dict[str, Any],
                   cc: Dict[str, Any]) -> Dict[str, Any]:
        t = pst["t"]
        terms = None
        if setup is not None:
            pst["inc"] = tfsf.advance_einc(pst["inc"], cc["coeffs"], t,
                                           static.dt, static.omega, setup,
                                           source=line_src)
            terms = record_terms(cc["plan"], pst["inc"])
            pst["inc"] = tfsf.advance_hinc(pst["inc"], cc["coeffs"], setup)
        point = point_src(t) if point_src is not None else None
        e_update_plain(pst["E"], pst["H"], pst.get("J"), pst["psE"],
                       cc["E"], terms, point)
        h_update_plain(pst["H"], pst["E"], pst["psH"], cc["H"], terms,
                       pst.get("K"))
        pst["t"] = t + 1
        return pst

    out = plain_step if plain else step
    out.spare = spare
    out.prepare = prepare
    out.pack = lambda state: pack(state, static)
    out.unpack = lambda p: unpack(p, static)
    out.packed = True
    on_cuda = torch.device(device).type == "cuda"
    out.kind = "packed_ds_cuda" if on_cuda and not plain \
        else "packed_ds_plain"
    return out


# --------------------------------------------------------------------------
# the sharded packed-ds step (domain decomposition in one process)
# --------------------------------------------------------------------------

def make_sharded_packed_ds_step(static, mesh, plain: bool = False):
    """The packed-ds step of a decomposed run: every shard of ``mesh`` (a
    ``parallel.mesh.ShardMesh``) holds its piece of the packed carry and
    of the coefficients on its own device, and a step runs in six
    phases:

    1. the incident line advances once on each device that holds a
       shard (``line_advance``, into the device's spare line), and every
       shard there reads the same two line buffers;
    2. each shard with a lower neighbour on a sharded axis receives that
       neighbour's last plane of old H as a pair (``stencil.
       exchange_stack``, a (6, plane) ghost); a shard at the global lo
       edge keeps the PEC zero;
    3. the pass (``ds_pass_sharded``) on every shard, out of place into
       its spare set, reading those ghosts, with PEC walls on the
       global edges only (``cc["open"]``) and its own records
       (``shard_records``: shard-local planes, the global line
       geometry); H at a hi edge with an upper neighbour sees the zero
       ghost;
    4. each shard with an upper neighbour receives that neighbour's
       first plane of new E as a pair;
    5. ``hi_edge_h`` on every such shard computes H, psi_H and K of its
       hi-edge planes again, whole, from the source buffers and those
       ghosts, over what the pass wrote there;
    6. each shard swaps its buffers with its spare set, and each device
       its line buffers once.

    Every cell runs the operations of the unsharded pass, in its order:
    an interior shard's slab profile pairs are exactly identity (psi
    stays 0, the curl term passes unchanged), so a sharded run equals
    the unsharded ``packed_ds`` run value for value. The reference adds
    the missing term to the zero-ghost H after its kernel instead
    (``pallas_packed_ds.py:1237-1280``) and agrees at the ds gates.

    ``plain=True`` runs the plain versions on any device (the yardstick
    of chip_smoke.py). The carry is ``{"shards": [one packed-ds carry a
    shard], "t"}``, the shards of a device sharing one ``inc``; ``pack``
    splits a global dict state onto the shards' devices, ``unpack``
    gives the shards' dict-form views and ``join`` the global dict
    state. Kind ``packed_ds_cuda`` on CUDA devices, ``packed_ds_plain``
    on the CPU or with ``plain``."""
    from fdtd3d_torch.solver import shard_static
    if not eligible(static):
        raise ValueError(
            "this float32x2 configuration is outside the packed-ds step's "
            "scope (solver.sharded_scope refuses it first)")
    local = shard_static(static, mesh)
    types = {d.type for d in mesh.devices}
    if len(types) != 1:
        raise ValueError(f"a mesh mixes device types {sorted(types)}")
    setup = static.tfsf_setup
    ps = static.cfg.point_source
    recs = [shard_records(static, mesh, r) for r in range(mesh.n)]
    has_point = [any(rec.corr is None for rec in rs["E"]) for rs in recs]
    line_src = tfsf.line_source(setup, static.omega, static.dt) \
        if setup is not None else None
    point_src = DsSourceTable(ps.waveform, 0.5, static.omega, static.dt,
                              ps.amplitude) if any(has_point) else None
    line_fn, pass_fn, edge_fn = \
        (line_advance_plain, ds_pass_plain, hi_edge_h_plain) if plain \
        else (line_advance, ds_pass_sharded, hi_edge_h)
    groups = packed.device_groups(mesh)
    exchange, ghosts = packed.make_exchange(mesh)
    spare: List[Dict[str, Any]] = []
    spare_inc: Dict[Any, Dict[str, torch.Tensor]] = {}

    def prepare(coeffs) -> List[Dict[str, Any]]:
        """Per-shard operands from the shards' device coefficients (a
        list, ``mesh.split`` of the global dict moved to each
        device)."""
        n_inc = setup.n_inc if setup is not None else 0
        out = []
        for r, co in enumerate(coeffs):
            off = mesh.offset(r)
            plan = build_term_plan(local, co, recs[r])
            pos = tuple(p - o for p, o in zip(ps.position, off))
            cc = {"coeffs": co, "plan": plan, "static": local,
                  "shape": tuple(local.grid_shape), "n_inc": n_inc,
                  "has_point": has_point[r], "open": mesh.open_sides(r)}
            for fam in ("E", "H"):
                cc[fam] = prepare_family(local, co, fam, recs[r][fam], plan,
                                         pos)
            cc["geo"], cc["geo_i0"], cc["h_first"] = kernel_geometry(
                plan, n_inc)
            out.append(cc)
        return out

    def alloc(shards) -> None:
        spare[:] = [packed.alloc_like(s) for s in shards]
        spare_inc.clear()
        if setup is not None:
            for d, rs in groups.items():
                spare_inc[d] = {k: torch.empty_like(v)
                                for k, v in shards[rs[0]]["inc"].items()}

    def step(carry, cc):
        shards = carry["shards"]
        t = carry["t"]
        if not spare or spare[0]["E"].device != shards[0]["E"].device:
            alloc(shards)
        if setup is not None:
            for d, rs in groups.items():
                line_fn(shards[rs[0]]["inc"], spare_inc[d], cc[rs[0]],
                        line_src(t))
        point = point_src(t) if point_src is not None else None
        lines = [(shards[r].get("inc"), spare_inc.get(d))
                 for r, d in enumerate(mesh.devices)]
        lo = exchange(shards, -1)
        for r, sh in enumerate(shards):
            pass_fn(sh, spare[r], cc[r], *lines[r],
                    point if has_point[r] else None, lo[r])
        hi = exchange(spare, 1)
        for r, sh in enumerate(shards):
            if hi[r]:
                edge_fn(sh, spare[r], cc[r], *lines[r], hi[r])
        for r, sh in enumerate(shards):
            packed.swap_buffers(sh, spare[r])
        if setup is not None:
            for d, rs in groups.items():
                new, spare_inc[d] = spare_inc[d], shards[rs[0]]["inc"]
                for r in rs:
                    shards[r]["inc"] = new
        carry["t"] = t + 1
        for sh in shards:
            sh["t"] = t + 1
        return carry

    step.prepare = prepare
    step.pack, step.unpack, step.join = packed.sharded_carry(mesh, local,
                                                             pack, unpack)
    step.pack_shard = pack
    step.exchange = exchange
    step.ghosts = ghosts
    step.spare = {"shards": spare, "inc": spare_inc}
    step.packed = True
    step.mesh = mesh
    step.kind = "packed_ds_cuda" if "cuda" in types and not plain \
        else "packed_ds_plain"
    step.diag = {"topology": list(mesh.topology), "shards": mesh.n}
    return step

"""Recompute-fused single pass: a whole Yee step in one x-marching pass.

Replaces the Pallas TPU kernel
``fdtd3d_tpu/ops/pallas_fused.py::make_fused_eh_step`` (builder :310,
kernel body :423, ``pallas_call`` :709) for 3D real float32 and bf16
storage, unsharded,
with the hand-written CUDA C++ kernel ``fdtd3d_torch/csrc/fused_eh.cu``
(``sm_90a``, built by nvcc at first use, bound with ctypes). CUDA C++
rather than Triton, as for the port's other stencils: a marching stencil
with shared-memory plane rings fed by cp.async and CPML slab branches.

What the pass computes: new E with every term in the kernel (the curl
of H, the CPML psi of all three slab axes, x included, the TFSF record
terms added into the accumulator before the cb multiply, the Drude
current, the point source after it, the PEC walls), then new H from
that final E (its own psi of every axis and its TFSF records). So the
reference's schedule, whose kernel computes H from the pre-patch E and
whose step then adds the x-slab post-pass, the TFSF and point patches
and the curl of those patches onto H, becomes one computation with
nothing patched afterwards. It moves 12 field volumes a step (48 B/cell
f32) plus psi, against the two-pass step's 18 (ops/pallas3d.py), and
writes out of place: a block computes E redundantly on a halo of cells
that a neighbouring block owns, from the old state.

A step: the E-incident line advance; ``tfsf.record_terms`` (E records
sample Hinc before the Hinc advance, H records Einc after the Einc
advance: both known here); the pass (``fused_eh``: one kernel for each
non-empty section of the work plan); the H-incident line advance. No
other op runs between the record terms and the H-incident advance. The
state dict is not mutated: a new one is returned.

The work plan (``plan_items``, made once per prepared operand set and
card, a small int32 device tensor): (y, z) tiles over x segments, the x
axis cut along its CPML bands, each item classed by the cells it
computes, its hi E halo included (one x plane, one y row and one z
column beyond what it owns): SLAB if one lies in a CPML slab, SOURCE if
one lies on a TFSF record's plane or is the point source's cell, PLAIN
otherwise. The sections of SECTIONS run them, each by its own kernel,
heaviest first; the inner kernel has no slab, record or point code, so a
halo cell always runs its owner's code. ``packed_tb.material`` finds the
box outside which the coefficient grids hold their background value;
only the items that reach it read the grids. The CPU tests check the
plan (tests/test_torch_fused_plan.py) and emulate the schedule item by
item (tests/test_torch_fused_kernel.py).

``fused_eh_plain`` is the kernel's plain PyTorch version in the kernel's
order (E with every term, then H from that E): the CPU step (kind
``fused_plain``) runs it, the CPU tests hold it against the reference's
interpret-mode kernel and ``chip_smoke.py`` holds the kernel against it
on the card. The wrapper ``fused_eh`` takes it only for CPU tensors; on
a CUDA tensor it launches the kernel or raises. ``fused_eh.launches``
counts its calls (one a step), ``fused_eh.kernels`` the section kernels
those calls launched.

bf16 storage: the pass computes in f32 from the widened fields, H from
the unrounded E', and rounds E' and H' to bf16 where it stores them, as
the reference's fused kernel keeps ``new_e`` for its H update
(pallas_fused.py:566-603).

Magnetic Drude K (the reference's :341, :360, :405, :444, :597): the H
half of the pass reads and writes K beside H, ``K' = km K + bm H``
added to H's accumulator after its records, as the E half does Drude J
(taken off). The coefficient grids of K's sphere make the H family's
da/db grids too, so every item reads grids (``packed_tb.material``).

Eligibility (``eligible``): the reference's ``pallas_fused.eligible``
(:48) and every CPML axis slab-compacted (:317-321). Sharded runs (A11)
raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from fdtd3d_torch.ops import packed_tb, pallas3d, tfsf
from fdtd3d_torch.ops.pallas3d import (MAX_REC, Drude, FamOps, Grid,
                                       point_drive, prepare)
from fdtd3d_torch.solver import has_coeff_grids, slab_axes

AXES = "xyz"
_LIB = "fused_eh"
PLAN_COLS = 8         # ints a plan row; mirrors csrc/fused_eh.cu
TILE = (10, 32)       # owned (y, z) cells of a tile at the source's BY, BZ


def eligible(static) -> bool:
    """The reference's ``pallas_fused.eligible`` (:48) plus its slab
    check (:317-321): 3D real f32/bf16, unsharded, not compensated, not
    double-single, every CPML axis slab-compacted."""
    if not pallas3d.eligible(static):
        return False
    if tuple(static.topology) != (1, 1, 1):
        return False
    slabs = slab_axes(static)
    return all(a in slabs for a in static.pml_axes)


def fused_preferred(static) -> bool:
    """The port's rule between the fused and the two-pass twins when
    ``FDTD3D_NO_PACKED`` alone sends a run down the ladder (the
    reference's ``tile >= 4`` was measured against a TPU's VMEM and is
    not copied). A pure function of the static setup: the fused step
    for float32 runs without coefficient grids, the two-pass step for
    bf16 storage and for runs with coefficient grids
    (``solver.has_coeff_grids``).

    Set from same-call CUDA-event times on an NVIDIA H100 80GB HBM3 at
    700 W (``scripts/solo_kernel_times.py --fused
    256,256_bf16,512,512_bf16 --only-fused``, two runs of the change in
    one call, each timing twice): the fused pass against the two-pass
    launches (each call with its host set-up), and the whole steps, on
    ``Examples/vacuum3D_tfsf.txt --same-size 256`` and on
    ``Examples/sphere3D_mie.txt`` (512^3, eps-sphere coefficient grids),
    ms:

    ===========  ===========  ===========  ===========  =============
    grid, dtype  fused pass   e + h        fused step   two-pass step
    ===========  ===========  ===========  ===========  =============
    256^3 f32    0.602-0.611  0.602-0.619  0.684-0.912  0.697-0.993
    256^3 bf16   0.541-0.592  0.503-0.524  0.747-1.069  0.684-1.241
    512^3 f32    4.212-4.242  4.063-4.112  4.339-4.403  4.167-4.246
    512^3 bf16   3.547-3.554  2.922-2.971  3.666-3.717  3.033-3.084
    ===========  ===========  ===========  ===========  =============

    In that call both steps launched 25.05 kernels a step at 256^3
    under the profiler (the two-pass step with its patches as torch ops
    before: 193.05). The fused pass moves 2/3 of the two-pass launches'
    bytes but runs at a smaller share of its bound: at 256^3 in float32
    the two are within the steps' spread, so the rule keeps the fused step
    there; with bf16 storage (two cells a thread in the two-pass march)
    and with grids (read by each family's launch only inside the box of
    its own grids) the two-pass step is the faster one."""
    return eligible(static) and static.cfg.dtype == "float32" \
        and not has_coeff_grids(static)


# --------------------------------------------------------------------------
# the kernel's work plan (host side; csrc/fused_eh.cu runs it)
# --------------------------------------------------------------------------

PLAIN, SOURCE, SLAB = 0, 1, 2   # item classes, lightest first
# the kernel's sections, in launch order (csrc/fused_eh.cu, kKernels):
# the SLAB items touching the slabs of several axes, of x only, of y
# only, of z only, then the SOURCE items, then the PLAIN ones
SECTIONS = ("edge", "edge_x", "edge_y", "edge_z", "source", "inner")
# the slab axes each section's kernel has compiled in (bit a for axis a)
SECTION_AXES = (7, 1, 2, 4, 0, 0)
# relative cost of one plane of an item, by class: the sections run in
# this order, heaviest first, and each section's items heaviest first
CLASS_COST = {PLAIN: 1.0, SOURCE: 1.2, SLAB: 1.7}
# x segment lengths, the first that gives every SM four items
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


def _axis_cuts(n: int, m: int, size: int, bands: bool,
               aligned: bool = False) -> List[Tuple[int, int]]:
    """Owned ranges of an axis: each CPML band and the interior between
    them apart (``bands``), or the whole axis at once, in the fewest
    near-equal pieces of at most ``size``, or (``aligned``) cut at the
    multiples of ``size``."""
    lo, hi = _bands(n, m) if bands else (0, 0)
    out: List[Tuple[int, int]] = []
    for a, b in ((0, lo), (lo, n - hi), (n - hi, n)):
        if b > a and aligned:
            cuts = [a] + list(range((a // size + 1) * size, b, size)) + [b]
            out += list(zip(cuts[:-1], cuts[1:]))
        elif b > a:
            out += _pieces(a, b, -(-(b - a) // size))
    return out


def computed_box(item, shape) -> Tuple[Tuple[int, int], ...]:
    """The cells an item computes (inclusive bounds per axis): E on its
    owned box grown by one cell above on every axis (H reads it), H on
    the owned box, inside the grid. ``item`` = (j0, k0, ny, nz, x0,
    x1)."""
    j0, k0, ny, nz, x0, x1 = (int(v) for v in item[:6])
    return ((x0, min(x1, shape[0] - 1)), (j0, min(j0 + ny, shape[1] - 1)),
            (k0, min(k0 + nz, shape[2] - 1)))


def item_axes(shape, m, item) -> int:
    """The axes whose CPML slab holds a cell the item computes (bit a for
    axis a)."""
    box = computed_box(item, shape)
    return sum(1 << a for a in range(3)
               if m[a] > 0 and (box[a][0] < m[a]
                                or box[a][1] >= shape[a] - m[a]))


def item_class(shape, m, records, point, item) -> int:
    """SLAB if a cell the item computes lies in a CPML slab; else SOURCE
    if one lies on a record's plane or is the point source's cell; else
    PLAIN."""
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


def section(shape, m, row) -> int:
    """The section of SECTIONS that runs an item (a plan row)."""
    if row[6] == SLAB:
        return {1: 1, 2: 2, 4: 3}.get(item_axes(shape, m, row), 0)
    return 4 if row[6] == SOURCE else 5


def reads_grid(item, shape, grids) -> bool:
    """Whether an item's computed cells read a coefficient grid:
    ``grids`` is None (no grid), "all" (everywhere), or the box
    (inclusive bounds per axis, or () when empty) outside which every
    grid holds its background value."""
    if grids is None or grids == ():
        return False
    if grids == "all":
        return True
    box = computed_box(item, shape)
    return all(box[a][0] <= grids[a][1] and grids[a][0] <= box[a][1]
               for a in range(3))


def item_cost(row) -> float:
    """The plan's estimate of an item's time: planes marched (the halo
    plane included) times its class's cost."""
    return (row[5] - row[4] + 1) * CLASS_COST[row[6]]


def plan_items(shape, m, records=(), point=None, tile=TILE, sms=132,
               grids=None, segments=SEGMENTS,
               bands=False) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """The pass's work items: (rows, counts).

    ``rows`` is (n, PLAN_COLS) int32: j0, k0, ny, nz, x0, x1, class,
    grid (an owned box of at most ``tile`` (y, z) cells over x planes
    [x0, x1); ``grid`` 1 if its computed cells read a coefficient grid,
    ``reads_grid``), in the sections of SECTIONS (``counts`` items each,
    the kernel's launches in order; ``section``), heaviest first within
    each (``item_cost``), ties in the order of their x segments. The x
    axis is cut along its CPML bands into segments of at most the
    segment length; y as a whole into near-equal pieces of at most
    ``tile``; z at the multiples of the tile's width, so that each owned
    row is whole aligned 128-byte lines (with ``bands``, y and z band by
    band like x), so the owned boxes tile the grid exactly once. The x segments are the
    first of ``segments`` long that gives the card's ``sms`` SMs four
    items each (else the last). ``m``: slab planes per axis (0: no
    CPML); ``records``: (normal axis, plane) of every TFSF record of
    both families; ``point``: the point source's cell or None."""
    m = tuple(m)
    records = [tuple(r) for r in records]
    ycuts = _axis_cuts(shape[1], m[1], tile[0], bands)
    zcuts = _axis_cuts(shape[2], m[2], tile[1], bands, aligned=True)
    for seg in segments:
        rows = []
        for x0, x1 in _axis_cuts(shape[0], m[0], seg, True):
            for j0, j1 in ycuts:
                for k0, k1 in zcuts:
                    item = (j0, k0, j1 - j0, k1 - k0, x0, x1)
                    rows.append(item + (
                        item_class(shape, m, records, point, item),
                        int(reads_grid(item, shape, grids))))
        if len(rows) >= 4 * sms:
            break
    sections: List[list] = [[] for _ in SECTIONS]
    for r in rows:
        sections[section(shape, m, r)].append(r)
    for sec in sections:
        sec.sort(key=item_cost, reverse=True)
    rows = np.array([r for sec in sections for r in sec],
                    dtype=np.int32).reshape(-1, PLAN_COLS)
    return rows, tuple(len(sec) for sec in sections)


def fused_eh_plain(E, H, psi_e, psi_h, J, fp, terms, drive, K=None):
    """The kernel's computation in torch: new E with every term (the
    psi of every slab axis, the record terms before the cb multiply,
    Drude J, the point source ``drive`` after it, walls), then new H
    from that E (its psi, records and magnetic Drude K). ``terms``:
    ``record_terms``' vector or None; ``drive``: the point source's add
    or None. Returns (E', H', psi_E', psi_H', J' or None, K' or None),
    fresh tensors. bf16 fields: H is computed from the unrounded float32
    E', and both are rounded to bf16 where they are stored, as the
    kernel keeps E' on chip."""
    rec_e = rec_h = point = None
    if terms is not None:
        rec_e = pallas3d.record_adder(fp, "E", terms)
        rec_h = pallas3d.record_adder(fp, "H", terms)
    if drive is not None:
        point = pallas3d.point_adder(fp, drive)
    new_e, pe, new_j = pallas3d._family_plain(E, H, psi_e, J, fp["E"],
                                              True, rec_e, point)
    new_h, ph, new_k = pallas3d._family_plain(H, new_e, psi_h, K, fp["H"],
                                              False, rec_h)
    return (pallas3d.stored(new_e, E), pallas3d.stored(new_h, H), pe, ph,
            new_j, new_k)


class _Params(ctypes.Structure):
    """Mirror of ``struct Params`` in csrc/fused_eh.cu."""
    _fields_ = [("e", FamOps), ("h", FamOps), ("dr", Drude),
                ("dk", Drude), ("g", Grid),
                ("terms", ctypes.c_void_p), ("plan", ctypes.c_void_p),
                ("rec", (pallas3d._Rec * MAX_REC) * 2),
                ("n_rec", ctypes.c_int * 2),
                ("pc", ctypes.c_int), ("pi", ctypes.c_int),
                ("pj", ctypes.c_int), ("pk", ctypes.c_int),
                ("drive", ctypes.c_float),
                ("n_item", ctypes.c_int * len(SECTIONS))]


def _library() -> ctypes.CDLL:
    lib = pallas3d.bind(_LIB, ("fdtd_fused_pass",), _Params)
    if not getattr(lib, "_fused_bound", False):
        for fn in ("fdtd_fused_tile", "fdtd_fused_occupancy"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
        lib._fused_bound = True
    return lib


def _material(fp):
    """``packed_tb.material(fp)``, computed once per prepared operand
    set."""
    if "_material" not in fp:
        fp["_material"] = packed_tb.material(fp)
    return fp["_material"]


def device_plan(fp, device, lib=None) -> Tuple[torch.Tensor,
                                               Tuple[int, ...]]:
    """The plan of a prepared pass on ``device`` for the tile the library
    was built with, the card's SM count and the grids' box, built once:
    (rows, counts)."""
    lib = lib or _library()
    geo = (ctypes.c_int * 2)()
    lib.fdtd_fused_tile(ctypes.addressof(geo))
    key = (device, tuple(geo))
    cached = fp.get("_plan")
    if cached is not None and cached[0] == key:
        return cached[1]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    m, records, point = packed_tb.plan_geometry(fp)
    rows, counts = plan_items(fp["shape"], m, records, point,
                              tile=(geo[0], geo[1]), sms=sms,
                              grids=_material(fp)[0])
    plan = (torch.from_numpy(rows).to(device), counts)
    fp["_plan"] = (key, plan)
    return plan


def occupancy() -> Dict[str, Dict[str, int]]:
    """Registers and local (spill) bytes a thread, resident blocks an SM
    and static shared bytes of each section's kernel, as the CUDA runtime
    reports them for the card: the float32 builds by section name, the
    bf16 ones as ``<section>_bf16``."""
    lib = _library()
    out = (ctypes.c_int * (8 * len(SECTIONS)))()
    err = lib.fdtd_fused_occupancy(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fdtd_fused_occupancy failed: CUDA error {err} "
                           f"({lib.fdtd_error_string(err).decode()})")
    keys = ("registers", "local_bytes", "blocks_per_sm", "static_smem")
    names = SECTIONS + tuple(n + "_bf16" for n in SECTIONS)
    return {n: {k: out[4 * q + i] for i, k in enumerate(keys)}
            for q, n in enumerate(names)}


def _static_params(fp, device, lib) -> _Params:
    """The part of the parameter block that does not change from call to
    call (the work plan, the record tables, the point source's cell),
    built once per prepared operand set and device."""
    cached = fp.get("_params")
    if cached is not None and cached[0] == device:
        return cached[1]
    prm = _Params()
    rows, counts = device_plan(fp, device, lib)
    prm.plan = rows.data_ptr()
    for q, n in enumerate(counts):
        prm.n_item[q] = n
    for f, fam in enumerate(("E", "H")):
        table = fp[f"rec_{fam}"]
        for r, (comp, axis, plane, off) in enumerate(table):
            prm.rec[f][r].comp, prm.rec[f][r].axis = comp, axis
            prm.rec[f][r].plane, prm.rec[f][r].off = plane, off
        prm.n_rec[f] = len(table)
    prm.pc = -1
    if fp["point"] is not None:
        prm.pc, (prm.pi, prm.pj, prm.pk) = fp["point"]
    fp["_params"] = (device, prm)
    return prm


def fused_params(E, H, psi_e, psi_h, J, fp, terms, drive, K=None,
                 lib=None):
    """The call's parameter block on CUDA tensors, with fresh outputs:
    (params, (E', H', psi_E', psi_H', J' or None, K' or None))."""
    fe = fp["E"]
    device = E[fe["comps"][0]].device
    prm = _Params.from_buffer_copy(_static_params(fp, device, lib))
    new_e, pe = pallas3d.fill_family(prm.e, E, psi_e, fe, device)
    new_h, ph = pallas3d.fill_family(prm.h, H, psi_h, fp["H"], device)
    fd = new_e[fe["comps"][0]].dtype
    if any(v.dtype != fd for v in new_h.values()):
        raise ValueError("fused_eh: E and H must share their storage dtype")
    new_j = pallas3d.fill_drude_grid(prm, J, fe, device, fd)
    new_k = pallas3d.fill_ade(prm.dk, K, fp["H"], device)
    # the items that read no grid take each E grid's background value
    for (key, c), value in _material(fp)[1].items():
        getattr(prm.e, key)[c].val = value
    if fp["plan"] is not None:
        prm.terms = pallas3d.check(terms, "terms", (fp["plan"].total,),
                                   device)
    if fp["point"] is not None:
        prm.drive = drive
    return prm, (new_e, new_h, pe, ph, new_j, new_k)


def fused_eh(E, H, psi_e, psi_h, J, fp, terms, drive, K=None):
    """New E, H (and psi, J, K) in fresh tensors: the CUDA kernel (one
    launch a non-empty section) on CUDA tensors, its plain version on
    CPU tensors."""
    first = E[fp["E"]["comps"][0]]
    if not first.is_cuda:
        return fused_eh_plain(E, H, psi_e, psi_h, J, fp, terms, drive, K)
    lib = _library()
    prm, outs = fused_params(E, H, psi_e, psi_h, J, fp, terms, drive, K,
                             lib)
    pallas3d.launch(lib, "fdtd_fused_pass", prm, first.device)
    fused_eh.launches += 1
    fused_eh.kernels += sum(n > 0 for n in prm.n_item)
    return outs


fused_eh.launches = 0
fused_eh.kernels = 0      # section kernels launched by those calls


# --------------------------------------------------------------------------
# the fused step
# --------------------------------------------------------------------------

def make_fused_eh_step(static, device, plain: bool = False):
    """The recompute-fused step on dict-form state (not mutated; a new
    state dict is returned), or None when not ``eligible``.

    On a CUDA ``device`` the kernel launches (kind ``fused_cuda``); on
    the CPU its plain version runs (kind ``fused_plain``). ``plain=True``
    runs the plain version on any device: the yardstick chip_smoke.py
    holds the kernel against."""
    if not eligible(static):
        return None
    setup = static.tfsf_setup
    fn = fused_eh_plain if plain else fused_eh
    psi_names = {fam: [k for v in pallas3d.kernel_psi_terms(
        static, fam).values() for _, k in v] for fam in ("E", "H")}

    def step(state, fp):
        coeffs = fp["coeffs"]
        t = state["t"]
        new_state = dict(state)
        terms = None
        if setup is not None:
            inc = tfsf.advance_einc(state["inc"], coeffs, t, static.dt,
                                    static.omega, setup)
            terms = tfsf.record_terms(fp["plan"], inc)
        new_E, new_H, pe, ph, new_J, new_K = fn(
            state["E"], state["H"],
            {k: state["psi_E"][k] for k in psi_names["E"]},
            {k: state["psi_H"][k] for k in psi_names["H"]},
            state.get("J"), fp, terms, point_drive(static, fp, t),
            K=state.get("K"))
        if setup is not None:
            new_state["inc"] = tfsf.advance_hinc(inc, coeffs, setup)
        if new_J is not None:
            new_state["J"] = new_J
        if new_K is not None:
            new_state["K"] = new_K
        if pe or ph:
            new_state["psi_E"] = dict(state["psi_E"], **pe)
            new_state["psi_H"] = dict(state["psi_H"], **ph)
        new_state["E"] = new_E
        new_state["H"] = new_H
        new_state["t"] = t + 1
        return new_state

    step.prepare = lambda coeffs: prepare(static, coeffs)
    on_cuda = torch.device(device).type == "cuda"
    step.kind = "fused_cuda" if on_cuda and not plain else "fused_plain"
    return step

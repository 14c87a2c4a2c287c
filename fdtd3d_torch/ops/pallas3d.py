"""Two-pass family step: one x-marching CUDA launch per field family.

Replaces the Pallas TPU kernel
``fdtd3d_tpu/ops/pallas3d.py::make_family_kernel`` (builder :167, kernel
body :293, ``pallas_call`` :507), through its step
``make_pallas_step`` (:1068), for 3D real float32 and bf16 storage,
unsharded and on a decomposed grid (``make_sharded_pallas_step``, with
the reference's ``gather_ghosts`` :559), with the hand-written CUDA
C++ kernel ``fdtd3d_torch/csrc/family.cu`` (``sm_90a``, built by nvcc
at first use, bound with ctypes). CUDA C++ rather than Triton: a marching stencil
with shared-memory plane rings fed by cp.async and CPML slab branches,
like the port's other kernels.

The module is named after the reference's, so a reader finds
``fdtd3d_tpu/ops/pallas3d.py`` from it. It runs on the unpacked state
dict (the plain step's form: the chunk runner's ``packed`` is False),
and does not mutate the state it is given: every kernel writes its
outputs into fresh tensors.

What each launch computes: the whole new family, nothing patched
afterwards. ``e_family``: the curl of H by backward differences, the
CPML psi of every slab axis (x too, on the compact ``(2m, n2, n3)``
psi), the TFSF E record terms (added into the accumulator at their
planes before the cb multiply), Drude J, the point source's drive after
it, ca/cb (scalar or grid) and the PEC walls last. ``h_family``: H from
forward differences of that E, its psi of every axis, the TFSF H record
terms and magnetic Drude K. The reference instead computes the pure x
curl in its kernel and patches the x slab (``x_slab_post`` :852), the
TFSF faces (``tfsf_patch`` :961) and the point source
(``point_source_patch`` :1012) onto each kernel's output.

A step: the E-incident line advance; ``tfsf.record_terms`` (E records
sample Hinc before its advance, H records Einc after its advance: both
known here, as in the fused step); ``e_family`` (one kernel for each
non-empty section of its plan, at most 3); the H-incident line advance;
``h_family`` (at most 3 kernels). Nothing else runs on the fields.

The work plan (``plan_items``, one per family, made once per prepared
operand set, card and tile, a small int32 device tensor): (y, z) tiles
of ``TILE_ROWS`` rows by 32 V columns (V = 2 z cells a thread where n3
is even, else 1; z cut at multiples of the tile's width) over x
segments cut along the x CPML bands, each item classed by the cells it
owns (``item_class``): SLAB (a CPML slab cell), SOURCE (a cell on one of
the family's record planes, or the point source's cell for E), PLAIN.
The sections of ``SECTIONS`` run them, each by its own kernel.
``packed.material`` finds, per family, the box outside which its
coefficient grids hold their background value; only the items that
reach it read the grids (the plan row's flag). The CPU tests check the
plan and emulate the march item by item
(tests/test_torch_family_plan.py).

Beside each kernel wrapper stands its plain PyTorch version with the
same signature (``e_family_plain``/``h_family_plain``), in the kernel's
order: the CPU step (kind ``pallas3d_plain``) runs it, the CPU tests
hold it against the reference's interpret-mode kernel and jnp step, and
``chip_smoke.py`` holds the kernel against it on the card. A wrapper
takes the plain version only for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises. ``e_family.launches`` and
``h_family.launches`` count calls; ``.kernels`` the section kernels
those calls launched.

The plain version in the kernel's order, against the reference's
patches. The reference adds ``cb * delta`` (the x slab), ``cb * term``
(a TFSF record) and ``ps_amp * cb * waveform`` (the point source) onto
its kernel's ``ca E + cb acc``; here they go into ``acc`` before the one
multiply, ``ca E + cb (acc + delta + term + drive)``. In float32 that
moves a patched cell by a rounding or two of its value, far inside the
2e-6 gate. With bf16 storage the reference rounds a patched cell twice
(the kernel's store, then the patch's ``.astype(fdt)`` and its add in
bf16) and this kernel once, where it stores: the two results differ by
at most about one bf16 rounding of the cell (2^-8 of its value, 4e-3),
and only on the patched planes, so the port stays inside the
reference's own bf16 gate, 2e-2 of each family's max, against its
interpret-mode ``pallas`` rung and its jnp step
(tests/test_torch_ladder.py holds it on every case of
tests/torch_parity.py and a K sphere). H is computed from the stored
(rounded) E in both.

Magnetic Drude K (the reference's ``drude = static.use_drude_m`` of the
H family, :191): ``h_family`` reads and writes K as ``e_family`` does
J, ``K' = km K + bm H`` added to the H accumulator after its records
(J is taken off E's), km/bm scalars or grids.

A decomposed grid (``make_sharded_pallas_step``): every shard holds
its piece of the dict-form state and of the coefficients; the launches
take the neighbours' boundary planes (``e_family_sharded``/
``h_family_sharded``: the sharded builds of csrc/family.cu, with ghost
planes, PEC walls on the global edges only and, on a y or z axis too
thin for slab psi, psi of the shard's whole local length: the
reference's "full" kind, :159/:242/:253), each shard's TFSF records
with shard-local planes and the point source on its owner shard only
(``shard_prepare``). A thin x axis stays on the plain step, as the
reference's does (:1095-1098).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fdtd3d_torch.layout import CURL_TERMS, component_axis
from fdtd3d_torch.ops import build, packed, packed_tb, tfsf
from fdtd3d_torch.ops.packed import _check as check
from fdtd3d_torch.ops.packed import family_value, field_dtype
from fdtd3d_torch.ops.sources import waveform
from fdtd3d_torch.ops.stencil import diff_ghost, make_diff_ops
from fdtd3d_torch.solver import _slab_fix, slab_axes

AXES = "xyz"
_LIB = "family"
MAX_REC = 16          # records of a family; mirrors csrc/family.cu
_diff_b, _diff_f = make_diff_ops()


def eligible(static) -> bool:
    """The reference's ``pallas3d.eligible`` (:86): 3D real f32/bf16
    storage, not compensated, not double-single; any topology."""
    if static.mode.name != "3D":
        return False
    if static.cfg.dtype not in ("float32", "bfloat16") \
            or static.cfg.complex_fields:
        return False
    return not (static.cfg.compensated or static.cfg.ds_fields)


def full_axes(static) -> Tuple[int, ...]:
    """The CPML axes whose local extent is too thin for slab psi: there
    the kernels keep psi of the whole local length (the reference's
    "full" kind, ``_classify`` :159)."""
    return tuple(sorted(set(static.pml_axes) - set(slab_axes(static))))


def kernel_psi_terms(static, family: str) -> Dict[str, List[Tuple[int, str]]]:
    """component -> [(term index, psi key)] of the psi the family's
    kernels update: the terms along every CPML axis, x included (slab
    psi, or full-length psi on a thin y or z axis)."""
    mode = static.mode
    comps = mode.e_components if family == "E" else mode.h_components
    out: Dict[str, List[Tuple[int, str]]] = {}
    for c in comps:
        terms = CURL_TERMS[component_axis(c)]
        out[c] = [(t, f"{c}_{AXES[a]}") for t, (a, _d, _s) in enumerate(terms)
                  if a in static.pml_axes]
    return out


def family_operands(static, coeffs, family: str) -> Dict[str, Any]:
    """One family's kernel operands from device coefficients: the
    material coefficients per component (host float or grid; the ADE
    current's, Drude J's kj/bj or K's km/bm, under ``kj``/``bj``), the
    slab CPML profiles (3, 2m) of every slab axis (``m``) and the
    full-length ones (3, n) of a thin axis (``full``: axis -> n), the
    in-kernel psi keys, the wall vectors (used by the plain version) and
    the open sides of a shard (``open``: per axis (below, above), none
    unsharded)."""
    from fdtd3d_torch.ops.packed import ade_keys
    mode = static.mode
    comps = mode.e_components if family == "E" else mode.h_components
    tag = "e" if family == "E" else "h"
    pa, pb = ("ca", "cb") if family == "E" else ("da", "db")
    slabs = dict(slab_axes(static))
    fc: Dict[str, Any] = {
        "family": family, "comps": tuple(comps),
        "shape": tuple(static.grid_shape),
        "inv_dx": float(np.float32(1.0 / static.dx)),
        "a": [coeffs[f"{pa}_{c}"] for c in comps],
        "b": [coeffs[f"{pb}_{c}"] for c in comps],
        "kj": None, "bj": None, "m": slabs, "prof": {},
        "full": {a: static.grid_shape[a] for a in full_axes(static)},
        "psi": kernel_psi_terms(static, family),
        "wall": [coeffs[f"wall_{ax}"] for ax in AXES], "comp": None,
        "open": ((False, False),) * 3}
    ade = ade_keys(static, family)
    if ade is not None:
        fc["kj"] = [coeffs[f"{ade[0]}_{c}"] for c in comps]
        fc["bj"] = [coeffs[f"{ade[1]}_{c}"] for c in comps]
    for a in slabs:
        fc["prof"][a] = torch.stack(
            [coeffs[f"pml_slab_{v}{tag}_{AXES[a]}"]
             for v in ("b", "c", "ik")]).contiguous()
    for a in fc["full"]:
        fc["prof"][a] = torch.stack(
            [coeffs[f"pml_{v}{tag}_{AXES[a]}"]
             for v in ("b", "c", "ik")]).contiguous()
    return fc


def psi_len(fc, a: int) -> int:
    """Planes of a family's psi along its own axis a: 2m of a slab axis,
    the local extent of a full one."""
    return 2 * fc["m"][a] if a in fc["m"] else fc["full"][a]


def prepare(static, coeffs, records=None) -> Dict[str, Any]:
    """Both families' operands (``family_operands``), the record plan and
    tables (``tfsf.build_record_plan`` over the TFSF records of
    ``packed_tb.tfsf_records``: (component index, normal axis, plane,
    offset) per record, in the order the kernels add them), and the
    point source's cell and f32 amplitude: what the two-pass and the
    recompute-fused steps' kernels take. ``records`` (family -> TFSF
    records) replace the configuration's: a shard's (``shard_prepare``).
    """
    if records is None:
        records = packed_tb.tfsf_records(static)
    plan = tfsf.build_record_plan(static, coeffs, records)
    fp: Dict[str, Any] = {
        "coeffs": coeffs, "shape": tuple(static.grid_shape),
        "E": family_operands(static, coeffs, "E"),
        "H": family_operands(static, coeffs, "H"),
        "plan": plan, "point": None, "amp": None}
    for fam in ("E", "H"):
        if len(records[fam]) > MAX_REC:
            raise ValueError(f"{len(records[fam])} TFSF records in the "
                             f"{fam} family; the kernels take at most "
                             f"{MAX_REC}")
        fp[f"rec_{fam}"] = [(rec.comp, rec.axis, rec.plane,
                             plan.offsets[(fam, r)])
                            for r, rec in enumerate(records[fam])]
    ps = static.cfg.point_source
    if ps.enabled and ps.component in static.mode.e_components:
        fp["point"] = (static.mode.e_components.index(ps.component),
                       tuple(ps.position))
        fp["amp"] = np.float32(
            torch.as_tensor(coeffs["ps_amp"]).reshape(-1)[0].item())
    return fp


def shard_prepare(static, mesh, r: int, coeffs) -> Dict[str, Any]:
    """Shard r's operands (``prepare`` on the shard's static setup and
    device coefficients): its TFSF records with shard-local planes and
    the global line geometry of its columns, the point source on its
    owner shard only, at its local cell
    (``packed_ds.shard_records``), and the shard's open sides."""
    from fdtd3d_torch.ops.packed_ds import shard_records
    from fdtd3d_torch.solver import shard_static
    recs = shard_records(static, mesh, r)
    tf = {fam: [rec for rec in recs[fam] if rec.corr is not None]
          for fam in ("E", "H")}
    fp = prepare(shard_static(static, mesh), coeffs, tf)
    if fp["point"] is not None:
        owner, cell = mesh.owner(static.cfg.point_source.position)
        fp["point"] = (fp["point"][0], tuple(cell)) if owner == r else None
    for fam in ("E", "H"):
        fp[fam]["open"] = mesh.open_sides(r)
    return fp


def point_drive(static, fp, t: int) -> Optional[float]:
    """The point source's add at step t, ``ps_amp * waveform(t)`` in f32
    (the temporal-blocked pass's drive), or None without one."""
    if fp["point"] is None:
        return None
    ps = static.cfg.point_source
    wf = waveform(ps.waveform, t, 0.5, static.omega, static.dt,
                  static.real_dtype)
    return float(fp["amp"] * wf)


# --------------------------------------------------------------------------
# plain versions (the kernel's arithmetic in torch; CPU tensors and tests)
# --------------------------------------------------------------------------

def _full_fix(a, s, dfa, psi, prof):
    """Full-length CPML psi along axis a (a thin axis): (new psi, the
    accumulator's correction s ((ik - 1) dfa + psi')), psi' = b psi + c
    dfa over the whole local axis, the operations ``_slab_fix`` does on
    each slab plane."""
    b, cc, ik = (v.reshape([-1 if d == a else 1 for d in range(3)])
                 for v in prof)
    new = b * psi + cc * dfa
    return new, s * ((ik - 1.0) * dfa + new)


def _family_plain(F, S, psi, J, fc, backward: bool, records=None,
                  point=None, ghost=None):
    """One family update as the kernels compute it: returns (new fields,
    new in-kernel psi, new ADE current or None), fresh tensors; the
    inputs are not touched. ``J``: the family's ADE current (Drude J on
    E, K on H) or None. ``records(ci, acc)`` and, for E, ``point(ci,
    acc)`` add the sources to component ci's curl accumulator: the
    records after the curl, the point source after the Drude current.
    bf16 fields are widened to float32 before any operation; the new
    fields come back in float32, unrounded (the callers round them where
    the kernel stores them). ``ghost`` (a shard of a decomposed run):
    axis -> the neighbour's plane (3, plane) beyond the edge the
    family's differences reach (E: below, H: above), in place of the
    PEC zero (``stencil.diff_ghost``)."""
    other = "H" if backward else "E"
    S = {k: v.float() for k, v in S.items()}
    new_f, new_psi, new_j = {}, {}, ({} if J is not None else None)
    for ci, c in enumerate(fc["comps"]):
        psi_of = dict(fc["psi"][c])
        acc = None
        for t, (a, d_axis, s) in enumerate(CURL_TERMS[component_axis(c)]):
            g = None if ghost is None else ghost.get(a)
            f = S[other + AXES[d_axis]]
            dfa = (diff_ghost(f, a, backward, g[d_axis].float())
                   if g is not None else
                   (_diff_b if backward else _diff_f)(f, a)) * fc["inv_dx"]
            term = s * dfa
            if t in psi_of:
                key = psi_of[t]
                prof = tuple(fc["prof"][a])
                new_psi[key], fix = (
                    _slab_fix(a, s, dfa, psi[key], prof, fc["m"][a])
                    if a in fc["m"] else _full_fix(a, s, dfa, psi[key], prof))
                term = term + fix
            acc = term if acc is None else acc + term
        if records is not None:
            acc = records(ci, acc)
        drude = None if J is None else (J[c], fc["kj"][ci], fc["bj"][ci])
        hook = None if point is None else (lambda v, ci=ci: point(ci, v))
        new_f[c], jn, _ = family_value(ci, F[c].float(), acc, fc["a"][ci],
                                       fc["b"][ci], fc["wall"], backward,
                                       drude, hook)
        if jn is not None:
            new_j[c] = jn
    return new_f, new_psi, new_j


def record_adder(fp, fam: str, terms):
    """records(ci, acc): each record of component ci of family ``fam``
    adds its plane term (``terms``: ``tfsf.record_terms``' vector) at its
    plane, in table order."""
    shape = fp["shape"]
    table = fp[f"rec_{fam}"]

    def add(ci, acc):
        for comp, axis, plane, off in table:
            if comp != ci:
                continue
            ps = tfsf.plane_shape(shape, axis)
            term = terms.narrow(0, off, int(np.prod(ps))).reshape(ps)
            acc.narrow(axis, plane, 1).add_(term)
        return acc

    return add


def point_adder(fp, drive):
    """point(ci, acc): the point source's ``drive`` added at its cell
    on its component."""
    comp, (i, j, k) = fp["point"]

    def add(ci, acc):
        if ci == comp:
            acc[i:i + 1, j:j + 1, k:k + 1] += drive
        return acc

    return add


def stored(new: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor]):
    """New fields rounded to the storage dtype of ``like`` (the old
    fields of the same family): what the kernel writes."""
    return {c: v.to(like[c].dtype) for c, v in new.items()}


def e_family_plain(E, H, psi, J, fp, terms=None, drive=None, ghost=None):
    """New E (and psi_E of every CPML axis, J) from backward differences
    of H with the E records (``terms``: ``tfsf.record_terms``' vector, or
    None) and the point source's ``drive`` (or None): the plain version
    of ``e_family`` (and, with a shard's H ``ghost`` planes, of
    ``e_family_sharded``)."""
    rec = None if terms is None else record_adder(fp, "E", terms)
    pt = None if drive is None else point_adder(fp, drive)
    new_e, new_psi, new_j = _family_plain(E, H, psi, J, fp["E"], True, rec,
                                          pt, ghost)
    return stored(new_e, E), new_psi, new_j


def h_family_plain(H, E, psi, fp, K=None, terms=None, ghost=None):
    """New H (and psi_H, K with magnetic Drude) from forward differences
    of E with the H records: the plain version of ``h_family`` (and,
    with a shard's E ``ghost`` planes, of ``h_family_sharded``)."""
    rec = None if terms is None else record_adder(fp, "H", terms)
    new_h, new_psi, new_k = _family_plain(H, E, psi, K, fp["H"], False, rec,
                                          None, ghost)
    return stored(new_h, H), new_psi, new_k


# --------------------------------------------------------------------------
# the kernels' work plan (host side; csrc/family.cu runs it)
# --------------------------------------------------------------------------

PLAN_COLS = 8        # j0, k0, ny, nz, x0, x1, class, grid; mirrors the source
PLAIN, SOURCE, SLAB = 0, 1, 2   # item classes
SECTIONS = ("slab", "source", "plain")   # the kernels, in launch order
TILE_ROWS = 4        # rows of a tile (one warp each), the source's TY
WARP = 32            # threads of a tile row
F32_PAIRS = True     # the source's F32_PAIRS: two z cells a thread in f32
SEGMENTS = (16, 8)   # x segment lengths, the first that gives
ITEMS_PER_SM = 6     # every SM this many items


def pairs_for(bf16: bool, n3: int) -> bool:
    """Whether a launch of the default build takes two z cells a thread
    (the source's ``pairs_for``): rows of an even n3 are aligned to words
    of two cells, which bf16 always pairs and float32 with F32_PAIRS."""
    return n3 % 2 == 0 and (bf16 or F32_PAIRS)


def default_tile(bf16: bool, n3: int) -> Tuple[int, int, int]:
    """(tile rows, tile columns, two cells a thread) of the source's
    default build: what ``fdtd_family_tile`` reports on the card."""
    pairs = pairs_for(bf16, n3)
    return TILE_ROWS, WARP * (2 if pairs else 1), int(pairs)


def item_class(shape, m, records, point, item) -> int:
    """SLAB if a cell the item owns lies in a CPML slab; else SOURCE if
    one lies on a record's plane (``records``: (normal axis, plane)) or
    is the point source's cell; else PLAIN."""
    if packed.item_slab(shape, m, item):
        return SLAB
    box = packed.item_box(item)
    if any(box[axis][0] <= plane <= box[axis][1] for axis, plane in records):
        return SOURCE
    if point is not None and all(box[a][0] <= point[a] <= box[a][1]
                                 for a in range(3)):
        return SOURCE
    return PLAIN


def section(row) -> int:
    """The section of SECTIONS that runs an item (a plan row)."""
    return {SLAB: 0, SOURCE: 1, PLAIN: 2}[int(row[6])]


def plan_items(shape, m, records=(), point=None, tile=(TILE_ROWS, WARP),
               sms=132, grids=None, segments=SEGMENTS
               ) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """A family launch's work items: (rows, counts).

    ``rows`` is (n, PLAN_COLS) int32: j0, k0, ny, nz, x0, x1, class,
    grid: an owned box of at most ``tile`` (y, z) cells over x planes
    [x0, x1); ``class`` its ``item_class``, ``grid`` 1 if its cells reach
    the grids' box (``packed.reads_grid``). y is cut into near-equal
    pieces of at most tile[0] rows, z at the multiples of tile[1] (so
    every owned row is whole aligned lines), x along its CPML bands into
    segments (``packed.x_cuts``) of the first length of ``segments`` that
    gives the card's ``sms`` SMs ``ITEMS_PER_SM`` items each (else the
    last): the owned boxes tile the grid exactly once. The items come in
    the sections of SECTIONS (``counts`` items each, the kernels'
    launches in order; ``section``), each section's items longest first,
    ties in plan order. ``m``: slab planes per axis (0: no CPML);
    ``records``: (normal axis, plane) of the family's TFSF records;
    ``point``: the point source's cell (E) or None."""
    n1, n2, n3 = (int(v) for v in shape)
    m = tuple(int(v) for v in m)
    records = [tuple(r) for r in records]
    ycuts = packed._pieces(0, n2, -(-n2 // tile[0]))
    zcuts = [(k, min(k + tile[1], n3)) for k in range(0, n3, tile[1])]
    for seg in segments:
        rows = []
        for x0, x1 in packed.x_cuts(n1, m[0], seg):
            for j0, j1 in ycuts:
                for k0, k1 in zcuts:
                    item = (j0, k0, j1 - j0, k1 - k0, x0, x1)
                    rows.append(item + (
                        item_class(shape, m, records, point, item),
                        int(packed.reads_grid(item, grids))))
        if len(rows) >= ITEMS_PER_SM * sms:
            break
    secs: List[list] = [[] for _ in SECTIONS]
    for r in rows:
        secs[section(r)].append(r)
    for sec in secs:
        sec.sort(key=lambda r: r[5] - r[4], reverse=True)
    out = np.array([r for sec in secs for r in sec],
                   dtype=np.int32).reshape(-1, PLAN_COLS)
    return out, tuple(len(sec) for sec in secs)


def material(fp, family: str):
    """``packed.material`` of one family's operands (the box outside
    which its grids hold their background, and those values), computed
    once per prepared operand set."""
    key = f"_material_{family}"
    if key not in fp:
        fp[key] = packed.material(fp[family])
    return fp[key]


def plan_geometry(fp, family: str):
    """(m per axis, the family's records as (axis, plane), the point
    source's cell for E or None) of a prepared operand set, as
    ``plan_items`` takes them; a full-length psi axis counts as a slab
    of its whole extent, so every item is a SLAB item."""
    fc = fp[family]
    m = tuple(fc["m"].get(a, fc["full"].get(a, 0)) for a in range(3))
    records = tuple((axis, plane) for _, axis, plane, _ in
                    fp[f"rec_{family}"])
    point = None
    if family == "E" and fp["point"] is not None:
        point = tuple(fp["point"][1])
    return m, records, point


# --------------------------------------------------------------------------
# the CUDA kernel wrappers
# --------------------------------------------------------------------------

class Coef(ctypes.Structure):
    """Mirror of ``struct Coef`` in csrc/family_cell.cuh."""
    _fields_ = [("grid", ctypes.c_void_p), ("val", ctypes.c_float)]


class FamOps(ctypes.Structure):
    """Mirror of ``struct FamOps`` in csrc/family_cell.cuh: one family's
    pointers and coefficients."""
    _fields_ = [("F", ctypes.c_void_p * 3), ("out", ctypes.c_void_p * 3),
                ("psi_in", (ctypes.c_void_p * 2) * 3),
                ("psi_out", (ctypes.c_void_p * 2) * 3),
                ("prof", ctypes.c_void_p * 3),
                ("a", Coef * 3), ("b", Coef * 3)]


class Drude(ctypes.Structure):
    """Mirror of ``struct Drude`` in csrc/family_cell.cuh: a family's
    ADE current (J, or K) and its coefficients."""
    _fields_ = [("Jin", ctypes.c_void_p * 3), ("Jout", ctypes.c_void_p * 3),
                ("kj", Coef * 3), ("bj", Coef * 3)]


class Grid(ctypes.Structure):
    """Mirror of ``struct Grid`` in csrc/family_cell.cuh."""
    _fields_ = [("m", ctypes.c_int * 3), ("n", ctypes.c_int * 3),
                ("inv_dx", ctypes.c_float), ("bf16", ctypes.c_int)]


class _Rec(ctypes.Structure):
    """Mirror of ``struct Rec`` in csrc/family.cu (and csrc/fused_eh.cu)."""
    _fields_ = [("off", ctypes.c_int), ("comp", ctypes.c_int),
                ("axis", ctypes.c_int), ("plane", ctypes.c_int)]


class _Params(ctypes.Structure):
    """Mirror of ``struct Params`` in csrc/family.cu."""
    _fields_ = [("f", FamOps), ("S", ctypes.c_void_p * 3),
                ("dr", Drude), ("g", Grid),
                ("terms", ctypes.c_void_p), ("plan", ctypes.c_void_p),
                ("rec", _Rec * MAX_REC), ("n_rec", ctypes.c_int),
                ("pc", ctypes.c_int), ("pi", ctypes.c_int),
                ("pj", ctypes.c_int), ("pk", ctypes.c_int),
                ("drive", ctypes.c_float), ("pairs", ctypes.c_int),
                ("n_item", ctypes.c_int * len(SECTIONS)),
                ("ghost", ctypes.c_void_p * 3),
                ("open_lo", ctypes.c_int * 3), ("open_hi", ctypes.c_int * 3),
                ("full", ctypes.c_int * 3)]


def bind(name: str, fns, params_cls) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library (building it if needed), set
    its entry points' signatures and check that its parameter block has
    the size of ``params_cls``."""
    lib = build.load(name)
    if not getattr(lib, "_fdtd_bound", False):
        for fn in fns:
            f = getattr(lib, fn)
            f.argtypes = [ctypes.POINTER(params_cls), ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.fdtd_params_size.restype = ctypes.c_int
        lib.fdtd_error_string.argtypes = [ctypes.c_int]
        lib.fdtd_error_string.restype = ctypes.c_char_p
        if lib.fdtd_params_size() != ctypes.sizeof(params_cls):
            raise RuntimeError(
                f"{name}: struct Params is {lib.fdtd_params_size()} bytes "
                f"in CUDA and {ctypes.sizeof(params_cls)} in ctypes")
        lib._fdtd_bound = True
    return lib


def launch(lib: ctypes.CDLL, fn: str, prm, device) -> None:
    """Launch ``fn`` on the current stream of ``device``; raise on a
    refused launch."""
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(ctypes.byref(prm), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} "
                           f"({lib.fdtd_error_string(err).decode()})")


def coef_struct(v, name: str, shape, device) -> Coef:
    """A coefficient for the kernel: a grid, or a scalar host float."""
    if isinstance(v, torch.Tensor):
        return Coef(check(v, name, shape, device), 0.0)
    return Coef(None, float(v))


def fill_family(ops: FamOps, F, psi, fc, device) -> Tuple[Dict, Dict]:
    """Fill one family's operand block: old fields, fresh outputs, the
    in-kernel psi (in and fresh out), profiles and coefficients.
    Returns (new fields, new psi)."""
    shape = fc["shape"]
    new_f, new_psi = {}, {}
    for ci, c in enumerate(fc["comps"]):
        fd = field_dtype(F[c])
        ops.F[ci] = check(F[c], c, shape, device, fd)
        new_f[c] = torch.empty(shape, dtype=fd, device=device)
        ops.out[ci] = new_f[c].data_ptr()
        ops.a[ci] = coef_struct(fc["a"][ci], f"a[{c}]", shape, device)
        ops.b[ci] = coef_struct(fc["b"][ci], f"b[{c}]", shape, device)
        for t, key in fc["psi"][c]:
            a = CURL_TERMS[component_axis(c)][t][0]
            ps = list(shape)
            ps[a] = psi_len(fc, a)
            ps = tuple(ps)
            ops.psi_in[ci][t] = check(psi[key], key, ps, device)
            new_psi[key] = torch.empty(ps, dtype=torch.float32,
                                       device=device)
            ops.psi_out[ci][t] = new_psi[key].data_ptr()
    for a in fc["prof"]:
        ops.prof[a] = check(fc["prof"][a], f"prof[{a}]", (3, psi_len(fc, a)),
                            device)
    return new_f, new_psi


def fill_ade(dr: Drude, J, fc, device) -> Optional[Dict]:
    """Fill a ``Drude`` block with a family's ADE current (``fc``'s
    family: Drude J on E, K on H), with fresh outputs; null pointers
    when the family has none. Returns the new current or None."""
    shape = fc["shape"]
    if fc["kj"] is None:
        return None
    name = "J" if fc["family"] == "E" else "K"
    if J is None:
        raise ValueError(f"ADE coefficients given but no {name}")
    new_j = {}
    for ci, c in enumerate(fc["comps"]):
        dr.Jin[ci] = check(J[c], f"{name}[{c}]", shape, device)
        new_j[c] = torch.empty(shape, dtype=torch.float32, device=device)
        dr.Jout[ci] = new_j[c].data_ptr()
        dr.kj[ci] = coef_struct(fc["kj"][ci], f"{name} k[{c}]", shape,
                                device)
        dr.bj[ci] = coef_struct(fc["bj"][ci], f"{name} b[{c}]", shape,
                                device)
    return new_j


def fill_drude_grid(prm, J, fce, device, fd) -> Optional[Dict]:
    """Fill a parameter block's ``dr`` (the ADE current of ``fce``'s
    family, ``fill_ade``) and ``g`` (``fd``: the fields' storage dtype).
    Returns the new current or None."""
    shape = fce["shape"]
    new_j = fill_ade(prm.dr, J, fce, device)
    for a, m in fce["m"].items():
        prm.g.m[a] = m
    for a, n in enumerate(shape):
        prm.g.n[a] = n
    prm.g.inv_dx = fce["inv_dx"]
    prm.g.bf16 = int(fd == torch.bfloat16)
    return new_j


def _library() -> ctypes.CDLL:
    lib = bind(_LIB, ("fdtd_e_family", "fdtd_h_family"), _Params)
    if not getattr(lib, "_family_bound", False):
        lib.fdtd_family_tile.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
        lib.fdtd_family_tile.restype = ctypes.c_int
        lib.fdtd_family_occupancy.argtypes = [ctypes.c_void_p]
        lib.fdtd_family_occupancy.restype = ctypes.c_int
        lib._family_bound = True
    return lib


_SMS: Dict[Any, int] = {}


def launch_geometry(lib, F, n3: int) -> Tuple[Tuple[int, int, int], int]:
    """(tile, SM count) of a launch on the card: the tile the library was
    built with for these fields (``fdtd_family_tile``) and the card's
    SMs, for the plan."""
    out = (ctypes.c_int * 3)()
    lib.fdtd_family_tile(int(F.dtype == torch.bfloat16), n3,
                         ctypes.addressof(out))
    if F.device not in _SMS:
        _SMS[F.device] = torch.cuda.get_device_properties(
            F.device).multi_processor_count
    return tuple(out), _SMS[F.device]


def device_plan(fp, family: str, device, tile, sms=132
                ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """A family's plan on ``device`` for ``tile`` (rows, columns, two
    cells a thread) and the card's ``sms``, built once: (rows, counts)."""
    key = (device, tuple(tile), sms)
    cached = fp.get(f"_plan_{family}")
    if cached is not None and cached[0] == key:
        return cached[1]
    m, records, point = plan_geometry(fp, family)
    rows, counts = plan_items(fp["shape"], m, records, point,
                              tile=tuple(tile[:2]), sms=sms,
                              grids=material(fp, family)[0])
    plan = (torch.from_numpy(rows).to(device), counts)
    fp[f"_plan_{family}"] = (key, plan)
    return plan


def _params(F, S, psi, J, fp, family: str, terms=None, drive=None,
            tile=None, sms=132, ghost=None):
    """The launch's parameter block on the fields' device, with fresh
    outputs: (params, new fields, new psi, new ADE current or None).
    ``tile``: (rows, columns, two cells a thread) of the library's build
    (``default_tile`` when None); ``sms``: the card's SM count, for the
    plan. Items outside the family's grid box take each grid's
    background value as their scalar. A shard of a decomposed run:
    ``fp[family]["open"]`` its open sides, ``fp[family]["full"]`` its
    full-length psi axes, ``ghost`` axis -> the neighbour's plane (3,
    the grid without the axis) beyond its edge (E: below, H: above)."""
    fc = fp[family]
    device = F[fc["comps"][0]].device
    shape = fc["shape"]
    fd = field_dtype(F[fc["comps"][0]])
    if tile is None:
        tile = default_tile(fd == torch.bfloat16, shape[2])
    prm = _Params()
    new_f, new_psi = fill_family(prm.f, F, psi, fc, device)
    other = "H" if family == "E" else "E"
    for d in range(3):
        key = other + AXES[d]
        prm.S[d] = check(S[key], key, shape, device, fd)
    new_j = fill_drude_grid(prm, J, fc, device, fd)
    for (key, c), value in material(fp, family)[1].items():
        blk = prm.dr if key in ("kj", "bj") else prm.f
        getattr(blk, key)[c].val = value
    rows, counts = device_plan(fp, family, device, tile, sms)
    prm.plan = rows.data_ptr()
    for q, n in enumerate(counts):
        prm.n_item[q] = n
    prm.pairs = tile[2]
    table = fp[f"rec_{family}"]
    for r, (comp, axis, plane, off) in enumerate(table):
        prm.rec[r].comp, prm.rec[r].axis = comp, axis
        prm.rec[r].plane, prm.rec[r].off = plane, off
    prm.n_rec = len(table)
    if table and fp["plan"] is not None:
        if terms is None:
            raise ValueError(f"{family} family: TFSF records but no terms")
        prm.terms = check(terms, "terms", (fp["plan"].total,), device)
    prm.pc = -1
    if family == "E" and fp["point"] is not None:
        if drive is None:
            raise ValueError("E family: a point source but no drive")
        prm.pc, (prm.pi, prm.pj, prm.pk) = fp["point"]
        prm.drive = drive
    for a, (lo, hi) in enumerate(fc["open"]):
        prm.open_lo[a], prm.open_hi[a] = int(lo), int(hi)
    for a in fc["full"]:
        prm.full[a] = 1
    for a, g in (ghost or {}).items():
        prm.ghost[a] = check(g, f"ghost[{a}]", packed.ghost_shape(shape, a),
                             device, fd)
    return prm, new_f, new_psi, new_j


def _launch_family(fn: str, F, S, psi, J, fp, family, terms, drive,
                   ghost=None):
    lib = _library()
    first = F[fp[family]["comps"][0]]
    prm, new_f, new_psi, new_j = _params(
        F, S, psi, J, fp, family, terms, drive,
        *launch_geometry(lib, first, fp["shape"][2]), ghost=ghost)
    launch(lib, fn, prm, first.device)
    return sum(n > 0 for n in prm.n_item), (new_f, new_psi, new_j)


def e_family(E, H, psi, J, fp, terms=None, drive=None):
    """New E (and psi_E, J) in fresh tensors: the CUDA kernels (one
    launch a non-empty section) on CUDA tensors, the plain version on CPU
    tensors."""
    if not E[fp["E"]["comps"][0]].is_cuda:
        return e_family_plain(E, H, psi, J, fp, terms, drive)
    n, outs = _launch_family("fdtd_e_family", E, H, psi, J, fp, "E", terms,
                             drive)
    e_family.launches += 1
    e_family.kernels += n
    return outs


def h_family(H, E, psi, fp, K=None, terms=None):
    """New H (and psi_H, K) in fresh tensors: the CUDA kernels on CUDA
    tensors, the plain version on CPU tensors."""
    if not H[fp["H"]["comps"][0]].is_cuda:
        return h_family_plain(H, E, psi, fp, K, terms)
    n, outs = _launch_family("fdtd_h_family", H, E, psi, K, fp, "H", terms,
                             None)
    h_family.launches += 1
    h_family.kernels += n
    return outs


e_family.launches = h_family.launches = 0
e_family.kernels = h_family.kernels = 0   # section kernels launched


def e_family_sharded(E, H, psi, J, fp, terms=None, drive=None, ghost=None):
    """One shard's new E (the sharded variant of ``e_family``): the
    sharded CUDA kernels with the shard's open sides, full-length psi
    axes and H ``ghost`` planes on CUDA tensors, the plain version on CPU
    tensors. ``e_family_sharded.launches`` counts calls, ``.kernels``
    the section kernels."""
    if not E[fp["E"]["comps"][0]].is_cuda:
        return e_family_plain(E, H, psi, J, fp, terms, drive, ghost)
    n, outs = _launch_family("fdtd_e_family", E, H, psi, J, fp, "E", terms,
                             drive, ghost)
    e_family_sharded.launches += 1
    e_family_sharded.kernels += n
    return outs


def h_family_sharded(H, E, psi, fp, K=None, terms=None, ghost=None):
    """One shard's new H (the sharded variant of ``h_family``), with its
    E ``ghost`` planes; ``h_family_sharded.launches`` counts calls."""
    if not H[fp["H"]["comps"][0]].is_cuda:
        return h_family_plain(H, E, psi, fp, K, terms, ghost)
    n, outs = _launch_family("fdtd_h_family", H, E, psi, K, fp, "H", terms,
                             None, ghost)
    h_family_sharded.launches += 1
    h_family_sharded.kernels += n
    return outs


e_family_sharded.launches = h_family_sharded.launches = 0
e_family_sharded.kernels = h_family_sharded.kernels = 0


KERNEL_NAMES = tuple(
    f"{fam}_{store}_{cells}_{sec}{shard}" for shard in ("", "_sharded")
    for fam in ("e", "h") for store in ("f32", "bf16")
    for cells in ("one", "pair") for sec in SECTIONS)


def occupancy() -> Dict[str, Dict[str, int]]:
    """Registers and local (spill) bytes a thread, resident blocks an SM
    and static shared bytes of each kernel of the library, as the CUDA
    runtime reports them for the card, by ``KERNEL_NAMES``: family,
    storage, one or two z cells a thread, section, and ``_sharded`` for
    the sharded builds."""
    lib = _library()
    out = (ctypes.c_int * (4 * len(KERNEL_NAMES)))()
    err = lib.fdtd_family_occupancy(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fdtd_family_occupancy failed: CUDA error {err} "
                           f"({lib.fdtd_error_string(err).decode()})")
    keys = ("registers", "local_bytes", "blocks_per_sm", "static_smem")
    return {n: {k: out[4 * q + i] for i, k in enumerate(keys)}
            for q, n in enumerate(KERNEL_NAMES)}


# --------------------------------------------------------------------------
# the two-pass step
# --------------------------------------------------------------------------

def make_pallas_step(static, device, plain: bool = False):
    """The two-pass step on dict-form state (not mutated; a new state
    dict is returned), or None when the reference would not take it (not
    ``eligible``, or a CPML x axis too thin for slab psi, where the
    reference runs its jnp step). A y or z axis too thin for slab psi
    keeps psi of its whole length (the sharded builds of the kernel).

    On a CUDA ``device`` the two family updates launch the kernels (kind
    ``pallas3d_cuda``); on the CPU they run their plain versions (kind
    ``pallas3d_plain``). ``plain=True`` runs the plain versions on any
    device: the yardstick chip_smoke.py holds the kernels against."""
    if tuple(static.topology) != (1, 1, 1):
        raise ValueError(
            f"a static setup on the sharded topology {static.topology} "
            f"steps through make_sharded_pallas_step (it takes the mesh)")
    if not eligible(static) or 0 in full_axes(static):
        return None
    setup = static.tfsf_setup
    e_fn, h_fn = (e_family_plain, h_family_plain) if plain \
        else (e_family, h_family)
    psi_names = {fam: [k for v in kernel_psi_terms(static, fam).values()
                       for _, k in v] for fam in ("E", "H")}

    def step(state, fp):
        coeffs = fp["coeffs"]
        t = state["t"]
        new_state = dict(state)
        terms = None
        if setup is not None:
            inc = tfsf.advance_einc(state["inc"], coeffs, t, static.dt,
                                    static.omega, setup)
            terms = tfsf.record_terms(fp["plan"], inc)
        new_E, pe, new_J = e_fn(
            state["E"], state["H"], {k: state["psi_E"][k]
                                     for k in psi_names["E"]},
            state.get("J"), fp, terms, point_drive(static, fp, t))
        if setup is not None:
            new_state["inc"] = tfsf.advance_hinc(inc, coeffs, setup)
        new_H, ph, new_K = h_fn(
            state["H"], new_E, {k: state["psi_H"][k]
                                for k in psi_names["H"]},
            fp, state.get("K"), terms)
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
    step.kind = "pallas3d_cuda" if on_cuda and not plain else "pallas3d_plain"
    return step


# --------------------------------------------------------------------------
# the sharded two-pass step (domain decomposition in one process)
# --------------------------------------------------------------------------

def make_sharded_pallas_step(static, mesh, plain: bool = False):
    """The two-pass step of a decomposed run: every shard of ``mesh`` (a
    ``parallel.mesh.ShardMesh``) holds its piece of the dict-form state
    and of the coefficients on its own device, and a step runs in six
    phases:

    1. the E-incident line advances once a device (its shards share it)
       and each shard's record terms are taken from it;
    2. each shard with a lower neighbour on a sharded axis receives that
       neighbour's last plane of old H (``stencil.exchange_components``,
       the ghost); a shard at the global lo edge keeps the PEC zero;
    3. ``e_family_sharded`` on every shard: the whole new E, with its
       records and the point source's drive (its owner only) in the
       kernel, PEC walls on the global edges only;
    4. the H-incident line advances;
    5. each shard with an upper neighbour receives that neighbour's
       first plane of new E;
    6. ``h_family_sharded`` on every shard.

    Nothing is patched. The reference's step (pallas3d.py:1068-1183)
    patches the x slab, the TFSF faces and the point source after each
    kernel, ownership-gated per shard (:961, :1012); here they are in
    the kernel, as in the unsharded two-pass step, so a cell computes
    the same operations in the same order as there: an interior shard's
    slab rows are identity (b = c = 0, 1/kappa = 1), and a thin shard's
    full-length psi (``full_axes``) is identity outside the absorber, so
    its curl terms keep their values. A sharded run is the unsharded
    two-pass run value for value (a zero's sign aside).

    Each shard's new family replaces its old one as soon as its launch
    returns (the carry's shard dicts are updated in place), so a card
    holds one family's new set beside the old one at a time, not a
    second state. ``plain=True`` runs the plain versions on any device
    (the yardstick of chip_smoke.py). The carry is ``{"shards": [one
    dict-form state a shard], "t"}`` (``packed.sharded_carry`` with
    identity pack and unpack): ``pack`` splits a global dict state onto
    the shards' devices, ``unpack`` gives the shards' dicts (a list) and
    ``join`` the global dict state (new tensors); ``pack_shard`` is None
    (the zero carry is the dict form). Kind ``pallas3d_cuda`` on CUDA
    devices, ``pallas3d_plain`` on the CPU or with ``plain``."""
    from fdtd3d_torch.solver import shard_static
    local = shard_static(static, mesh)
    if not eligible(local) or 0 in full_axes(local):
        raise ValueError(
            "the sharded two-pass step takes 3D real float32 or bf16 "
            "storage, not compensated, with slab psi on a CPML x axis "
            "(solver.sharded_scope)")
    types = {d.type for d in mesh.devices}
    if len(types) != 1:
        raise ValueError(f"a mesh mixes device types {sorted(types)}")
    setup = static.tfsf_setup
    e_fn, h_fn = (e_family_plain, h_family_plain) if plain \
        else (e_family_sharded, h_family_sharded)
    mode = static.mode
    names = {"E": tuple(mode.e_components), "H": tuple(mode.h_components)}
    groups = packed.device_groups(mesh)
    exchange, ghosts = packed.make_exchange(mesh, names)
    psi_names = {fam: [k for v in kernel_psi_terms(local, fam).values()
                       for _, k in v] for fam in ("E", "H")}

    def prepare(coeffs) -> List[Dict[str, Any]]:
        """Per-shard operands from the shards' device coefficients (a
        list, ``mesh.split`` of the global dict moved to each device)."""
        return [shard_prepare(static, mesh, r, cc)
                for r, cc in enumerate(coeffs)]

    def advance_line(shards, fps, fn):
        for rs in groups.values():
            inc = fn(shards[rs[0]]["inc"], fps[rs[0]]["coeffs"])
            for r in rs:
                shards[r]["inc"] = inc

    def step(carry, fps):
        shards = carry["shards"]
        t = carry["t"]
        terms = [None] * len(shards)
        if setup is not None:
            advance_line(shards, fps, lambda inc, co: tfsf.advance_einc(
                inc, co, t, static.dt, static.omega, setup))
            terms = [tfsf.record_terms(fp["plan"], ps["inc"])
                     for ps, fp in zip(shards, fps)]
        gh = exchange(shards, -1)
        for r, (ps, fp) in enumerate(zip(shards, fps)):
            new_e, pe, new_j = e_fn(
                ps["E"], ps["H"], {k: ps["psi_E"][k] for k in psi_names["E"]},
                ps.get("J"), fp, terms[r], point_drive(local, fp, t),
                ghost=gh[r])
            ps["E"] = new_e
            if pe:
                ps["psi_E"] = dict(ps["psi_E"], **pe)
            if new_j is not None:
                ps["J"] = new_j
        if setup is not None:
            advance_line(shards, fps, lambda inc, co: tfsf.advance_hinc(
                inc, co, setup))
        ge = exchange(shards, 1)
        for r, (ps, fp) in enumerate(zip(shards, fps)):
            new_h, ph, new_k = h_fn(
                ps["H"], ps["E"], {k: ps["psi_H"][k] for k in psi_names["H"]},
                fp, ps.get("K"), terms[r], ghost=ge[r])
            ps["H"] = new_h
            if ph:
                ps["psi_H"] = dict(ps["psi_H"], **ph)
            if new_k is not None:
                ps["K"] = new_k
        carry["t"] = t + 1
        for ps in shards:
            ps["t"] = t + 1
        return carry

    step.prepare = prepare
    step.pack, step.unpack, step.join = packed.sharded_carry(
        mesh, local, lambda piece, _local: piece, lambda ps, _local: ps)
    step.pack_shard = None
    step.exchange = exchange
    step.ghosts = ghosts
    step.packed = True
    step.mesh = mesh
    step.kind = "pallas3d_cuda" if "cuda" in types and not plain \
        else "pallas3d_plain"
    step.diag = {"topology": list(mesh.topology), "shards": mesh.n}
    return step

"""Packed single-step leapfrog: stacked E/H carry, two CUDA launches.

Replaces the Pallas TPU kernel
``fdtd3d_tpu/ops/pallas_packed.py::make_packed_eh_step`` (builder :548,
kernel body :694, ``pallas_call`` :1138) for 3D real float32 and bf16
storage, with the hand-written CUDA C++ kernel
``fdtd3d_torch/csrc/packed_eh.cu`` (``sm_90a``, built by nvcc at first
use, bound with ctypes). CUDA C++
rather than Triton: a stencil with per-cell coefficients and CPML slab
branches, which wants explicit control of its indexing.

What bounds it on the card: memory bytes and the requests a thread
makes. A step does ~60 flops per cell against 48 B/cell of unavoidable
traffic (E and H read once and written once), far below the H100's ~20
flops per byte. The TPU kernel's lagged-H carry needs an ordered grid,
which CUDA does not have, and a single CUDA pass would need a wavefront
across blocks or a spare copy of E, H, J and K to recompute halos out
of place (ROADMAP B1(d)), so a step is two launches on the stacked
layout, ``e_update`` then ``h_update``, each updating its family in
place: 18 field volumes (72 B/cell) a step. Each launch marches x over
the (y, z) tiles of a host work plan (``plan_items``, a small int32
device tensor made once per prepared family, lane count and tile):
whole aligned 128-byte z rows, the source family read once an item
through a shared-memory plane ring fed by cp.async, two z cells a
thread in bf16 and compensated mode (4-byte requests), the coefficient
grids read only by the items that reach their box (``material``), and
the items with a CPML slab cell run by their own kernel
(csrc/packed_eh.cu). TFSF and the point source are torch plane patches
between the launches (ops/patches.py), in the plain step's order: E
update, E patches, Hinc advance, H update, H patches. The x-slab CPML
therefore runs in-kernel for every source position: the curl that feeds
psi never includes a source term.

bf16 storage (the reference's ``fst = static.field_dtype``,
pallas_packed.py:591): E and H are bf16, psi, J and the coefficients
f32; the kernels load the fields as floats, compute in f32 and round
each new value to bf16 where they store it, so the H launch reads the
rounded E. The patches between the launches add their value rounded to
bf16 onto the stored field, as the reference's patches do (the sum is
rounded again), so a face cell differs from the plain step by a bf16
rounding or two.

Magnetic Drude K (the reference's :630-635 and :955-962): the H launch
reads and writes K as the E launch does J, ``K' = km K + bm H`` added to
H's accumulator (J is taken off E's), with km/bm scalars or grids.

Compensated (Kahan) float32 (:588-589, :757-759, :872-881, :963-972):
both launches scale every difference by the double-single 1/dx, apply
the scalar coefficients' double-single low words and feed back the
bf16 residuals ``rE``/``rH`` (read and written in place beside the
field, zeroed by the PEC walls with E). That variant runs in the plain
version's order with every product and sum explicitly rounded
(``__fmul_rn``/``__fadd_rn``, no FMA contraction), so it reproduces the
plain version's bits; the uncompensated builds keep their arithmetic.
As in the reference, the variant takes scalar coefficients only
(``declines`` sends compensated runs with a grid to the plain step),
and the patches between the launches add onto the field in plain f32
and leave the residuals alone (pallas_packed.py:94-103).

Layout (the port's own; parity is judged on the unpacked state):
``E``, ``H`` (3, n1, n2, n3); ``psE[a]``/``psH[a]`` the compact slab psi
of axis a, (2, ...) with dim 1+a of 2m planes, rows = the two
components with a curl term along a, in component order; ``J``
(3, n1, n2, n3) with Drude, ``K`` likewise with magnetic Drude, ``rE``,
``rH`` (3, n1, n2, n3) bf16 in compensated mode; ``inc`` and ``t`` as in
the dict form.

Lanes: the same kernels are the port of the reference's lane-capable
build (``make_packed_eh_step_batched``, :537, whose ``pallas_call`` the
batch executor vmaps). With ``batch=B`` every carry leaf has a leading
lane axis (``E`` (B, 3, n1, n2, n3), psi (B, 2, ...), ``J``, the
incident line (B, n)), a coefficient is a host float shared by every
lane, a shared grid (n1, n2, n3) or a per-lane grid (B, n1, n2, n3), and
one launch per family advances all B lanes (the lane is a column of
the plan's rows; the grids' box is the union of the lanes'). The
sources carry per-lane values as device tensors: the TFSF face patch
its per-lane ``cb``, the point source ``ps_amp * cb`` per lane. A solo
run (``batch=0``) keeps the carry without the lane axis and launches
the same kernels with one lane.

Shards (``make_sharded_packed_step``): a decomposed run's shards each
run the two launches on their local grid with the neighbours' boundary
planes as ghost operands (``e_update_sharded``/``h_update_sharded``,
``Params.ghost``) and PEC walls on the global edges only
(``fc["open"]``); the plain versions take the same ghosts.

Beside each kernel wrapper stands its plain PyTorch version with the
same signature (``e_update_plain``/``h_update_plain``), on the solo
and the lane-stacked layouts alike. A wrapper uses the plain version
only for tensors on the CPU; on a CUDA tensor it launches the kernel or
raises. ``e_update.launches`` and ``h_update.launches`` count their
calls (one per call, whatever the number of lanes; a call launches one
kernel for each non-empty section of the plan).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from fdtd3d_torch.layout import component_axis
from fdtd3d_torch.ops import build, patches, tfsf
from fdtd3d_torch.ops.stencil import (diff_ghost, exchange_stack,
                                      ghost_buffers, make_diff_ops)
from fdtd3d_torch.solver import _bcast1d, _slab_fix, slab_axes

AXES = "xyz"
_LIB = "packed_eh"
_diff_b, _diff_f = make_diff_ops()


# the carry's per-component stacks besides E, H and psi, with the
# components they stack: Drude J, magnetic Drude K, the Kahan residuals
STACKED_AUX = (("J", "e_components"), ("K", "h_components"),
               ("rE", "e_components"), ("rH", "h_components"))


def eligible(static) -> bool:
    """The reference's ``pallas_packed.eligible`` (:229), unsharded: 3D
    real float32 or bf16 storage (not complex: a complex run's legs are
    real), not double-single, and not
    compensated mode with magnetic Drude K (whose residual the kernel
    does not Kahan-treat)."""
    cfg = static.cfg
    return static.mode.name == "3D" \
        and cfg.dtype in ("float32", "bfloat16") \
        and not cfg.complex_fields \
        and not (static.use_drude_m and cfg.compensated)


def declines(static) -> bool:
    """Whether the reference's packed kernel declines this configuration
    and its dispatch runs the jnp step instead: compensated mode with a
    coefficient grid (its double-single coefficients are embedded
    scalars, pallas_packed.py:647) or with magnetic Drude K (whose
    residual is not Kahan-treated, :251). The port runs its plain step
    there, and no kernel."""
    from fdtd3d_torch.solver import has_coeff_grids
    return bool(static.cfg.compensated
                and (static.use_drude_m or has_coeff_grids(static)))


def psi_row(c: int, a: int) -> int:
    """Row of component c in the psi stack of axis a (the two
    components other than a, in order)."""
    return c if c < a else c - 1


def pack(state: Dict[str, Any], static, lanes: bool = False
         ) -> Dict[str, Any]:
    """Dict-form state -> packed carry (new tensors). ``lanes``: every
    leaf of the state carries a leading lane axis, which stays in front
    of the stacked component axis."""
    mode = static.mode
    d = int(lanes)
    p: Dict[str, Any] = {
        "E": torch.stack([state["E"][c] for c in mode.e_components], d),
        "H": torch.stack([state["H"][c] for c in mode.h_components], d),
        "t": int(state["t"]),
        "psE": {}, "psH": {}}
    for a in slab_axes(static):
        for fam, key, comps in (("psE", "psi_E", mode.e_components),
                                ("psH", "psi_H", mode.h_components)):
            rows = [c for c in comps if component_axis(c) != a]
            p[fam][a] = torch.stack(
                [state[key][f"{c}_{AXES[a]}"] for c in rows], d)
    for key, comps in STACKED_AUX:
        if key in state:
            comps = getattr(mode, comps)
            p[key] = torch.stack([state[key][c] for c in comps], d)
    if static.tfsf_setup is not None:
        p["inc"] = {k: v.clone() for k, v in state["inc"].items()}
    return p


def unpack(p: Dict[str, Any], static, lanes: bool = False
           ) -> Dict[str, Any]:
    """Packed carry -> dict-form state (views into the carry)."""
    mode = static.mode
    d = int(lanes)
    state: Dict[str, Any] = {
        "E": {c: p["E"].select(d, j)
              for j, c in enumerate(mode.e_components)},
        "H": {c: p["H"].select(d, j)
              for j, c in enumerate(mode.h_components)},
        "t": p["t"]}
    if p["psE"]:
        state["psi_E"], state["psi_H"] = {}, {}
        for a in p["psE"]:
            for fam, key, comps in (("psE", "psi_E", mode.e_components),
                                    ("psH", "psi_H", mode.h_components)):
                rows = [c for c in comps if component_axis(c) != a]
                for r, c in enumerate(rows):
                    state[key][f"{c}_{AXES[a]}"] = p[fam][a].select(d, r)
    for key, comps in STACKED_AUX:
        if key in p:
            state[key] = {c: p[key].select(d, j)
                          for j, c in enumerate(getattr(mode, comps))}
    if "inc" in p:
        state["inc"] = dict(p["inc"])
    return state


def baked_coeff_keys(static) -> Tuple[str, ...]:
    """Coefficient keys the packed kernels take as one scalar for every
    lane when their host value is scalar (np.ndim < 3): the reference's
    ``pallas_packed.baked_coeff_keys`` (:517). The batch dispatch
    authority (``solver.batch_fallback_reason``) sweeps them across
    lanes; a scalar that differs between lanes would run lane 0's value
    in every lane (``scalar_coeff_divergence``)."""
    mode = static.mode
    pairs_e = ["ca", "cb"] + (["kj", "bj"] if static.use_drude else [])
    pairs_h = ["da", "db"] + (["km", "bm"] if static.use_drude_m else [])
    keys = [f"{p}_{c}" for c in mode.e_components for p in pairs_e]
    keys += [f"{p}_{c}" for c in mode.h_components for p in pairs_h]
    return tuple(keys)


def ade_keys(static, family: str):
    """The family's ADE (auxiliary current) coefficient names, or None:
    Drude J's ``kj``/``bj`` on E, magnetic Drude K's ``km``/``bm`` on
    H. The operand dicts keep them under ``kj``/``bj`` for either
    family, and the kernels take them as the family's one ADE current
    (taken off E's accumulator, added to H's)."""
    if family == "E":
        return ("kj", "bj") if static.use_drude else None
    return ("km", "bm") if static.use_drude_m else None


def prepare_family(static, coeffs, family: str) -> Dict[str, Any]:
    """Per-family kernel operands from device coefficients: scalar or
    grid coefficients per component (the ADE current's under
    ``kj``/``bj``), the slab CPML profiles (3, 2m) per axis, the wall
    vectors (used by the plain version), and in compensated mode the
    coefficients' low words and 1/dx's (``comp``: a_lo, b_lo,
    inv_dx_lo; None otherwise)."""
    from fdtd3d_torch.solver import inv_dx_pair
    mode = static.mode
    comps = mode.e_components if family == "E" else mode.h_components
    tag = "e" if family == "E" else "h"
    pa, pb = ("ca", "cb") if family == "E" else ("da", "db")
    fc: Dict[str, Any] = {
        "family": family, "shape": tuple(static.grid_shape),
        "inv_dx": float(np.float32(1.0 / static.dx)),
        "a": [coeffs[f"{pa}_{c}"] for c in comps],
        "b": [coeffs[f"{pb}_{c}"] for c in comps],
        "kj": None, "bj": None, "m": dict(slab_axes(static)), "prof": {},
        "wall": [coeffs[f"wall_{ax}"] for ax in AXES], "comp": None}
    ade = ade_keys(static, family)
    if ade is not None:
        fc["kj"] = [coeffs[f"{ade[0]}_{c}"] for c in comps]
        fc["bj"] = [coeffs[f"{ade[1]}_{c}"] for c in comps]
    if static.cfg.compensated:
        fc["comp"] = {"a_lo": [coeffs[f"{pa}_{c}_lo"] for c in comps],
                      "b_lo": [coeffs[f"{pb}_{c}_lo"] for c in comps],
                      "inv_dx_lo": inv_dx_pair(static.dx)[1]}
    for a in fc["m"]:
        fc["prof"][a] = torch.stack(
            [coeffs[f"pml_slab_{v}{tag}_{AXES[a]}"]
             for v in ("b", "c", "ik")]).contiguous()
    return fc


# --------------------------------------------------------------------------
# plain versions (the kernel's arithmetic in torch; CPU tensors and tests)
# --------------------------------------------------------------------------

def family_value(c: int, old, acc, a, b, walls, backward: bool,
                 drude=None, point=None, comp=None):
    """Component c's new value from its curl accumulator, as the kernels
    compute it: the family's ADE current ``drude`` = (J or K, k, b):
    J' = kj J + bj old taken off E's acc (``backward``), K' = km K +
    bm old added to H's; then, for E, ``point(acc)``; ca old + cb acc
    (H: da old - db acc), or in compensated mode (``comp`` = (a_lo,
    b_lo, old residual)) the Kahan update of ``solver.kahan_update``;
    and for E the PEC walls of the other two axes (``walls``: one vector
    per axis), on the residual too. -> (new value, new ADE current or
    None, new residual or None). Shared with the dict-form plain version
    (ops/pallas3d.py)."""
    from fdtd3d_torch.solver import kahan_update
    jn = r = None
    if drude is not None:
        J, kj, bj = drude
        jn = kj * J + bj * old
        acc = acc - jn if backward else acc + jn
    if point is not None:
        acc = point(acc)
    if comp is not None:
        v, r = kahan_update(old, acc, a, b, *comp, backward)
    else:
        v = a * old + b * acc if backward else a * old - b * acc
    if backward:
        for w in range(3):
            if w != c:
                wv = _bcast1d(walls[w], w)
                v = v * wv
                if r is not None:
                    r = r * wv
    return v, jn, r


def scaled_diff(d0, fc):
    """A difference over dx as the kernels scale it: ``d0 * inv_dx``, or
    in compensated mode ``d0 * inv_dx + d0 * inv_dx_lo``."""
    if fc["comp"] is None:
        return d0 * fc["inv_dx"]
    return d0 * fc["inv_dx"] + d0 * fc["comp"]["inv_dx_lo"]


def _curl_diff(f, a: int, backward: bool, ghost, d: int):
    """The difference of component d's field ``f`` along axis a: with
    the PEC zero beyond the edge, or a neighbour shard's plane from
    ``ghost`` (axis -> (3, plane)) where it has one."""
    g = None if ghost is None else ghost.get(a)
    if g is None:
        return (_diff_b if backward else _diff_f)(f, a)
    return diff_ghost(f, a, backward, g[d].float())


def _family_plain(F, S, J, psi, fc, backward: bool, records=None,
                  point=None, R=None, ghost=None) -> None:
    """One family update in place. ``J``: the family's ADE current (J on
    E, K on H) or None; ``R``: the Kahan residuals (bf16) in compensated
    mode. ``records(c, acc)`` and, for E, ``point(c, acc)`` add in-kernel
    sources to component c's curl accumulator (the temporal-blocked
    pass, ops/packed_tb.py): the records after the curl, the point
    source after the Drude current, as the reference's kernels order
    them. bf16 fields are widened to float32 before any operation and
    the new values rounded to bf16 where they are stored, as the kernel
    loads and stores them. ``ghost`` (a shard of a decomposed run):
    axis -> the neighbour's plane (3, plane) beyond the edge the
    family's differences reach (E: below, H: above)."""
    S = S.float()
    for c in range(3):
        acc = None
        for t in range(2):
            a, d = (c + 1 + t) % 3, (c + 2 - t) % 3
            s = 1.0 if t == 0 else -1.0
            dfa = scaled_diff(_curl_diff(S[d], a, backward, ghost, d), fc)
            if a in fc["m"]:
                row = psi[a][psi_row(c, a)]
                new_psi, fix = _slab_fix(a, s, dfa, row,
                                         tuple(fc["prof"][a]), fc["m"][a])
                row.copy_(new_psi)
                acc = fix if acc is None else acc + fix
            acc = s * dfa if acc is None else acc + s * dfa
        if records is not None:
            acc = records(c, acc)
        drude = None if J is None else (J[c], fc["kj"][c], fc["bj"][c])
        hook = None if point is None else (lambda acc, c=c: point(c, acc))
        comp = None if fc["comp"] is None else (
            fc["comp"]["a_lo"][c], fc["comp"]["b_lo"][c], R[c])
        v, jn, r = family_value(c, F[c].float(), acc, fc["a"][c],
                                fc["b"][c], fc["wall"], backward, drude,
                                hook, comp)
        if jn is not None:
            J[c].copy_(jn)
        if r is not None:
            R[c].copy_(r)
        F[c].copy_(v)


def lane_fc(fc: Dict[str, Any], lane: int) -> Dict[str, Any]:
    """One lane's family operands: per-lane coefficient grids
    (B, n1, n2, n3) cut to the lane; scalars and shared grids as they
    are."""
    def cut(v):
        return v[lane] if isinstance(v, torch.Tensor) and v.dim() == 4 \
            else v
    out = {k: v for k, v in fc.items() if not k.startswith("_")}
    for key in ("a", "b", "kj", "bj"):
        if fc[key] is not None:
            out[key] = [cut(v) for v in fc[key]]
    return out


def lane_views(F, S, J, psi, R=None):
    """The solo-layout operands of every lane: a solo carry is its own
    single lane; a lane-stacked one yields a view per lane."""
    if F.dim() == 4:
        yield None, F, S, J, psi, R
        return
    for lane in range(F.shape[0]):
        yield (lane, F[lane], S[lane], None if J is None else J[lane],
               {a: v[lane] for a, v in psi.items()},
               None if R is None else R[lane])


def e_update_plain(E, H, J, psi, fc, R=None, ghost=None) -> None:
    """E (and J, psi_E, the residual rE in compensated mode) in place
    from backward differences of H, on the solo or the lane-stacked
    layout (one lane after the other). ``ghost``: a shard's H ghost
    planes (axis -> the lower neighbour's last plane), solo layout
    only."""
    for lane, e, h, j, ps, r in lane_views(E, H, J, psi, R):
        _family_plain(e, h, j, ps, fc if lane is None else lane_fc(fc, lane),
                      backward=True, R=r, ghost=ghost)


def h_update_plain(H, E, psi, fc, K=None, R=None, ghost=None) -> None:
    """H (and K with magnetic Drude, psi_H, the residual rH in
    compensated mode) in place from forward differences of E, on the
    solo or the lane-stacked layout. ``ghost``: a shard's E ghost
    planes (axis -> the upper neighbour's first plane)."""
    for lane, h, e, k, ps, r in lane_views(H, E, K, psi, R):
        _family_plain(h, e, k, ps, fc if lane is None else lane_fc(fc, lane),
                      backward=False, R=r, ghost=ghost)


# --------------------------------------------------------------------------
# the kernels' work plan (host side; csrc/packed_eh.cu runs it)
# --------------------------------------------------------------------------

PLAN_COLS = 8        # j0, k0, ny, nz, x0, x1, lane, flags; mirrors the source
GRID, SLAB = 1, 2    # plan row flags: reads the grids, has a CPML slab cell
TILE_ROWS = 8        # rows of a tile (one warp each), the source's TY
WARP = 32            # threads of a tile row
F32_PAIRS = False    # the source's F32_PAIRS: two z cells a thread in f32
SEGMENTS = (16, 8)   # x segment lengths, the first that gives
ITEMS_PER_SM = 6     # every SM this many items


def pairs_for(bf16: bool, comp: bool, n3: int,
              f32_pairs: bool = F32_PAIRS) -> bool:
    """Whether a launch takes two z cells a thread (the source's
    ``pairs_for``): rows of an even n3 are aligned to words of two cells;
    bf16 and compensated mode always pair them, float32 with
    ``f32_pairs``."""
    return n3 % 2 == 0 and (bf16 or comp or f32_pairs)


def default_tile(bf16: bool, comp: bool, n3: int
                 ) -> Tuple[int, int, int, int]:
    """(tile rows, tile columns, sections, two cells a thread) of the
    source's default build: what ``fdtd_packed_tile`` reports on the
    card."""
    pairs = pairs_for(bf16, comp, n3)
    return TILE_ROWS, WARP * (2 if pairs else 1), 1, int(pairs)


def _pieces(a: int, b: int, k: int) -> List[Tuple[int, int]]:
    """[a, b) in k near-equal pieces (fewer if it is shorter than k)."""
    n = b - a
    k = max(1, min(k, n))
    cuts = [a + (n * q) // k for q in range(k + 1)]
    return list(zip(cuts[:-1], cuts[1:])) if n > 0 else []


def x_cuts(n: int, m: int, seg: int) -> List[Tuple[int, int]]:
    """The x segments: the low CPML band, the interior and the high band
    apart (with an m-plane slab), each in the fewest near-equal pieces of
    at most ``seg`` planes."""
    bands = [(0, m), (m, n - m), (n - m, n)] if 0 < m and 2 * m < n \
        else [(0, n)]
    out: List[Tuple[int, int]] = []
    for a, b in bands:
        out += _pieces(a, b, -(-(b - a) // seg))
    return out


def item_box(item) -> Tuple[Tuple[int, int], ...]:
    """The cells an item owns and computes (inclusive bounds per axis x,
    y, z); ``item`` = (j0, k0, ny, nz, x0, x1, ...)."""
    j0, k0, ny, nz, x0, x1 = (int(v) for v in item[:6])
    return ((x0, x1 - 1), (j0, j0 + ny - 1), (k0, k0 + nz - 1))


def item_slab(shape, m, item) -> bool:
    """Whether a cell of the item lies in the CPML slab of an axis
    (``m``: slab planes a side per axis, 0 without)."""
    box = item_box(item)
    return any(m[a] > 0 and (box[a][0] < m[a]
                             or box[a][1] >= shape[a] - m[a])
               for a in range(3))


def reads_grid(item, grids) -> bool:
    """Whether an item's cells read the coefficient grids: ``grids`` is
    None (no grid), "all" (everywhere), or the box (inclusive bounds per
    axis, () when empty) outside which every grid holds its background
    value (``material``)."""
    if grids is None or grids == ():
        return False
    if grids == "all":
        return True
    box = item_box(item)
    return all(box[a][0] <= grids[a][1] and grids[a][0] <= box[a][1]
               for a in range(3))


def plan_items(shape, m, lanes: int = 1, tile=(TILE_ROWS, WARP), sms=132,
               grids=None, segments=SEGMENTS, sections: bool = True
               ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """A launch's work items: (rows, counts).

    ``rows`` is (n, PLAN_COLS) int32: j0, k0, ny, nz, x0, x1, lane,
    flags: an owned box of at most ``tile`` (y, z) cells over x planes
    [x0, x1) of one lane; flags GRID if its cells reach the grids' box
    (``reads_grid``), SLAB if one lies in a CPML slab (``item_slab``).
    y is cut into near-equal pieces of at most tile[0] rows, z at the
    multiples of tile[1] (so every owned row is whole aligned lines), x
    along its CPML bands into segments (``x_cuts``) of the first length
    of ``segments`` that gives the card's ``sms`` SMs ``ITEMS_PER_SM``
    items each (else the last), for every lane: the owned boxes tile
    each lane's grid exactly once. With ``sections`` the SLAB items come
    first and ``counts`` = (SLAB items, the others), the slab and the
    plain kernel's launches; without, every item runs the slab kernel
    (counts (n, 0)). Each section's items run longest first, ties in
    plan order. ``m``: slab planes per axis (0: no CPML); ``grids``: as
    ``reads_grid`` takes it, the same for every lane."""
    n1, n2, n3 = (int(v) for v in shape)
    m = tuple(int(v) for v in m)
    ycuts = _pieces(0, n2, -(-n2 // tile[0]))
    zcuts = [(k, min(k + tile[1], n3)) for k in range(0, n3, tile[1])]
    for seg in segments:
        rows = []
        for lane in range(lanes):
            for x0, x1 in x_cuts(n1, m[0], seg):
                for j0, j1 in ycuts:
                    for k0, k1 in zcuts:
                        item = (j0, k0, j1 - j0, k1 - k0, x0, x1)
                        flags = GRID * reads_grid(item, grids) \
                            + SLAB * item_slab(shape, m, item)
                        rows.append(item + (lane, flags))
        if len(rows) >= ITEMS_PER_SM * sms:
            break
    secs: List[list] = [[], []]
    for r in rows:
        secs[0 if r[7] & SLAB or not sections else 1].append(r)
    for sec in secs:
        sec.sort(key=lambda r: r[5] - r[4], reverse=True)
    out = np.array(secs[0] + secs[1], dtype=np.int32).reshape(-1, PLAN_COLS)
    return out, (len(secs[0]), len(secs[1]))


def material(fc) -> Tuple[Any, Dict[Tuple[str, int], float]]:
    """Where a family's coefficient grids (a, b and its ADE current's kj,
    bj) differ from their background: (``grids`` as ``plan_items`` takes
    it, the background value of each grid by (key, component)). A grid's
    background is its value at cell (0, 0, 0), which must be the same on
    every lane, else every item reads the grids ("all"); the box is the
    union over the grids and the lanes. ``packed_tb.material``'s rule,
    for one family of the packed step."""
    shape = tuple(fc["shape"])
    lo: List[Any] = [None] * 3
    hi: List[Any] = [None] * 3
    bg: Dict[Tuple[str, int], float] = {}
    for key in ("a", "b", "kj", "bj"):
        for c, v in enumerate(fc[key] or []):
            if not isinstance(v, torch.Tensor):
                continue
            lanes = v.reshape((-1,) + shape)
            corner = lanes[:, 0, 0, 0]
            if not bool((corner == corner[0]).all()):
                return "all", {}
            bg[(key, c)] = float(corner[0])
            mask = (lanes != corner[0]).any(0)
            for a, proj in enumerate((mask.any(2).any(1), mask.any(2).any(0),
                                      mask.any(1).any(0))):
                idx = torch.nonzero(proj).flatten()
                if idx.numel():
                    lo[a] = min(int(idx[0]), shape[a] if lo[a] is None
                                else lo[a])
                    hi[a] = max(int(idx[-1]), -1 if hi[a] is None else hi[a])
    if not bg:
        return None, {}
    return (() if lo[0] is None else tuple(zip(lo, hi))), bg


# --------------------------------------------------------------------------
# the CUDA kernel wrappers
# --------------------------------------------------------------------------

class _Coef(ctypes.Structure):
    """Mirror of ``struct Coef`` in csrc/packed_eh.cu and packed_tb.cu."""
    _fields_ = [("grid", ctypes.c_void_p), ("lane", ctypes.c_longlong),
                ("val", ctypes.c_float)]


class _Params(ctypes.Structure):
    """Mirror of ``struct Params`` in csrc/packed_eh.cu."""
    _fields_ = [("F", ctypes.c_void_p), ("S", ctypes.c_void_p),
                ("J", ctypes.c_void_p), ("R", ctypes.c_void_p),
                ("psi", ctypes.c_void_p * 3), ("prof", ctypes.c_void_p * 3),
                ("field_lane", ctypes.c_longlong),
                ("psi_lane", ctypes.c_longlong * 3),
                ("m", ctypes.c_int * 3),
                ("a", _Coef * 3), ("b", _Coef * 3),
                ("kj", _Coef * 3), ("bj", _Coef * 3),
                ("a_lo", ctypes.c_float * 3), ("b_lo", ctypes.c_float * 3),
                ("n1", ctypes.c_int), ("n2", ctypes.c_int),
                ("n3", ctypes.c_int), ("lanes", ctypes.c_int),
                ("inv_dx", ctypes.c_float), ("inv_dx_lo", ctypes.c_float),
                ("bf16", ctypes.c_int), ("pairs", ctypes.c_int),
                ("plan", ctypes.c_void_p), ("n_item", ctypes.c_int * 2),
                ("ghost", ctypes.c_void_p * 3),
                ("open_lo", ctypes.c_int * 3), ("open_hi", ctypes.c_int * 3)]


def _library() -> ctypes.CDLL:
    lib = build.load(_LIB)
    if not getattr(lib, "_fdtd_bound", False):
        for fn in ("fdtd_e_update", "fdtd_h_update"):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.fdtd_packed_tile.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
        lib.fdtd_packed_tile.restype = ctypes.c_int
        lib.fdtd_packed_occupancy.argtypes = [ctypes.c_void_p]
        lib.fdtd_packed_occupancy.restype = ctypes.c_int
        lib.fdtd_params_size.restype = ctypes.c_int
        lib.fdtd_error_string.argtypes = [ctypes.c_int]
        lib.fdtd_error_string.restype = ctypes.c_char_p
        if lib.fdtd_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"{_LIB}: struct Params is {lib.fdtd_params_size()} bytes "
                f"in CUDA and {ctypes.sizeof(_Params)} in ctypes")
        lib._fdtd_bound = True
    return lib


FIELD_DTYPES = (torch.float32, torch.bfloat16)   # the kernels' storage


def _check(t: torch.Tensor, name: str, shape, device,
           dtype=torch.float32) -> int:
    """The data pointer of a contiguous tensor of ``dtype`` and ``shape``
    on ``device``; anything else raises."""
    if t.device != device or t.dtype != dtype \
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {tuple(t.shape)} "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    return t.data_ptr()


def field_dtype(t: torch.Tensor) -> torch.dtype:
    """The storage dtype of a kernel's fields (float32 or bfloat16; the
    other operands are float32 either way); anything else raises."""
    if t.dtype not in FIELD_DTYPES:
        raise ValueError(f"the kernels store fields in float32 or bfloat16, "
                         f"got {t.dtype}")
    return t.dtype


def _coef_struct(v, name, shape, device, lanes: int) -> _Coef:
    """A coefficient for the kernel: a scalar for every lane, a grid
    shared by every lane (lane stride 0) or a per-lane grid."""
    if not isinstance(v, torch.Tensor):
        return _Coef(None, 0, float(v))
    if v.dim() == 4:
        vol = shape[0] * shape[1] * shape[2]
        return _Coef(_check(v, name, (lanes,) + tuple(shape), device), vol,
                     0.0)
    return _Coef(_check(v, name, shape, device), 0, 0.0)


def carry_lanes(F: torch.Tensor) -> Tuple[int, Tuple[int, ...]]:
    """(lanes, leading dims) of a stacked field: a solo carry
    (3, n1, n2, n3) is one lane with no lane axis; a batch carry is
    (B, 3, n1, n2, n3)."""
    return (F.shape[0], (F.shape[0],)) if F.dim() == 5 else (1, ())


def psi_shape(shape, a: int, m: int, lead=()) -> Tuple[int, ...]:
    """Shape of the compact slab psi stack of axis a."""
    ps = [2] + list(shape)
    ps[1 + a] = 2 * m
    return tuple(lead) + tuple(ps)


def carry_buffers(carry) -> List[torch.Tensor]:
    """The buffers an out-of-place pass reads and writes, in a fixed
    order: E, H, psi, J, K."""
    out = [carry["E"], carry["H"]]
    out += [carry["psE"][a] for a in sorted(carry["psE"])]
    out += [carry["psH"][a] for a in sorted(carry["psH"])]
    out += [carry[k] for k in ("J", "K") if k in carry]
    return out


def alloc_like(carry) -> Dict[str, Any]:
    """A spare set of a carry's pass buffers (E, H, psi, J, K)."""
    return {"E": torch.empty_like(carry["E"]),
            "H": torch.empty_like(carry["H"]),
            "psE": {a: torch.empty_like(v) for a, v in carry["psE"].items()},
            "psH": {a: torch.empty_like(v) for a, v in carry["psH"].items()},
            **{k: torch.empty_like(carry[k]) for k in ("J", "K")
               if k in carry}}


def swap_buffers(carry, spare) -> None:
    """Exchange the pass buffers between the carry and the spare."""
    for key in ("E", "H", "J", "K"):
        if key in carry:
            carry[key], spare[key] = spare[key], carry[key]
    for fam in ("psE", "psH"):
        for a in carry[fam]:
            carry[fam][a], spare[fam][a] = spare[fam][a], carry[fam][a]


def ghost_shape(shape, a: int) -> Tuple[int, ...]:
    """Shape of a ghost plane of axis a: (3, the grid without a)."""
    out = [3] + list(shape)
    del out[1 + a]
    return tuple(out)


def _params(F, S, J, psi, fc, R=None, tile=None, sms=132,
            ghost=None) -> _Params:
    """The launch's parameter block; the static part (coefficients with
    each grid's background, profiles, the work plan) is built and checked
    once per prepared family, device, lane count and tile. ``J``: the
    family's ADE current (J or K) or None; ``R``: the bf16 Kahan
    residuals of compensated mode (``fc["comp"]`` set), whose
    coefficients the kernel takes as scalars only. ``tile``: (rows,
    columns, sections, two cells a thread) of the library's build
    (``default_tile`` when None); ``sms``: the card's SM count, for the
    plan. A shard of a decomposed run: ``fc["open"]`` per axis (below,
    above) whether a neighbour lies there (no PEC wall on that side),
    ``ghost`` axis -> the neighbour's plane (``ghost_shape``) the
    launch reads beyond its edge (E: below, H: above)."""
    device = F.device
    shape = fc["shape"]
    lanes, lead = carry_lanes(F)
    fd = field_dtype(F)
    comp = fc["comp"]
    if tile is None:
        tile = default_tile(fd == torch.bfloat16, comp is not None, shape[2])
    key = (device, lanes, tuple(tile))
    base = fc.get("_params")
    if base is None or base[0] != key:
        prm = _Params()
        if comp is not None:
            for c in range(3):
                for k in ("a", "b"):
                    if isinstance(fc[k][c], torch.Tensor) \
                            or isinstance(comp[f"{k}_lo"][c], torch.Tensor):
                        raise ValueError(
                            "the compensated kernel takes scalar "
                            "coefficients only (packed.declines "
                            "sends grids to the plain step)")
                prm.a_lo[c] = float(comp["a_lo"][c])
                prm.b_lo[c] = float(comp["b_lo"][c])
            prm.inv_dx_lo = comp["inv_dx_lo"]
        for c in range(3):
            prm.a[c] = _coef_struct(fc["a"][c], f"a[{c}]", shape, device,
                                    lanes)
            prm.b[c] = _coef_struct(fc["b"][c], f"b[{c}]", shape, device,
                                    lanes)
            if fc["kj"] is not None:
                prm.kj[c] = _coef_struct(fc["kj"][c], f"kj[{c}]", shape,
                                         device, lanes)
                prm.bj[c] = _coef_struct(fc["bj"][c], f"bj[{c}]", shape,
                                         device, lanes)
        if "_material" not in fc:
            fc["_material"] = material(fc)
        grids, background = fc["_material"]
        # the items outside the grids' box take each grid's background
        for (k, c), value in background.items():
            getattr(prm, k)[c].val = value
        m = [0, 0, 0]
        for a, ma in fc["m"].items():
            m[a] = ma
            prm.m[a] = ma
            prm.prof[a] = _check(fc["prof"][a], f"prof[{a}]", (3, 2 * ma),
                                 device)
            prm.psi_lane[a] = int(np.prod(psi_shape(shape, a, ma)))
        rows, counts = plan_items(shape, m, lanes, tile[:2], sms, grids,
                                  sections=bool(tile[2]))
        if rows.size >= 2 ** 31:   # the kernel indexes the plan in 32 bits
            raise ValueError(f"{len(rows)} work items: more than the "
                             f"kernel's plan index holds")
        plan = torch.from_numpy(rows).to(device)
        prm.plan = plan.data_ptr()
        prm.n_item[0], prm.n_item[1] = counts
        prm.pairs = tile[3]
        prm.n1, prm.n2, prm.n3 = shape
        prm.lanes = lanes
        prm.field_lane = 3 * shape[0] * shape[1] * shape[2]
        prm.inv_dx = fc["inv_dx"]
        for a, (lo, hi) in enumerate(fc.get("open") or ((0, 0),) * 3):
            prm.open_lo[a], prm.open_hi[a] = int(lo), int(hi)
        fc["_params"] = base = (key, prm, plan)
    prm = _Params.from_buffer_copy(base[1])
    full = lead + (3,) + tuple(shape)
    prm.F = _check(F, "F", full, device, fd)
    prm.S = _check(S, "S", full, device, fd)
    prm.bf16 = int(fd == torch.bfloat16)
    if J is not None:
        prm.J = _check(J, "J" if fc["family"] == "E" else "K", full, device)
    elif fc["kj"] is not None:
        raise ValueError("Drude coefficients given but no J or K stack")
    if comp is not None:
        if fd != torch.float32:
            raise ValueError("compensated mode needs float32 fields")
        if R is None:
            raise ValueError("compensated mode needs the residual stack")
        prm.R = _check(R, "R", full, device, torch.bfloat16)
    for a, ma in fc["m"].items():
        prm.psi[a] = _check(psi[a], f"psi[{a}]",
                            psi_shape(shape, a, ma, lead), device)
    for a, g in (ghost or {}).items():
        if lead:
            raise ValueError("ghost planes are for a solo carry")
        prm.ghost[a] = _check(g, f"ghost[{a}]", ghost_shape(shape, a),
                              device, fd)
    return prm


_SMS: Dict[Any, int] = {}


def launch_geometry(lib, F, fc) -> Tuple[Tuple[int, int, int], int]:
    """(tile, SM count) of a launch on the card: the tile the library was
    built with for these fields (``fdtd_packed_tile``) and the card's
    SMs, for the plan."""
    out = (ctypes.c_int * 4)()
    lib.fdtd_packed_tile(int(F.dtype == torch.bfloat16),
                         int(fc["comp"] is not None), fc["shape"][2],
                         ctypes.addressof(out))
    if F.device not in _SMS:
        _SMS[F.device] = torch.cuda.get_device_properties(
            F.device).multi_processor_count
    return tuple(out), _SMS[F.device]


KERNEL_NAMES = tuple(
    f"{fam}_{store}_{cells}_{sec}{shard}" for shard in ("", "_sharded")
    for fam in ("e", "h") for store in ("f32", "bf16", "comp")
    for cells in ("one", "pair") for sec in ("slab", "plain"))


def occupancy() -> Dict[str, Dict[str, int]]:
    """Registers and local (spill) bytes a thread, resident blocks an SM
    and static shared bytes of each kernel of the library, as the CUDA
    runtime reports them for the card, by ``KERNEL_NAMES``: family,
    storage (f32, bf16, compensated), one or two z cells a thread, the
    slab or the plain section, and the sharded builds (``_sharded``:
    ghost planes and open sides compiled in)."""
    lib = _library()
    out = (ctypes.c_int * (4 * len(KERNEL_NAMES)))()
    err = lib.fdtd_packed_occupancy(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fdtd_packed_occupancy failed: CUDA error {err} "
                           f"({lib.fdtd_error_string(err).decode()})")
    keys = ("registers", "local_bytes", "blocks_per_sm", "static_smem")
    return {n: {k: out[4 * q + i] for i, k in enumerate(keys)}
            for q, n in enumerate(KERNEL_NAMES)}


def _launch(lib, fn: str, prm: _Params, device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(ctypes.byref(prm), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} "
                           f"({lib.fdtd_error_string(err).decode()})")


def e_update(E, H, J, psi, fc, R=None) -> None:
    """E (and J, psi_E, rE) in place, every lane of a lane-stacked carry
    in one launch: the CUDA kernel on CUDA tensors, its plain version on
    CPU tensors."""
    if not E.is_cuda:
        e_update_plain(E, H, J, psi, fc, R)
        return
    lib = _library()
    _launch(lib, "fdtd_e_update", _params(E, H, J, psi, fc, R,
                                          *launch_geometry(lib, E, fc)),
            E.device)
    e_update.launches += 1


def h_update(H, E, psi, fc, K=None, R=None) -> None:
    """H (and K, psi_H, rH) in place, every lane in one launch: the CUDA
    kernel on CUDA tensors, its plain version on CPU tensors."""
    if not H.is_cuda:
        h_update_plain(H, E, psi, fc, K, R)
        return
    lib = _library()
    _launch(lib, "fdtd_h_update", _params(H, E, K, psi, fc, R,
                                          *launch_geometry(lib, H, fc)),
            H.device)
    h_update.launches += 1


e_update.launches = 0
h_update.launches = 0


def e_update_sharded(E, H, J, psi, fc, R=None, ghost=None) -> None:
    """One shard's E update (the sharded variant of ``e_update``): the
    CUDA kernel with the shard's open sides (``fc["open"]``) and its H
    ghost planes on CUDA tensors, the plain version on CPU tensors.
    ``e_update_sharded.launches`` counts its calls."""
    if not E.is_cuda:
        e_update_plain(E, H, J, psi, fc, R, ghost)
        return
    lib = _library()
    _launch(lib, "fdtd_e_update",
            _params(E, H, J, psi, fc, R, *launch_geometry(lib, E, fc),
                    ghost=ghost), E.device)
    e_update_sharded.launches += 1


def h_update_sharded(H, E, psi, fc, K=None, R=None, ghost=None) -> None:
    """One shard's H update (the sharded variant of ``h_update``), with
    its E ghost planes; ``h_update_sharded.launches`` counts calls."""
    if not H.is_cuda:
        h_update_plain(H, E, psi, fc, K, R, ghost)
        return
    lib = _library()
    _launch(lib, "fdtd_h_update",
            _params(H, E, K, psi, fc, R, *launch_geometry(lib, H, fc),
                    ghost=ghost), H.device)
    h_update_sharded.launches += 1


e_update_sharded.launches = 0
h_update_sharded.launches = 0


# --------------------------------------------------------------------------
# the packed step
# --------------------------------------------------------------------------

def make_packed_step(static, device, plain: bool = False, batch: int = 0):
    """The packed step over the packed carry (updated in place).

    On a CUDA ``device`` the two family updates launch the kernels
    (kind ``packed_cuda``); on the CPU they run their plain versions
    (kind ``packed_plain``). ``plain=True`` runs the plain versions on
    any device: the yardstick chip_smoke.py holds the kernels against.
    ``batch=B`` (B >= 1) builds the lane-capable step over a carry with
    a leading lane axis of B lanes (see the module docstring); the host
    ops of a step do not grow with B.
    """
    if declines(static):
        raise ValueError(
            "the packed kernel declines compensated mode with coefficient "
            "grids or magnetic Drude K, as the reference's does: the "
            "dispatch runs the plain step there (packed.declines)")
    setup = static.tfsf_setup
    thin = sorted(set(static.pml_axes) - set(slab_axes(static)))
    if thin:
        # unsharded, slab storage fits whenever the PML leaves an
        # interior; only a shard's local extent can be too thin
        # (solver.sharded_scope refuses it first)
        raise NotImplementedError(
            f"full-length CPML psi on axis {', '.join(AXES[a] for a in thin)}"
            f" (a PML too thick for slab storage) is not in the packed "
            f"step's scope (ROADMAP.md queue A11(b)/B3(c))")
    e_fn, h_fn = (e_update_plain, h_update_plain) if plain \
        else (e_update, h_update)

    def prepare(coeffs) -> Dict[str, Any]:
        return {"coeffs": coeffs,
                "E": prepare_family(static, coeffs, "E"),
                "H": prepare_family(static, coeffs, "H"),
                "tfsf_E": patches.build_tfsf_plan(static, coeffs, "E",
                                                  batch),
                "tfsf_H": patches.build_tfsf_plan(static, coeffs, "H",
                                                  batch),
                "point": patches.build_point_source(static, coeffs)}

    def step(ps: Dict[str, Any], cc: Dict[str, Any]) -> Dict[str, Any]:
        t = ps["t"]
        if setup is not None:
            ps["inc"] = tfsf.advance_einc(ps["inc"], cc["coeffs"], t,
                                          static.dt, static.omega, setup)
        e_fn(ps["E"], ps["H"], ps.get("J"), ps["psE"], cc["E"],
             ps.get("rE"))
        if setup is not None:
            patches.tfsf_patch(ps["E"], cc["tfsf_E"], ps["inc"])
        patches.point_source_patch(static, ps["E"], cc["point"], t)
        if setup is not None:
            ps["inc"] = tfsf.advance_hinc(ps["inc"], cc["coeffs"], setup)
        h_fn(ps["H"], ps["E"], ps["psH"], cc["H"], ps.get("K"),
             ps.get("rH"))
        if setup is not None:
            patches.tfsf_patch(ps["H"], cc["tfsf_H"], ps["inc"])
        ps["t"] = t + 1
        return ps

    step.prepare = prepare
    step.pack = lambda state: pack(state, static, batch > 0)
    step.unpack = lambda p: unpack(p, static, batch > 0)
    step.packed = True
    on_cuda = torch.device(device).type == "cuda"
    step.kind = "packed_cuda" if on_cuda and not plain else "packed_plain"
    return step


# --------------------------------------------------------------------------
# the sharded packed step (domain decomposition in one process)
# --------------------------------------------------------------------------

def make_sharded_packed_step(static, mesh, plain: bool = False):
    """The packed step of a decomposed run: every shard of ``mesh`` (a
    ``parallel.mesh.ShardMesh``) holds its piece of the state and the
    coefficients on its own device, and a step runs shard by shard in
    six phases:

    1. each shard with a lower neighbour on a sharded axis receives that
       neighbour's last plane of old H (``stencil.exchange_stack``, the
       ghost); a shard at the global lo edge keeps the PEC zero;
    2. the E launch (``e_update_sharded``) on every shard, reading the
       ghosts, with PEC walls only on the global edges (``fc["open"]``);
    3. the E patches: the TFSF faces and the point source, each shard
       the part inside its box (``patches.build_tfsf_plan``'s and
       ``build_point_source``'s ``offset``);
    4. each shard with an upper neighbour receives that neighbour's
       first plane of new E (after its patches);
    5. the H launch on every shard, reading those ghosts;
    6. the H patches.

    The reference's TPU kernel runs E and H in one pass, so its sharded
    step fixes the H planes at a shard's hi edge after the kernel
    (``pallas_packed.hi_edge_h_fix`` :139) and the patch terms that
    cross a shard edge (``pallas_fused._traced_patch_fix`` :72). Here
    the H launch runs after the E patches and reads the true neighbour
    plane, so neither fix exists: a cell computes the same operations
    in the same order as in the unsharded step. An interior shard's
    CPML slab rows are identity (b = c = 0, 1/kappa = 1, the reference's
    ``build_slab_coeffs``), so its psi stays 0 and its curl terms are
    unchanged: a sharded run is the unsharded packed run, value for
    value.

    The incident line advances once a step on each device that holds a
    shard, and every shard on that device reads the same tensors.
    ``plain=True`` runs the plain versions on any device (the yardstick
    of chip_smoke.py). The carry is ``{"shards": [one packed carry a
    shard], "t"}``; ``pack`` splits a global dict state onto the shards'
    devices, ``unpack`` gives the shards' dict-form views (a list) and
    ``join`` the global dict state (new tensors). Kind ``packed_cuda``
    on CUDA devices, ``packed_plain`` on the CPU or with ``plain``;
    ``step.mesh`` names the mesh."""
    from fdtd3d_torch.solver import shard_static
    local = shard_static(static, mesh)
    types = {d.type for d in mesh.devices}
    if len(types) != 1:
        raise ValueError(f"a mesh mixes device types {sorted(types)}")
    setup = static.tfsf_setup
    e_fn, h_fn = (e_update_plain, h_update_plain) if plain \
        else (e_update_sharded, h_update_sharded)
    groups = device_groups(mesh)
    exchange, ghosts = make_exchange(mesh)

    def prepare(coeffs) -> List[Dict[str, Any]]:
        """Per-shard operands from the shards' device coefficients (a
        list, ``mesh.split`` of the global dict moved to each device)."""
        out = []
        for r, cc in enumerate(coeffs):
            off = mesh.offset(r)
            fam = {f: prepare_family(local, cc, f) for f in ("E", "H")}
            for fc in fam.values():
                fc["open"] = mesh.open_sides(r)
            out.append({"coeffs": cc, **fam,
                        "tfsf_E": patches.build_tfsf_plan(local, cc, "E", 0,
                                                          off),
                        "tfsf_H": patches.build_tfsf_plan(local, cc, "H", 0,
                                                          off),
                        "point": patches.build_point_source(local, cc, off)})
        return out

    def advance_line(shards, cc, fn):
        for rs in groups.values():
            inc = fn(shards[rs[0]]["inc"], cc[rs[0]]["coeffs"])
            for r in rs:
                shards[r]["inc"] = inc

    def step(carry, cc):
        shards = carry["shards"]
        t = carry["t"]
        if setup is not None:
            advance_line(shards, cc, lambda inc, co: tfsf.advance_einc(
                inc, co, t, static.dt, static.omega, setup))
        gh = exchange(shards, -1)
        for r, ps in enumerate(shards):
            e_fn(ps["E"], ps["H"], ps.get("J"), ps["psE"], cc[r]["E"],
                 ps.get("rE"), ghost=gh[r])
        for r, ps in enumerate(shards):
            if setup is not None:
                patches.tfsf_patch(ps["E"], cc[r]["tfsf_E"], ps["inc"])
            patches.point_source_patch(local, ps["E"], cc[r]["point"], t)
        if setup is not None:
            advance_line(shards, cc, lambda inc, co: tfsf.advance_hinc(
                inc, co, setup))
        ge = exchange(shards, 1)
        for r, ps in enumerate(shards):
            h_fn(ps["H"], ps["E"], ps["psH"], cc[r]["H"], ps.get("K"),
                 ps.get("rH"), ghost=ge[r])
        if setup is not None:
            for r, ps in enumerate(shards):
                patches.tfsf_patch(ps["H"], cc[r]["tfsf_H"], ps["inc"])
        carry["t"] = t + 1
        for ps in shards:
            ps["t"] = t + 1
        return carry

    step.prepare = prepare
    step.pack, step.unpack, step.join = sharded_carry(mesh, local, pack,
                                                      unpack)
    step.exchange = exchange
    step.ghosts = ghosts
    step.packed = True
    step.mesh = mesh
    on_cuda = "cuda" in types
    step.kind = "packed_cuda" if on_cuda and not plain else "packed_plain"
    step.diag = {"topology": list(mesh.topology), "shards": mesh.n}
    return step


def device_groups(mesh) -> Dict[Any, List[int]]:
    """The shards of each device of ``mesh``, in the mesh's order: the
    first of each advances the incident line the device's shards
    share."""
    groups: Dict[Any, List[int]] = {}
    for r, d in enumerate(mesh.devices):
        groups.setdefault(d, []).append(r)
    return groups


def make_exchange(mesh):
    """(exchange, ghosts) of a sharded step: ``exchange(shards, side)``
    fills and returns the ghost buffers of one phase from ``shards``
    (carries or spare sets): side -1 the lower neighbours' last planes
    of H (before the E launch or the pass), +1 the upper neighbours'
    first planes of E (before the H launch or the hi-edge launch), as
    ``stencil.exchange_stack`` copies them; ``ghosts`` side -> the
    buffers, made once (anew if the stacks' dtype or devices
    change)."""
    ghosts: Dict[int, List[Dict[int, torch.Tensor]]] = {}

    def exchange(shards, side: int):
        src = [s["H" if side < 0 else "E"] for s in shards]
        bufs = ghosts.get(side)
        if bufs is None or any(
                g.device != st.device or g.dtype != st.dtype
                for b, st in zip(bufs, src) for g in b.values()):
            bufs = ghosts[side] = ghost_buffers(mesh, src, side)
        exchange_stack(src, bufs, mesh, side)
        return bufs

    return exchange, ghosts


def sharded_carry(mesh, local, pack_fn, unpack_fn):
    """(pack, unpack, join) of a sharded carry ``{"shards", "t"}``:
    ``pack`` splits a global dict-form state (tensors or numpy) onto the
    shards, each piece copied to its device and packed by
    ``pack_fn(piece, local)``, the line shared per device; ``unpack``
    gives the shards' dict-form views (a list); ``join`` the global
    dict state (new tensors)."""
    groups = device_groups(mesh)

    def pack_state(state) -> Dict[str, Any]:
        shards = [pack_fn(_to_device(piece, mesh.devices[r]), local)
                  for r, piece in enumerate(mesh.split(state))]
        for rs in groups.values():
            for r in rs[1:]:
                if "inc" in shards[r]:
                    shards[r]["inc"] = shards[rs[0]]["inc"]
        return {"shards": shards, "t": int(state["t"])}

    def unpack_views(carry) -> List[Dict[str, Any]]:
        views = []
        for ps in carry["shards"]:
            ps["t"] = carry["t"]
            views.append(unpack_fn(ps, local))
        return views

    def join(carry, device=None) -> Dict[str, Any]:
        out = mesh.join(unpack_views(carry), device)
        out["t"] = carry["t"]
        return out

    return pack_state, unpack_views, join


def _to_device(tree, device):
    """A tree of numpy or tensor leaves as contiguous tensors on
    ``device`` (new tensors)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True).contiguous()
    if isinstance(tree, np.ndarray):
        from fdtd3d_torch.convert import from_host
        return from_host(np.ascontiguousarray(tree)).to(device)
    return tree

"""Packed double-single (float32x2) step: two CUDA launches per step.

Replaces the Pallas TPU kernel
``fdtd3d_tpu/ops/pallas_packed_ds.py::make_packed_ds_step`` (factory
:193, kernel :364 with body :429, ``pallas_call`` :936) for unsharded
3D float32x2 runs, with the hand-written CUDA C++ kernel
``fdtd3d_torch/csrc/packed_ds.cu`` (``sm_90a``, built by nvcc with
``--fmad=false`` at first use, bound with ctypes). CUDA C++ rather than
Triton: every error-free transform needs its exact rounding sequence,
which the source states op by op with explicitly rounded intrinsics.

What one step computes: the reference kernel's arithmetic on hi+lo f32
pairs. Per E component: the EFT curl of the H pair times 1/dx as a
pair, the y/z/x slab CPML as pair recursions (term = ik*d + psi'),
each source record's plane term added into the accumulator pair at its
plane before the ca/cb pair multiply, Drude J in plain f32, PEC walls;
then H the same from the fully corrected new E. The source records are
the reference's: every TFSF face correction whose polarisation
projection does not vanish, grouped by normal axis, with the point
source as a pseudo-record at the end of the axis-0 group (E only).

Design. The reference lags H one x-tile behind E in one ordered grid;
CUDA blocks run in no order, so the step is two launches on the stacked
layout, ``e_update`` then ``h_update``, each in place (the race argument
of ``ops/packed.py``). The per-step plane terms (the math of
``tfsf.record_term_ds``) are thin torch ds ops outside the kernel: the
geometry (interpolation index, weight pairs, gate, sign*pol/dx pair) is
fixed per record and computed once in ``prepare``; a step gathers the
incident-line samples of every record of both families at once and runs
one batch of ds ops over their concatenated planes. The kernel gets the
record table (comp, axis, plane, offset) in its parameter block and a
device pointer to the stacked terms; the point source's pair rides in
the table as two floats.

What bounds it on the card: memory bytes. A launch reads the other
family's 6 pair volumes, reads and writes its own 6, so a step moves 24
pair-volume words (96 B/cell) per family against the reference's single
fused pass at 96 B/cell per step; the EFT work (~400 flops/cell/family)
stays below the H100's ~20 flops per byte.

Layout (the reference's): ``E``, ``H`` (6, n1, n2, n3) with rows [0,3)
the hi words and [3,6) the lo words; ``psE[a]``/``psH[a]`` (4, ...)
with dim 1+a of 2m planes, rows = the two components with a curl term
along a (hi, then the same two lo); ``J`` (3, ...) with Drude; ``inc``
the ds line with ``*_lo`` words.

Beside each kernel wrapper stands its plain PyTorch version with the
same signature (``e_update_plain``/``h_update_plain``); a wrapper takes
it only for CPU tensors. ``e_update.launches``/``h_update.launches``
count kernel launches. The EFT probe ``eft_probe`` runs the kernel's own
``two_sum``/``two_prod`` device functions on the card.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from fdtd3d_torch.layout import component_axis
from fdtd3d_torch.ops import build, ds, tfsf
from fdtd3d_torch.ops.packed import psi_row
from fdtd3d_torch.ops.sources import DsSourceTable
from fdtd3d_torch.solver import (_bcast1d, _shift, coef_pair, ds_diff,
                                 slab_axes)

AXES = "xyz"
_LIB = "packed_ds"
MAX_REC = 16          # records per family; mirrors csrc/packed_ds.cu


def eligible(static) -> bool:
    """Packed-ds scope: 3D float32x2, unsharded, every CPML axis with
    slab-compact psi."""
    return (static.cfg.ds_fields and static.mode.name == "3D"
            and tuple(static.topology) == (1, 1, 1)
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
    if "inc" in p:
        state["inc"] = dict(p["inc"])
    return state


def prepare_family(static, coeffs, family: str, records: List[Record],
                   plan: Optional[TermPlan]) -> Dict[str, Any]:
    """Per-family operands: ca/cb (E) or da/db (H) as hi/lo pairs of
    tensors (0-d scalars or grids), kj/bj in plain f32, the slab CPML
    profile packs (6, 2m) per axis (b, c, ik hi then lo), the walls, the
    1/dx pair, and the record table with each record's term offset
    (the point source's cell in ``point_pos``)."""
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
        "point_pos": tuple(static.cfg.point_source.position)}
    if family == "E" and static.use_drude:
        fc["kj"] = [ds.as_f32(coeffs[f"kj_{c}"], like) for c in comps]
        fc["bj"] = [ds.as_f32(coeffs[f"bj_{c}"], like) for c in comps]
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


def _family_plain(F, S, J, psi, fc, terms, point, backward: bool) -> None:
    iv = fc["iv"]
    for c in range(3):
        acc = None
        for t in range(2):
            a, d = (c + 1 + t) % 3, (c + 2 - t) % 3
            f = (S[d], S[3 + d])
            g = (_shift(f[0], a, backward), _shift(f[1], a, backward))
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
            vh, vl = ds.sub_ff(*ds.mul_ff(*old, *fc["a"][c]),
                               *ds.mul_ff(*acc, *fc["b"][c]))
        F[c].copy_(vh)
        F[3 + c].copy_(vl)


def e_update_plain(E, H, J, psi, fc, terms, point) -> None:
    """E pairs (and J, psi_E pairs) in place from backward ds
    differences of the H pairs, with the E records and the point
    source's pair ``point`` (or None)."""
    _family_plain(E, H, J, psi, fc, terms, point, backward=True)


def h_update_plain(H, E, psi, fc, terms) -> None:
    """H pairs (and psi_H pairs) in place from forward ds differences
    of the E pairs, with the H records."""
    _family_plain(H, E, None, psi, fc, terms, None, backward=False)


# --------------------------------------------------------------------------
# the CUDA kernel wrappers
# --------------------------------------------------------------------------

class _Pair(ctypes.Structure):
    _fields_ = [("hi", ctypes.c_void_p), ("lo", ctypes.c_void_p),
                ("vh", ctypes.c_float), ("vl", ctypes.c_float)]


class _Coef(ctypes.Structure):
    _fields_ = [("grid", ctypes.c_void_p), ("val", ctypes.c_float)]


class _Rec(ctypes.Structure):
    """Mirror of ``struct Rec`` in csrc/packed_ds.cu."""
    _fields_ = [("off", ctypes.c_longlong), ("comp", ctypes.c_int),
                ("axis", ctypes.c_int), ("plane", ctypes.c_int),
                ("point", ctypes.c_int), ("pj", ctypes.c_int),
                ("pk", ctypes.c_int), ("vh", ctypes.c_float),
                ("vl", ctypes.c_float)]


class _Params(ctypes.Structure):
    """Mirror of ``struct Params`` in csrc/packed_ds.cu."""
    _fields_ = [("F", ctypes.c_void_p), ("S", ctypes.c_void_p),
                ("J", ctypes.c_void_p),
                ("psi", ctypes.c_void_p * 3), ("prof", ctypes.c_void_p * 3),
                ("terms", ctypes.c_void_p), ("total", ctypes.c_longlong),
                ("m", ctypes.c_int * 3),
                ("a", _Pair * 3), ("b", _Pair * 3),
                ("kj", _Coef * 3), ("bj", _Coef * 3),
                ("rec", _Rec * MAX_REC), ("n_rec", ctypes.c_int),
                ("n1", ctypes.c_int), ("n2", ctypes.c_int),
                ("n3", ctypes.c_int),
                ("iv_h", ctypes.c_float), ("iv_l", ctypes.c_float)]


def _library() -> ctypes.CDLL:
    lib = build.load(_LIB)
    if not getattr(lib, "_fdtd_bound", False):
        for fn in ("fdtd_ds_e_update", "fdtd_ds_h_update"):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            f.restype = ctypes.c_int
        lib.fdtd_ds_eft_probe.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_void_p]
        lib.fdtd_ds_eft_probe.restype = ctypes.c_int
        lib.fdtd_ds_params_size.restype = ctypes.c_int
        lib.fdtd_ds_error_string.argtypes = [ctypes.c_int]
        lib.fdtd_ds_error_string.restype = ctypes.c_char_p
        if lib.fdtd_ds_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"{_LIB}: struct Params is {lib.fdtd_ds_params_size()} "
                f"bytes in CUDA and {ctypes.sizeof(_Params)} in ctypes")
        lib._fdtd_bound = True
    return lib


def _check(t: torch.Tensor, name: str, shape, device) -> int:
    if t.device != device or t.dtype != torch.float32 \
            or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: need a contiguous float32 tensor of shape "
            f"{tuple(shape)} on {device}, got {tuple(t.shape)} "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    return t.data_ptr()


def _coef_struct(v: torch.Tensor, name, shape, device) -> _Coef:
    if v.dim() == 0:
        return _Coef(None, float(v))
    return _Coef(_check(v, name, shape, device), 0.0)


def _pair_struct(p, name, shape, device) -> _Pair:
    if p[0].dim() == 0:
        return _Pair(None, None, float(p[0]), float(p[1]))
    return _Pair(_check(p[0], name, shape, device),
                 _check(p[1], name + "_lo", shape, device), 0.0, 0.0)


def _params(F, S, J, psi, fc, terms, point) -> _Params:
    """The launch's parameter block; the static part (coefficients,
    profiles, record table) is built and checked once per prepared
    family, the step's part (fields, terms, the point pair) per call."""
    device = F.device
    shape = fc["shape"]
    base = fc.get("_params")
    if base is None or base[0] != device:
        prm = _Params()
        for c in range(3):
            prm.a[c] = _pair_struct(fc["a"][c], f"a[{c}]", shape, device)
            prm.b[c] = _pair_struct(fc["b"][c], f"b[{c}]", shape, device)
            if fc["kj"] is not None:
                prm.kj[c] = _coef_struct(fc["kj"][c], f"kj[{c}]", shape,
                                         device)
                prm.bj[c] = _coef_struct(fc["bj"][c], f"bj[{c}]", shape,
                                         device)
        for a, m in fc["m"].items():
            prm.m[a] = m
            prm.prof[a] = _check(fc["prof"][a], f"prof[{a}]", (6, 2 * m),
                                 device)
        for r, (rec, off) in enumerate(zip(fc["records"], fc["offsets"])):
            prm.rec[r].comp, prm.rec[r].axis = rec.comp, rec.axis
            prm.rec[r].plane = rec.plane
            if rec.corr is None:
                prm.rec[r].point = 1
                _, prm.rec[r].pj, prm.rec[r].pk = fc["point_pos"]
            else:
                prm.rec[r].off = off
        prm.n_rec = len(fc["records"])
        prm.n1, prm.n2, prm.n3 = shape
        prm.iv_h, prm.iv_l = (float(v) for v in fc["iv"])
        fc["_params"] = base = (device, prm)
    prm = _Params.from_buffer_copy(base[1])
    full = (6,) + tuple(shape)
    prm.F = _check(F, "F", full, device)
    prm.S = _check(S, "S", full, device)
    if J is not None:
        prm.J = _check(J, "J", (3,) + tuple(shape), device)
    elif fc["family"] == "E" and fc["kj"] is not None:
        raise ValueError("Drude coefficients given but no J stack")
    for a, m in fc["m"].items():
        ps = [4] + list(shape)
        ps[1 + a] = 2 * m
        prm.psi[a] = _check(psi[a], f"psi[{a}]", ps, device)
    if terms is not None:
        prm.terms = _check(terms, "terms", (2, terms.shape[1]), device)
        prm.total = terms.shape[1]
    elif any(rec.corr is not None for rec in fc["records"]):
        raise ValueError("TFSF records given but no plane terms")
    for r, rec in enumerate(fc["records"]):
        if rec.corr is None:
            # no point pair this step: a zero pair adds nothing
            prm.rec[r].vh, prm.rec[r].vl = point or (0.0, 0.0)
    return prm


def _launch(fn: str, prm: _Params, device) -> None:
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(ctypes.byref(prm), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} "
                           f"({lib.fdtd_ds_error_string(err).decode()})")


def e_update(E, H, J, psi, fc, terms, point) -> None:
    """E pairs (and J, psi_E) in place: the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors."""
    if not E.is_cuda:
        e_update_plain(E, H, J, psi, fc, terms, point)
        return
    _launch("fdtd_ds_e_update",
            _params(E, H, J, psi, fc, terms, point), E.device)
    e_update.launches += 1


def h_update(H, E, psi, fc, terms) -> None:
    """H pairs (and psi_H) in place: the CUDA kernel on CUDA tensors,
    its plain version on CPU tensors."""
    if not H.is_cuda:
        h_update_plain(H, E, psi, fc, terms)
        return
    _launch("fdtd_ds_h_update",
            _params(H, E, None, psi, fc, terms, None), H.device)
    h_update.launches += 1


e_update.launches = 0
h_update.launches = 0


def eft_probe(a: torch.Tensor, b: torch.Tensor):
    """The kernel's own ``two_sum`` and ``two_prod`` device functions on
    two CUDA float32 tensors of one shape: (s, e, p, pe)."""
    if not a.is_cuda or a.shape != b.shape:
        raise ValueError("eft_probe takes two CUDA tensors of one shape")
    a, b = a.contiguous(), b.contiguous()
    outs = [torch.empty_like(a) for _ in range(4)]
    lib = _library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.fdtd_ds_eft_probe(
        *(ctypes.c_void_p(t.data_ptr()) for t in (a, b, *outs)),
        ctypes.c_int(a.numel()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fdtd_ds_eft_probe launch failed: CUDA error "
                           f"{err} ({lib.fdtd_ds_error_string(err).decode()})")
    return tuple(outs)


# --------------------------------------------------------------------------
# the packed-ds step
# --------------------------------------------------------------------------

def make_packed_ds_step(static, device, plain: bool = False):
    """The packed float32x2 step over the packed carry (in place).

    On a CUDA ``device`` the two family updates launch the kernels
    (kind ``packed_ds_cuda``); on the CPU they run their plain versions
    (kind ``packed_ds_plain``). ``plain=True`` runs the plain versions
    on any device: the yardstick chip_smoke.py holds the kernels
    against."""
    if not eligible(static):
        raise NotImplementedError(
            "this float32x2 configuration is outside the packed-ds "
            "step's scope (a PML too thick for slab psi storage: "
            "ROADMAP.md queue A4); run it with use_pallas=False")
    setup = static.tfsf_setup
    ps = static.cfg.point_source
    records = {"E": family_records(static, "E"),
               "H": family_records(static, "H")}
    line_src = tfsf.line_source(setup, static.omega, static.dt) \
        if setup is not None else None
    has_point = any(r.corr is None for r in records["E"])
    point_src = DsSourceTable(ps.waveform, 0.5, static.omega, static.dt,
                              ps.amplitude) if has_point else None
    e_fn, h_fn = (e_update_plain, h_update_plain) if plain \
        else (e_update, h_update)

    def prepare(coeffs) -> Dict[str, Any]:
        plan = build_term_plan(static, coeffs, records)
        cc = {"coeffs": coeffs, "plan": plan}
        for fam in ("E", "H"):
            cc[fam] = prepare_family(static, coeffs, fam, records[fam],
                                     plan)
        return cc

    def step(pst: Dict[str, Any], cc: Dict[str, Any]) -> Dict[str, Any]:
        t = pst["t"]
        terms = None
        if setup is not None:
            pst["inc"] = tfsf.advance_einc(pst["inc"], cc["coeffs"], t,
                                           static.dt, static.omega, setup,
                                           source=line_src)
            terms = record_terms(cc["plan"], pst["inc"])
            pst["inc"] = tfsf.advance_hinc(pst["inc"], cc["coeffs"], setup)
        point = point_src(t) if point_src is not None else None
        e_fn(pst["E"], pst["H"], pst.get("J"), pst["psE"], cc["E"], terms,
             point)
        h_fn(pst["H"], pst["E"], pst["psH"], cc["H"], terms)
        pst["t"] = t + 1
        return pst

    step.prepare = prepare
    step.pack = lambda state: pack(state, static)
    step.unpack = lambda p: unpack(p, static)
    step.packed = True
    on_cuda = torch.device(device).type == "cuda"
    step.kind = "packed_ds_cuda" if on_cuda and not plain \
        else "packed_ds_plain"
    return step

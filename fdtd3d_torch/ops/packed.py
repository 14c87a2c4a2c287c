"""Packed single-step leapfrog: stacked E/H carry, two CUDA launches.

Replaces the Pallas TPU kernel
``fdtd3d_tpu/ops/pallas_packed.py::make_packed_eh_step`` (builder :548,
kernel body :694, ``pallas_call`` :1138) for 3D real float32 and bf16
storage, with the hand-written CUDA C++ kernel
``fdtd3d_torch/csrc/packed_eh.cu`` (``sm_90a``, built by nvcc at first
use, bound with ctypes). CUDA C++
rather than Triton: a stencil with per-cell coefficients and CPML slab
branches, which wants explicit control of its indexing.

What bounds it on the card: memory bytes. A step does ~60 flops per
cell against 48 B/cell of unavoidable traffic (E and H read once and
written once), far below the H100's ~20 flops per byte. Design: the
TPU kernel's lagged-H carry needs an ordered grid, which CUDA does not
have, so a step is two launches on the stacked layout, ``e_update``
then ``h_update``, each updating its family in place. That moves 18
field volumes (72 B/cell) per step against the 12 (48 B/cell) of the
reference's fused pass; a single-launch fusion is later work. TFSF and
the point source are torch plane patches between the launches
(ops/patches.py), in the plain step's order: E update, E patches, Hinc
advance, H update, H patches. The x-slab CPML therefore runs in-kernel
for every source position: the curl that feeds psi never includes a
source term.

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
one launch per family advances all B lanes (csrc/packed_eh.cu). The
sources carry per-lane values as device tensors: the TFSF face patch
its per-lane ``cb``, the point source ``ps_amp * cb`` per lane. A solo
run (``batch=0``) keeps the carry without the lane axis and launches
the same kernels with one lane.

Beside each kernel wrapper stands its plain PyTorch version with the
same signature (``e_update_plain``/``h_update_plain``), on the solo
and the lane-stacked layouts alike. A wrapper uses the plain version
only for tensors on the CPU; on a CUDA tensor it launches the kernel or
raises. ``e_update.launches`` and ``h_update.launches`` count kernel
launches (one per launch, whatever the number of lanes).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from fdtd3d_torch.layout import component_axis
from fdtd3d_torch.ops import build, patches, tfsf
from fdtd3d_torch.ops.stencil import make_diff_ops
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
    real float32 or bf16 storage, not double-single, and not
    compensated mode with magnetic Drude K (whose residual the kernel
    does not Kahan-treat)."""
    cfg = static.cfg
    return static.mode.name == "3D" \
        and cfg.dtype in ("float32", "bfloat16") \
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


def _family_plain(F, S, J, psi, fc, backward: bool, records=None,
                  point=None, R=None) -> None:
    """One family update in place. ``J``: the family's ADE current (J on
    E, K on H) or None; ``R``: the Kahan residuals (bf16) in compensated
    mode. ``records(c, acc)`` and, for E, ``point(c, acc)`` add in-kernel
    sources to component c's curl accumulator (the temporal-blocked
    pass, ops/packed_tb.py): the records after the curl, the point
    source after the Drude current, as the reference's kernels order
    them. bf16 fields are widened to float32 before any operation and
    the new values rounded to bf16 where they are stored, as the kernel
    loads and stores them."""
    diff = _diff_b if backward else _diff_f
    S = S.float()
    for c in range(3):
        acc = None
        for t in range(2):
            a, d = (c + 1 + t) % 3, (c + 2 - t) % 3
            s = 1.0 if t == 0 else -1.0
            dfa = scaled_diff(diff(S[d], a), fc)
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
    out = {k: v for k, v in fc.items() if k != "_params"}
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


def e_update_plain(E, H, J, psi, fc, R=None) -> None:
    """E (and J, psi_E, the residual rE in compensated mode) in place
    from backward differences of H, on the solo or the lane-stacked
    layout (one lane after the other)."""
    for lane, e, h, j, ps, r in lane_views(E, H, J, psi, R):
        _family_plain(e, h, j, ps, fc if lane is None else lane_fc(fc, lane),
                      backward=True, R=r)


def h_update_plain(H, E, psi, fc, K=None, R=None) -> None:
    """H (and K with magnetic Drude, psi_H, the residual rH in
    compensated mode) in place from forward differences of E, on the
    solo or the lane-stacked layout."""
    for lane, h, e, k, ps, r in lane_views(H, E, K, psi, R):
        _family_plain(h, e, k, ps, fc if lane is None else lane_fc(fc, lane),
                      backward=False, R=r)


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
                ("bf16", ctypes.c_int)]


def _library() -> ctypes.CDLL:
    lib = build.load(_LIB)
    if not getattr(lib, "_fdtd_bound", False):
        for fn in ("fdtd_e_update", "fdtd_h_update"):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            f.restype = ctypes.c_int
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
    order: E, H, psi, J."""
    out = [carry["E"], carry["H"]]
    out += [carry["psE"][a] for a in sorted(carry["psE"])]
    out += [carry["psH"][a] for a in sorted(carry["psH"])]
    if "J" in carry:
        out.append(carry["J"])
    return out


def alloc_like(carry) -> Dict[str, Any]:
    """A spare set of a carry's pass buffers (E, H, psi, J)."""
    return {"E": torch.empty_like(carry["E"]),
            "H": torch.empty_like(carry["H"]),
            "psE": {a: torch.empty_like(v) for a, v in carry["psE"].items()},
            "psH": {a: torch.empty_like(v) for a, v in carry["psH"].items()},
            **({"J": torch.empty_like(carry["J"])} if "J" in carry else {})}


def swap_buffers(carry, spare) -> None:
    """Exchange the pass buffers between the carry and the spare."""
    for key in ("E", "H", "J"):
        if key in carry:
            carry[key], spare[key] = spare[key], carry[key]
    for fam in ("psE", "psH"):
        for a in carry[fam]:
            carry[fam][a], spare[fam][a] = spare[fam][a], carry[fam][a]


def _params(F, S, J, psi, fc, R=None) -> _Params:
    """The launch's parameter block; the static part (coefficients,
    profiles) is built and checked once per prepared family, device and
    lane count. ``J``: the family's ADE current (J or K) or None;
    ``R``: the bf16 Kahan residuals of compensated mode (``fc["comp"]``
    set), whose coefficients the kernel takes as scalars only."""
    device = F.device
    shape = fc["shape"]
    lanes, lead = carry_lanes(F)
    base = fc.get("_params")
    if base is None or base[0] != (device, lanes):
        prm = _Params()
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
        for a, m in fc["m"].items():
            prm.m[a] = m
            prm.prof[a] = _check(fc["prof"][a], f"prof[{a}]", (3, 2 * m),
                                 device)
            prm.psi_lane[a] = int(np.prod(psi_shape(shape, a, m)))
        comp = fc["comp"]
        if comp is not None:
            for c in range(3):
                for key in ("a", "b"):
                    if isinstance(fc[key][c], torch.Tensor) \
                            or isinstance(comp[f"{key}_lo"][c], torch.Tensor):
                        raise ValueError(
                            "the compensated kernel takes scalar "
                            "coefficients only (packed.declines "
                            "sends grids to the plain step)")
                prm.a_lo[c] = float(comp["a_lo"][c])
                prm.b_lo[c] = float(comp["b_lo"][c])
            prm.inv_dx_lo = comp["inv_dx_lo"]
        prm.n1, prm.n2, prm.n3 = shape
        prm.lanes = lanes
        prm.field_lane = 3 * shape[0] * shape[1] * shape[2]
        prm.inv_dx = fc["inv_dx"]
        fc["_params"] = base = ((device, lanes), prm)
    prm = _Params.from_buffer_copy(base[1])
    full = lead + (3,) + tuple(shape)
    fd = field_dtype(F)
    prm.F = _check(F, "F", full, device, fd)
    prm.S = _check(S, "S", full, device, fd)
    prm.bf16 = int(fd == torch.bfloat16)
    if J is not None:
        prm.J = _check(J, "J" if fc["family"] == "E" else "K", full, device)
    elif fc["kj"] is not None:
        raise ValueError("Drude coefficients given but no J or K stack")
    if fc["comp"] is not None:
        if fd != torch.float32:
            raise ValueError("compensated mode needs float32 fields")
        if R is None:
            raise ValueError("compensated mode needs the residual stack")
        prm.R = _check(R, "R", full, device, torch.bfloat16)
    for a, m in fc["m"].items():
        prm.psi[a] = _check(psi[a], f"psi[{a}]", psi_shape(shape, a, m, lead),
                            device)
    return prm


def _launch(fn: str, prm: _Params, device) -> None:
    lib = _library()
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
    _launch("fdtd_e_update", _params(E, H, J, psi, fc, R), E.device)
    e_update.launches += 1


def h_update(H, E, psi, fc, K=None, R=None) -> None:
    """H (and K, psi_H, rH) in place, every lane in one launch: the CUDA
    kernel on CUDA tensors, its plain version on CPU tensors."""
    if not H.is_cuda:
        h_update_plain(H, E, psi, fc, K, R)
        return
    _launch("fdtd_h_update", _params(H, E, K, psi, fc, R), H.device)
    h_update.launches += 1


e_update.launches = 0
h_update.launches = 0


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
        # the reference runs a thin y or z axis through pallas3d's
        # in-kernel full-length psi, and a thin x axis on its jnp step
        item = "B3" if any(a in (1, 2) for a in thin) else "A4"
        raise NotImplementedError(
            f"full-length CPML psi on axis {', '.join(AXES[a] for a in thin)}"
            f" (a PML too thick for slab storage) is not in the packed "
            f"step's scope (ROADMAP.md queue {item})")
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

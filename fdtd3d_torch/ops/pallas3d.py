"""Two-pass family step: one CUDA launch per field family, thin patches.

Replaces the Pallas TPU kernel
``fdtd3d_tpu/ops/pallas3d.py::make_family_kernel`` (builder :167, kernel
body :293, ``pallas_call`` :507), through its step
``make_pallas_step`` (:1068), for 3D real float32 and bf16 storage,
unsharded, with the
hand-written CUDA C++ kernel ``fdtd3d_torch/csrc/family.cu``
(``sm_90a``, built by nvcc at first use, bound with ctypes). CUDA C++
rather than Triton: a stencil on per-component pointers with slab CPML
branches and per-cell or scalar coefficients, which wants explicit
control of its indexing, like the port's other kernels.

The module is named after the reference's, so a reader finds
``fdtd3d_tpu/ops/pallas3d.py`` from it. It runs on the unpacked state
dict (the plain step's form: the chunk runner's ``packed`` is False),
and does not mutate the state it is given: every kernel writes its
outputs into fresh tensors, and the patches add onto those.

A step, in the reference's order (:1101-1183):

1. the E-incident line advance;
2. the E-family kernel (``e_family``): the curl of H by backward
   differences, ca/cb (scalar or grid), the y/z slab psi recursions and
   their accumulator deltas, the **pure** curl on x, Drude J, the PEC
   wall masks, PEC zero ghosts outside the domain;
3. the x-slab CPML post-pass (``x_slab_post``): the x psi recursion and
   its delta on the 2m boundary planes of x;
4. the TFSF E patch and the point source (``tfsf_patch``,
   ``point_source_patch``);
5. the H-incident line advance;
6. the H-family kernel (``h_family``, forward differences of the new E);
7. the H x-slab post-pass;
8. the TFSF H patch.

What bounds the kernel on the card: memory bytes. A family launch reads
the old family and the other family (6 volumes) and writes the new
family (3), so a step moves 18 field volumes (72 B/cell f32) plus the
y/z psi slabs, against ~30 flops a cell per family.

The patch helpers are thin torch counterparts of the reference's jnp
helpers (``slab_post``/``x_slab_post`` :722/:852, ``plane_corrections``
:859, ``tfsf_patch`` :961, ``point_source_patch`` :1012), unsharded
only. Each adds in place onto the fresh field tensors it is given. The
TFSF geometry comes from ``ops/tfsf.py``, the functions the plain
step uses, so the two cannot drift; it is planned once per coefficient
dict (``tfsf_plan``) and a step's patch is a few ops per face.

Beside each kernel wrapper stands its plain PyTorch version with the
same signature (``e_family_plain``/``h_family_plain``): the CPU tests
use it and ``chip_smoke.py`` holds the kernel against it on the card.
A wrapper takes the plain version only for tensors on the CPU; on a
CUDA tensor it launches the kernel or raises. ``e_family.launches`` and
``h_family.launches`` count kernel launches.

bf16 storage: the kernels load E and H as floats, compute in f32 (psi,
J and the coefficients are f32) and round their outputs to bf16; the
patches then add their values rounded to bf16 onto those outputs, as
the reference's post-passes do (``val.astype(fdt)`` and an add in the
field dtype: two roundings on a patched cell).

Magnetic Drude K (the reference's ``drude = static.use_drude_m`` of the
H family, :191): ``h_family`` reads and writes K as ``e_family`` does
J, ``K' = km K + bm H`` added to the H accumulator before the
coefficient step (J is taken off E's), km/bm scalars or grids; the x
slab's delta is then added by the post-pass, as in the reference.

Out of scope here, and raising ``NotImplementedError`` with the
ROADMAP.md item (the reference's kernel accepts them): sharded runs
(A11).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fdtd3d_torch.layout import CURL_TERMS, component_axis
from fdtd3d_torch.ops import build, tfsf
from fdtd3d_torch.ops.packed import _check as check
from fdtd3d_torch.ops.packed import family_value, field_dtype
from fdtd3d_torch.ops.sources import host_round, waveform
from fdtd3d_torch.ops.stencil import make_diff_ops
from fdtd3d_torch.solver import _bcast1d, _slab_fix, slab_axes

AXES = "xyz"
_LIB = "family"
_diff_b, _diff_f = make_diff_ops()


def eligible(static) -> bool:
    """The reference's ``pallas3d.eligible`` (:86): 3D real f32/bf16
    storage, not compensated, not double-single; any topology."""
    if static.mode.name != "3D":
        return False
    if static.cfg.dtype not in ("float32", "bfloat16"):
        return False
    return not (static.cfg.compensated or static.cfg.ds_fields)


def check_scope(static, what: str) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item, for what
    the reference's kernel covers and this twin does not yet."""
    def out(feature: str, item: str):
        raise NotImplementedError(
            f"{feature} in the {what} is not ported to fdtd3d_torch yet "
            f"(ROADMAP.md queue {item}); run it with the reference "
            f"package fdtd3d_tpu")
    if tuple(static.topology) != (1, 1, 1):
        out(f"topology {tuple(static.topology)}", "A11")


def kernel_psi_terms(static, family: str,
                     x_slab: bool = False) -> Dict[str, List[Tuple[int, str]]]:
    """component -> [(term index, psi key)] of the psi the family's
    kernel updates in-kernel: the slab axes y and z (x is the two-pass
    step's post-pass axis, the reference's ``_classify`` :159), and x
    too with ``x_slab`` (the recompute-fused pass)."""
    slabs = slab_axes(static)
    mode = static.mode
    comps = mode.e_components if family == "E" else mode.h_components
    out: Dict[str, List[Tuple[int, str]]] = {}
    for c in comps:
        terms = CURL_TERMS[component_axis(c)]
        out[c] = [(t, f"{c}_{AXES[a]}") for t, (a, _d, _s) in enumerate(terms)
                  if (x_slab or a != 0) and a in slabs]
    return out


def family_operands(static, coeffs, family: str,
                    x_slab: bool = False) -> Dict[str, Any]:
    """One family's kernel operands from device coefficients: the
    material coefficients per component (host float or grid; the ADE
    current's, Drude J's kj/bj or K's km/bm, under ``kj``/``bj``), the
    slab CPML profiles (3, 2m) of the in-kernel axes (y and z; x too
    with ``x_slab``), the in-kernel psi keys, and the wall vectors (used
    by the plain version)."""
    from fdtd3d_torch.ops.packed import ade_keys
    mode = static.mode
    comps = mode.e_components if family == "E" else mode.h_components
    tag = "e" if family == "E" else "h"
    pa, pb = ("ca", "cb") if family == "E" else ("da", "db")
    slabs = {a: m for a, m in slab_axes(static).items() if x_slab or a != 0}
    fc: Dict[str, Any] = {
        "family": family, "comps": tuple(comps),
        "shape": tuple(static.grid_shape),
        "inv_dx": float(np.float32(1.0 / static.dx)),
        "a": [coeffs[f"{pa}_{c}"] for c in comps],
        "b": [coeffs[f"{pb}_{c}"] for c in comps],
        "kj": None, "bj": None, "m": slabs, "prof": {},
        "psi": kernel_psi_terms(static, family, x_slab),
        "wall": [coeffs[f"wall_{ax}"] for ax in AXES], "comp": None}
    ade = ade_keys(static, family)
    if ade is not None:
        fc["kj"] = [coeffs[f"{ade[0]}_{c}"] for c in comps]
        fc["bj"] = [coeffs[f"{ade[1]}_{c}"] for c in comps]
    for a in slabs:
        fc["prof"][a] = torch.stack(
            [coeffs[f"pml_slab_{v}{tag}_{AXES[a]}"]
             for v in ("b", "c", "ik")]).contiguous()
    return fc


# --------------------------------------------------------------------------
# plain versions (the kernel's arithmetic in torch; CPU tensors and tests)
# --------------------------------------------------------------------------

def _family_plain(F, S, psi, J, fc, backward: bool, records=None,
                  point=None):
    """One family update as the kernel body computes it (:377-429):
    returns (new fields, new in-kernel psi, new ADE current or None),
    fresh tensors; the inputs are not touched. ``J``: the family's ADE
    current (Drude J on E, K on H) or None. ``records(ci, acc)`` and, for
    E, ``point(ci, acc)`` add in-kernel sources to component ci's curl
    accumulator (the recompute-fused pass, ops/pallas_fused.py): the
    records after the curl, the point source after the Drude current.
    bf16 fields are widened to float32 before any operation; the new
    fields come back in float32, unrounded (the callers round them where
    the kernel stores them)."""
    diff = _diff_b if backward else _diff_f
    other = "H" if backward else "E"
    S = {k: v.float() for k, v in S.items()}
    new_f, new_psi, new_j = {}, {}, ({} if J is not None else None)
    for ci, c in enumerate(fc["comps"]):
        psi_of = dict(fc["psi"][c])
        acc = None
        for t, (a, d_axis, s) in enumerate(CURL_TERMS[component_axis(c)]):
            dfa = diff(S[other + AXES[d_axis]], a) * fc["inv_dx"]
            term = s * dfa
            if t in psi_of:
                key = psi_of[t]
                new_psi[key], fix = _slab_fix(a, s, dfa, psi[key],
                                              tuple(fc["prof"][a]),
                                              fc["m"][a])
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


def stored(new: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor]):
    """New fields rounded to the storage dtype of ``like`` (the old
    fields of the same family): what the kernel writes."""
    return {c: v.to(like[c].dtype) for c, v in new.items()}


def e_family_plain(E, H, psi, J, fc):
    """New E (and in-kernel psi_E, J) from backward differences of H:
    the plain version of ``e_family``."""
    new_e, new_psi, new_j = _family_plain(E, H, psi, J, fc, backward=True)
    return stored(new_e, E), new_psi, new_j


def h_family_plain(H, E, psi, fc, K=None):
    """New H (and in-kernel psi_H, K with magnetic Drude) from forward
    differences of E: the plain version of ``h_family``."""
    new_h, new_psi, new_k = _family_plain(H, E, psi, K, fc, backward=False)
    return stored(new_h, H), new_psi, new_k


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


class _Params(ctypes.Structure):
    """Mirror of ``struct Params`` in csrc/family.cu."""
    _fields_ = [("f", FamOps), ("S", ctypes.c_void_p * 3),
                ("dr", Drude), ("g", Grid)]


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


def psi_shape(shape, a: int, m: int) -> Tuple[int, ...]:
    """Shape of a compact slab psi array of axis a."""
    s = list(shape)
    s[a] = 2 * m
    return tuple(s)


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
            ps = psi_shape(shape, a, fc["m"][a])
            ops.psi_in[ci][t] = check(psi[key], key, ps, device)
            new_psi[key] = torch.empty(ps, dtype=torch.float32,
                                       device=device)
            ops.psi_out[ci][t] = new_psi[key].data_ptr()
    for a, m in fc["m"].items():
        ops.prof[a] = check(fc["prof"][a], f"prof[{a}]", (3, 2 * m), device)
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


def _params(F, S, psi, J, fc) -> Tuple[_Params, Dict, Dict, Optional[Dict]]:
    device = F[fc["comps"][0]].device
    shape = fc["shape"]
    prm = _Params()
    new_f, new_psi = fill_family(prm.f, F, psi, fc, device)
    fd = field_dtype(F[fc["comps"][0]])
    other = "H" if fc["family"] == "E" else "E"
    for d in range(3):
        key = other + AXES[d]
        prm.S[d] = check(S[key], key, shape, device, fd)
    new_j = fill_drude_grid(prm, J, fc, device, fd)
    return prm, new_f, new_psi, new_j


def _library() -> ctypes.CDLL:
    return bind(_LIB, ("fdtd_e_family", "fdtd_h_family"), _Params)


def e_family(E, H, psi, J, fc):
    """New E (and in-kernel psi_E, J) in fresh tensors: the CUDA kernel
    on CUDA tensors, its plain version on CPU tensors."""
    if not E[fc["comps"][0]].is_cuda:
        return e_family_plain(E, H, psi, J, fc)
    prm, new_e, new_psi, new_j = _params(E, H, psi, J, fc)
    launch(_library(), "fdtd_e_family", prm, E[fc["comps"][0]].device)
    e_family.launches += 1
    return new_e, new_psi, new_j


def h_family(H, E, psi, fc, K=None):
    """New H (and in-kernel psi_H, K) in fresh tensors: the CUDA kernel
    on CUDA tensors, its plain version on CPU tensors."""
    if not H[fc["comps"][0]].is_cuda:
        return h_family_plain(H, E, psi, fc, K)
    prm, new_h, new_psi, new_k = _params(H, E, psi, K, fc)
    launch(_library(), "fdtd_h_family", prm, H[fc["comps"][0]].device)
    h_family.launches += 1
    return new_h, new_psi, new_k


e_family.launches = 0
h_family.launches = 0


# --------------------------------------------------------------------------
# thin patches on kernel output (the reference's jnp post-passes)
# --------------------------------------------------------------------------

def _cut(f: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    return f.narrow(axis, lo, hi - lo)


def _pad1(f: torch.Tensor, axis: int, lo_side: bool) -> torch.Tensor:
    z = torch.zeros_like(f.narrow(axis, 0, 1))
    return torch.cat([z, f] if lo_side else [f, z], dim=axis)


def slab_post(static, family: str, fields, src, psi_ax, coeffs, slabs,
              axis: int):
    """One axis's CPML psi recursion and delta onto kernel output: the
    kernel computed the plain ``s * dfa`` for this axis's curl terms;
    the exact CPML term differs on the two slabs of ``axis`` by
    ``s * ((ik - 1) * dfa + psi')``. Adds in place onto ``fields``
    (fresh kernel outputs) and returns (fields, new psi of the axis)."""
    mode = static.mode
    upd = mode.e_components if family == "E" else mode.h_components
    tag = "e" if family == "E" else "h"
    ax = AXES[axis]
    inv_dx = float(np.float32(1.0 / static.dx))
    n1 = static.grid_shape[axis]
    m = slabs[axis]
    b = coeffs[f"pml_slab_b{tag}_{ax}"]
    cc = coeffs[f"pml_slab_c{tag}_{ax}"]
    ik = coeffs[f"pml_slab_ik{tag}_{ax}"]

    def r3(v, lo, hi):
        return _bcast1d(v[lo:hi], axis)

    def cut(f, lo, hi):
        return _cut(f, axis, lo, hi)

    new_psi = {}
    for c in upd:
        for (a, d_axis, s) in CURL_TERMS[component_axis(c)]:
            if a != axis:
                continue
            d = ("H" if family == "E" else "E") + AXES[d_axis]
            if d not in src:
                continue
            f = src[d]
            # slice first, widen the thin regions after (bf16 storage)
            f_lo = cut(f, 0, m + 1).float()
            f_hi = cut(f, n1 - m - 1, n1).float()
            if family == "E":      # backward diff, slabs [0,m) / [n1-m,n1)
                d_lo = (cut(f_lo, 0, m)
                        - _pad1(cut(f_lo, 0, m - 1), axis, True)) * inv_dx
                d_hi = (cut(f_hi, 1, m + 1) - cut(f_hi, 0, m)) * inv_dx
            else:                  # forward diff
                d_lo = (cut(f_lo, 1, m + 1) - cut(f_lo, 0, m)) * inv_dx
                d_hi = (_pad1(cut(f_hi, 2, m + 1), axis, False)
                        - cut(f_hi, 1, m + 1)) * inv_dx
            key = f"{c}_{ax}"
            psi = psi_ax[key]
            p_lo = r3(b, 0, m) * cut(psi, 0, m) + r3(cc, 0, m) * d_lo
            p_hi = (r3(b, m, 2 * m) * cut(psi, m, 2 * m)
                    + r3(cc, m, 2 * m) * d_hi)
            new_psi[key] = torch.cat([p_lo, p_hi], dim=axis)
            dl = s * ((r3(ik, 0, m) - 1.0) * d_lo + p_lo)
            dh = s * ((r3(ik, m, 2 * m) - 1.0) * d_hi + p_hi)
            cb = coeffs[("cb_" if family == "E" else "db_") + c]
            sign = 1.0 if family == "E" else -1.0
            if isinstance(cb, torch.Tensor):
                cb_lo, cb_hi = cut(cb, 0, m), cut(cb, n1 - m, n1)
            else:
                cb_lo = cb_hi = cb
            if family == "E":
                # respect PEC walls (the kernel already zeroed the field)
                wx = coeffs[f"wall_{ax}"]
                dl = dl * r3(wx, 0, m)
                dh = dh * r3(wx, n1 - m, n1)
                for a2 in range(3):
                    if a2 != component_axis(c) and a2 != axis:
                        w = _bcast1d(coeffs[f"wall_{AXES[a2]}"], a2)
                        dl = dl * w
                        dh = dh * w
            fdt = fields[c].dtype
            cut(fields[c], 0, m).add_((sign * cb_lo * dl).to(fdt))
            cut(fields[c], n1 - m, n1).add_((sign * cb_hi * dh).to(fdt))
    return fields, new_psi


def x_slab_post(static, family, fields, src, psi_x, coeffs, slabs):
    """Axis-0 wrapper of slab_post (the two-pass kernels' post-pass)."""
    return slab_post(static, family, fields, src, psi_x, coeffs, slabs, 0)


class FacePatch(NamedTuple):
    """The fixed part of one TFSF face correction on its plane: the line
    sampled, the interpolation (index and weights, broadcast over the
    plane), ``sign*pol/dx``, the 0/1 mask (transverse box gate and PEC
    walls) and ``sign * cb`` at the plane."""
    comp: str
    axis: int
    plane: int
    line: str
    i0: torch.Tensor
    i1: torch.Tensor
    ow: torch.Tensor
    w: torch.Tensor
    k: float
    mask: Optional[torch.Tensor]
    coef: Any


def plane_corrections(field: str, comp: str, setup, coeffs, inc,
                      active_axes, dx: float):
    """TFSF corrections of one component as (axis, plane, broadcastable
    term) triples, without the normal-axis onehot (the reference's
    ``plane_corrections`` :859): ``tfsf.corr_plane_term`` of each face."""
    out = []
    for corr in setup.corrections:
        if corr.field != field or corr.comp != comp:
            continue
        term = tfsf.corr_plane_term(corr, setup, coeffs, inc, active_axes,
                                    dx)
        if term is not None:
            out.append((corr.axis, corr.plane, term))
    return out


def tfsf_plan(static, coeffs, family: str) -> List[FacePatch]:
    """The fixed geometry of one family's TFSF face patches (the terms
    of ``plane_corrections`` up to the line samples), planned once per
    coefficient dict: the same geometry functions, so a planned patch
    has the bits of one computed from scratch."""
    setup = static.tfsf_setup
    if setup is None:
        return []
    mode = static.mode
    gs = (coeffs["gx"], coeffs["gy"], coeffs["gz"])
    comps = mode.e_components if family == "E" else mode.h_components
    sign = 1.0 if family == "E" else -1.0
    plan = []
    for c in comps:
        cb = coeffs[("cb_" if family == "E" else "db_") + c]
        for corr in setup.corrections:
            if corr.field != family or corr.comp != c:
                continue
            pol = tfsf.corr_polarization(corr, setup)
            if abs(pol) < tfsf.POL_EPS:
                continue
            if not 0 <= corr.plane < static.grid_shape[corr.axis]:
                continue
            u = tfsf.corr_line_coord(corr, setup, gs, mode.active_axes)
            i0, w = tfsf.clipped_line_coord(u, setup.n_inc)
            mask = tfsf.corr_gate_transverse(corr, setup, gs,
                                             mode.active_axes, torch.float32)
            if family == "E":
                # PEC wall zeroing must survive the patch
                for a2 in mode.active_axes:
                    if a2 != component_axis(c) and a2 != corr.axis:
                        wl = _bcast1d(coeffs[f"wall_{AXES[a2]}"], a2)
                        mask = wl if mask is None else mask * wl
            coef = sign * (cb.narrow(corr.axis, corr.plane, 1)
                           if isinstance(cb, torch.Tensor) else cb)
            plan.append(FacePatch(
                c, corr.axis, corr.plane,
                "Einc" if corr.src[0] == "E" else "Hinc", i0, i0 + 1,
                1.0 - w, w, float(np.float32(corr.sign * pol / static.dx)),
                mask, coef))
    return plan


def tfsf_patch(static, family: str, fields, coeffs, inc,
               plan: Optional[List[FacePatch]] = None):
    """Add the TFSF face corrections onto the kernel output planes, in
    place (``cb * term`` per face: the reference's ``tfsf_patch`` :961).
    ``plan``: ``tfsf_plan``'s result, made here when not given."""
    if plan is None:
        plan = tfsf_plan(static, coeffs, family)
    for fp in plan:
        line = inc[fp.line]
        term = fp.k * (fp.ow * line[fp.i0] + fp.w * line[fp.i1])
        if fp.mask is not None:
            term = term * fp.mask
        dst = fields[fp.comp].narrow(fp.axis, fp.plane, 1)
        dst.add_((fp.coef * term).to(dst.dtype))
    return fields


def point_plan(static, coeffs):
    """The point source's fixed part: (component, cell, ps_amp * cb at
    the cell), or None when off."""
    ps = static.cfg.point_source
    if not ps.enabled or ps.component not in static.mode.e_components:
        return None
    cb = coeffs[f"cb_{ps.component}"]
    amp = np.float32(coeffs["ps_amp"])
    idx = tuple(ps.position)
    if isinstance(cb, torch.Tensor):
        scale = float(amp) * cb[idx]
    else:
        scale = float(amp * np.float32(cb))
    return ps.component, idx, scale


def point_source_patch(static, fields, coeffs, t: int, plan=None):
    """Soft point source as a single-cell add, in place
    (``ps_amp * cb * waveform``: the reference's ``point_source_patch``
    :1012)."""
    if plan is None:
        plan = point_plan(static, coeffs)
    if plan is None:
        return fields
    c, (i, j, k), scale = plan
    ps = static.cfg.point_source
    wf = np.float32(waveform(ps.waveform, t, 0.5, static.omega, static.dt,
                             static.real_dtype))
    cell = fields[c][i, j, k]
    if isinstance(scale, torch.Tensor):
        val = (scale * float(wf)).to(cell.dtype)
    else:
        val = host_round(float(np.float32(scale) * wf), cell.dtype)
    cell.add_(val)
    return fields


# --------------------------------------------------------------------------
# the two-pass step
# --------------------------------------------------------------------------

def make_pallas_step(static, device, plain: bool = False):
    """The two-pass step on dict-form state (not mutated; a new state
    dict is returned), or None when the reference would not take it (not
    ``eligible``, or a CPML x axis too thin for slab psi, where the
    reference runs its jnp step).

    On a CUDA ``device`` the two family updates launch the kernel (kind
    ``pallas3d_cuda``); on the CPU they run their plain versions (kind
    ``pallas3d_plain``). ``plain=True`` runs the plain versions on any
    device: the yardstick chip_smoke.py holds the kernel against."""
    if not eligible(static):
        return None
    check_scope(static, "two-pass family kernel (ROADMAP B3)")
    slabs = slab_axes(static)
    if 0 in static.pml_axes and 0 not in slabs:
        return None
    if any(a not in slabs for a in static.pml_axes):
        # only a sharded local extent can be too thin for slab psi
        raise NotImplementedError(
            "full-length CPML psi on y or z (a PML too thick for slab "
            "storage, which only a sharded topology makes) is not ported "
            "(ROADMAP.md queue A11)")
    setup = static.tfsf_setup
    x_active = 0 in static.pml_axes
    e_fn, h_fn = (e_family_plain, h_family_plain) if plain \
        else (e_family, h_family)
    psi_e_names = [k for v in kernel_psi_terms(static, "E").values()
                   for _, k in v]
    psi_h_names = [k for v in kernel_psi_terms(static, "H").values()
                   for _, k in v]

    def prepare(coeffs) -> Dict[str, Any]:
        return {"coeffs": coeffs,
                "E": family_operands(static, coeffs, "E"),
                "H": family_operands(static, coeffs, "H"),
                "tfsf_E": tfsf_plan(static, coeffs, "E"),
                "tfsf_H": tfsf_plan(static, coeffs, "H"),
                "point": point_plan(static, coeffs)}

    def step(state, cc):
        coeffs = cc["coeffs"]
        t = state["t"]
        new_state = dict(state)
        if setup is not None:
            new_state["inc"] = tfsf.advance_einc(
                state["inc"], coeffs, t, static.dt, static.omega, setup)

        # E family
        psi_e_in = {k: state["psi_E"][k] for k in psi_e_names}
        new_E, psi_e_out, new_J = e_fn(state["E"], state["H"], psi_e_in,
                                       state.get("J"), cc["E"])
        if new_J is not None:
            new_state["J"] = new_J
        psi_E = dict(state.get("psi_E", {}), **psi_e_out)
        if x_active:
            px = {k: v for k, v in psi_E.items() if k.endswith("_x")}
            new_E, px_new = x_slab_post(static, "E", new_E, state["H"], px,
                                        coeffs, slabs)
            psi_E.update(px_new)
        if setup is not None:
            tfsf_patch(static, "E", new_E, coeffs, new_state["inc"],
                       plan=cc["tfsf_E"])
        point_source_patch(static, new_E, coeffs, t, plan=cc["point"])
        new_state["E"] = new_E

        if setup is not None:
            new_state["inc"] = tfsf.advance_hinc(new_state["inc"], coeffs,
                                                 setup)

        # H family
        psi_h_in = {k: state["psi_H"][k] for k in psi_h_names}
        new_H, psi_h_out, new_K = h_fn(state["H"], new_E, psi_h_in,
                                       cc["H"], state.get("K"))
        if new_K is not None:
            new_state["K"] = new_K
        psi_H = dict(state.get("psi_H", {}), **psi_h_out)
        if x_active:
            px = {k: v for k, v in psi_H.items() if k.endswith("_x")}
            new_H, px_new = x_slab_post(static, "H", new_H, new_E, px,
                                        coeffs, slabs)
            psi_H.update(px_new)
        if setup is not None:
            tfsf_patch(static, "H", new_H, coeffs, new_state["inc"],
                       plan=cc["tfsf_H"])
        new_state["H"] = new_H
        if psi_E:
            new_state["psi_E"] = psi_E
            new_state["psi_H"] = psi_H
        new_state["t"] = t + 1
        return new_state

    step.prepare = prepare
    on_cuda = torch.device(device).type == "cuda"
    step.kind = "pallas3d_cuda" if on_cuda and not plain else "pallas3d_plain"
    return step

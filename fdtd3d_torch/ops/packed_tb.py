"""Temporal-blocked packed pass at depth 2: two Yee steps per launch.

Replaces the Pallas TPU kernel
``fdtd3d_tpu/ops/pallas_packed_tb.py::make_packed_tb_step`` (builder
:520, kernel body :900, ``pallas_call`` :1320; scope ``_reject_reason``
:214, host step :1809-1955) for unsharded 3D float32 runs at k = 2,
with the hand-written CUDA C++ kernel ``fdtd3d_torch/csrc/packed_tb.cu``
(``sm_90a``, built by nvcc at first use, bound with ctypes). CUDA C++
rather than Triton: a marching stencil with shared-memory plane rings,
per-column register state and CPML slab branches.

What one pass computes: E(t+1), H(t+1), E(t+2), H(t+2) from E(t), H(t),
with the slab CPML of every axis run twice, electric Drude J, material
grids, PEC walls, and the sources added into the accumulator at each
generation (the reference tb's form): TFSF through the record table of
``ops/packed_ds.py`` with this pass's two rows of f32 plane terms
(``tfsf.record_terms``), the point source as ``ps_amp * waveform(t+g-1)``
for g = 1, 2. Generation t+1 never reaches device memory.

Design: the kernel reads the carry and writes a second buffer set of
the same shapes, because a block reads halo cells that a neighbour
writes (csrc/packed_tb.cu). The step keeps that spare set and swaps it
with the carry's E, H, psi and J every pass, so the carry always holds
the live fields and the spare costs one more copy of them in memory. The
incident line advances on the host side of the pass in thin torch ops,
twice per pass, in the reference's order: ``advance_einc(t+g-1)``, the
records' terms of generation g, ``advance_hinc``.

The step advances two steps per call (``steps_per_call``); its
``tail_step`` is the packed single step (``ops/packed.py``), which shares
the carry layout, ``pack``/``unpack`` and ``prepare``, and runs in place
on whichever buffer is live for an odd remainder.

Lanes (the reference's ``batch=B`` build of this kernel): with
``batch=B`` the carry and its spare have a leading lane axis (see
``ops/packed.py``), and one launch advances all B lanes by two steps.
The record table is geometry and serves every lane; the record terms
are (2, B, total), one row per generation and lane, from the
lane-stacked incident line in the same eight ops as a solo run; the
point source's drive is a (B, 2) device tensor, ``ps_amp`` of each lane
times ``waveform(t+g-1)``. A solo run (``batch=0``) is one lane, and a
launch of one lane takes its drive as two host floats (kernel
parameters), as the solo pass did before lanes existed: the one-lane
build of the kernel is then the solo pass's code (csrc/packed_tb.cu).

Beside the kernel wrapper ``tb_pass`` stands its plain PyTorch version
``tb_pass_plain`` with the same signature, on the solo and the
lane-stacked layouts; the wrapper takes it only for CPU tensors, and on
a CUDA tensor launches the kernel or raises. ``tb_pass.launches`` counts
kernel launches (one per launch, whatever the number of lanes).
"""

from __future__ import annotations

import ctypes
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fdtd3d_torch.ops import build, packed, tfsf
from fdtd3d_torch.ops.packed_ds import Record, family_records
from fdtd3d_torch.ops.sources import waveform
from fdtd3d_torch.solver import slab_axes

DEPTH = 2             # steps per pass; the only depth of this kernel
MAX_REC = 16          # records per family; mirrors csrc/packed_tb.cu
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
    same (``ds_fields``, ``packed_ineligible``, ``compensated``,
    ``magnetic_drude``, ``source_in_absorber``), and the port's own for
    what this slice leaves out: ``dtype`` (float64), ``sharded``, and
    ``depth`` (``FDTD3D_TB_DEPTH`` pinned to anything but 2)."""
    cfg = static.cfg
    if cfg.ds_fields:
        return "ds_fields"
    if cfg.dtype != "float32":
        return "dtype"
    if tuple(static.topology) != (1, 1, 1):
        return "sharded"
    if set(static.pml_axes) != set(slab_axes(static)):
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


def _fields(carry) -> List[torch.Tensor]:
    """The pass's buffers of a carry, in a fixed order: E, H, psi, J."""
    out = [carry["E"], carry["H"]]
    out += [carry["psE"][a] for a in sorted(carry["psE"])]
    out += [carry["psH"][a] for a in sorted(carry["psH"])]
    if "J" in carry:
        out.append(carry["J"])
    return out


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
    lane-stacked carry, one lane after the other."""
    for a, b in zip(_fields(dst), _fields(src)):
        a.copy_(b)
    if dst["E"].dim() == 4:
        _generations(dst, tb, terms, drive)
        return
    for lane in range(dst["E"].shape[0]):
        lane_tb = dict(tb, E=packed.lane_fc(tb["E"], lane),
                       H=packed.lane_fc(tb["H"], lane))
        _generations(_lane_carry(dst, lane), lane_tb,
                     None if terms is None else terms[:, lane],
                     drive if drive is None or isinstance(drive, list)
                     else drive[lane])


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
                ("fe", _Family), ("fh", _Family),
                ("kj", packed._Coef * 3), ("bj", packed._Coef * 3),
                ("m", ctypes.c_int * 3),
                ("pc", ctypes.c_int), ("pi", ctypes.c_int),
                ("pj", ctypes.c_int), ("pk", ctypes.c_int),
                ("drive", ctypes.c_float * 2),
                ("n1", ctypes.c_int), ("n2", ctypes.c_int),
                ("n3", ctypes.c_int), ("lanes", ctypes.c_int),
                ("inv_dx", ctypes.c_float)]


def _library() -> ctypes.CDLL:
    lib = build.load(_LIB)
    if not getattr(lib, "_fdtd_bound", False):
        lib.fdtd_tb_pass.argtypes = [ctypes.POINTER(_Params),
                                     ctypes.c_void_p]
        lib.fdtd_tb_pass.restype = ctypes.c_int
        lib.fdtd_tb_params_size.restype = ctypes.c_int
        lib.fdtd_tb_error_string.argtypes = [ctypes.c_int]
        lib.fdtd_tb_error_string.restype = ctypes.c_char_p
        if lib.fdtd_tb_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"{_LIB}: struct Params is {lib.fdtd_tb_params_size()} "
                f"bytes in CUDA and {ctypes.sizeof(_Params)} in ctypes")
        lib._fdtd_bound = True
    return lib


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


def _params(src, dst, tb, terms, drive) -> _Params:
    device = src["E"].device
    shape = tb["shape"]
    lanes, lead = packed.carry_lanes(src["E"])
    prm = _Params.from_buffer_copy(_base_params(tb, device, lanes))
    full = lead + (3,) + tuple(shape)
    prm.E0 = packed._check(src["E"], "E", full, device)
    prm.H0 = packed._check(src["H"], "H", full, device)
    prm.E2 = packed._check(dst["E"], "E (destination)", full, device)
    prm.H2 = packed._check(dst["H"], "H (destination)", full, device)
    if tb["E"]["kj"] is not None:
        prm.J0 = packed._check(src["J"], "J", full, device)
        prm.J2 = packed._check(dst["J"], "J (destination)", full, device)
    for a, m in tb["E"]["m"].items():
        ps = packed.psi_shape(shape, a, m, lead)
        prm.psE0[a] = packed._check(src["psE"][a], f"psE[{a}]", ps, device)
        prm.psH0[a] = packed._check(src["psH"][a], f"psH[{a}]", ps, device)
        prm.psE2[a] = packed._check(dst["psE"][a], f"psE[{a}] (dst)", ps,
                                    device)
        prm.psH2[a] = packed._check(dst["psH"][a], f"psH[{a}] (dst)", ps,
                                    device)
    if {t.data_ptr() for t in _fields(src)} \
            & {t.data_ptr() for t in _fields(dst)}:
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
    lane-stacked carry in one launch: the CUDA kernel on CUDA tensors,
    its plain version on CPU tensors."""
    if not src["E"].is_cuda:
        tb_pass_plain(src, dst, tb, terms, drive)
        return
    prm = _params(src, dst, tb, terms, drive)
    lib = _library()
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

def _alloc_like(carry) -> Dict[str, Any]:
    return {"E": torch.empty_like(carry["E"]),
            "H": torch.empty_like(carry["H"]),
            "psE": {a: torch.empty_like(v) for a, v in carry["psE"].items()},
            "psH": {a: torch.empty_like(v) for a, v in carry["psH"].items()},
            **({"J": torch.empty_like(carry["J"])} if "J" in carry else {})}


def _swap(carry, spare) -> None:
    """Exchange the pass's buffers between the carry and the spare."""
    for key in ("E", "H", "J"):
        if key in carry:
            carry[key], spare[key] = spare[key], carry[key]
    for fam in ("psE", "psH"):
        for a in carry[fam]:
            carry[fam][a], spare[fam][a] = spare[fam][a], carry[fam][a]


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
            spare.update(_alloc_like(ps))
        fn(ps, spare, cc["tb"], terms, drive)
        _swap(ps, spare)
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

"""Temporal-blocked packed pass at depth 2: two Yee steps per call.

Replaces the Pallas TPU kernel
``fdtd3d_tpu/ops/pallas_packed_tb.py::make_packed_tb_step`` (builder
:520, kernel body :900, ``pallas_call`` :1320; scope ``_reject_reason``
:214, host step :1809-1955; sharded parts :1339-1788) for 3D float32
and bf16 storage runs at k = 2, unsharded and on a decomposed grid,
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

Shards (``make_sharded_packed_tb_step``, the sharded variant): each
shard of a decomposed run runs its two generations on its frame, its box
grown by GHOST = 2 cells on every side with a neighbour. Before a pass
the neighbours' last two generation-0 planes of E, H, J and of each psi
stack are copied into the shard's ghost buffers, axis by axis, those of
a later axis spanning the earlier axes' ghost planes (the corners;
``stencil.exchange_stack(..., depth=2)``); the kernel's sharded build
reads them where the frame leaves the shard's box and computes
generation 1 there in its own halo, as it already does between the
blocks of one grid, so H(t+2) at a shard's upper edge reads the true
E(t+2). This route replaces the reference's: its TPU pass keeps the
interconnect bytes of a step whatever the depth with a plain boundary
pre-pass (the wedge, :1537/:1612) that advances the outer planes and
sends generation ghosts, plus a hi-edge fix after the kernel; here the
kernel recomputes that wedge from generation 0, so there is neither a
pre-pass nor a fix, and a pass copies two planes a side of E, H, J and
psi, about twice the single-step exchange's planes a step. The frame's
coordinates carry every decision: walls on the global edges only
(``ShardMesh.open_sides``), the TFSF records and the point source
wherever the frame holds their cells (a neighbour's halo included), a
ghost plane outside every CPML slab of its axis (``shards_fit``, else
the token ``no_viable_depth``); the coefficient grids stay the shard's
own with their frame cells in ghost buffers built once
(``frame_coeffs``). The kernel takes its CPML slab decisions on the
global grid, so an interior shard's identity slab rows run the plain
code (``plan_rows``). Its sharded builds compute a cell as the
unsharded ones do, with the products nvcc contracts into FMAs, so on
the card a shard's pass agrees with ``tb_pass_sharded_plain``, the
plain version (``tb_pass_plain`` on the frame grown from those
buffers, its slabs widened by GHOST identity rows on a sharded axis,
the shard's box kept), and a sharded run with the unsharded one, at the
pass's gate; on the CPU both are the plain versions and agree bit for
bit.

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
from fdtd3d_torch.ops.stencil import (deep_copies, deep_ghost_buffers,
                                      exchange_stack, extend_stack,
                                      run_copies)
from fdtd3d_torch.solver import slab_axes

DEPTH = 2             # steps per pass; the only depth of this kernel
GHOST = 2             # planes a shard reads beyond each open side a pass
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
    ``source_in_absorber``, ``no_viable_depth``: on a topology, a shard
    too thin for its two ghost planes, ``shards_fit``), and the port's
    own for what this slice leaves out: ``dtype`` (float64) and
    ``depth`` (``FDTD3D_TB_DEPTH`` pinned to anything but 2)."""
    cfg = static.cfg
    if static.paired_complex:
        return "paired_complex"
    if cfg.ds_fields:
        return "ds_fields"
    if static.mode.name != "3D" or cfg.complex_fields:
        return "packed_ineligible"
    if cfg.dtype not in ("float32", "bfloat16"):
        return "dtype"
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
    if not shards_fit(static):
        return "no_viable_depth"
    return None


def shards_fit(static) -> bool:
    """Whether every shard of a decomposed run holds the sharded pass's
    frame (``shard_frame``): on each sharded axis a local extent of at
    least four cells and of ``2 m + 2`` with an m-plane CPML slab, so
    that the GHOST planes it reads from a neighbour lie outside every
    CPML slab of that axis (their psi is then zero) and the frame's
    widened slab rows fit on each side. True unsharded."""
    slabs = slab_axes(static)
    for a in range(3):
        p = static.topology[a]
        if p > 1 and static.grid_shape[a] // p < max(
                2 * GHOST, 2 * slabs.get(a, 0) + GHOST):
            return False
    return True


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
    inc, terms, drives = generation_terms_many(static, [tb], inc, t)
    return inc, terms[0], drives[0]


def generation_terms_many(static, tbs: List[Dict[str, Any]], inc, t: int):
    """``generation_terms`` of several prepared passes that share one
    incident line (the shards of one device): the line advanced once,
    each pass's record terms and drive from it -> (line, [terms],
    [drive])."""
    setup = static.tfsf_setup
    terms: List[Optional[torch.Tensor]] = [None] * len(tbs)
    if setup is not None:
        for i, tb in enumerate(tbs):
            plan = tb["plan"]
            if plan is not None:
                lanes = (tb["batch"],) if tb["batch"] else ()
                terms[i] = torch.empty((DEPTH,) + lanes + (plan.total,),
                                       dtype=torch.float32,
                                       device=plan.w.device)
        coeffs = tbs[0]["coeffs"]
        for g in range(DEPTH):
            inc = tfsf.advance_einc(inc, coeffs, t + g, static.dt,
                                    static.omega, setup)
            for tb, out in zip(tbs, terms):
                if out is not None:
                    tfsf.record_terms(tb["plan"], inc, out=out[g])
            inc = tfsf.advance_hinc(inc, coeffs, setup)
    drives: List[Any] = [None] * len(tbs)
    ps = static.cfg.point_source
    if ps.enabled:
        wfs = [waveform(ps.waveform, t + g, 0.5, static.omega, static.dt,
                        static.real_dtype) for g in range(DEPTH)]
        for i, tb in enumerate(tbs):
            amp = tb.get("amp")
            if tb["point"] is None:
                continue
            if isinstance(amp, torch.Tensor):
                drive = torch.empty((amp.shape[0], DEPTH),
                                    dtype=torch.float32, device=amp.device)
                for g, wf in enumerate(wfs):
                    torch.mul(amp, float(wf), out=drive[:, g])
                drives[i] = drive
            else:
                drives[i] = [float(amp * wf) for wf in wfs]
    return inc, terms, drives


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
# a shard's frame (the sharded pass)
# --------------------------------------------------------------------------

# identity values of the CPML slab profiles' rows: psi's decay b and
# coupling c 0, 1/kappa 1 (a row the frame adds runs the slab code on a
# psi that stays 0 and adds exact zeros)
_IDENTITY = {"b": 0.0, "c": 0.0, "ik": 1.0}


def shard_frame(static, mesh, r: int) -> Dict[str, Any]:
    """Shard r's frame: its box grown by GHOST cells on every side with a
    neighbour (the cells whose generation 1 the pass computes again from
    the neighbours' generation 0), as per-axis tuples: ``lo``/``hi``
    (GHOST or 0), ``nl`` (the local extent), ``shape`` (the frame's),
    ``base`` (the frame's first global index), ``ml`` (the local slab
    planes a side, 0 without), ``open`` (``ShardMesh.open_sides``), and
    ``me``: axis -> the frame's slab planes a side, ``ml`` + GHOST on a
    sharded axis (the frame's rows beyond the shard's slab are
    identity: its ghost planes, or interior cells beside a closed side,
    whose psi is 0 by ``shards_fit``), ``ml`` elsewhere (the plain
    version's slabs; the kernel takes its slab decisions on the global
    grid ``grid``, where only the global CPML slabs are)."""
    opens = mesh.open_sides(r)
    nl, off = mesh.local_shape, mesh.offset(r)
    lo = tuple(GHOST if opens[a][0] else 0 for a in range(3))
    hi = tuple(GHOST if opens[a][1] else 0 for a in range(3))
    slabs = slab_axes(static)
    return {"lo": lo, "hi": hi, "nl": tuple(nl), "open": opens,
            "grid": tuple(mesh.grid_shape),
            "shape": tuple(nl[a] + lo[a] + hi[a] for a in range(3)),
            "base": tuple(off[a] - lo[a] for a in range(3)),
            "ml": tuple(slabs.get(a, 0) for a in range(3)),
            "me": {a: m + (GHOST if mesh.topology[a] > 1 else 0)
                   for a, m in slabs.items()}}


def pad_slab(t: torch.Tensor, dim: int, m: int, opens, fill) -> torch.Tensor:
    """A slab-compact stack (2m planes along ``dim``: the low slab, then
    the high one) widened to the frame's 2 (m + GHOST): GHOST planes of
    ``fill`` before the low slab on an open low side (after it on a
    closed one), after the high slab on an open high side (before it on
    a closed one)."""
    shape = list(t.shape)
    shape[dim] = GHOST
    z = torch.full(shape, fill, dtype=t.dtype, device=t.device)
    low, high = t.narrow(dim, 0, m), t.narrow(dim, m, m)
    return torch.cat(([z, low] if opens[0] else [low, z])
                     + ([high, z] if opens[1] else [z, high]), dim)


def unpad_slab(t: torch.Tensor, dim: int, m: int, opens) -> torch.Tensor:
    """The shard's own 2m planes of a frame-wide slab stack
    (``pad_slab``'s inverse), as a new tensor."""
    me = m + GHOST
    low = t.narrow(dim, GHOST if opens[0] else 0, m)
    high = t.narrow(dim, me + (0 if opens[1] else GHOST), m)
    return torch.cat([low, high], dim)


def frame_coeffs(static, mesh, coeffs: List[Dict[str, Any]]
                 ) -> List[Dict[str, Any]]:
    """Every shard's coefficients over its frame, from the shards' own
    dicts (``ShardMesh.split``'s cut): a vector along an axis of the
    shard's length (cell indices, walls, full CPML profiles) grown by its
    neighbours' GHOST boundary cells (new tensors); the slab profiles
    ``pml_slab_*`` of a sharded axis widened by ``pad_slab`` with
    identity rows; a 3D grid kept as the shard's own, its frame cells
    beyond the box in GHOST-plane buffers under ``_frame_ghosts`` (key
    -> ``stencil.deep_ghost_buffers`` of the grid as a one-row stack,
    filled by ``exchange_stack``: the corners from the neighbours'
    buffers), which the kernel reads as it reads the fields' ghosts;
    everything else as it is. Built once, when the step prepares."""
    from fdtd3d_torch.parallel.mesh import _axis_suffix
    nl = mesh.local_shape
    slabs = slab_axes(static)
    out = [dict(c, _frame_ghosts={}) for c in coeffs]
    for key, v0 in coeffs[0].items():
        if not isinstance(v0, torch.Tensor):
            continue
        if v0.dim() == 3:
            stacks = [c[key].unsqueeze(0) for c in coeffs]
            gh = deep_ghost_buffers(mesh, stacks, GHOST)
            exchange_stack(stacks, gh, mesh, 0, depth=GHOST)
            for r in range(mesh.n):
                out[r]["_frame_ghosts"][key] = gh[r]
            continue
        if v0.dim() == 1 and _axis_suffix(key) is not None:
            a = _axis_suffix(key)
            if key.startswith("pml_slab_") and a in slabs \
                    and mesh.topology[a] > 1:
                core = key[len("pml_slab_"):-2]
                ident = _IDENTITY[next(v for v in ("ik", "b", "c")
                                       if core.startswith(v))]
                for r in range(mesh.n):
                    out[r][key] = pad_slab(coeffs[r][key], 0, slabs[a],
                                           mesh.open_sides(r)[a], ident)
                continue
            if v0.shape[0] != nl[a] or mesh.topology[a] == 1:
                continue
            for r in range(mesh.n):
                parts = []
                lo, hi = mesh.neighbor(r, a, -1), mesh.neighbor(r, a, 1)
                dev = coeffs[r][key].device
                if lo is not None:
                    parts.append(coeffs[lo][key][-GHOST:].to(dev))
                parts.append(coeffs[r][key])
                if hi is not None:
                    parts.append(coeffs[hi][key][:GHOST].to(dev))
                out[r][key] = torch.cat(parts)
    return out


def frame_family(fc) -> Dict[str, Any]:
    """A sharded pass's family operands with every coefficient grid grown
    over the frame from its ghost buffers (new tensors): the plain
    version's operands."""
    out = dict(fc)
    for key, ghosts in fc["ghost"].items():
        out[key] = [v if g is None else
                    extend_stack(v.unsqueeze(0), g)[0]
                    for v, g in zip(fc[key], ghosts)]
    return out


def prepare_shard(static, mesh, r: int, coeffs: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """Shard r's pass operands over its frame (``prepare``'s, from
    ``frame_coeffs``' dict): the families with the frame's slab planes
    ``me`` and widened profiles, the global TFSF records whose plane
    crosses the frame with that plane in frame coordinates (their term
    plan from the frame's cell indices, so every record cell of the halo
    gets its term), the point source wherever the frame holds its cell
    (a halo cell of a neighbour's included), and ``frame``
    (``shard_frame``)."""
    import dataclasses
    fr = shard_frame(static, mesh, r)
    ext = dataclasses.replace(static, grid_shape=fr["shape"],
                              topology=(1, 1, 1))
    base = fr["base"]
    fams = {}
    # each grid's frame cells beyond the shard's box, by the grid (the
    # families hold the coefficient dict's tensors)
    ghosts = {id(coeffs[key]): g
              for key, g in coeffs.get("_frame_ghosts", {}).items()}
    for f in ("E", "H"):
        fc = packed.prepare_family(ext, coeffs, f)
        fc["m"] = dict(fr["me"])
        fc["ghost"] = {key: [ghosts.get(id(v)) for v in fc[key]]
                       for key in ("a", "b", "kj", "bj")
                       if fc[key] is not None}
        fams[f] = fc
    records = {fam: [rec._replace(plane=rec.plane - base[rec.axis])
                     for rec in recs
                     if 0 <= rec.plane - base[rec.axis]
                     < fr["shape"][rec.axis]]
               for fam, recs in tfsf_records(static).items()}
    tb = prepare(ext, {"coeffs": coeffs, **fams}, records)
    if tb["point"] is not None:
        cell = tuple(p - b for p, b in zip(tb["point"][1], base))
        inside = all(0 <= cell[a] < fr["shape"][a] for a in range(3))
        tb["point"] = (tb["point"][0], cell) if inside else None
    tb["frame"] = fr
    tb["_material"] = frame_material(tb)
    return tb


def frame_material(tb) -> Tuple[Any, Dict[Tuple[str, int], float]]:
    """``material`` of a sharded pass over its frame: each grid grown
    over the frame one at a time (``packed.material``'s rule on it), the
    boxes joined."""
    shape = tb["shape"]
    fe, fh = tb["E"], tb["H"]
    if fe["kj"] is not None or fh["kj"] is not None \
            or any(isinstance(v, torch.Tensor)
                   for key in ("a", "b") for v in fh[key]):
        return "all", {}
    box, bg = None, {}
    for key in ("a", "b"):
        for c, (v, g) in enumerate(zip(fe[key], fe["ghost"][key])):
            if g is None:
                continue
            one = {"shape": shape, "a": [extend_stack(v.unsqueeze(0), g)[0]],
                   "b": None, "kj": None, "bj": None}
            got, val = packed.material(one)
            if got == "all":
                return "all", {}
            bg[(key, c)] = val[("a", 0)]
            if got == ():
                continue
            box = got if box is None else tuple(
                (min(p[0], q[0]), max(p[1], q[1])) for p, q in zip(box, got))
    if not bg:
        return None, {}
    return (() if box is None else box), bg


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


def _ranges(n: int, m: int, own) -> List[Tuple[int, int, bool]]:
    """The CPML bands and the interior of an axis of n cells, each cut to
    the owned range ``own`` (all of the axis when None), with whether it
    is a band."""
    lo, hi = _bands(n, m)
    oa, ob = own if own is not None else (0, n)
    return [(max(a, oa), min(b, ob), band)
            for a, b, band in ((0, lo, True), (lo, n - hi, False),
                               (n - hi, n, True))]


def _axis_cuts(n: int, m: int, size: int, align: int = 1,
               own=None) -> List[Tuple[int, int, bool]]:
    """Owned ranges of a y or z axis: each CPML band and the interior
    between them (inside ``own``), cut into the fewest near-equal pieces
    of at most ``size`` (the interior, with ``align`` > 1, at multiples
    of it); each with whether it lies in a band."""
    out: List[Tuple[int, int, bool]] = []
    for a, b, band in _ranges(n, m, own):
        if b > a and align > 1 and not band:
            out += [(u, v, band) for u, v in _aligned(a, b, size, align)]
        elif b > a:
            out += [(u, v, band)
                    for u, v in _pieces(a, b, -(-(b - a) // size))]
    return out


def _x_cuts(n: int, m: int, seg: int,
            own=None) -> List[Tuple[int, int, bool]]:
    """x segments: each CPML band whole, the interior in near-equal
    segments of at most ``seg`` planes (and none above MAX_PLANES), inside
    ``own``; each with whether it lies in a band."""
    out: List[Tuple[int, int, bool]] = []
    for a, b, band in _ranges(n, m, own):
        size = b - a if band else seg
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


def _tilings(shape, m, tile, zband: bool, zalign: int, own=None):
    """The (y, z) tiles of an x segment in a CPML band and of one in the
    interior: (j0, ny, k0, nz, layout) each. z-band columns narrow enough
    take the transposed layout; the interior tiles of the interior
    segments are ``zalign``-aligned along z (``_axis_cuts``), so their
    rows of owned cells start and end on whole 32-byte sectors when
    ``zalign`` is 8; the others keep ``tile``'s width."""
    n2, n3 = shape[1:]
    oy, oz = (None, None) if own is None else own[1:]
    wide = transposed_tile(tile)
    ycuts = {0: _axis_cuts(n2, m[1], tile[0], own=oy),
             1: _axis_cuts(n2, m[1], wide[0], own=oy)}
    zcuts = _axis_cuts(n3, m[2], tile[1], own=oz)
    zaligned = [c for c in _axis_cuts(n3, m[2], tile[1], zalign, oz)
                if not c[2]]
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
               zband=True, grids=None, zalign=8, segments=SEGMENTS,
               own=None) -> Tuple[np.ndarray, Tuple[int, ...]]:
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
    every lane): every lane of a batch runs the items of a solo call.
    ``own``: per axis the range [a, b) of the owned cells (a shard's box
    inside its frame, ``shard_frame``; all of ``shape`` when None): the
    owned boxes tile it, and the halo cells beyond it count as computed
    cells of the items beside it."""
    n1 = shape[0]
    m = tuple(m)
    records = [tuple(r) for r in records]
    tilings = _tilings(shape, m, tile, zband, zalign, own)
    for seg in segments:
        rows = []
        for x0, x1, xb in _x_cuts(n1, m[0], seg,
                                  None if own is None else own[0]):
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
    family read everywhere ("all"). A sharded pass's over its frame
    (``frame_material``)."""
    if "frame" in tb:
        return frame_material(tb)
    fe, fh = tb["E"], tb["H"]
    if fe["kj"] is not None or fh["kj"] is not None \
            or any(isinstance(v, torch.Tensor)
                   for key in ("a", "b") for v in fh[key]):
        return "all", {}
    return packed.material(fe)


def plan_rows(tb, tile=TILE, sms=132, zband=True):
    """``plan_items`` of a prepared pass. A sharded pass's (``frame``)
    is planned on the global grid, over the shard's box (``own``), with
    the global slabs, records, point source and grid box, and its rows
    moved into the frame's coordinates: the kernel takes its slab
    decisions on global coordinates, so an item is SLAB only where it
    reaches a global CPML slab (an interior shard's identity slab rows
    run the plain code)."""
    m, records, point = plan_geometry(tb)
    grids = _material(tb)[0]
    fr = tb.get("frame")
    if fr is None:
        return plan_items(tb["shape"], m, records, point, tile=tile,
                          sms=sms, zband=zband, grids=grids)
    base = fr["base"]
    if grids not in (None, (), "all"):
        grids = tuple((lo + base[a], hi + base[a])
                      for a, (lo, hi) in enumerate(grids))
    rows, counts = plan_items(
        fr["grid"], fr["ml"], [(a, q + base[a]) for a, q in records],
        None if point is None else tuple(
            q + base[a] for a, q in enumerate(point)),
        tile=tile, sms=sms, zband=zband, grids=grids,
        own=tuple((base[a] + fr["lo"][a], base[a] + fr["lo"][a]
                   + fr["nl"][a]) for a in range(3)))
    rows = rows.copy()
    for col, a in ((0, 1), (1, 2), (4, 0), (5, 0)):
        rows[:, col] -= base[a]
    return rows, counts


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

# the coefficient grids a shard's pass reads through ghost buffers, in the
# order of Params.gco in csrc/packed_tb.cu (three components each)
GRID_SLOTS = (("E", "a"), ("E", "b"), ("E", "kj"), ("E", "bj"), ("H", "a"),
              ("H", "b"))


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
                ("inv_dx", ctypes.c_float), ("bf16", ctypes.c_int),
                ("shard", ctypes.c_int), ("lo", ctypes.c_int * 3),
                ("nl", ctypes.c_int * 3),
                ("open_lo", ctypes.c_int * 3),
                ("open_hi", ctypes.c_int * 3),
                ("base", ctypes.c_int * 3), ("ng", ctypes.c_int * 3),
                ("gE", ctypes.c_void_p * 6), ("gH", ctypes.c_void_p * 6),
                ("gJ", ctypes.c_void_p * 6), ("gpE", ctypes.c_void_p * 18),
                ("gpH", ctypes.c_void_p * 18),
                ("gco", ctypes.c_void_p * (18 * len(GRID_SLOTS)))]


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
    rows, counts = plan_rows(tb, (geo[0], geo[1]), sms, bool(geo[3]))
    if int((rows[:, 5] - rows[:, 4]).max()) > geo[2]:
        raise ValueError("plan_items made an item longer than the kernel's "
                         f"{geo[2]} planes")
    plan = (torch.from_numpy(rows).to(device), counts)
    tb["_plan"] = (key, plan)
    return plan


def occupancy() -> Dict[str, Dict[str, int]]:
    """Registers and local (spill) bytes a thread, resident blocks an SM
    and static shared bytes of each tb kernel, as the CUDA runtime
    reports them for the card: each section's kernel (SECTIONS), solo,
    lane-capable (``*_lanes``) and a shard's (``*_sharded``), float32
    and bf16 (``*_bf16``); the grid sections' at their larger shared
    memory."""
    lib = _library()
    out = (ctypes.c_int * (24 * len(SECTIONS)))()
    err = lib.fdtd_tb_occupancy(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fdtd_tb_occupancy failed: CUDA error {err} "
                           f"({lib.fdtd_tb_error_string(err).decode()})")
    names = tuple(n + lane + dt for dt in ("", "_bf16") for n in SECTIONS
                  for lane in ("", "_lanes", "_sharded"))
    keys = ("registers", "local_bytes", "blocks_per_sm", "static_smem")
    return {n: {k: out[4 * q + i] for i, k in enumerate(keys)}
            for q, n in enumerate(names)}


def _family_struct(fc, table, device, lanes: int, shape=None) -> _Family:
    shape = shape or fc["shape"]
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
    # a shard's grids are its own (its frame's cells beyond them in
    # ghost buffers)
    grids = tb["frame"]["nl"] if "frame" in tb else shape
    prm = _Params()
    prm.fe = _family_struct(fe, tb["rec_E"], device, lanes, grids)
    # the items that read no grid take each E grid's background value
    for (key, c), value in _material(tb)[1].items():
        getattr(prm.fe, key)[c].val = value
    prm.fh = _family_struct(tb["H"], tb["rec_H"], device, lanes, grids)
    if fe["kj"] is not None:
        for c in range(3):
            prm.kj[c] = packed._coef_struct(fe["kj"][c], f"kj[{c}]", grids,
                                            device, lanes)
            prm.bj[c] = packed._coef_struct(fe["bj"][c], f"bj[{c}]", grids,
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
# the sharded pass: one shard's two generations in its frame
# --------------------------------------------------------------------------

def frame_carry(src, ghosts, fr) -> Dict[str, Any]:
    """A shard's pass buffers over its frame (new tensors): E, H and J
    grown by their ghost planes, each psi stack grown along the other
    sharded axes and widened along its own by ``pad_slab`` with zero
    planes where that axis is sharded."""
    out = {"E": extend_stack(src["E"], ghosts["E"]),
           "H": extend_stack(src["H"], ghosts["H"]), "psE": {}, "psH": {}}
    if "J" in src:
        out["J"] = extend_stack(src["J"], ghosts["J"])
    for fam in ("psE", "psH"):
        for b, v in src[fam].items():
            e = extend_stack(v, ghosts[fam][b])
            if b in fr["me"] and fr["me"][b] != fr["ml"][b]:
                e = pad_slab(e, 1 + b, fr["ml"][b], fr["open"][b], 0.0)
            out[fam][b] = e
    return out


def _local(t: torch.Tensor, fr, skip=None) -> torch.Tensor:
    """The shard's box of a frame-wide tensor with a leading row axis
    (all but ``skip``, a psi stack's own axis)."""
    for a in range(3):
        if a != skip:
            t = t.narrow(1 + a, fr["lo"][a], fr["nl"][a])
    return t


def tb_pass_sharded_plain(src, dst, tb, terms, drive, ghosts) -> None:
    """The plain version of ``tb_pass_sharded``: ``tb_pass_plain`` on the
    shard's frame (``frame_carry`` of ``src`` and its ghosts, with the
    frame's operands ``tb`` from ``prepare_shard``; PEC zero beyond the
    frame, walls on the global edges only through the frame's wall
    vectors), the shard's box of the result written into ``dst``. A
    frame cell within GHOST - 1 of an open edge is wrong after two
    generations (its stencil reaches past the frame) and is dropped with
    the rest of the halo: no cell of the box reads it."""
    fr = tb["frame"]
    frame = frame_carry(src, ghosts, fr)
    out = packed.alloc_like(frame)
    tb_pass_plain(frame, out, dict(tb, E=frame_family(tb["E"]),
                                   H=frame_family(tb["H"])), terms, drive)
    for key in ("E", "H", "J"):
        if key in dst:
            dst[key].copy_(_local(out[key], fr))
    for fam in ("psE", "psH"):
        for b, v in dst[fam].items():
            t = _local(out[fam][b], fr, skip=b)
            if fr["me"][b] != fr["ml"][b]:
                t = unpad_slab(t, 1 + b, fr["ml"][b], fr["open"][b])
            v.copy_(t)


def _ghost_tensors(ghosts) -> List[torch.Tensor]:
    """The ghost buffers of one shard's pass, in a fixed order."""
    out = []
    for key in ("E", "H", "J", "psE", "psH"):
        gh = ghosts.get(key, {})
        for one in ((gh,) if key in ("E", "H", "J") else
                    [gh[a] for a in sorted(gh)]):
            out += [b for a in sorted(one) for b in one[a] if b is not None]
    return out


def _params_sharded(src, dst, tb, terms, drive, ghosts, lib) -> _Params:
    """``_params`` of one shard's pass: the frame's operands (its shape,
    coefficient grids, widened slab profiles, records and point source),
    the shard's own buffers (local shape) and the ghost buffers
    (``stencil.deep_ghost_buffers``' layout) by axis and side. The block
    is checked and built once per set of buffers (a shard's carry and
    spare set swap every pass: two blocks), its record terms and drive
    set every call."""
    key = tuple(t.data_ptr() for t in packed.carry_buffers(src)
                + packed.carry_buffers(dst) + _ghost_tensors(ghosts))
    cache = tb.setdefault("_sharded_params", {})
    prm = cache.get(key)
    if prm is None:
        if len(cache) >= 4:
            cache.clear()
        prm = cache[key] = _build_params_sharded(src, dst, tb, ghosts, lib)
    if tb["plan"] is not None:
        prm.terms = packed._check(terms, "terms", (DEPTH, tb["plan"].total),
                                  src["E"].device)
        prm.total = tb["plan"].total
    if tb["point"] is not None:
        prm.drive[0], prm.drive[1] = drive
    return prm


def _build_params_sharded(src, dst, tb, ghosts, lib) -> _Params:
    device = src["E"].device
    fr = tb["frame"]
    prm = _Params.from_buffer_copy(_base_params(tb, device, 1))
    plan, counts = _device_plan(tb, device, lib)
    prm.plan = plan.data_ptr()
    for q, n in enumerate(counts):
        prm.n_item[q] = n
    nl = fr["nl"]
    full = (3,) + tuple(nl)
    fd = packed.field_dtype(src["E"])
    if src["E"].dim() != 4:
        raise ValueError("tb_pass_sharded takes a solo shard carry")
    prm.E0 = packed._check(src["E"], "E", full, device, fd)
    prm.H0 = packed._check(src["H"], "H", full, device, fd)
    prm.E2 = packed._check(dst["E"], "E (destination)", full, device, fd)
    prm.H2 = packed._check(dst["H"], "H (destination)", full, device, fd)
    prm.bf16 = int(fd == torch.bfloat16)
    prm.shard = 1
    for a in range(3):
        prm.lo[a], prm.nl[a] = fr["lo"][a], nl[a]
        prm.open_lo[a], prm.open_hi[a] = (int(v) for v in fr["open"][a])
        prm.base[a], prm.ng[a] = fr["base"][a], fr["grid"][a]
    # the kernel's slabs are the global ones: the shard's own slab planes
    # and profile rows (the frame's widened rows are the plain version's)
    for fam, f in (("E", prm.fe), ("H", prm.fh)):
        for a, prof in _local_profiles(tb, fam).items():
            prm.m[a] = fr["ml"][a]
            f.prof[a] = packed._check(prof, f"{fam} prof[{a}]",
                                      (3, 2 * fr["ml"][a]), device)

    def ghost_ptrs(gh, name, like, out, at, dtype=torch.float32):
        for a, pair in gh.items():
            for side, buf in enumerate(pair):
                if buf is None:
                    continue
                want = list(like.shape)
                want[1 + a] = GHOST
                for c in range(a):
                    if c in gh:
                        want[1 + c] += fr["lo"][c] + fr["hi"][c]
                out[at + 2 * a + side] = packed._check(
                    buf, f"{name} ghost[{a}][{side}]", tuple(want), device,
                    dtype)

    # the coefficient grids' frame cells: slot s of GRID_SLOTS
    for s, (fam, key) in enumerate(GRID_SLOTS):
        for c, g in enumerate(tb[fam]["ghost"].get(key, (None,) * 3)):
            if g is not None:
                ghost_ptrs(g, f"{fam} {key}[{c}]",
                           tb[fam][key][c].unsqueeze(0), prm.gco,
                           6 * (3 * s + c))
    ghost_ptrs(ghosts["E"], "E", src["E"], prm.gE, 0, fd)
    ghost_ptrs(ghosts["H"], "H", src["H"], prm.gH, 0, fd)
    if tb["E"]["kj"] is not None:
        prm.J0 = packed._check(src["J"], "J", full, device)
        prm.J2 = packed._check(dst["J"], "J (destination)", full, device)
        ghost_ptrs(ghosts["J"], "J", src["J"], prm.gJ, 0)
    for a in tb["E"]["m"]:
        ml = fr["ml"][a]
        ps = packed.psi_shape(nl, a, ml)
        if int(np.prod(ps)) >= 2 ** 31:
            raise ValueError(f"psi[{a}] of a shard of {nl} exceeds the "
                             "kernel's 32-bit psi offsets")
        prm.psE0[a] = packed._check(src["psE"][a], f"psE[{a}]", ps, device)
        prm.psH0[a] = packed._check(src["psH"][a], f"psH[{a}]", ps, device)
        prm.psE2[a] = packed._check(dst["psE"][a], f"psE[{a}] (dst)", ps,
                                    device)
        prm.psH2[a] = packed._check(dst["psH"][a], f"psH[{a}] (dst)", ps,
                                    device)
        ghost_ptrs(ghosts["psE"][a], f"psE[{a}]", src["psE"][a], prm.gpE,
                   6 * a)
        ghost_ptrs(ghosts["psH"][a], f"psH[{a}]", src["psH"][a], prm.gpH,
                   6 * a)
    if {t.data_ptr() for t in packed.carry_buffers(src)} \
            & {t.data_ptr() for t in packed.carry_buffers(dst)}:
        raise ValueError("tb_pass_sharded writes out of place: the "
                         "destination shares a buffer with the source")
    return prm


def _local_profiles(tb, fam: str) -> Dict[int, torch.Tensor]:
    """A sharded pass's CPML profiles of the shard's own slab planes (the
    frame's, ``pad_slab``'s, without their identity rows), made once."""
    key = f"_local_prof_{fam}"
    if key not in tb:
        fr = tb["frame"]
        tb[key] = {a: v if fr["me"][a] == fr["ml"][a] else unpad_slab(
            v, 1, fr["ml"][a], fr["open"][a]).contiguous()
            for a, v in tb[fam]["prof"].items()}
    return tb[key]


def tb_pass_sharded(src, dst, tb, terms, drive, ghosts) -> None:
    """One shard's two generations from ``src`` into ``dst`` (the sharded
    variant of ``tb_pass``): the CUDA kernel's sharded build on CUDA
    tensors, reading the generation-0 cells beyond the shard's box from
    its ``ghosts`` (``stencil.deep_ghost_buffers``: E, H, J, and each psi
    stack's by axis) and computing generation 1 on the frame
    (``prepare_shard``'s operands); its plain version on CPU tensors.
    ``tb_pass_sharded.launches`` counts the kernel's calls."""
    if not src["E"].is_cuda:
        tb_pass_sharded_plain(src, dst, tb, terms, drive, ghosts)
        return
    lib = _library()
    prm = _params_sharded(src, dst, tb, terms, drive, ghosts, lib)
    stream = torch.cuda.current_stream(src["E"].device).cuda_stream
    err = lib.fdtd_tb_pass(ctypes.byref(prm), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"fdtd_tb_pass (sharded) launch failed: CUDA "
                           f"error {err} "
                           f"({lib.fdtd_tb_error_string(err).decode()})")
    tb_pass_sharded.launches += 1


tb_pass_sharded.launches = 0


def make_deep_exchange(mesh):
    """(exchange, ghosts) of the sharded pass: ``exchange(shards)`` fills
    and returns every shard's GHOST-plane buffers of E, H, J and each
    psi stack (``stencil.exchange_stack(..., depth=GHOST)``) from the
    shards' carries, as a list of {"E", "H", "J", "psE": {axis},
    "psH": {axis}} of ``deep_ghost_buffers`` dicts; ``ghosts`` key ->
    the buffers, made once (anew if the dtype or a device changes). The
    copies of every stack, as views, are built once for each set of
    source buffers (the carry and its spare set swap every pass: two
    sets) and run axis by axis, all stacks together
    (``stencil.run_copies``)."""
    ghosts: Dict[Any, Any] = {}
    plans: Dict[Any, Any] = {}

    def stacks_of(shards):
        out = {key: [s[key] for s in shards] for key in ("E", "H", "J")
               if key in shards[0]}
        for fam in ("psE", "psH"):
            for a in shards[0][fam]:
                out[(fam, a)] = [s[fam][a] for s in shards]
        return out

    def build(stacks):
        out = [{"psE": {}, "psH": {}} for _ in range(mesh.n)]
        copies: Dict[int, List[Any]] = {}
        for key, st in stacks.items():
            skip = key[1] if isinstance(key, tuple) else None
            bufs = ghosts.get(key)
            if bufs is None or any(b.dtype != s.dtype or b.device != s.device
                                   for gh, s in zip(bufs, st)
                                   for pair in gh.values() for b in pair
                                   if b is not None):
                bufs = ghosts[key] = deep_ghost_buffers(mesh, st, GHOST,
                                                        skip)
            for a, pairs in deep_copies(st, bufs, mesh, GHOST).items():
                copies.setdefault(a, []).extend(pairs)
            for o, b in zip(out, bufs):
                if skip is None:
                    o[key] = b
                else:
                    o[key[0]][skip] = b
        return copies, out

    def exchange(shards):
        stacks = stacks_of(shards)
        key = tuple((t.data_ptr(), t.dtype, t.device)
                    for st in stacks.values() for t in st)
        plan = plans.get(key)
        if plan is None:
            if len(plans) >= 2:
                plans.clear()
            plan = plans[key] = build(stacks)
        run_copies(plan[0])
        return plan[1]

    return exchange, ghosts


def make_sharded_packed_tb_step(static, mesh, plain: bool = False):
    """The depth-2 temporal-blocked step of a decomposed run (the sharded
    variant of ``make_packed_tb_step``) over the sharded packed carry
    ``{"shards", "t"}`` (``packed.sharded_carry``). A pass: the incident
    line through both generations once a device (its shards' record
    terms and drives from it, ``generation_terms_many``), the GHOST-plane
    exchange of E, H, J and psi (``make_deep_exchange``), then
    ``tb_pass_sharded`` on every shard into its own spare set, the swaps,
    ``t`` + 2. ``tail_step`` is the sharded packed step on the same carry
    (odd horizons). Kind ``packed_tb_cuda`` on CUDA devices,
    ``packed_tb_plain`` on the CPU or with ``plain`` (the plain versions
    on any device: chip_smoke.py's yardstick)."""
    reason = reject_reason(static)
    if reason is not None:
        raise NotImplementedError(
            f"this configuration is outside the temporal-blocked pass's "
            f"scope ({reason}); the sharded packed step runs it")
    tail = packed.make_sharded_packed_step(static, mesh, plain=plain)
    fn = tb_pass_sharded_plain if plain else tb_pass_sharded
    groups = packed.device_groups(mesh)
    exchange, ghosts = make_deep_exchange(mesh)
    spares: List[Dict[str, Any]] = []

    def prepare_tb(coeffs) -> List[Dict[str, Any]]:
        cc = tail.prepare(coeffs)
        for r, fc in enumerate(frame_coeffs(static, mesh, coeffs)):
            cc[r]["tb"] = prepare_shard(static, mesh, r, fc)
        return cc

    def step(carry, cc):
        shards, t = carry["shards"], carry["t"]
        work, lines = [], []
        for rs in groups.values():
            inc, terms, drives = generation_terms_many(
                static, [cc[r]["tb"] for r in rs], shards[rs[0]].get("inc"),
                t)
            work += zip(rs, terms, drives)
            lines.append((rs, inc))
        gh = exchange(shards)
        if not spares:
            # psi zeroed: the kernel leaves an interior shard's identity
            # slab rows alone (their psi stays 0 in both sets)
            for ps in shards:
                sp = packed.alloc_like(ps)
                for fam in ("psE", "psH"):
                    for v in sp[fam].values():
                        v.zero_()
                spares.append(sp)
        for r, terms, drive in work:
            fn(shards[r], spares[r], cc[r]["tb"], terms, drive, gh[r])
        for ps, sp in zip(shards, spares):
            packed.swap_buffers(ps, sp)
        for rs, inc in lines:
            if inc is not None:
                for r in rs:
                    shards[r]["inc"] = inc
        carry["t"] = t + DEPTH
        for ps in shards:
            ps["t"] = t + DEPTH
        return carry

    step.prepare = prepare_tb
    step.pack, step.unpack, step.join = tail.pack, tail.unpack, tail.join
    step.pack_shard = tail.pack_shard
    step.exchange = exchange
    # the tail's one-plane buffers by side, and under "deep" the pass's
    # GHOST-plane buffers (make_deep_exchange), which the planner counts;
    # both filled as the exchanges first run
    tail.ghosts["deep"] = ghosts
    step.ghosts = tail.ghosts
    step.spare = {"shards": spares}
    step.packed = True
    step.steps_per_call = DEPTH
    step.tail_step = tail
    step.mesh = mesh
    step.kind = "packed_tb_cuda" if "cuda" in {d.type for d in mesh.devices} \
        and not plain else "packed_tb_plain"
    step.diag = {"temporal_block": DEPTH, "topology": list(mesh.topology),
                 "shards": mesh.n}
    return step


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
    step.spare = spare
    step.packed = True
    step.steps_per_call = DEPTH
    step.tail_step = tail
    step.diag = {"temporal_block": DEPTH}
    on_cuda = torch.device(device).type == "cuda"
    step.kind = "packed_tb_cuda" if on_cuda and not plain \
        else "packed_tb_plain"
    return step

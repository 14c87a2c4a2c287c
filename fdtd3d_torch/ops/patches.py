"""Thin source patches applied between the packed step's two launches.

Counterpart of the patch helpers of ``fdtd3d_tpu/ops/pallas3d.py``
(``plane_corrections`` :859, ``tfsf_patch`` :961, ``point_source_patch``
:1012); on a decomposed run each shard patches the cells it owns. A
source adds ``cb * term`` to the E cells it drives (``-db * term`` to
H), after the family's kernel: the reference's
plain step adds ``term`` to the curl accumulator before the ``cb``
multiply, so the two differ by one rounding of the added term. With
bf16 fields the patch value is rounded to bf16 before it is added, and
the sum is rounded again, as the reference's patches do.

The TFSF faces are planned once per run (``build_tfsf_plan``): the
face cells, the line indices and weights of the interpolation, and the
coefficients are static, so a step's patch is two gathers off the
incident line, a few elementwise ops on the face cells, and an
``index_add_`` onto the stacked field for each round of distinct cells
(``_rounds``: a box edge's cells take two entries, a corner's three),
so every cell adds its entries in plan order on either device. The geometry comes from the same
functions the plain step uses (ops/tfsf.py), so the two cannot drift.

Lanes: on a lane-stacked carry (B, 3, n1, n2, n3) with a lane-stacked
incident line (B, n), the face patch takes a per-lane ``cb`` (B, N) and
adds its (B, N) values in one ``index_add_`` along the lane's row; the
point source adds ``ps_amp * cb`` of each lane, a (B,) device tensor, at
the driven cell of every lane. A solo carry is one lane: the same ops,
the same values.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fdtd3d_torch.layout import component_axis
from fdtd3d_torch.ops import tfsf
from fdtd3d_torch.ops.sources import waveform

AXES = "xyz"


def _plane_cells(shape, comp_index: int, axis: int, plane: int,
                 device) -> torch.Tensor:
    """Flat indices, into the stacked (3, n1, n2, n3) array, of one
    component's cells on plane ``plane`` of ``axis``; shaped as the
    plane (size 1 along ``axis``)."""
    n1, n2, n3 = shape
    rng = [torch.arange(n, device=device) for n in shape]
    rng[axis] = torch.tensor([plane], device=device)
    i = rng[0].reshape(-1, 1, 1)
    j = rng[1].reshape(1, -1, 1)
    k = rng[2].reshape(1, 1, -1)
    return ((comp_index * n1 + i) * n2 + j) * n3 + k


def _coef_at(coef, cells: torch.Tensor, vol: int, batch: int = 0):
    """A coefficient at flat stacked-cell indices (scalar, grid or
    per-lane grid): (N,) for a solo run, (B, N) for ``batch=B``."""
    if isinstance(coef, torch.Tensor):
        v = coef.reshape(-1, vol)[:, cells % vol]
    else:
        v = torch.full((1,) + tuple(cells.shape), coef, dtype=torch.float32,
                       device=cells.device)
    if not batch:
        return v[0]
    return v.expand(batch, -1)


def build_tfsf_plan(static, coeffs, family: str,
                    batch: int = 0, offset=(0, 0, 0)) -> Optional[Dict]:
    """The static part of one family's TFSF face patches, flattened over
    every correction that can touch a cell: target cell, line indices,
    interpolation weights, ``sign*pol/dx`` and ``+-cb`` per entry (per
    lane, (B, N), for ``batch=B``). Cells the transverse box gate or a
    PEC wall zeroes are left out.

    A shard of a decomposed run (``static`` its local setup, ``coeffs``
    its piece of the coefficients, whose ``gx``/``gy``/``gz`` hold the
    global indices of its cells) passes its global ``offset``: a face
    plane is patched by the shard that owns it, in local indices, over
    the part of the plane inside the shard's box (the transverse gate
    reads the global indices)."""
    setup = static.tfsf_setup
    if setup is None:
        return None
    mode = static.mode
    shape = static.grid_shape
    vol = shape[0] * shape[1] * shape[2]
    comps = mode.e_components if family == "E" else mode.h_components
    gs = (coeffs["gx"], coeffs["gy"], coeffs["gz"])
    device = gs[0].device
    parts = {k: [] for k in ("cells", "i0", "w0", "w1", "k", "cb")}
    for ci, c in enumerate(comps):
        cb = coeffs[("cb_" if family == "E" else "db_") + c]
        sign = 1.0 if family == "E" else -1.0
        for corr in setup.corrections:
            if corr.field != family or corr.comp != c:
                continue
            pol = tfsf.corr_polarization(corr, setup)
            if abs(pol) < tfsf.POL_EPS:
                continue
            plane = corr.plane - offset[corr.axis]
            if not 0 <= plane < shape[corr.axis]:
                continue
            pshape = list(shape)
            pshape[corr.axis] = 1
            u = tfsf.corr_line_coord(corr, setup, gs, mode.active_axes)
            i0, w = tfsf.clipped_line_coord(u, setup.n_inc)
            keep = torch.ones(pshape, dtype=torch.bool, device=device)
            gate = tfsf.corr_gate_transverse(corr, setup, gs,
                                             mode.active_axes,
                                             torch.float32)
            if gate is not None:
                keep &= gate.expand(pshape) > 0
            if family == "E":
                # PEC walls: the patch must not revive a zeroed cell
                for a2 in mode.active_axes:
                    if a2 != component_axis(c):
                        w2 = coeffs[f"wall_{AXES[a2]}"]
                        if a2 == corr.axis:
                            w2 = w2[plane:plane + 1]
                        s2 = [1, 1, 1]
                        s2[a2] = w2.shape[0]
                        keep &= w2.reshape(s2).expand(pshape) > 0
            cells = _plane_cells(shape, ci, corr.axis, plane, device)
            cells = cells.expand(pshape)[keep]
            parts["cells"].append(cells)
            parts["i0"].append(i0.expand(pshape)[keep])
            parts["w0"].append((1.0 - w).expand(pshape)[keep])
            parts["w1"].append(w.expand(pshape)[keep])
            parts["k"].append(torch.full(
                cells.shape, float(np.float32(corr.sign * pol / static.dx)),
                dtype=torch.float32, device=device))
            parts["cb"].append(sign * _coef_at(cb, cells, vol, batch))
    if not parts["cells"]:
        return None
    plan = {k: torch.cat(v, dim=-1) for k, v in parts.items()}
    plan["i1"] = plan["i0"] + 1
    plan["line"] = "Hinc" if family == "E" else "Einc"
    plan["rounds"] = _rounds(plan["cells"])
    return plan


def _rounds(cells: torch.Tensor):
    """The entries in rounds of distinct cells, in entry order: round r
    holds each cell's (r+1)-th entry (a cell on an edge of the TFSF box
    takes a correction of each face). ``tfsf_patch`` adds one round
    after the other, so a cell sums its entries in plan order on any
    device (a single ``index_add_`` on the card adds duplicates by
    atomics, in no fixed order), and a shard's plan, whose entries keep
    that order, adds the same values in the same order as the whole
    grid's: None when every cell is distinct."""
    flat = cells.cpu().numpy()
    order = np.argsort(flat, kind="stable")
    srt = flat[order]
    start = np.r_[True, srt[1:] != srt[:-1]]
    first = np.maximum.accumulate(np.where(start, np.arange(len(srt)), 0))
    rank = np.empty(len(flat), np.int64)
    rank[order] = np.arange(len(srt)) - first
    if rank.max(initial=0) == 0:
        return None
    return [torch.from_numpy(np.flatnonzero(rank == r)).to(cells.device)
            for r in range(int(rank.max()) + 1)]


def tfsf_patch(arr: torch.Tensor, plan: Optional[Dict],
               inc: Dict[str, torch.Tensor]) -> None:
    """Add one family's TFSF face corrections onto its stacked field
    (every lane of a lane-stacked one), in place."""
    if plan is None:
        return
    line = inc[plan["line"]]
    val = plan["w0"] * line[..., plan["i0"]] \
        + plan["w1"] * line[..., plan["i1"]]
    val = (plan["cb"] * (plan["k"] * val)).to(arr.dtype)
    flat = arr.view(-1) if val.dim() == 1 else arr.view(val.shape[0], -1)
    rounds = plan.get("rounds")
    if rounds is None:
        flat.index_add_(flat.dim() - 1, plan["cells"], val)
        return
    for idx in rounds:
        flat.index_add_(flat.dim() - 1, plan["cells"][idx],
                        val.index_select(val.dim() - 1, idx))


def build_point_source(static, coeffs, offset=(0, 0, 0)) -> Optional[Dict]:
    """Static part of the point-source patch: the driven cell of the
    stacked E array and ``ps_amp * cb`` there for each lane, a (B,)
    device tensor ((1,) for a solo run), or None when off, or on a
    wall. ``coeffs["ps_amp"]`` is a host float, or a (B,) tensor of
    per-lane amplitudes. A shard of a decomposed run (its local
    ``static`` and global ``offset``) drives the cell only if it owns
    it (None otherwise)."""
    ps = static.cfg.point_source
    if not ps.enabled:
        return None
    mode = static.mode
    n1, n2, n3 = static.grid_shape
    i, j, k = (ps.position[a] - offset[a] for a in range(3))
    if not (0 <= i < n1 and 0 <= j < n2 and 0 <= k < n3):
        return None       # another shard owns the driven cell
    ci = mode.e_components.index(ps.component)
    for a2 in mode.active_axes:
        if a2 != component_axis(ps.component) \
                and ps.position[a2] in (0, static.cfg.grid_shape[a2] - 1):
            return None   # a PEC wall cell stays zero
    cb = coeffs[f"cb_{ps.component}"]
    device = coeffs["gx"].device
    if isinstance(cb, torch.Tensor):
        cb = cb[..., i, j, k].reshape(-1)
    else:
        cb = torch.tensor([cb], dtype=torch.float32, device=device)
    amp = torch.as_tensor(coeffs["ps_amp"], dtype=torch.float32,
                          device=device).reshape(-1)
    return {"cell": ((ci * n1 + i) * n2 + j) * n3 + k, "amp_cb": amp * cb}


def point_source_patch(static, E: torch.Tensor, src: Optional[Dict],
                       t: int) -> None:
    """Soft point source as a single-cell add onto stacked E (the cell
    of every lane), in place."""
    if src is None:
        return
    ps = static.cfg.point_source
    wf = waveform(ps.waveform, t, 0.5, static.omega, static.dt,
                  static.real_dtype)
    lanes = E.shape[0] if E.dim() == 5 else 1
    E.view(lanes, -1).select(1, src["cell"]).add_(
        (src["amp_cb"] * float(wf)).to(E.dtype))

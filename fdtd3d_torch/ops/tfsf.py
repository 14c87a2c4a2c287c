"""Total-field / scattered-field (TFSF) plane-wave injection, in torch.

Counterpart of ``fdtd3d_tpu/ops/tfsf.py`` (f32 path): the static
geometry (``build_setup``, the incidence basis, the line's matched-loss
tail) is the reference's numpy code unchanged; the incident-line
leapfrog and the face corrections are torch ops on device tensors.

Mechanism (see the reference module for the derivation): a 1D incident
line (Einc at integer positions, Hinc at half positions) is leapfrogged
each step; every curl difference that straddles the total-field box
face is corrected by the incident value of the missing field,
interpolated off the line at the straddling sample's staggered
position. Einc advances to t^{n+1} before the E update, Hinc after it.

The f32 line may carry a leading lane axis, (B, n) for a batch of B
same-geometry scenarios: every op of the advance and of the record terms
works along the last axis, so each lane's line has the bits of a solo
line.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fdtd3d_torch import physics
from fdtd3d_torch.layout import CURL_TERMS, YEE_OFFSETS, component_axis
from fdtd3d_torch.ops import ds
from fdtd3d_torch.ops.sources import DsSourceTable, waveform

_TAIL = 24  # absorbing-tail length on the incident line, cells

# Polarization-projection cutoff: a correction whose ehat/hhat
# projection is below this is an exact geometric zero blurred by f64
# rounding, and is dropped (the reference's single threshold).
POL_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class Correction:
    """One face-plane consistency correction (static descriptor)."""

    field: str        # "E" | "H": which update this correction belongs to
    comp: str         # component being updated (e.g. "Ez")
    axis: int         # derivative axis a
    plane: int        # global integer coordinate g_a of the corrected cells
    src: str          # incident component sampled (e.g. "Hy")
    sign: float       # +-s premultiplied sign (without 1/dx)
    pos_a: float      # position along `axis` at which src is sampled (cells)
    mask_comp: str    # component whose TRANSVERSE box membership gates
    #                   the correction


@dataclasses.dataclass(frozen=True)
class TfsfSetup:
    """Static TFSF geometry: box, incidence basis, line length, corrections."""

    lo: Tuple[int, int, int]
    hi: Tuple[int, int, int]
    khat: Tuple[float, float, float]
    ehat: Tuple[float, float, float]
    hhat: Tuple[float, float, float]
    origin: Tuple[float, float, float]
    zeta0: float            # guard offset added to projections (cells)
    n_inc: int              # incident-line length
    corrections: Tuple[Correction, ...]
    waveform: str
    amplitude: float


def _incidence_basis(teta_deg, phi_deg, psi_deg):
    """k/E/H unit vectors from the reference's teta/phi/psi angles."""
    th, ph, ps = (math.radians(v) for v in (teta_deg, phi_deg, psi_deg))
    khat = np.array([math.sin(th) * math.cos(ph),
                     math.sin(th) * math.sin(ph),
                     math.cos(th)])
    # Spherical unit vectors at (th, ph); for th == 0 they default to (x, y).
    theta_hat = np.array([math.cos(th) * math.cos(ph),
                          math.cos(th) * math.sin(ph),
                          -math.sin(th)])
    phi_hat = np.array([-math.sin(ph), math.cos(ph), 0.0])
    ehat = math.cos(ps) * theta_hat + math.sin(ps) * phi_hat
    hhat = np.cross(khat, ehat)
    return tuple(khat), tuple(ehat), tuple(hhat)


def build_setup(cfg, static) -> TfsfSetup:
    mode = static.mode
    shape = static.grid_shape
    lo, hi = [0, 0, 0], [0, 0, 0]
    for a in range(3):
        if a in mode.active_axes:
            pad = cfg.pml.size[a] + cfg.tfsf.margin[a]
            lo[a], hi[a] = pad, shape[a] - 1 - pad
            if hi[a] - lo[a] < 2:
                raise ValueError(f"TFSF box empty on axis {a}")
    khat, ehat, hhat = _incidence_basis(
        cfg.tfsf.angle_teta, cfg.tfsf.angle_phi, cfg.tfsf.angle_psi)
    for a in range(3):
        if a not in mode.active_axes and abs(khat[a]) > 1e-12:
            raise ValueError(
                f"incidence direction has a component along inactive axis "
                f"{a} for scheme {mode.name}")
    origin = tuple(
        float(lo[a]) if khat[a] >= 0.0 else float(hi[a]) for a in range(3))
    zeta0 = 2.0  # guard so slightly-negative projections stay in range
    span = sum(abs(khat[a]) * (hi[a] - lo[a]) for a in mode.active_axes)
    n_inc = int(math.ceil(span + zeta0)) + 8 + _TAIL

    corrections: List[Correction] = []
    # E-update corrections (incident H sampled at half positions).
    for c in mode.e_components:
        ca = component_axis(c)
        for (a, d_axis, s) in CURL_TERMS[ca]:
            d = "H" + "xyz"[d_axis]
            if a not in mode.active_axes or d not in mode.h_components:
                continue
            corrections.append(Correction("E", c, a, lo[a], d, -s,
                                          lo[a] - 0.5, c))
            corrections.append(Correction("E", c, a, hi[a], d, +s,
                                          hi[a] + 0.5, c))
    # H-update corrections (incident E sampled at integer positions).
    for c in mode.h_components:
        ca = component_axis(c)
        for (a, d_axis, s) in CURL_TERMS[ca]:
            d = "E" + "xyz"[d_axis]
            if a not in mode.active_axes or d not in mode.e_components:
                continue
            corrections.append(Correction("H", c, a, lo[a] - 1, d, -s,
                                          float(lo[a]), d))
            corrections.append(Correction("H", c, a, hi[a], d, +s,
                                          float(hi[a]), d))
    return TfsfSetup(tuple(lo), tuple(hi), khat, ehat, hhat, origin, zeta0,
                     n_inc, tuple(corrections), cfg.tfsf.waveform,
                     cfg.tfsf.amplitude)


def line_loss_profiles(n_inc: int, dt: float, dx: float, dtype):
    """Matched graded-loss absorbing tail for the 1D incident line.

    Returns (ae, be, ah, bh): Einc = ae*Einc - be*dHinc ; likewise H.
    """
    d = (np.arange(n_inc) - (n_inc - 1 - _TAIL)) / _TAIL
    d = np.clip(d, 0.0, 1.0)
    smax = 4.0 / (physics.ETA0 * _TAIL * dx)  # ~R0 1e-5 at normal incidence
    sigma = smax * d ** 3
    se = sigma * dt / (2.0 * physics.EPS0)
    ae = ((1.0 - se) / (1.0 + se)).astype(dtype)
    be = ((dt / (physics.EPS0 * dx)) / (1.0 + se)).astype(dtype)
    # matched magnetic loss at half positions
    d_h = (np.arange(n_inc) + 0.5 - (n_inc - 1 - _TAIL)) / _TAIL
    d_h = np.clip(d_h, 0.0, 1.0)
    sh = (smax * d_h ** 3) * dt / (2.0 * physics.EPS0)  # sigma_m/mu = sig/eps
    ah = ((1.0 - sh) / (1.0 + sh)).astype(dtype)
    bh = ((dt / (physics.MU0 * dx)) / (1.0 + sh)).astype(dtype)
    return ae, be, ah, bh


def real_type(dtype):
    """The numpy scalar type of a torch dtype's real part."""
    return np.float64 if dtype in (torch.float64, torch.complex128) \
        else np.float32


def real_dtype(dtype):
    """The torch dtype of a dtype's real part: a complex line's samples
    are taken at real coordinates, in the matching precision."""
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def advance_einc(inc: Dict[str, torch.Tensor], coeffs, t: int, dt, omega,
                 setup: TfsfSetup, source=None) -> Dict[str, torch.Tensor]:
    """Einc^{n} -> Einc^{n+1} using Hinc^{n+1/2}; hard source at cell 0
    (of every lane of a lane-stacked line).

    A float32x2 line (``Einc_lo`` present) advances in ds; ``source``
    is then its ``sources.DsSourceTable`` (made here when not given)."""
    if "Einc_lo" in inc:
        return _advance_einc_ds(inc, coeffs, t, dt, omega, setup, source)
    einc, hinc = inc["Einc"], inc["Hinc"]
    rd = real_type(einc.dtype)
    dh = hinc.clone()
    dh[..., 1:] -= hinc[..., :-1]
    einc = coeffs["inc_ae"] * einc - coeffs["inc_be"] * dh
    wf = waveform(setup.waveform, t, 1.0, omega, dt, rd)
    # fill_ passes the value as a kernel argument; item assignment would
    # copy it from pageable host memory every step
    einc.narrow(-1, 0, 1).fill_(float(rd(setup.amplitude) * wf))
    return dict(inc, Einc=einc)


def advance_hinc(inc: Dict[str, torch.Tensor], coeffs,
                 setup: TfsfSetup) -> Dict[str, torch.Tensor]:
    """Hinc^{n+1/2} -> Hinc^{n+3/2} using Einc^{n+1}."""
    if "Einc_lo" in inc:
        return _advance_hinc_ds(inc, coeffs)
    einc, hinc = inc["Einc"], inc["Hinc"]
    de = -einc
    de[..., :-1] += einc[..., 1:]
    hinc = coeffs["inc_ah"] * hinc - coeffs["inc_bh"] * de
    return dict(inc, Hinc=hinc)


def clipped_line_coord(u: torch.Tensor, n: int):
    """(i0, w) of linear interpolation at fractional index u, clipped
    into the line as the reference clips it."""
    u = torch.clamp(u, 0.0, n - 1.001)
    i0 = torch.floor(u).to(torch.int64)
    return i0, u - i0.to(u.dtype)


def _interp_line(line: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of the 1D line at fractional index u."""
    i0, w = clipped_line_coord(u, line.shape[0])
    return (1.0 - w) * line[i0] + w * line[i0 + 1]


def corr_gate_transverse(corr: Correction, setup: TfsfSetup, gs,
                         active_axes, dtype) -> Optional[torch.Tensor]:
    """Staggered transverse box membership (no normal-axis onehot) as a
    broadcastable 0/1 mask, or None when no transverse axis is active.
    Half-offset components occupy [lo, hi-1], integer ones [lo, hi]."""
    gate = None
    m_off = YEE_OFFSETS[corr.mask_comp]
    for b in range(3):
        if b == corr.axis or b not in active_axes:
            continue
        hi_b = setup.hi[b] - 1 if m_off[b] == 0.5 else setup.hi[b]
        ind = (gs[b] >= setup.lo[b]) & (gs[b] <= hi_b)
        shape_b = [1, 1, 1]
        shape_b[b] = ind.shape[0]
        ind = ind.reshape(shape_b).to(dtype)
        gate = ind if gate is None else gate * ind
    return gate


def corr_line_coord(corr: Correction, setup: TfsfSetup, gs, active_axes,
                    dtype=torch.float32) -> torch.Tensor:
    """The line coordinate (in line cells) at which this correction
    samples its incident component: a broadcastable tensor over the two
    transverse axes. Hinc samples live at half positions on the line."""
    off = YEE_OFFSETS[corr.src]
    zeta = setup.zeta0 + setup.khat[corr.axis] * (
        corr.pos_a - setup.origin[corr.axis])
    zeta = torch.tensor(zeta, dtype=dtype, device=gs[0].device).reshape(
        1, 1, 1)
    rd = real_type(dtype)
    for b in range(3):
        if b == corr.axis or b not in active_axes:
            continue
        pb = gs[b].to(dtype) + off[b]
        shape = [1, 1, 1]
        shape[b] = pb.shape[0]
        zeta = zeta + float(rd(setup.khat[b])) * (
            pb - float(rd(setup.origin[b]))).reshape(shape)
    if corr.src[0] == "H":
        zeta = zeta - 0.5
    return zeta


def corr_polarization(corr: Correction, setup: TfsfSetup) -> float:
    """Projection of the incident field onto the sampled component."""
    if corr.src[0] == "E":
        return setup.ehat[component_axis(corr.src)]
    return setup.hhat[component_axis(corr.src)]


def corr_plane_term(corr: Correction, setup: TfsfSetup, coeffs,
                    inc: Dict[str, torch.Tensor], active_axes,
                    dx: float) -> Optional[torch.Tensor]:
    """ONE correction's accumulator term on its face plane (transverse
    box gate applied, no normal-axis onehot), or None when the
    polarization projection vanishes."""
    pol = corr_polarization(corr, setup)
    if abs(pol) < POL_EPS:
        return None
    gs = (coeffs["gx"], coeffs["gy"], coeffs["gz"])
    rdt = real_dtype(inc["Einc"].dtype)
    line = inc["Einc"] if corr.src[0] == "E" else inc["Hinc"]
    val = _interp_line(line, corr_line_coord(corr, setup, gs, active_axes,
                                             rdt))
    gate = corr_gate_transverse(corr, setup, gs, active_axes, val.dtype)
    term = float(real_type(val.dtype)(corr.sign * pol / dx)) * val
    return term if gate is None else term * gate


# --------------------------------------------------------------------------
# source records: every face correction's plane term, batched per step
# --------------------------------------------------------------------------

def plane_shape(shape, axis: int) -> Tuple[int, int, int]:
    """The grid shape with ``axis`` cut to one plane."""
    s = list(shape)
    s[axis] = 1
    return tuple(s)


def record_planes(static, records):
    """(family, record index, correction, plane shape) of every TFSF
    record of ``records`` (family -> records with a ``corr`` field; the
    point source's pseudo-record has none), E records then H records:
    the order of the flat term vector of the batched builders."""
    for fam in ("E", "H"):
        for r, rec in enumerate(records[fam]):
            if rec.corr is not None:
                yield fam, r, rec.corr, plane_shape(static.grid_shape,
                                                    rec.corr.axis)


class RecordPlan(NamedTuple):
    """Fixed f32 geometry of every TFSF record of both families,
    flattened into one vector of plane cells: E records, then H."""
    offsets: Dict[Any, int]       # (family, record index) -> offset
    total: int
    i01: torch.Tensor             # cat(i0, i0 + 1): indices into
                                  # cat(Einc, Hinc)
    ow: torch.Tensor              # 1 - w
    w: torch.Tensor
    sg: torch.Tensor              # f32(sign * pol / dx) times the
                                  # transverse box membership (0/1)


def build_record_plan(static, coeffs, records) -> Optional[RecordPlan]:
    """Per record: the interpolation index and weights of its line
    coordinate, its ``sign*pol/dx`` and its transverse gate, broadcast
    to the record's plane and flattened (C order over the two
    transverse axes). The same geometry functions as
    ``corr_plane_term``, so ``record_terms`` gives its bits."""
    setup = static.tfsf_setup
    if setup is None:
        return None
    gs = (coeffs["gx"], coeffs["gy"], coeffs["gz"])
    n = setup.n_inc
    parts: Dict[str, list] = {k: [] for k in ("i0", "ow", "w", "scale",
                                              "gate")}
    offsets: Dict[Any, int] = {}
    total = 0
    for fam, r, corr, pshape in record_planes(static, records):
        u = corr_line_coord(corr, setup, gs, static.mode.active_axes)
        i0, w = clipped_line_coord(u, n)
        if corr.src[0] == "H":
            i0 = i0 + n                     # the Hinc half of the line
        gate = corr_gate_transverse(corr, setup, gs,
                                    static.mode.active_axes, torch.float32)
        if gate is None:
            gate = torch.ones((), device=gs[0].device)
        scale = torch.full((), float(np.float32(
            corr.sign * corr_polarization(corr, setup) / static.dx)),
            device=gs[0].device)
        size = int(np.prod(pshape))
        for key, v in (("i0", i0), ("ow", 1.0 - w), ("w", w),
                       ("scale", scale), ("gate", gate)):
            parts[key].append(v.expand(pshape).reshape(size))
        offsets[(fam, r)] = total
        total += size
    if total == 0:
        return None
    cat = {k: torch.cat(v).contiguous() for k, v in parts.items()}
    return RecordPlan(offsets, total,
                      torch.cat([cat["i0"], cat["i0"] + 1]).contiguous(),
                      cat["ow"], cat["w"], cat["scale"] * cat["gate"])


def record_terms(plan: Optional[RecordPlan], inc,
                 out: Optional[torch.Tensor] = None):
    """The plane terms of every record, (total,) f32 ((B, total) for a
    lane-stacked line), written into ``out`` when given:
    ``corr_plane_term`` of each record, bit for bit, in six ops for all
    of them and every lane (both samples gathered at once; the gate, 0
    or 1, folded into the scale, which changes no bit of a finite
    term: ``(scale * v) * gate`` and ``v * (scale * gate)`` are both
    ``scale * v`` or a zero of its sign). E records sample Hinc and H
    records Einc, so this runs after the Einc advance and before the
    Hinc advance."""
    if plan is None:
        return None
    line = torch.cat([inc["Einc"], inc["Hinc"]], dim=-1)
    both = line.index_select(-1, plan.i01)
    v = plan.ow * both[..., :plan.total] + plan.w * both[..., plan.total:]
    return torch.mul(v, plan.sg, out=out)


def corrections_for(field: str, comp: str, setup: TfsfSetup, coeffs,
                    inc: Dict[str, torch.Tensor], active_axes,
                    dx: float) -> Optional[torch.Tensor]:
    """Sum of this component's TFSF curl-accumulator corrections (or
    None): each face's plane term times its normal-axis onehot."""
    gs = (coeffs["gx"], coeffs["gy"], coeffs["gz"])
    total = None
    for corr in setup.corrections:
        if corr.field != field or corr.comp != comp:
            continue
        term = corr_plane_term(corr, setup, coeffs, inc, active_axes, dx)
        if term is None:
            continue
        onehot_shape = [1, 1, 1]
        onehot_shape[corr.axis] = gs[corr.axis].shape[0]
        onehot = (gs[corr.axis] == corr.plane).reshape(onehot_shape)
        term = term * onehot.to(term.dtype)
        total = term if total is None else total + term
    return total


# --------------------------------------------------------------------------
# float32x2: the incident line and the face corrections in double-single
# --------------------------------------------------------------------------

def _ds_line_diff(fh, fl, forward: bool):
    """Double-single neighbour difference on the 1D line (PEC ghost)."""
    z = torch.zeros_like(fh[:1])
    if forward:
        sh, sl = torch.cat([fh[1:], z]), torch.cat([fl[1:], z])
        dh, de = ds.two_diff(sh, fh)
        dl = sl - fl
    else:
        sh, sl = torch.cat([z, fh[:-1]]), torch.cat([z, fl[:-1]])
        dh, de = ds.two_diff(fh, sh)
        dl = fl - sl
    return ds.two_sum(dh, de + dl)


def line_source(setup: TfsfSetup, omega, dt):
    """The hard source of the ds line: amplitude * waveform_ds(t + 1)
    as host (hi, lo) floats per step."""
    return DsSourceTable(setup.waveform, 1.0, omega, dt, setup.amplitude)


def _advance_einc_ds(inc, coeffs, t, dt, omega, setup: TfsfSetup,
                     source=None):
    """float32x2 incident line: the line's own leapfrog holds the same
    ~2^-47 class as the 3D fields it forces, with ds coefficients."""
    dh_h, dh_l = _ds_line_diff(inc["Hinc"], inc["Hinc_lo"], forward=False)
    t1 = ds.mul_ff(inc["Einc"], inc["Einc_lo"], coeffs["inc_ae"],
                   coeffs["inc_ae_lo"])
    t2 = ds.mul_ff(dh_h, dh_l, coeffs["inc_be"], coeffs["inc_be_lo"])
    eh, el = ds.sub_ff(*t1, *t2)
    sh, sl = (source or line_source(setup, omega, dt))(t)
    eh.narrow(0, 0, 1).fill_(sh)
    el.narrow(0, 0, 1).fill_(sl)
    return dict(inc, Einc=eh, Einc_lo=el)


def _advance_hinc_ds(inc, coeffs):
    de_h, de_l = _ds_line_diff(inc["Einc"], inc["Einc_lo"], forward=True)
    t1 = ds.mul_ff(inc["Hinc"], inc["Hinc_lo"], coeffs["inc_ah"],
                   coeffs["inc_ah_lo"])
    t2 = ds.mul_ff(de_h, de_l, coeffs["inc_bh"], coeffs["inc_bh_lo"])
    hh, hl = ds.sub_ff(*t1, *t2)
    return dict(inc, Hinc=hh, Hinc_lo=hl)


def record_coord_ds(corr: Correction, setup: TfsfSetup, gs, active_axes):
    """The ds line coordinate (zh, zl) at which a correction samples its
    incident component, broadcastable over the transverse axes (Hinc's
    half-position shift included). A single-f32 coordinate would carry
    an absolute sampling error of eps32*|zeta|, coherent with the wave;
    the pair keeps the interpolation weight exact to ~2^-24."""
    like = gs[0]
    off = YEE_OFFSETS[corr.src]
    z0 = np.float64(setup.zeta0) + np.float64(
        setup.khat[corr.axis]) * (corr.pos_a - setup.origin[corr.axis])
    zh, zl = ds.pair_tensors(z0, like)
    for b in range(3):
        if b == corr.axis or b not in active_axes:
            continue
        pb = gs[b].to(torch.float32) + off[b]   # integers + 0.5: exact
        shape = [1, 1, 1]
        shape[b] = pb.shape[0]
        oh, ol = ds.pair_tensors(setup.origin[b], like)
        dh_, dl_ = ds.add_f(-oh, -ol, pb)
        th_, tl_ = ds.mul_ff(dh_, dl_,
                             *ds.pair_tensors(setup.khat[b], like))
        zh, zl = ds.add_ff(zh, zl, th_.reshape(shape), tl_.reshape(shape))
    if corr.src[0] == "H":
        zh, zl = ds.add_f(zh, zl, ds.f32(-0.5, like))
    return zh, zl


def interp_weights_ds(n: int, u_pair):
    """(i0, w pair, 1 - w pair) of the ds linear interpolation at the ds
    line coordinate ``u_pair`` on a line of n samples. The weight comes
    from an exact two_diff against the floored index, so its absolute
    error is ~2^-24 whatever |u|; (1 - w) is a pair too."""
    uh, ul = u_pair
    u = torch.clamp(uh + ul, 0.0, n - 1.001)
    i0 = torch.floor(u).to(torch.int64)
    wh, we = ds.two_diff(uh, i0.to(uh.dtype))
    wh, wl = ds.two_sum(wh, we + ul)
    owh, owl = ds.add_f(-wh, -wl, ds.f32(1.0, uh))
    return i0, (wh, wl), (owh, owl)


def _interp_line_ds(line_h, line_l, u_pair):
    """Double-single linear interpolation of the (hi, lo) line."""
    i0, w, ow = interp_weights_ds(line_h.shape[0], u_pair)
    v0 = (line_h[i0], line_l[i0])
    v1 = (line_h[i0 + 1], line_l[i0 + 1])
    return ds.add_ff(*ds.mul_ff(*v0, *ow), *ds.mul_ff(*v1, *w))


def record_scale_ds(corr: Correction, setup: TfsfSetup, dx: float):
    """sign * pol / dx of a correction as a host (hi, lo) pair, or None
    when the polarisation projection vanishes."""
    pol = corr_polarization(corr, setup)
    if abs(pol) < POL_EPS:
        return None
    return ds.from_f64(np.float64(corr.sign) * pol / dx)


def record_term_ds(corr: Correction, setup: TfsfSetup, coeffs, inc,
                   active_axes, dx: float):
    """ONE correction's ds accumulator term on its plane (hi, lo), the
    transverse box gate applied but without the normal-axis onehot, or
    None when the polarisation projection vanishes."""
    scale = record_scale_ds(corr, setup, dx)
    if scale is None:
        return None
    gs = (coeffs["gx"], coeffs["gy"], coeffs["gz"])
    key = "Einc" if corr.src[0] == "E" else "Hinc"
    vh, vl = _interp_line_ds(inc[key], inc[f"{key}_lo"],
                             record_coord_ds(corr, setup, gs, active_axes))
    th, tl = ds.mul_ff(vh, vl, ds.f32(scale[0], vh), ds.f32(scale[1], vh))
    gate = corr_gate_transverse(corr, setup, gs, active_axes, th.dtype)
    if gate is not None:
        th, tl = th * gate, tl * gate      # 0/1 mask: exact
    return th, tl


def corrections_for_ds(field: str, comp: str, setup: TfsfSetup, coeffs,
                       inc, active_axes, dx: float):
    """corrections_for in double-single: an (hi, lo) pair or None."""
    gs = (coeffs["gx"], coeffs["gy"], coeffs["gz"])
    tot = None
    for corr in setup.corrections:
        if corr.field != field or corr.comp != comp:
            continue
        term = record_term_ds(corr, setup, coeffs, inc, active_axes, dx)
        if term is None:
            continue
        th, tl = term
        onehot_shape = [1, 1, 1]
        onehot_shape[corr.axis] = gs[corr.axis].shape[0]
        onehot = (gs[corr.axis] == corr.plane) \
            .reshape(onehot_shape).to(th.dtype)
        th, tl = th * onehot, tl * onehot  # 0/1 mask: exact
        tot = (th, tl) if tot is None else ds.add_ff(*tot, th, tl)
    return tot

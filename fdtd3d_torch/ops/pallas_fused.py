"""Recompute-fused single pass: one CUDA launch for E and H a step.

Replaces the Pallas TPU kernel
``fdtd3d_tpu/ops/pallas_fused.py::make_fused_eh_step`` (builder :310,
kernel body :423, ``pallas_call`` :709) for 3D real float32, unsharded,
with the hand-written CUDA C++ kernel ``fdtd3d_torch/csrc/fused_eh.cu``
(``sm_90a``, built by nvcc at first use, bound with ctypes). CUDA C++
rather than Triton, as for the port's other stencils.

The kernel computes new E on each block's cells **plus a redundant
halo** (one x plane ahead, one y row and one z column) from old E, H,
psi_E, J and the E-side coefficients there, then new H on the block's
cells from that new E: no block waits on another, which suits CUDA's
unordered blocks (see the source's header for the blocking). It moves
12 field volumes a step (48 B/cell f32) plus psi and the halo re-reads,
against the two-pass step's 18 (ops/pallas3d.py). It writes out of
place: the redundant halo reads old E, psi_E and J, and the E update's
backward differences read old H, on cells a neighbouring block writes.

A step (the reference's :729-817): the E-incident line; the kernel
(``fused_eh``: E and H, with the **pure** curl on x, y/z slab psi,
Drude J, walls); the E post-passes with ``collect`` (x-slab CPML, TFSF
E patch, point source, ops/pallas3d.py); ``apply_patch_h_corrections``,
which adds to H the curl of those E patches (the kernel computed H from
the pre-patch E; the update is linear); the H-incident line; the H
x-slab post-pass on the corrected E; the TFSF H patch. The state dict
is not mutated: a new one is returned.

``fused_eh_plain`` is the kernel's plain PyTorch version with its
schedule (H from the pre-patch E), so the step built on it goes through
the same patch corrections: the CPU tests hold it against the
reference's interpret-mode kernel and ``chip_smoke.py`` holds the
kernel against it on the card. ``fused_eh.launches`` counts launches.

Eligibility (``eligible``): the reference's ``pallas_fused.eligible``
(:48) and every CPML axis slab-compacted (:317-321). Magnetic Drude K
(A4(b)), bf16 storage (A4(a)) and sharded runs (A11) raise
``NotImplementedError`` naming their ROADMAP.md item; the reference's
sharded-only ``_traced_patch_fix`` waits for A11.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict

import numpy as np
import torch

from fdtd3d_torch.layout import CURL_TERMS, component_axis
from fdtd3d_torch.ops import pallas3d, tfsf
from fdtd3d_torch.ops.pallas3d import Drude, FamOps, Grid
from fdtd3d_torch.solver import _bcast1d, slab_axes

AXES = "xyz"
_LIB = "fused_eh"


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
    not copied). A pure function of the static setup.

    Set from same-call CUDA-event times on an NVIDIA H100 80GB HBM3 at
    700 W (``chip_smoke.py`` phase 13): the fused launch against the
    two-pass kernels' E + H launches, and the whole steps, on
    ``Examples/vacuum3D_tfsf.txt --same-size 256`` and on
    ``Examples/sphere3D_mie.txt`` (512^3, eps-sphere coefficient grids):

    ========  ==========  ==============  ==========  =============
    grid      fused (ms)  two-pass E + H  fused step  two-pass step
    ========  ==========  ==============  ==========  =============
    256^3     0.726       0.327 + 0.322   7.82        4.24
    512^3     5.77        3.21 + 2.40     8.15        7.06
    ========  ==========  ==============  ==========  =============

    The fused launch moves 2/3 of the bytes but is latency-bound (a
    barrier-separated march over x) and ran 1.03-1.12x the two launches;
    its step adds the H corrections of the E patches, ~160 more small
    ops a step, which the host cannot hide at 256^3. The two-pass step
    is the faster at both sizes, so the rule picks it for every
    configuration; ``FDTD3D_FORCE_FUSED`` still takes the fused twin.

    So the rule is the constant False until a measured crossover exists:
    no configuration measured yet has the fused step ahead, so there is
    nothing in the static setup for it to read."""
    return False


def _shift_lo(v: torch.Tensor, axis: int) -> torch.Tensor:
    """v shifted one plane toward lo along axis, zero-filled at hi."""
    n = v.shape[axis]
    out = torch.zeros_like(v)
    out.narrow(axis, 0, n - 1).copy_(v.narrow(axis, 1, n - 1))
    return out


def apply_patch_h_corrections(static, new_H, psi_H, patches, coeffs,
                              slabs):
    """Correct the kernel's H for the post-kernel E patches, in place
    (the reference's :142, unsharded branch). The kernel computed H from
    E' (pre-patch); the exact H uses E' + sum(patches), and the update is
    linear, so dH_c = -db_c * sum_terms s * F_a(D_a(dE_d)/dx) at the
    patches' planes only, with F_a the kernel's CPML handling of axis a:
    the identity on x (the post axis: the x-slab delta is added later
    over the corrected E) and where a has no CPML; ``ik + c`` on a y/z
    slab axis, whose stored psi' also needs ``+c * D_a(dE)/dx`` at the
    slab overlap."""
    mode = static.mode
    inv_dx = float(np.float32(1.0 / static.dx))

    def slab_f(a: int, lo: int, hi: int) -> torch.Tensor:
        """F = ik + c at absolute planes [lo, hi) of axis a, from the
        full-length h profiles (the identity outside the absorber)."""
        v = (coeffs[f"pml_ikh_{AXES[a]}"] + coeffs[f"pml_ch_{AXES[a]}"])
        return _bcast1d(v[lo:hi], a)

    for c in mode.h_components:
        db = coeffs[f"db_{c}"]
        for (a, d_axis, s) in CURL_TERMS[component_axis(c)]:
            d = "E" + AXES[d_axis]
            for p in patches:
                if p.comp != d:
                    continue
                b, start, delta = p.axis, p.start, p.delta
                k = delta.shape[b]
                n_a = static.grid_shape[a]
                if a == b:
                    # forward diff along the patch normal: k+1 planes from
                    # start-1 (zero ghost beyond the patch)
                    z = torch.zeros_like(delta.narrow(a, 0, 1))
                    vpad = torch.cat([z, delta, z], dim=a)
                    w = (vpad.narrow(a, 1, k + 1)
                         - vpad.narrow(a, 0, k + 1)) * inv_dx
                    pstart = start - 1
                    lo_clip = max(0, -pstart)
                    hi_clip = min(k + 1, n_a - pstart)
                    if hi_clip <= lo_clip:
                        continue
                    w = w.narrow(a, lo_clip, hi_clip - lo_clip)
                    pstart += lo_clip
                    plen = hi_clip - lo_clip
                else:
                    # in-patch forward diff along a (PEC zero ghost at hi)
                    w = (_shift_lo(delta, a) - delta) * inv_dx
                    pstart, plen = start, k
                pa = a if a == b else b
                if a in slabs and a != 0:
                    if a == b:
                        dacc = s * slab_f(a, pstart, pstart + plen) * w
                    else:
                        dacc = s * slab_f(a, 0, n_a) * w
                    key = f"{c}_{AXES[a]}"
                    m = slabs[a]
                    c_prof = coeffs[f"pml_slab_ch_{AXES[a]}"]
                    if a == b:
                        # patch planes vs slabs [0, m) and [n_a-m, n_a),
                        # compact [0, m) / [m, 2m)
                        for (s_lo, s_hi, c_off) in ((0, m, 0),
                                                    (n_a - m, n_a, m)):
                            o_lo = max(pstart, s_lo)
                            o_hi = min(pstart + plen, s_hi)
                            if o_hi <= o_lo:
                                continue
                            q = c_off + o_lo - s_lo
                            cp = _bcast1d(c_prof[q:q + o_hi - o_lo], a)
                            psi_H[key].narrow(a, q, o_hi - o_lo).add_(
                                cp * w.narrow(a, o_lo - pstart, o_hi - o_lo))
                    else:
                        add = torch.cat(
                            [_bcast1d(c_prof[:m], a) * w.narrow(a, 0, m),
                             _bcast1d(c_prof[m:], a)
                             * w.narrow(a, n_a - m, m)], dim=a)
                        psi_H[key].narrow(b, pstart, plen).add_(add)
                else:
                    dacc = s * w
                db_sl = db.narrow(pa, pstart, plen) \
                    if isinstance(db, torch.Tensor) else db
                new_H[c].narrow(pa, pstart, plen).add_(-db_sl * dacc)
    return new_H, psi_H


# --------------------------------------------------------------------------
# the kernel: plain version and CUDA wrapper
# --------------------------------------------------------------------------

def fused_eh_plain(E, H, psi_e, psi_h, J, fce, fch):
    """The kernel's schedule in torch: new E (the pure x curl, y/z slab
    psi, J, walls), then new H from that pre-patch E. Returns (E', H',
    psi_E', psi_H', J' or None), fresh tensors."""
    new_e, pe, new_j = pallas3d.e_family_plain(E, H, psi_e, J, fce)
    new_h, ph = pallas3d.h_family_plain(H, new_e, psi_h, fch)
    return new_e, new_h, pe, ph, new_j


class _Params(ctypes.Structure):
    """Mirror of ``struct Params`` in csrc/fused_eh.cu."""
    _fields_ = [("e", FamOps), ("h", FamOps), ("dr", Drude), ("g", Grid)]


def fused_params(E, H, psi_e, psi_h, J, fce, fch):
    """The launch's parameter block on CUDA tensors, with fresh outputs:
    (params, (E', H', psi_E', psi_H', J' or None))."""
    device = E[fce["comps"][0]].device
    prm = _Params()
    new_e, pe = pallas3d.fill_family(prm.e, E, psi_e, fce, device)
    new_h, ph = pallas3d.fill_family(prm.h, H, psi_h, fch, device)
    new_j = pallas3d.fill_drude_grid(prm, J, fce, device)
    return prm, (new_e, new_h, pe, ph, new_j)


def fused_eh(E, H, psi_e, psi_h, J, fce, fch):
    """New E, H (and psi, J) in fresh tensors, one launch: the CUDA
    kernel on CUDA tensors, its plain version on CPU tensors."""
    first = E[fce["comps"][0]]
    if not first.is_cuda:
        return fused_eh_plain(E, H, psi_e, psi_h, J, fce, fch)
    prm, outs = fused_params(E, H, psi_e, psi_h, J, fce, fch)
    lib = pallas3d.bind(_LIB, ("fdtd_fused_eh",), _Params)
    pallas3d.launch(lib, "fdtd_fused_eh", prm, first.device)
    fused_eh.launches += 1
    return outs


fused_eh.launches = 0


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
    pallas3d.check_scope(static, "recompute-fused kernel (ROADMAP B6)")
    slabs = slab_axes(static)
    setup = static.tfsf_setup
    x_pml = 0 in static.pml_axes
    fn = fused_eh_plain if plain else fused_eh
    psi_e_names = [k for v in pallas3d.kernel_psi_terms(static, "E").values()
                   for _, k in v]
    psi_h_names = [k for v in pallas3d.kernel_psi_terms(static, "H").values()
                   for _, k in v]

    def prepare(coeffs) -> Dict[str, Any]:
        return {"coeffs": coeffs,
                "E": pallas3d.family_operands(static, coeffs, "E"),
                "H": pallas3d.family_operands(static, coeffs, "H"),
                "tfsf_E": pallas3d.tfsf_plan(static, coeffs, "E"),
                "tfsf_H": pallas3d.tfsf_plan(static, coeffs, "H"),
                "point": pallas3d.point_plan(static, coeffs)}

    def step(state, cc):
        coeffs = cc["coeffs"]
        t = state["t"]
        new_state = dict(state)
        if setup is not None:
            new_state["inc"] = tfsf.advance_einc(
                state["inc"], coeffs, t, static.dt, static.omega, setup)
        new_E, new_H, pe, ph, new_J = fn(
            state["E"], state["H"],
            {k: state["psi_E"][k] for k in psi_e_names},
            {k: state["psi_H"][k] for k in psi_h_names},
            state.get("J"), cc["E"], cc["H"])
        if new_J is not None:
            new_state["J"] = new_J
        psi_E = dict(state.get("psi_E", {}), **pe)
        psi_H = dict(state.get("psi_H", {}), **ph)

        # E post-passes, collecting the applied thin patches
        patches: list = []
        if x_pml:
            px = {k: v for k, v in psi_E.items() if k.endswith("_x")}
            new_E, px_new = pallas3d.x_slab_post(
                static, "E", new_E, state["H"], px, coeffs, slabs,
                collect=patches)
            psi_E.update(px_new)
        if setup is not None:
            pallas3d.tfsf_patch(static, "E", new_E, coeffs,
                                new_state["inc"], collect=patches,
                                plan=cc["tfsf_E"])
        pallas3d.point_source_patch(static, new_E, coeffs, t,
                                    collect=patches, plan=cc["point"])

        # H corrections: the curl of the E patches
        if patches:
            new_H, psi_H = apply_patch_h_corrections(
                static, new_H, psi_H, patches, coeffs, slabs)
        if setup is not None:
            new_state["inc"] = tfsf.advance_hinc(new_state["inc"], coeffs,
                                                 setup)
        if x_pml:
            px = {k: v for k, v in psi_H.items() if k.endswith("_x")}
            new_H, px_new = pallas3d.x_slab_post(
                static, "H", new_H, new_E, px, coeffs, slabs)
            psi_H.update(px_new)
        if setup is not None:
            pallas3d.tfsf_patch(static, "H", new_H, coeffs,
                                new_state["inc"], plan=cc["tfsf_H"])
        new_state["E"] = new_E
        new_state["H"] = new_H
        if psi_E or psi_H:
            new_state["psi_E"] = psi_E
            new_state["psi_H"] = psi_H
        new_state["t"] = t + 1
        return new_state

    step.prepare = prepare
    on_cuda = torch.device(device).type == "cuda"
    step.kind = "fused_cuda" if on_cuda and not plain else "fused_plain"
    return step

"""Field diagnostics of the PyTorch port: energy, divergence, norms, the
per-interval metrics record.

Counterpart of ``fdtd3d_tpu/diag.py``. Every per-interval quantity is
reduced on the device from views of the live carry (nothing is cloned)
and read back as one small tensor: the metrics pass (``metrics``,
``em_energy``, ``divergence_e``) is one pass cached per step, so when
``--norms-every`` and ``--metrics-every`` land on one step the norms
reuse it (``field_norms``), as the reference's do.

The material-weighted energy weighs each component by its eps (E) or
mu (H): a background scalar plus, where a sphere or a material file
makes it vary, the box outside of which it holds the background
(``_energy_weights``), so no whole-volume weight grid lives on the
device; the energy is background x sum |v|^2 plus the box's correction.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from fdtd3d_torch.layout import YEE_OFFSETS, component_axis
from fdtd3d_torch.ops.tfsf import real_dtype
from fdtd3d_torch.telemetry import (DIV_SLAB_CELLS, Parts, lane_minmax,
                                    max_abs, plane_norms)


def div_e_parts(e_state: Dict[str, torch.Tensor], e_comps: Sequence[str],
                active: Sequence[int], inv_dx: float, cast,
                slab_cells: int = DIV_SLAB_CELLS
                ) -> Tuple[torch.Tensor, float, torch.Tensor]:
    """Discrete interior div·E residual -> (sum of squares (B,), count,
    max (B,)), of lane-leading (B, n1, n2, n3) components.

    The Yee update conserves the discrete divergence of D in source-free
    uniform regions; growth flags a stencil or coefficient bug or an
    unaccounted source. The backward difference of each E component
    along its own axis lands on integer cells; PEC walls carry surface
    charge, so only interior cells (1..n-2 on every active axis) count
    (``fdtd3d_tpu/diag.py::div_e_parts``). Interior cells never read the
    padded plane of the backward difference, so the pass runs over
    x-slabs of at most ``slab_cells`` cells: its temporaries are a few
    slabs in ``cast`` (the compute dtype: bf16 storage widens to f32;
    complex fields difference in complex and are read through the
    modulus, as the reference's ``jnp.abs``), never a whole volume. Each
    slab's differences are summed, then read by one ``aminmax`` and one
    ``vector_norm``; 1/dx scales the two
    results (the reference scales each difference: an ulp apart)."""
    comps = [(c, component_axis(c)) for c in e_comps
             if component_axis(c) in active]
    if not comps:
        z = torch.zeros(1)
        return z, 1.0, z
    v0 = e_state[comps[0][0]]
    lanes, shape = v0.shape[0], tuple(v0.shape[1:])
    inner = [slice(1, shape[a] - 1) if a in active else slice(None)
             for a in range(3)]
    sizes = [max(0, shape[a] - 2) if a in active else shape[a]
             for a in range(3)]
    count = float(np.prod(sizes))
    rdt = real_dtype(cast)
    sumsq = torch.zeros(lanes, dtype=rdt, device=v0.device)
    linf = torch.zeros(lanes, dtype=rdt, device=v0.device)
    if count == 0:
        return sumsq, 1.0, linf
    x0, x1 = (1, shape[0] - 1) if 0 in active else (0, shape[0])
    depth = max(1, slab_cells // max(1, sizes[1] * sizes[2]))
    for lo in range(x0, x1, depth):
        cur = [slice(None), slice(lo, min(lo + depth, x1)), inner[1],
               inner[2]]
        div = None
        for c, a in comps:
            prev = list(cur)
            s = cur[a + 1]
            prev[a + 1] = slice(s.start - 1, s.stop - 1)
            v = e_state[c]
            d = torch.sub(v[tuple(cur)].to(cast), v[tuple(prev)].to(cast))
            div = d if div is None else div.add_(d)
        flat = div.reshape(lanes, -1)
        if flat.is_complex():
            flat = flat.abs()
        mn, mx = torch.aminmax(flat, dim=1)
        linf = torch.maximum(linf, torch.maximum(mx, -mn))
        sumsq = sumsq + torch.linalg.vector_norm(flat, dim=1).square()
    return sumsq * (inv_dx * inv_dx), count, linf * inv_dx


def tfsf_leakage(fields: Dict[str, np.ndarray], lo: Sequence[int],
                 hi: Sequence[int]) -> float:
    """Scattered-field leakage of a TFSF run: max |E| over the cells
    outside the total-field box (more than one cell beyond any face, to
    stay clear of the staggered face samples) over max |E| inside it.
    In vacuum the scattered region should hold only roundoff; an
    indexing or sign error in the face corrections shows up here."""
    e = [np.abs(np.asarray(v)) for k, v in fields.items() if k[0] == "E"]
    shape = e[0].shape
    inside = np.ones(shape, dtype=bool)
    for a in range(3):
        idx = np.arange(shape[a])
        ok = (idx >= lo[a] - 1) & (idx <= hi[a] + 1)
        s = [1, 1, 1]
        s[a] = shape[a]
        inside &= ok.reshape(s)
    mx_in = max(float(v[inside].max()) for v in e)
    mx_out = max(float(v[~inside].max()) for v in e)
    return mx_out / mx_in if mx_in > 0 else float("inf")


def _sphere_box(comp, shape, active, sphere):
    """The index box of a sphere's cells at ``comp``'s staggered
    positions (``materials._sphere_mask``'s test), or None when empty:
    (slices, mask of the box)."""
    off = YEE_OFFSETS[comp]
    box, pos = [], []
    for a in range(3):
        n = shape[a]
        o = off[a] if n > 1 else 0.0
        if a in active:
            lo = max(0, math.ceil(sphere.center[a] - sphere.radius - o))
            hi = min(n - 1, math.floor(sphere.center[a] + sphere.radius - o))
            if hi < lo:
                return None
        else:
            lo, hi = 0, n - 1
        box.append(slice(lo, hi + 1))
        p = np.arange(lo, hi + 1, dtype=np.float64) + o
        s = [1, 1, 1]
        s[a] = hi + 1 - lo
        pos.append(p.reshape(s))
    d2 = 0.0
    for a in range(3):
        if a in active:
            d2 = d2 + (pos[a] - sphere.center[a]) ** 2
    mask = np.broadcast_to(d2 <= sphere.radius ** 2,
                           tuple(s.stop - s.start for s in box))
    return tuple(box), mask


def _grid_box(grid: np.ndarray, base: float):
    """The bounding box of a whole material grid's cells off ``base``."""
    off = grid != base
    box = []
    for a in range(3):
        other = tuple(x for x in range(3) if x != a)
        idx = np.nonzero(off.any(axis=other))[0]
        if idx.size == 0:
            return None
        box.append(slice(int(idx[0]), int(idx[-1]) + 1))
    return tuple(box)


def _energy_weights(sim) -> Dict[str, Tuple[float, Any, Any]]:
    """Per component: (background eps or mu, the box outside of which the
    weight is the background (or None), the weight minus the background
    inside it as a device tensor in the compute dtype), built once and
    cached on the sim (``fdtd3d_tpu/diag.py::_energy_weights`` holds
    whole-volume grids instead)."""
    cache = getattr(sim, "_energy_weights_cache", None)
    if cache is not None:
        return cache
    from fdtd3d_torch import materials
    static = sim.static
    mode, shape = static.mode, static.grid_shape
    mat = sim.cfg.materials
    cache = {}
    for comps, base, sph, fil in (
            (mode.e_components, mat.eps, mat.eps_sphere, mat.eps_file),
            (mode.h_components, mat.mu, mat.mu_sphere, mat.mu_file)):
        for c in comps:
            base = float(base)
            box, delta = None, None
            if fil:
                grid = materials.scalar_or_grid(c, shape, mode.active_axes,
                                                base, sph, fil)
                box = _grid_box(np.asarray(grid), base)
                if box is not None:
                    delta = np.asarray(grid)[box] - base
            elif sph is not None and sph.enabled and sph.radius > 0:
                hit = _sphere_box(c, shape, mode.active_axes, sph)
                if hit is not None:
                    box, mask = hit
                    delta = np.where(mask, float(sph.value) - base, 0.0)
            if box is not None:
                delta = torch.from_numpy(np.ascontiguousarray(delta)).to(
                    device=sim.device,
                    dtype=real_dtype(static.compute_dtype))
            cache[c] = (base, box, delta)
    sim._energy_weights_cache = cache
    return cache


def _device_metrics(sim) -> Dict[str, float]:
    """One pass computing every per-interval metric, read back once.

    Cached per step: when --norms-every and --metrics-every land on the
    same step (the CLI's interval is the gcd of the cadences), the
    volume pass runs once and both records derive from it."""
    cache = getattr(sim, "_metrics_cache", None)
    t_now = sim.t
    if cache is not None and cache[0] == t_now:
        return cache[1]
    from fdtd3d_torch import physics
    static = sim.static
    mode = static.mode
    cdt = static.compute_dtype
    cell = float(static.dx ** mode.ndim)
    weights = _energy_weights(sim)
    # a paired complex run's components are joined one at a time
    comps = sim.component_views()
    names = {g: [c for c in comps if c[0] == g] for g in ("E", "H")}
    parts = Parts()
    e = {}
    for c in comps:
        v = comps[c].unsqueeze(0)
        if c[0] == "E":
            e[c] = v
        lo, hi = lane_minmax(v)
        parts.add(f"lo:{c}", lo)
        parts.add(f"hi:{c}", hi)
        parts.add(f"sq:{c}", plane_norms(v, cdt))
        _base, box, delta = weights[c]
        if box is not None:
            vb = v[0][box].to(cdt)
            if vb.is_complex():
                vb = vb.abs()
            parts.add(f"box:{c}", (delta * vb * vb).sum()
                      .reshape(1, 1))
        del v
    sumsq, count, linf = div_e_parts(e, mode.e_components,
                                     mode.active_axes, 1.0 / static.dx,
                                     cdt)
    parts.add("div_sumsq", sumsq)
    parts.add("div_linf", linf)
    tensor, dec = parts.finish()
    p = dec(tensor.tolist()[0])   # the one readback
    out: Dict[str, float] = {}
    energy = 0.0
    for grp, c0 in (("E", physics.EPS0), ("H", physics.MU0)):
        for c in names[grp]:
            lo, hi = p[f"lo:{c}"][0], p[f"hi:{c}"][0]
            out[f"max_{c}"] = hi if math.isnan(hi) else max(hi, -lo)
            base, box, _d = weights[c]
            s = base * math.fsum(x * x for x in p[f"sq:{c}"])
            if box is not None:
                s += p[f"box:{c}"][0]
            energy += 0.5 * c0 * cell * s
    out["energy"] = energy
    out["div_l2"] = math.sqrt(p["div_sumsq"][0] / count)
    out["div_linf"] = p["div_linf"][0]
    out["e_scale"] = max((out[f"max_{c}"] for c in names["E"]), default=0.0)
    sim._metrics_cache = (t_now, out)
    return out


def em_energy(sim) -> float:
    """Total electromagnetic field energy, J (material-weighted)."""
    return float(_device_metrics(sim)["energy"])


def error_norms(actual: np.ndarray, expected: np.ndarray) -> Dict[str, float]:
    """L2 (RMS) and Linf absolute error norms, plus relative L2."""
    diff = np.abs(np.asarray(actual) - np.asarray(expected))
    l2 = float(np.sqrt(np.mean(diff ** 2)))
    linf = float(np.max(diff))
    ref = float(np.sqrt(np.mean(np.abs(expected) ** 2)))
    return {"l2": l2, "linf": linf,
            "rel_l2": l2 / ref if ref > 0 else float("inf")}


def field_norms(sim) -> Dict[str, float]:
    """max|comp| for every stored field component: the metrics pass's
    values when one ran at this step, else one max reduction per
    component on the device and one readback."""
    cache = getattr(sim, "_metrics_cache", None)
    comps = sim.component_views()
    if cache is not None and cache[0] == sim.t:
        return {c: cache[1][f"max_{c}"] for c in comps}
    vals = torch.stack([max_abs(v) for v in comps.values()]).tolist()
    return dict(zip(comps, vals))


def divergence_e(sim) -> Dict[str, float]:
    """Absolute L2/Linf of the interior div·E residual plus the field
    scale ``e_scale`` the caller can normalise by."""
    dm = _device_metrics(sim)
    return {k: float(dm[k]) for k in ("div_l2", "div_linf", "e_scale")}


def metrics(sim) -> Dict[str, float]:
    """The structured per-interval metrics record: t, material-weighted
    EM energy, per-component max norms, the divergence residual and
    e_scale; one device pass and one small readback. The CLI's
    ``--metrics-every`` writes it to ``save_dir/metrics.jsonl``."""
    dm = _device_metrics(sim)
    out: Dict[str, float] = {"t": float(sim.t)}
    out.update((k, dm[k]) for k in sorted(dm))   # the reference's order
    return out


"""Convolutional PML (CPML) coefficient builder.

A copy of ``fdtd3d_tpu/ops/cpml.py`` (numpy only), kept in the port so
that it imports nothing of the JAX package.

Reference parity: PML/CPML absorbing boundaries (BASELINE.json north-star;
SURVEY.md §2 InternalScheme row — PML via auxiliary grids + sigma coeffs).
The reference stores full-domain sigma material grids and branches per cell;
here the recursive-convolution coefficients are 1D per-axis profiles
(Roden & Gedney 2000 formulation) that are exactly (b=anything, c=0,
1/kappa=1) outside the absorbing slabs — so the update is branch-free and
the psi memory state simply stays zero in the interior.

Two staggered profile sets per axis:
  * "e" set — sampled at integer positions (E components are at integer
    coordinates along their transverse/derivative axes; layout.py)
  * "h" set — sampled at half-integer positions (H components)

Builder is pure numpy (runs at setup on host); arrays are later device_put
with a P('x')/P('y')/P('z') sharding so each shard holds its slice.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from fdtd3d_torch import physics


def axis_profiles(n: int, npml: int, dx: float, dt: float, pml_cfg,
                  offset: float, dtype) -> Dict[str, np.ndarray]:
    """b, c, 1/kappa profiles of length ``n`` at positions ``g + offset``.

    PML slabs occupy positions [0, npml] and [n-1-npml, n-1] (graded from
    the inner interface toward the PEC-backed wall). npml == 0 -> identity
    profiles (no absorption).
    """
    pos = np.arange(n, dtype=np.float64) + offset
    if npml <= 0:
        return {
            "b": np.zeros(n, dtype),
            "c": np.zeros(n, dtype),
            "ik": np.ones(n, dtype),
        }
    # Normalized depth into the PML, 0 at the inner interface, 1 at the wall.
    d_lo = (npml - pos) / npml
    d_hi = (pos - (n - 1 - npml)) / npml
    d = np.clip(np.maximum(d_lo, d_hi), 0.0, 1.0)

    m = pml_cfg.m
    sigma_max = (pml_cfg.sigma_scale * (-(m + 1.0) * math.log(pml_cfg.r0))
                 / (2.0 * physics.ETA0 * npml * dx))
    sigma = sigma_max * d ** m
    kappa = 1.0 + (pml_cfg.kappa_max - 1.0) * d ** m
    alpha = pml_cfg.alpha_max * (1.0 - d)

    b = np.exp(-(sigma / kappa + alpha) * dt / physics.EPS0)
    denom = sigma * kappa + kappa * kappa * alpha
    with np.errstate(divide="ignore", invalid="ignore"):
        c = np.where(denom > 0.0, sigma * (b - 1.0) / denom, 0.0)
    # Outside the slabs force the exact identity (c = 0 keeps psi == 0).
    inside = d > 0.0
    b = np.where(inside, b, 0.0)
    c = np.where(inside, c, 0.0)
    return {
        "b": b.astype(dtype),
        "c": c.astype(dtype),
        "ik": (1.0 / kappa).astype(dtype),
    }


def build_slab_coeffs(full_coeffs: Dict[str, np.ndarray], static,
                      slabs: Dict[int, int]) -> Dict[str, np.ndarray]:
    """Slab-compacted CPML profiles for psi's boundary-plane storage.

    For each slab axis a (solver.slab_axes, m planes per side): gather the
    already-built full-length b/c/ik profiles (``full_coeffs`` from
    build_cpml_coeffs — gathering instead of rebuilding keeps the two
    representations from ever drifting) at every shard's first/last m
    positions, concatenated shard by shard -> 1D arrays of length
    2*m*topology[a] whose per-shard slice under sharding is exactly that
    shard's (lo ++ hi) slab profile. Interior shards get the identity
    profile (b=c=0, ik=1), keeping their psi slabs exactly zero — one SPMD
    program for every rank, like the reference's sigma grids being zero
    outside the PML.
    """
    out: Dict[str, np.ndarray] = {}
    shape = static.grid_shape
    for a, m in slabs.items():
        name = "xyz"[a]
        n = shape[a]
        p = static.topology[a]
        local_n = n // p
        idx = np.concatenate([
            np.concatenate([i * local_n + np.arange(m),
                            (i + 1) * local_n - m + np.arange(m)])
            for i in range(p)])
        for tag in ("e", "h"):
            for prof in ("b", "c", "ik"):
                out[f"pml_slab_{prof}{tag}_{name}"] = \
                    full_coeffs[f"pml_{prof}{tag}_{name}"][idx]
    return out


def build_cpml_coeffs(cfg, static, dtype) -> Dict[str, np.ndarray]:
    """All per-axis CPML profile arrays, keyed for the coeffs pytree.

    Keys: pml_{b,c,ik}{e,h}_{x,y,z}. Inactive axes get identity profiles of
    length 1. Naming convention drives sharding-spec inference
    (parallel/mesh.py): a key suffix _x/_y/_z shards along that axis.
    """
    out: Dict[str, np.ndarray] = {}
    shape = static.grid_shape
    for a, name in enumerate(("x", "y", "z")):
        n = shape[a]
        npml = cfg.pml.size[a] if a in static.mode.active_axes else 0
        for tag, off in (("e", 0.0), ("h", 0.5)):
            prof = axis_profiles(n, npml, cfg.dx, static.dt, cfg.pml,
                                 off, dtype)
            out[f"pml_b{tag}_{name}"] = prof["b"]
            out[f"pml_c{tag}_{name}"] = prof["c"]
            out[f"pml_ik{tag}_{name}"] = prof["ik"]
    return out

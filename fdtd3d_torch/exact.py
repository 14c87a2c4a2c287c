"""Exact solutions of the discrete Yee scheme, for accuracy checks.

The port's own copy (numpy only) of ``discrete_omega``,
``discrete_k_1d``, ``cavity_mode_tmz``, ``cavity_mode``,
``cavity_expectation`` and ``plane_wave_1d_steady`` of
``fdtd3d_tpu/exact.py``: the port imports nothing of the JAX package. A PEC-cavity eigenmode (a sin-product mode
shape) is an eigenvector of the discrete curl-curl with PEC walls, and
its discrete frequency follows the exact discrete dispersion relation,
so a run started from it has a machine-precision oracle: the cavity
accuracy check of compensated mode (``tests/test_compensated.py``'s
gate, held by ``tests/test_torch_compensated.py`` on the CPU and by
``chip_smoke.py`` on the card).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from fdtd3d_torch import physics


def discrete_omega(k_cells: Sequence[float], dx: float, dt: float) -> float:
    """Discrete Yee dispersion: frequency of a mode with per-axis wave
    numbers ``k_cells`` (radians per CELL; pass 0 for inactive axes).

    sin^2(w dt/2) = (c dt/dx)^2 * sum_a sin^2(k_a / 2)
    """
    s = sum(math.sin(k / 2.0) ** 2 for k in k_cells)
    arg = (physics.C0 * dt / dx) * math.sqrt(s)
    if arg > 1.0:
        raise ValueError("mode beyond the stability limit")
    return 2.0 / dt * math.asin(arg)


def discrete_k_1d(omega: float, dx: float, dt: float) -> float:
    """Inverse dispersion: wave number (rad/cell) of a CW at ``omega``."""
    s = math.sin(omega * dt / 2.0) / (physics.C0 * dt / dx)
    if s > 1.0:
        raise ValueError("frequency beyond the grid's passband")
    return 2.0 * math.asin(s)


def cavity_mode_tmz(size: Tuple[int, int], m: int, n: int,
                    dx: float, dt: float):
    """2D TMz PEC-cavity eigenmode: (Ez0 mode shape on the (Nx, Ny)
    E-grid, omega_discrete). Walls at i=0, i=Nx-1, j=0, j=Ny-1 (where
    tangential Ez is pinned); Ez0 = sin(m pi i/(Nx-1)) sin(n pi j/(Ny-1)).
    From E^0 = mode and H = 0 the step gives
    E^t = mode * cos(w(t - 1/2)dt)/cos(w dt/2) (``cavity_expectation``)."""
    nx, ny = size
    kx = m * math.pi / (nx - 1)
    ky = n * math.pi / (ny - 1)
    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    shape = np.sin(kx * i) * np.sin(ky * j)
    return shape, discrete_omega((kx, ky, 0.0), dx, dt)


def cavity_mode(size: Tuple[int, int, int], mnp: Tuple[int, int, int],
                dx: float, dt: float,
                cvec: Tuple[float, float, float] = (0.37, -0.61, 0.83),
                avec: Tuple[float, float, float] = None):
    """PEC-cavity eigenmode of the DISCRETE Yee operator, any dimension.

    Works for every scheme mode: an inactive axis (size 1, m = 0) simply
    contributes no trig factor. Returns ({comp: staggered E-grid array},
    omega_discrete); identically-zero components are omitted.

    Construction: with k_a = m_a pi/(N_a - 1) (rad/cell) the staggered
    trig product
        Ex(i+1/2, j, k) = Ax cos(kx(i+1/2)) sin(ky j) sin(kz k)   (cyc.)
    turns the discrete curl/div into the continuum ones with the EXACT
    substitution K_a = 2 sin(k_a/2)/dx. An amplitude vector A with
    K . A = 0 (discrete divergence-free) makes E0 a discrete curl-curl
    eigenvector with eigenvalue c^2 |K|^2, so with H = 0 at init it
    evolves as cavity_expectation — machine precision in f64. Tangential
    E vanishes on all PEC walls because sin(k_a g) is zero at g = 0 and
    g = N_a - 1.

    ``avec``: explicit amplitude vector (validated K . A ~ 0) — use it to
    select a scheme's components (e.g. (0,0,1) for TMz, K x e_z for TEz).
    Default: A = K x cvec (generic full-vector mode).
    """
    k = [mnp[a] * math.pi / (size[a] - 1) if size[a] > 1 else 0.0
         for a in range(3)]
    bigk = np.array([2.0 * math.sin(k[a] / 2.0) / dx for a in range(3)])
    if avec is not None:
        amp = np.asarray(avec, dtype=np.float64)
        if abs(float(bigk @ amp)) > 1e-9 * (
                np.linalg.norm(bigk) * np.linalg.norm(amp) + 1e-300):
            raise ValueError("avec is not discrete-divergence-free")
    else:
        amp = np.cross(bigk, np.asarray(cvec, dtype=np.float64))
    scale = np.max(np.abs(amp))
    if scale == 0.0:
        raise ValueError(f"degenerate mode/amplitude combination {mnp}")
    amp = amp / scale

    def axis_fn(a: int, half: bool):
        g = np.arange(size[a], dtype=np.float64) + (0.5 if half else 0.0)
        v = np.cos(k[a] * g) if half else np.sin(k[a] * g)
        sh = [1, 1, 1]
        sh[a] = size[a]
        return v.reshape(sh)

    out = {}
    for a, comp in enumerate(("Ex", "Ey", "Ez")):
        # a sin factor of a k=0 ACTIVE transverse axis zeroes the whole
        # component (inactive axes contribute no factor at all)
        if abs(amp[a]) < 1e-14 or any(
                k[b] == 0.0 and size[b] > 1 for b in range(3) if b != a):
            continue
        f = amp[a]
        for b in range(3):
            if size[b] > 1:
                f = f * axis_fn(b, half=(b == a))
        f = np.broadcast_to(np.asarray(f), size).copy()
        if k[a] != 0.0:
            # The outermost own-axis half-plane (position N_a - 1/2) lies
            # OUTSIDE the PEC box. Zeroed, it stays exactly zero: every
            # term of its update reads other beyond-wall planes that are
            # also zero, so the whole-array evolution is machine-exact.
            sl = [slice(None)] * 3
            sl[a] = size[a] - 1
            f[tuple(sl)] = 0.0
        out[comp] = f
    return out, discrete_omega(tuple(k), dx, dt)


def cavity_expectation(mode_shape: np.ndarray, omega: float, dt: float,
                       t: int) -> np.ndarray:
    """Expected E-field of a cavity mode at step ``t`` (solver convention)."""
    return mode_shape * (math.cos(omega * (t - 0.5) * dt)
                         / math.cos(omega * 0.5 * dt))


def plane_wave_1d_steady(x_cells: np.ndarray, t: int, omega: float,
                         dx: float, dt: float, amplitude: float = 1.0,
                         phase0: float = 0.0) -> np.ndarray:
    """Steady-state CW plane wave with the DISCRETE wave number."""
    k = discrete_k_1d(omega, dx, dt)
    return amplitude * np.sin(omega * t * dt - k * x_cells + phase0)

"""Physical constants (SI units).

A copy of ``fdtd3d_tpu/physics.py``, kept in the port so that it imports
nothing of the JAX package.

Parity: reference ``Source/Physics/PhysicsConst.h`` (SURVEY.md §2 —
c, eps0, mu0, accuracy constants; Courant dt from dx / courant factor).
"""

import math

# Exact SI values (CODATA 2018).
SPEED_OF_LIGHT = 299_792_458.0  # c0, m/s (exact)
EPS0 = 8.854_187_8128e-12       # vacuum permittivity, F/m
MU0 = 1.256_637_062_12e-6       # vacuum permeability, H/m
ETA0 = math.sqrt(MU0 / EPS0)    # vacuum impedance, ~376.73 Ohm

C0 = SPEED_OF_LIGHT


def courant_dt(dx: float, courant_factor: float, ndim_active: int) -> float:
    """Stable leapfrog timestep.

    dt = cf * dx / (c0 * sqrt(d))  with d = number of active spatial axes.
    The reference derives dt from ``--dx`` / ``--courant-factor`` the same
    way (SURVEY.md §2 Physics row). cf must be <= 1 for stability.
    """
    return courant_factor * dx / (C0 * math.sqrt(float(ndim_active)))

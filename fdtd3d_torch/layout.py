"""Yee-grid layout: scheme modes, component staggering, wall masks.

A copy of ``fdtd3d_tpu/layout.py``, kept in the port so that it imports
nothing of the JAX package.

This is the staggering authority — the TPU-native replacement for the
reference's ``Source/Layout/YeeGridLayout.h`` (SURVEY.md §2): where each of
Ex/Ey/Ez/Hx/Hy/Hz lives relative to the cell corner (E_CENTERED layout), and
which components/axes are active for each of the 13 scheme modes
(reference ``SchemeType`` explicit template instantiations, SURVEY.md §2
"SchemeType / dim modes").

Design difference vs the reference (deliberate, TPU-first): instead of 13
compile-time template instantiations and stored coordinate objects, every
mode runs through ONE generic 3D kernel. Arrays are always rank-3
``(Nx, Ny, Nz)``; an inactive axis has size 1 and its spatial derivative is
identically zero; inactive field components simply do not exist in the state
pytree. XLA folds the singleton dims away, so a 1D solve compiles to true 1D
code.

Yee staggering (offsets in units of the cell, E_CENTERED):

    Ex at (i+1/2, j,     k    )     Hx at (i,     j+1/2, k+1/2)
    Ey at (i,     j+1/2, k    )     Hy at (i+1/2, j,     k+1/2)
    Ez at (i,     j,     k+1/2)     Hz at (i+1/2, j+1/2, k    )

E components sit at INTEGER positions along their transverse axes (the axes
they are differentiated along), H components at HALF positions — this drives
which of the two staggered CPML coefficient sets each psi update uses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

E_COMPONENTS = ("Ex", "Ey", "Ez")
H_COMPONENTS = ("Hx", "Hy", "Hz")
ALL_COMPONENTS = E_COMPONENTS + H_COMPONENTS

AXIS_NAMES = ("x", "y", "z")

# Yee offsets of each component, in cell units, E_CENTERED layout.
YEE_OFFSETS: Dict[str, Tuple[float, float, float]] = {
    "Ex": (0.5, 0.0, 0.0),
    "Ey": (0.0, 0.5, 0.0),
    "Ez": (0.0, 0.0, 0.5),
    "Hx": (0.0, 0.5, 0.5),
    "Hy": (0.5, 0.0, 0.5),
    "Hz": (0.5, 0.5, 0.0),
}

# curl structure: component c's update couples the two other axes.
# E-update (Ampere):  dEc/dt ~ +dH[b]/da - dH[a]/db   for (c,a,b) cyclic
# H-update (Faraday): dHc/dt ~ -(+dE[b]/da - dE[a]/db)
# Concretely, with axis indices (0,1,2) and cyclic triples:
#   curl_x(F) = dFz/dy - dFy/dz
#   curl_y(F) = dFx/dz - dFz/dx
#   curl_z(F) = dFy/dx - dFx/dy
# CURL_TERMS[c] = ((axis_of_derivative, source_component, sign), ...)
CURL_TERMS: Dict[int, Tuple[Tuple[int, int, int], ...]] = {
    0: ((1, 2, +1), (2, 1, -1)),  # x: +d(comp z)/dy - d(comp y)/dz
    1: ((2, 0, +1), (0, 2, -1)),  # y: +d(comp x)/dz - d(comp z)/dx
    2: ((0, 1, +1), (1, 0, -1)),  # z: +d(comp y)/dx - d(comp x)/dy
}


@dataclasses.dataclass(frozen=True)
class SchemeMode:
    """One of the 13 solver modes (reference SchemeType)."""

    name: str
    e_components: Tuple[str, ...]
    h_components: Tuple[str, ...]
    active_axes: Tuple[int, ...]  # axes with spatial variation

    @property
    def ndim(self) -> int:
        return len(self.active_axes)

    @property
    def components(self) -> Tuple[str, ...]:
        return self.e_components + self.h_components

    def grid_shape(self, size: Tuple[int, int, int]) -> Tuple[int, int, int]:
        """Always-rank-3 shape; inactive axes collapse to 1."""
        return tuple(
            size[a] if a in self.active_axes else 1 for a in range(3)
        )


def _mode(name, e, h, axes):
    return SchemeMode(name, tuple(e), tuple(h), tuple(axes))


# The 13 modes, matching the reference's SchemeType enumeration
# (SURVEY.md §2: 1D {Ex_Hy, Ex_Hz, Ey_Hx, Ey_Hz, Ez_Hx, Ez_Hy},
#  2D {TEx, TEy, TEz, TMx, TMy, TMz}, 3D).
# 1D propagation axis = the axis completing the E/H right-handed pair.
# 2D TM_a: E along a + the two H transverse; TE_a: H along a + two E.
SCHEME_MODES: Dict[str, SchemeMode] = {
    m.name: m
    for m in [
        # --- 1D (one active axis) ---
        _mode("1D_ExHy", ["Ex"], ["Hy"], [2]),  # varies along z
        _mode("1D_ExHz", ["Ex"], ["Hz"], [1]),  # varies along y
        _mode("1D_EyHx", ["Ey"], ["Hx"], [2]),  # varies along z
        _mode("1D_EyHz", ["Ey"], ["Hz"], [0]),  # varies along x
        _mode("1D_EzHx", ["Ez"], ["Hx"], [1]),  # varies along y
        _mode("1D_EzHy", ["Ez"], ["Hy"], [0]),  # varies along x
        # --- 2D (two active axes) ---
        _mode("2D_TMx", ["Ex"], ["Hy", "Hz"], [1, 2]),
        _mode("2D_TMy", ["Ey"], ["Hx", "Hz"], [0, 2]),
        _mode("2D_TMz", ["Ez"], ["Hx", "Hy"], [0, 1]),
        _mode("2D_TEx", ["Ey", "Ez"], ["Hx"], [1, 2]),
        _mode("2D_TEy", ["Ex", "Ez"], ["Hy"], [0, 2]),
        _mode("2D_TEz", ["Ex", "Ey"], ["Hz"], [0, 1]),
        # --- 3D ---
        _mode("3D", list(E_COMPONENTS), list(H_COMPONENTS), [0, 1, 2]),
    ]
}


def get_mode(name: str) -> SchemeMode:
    try:
        return SCHEME_MODES[name]
    except KeyError:
        raise ValueError(
            f"unknown scheme mode {name!r}; one of {sorted(SCHEME_MODES)}"
        ) from None


def component_axis(comp: str) -> int:
    """0/1/2 for the vector direction of a component name like 'Ex'."""
    return AXIS_NAMES.index(comp[1])


def transverse_axes(comp: str) -> Tuple[int, int]:
    a = component_axis(comp)
    return tuple(x for x in range(3) if x != a)


def stagger_offset(comp: str, axis: int) -> float:
    return YEE_OFFSETS[comp][axis]

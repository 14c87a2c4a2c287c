"""Material grids evaluated at Yee-staggered component positions.

A copy of ``fdtd3d_tpu/materials.py`` (numpy only): the port keeps its
own copy so that it imports nothing of the JAX package.

Reference parity: ``Scheme::initGrids`` material fills (SURVEY.md §2 —
uniform, spherical inclusions like ``--eps-sphere``, or loaded from file)
and the dispersive OmegaPE/GammaE grids of the Drude update.

Memory-conscious design: a uniform material evaluates to a python float
(broadcast by XLA at trace time — zero HBM), only spatially-varying
materials materialize full 3D arrays. Positions are taken at each
component's own staggered location (layout.YEE_OFFSETS), matching the
reference's per-component material sampling.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

import numpy as np

from fdtd3d_torch.layout import YEE_OFFSETS

Material = Union[float, np.ndarray]


def _positions(comp: str, shape, active_axes):
    """Broadcastable (px, py, pz) position arrays, in cell units."""
    off = YEE_OFFSETS[comp]
    out = []
    for a in range(3):
        n = shape[a]
        p = np.arange(n, dtype=np.float64) + (off[a] if n > 1 else 0.0)
        bshape = [1, 1, 1]
        bshape[a] = n
        out.append(p.reshape(bshape))
    return out


def _sphere_mask(comp, shape, active_axes, sphere, planes=slice(None)):
    """Cells inside ``sphere``; ``planes`` takes a slice of axis 0."""
    px, py, pz = _positions(comp, shape, active_axes)
    px = px[planes]
    d2 = 0.0
    for a, p in enumerate((px, py, pz)):
        if a in active_axes:
            d2 = d2 + (p - sphere.center[a]) ** 2
    return d2 <= sphere.radius ** 2


def _load_bmp_grid(path: str, shape, active_axes, base: float) -> np.ndarray:
    """Material grid from a BMP image (reference BMPLoader init path).

    Luminance maps linearly: black -> 1.0 (vacuum), white -> ``base``
    (the configured background value). The image spans the first two
    active axes — columns = first axis, rows = second (the same layout
    dump_bmp writes) — and is broadcast along the third.
    """
    from fdtd3d_torch import io
    axes = [a for a in range(3) if a in active_axes]
    if len(axes) < 2:
        raise ValueError(
            "BMP material init needs a scheme with >= 2 active axes")
    a, b = axes[0], axes[1]
    lum = io.load_bmp_gray(path)
    if lum.shape != (shape[b], shape[a]):
        raise ValueError(
            f"{path}: image is {lum.shape[1]}x{lum.shape[0]} (WxH) but the "
            f"grid needs {shape[a]}x{shape[b]}")
    vals = 1.0 + (float(base) - 1.0) * lum.T      # (na, nb)
    shp = [1, 1, 1]
    shp[a], shp[b] = shape[a], shape[b]
    grid = np.empty(shape, dtype=np.float64)
    grid[:] = vals.reshape(shp)                   # broadcast along 3rd axis
    return grid


def _load_file(path: str, shape, active_axes=(0, 1, 2),
               base: float = 1.0) -> np.ndarray:
    if path.endswith(".bmp"):
        return _load_bmp_grid(path, shape, active_axes, base)
    arr = np.load(path) if path.endswith(".npy") else np.fromfile(
        path, dtype=np.float64).reshape(shape)
    return np.broadcast_to(arr, shape).astype(np.float64)


def scalar_or_grid(comp: str, shape, active_axes, base: float,
                   sphere, file_path: Optional[str]) -> Material:
    """Evaluate one material channel at ``comp``'s staggered positions."""
    if file_path:
        return _load_file(file_path, shape, active_axes, base)
    if sphere is not None and sphere.enabled and sphere.radius > 0:
        grid = np.full(shape, base, dtype=np.float64)
        grid[_sphere_mask(comp, shape, active_axes, sphere)] = sphere.value
        return grid
    return float(base)


def drude_params(comp: str, shape, active_axes, mat,
                 magnetic: bool = False) -> tuple:
    """(omega_p, gamma, region_is_uniform) at comp positions.

    When the (electric or magnetic) drude sphere is enabled the plasma is
    confined to it (omega_p = 0 outside); otherwise the whole domain is
    dispersive. ``magnetic=True`` selects the OmegaPM/GammaM analog
    (reference metamaterial mode).
    """
    sphere = mat.drude_m_sphere if magnetic else mat.drude_sphere
    wp0 = mat.omega_pm if magnetic else mat.omega_p
    g = mat.gamma_m if magnetic else mat.gamma
    if sphere.enabled and sphere.radius > 0:
        wp = np.zeros(shape, dtype=np.float64)
        wp[_sphere_mask(comp, shape, active_axes, sphere)] = wp0
        return wp, float(g), False
    return float(wp0), float(g), True


def sphere_enabled(sphere) -> bool:
    return sphere is not None and sphere.enabled and sphere.radius > 0


def _by_planes(shape, fill) -> None:
    """Call ``fill(planes)`` on slices of axis 0 that cover ``shape``,
    on a thread each when the grid is large: numpy's loops release the
    GIL, and each plane's result does not depend on the slicing."""
    workers = min(8, len(os.sched_getaffinity(0)))
    if workers < 2 or int(np.prod(shape)) < (1 << 20):
        fill(slice(None))
        return
    step = -(-shape[0] // (4 * workers))
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(lambda i: fill(slice(i, i + step)),
                      range(0, shape[0], step)))


def sphere_labels(comp: str, shape, active_axes,
                  spheres) -> Optional[np.ndarray]:
    """uint8 grid at ``comp``'s positions whose bit b is set inside
    ``spheres[b]`` (a None or disabled entry sets no bit), or None when
    no sphere is enabled."""
    live = [(b, sp) for b, sp in enumerate(spheres) if sphere_enabled(sp)]
    if not live:
        return None
    label = np.zeros(shape, np.uint8)

    def fill(planes):
        for b, sphere in live:
            label[planes] |= _sphere_mask(comp, shape, active_axes, sphere,
                                          planes).view(np.uint8) << b
    _by_planes(shape, fill)
    return label


def label_grid(table: np.ndarray, label: np.ndarray) -> np.ndarray:
    """``table[label]``: the grid of a per-label table."""
    out = np.empty(label.shape, table.dtype)

    def fill(planes):
        out[planes] = table[label[planes]]
    _by_planes(label.shape, fill)
    return out


def sphere_table(b: int, nbits: int, inside: float,
                 outside: float) -> np.ndarray:
    """A material that is ``inside`` in sphere b and ``outside``
    elsewhere, as one f64 value per label of ``sphere_labels`` over
    ``nbits`` spheres: what ``scalar_or_grid`` and ``drude_params``
    store at the cells of that label."""
    inner = (np.arange(1 << nbits) >> b) & 1 == 1
    return np.where(inner, np.float64(inside), np.float64(outside))


def merge_drude_eps(eps: Material, omega_p, eps_inf: float) -> Material:
    """Background eps_r is eps_inf wherever the Drude plasma is active."""
    if np.isscalar(omega_p):
        return float(eps_inf) if omega_p > 0 else eps
    grid = np.asarray(np.broadcast_to(np.asarray(eps, dtype=np.float64),
                                      omega_p.shape)).copy()
    grid[omega_p > 0] = eps_inf
    return grid

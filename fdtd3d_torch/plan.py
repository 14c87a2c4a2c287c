"""Memory and halo planner of the port: size a run before touching a
device.

Counterpart of ``fdtd3d_tpu/plan.py`` (``Plan`` :111, ``plan`` :239,
``plan_for_topology`` :325, the topology ladder :460-500), counting what
the port allocates rather than what the reference does. ``plan(cfg)``
gives, per shard (one shard a device), the bytes of every array a run
holds there, from the same layout rules as ``solver.init_state``,
``solver.build_coeffs``, ``parallel.mesh.ShardMesh.split`` and the
sharded packed step, without allocating anything:

* the carry: E and H at the storage width, the slab-compact CPML psi
  (2 m planes a shard along its own axis), J and K, the Kahan residuals
  of compensated mode, float32x2's low words, the incident line (one a
  device);
* the coefficients in the port's layout: every 3D grid build_coeffs
  makes (``ca``/``cb``/``bj``, ``da``/``db``/``bm``, their ``*_lo``
  words in compensated and float32x2 modes), and the 1D vectors (cell
  indices, walls, CPML profiles, the line's loss profiles), which every
  shard holds its own piece or copy of;
* the ghost buffers of the sharded steps: (3, plane) a side with a
  neighbour, E's from below and H's from above; float32x2 pairs (6,
  plane), old H from below and new E from above;
* the packed-ds step's spare set (it writes out of place): a second
  E, H, psi, J and K, and a second incident line a device;
* the sharded two-pass step's out-of-place family (kind ``pallas3d``,
  where ``solver.sharded_two_pass_reason`` sends a decomposed run): a
  new E with its psi and J (or H with its psi and K) lives beside the
  old one while its launch runs, the larger of the two families.

The work plans and TFSF patch tables the packed step prepares (a few
kilobytes to megabytes of int32 and float rows) are not counted.

``halo_bytes_per_step`` is the traffic of one step of the most connected
shard: on each sharded axis, toward each neighbour, the two components
of one family received and the two of the other sent, a plane each
(the reference's count for an interior shard), float32x2 planes as
pairs.

``CommStrategy`` records the port's one exchange schedule, fixed: the
two component planes of an axis copied together (one strided copy for
x and z, one a component for y), on the receiving shard's stream,
before the launch that reads them (no overlap). The reference's chooser
scores strategies against its cost model (``costs.py``), which is
ROADMAP.md item A14(b) here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fdtd3d_torch import solver
from fdtd3d_torch.layout import CURL_TERMS, component_axis

AXES = "xyz"


@dataclasses.dataclass(frozen=True)
class CommStrategy:
    """The halo exchange of a decomposed run, as the port schedules it
    (fixed; see the module docstring)."""

    step_kind: str
    topology: Tuple[int, int, int]
    shard_axes: Tuple[str, ...]
    ghost_depth: int
    split: str
    schedule: str
    source: str
    plane_bytes_max: int


@dataclasses.dataclass(frozen=True)
class Plan:
    topology: Tuple[int, int, int]
    local_shape: Tuple[int, int, int]
    fields_bytes: int          # E + H (+ float32x2 low words)
    psi_bytes: int             # CPML psi (slab-compact; + ds low words)
    drude_bytes: int           # J and K
    residual_bytes: int        # compensated mode's rE, rH (bf16)
    inc_bytes: int             # the TFSF incident line, one a device
    coeff_bytes: int           # 3D coefficient grids
    vector_bytes: int          # 1D coefficients (indices, walls, profiles)
    ghost_bytes: int           # the sharded step's ghost buffers
    spare_bytes: int           # the packed-ds or two-pass step's
                               # out-of-place set
    halo_bytes_per_step: int   # received + sent a step, busiest shard
    n_chips: int
    halo_by_axis: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    comm_strategy: Optional[CommStrategy] = None

    @property
    def hbm_per_chip(self) -> int:
        return (self.fields_bytes + self.psi_bytes + self.drude_bytes
                + self.residual_bytes + self.inc_bytes + self.coeff_bytes
                + self.vector_bytes + self.ghost_bytes + self.spare_bytes)

    def report(self) -> str:
        gib = 1 << 30
        mib = 1 << 20
        two_pass = self.comm_strategy is not None \
            and self.comm_strategy.step_kind == "pallas3d"
        spare_label = "new E or H family:" if two_pass else "ds spare set:"
        lines = [
            f"topology {self.topology} ({self.n_chips} device"
            f"{'s' if self.n_chips != 1 else ''}), local grid "
            f"{self.local_shape}",
            f"  fields (E+H):        {self.fields_bytes / gib:8.3f} GiB",
            f"  CPML psi (slabs):    {self.psi_bytes / gib:8.3f} GiB",
            f"  Drude J/K:           {self.drude_bytes / gib:8.3f} GiB",
            f"  Kahan residuals:     {self.residual_bytes / gib:8.3f} GiB",
            f"  TFSF incident line:  {self.inc_bytes / mib:8.3f} MiB",
            f"  material coeffs:     {self.coeff_bytes / gib:8.3f} GiB",
            f"  1D coefficients:     {self.vector_bytes / mib:8.3f} MiB",
            f"  ghost planes:        {self.ghost_bytes / mib:8.3f} MiB",
            f"  {spare_label:<20s} {self.spare_bytes / gib:8.3f} GiB",
            f"  TOTAL per device:    {self.hbm_per_chip / gib:8.3f} GiB",
            f"  halo exchange:       {self.halo_bytes_per_step / mib:8.3f}"
            f" MiB/device/step",
        ]
        if self.comm_strategy is not None:
            s = self.comm_strategy
            lines.append(
                f"  comm strategy:       {s.split} + {s.schedule}, ghost "
                f"depth {s.ghost_depth} ({s.step_kind}; source: "
                f"{s.source})")
        return "\n".join(lines)


def _coeff_grid_counts(static) -> Tuple[int, int]:
    """(grids a E component, grids a H component) build_coeffs makes:
    ca/cb where eps varies (a file, a sphere, or a Drude sphere's merged
    eps), bj where a Drude sphere confines the plasma (kj stays scalar),
    the H family's dual; compensated and float32x2 modes add a low word
    of each material grid (``*_lo``)."""
    mat = static.cfg.materials
    lo = 2 if (static.cfg.compensated or static.cfg.ds_fields) else 1

    def sphere_on(s):
        return s is not None and s.enabled and s.radius > 0

    def side(base_grid, use, wp_sphere, wp0):
        drive = 0
        if use:
            if sphere_on(wp_sphere):
                base_grid, drive = True, 1
            elif wp0 > 0:
                base_grid = False
        return 2 * base_grid * lo + drive

    per_e = side(bool(mat.eps_file) or sphere_on(mat.eps_sphere),
                 static.use_drude, mat.drude_sphere, mat.omega_p)
    per_h = side(bool(mat.mu_file) or sphere_on(mat.mu_sphere),
                 static.use_drude_m, mat.drude_m_sphere, mat.omega_pm)
    return per_e, per_h


def _vector_bytes(static, local) -> int:
    """The 1D coefficients of one shard (build_coeffs' vectors, cut by
    ``ShardMesh.split``: axis-suffixed ones to the local extent, the
    slab profiles to 2 m, the line's profiles whole)."""
    rb = np.dtype(static.real_dtype).itemsize
    n = 0
    for a in range(3):
        n += local[a] * (4 + rb)                 # g{x,y,z} int32, wall_*
    words = 2 if static.cfg.ds_fields else 1     # ds hi + lo profiles
    if static.pml_axes:
        # pml_{b,c,ik}{e,h}_{x,y,z}: every axis, full local length
        n += sum(6 * local[a] * rb * words for a in range(3))
        for a, m in solver.slab_axes(static).items():
            n += 6 * 2 * m * rb * words
    if static.tfsf_setup is not None:
        lo = 2 if static.cfg.ds_fields else 1
        n += 4 * static.tfsf_setup.n_inc * rb * lo
    return n


def _halo_planes(mode, a: int) -> int:
    """Planes a shard interior to axis a receives (and sends) a step: one
    a curl term whose difference crosses the axis."""
    n = 0
    for upd, srcs, other in ((mode.e_components, mode.h_components, "H"),
                             (mode.h_components, mode.e_components, "E")):
        for c in upd:
            for (ax, d_axis, _s) in CURL_TERMS[component_axis(c)]:
                if ax == a and other + AXES[d_axis] in srcs:
                    n += 1
    return n


def plan(cfg, n_devices: int = 1) -> Plan:
    """The per-device plan of ``cfg`` over ``n_devices`` (the topology
    authority's resolution: manual as given, "auto" over the count),
    without any device work."""
    topo = solver.config_topology(cfg, n_devices=n_devices)
    static = solver.build_static(cfg, topology=topo)
    mode = static.mode
    local = tuple(static.grid_shape[a] // topo[a] for a in range(3))
    cells = int(np.prod(local))
    fb = torch.empty((), dtype=static.field_dtype).element_size()
    ab = torch.empty((), dtype=static.aux_dtype).element_size()
    rb = np.dtype(static.real_dtype).itemsize
    ds = static.cfg.ds_fields
    fields = len(mode.components) * cells * fb * (2 if ds else 1)
    slabs = solver.slab_axes(static)
    # per family: its fields, psi and ADE current (J on E, K on H)
    fam_psi = {}
    for fam, comps in (("E", mode.e_components), ("H", mode.h_components)):
        fam_psi[fam] = 0
        for c in comps:
            for (a, _d, _s) in CURL_TERMS[component_axis(c)]:
                if a in static.pml_axes:
                    shape = list(local)
                    if a in slabs:
                        shape[a] = 2 * slabs[a]
                    fam_psi[fam] += int(np.prod(shape)) * ab * (2 if ds
                                                                else 1)
    psi = fam_psi["E"] + fam_psi["H"]
    fam_ade = {"E": len(mode.e_components) * cells * ab
               if static.use_drude else 0,
               "H": len(mode.h_components) * cells * ab
               if static.use_drude_m else 0}
    drude = fam_ade["E"] + fam_ade["H"]
    residual = len(mode.components) * cells * 2 \
        if static.cfg.compensated else 0
    inc = 2 * static.tfsf_setup.n_inc * ab * (2 if ds else 1) \
        if static.tfsf_setup is not None else 0
    per_e, per_h = _coeff_grid_counts(static)
    coeff = (len(mode.e_components) * per_e
             + len(mode.h_components) * per_h) * cells * rb
    vectors = _vector_bytes(static, local)
    spare = 0
    kind = "packed_ds" if ds else "packed"
    if ds and static.cfg.use_pallas is not False \
            and solver._ds_kernel_wanted(static):
        # the packed-ds step on the card (use_pallas None or True)
        spare = fields + psi + drude + inc
    elif max(topo) > 1 and solver.sharded_two_pass_reason(static):
        kind = "pallas3d"
        spare = max(len(comps) * cells * fb + fam_psi[fam] + fam_ade[fam]
                    for fam, comps in (("E", mode.e_components),
                                       ("H", mode.h_components)))
    words = 2 if ds else 1
    ghost, halo = 0, 0
    by_axis: Dict[str, Dict[str, int]] = {}
    for a in range(3):
        if topo[a] > 1:
            plane = cells // local[a]
            # the busiest shard: with more than two shards on the axis an
            # interior one has a buffer from below (E's) and one from
            # above (H's), three components each; with two, one of them
            sides = 2 if topo[a] > 2 else 1
            ghost += sides * 3 * words * plane * fb
            # each side: the planes of one family received, the other's
            # sent
            planes = _halo_planes(mode, a)
            pb = words * plane * fb
            by_axis[AXES[a]] = {
                "planes_per_step": planes, "plane_bytes": pb,
                "bytes_per_neighbor_per_step": planes * pb,
                "bytes_per_step": sides * planes * pb}
            halo += sides * planes * pb
    strat = None
    if max(topo) > 1:
        strat = CommStrategy(
            step_kind=kind, topology=topo,
            shard_axes=tuple(AXES[a] for a in range(3) if topo[a] > 1),
            ghost_depth=1, split="fused", schedule="sync",
            source="fixed",
            plane_bytes_max=max(v["plane_bytes"] * 2
                                for v in by_axis.values()))
    return Plan(topology=topo, local_shape=local, fields_bytes=fields,
                psi_bytes=psi, drude_bytes=drude, residual_bytes=residual,
                inc_bytes=inc, coeff_bytes=coeff, vector_bytes=vectors,
                ghost_bytes=ghost, spare_bytes=spare,
                halo_bytes_per_step=halo,
                n_chips=int(np.prod(topo)), halo_by_axis=by_axis,
                comm_strategy=strat)


def plan_for_topology(cfg, topology: Tuple[int, int, int]) -> Plan:
    """``plan`` with a forced (px, py, pz) decomposition."""
    from fdtd3d_torch.config import ParallelConfig
    topology = tuple(int(p) for p in topology)
    cfg = dataclasses.replace(
        cfg, parallel=ParallelConfig(topology="manual",
                                     manual_topology=topology))
    return plan(cfg, n_devices=int(np.prod(topology)))


def degrade_topology(topology: Tuple[int, int, int]
                     ) -> Optional[Tuple[int, int, int]]:
    """One rung down the topology ladder (the reference's rule): the
    largest factor shrunk to its largest proper divisor (the first such
    axis on ties), or None at (1, 1, 1)."""
    t = [int(p) for p in topology]
    mx = max(t)
    if mx <= 1:
        return None
    a = t.index(mx)
    for d in range(mx // 2, 0, -1):
        if mx % d == 0:
            t[a] = d
            break
    return tuple(t)


def fits_devices(topology: Tuple[int, int, int], n_devices: int) -> bool:
    """Whether a decomposition maps onto ``n_devices`` devices."""
    return int(np.prod([int(p) for p in topology])) <= int(n_devices)


def shrink_to_devices(topology: Tuple[int, int, int], n_devices: int
                      ) -> Tuple[int, int, int]:
    """The first rung of the topology ladder with at most ``n_devices``
    shards (at worst (1, 1, 1))."""
    topo: Optional[Tuple[int, int, int]] = tuple(int(p) for p in topology)
    while topo is not None and not fits_devices(topo, n_devices):
        topo = degrade_topology(topo)
    return topo if topo is not None else (1, 1, 1)

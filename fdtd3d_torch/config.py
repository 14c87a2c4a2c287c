"""Runtime configuration of the PyTorch port.

The dataclasses of ``fdtd3d_tpu/config.py`` with the same fields and
defaults, so a command file parses to equal configurations in both
packages (``dataclasses.asdict`` compares them in the tests). What the
port leaves out: the ``FDTD3D_*`` environment-knob registry and the
VMEM calibration table, which belong to the TPU kernels. The dtype
mapping is done in torch (``SimConfig.torch_dtype``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from fdtd3d_torch import physics
from fdtd3d_torch.layout import get_mode


@dataclasses.dataclass
class PmlConfig:
    """CPML absorbing boundary (reference PML/CPML flags, SURVEY.md §0/§2).

    ``size``: thickness in cells per axis (0 disables on that axis). Applied
    on both ends of each active axis, backed by the PEC wall.
    Grading follows Roden & Gedney recursive-convolution CPML:
    sigma ~ sigma_max * d^m, kappa = 1+(kappa_max-1) d^m, alpha linear in
    (1-d), with sigma_max = -(m+1) ln(R0) / (2 eta0 dx * size).
    """

    size: Tuple[int, int, int] = (0, 0, 0)
    m: float = 3.0                 # polynomial grading order
    r0: float = 1e-8               # target normal-incidence reflection
    # kappa_max > 1 trades normal-incidence absorption for evanescent/
    # grazing handling (measured: 10-cell slab reflects 4e-4 at kappa=1 but
    # 1.4e-2 at kappa=5, identical numbers from an independent textbook
    # implementation). Default favors the common propagating-wave case.
    kappa_max: float = 1.0
    alpha_max: float = 0.05
    sigma_scale: float = 1.0       # multiplier on the optimal sigma_max

    @property
    def enabled(self) -> bool:
        return any(s > 0 for s in self.size)


@dataclasses.dataclass
class TfsfConfig:
    """Total-field/scattered-field plane-wave injection.

    Reference: TFSF source with 1D auxiliary incident grids EInc/HInc and
    ``--angle-teta/phi/psi`` oblique incidence (SURVEY.md §3.4).
    ``margin``: distance in cells from the domain wall (or from the PML inner
    face if PML is on) to the TFSF box face, per axis.
    Angles in degrees: teta = polar from +z, phi = azimuth from +x,
    psi = polarization rotation about the propagation direction
    (psi=0 -> E along the unit theta vector).
    """

    enabled: bool = False
    margin: Tuple[int, int, int] = (8, 8, 8)
    angle_teta: float = 0.0
    angle_phi: float = 0.0
    angle_psi: float = 0.0
    amplitude: float = 1.0
    # Incident waveform: "sin" (CW ramp-up) | "gauss_pulse" (modulated)
    waveform: str = "sin"


@dataclasses.dataclass
class PointSourceConfig:
    """Soft point (current) source on one field component.

    Reference analog: point-source excitation used by BASELINE config #2
    ("2D TMz point source"). Position in global cells.
    """

    enabled: bool = False
    component: str = "Ez"
    position: Tuple[int, int, int] = (0, 0, 0)
    amplitude: float = 1.0
    waveform: str = "sin"          # "sin" | "gauss_pulse" | "ricker"


@dataclasses.dataclass
class SphereConfig:
    """Spherical inclusion (reference ``--eps-sphere*`` style material init)."""

    enabled: bool = False
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # cells
    radius: float = 0.0                                   # cells
    value: float = 1.0


@dataclasses.dataclass
class MaterialsConfig:
    """Material definition (reference ``Scheme::initGrids`` fills, SURVEY §2).

    Uniform background + optional sphere inclusions + optional load-from-file
    (array path, .npy/.dat). Drude media: eps(w) = eps_inf -
    wp^2 / (w^2 + i gamma w), active where omega_p > 0.
    """

    eps: float = 1.0               # background relative permittivity
    mu: float = 1.0                # background relative permeability
    sigma_e: float = 0.0           # electric conductivity S/m
    sigma_m: float = 0.0           # magnetic loss
    eps_sphere: SphereConfig = dataclasses.field(default_factory=SphereConfig)
    mu_sphere: SphereConfig = dataclasses.field(default_factory=SphereConfig)
    # Drude (electric)
    use_drude: bool = False
    eps_inf: float = 1.0
    omega_p: float = 0.0           # rad/s (0 -> no plasma response)
    gamma: float = 0.0             # collision rate, rad/s
    drude_sphere: SphereConfig = dataclasses.field(default_factory=SphereConfig)
    # Drude (magnetic) — the reference's metamaterial mode pairs the
    # OmegaPE/GammaE grids with OmegaPM/GammaM ones so both eps(w) and
    # mu(w) disperse (double-negative media): mu(w) = mu_inf -
    # wpm^2/(w^2 + i gm w), realized as an ADE magnetic current K.
    use_drude_m: bool = False
    mu_inf: float = 1.0
    omega_pm: float = 0.0
    gamma_m: float = 0.0
    drude_m_sphere: SphereConfig = dataclasses.field(
        default_factory=SphereConfig)
    # load-from-file (path to .npy with shape (Nx,Ny,Nz) or broadcastable)
    eps_file: Optional[str] = None
    mu_file: Optional[str] = None


@dataclasses.dataclass
class ParallelConfig:
    """Spatial domain decomposition (reference ParallelGrid modes, SURVEY §2.9).

    topology: "none" | "auto" | explicit (px,py,pz) via manual_topology.
    Auto picks the factorization of n_devices over the ACTIVE axes minimizing
    total halo surface (the reference's optimal-node-grid heuristic).

    Deliberate non-feature: the reference's configurable ghost width
    (``--buffer-size``: exchange k planes, then step k times without
    communicating, recomputing the overlap) is an MPI-latency lever. On
    the TPU torus the one-plane ``ppermute`` per axis per half-step rides
    ICI at ~us latency and XLA overlaps it with the interior compute, so
    redundant-compute halos would pay FLOPs + memory for a latency that
    is not the bottleneck; the knob is omitted rather than accepted and
    ignored.
    """

    topology: str = "none"
    manual_topology: Optional[Tuple[int, int, int]] = None
    n_devices: Optional[int] = None  # default: all visible devices


@dataclasses.dataclass
class NtffConfig:
    """Near-to-far-field transform (reference --ntff-* flags, SURVEY §2).

    A running DFT of the tangential fields on a closed virtual box
    accumulates during the run (fdtd3d_tpu.ntff.NtffCollector); the
    far-field directivity pattern is written at the end.

    frequency: DFT frequency in Hz; None = the source frequency
    (C0/wavelength). every: sampling cadence in steps; None = auto
    (~16 samples per period). start: first sampling step; None = auto
    (after half the run, once the CW state is established). margin:
    box distance in cells inward from the PML inner face.
    """

    enabled: bool = False
    frequency: Optional[float] = None
    every: Optional[int] = None
    start: Optional[int] = None
    margin: int = 2
    # Explicit box override (global cell coords, inclusive): when set,
    # wins over `margin` (the collector's `box=` argument).
    box_lo: Optional[Tuple[int, int, int]] = None
    box_hi: Optional[Tuple[int, int, int]] = None
    theta_steps: int = 19          # pattern grid: theta in [0, 180]
    phi_steps: int = 24            # phi in [0, 360)


@dataclasses.dataclass
class OutputConfig:
    """Dump/diagnostics cadence (reference --save-res/dumpers, SURVEY §2)."""

    save_res: int = 0              # every N steps dump fields (0 = never)
    save_dir: str = "out"
    formats: Tuple[str, ...] = ("dat",)   # subset of {"dat","txt","bmp"}
    save_materials: bool = False
    checkpoint_every: int = 0      # full-state checkpoint cadence
    # "npz": rank-0 gathers and writes one file; "orbax": sharding-aware,
    # every host writes its own shards (large/multi-host runs)
    checkpoint_backend: str = "npz"
    # keep-K rotation for the checkpoint_every cadence: after each
    # cadence snapshot commits, only the newest K stay on disk
    # (0 = keep all). Snapshots are written crash-safely (io.atomic_open)
    # and named ckpt_tNNNNNN[.npz] in save_dir; resume with the CLI's
    # --resume auto (io.find_latest_checkpoint).
    checkpoint_keep: int = 3
    norms_every: int = 0           # print L2/Linf norms every N steps
    # structured per-interval metrics (energy, norms, divergence
    # residual — diag.metrics) appended to save_dir/metrics.jsonl
    # (SURVEY §5.5 observability)
    metrics_every: int = 0
    log_level: int = 1
    # Attach a profiling.StepClock to the Simulation: every advance()
    # chunk is timed (with a device sync, so honest but intrusive) and
    # aggregated in sim.clock (reference Clock compute-share timing,
    # SURVEY.md §5.1).
    profile: bool = False
    # NaN/Inf tripwire after every advance() chunk. Implemented by the
    # health pass (fdtd3d_torch/telemetry.py): one reduction over views
    # of the live carry at the chunk's end + one scalar readback, never
    # a host-side pass over the fields. Independent of log_level so it
    # can guard production runs.
    check_finite: bool = False
    # Flight-recorder JSONL (fdtd3d_torch/telemetry.py): when set, every
    # advance() chunk appends a schema-versioned record (the health
    # counters, wall time, throughput) to this path, after a run_start
    # provenance record. CLI flag: --telemetry PATH. Summarize with
    # tools/telemetry_report.py.
    telemetry_path: Optional[str] = None
    # OpenMetrics exposition (fdtd3d_tpu/metrics.py): when set, a
    # MetricsRegistry observes every telemetry record host-side
    # (counters/gauges/histograms: throughput, chunk wall, recovery
    # events, unhealthy lanes, cache hits) and the Prometheus text
    # exposition is written to this path at close — any scraper can
    # ingest a run without parsing our JSONL. Works with or without
    # telemetry_path (a file-less sink feeds it). CLI: --metrics PATH.
    metrics_path: Optional[str] = None
    # Per-chip lane (telemetry schema v4): with a sink attached, each
    # chunk additionally records the per-chip health counters (length-1
    # vectors unsharded, on the same single readback) as a "per_chip"
    # record (and, with several chips, an "imbalance" summary). CLI
    # flag: --per-chip-telemetry. No-op without telemetry_path.
    per_chip_telemetry: bool = False
    # Trace capture: when set, Simulation starts a torch.profiler
    # capture at the first advance() and writes DIR/trace.json in
    # Simulation.close() — crash-safe via the callers' try/finally,
    # degrade-to-skip when no profiler is available
    # (profiling.TraceCapture). CLI flag: --profile DIR or --trace DIR.
    profile_dir: Optional[str] = None


@dataclasses.dataclass
class SimConfig:
    """Top-level solver configuration (reference Settings + CMake matrix)."""

    scheme: str = "3D"
    size: Tuple[int, int, int] = (32, 32, 32)   # cells per axis (global)
    time_steps: int = 100
    dx: float = 1e-3               # uniform spatial step, meters
    courant_factor: float = 0.5
    wavelength: float = 20e-3      # source wavelength, meters
    # "float32" | "float64" | "bfloat16" | "float32x2" (double-single:
    # hi+lo f32 pairs, ~f64-class accumulation at 2x f32 traffic)
    dtype: str = "float32"
    complex_fields: bool = False   # reference COMPLEX_FIELD_VALUES mode
    # Kahan-compensated f32 updates: each field family carries a bf16
    # residual of the lost low-order bits of its leapfrog accumulation,
    # recovering ~1e-7-class long-horizon accuracy (the reference is
    # f64 C++; plain f32 drifts past 1e-6 by ~1000 steps — BASELINE.md
    # frontier table) at ~1.25x the f32 HBM traffic instead of f64's
    # ~10x slowdown. float32 only.
    compensated: bool = False

    pml: PmlConfig = dataclasses.field(default_factory=PmlConfig)
    tfsf: TfsfConfig = dataclasses.field(default_factory=TfsfConfig)
    point_source: PointSourceConfig = dataclasses.field(
        default_factory=PointSourceConfig)
    materials: MaterialsConfig = dataclasses.field(
        default_factory=MaterialsConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)
    output: OutputConfig = dataclasses.field(default_factory=OutputConfig)
    ntff: NtffConfig = dataclasses.field(default_factory=NtffConfig)

    # The kernel step (name kept from the reference, where it selects
    # the Pallas kernels): None = auto (the packed CUDA step on a CUDA
    # device, the plain step on the CPU), True = the packed step (its
    # kernels' plain versions on the CPU), False = the plain step.
    use_pallas: Optional[bool] = None
    # Error out at construction if the CUDA kernels do NOT engage.
    require_pallas: bool = False

    # ---- derived ----
    @property
    def mode(self):
        return get_mode(self.scheme)

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return self.mode.grid_shape(self.size)

    @property
    def dt(self) -> float:
        return physics.courant_dt(self.dx, self.courant_factor,
                                  self.mode.ndim)

    @property
    def omega(self) -> float:
        return 2.0 * math.pi * physics.C0 / self.wavelength

    def torch_dtype(self):
        """The torch dtype of the stored fields (the port's counterpart
        of ``np_dtype``, which imports jax for bfloat16)."""
        import torch
        if self.complex_fields:
            return {"float32": torch.complex64,
                    "float32x2": torch.complex64,
                    "float64": torch.complex128}[self.dtype]
        return {"float32": torch.float32, "float64": torch.float64,
                "bfloat16": torch.bfloat16,
                "float32x2": torch.float32}[self.dtype]

    @property
    def ds_fields(self) -> bool:
        """Double-single (hi+lo f32 pair) field storage — ~f64-class
        accumulation on the f32 vector units (ops/ds.py) at 2x field
        traffic; the ``--dtype float32x2`` accuracy rung."""
        return self.dtype == "float32x2"

    def validate(self) -> "SimConfig":
        mode = self.mode  # raises on bad scheme
        if not (0.0 < self.courant_factor <= 1.0):
            raise ValueError("courant_factor must be in (0, 1]")
        for a in range(3):
            if a in mode.active_axes and self.size[a] < 4:
                raise ValueError(f"active axis {a} needs >= 4 cells")
        if self.pml.enabled:
            for a in mode.active_axes:
                if self.pml.size[a] * 2 + 4 > self.size[a] and \
                        self.pml.size[a] > 0:
                    raise ValueError(f"PML too thick on axis {a}")
        if self.dtype not in ("float32", "float64", "bfloat16",
                              "float32x2"):
            raise ValueError(f"bad dtype {self.dtype}")
        if self.output.checkpoint_backend not in ("npz", "orbax"):
            raise ValueError(
                f"bad checkpoint backend "
                f"{self.output.checkpoint_backend!r} (npz | orbax)")
        for use, wp, base, tag in (
                (self.materials.use_drude, self.materials.omega_p,
                 self.materials.eps_inf, "eps_inf"),
                (self.materials.use_drude_m, self.materials.omega_pm,
                 self.materials.mu_inf, "mu_inf")):
            if use and wp > 0:
                # Drude dispersion w^2 = (wp^2 + c^2 k^2)/base tightens
                # the leapfrog stability limit:
                # ((wp dt/2)^2 + cf^2)/base <= 1 (cf is the fraction of
                # the vacuum Courant limit). Violations blow up to NaN.
                margin = ((wp * self.dt / 2.0) ** 2
                          + self.courant_factor ** 2) / base
                if margin > 1.0:
                    raise ValueError(
                        f"unstable Drude configuration: ((wp*dt/2)^2 + "
                        f"courant_factor^2)/{tag} = {margin:.3f} > 1; "
                        f"reduce courant_factor or the plasma frequency")
        if self.point_source.enabled and \
                self.point_source.component not in mode.e_components:
            raise ValueError(
                f"point source component {self.point_source.component!r} "
                f"is not an active E component of scheme {self.scheme} "
                f"(active: {mode.e_components})")
        if self.complex_fields and self.dtype == "bfloat16":
            raise ValueError("complex_fields requires float32/float64")
        if self.compensated and (self.dtype != "float32"
                                 or self.complex_fields):
            raise ValueError(
                "compensated updates require real float32 fields "
                "(float64 needs no compensation; bfloat16 storage is "
                "already below the residual's resolution; float32x2 "
                "supersedes compensation — its lo words ARE the "
                "residuals, carried through the curls too)")
        if self.ntff.enabled:
            if mode.name != "3D":
                raise ValueError("NTFF requires the 3D scheme")
            if self.ntff.theta_steps < 2 or self.ntff.phi_steps < 1:
                raise ValueError(
                    "NTFF needs theta_steps >= 2 and phi_steps >= 1")
            if self.ntff.every is not None and self.ntff.every < 1:
                raise ValueError("ntff.every must be >= 1")
        return self

"""Solver core of the PyTorch port: static setup, coefficients, the step.

Counterpart of ``fdtd3d_tpu/solver.py``. The state is a dict of torch
tensors ``{E, H, psi_E, psi_H, J, inc, t}`` with the reference's keys
(``t`` is a host integer here); coefficients are host-built numpy
(``build_coeffs``, the reference's code) moved to the device once
(``coeffs_to_device``). Update equations: see the reference module.

``make_step`` dispatches an in-scope configuration to one of four steps:

* float32: the temporal-blocked pass (``ops/packed_tb.py``): two
  steps per hand-written CUDA launch on a CUDA device (kind
  ``packed_tb_cuda``), its plain torch version on the CPU (kind
  ``packed_tb_plain``), with the packed step as its tail for an odd
  remainder; the reference's first choice, taken whenever the
  configuration is in its scope, ``FDTD3D_NO_TEMPORAL`` is unset and
  the caller allows multi-step steps. Otherwise the packed step
  (``ops/packed.py``): stacked E/H carry, one hand-written CUDA launch
  per field family on a CUDA device (kind ``packed_cuda``), the same
  arithmetic in plain torch on the CPU (kind ``packed_plain``); or the
  plain step (kind ``plain``): the reference's jnp branch written in
  torch on dict-form state. It is the port's oracle, as the jnp step
  is the reference's. Every step but the temporal-blocked one carries
  ``diag["tb_fallback"]`` naming why (``tb_fallback_reason``).
  The kernel ladder below packed: ``FDTD3D_NO_PACKED`` or
  ``FDTD3D_FORCE_FUSED`` skips the pass and the packed step; the run
  takes the recompute-fused single pass (``ops/pallas_fused.py``, kinds
  ``fused_cuda``/``fused_plain``) where it is eligible and
  ``FDTD3D_FORCE_FUSED`` is set or the port's ``fused_preferred`` rule
  picks it, else the two-pass family step (``ops/pallas3d.py``, kinds
  ``pallas3d_cuda``/``pallas3d_plain``). ``FDTD3D_NO_FUSED`` skips the
  fused rung; alone it changes nothing above packed.
* float32x2 (double-single hi+lo pairs, ops/ds.py): the packed-ds step
  (``ops/packed_ds.py``, kinds ``packed_ds_cuda``/``packed_ds_plain``)
  or the plain ds step (kind ``plain_ds``, the reference's jnp-ds
  branch), which ``FDTD3D_NO_PACKED`` also selects. Drude J and
  magnetic Drude K ride both in plain f32, as in the reference.
* float64: the plain step in f64 (no kernel in either package); it is
  the oracle of the accuracy check on the card.

``use_pallas`` keeps its meaning: None picks the packed steps on CUDA
and the plain step on the CPU, True forces the packed steps, False the
plain one.

``make_step(batch=B)`` builds the lane-capable step of a batch of B
same-shape scenarios (fdtd3d_torch/batch.py): the temporal-blocked pass
with its packed tail, or the packed step outside the pass's scope, over
a carry with a leading lane axis, one launch for every lane. Callers
gate it with ``batch_fallback_reason``, the batch dispatch authority;
a batch it gives a token runs the plain step lane by lane.

bfloat16 is a storage dtype (the reference's mixed precision): E and H
are stored in bf16, every operation runs in float32, and the recursion
state (CPML psi, Drude J, the incident line) and the coefficients stay
float32. A field is rounded to bf16 (round to nearest even) where it is
stored; the steps above are the same functions with bf16 fields.

Compensated (Kahan) float32 (``cfg.compensated``, the reference's
mode): E and H carry bf16 residuals ``rE``/``rH`` of the low-order bits
their f32 add drops, the material coefficients a double-single low word
(``*_lo``) and 1/dx a low word too. It runs on the packed step, as the
reference's; with a coefficient grid, or with magnetic Drude K, the
reference declines its packed kernel and so does the port: the plain
step runs.

Complex fields (``cfg.complex_fields``, the reference's
COMPLEX_FIELD_VALUES mode) take one of the reference's two routes. On a
CUDA device (or under the reference's test hook
``FDTD3D_FORCE_PAIRED_COMPLEX``) the run is two real legs
(``_make_paired_complex_step``, ``StaticSetup.paired_complex``): the
update is linear with real coefficients and real sources, so the re leg
carries the sources, the im leg runs the same step with their
amplitudes zeroed, and each leg rides the normal kernel chain (kind
``complex2x_<leg kind>``: ``complex2x_packed_cuda`` in 3D f32,
``complex2x_packed_ds_cuda`` in 3D float32x2). Elsewhere the plain step
runs in native complex arithmetic (complex64 or complex128 fields, psi,
J, K and incident line; the waveform and the line coordinates stay
real): the oracle of the paired route, as the reference's CPU route is
of its TPU one. Complex float32x2 has no native route (the reference's
fails on its first complex clip): it runs only as paired ds legs.

Every kernel is 3D-only, as the reference's are: a 1D or 2D scheme
mode (inactive axes are singleton dims) runs the plain step (kind
``plain``, ``plain_ds`` with float32x2), the counterpart of the
reference's jnp and jnp-ds steps, with ``tb_fallback`` token
``packed_ineligible``; ``require_pallas`` raises on it.

A sharded topology (``StaticSetup.topology``, resolved by
``config_topology``) runs, over a ``parallel.mesh.ShardMesh``
(``make_step(mesh=)``), in 3D f32 or bf16 storage the sharded
temporal-blocked pass (``ops/packed_tb.py::make_sharded_packed_tb_step``)
wherever the unsharded dispatch would take its pass, else the sharded
packed step (``ops/packed.py::make_sharded_packed_step``; compensated
where the packed kernel takes it) with the reference's ``tb_fallback``
token (``tb_fallback_reason``), and 3D float32x2 the sharded packed-ds
step (``ops/packed_ds.py::make_sharded_packed_ds_step``, token
``ds_fields``). Where the reference's dispatch lands a sharded f32/bf16
run on its two-pass kernels (``FDTD3D_NO_PACKED``/``FDTD3D_FORCE_FUSED``,
a source inside the absorber, a y or z shard too thin for slab psi:
``sharded_two_pass_reason``), the sharded two-pass step runs
(``ops/pallas3d.py::make_sharded_pallas_step``) with the token the
reference records there; ``check_scope`` and ``sharded_scope`` refuse
the rest, naming the item.

Scope: every scheme mode, real float32, bfloat16, float32x2 and
float64, complex float32 and float64, CPML on any axes, TFSF, the point
source, electric Drude J, magnetic Drude K, compensated float32,
material coefficient grids, PEC walls, unsharded; the sharded packed
and two-pass steps above. Everything else raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from fdtd3d_torch import materials, physics
from fdtd3d_torch.config import SimConfig
from fdtd3d_torch.layout import CURL_TERMS, component_axis
from fdtd3d_torch.ops import cpml, ds, tfsf
from fdtd3d_torch.ops.sources import DsSourceTable, point_mask, waveform
from fdtd3d_torch.ops.stencil import make_diff_ops

AXES = "xyz"


@dataclasses.dataclass(frozen=True)
class StaticSetup:
    """Everything fixed for a run: read by the step functions."""

    cfg: SimConfig
    mode: Any
    grid_shape: Tuple[int, int, int]
    dt: float
    dx: float
    omega: float
    pml_axes: Tuple[int, ...]        # active axes with a PML slab
    tfsf_setup: Optional[tfsf.TfsfSetup]
    use_drude: bool
    field_dtype: Any                 # torch dtype of E/H (the Kahan
                                     # residuals rE/rH are bf16 always)
    real_dtype: Any                  # numpy dtype of the coefficients
    use_drude_m: bool = False
    topology: Tuple[int, int, int] = (1, 1, 1)
    # complex fields as two real legs (_make_paired_complex_step)
    paired_complex: bool = False

    @property
    def aux_dtype(self):
        """torch dtype of the recursion state (CPML psi, Drude J, the
        incident line): float32 when the fields are bf16 storage, else
        the field dtype (the reference's ``StaticSetup.aux_dtype``)."""
        return torch.float32 if self.field_dtype == torch.bfloat16 \
            else self.field_dtype

    @property
    def compute_dtype(self):
        """torch dtype the update arithmetic runs in: the recursion
        state's, so bf16 storage computes in float32."""
        return self.aux_dtype


def slab_axes(static: StaticSetup) -> Dict[int, int]:
    """axis -> planes per side of the compact slab psi storage.

    CPML psi is identically zero outside the two absorbing slabs of its
    own axis, so psi keeps only the boundary planes (lo slab ++ hi
    slab). One extra plane per side: the h-staggered hi-side profile is
    nonzero at index n-1-npml (ops/cpml.py), so exact parity with full
    storage needs npml+1 planes per side.
    """
    out: Dict[int, int] = {}
    for a in static.pml_axes:
        npml = static.cfg.pml.size[a]
        m = npml + 1
        local_n = static.grid_shape[a] // static.topology[a]
        if npml > 0 and local_n > 2 * m:
            out[a] = m
    return out


def _out_of_scope(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to fdtd3d_torch yet (ROADMAP.md queue "
        f"{item}); run it with the reference package fdtd3d_tpu")


def check_scope(cfg: SimConfig, topology=(1, 1, 1)) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item, for every
    configuration this slice of the port does not run. On a sharded
    ``topology`` the port runs the sharded packed and two-pass steps
    only (3D: float32 or bf16 storage, compensated mode where the packed
    kernel takes it, and float32x2 on the sharded packed-ds step;
    ``sharded_scope``); what the reference runs sharded otherwise waits
    for its item."""
    if cfg.output.checkpoint_backend == "orbax":
        _out_of_scope("the orbax checkpoint backend", "A11(b)")
    if max(topology) == 1:
        return
    where = f"on the sharded topology {tuple(topology)}"
    if cfg.mode.name != "3D":
        _out_of_scope(f"the {cfg.mode.name} mode {where} (the sharded "
                      f"plain step)", "A11(b)")
    if cfg.dtype == "float64":
        _out_of_scope(f"float64 {where} (the sharded plain step)",
                      "A11(b)")
    if cfg.ntff.enabled:
        _out_of_scope(f"the far-field transform {where}", "A11(b)")
    if cfg.use_pallas is False:
        _out_of_scope(f"the plain step {where}", "A11(b)")


def sharded_scope(static: "StaticSetup") -> None:
    """What a sharded topology runs, mirroring the reference's dispatch
    under a mesh: the sharded packed step (its ``pallas_packed.eligible``,
    pallas_packed.py:219-248: slab psi on each shard, the sources inside
    the CPML identity region, ``sources_interior``), and where that
    declines (``sharded_two_pass_reason``: a y or z shard too thin for
    slab psi, a source inside the absorber, ``FDTD3D_NO_PACKED`` or
    ``FDTD3D_FORCE_FUSED``) the sharded two-pass step, whose scope is
    the reference's ``pallas3d.eligible`` (:86-106, not compensated) with
    its slab-psi check on x (:1095-1098). float32x2 takes the sharded
    packed-ds step, whose scope is the reference's
    ``pallas_packed_ds.eligible`` under a mesh (:116-130) with its
    slab-psi check (:199-202): slab psi on each shard, no
    ``FDTD3D_NO_PACKED``, and nothing else (its records carry the
    sources on any shard). Raise NotImplementedError naming the item of
    what falls outside: the reference runs it on its jnp (or jnp-ds)
    step, the sharded plain step of A11(b)."""
    import os
    where = f"on the sharded topology {tuple(static.topology)}"
    thin = sorted(set(static.pml_axes) - set(slab_axes(static)))
    thin_s = ", ".join(AXES[a] for a in thin)
    if static.cfg.ds_fields:
        if thin:
            _out_of_scope(
                f"float32x2 on a shard too thin for slab CPML psi on axis "
                f"{thin_s} ({where}: the local extent must exceed 2 (pml "
                f"+ 1) planes; the reference runs it on its jnp-ds step, "
                f"the sharded plain ds step)", "A11(b)")
        if os.environ.get("FDTD3D_NO_PACKED"):
            _out_of_scope(
                f"float32x2 under FDTD3D_NO_PACKED {where} (the reference "
                f"runs it on its jnp-ds step, the sharded plain ds step)",
                "A11(b)")
        return
    if 0 in thin:
        _out_of_scope(
            f"a shard too thin for slab CPML psi on axis x ({where}: the "
            f"local extent must exceed 2 (pml + 1) planes; the reference "
            f"runs it on its jnp step, the sharded plain step)", "A11(b)")
    from fdtd3d_torch.ops import packed
    if static.cfg.compensated and (
            sharded_two_pass_reason(static) is not None
            or packed.declines(static)):
        # the reference's two-pass kernels decline compensated mode
        _out_of_scope(
            f"compensated mode {where} where the sharded packed kernel "
            f"declines it (a shard too thin for slab psi, a source inside "
            f"the absorber, coefficient grids or magnetic Drude K, or the "
            f"ladder variables; the reference runs it on its jnp step, "
            f"the sharded plain step)", "A11(b)")


def sharded_two_pass_reason(static: "StaticSetup",
                            allow_multistep: bool = True) -> Optional[str]:
    """Where the reference's dispatch lands a sharded float32 or bf16
    run on its two-pass kernels (its ``pallas`` kind), the
    ``tb_fallback`` token it records there; None where it runs the
    sharded packed step. The two-pass kernels take the run when the
    packed kernel declines a source inside the absorber
    (``sources_interior``, token ``packed_ineligible``), when
    ``FDTD3D_NO_PACKED`` or ``FDTD3D_FORCE_FUSED`` skips packed (its
    fused kernel is unsharded only), or when a y or z shard is too thin
    for slab psi (``thin_grid_psi``); the token is the reference's
    ``tb_fallback_reason`` for such a run, in its order
    (fdtd3d_tpu/solver.py:530-570: the tb pass's scope token
    ``magnetic_drude`` first, then the dispatch context, then
    ``thin_grid_psi``)."""
    import os
    env = {k: bool(os.environ.get(k)) for k in (
        "FDTD3D_NO_TEMPORAL", "FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED")}
    src = (static.tfsf_setup is not None
           or static.cfg.point_source.enabled) \
        and not sources_interior(static)
    thin = set(static.pml_axes) != set(slab_axes(static))
    if not (src or thin or env["FDTD3D_NO_PACKED"]
            or env["FDTD3D_FORCE_FUSED"]):
        return None
    if src:
        return "packed_ineligible"
    if static.use_drude_m:
        return "magnetic_drude"
    if not allow_multistep:
        return "single_step_contract"
    for name in env:
        if env[name]:
            return f"env:{name}"
    return "thin_grid_psi"


def sources_interior(static: "StaticSetup") -> bool:
    """True iff every TFSF E-correction plane and the point source sit,
    with a one-plane guard, strictly inside the region where both CPML
    profile sets are identity (planes [npml, n-2-npml]): the reference's
    ``pallas_packed._sources_interior`` (:179), the scope of its sharded
    packed step."""
    lo = [None, None, None]
    hi = [None, None, None]

    def grow(a, v):
        lo[a] = v if lo[a] is None else min(lo[a], v)
        hi[a] = v if hi[a] is None else max(hi[a], v)

    setup = static.tfsf_setup
    if setup is not None:
        for corr in setup.corrections:
            if corr.field != "E":
                continue
            grow(corr.axis, corr.plane)
            for b in range(3):
                if b != corr.axis and b in static.mode.active_axes:
                    grow(b, setup.lo[b])
                    grow(b, setup.hi[b])
    if static.cfg.point_source.enabled:
        for a in range(3):
            grow(a, static.cfg.point_source.position[a])
    for a in static.mode.active_axes:
        if lo[a] is None:
            continue
        npml = static.cfg.pml.size[a] if a in static.pml_axes else 0
        n = static.grid_shape[a]
        if lo[a] - 1 < npml or hi[a] + 1 > n - 2 - npml:
            return False
    return True


def shard_static(static: "StaticSetup", mesh) -> "StaticSetup":
    """The static setup of one shard of ``mesh``: the local grid shape,
    unsharded (``slab_axes`` gives the same slabs: the same local
    extent), the global TFSF geometry and configuration kept (the
    patches place the global faces by each shard's offset)."""
    return dataclasses.replace(static, grid_shape=tuple(mesh.local_shape),
                               topology=(1, 1, 1))


def paired_complex_wanted(cfg: SimConfig, device=None) -> bool:
    """Whether a complex run takes the paired-real route: on a CUDA
    device, as the reference takes it on its TPU, or anywhere under the
    reference's test hook ``FDTD3D_FORCE_PAIRED_COMPLEX``; otherwise the
    plain step runs in native complex arithmetic."""
    import os
    if not cfg.complex_fields:
        return False
    if os.environ.get("FDTD3D_FORCE_PAIRED_COMPLEX"):
        return True
    return device is not None and torch.device(device).type == "cuda"


def config_topology(cfg: SimConfig, n_devices=None) -> Tuple[int, int, int]:
    """The topology ``cfg`` asks for (``parallel.mesh.resolve_topology``):
    a manual topology as it stands, "auto" over ``n_devices`` (or the
    config's ``n_devices``), unsharded when "auto" has no count."""
    from fdtd3d_torch.parallel.mesh import resolve_topology
    par = cfg.parallel
    if par.topology == "auto" and not (par.n_devices or n_devices):
        return (1, 1, 1)
    return resolve_topology(par, cfg.grid_shape, cfg.mode.active_axes,
                            n_devices=n_devices)


def build_static(cfg: SimConfig, device=None,
                 topology=None) -> StaticSetup:
    """The static setup of ``cfg`` for a run on ``device`` (which
    decides the complex route; None: not on a CUDA device) over
    ``topology`` (None: ``config_topology(cfg)``)."""
    cfg.validate()
    topo = tuple(topology) if topology is not None \
        else config_topology(cfg)
    check_scope(cfg, topo)
    mode = cfg.mode
    pml_axes = tuple(a for a in mode.active_axes if cfg.pml.size[a] > 0)
    st = StaticSetup(
        cfg=cfg, mode=mode, grid_shape=cfg.grid_shape, dt=cfg.dt,
        dx=cfg.dx, omega=cfg.omega, pml_axes=pml_axes, tfsf_setup=None,
        use_drude=cfg.materials.use_drude,
        field_dtype=cfg.torch_dtype(),
        real_dtype=np.float64 if cfg.dtype == "float64" else np.float32,
        use_drude_m=cfg.materials.use_drude_m, topology=topo,
        paired_complex=paired_complex_wanted(cfg, device))
    if cfg.tfsf.enabled:
        st = dataclasses.replace(st, tfsf_setup=tfsf.build_setup(cfg, st))
    if max(topo) > 1:
        if cfg.complex_fields:
            _sharded_complex(st)
        sharded_scope(st)
    return st


def _sharded_complex(static: StaticSetup) -> None:
    """Complex fields on a sharded topology: the paired-real route
    raises as the reference's does (solver.py:1218-1224); the native
    complex route is the sharded plain step (A11(b))."""
    if static.paired_complex:
        raise ValueError(
            "complex fields on the paired-real route cannot run on a "
            "sharded topology (the reference's rule: its complex<->paired "
            "conversion cannot run inside shard_map). Run complex sharded "
            "on the native complex route, or run real-dtype sharded; see "
            "solver._make_paired_complex_step.")
    _out_of_scope(f"native complex fields on the sharded topology "
                  f"{tuple(static.topology)} (the sharded plain step)",
                  "A11(b)")


# --------------------------------------------------------------------------
# coefficients (host-built numpy, as in the reference)
# --------------------------------------------------------------------------

def build_coeffs(static: StaticSetup) -> Dict[str, Any]:
    """The reference's coefficient dict, key for key and bit for bit
    (``fdtd3d_tpu/solver.py::build_coeffs``): numpy arrays and scalars
    of the real dtype, with the double-single low words (``*_lo``) of
    the float32x2 mode."""
    cfg, mode = static.cfg, static.mode
    shape = static.grid_shape
    dt, rd = static.dt, static.real_dtype
    mat = cfg.materials
    out: Dict[str, Any] = {}

    for a in range(3):
        out[f"g{AXES[a]}"] = np.arange(shape[a], dtype=np.int32)
        wall = np.ones(shape[a], dtype=rd)
        if a in mode.active_axes:
            wall[0] = 0.0
            wall[-1] = 0.0
        out[f"wall_{AXES[a]}"] = wall

    def _cast(v):
        return rd(v) if np.isscalar(v) else v.astype(rd)

    # Without a material file, each medium is uniform inside and outside
    # its sphere and the Drude plasma's: the formulas below then run on
    # one f64 value per label of ``materials.sphere_labels`` (bit 0 the
    # medium's sphere, bit 1 the plasma's) and ``_grid`` gathers the
    # stored values at the cells. f64 arithmetic is elementwise, so each
    # cell gets the bits the formulas give on full grids, which a
    # material file still takes.
    label = None

    def _grid(v):
        if isinstance(v, np.ndarray) and v.ndim == 1:
            return materials.label_grid(v, label)
        return v

    def _medium(c, base, sphere, file_path, drude, magnetic):
        """(medium, plasma frequency, gamma) of component c, the plasma's
        None without ``drude``; sets the labels their tables are on."""
        nonlocal label
        if file_path:
            label = None
            med = materials.scalar_or_grid(c, shape, mode.active_axes, base,
                                           sphere, file_path)
            if not drude:
                return med, None, None
            wp, g, _ = materials.drude_params(c, shape, mode.active_axes,
                                              mat, magnetic=magnetic)
            return med, wp, g
        plasma = mat.drude_m_sphere if magnetic else mat.drude_sphere
        plasma = plasma if drude else None
        label = materials.sphere_labels(c, shape, mode.active_axes,
                                        (sphere, plasma))
        med = (materials.sphere_table(0, 2, sphere.value, base)
               if materials.sphere_enabled(sphere) else float(base))
        if not drude:
            return med, None, None
        wp0 = mat.omega_pm if magnetic else mat.omega_p
        wp = (materials.sphere_table(1, 2, wp0, 0.0)
              if materials.sphere_enabled(plasma) else float(wp0))
        return med, wp, float(mat.gamma_m if magnetic else mat.gamma)

    def _cast_ds(key, v):
        """Store coefficient ``key``; in compensated and float32x2 modes
        also its double-single low word ``key_lo`` = f32(v64 - f32(v64)):
        an f32 ca/cb/da/db alone perturbs the discrete system by ~eps32,
        a drift from f64 that grows linearly in t."""
        hi = _cast(v)
        out[key] = _grid(hi)
        if cfg.compensated or cfg.ds_fields:
            v64 = np.asarray(v, np.float64)
            out[f"{key}_lo"] = _grid(_cast(v64 - np.asarray(hi,
                                                            np.float64)))

    for c in mode.e_components:
        eps, wp, gamma = _medium(c, mat.eps, mat.eps_sphere, mat.eps_file,
                                 static.use_drude, False)
        if static.use_drude:
            eps = materials.merge_drude_eps(eps, wp, mat.eps_inf)
            out[f"kj_{c}"] = _cast((1.0 - gamma * dt / 2.0)
                                   / (1.0 + gamma * dt / 2.0))
            out[f"bj_{c}"] = _grid(_cast(physics.EPS0 * np.square(wp) * dt
                                         / (1.0 + gamma * dt / 2.0)))
        se = mat.sigma_e * dt / (2.0 * physics.EPS0 * np.asarray(eps))
        _cast_ds(f"ca_{c}", (1.0 - se) / (1.0 + se))
        _cast_ds(f"cb_{c}", dt / (physics.EPS0 * np.asarray(eps))
                 / (1.0 + se))

    for c in mode.h_components:
        mu, wpm, gm = _medium(c, mat.mu, mat.mu_sphere, mat.mu_file,
                              static.use_drude_m, True)
        if static.use_drude_m:
            # magnetic Drude (metamaterial) K: the dual of J
            mu = materials.merge_drude_eps(mu, wpm, mat.mu_inf)
            out[f"km_{c}"] = _cast((1.0 - gm * dt / 2.0)
                                   / (1.0 + gm * dt / 2.0))
            out[f"bm_{c}"] = _grid(_cast(physics.MU0 * np.square(wpm) * dt
                                         / (1.0 + gm * dt / 2.0)))
        sm = mat.sigma_m * dt / (2.0 * physics.MU0 * np.asarray(mu))
        _cast_ds(f"da_{c}", (1.0 - sm) / (1.0 + sm))
        _cast_ds(f"db_{c}", dt / (physics.MU0 * np.asarray(mu))
                 / (1.0 + sm))

    if static.pml_axes and cfg.ds_fields:
        # double-single CPML profiles: the slab algebra runs in ds (f32
        # profiles inject eps32 noise at the absorbing interface, which
        # reflects back coherently); the low word's key keeps the axis
        # suffix last: pml_{b,c,ik}{e,h}lo_{x,y,z}
        full64 = cpml.build_cpml_coeffs(cfg, static, np.float64)
        slab64 = cpml.build_slab_coeffs(full64, static, slab_axes(static))
        for src64 in (full64, slab64):
            for k, v in src64.items():
                hi, lo = ds.from_f64(v)
                base, ax = k.rsplit("_", 1)
                out[k] = hi
                out[f"{base}lo_{ax}"] = lo
    elif static.pml_axes:
        full = cpml.build_cpml_coeffs(cfg, static, rd)
        out.update(full)
        out.update(cpml.build_slab_coeffs(full, static, slab_axes(static)))

    if cfg.point_source.enabled:
        out["ps_amp"] = rd(cfg.point_source.amplitude)

    if static.tfsf_setup is not None and cfg.ds_fields:
        # double-single line coefficients: the line's own f32 rounding
        # would bring back the linear-in-t drift the mode removes
        prof64 = tfsf.line_loss_profiles(static.tfsf_setup.n_inc, dt,
                                         static.dx, np.float64)
        for k, v in zip(("inc_ae", "inc_be", "inc_ah", "inc_bh"), prof64):
            out[k], out[f"{k}_lo"] = ds.from_f64(v)
    elif static.tfsf_setup is not None:
        ae, be, ah, bh = tfsf.line_loss_profiles(
            static.tfsf_setup.n_inc, dt, static.dx, rd)
        out.update(inc_ae=ae, inc_be=be, inc_ah=ah, inc_bh=bh)
    return out


def has_coeff_grids(static: StaticSetup) -> bool:
    """Whether ``build_coeffs`` makes any material coefficient a 3D grid
    (ca/cb/kj/bj, da/db/km/bm), decided from the configuration alone: a
    material file or an enabled sphere of eps or mu, or a Drude sphere
    of J or K (the plasma confined to it makes its coefficients and the
    merged eps or mu grids)."""
    mat = static.cfg.materials

    def sphere(sp):
        return sp is not None and sp.enabled and sp.radius > 0
    return bool(mat.eps_file or mat.mu_file or sphere(mat.eps_sphere)
                or sphere(mat.mu_sphere)
                or (static.use_drude and sphere(mat.drude_sphere))
                or (static.use_drude_m and sphere(mat.drude_m_sphere)))


def coeffs_to_device(np_coeffs: Dict[str, Any],
                     device) -> Dict[str, Any]:
    """Arrays become tensors on ``device``; scalars stay host floats
    (their f32 values), as the reference bakes them into the graph."""
    out: Dict[str, Any] = {}
    for k, v in np_coeffs.items():
        if np.ndim(v) == 0:
            out[k] = float(v)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def init_state(static: StaticSetup, device) -> Dict[str, Any]:
    """Zero dict-form state on ``device`` (the reference's layout): E
    and H in the field dtype, psi, J, K and the incident line in the
    recursion state's (``aux_dtype``), the Kahan residuals ``rE``/``rH``
    of compensated mode in bf16 (the reference's choice: ~8 of the bits
    the f32 add drops, at a quarter of an f32 residual's traffic)."""
    shape, fd = static.grid_shape, static.field_dtype
    mode = static.mode
    slabs = slab_axes(static)

    def zeros(s=shape, dtype=static.aux_dtype):
        return torch.zeros(s, dtype=dtype, device=device)

    def psi_zeros(a: int):
        """psi_{c,a} storage: slab-compacted along its own axis a."""
        s = list(shape)
        if a in slabs:
            s[a] = 2 * slabs[a] * static.topology[a]
        return zeros(tuple(s))

    state: Dict[str, Any] = {
        "E": {c: zeros(dtype=fd) for c in mode.e_components},
        "H": {c: zeros(dtype=fd) for c in mode.h_components},
        "t": 0,
    }
    psi_e, psi_h = {}, {}
    for c in mode.e_components:
        for (a, _d, _s) in CURL_TERMS[component_axis(c)]:
            if a in static.pml_axes:
                psi_e[f"{c}_{AXES[a]}"] = psi_zeros(a)
    for c in mode.h_components:
        for (a, _d, _s) in CURL_TERMS[component_axis(c)]:
            if a in static.pml_axes:
                psi_h[f"{c}_{AXES[a]}"] = psi_zeros(a)
    ds_fields = static.cfg.ds_fields
    # the low words are real float32 even with complex fields, as the
    # reference's init_state makes them (a paired run joins them into
    # complex with the rest of the state once it has stepped)
    f32 = torch.float32
    if psi_e:
        state["psi_E"] = psi_e
        state["psi_H"] = psi_h
        if ds_fields:
            # the psi recursions run in ds too (build_coeffs)
            state["lopsi_E"] = {k: zeros(v.shape, f32)
                                for k, v in psi_e.items()}
            state["lopsi_H"] = {k: zeros(v.shape, f32)
                                for k, v in psi_h.items()}
    if static.use_drude:
        state["J"] = {c: zeros() for c in mode.e_components}
    if static.use_drude_m:
        state["K"] = {c: zeros() for c in mode.h_components}
    if static.cfg.compensated:
        state["rE"] = {c: zeros(dtype=torch.bfloat16)
                       for c in mode.e_components}
        state["rH"] = {c: zeros(dtype=torch.bfloat16)
                       for c in mode.h_components}
    if ds_fields:
        # double-single low words: E/H carried as hi+lo f32 pairs
        state["loE"] = {c: zeros(dtype=f32) for c in mode.e_components}
        state["loH"] = {c: zeros(dtype=f32) for c in mode.h_components}
    if static.tfsf_setup is not None:
        n = static.tfsf_setup.n_inc
        state["inc"] = {"Einc": zeros((n,)), "Hinc": zeros((n,))}
        if ds_fields:
            state["inc"]["Einc_lo"] = zeros((n,), f32)
            state["inc"]["Hinc_lo"] = zeros((n,), f32)
    return state


# --------------------------------------------------------------------------
# the plain step (the reference's jnp branch, in torch)
# --------------------------------------------------------------------------

def _bcast1d(arr: torch.Tensor, axis: int) -> torch.Tensor:
    shape = [1, 1, 1]
    shape[axis] = arr.shape[0]
    return arr.reshape(shape)


def _slab_delta(a, s, dfa, psi, prof, m):
    """Slab-psi CPML correction: -> (new compact psi, lo delta, hi delta).

    ``prof`` = (b, c, 1/kappa) slab profiles of length 2m along axis a.
    The exact CPML term differs from the pure curl only inside the two
    m-plane slabs of axis a, by s * ((ik - 1) * dfa + psi_new).
    """
    nloc = dfa.shape[a]

    def cut(f, lo, hi):
        return f.narrow(a, lo, hi - lo)

    b, cc, ik = (_bcast1d(v, a) for v in prof)
    d_lo, d_hi = cut(dfa, 0, m), cut(dfa, nloc - m, nloc)
    p_lo = cut(b, 0, m) * cut(psi, 0, m) + cut(cc, 0, m) * d_lo
    p_hi = cut(b, m, 2 * m) * cut(psi, m, 2 * m) + cut(cc, m, 2 * m) * d_hi
    dl = s * ((cut(ik, 0, m) - 1.0) * d_lo + p_lo)
    dh = s * ((cut(ik, m, 2 * m) - 1.0) * d_hi + p_hi)
    return torch.cat([p_lo, p_hi], dim=a), dl, dh


def _pad_slab(dl, dh, a, nloc, m):
    """The two slab deltas placed back at the full local extent (zeros
    between them; the slabs are disjoint since nloc > 2m)."""
    shape = list(dl.shape)
    shape[a] = nloc
    out = torch.zeros(shape, dtype=dl.dtype, device=dl.device)
    out.narrow(a, 0, m).copy_(dl)
    out.narrow(a, nloc - m, m).copy_(dh)
    return out


def _slab_fix(a, s, dfa, psi, prof, m):
    """``_slab_delta`` with its deltas placed at the full extent of axis
    a: -> (new compact psi, the accumulator's slab correction)."""
    psi, dl, dh = _slab_delta(a, s, dfa, psi, prof, m)
    return psi, _pad_slab(dl, dh, a, dfa.shape[a], m)


def inv_dx_pair(dx: float) -> Tuple[float, float]:
    """1/dx as a double-single pair of f32 values (hi, lo), as host
    floats: compensated mode scales every difference by both
    (``d0 * hi + d0 * lo``), since the f32 rounding of 1/dx alone
    perturbs the discrete system as an f32 ca/cb would."""
    inv = 1.0 / dx
    hi = np.float32(inv)
    return float(hi), float(np.float32(inv - np.float64(hi)))


def minus_one(v):
    """``v - 1`` of an f32 coefficient, rounded to f32 as the reference
    computes it on its f32 value (a host float stays a host float)."""
    if isinstance(v, torch.Tensor):
        return v - 1.0
    return float(np.float32(v) - np.float32(1.0))


def kahan_update(old, acc, a, b, a_lo, b_lo, r_old, backward: bool):
    """One compensated (Kahan) update: new = old + u with ``u = (a - 1)
    old + b acc + (a_lo old + b_lo acc)`` (E, ``backward``: ca, cb; H:
    da, db and ``-`` before each b term), fed back the stored residual
    ``r_old`` (bf16) of the previous add. Returns (new value, new
    residual in f32), before the walls: the reference's
    solver.py:855-881 and :909-920, operation for operation, as the
    plain step and the packed kernel's plain version compute it."""
    if backward:
        u = minus_one(a) * old + b * acc + (a_lo * old + b_lo * acc)
    else:
        u = minus_one(a) * old - b * acc + (a_lo * old - b_lo * acc)
    y = u - r_old.to(u.dtype)
    new = old + y
    return new, (new - old) - y


def make_plain_step(static: StaticSetup):
    """The reference's jnp leapfrog step (solver.py, f32, bf16 and f64
    branches, compensated mode and magnetic Drude K included) in torch,
    on dict-form state. Returns a new state dict.

    bf16 storage: every field operand is widened to float32 before it
    meets an operation (torch keeps ``float * bf16`` and ``bf16 - bf16``
    in bf16), and E and H are rounded to bf16 where they are stored, so
    the H update reads the stored E, as in the reference.

    Compensated mode, in the reference's order of operations (torch
    reassociates no more than XLA does): every difference scaled by the
    double-single 1/dx (``d0 * iv_hi + d0 * iv_lo``); the update
    ``u = (a - 1) old +- b acc + (a_lo old +- b_lo acc)``,
    ``y = u - r``, ``new = old + y`` and the new residual
    ``(new - old) - y``, stored in bf16; the PEC walls zero the residual
    with the field. K (magnetic Drude): ``K' = km K + bm H`` enters H's
    accumulator with the sign opposite to J's on E (``acc + K'``)."""
    mode, cfg = static.mode, static.cfg
    cdt = static.compute_dtype
    diff_b, diff_f = make_diff_ops()
    rd = static.real_dtype
    inv_dx = float(rd(1.0 / static.dx))
    compensated = cfg.compensated
    iv_hi, iv_lo = inv_dx_pair(static.dx)
    setup = static.tfsf_setup
    ps = cfg.point_source
    slabs = slab_axes(static)

    def _half_update(field: str, state, coeffs, new_psi):
        """One family's curl accumulators (field='E' or 'H')."""
        upd_comps = mode.e_components if field == "E" else mode.h_components
        src = state["H"] if field == "E" else state["E"]
        src = {k: v.to(cdt) for k, v in src.items()}
        tag = "e" if field == "E" else "h"
        diff = diff_b if field == "E" else diff_f
        psi_key = "psi_E" if field == "E" else "psi_H"
        out = {}
        for c in upd_comps:
            acc = None
            for (a, d_axis, s) in CURL_TERMS[component_axis(c)]:
                d = ("H" if field == "E" else "E") + AXES[d_axis]
                if d not in src:
                    continue
                if compensated:
                    d0 = diff(src[d], a)
                    dfa = d0 * iv_hi + d0 * iv_lo
                else:
                    dfa = diff(src[d], a) * inv_dx
                if a in slabs:
                    key = f"{c}_{AXES[a]}"
                    prof = tuple(coeffs[f"pml_slab_{v}{tag}_{AXES[a]}"]
                                 for v in ("b", "c", "ik"))
                    psi, acc_fix = _slab_fix(a, s, dfa,
                                             state[psi_key][key], prof,
                                             slabs[a])
                    new_psi[psi_key][key] = psi
                    acc = acc_fix if acc is None else acc + acc_fix
                    term = dfa
                elif a in static.pml_axes:
                    ax = AXES[a]
                    b = _bcast1d(coeffs[f"pml_b{tag}_{ax}"], a)
                    cc = _bcast1d(coeffs[f"pml_c{tag}_{ax}"], a)
                    ik = _bcast1d(coeffs[f"pml_ik{tag}_{ax}"], a)
                    key = f"{c}_{ax}"
                    psi = b * state[psi_key][key] + cc * dfa
                    new_psi[psi_key][key] = psi
                    term = ik * dfa + psi
                else:
                    term = dfa
                acc = s * term if acc is None else acc + s * term
            if acc is None:
                acc = torch.zeros_like(state[field][c], dtype=cdt)
            if setup is not None:
                corr = tfsf.corrections_for(field, c, setup, coeffs,
                                            state["inc"], mode.active_axes,
                                            static.dx)
                if corr is not None:
                    acc = acc + corr
            out[c] = acc
        return out

    def step(state, coeffs):
        t = state["t"]
        new_state = dict(state)
        new_psi = {"psi_E": dict(state.get("psi_E", {})),
                   "psi_H": dict(state.get("psi_H", {}))}

        # 1. incident line E advance (Einc -> t^{n+1})
        if setup is not None:
            new_state["inc"] = tfsf.advance_einc(
                state["inc"], coeffs, t, static.dt, static.omega, setup)
            state = dict(state, inc=new_state["inc"])

        # 2. E family
        new_E, new_J, new_rE = {}, {}, {}
        acc_e = _half_update("E", state, coeffs, new_psi)
        for c in mode.e_components:
            acc = acc_e[c]
            old = state["E"][c].to(cdt)
            if static.use_drude:
                j_new = coeffs[f"kj_{c}"] * state["J"][c] \
                    + coeffs[f"bj_{c}"] * old
                new_J[c] = j_new
                acc = acc - j_new
            if ps.enabled and ps.component == c:
                mask = point_mask(coeffs["gx"], coeffs["gy"], coeffs["gz"],
                                  ps.position, mode.active_axes)
                wf = waveform(ps.waveform, t, 0.5, static.omega,
                              static.dt, static.real_dtype)
                amp = float(rd(coeffs["ps_amp"]) * wf)
                acc = acc + amp * mask.to(acc.dtype)
            if compensated:
                e, r = kahan_update(
                    old, acc, coeffs[f"ca_{c}"], coeffs[f"cb_{c}"],
                    coeffs[f"ca_{c}_lo"], coeffs[f"cb_{c}_lo"],
                    state["rE"][c], True)
            else:
                e = coeffs[f"ca_{c}"] * old + coeffs[f"cb_{c}"] * acc
            # PEC walls: zero tangential E on transverse-axis walls.
            for a in mode.active_axes:
                if a != component_axis(c):
                    w = _bcast1d(coeffs[f"wall_{AXES[a]}"], a)
                    e = e * w
                    if compensated:
                        r = r * w
            new_E[c] = e.to(static.field_dtype)
            if compensated:
                new_rE[c] = r.to(torch.bfloat16)
        new_state["E"] = new_E
        if compensated:
            new_state["rE"] = new_rE
        if static.use_drude:
            new_state["J"] = new_J
        state = dict(state, E=new_E)

        # 3. incident line H advance (Hinc -> t^{n+3/2})
        if setup is not None:
            new_state["inc"] = tfsf.advance_hinc(new_state["inc"], coeffs,
                                                 setup)
            state = dict(state, inc=new_state["inc"])

        # 4. H family (the dual of 2: mu0 mu dH/dt = -curl E - K)
        new_H, new_K, new_rH = {}, {}, {}
        acc_h = _half_update("H", state, coeffs, new_psi)
        for c in mode.h_components:
            acc = acc_h[c]
            old = state["H"][c].to(cdt)
            if static.use_drude_m:
                k_new = coeffs[f"km_{c}"] * state["K"][c] \
                    + coeffs[f"bm_{c}"] * old
                new_K[c] = k_new
                acc = acc + k_new
            if compensated:
                h, r = kahan_update(
                    old, acc, coeffs[f"da_{c}"], coeffs[f"db_{c}"],
                    coeffs[f"da_{c}_lo"], coeffs[f"db_{c}_lo"],
                    state["rH"][c], False)
                new_rH[c] = r.to(torch.bfloat16)
            else:
                h = coeffs[f"da_{c}"] * old - coeffs[f"db_{c}"] * acc
            new_H[c] = h.to(static.field_dtype)
        new_state["H"] = new_H
        if compensated:
            new_state["rH"] = new_rH
        if static.use_drude_m:
            new_state["K"] = new_K

        if new_psi["psi_E"]:
            new_state["psi_E"] = new_psi["psi_E"]
            new_state["psi_H"] = new_psi["psi_H"]
        new_state["t"] = t + 1
        return new_state

    step.kind = "plain"
    return step


def _shift(f: torch.Tensor, a: int, backward: bool) -> torch.Tensor:
    """f[i-1] (backward) or f[i+1] along axis a, zero ghost (PEC)."""
    n = f.shape[a]
    out = torch.zeros_like(f)
    if backward:
        out.narrow(a, 1, n - 1).copy_(f.narrow(a, 0, n - 1))
    else:
        out.narrow(a, 0, n - 1).copy_(f.narrow(a, 1, n - 1))
    return out


def ds_diff(fp, sp, iv) -> ds.Pair:
    """(f - s) * (1/dx), all pairs, with an error-free difference: the
    one EFT sequence of every curl term (plain and packed ds steps)."""
    dh, de = ds.two_diff(fp[0], sp[0])
    dl = fp[1] - sp[1]
    dh, dl = ds.two_sum(dh, de + dl)
    return ds.mul_ff(dh, dl, *iv)


def coef_pair(coeffs, key: str, like: torch.Tensor) -> ds.Pair:
    """Coefficient ``key`` and its ``key_lo`` as float32 tensors: a
    scalar (a host float in the device coefficients) becomes a 0-d
    tensor, so the ds products split it in f32."""
    return ds.as_f32(coeffs[key], like), ds.as_f32(coeffs[f"{key}_lo"],
                                                   like)


def make_plain_ds_step(static: StaticSetup):
    """The reference's double-single leapfrog step
    (``solver._make_ds_step``, kind ``jnp_ds``) in torch, on dict-form
    state: E/H, the psi recursions and the incident line as hi+lo f32
    pairs (``loE``/``loH``/``lopsi_*``/``inc/*_lo``), every difference,
    product and sum an error-free-transform sequence (ops/ds.py).

    Deliberately plain f32, as in the reference: the Drude J and
    magnetic Drude K currents (each ``k' = k_c k + b_c f`` on the hi word
    of the old field, added to the accumulator pair by ``add_f`` after
    the TFSF corrections), the Gaussian envelope of a pulse, and the
    geometry of the interpolation. Kind ``plain_ds``."""
    mode, cfg = static.mode, static.cfg
    setup = static.tfsf_setup
    ps = cfg.point_source
    slabs = slab_axes(static)
    line_src = tfsf.line_source(setup, static.omega, static.dt) \
        if setup is not None else None
    point_src = DsSourceTable(ps.waveform, 0.5, static.omega, static.dt,
                              ps.amplitude) if ps.enabled else None

    def slab_delta_ds(a, tag, s, dfa, psi, coeffs, m):
        """The slab CPML correction in ds: -> (psi pair, lo/hi deltas)."""
        ax = AXES[a]

        def prof(name):
            return (_bcast1d(coeffs[f"pml_slab_{name}{tag}_{ax}"], a),
                    _bcast1d(coeffs[f"pml_slab_{name}{tag}lo_{ax}"], a))

        def cut(f, lo, hi):
            return f.narrow(a, lo, hi - lo)

        (bh, bl), (ch, cl), (ikh, ikl) = prof("b"), prof("c"), prof("ik")
        nloc = dfa[0].shape[a]
        minus_one = ds.f32(-1.0, dfa[0])

        def side(d0, d1, p0, p1):
            d_pair = (cut(dfa[0], d0, d1), cut(dfa[1], d0, d1))
            p_pair = (cut(psi[0], p0, p1), cut(psi[1], p0, p1))
            p_new = ds.add_ff(
                *ds.mul_ff(cut(bh, p0, p1), cut(bl, p0, p1), *p_pair),
                *ds.mul_ff(cut(ch, p0, p1), cut(cl, p0, p1), *d_pair))
            ikm1 = ds.add_f(cut(ikh, p0, p1), cut(ikl, p0, p1), minus_one)
            delta = ds.add_ff(*ds.mul_ff(*ikm1, *d_pair), *p_new)
            if s < 0:
                delta = ds.neg(*delta)
            return p_new, delta

        pn_lo, delta_lo = side(0, m, 0, m)
        pn_hi, delta_hi = side(nloc - m, nloc, m, 2 * m)
        psi_new = (torch.cat([pn_lo[0], pn_hi[0]], dim=a),
                   torch.cat([pn_lo[1], pn_hi[1]], dim=a))
        return psi_new, delta_lo, delta_hi

    def _half_update(field, state, coeffs, new_psi):
        upd = mode.e_components if field == "E" else mode.h_components
        other = "H" if field == "E" else "E"
        srch, srcl = state[other], state["lo" + other]
        backward = field == "E"
        tag = "e" if field == "E" else "h"
        psi_key, lopsi_key = f"psi_{field}", f"lopsi_{field}"
        iv = ds.pair_tensors(1.0 / np.float64(static.dx),
                             next(iter(srch.values())))
        out = {}
        for c in upd:
            acc = None
            for (a, d_axis, s) in CURL_TERMS[component_axis(c)]:
                d = other + AXES[d_axis]
                if d not in srch or srch[d].shape[a] == 1:
                    # a component outside the mode, or a difference
                    # along an inactive axis: no term (the reference's)
                    continue
                f = (srch[d], srcl[d])
                g = (_shift(f[0], a, backward), _shift(f[1], a, backward))
                dh, dl = ds_diff(f, g, iv) if backward \
                    else ds_diff(g, f, iv)
                fix = None
                if a in slabs:
                    key = f"{c}_{AXES[a]}"
                    psi_new, delta_lo, delta_hi = slab_delta_ds(
                        a, tag, s, (dh, dl),
                        (state[psi_key][key], state[lopsi_key][key]),
                        coeffs, slabs[a])
                    new_psi[psi_key][key] = psi_new[0]
                    new_psi[lopsi_key][key] = psi_new[1]
                    nloc = dh.shape[a]
                    fix = (_pad_slab(delta_lo[0], delta_hi[0], a, nloc,
                                     slabs[a]),
                           _pad_slab(delta_lo[1], delta_hi[1], a, nloc,
                                     slabs[a]))
                th, tl = dh, dl
                if s < 0:
                    th, tl = -th, -tl
                acc = (th, tl) if acc is None else ds.add_ff(*acc, th, tl)
                if fix is not None:      # carries s already
                    acc = ds.add_ff(*acc, *fix)
            if acc is None:
                z = torch.zeros_like(state[field][c])
                acc = (z, z)
            if setup is not None:
                corr = tfsf.corrections_for_ds(
                    field, c, setup, coeffs, state["inc"],
                    mode.active_axes, static.dx)
                if corr is not None:
                    acc = ds.add_ff(*acc, *corr)
            out[c] = acc
        return out

    def step(state, coeffs):
        t = state["t"]
        new_state = dict(state)
        new_psi = {k: dict(state.get(k, {}))
                   for k in ("psi_E", "psi_H", "lopsi_E", "lopsi_H")}
        if setup is not None:
            new_state["inc"] = tfsf.advance_einc(
                state["inc"], coeffs, t, static.dt, static.omega, setup,
                source=line_src)
            state = dict(state, inc=new_state["inc"])

        new_E, new_lo, new_J = {}, {}, {}
        acc_e = _half_update("E", state, coeffs, new_psi)
        for c in mode.e_components:
            ah, al = acc_e[c]
            if static.use_drude:
                j_new = coeffs[f"kj_{c}"] * state["J"][c] \
                    + coeffs[f"bj_{c}"] * state["E"][c]
                new_J[c] = j_new
                ah, al = ds.add_f(ah, al, -j_new)
            if ps.enabled and ps.component == c:
                mask = point_mask(coeffs["gx"], coeffs["gy"], coeffs["gz"],
                                  ps.position, mode.active_axes).to(ah.dtype)
                wh, wl = point_src(t)
                ah, al = ds.add_ff(ah, al, wh * mask, wl * mask)
            t1 = ds.mul_ff(state["E"][c], state["loE"][c],
                           *coef_pair(coeffs, f"ca_{c}", ah))
            t2 = ds.mul_ff(ah, al, *coef_pair(coeffs, f"cb_{c}", ah))
            eh, el = ds.add_ff(*t1, *t2)
            for a in mode.active_axes:       # PEC walls: exact 0/1 mask
                if a != component_axis(c):
                    w = _bcast1d(coeffs[f"wall_{AXES[a]}"], a)
                    eh, el = eh * w, el * w
            new_E[c], new_lo[c] = eh, el
        new_state["E"], new_state["loE"] = new_E, new_lo
        if static.use_drude:
            new_state["J"] = new_J
        state = dict(state, E=new_E, loE=new_lo)

        if setup is not None:
            new_state["inc"] = tfsf.advance_hinc(new_state["inc"], coeffs,
                                                 setup)
            state = dict(state, inc=new_state["inc"])

        new_H, new_loH, new_K = {}, {}, {}
        acc_h = _half_update("H", state, coeffs, new_psi)
        for c in mode.h_components:
            ah, al = acc_h[c]
            if static.use_drude_m:
                # after the TFSF corrections, before da/db: the
                # reference's order; K stays plain f32 on the hi word
                k_new = coeffs[f"km_{c}"] * state["K"][c] \
                    + coeffs[f"bm_{c}"] * state["H"][c]
                new_K[c] = k_new
                ah, al = ds.add_f(ah, al, k_new)
            t1 = ds.mul_ff(state["H"][c], state["loH"][c],
                           *coef_pair(coeffs, f"da_{c}", ah))
            t2 = ds.mul_ff(ah, al, *coef_pair(coeffs, f"db_{c}", ah))
            new_H[c], new_loH[c] = ds.sub_ff(*t1, *t2)
        new_state["H"], new_state["loH"] = new_H, new_loH
        if static.use_drude_m:
            new_state["K"] = new_K
        if new_psi["psi_E"]:
            new_state.update(new_psi)
        new_state["t"] = t + 1
        return new_state

    step.kind = "plain_ds"
    return step


def tb_fallback_reason(static: StaticSetup, packed: bool,
                       allow_multistep: bool = True) -> Optional[str]:
    """Why the dispatch does not take the temporal-blocked pass, or None
    when it does (the reference's ``solver.tb_fallback_reason``): the
    pass's scope token first, then the dispatch context
    (``single_step_contract``, ``env:FDTD3D_NO_TEMPORAL``,
    ``pallas_disabled``, ``env:FDTD3D_NO_PACKED``,
    ``env:FDTD3D_FORCE_FUSED``), in the reference's order."""
    import os

    from fdtd3d_torch.ops import packed_tb
    reason = packed_tb.reject_reason(static)
    if reason is not None:
        return reason
    if not allow_multistep:
        return "single_step_contract"
    if os.environ.get("FDTD3D_NO_TEMPORAL"):
        return "env:FDTD3D_NO_TEMPORAL"
    if not packed:
        return "pallas_disabled"
    if os.environ.get("FDTD3D_NO_PACKED"):
        return "env:FDTD3D_NO_PACKED"
    if os.environ.get("FDTD3D_FORCE_FUSED"):
        return "env:FDTD3D_FORCE_FUSED"
    return None


# the field dtypes of the lane-capable kernels: batch_fallback_reason
# admits no other, and make_step(batch=) builds no other
LANE_DTYPES = ("float32", "bfloat16")


def batch_fallback_reason(static: StaticSetup, device, lane_coeffs=None,
                          batch: int = 0) -> Optional[str]:
    """Why a batch of ``batch`` lanes over ``static`` cannot ride the
    lane-capable packed kernels, or None when it can: the reference's
    ``solver.batch_fallback_reason`` (solver.py:476) and its tokens, in
    its order: ``pallas_disabled`` (the packed steps are not wanted:
    ``use_pallas`` False, or None off CUDA, or a configuration no packed
    kernel covers), ``env:FDTD3D_NO_PACKED``, ``env:FDTD3D_FORCE_FUSED``,
    ``kernel_ineligible`` (a sharded topology, or a CPML axis too thin
    for slab psi, which only a sharded local extent can be), and last
    ``scalar_coeff_divergence``: a key of ``baked_coeff_keys`` that is
    scalar in some lane and differs between lanes, or is a scalar in one
    lane and a grid in another (``lane_coeffs``: the lanes' host
    coefficient dicts). The reference's ``vmem_exhausted`` has no cause
    here: the kernels' shared memory does not depend on the lane
    count."""
    import os

    from fdtd3d_torch.ops import packed, pallas3d
    cfg = static.cfg
    flag = cfg.use_pallas
    want = torch.device(device).type == "cuda" if flag is None else flag
    # the reference's _want_pallas: some kernel covers the configuration
    # (compensated + K: neither the two-pass nor the packed kernel)
    if not want or cfg.dtype not in LANE_DTYPES \
            or not (pallas3d.eligible(static) or packed.eligible(static)):
        return "pallas_disabled"
    if os.environ.get("FDTD3D_NO_PACKED"):
        return "env:FDTD3D_NO_PACKED"
    if os.environ.get("FDTD3D_FORCE_FUSED"):
        return "env:FDTD3D_FORCE_FUSED"
    if tuple(static.topology) != (1, 1, 1) \
            or set(static.pml_axes) != set(slab_axes(static)):
        return "kernel_ineligible"
    for key in packed.baked_coeff_keys(static) if lane_coeffs else ():
        vals = [lc[key] for lc in lane_coeffs]
        nds = [np.ndim(v) for v in vals]
        if all(nd >= 3 for nd in nds):
            continue          # grids are per-lane operands
        if any(nd >= 3 for nd in nds):
            return "scalar_coeff_divergence"
        v0 = np.asarray(vals[0])
        if any(not np.array_equal(np.asarray(v), v0) for v in vals[1:]):
            return "scalar_coeff_divergence"
    return None


def _stamp_tb_fallback(step, reason: str):
    """Record on a step that is not the temporal-blocked pass why it is
    not (``diag["tb_fallback"]``, as the reference's steps carry it)."""
    diag = getattr(step, "diag", None)
    if diag is None:
        diag = step.diag = {}
    diag["tb_fallback"] = {"reason": reason}
    return step


def _ladder_step(static: StaticSetup, device):
    """The rungs below packed (the reference's ``make_step``
    :697-726), for a run that ``FDTD3D_NO_PACKED`` or
    ``FDTD3D_FORCE_FUSED`` sends there: the recompute-fused twin
    (ops/pallas_fused.py) where it is eligible and either
    ``FDTD3D_FORCE_FUSED`` is set or the port's ``fused_preferred``
    rule picks it, unless ``FDTD3D_NO_FUSED`` is set; else the two-pass
    twin (ops/pallas3d.py); else the plain step, the reference ladder's
    bottom rung (its jnp step)."""
    import os

    from fdtd3d_torch.ops import pallas3d, pallas_fused
    if not os.environ.get("FDTD3D_NO_FUSED") \
            and pallas_fused.eligible(static) \
            and (os.environ.get("FDTD3D_FORCE_FUSED")
                 or pallas_fused.fused_preferred(static)):
        return pallas_fused.make_fused_eh_step(static, device)
    step = pallas3d.make_pallas_step(static, device)
    return step if step is not None else make_plain_step(static)


def make_step(static: StaticSetup, device, allow_multistep: bool = True,
              batch: int = 0, mesh=None):
    """The step for ``static`` on ``device`` (see the module docstring
    for the dispatch rule). ``allow_multistep=False`` skips the
    temporal-blocked pass, whose step advances two steps per call.
    ``batch=B`` (B >= 1) builds the lane-capable step; the caller gates
    it with ``batch_fallback_reason`` first, and a configuration no
    lane-capable kernel covers raises rather than running another
    step. A sharded ``static`` (``build_static`` checked its scope)
    takes over ``mesh`` (a ``parallel.mesh.ShardMesh``) the sharded
    temporal-blocked pass where ``tb_fallback_reason`` gives no token,
    else the sharded packed step with that token, or where the
    reference's dispatch runs its two-pass kernels the sharded two-pass
    step, with the token it records there (``sharded_two_pass_reason``);
    in float32x2 the
    sharded packed-ds step, with the token the reference's dispatch
    records for it (``ds_fields``)."""
    import os
    if max(static.topology) > 1:
        from fdtd3d_torch.ops import packed as packed_mod
        if mesh is None or tuple(mesh.topology) != tuple(static.topology):
            raise ValueError(
                f"a static setup on the sharded topology {static.topology} "
                f"needs its ShardMesh (make_step(..., mesh=))")
        if batch:
            _out_of_scope("a batch on a sharded topology", "A11(b)")
        if static.cfg.ds_fields:
            from fdtd3d_torch.ops import packed_ds
            return _stamp_tb_fallback(
                packed_ds.make_sharded_packed_ds_step(static, mesh),
                tb_fallback_reason(static, True, allow_multistep))
        reason = sharded_two_pass_reason(static, allow_multistep)
        if reason is not None:
            from fdtd3d_torch.ops import pallas3d
            return _stamp_tb_fallback(
                pallas3d.make_sharded_pallas_step(static, mesh), reason)
        reason = tb_fallback_reason(static, True, allow_multistep)
        if reason is None:
            from fdtd3d_torch.ops import packed_tb
            return packed_tb.make_sharded_packed_tb_step(static, mesh)
        return _stamp_tb_fallback(
            packed_mod.make_sharded_packed_step(static, mesh), reason)
    if batch and (static.cfg.complex_fields
                  or static.cfg.dtype not in LANE_DTYPES):
        raise RuntimeError(
            "make_step(batch>0): only real float32 and bfloat16 steps are "
            "lane-capable; gate batched builds with "
            "solver.batch_fallback_reason")
    if static.paired_complex:
        flag = static.cfg.use_pallas
        packed = torch.device(device).type == "cuda" if flag is None \
            else flag
        return _stamp_tb_fallback(
            _make_paired_complex_step(static, device),
            tb_fallback_reason(static, packed, allow_multistep))
    if static.cfg.complex_fields and static.cfg.ds_fields:
        raise ValueError(
            "complex fields with float32x2 run only as the paired real "
            "legs (complex2x_plain_ds / complex2x_packed_ds_*, ROADMAP "
            "A10): the reference's native complex jnp-ds route fails on "
            "complex values, so none is ported. Run on a CUDA device, or "
            "set FDTD3D_FORCE_PAIRED_COMPLEX=1 on the CPU")
    if static.cfg.complex_fields and torch.device(device).type == "cuda" \
            and static.cfg.use_pallas is not False:
        raise ValueError(
            "complex fields on a CUDA device run the paired-real legs: "
            "build the static setup with the run's device "
            "(solver.build_static(cfg, device)), or pass use_pallas=False "
            "for the native complex plain step")
    if batch:
        reason = tb_fallback_reason(static, True, allow_multistep)
        if reason in ("env:FDTD3D_NO_PACKED", "env:FDTD3D_FORCE_FUSED"):
            raise RuntimeError(
                f"make_step(batch>0): {reason} leaves no lane-capable "
                f"kernel; gate batched builds with "
                f"solver.batch_fallback_reason")
        from fdtd3d_torch.ops import packed as packed_mod
        if packed_mod.declines(static):
            # the reference's batch authority admits such lanes and its
            # batched build then raises the same way (solver.py:717)
            raise RuntimeError(
                "make_step(batch>0): no lane-capable packed kind engaged "
                "(the packed kernel declines compensated mode with "
                "coefficient grids or magnetic Drude K)")
        if reason is None:
            from fdtd3d_torch.ops import packed_tb
            return packed_tb.make_packed_tb_step(static, device, batch=batch)
        return _stamp_tb_fallback(
            packed_mod.make_packed_step(static, device, batch=batch), reason)
    from fdtd3d_torch.ops import packed as packed_mod
    from fdtd3d_torch.ops import packed_ds, pallas3d
    flag = static.cfg.use_pallas
    packed = torch.device(device).type == "cuda" if flag is None else flag
    reason = tb_fallback_reason(static, packed, allow_multistep)
    if static.cfg.ds_fields:
        if packed and _ds_kernel_wanted(static):
            step = packed_ds.make_packed_ds_step(static, device)
        else:
            step = make_plain_ds_step(static)
    elif static.cfg.dtype == "float64":
        if flag:
            raise NotImplementedError(
                "float64 has no kernel in either package: it runs the "
                "plain step (use_pallas=None or False)")
        step = make_plain_step(static)
    elif reason is None:
        from fdtd3d_torch.ops import packed_tb
        return packed_tb.make_packed_tb_step(static, device)
    elif not (packed and (packed_mod.eligible(static)
                          or pallas3d.eligible(static))):
        # no kernel is wanted, or none covers the configuration (a 1D/2D
        # mode): the reference's _want_pallas is false, its jnp step runs
        step = make_plain_step(static)
    elif os.environ.get("FDTD3D_NO_PACKED") \
            or os.environ.get("FDTD3D_FORCE_FUSED"):
        step = _ladder_step(static, device)
    else:
        # where the reference's packed kernel declines, its dispatch runs
        # its jnp step
        step = make_plain_step(static) if packed_mod.declines(static) \
            else packed_mod.make_packed_step(static, device)
    return _stamp_tb_fallback(step, reason)


def _ds_kernel_wanted(static: StaticSetup) -> bool:
    """The reference's ds dispatch: the packed-ds kernel runs a float32x2
    configuration inside its scope unless ``FDTD3D_NO_PACKED`` is set;
    otherwise (a 1D/2D mode, or the variable) the plain ds step runs,
    the bottom of the ds ladder (its jnp-ds branch)."""
    import os

    from fdtd3d_torch.ops import packed_ds
    return packed_ds.eligible(static) \
        and not os.environ.get("FDTD3D_NO_PACKED")


def _complex_parts(tree, part):
    """One real part of a complex dict-form state (fresh contiguous
    tensors; a real leaf is its own real part and has a zero imaginary
    one; ``t`` stays as it is)."""
    if isinstance(tree, dict):
        return {k: _complex_parts(v, part) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    if tree.is_complex():
        return part(tree).contiguous()
    return tree.clone() if part is torch.real else torch.zeros_like(tree)


def _complex_join(re, im):
    """The complex dict-form state of two real legs' dict forms: new
    tensors ``re + 1j im``, exact (``torch.complex``)."""
    if isinstance(re, dict):
        return {k: _complex_join(v, im[k]) for k, v in re.items()}
    if isinstance(re, torch.Tensor) and re.is_floating_point():
        return torch.complex(re, im)
    return re


def _make_paired_complex_step(static: StaticSetup, device):
    """Complex fields as two real legs (the reference's
    ``solver._make_paired_complex_step``, fdtd3d_tpu/solver.py:1198).

    The update is linear with real coefficients and real sources, so a
    complex run decomposes exactly: the re leg carries the sources, the
    im leg runs the same step with the TFSF and point-source amplitudes
    zeroed (its incident line stays zero: the machinery is present and
    inert). Each leg is the normal step of its real configuration,
    built with ``allow_multistep=False`` (the pair calls each leg once
    a step): on a CUDA device the packed twin ``csrc/packed_eh.cu`` in
    3D f32, its K build with magnetic Drude, the ladder's twins under
    their escape hatches; in 3D float32x2 the packed-ds twin
    ``csrc/packed_ds.cu`` (J and K included), the plain ds step under
    ``FDTD3D_NO_PACKED``; f64 and 1D/2D legs run the plain step (or
    the plain ds step), as real runs do. On a CUDA device an eligible
    leg that does not run a kernel is an error, never a quiet plain
    run.

    With float32x2 the complex state's low words start real (float32,
    the reference's ``init_state``) and a real leaf's imaginary part is
    zero here: the reference copies a real leaf into both legs, which
    agrees while the low words are zero (every state it packs: the
    initial one, or one it unpacked after a step, whose leaves it made
    complex). ROADMAP.md §C records the difference for a nonzero real
    low word installed by hand.

    The carry is ``{"re": leg, "im": leg, "t": t}``, each leg in its
    step's own form (packed when the leg step is packed). ``pack`` and
    ``unpack`` convert to and from the complex dict form on the device
    (``.real``/``.imag`` copied contiguous, ``torch.complex``): exact,
    and no host round trip, where the reference must go through host
    numpy. ``legs`` gives the two legs' dict-form views, the health
    pass's input (the reference's ``health_view``). Kind
    ``complex2x_<leg kind>``; ``diag`` the re leg's."""
    from fdtd3d_torch.ops import packed as packed_mod
    from fdtd3d_torch.ops import pallas3d
    cfg = static.cfg
    cfg_re = dataclasses.replace(cfg, complex_fields=False)
    cfg_im = dataclasses.replace(
        cfg_re,
        point_source=dataclasses.replace(cfg.point_source, amplitude=0.0),
        tfsf=dataclasses.replace(cfg.tfsf, amplitude=0.0))
    st_re = dataclasses.replace(build_static(cfg_re),
                                topology=static.topology)
    st_im = dataclasses.replace(build_static(cfg_im),
                                topology=static.topology)
    step_re = make_step(st_re, device, allow_multistep=False)
    step_im = make_step(st_im, device, allow_multistep=False)
    kernel_leg = _ds_kernel_wanted(st_re) if cfg.ds_fields \
        else packed_mod.eligible(st_re) or pallas3d.eligible(st_re)
    if torch.device(device).type == "cuda" and cfg.use_pallas is not False \
            and kernel_leg and not step_re.kind.endswith("_cuda"):
        raise RuntimeError(
            f"complex leg on a CUDA device ran {step_re.kind}, not a "
            f"kernel")
    prep_re = getattr(step_re, "prepare", None)
    prep_im = getattr(step_im, "prepare", None)
    leg_packed = getattr(step_re, "packed", False)

    def im_coeffs(coeffs):
        # the im leg's point-source drive: its amplitude coefficient
        # zeroed (the reference zeroes its traced ps_amp the same way)
        if "ps_amp" not in coeffs:
            return coeffs
        out = dict(coeffs)
        out["ps_amp"] = 0.0
        return out

    def prepare(coeffs):
        ci = im_coeffs(coeffs)
        return {"re": prep_re(coeffs) if prep_re is not None else coeffs,
                "im": prep_im(ci) if prep_im is not None else ci}

    def step(s, cc):
        # the pair's t is the one a restore or a state install sets
        s["re"]["t"] = s["im"]["t"] = s["t"]
        re = step_re(s["re"], cc["re"])
        im = step_im(s["im"], cc["im"])
        return {"re": re, "im": im, "t": re["t"]}

    def leg_view(leg):
        return step_re.unpack(leg) if leg_packed else leg

    def pack(state):
        legs = [_complex_parts(state, part)
                for part in (torch.real, torch.imag)]
        if leg_packed:
            legs = [step_re.pack(leg) for leg in legs]
        return {"re": legs[0], "im": legs[1], "t": int(state["t"])}

    def unpack(p):
        out = _complex_join(leg_view(p["re"]), leg_view(p["im"]))
        out["t"] = p["t"]       # the legs' own t is synced at each step
        return out

    step.prepare = prepare
    step.pack = pack
    step.unpack = unpack
    step.legs = lambda p: [leg_view(p["re"]), leg_view(p["im"])]
    step.packed = True
    step.kind = "complex2x_" + step_re.kind
    step.diag = dict(getattr(step_re, "diag", None) or {})
    return step


def make_chunk_runner(static: StaticSetup, device, health: bool = False,
                      batch: int = 0, per_chip: bool = False, mesh=None):
    """run_chunk(state, coeffs, n): n steps in a Python loop.

    Steps exposing ``prepare`` (the packed steps) get it called outside
    the loop, once per coefficient dict (in a ``prepare`` scope). When a
    packed step is engaged (``run_chunk.packed``) the carry is the packed
    state; callers convert once with ``run_chunk.pack``/``run_chunk.unpack``.
    A step that advances ``steps_per_call`` > 1 steps per call (the
    temporal-blocked pass) runs ``n // steps_per_call`` times, and its
    ``tail_step`` the ``n % steps_per_call`` remaining steps.

    ``health=True``: run_chunk returns ``(state, health)`` where health
    is the :class:`telemetry.Health` of ``telemetry.make_health_fn``,
    computed on the dict-form view of the chunk's final carry (a packed
    carry through ``unpack``: views, built anew every chunk, since the tb
    pass swaps its buffers; a paired complex carry as its two legs'
    views, ``run_chunk.legs``) in a ``health`` scope, and read back by
    the caller once. ``per_chip`` adds the per-chip vectors
    (``run_chunk.per_chip``).

    ``batch=B`` builds the lane-capable runner (``make_step``'s batch):
    its carry has a leading lane axis and its health is that of
    ``telemetry.make_lane_health_fn``, per lane.

    ``mesh`` (a sharded static): the sharded packed step; its views are
    the shards' dict forms (``run_chunk.views``, a list) and its health
    that of ``telemetry.make_sharded_health_fn``: local partials
    finished over the shards.
    """
    from fdtd3d_torch import telemetry
    step = make_step(static, device, batch=batch, mesh=mesh)
    prep = getattr(step, "prepare", None)
    spc = getattr(step, "steps_per_call", 1)
    tail = getattr(step, "tail_step", step)
    packed = getattr(step, "packed", False)
    legs = getattr(step, "legs", None)
    health_fn = None
    sharded = getattr(step, "mesh", None)
    if health and sharded is not None:
        health_fn = telemetry.make_sharded_health_fn(static, sharded,
                                                     per_chip=per_chip)
    elif health:
        health_fn = (telemetry.make_lane_health_fn if batch
                     else telemetry.make_health_fn)(static,
                                                    per_chip=per_chip)

    prepared: Dict[str, Any] = {}

    def run_chunk(state, coeffs, n: int):
        cc = coeffs
        if prep is not None:
            # the prepared operands depend only on the coefficients:
            # build them once per coefficient dict, not per chunk (the
            # TFSF plan's masked selects synchronize with the device)
            if prepared.get("src") is not coeffs:
                with telemetry.named("prepare"):
                    prepared["src"], prepared["cc"] = coeffs, prep(coeffs)
            cc = prepared["cc"]
        passes, rem = divmod(n, spc)
        for _ in range(passes):
            state = step(state, cc)
        for _ in range(rem):
            state = tail(state, cc)
        if health_fn is not None:
            return state, health_fn(views(state))
        return state

    def views(state):
        """The dict-form views the health pass reads: the two legs of a
        paired complex carry, else the carry's one dict form."""
        if legs is not None:
            return legs(state)
        return step.unpack(state) if packed else state

    run_chunk.health = health_fn is not None
    run_chunk.per_chip = health_fn is not None and per_chip
    run_chunk.kind = step.kind
    run_chunk.steps_per_call = spc
    run_chunk.diag = getattr(step, "diag", None)
    run_chunk.packed = packed
    run_chunk.legs = legs
    run_chunk.views = views
    run_chunk.mesh = sharded
    if packed:
        run_chunk.pack = step.pack
        run_chunk.unpack = step.unpack
    # the out-of-place steps' spare buffers (the packed-ds and tb steps),
    # which the planner counts
    run_chunk.spare = getattr(step, "spare", None)
    if sharded is not None:
        run_chunk.join = step.join
        run_chunk.ghosts = step.ghosts
        # the form a zero shard is made in (None: the dict form)
        run_chunk.pack_shard = step.pack_shard
    return run_chunk

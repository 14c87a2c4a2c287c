"""The 1D and 2D scheme modes of the port against the JAX reference on
the CPU.

Every kernel is 3D-only in both packages, so a 1D/2D run takes the
plain step (kind ``plain``, ``plain_ds``), the counterpart of the
reference's jnp and jnp-ds steps. Inactive axes are singleton dims.

* every one of the 12 non-3D modes with a point source and CPML on its
  active axes, from seeded fields, against the reference's jnp step:
  f32 at 2e-6 of the family max (E or H), f64 at 1e-12, bf16 at 2e-2,
  compensated f32 at 2e-6; float32x2 against the reference's float64
  run at the float32x2 accuracy bar, 2e-7 (tests/test_float32x2.py), and
  in 1D against the reference's jnp-ds step at the packed-ds gates (hi
  words 1e-9, the reference's 2D jnp-ds graph takes XLA:CPU minutes to
  compile);
* 1D TFSF: the exact propagation at the magic time step
  (tests/test_core_modes.py:19) and the reference's run, 2D oblique TFSF,
  and the inactive-axis incidence error of both packages;
* 1D electric Drude J (tests/test_drude.py's metal half-space) and
  magnetic Drude K (the double-negative slab), small;
* the discrete dispersion (1D) and the 2D PEC cavity mode, in f64,
  against the port's exact.py;
* the material grids on singleton axes (spheres, Drude spheres, a BMP
  file) against the reference's materials.py;
* dispatch: the kind and ``tb_fallback`` token of each dispatch setting,
  ``require_pallas`` raising, and a 2D batch running the plain step lane
  by lane (``pallas_disabled``) with each lane equal to the reference's
  solo run.
"""

import dataclasses
import math

import numpy as np
import pytest
from torch_parity import run_pair, seed_reference, np_state, to_port

from fdtd3d_torch import convert
from fdtd3d_torch import exact as texact
from fdtd3d_torch import io as tio
from fdtd3d_torch import materials as tmat
from fdtd3d_torch.batch import BatchSimulation
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu import materials as rmat
from fdtd3d_tpu import physics
from fdtd3d_tpu.config import (MaterialsConfig, PmlConfig,
                               PointSourceConfig, SimConfig, SphereConfig,
                               TfsfConfig)
from fdtd3d_tpu.layout import SCHEME_MODES
from fdtd3d_tpu.sim import Simulation as RSim

MODES = sorted(m for m in SCHEME_MODES if m != "3D")


def mode_config(name: str, n: int = 24, steps: int = 25, **kw) -> SimConfig:
    """``name`` on an n-cell grid along each active axis: CPML of 4 on
    them, a point source on the first E component at the centre."""
    mode = SCHEME_MODES[name]
    size = tuple(n if a in mode.active_axes else 1 for a in range(3))
    base = dict(
        scheme=name, size=size, time_steps=steps, dx=1e-3,
        courant_factor=0.5, wavelength=12e-3,
        pml=PmlConfig(size=tuple(4 if a in mode.active_axes else 0
                                 for a in range(3))),
        point_source=PointSourceConfig(
            enabled=True, component=mode.e_components[0],
            position=tuple(s // 2 for s in size)))
    base.update(kw)
    return SimConfig(**base)


def family_rel(want, got, group):
    """max |got - want| over the family's components, relative to the
    family's max |want|."""
    fam = "E" if group in ("E", "loE") else "H"
    scale = max(np.abs(np.asarray(v)).max() for v in want[fam].values())
    err = max(np.abs(np.asarray(want[group][c], np.float64)
                     - np.asarray(got[group][c], np.float64)).max()
              for c in want[group])
    return err / scale


def assert_modes_close(want, got, tol):
    """E and H at ``tol`` of their family max; every other leaf (psi, J,
    K, the incident line) at ``tol`` of its own max."""
    for group in ("E", "H"):
        assert set(want[group]) == set(got[group])
        rel = family_rel(want, got, group)
        assert rel < tol, f"{group}: rel {rel:.2e}"
    for group, sub in want.items():
        if group in ("E", "H", "t", "rE", "rH") or not isinstance(sub, dict):
            continue
        for k, a in sub.items():
            a = np.asarray(a, np.float64)
            b = np.asarray(got[group][k], np.float64)
            assert a.shape == b.shape, f"{group}/{k}"
            scale = np.abs(a).max()
            err = np.abs(a - b).max()
            assert err <= tol * scale, f"{group}/{k}: {err:.2e} vs {scale:.2e}"


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6),
                                       ("float64", 1e-12),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("name", MODES)
def test_mode_matches_reference_jnp(name, dtype, tol):
    want, got, ref, port = run_pair(mode_config(name, dtype=dtype), seed=1)
    assert (ref.step_kind, port.step_kind) == ("jnp", "plain")
    assert np.abs(np.asarray(want["E"][ref.cfg.point_source.component])
                  ).max() > 0
    assert_modes_close(want, got, tol)


@pytest.mark.parametrize("name", MODES)
def test_compensated_mode_matches_reference_jnp(name):
    want, got, ref, port = run_pair(mode_config(name, compensated=True),
                                    seed=2)
    assert (ref.step_kind, port.step_kind) == ("jnp", "plain")
    assert set(want["rE"]) == set(got["rE"])
    assert_modes_close(want, got, 2e-6)


@pytest.mark.parametrize("name", MODES)
def test_float32x2_mode_tracks_float64(name):
    """The plain ds step from f32 fields against the reference's float64
    jnp step from the same fields: the float32x2 accuracy bar."""
    cfg = mode_config(name, dtype="float32x2")
    ref = RSim(dataclasses.replace(cfg, dtype="float64"))
    seed_reference(ref, 3)
    port = TSim(to_port(cfg), device="cpu")
    assert port.step_kind == "plain_ds"
    for group in ("E", "H"):
        for c, v in np_state(ref)[group].items():
            port.set_field(c, v.astype(np.float32))
    ref.advance(cfg.time_steps)
    port.advance(cfg.time_steps)
    want = np_state(ref)
    got = convert.state_to_reference(port.state)
    for group in ("E", "H"):
        hi_lo = {c: np.asarray(got[group][c], np.float64)
                 + np.asarray(got["lo" + group][c], np.float64)
                 for c in got[group]}
        rel = family_rel(want, dict(got, **{group: hi_lo}), group)
        assert rel < 2e-7, f"{group}: rel {rel:.2e} vs float64"


@pytest.mark.parametrize("name", ["1D_EzHy", "1D_ExHz"])
def test_float32x2_1d_matches_reference_jnp_ds(name):
    want, got, ref, port = run_pair(
        mode_config(name, dtype="float32x2", use_pallas=True), seed=4)
    assert (ref.step_kind, port.step_kind) == ("jnp_ds", "plain_ds")
    for group in ("E", "H", "loE", "loH"):
        rel = family_rel(want, got, group)
        assert rel < 1e-9, f"{group}: rel {rel:.2e}"


# --------------------------------------------------------------------------
# TFSF in 1D and 2D
# --------------------------------------------------------------------------

def tfsf_1d(n=200, steps=300, **kw):
    base = dict(scheme="1D_EzHy", size=(n, 1, 1), time_steps=steps,
                dx=1e-3, courant_factor=1.0, wavelength=30e-3,
                tfsf=TfsfConfig(enabled=True, margin=(20, 0, 0),
                                angle_teta=90.0, angle_phi=0.0,
                                angle_psi=180.0))
    base.update(kw)
    return SimConfig(**base)


def test_1d_tfsf_exact_propagation():
    """At the magic time step the TFSF injection is exact: the total field
    inside the box equals the incident line, the scattered field outside
    is ~0 (tests/test_core_modes.py:19, on the port)."""
    sim = TSim(to_port(tfsf_1d()), device="cpu").run()
    ez = sim.field("Ez")[:, 0, 0]
    setup = sim.static.tfsf_setup
    lo, hi = setup.lo[0], setup.hi[0]
    sf = np.concatenate([ez[: lo - 1], ez[hi + 2:]])
    assert np.max(np.abs(sf)) < 5e-6 * max(np.max(np.abs(ez)), 1e-30)
    einc = convert.to_host(sim.state["inc"]["Einc"])
    interior = np.arange(lo + 1, hi - 1)
    zeta = setup.zeta0 + (interior - setup.origin[0])
    expect = setup.ehat[2] * einc[np.round(zeta).astype(int)]
    err = np.max(np.abs(ez[interior] - expect))
    assert err < 2e-5 * np.max(np.abs(einc) + 1e-30)


@pytest.mark.parametrize("cfg", [
    tfsf_1d(n=80, steps=60, courant_factor=0.5,
            pml=PmlConfig(size=(8, 0, 0))),
    SimConfig(scheme="2D_TMz", size=(40, 36, 1), time_steps=40, dx=1e-3,
              courant_factor=0.5, wavelength=12e-3,
              pml=PmlConfig(size=(5, 5, 0)),
              tfsf=TfsfConfig(enabled=True, margin=(3, 3, 0),
                              angle_teta=90.0, angle_phi=30.0,
                              angle_psi=180.0)),
    SimConfig(scheme="2D_TEz", size=(36, 40, 1), time_steps=40, dx=1e-3,
              courant_factor=0.5, wavelength=12e-3,
              pml=PmlConfig(size=(5, 5, 0)),
              tfsf=TfsfConfig(enabled=True, margin=(3, 3, 0),
                              angle_teta=90.0, angle_phi=200.0,
                              angle_psi=90.0)),
], ids=["1D_EzHy", "2D_TMz_oblique", "2D_TEz_oblique"])
def test_tfsf_matches_reference(cfg):
    want, got, ref, port = run_pair(cfg, seed=5)
    assert port.step_kind == "plain"
    assert_modes_close(want, got, 2e-6)


def test_tfsf_incidence_along_an_inactive_axis_raises():
    cfg = dataclasses.replace(tfsf_1d(), tfsf=TfsfConfig(
        enabled=True, margin=(20, 0, 0), angle_teta=30.0))
    with pytest.raises(ValueError, match="inactive axis"):
        RSim(cfg)
    with pytest.raises(ValueError, match="inactive axis"):
        TSim(to_port(cfg), device="cpu")


# --------------------------------------------------------------------------
# Drude J and K in 1D
# --------------------------------------------------------------------------

def drude_1d(electric: bool, magnetic: bool, n=96, steps=60):
    """tests/test_drude.py's half-space set-up, cut: a TFSF wave onto a
    dispersive slab behind CPML."""
    wavelength = 15e-3
    wp = 1.2 * 2 * math.pi * physics.C0 / wavelength
    sphere = SphereConfig(enabled=True, center=(70.0, 0.0, 0.0),
                          radius=14.0)
    return SimConfig(
        scheme="1D_EzHy", size=(n, 1, 1), time_steps=steps, dx=1e-3,
        courant_factor=0.5, wavelength=wavelength,
        pml=PmlConfig(size=(8, 0, 0)),
        tfsf=TfsfConfig(enabled=True, margin=(6, 0, 0), angle_teta=90.0,
                        angle_phi=0.0, angle_psi=180.0),
        materials=MaterialsConfig(
            use_drude=electric, eps_inf=1.0,
            omega_p=wp if electric else 0.0, gamma=1e9,
            drude_sphere=sphere, use_drude_m=magnetic, mu_inf=1.0,
            omega_pm=wp if magnetic else 0.0, gamma_m=1e9,
            drude_m_sphere=sphere))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("electric,magnetic", [(True, False), (False, True),
                                               (True, True)],
                         ids=["J", "K", "JK"])
def test_drude_1d_matches_reference(electric, magnetic, dtype, tol):
    cfg = dataclasses.replace(drude_1d(electric, magnetic), dtype=dtype)
    want, got, ref, port = run_pair(cfg, seed=6)
    assert port.step_kind == "plain"
    assert ("J" in got) == electric and ("K" in got) == magnetic
    assert_modes_close(want, got, tol)


def test_drude_metal_reflects_on_the_port():
    """tests/test_drude.py's metal half-space, cut to 600 steps: a
    standing wave in front of the metal, evanescent decay inside."""
    n, wavelength = 160, 15e-3
    omega = 2 * math.pi * physics.C0 / wavelength
    cfg = SimConfig(
        scheme="1D_EzHy", size=(n, 1, 1), time_steps=600, dx=1e-3,
        courant_factor=0.5, wavelength=wavelength,
        pml=PmlConfig(size=(10, 0, 0)),
        tfsf=TfsfConfig(enabled=True, margin=(8, 0, 0), angle_teta=90.0,
                        angle_phi=0.0, angle_psi=180.0),
        materials=MaterialsConfig(
            use_drude=True, eps_inf=1.0, omega_p=3.0 * omega, gamma=0.0,
            drude_sphere=SphereConfig(enabled=True, center=(n, 0.0, 0.0),
                                      radius=n - 100.0)))
    sim = TSim(to_port(cfg), device="cpu").run()
    front, inside = 0.0, 0.0
    for _ in range(6):
        sim.advance(7)
        ez = sim.field("Ez")[:, 0, 0]
        front = max(front, np.abs(ez[40:95]).max())
        inside = max(inside, np.abs(ez[112:118]).max())
    kappa = omega / physics.C0 * cfg.dx * math.sqrt(8.0)
    assert front > 1.5, f"no standing wave, max {front:.2f}"
    assert inside < 3.0 * 2.0 * math.exp(-kappa * 12) + 0.02


# --------------------------------------------------------------------------
# exact solutions (float64)
# --------------------------------------------------------------------------

def test_cavity_mode_2d_exact_evolution_f64():
    n, steps = 33, 300
    cfg = SimConfig(scheme="2D_TMz", size=(n, n, 1), time_steps=steps,
                    dx=1e-3, courant_factor=0.6, wavelength=10e-3,
                    dtype="float64")
    sim = TSim(to_port(cfg), device="cpu")
    shape, omega = texact.cavity_mode_tmz((n, n), 2, 3, cfg.dx, cfg.dt)
    sim.set_field("Ez", shape[:, :, None])
    sim.run()
    expected = texact.cavity_expectation(shape, omega, cfg.dt, steps)
    assert np.max(np.abs(sim.field("Ez")[:, :, 0] - expected)) < 1e-10


def test_discrete_dispersion_matches_tfsf_steady_state():
    """tests/test_core_modes.py's CW check on the port: the interior
    field fits the plane wave with the discrete wave number."""
    n = 220
    cfg = SimConfig(
        scheme="1D_EzHy", size=(n, 1, 1), time_steps=1200, dx=1e-3,
        courant_factor=0.7, wavelength=20e-3, dtype="float64",
        pml=PmlConfig(size=(10, 0, 0)),
        tfsf=TfsfConfig(enabled=True, margin=(8, 0, 0), angle_teta=90.0,
                        angle_phi=0.0, angle_psi=180.0))
    sim = TSim(to_port(cfg), device="cpu").run()
    ez = sim.field("Ez")[:, 0, 0]
    x = np.arange(60, 160, dtype=np.float64)
    k = texact.discrete_k_1d(cfg.omega, cfg.dx, cfg.dt)
    basis = np.stack([np.sin(k * x), np.cos(k * x)], axis=1)
    coef = np.linalg.lstsq(basis, ez[60:160], rcond=None)[0]
    amp = math.hypot(*coef)
    assert 0.97 < amp < 1.03, f"amplitude {amp}"
    assert np.max(np.abs(basis @ coef - ez[60:160])) < 1.5e-2 * amp
    steady = texact.plane_wave_1d_steady(x, 0, cfg.omega, cfg.dx, cfg.dt)
    assert steady.shape == x.shape


# --------------------------------------------------------------------------
# materials on singleton axes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,size", [("1D_EzHy", (40, 1, 1)),
                                       ("1D_ExHy", (1, 1, 40)),
                                       ("2D_TMz", (30, 26, 1)),
                                       ("2D_TEx", (1, 28, 30))])
def test_material_grids_match_reference(name, size):
    mode = SCHEME_MODES[name]
    sph = SphereConfig(enabled=True, center=(15.0, 13.0, 14.0),
                       radius=6.5, value=3.5)
    mat = MaterialsConfig(use_drude=True, omega_p=1e11, eps_inf=2.0,
                          drude_sphere=sph)
    for comp in mode.components:
        want = rmat.scalar_or_grid(comp, size, mode.active_axes, 1.5, sph,
                                   None)
        got = tmat.scalar_or_grid(comp, size, mode.active_axes, 1.5, sph,
                                  None)
        assert np.array_equal(want, got), comp
        assert want.shape == size and (want == 3.5).any()
        w = rmat.drude_params(comp, size, mode.active_axes, mat)
        g = tmat.drude_params(comp, size, mode.active_axes, mat)
        assert np.array_equal(w[0], g[0]) and w[1:] == g[1:]


def test_bmp_material_grid_matches_reference(tmp_path):
    """A BMP file initialises a 2D eps grid: both loaders give the same
    grid, and a 1D mode refuses the file in both packages."""
    size = (20, 12, 1)
    rng = np.random.RandomState(8)
    img = rng.uniform(-1, 1, (12, 20))
    path = str(tmp_path / "eps.bmp")
    with open(path, "wb") as f:
        f.write(tio.bmp_encode(tio.colormap_diverging(img)))
    axes = SCHEME_MODES["2D_TMz"].active_axes
    want = rmat.scalar_or_grid("Ez", size, axes, 4.0, None, path)
    got = tmat.scalar_or_grid("Ez", size, axes, 4.0, None, path)
    assert np.array_equal(want, got) and want.shape == size
    one = SCHEME_MODES["1D_EzHy"].active_axes
    for mod in (rmat, tmat):
        with pytest.raises(ValueError, match="2 active axes"):
            mod.scalar_or_grid("Ez", (20, 1, 1), one, 4.0, None, path)


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("env", [(), ("FDTD3D_NO_TEMPORAL",),
                                 ("FDTD3D_NO_PACKED",),
                                 ("FDTD3D_FORCE_FUSED",)])
@pytest.mark.parametrize("name,dtype", [("2D_TMz", "float32"),
                                        ("1D_EzHy", "bfloat16"),
                                        ("2D_TEy", "float32x2")])
def test_dispatch_matches_reference(name, dtype, env, monkeypatch):
    """With the kernels asked for, a 1D/2D run takes the plain step (the
    reference's jnp/jnp-ds), and both name the same tb_fallback token."""
    for k in env:
        monkeypatch.setenv(k, "1")
    cfg = mode_config(name, dtype=dtype, use_pallas=True)
    ref = RSim(cfg)
    port = TSim(to_port(cfg), device="cpu")
    plain = "plain_ds" if dtype == "float32x2" else "plain"
    assert port.step_kind == plain
    assert ref.step_kind == {"plain": "jnp", "plain_ds": "jnp_ds"}[plain]
    assert port.step_diag["tb_fallback"] == ref.step_diag["tb_fallback"]


def test_require_pallas_raises_on_a_2d_run():
    cfg = mode_config("2D_TMz", use_pallas=True, require_pallas=True)
    with pytest.raises(ValueError, match="require_pallas"):
        TSim(to_port(cfg), device="cpu")


def test_batch_of_2d_lanes_matches_reference_solo_runs():
    """A 2D batch gets the reference's token (no kernel covers it) and
    runs the plain step lane by lane; each lane equals the reference's
    solo jnp run."""
    cfgs = [mode_config("2D_TMz", use_pallas=True,
                        point_source=PointSourceConfig(
                            enabled=True, component="Ez",
                            position=(12, 12, 0), amplitude=amp))
            for amp in (1.0, 2.5)]
    bsim = BatchSimulation([to_port(c) for c in cfgs], device="cpu").run()
    assert bsim.step_kind == "plain"
    assert bsim.batch_fallback == "batch_unsupported:pallas_disabled"
    for lane, cfg in enumerate(cfgs):
        ref = RSim(dataclasses.replace(cfg, use_pallas=False)).run()
        want = np_state(ref)
        got = convert.state_to_reference(bsim.lane_state(lane))
        assert_modes_close(want, got, 2e-6)

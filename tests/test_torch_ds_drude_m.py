"""Magnetic Drude K with float32x2 (double-single) fields: the port
against the JAX reference on the CPU.

K (``K' = km K + bm H`` on the hi word of the old H, plain f32 as the
reference keeps its ADE currents) rides the plain ds step (kind
``plain_ds``) and the packed-ds step (kind ``packed_ds_plain``, the
plain versions of the CUDA launches of ``csrc/packed_ds.cu``). Both
are held against the reference's jnp-ds step (``use_pallas=False``,
kind ``jnp_ds``) from one seeded carry: f64 draws split into
normalised (hi, lo) pairs. The reference's own tests hold its
interpret-mode packed-ds kernel to that step
(tests/test_pallas_packed_ds.py:263); the interpret-mode kernel is not
run here (its compile takes minutes at 16^3). Gates, the reference's:
E and H (hi and lo words) at 1e-6 of the family's max, J and K at 1e-5
of their own max, psi pairs at 1e-6 of the psi max, the incident line
at 1e-12 (the same EFT sequence op for op). With coefficient grids the
two packages part by a hi-word ulp of K after a few steps (XLA:CPU's
fused loops against torch's), ~5e-8 of the family max at 8 steps.

Also: the CUDA step's schedule (out of place, the spare set swapped in,
K read and written at the lagged H cell) bit-equal on every leaf to the
in-place plain ds step; 1D float32x2 with K against the reference's
jnp-ds step; the health counters of a ds K carry against the
reference's; npz checkpoints of a ds K run restored across both
packages; a supervised NaN degrading ``packed_ds_plain`` to
``plain_ds``; and the CLI on the precision example with the DNG
sphere's flags against the reference CLI.
"""

import dataclasses
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (K_SPHERE, assert_ds_state_close, ref_config,
                          run_pair, to_port)

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import convert, faults
from fdtd3d_torch import io as tio
from fdtd3d_torch import telemetry as ttel
from fdtd3d_torch.ops import ds as tds
from fdtd3d_torch.ops import packed_ds
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_torch.supervisor import RetryPolicy, Supervisor
from fdtd3d_tpu import cli as rcli
from fdtd3d_tpu import io as rio
from fdtd3d_tpu import telemetry as rtel
from fdtd3d_tpu.config import (MaterialsConfig, OutputConfig, PmlConfig,
                               SimConfig, SphereConfig, TfsfConfig)
from fdtd3d_tpu.sim import Simulation as RSim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRECISION = os.path.join(ROOT, "Examples", "precision3D_float32x2.txt")
FIELD_TOL = 1e-6
STEPS = 8
OMEGA = 2.0 * np.pi * 3e8 / 8e-3
DNG_SPHERE = SphereConfig(enabled=True, center=(8.0, 8.0, 8.0), radius=4.0)

# case -> reference config (3D, 16^3, float32x2, the jnp-ds step)
CASES = {
    # the uniform Drude e+m materials of tests/test_pallas_packed_ds.py:277
    "uniform_jk": ref_config("xyz_cpml", dtype="float32x2", materials=(
        MaterialsConfig(use_drude=True, eps_inf=1.0, omega_p=0.05 * OMEGA,
                        gamma=0.0, use_drude_m=True, mu_inf=1.0,
                        omega_pm=0.05 * OMEGA, gamma_m=0.0))),
    # tests/torch_parity.py's K sphere with xyz CPML and oblique TFSF
    "k_sphere_oblique": ref_config("oblique_tfsf", dtype="float32x2",
                                   materials=K_SPHERE),
    # a double-negative sphere: J and K in one sphere
    "dng_sphere": ref_config("xyz_cpml", dtype="float32x2", materials=(
        MaterialsConfig(use_drude=True, eps_inf=1.0, omega_p=0.3 * OMEGA,
                        gamma=1e9, drude_sphere=DNG_SPHERE,
                        use_drude_m=True, mu_inf=1.0,
                        omega_pm=0.3 * OMEGA, gamma_m=1e9,
                        drude_m_sphere=DNG_SPHERE))),
}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("FDTD3D_NO_TEMPORAL", "FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED",
              "FDTD3D_FORCE_FUSED", "FDTD3D_FAULT_PLAN",
              "FDTD3D_FORCE_PAIRED_COMPLEX"):
        monkeypatch.delenv(k, raising=False)
    faults.clear()
    yield monkeypatch
    faults.clear()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def seed_pairs(ref: RSim, seed: int) -> None:
    """Seeded E/H pairs on the reference: f64 draws split into (hi, lo)."""
    from fdtd3d_tpu.ops import ds as rds
    rng = np.random.RandomState(seed)
    st = ref.state
    for grp in ("E", "H"):
        for c in st[grp]:
            st[grp][c], st["lo" + grp][c] = rds.from_f64(
                0.01 * rng.standard_normal(st[grp][c].shape))
    ref.state = st


def _rel(a, b, scale):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max()
                 / (scale + 1e-30))


@pytest.fixture(scope="module")
def reference_runs():
    """case -> (initial state, state after STEPS jnp-ds steps), numpy."""
    out = {}
    for i, (case, cfg) in enumerate(sorted(CASES.items())):
        ref = RSim(dataclasses.replace(cfg, use_pallas=False))
        assert ref.step_kind == "jnp_ds", ref.step_kind
        seed_pairs(ref, 20 + i)
        init = _np(ref.state)
        ref.advance(STEPS)
        out[case] = (init, _np(ref.state))
    return out


@pytest.mark.parametrize("use_pallas,kind", [(False, "plain_ds"),
                                             (True, "packed_ds_plain")])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ds_step_with_k_matches_reference_jnp_ds(case, use_pallas, kind,
                                                 reference_runs):
    init, want = reference_runs[case]
    port = TSim(to_port(dataclasses.replace(CASES[case],
                                            use_pallas=use_pallas)),
                device="cpu")
    assert port.step_kind == kind
    port.state = convert.state_from_reference(init)
    port.advance(STEPS)
    got = convert.state_to_reference(port.state)
    assert np.abs(got["K"]["Hx"]).max() > 0
    assert_ds_state_close(want, got)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("case", ["dng_sphere", "k_sphere_oblique",
                                  "uniform_jk"])
def test_kernel_schedule_with_k_matches_plain_step(case):
    """Four steps on the CUDA step's schedule (the line into a second
    buffer, one out-of-place pass, the spare set swapped in, K read and
    written at the H cell) against four of the in-place plain ds step
    (the reference's schedule), bit for bit on every leaf of the carry,
    K included, from a seeded carry (E/H pairs, J, K)."""
    cfg = to_port(dataclasses.replace(CASES[case], use_pallas=True))
    sim = TSim(cfg, device="cpu")
    sim.advance(2)
    g = torch.Generator().manual_seed(5)
    carry = sim._carry
    for key in ("E", "H"):
        hi, lo = tds.from_f64(0.01 * torch.randn(
            tuple(carry[key][:3].shape), generator=g,
            dtype=torch.float64).numpy())
        carry[key][:3] = torch.from_numpy(np.array(hi, np.float32))
        carry[key][3:] = torch.from_numpy(np.array(lo, np.float32))
    for key in ("J", "K"):
        if key in carry:
            carry[key].normal_(generator=g).mul_(1e-3)
    k_step = packed_ds.make_packed_ds_step(sim.static, "cpu")
    p_step = packed_ds.make_packed_ds_step(sim.static, "cpu", plain=True)
    cc = k_step.prepare(sim.coeffs)
    if case == "dng_sphere":
        # km/bm grids read inside the sphere's box, the background outside
        assert cc["H"]["box"] == ((4, 11), (4, 11), (4, 11))
    ck = carry
    cp = {k: ({a: v.clone() for a, v in x.items()} if isinstance(x, dict)
              else x.clone() if isinstance(x, torch.Tensor) else x)
          for k, x in carry.items()}
    for _ in range(4):
        ck = k_step(ck, cc)
        cp = p_step(cp, cc)
    assert ck["t"] == cp["t"] and "K" in cp
    for key, want in cp.items():
        if isinstance(want, dict):
            for sub, w in want.items():
                np.testing.assert_array_equal(_bits(ck[key][sub]), _bits(w),
                                              err_msg=f"{key}[{sub}]")
        elif isinstance(want, torch.Tensor):
            np.testing.assert_array_equal(_bits(ck[key]), _bits(want),
                                          err_msg=key)
    assert float(cp["K"].abs().max()) > 0


def _drude_1d(electric: bool):
    """tests/test_torch_modes.py's 1D dispersive slab, float32x2, K on."""
    wavelength = 15e-3
    wp = 1.2 * 2 * math.pi * 3e8 / wavelength
    sphere = SphereConfig(enabled=True, center=(70.0, 0.0, 0.0),
                          radius=14.0)
    return SimConfig(
        scheme="1D_EzHy", size=(96, 1, 1), time_steps=60, dx=1e-3,
        courant_factor=0.5, wavelength=wavelength, dtype="float32x2",
        pml=PmlConfig(size=(8, 0, 0)),
        tfsf=TfsfConfig(enabled=True, margin=(6, 0, 0), angle_teta=90.0,
                        angle_phi=0.0, angle_psi=180.0),
        materials=MaterialsConfig(
            use_drude=electric, eps_inf=1.0,
            omega_p=wp if electric else 0.0, gamma=1e9,
            drude_sphere=sphere, use_drude_m=True, mu_inf=1.0,
            omega_pm=wp, gamma_m=1e9, drude_m_sphere=sphere))


@pytest.mark.parametrize("electric", [False, True], ids=["K", "JK"])
def test_1d_float32x2_with_k_matches_reference_jnp_ds(electric):
    """1D float32x2 with K runs the plain ds step in both packages (every
    kernel is 3D-only): the port's against the reference's jnp-ds step."""
    want, got, ref, port = run_pair(_drude_1d(electric), seed=8)
    assert (ref.step_kind, port.step_kind) == ("jnp_ds", "plain_ds")
    assert np.abs(got["K"]["Hy"]).max() > 0
    assert_ds_state_close(want, got)


def test_health_counters_of_a_ds_k_carry_match_reference():
    cfg = CASES["dng_sphere"]
    port = TSim(to_port(dataclasses.replace(cfg, use_pallas=True)),
                device="cpu")
    rng = np.random.RandomState(9)
    for grp in ("E", "H"):
        for c, v in port.component_views().items():
            if c[0] == grp:
                port.set_field(c, 0.01 * rng.standard_normal(
                    tuple(v.shape)).astype(np.float32))
    port.advance(3)
    got = ttel.readback(ttel.make_health_fn(port.static)(
        port._dict_view()))
    st = jax.tree.map(jnp.asarray, convert.state_to_reference(port.state))
    from fdtd3d_tpu.solver import build_static
    want = {k: float(np.asarray(v)) for k, v in jax.device_get(
        rtel.make_health_fn(build_static(cfg))([st])).items()}
    assert got["finite"] and want["nonfinite"] == 0.0
    for k, tol in (("max_e", 1e-6), ("max_h", 1e-6), ("div_linf", 1e-6),
                   ("energy", 1e-5), ("div_l2", 1e-5)):
        assert abs(got[k] - want[k]) <= tol * abs(want[k]), \
            (k, got[k], want[k])
    port._dict_view()["K"]["Hz"].view(-1)[7] = float("nan")
    assert not ttel.readback(ttel.make_health_fn(port.static)(
        port._dict_view()))["finite"]


def test_ds_k_checkpoints_restore_across_packages(tmp_path,
                                                   reference_runs):
    """The reference's file of a ds K run in the port and the port's in
    the reference: every leaf (lo words, J, K, psi pairs, the line)
    restored bit for bit; the port's run resumed from its own file
    continues bit-equal to the uninterrupted run."""
    cfg = CASES["dng_sphere"]
    _init, want = reference_runs["dng_sphere"]
    ref = RSim(dataclasses.replace(cfg, use_pallas=False))
    ref.state = jax.tree.map(jnp.asarray, want)
    ref.checkpoint(str(tmp_path / "ref.npz"))
    port = TSim(to_port(dataclasses.replace(cfg, use_pallas=True)),
                device="cpu").restore(str(tmp_path / "ref.npz"))
    got = convert.state_to_reference(port.state)
    jax.tree.map(np.testing.assert_array_equal, _np(want), got)
    port.checkpoint(str(tmp_path / "port.npz"))
    back = _np(RSim(cfg).restore(str(tmp_path / "port.npz")).state)
    jax.tree.map(np.testing.assert_array_equal, _np(want), back)
    loaded, _meta = tio.load_checkpoint(str(tmp_path / "port.npz"))
    assert loaded["K"]["Hx"].dtype == np.float32
    port.advance(3)
    again = TSim(to_port(dataclasses.replace(cfg, use_pallas=True)),
                 device="cpu").restore(str(tmp_path / "port.npz"))
    again.advance(3)
    jax.tree.map(np.testing.assert_array_equal,
                 convert.state_to_reference(port.state),
                 convert.state_to_reference(again.state))


def test_supervised_nan_degrades_packed_ds_with_k_to_plain_ds(tmp_path):
    cfg = to_port(dataclasses.replace(
        CASES["k_sphere_oblique"], use_pallas=True, time_steps=12,
        output=OutputConfig(save_dir=str(tmp_path), checkpoint_every=4)))
    faults.install("nan@t=6")
    sup = Supervisor(cfg, device="cpu",
                     policy=RetryPolicy(sleep=lambda _s: None))
    assert sup.ensure_sim().step_kind == "packed_ds_plain"
    sim = sup.run(interval=2)
    assert sim.t == 12 and sup.rollbacks == 1 and sup.degrades == 1
    assert sim.step_kind == "plain_ds"
    assert all(np.isfinite(v).all() for v in sim.fields().values())
    assert np.isfinite(convert.state_to_reference(sim.state)["K"]["Hx"]) \
        .all()


def _norms(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith("[t=")]
    assert lines, out
    return lines[-1].split()[0], {
        k: float(v) for k, v in re.findall(r"([EH][xyz])=([\d.e+-]+)",
                                           lines[-1])}


# the precision example cut to 16^3 and 6 steps (XLA:CPU's compile of
# the reference's jnp-ds step grows with the grid: ~2.5 min at 32^3),
# with the DNG sphere of chip_smoke.dng_flags (electric and magnetic
# Drude on one sphere, omega_p = omega_pm = 3.7675e10 rad/s)
DNG_ARGV = ["--cmd-from-file", PRECISION, "--same-size", "16",
            "--time-steps", "6", "--save-res", "6", "--norms-every", "6",
            "--pml-size", "3", "--tfsf-margin", "2",
            "--drude-sphere-center-x", "8", "--drude-sphere-center-y",
            "8", "--drude-sphere-center-z", "8", "--drude-sphere-radius",
            "3", "--use-drude", "--omega-p", "3.7675e10",
            "--drude-m-sphere-center-x", "8", "--drude-m-sphere-center-y",
            "8", "--drude-m-sphere-center-z", "8",
            "--drude-m-sphere-radius", "3", "--use-drude-m", "--omega-pm",
            "3.7675e10"]


def test_cli_float32x2_with_k_matches_reference_cli(tmp_path, capsys):
    """The precision example with a double-negative sphere through both
    CLIs (the reference's jnp-ds step; the port's plain ds step and its
    packed-ds step): the printed norms to their last digit, the DAT
    dumps (hi words, f32) at the field gate, the manifests byte for
    byte."""
    ref_dir = tmp_path / "ref"
    assert rcli.main(DNG_ARGV + ["--save-dir", str(ref_dir)]) == 0
    t_ref, want = _norms(capsys.readouterr().out)
    for extra in ([], ["--use-pallas", "on"]):
        port_dir = tmp_path / f"port{len(extra)}"
        assert tcli.main(DNG_ARGV + extra + ["--save-dir", str(port_dir),
                                             "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert ("step_kind=packed_ds_plain" if extra
                else "step_kind=plain_ds") in out
        t_port, got = _norms(out)
        assert t_port == t_ref and set(got) == set(want)
        for c, v in want.items():
            scale = max(w for k, w in want.items() if k[0] == c[0])
            assert abs(got[c] - v) <= 1e-4 * scale, (c, got[c], v)
        assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
        for fam in "EH":
            comps = [c for c in want if c[0] == fam]
            pairs = {c: (rio.load_dat(str(ref_dir / f"{c}_t000006.dat")),
                         tio.load_dat(str(port_dir / f"{c}_t000006.dat")))
                     for c in comps}
            scale = max(np.abs(a).max() for a, _b in pairs.values())
            assert scale > 0
            for c, (a, b) in pairs.items():
                assert b.dtype == np.float32
                assert _rel(a, b, scale) < FIELD_TOL, c
                name = f"{c}_t000006.dat.manifest.json"
                assert (port_dir / name).read_bytes() == \
                    (ref_dir / name).read_bytes()

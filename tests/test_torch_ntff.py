"""The port's near-to-far-field transform (fdtd3d_torch/ntff.py) against
the JAX reference's (fdtd3d_tpu/ntff.py) on the CPU.

* the accumulators and the directivity pattern of the same 24^3
  point-source run in both packages: rel 1e-6 of the max in f32 (the
  fields differ at the f32 gate), 1e-12 in f64;
* the sampling rules on the same numbers: the reference's collector fed
  the port's fields as the port samples them (a bf16 field widened to
  f32 before the H average, the hi words of a float32x2 run) equals the
  port's collector at 1e-7; and the bf16 run against the reference's
  bf16 run at the bf16 gate, 2e-2;
* the dipole's sin^2(theta) pattern (tests/test_exact_ntff.py:111's
  gates) on the port's temporal-blocked pass (its plain version), whose
  buffer swaps the collector must follow;
* the box: margin-derived, explicit (the same pattern), every invalid
  box and a half-given one raising the reference's errors, and a 2D sim
  refused;
* a supervised run whose NaN trip degrades the kernel: the collector
  follows the live sim and its pattern matches the uninterrupted run's.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import to_port

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import faults
from fdtd3d_torch.ntff import NtffCollector as TCol
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu import physics
from fdtd3d_tpu.config import (NtffConfig, PmlConfig, PointSourceConfig,
                               SimConfig)
from fdtd3d_tpu.ntff import NtffCollector as RCol
from fdtd3d_tpu.sim import Simulation as RSim

THETAS = [0.0, 30.0, 60.0, 90.0, 135.0, 180.0]
PHIS = [0.0, 45.0, 90.0, 200.0]


def dipole(n=24, npml=4, **kw):
    base = dict(scheme="3D", size=(n, n, n), time_steps=0, dx=1e-3,
                courant_factor=0.5, wavelength=8e-3,
                pml=PmlConfig(size=(npml,) * 3),
                point_source=PointSourceConfig(
                    enabled=True, component="Ez", position=(n // 2,) * 3))
    base.update(kw)
    return SimConfig(**base)


def freq(cfg):
    return physics.C0 / cfg.wavelength


def rel_max(want, got):
    return np.abs(np.asarray(want) - np.asarray(got)).max() \
        / np.abs(np.asarray(want)).max()


def acc_rel(want, got):
    assert list(want) == list(got)
    scale = max(np.abs(v).max() for v in want.values())
    return max(np.abs(want[k] - got[k]).max() for k in want) / scale


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("float64", 1e-12),
                                       ("bfloat16", 2e-2)])
def test_accumulators_and_pattern_match_reference(dtype, tol):
    cfg = dipole(dtype=dtype)
    ref, port = RSim(cfg), TSim(to_port(cfg), device="cpu")
    rc, tc = RCol(ref, freq(cfg)), TCol(port, freq(cfg))
    assert tc.lo == rc.lo == (6, 6, 6) and tc.hi == rc.hi == (17, 17, 17)
    assert len(tc.keys) == 24 and list(tc.keys) == rc._keys
    ref.advance(20)
    port.advance(20)
    for _ in range(12):
        ref.advance(3)
        port.advance(3)
        rc.sample()
        tc.sample()
    assert tc.n_samples == rc.n_samples == 12
    assert acc_rel(rc.acc, tc.acc) < tol
    want = rc.directivity_pattern(THETAS, PHIS)
    got = tc.directivity_pattern(THETAS, PHIS)
    assert got.shape == (len(THETAS), len(PHIS))
    assert rel_max(want, got) < tol
    et, ep = rc.far_field(60.0, 200.0)
    gt, gp = tc.far_field(60.0, 200.0)
    assert abs(gt - et) + abs(gp - ep) < tol * (abs(et) + abs(ep))


def _fed_reference(ref, fields, t):
    """A stand-in Simulation for the reference's collector: its static
    and config, ``fields`` as its state at step ``t``."""
    state = {g: {c: jnp.asarray(v) for c, v in fields.items()
                 if c[0] == g} for g in "EH"}
    return types.SimpleNamespace(static=ref.static, cfg=ref.cfg, t=t,
                                 state=state)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32x2"])
def test_sampling_rule_matches_reference_on_the_same_fields(dtype):
    """bf16 planes widened before the H average, float32x2's hi words:
    the reference's collector fed exactly those numbers agrees."""
    cfg = dipole(dtype=dtype)
    port = TSim(to_port(cfg), device="cpu")
    ref = RSim(dataclasses.replace(cfg, dtype="float32"))
    tc, rc = TCol(port, freq(cfg)), RCol(ref, freq(cfg))
    port.advance(20)
    for _ in range(10):
        port.advance(3)
        tc.sample()
        rc.sim = _fed_reference(ref, port.fields(), port.t)
        rc.sample()
    assert port.fields()["Ez"].dtype == np.float32
    assert acc_rel(rc.acc, tc.acc) < 1e-7
    want = rc.directivity_pattern(THETAS, PHIS)
    assert rel_max(want, tc.directivity_pattern(THETAS, PHIS)) < 1e-7


def test_dipole_pattern_is_sin_squared():
    """A z-directed point current radiates sin^2(theta): the gates of
    tests/test_exact_ntff.py:111 on the port's temporal-blocked pass
    (its plain version; an odd stride runs passes and a tail step), at
    32^3 with a 10-cell wavelength (the reference's 48^3 and 12 cells
    cut to the CPU's budget; the gates hold unchanged)."""
    n = 32
    cfg = dipole(n=n, npml=6, wavelength=10e-3, use_pallas=True)
    sim = TSim(to_port(cfg), device="cpu")
    assert sim.step_kind == "packed_tb_plain"
    sim.advance(150)
    col = TCol(sim, frequency=freq(cfg),
               box=((8, 8, 8), (n - 8, n - 8, n - 8)))
    for _ in range(32):
        sim.advance(3)        # ~12 samples a period (34.6 steps)
        col.sample()
    p90 = col.directivity_pattern([90.0], [0.0, 90.0, 180.0, 270.0])[0]
    p90d = col.directivity_pattern([90.0], [45.0])[0, 0]
    r45 = col.directivity_pattern([45.0], [0.0])[0, 0] / p90.mean()
    r10 = col.directivity_pattern([10.0], [0.0])[0, 0] / p90.mean()
    assert p90.max() / p90.min() < 1.2, f"phi asymmetry {p90}"
    assert 0.6 < p90d / p90.mean() < 1.4
    assert 0.35 < r45 < 0.75, f"D(45)/D(90) = {r45:.3f}"
    assert r10 < 0.15, f"D(10)/D(90) = {r10:.3f}"


def test_explicit_box_equals_the_margin_box():
    cfg = dipole()
    sim = TSim(to_port(cfg), device="cpu")
    a = TCol(sim, freq(cfg), margin=3)
    b = TCol(sim, freq(cfg), box=((7, 7, 7), (16, 16, 16)))
    boxed = TSim(to_port(dataclasses.replace(cfg, ntff=NtffConfig(
        box_lo=(7, 7, 7), box_hi=(16, 16, 16)))), device="cpu")
    c = TCol(boxed, freq(cfg), margin=0)
    assert a.lo == b.lo == c.lo == (7, 7, 7)
    for _ in range(6):
        sim.advance(4)
        boxed.advance(4)
        for col in (a, b, c):
            col.sample()
    pa = a.directivity_pattern(THETAS, PHIS)
    assert np.array_equal(pa, b.directivity_pattern(THETAS, PHIS))
    assert np.array_equal(pa, c.directivity_pattern(THETAS, PHIS))


@pytest.mark.parametrize("box", [((0, 5, 5), (18, 18, 18)),
                                 ((5, 5, 5), (18, 24, 18)),
                                 ((5, 5, 9), (18, 18, 9)),
                                 ((5, 5, 5), (18, 18, 4))])
def test_invalid_box_raises_as_the_reference(box):
    cfg = dipole()
    ref, port = RSim(cfg), TSim(to_port(cfg), device="cpu")
    with pytest.raises(ValueError) as want:
        RCol(ref, freq(cfg), box=box)
    with pytest.raises(ValueError) as got:
        TCol(port, freq(cfg), box=box)
    assert str(got.value) == str(want.value)


def test_half_given_box_and_other_modes_raise():
    cfg = dataclasses.replace(dipole(), ntff=NtffConfig(box_lo=(6, 6, 6)))
    ref, port = RSim(cfg), TSim(to_port(cfg), device="cpu")
    with pytest.raises(ValueError, match="set together"):
        RCol(ref, freq(cfg))
    with pytest.raises(ValueError, match="set together"):
        TCol(port, freq(cfg))
    with pytest.raises(SystemExit, match="given together"):
        tcli.main(["--3d", "--same-size", "24", "--time-steps", "4",
                   "--ntff", "--ntff-box-hi", "17,17,17", "--device",
                   "cpu"])
    flat = TSim(to_port(SimConfig(scheme="2D_TMz", size=(24, 24, 1))),
                device="cpu")
    with pytest.raises(ValueError, match="3D scheme"):
        TCol(flat, 1e10)
    clean = TSim(to_port(dipole()), device="cpu")
    with pytest.raises(RuntimeError, match="no samples"):
        TCol(clean, freq(cfg), margin=3).far_field(90.0, 0.0)


def test_accumulators_stay_on_the_device_until_read():
    cfg = dipole()
    sim = TSim(to_port(cfg), device="cpu")
    col = TCol(sim, freq(cfg))
    sim.advance(10)
    col.sample()
    assert col.device_bytes() == 24 * 4 * 12 * 12 * 4
    first = col.acc
    assert col.acc is first            # cached until the next sample
    sim.advance(2)
    col.sample()
    assert col.acc is not first
    assert all(v.dtype == np.complex128 and v.shape == (12, 12)
               for v in col.acc.values())


def _cli_dipole(save_dir):
    return ["--3d", "--same-size", "24", "--time-steps", "60",
            "--courant-factor", "0.5", "--wavelength", "12e-3", "--use-pml",
            "--pml-size", "4", "--point-source", "Ez", "--ntff",
            "--ntff-margin", "2", "--ntff-theta-steps", "5",
            "--ntff-phi-steps", "4", "--use-pallas", "on",
            "--checkpoint-every", "12", "--save-dir", str(save_dir),
            "--device", "cpu"]


def test_supervised_degrade_keeps_the_collector_on_the_live_sim(
        tmp_path, capsys):
    """A NaN at t=42 (the first sample is at 30, every 3) trips the
    temporal-blocked run; the supervisor rolls back and degrades to the
    packed step; the pattern equals the uninterrupted run's within f32
    noise."""
    assert tcli.main(_cli_dipole(tmp_path / "clean")) == 0
    faults.install("nan@t=42,field=Ez")
    try:
        assert tcli.main(_cli_dipole(tmp_path / "sup")
                         + ["--supervise"]) == 0
    finally:
        faults.clear()
    out = capsys.readouterr().out
    assert "ladder degrades (now packed_plain)" in out
    assert "ntff: " in out
    want = np.loadtxt(tmp_path / "clean" / "ntff_pattern.txt")
    got = np.loadtxt(tmp_path / "sup" / "ntff_pattern.txt")
    assert want.shape == got.shape == (20, 3)
    assert np.isfinite(got).all()
    assert np.abs(want - got).max() < 1e-5


def test_cli_pattern_matches_reference_cli(tmp_path):
    """tests/test_exact_ntff.py's CLI run on both packages, cut to 24^3
    and 60 steps: the pattern files agree at 1e-6."""
    from fdtd3d_tpu import cli as rcli
    argv = ["--3d", "--same-size", "24", "--time-steps", "60",
            "--courant-factor", "0.5", "--wavelength", "12e-3",
            "--use-pml", "--pml-size", "4", "--point-source", "Ez",
            "--ntff", "--ntff-margin", "2", "--ntff-theta-steps", "7",
            "--ntff-phi-steps", "8"]
    assert rcli.main(argv + ["--save-dir", str(tmp_path / "ref")]) == 0
    assert tcli.main(argv + ["--save-dir", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    want = np.loadtxt(tmp_path / "ref" / "ntff_pattern.txt")
    rows = np.loadtxt(tmp_path / "port" / "ntff_pattern.txt")
    assert rows.shape == (56, 3)
    assert np.array_equal(want[:, :2], rows[:, :2])
    assert np.abs(want[:, 2] - rows[:, 2]).max() < 1e-6
    with open(tmp_path / "port" / "ntff_pattern.txt") as f:
        assert f.readline() == \
            "# theta_deg phi_deg directivity(normalized)\n"

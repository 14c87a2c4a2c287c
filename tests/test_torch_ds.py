"""The port's double-single arithmetic against the reference's, on the
CPU, bit for bit: every error-free-transform primitive of
fdtd3d_torch/ops/ds.py against fdtd3d_tpu/ops/ds.py on seeded inputs
with widely spread exponents (as tests/test_ds.py spreads them),
``from_f64``, the ds oscillator ``sin2pi``, the exact source phase and
the ds waveform at steps past 2^24, and 50 steps of the ds incident
line against the reference's ``_advance_einc_ds``/``_advance_hinc_ds``.
The Gaussian pulse's f32 envelope and the Ricker wavelet (an f32
``exp`` of each library) are held at 2 ulp instead."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import ref_config, to_port

from fdtd3d_torch import solver as tsolver
from fdtd3d_torch.ops import ds as tds
from fdtd3d_torch.ops import sources as tsources
from fdtd3d_torch.ops import tfsf as ttfsf
from fdtd3d_tpu import solver as rsolver
from fdtd3d_tpu.ops import ds as rds
from fdtd3d_tpu.ops import sources as rsources
from fdtd3d_tpu.ops import tfsf as rtfsf

SHAPE = (8, 128)


def _wide(rng):
    """f32 values with exponents spread over 2^-18 .. 2^18."""
    return (rng.standard_normal(SHAPE)
            * np.exp2(rng.integers(-18, 18, SHAPE))).astype(np.float32)


def _pair(rng):
    hi, lo = rds.from_f64(rng.standard_normal(SHAPE)
                          * np.exp2(rng.integers(-18, 18, SHAPE)))
    return hi, lo


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.numpy(), np.float32),
                                      np.asarray(w, np.float32))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("name", ["two_sum", "two_diff", "two_prod"])
def test_eft_two_operand_bit_exact(name):
    rng = np.random.default_rng(5)
    a, b = _wide(rng), _wide(rng)
    _same(getattr(tds, name)(_t(a), _t(b)),
          getattr(rds, name)(jnp.asarray(a), jnp.asarray(b)))


def test_split_bit_exact():
    a = _wide(np.random.default_rng(6))
    _same(tds.split(_t(a)), rds.split(jnp.asarray(a)))


@pytest.mark.parametrize("name", ["add_ff", "sub_ff", "mul_ff"])
def test_pair_pair_bit_exact(name):
    rng = np.random.default_rng(7)
    (ah, al), (bh, bl) = _pair(rng), _pair(rng)
    _same(getattr(tds, name)(_t(ah), _t(al), _t(bh), _t(bl)),
          getattr(rds, name)(*(jnp.asarray(v) for v in (ah, al, bh, bl))))


@pytest.mark.parametrize("name", ["add_f", "scale_f"])
def test_pair_single_bit_exact(name):
    rng = np.random.default_rng(8)
    (ah, al), b = _pair(rng), _wide(rng)
    _same(getattr(tds, name)(_t(ah), _t(al), _t(b)),
          getattr(rds, name)(*(jnp.asarray(v) for v in (ah, al, b))))


def test_neg_to_f32_from_f64():
    rng = np.random.default_rng(9)
    ah, al = _pair(rng)
    _same(tds.neg(_t(ah), _t(al)), rds.neg(jnp.asarray(ah),
                                           jnp.asarray(al)))
    _same(tds.to_f32(_t(ah), _t(al)),
          rds.to_f32(jnp.asarray(ah), jnp.asarray(al)))
    x = rng.standard_normal(SHAPE) * np.exp2(rng.integers(-40, 40, SHAPE))
    for got, want in zip(tds.from_f64(x), rds.from_f64(x)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    hi, lo = tds.from_f64(x)
    assert np.all(np.abs(lo) <= np.spacing(np.abs(hi)) / 2)


def test_sin2pi_bit_exact():
    rng = np.random.default_rng(10)
    f = rng.uniform(0.0, 2.0, SHAPE)
    fh = (np.floor(f * 2 ** 24) / 2 ** 24).astype(np.float32)
    fl = (f - fh.astype(np.float64)).astype(np.float32)
    got = tds.sin2pi(_t(fh), _t(fl))
    _same(got, rds.sin2pi(jnp.asarray(fh), jnp.asarray(fl)))
    err = np.abs(got[0].numpy().astype(np.float64) + got[1].numpy()
                 - np.sin(2 * np.pi * (fh.astype(np.float64) + fl)))
    assert err.max() < 1e-12


STEPS = (0, 1, 7, 999, 65535, 65536, 2 ** 24 - 1, 2 ** 24 + 3, 123456789,
         2 ** 31 - 1)


def test_phase_frac_ds_bit_exact():
    for f in (0.0123456789, 0.4999999, 0.987654321):
        fh, fl = tsources.phase_frac_ds(STEPS, f)
        for i, s in enumerate(STEPS):
            wh, wl = rsources.phase_frac_ds(jnp.int32(s), f)
            assert fh[i].item() == float(wh) and fl[i].item() == float(wl), \
                (f, s)


@pytest.mark.parametrize("kind", ["sin", "gauss_pulse", "ricker"])
def test_waveform_ds_matches_reference(kind):
    omega, dt = 2.35e11, 9.6e-13
    for off in (0.5, 1.0):
        gh, gl = tsources.waveform_ds(kind, STEPS, off, omega, dt)
        for i, s in enumerate(STEPS):
            wh, wl = (np.float32(v) for v in rsources.waveform_ds(
                kind, jnp.int32(s), off, omega, dt))
            if kind != "sin":
                # an f32 exp of each library: 2 ulp
                tol = 2 * np.spacing(np.abs(wh))
                assert abs(gh[i].item() - wh) <= tol, (s, off)
                continue
            assert (gh[i].item(), gl[i].item()) == (wh, wl), (kind, s, off)


def test_source_table_matches_single_steps():
    """The block-evaluated table gives each step the bits of a single
    waveform_ds call times the amplitude pair."""
    omega, dt = 2.35e11, 9.6e-13
    table = tsources.DsSourceTable("sin", 0.5, omega, dt, 0.7, block=16)
    for s in (0, 5, 15, 16, 40, 3):
        wh, wl = tsources.waveform_ds("sin", [s], 0.5, omega, dt)
        want = tds.mul_ff(wh, wl, *tds.pair_tensors(0.7, wh))
        assert table(s) == (want[0].item(), want[1].item())


def test_incident_line_50_steps_bit_exact():
    cfg = ref_config("oblique_tfsf", dtype="float32x2")
    rs = rsolver.build_static(cfg)
    ts = tsolver.build_static(to_port(cfg))
    rc = {k: jnp.asarray(v) for k, v in rsolver.build_coeffs(rs).items()}
    tc = tsolver.coeffs_to_device(tsolver.build_coeffs(ts), "cpu")
    n = rs.tfsf_setup.n_inc
    rng = np.random.default_rng(11)
    init = {}
    for key in ("Einc", "Hinc"):
        init[key], init[f"{key}_lo"] = rds.from_f64(
            0.1 * rng.standard_normal(n))
    rinc = {k: jnp.asarray(v) for k, v in init.items()}
    tinc = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    src = ttfsf.line_source(ts.tfsf_setup, ts.omega, ts.dt)
    for step in range(50):
        rinc = rtfsf.advance_hinc(rtfsf.advance_einc(
            rinc, rc, jnp.int32(step), rs.dt, rs.omega, rs.tfsf_setup),
            rc, rs.tfsf_setup)
        tinc = ttfsf.advance_hinc(ttfsf.advance_einc(
            tinc, tc, step, ts.dt, ts.omega, ts.tfsf_setup, source=src),
            tc, ts.tfsf_setup)
    for k in init:
        np.testing.assert_array_equal(tinc[k].numpy(), np.asarray(rinc[k]),
                                      err_msg=k)
    assert np.abs(np.asarray(rinc["Einc"])).max() > 1e-3

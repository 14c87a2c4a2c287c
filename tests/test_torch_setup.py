"""The PyTorch port's setup and step building blocks against the
reference's, on the CPU: coefficients and initial state array by array,
the source waveforms, the point mask, the TFSF incident line and face
corrections, and the state carried across by fdtd3d_torch.convert."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import CASES, MODE_CASES, ref_config, to_port

from fdtd3d_torch import convert
from fdtd3d_torch import solver as tsolver
from fdtd3d_torch.ops import packed as tpacked
from fdtd3d_torch.ops import sources as tsources
from fdtd3d_torch.ops import tfsf as ttfsf
from fdtd3d_tpu import solver as rsolver
from fdtd3d_tpu.ops import sources as rsources
from fdtd3d_tpu.ops import tfsf as rtfsf


def _statics(case):
    cfg = ref_config(case)
    return rsolver.build_static(cfg), tsolver.build_static(to_port(cfg))


@pytest.mark.parametrize("case", sorted(CASES) + sorted(MODE_CASES))
def test_build_coeffs_equal_reference(case):
    rs, ts = _statics(case)
    want = rsolver.build_coeffs(rs)
    got = tsolver.build_coeffs(ts)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_state_equals_reference(case):
    rs, ts = _statics(case)
    want = jnp_to_np(rsolver.init_state(rs))
    got = convert.state_to_reference(tsolver.init_state(ts, "cpu"))

    def walk(a, b, path):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert a[k].shape == b[k].shape, f"{path}/{k}"
                assert a[k].dtype == b[k].dtype, f"{path}/{k}"
                np.testing.assert_array_equal(a[k], b[k])
    walk(want, got, "")


def jnp_to_np(tree):
    if isinstance(tree, dict):
        return {k: jnp_to_np(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("kind", ["sin", "gauss_pulse", "ricker"])
def test_waveform_matches_reference(kind):
    omega, dt = 2.35e11, 9.6e-13
    for step in (0, 1, 7, 150, 4097, 123457):
        for off in (0.5, 1.0):
            want = float(rsources.waveform(kind, jnp.int32(step), off,
                                           omega, dt, np.float32))
            got = float(tsources.waveform(kind, step, off, omega, dt,
                                          np.float32))
            assert abs(got - want) <= 4e-7 * max(1.0, abs(want)), \
                (kind, step, off, got, want)


def test_phase_frac_bit_exact():
    for f in (0.0123456789, 0.4999999, 0.987654321):
        for step in (0, 1, 65535, 65536, 2 ** 31 - 1):
            want = np.float32(rsources._phase_frac(jnp.int32(step), f))
            assert tsources._phase_frac(step, f) == want


def test_point_mask_matches_reference():
    g = [np.arange(n, dtype=np.int32) for n in (5, 6, 7)]
    want = np.asarray(rsources.point_mask(*[jnp.asarray(x) for x in g],
                                          (2, 3, 4), (0, 1, 2)))
    got = tsources.point_mask(*[torch.from_numpy(x) for x in g],
                              (2, 3, 4), (0, 1, 2)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["oblique_tfsf", "kitchen_sink"])
def test_tfsf_line_and_corrections_match_reference(case):
    rs, ts = _statics(case)
    assert ts.tfsf_setup == ts.tfsf_setup.__class__(
        **{f: getattr(rs.tfsf_setup, f) if f != "corrections" else tuple(
            ttfsf.Correction(**vars(c)) for c in rs.tfsf_setup.corrections)
           for f in ts.tfsf_setup.__dataclass_fields__})
    np_c = rsolver.build_coeffs(rs)
    rc = {k: jnp.asarray(v) for k, v in np_c.items()}
    tc = convert.coeffs_from_reference(np_c)
    rng = np.random.RandomState(3)
    n = rs.tfsf_setup.n_inc
    inc = {"Einc": rng.standard_normal(n).astype(np.float32),
           "Hinc": 0.01 * rng.standard_normal(n).astype(np.float32)}
    rinc = {k: jnp.asarray(v) for k, v in inc.items()}
    tinc = {k: torch.from_numpy(v.copy()) for k, v in inc.items()}
    for field, comps in (("E", rs.mode.e_components),
                         ("H", rs.mode.h_components)):
        for c in comps:
            want = rtfsf.corrections_for(field, c, rs.tfsf_setup, rc, rinc,
                                         rs.mode.active_axes, rs.dx)
            got = ttfsf.corrections_for(field, c, ts.tfsf_setup, tc, tinc,
                                        ts.mode.active_axes, ts.dx)
            if want is None:
                assert got is None, (field, c)
                continue
            want = np.broadcast_to(np.asarray(want), rs.grid_shape)
            got = np.broadcast_to(got.numpy(), rs.grid_shape)
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 1e-6 * scale, (field, c)
    for step in (0, 3, 40):
        want = rtfsf.advance_hinc(rtfsf.advance_einc(
            rinc, rc, jnp.int32(step), rs.dt, rs.omega, rs.tfsf_setup),
            rc, rs.tfsf_setup)
        got = ttfsf.advance_hinc(ttfsf.advance_einc(
            tinc, tc, step, ts.dt, ts.omega, ts.tfsf_setup),
            tc, ts.tfsf_setup)
        for k in ("Einc", "Hinc"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-6 * np.abs(
                                           np.asarray(want[k])).max())


@pytest.mark.parametrize("case", ["kitchen_sink", "drude_sphere"])
def test_pack_unpack_roundtrip(case):
    _, ts = _statics(case)
    st = tsolver.init_state(ts, "cpu")
    gen = torch.Generator().manual_seed(5)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif isinstance(v, torch.Tensor):
                v.copy_(torch.randn(v.shape, generator=gen))
    fill(st)
    st["t"] = 11
    back = tpacked.unpack(tpacked.pack(st, ts), ts)
    want = convert.state_to_reference(st)
    got = convert.state_to_reference(back)

    def walk(a, b):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k])
    walk(want, got)


def test_convert_roundtrip_keeps_reference_form():
    rs, ts = _statics("kitchen_sink")
    want = jnp_to_np(rsolver.init_state(rs))
    want["E"]["Ez"] = np.full(want["E"]["Ez"].shape, 2.5, np.float32)
    back = convert.state_to_reference(convert.state_from_reference(want))
    assert back["t"].dtype == np.int32
    np.testing.assert_array_equal(back["E"]["Ez"], want["E"]["Ez"])
    assert set(back) == set(want)


@pytest.mark.parametrize("case", ["kitchen_sink", "oblique_tfsf",
                                  "drude_sphere"])
def test_ds_coeffs_and_init_state_equal_reference(case):
    """float32x2: the *_lo coefficient words, the ds CPML profile pairs
    (pml_*lo_*), the ds incident-line coefficients and the lo state
    keys, key for key and bit for bit."""
    cfg = ref_config(case, dtype="float32x2")
    rs = rsolver.build_static(cfg)
    ts = tsolver.build_static(to_port(cfg))
    want = rsolver.build_coeffs(rs)
    got = tsolver.build_coeffs(ts)
    assert set(got) == set(want)
    assert any(k.endswith("_lo") for k in want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)
    want_st = jnp_to_np(rsolver.init_state(rs))
    got_st = convert.state_to_reference(tsolver.init_state(ts, "cpu"))
    assert {"loE", "loH"} <= set(got_st) and set(got_st) == set(want_st)
    for k in want_st:
        if k == "t":
            continue
        assert set(got_st[k]) == set(want_st[k]), k
        for c in want_st[k]:
            assert got_st[k][c].shape == want_st[k][c].shape, (k, c)
            assert got_st[k][c].dtype == want_st[k][c].dtype, (k, c)


def test_float64_coeffs_equal_reference():
    """float64: every coefficient in f64, as the reference builds them
    (its static is made f64 without flipping jax's global x64 switch)."""
    cfg = ref_config("kitchen_sink", dtype="float64")
    rs = dataclasses.replace(rsolver.build_static(ref_config("kitchen_sink")),
                             cfg=cfg, real_dtype=np.float64,
                             field_dtype=np.float64)
    ts = tsolver.build_static(to_port(cfg))
    assert ts.real_dtype == np.float64
    want = rsolver.build_coeffs(rs)
    got = tsolver.build_coeffs(ts)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)
    st = tsolver.init_state(ts, "cpu")
    assert st["E"]["Ez"].dtype == st["psi_E"]["Ez_x"].dtype == \
        st["inc"]["Einc"].dtype == torch.float64


def test_convert_roundtrips_ds_state():
    """loE, loH, lopsi_E, lopsi_H and inc/*_lo cross both ways, and
    through a packed-ds Simulation's carry, unchanged."""
    from fdtd3d_torch.sim import Simulation
    cfg = ref_config("kitchen_sink", dtype="float32x2")
    rs = rsolver.build_static(cfg)
    want = jnp_to_np(rsolver.init_state(rs))
    rng = np.random.RandomState(4)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k != "t":
                tree[k] = rng.standard_normal(v.shape).astype(v.dtype)
    fill(want)
    want["t"] = np.asarray(5, np.int32)
    for k in ("loE", "loH", "lopsi_E", "lopsi_H"):
        assert k in want
    assert {"Einc_lo", "Hinc_lo"} <= set(want["inc"])
    back = convert.state_to_reference(convert.state_from_reference(want))
    sim = Simulation(to_port(dataclasses.replace(cfg, use_pallas=True)),
                     device="cpu")
    assert sim.step_kind == "packed_ds_plain"
    sim.state = convert.state_from_reference(want)
    through = convert.state_to_reference(sim.state)

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=path + k)
    walk(want, back)
    walk(want, through)

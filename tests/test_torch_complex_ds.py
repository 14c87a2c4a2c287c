"""Complex fields with float32x2 (double-single) values: the paired real
legs, each a ds leg, against the JAX reference on the CPU.

The reference runs complex float32x2 only as two real legs
(``complex2x_<leg kind>``; its native complex jnp-ds route fails on its
first complex clip), each leg its real ds step: on the CPU under its
test hook ``FDTD3D_FORCE_PAIRED_COMPLEX`` (monkeypatched here), kind
``complex2x_jnp_ds``. The port's legs are its plain ds step (kind
``complex2x_plain_ds``) or the plain versions of the packed-ds CUDA
launches (``complex2x_packed_ds_plain``; on the card
``complex2x_packed_ds_cuda``). Without the hook on the CPU the port
raises a ValueError naming the paired route.

From one seeded complex state (a double-negative sphere, J and K, xyz
CPML), the states are compared leaf by leaf in the reference's unpacked
form after the steps, dtypes included (every floating leaf complex64,
the low words too), at the reference's ds gates: E and H (hi and lo) at
1e-6 of the family's max, J and K at 1e-5, psi at 1e-6 of its max, the
incident line at 1e-12. Also, on the port alone: the re leg of a
TFSF-driven complex run bit-equal to the real float32x2 run and its im
leg exactly 0; a mid-run checkpoint resumed bit-equal; and across the
packages: checkpoints restored both ways, the health counters of the
two ds legs, the far-field accumulators, the CLI's norms and ``<c8``
DAT dumps, a supervised NaN walking ``complex2x_packed_ds_plain`` to
``complex2x_plain_ds``, and the batch's refusal of float32x2.
"""

import contextlib
import dataclasses
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import ref_config, to_port

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import convert, faults
from fdtd3d_torch import io as tio
from fdtd3d_torch import telemetry as ttel
from fdtd3d_torch.batch import BatchSimulation
from fdtd3d_torch.ntff import NtffCollector as TCol
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_torch.supervisor import RetryPolicy, Supervisor
from fdtd3d_tpu import cli as rcli
from fdtd3d_tpu import io as rio
from fdtd3d_tpu import physics
from fdtd3d_tpu import telemetry as rtel
from fdtd3d_tpu.config import MaterialsConfig, OutputConfig, SphereConfig
from fdtd3d_tpu.ntff import NtffCollector as RCol
from fdtd3d_tpu.sim import Simulation as RSim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRECISION = os.path.join(ROOT, "Examples", "precision3D_float32x2.txt")
PAIRED = "FDTD3D_FORCE_PAIRED_COMPLEX"
FIELD_TOL, PSI_TOL, ADE_TOL, LINE_TOL = 1e-6, 1e-6, 1e-5, 1e-12
OMEGA = 2.0 * np.pi * 3e8 / 8e-3
SPHERE = SphereConfig(enabled=True, center=(8.0, 8.0, 8.0), radius=4.0)
DNG = MaterialsConfig(use_drude=True, eps_inf=1.0, omega_p=0.3 * OMEGA,
                      gamma=1e9, drude_sphere=SPHERE, use_drude_m=True,
                      mu_inf=1.0, omega_pm=0.3 * OMEGA, gamma_m=1e9,
                      drude_m_sphere=SPHERE)
# seeded complex fields, no source: the reference's paired jnp-ds legs
# compile in ~20 s on XLA:CPU (with an oblique TFSF line, minutes)
CFG = ref_config("xyz_cpml", dtype="float32x2", complex_fields=True,
                 materials=DNG)
# a real-driven complex run (oblique TFSF onto a K sphere): port only
DRIVEN = dict(dtype="float32x2", materials=MaterialsConfig(
    use_drude_m=True, mu_inf=1.5, omega_pm=1e11, gamma_m=1e10,
    drude_m_sphere=SphereConfig(enabled=True, center=(8, 8, 8), radius=3)))
STEPS, SAMPLES = 2, 2        # the reference advances 2 steps a sample


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in (PAIRED, "FDTD3D_NO_TEMPORAL", "FDTD3D_NO_PACKED",
              "FDTD3D_NO_FUSED", "FDTD3D_FORCE_FUSED", "FDTD3D_FAULT_PLAN"):
        monkeypatch.delenv(k, raising=False)
    faults.clear()
    yield monkeypatch
    faults.clear()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def seeded_fields(sim, seed):
    """{comp: complex128 array} of 0.01 N(0, 1) real and imaginary
    parts, for the components of ``sim`` (either package)."""
    rng = np.random.RandomState(seed)
    st = sim.state
    return {c: 0.01 * rng.standard_normal(st[g][c].shape)
            + 0.01j * rng.standard_normal(st[g][c].shape)
            for g in ("E", "H") for c in st[g]}


def seed(sim, fields):
    for c, v in fields.items():
        sim.set_field(c, v.astype(np.complex64))
    return sim


def freq():
    return physics.C0 / CFG.wavelength


@pytest.fixture(scope="module")
def reference():
    """The reference's paired run of CFG: (seeded fields, its state after
    STEPS * SAMPLES steps, its NTFF collector sampled every STEPS, its
    checkpoint file's directory)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(PAIRED, "1")
        ref = RSim(CFG)
        assert ref.step_kind == "complex2x_jnp_ds", ref.step_kind
        fields = seeded_fields(ref, 31)
        seed(ref, fields)
        col = RCol(ref, freq())
        for _ in range(SAMPLES):
            ref.advance(STEPS)
            col.sample()
        return fields, _np(ref.state), col, ref


def port_run(fields, use_pallas=None, steps=STEPS * SAMPLES):
    port = TSim(to_port(dataclasses.replace(CFG, use_pallas=use_pallas)),
                device="cpu")
    seed(port, fields)
    port.advance(steps)
    return port


def check_complex_state(want, got, path=""):
    """Leaf by leaf in the reference's form: the same keys, shapes and
    dtypes, values at the ds gates (a family's or a leaf's max)."""
    assert set(want) == set(got), (path, set(want), set(got))
    for grp in ("E", "H"):
        scale = max(np.abs(want[grp][c]).max() for c in want[grp])
        for key in (grp, "lo" + grp):
            for c in want[key]:
                a, b = np.asarray(want[key][c]), np.asarray(got[key][c])
                assert a.dtype == b.dtype == np.complex64, (key, c, b.dtype)
                r = np.abs(a.astype(np.complex128) - b).max() / scale
                assert r < FIELD_TOL, f"{key}/{c}: rel {r:.2e}"
    gates = {"psi_E": PSI_TOL, "psi_H": PSI_TOL, "lopsi_E": PSI_TOL,
             "lopsi_H": PSI_TOL, "J": ADE_TOL, "K": ADE_TOL,
             "inc": LINE_TOL}
    for key, tol in gates.items():
        assert (key in want) == (key in got), key
        for c in want.get(key, {}):
            ref_key = key.replace("lo", "") if key.startswith("lo") else key
            hi = want[ref_key][c.replace("_lo", "")]
            a, b = np.asarray(want[key][c]), np.asarray(got[key][c])
            assert a.dtype == b.dtype == np.complex64, (key, c, b.dtype)
            r = np.abs(a.astype(np.complex128) - b).max() \
                / (np.abs(hi).max() + 1e-30)
            assert r < tol, f"{key}/{c}: rel {r:.2e}"
    assert int(want["t"]) == int(got["t"])


def test_native_complex_float32x2_raises_naming_the_paired_route():
    with pytest.raises(ValueError, match=PAIRED):
        TSim(to_port(CFG), device="cpu")


@pytest.mark.parametrize("use_pallas,kind", [
    (None, "complex2x_plain_ds"), (True, "complex2x_packed_ds_plain")])
def test_paired_ds_legs_match_reference_complex2x_jnp_ds(
        _env, reference, use_pallas, kind):
    fields, want, _col, _ref = reference
    _env.setenv(PAIRED, "1")
    port = port_run(fields, use_pallas)
    assert port.step_kind == kind
    assert port.step_diag["tb_fallback"]["reason"] == "paired_complex"
    got = convert.state_to_reference(port.state)
    assert np.abs(got["K"]["Hx"].imag).max() > 0
    check_complex_state(want, got)


@pytest.mark.parametrize("use_pallas", [None, True])
def test_re_leg_is_the_real_run_and_im_leg_stays_zero(_env, use_pallas):
    """A TFSF-driven complex run: every leaf's real part bit-equal to
    the real float32x2 run's, every imaginary part exactly 0."""
    cfg = ref_config("oblique_tfsf", use_pallas=use_pallas, **DRIVEN)
    real = TSim(to_port(cfg), device="cpu").run(6)
    _env.setenv(PAIRED, "1")
    cplx = TSim(to_port(dataclasses.replace(cfg, complex_fields=True)),
                device="cpu").run(6)
    assert cplx.step_kind == "complex2x_" + real.step_kind
    want = convert.state_to_reference(real.state)
    got = convert.state_to_reference(cplx.state)

    def walk(w, g, path):
        for k, v in w.items():
            if isinstance(v, dict):
                walk(v, g[k], f"{path}/{k}")
            elif k != "t":
                z = np.asarray(g[k])
                assert z.dtype == np.complex64, path
                np.testing.assert_array_equal(
                    z.real.view(np.uint32),
                    np.asarray(v, np.float32).view(np.uint32),
                    err_msg=f"{path}/{k}")
                assert not np.any(z.imag), f"{path}/{k}"
    walk(want, got, "")
    assert np.abs(want["E"]["Ez"]).max() > 0


def test_mid_run_checkpoint_resumes_bit_equal(_env, tmp_path):
    _env.setenv(PAIRED, "1")
    cfg = to_port(ref_config("oblique_tfsf", use_pallas=True,
                             complex_fields=True, **DRIVEN))
    sim = TSim(cfg, device="cpu")
    assert sim.step_kind == "complex2x_packed_ds_plain"
    seed(sim, seeded_fields(sim, 5)).run(3)
    sim.checkpoint(str(tmp_path / "mid.npz"))
    sim.run(3)
    again = TSim(cfg, device="cpu").restore(str(tmp_path / "mid.npz"))
    assert again.t == 3
    again.run(3)
    jax.tree.map(np.testing.assert_array_equal,
                 convert.state_to_reference(sim.state),
                 convert.state_to_reference(again.state))


def test_complex_ds_checkpoints_restore_across_packages(
        _env, reference, tmp_path):
    fields, want, _col, ref = reference
    ref.checkpoint(str(tmp_path / "ref.npz"))
    _env.setenv(PAIRED, "1")
    port = TSim(to_port(CFG), device="cpu").restore(
        str(tmp_path / "ref.npz"))
    jax.tree.map(assert_same_leaf, want,
                 convert.state_to_reference(port.state))
    port.checkpoint(str(tmp_path / "port.npz"))
    loaded, _meta = tio.load_checkpoint(str(tmp_path / "port.npz"))
    jax.tree.map(assert_same_leaf, want, loaded)
    assert loaded["loE"]["Ex"].dtype == np.complex64 \
        and loaded["K"]["Hx"].dtype == np.complex64
    # the port's own run's file, into the reference
    mine = port_run(fields)
    mine.checkpoint(str(tmp_path / "mine.npz"))
    for path, tree in (("port.npz", want),
                       ("mine.npz", convert.state_to_reference(mine.state))):
        with pytest.warns(np.exceptions.ComplexWarning):
            back = _np(RSim(CFG).restore(str(tmp_path / path)).state)
        assert_restored_by_reference(tree, back)


def assert_same_leaf(want, got):
    """One leaf of the reference's state form: dtype and bits."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype, (want.dtype, got.dtype)
    np.testing.assert_array_equal(got, want)


def assert_restored_by_reference(want, back):
    """What the reference's restore keeps of a complex ds file: every
    leaf as it was, but the low words, which it casts to its fresh
    state's real float32 (fdtd3d_tpu/sim.py:1098), keeping their real
    parts only (ROADMAP.md §C: its paired pack then copies them into
    both legs)."""
    for key, sub in want.items():
        if key == "t":
            assert int(back["t"]) == int(sub)
            continue
        for k, v in sub.items():
            b = back[key][k]
            if key.startswith("lo") or k.endswith("_lo"):
                assert b.dtype == np.float32, (key, k)
                np.testing.assert_array_equal(b, np.real(v))
            else:
                np.testing.assert_array_equal(b, v)


def test_health_counters_of_complex_ds_legs_match_reference(_env,
                                                            reference):
    fields, want_state, _col, ref = reference
    _env.setenv(PAIRED, "1")
    port = port_run(fields, True)
    got = ttel.readback(ttel.make_health_fn(port.static)(
        port._runner.views(port._carry)))
    # the reference's counters of its two real legs (its health_view)
    views = [jax.tree.map(lambda x, f=f: jnp.asarray(f(x)), want_state)
             for f in (np.real, np.imag)]
    want = {k: float(np.asarray(v)) for k, v in jax.device_get(
        rtel.make_health_fn(ref.static)(views)).items()}
    assert got["finite"] and want["nonfinite"] == 0.0
    for k, tol in (("max_e", 1e-6), ("max_h", 1e-6), ("energy", 1e-5),
                   ("div_l2", 1e-5), ("div_linf", 1e-5)):
        assert abs(got[k] - want[k]) <= tol * abs(want[k]), \
            (k, got[k], want[k])


def test_ntff_samples_the_ds_legs_hi_words(_env, reference):
    fields, _want, rc, _ref = reference
    _env.setenv(PAIRED, "1")
    port = TSim(to_port(CFG), device="cpu")
    seed(port, fields)
    tc = TCol(port, freq())
    for _ in range(SAMPLES):
        port.advance(STEPS)
        tc.sample()
    want, got = rc.acc, tc.acc
    scale = max(np.abs(v).max() for v in want.values())
    assert scale > 0
    assert max(np.abs(want[k] - got[k]).max() for k in want) < 1e-6 * scale


def _norms(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith("[t=")]
    assert lines, out
    return lines[-1].split()[0], {
        k: float(v) for k, v in re.findall(r"([EH][xyz])=([\d.e+-]+)",
                                           lines[-1])}


# the precision example cut to 16^3 and 4 steps, complex (XLA:CPU's
# compile of the reference's two jnp-ds legs grows with the grid: ~4 min
# at 32^3)
CLI_ARGV = ["--cmd-from-file", PRECISION, "--same-size", "16",
            "--time-steps", "4", "--save-res", "4", "--norms-every", "4",
            "--pml-size", "3", "--tfsf-margin", "2"]


def test_cli_complex_float32x2_matches_reference_cli(_env, tmp_path):
    """Both CLIs on the precision example with --complex-field-values
    (the hook set): the kind and token, the norms to their last digit,
    ``<c8`` DAT dumps (the hi words) at the field gate with equal
    manifests; the port's re parts bit-equal to its real run's dumps and
    its im parts exactly 0."""
    _env.setenv(PAIRED, "1")
    outs = {}
    for name, main, extra in (
            ("ref", rcli.main, ["--complex-field-values"]),
            ("port", tcli.main, ["--complex-field-values", "--device",
                                 "cpu", "--use-pallas", "on"]),
            ("real", tcli.main, ["--device", "cpu", "--use-pallas", "on"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(CLI_ARGV + extra + ["--save-dir",
                                            str(tmp_path / name)]) == 0
        outs[name] = buf.getvalue()
    assert "step_kind=complex2x_packed_ds_plain tb_fallback=paired_complex" \
        in outs["port"]
    t_ref, want = _norms(outs["ref"])
    t_port, got = _norms(outs["port"])
    assert t_ref == t_port and set(got) == set(want)
    for c, v in want.items():
        scale = max(w for k, w in want.items() if k[0] == c[0])
        assert abs(got[c] - v) <= 1e-4 * scale, (c, got[c], v)
    for fam in "EH":
        comps = [c for c in want if c[0] == fam]
        dumps = {c: [(tio.load_dat if n != "ref" else rio.load_dat)(
            str(tmp_path / n / f"{c}_t000004.dat"))
            for n in ("ref", "port", "real")] for c in comps}
        scale = max(np.abs(d[0]).max() for d in dumps.values())
        assert scale > 0
        for c, (a, b, r) in dumps.items():
            assert a.dtype == b.dtype == np.complex64
            assert np.abs(a.astype(np.complex128) - b).max() \
                < FIELD_TOL * scale, c
            np.testing.assert_array_equal(b.real.view(np.uint32),
                                          r.view(np.uint32))
            assert not np.any(b.imag), c
            name = f"{c}_t000004.dat.manifest.json"
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "ref" / name).read_bytes()


def test_supervised_nan_degrades_the_ds_legs(_env, tmp_path):
    _env.setenv(PAIRED, "1")
    cfg = to_port(dataclasses.replace(ref_config(
        "oblique_tfsf", use_pallas=True, complex_fields=True,
        output=OutputConfig(save_dir=str(tmp_path), checkpoint_every=4),
        **DRIVEN), time_steps=12))
    faults.install("nan@t=6")
    sup = Supervisor(cfg, device="cpu",
                     policy=RetryPolicy(sleep=lambda _s: None))
    assert sup.ensure_sim().step_kind == "complex2x_packed_ds_plain"
    sim = sup.run(interval=2)
    assert sim.t == 12 and sup.rollbacks == 1 and sup.degrades == 1
    assert sim.step_kind == "complex2x_plain_ds"
    for c, v in sim.fields().items():
        assert np.iscomplexobj(v) and np.isfinite(v).all(), c
    sup._restore_env()
    assert torch.is_tensor(sim.component_legs()[1]["Ez"])


def test_float32x2_batches_keep_the_reference_refusal(_env):
    _env.setenv(PAIRED, "1")
    for complex_fields in (False, True):
        cfg = to_port(dataclasses.replace(CFG,
                                          complex_fields=complex_fields))
        with pytest.raises(ValueError, match="float32x2"):
            BatchSimulation([cfg, cfg], device="cpu")

"""Complex field values (the reference's COMPLEX_FIELD_VALUES mode) in the
PyTorch port, against the JAX reference on the CPU.

The solver is linear with real coefficients and real sources, so a
complex run is the real-part run plus 1j times the source-free
imaginary-part run. The port has the reference's two routes: native
complex arithmetic in the plain step (the CPU route, and the oracle),
and two real legs on the normal kernel chain (the route on a CUDA
device; ``FDTD3D_FORCE_PAIRED_COMPLEX``, the reference's test hook,
takes it on the CPU). Every case starts both packages from the same
numpy-seeded complex fields; the gates:

* the native run against the reference's in 1D, 2D TMz and 3D with CPML,
  oblique TFSF and a Drude sphere: 2e-6 of each leaf's max, and the
  superposition identity in the port (its complex run against its real
  runs of the two parts) at 2e-6;
* the f64 cavity phasor against the discrete oracle at 1e-10;
* the paired legs against the native run at 2e-6 (plain legs, and the
  packed legs, kind ``complex2x_packed_plain``, against the reference's
  ``complex2x_pallas_packed`` in interpret mode), with the reference's
  ``tb_fallback`` tokens;
* the chunk health counters against the reference's (max 1e-6, energy
  1e-5), native and paired;
* TXT dumps byte-equal to the reference's writer, BMP of the real part,
  ``<c8`` DAT round trips, complex npz checkpoints restored across both
  packages and both routes, the NTFF accumulators at 1e-6;
* the 2D TMz CLI's norms lines against the reference CLI's, a complex
  batch and a sharded complex configuration rejected, and a supervised
  NaN that rolls back and degrades with complex kinds.
"""

import contextlib
import dataclasses
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_port

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import convert, faults
from fdtd3d_torch import exact as texact
from fdtd3d_torch import io as tio
from fdtd3d_torch import telemetry as ttel
from fdtd3d_torch.batch import BatchSimulation
from fdtd3d_torch.ntff import NtffCollector as TCol
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_torch.supervisor import RetryPolicy, Supervisor
from fdtd3d_tpu import _native
from fdtd3d_tpu import cli as rcli
from fdtd3d_tpu import io as rio
from fdtd3d_tpu import physics
from fdtd3d_tpu import telemetry as rtel
from fdtd3d_tpu.config import (MaterialsConfig, OutputConfig,
                               ParallelConfig, PmlConfig, PointSourceConfig,
                               SimConfig, SphereConfig, TfsfConfig)
from fdtd3d_tpu.ntff import NtffCollector as RCol
from fdtd3d_tpu.sim import Simulation as RSim

TOL = 2e-6
PAIRED = "FDTD3D_FORCE_PAIRED_COMPLEX"
OBLIQUE = dict(pml=PmlConfig(size=(3, 3, 3)),
               tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2),
                               angle_teta=30.0, angle_phi=40.0,
                               angle_psi=15.0))
CASES = {
    "1d": ("1D_EzHy", (64, 1, 1), 40, dict(pml=PmlConfig(size=(6, 0, 0)))),
    "2d_tmz": ("2D_TMz", (24, 24, 1), 25, dict(
        pml=PmlConfig(size=(4, 4, 0)),
        point_source=PointSourceConfig(enabled=True, component="Ez",
                                       position=(12, 12, 0)))),
    "3d_full": ("3D", (16, 16, 16), 12, dict(
        OBLIQUE, materials=MaterialsConfig(
            use_drude=True, eps_inf=1.5, omega_p=1e11, gamma=1e10,
            drude_sphere=SphereConfig(enabled=True, center=(8.0, 8.0, 8.0),
                                      radius=3.0)))),
}


@pytest.fixture(autouse=True)
def _native_route(monkeypatch):
    for k in (PAIRED, "FDTD3D_NO_TEMPORAL", "FDTD3D_NO_PACKED",
              "FDTD3D_NO_FUSED", "FDTD3D_FORCE_FUSED", "FDTD3D_FAULT_PLAN"):
        monkeypatch.delenv(k, raising=False)
    faults.clear()
    yield monkeypatch
    faults.clear()


def cfg_of(case, complex_fields=True, sources=True, **kw) -> SimConfig:
    scheme, size, steps, extra = CASES[case]
    steps = kw.pop("time_steps", steps)
    extra = dict(extra, **kw)
    if not sources:
        extra.pop("tfsf", None)
        extra.pop("point_source", None)
    return SimConfig(scheme=scheme, size=size, time_steps=steps, dx=1e-3,
                     courant_factor=0.4, wavelength=8e-3,
                     complex_fields=complex_fields, **extra)


def seeded_fields(sim, seed):
    """{comp: complex128 array} of 0.01 N(0, 1) real and imaginary parts,
    for the components of ``sim`` (either package)."""
    rng = np.random.RandomState(seed)
    st = sim.state
    return {c: 0.01 * rng.standard_normal(st[g][c].shape)
            + 0.01j * rng.standard_normal(st[g][c].shape)
            for g in ("E", "H") for c in st[g]}


def seed(sim, fields, part=None):
    for c, v in fields.items():
        sim.set_field(c, v if part is None else part(v))
    return sim


def leaf_rel(want, got, path=""):
    """max over the state's leaves of max |diff| / max |want|."""
    if isinstance(want, dict):
        assert set(want) == set(got), f"{path}: {set(want)} != {set(got)}"
        return max([leaf_rel(want[k], got[k], f"{path}/{k}") for k in want
                    if k != "t"] or [0.0])
    a, b = np.asarray(want), np.asarray(got)
    assert a.shape == b.shape and np.iscomplexobj(b) == np.iscomplexobj(a), \
        (path, a.shape, b.shape, a.dtype, b.dtype)
    scale = np.abs(a).max()
    return float(np.abs(a - b).max() / scale) if scale > 0 \
        else float(np.abs(b).max())


def port_state(sim):
    return convert.state_to_reference(sim.state)


def ref_state(sim):
    return jax.tree.map(np.asarray, sim.state)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_run_matches_reference_and_superposes(case):
    cfg = cfg_of(case)
    ref = RSim(cfg)
    fields = seeded_fields(ref, 7)
    seed(ref, fields).run()
    port = seed(TSim(to_port(cfg), device="cpu"), fields)
    assert port.step_kind == "plain" and not port.static.paired_complex
    port.run()
    want, got = ref_state(ref), port_state(port)
    assert np.iscomplexobj(got["E"][next(iter(got["E"]))])
    assert leaf_rel(want, got) < TOL
    # superposition in the port: the re run (sourced) + 1j the im run
    # (source-free), each a real run of the same step
    re = seed(TSim(to_port(cfg_of(case, False)), device="cpu"), fields,
              np.real).run()
    im = seed(TSim(to_port(cfg_of(case, False, sources=False)),
                   device="cpu"), fields, np.imag).run()
    for c, v in port.fields().items():
        sup = re.field(c) + 1j * im.field(c)
        assert np.abs(v - sup).max() <= TOL * np.abs(sup).max(), c


def test_cavity_phasor_f64_exact():
    n, steps = 21, 150
    cfg = SimConfig(scheme="2D_TMz", size=(n, n, 1), time_steps=steps,
                    dx=1e-3, courant_factor=0.6, wavelength=10e-3,
                    dtype="float64", complex_fields=True)
    sim = TSim(to_port(cfg), device="cpu")
    shape, omega = texact.cavity_mode_tmz((n, n), 2, 3, cfg.dx, cfg.dt)
    amp = 1.0 + 0.5j
    sim.set_field("Ez", amp * shape[:, :, None])
    sim.run()
    expected = amp * texact.cavity_expectation(shape, omega, cfg.dt, steps)
    ez = sim.field("Ez")
    assert ez.dtype == np.complex128
    assert np.abs(ez[:, :, 0] - expected).max() < 1e-10


@pytest.mark.parametrize("use_pallas,kind", [
    (None, "complex2x_plain"), (True, "complex2x_packed_plain")])
def test_paired_legs_match_native(_native_route, use_pallas, kind):
    cfg = to_port(cfg_of("3d_full", use_pallas=use_pallas,
                         point_source=PointSourceConfig(
                             enabled=True, component="Ez",
                             position=(8, 8, 8))))
    fields = seeded_fields(RSim(cfg_of("3d_full")), 3)
    native = seed(TSim(dataclasses.replace(cfg, use_pallas=None),
                       device="cpu"), fields).run()
    _native_route.setenv(PAIRED, "1")
    paired = seed(TSim(cfg, device="cpu"), fields)
    assert paired.static.paired_complex and paired.step_kind == kind
    assert paired.step_diag["tb_fallback"]["reason"] == "paired_complex"
    paired.run()
    assert leaf_rel(port_state(native), port_state(paired)) < TOL
    assert isinstance(paired.sample("Ez", (8, 8, 8)), complex)


def test_packed_legs_match_reference_interpret(_native_route):
    """The paired legs on the packed step's plain version against the
    reference's paired legs on its packed kernel (interpret mode), with
    the same kind suffix and tb_fallback token."""
    _native_route.setenv(PAIRED, "1")
    cfg = SimConfig(scheme="3D", size=(16, 16, 16), time_steps=6, dx=1e-3,
                    courant_factor=0.4, wavelength=8e-3, complex_fields=True,
                    use_pallas=True, pml=PmlConfig(size=(3, 3, 3)),
                    point_source=PointSourceConfig(
                        enabled=True, component="Ez", position=(8, 8, 8)))
    ref = RSim(cfg)
    assert ref.step_kind == "complex2x_pallas_packed"
    fields = seeded_fields(ref, 5)
    seed(ref, fields).run()
    port = seed(TSim(to_port(cfg), device="cpu"), fields)
    assert port.step_kind == "complex2x_packed_plain"
    assert port.step_diag["tb_fallback"] == ref.step_diag["tb_fallback"]
    port.run()
    assert leaf_rel(ref_state(ref), port_state(port)) < TOL


def test_tb_fallback_tokens_match_reference(_native_route):
    for paired in (False, True):
        if paired:
            _native_route.setenv(PAIRED, "1")
        cfg = cfg_of("3d_full", use_pallas=True)
        ref, port = RSim(cfg), TSim(to_port(cfg), device="cpu")
        assert ref.static.paired_complex == port.static.paired_complex \
            == paired
        assert port.step_diag["tb_fallback"] == \
            ref.step_diag["tb_fallback"], paired


@pytest.mark.parametrize("paired", [False, True])
def test_health_counters_match_reference(_native_route, paired):
    if paired:
        _native_route.setenv(PAIRED, "1")
    cfg = cfg_of("3d_full")
    ref = RSim(cfg)
    fields = seeded_fields(ref, 11)
    seed(ref, fields).run()
    port = seed(TSim(to_port(cfg), device="cpu"), fields).run()
    got = ttel.readback(ttel.make_health_fn(port.static)(
        port._runner.views(port._carry)))
    # the reference's counters of its own state: its two real legs (what
    # its paired step's health_view gives), or the native complex state
    st = ref_state(ref)
    views = [jax.tree.map(lambda x, f=f: jnp.asarray(f(x)), st)
             for f in (np.real, np.imag)] if paired \
        else [jax.tree.map(jnp.asarray, st)]
    want = {k: float(np.asarray(v)) for k, v in jax.device_get(
        rtel.make_health_fn(ref.static)(views)).items()}
    assert got["finite"] and want["nonfinite"] == 0.0
    for k, tol in (("max_e", 1e-6), ("max_h", 1e-6), ("energy", 1e-5),
                   ("div_l2", 1e-5), ("div_linf", 1e-5)):
        assert abs(got[k] - want[k]) <= tol * abs(want[k]), \
            (k, got[k], want[k])


@pytest.mark.parametrize("native", [True, False])
def test_txt_bmp_dat_of_complex_fields(tmp_path, monkeypatch, native):
    rng = np.random.RandomState(4)
    arr = (rng.standard_normal((5, 6, 4))
           + 1j * rng.standard_normal((5, 6, 4))).astype(np.complex64)
    arr[0, 0, 0] = -0.0 + 0.0j
    if not native:
        # the reference's pure-Python writer and reader
        monkeypatch.setattr(_native, "dump_txt", lambda *a: False)
        monkeypatch.setattr(_native, "load_txt", lambda *a: None)
    for ext, port_fn, ref_fn in (("txt", tio.dump_txt, rio.dump_txt),
                                 ("dat", tio.dump_dat, rio.dump_dat),
                                 ("bmp", tio.dump_bmp, rio.dump_bmp)):
        port_fn(arr, str(tmp_path / f"p.{ext}"))
        ref_fn(arr, str(tmp_path / f"r.{ext}"))
        assert (tmp_path / f"p.{ext}").read_bytes() == \
            (tmp_path / f"r.{ext}").read_bytes(), ext
    back = tio.load_txt(str(tmp_path / "p.txt"), arr.shape, np.complex128)
    assert np.array_equal(back, rio.load_txt(str(tmp_path / "r.txt"),
                                             arr.shape, np.complex128))
    assert np.abs(back - arr).max() <= 1e-8 * np.abs(arr).max()
    dat = tio.load_dat(str(tmp_path / "p.dat"))
    assert dat.dtype == np.complex64 and np.array_equal(dat, arr)
    assert tio.bmp_image(arr, (0, 1)).dtype == np.float32
    assert np.array_equal(tio.bmp_image(arr, (0, 1)),
                          tio.bmp_image(arr.real, (0, 1)))


@pytest.mark.parametrize("paired", [False, True])
def test_checkpoints_restore_across_packages(tmp_path, _native_route,
                                             paired):
    cfg = cfg_of("3d_full", time_steps=4)
    ref = RSim(cfg)
    fields = seeded_fields(ref, 13)
    seed(ref, fields).run()
    if paired:
        _native_route.setenv(PAIRED, "1")
    port = seed(TSim(to_port(cfg), device="cpu"), fields).run()
    assert port.static.paired_complex == paired
    port.checkpoint(str(tmp_path / "port.npz"))
    _native_route.delenv(PAIRED, raising=False)
    ref.checkpoint(str(tmp_path / "ref.npz"))
    got, meta = tio.load_checkpoint(str(tmp_path / "port.npz"))
    assert got["E"]["Ez"].dtype == np.complex64 \
        and got["inc"]["Einc"].dtype == np.complex64
    # the port's file in the reference, the reference's in the port
    r2 = RSim(cfg).restore(str(tmp_path / "port.npz"))
    assert leaf_rel(ref_state(ref), ref_state(r2)) < TOL
    if paired:
        _native_route.setenv(PAIRED, "1")
    p2 = TSim(to_port(cfg), device="cpu").restore(str(tmp_path / "ref.npz"))
    assert leaf_rel(port_state(port), port_state(p2)) < TOL
    p3 = TSim(to_port(cfg), device="cpu").restore(str(tmp_path / "port.npz"))
    assert leaf_rel(port_state(port), port_state(p3)) == 0.0
    for sim in (r2, p2):
        sim.advance(3)
    assert leaf_rel(ref_state(r2), port_state(p2)) < TOL


@pytest.mark.parametrize("paired", [False, True])
def test_ntff_accumulators_match_reference(_native_route, paired):
    n = 20
    cfg = SimConfig(scheme="3D", size=(n, n, n), time_steps=0, dx=1e-3,
                    courant_factor=0.5, wavelength=8e-3, complex_fields=True,
                    pml=PmlConfig(size=(3, 3, 3)),
                    point_source=PointSourceConfig(
                        enabled=True, component="Ez", position=(10,) * 3))
    freq = physics.C0 / cfg.wavelength
    ref = RSim(cfg)
    fields = seeded_fields(ref, 17)
    seed(ref, fields)
    if paired:
        _native_route.setenv(PAIRED, "1")
    port = seed(TSim(to_port(cfg), device="cpu"), fields)
    rc, tc = RCol(ref, freq), TCol(port, freq)
    for _ in range(6):
        ref.advance(3)
        port.advance(3)
        rc.sample()
        tc.sample()
    want, got = rc.acc, tc.acc
    scale = max(np.abs(v).max() for v in want.values())
    assert max(np.abs(want[k] - got[k]).max() for k in want) < 1e-6 * scale
    thetas, phis = [0.0, 45.0, 90.0, 150.0], [0.0, 90.0, 200.0]
    wp = rc.directivity_pattern(thetas, phis)
    assert np.abs(tc.directivity_pattern(thetas, phis) - wp).max() \
        < 1e-6 * np.abs(wp).max()


def _norms(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("[t=20]"):
            for kv in line.split()[1:]:
                k, v = kv.split("=")
                out[k] = float(v)
    return out


def test_cli_black_box_norms_match_reference(tmp_path):
    argv = ["--2d", "TMz", "--sizex", "24", "--sizey", "24", "--sizez", "1",
            "--time-steps", "20", "--complex-field-values", "--use-pml",
            "--pml-size", "4", "--point-source", "Ez", "--norms-every", "20",
            "--save-res", "20", "--save-formats", "dat,txt"]
    bufs = {}
    for name, main, extra in (("ref", rcli.main, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv + ["--save-dir", str(tmp_path / name)] + extra)
        assert rc == 0
        bufs[name] = buf.getvalue()
    assert "step_kind=plain tb_fallback=packed_ineligible" in bufs["port"]
    want, got = _norms(bufs["ref"]), _norms(bufs["port"])
    assert sorted(got) == sorted(want) == ["Ez", "Hx", "Hy"]
    for k in want:
        assert abs(got[k] - want[k]) <= 2e-6 * max(want.values()), k
    for c in ("Ez", "Hx", "Hy"):
        base = f"{c}_t000020"
        a = rio.load_dat(str(tmp_path / "ref" / f"{base}.dat"))
        b = tio.load_dat(str(tmp_path / "port" / f"{base}.dat"))
        assert b.dtype == a.dtype == np.complex64
        assert np.abs(a - b).max() <= TOL * np.abs(a).max()
        assert len((tmp_path / "port" / f"{base}.txt").read_text()
                   .splitlines()[0].split()) == 5


def test_batch_and_sharded_complex_are_rejected(_native_route):
    cfg = to_port(cfg_of("3d_full"))
    with pytest.raises(ValueError, match="paired-complex"):
        BatchSimulation([cfg, cfg], device="cpu")
    _native_route.setenv(PAIRED, "1")
    sharded = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, topology="manual", manual_topology=(1, 2, 2)))
    # the paired route on a topology raises as the reference's does
    with pytest.raises(ValueError, match="cannot run on a sharded"):
        TSim(sharded, device="cpu")
    ref_sharded = dataclasses.replace(cfg_of("3d_full"), parallel=(
        ParallelConfig(topology="manual", manual_topology=(1, 2, 2))))
    with pytest.raises(ValueError, match="native complex"):
        RSim(ref_sharded)


def test_supervised_nan_rolls_back_and_degrades(tmp_path, _native_route):
    _native_route.setenv(PAIRED, "1")
    cfg = to_port(cfg_of("3d_full", time_steps=16, use_pallas=True,
                         output=OutputConfig(save_dir=str(tmp_path),
                                             checkpoint_every=8)))
    faults.install("nan@t=10")
    sup = Supervisor(cfg, device="cpu",
                     policy=RetryPolicy(sleep=lambda _s: None))
    assert sup.ensure_sim().step_kind == "complex2x_packed_plain"
    sim = sup.run(interval=4)
    assert sim.t == 16 and sup.rollbacks == 1 and sup.degrades == 1
    assert sim.step_kind in ("complex2x_fused_plain",
                             "complex2x_pallas3d_plain")
    for c, v in sim.fields().items():
        assert np.iscomplexobj(v) and np.isfinite(v).all(), c
    assert math.isfinite(abs(sim.sample("Ez", (8, 8, 8))))
    sup._restore_env()
    assert torch.is_tensor(sim.component_legs()[1]["Ez"])

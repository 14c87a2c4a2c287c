"""bf16 storage with f32 compute (``--dtype bfloat16``) in the PyTorch
port, against the JAX reference on the CPU.

E and H are stored in bf16; every operation runs in float32, and the
recursion state (CPML psi, Drude J, the incident line) stays float32, as
in the reference. A field is rounded to bf16 where it is stored: the
plain step rounds E before the H update, the temporal-blocked pass keeps
generation 1 (and the E(2) its H(2) reads) in float32, the fused pass
computes H from the unrounded E, and the thin patches of the packed and
two-pass steps add a bf16-rounded value onto the stored field.

* The plain bf16 step against the reference's jnp bf16 step
  (tests/test_pallas.py:211's configuration: CPML 3, oblique TFSF, a
  Drude sphere, 12 steps) at 2e-2 of each component's max, with E/H bf16
  and psi, J and the incident line f32 on both sides.
* The bf16 run tracks the f32 run within 5e-2 (tests/test_pallas.py:249).
* Each rung's plain kind in bf16 against the reference: packed, fused
  and two-pass against the reference's interpret-mode kernels at 2e-2
  (tests/test_pallas_packed.py:180, tests/test_pallas_fused.py:84), the
  temporal-blocked pass against its jnp step at 3e-2
  (tests/test_pallas_packed_tb.py:161).
* The storage rule of the temporal-blocked and fused plain versions: a
  bf16 call equals the float32 call on the widened inputs with E and H
  rounded once at the end, bit for bit.
* A bf16 reference state crosses to the port and back bit for bit.
* The CLI writes the reference CLI's DAT files: 2-byte words with the
  manifest dtype ``"<V2"``, byte-identical sidecars, values at 2e-2.
* A bf16 batch: ``batch_fallback_reason`` and ``make_step(batch=)``
  agree, and each lane equals its solo run bit for bit.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch
from torch_parity import np_state, seed_reference, to_port

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import convert
from fdtd3d_torch import io as tio
from fdtd3d_torch.batch import BatchSimulation
from fdtd3d_torch.ops import packed_tb, pallas3d, pallas_fused, tfsf
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_torch.solver import (batch_fallback_reason, build_coeffs,
                                 build_static, coeffs_to_device, init_state,
                                 make_step)
from fdtd3d_tpu import cli as rcli
from fdtd3d_tpu.config import (MaterialsConfig, PmlConfig,
                               PointSourceConfig, SimConfig, SphereConfig,
                               TfsfConfig)
from fdtd3d_tpu.sim import Simulation as RSim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "Examples", "vacuum3D_tfsf.txt")
COMPS = ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")
BF16_TOL = 2e-2          # tests/test_pallas_packed.py:187
TB_BF16_TOL = 3e-2       # tests/test_pallas_packed_tb.py:161
TRACK_TOL = 5e-2         # tests/test_pallas.py:249

OBLIQUE = TfsfConfig(enabled=True, margin=(2, 2, 2), angle_teta=30.0,
                     angle_phi=40.0, angle_psi=15.0)
DRUDE = MaterialsConfig(use_drude=True, eps_inf=1.5, omega_p=1e11,
                        gamma=1e10, drude_sphere=SphereConfig(
                            enabled=True, center=(8, 8, 8), radius=3))
# tests/test_pallas.py:211
STORAGE = dict(scheme="3D", size=(16, 16, 16), time_steps=12, dx=1e-3,
               courant_factor=0.5, wavelength=8e-3, dtype="bfloat16",
               pml=PmlConfig(size=(3, 3, 3)), tfsf=OBLIQUE, materials=DRUDE)
# tests/test_pallas_packed.py / test_pallas_fused.py's BASE
RUNG_BASE = dict(scheme="3D", size=(16, 16, 16), time_steps=8, dx=1e-3,
                 courant_factor=0.4, wavelength=8e-3, dtype="bfloat16")
RUNG_CASES = {
    # the reference's bf16 cases (pml (0, 3, 3), seeded fields)
    "yz_cpml": dict(pml=PmlConfig(size=(0, 3, 3))),
    # every source and material the kernels take: patches in bf16
    "kitchen_sink": dict(
        pml=PmlConfig(size=(3, 3, 3)), tfsf=OBLIQUE,
        point_source=PointSourceConfig(enabled=True, component="Ez",
                                       position=(8, 8, 8)),
        materials=MaterialsConfig(
            eps=2.0, eps_sphere=SphereConfig(enabled=True, center=(8, 8, 8),
                                             radius=4, value=6.0),
            use_drude=True, eps_inf=1.5, omega_p=1e11, gamma=1e10,
            drude_sphere=SphereConfig(enabled=True, center=(8, 8, 8),
                                      radius=3))),
}
# rung -> (variables, the reference's kind, its gate, the port's kind)
RUNGS = {
    "packed": (("FDTD3D_NO_TEMPORAL",), "pallas_packed", BF16_TOL,
               "packed_plain"),
    "fused": (("FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED"), "pallas_fused",
              BF16_TOL, "fused_plain"),
    "pallas3d": (("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"), "pallas",
                 BF16_TOL, "pallas3d_plain"),
    "tb": ((), "jnp", TB_BF16_TOL, "packed_tb_plain"),
}


def as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def assert_components_close(want, got, tol):
    """Each field component within ``tol`` of its own max."""
    for g in ("E", "H"):
        for c, a in want[g].items():
            a = as_f32(a)
            err = np.abs(a - as_f32(got[g][c])).max()
            scale = np.abs(a).max()
            assert err <= tol * scale, f"{c}: {err:.2e} vs max {scale:.2e}"


def assert_storage_dtypes(state, bf16, f32):
    """E/H of ``bf16`` dtype, psi, J and the incident line of ``f32``."""
    for g in ("E", "H"):
        for v in state[g].values():
            assert v.dtype == bf16, (g, v.dtype)
    for g in ("psi_E", "psi_H", "J", "inc"):
        assert state.get(g), g
        for k, v in state[g].items():
            assert v.dtype == f32, (g, k, v.dtype)


def test_plain_step_matches_reference_jnp():
    ref = RSim(SimConfig(**STORAGE, use_pallas=False))
    port = TSim(to_port(SimConfig(**STORAGE, use_pallas=False)),
                device="cpu")
    ref.run()
    port.run()
    assert ref.step_kind == "jnp" and port.step_kind == "plain"
    assert_storage_dtypes(np_state(ref), np.dtype(ml_dtypes.bfloat16),
                          np.float32)
    assert_storage_dtypes(port.state, torch.bfloat16, torch.float32)
    assert_components_close(np_state(ref), port.state, BF16_TOL)


def test_bf16_tracks_f32():
    """tests/test_pallas.py:249: once the wave fills the TFSF box, bf16
    storage stays within 5e-2 of the f32 run."""
    def run(dtype):
        cfg = SimConfig(scheme="3D", size=(24, 24, 24), time_steps=60,
                        dx=1e-3, courant_factor=0.5, wavelength=10e-3,
                        dtype=dtype, use_pallas=False,
                        pml=PmlConfig(size=(4, 4, 4)),
                        tfsf=TfsfConfig(enabled=True, margin=(3, 3, 3),
                                        angle_teta=20.0, angle_phi=30.0,
                                        angle_psi=10.0))
        return TSim(to_port(cfg), device="cpu").run()
    f32, b16 = run("float32"), run("bfloat16")
    for c in ("Ez", "Hy"):
        a, b = f32.field(c), b16.field(c)
        assert b.dtype == np.float32
        rel = np.abs(a - b).max() / np.abs(a).max()
        assert rel < TRACK_TOL, f"{c}: rel {rel:.2e}"


@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("case", sorted(RUNG_CASES))
def test_rung_matches_reference(case, rung, monkeypatch):
    names, ref_kind, tol, port_kind = RUNGS[rung]
    for k in names:
        monkeypatch.setenv(k, "1")
    cfg = SimConfig(**RUNG_BASE, **RUNG_CASES[case],
                    use_pallas=ref_kind != "jnp")
    ref = RSim(cfg)
    seed_reference(ref, 3)
    port = TSim(to_port(SimConfig(**RUNG_BASE, **RUNG_CASES[case],
                                  use_pallas=True)), device="cpu")
    port.state = convert.state_from_reference(np_state(ref))
    ref.run()
    port.run()
    assert ref.step_kind == ref_kind, ref.step_kind
    assert port.step_kind == port_kind, port.step_kind
    for g in ("E", "H", "psi_E"):
        assert {v.dtype for v in port.state[g].values()} \
            == {torch.bfloat16 if g in "EH" else torch.float32}
    assert_components_close(np_state(ref), port.state, tol)


def seeded(case, dtype):
    """(static, coeffs, state) of a rung case with every state leaf
    seeded from numpy (E and H rounded to their storage dtype)."""
    cfg = to_port(SimConfig(**dict(RUNG_BASE, dtype=dtype),
                            **RUNG_CASES[case], use_pallas=True))
    static = build_static(cfg)
    coeffs = coeffs_to_device(build_coeffs(static), "cpu")
    state = init_state(static, "cpu")
    rng = np.random.RandomState(9)
    for grp in ("E", "H", "J", "psi_E", "psi_H", "inc"):
        for v in state.get(grp, {}).values():
            v.copy_(torch.from_numpy(0.01 * rng.standard_normal(
                v.shape).astype(np.float32)))
    return static, coeffs, state


def widened(tree):
    if isinstance(tree, dict):
        return {k: widened(v) for k, v in tree.items()}
    return tree.float() if isinstance(tree, torch.Tensor) else tree


def assert_bits_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_bits_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, tuple):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_bits_equal(g, w, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("case", sorted(RUNG_CASES))
def test_tb_plain_rounds_only_generation_two(case):
    """One bf16 pass of ``tb_pass_plain`` equals the float32 pass on the
    widened carry with E and H rounded to bf16 once, at the end."""
    static, coeffs, state = seeded(case, "bfloat16")
    step = packed_tb.make_packed_tb_step(static, "cpu")
    cc = step.prepare(coeffs)
    carry = step.pack(state)
    wide = dict(widened(carry), t=carry["t"])
    inc, terms, drive = packed_tb.generation_terms(
        static, cc["tb"], carry.get("inc"), carry["t"])
    out = packed_tb.packed.alloc_like(carry)
    out32 = packed_tb.packed.alloc_like(wide)
    packed_tb.tb_pass_plain(carry, out, cc["tb"], terms, drive)
    packed_tb.tb_pass_plain(wide, out32, cc["tb"], terms, drive)
    assert out["E"].dtype == torch.bfloat16
    want = dict(out32, E=out32["E"].to(torch.bfloat16),
                H=out32["H"].to(torch.bfloat16))
    assert_bits_equal(out, want)


@pytest.mark.parametrize("case", sorted(RUNG_CASES))
def test_fused_plain_computes_h_from_the_unrounded_e(case):
    """One bf16 call of ``fused_eh_plain`` equals the float32 call on the
    widened fields with E' and H' rounded to bf16 once, at the end."""
    static, coeffs, st = seeded(case, "bfloat16")
    fp = pallas_fused.prepare(static, coeffs)
    terms = None
    if static.tfsf_setup is not None:
        inc = tfsf.advance_einc(st["inc"], coeffs, 2, static.dt,
                                static.omega, static.tfsf_setup)
        terms = tfsf.record_terms(fp["plan"], inc)
    names = {fam: [k for v in pallas3d.kernel_psi_terms(
        static, fam).values() for _, k in v]
        for fam in ("E", "H")}
    rest = ({k: st["psi_E"][k] for k in names["E"]},
            {k: st["psi_H"][k] for k in names["H"]}, st.get("J"), fp, terms,
            pallas_fused.point_drive(static, fp, 2))
    got = pallas_fused.fused_eh_plain(st["E"], st["H"], *rest)
    want = pallas_fused.fused_eh_plain(widened(st["E"]), widened(st["H"]),
                                       *rest)
    rounded = tuple({c: v.to(torch.bfloat16) for c, v in want[i].items()}
                    for i in (0, 1))
    assert_bits_equal(got, rounded + want[2:])


def test_state_round_trip_bit_for_bit():
    """A bf16 reference state (ml_dtypes leaves) comes across as bf16
    tensors with the same bits, goes back as float32 holding the same
    values, and installs into a port Simulation with the same bits."""
    ref = RSim(SimConfig(**STORAGE, use_pallas=False))
    seed_reference(ref, 4)
    ref.run(4)
    want = np_state(ref)
    state = convert.state_from_reference(want)
    for g in ("E", "H"):
        for c, a in want[g].items():
            assert a.dtype == ml_dtypes.bfloat16
            assert state[g][c].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                convert.bf16_words(state[g][c]), a.view(np.int16))
    back = convert.state_to_reference(state)
    for g in want:
        if g == "t":
            assert int(back[g]) == int(want[g])
            continue
        for k, a in want[g].items():
            assert back[g][k].dtype == np.float32
            np.testing.assert_array_equal(back[g][k], as_f32(a))
    port = TSim(to_port(SimConfig(**STORAGE, use_pallas=False)),
                device="cpu")
    port.state = back
    assert_bits_equal(port.state, state)


def test_cli_dumps_match_reference_cli(tmp_path, capsys):
    flags = ["--cmd-from-file", EXAMPLE, "--same-size", "32",
             "--time-steps", "20", "--save-res", "20", "--check-finite",
             "--dtype", "bfloat16"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    assert rcli.main(flags + ["--save-dir", str(ref_dir)]) == 0
    assert tcli.main(flags + ["--save-dir", str(port_dir), "--device",
                              "cpu"]) == 0
    assert "step_kind=plain" in capsys.readouterr().out
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    got, want = {}, {}
    for c in COMPS:
        name = f"{c}_t000020.dat"
        assert (port_dir / name).stat().st_size == 2 * 32 ** 3
        assert (port_dir / name).stat().st_size \
            == (ref_dir / name).stat().st_size
        manifest = (port_dir / f"{name}.manifest.json").read_bytes()
        assert b'"dtype": "<V2"' in manifest
        assert manifest == (ref_dir / f"{name}.manifest.json").read_bytes()
        got[c] = tio.load_dat(str(port_dir / name))
        want[c] = tio.load_dat(str(ref_dir / name))
        assert got[c].dtype == np.float32 and got[c].shape == (32,) * 3
    for fam in "EH":
        scale = max(np.abs(want[c]).max() for c in COMPS if c[0] == fam)
        assert scale > 0
        for c in COMPS:
            if c[0] == fam:
                err = np.abs(got[c] - want[c]).max()
                assert err < BF16_TOL * scale, f"{c}: {err:.2e}"


def test_batch_lanes_equal_their_solo_runs():
    """bf16 lanes: the dispatch authority gives no token and
    ``make_step(batch=)`` builds the lane-capable pass; each lane equals
    a solo run of its configuration, bit for bit."""
    cfgs = [to_port(SimConfig(**{
        **RUNG_BASE, **RUNG_CASES["kitchen_sink"], "use_pallas": True,
        "point_source": PointSourceConfig(enabled=True, component="Ez",
                                          position=(8, 8, 8), amplitude=a)}))
        for a in (1.0, -2.0)]
    static = build_static(cfgs[0])
    lane_coeffs = [build_coeffs(build_static(c)) for c in cfgs]
    assert batch_fallback_reason(static, "cpu", lane_coeffs, 2) is None
    assert make_step(static, "cpu", batch=2).kind == "packed_tb_plain"
    bsim = BatchSimulation(cfgs, device="cpu")
    rng = np.random.RandomState(6)
    init = {c: 0.01 * rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
            for c in COMPS}
    for c in COMPS:
        bsim.set_field(c, init[c])
    bsim.run(7)
    assert bsim.step_kind == "packed_tb_plain" and bsim.batch_fallback is None
    for lane, cfg in enumerate(cfgs):
        solo = TSim(cfg, device="cpu")
        for c in COMPS:
            solo.set_field(c, init[c][lane])
        solo.run(7)
        assert_bits_equal(bsim.lane_state(lane), solo.state)
        assert bsim.lane_field(lane, "Ez").dtype == np.float32

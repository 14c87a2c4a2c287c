"""Compensated (Kahan) float32 in the PyTorch port, against the JAX
reference on the CPU.

E and H carry bf16 residuals ``rE``/``rH`` of the bits their f32 add
drops; the coefficients a double-single low word, 1/dx too. The port's
plain step runs the reference's jnp arithmetic operation for operation
(solver.py:738-742, :855-881, :909-926), and its packed step runs the
same Kahan update in both launches (``e_update``/``h_update``; the
patches between them add in plain f32, as the reference's do).

* The plain compensated step against the reference's jnp compensated
  step, 8 steps at 16^3: E, H and psi at 2e-6 of each leaf's max (the
  reference's ``tests/test_compensated.py:118`` gate); the residuals at
  2e-6 of their field family's max (a residual is part of its field's
  value). Where XLA:CPU contracts a recursion into an FMA (the CPML psi
  and Drude J updates once psi and J are non-zero), E differs by an f32
  ulp and the residual, the rounding error of that add, by as much as
  itself; so bit for bit (within 1 bf16 ulp of the element, measured 0)
  is held where both sides round alike: vacuum, a point source and a
  TFSF wave without CPML, from seeded fields and seeded residuals, and
  one step with CPML.
* The packed step (kind ``packed_plain``) against the reference's
  interpret-mode packed kernel and its jnp step at 2e-6, and bit for
  bit against the port's plain step where no source patch runs (the
  launches are the plain step's arithmetic in its order).
* The dispatch: compensated takes the packed step with ``tb_fallback``
  ``compensated``; with a coefficient grid, or with magnetic Drude K,
  the plain step, as the reference's jnp step (tokens ``compensated``
  and ``packed_ineligible``); batch tokens equal the reference's.
* The cavity gate of ``tests/test_compensated.py:87`` on the port's
  plain and packed steps: a 17^3 PEC cavity mode (2, 3, 1), 1000 steps,
  against ``fdtd3d_torch/exact.py``: e32c < 0.9 e32 and e32c < 2.5e-6.
* ``Examples/precision3D_compensated.txt`` through the port's CLI at
  ``tests/test_examples.py``'s shrink (32^3, 60 steps): its golden norms
  within that table's 5e-3, the DAT dumps at 2e-6 of the reference
  CLI's family max.
"""

import os
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_parity import BASE, CASES, np_state, seed_reference, to_port

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import convert, exact
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_torch.solver import (batch_fallback_reason, build_coeffs,
                                 build_static)
from fdtd3d_tpu import cli as rcli
from fdtd3d_tpu import io as rio
from fdtd3d_tpu import solver as rsolver
from fdtd3d_tpu.config import (MaterialsConfig, PmlConfig,
                               PointSourceConfig, SimConfig, SphereConfig,
                               TfsfConfig)
from fdtd3d_tpu.sim import Simulation as RSim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "Examples", "precision3D_compensated.txt")
TOL = 2e-6               # tests/test_compensated.py:118
COMPS = ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")
NO_PML = PmlConfig(size=(0, 0, 0))
UNIFORM_DRUDE = MaterialsConfig(use_drude=True, eps_inf=2.0, omega_p=2e10,
                                gamma=1e10)
K_SPHERE = MaterialsConfig(use_drude_m=True, mu_inf=1.5, omega_pm=1e11,
                           gamma_m=1e10, drude_m_sphere=SphereConfig(
                               enabled=True, center=(8, 8, 8), radius=3))

# the plain step against the reference's jnp step (run length: 8 steps)
JNP_CASES = {
    "point_source": CASES["point_source"],
    "oblique_tfsf": CASES["oblique_tfsf"],
    "uniform_drude": dict(pml=PmlConfig(size=(3, 3, 3)),
                          materials=UNIFORM_DRUDE),
    "kitchen_sink": CASES["kitchen_sink"],   # grids: the plain step
}
# where both sides round alike (no contracted recursion): bit for bit
EXACT_CASES = {
    "vacuum": dict(pml=NO_PML),
    "point_source": dict(pml=NO_PML, point_source=PointSourceConfig(
        enabled=True, component="Ey", position=(7, 8, 9))),
    "tfsf": dict(pml=NO_PML, tfsf=TfsfConfig(enabled=True,
                                             margin=(2, 2, 2))),
}


def comp_config(case_kw, **kw) -> SimConfig:
    return SimConfig(**BASE, **case_kw, compensated=True, **kw)


def wide(tree):
    """numpy leaves widened to float64 (bf16 ones included)."""
    if isinstance(tree, dict):
        return {k: wide(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(np.float64) if a.dtype.kind in "fV" else a


def assert_close(want, got, tol=TOL):
    """E, H, psi, J and the incident line at ``tol`` of each leaf's max;
    the residuals rE/rH at ``tol`` of their field family's max."""
    want, got = wide(want), wide(got)
    assert set(want) == set(got)
    for fam, leaves in want.items():
        if fam == "t":
            assert int(leaves) == int(got[fam])
            continue
        for k, a in leaves.items():
            b = got[fam][k]
            if fam in ("rE", "rH"):
                scale = max(np.abs(v).max() for v in want[fam[1]].values())
            else:
                scale = np.abs(a).max()
            err = np.abs(a - b).max()
            rel = err / scale if scale > 0 else err
            assert rel < tol, f"{fam}/{k}: rel {rel:.2e} (scale {scale:.2e})"


def bf16_ulps(want, got) -> float:
    """Worst difference of two bf16 residual trees in bf16 ulps of the
    element (the larger of the two values)."""
    worst = 0.0
    for k, a in want.items():
        a, b = np.asarray(a).astype(np.float64), np.asarray(got[k], np.float64)
        mag = np.maximum(np.abs(a), np.abs(b))
        ulp = np.ldexp(1.0, np.frexp(np.where(mag > 0, mag, 1.0))[1] - 8)
        worst = max(worst, float((np.abs(a - b) / ulp).max()))
    return worst


def seeded_pair(cfg, seed):
    """The reference and the port from one state: E, H and the residuals
    rE/rH seeded (numpy), the residuals bf16 on both sides."""
    ref = RSim(cfg)
    seed_reference(ref, seed)
    state = np_state(ref)
    rng = np.random.RandomState(seed + 100)
    for fam in ("rE", "rH"):
        for c, v in state[fam].items():
            scale = np.abs(np.asarray(state[fam[1]][c], np.float32)).max()
            state[fam][c] = (scale * 2.0 ** -25 * rng.standard_normal(
                v.shape)).astype(ml_dtypes.bfloat16)
    ref.state = jax.tree.map(jnp.asarray, state)
    port = TSim(to_port(cfg), device="cpu")
    port.state = convert.state_from_reference(state)
    return ref, port


@pytest.mark.parametrize("case", sorted(JNP_CASES))
def test_plain_step_matches_reference_jnp(case):
    cfg = comp_config(JNP_CASES[case], use_pallas=False)
    ref, port = seeded_pair(cfg, 1)
    ref.advance(8)
    port.advance(8)
    assert ref.step_kind == "jnp" and port.step_kind == "plain"
    state = port.state
    for fam in ("rE", "rH"):
        assert {v.dtype for v in state[fam].values()} == {torch.bfloat16}
    for fam in ("E", "H"):
        assert {v.dtype for v in state[fam].values()} == {torch.float32}
    assert_close(np_state(ref), convert.state_to_reference(state))


@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("case", sorted(EXACT_CASES))
def test_residuals_match_bit_for_bit(case, steps):
    cfg = comp_config(EXACT_CASES[case], use_pallas=False)
    ref, port = seeded_pair(cfg, 2)
    ref.advance(steps)
    port.advance(steps)
    want, got = np_state(ref), convert.state_to_reference(port.state)
    for fam in ("E", "H"):
        for c in want[fam]:
            assert np.array_equal(np.asarray(want[fam][c]), got[fam][c]), c
    for fam in ("rE", "rH"):
        assert bf16_ulps(want[fam], got[fam]) <= 1.0, fam


def test_one_step_with_cpml_matches_bit_for_bit():
    """Zero psi: the first step's CPML has no recursion to contract."""
    cfg = comp_config(CASES["point_source"], use_pallas=False)
    ref, port = seeded_pair(cfg, 3)
    ref.advance(1)
    port.advance(1)
    want, got = np_state(ref), convert.state_to_reference(port.state)
    for fam in ("E", "H", "psi_E", "psi_H"):
        for c in want[fam]:
            assert np.array_equal(np.asarray(want[fam][c]), got[fam][c]), c
    for fam in ("rE", "rH"):
        assert bf16_ulps(want[fam], got[fam]) == 0.0, fam


@pytest.mark.parametrize("ref_pallas", [True, False],
                         ids=["interpret_kernel", "jnp"])
@pytest.mark.parametrize("case", ["point_source", "uniform_drude"])
def test_packed_step_matches_reference(case, ref_pallas):
    ref, seeded = seeded_pair(comp_config(JNP_CASES[case],
                                          use_pallas=ref_pallas), 4)
    port = TSim(to_port(comp_config(JNP_CASES[case], use_pallas=True)),
                device="cpu")
    port.state = seeded.state
    ref.advance(8)
    port.advance(8)
    assert ref.step_kind == ("pallas_packed" if ref_pallas else "jnp")
    assert port.step_kind == "packed_plain"
    assert port.step_diag["tb_fallback"] == {"reason": "compensated"}
    assert_close(np_state(ref), convert.state_to_reference(port.state))


@pytest.mark.parametrize("case", ["xyz_cpml", "uniform_drude"])
def test_packed_step_equals_the_plain_step(case):
    """Without a source patch, the two launches compute the plain step's
    arithmetic in its order: bit for bit, residuals included."""
    kw = JNP_CASES.get(case, CASES.get(case))
    runs = {}
    for up in (False, True):
        ref, port = seeded_pair(comp_config(kw, use_pallas=False), 5)
        if up:
            state = port.state
            port = TSim(to_port(comp_config(kw, use_pallas=True)),
                        device="cpu")
            port.state = state
        port.advance(8)
        runs[port.step_kind] = convert.state_to_reference(port.state)
    want, got = runs["plain"], runs["packed_plain"]
    for fam in want:
        if fam == "t":
            continue
        for k in want[fam]:
            assert np.array_equal(want[fam][k], got[fam][k]), f"{fam}/{k}"


DISPATCH = {
    "point_source": (CASES["point_source"], "packed_plain", "compensated"),
    "grid": (CASES["kitchen_sink"], "plain", "compensated"),
    "magnetic_drude": (dict(pml=PmlConfig(size=(3, 3, 3)),
                            materials=K_SPHERE), "plain",
                       "packed_ineligible"),
}


@pytest.mark.parametrize("names", [(), ("FDTD3D_NO_PACKED",),
                                   ("FDTD3D_FORCE_FUSED",)])
@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_dispatch_matches_reference(case, names, monkeypatch):
    """The step kind follows the reference's (its packed kernel, or its
    jnp step: the port's plain step) and ``tb_fallback`` carries its
    token; no kernel runs where the reference declines its own."""
    for k in names:
        monkeypatch.setenv(k, "1")
    kw, kind, token = DISPATCH[case]
    cfg = comp_config(kw, use_pallas=True)
    ref = RSim(cfg)
    port = TSim(to_port(cfg), device="cpu")
    want = {"pallas_packed": "packed_plain", "jnp": "plain"}[ref.step_kind]
    assert port.step_kind == want
    if not names:
        assert want == kind
    else:
        assert want == "plain"       # no rung below packed takes Kahan
    assert port.step_diag["tb_fallback"] == ref.step_diag["tb_fallback"]
    if not names:
        assert port.step_diag["tb_fallback"] == {"reason": token}


@pytest.mark.parametrize("case", ["point_source", "grid", "magnetic_drude"])
def test_batch_token_matches_reference(case):
    """``batch_fallback_reason`` on compensated lanes: the reference's
    token (None for scalar coefficients, whose lanes the packed kernel
    carries; ``pallas_disabled`` with K)."""
    cfg = comp_config(DISPATCH[case][0], use_pallas=True)
    rst = rsolver.build_static(cfg)
    want = rsolver.batch_fallback_reason(
        rst, None, [rsolver.build_coeffs(rst)] * 2, batch=2)
    st = build_static(to_port(cfg))
    got = batch_fallback_reason(st, "cpu", [build_coeffs(st)] * 2, batch=2)
    assert got == want


def cavity_error(compensated, use_pallas):
    """tests/test_compensated.py:87's run on the port: the (2, 3, 1)
    eigenmode of a 17^3 PEC cavity for 1000 steps, worst component's
    error against the exact discrete evolution over its mode's max."""
    cfg = to_port(SimConfig(scheme="3D", size=(17, 17, 17),
                            time_steps=1000, dx=1e-3, courant_factor=0.5,
                            wavelength=8e-3, pml=NO_PML,
                            compensated=compensated, use_pallas=use_pallas))
    sim = TSim(cfg, device="cpu")
    shapes, omega = exact.cavity_mode((17, 17, 17), (2, 3, 1), cfg.dx,
                                      cfg.dt)
    for c, v in shapes.items():
        sim.set_field(c, v.astype(np.float32))
    sim.run()
    err = max(np.abs(np.asarray(sim.field(c), np.float64)
                     - exact.cavity_expectation(s, omega, cfg.dt, 1000)
                     ).max() / np.abs(s).max() for c, s in shapes.items())
    return err, sim.step_kind


@pytest.mark.parametrize("use_pallas,kinds", [
    (False, ("plain", "plain")), (True, ("packed_tb_plain",
                                         "packed_plain"))])
def test_cavity_gate(use_pallas, kinds):
    (e32, k32), (e32c, k32c) = (cavity_error(False, use_pallas),
                                cavity_error(True, use_pallas))
    assert (k32, k32c) == kinds
    assert e32c < 0.9 * e32, (e32, e32c)
    assert e32c < 2.5e-6, e32c


def test_exact_copy_matches_the_reference():
    from fdtd3d_tpu import exact as rexact
    got, w = exact.cavity_mode((17, 13, 11), (2, 3, 1), 1e-3, 1e-12)
    want, w_ref = rexact.cavity_mode((17, 13, 11), (2, 3, 1), 1e-3, 1e-12)
    assert w == w_ref and set(got) == set(want)
    for c in want:
        assert np.array_equal(got[c], want[c])
        assert np.array_equal(exact.cavity_expectation(got[c], w, 1e-12, 7),
                              rexact.cavity_expectation(want[c], w, 1e-12,
                                                        7))


# tests/test_examples.py's shrink of the example and its golden norms
SHRINK = ["--same-size", "32", "--time-steps", "60", "--pml-size", "4",
          "--point-source-x", "16", "--point-source-y", "16",
          "--point-source-z", "16", "--norms-every", "60"]
GOLDEN = {"Ex": 6.4461e-02, "Ez": 1.5448e-01, "Hy": 5.0197e-05}
RTOL = 5e-3


@pytest.fixture(scope="module")
def example_reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref")
    assert rcli.main(["--cmd-from-file", EXAMPLE, *SHRINK, "--save-res",
                      "60", "--save-dir", str(out)]) == 0
    return out


@pytest.mark.parametrize("use_pallas,kind", [("auto", "plain"),
                                             ("on", "packed_plain")])
def test_cli_example_matches_reference(tmp_path, capsys, example_reference,
                                       use_pallas, kind):
    capsys.readouterr()
    out_dir = tmp_path / "port"
    assert tcli.main(["--cmd-from-file", EXAMPLE, *SHRINK, "--save-res",
                      "60", "--check-finite", "--save-dir", str(out_dir),
                      "--device", "cpu", "--use-pallas", use_pallas]) == 0
    out = capsys.readouterr().out
    assert f"step_kind={kind}" in out
    norms = dict(re.findall(r"(\w+)=([\d.e+-]+)",
                            [ln for ln in out.splitlines()
                             if ln.startswith("[t=")][-1]))
    for c, want in GOLDEN.items():
        assert float(norms[c]) == pytest.approx(want, rel=RTOL), c
    want = {c: rio.load_dat(str(example_reference / f"{c}_t000060.dat"))
            for c in COMPS}
    for fam in "EH":
        scale = max(np.abs(want[c]).max() for c in COMPS if c[0] == fam)
        for c in COMPS:
            if c[0] != fam:
                continue
            got = rio.load_dat(str(out_dir / f"{c}_t000060.dat"))
            assert got.shape == (32, 32, 32) and got.dtype == np.float32
            err = np.abs(got.astype(np.float64) - want[c]).max()
            assert err < TOL * scale, f"{c}: {err:.2e} vs {scale:.2e}"
    assert sorted(os.listdir(out_dir)) == sorted(os.listdir(
        example_reference))


def test_state_round_trip_carries_the_residuals():
    """rE/rH cross from the reference (ml_dtypes bf16) as bf16 tensors
    with the same bits and go back holding the same values."""
    ref, port = seeded_pair(comp_config(CASES["xyz_cpml"],
                                        use_pallas=False), 6)
    want = np_state(ref)
    back = convert.state_to_reference(convert.state_from_reference(want))
    for fam in ("rE", "rH"):
        for c, v in want[fam].items():
            words = np.asarray(v).view(np.int16)
            t = convert.state_from_reference(want)[fam][c]
            assert t.dtype == torch.bfloat16
            assert np.array_equal(convert.bf16_words(t), words)
            assert np.array_equal(back[fam][c],
                                  np.asarray(v).astype(np.float32))


def test_parameter_blocks_carry_the_residuals():
    """The compensated launch's parameter block (built on CPU tensors, no
    launch): the bf16 residual stack, the coefficients' low words and
    1/dx's; a coefficient grid, or bf16 fields, refused."""
    from fdtd3d_torch.ops import packed
    from fdtd3d_torch.solver import coeffs_to_device, init_state
    static = build_static(to_port(comp_config(CASES["xyz_cpml"],
                                              use_pallas=True)))
    np_coeffs = build_coeffs(static)
    coeffs = coeffs_to_device(np_coeffs, "cpu")
    step = packed.make_packed_step(static, "cpu")
    carry = step.pack(init_state(static, "cpu"))
    cc = step.prepare(coeffs)
    for fam, F, S, R, pa in (("E", "E", "H", "rE", "ca"),
                             ("H", "H", "E", "rH", "da")):
        prm = packed._params(carry[F], carry[S], None, carry[f"ps{fam}"],
                             cc[fam], carry[R])
        assert carry[R].dtype == torch.bfloat16
        assert prm.R == carry[R].data_ptr()
        for ci, c in enumerate(static.mode.e_components if fam == "E"
                               else static.mode.h_components):
            assert prm.a_lo[ci] == np.float32(np_coeffs[f"{pa}_{c}_lo"])
        hi = np.float32(1.0 / static.dx)
        assert prm.inv_dx == hi
        assert prm.inv_dx_lo == np.float32(1.0 / static.dx - np.float64(hi))
    with pytest.raises(ValueError, match="residual"):
        packed._params(carry["E"], carry["H"], None, carry["psE"], cc["E"])
    grid = dict(cc["E"], a=[torch.ones(static.grid_shape)] * 3)
    grid.pop("_params", None)
    with pytest.raises(ValueError, match="scalar"):
        packed._params(carry["E"], carry["H"], None, carry["psE"], grid,
                       carry["rE"])


def test_batch_lanes_equal_their_solo_runs():
    """Compensated lanes (point-source amplitudes differ) ride the
    lane-capable packed step, residuals per lane, and each lane equals
    its own solo packed run bit for bit."""
    from fdtd3d_torch.batch import BatchSimulation
    lanes = [to_port(comp_config(dict(
        pml=PmlConfig(size=(3, 3, 3)), point_source=PointSourceConfig(
            enabled=True, component="Ez", position=(7, 8, 9),
            amplitude=a)), use_pallas=True)) for a in (1.0, -2.5)]
    bsim = BatchSimulation(lanes, device="cpu")
    assert bsim.step_kind == "packed_plain" and not bsim.batch_fallback
    bsim.advance(6)
    for lane, cfg in enumerate(lanes):
        solo = TSim(cfg, device="cpu")
        solo.advance(6)
        want, got = solo.state, bsim.lane_state(lane)
        for fam in ("E", "H", "rE", "rH", "psi_E", "psi_H"):
            for k in want[fam]:
                assert torch.equal(want[fam][k], got[fam][k]), (lane, fam, k)


def test_batch_of_compensated_grid_lanes_raises_as_the_reference():
    """The batch authority admits compensated lanes with coefficient
    grids (its token is the reference's, None), and the batched build
    then raises, as the reference's does: its packed kernel declines
    compensated grids."""
    from fdtd3d_torch.batch import BatchSimulation
    cfg = to_port(comp_config(CASES["kitchen_sink"], use_pallas=True))
    with pytest.raises(RuntimeError, match="lane-capable"):
        BatchSimulation([cfg, cfg], device="cpu")

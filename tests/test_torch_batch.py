"""The port's batched execution (fdtd3d_torch/batch.py) against the JAX
reference on the CPU.

On the CPU the lane-capable steps run their plain versions (kinds
``packed_tb_plain`` and ``packed_plain``) over the lane-stacked carry.
The reference's own batched packed path is not bit-exact on the CPU, so
each lane is held against the reference's SOLO jnp run of the same
config from the same numpy-seeded fields, at the reference's 2e-6 gate
scaled by the family max (E, H, psi_E, psi_H, J, the incident line), with
t exact:

* amplitude lanes (3 lanes differing in the point-source amplitude) at
  an odd horizon (7: three passes and the packed tail) and an even one
  (8), on the temporal-blocked pass and, with FDTD3D_NO_TEMPORAL, on the
  lane-capable packed step;
* sphere lanes (2 lanes with different eps-sphere and Drude values:
  per-lane coefficient grids and J);
* scalar divergence (uniform eps 1.0 and 2.0): the token path, kind
  ``plain``, per lane;
* the batch fingerprints and dispatch tokens equal the reference's;
* a NaN set into lane 1 flips only lane 1's flag, and lanes 0 and 2
  equal a clean solo run;
* named errors, the CLI's per-lane lines, and the lane-stacked
  conversions of state and coefficients.
"""

import contextlib
import dataclasses
import functools
import io

import numpy as np
import pytest
import torch
from torch_parity import TOL, np_state, seed_reference, to_port

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import convert, telemetry
from fdtd3d_torch.batch import BatchSimulation, stack_lane_coeffs
from fdtd3d_torch.scenario import ScenarioSpec as TSpec
from fdtd3d_torch.scenario import batch_fingerprint_diff as t_fp_diff
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_torch.solver import batch_fallback_reason as t_reason
from fdtd3d_torch.solver import build_coeffs as t_build_coeffs
from fdtd3d_torch.solver import build_static as t_build_static
from fdtd3d_tpu import cli as rcli
from fdtd3d_tpu.config import (MaterialsConfig, OutputConfig, PmlConfig,
                               PointSourceConfig, SimConfig, SphereConfig,
                               TfsfConfig)
from fdtd3d_tpu.scenario import ScenarioSpec as RSpec
from fdtd3d_tpu.scenario import batch_fingerprint_diff as r_fp_diff
from fdtd3d_tpu.sim import Simulation as RSim
from fdtd3d_tpu.solver import batch_fallback_reason as r_reason
from fdtd3d_tpu.solver import build_coeffs as r_build_coeffs
from fdtd3d_tpu.solver import build_static as r_build_static

BASE = dict(scheme="3D", size=(16, 16, 16), time_steps=8, dx=1e-3,
            courant_factor=0.4, wavelength=8e-3, pml=PmlConfig(size=(3, 3, 3)))
OBLIQUE = TfsfConfig(enabled=True, margin=(2, 2, 2), angle_teta=30.0,
                     angle_phi=40.0, angle_psi=15.0)


def _point(amp, pos=(7, 8, 9)):
    return PointSourceConfig(enabled=True, component="Ez", position=pos,
                             amplitude=amp)


def _spheres(eps, wp):
    return MaterialsConfig(
        eps=1.5, eps_sphere=SphereConfig(enabled=True, center=(8, 7, 8),
                                         radius=4, value=eps),
        use_drude=True, eps_inf=2.0, omega_p=wp, gamma=1e10,
        drude_sphere=SphereConfig(enabled=True, center=(8, 8, 8), radius=3))


# lane configs (reference dataclasses) of each batch case
LANES = {
    "amplitudes": [SimConfig(**BASE, tfsf=OBLIQUE, point_source=_point(a))
                   for a in (1.0, 2.5, -0.7)],
    "spheres": [SimConfig(**BASE, tfsf=OBLIQUE, point_source=_point(a),
                          materials=_spheres(e, wp))
                for e, wp, a in ((3.0, 2e11, 1.0), (6.0, 1e11, 2.0))],
    "uniform_eps": [SimConfig(**BASE, point_source=_point(1.0),
                              materials=MaterialsConfig(eps=e))
                    for e in (1.0, 2.0)],
}


def lane_cfgs(case, use_pallas=True):
    return [dataclasses.replace(c, use_pallas=use_pallas)
            for c in LANES[case]]


def seeds(case):
    return [10 * len(case) + lane for lane in range(len(LANES[case]))]


@functools.lru_cache(maxsize=None)
def reference_solo(case: str, lane: int, steps: int):
    """The reference's solo jnp run of one lane, from its seeded fields:
    (initial E/H fields, final unpacked state)."""
    ref = RSim(dataclasses.replace(LANES[case][lane], use_pallas=False))
    seed_reference(ref, seeds(case)[lane])
    init = {g: {c: np.asarray(v) for c, v in np_state(ref)[g].items()}
            for g in ("E", "H")}
    ref.advance(steps)
    assert ref.step_kind == "jnp"
    return init, np_state(ref)


def seeded_batch(case, steps, **kw):
    """The port's batch of ``case`` from the reference's seeded fields."""
    bsim = BatchSimulation([to_port(c) for c in lane_cfgs(case, **kw)],
                           device="cpu")
    inits = [reference_solo(case, lane, steps)[0]
             for lane in range(bsim.batch_size)]
    for g in ("E", "H"):
        for c in inits[0][g]:
            bsim.set_field(c, np.stack([i[g][c] for i in inits]))
    return bsim


def assert_lane_close(want, got):
    """Every leaf at TOL relative to its family's max (E, H, psi_E,
    psi_H, J, inc) and t exact."""
    assert set(want) == set(got), (set(want), set(got))
    assert int(want["t"]) == int(got["t"])
    for fam in want:
        if fam == "t":
            continue
        scale = max(np.abs(np.asarray(v)).max() for v in want[fam].values())
        assert set(want[fam]) == set(got[fam]), fam
        for k, a in want[fam].items():
            b = np.asarray(got[fam][k])
            assert np.shape(a) == b.shape, (fam, k)
            err = np.abs(np.asarray(a, np.float64) - b).max()
            rel = err / scale if scale > 0 else err
            assert rel < TOL, f"{fam}/{k}: rel {rel:.2e} (max {scale:.2e})"


@pytest.mark.parametrize("case,steps,env,kind", [
    ("amplitudes", 7, {}, "packed_tb_plain"),
    ("amplitudes", 8, {}, "packed_tb_plain"),
    ("amplitudes", 7, {"FDTD3D_NO_TEMPORAL": "1"}, "packed_plain"),
    ("spheres", 7, {}, "packed_tb_plain"),
    ("spheres", 8, {}, "packed_tb_plain"),
    ("uniform_eps", 8, {}, "plain"),
])
def test_lanes_match_reference_solo_runs(case, steps, env, kind,
                                         monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    bsim = seeded_batch(case, steps)
    assert bsim.step_kind == kind
    want_token = "batch_unsupported:scalar_coeff_divergence" \
        if case == "uniform_eps" else None
    assert bsim.batch_fallback == want_token
    bsim.advance(steps)
    assert bsim.t == steps
    for lane in range(bsim.batch_size):
        _, want = reference_solo(case, lane, steps)
        assert_lane_close(want,
                          convert.state_to_reference(bsim.lane_state(lane)))
    # the lanes really differ (amplitude or material per lane)
    assert not np.array_equal(bsim.lane_field(0, "Ez"),
                              bsim.lane_field(1, "Ez"))


def _token_case(name):
    """(lane configs, env) of a dispatch-token case."""
    amp = lane_cfgs("amplitudes")
    return {
        "in_scope": (amp, {}),
        "spheres": (lane_cfgs("spheres"), {}),
        "uniform_eps": (lane_cfgs("uniform_eps"), {}),
        "grid_vs_scalar": ([dataclasses.replace(amp[0], materials=(
            MaterialsConfig(eps_sphere=SphereConfig(
                enabled=True, center=(8, 8, 8), radius=4, value=3.0)))),
            amp[1]], {}),
        "sharded_y": (amp, {}),
        "pallas_off": (lane_cfgs("amplitudes", use_pallas=False), {}),
        "pallas_auto": (lane_cfgs("amplitudes", use_pallas=None), {}),
        "float32x2": ([dataclasses.replace(c, dtype="float32x2")
                       for c in amp], {}),
        "no_packed": (amp, {"FDTD3D_NO_PACKED": "1"}),
        "force_fused": (amp, {"FDTD3D_FORCE_FUSED": "1"}),
    }[name]


@pytest.mark.parametrize("name,token", [
    ("in_scope", None), ("spheres", None),
    ("uniform_eps", "scalar_coeff_divergence"),
    ("grid_vs_scalar", "scalar_coeff_divergence"),
    ("sharded_y", "kernel_ineligible"), ("pallas_off", "pallas_disabled"),
    ("pallas_auto", "pallas_disabled"), ("float32x2", "pallas_disabled"),
    ("no_packed", "env:FDTD3D_NO_PACKED"),
    ("force_fused", "env:FDTD3D_FORCE_FUSED"),
])
def test_dispatch_tokens_match_reference(name, token, monkeypatch):
    cfgs, env = _token_case(name)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # sharded_y: the static re-stamped with a (1, 2, 1) topology, as a
    # sharded caller would pass it (the y slab psi is then thin too)
    topo = (1, 2, 1) if name == "sharded_y" else (1, 1, 1)
    r_lanes = [r_build_coeffs(r_build_static(c)) for c in cfgs]
    r_static = dataclasses.replace(r_build_static(cfgs[0]), topology=topo)
    want = r_reason(r_static, None, lane_coeffs=r_lanes, batch=len(cfgs))
    t_lanes = [t_build_coeffs(t_build_static(to_port(c))) for c in cfgs]
    t_static = dataclasses.replace(t_build_static(to_port(cfgs[0])),
                                   topology=topo)
    got = t_reason(t_static, torch.device("cpu"), lane_coeffs=t_lanes,
                   batch=len(cfgs))
    assert want == token
    assert got == token


FP_PAIRS = {
    "amplitude": (LANES["amplitudes"][0], LANES["amplitudes"][1]),
    "materials": (LANES["spheres"][0], LANES["spheres"][1]),
    "size": (LANES["amplitudes"][0], dataclasses.replace(
        LANES["amplitudes"][0], size=(12, 12, 12))),
    "position": (LANES["amplitudes"][0], dataclasses.replace(
        LANES["amplitudes"][0], point_source=_point(1.0, (8, 8, 8)))),
    "tfsf_angle": (LANES["amplitudes"][0], dataclasses.replace(
        LANES["amplitudes"][0], tfsf=dataclasses.replace(OBLIQUE,
                                                         angle_phi=10.0))),
    "output": (LANES["amplitudes"][0], dataclasses.replace(
        LANES["amplitudes"][0], output=OutputConfig(check_finite=True))),
    "dtype": (LANES["amplitudes"][0], dataclasses.replace(
        LANES["amplitudes"][0], dtype="float32x2")),
}


@pytest.mark.parametrize("pair", sorted(FP_PAIRS))
def test_batch_fingerprints_match_reference(pair):
    a, b = FP_PAIRS[pair]
    ra, rb = RSpec(a).batch_fingerprint(), RSpec(b).batch_fingerprint()
    ta = TSpec(to_port(a)).batch_fingerprint()
    tb = TSpec(to_port(b)).batch_fingerprint()
    assert ta == ra and tb == rb
    assert t_fp_diff(ta, tb) == r_fp_diff(ra, rb)
    assert (t_fp_diff(ta, tb) is None) == (pair in ("amplitude",
                                                   "materials", "output"))


def test_nan_in_one_lane_flips_only_its_flag():
    """A NaN set into lane 1 trips lane 1 alone (one readback per chunk,
    no raise); lanes 0 and 2 equal clean solo runs of the port bit for
    bit."""
    cfgs = [dataclasses.replace(to_port(c), output=to_port(OutputConfig(
        check_finite=True))) for c in lane_cfgs("amplitudes")]
    bsim = BatchSimulation(cfgs, device="cpu")
    bsim.advance(2)
    assert bsim.lane_finite == [True, True, True]
    ez = np.stack([bsim.lane_field(i, "Ez") for i in range(3)])
    ez[1, 5, 6, 7] = np.nan
    bsim.set_field("Ez", ez)
    bsim.advance(3)
    assert bsim.lane_finite == [True, False, True]
    assert bsim.lane_first_unhealthy_t == [None, 5, None]
    bsim.verify_final_lanes()
    assert bsim.lane_finite == [True, False, True]
    for lane in (0, 2):
        solo = TSim(cfgs[lane], device="cpu")
        solo.advance(5)
        for comp in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
            np.testing.assert_array_equal(bsim.lane_field(lane, comp),
                                          solo.field(comp))


def test_lane_health_reduction():
    """One health pass over lane-leading leaves, read back once: NaN and
    inf flip their lane only, in a field and in a leaf outside E/H."""
    bsim = BatchSimulation([to_port(c) for c in lane_cfgs("spheres")]
                           + [to_port(lane_cfgs("spheres")[0])],
                           device="cpu")
    health = telemetry.make_lane_health_fn(bsim.static)
    state = bsim._dict_view()
    hv = telemetry.readback(health(state))
    assert hv["finite"] == [True] * 3
    state["E"]["Ey"][2, 1, 0, 0] = float("inf")
    next(iter(state["J"].values()))[0, 3, 3, 3] = float("nan")
    hv = telemetry.readback(health(state))
    assert hv["finite"] == [False, True, False]
    assert hv["max_e"][1] == 0.0 and hv["max_e"][2] is None


@pytest.mark.parametrize("what", ["size", "float32x2", "batch_max",
                                  "batch_max_text", "structure"])
def test_named_errors(what, monkeypatch):
    amp = [to_port(c) for c in lane_cfgs("amplitudes")]
    match = {"size": "differ in the graph-shaping config field size",
             "float32x2": "float32x2 scenarios do not batch",
             "batch_max": "exceeds the FDTD3D_BATCH_MAX bound",
             "batch_max_text": "must be an integer lane count",
             "structure": "not same-shape"}[what]
    if what == "size":
        amp[1] = dataclasses.replace(amp[1], size=(12, 12, 12))
    elif what == "float32x2":
        amp = [dataclasses.replace(c, dtype="float32x2") for c in amp]
    elif what == "batch_max":
        monkeypatch.setenv("FDTD3D_BATCH_MAX", "2")
    elif what == "batch_max_text":
        monkeypatch.setenv("FDTD3D_BATCH_MAX", "two")
    else:
        amp = [to_port(c) for c in _token_case("grid_vs_scalar")[0]]
    with pytest.raises(ValueError, match=match):
        BatchSimulation(amp, device="cpu")


def _spec_files(tmp_path, amps, extra=""):
    paths = []
    for i, amp in enumerate(amps):
        path = tmp_path / f"lane{i}{extra.strip()}.txt"
        path.write_text(
            "--3d\n--same-size 12\n--time-steps 6\n--courant-factor 0.4\n"
            "--wavelength 8e-3\n--use-pml\n--pml-size 3\n"
            f"--point-source Ez\n--point-source-amplitude {amp}\n{extra}")
        paths.append(str(path))
    return paths


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().splitlines()


def test_cli_batch_prints_the_reference_lines(tmp_path):
    """The per-lane lines and the dispatch token as the reference's CLI
    prints them (its auto dispatch on the CPU: the token
    pallas_disabled), then the lane-capable path (--use-pallas on in
    the lanes' files)."""
    paths = _spec_files(tmp_path, (1.0, 2.0))
    got = _lines(tcli.main, ["--batch", *paths, "--check-finite",
                             "--device", "cpu"])
    want = _lines(rcli.main, ["--batch", *paths, "--check-finite"])
    lane_lines = [ln for ln in want if ln.startswith("batch lane")]
    assert lane_lines == ["batch lane 0: healthy", "batch lane 1: healthy"]
    assert [ln for ln in got if ln.startswith("batch lane")] == lane_lines
    token = " batch_unsupported:pallas_disabled"
    assert [ln for ln in want if ln.startswith("batch: ")] == [
        "batch: 2 lanes step_kind=jnp" + token]
    assert [ln for ln in got if ln.startswith("batch: ")] == [
        "batch: 2 lanes step_kind=plain" + token]
    paths = _spec_files(tmp_path, (1.0, 2.0), "--use-pallas on\n")
    got = _lines(tcli.main, ["--batch", *paths, "--device", "cpu"])
    assert "batch: 2 lanes step_kind=packed_tb_plain" in got
    assert [ln for ln in got if ln.startswith("batch lane")] == lane_lines
    assert any(ln.startswith("done: 2 lanes x 6 steps in ") for ln in got)


@pytest.mark.parametrize("flag,item", [("--metrics=m.txt", "A15"),
                                       ("--ntff", r"A13\(b\)"),
                                       ("--save-materials", r"A13\(b\)")])
def test_cli_batch_unported_flags_raise(tmp_path, flag, item):
    paths = _spec_files(tmp_path, (1.0, 2.0))
    with pytest.raises(NotImplementedError, match=item):
        tcli.main(["--batch", *paths, flag, "--device", "cpu"])


@pytest.mark.parametrize("flag", ["--profile", "--telemetry"])
def test_cli_batch_observability_flags(tmp_path, capsys, flag):
    """--profile with --batch logs that a batch keeps no clock (as the
    reference's batch has none) and runs; --telemetry writes the batch's
    stream: run_start with the lane count, one batch_lane row per lane
    per chunk and the aggregate chunk record, run_end."""
    import json
    paths = _spec_files(tmp_path, (1.0, 2.0))
    tel = tmp_path / "t.jsonl"
    arg = "--profile" if flag == "--profile" else f"--telemetry={tel}"
    assert tcli.main(["--batch", *paths, arg, "--batch-chunk", "3",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "batch lane 1: healthy" in out
    if flag == "--profile":
        assert "profile: a batch keeps no per-chunk clock" in out
        return
    recs = [json.loads(ln) for ln in tel.read_text().splitlines()]
    assert recs[0]["type"] == "run_start" and recs[0]["batch"] == 2
    assert recs[0]["batch_fallback"] == "batch_unsupported:pallas_disabled"
    assert [(r["t"], r["lane"]) for r in recs if r["type"] == "batch_lane"] \
        == [(3, 0), (3, 1), (6, 0), (6, 1)]
    assert [r["t"] for r in recs if r["type"] == "chunk"] == [3, 6]
    assert recs[-1]["type"] == "run_end" and recs[-1]["steps"] == 6


def test_run_batch_and_lane_stacked_conversions():
    """Simulation.run_batch sweeps the final lanes; the lane-stacked
    state and coefficients cross to the reference's stacked form and
    back unchanged."""
    cfgs = [to_port(c) for c in lane_cfgs("spheres")]
    bsim = TSim.run_batch(cfgs, time_steps=3, device="cpu")
    assert bsim.lane_finite == [True, True] and bsim.t == 3
    ref_state = convert.stacked_state_to_reference(bsim.state, 2)
    assert ref_state["t"].tolist() == [3, 3]
    assert ref_state["E"]["Ex"].shape == (2, 16, 16, 16)
    back = convert.stacked_state_from_reference(ref_state)
    for grp in ("E", "H", "psi_E", "J", "inc"):
        for k, v in back[grp].items():
            assert torch.equal(v, bsim.state[grp][k]), (grp, k)
    lanes = [t_build_coeffs(t_build_static(c)) for c in cfgs]
    coeffs = stack_lane_coeffs(lanes, "cpu")
    assert coeffs["cb_Ex"].shape == (2, 16, 16, 16)
    assert coeffs["ps_amp"].tolist() == [1.0, 2.0]
    assert isinstance(coeffs["da_Hx"], float)
    stacked = convert.stacked_coeffs_to_reference(coeffs, 2)
    want = {k: np.stack([np.asarray(lc[k]) for lc in lanes]) for k in lanes[0]}
    assert set(stacked) == set(want)
    for k in want:
        np.testing.assert_array_equal(stacked[k], want[k])
    again = convert.stacked_coeffs_from_reference(want)
    for k, v in coeffs.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(again[k], v), k
        else:
            assert again[k] == v, k

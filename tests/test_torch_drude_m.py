"""Magnetic Drude K (the reference's metamaterial mode) in the PyTorch
port, 3D, against the JAX reference on the CPU.

K is the dual of electric Drude J: ``K' = km K + bm H`` enters H's curl
accumulator with the sign opposite to J's on E (``acc + K'``), with mu
merged to ``mu_inf`` inside the K sphere (so da/db become grids). It is
float32 auxiliary state in f32 and bf16 runs (as J), float64 in f64.

* The plain step against the reference's jnp step, 8 steps at 16^3 with
  CPML, a TFSF wave and a K sphere (tests/test_pallas_packed.py:277's
  materials), and the double-negative case (J and K on one sphere): f32
  at 2e-6 of each family's max, bf16 at 2e-2, float64 at 1e-12.
* Each kernel rung's plain kind (packed, recompute-fused, two-pass)
  against the reference's interpret-mode kernel and against the port's
  own plain step (f32 2e-6, bf16 2e-2), with the reference's kinds and
  ``tb_fallback`` token (``magnetic_drude``).
* A batch of K lanes: ``batch_fallback_reason`` equals the reference's
  (None: its packed kernel carries K lanes), and each lane of the
  lane-capable packed step equals the reference's solo jnp run.
* float32x2 with K (B4(b), ported), in 3D and in 1D: the cases that
  raised its ROADMAP.md item now run it, the packed-ds step's plain kind
  against the plain ds step in 3D, the plain ds step against the
  reference's jnp-ds step in 1D (tests/test_torch_ds_drude_m.py holds
  the rest).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (BASE, assert_ds_state_close, np_state,
                          seed_reference, to_port)

from fdtd3d_torch import convert
from fdtd3d_torch.batch import BatchSimulation
from fdtd3d_torch.ops import packed, pallas3d
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_torch.solver import (batch_fallback_reason, build_coeffs,
                                 build_static, init_state)
from fdtd3d_tpu import solver as rsolver
from fdtd3d_tpu.config import (MaterialsConfig, PmlConfig,
                               PointSourceConfig, SimConfig, SphereConfig,
                               TfsfConfig)
from fdtd3d_tpu.sim import Simulation as RSim

SPHERE = SphereConfig(enabled=True, center=(8, 8, 8), radius=3)
K_MAT = dict(use_drude_m=True, mu_inf=1.5, omega_pm=1e11, gamma_m=1e10,
             drude_m_sphere=SPHERE)
CASES = {
    # tests/test_pallas_packed.py:277's K sphere, CPML on every axis, TFSF
    "k_sphere": dict(pml=PmlConfig(size=(3, 3, 3)),
                     tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2)),
                     materials=MaterialsConfig(**K_MAT)),
    # double negative: J and K on one sphere, a point source
    "dng": dict(pml=PmlConfig(size=(3, 3, 3)),
                point_source=PointSourceConfig(enabled=True, component="Ez",
                                               position=(5, 9, 7)),
                materials=MaterialsConfig(use_drude=True, eps_inf=1.5,
                                          omega_p=1e11, gamma=1e10,
                                          drude_sphere=SPHERE, **K_MAT)),
}
TOLS = {"float32": 2e-6, "bfloat16": 2e-2, "float64": 1e-12}
# rung -> (variables, the reference's kernel kind, the port's CPU kind)
RUNGS = {
    "packed": (("FDTD3D_NO_TEMPORAL",), "pallas_packed", "packed_plain"),
    "fused": (("FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED"), "pallas_fused",
              "fused_plain"),
    "pallas3d": (("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"), "pallas",
                 "pallas3d_plain"),
}


def config(case, dtype="float32", **kw) -> SimConfig:
    return SimConfig(**dict(BASE, dtype=dtype), **dict(CASES[case], **kw))


def wide(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(a).astype(np.float64)


def assert_family_close(want, got, tol):
    """Every leaf of the unpacked state within ``tol`` of its family's
    max (E, H, psi_E, psi_H, J, K; each incident line on its own)."""
    assert set(want) == set(got), f"keys {set(want)} != {set(got)}"
    for fam, leaves in want.items():
        if fam == "t":
            assert int(leaves) == int(got[fam])
            continue
        groups = ({k: {k: v} for k, v in leaves.items()} if fam == "inc"
                  else {fam: leaves})
        for name, sub in groups.items():
            scale = max(float(np.abs(wide(v)).max()) for v in sub.values())
            for k, v in sub.items():
                err = float(np.abs(wide(v) - wide(got[fam][k])).max())
                rel = err / scale if scale > 0 else err
                assert rel < tol, \
                    f"{fam}/{k}: rel {rel:.2e} of the {name} max {scale:.2e}"


def pair(ref_cfg, port_cfg, seed=3, steps=8):
    ref = RSim(ref_cfg)
    seed_reference(ref, seed)
    port = TSim(to_port(port_cfg), device="cpu")
    port.state = convert.state_from_reference(np_state(ref))
    ref.advance(steps)
    port.advance(steps)
    return ref, port


@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_step_matches_reference_jnp(case, dtype):
    cfg = config(case, dtype, use_pallas=False)
    ref, port = pair(cfg, cfg)
    assert ref.step_kind == "jnp" and port.step_kind == "plain"
    state = port.state
    aux = torch.float64 if dtype == "float64" else torch.float32
    assert {v.dtype for v in state["K"].values()} == {aux}
    assert_family_close(np_state(ref), convert.state_to_reference(state),
                        TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_rung_matches_reference_kernel(case, rung, dtype, monkeypatch):
    names, ref_kind, port_kind = RUNGS[rung]
    for k in names:
        monkeypatch.setenv(k, "1")
    cfg = config(case, dtype, use_pallas=True)
    ref, port = pair(cfg, cfg)
    assert ref.step_kind == ref_kind and port.step_kind == port_kind
    assert port.step_diag["tb_fallback"] == ref.step_diag["tb_fallback"] \
        == {"reason": "magnetic_drude"}
    assert_family_close(np_state(ref), convert.state_to_reference(
        port.state), TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rung", sorted(RUNGS))
def test_rung_matches_the_plain_step(rung, dtype, monkeypatch):
    """Each kernel's plain version with K (e_update_plain/h_update_plain,
    e_family_plain/h_family_plain, fused_eh_plain) against the port's
    plain step from one seeded state."""
    cfg = to_port(config("dng", dtype, use_pallas=False))
    plain = TSim(cfg, device="cpu")
    rng = np.random.RandomState(11)
    for c in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
        plain.set_field(c, 0.01 * rng.standard_normal((16, 16, 16)))
    init = plain.state
    for k in RUNGS[rung][0]:
        monkeypatch.setenv(k, "1")
    kern = TSim(dataclasses.replace(cfg, use_pallas=True), device="cpu")
    assert kern.step_kind == RUNGS[rung][2]
    kern.state = init
    plain.advance(8)
    kern.advance(8)
    assert_family_close(convert.state_to_reference(plain.state),
                        convert.state_to_reference(kern.state), TOLS[dtype])


def test_h_launches_read_and_write_k():
    """One h_update_plain and one h_family_plain with K: K' = km K + bm H
    and H' = da H - db (curl E + K') at every cell."""
    static = build_static(to_port(config("k_sphere", use_pallas=True)))
    from fdtd3d_torch.solver import coeffs_to_device
    coeffs = coeffs_to_device(build_coeffs(static), "cpu")
    state = init_state(static, "cpu")
    rng = np.random.RandomState(2)
    for g in ("E", "H", "K"):
        for v in state[g].values():
            v.copy_(torch.from_numpy(rng.standard_normal(v.shape)
                                     .astype(np.float32)))
    fp = pallas3d.prepare(static, coeffs)
    zero_e = {c: torch.zeros_like(v) for c, v in state["E"].items()}
    psi = {k: torch.zeros_like(state["psi_H"][k])
           for v in fp["H"]["psi"].values() for _, k in v}
    new_h, _, new_k = pallas3d.h_family_plain(state["H"], zero_e, psi, fp,
                                              state["K"])
    stack = {g: torch.stack([state[g][c] for c in ("Hx", "Hy", "Hz")])
             for g in ("H", "K")}
    e0 = torch.zeros_like(stack["H"])
    pfc = packed.prepare_family(static, coeffs, "H")
    psi_p = {a: torch.zeros(packed.psi_shape(static.grid_shape, a, m))
             for a, m in pfc["m"].items()}
    h_p, k_p = stack["H"].clone(), stack["K"].clone()
    packed.h_update_plain(h_p, e0, psi_p, pfc, K=k_p)
    for j, c in enumerate(("Hx", "Hy", "Hz")):
        km, bm = coeffs[f"km_{c}"], coeffs[f"bm_{c}"]
        kn = km * state["K"][c] + bm * state["H"][c]
        hn = coeffs[f"da_{c}"] * state["H"][c] - coeffs[f"db_{c}"] * kn
        assert torch.equal(new_k[c], kn) and torch.equal(k_p[j], kn)
        assert torch.equal(new_h[c], hn) and torch.equal(h_p[j], hn)


LANE_CASES = [config("k_sphere", use_pallas=True,
                     point_source=PointSourceConfig(
                         enabled=True, component="Ez", position=(7, 8, 9),
                         amplitude=a),
                     materials=MaterialsConfig(**dict(K_MAT, omega_pm=wpm)))
              for a, wpm in ((1.0, 1e11), (2.0, 5e10))]


def test_batch_token_matches_reference():
    lanes = [rsolver.build_coeffs(rsolver.build_static(c))
             for c in LANE_CASES]
    want = rsolver.batch_fallback_reason(
        rsolver.build_static(LANE_CASES[0]), None, lanes, batch=2)
    st = build_static(to_port(LANE_CASES[0]))
    got = batch_fallback_reason(
        st, "cpu", [build_coeffs(build_static(to_port(c)))
                    for c in LANE_CASES], batch=2)
    assert got == want is None


def test_batch_lanes_match_the_reference_solo_runs():
    """Two K lanes with different omega_pm (per-lane bm and da/db grids)
    and point-source amplitudes on the lane-capable packed step, each
    against the reference's solo jnp run from the same seeded fields."""
    bsim = BatchSimulation([to_port(c) for c in LANE_CASES], device="cpu")
    assert bsim.step_kind == "packed_plain"
    wants, inits = [], []
    for lane, cfg in enumerate(LANE_CASES):
        ref = RSim(dataclasses.replace(cfg, use_pallas=False))
        seed_reference(ref, 40 + lane)
        inits.append(np_state(ref))
        ref.advance(8)
        wants.append(np_state(ref))
    for g in ("E", "H"):
        for c in inits[0][g]:
            bsim.set_field(c, np.stack([np.asarray(i[g][c]) for i in inits]))
    bsim.advance(8)
    for lane, want in enumerate(wants):
        got = convert.state_to_reference(bsim.lane_state(lane))
        assert_family_close(want, got, TOLS["float32"])


@pytest.mark.parametrize("kw,item", [
    (dict(dtype="float32x2"), r"B4\(b\)"),
])
def test_out_of_scope_k_raises_naming_its_item(kw, item):
    """The configuration that raised ``item`` runs since it was ported:
    float32x2 with the K sphere on the packed-ds step's plain kind, 6
    steps from seeded E/H, against the plain ds step at 1e-9 of each
    family's max (the slab CPML sums differ in order at O(eps^2)) and K
    at 1e-9 of its max (psi at the ds gate, 1e-6)."""
    runs = {}
    for use_pallas in (True, False):
        sim = TSim(to_port(config("k_sphere", use_pallas=use_pallas,
                                  **kw)), device="cpu")
        rng = np.random.RandomState(17)
        for c in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
            sim.set_field(c, 0.01 * rng.standard_normal((16, 16, 16)))
        runs[sim.step_kind] = convert.state_to_reference(sim.run(6).state)
    assert set(runs) == {"packed_ds_plain", "plain_ds"}, item
    assert np.abs(runs["plain_ds"]["K"]["Hx"]).max() > 0
    assert_ds_state_close(runs["plain_ds"], runs["packed_ds_plain"],
                          {"field": 1e-9, "ade": 1e-9})


def test_one_dimensional_k_raises_naming_its_item():
    """float32x2 with K in 1D, which raised B4(b), runs since it was
    ported: the plain ds step (kind ``plain_ds``, as every kernel is
    3D-only) against the reference's jnp-ds step, 4 steps from seeded
    fields, at the ds gates (E/H 1e-6 of the family max, K 1e-5)."""
    cfg = SimConfig(scheme="1D_EzHy", size=(64, 1, 1), time_steps=4,
                    dx=1e-3, courant_factor=0.5, wavelength=15e-3,
                    dtype="float32x2",
                    materials=MaterialsConfig(**dict(
                        K_MAT, drude_m_sphere=SphereConfig(
                            enabled=True, center=(32, 0, 0), radius=5))))
    ref = RSim(cfg)
    seed_reference(ref, 18)
    port = TSim(to_port(cfg), device="cpu")
    assert (ref.step_kind, port.step_kind) == ("jnp_ds", "plain_ds")
    port.state = convert.state_from_reference(np_state(ref))
    ref.run()
    port.run()
    want, got = np_state(ref), convert.state_to_reference(port.state)
    assert np.abs(want["K"]["Hy"]).max() > 0
    assert_ds_state_close(want, got)


def test_parameter_blocks_carry_k():
    """The launch parameter blocks of the H family (built on CPU tensors,
    no launch): K's pointers and its km/bm coefficients in the ADE slots
    of the two-pass block and of the packed block."""
    static = build_static(to_port(config("k_sphere", use_pallas=True)))
    from fdtd3d_torch.solver import coeffs_to_device
    coeffs = coeffs_to_device(build_coeffs(static), "cpu")
    state = init_state(static, "cpu")
    fp = pallas3d.prepare(static, coeffs)
    psi = {k: state["psi_H"][k] for v in fp["H"]["psi"].values()
           for _, k in v}
    terms = None if fp["plan"] is None else torch.zeros(fp["plan"].total)
    prm, _, _, new_k = pallas3d._params(state["H"], state["E"], psi,
                                        state["K"], fp, "H", terms)
    assert set(new_k) == {"Hx", "Hy", "Hz"}
    for ci, c in enumerate(("Hx", "Hy", "Hz")):
        assert prm.dr.Jin[ci] == state["K"][c].data_ptr()
        assert prm.dr.Jout[ci] == new_k[c].data_ptr()
        assert prm.dr.kj[ci].val == coeffs[f"km_{c}"]
        assert prm.dr.bj[ci].grid == coeffs[f"bm_{c}"].data_ptr()
    with pytest.raises(ValueError, match="no K"):
        pallas3d._params(state["H"], state["E"], psi, None, fp, "H", terms)
    p = packed.make_packed_step(static, "cpu")
    carry = p.pack(state)
    cc = p.prepare(coeffs)
    prm = packed._params(carry["H"], carry["E"], carry["K"], carry["psH"],
                         cc["H"])
    assert prm.J == carry["K"].data_ptr() and prm.R is None
    assert prm.kj[0].val == coeffs["km_Hx"]
    assert prm.bj[0].grid == coeffs["bm_Hx"].data_ptr()

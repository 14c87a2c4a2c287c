"""The kernel ladder below packed against the JAX reference on the CPU.

The port's two rungs under the packed step: the recompute-fused single
pass (``ops/pallas_fused.py``, kind ``fused_plain`` on the CPU) and the
two-pass family step (``ops/pallas3d.py``, kind ``pallas3d_plain``).
On the CPU each runs its kernel's plain version, in the kernel's order:
the fused pass computes E with the x slab CPML, the TFSF record terms
and the point source, then H from that E; the two-pass step patches the
x slab, TFSF and the point source onto each kernel's output.

* Each rung, from one seeded state (E and H at 0.01 N(0, 1)), against
  the reference's own kernel in interpret mode (``use_pallas=True``:
  ``pallas_fused`` under ``FDTD3D_NO_PACKED`` and
  ``FDTD3D_FORCE_FUSED``, ``pallas`` under ``FDTD3D_NO_PACKED`` and
  ``FDTD3D_NO_FUSED``) and against its jnp step, 8 steps at 16^3, on
  the kitchen sink (Drude J with material grids, xyz CPML, TFSF, point
  source), xyz CPML, oblique TFSF, and oblique TFSF with margin 1,
  which puts TFSF faces inside the CPML slabs (the reference's
  ``test_fused_tfsf_in_slab_parity`` geometry). Gate: 2e-6 of each
  family's max on E, H, psi, J and each incident line.
* The dispatch (ROADMAP C1): the kinds and ``tb_fallback`` tokens under
  the ladder's variables against the reference's.
* The dispatch also for magnetic Drude K (f32 and bf16) and compensated
  mode (with a point source; with coefficient grids, where the
  reference declines its kernels and runs its jnp step).
* Sharded runs and float32x2 with K raise, naming their ROADMAP.md item;
  the steps do not mutate the state they are given.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (BASE, CASES, TOL, np_state, ref_config,
                          seed_reference, to_port)

from fdtd3d_torch import convert
from fdtd3d_torch.ops import build, pallas3d, pallas_fused
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_torch.solver import (build_coeffs, build_static,
                                 coeffs_to_device, init_state, make_step)
from fdtd3d_tpu.config import (MaterialsConfig, ParallelConfig, PmlConfig,
                               SimConfig, SphereConfig, TfsfConfig)
from fdtd3d_tpu.sim import Simulation as RSim

LADDER_CASES = {
    "kitchen_sink": CASES["kitchen_sink"],
    "xyz_cpml": CASES["xyz_cpml"],
    "oblique_tfsf": CASES["oblique_tfsf"],
    # margin 1 pushes the TFSF planes into the y/z CPML slabs
    "tfsf_in_slab": dict(
        pml=PmlConfig(size=(3, 3, 3)),
        tfsf=TfsfConfig(enabled=True, margin=(1, 1, 1), angle_teta=30.0,
                        angle_phi=40.0, angle_psi=15.0)),
}

# rung -> (variables, the reference's kernel kind, the port's CPU kind)
RUNGS = {
    "fused": (("FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED"), "pallas_fused",
              "fused_plain"),
    "pallas3d": (("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"), "pallas",
                 "pallas3d_plain"),
}


def case_config(case, **kw) -> SimConfig:
    return SimConfig(**BASE, **LADDER_CASES[case], **kw)


def assert_family_close(want, got, tol: float = TOL):
    """Every leaf of the reference's unpacked state within ``tol`` of
    its family's max: E, H, psi_E, psi_H and J each over all their
    components, each incident line on its own."""
    assert set(want) == set(got), f"keys {set(want)} != {set(got)}"
    for fam, a in want.items():
        if fam == "t":
            assert int(a) == int(got[fam])
            continue
        groups = ({k: {k: v} for k, v in a.items()} if fam == "inc"
                  else {fam: a})
        for name, leaves in groups.items():
            scale = max(float(np.abs(v).max()) for v in leaves.values())
            for k, v in leaves.items():
                g = np.asarray(got[fam][k])
                assert g.shape == v.shape, f"{fam}/{k}: shape"
                err = float(np.abs(np.asarray(v, np.float64) - g).max())
                rel = err / scale if scale > 0 else err
                assert rel < tol, \
                    f"{fam}/{k}: rel {rel:.2e} of the {name} max {scale:.2e}"


def run_rung(case, rung, ref_pallas, monkeypatch, steps=8, seed=7):
    names, ref_kind, port_kind = RUNGS[rung]
    for k in names:
        monkeypatch.setenv(k, "1")
    ref = RSim(case_config(case, use_pallas=ref_pallas))
    seed_reference(ref, seed)
    port = TSim(to_port(case_config(case, use_pallas=True)), device="cpu")
    port.state = convert.state_from_reference(np_state(ref))
    ref.advance(steps)
    port.advance(steps)
    assert ref.step_kind == (ref_kind if ref_pallas else "jnp")
    assert port.step_kind == port_kind
    if ref_pallas:
        assert port.step_diag["tb_fallback"] == ref.step_diag["tb_fallback"]
    return np_state(ref), convert.state_to_reference(port.state)


@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_rung_matches_reference_kernel(case, rung, monkeypatch):
    want, got = run_rung(case, rung, True, monkeypatch)
    assert_family_close(want, got)


@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_rung_matches_reference_jnp(case, rung, monkeypatch):
    want, got = run_rung(case, rung, False, monkeypatch)
    assert_family_close(want, got)


def _port_ladder_kind(cfg) -> str:
    static = build_static(to_port(cfg))
    return "fused_plain" if pallas_fused.fused_preferred(static) \
        else "pallas3d_plain"


# (case, dtype) of the dispatch check: the kitchen sink and the
# compensated and K configurations, bf16 where the mode admits it
# (compensated runs are float32 only)
DISPATCH_CASES = [(case, dtype) for case in
                  ("kitchen_sink", "k_sphere", "compensated_point",
                   "compensated_grid")
                  for dtype in ("float32", "bfloat16")
                  if dtype == "float32" or not case.startswith("compensated")]


@pytest.mark.parametrize("case,dtype", DISPATCH_CASES)
@pytest.mark.parametrize("names", [
    ("FDTD3D_NO_PACKED",), ("FDTD3D_FORCE_FUSED",),
    ("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"),
    ("FDTD3D_FORCE_FUSED", "FDTD3D_NO_FUSED"), ("FDTD3D_NO_FUSED",),
    ("FDTD3D_NO_TEMPORAL", "FDTD3D_NO_PACKED"),
])
def test_dispatch_matches_reference(names, case, dtype, monkeypatch):
    """Each configuration with the kernels wanted: the port's kind
    follows the reference's rung (its jnp step: the port's plain step),
    and ``tb_fallback`` carries the reference's token (ROADMAP C1)."""
    for k in names:
        monkeypatch.setenv(k, "1")
    cfg = ref_config(case, use_pallas=True, dtype=dtype)
    ref = RSim(cfg)
    port = TSim(to_port(cfg), device="cpu")
    kinds = {"pallas_packed_tb": "packed_tb_plain",
             "pallas_packed": "packed_plain",
             "pallas_fused": "fused_plain", "pallas": "pallas3d_plain",
             "jnp": "plain"}
    want = kinds[ref.step_kind]
    if names in (("FDTD3D_NO_PACKED",),
                 ("FDTD3D_NO_TEMPORAL", "FDTD3D_NO_PACKED")) \
            and ref.step_kind in ("pallas_fused", "pallas"):
        want = _port_ladder_kind(cfg)     # the port's own rule
    assert port.step_kind == want
    if ref.step_kind == "pallas_packed_tb":
        assert port.step_diag["temporal_block"] == 2
        return
    assert port.step_diag["tb_fallback"] == ref.step_diag["tb_fallback"]


@pytest.mark.parametrize("name", ["FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED"])
def test_batched_build_under_the_ladder_raises(name, monkeypatch):
    """No lane-capable kernel lies below packed: a batched build that the
    dispatch authority was not asked about raises, as in the
    reference."""
    monkeypatch.setenv(name, "1")
    static = build_static(to_port(ref_config("xyz_cpml", use_pallas=True)))
    with pytest.raises(RuntimeError, match="lane-capable"):
        make_step(static, "cpu", batch=2)


def test_float32x2_under_no_packed_takes_the_plain_ds_step(monkeypatch):
    monkeypatch.setenv("FDTD3D_NO_PACKED", "1")
    cfg = ref_config("kitchen_sink", use_pallas=True, dtype="float32x2")
    ref = RSim(cfg)
    port = TSim(to_port(cfg), device="cpu")
    assert ref.step_kind == "jnp_ds"
    assert port.step_kind == "plain_ds"
    assert port.step_diag["tb_fallback"] == ref.step_diag["tb_fallback"] \
        == {"reason": "ds_fields"}


_K = MaterialsConfig(use_drude_m=True, mu_inf=1.5, omega_pm=1e11,
                     gamma_m=1e10,
                     drude_m_sphere=SphereConfig(enabled=True,
                                                 center=(8, 8, 8), radius=3))


@pytest.mark.parametrize("names", [("FDTD3D_NO_PACKED",),
                                   ("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED")])
@pytest.mark.parametrize("kw,item", [
    (dict(dtype="float32x2", materials=_K), r"B4\(b\)"),
    (dict(dtype="bfloat16", materials=_K, parallel=ParallelConfig(
        topology="manual", manual_topology=(1, 2, 1))), "A11"),
    (dict(parallel=ParallelConfig(topology="manual",
                                  manual_topology=(2, 1, 1))), "A11"),
])
def test_out_of_scope_configs_raise_naming_their_item(kw, item, names,
                                                      monkeypatch):
    for k in names:
        monkeypatch.setenv(k, "1")
    cfg = to_port(ref_config("xyz_cpml", use_pallas=True, **kw))
    with pytest.raises(NotImplementedError, match=item):
        TSim(cfg, device="cpu")


@pytest.mark.parametrize("change,item", [
    (dict(use_drude_m=True, topology=(1, 2, 1)), "A11"),
    (dict(dtype="bfloat16", use_drude_m=True, topology=(1, 1, 2)), "A11"),
    (dict(topology=(2, 1, 1)), "A11"),
])
def test_builders_raise_naming_their_item(change, item):
    """The kernels' own builders refuse what the reference's kernels
    cover and these twins do not, whoever calls them: a sharded static
    (with f32 or bf16 storage, with magnetic Drude K or without, which
    are in their scope) raises in the two-pass builder and is not
    fused-eligible, as in the reference."""
    static = build_static(to_port(ref_config("xyz_cpml")))
    change = dict(change)
    if "dtype" in change:
        static = dataclasses.replace(static, cfg=dataclasses.replace(
            static.cfg, dtype=change.pop("dtype")))
    static = dataclasses.replace(static, **change)
    with pytest.raises(NotImplementedError, match=item):
        pallas3d.make_pallas_step(static, "cpu")
    if "topology" in change:
        assert pallas_fused.make_fused_eh_step(static, "cpu") is None
    else:
        with pytest.raises(NotImplementedError, match=item):
            pallas_fused.make_fused_eh_step(static, "cpu")


@pytest.mark.parametrize("build_step", [pallas3d.make_pallas_step,
                                        pallas_fused.make_fused_eh_step])
def test_steps_leave_their_input_state_alone(build_step):
    """Both steps write fresh outputs and patch those: the state they
    are given is unchanged, and no kernel is built or launched on the
    CPU."""
    pallas3d.e_family.launches = pallas3d.h_family.launches = 0
    pallas_fused.fused_eh.launches = 0
    static = build_static(to_port(ref_config("kitchen_sink")))
    coeffs = coeffs_to_device(build_coeffs(static), "cpu")
    state = init_state(static, "cpu")
    rng = np.random.RandomState(3)
    for grp in ("E", "H", "J", "psi_E", "psi_H", "inc"):
        for v in state[grp].values():
            v.copy_(torch.from_numpy(0.01 * rng.standard_normal(
                v.shape).astype(np.float32)))
    before = convert.state_to_reference(state)
    step = build_step(static, "cpu")
    after = step(state, step.prepare(coeffs))
    assert after["t"] == 1
    for grp, leaves in convert.state_to_reference(state).items():
        if grp == "t":
            continue
        for k, v in leaves.items():
            np.testing.assert_array_equal(v, before[grp][k])
    assert pallas3d.e_family.launches == pallas3d.h_family.launches == 0
    assert pallas_fused.fused_eh.launches == 0
    assert "family" not in build._LIBS and "fused_eh" not in build._LIBS


@pytest.mark.parametrize("case", ["kitchen_sink", "oblique_tfsf"])
def test_planned_face_patches_equal_plane_corrections(case):
    """The TFSF face patches planned once per coefficient dict
    (``tfsf_plan``) add, per face, the bits of ``cb`` times the
    reference-style ``plane_corrections`` term computed from scratch,
    PEC walls applied."""
    static = build_static(to_port(ref_config(case)))
    coeffs = coeffs_to_device(build_coeffs(static), "cpu")
    rng = np.random.RandomState(11)
    n = static.tfsf_setup.n_inc
    inc = {k: torch.from_numpy(rng.standard_normal(n).astype(np.float32))
           for k in ("Einc", "Hinc")}
    for family in ("E", "H"):
        comps = static.mode.e_components if family == "E" \
            else static.mode.h_components
        planned = {c: torch.zeros(static.grid_shape) for c in comps}
        pallas3d.tfsf_patch(static, family, planned, coeffs, inc)
        want = {c: torch.zeros(static.grid_shape) for c in comps}
        sign = 1.0 if family == "E" else -1.0
        for c in comps:
            cb = coeffs[("cb_" if family == "E" else "db_") + c]
            for axis, plane, term in pallas3d.plane_corrections(
                    family, c, static.tfsf_setup, coeffs, inc,
                    static.mode.active_axes, static.dx):
                if family == "E":
                    for a2 in static.mode.active_axes:
                        if a2 not in (axis,
                                      static.mode.e_components.index(c)):
                            w = coeffs[f"wall_{'xyz'[a2]}"]
                            shape = [1, 1, 1]
                            shape[a2] = w.shape[0]
                            term = term * w.reshape(shape)
                scale = cb.narrow(axis, plane, 1) \
                    if isinstance(cb, torch.Tensor) else cb
                want[c].narrow(axis, plane, 1).add_(sign * scale * term)
        for c in comps:
            assert torch.equal(planned[c], want[c]), f"{family} {c}"

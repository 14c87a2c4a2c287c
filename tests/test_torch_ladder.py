"""The kernel ladder below packed against the JAX reference on the CPU.

The port's two rungs under the packed step: the recompute-fused single
pass (``ops/pallas_fused.py``, kind ``fused_plain`` on the CPU) and the
two-pass family step (``ops/pallas3d.py``, kind ``pallas3d_plain``).
On the CPU each runs its kernels' plain versions, in the kernels' order:
the fused pass computes E with the x slab CPML, the TFSF record terms
and the point source, then H from that E; the two-pass step does the
same in two launches (E with every term, then H from the stored E), and
patches nothing afterwards, where the reference patches the x slab,
TFSF and the point source onto each kernel's output.

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
* The two-pass rung in bf16 (gate 2e-2, the reference's bf16 gate) on
  every case of tests/torch_parity.py, a K sphere and the TFSF planes
  inside the slabs, and in f32 on the cases the line above leaves out,
  against the reference's interpret-mode ``pallas`` kernel and its jnp
  step: the plain version's sources inside the accumulator hold the
  reference's patches' gates (the reference rounds a patched bf16 cell
  twice, the port once).
* The two-pass step issues none of the reference's patches: the
  port's patch helpers are gone, and stand-ins that raise change
  nothing.
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
from torch_parity import (BASE, CASES, MODE_CASES, TOL, np_state,
                          ref_config, seed_reference, to_port)

from fdtd3d_torch import convert
from fdtd3d_torch.ops import build, patches, pallas3d, pallas_fused
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


def run_rung(case, rung, ref_pallas, monkeypatch, steps=8, seed=7,
             cases=None, **kw):
    names, ref_kind, port_kind = RUNGS[rung]
    for k in names:
        monkeypatch.setenv(k, "1")
    spec = (cases or LADDER_CASES)[case]
    ref = RSim(SimConfig(**BASE, **spec, use_pallas=ref_pallas, **kw))
    seed_reference(ref, seed)
    port = TSim(to_port(SimConfig(**BASE, **spec, use_pallas=True, **kw)),
                device="cpu")
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
    if item == r"B4\(b\)":
        # ported (float32x2 with K): the escape hatches send it to the
        # plain ds step, the bottom of the ds ladder (the reference's
        # jnp-ds rung), which carries K
        sim = TSim(cfg, device="cpu").run(2)
        assert sim.step_kind == "plain_ds" and "K" in sim.state
        return
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


# every case of tests/torch_parity.py, a K sphere and the TFSF planes
# inside the slabs, on the two-pass rung: bf16 on all of them, f32 on
# those test_rung_matches_reference_* above leave out
TWO_PASS_CASES = dict(CASES, k_sphere=MODE_CASES["k_sphere"],
                      tfsf_in_slab=LADDER_CASES["tfsf_in_slab"])
TWO_PASS_TOLS = {"float32": TOL, "bfloat16": 2e-2}


@pytest.mark.parametrize("ref_pallas", [True, False],
                         ids=["interpret_kernel", "jnp"])
@pytest.mark.parametrize("case,dtype", [
    (case, dtype) for case in sorted(TWO_PASS_CASES)
    for dtype in sorted(TWO_PASS_TOLS)
    if dtype == "bfloat16" or case not in LADDER_CASES])
def test_two_pass_rung_on_every_case(case, dtype, ref_pallas, monkeypatch):
    """The two-pass rung (its plain versions, with the x slab, the
    records and the point source added into the accumulator) against the
    reference's two-pass kernel in interpret mode, which patches them on,
    and against its jnp step: 8 steps at 16^3 from one seeded state, at
    2e-6 (f32) or 2e-2 (bf16) of each family's max."""
    want, got = run_rung(case, "pallas3d", ref_pallas, monkeypatch,
                         cases=TWO_PASS_CASES, dtype=dtype)
    assert_family_close(want, got, TWO_PASS_TOLS[dtype])


def test_two_pass_step_issues_no_patches(monkeypatch):
    """The reference's post-passes (``x_slab_post``, ``tfsf_patch``,
    ``point_source_patch``) have no counterpart left in the two-pass
    module, and stand-ins that raise, there and in ``ops/patches.py``
    (the packed step's patches), leave a step of the kitchen sink (x
    CPML, TFSF, point source, Drude J, grids) as it was."""
    static = build_static(to_port(ref_config("kitchen_sink")))
    coeffs = coeffs_to_device(build_coeffs(static), "cpu")
    state = init_state(static, "cpu")
    rng = np.random.RandomState(5)
    for grp in ("E", "H", "J", "psi_E", "psi_H", "inc"):
        for v in state[grp].values():
            v.copy_(torch.from_numpy(0.01 * rng.standard_normal(
                v.shape).astype(np.float32)))
    step = pallas3d.make_pallas_step(static, "cpu")
    fp = step.prepare(coeffs)
    want = convert.state_to_reference(step(state, fp))
    names = ("x_slab_post", "slab_post", "tfsf_patch", "point_source_patch",
             "tfsf_plan", "point_plan")
    assert not any(hasattr(pallas3d, n) for n in names)

    def raiser(*args, **kw):
        raise AssertionError("the two-pass step issued a patch")
    for n in names:
        monkeypatch.setattr(pallas3d, n, raiser, raising=False)
    for n in ("tfsf_patch", "point_source_patch"):
        monkeypatch.setattr(patches, n, raiser)
    got = convert.state_to_reference(step(state, fp))
    for grp, leaves in want.items():
        if grp == "t":
            assert int(got[grp]) == int(leaves)
            continue
        for k, v in leaves.items():
            np.testing.assert_array_equal(got[grp][k], v)

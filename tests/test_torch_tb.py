"""The port's temporal-blocked pass (ops/packed_tb.py) against the JAX
reference on the CPU.

On the CPU the pass runs its plain version (``tb_pass_plain``, kind
``packed_tb_plain``): two generations over the whole volume with the
sources added into the accumulator, as the CUDA kernel does. Held at
the reference's 2e-6 gate on E, H, psi, J, the incident line and t:

* against the reference's jnp step (``use_pallas=False``) over the
  parametrised set of tests/torch_parity.py, for an even horizon (8: four
  passes) and an odd one (9: four passes and one packed tail step);
* against the reference's own temporal-blocked kernel in interpret mode
  (``use_pallas=True``, ``FDTD3D_TB_DEPTH=2``), for oblique TFSF at an
  even horizon and the kitchen sink at an odd one;
* the scope tokens of ``reject_reason`` against the reference's
  ``_reject_reason``, and the ``tb_fallback`` record of the other kinds;
* chunking (advance(8) against advance(3) + advance(5)) and set_field
  on the live buffer after a pass.
"""

import numpy as np
import pytest
from torch_parity import (CASES, assert_state_close, np_state, ref_config,
                          seed_reference, to_port)

from fdtd3d_torch import convert
from fdtd3d_torch.ops import build, packed_tb
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_torch.solver import build_static
from fdtd3d_tpu.config import PointSourceConfig
from fdtd3d_tpu.ops import pallas_packed_tb
from fdtd3d_tpu.sim import Simulation as RSim
from fdtd3d_tpu.solver import build_static as ref_build_static


def run_tb_pair(case: str, steps: int, ref_pallas: bool, seed: int = 4):
    """The reference (jnp step or its interpret-mode tb kernel) and the
    port's tb pass from one seeded state; both final states, unpacked."""
    ref = RSim(ref_config(case, use_pallas=ref_pallas))
    seed_reference(ref, seed)
    port = TSim(to_port(ref_config(case, use_pallas=True)), device="cpu")
    port.state = convert.state_from_reference(np_state(ref))
    ref.advance(steps)
    port.advance(steps)
    assert port.step_kind == "packed_tb_plain"
    assert port.step_diag["temporal_block"] == 2
    return np_state(ref), convert.state_to_reference(port.state), ref


@pytest.mark.parametrize("steps", [8, 9])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tb_matches_reference_jnp(case, steps):
    want, got, ref = run_tb_pair(case, steps, ref_pallas=False)
    assert ref.step_kind == "jnp"
    assert int(got["t"]) == steps
    assert_state_close(want, got)


@pytest.mark.parametrize("case,steps", [("oblique_tfsf", 8),
                                        ("kitchen_sink", 9)])
def test_tb_matches_reference_tb_kernel(case, steps, monkeypatch):
    monkeypatch.setenv("FDTD3D_TB_DEPTH", "2")
    want, got, ref = run_tb_pair(case, steps, ref_pallas=True)
    assert ref.step_kind == "pallas_packed_tb", ref.step_kind
    assert ref.step_diag["temporal_block"] == 2
    assert_state_close(want, got)


@pytest.mark.parametrize("case,kw,token", [
    ("kitchen_sink", dict(), None),
    ("kitchen_sink", dict(dtype="float32x2"), "ds_fields"),
    ("xyz_cpml", dict(point_source=PointSourceConfig(
        enabled=True, component="Ez", position=(2, 8, 8))),
     "source_in_absorber"),
])
def test_reject_reason_matches_reference(case, kw, token):
    cfg = ref_config(case, **kw)
    assert pallas_packed_tb._reject_reason(ref_build_static(cfg)) == token
    assert packed_tb.reject_reason(build_static(to_port(cfg))) == token


@pytest.mark.parametrize("kw,env,reason,kind", [
    (dict(use_pallas=True), {"FDTD3D_NO_TEMPORAL": "1"},
     "env:FDTD3D_NO_TEMPORAL", "packed_plain"),
    (dict(use_pallas=True), {"FDTD3D_TB_DEPTH": "3"}, "depth",
     "packed_plain"),
    (dict(use_pallas=False), {}, "pallas_disabled", "plain"),
    (dict(use_pallas=True, dtype="float32x2"), {}, "ds_fields",
     "packed_ds_plain"),
    (dict(dtype="float64"), {}, "dtype", "plain"),
    # FDTD3D_NO_PACKED alone: the rung pallas_fused.fused_preferred names
    # (the two-pass one for the kitchen sink's coefficient grids)
    (dict(use_pallas=True), {"FDTD3D_NO_PACKED": "1"},
     "env:FDTD3D_NO_PACKED", "pallas3d_plain"),
    (dict(use_pallas=True), {"FDTD3D_FORCE_FUSED": "1"},
     "env:FDTD3D_FORCE_FUSED", "fused_plain"),
])
def test_other_kinds_name_their_tb_fallback(kw, env, reason, kind,
                                            monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sim = TSim(to_port(ref_config("kitchen_sink", **kw)), device="cpu")
    assert sim.step_kind == kind
    assert sim.step_diag["tb_fallback"] == {"reason": reason}


def test_chunks_and_set_field_on_the_live_buffer():
    """advance(8) against advance(3) + advance(5) (passes and tail steps
    in other places: equal at the gate); set_field after a pass writes
    the buffer the next pass reads, and no kernel is built on the CPU."""
    packed_tb.tb_pass.launches = 0
    cfg = to_port(ref_config("kitchen_sink", use_pallas=True))
    one, two = TSim(cfg, device="cpu"), TSim(cfg, device="cpu")
    rng = np.random.RandomState(5)
    init = convert.state_to_reference(one.state)
    for grp in ("E", "H"):
        for c in init[grp]:
            init[grp][c] = 0.01 * rng.standard_normal(
                init[grp][c].shape).astype(np.float32)
    for sim in (one, two):
        sim.state = convert.state_from_reference(init)
    one.advance(8)
    two.advance(3)
    two.advance(5)
    assert one.t == two.t == 8
    assert_state_close(convert.state_to_reference(one.state),
                       convert.state_to_reference(two.state))

    live = one._carry["E"]
    value = np.full((16, 16, 16), 0.5, np.float32)
    one.set_field("Ey", value)
    assert one._carry["E"] is live
    np.testing.assert_array_equal(one.field("Ey"), value)
    fresh = TSim(cfg, device="cpu")
    fresh.state = one.state
    one.advance(2)
    fresh.advance(2)
    np.testing.assert_array_equal(one.field("Ey"), fresh.field("Ey"))
    assert one._carry["E"] is not live        # the pass swapped buffers
    assert packed_tb.tb_pass.launches == 0
    assert "packed_tb" not in build._LIBS

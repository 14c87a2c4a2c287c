"""The PyTorch port's steps against the JAX reference on the CPU.

* the port's plain step against the reference's jnp step
  (``use_pallas=False``), over the parametrised set of
  tests/torch_parity.py;
* the port's packed step (its kernels' plain versions, on the CPU)
  against the reference's packed Pallas kernel in interpret mode
  (``use_pallas=True`` with ``FDTD3D_NO_TEMPORAL=1``, as
  tests/test_pallas_packed.py runs it);
* the port's temporal-blocked pass and its packed single step (with
  ``FDTD3D_NO_TEMPORAL=1``) against its plain step.

Both sides start from the same seeded fields, carried across with
fdtd3d_torch.convert, and are compared on E, H, psi, J, the incident
line and t at the reference's 2e-6 gate.
"""

import numpy as np
import pytest
from torch_parity import (CASES, assert_state_close, ref_config, run_pair,
                          to_port)

from fdtd3d_torch import convert
from fdtd3d_torch.sim import Simulation as TSim


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_step_matches_reference_jnp(case):
    want, got, ref, port = run_pair(ref_config(case, use_pallas=False),
                                    seed=1)
    assert ref.step_kind == "jnp"
    assert port.step_kind == "plain"
    assert_state_close(want, got)


@pytest.mark.parametrize("case", ["xyz_cpml", "oblique_tfsf",
                                  "kitchen_sink"])
def test_packed_step_matches_reference_packed_kernel(case, monkeypatch):
    monkeypatch.setenv("FDTD3D_NO_TEMPORAL", "1")
    want, got, ref, port = run_pair(ref_config(case, use_pallas=True),
                                    seed=2)
    assert ref.step_kind == "pallas_packed", ref.step_kind
    assert port.step_kind == "packed_plain"
    assert_state_close(want, got)


@pytest.mark.parametrize("kind", ["packed_tb_plain", "packed_plain"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_step_matches_plain_step(case, kind, monkeypatch):
    """The kernels' arithmetic (plain versions on the packed carry: the
    temporal-blocked pass with in-kernel sources, or the single step
    with the source patches between its launches) against the port's
    own oracle, over 12 steps from seeded fields."""
    if kind == "packed_plain":
        monkeypatch.setenv("FDTD3D_NO_TEMPORAL", "1")
    rng = np.random.RandomState(7)
    sims = [TSim(to_port(ref_config(case, use_pallas=flag)), device="cpu")
            for flag in (False, True)]
    init = convert.state_to_reference(sims[0].state)
    for grp in ("E", "H"):
        for c in init[grp]:
            init[grp][c] = 0.01 * rng.standard_normal(
                init[grp][c].shape).astype(np.float32)
    for sim in sims:
        sim.state = convert.state_from_reference(init)
        sim.advance(12)
    assert [s.step_kind for s in sims] == ["plain", kind]
    assert_state_close(convert.state_to_reference(sims[0].state),
                       convert.state_to_reference(sims[1].state))


def test_packed_carry_across_chunks_and_edits():
    """Several advance() calls reuse the packed carry; set_field writes
    into it; sample() reads it; state is a snapshot."""
    cfg = to_port(ref_config("point_source", use_pallas=True))
    one = TSim(cfg, device="cpu")
    one.advance(8)
    many = TSim(cfg, device="cpu")
    for _ in range(4):
        many.advance(2)
        snap = many.state
        snap["E"]["Ez"].zero_()          # a snapshot: the carry is intact
    np.testing.assert_array_equal(one.field("Ez"), many.field("Ez"))
    assert one.t == many.t == 8
    assert many.sample("Ez", (7, 8, 9)) == float(many.field("Ez")[7, 8, 9])
    many.set_field("Ez", np.zeros((16, 16, 16), np.float32))
    assert many.sample("Ez", (7, 8, 9)) == 0.0
    many.advance(1)
    assert np.isfinite(many.field("Ez")).all()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_set_field_resets_the_lo_word(use_pallas):
    """float32x2: set_field writes the hi word and zeroes the lo word
    (the pair's value is hi + lo), in dict and packed carries alike;
    field() returns the hi word."""
    cfg = to_port(ref_config("xyz_cpml", dtype="float32x2",
                             use_pallas=use_pallas))
    sim = TSim(cfg, device="cpu")
    rng = np.random.RandomState(3)
    st = convert.state_to_reference(sim.state)
    st["E"]["Ey"] = 0.01 * rng.standard_normal((16, 16, 16)).astype(
        np.float32)
    st["loE"]["Ey"] = 1e-11 * rng.standard_normal((16, 16, 16)).astype(
        np.float32)
    sim.state = convert.state_from_reference(st)
    sim.advance(2)
    assert np.abs(convert.state_to_reference(sim.state)["loE"]["Ey"])\
        .max() > 0
    value = np.full((16, 16, 16), 0.25, np.float32)
    sim.set_field("Ey", value)
    snap = convert.state_to_reference(sim.state)
    np.testing.assert_array_equal(snap["E"]["Ey"], value)
    assert not np.any(snap["loE"]["Ey"])
    assert np.abs(snap["loE"]["Ex"]).max() > 0      # the others stay
    np.testing.assert_array_equal(sim.field("Ey"), value)

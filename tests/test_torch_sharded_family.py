"""The sharded two-pass family step (B3(c): ``ops/pallas3d.py::
make_sharded_pallas_step``, the sharded builds of ``csrc/family.cu``)
against the reference on its 8-device virtual CPU mesh, mirroring
tests/test_pallas_sharded.py.

The reference's dispatch lands a sharded run on its two-pass kernels
(its ``pallas`` kind) in three cases, each covered here: the ladder
variables ``FDTD3D_NO_PACKED``/``FDTD3D_FORCE_FUSED`` (its fused kernel
is unsharded only), a source inside the absorber (its sharded packed
kernel declines it), and a y or z shard too thin for slab psi (its
kernel keeps full-length psi there). On each case, from the same
numpy-seeded fields:

* the port's sharded run against the reference's sharded ``pallas``
  run, every leaf at 2e-6 of its family max (bf16 2e-2): an x-sharded
  (2,2,1), a thin-y (1,4,2) with full-length y psi, bf16, Drude J and
  magnetic Drude K spheres (with an eps grid) whose boxes cross every
  shard edge, a point source inside the x CPML on (2,2,2) with no
  variable set;
* the same runs against the port's unsharded two-pass run
  (``FDTD3D_NO_PACKED`` + ``FDTD3D_NO_FUSED``) bit for bit, psi moved to
  the unsharded layout (``io.reshard_psi_tree``): a thin shard's
  full-length psi is identity outside the absorber (b = c = 0,
  1/kappa = 1), so it adds a zero there;
* the step kind and ``tb_fallback`` token follow the reference's on each
  case (and a run outside them stays on the sharded packed step); a thin
  x shard, compensated mode and float32x2 under ``FDTD3D_NO_PACKED``
  still raise A11(b);
* the CUDA kernel's sharded march (ghost planes loaded where the kernel
  loads them, open walls, full-length psi) emulated on the CPU item by
  item through the ring (``test_torch_family_plan.emulate``) equals the
  plain versions with ghosts bit for bit, shard by shard, at a small
  tile that puts many halos on the shard edges;
* ``stencil.exchange_components`` copies the planes
  ``exchange_stack`` copies;
* a checkpoint written on (1,4,1) (full-length y psi) and restored
  unsharded, and the reverse, continue bit-equal to the uninterrupted
  run.
"""

import numpy as np
import pytest
import torch
from test_torch_family_plan import emulate
from torch_parity import (assert_state_close, np_state, seed_reference,
                          to_port)

from fdtd3d_torch import convert
from fdtd3d_torch import io as tio
from fdtd3d_torch import solver as tsolver
from fdtd3d_torch.ops import pallas3d, stencil, tfsf
from fdtd3d_torch.parallel.mesh import ShardMesh
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu.config import (MaterialsConfig, OutputConfig,
                               ParallelConfig, PmlConfig, PointSourceConfig,
                               SimConfig, SphereConfig, TfsfConfig)
from fdtd3d_tpu.sim import Simulation as RSim

TOL = 2e-6
BF16_TOL = 2e-2
N = 16
STEPS = 5
LADDER = ("FDTD3D_NO_TEMPORAL", "FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED",
          "FDTD3D_NO_FUSED")
JK = MaterialsConfig(
    eps=1.0, eps_sphere=SphereConfig(enabled=True, center=(8, 7, 8),
                                     radius=5, value=3.0),
    use_drude=True, eps_inf=1.5, omega_p=1e11, gamma=1e10,
    drude_sphere=SphereConfig(enabled=True, center=(8, 8, 8), radius=3),
    use_drude_m=True, mu_inf=1.5, omega_pm=1e11, gamma_m=1e10,
    drude_m_sphere=SphereConfig(enabled=True, center=(8, 8, 8), radius=3))

# name -> (topology, variables set, configuration, the reference's token)
CASES = {
    "x_221": ((2, 2, 1), ("FDTD3D_NO_PACKED",), {}, "env:FDTD3D_NO_PACKED"),
    "thin_y_142": ((1, 4, 2), (), {}, "thin_grid_psi"),
    "bf16_221": ((2, 2, 1), ("FDTD3D_NO_PACKED",), dict(dtype="bfloat16"),
                 "env:FDTD3D_NO_PACKED"),
    "jk_122": ((1, 2, 2), ("FDTD3D_FORCE_FUSED",), dict(materials=JK),
               "magnetic_drude"),
    "absorber_222": ((2, 2, 2), (), dict(point_source=PointSourceConfig(
        enabled=True, component="Ez", position=(1, 9, 7))),
        "packed_ineligible"),
}


def cfg_of(case, topo=None, **kw) -> SimConfig:
    """16^3, pml 2 (a local x of 8 holds slab psi, a local y of 4 does
    not), an oblique plane wave and a point source, the case's
    configuration; ``topo`` None: unsharded."""
    par = ParallelConfig() if topo is None else ParallelConfig(
        topology="manual", manual_topology=topo)
    base = dict(scheme="3D", size=(N, N, N), time_steps=STEPS, dx=1e-3,
                courant_factor=0.4, wavelength=8e-3,
                pml=PmlConfig(size=(2, 2, 2)),
                tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2),
                                angle_teta=30.0, angle_phi=40.0,
                                angle_psi=15.0),
                point_source=PointSourceConfig(enabled=True, component="Ez",
                                               position=(5, 9, 7)),
                parallel=par, use_pallas=True)
    base.update(CASES[case][2] if case in CASES else {})
    base.update(kw)
    return SimConfig(**base)


def set_env(mp, names):
    for k in LADDER:
        mp.delenv(k, raising=False)
    for k in names:
        mp.setenv(k, "1")


def seeded_pair(case, topo, names, seed=3):
    """The reference's and the port's Simulation of ``case`` on
    ``topo`` under ``names``, the port's state the reference's seeded
    one."""
    mp = pytest.MonkeyPatch()
    try:
        set_env(mp, names)
        ref = RSim(cfg_of(case, topo))
        seed_reference(ref, seed)
        port = TSim(to_port(cfg_of(case, topo)), device="cpu")
        port.adopt_state(convert.state_from_reference(np_state(ref)))
    finally:
        mp.undo()
    return ref, port


_RUNS = {}


def runs(case):
    """(the reference's final state, the port's sharded run's, the
    port's Simulation, the reference's kind and token) of ``case``,
    cached per module."""
    if case not in _RUNS:
        topo, names, _, _ = CASES[case]
        ref, port = seeded_pair(case, topo, names)
        kind = (ref.step_kind, (ref.step_diag or {}).get(
            "tb_fallback", {}).get("reason"))
        ref.advance(STEPS)
        port.advance(STEPS)
        _RUNS[case] = (np_state(ref), convert.state_to_reference(port.state),
                       port, kind)
    return _RUNS[case]


_UNSHARDED = {}


def unsharded(case):
    """The port's unsharded two-pass run of ``case`` from the same
    seeded fields (the reference's unpacked numpy form) and its
    static."""
    if case not in _UNSHARDED:
        mp = pytest.MonkeyPatch()
        try:
            set_env(mp, ("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"))
            ref = RSim(cfg_of(case, use_pallas=False))
            seed_reference(ref, 3)
            port = TSim(to_port(cfg_of(case)), device="cpu")
            assert port.step_kind == "pallas3d_plain", port.step_kind
            port.state = convert.state_from_reference(np_state(ref))
            port.advance(STEPS)
        finally:
            mp.undo()
        _UNSHARDED[case] = (convert.state_to_reference(port.state),
                            port.static)
    return _UNSHARDED[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_two_pass_matches_reference(case):
    want, got, port, (kind, _) = runs(case)
    assert kind == "pallas"
    assert port.mesh is not None and port.step_kind == "pallas3d_plain"
    assert_state_close(want, got, BF16_TOL if "bf16" in case else TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_two_pass_equals_unsharded_two_pass(case):
    _, got, port, _ = runs(case)
    uwant, ustatic = unsharded(case)
    moved = tio.reshard_psi_tree(
        got, ustatic.grid_shape, port.topology,
        tsolver.slab_axes(port.static), (1, 1, 1),
        tsolver.slab_axes(ustatic))
    for grp, leaves in uwant.items():
        if not isinstance(leaves, dict):
            continue
        for k in leaves:
            np.testing.assert_array_equal(moved[grp][k], leaves[k],
                                          err_msg=f"{case}: {grp}/{k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatch_kind_and_token_follow_reference(case):
    _, _, port, (kind, token) = runs(case)
    assert kind == "pallas" and token == CASES[case][3]
    assert port.step_kind == "pallas3d_plain"
    assert port.step_diag["tb_fallback"]["reason"] == token
    assert port.step_diag["topology"] == list(CASES[case][0])


def test_outside_the_cases_stays_on_the_sharded_packed_step(monkeypatch):
    set_env(monkeypatch, ())
    port = TSim(to_port(cfg_of("x_221", (2, 2, 1))), device="cpu")
    assert port.step_kind == "packed_plain"
    assert port.step_diag["tb_fallback"]["reason"] == "sharded_tb:B2(d)"
    # the reference's sharded packed kernels (its tb pass, B2(d) here)
    ref = RSim(cfg_of("x_221", (2, 2, 1)))
    assert ref.step_kind in ("pallas_packed_tb", "pallas_packed")


@pytest.mark.parametrize("topo,names,kw", [
    ((4, 1, 1), (), {}),                                 # thin x: jnp
    ((4, 1, 1), ("FDTD3D_NO_PACKED",), {}),
    ((2, 2, 1), ("FDTD3D_NO_PACKED",), dict(compensated=True)),
    ((1, 4, 1), (), dict(compensated=True)),
    ((2, 2, 1), ("FDTD3D_NO_PACKED",), dict(dtype="float32x2")),
])
def test_what_the_reference_runs_on_its_jnp_step_raises(topo, names, kw,
                                                        monkeypatch):
    set_env(monkeypatch, names)
    with pytest.raises(NotImplementedError, match=r"A11\(b\)"):
        TSim(to_port(cfg_of("x_221", topo, **kw)), device="cpu")
    assert RSim(cfg_of("x_221", topo, **kw)).step_kind in ("jnp", "jnp_ds")


# --------------------------------------------------------------------------
# the kernel's sharded march, emulated shard by shard
# --------------------------------------------------------------------------

def seeded_port(case, topo, names, seed=11):
    """A port Simulation of ``case`` on ``topo`` with every E, H, J, K
    and psi leaf seeded (numpy, in the global form)."""
    mp = pytest.MonkeyPatch()
    try:
        set_env(mp, names)
        sim = TSim(to_port(cfg_of(case, topo)), device="cpu")
    finally:
        mp.undo()
    rng = np.random.RandomState(seed)
    tree = {}
    for grp, leaves in sim.state.items():
        if not isinstance(leaves, dict) or grp == "inc":
            continue
        tree[grp] = {k: torch.from_numpy(
            (0.01 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
        ).to(v.dtype) for k, v in leaves.items()}
    sim.adopt_state(dict(sim.state, **tree))
    return sim


@pytest.mark.parametrize("case,tile", [
    ("x_221", (2, 8)), ("thin_y_142", (1, 4)), ("bf16_221", (2, 4)),
    ("jk_122", (3, 8)), ("absorber_222", (2, 8))])
def test_emulated_sharded_march_equals_the_plain_version(case, tile):
    topo, names, _, _ = CASES[case]
    sim = seeded_port(case, topo, names)
    step = pallas3d.make_sharded_pallas_step(sim.static, sim.mesh)
    fps = step.prepare(sim.coeffs)
    shards = sim._carry["shards"]
    local = tsolver.shard_static(sim.static, sim.mesh)
    gh = step.exchange(shards, -1)
    new_e = []
    for r, (ps, fp) in enumerate(zip(shards, fps)):
        inc = tfsf.advance_einc(ps["inc"], fp["coeffs"], 3, local.dt,
                                local.omega, local.tfsf_setup)
        terms = tfsf.record_terms(fp["plan"], inc)
        drive = pallas3d.point_drive(local, fp, 3)
        psi = {k: ps["psi_E"][k] for v in fp["E"]["psi"].values()
               for _, k in v}
        want = pallas3d.e_family_plain(ps["E"], ps["H"], psi, ps.get("J"),
                                       fp, terms, drive, ghost=gh[r])
        got = emulate(ps["E"], ps["H"], psi, ps.get("J"), fp, "E", terms,
                      drive, tile, ghost=gh[r])
        for g, w in zip(got, want):
            for k in (w or {}):
                assert torch.equal(g[k], w[k]), f"{case} shard {r} E {k}"
        new_e.append(want[0])
    ge = step.exchange([{"E": e} for e in new_e], 1)
    for r, (ps, fp) in enumerate(zip(shards, fps)):
        psi = {k: ps["psi_H"][k] for v in fp["H"]["psi"].values()
               for _, k in v}
        want = pallas3d.h_family_plain(ps["H"], new_e[r], psi, fp,
                                       ps.get("K"), None, ghost=ge[r])
        got = emulate(ps["H"], new_e[r], psi, ps.get("K"), fp, "H", None,
                      None, tile, ghost=ge[r])
        for g, w in zip(got, want):
            for k in (w or {}):
                assert torch.equal(g[k], w[k]), f"{case} shard {r} H {k}"


def test_shard_operands_carry_local_records_and_the_owner_point():
    sim = seeded_port("absorber_222", (2, 2, 2), ())
    step = pallas3d.make_sharded_pallas_step(sim.static, sim.mesh)
    fps = step.prepare(sim.coeffs)
    owner, cell = sim.mesh.owner((1, 9, 7))
    for r, fp in enumerate(fps):
        assert (fp["point"] is not None) == (r == owner)
        if r == owner:
            assert fp["point"][1] == tuple(cell)
        assert fp["E"]["open"] == sim.mesh.open_sides(r)
        for fam in ("E", "H"):
            for _, axis, plane, _ in fp[f"rec_{fam}"]:
                assert 0 <= plane < sim.mesh.local_shape[axis]
    thin = seeded_port("thin_y_142", (1, 4, 2), ())
    fp = pallas3d.make_sharded_pallas_step(
        thin.static, thin.mesh).prepare(thin.coeffs)[0]
    assert fp["E"]["full"] == {1: 4} and set(fp["E"]["m"]) == {0, 2}
    assert tuple(fp["E"]["prof"][1].shape) == (3, 4)


def test_exchange_components_copies_what_exchange_stack_copies():
    mesh = ShardMesh((2, 2, 2), (8, 6, 4), ["cpu"] * 8)
    rng = np.random.RandomState(5)
    stacks = [torch.from_numpy(rng.standard_normal(
        (3,) + mesh.local_shape).astype(np.float32)) for _ in range(8)]
    fields = [{c: st[i] for i, c in enumerate(("Hx", "Hy", "Hz"))}
              for st in stacks]
    for side in (-1, 1):
        a = stencil.ghost_buffers(mesh, stacks, side)
        b = stencil.ghost_buffers(mesh, stacks, side)
        stencil.exchange_stack(stacks, a, mesh, side)
        stencil.exchange_components(fields, ("Hx", "Hy", "Hz"), b, mesh,
                                    side)
        for ga, gb in zip(a, b):
            assert set(ga) == set(gb)
            for ax in ga:
                assert torch.equal(ga[ax], gb[ax])


# --------------------------------------------------------------------------
# checkpoints between a thin topology (full-length psi) and unsharded
# --------------------------------------------------------------------------

@pytest.mark.parametrize("first,second", [((1, 4, 1), None),
                                          (None, (1, 4, 1))])
def test_checkpoint_between_thin_and_unsharded_continues_bit_equal(
        first, second, tmp_path, monkeypatch):
    set_env(monkeypatch, ("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"))
    path = str(tmp_path / "ckpt.npz")

    def sim_on(topo, steps):
        cfg = to_port(cfg_of("x_221", topo, time_steps=steps,
                             output=OutputConfig(save_dir=str(tmp_path))))
        return TSim(cfg, device="cpu")

    whole = sim_on(None, 8)
    whole.run()
    a = sim_on(first, 8)
    a.advance(3)
    a.checkpoint(path)
    b = sim_on(second, 8)
    b.restore(path)
    assert b.t == 3
    b.advance(5)
    assert b.step_kind == "pallas3d_plain"
    for grp in ("E", "H"):
        for c in whole.state[grp]:
            np.testing.assert_array_equal(b.field(c), whole.field(c),
                                          err_msg=f"{grp}/{c}")
    got = convert.state_to_reference(b.state)
    want = convert.state_to_reference(whole.state)
    moved = tio.reshard_psi_tree(
        got, whole.static.grid_shape, b.topology,
        tsolver.slab_axes(b.static), (1, 1, 1),
        tsolver.slab_axes(whole.static))
    for grp in ("psi_E", "psi_H"):
        for k in want[grp]:
            np.testing.assert_array_equal(moved[grp][k], want[grp][k])


def test_thin_shard_psi_is_full_length_in_the_sharded_layout():
    sim = seeded_port("thin_y_142", (1, 4, 2), ())
    view = sim._shard_views()[0]
    assert tuple(view["psi_E"]["Ex_y"].shape) == (16, 4, 8)
    assert tuple(view["psi_E"]["Ex_z"].shape) == (16, 4, 6)
    glob = sim.state
    assert tuple(glob["psi_E"]["Ex_y"].shape) == (16, 16, 16)

"""The port's planner (``fdtd3d_torch/plan.py``), mirroring
tests/test_plan.py.

* ``plan`` equals, byte for byte, what a run of the port allocates on
  the CPU on each shard (its carry, its coefficients, the ghost buffers
  of the busiest shard and the packed-ds step's spare set after a
  step), unsharded and sharded, in f32, bf16, compensated mode, with
  magnetic Drude K, coefficient grids and TFSF, and float32x2 (its pair
  ghosts on a topology);
* the halo count per mode, the topology ladder (``degrade_topology``,
  ``fits_devices``, ``shrink_to_devices``) and the topology it plans
  for are the reference's;
* ``--dry-run`` runs on both CLIs without a device (config #5, and the
  float32x2 precision example on 4 devices), whatever log level an
  earlier test in the worker left either package at; config #5
  (``Examples/drude3D_nanoantenna.txt``, 1024^3) on 4 devices fits an
  80 GB card;
* a configuration ``Simulation`` refuses, ``plan`` refuses the same way.
"""

import os

import numpy as np
import pytest
import torch

from fdtd3d_torch import SimConfig, Simulation
from fdtd3d_torch import cli as tcli
from fdtd3d_torch import plan as tplan
from fdtd3d_torch.ops import packed_tb
from fdtd3d_torch.config import (MaterialsConfig, ParallelConfig, PmlConfig,
                                 PointSourceConfig, SphereConfig,
                                 TfsfConfig)
from fdtd3d_tpu import cli as rcli
from fdtd3d_tpu import plan as rplan
from fdtd3d_tpu.config import ParallelConfig as RPar
from fdtd3d_tpu.config import PmlConfig as RPml
from fdtd3d_tpu.config import SimConfig as RConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPHERES = MaterialsConfig(
    eps_sphere=SphereConfig(enabled=True, center=(16, 16, 16), radius=5,
                            value=3.0),
    use_drude=True, eps_inf=2.0, omega_p=2e11, gamma=1e10,
    drude_sphere=SphereConfig(enabled=True, center=(16, 16, 16), radius=3),
    use_drude_m=True, mu_inf=1.5, omega_pm=1e11, gamma_m=1e10,
    drude_m_sphere=SphereConfig(enabled=True, center=(16, 16, 16),
                                radius=3))
# the spheres without K: inside the temporal-blocked pass's scope
TB_SPHERES = MaterialsConfig(
    eps_sphere=SPHERES.eps_sphere, use_drude=True, eps_inf=2.0,
    omega_p=2e11, gamma=1e10, drude_sphere=SPHERES.drude_sphere)
CASES = {
    "f32_spheres": dict(materials=SPHERES),
    "f32_tb": dict(materials=TB_SPHERES),
    "bf16_tb": dict(dtype="bfloat16", materials=TB_SPHERES),
    "bf16": dict(dtype="bfloat16", materials=SPHERES),
    "compensated": dict(compensated=True),
    "float32x2": dict(dtype="float32x2"),
}


def _cfg(case, topo):
    """32^3 with TFSF and a point source; four shards along x take a
    thinner x PML (their local extent of 8 must exceed 2 (pml + 1))."""
    par = ParallelConfig(topology="manual", manual_topology=topo)
    pml = (2, 3, 3) if topo[0] == 4 else (3, 3, 3)
    return SimConfig(scheme="3D", size=(32, 32, 32), time_steps=2,
                     pml=PmlConfig(size=pml), use_pallas=True,
                     tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2)),
                     point_source=PointSourceConfig(
                         enabled=True, component="Ez",
                         position=(15, 16, 17)),
                     parallel=par, **CASES[case])


def _bytes(tree, seen):
    if isinstance(tree, dict):
        return sum(_bytes(v, seen) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v, seen) for v in tree)
    if isinstance(tree, torch.Tensor) and id(tree) not in seen:
        seen.add(id(tree))
        return tree.numel() * tree.element_size()
    return 0


@pytest.mark.parametrize("case,topo", [
    ("f32_spheres", (1, 1, 1)), ("f32_spheres", (2, 2, 2)),
    ("f32_spheres", (4, 1, 1)), ("bf16", (1, 2, 2)),
    ("compensated", (2, 1, 2)), ("float32x2", (1, 1, 1)),
    ("float32x2", (2, 2, 1)), ("float32x2", (4, 1, 2)),
    ("f32_tb", (1, 1, 1)), ("f32_tb", (2, 2, 1)), ("bf16_tb", (1, 2, 2))])
def test_plan_matches_actual_allocation(case, topo):
    cfg = _cfg(case, topo)
    sim = Simulation(cfg, device="cpu")
    sim.run(3)     # a tb run: a pass and its packed tail
    p = tplan.plan(cfg)
    tb = case.endswith("_tb")
    assert p.step_kind == ("packed_tb" if tb else "packed_ds"
                           if case == "float32x2" else "packed")
    assert sim.step_kind.startswith("packed_tb") == tb
    assert p.topology == topo and p.local_shape == tuple(
        32 // t for t in topo)
    shards = sim._carry["shards"] if sim.mesh else [sim._carry]
    coeffs = sim.coeffs if sim.mesh else [sim.coeffs]
    # the packed-ds and tb steps' spare set: a shard's pass buffers (and
    # the ds step's device's second line)
    spare = sim._runner.spare
    if spare is None:
        spares = [0] * len(shards)
    elif sim.mesh is not None:
        spares = [_bytes(sh, set()) + _bytes(spare.get("inc", {}), set())
                  for sh in spare["shards"]]
    else:
        spares = [_bytes(spare, set())]
    assert (p.spare_bytes > 0) == (case == "float32x2" or tb)
    # the sharded tb pass's ghost buffers of the coefficient grids, as
    # its prepare makes them
    frame = 0
    if tb and sim.mesh is not None:
        frame = max(_bytes(fc["_frame_ghosts"], set())
                    for fc in packed_tb.frame_coeffs(sim.static, sim.mesh,
                                                     sim.coeffs))
        assert frame > 0
    assert frame == p.frame_bytes
    for ps, cc, sp in zip(shards, coeffs, spares):
        assert sp == p.spare_bytes
        assert _bytes(ps, set()) + _bytes(cc, set()) == \
            p.hbm_per_chip - p.ghost_bytes - p.spare_bytes - p.frame_bytes
    ghosts = 0
    if sim.mesh is not None:
        g = sim._runner.ghosts
        deep = g.get("deep", {})
        ghosts = max(sum(_bytes(b, set()) for b in (g[-1][r], g[1][r]))
                     + sum(_bytes(bufs[r], set()) for bufs in deep.values())
                     for r in range(sim.mesh.n))
    assert ghosts == p.ghost_bytes


def test_halo_counts_and_ladder_equal_reference():
    mode = SimConfig(scheme="3D").mode
    rmode = RConfig(scheme="3D").mode
    for a in range(3):
        assert tplan._halo_planes(mode, a) == rplan._halo_planes(rmode, a)
    for topo in ((2, 2, 2), (4, 2, 1), (1, 1, 1), (3, 3, 1), (8, 1, 1)):
        assert tplan.degrade_topology(topo) == rplan.degrade_topology(topo)
        for n in (1, 2, 4, 8):
            assert tplan.fits_devices(topo, n) == rplan.fits_devices(topo,
                                                                      n)
            assert tplan.shrink_to_devices(topo, n) == \
                rplan.shrink_to_devices(topo, n)
    # an interior shard moves what the reference plans for a chip
    p = tplan.plan(_cfg("f32_spheres", (4, 1, 1)))
    rp = rplan.plan(RConfig(
        scheme="3D", size=(32, 32, 32), pml=RPml(size=(3, 3, 3)),
        parallel=RPar(topology="manual", manual_topology=(4, 1, 1))))
    assert p.halo_bytes_per_step == rp.halo_bytes_per_step
    assert p.topology == rp.topology


def test_plan_refuses_what_simulation_refuses():
    cfg = _cfg("f32_spheres", (8, 1, 1))  # a local x extent of 4
    with pytest.raises(NotImplementedError, match=r"A11\(b\)"):
        Simulation(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=r"A11\(b\)"):
        tplan.plan(cfg)


def _family_set(shard, fam):
    """Bytes of one family's fields, psi and ADE current in a shard's
    dict-form state: what the two-pass step's launch makes anew."""
    seen = set()
    return (_bytes(shard[fam], seen) + _bytes(shard[f"psi_{fam}"], seen)
            + _bytes(shard.get("J" if fam == "E" else "K", {}), seen))


@pytest.mark.parametrize("topo,env", [((1, 8, 1), ()),   # thin y
                                      ((2, 2, 1), ("FDTD3D_NO_PACKED",))])
def test_plan_of_the_sharded_two_pass_step(topo, env, monkeypatch):
    """A thin-y run and a ``FDTD3D_NO_PACKED`` run on (2,2,1): step kind
    ``pallas3d``, the carry, coefficients and ghosts as allocated, and
    the out-of-place family (the larger of a new E with its psi and J
    and a new H with its psi and K) counted as spare."""
    for k in ("FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED"):
        monkeypatch.delenv(k, raising=False)
    for k in env:
        monkeypatch.setenv(k, "1")
    cfg = _cfg("f32_spheres", topo)
    sim = Simulation(cfg, device="cpu")
    assert sim.step_kind == "pallas3d_plain"
    sim.run(1)
    p = tplan.plan(cfg)
    assert p.comm_strategy.step_kind == "pallas3d"
    assert "new E or H family" in p.report()
    for r, (sh, cc) in enumerate(zip(sim._carry["shards"], sim.coeffs)):
        assert p.spare_bytes == max(_family_set(sh, f) for f in "EH")
        assert _bytes(sh, set()) + _bytes(cc, set()) == \
            p.hbm_per_chip - p.ghost_bytes - p.spare_bytes
    g = sim._runner.ghosts
    assert p.ghost_bytes == max(
        sum(_bytes(b, set()) for b in (g[-1][r], g[1][r]))
        for r in range(sim.mesh.n))


def test_config5_on_four_devices_fits_an_80gb_card():
    argv = tcli.read_cmd_file(os.path.join(ROOT, "Examples",
                                           "drude3D_nanoantenna.txt"))
    cfg = tcli.args_to_config(tcli.build_parser().parse_args(
        argv + ["--num-devices", "4"]))
    p = tplan.plan(cfg, n_devices=4)
    assert int(np.prod(p.topology)) == 4
    assert p.hbm_per_chip < 80e9
    assert p.comm_strategy is not None and p.comm_strategy.source == "fixed"
    # the bytes a device holds fall with the shards (the 1D
    # coefficients and the line do not)
    one = tplan.plan_for_topology(cfg, (1, 1, 1))
    assert 3.9 * p.hbm_per_chip < one.hbm_per_chip < 4 * p.hbm_per_chip


@pytest.fixture
def log_level_one():
    """Both packages' process-global log levels pinned at 1 (the CLIs'
    ``--dry-run`` prints its plan through it without setting it; an
    earlier CLI run in the worker with ``--log-level 0`` leaves it
    silent), restored after."""
    from fdtd3d_torch import log as tlog
    from fdtd3d_tpu import log as rlog
    saved = (tlog._level, rlog.get_level())
    tlog.set_level(1)
    rlog.set_level(1)
    yield
    tlog.set_level(saved[0])
    rlog.set_level(saved[1])


def _dry_run_topologies(name, capsys, extra=()):
    """The ``topology (`` lines both CLIs' ``--dry-run --num-devices 4``
    print for an example, and the port's output."""
    argv = ["--cmd-from-file", os.path.join(ROOT, "Examples", name),
            "--dry-run", "--num-devices", "4", *extra]
    assert rcli.main(argv) == 0
    ref_out = capsys.readouterr().out
    assert tcli.main(argv) == 0
    port_out = capsys.readouterr().out
    return ([ln for ln in ref_out.splitlines() if "topology (" in ln],
            [ln for ln in port_out.splitlines() if "topology (" in ln],
            port_out)


def test_dry_run_float32x2_on_a_topology(capsys, log_level_one):
    """The float32x2 precision example plans on 4 devices on both CLIs
    (the sharded packed-ds step: pair ghosts, the spare set)."""
    ref, port, out = _dry_run_topologies("precision3D_float32x2.txt",
                                         capsys, ("--topology", "auto"))
    assert port and ref and port[0].split("(")[1] == ref[0].split("(")[1]
    assert "(1, 1, 1)" not in port[0]
    assert "ds spare set" in out and "packed_ds" in out


def test_dry_run_on_both_clis(capsys, log_level_one):
    argv = ["--cmd-from-file", os.path.join(ROOT, "Examples",
                                            "drude3D_nanoantenna.txt"),
            "--dry-run", "--num-devices", "4"]
    assert rcli.main(argv) == 0
    ref_out = capsys.readouterr().out
    assert tcli.main(argv) == 0
    port_out = capsys.readouterr().out
    topo = [ln for ln in port_out.splitlines() if "topology (" in ln]
    assert topo and topo[0].split("(")[1] == \
        [ln for ln in ref_out.splitlines()
         if "topology (" in ln][0].split("(")[1]
    assert "TOTAL per device" in port_out
    with pytest.raises(SystemExit, match="--num-devices"):
        tcli.main(argv[:3])

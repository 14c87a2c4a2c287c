"""The sharded packed-ds step (B4(c)) on the CPU, mirroring
tests/test_pallas_packed_ds.py::test_packed_ds_sharded_parity.

* The port's sharded float32x2 run (the plain versions of the sharded
  pass and the hi-edge H launch, ``devices=["cpu"] * n``) against its
  own unsharded packed-ds run, bit for bit on every leaf (hi and lo
  words, psi on the full axis, J, K, the incident line): the
  reference's ``_SHARD_KW`` case (16^3, pml 2, oblique TFSF 30/40/15, a
  point source at (5, 9, 7), 6 steps) on (2,1,1), (1,2,2) and (2,2,2),
  and J, K and coefficient-grid spheres across every shard edge on
  (2,2,1); through the CLI too (DAT dumps byte-equal).
* The (2,2,2) case against one run of the reference's sharded
  packed-ds step on its 8-device CPU mesh (interpret mode) at the ds
  gates (``torch_parity.assert_ds_state_close``): the reference adds
  the missing hi-edge term to the zero-ghost H, the port computes those
  cells again whole, so the two agree at the gates, not bit for bit.
* Each shard's record table is the global one with the planes shifted
  by the shard's offset, and the geometry of its record terms the
  global geometry of its columns; the point source is its owner's.
* Sharded health counters (hi words) against the unsharded run's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch_parity import assert_ds_state_close, np_state, to_port

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import convert
from fdtd3d_torch import io as tio
from fdtd3d_torch import solver as tsolver
from fdtd3d_torch import telemetry as ttel
from fdtd3d_torch.ops import packed, packed_ds
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu.config import (MaterialsConfig, ParallelConfig, PmlConfig,
                               PointSourceConfig, SimConfig, SphereConfig,
                               TfsfConfig)
from fdtd3d_tpu.ops import ds as rds
from fdtd3d_tpu.sim import Simulation as RSim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(scheme="3D", size=(16, 16, 16), time_steps=6, dx=1e-3,
            courant_factor=0.4, wavelength=8e-3, dtype="float32x2")
SHARD_KW = dict(pml=PmlConfig(size=(2, 2, 2)),
                tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2),
                                angle_teta=30.0, angle_phi=40.0,
                                angle_psi=15.0),
                point_source=PointSourceConfig(enabled=True, component="Ez",
                                               position=(5, 9, 7)))
OMEGA = 2.0 * np.pi * 3e8 / BASE["wavelength"]
# J, K and eps/mu spheres whose boxes cross every shard edge of (2,2,1)
GRIDS_KW = dict(SHARD_KW, materials=MaterialsConfig(
    eps=1.5, eps_sphere=SphereConfig(enabled=True, center=(8, 7, 8),
                                     radius=4, value=3.0),
    mu_sphere=SphereConfig(enabled=True, center=(7, 8, 8), radius=4,
                           value=2.0),
    use_drude=True, eps_inf=1.0, omega_p=0.05 * OMEGA, gamma=1e10,
    drude_sphere=SphereConfig(enabled=True, center=(8, 8, 8), radius=3),
    use_drude_m=True, mu_inf=1.5, omega_pm=0.05 * OMEGA, gamma_m=1e10,
    drude_m_sphere=SphereConfig(enabled=True, center=(8, 8, 7),
                                radius=3)))
CASES = {"shard_kw": SHARD_KW, "grids_jk": GRIDS_KW}


def ref_cfg(case, topo=None) -> SimConfig:
    par = ParallelConfig() if topo is None else ParallelConfig(
        topology="manual", manual_topology=topo)
    return SimConfig(**BASE, use_pallas=True, parallel=par, **CASES[case])


def seeded_state(sim, seed):
    """A dict-form state of ``sim``'s shapes with seeded f64 fields split
    into normalised (hi, lo) pairs, and seeded J and K (numpy)."""
    rng = np.random.RandomState(seed)
    st = convert.state_to_reference(sim.state)
    for grp in ("E", "H"):
        for c in st[grp]:
            st[grp][c], st["lo" + grp][c] = rds.from_f64(
                0.01 * rng.standard_normal(st[grp][c].shape))
    for grp in ("J", "K"):
        for c in st.get(grp, {}):
            st[grp][c] = (1e-4 * rng.standard_normal(st[grp][c].shape)
                          ).astype(np.float32)
    return st


def port_run(case, topo=None, seed=7):
    """The port's packed-ds run (sharded over ``topo`` on as many CPU
    shards) from the seeded state; -> (sim, final state in the
    reference's unpacked form with psi on the full axis)."""
    devices = None if topo is None else ["cpu"] * int(np.prod(topo))
    sim = TSim(to_port(ref_cfg(case, topo)), device="cpu", devices=devices)
    assert sim.step_kind == "packed_ds_plain", sim.step_kind
    one = TSim(to_port(ref_cfg(case)), device="cpu")
    sim.adopt_state(convert.state_from_reference(seeded_state(one, seed)),
                    src_topology=(1, 1, 1))
    sim.run()
    return sim, full_axis(sim)


def full_axis(sim):
    """The state (reference form, numpy) with psi expanded to the full
    axis from its topology's slab layout."""
    out = convert.state_to_reference(sim.state)
    return tio.reshard_psi_tree(out, sim.static.grid_shape, sim.topology,
                                tsolver.slab_axes(sim.static), (1, 1, 1), {})


def flat(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", np.asarray(v)


def assert_bit_equal(want, got):
    a, b = dict(flat(want)), dict(flat(got))
    assert set(a) == set(b)
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    assert not bad, f"differ: {bad}"


@pytest.fixture(scope="module")
def unsharded():
    return {case: port_run(case)[1] for case in CASES}


@pytest.mark.parametrize("case,topo", [
    ("shard_kw", (2, 1, 1)), ("shard_kw", (1, 2, 2)),
    ("shard_kw", (2, 2, 2)), ("grids_jk", (2, 2, 1))])
def test_sharded_ds_equals_unsharded_bit_for_bit(case, topo, unsharded):
    sim, got = port_run(case, topo)
    assert sim.mesh is not None and sim.topology == topo
    assert sim.step_diag["tb_fallback"]["reason"] == "ds_fields"
    assert sim.step_diag["topology"] == list(topo)
    assert_bit_equal(unsharded[case], got)


def test_hi_edge_launch_matters():
    """Without the hi-edge H launch the sharded run misses the unsharded
    one (the pass alone sees the zero ghost at a shard's hi edges)."""
    cfg = to_port(ref_cfg("shard_kw", (2, 2, 2)))
    sim = TSim(cfg, device="cpu", devices=["cpu"] * 8)
    step = packed_ds.make_sharded_packed_ds_step(sim.static, sim.mesh)
    cc = step.prepare(sim.coeffs)
    one = TSim(to_port(ref_cfg("shard_kw")), device="cpu")
    start = convert.state_from_reference(seeded_state(one, 3))
    sim.adopt_state(start, src_topology=(1, 1, 1))
    carry = step(sim._carry, cc)
    edge = [r for r in range(sim.mesh.n) if any(
        up for _, up in sim.mesh.open_sides(r))]
    assert len(edge) == 7
    # the pass alone, without the hi-edge launch, from the same carry
    sim2 = TSim(cfg, device="cpu", devices=["cpu"] * 8)
    sim2.adopt_state(start, src_topology=(1, 1, 1))
    lo = step.exchange(sim2._carry["shards"], -1)
    spare = [packed.alloc_like(s) for s in sim2._carry["shards"]]
    line = {}
    for r, sh in enumerate(sim2._carry["shards"]):
        if not line:      # the shards of the one CPU device share a line
            line = {k: torch.empty_like(v) for k, v in sh["inc"].items()}
            packed_ds.line_advance(sh["inc"], line, cc[r], step_pair(sim2))
        packed_ds.ds_pass_sharded(sh, spare[r], cc[r], sh["inc"], line,
                                  point_pair(sim2, cc[r]), lo[r])
    diff = [r for r in edge
            if not torch.equal(spare[r]["H"], carry["shards"][r]["H"])]
    assert diff == edge
    same = [r for r in range(8) if r not in edge]
    assert all(torch.equal(spare[r]["H"], carry["shards"][r]["H"])
               for r in same)


def step_pair(sim):
    from fdtd3d_torch.ops import tfsf
    st = sim.static
    return tfsf.line_source(st.tfsf_setup, st.omega, st.dt)(sim.t)


def point_pair(sim, cc):
    from fdtd3d_torch.ops.sources import DsSourceTable
    if not cc["has_point"]:
        return None
    ps = sim.static.cfg.point_source
    st = sim.static
    return DsSourceTable(ps.waveform, 0.5, st.omega, st.dt,
                         ps.amplitude)(sim.t)


@pytest.fixture(scope="module")
def reference_222():
    """One run of the reference's sharded packed-ds step (interpret
    mode, its 8-device CPU mesh) from the seeded state: (initial,
    final) in numpy."""
    ref = RSim(ref_cfg("shard_kw", (2, 2, 2)))
    assert ref.mesh is not None
    assert ref.step_kind == "pallas_packed_ds", ref.step_kind
    one = TSim(to_port(ref_cfg("shard_kw")), device="cpu")
    start = seeded_state(one, 7)
    slabs = tsolver.slab_axes(one.static)
    ref.state = tio.reshard_psi_tree(start, ref.static.grid_shape,
                                     (1, 1, 1), slabs, (2, 2, 2), slabs)
    init = np_state(ref)
    ref.run()
    return init, np_state(ref)


def test_sharded_ds_against_reference_sharded_run(reference_222):
    init, want = reference_222
    sim = TSim(to_port(ref_cfg("shard_kw", (2, 2, 2))), device="cpu",
               devices=["cpu"] * 8)
    sim.state = convert.state_from_reference(init)
    sim.run()
    assert_ds_state_close(want, convert.state_to_reference(sim.state))


def test_shard_records_are_the_global_table_shifted():
    cfg = to_port(ref_cfg("shard_kw", (2, 2, 2)))
    sim = TSim(cfg, device="cpu", devices=["cpu"] * 8)
    static, mesh = sim.static, sim.mesh
    one = TSim(to_port(ref_cfg("shard_kw")), device="cpu")
    glob = {f: packed_ds.family_records(one.static, f) for f in ("E", "H")}
    gplan = packed_ds.build_term_plan(one.static, one.coeffs, glob)
    owners = []
    n = mesh.local_shape
    for r in range(mesh.n):
        off = mesh.offset(r)
        recs = packed_ds.shard_records(static, mesh, r)
        local = tsolver.shard_static(static, mesh)
        plan = packed_ds.build_term_plan(local, sim.coeffs[r], recs)
        for fam in ("E", "H"):
            want = [g._replace(plane=g.plane - off[g.axis])
                    for g in glob[fam]
                    if 0 <= g.plane - off[g.axis] < n[g.axis]
                    and (g.corr is not None
                         or mesh.owner((5, 9, 7))[0] == r)]
            assert recs[fam] == want
            owners += [r for rec in recs[fam] if rec.corr is None]
            # each record's geometry is the global record's on the
            # shard's columns
            for i, rec in enumerate(recs[fam]):
                if rec.corr is None:
                    continue
                g = glob[fam].index(rec._replace(plane=rec.plane
                                                 + off[rec.axis]))
                gshape = list(one.static.grid_shape)
                gshape[rec.axis] = 1
                lshape = list(n)
                lshape[rec.axis] = 1
                sl = tuple(slice(0, 1) if b == rec.axis
                           else slice(off[b], off[b] + n[b])
                           for b in range(3))
                for name, gv, lv in (("i0", gplan.i0, plan.i0),
                                     ("w", gplan.w[0], plan.w[0]),
                                     ("w_lo", gplan.w[1], plan.w[1]),
                                     ("gate", gplan.gate, plan.gate)):
                    size_g, size_l = int(np.prod(gshape)), int(np.prod(lshape))
                    a = gv[gplan.offsets[(fam, g)]:][:size_g] \
                        .reshape(gshape)[sl]
                    b = lv[plan.offsets[(fam, i)]:][:size_l].reshape(lshape)
                    assert torch.equal(a, b), (r, fam, i, name)
    assert owners == [mesh.owner((5, 9, 7))[0]]


def test_sharded_ds_cli_dumps_equal_unsharded(tmp_path):
    base = ["--cmd-from-file",
            os.path.join(ROOT, "Examples", "precision3D_float32x2.txt"),
            "--same-size", "32", "--time-steps", "8", "--pml-size", "3",
            "--tfsf-margin", "3", "--device", "cpu", "--use-pallas", "on",
            "--save-res", "8", "--check-finite"]
    for name, extra in (("one", []), ("four", ["--manual-topology",
                                               "2x2x1"])):
        assert tcli.main(base + extra + ["--save-dir",
                                          str(tmp_path / name)]) == 0
    files = sorted(os.listdir(tmp_path / "one"))
    assert any(f.endswith(".dat") for f in files)
    for f in files:
        if f.endswith(".dat"):
            assert (tmp_path / "one" / f).read_bytes() == \
                (tmp_path / "four" / f).read_bytes(), f


def test_sharded_ds_health_counters_equal_unsharded():
    """The health pass of a sharded float32x2 run (the hi words, as the
    reference counts them) against the unsharded run's on the same
    fields: the maxima equal, the energy to its summation order."""
    cfg = to_port(ref_cfg("shard_kw", (2, 2, 1)))
    cfg = dataclasses.replace(cfg, output=dataclasses.replace(
        cfg.output, check_finite=True))
    sim = TSim(cfg, device="cpu", devices=["cpu"] * 4)
    one = TSim(dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, topology="none", manual_topology=None)), device="cpu")
    assert one.mesh is None and sim.mesh is not None
    start = convert.state_from_reference(seeded_state(one, 5))
    reads = []
    for s in (one, sim):
        s.adopt_state(start, src_topology=(1, 1, 1))
        _, health = s._runner(s._carry, s.coeffs, 3)
        reads.append(ttel.readback(health))
    a, b = reads
    assert a["finite"] and b["finite"]
    assert a["max_e"] == b["max_e"] and a["max_h"] == b["max_h"]
    assert abs(a["energy"] - b["energy"]) <= 1e-6 * a["energy"]

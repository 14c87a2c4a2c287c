"""The port's domain decomposition (A11(a)) against the reference's on
its 8-device virtual CPU mesh, mirroring tests/test_parallel.py.

* ``choose_topology`` and ``resolve_topology`` give the reference's
  answers, refusals included;
* a seeded run with oblique TFSF, a point source, an eps sphere and a
  Drude sphere (J) on (2,1,1), (1,2,1), (1,1,2), (2,2,1) and (2,2,2)
  (eight shards on the CPU) matches the reference's sharded run (its jnp
  step under the mesh, the run in its sharded layout: psi 2 m p planes
  along its axis) leaf for leaf at 2e-6 of the family max (E, H, psi, J
  and the incident line), and the port's unsharded packed run
  (``FDTD3D_NO_TEMPORAL``) bit for bit once its psi is moved onto the
  unsharded layout;
* the shard layout: split and join are inverse, the slab profile rows
  of an interior shard are identity, ghost exchange fills exactly the
  neighbour's plane.
Reference runs are cached per module.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import (BASE, assert_state_close, np_state,
                          seed_reference, to_port)

from fdtd3d_torch import convert
from fdtd3d_torch import io as tio
from fdtd3d_torch import solver as tsolver
from fdtd3d_torch.parallel import mesh as tmesh
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu.config import (MaterialsConfig, ParallelConfig, PmlConfig,
                               PointSourceConfig, SimConfig, SphereConfig,
                               TfsfConfig)
from fdtd3d_tpu.parallel import mesh as rmesh
from fdtd3d_tpu.sim import Simulation as RSim

TOL = 2e-6
TOPOLOGIES = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1), (2, 2, 2)]
N = 24
STEPS = 6


def full_cfg(topo=None, **kw) -> SimConfig:
    """The full physics stack of tests/test_parallel.py at 24^3 (16^3
    leaves a shard too thin for slab psi), with a point source and an
    eps sphere whose box crosses every shard edge."""
    par = ParallelConfig() if topo is None else ParallelConfig(
        topology="manual", manual_topology=topo)
    base = dict(
        pml=PmlConfig(size=(3, 3, 3)),
        tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2), angle_teta=30.0,
                        angle_phi=40.0, angle_psi=15.0),
        point_source=PointSourceConfig(enabled=True, component="Ez",
                                       position=(11, 13, 12)),
        materials=MaterialsConfig(
            eps=1.5, eps_sphere=SphereConfig(enabled=True,
                                             center=(12, 11, 12),
                                             radius=5, value=3.0),
            use_drude=True, eps_inf=2.0, omega_p=2e11, gamma=1e10,
            drude_sphere=SphereConfig(enabled=True, center=(12, 12, 12),
                                      radius=3)),
        parallel=par, use_pallas=False)
    base.update(kw)
    return SimConfig(**dict(BASE, size=(N, N, N), time_steps=STEPS),
                     **base)


def seeded_pair(topo, **kw):
    """(reference sim, port sim) of ``topo`` from the same seeded
    fields, not stepped."""
    ref = RSim(full_cfg(topo, **kw))
    seed_reference(ref, 0)
    port = TSim(dataclasses.replace(to_port(full_cfg(topo, **kw)),
                                    use_pallas=None), device="cpu")
    port.adopt_state(convert.state_from_reference(np_state(ref)))
    return ref, port


@pytest.fixture(scope="module")
def unsharded_packed():
    """The port's unsharded packed run (``FDTD3D_NO_TEMPORAL``) from the
    same seeded fields, numpy."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FDTD3D_NO_TEMPORAL", "1")
    try:
        ref = RSim(full_cfg())
        seed_reference(ref, 0)
        port = TSim(dataclasses.replace(to_port(full_cfg()),
                                        use_pallas=True), device="cpu")
        assert port.step_kind == "packed_plain"
        port.state = convert.state_from_reference(np_state(ref))
        port.advance(STEPS)
        return convert.state_to_reference(port.state), port.static
    finally:
        mp.undo()


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_sharded_matches_reference_and_unsharded(topo, unsharded_packed,
                                                 monkeypatch):
    # the sharded packed step (the sharded tb pass has its own tests,
    # tests/test_torch_sharded_tb.py)
    monkeypatch.setenv("FDTD3D_NO_TEMPORAL", "1")
    ref, port = seeded_pair(topo)
    assert port.mesh is not None and port.step_kind == "packed_plain"
    assert port.step_diag["tb_fallback"]["reason"] == \
        "env:FDTD3D_NO_TEMPORAL"
    assert ref.mesh is not None and ref.step_kind == "jnp"
    ref.advance(STEPS)
    port.advance(STEPS)
    got = convert.state_to_reference(port.state)
    # against the reference's sharded run, in the sharded layout
    assert_state_close(np_state(ref), got, TOL)
    # against the port's unsharded packed run, bit for bit
    want, ustatic = unsharded_packed
    moved = tio.reshard_psi_tree(got, ustatic.grid_shape, topo,
                                 tsolver.slab_axes(port.static), (1, 1, 1),
                                 tsolver.slab_axes(ustatic))
    for grp in want:
        if isinstance(want[grp], dict):
            for k in want[grp]:
                np.testing.assert_array_equal(moved[grp][k], want[grp][k],
                                              err_msg=f"{grp}/{k} {topo}")
    assert int(moved["t"]) == int(want["t"]) == STEPS


@pytest.mark.parametrize("n,shape,axes", [
    (8, (64, 64, 64), (0, 1, 2)), (4, (256, 16, 16), (0, 1, 2)),
    (4, (64, 64, 1), (0, 1)), (6, (60, 64, 64), (0, 1, 2)),
    (2, (33, 64, 64), (0, 1, 2)), (3, (64, 64, 64), (0, 1, 2))])
def test_choose_topology_equals_reference(n, shape, axes):
    try:
        want = rmesh.choose_topology(n, shape, axes)
    except ValueError:
        with pytest.raises(ValueError):
            tmesh.choose_topology(n, shape, axes)
        return
    assert tmesh.choose_topology(n, shape, axes) == want


@pytest.mark.parametrize("par", [
    ParallelConfig(), ParallelConfig(topology="auto", n_devices=8),
    ParallelConfig(topology="manual", manual_topology=(2, 2, 2)),
    ParallelConfig(topology="manual", manual_topology=(3, 1, 1)),
    ParallelConfig(topology="manual", manual_topology=(1, 1, 2)),
    ParallelConfig(topology="bogus")])
def test_resolve_topology_equals_reference(par):
    shape, axes = (24, 24, 24), (0, 1, 2)
    try:
        want = rmesh.resolve_topology(par, shape, axes, n_devices=8)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc).split(" ")[0]):
            tmesh.resolve_topology(to_port(par), shape, axes, n_devices=8)
        return
    assert tmesh.resolve_topology(to_port(par), shape, axes,
                                  n_devices=8) == want


def test_auto_topology_takes_the_cpu_shards():
    """"auto" with a count of 8 (the configuration's, or a device list
    of 8) takes the reference's topology over the CPU shards; without a
    count it stays unsharded on the CPU."""
    cfg = to_port(full_cfg())
    auto = dataclasses.replace(cfg, use_pallas=None, parallel=dataclasses.
                               replace(cfg.parallel, topology="auto"))
    want = rmesh.choose_topology(8, (N, N, N), (0, 1, 2))
    counted = dataclasses.replace(auto, parallel=dataclasses.replace(
        auto.parallel, n_devices=8))
    for sim in (TSim(counted, device="cpu"),
                TSim(auto, devices=["cpu"] * tmesh.CPU_SHARDS)):
        assert sim.mesh is not None and sim.mesh.n == tmesh.CPU_SHARDS
        assert sim.topology == want
        sim.run(2)
        assert sim.t == 2
    assert TSim(auto, device="cpu").mesh is None


def test_split_and_join_are_inverse():
    static = tsolver.build_static(to_port(full_cfg((2, 2, 2),
                                                   use_pallas=None)))
    mesh = tmesh.ShardMesh((2, 2, 2), static.grid_shape, ["cpu"] * 8)
    coeffs = tsolver.build_coeffs(static)
    pieces = mesh.split(coeffs, coeff=True)
    back = mesh.join(pieces, coeff=True)
    for k, v in coeffs.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v))
    # an interior edge's slab rows are identity: psi stays exactly 0
    m = tsolver.slab_axes(static)[0]
    rows = pieces[0]["pml_slab_be_x"]
    assert rows.shape == (2 * m,)
    np.testing.assert_array_equal(rows[m:], 0.0)
    np.testing.assert_array_equal(pieces[0]["pml_slab_ike_x"][m:], 1.0)
    np.testing.assert_array_equal(pieces[0]["gx"], np.arange(N // 2))
    np.testing.assert_array_equal(pieces[7]["gz"], N // 2 + np.arange(N // 2))
    assert float(pieces[0]["wall_x"][-1]) == 1.0 \
        and float(pieces[0]["wall_x"][0]) == 0.0
    state = tsolver.init_state(static, "cpu")
    g = torch.Generator().manual_seed(1)
    for grp in ("E", "H", "psi_E", "J"):
        for v in state[grp].values():
            v.copy_(torch.randn(v.shape, generator=g))
    joined = mesh.join(mesh.split(state))
    for grp in ("E", "H", "psi_E", "J"):
        for k, v in state[grp].items():
            assert torch.equal(joined[grp][k], v)


@pytest.mark.parametrize("side", [-1, 1])
def test_exchange_fills_the_neighbours_plane(side):
    from fdtd3d_torch.ops.stencil import exchange_stack, ghost_buffers
    mesh = tmesh.ShardMesh((2, 2, 2), (8, 6, 4), ["cpu"] * 8)
    g = torch.Generator().manual_seed(2)
    stacks = [torch.randn((3,) + mesh.local_shape, generator=g)
              for _ in range(mesh.n)]
    bufs = ghost_buffers(mesh, stacks, side)
    exchange_stack(stacks, bufs, mesh, side)
    for r, b in enumerate(bufs):
        for a in range(3):
            nb = mesh.neighbor(r, a, side)
            assert (a in b) == (nb is not None)
            if nb is None:
                continue
            n = mesh.local_shape[a]
            plane = stacks[nb].select(1 + a, n - 1 if side < 0 else 0)
            for c in range(3):
                if c == a:
                    assert not b[a][c].any()
                else:
                    assert torch.equal(b[a][c], plane[c])


def test_sharded_run_imports_no_reference():
    """A sharded run, its plan and its checkpoint pull in neither jax
    nor the reference package (a subprocess: this one imports jax)."""
    import os
    import subprocess
    import sys
    child = (
        "import sys\n"
        "from fdtd3d_torch import SimConfig, Simulation, plan\n"
        "from fdtd3d_torch.config import ParallelConfig, PmlConfig\n"
        "cfg = SimConfig(scheme='3D', size=(24, 24, 24), time_steps=2,\n"
        "                pml=PmlConfig(size=(3, 3, 3)),\n"
        "                parallel=ParallelConfig(topology='manual',\n"
        "                                        manual_topology=(2, 2, 1)))\n"
        "sim = Simulation(cfg, device='cpu').run()\n"
        "plan.plan(cfg)\n"
        "sim.checkpoint(sys.argv[1])\n"
        "bad = [m for m in sys.modules if m == 'jax' or\n"
        "       m.startswith(('jax.', 'fdtd3d_tpu', 'ml_dtypes'))]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run([sys.executable, "-c", child,
                              os.path.join(d, "ck.npz")], cwd=root,
                             env=env, capture_output=True, text=True,
                             timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_sharded_coefficients_equal_the_references():
    """``build_coeffs`` of a sharded static is the reference's, key for
    key and bit for bit (the slab profiles ``2 m p`` long), and each
    shard's piece is what the reference's spec rules give a device."""
    from fdtd3d_tpu import solver as rsolver
    topo = (2, 1, 2)
    rcfg = full_cfg(topo)
    rst = dataclasses.replace(rsolver.build_static(rcfg), topology=topo)
    want = rsolver.build_coeffs(rst)
    st = tsolver.build_static(to_port(full_cfg(topo, use_pallas=None)))
    got = tsolver.build_coeffs(st)
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)
    mesh = tmesh.ShardMesh(topo, st.grid_shape, ["cpu"] * 4)
    spec = rmesh.coeff_specs(want, topo)
    for r, piece in enumerate(mesh.split(got, coeff=True)):
        for k, v in want.items():
            idx = []
            for d, name in enumerate(spec[k]):
                if name is None:
                    idx.append(slice(None))
                    continue
                a = "xyz".index(name)
                size = np.shape(v)[d] // topo[a]
                c = mesh.coords[r][a]
                idx.append(slice(c * size, (c + 1) * size))
            np.testing.assert_array_equal(
                np.asarray(piece[k]), np.asarray(v)[tuple(idx)]
                if idx else np.asarray(v), err_msg=f"{k} shard {r}")


def test_cli_dumps_byte_equal_to_the_unsharded_run(tmp_path, monkeypatch):
    """DAT, TXT and BMP dumps of a (2,2,1) run through the CLI, byte for
    byte those of the unsharded packed run."""
    import os

    from fdtd3d_torch import cli as tcli
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["--cmd-from-file", os.path.join(root, "Examples",
                                            "vacuum3D_tfsf.txt"),
            "--same-size", "24", "--time-steps", "12", "--pml-size", "3",
            "--tfsf-margin", "2", "--device", "cpu", "--use-pallas", "on",
            "--save-res", "12", "--save-formats", "dat,txt,bmp",
            "--log-level", "0"]
    monkeypatch.setenv("FDTD3D_NO_TEMPORAL", "1")
    assert tcli.main(argv + ["--save-dir", str(tmp_path / "one")]) == 0
    assert tcli.main(argv + ["--save-dir", str(tmp_path / "sh"),
                             "--manual-topology", "2x2x1"]) == 0
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "sh")) and len(names) > 6
    for n in names:
        assert (tmp_path / "one" / n).read_bytes() == \
            (tmp_path / "sh" / n).read_bytes(), n

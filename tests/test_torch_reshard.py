"""Reshard on resume in the port, against the reference, mirroring
tests/test_reshard.py.

* ``io.psi_slab_expand``/``psi_slab_compact``/``reshard_psi_tree`` are
  the reference's, exactly: the same arrays out, the same refusals;
* a run checkpointed on (2,2,2) and resumed on (1,2,2), (2,1,1) and
  unsharded finishes bit-identical to the uninterrupted run (the packed
  steps; ``FDTD3D_NO_TEMPORAL`` so the unsharded run is the packed
  step, whose cells the sharded one reproduces bit for bit), through
  ``Simulation`` and through the CLI killed and resumed;
* each package restores the other's sharded npz onto another topology,
  leaf for leaf what the other package restores;
* a float32x2 snapshot written on (2,2,1) (the sharded packed-ds
  step, lo words and ``lopsi_*`` in the reference's sharded layout)
  restores unsharded and on (1,2,2) leaf for leaf as the reference
  restores it, and the resumed run finishes bit-identical to the
  uninterrupted one;
* the metadata records the layout; a forged layout is refused; a
  topology that needs more devices than there are is a named
  SystemExit.
"""

import dataclasses
import os

import numpy as np
import pytest
from torch_parity import to_port

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import convert
from fdtd3d_torch import faults as tfaults
from fdtd3d_torch import io as tio
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu import faults as rfaults
from fdtd3d_tpu import io as rio
from fdtd3d_tpu.config import (OutputConfig, ParallelConfig, PmlConfig,
                               PointSourceConfig, SimConfig)
from fdtd3d_tpu.sim import Simulation as RSim


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("FDTD3D_FAULT_PLAN", raising=False)
    monkeypatch.setenv("FDTD3D_NO_TEMPORAL", "1")
    tfaults.clear()
    rfaults.clear()
    yield
    tfaults.clear()
    rfaults.clear()


def _cfg3d(topo=None, steps=16, save_dir=None, every=0) -> SimConfig:
    par = ParallelConfig() if topo is None else ParallelConfig(
        topology="manual", manual_topology=topo)
    out = OutputConfig() if save_dir is None else OutputConfig(
        save_dir=str(save_dir), checkpoint_every=every)
    return SimConfig(
        scheme="3D", size=(24, 24, 24), time_steps=steps, dx=1e-3,
        courant_factor=0.4, wavelength=8e-3, pml=PmlConfig(size=(3, 3, 3)),
        point_source=PointSourceConfig(enabled=True, component="Ez",
                                       position=(12, 12, 12)),
        parallel=par, output=out)


def _port(topo=None, steps=16):
    return TSim(dataclasses.replace(to_port(_cfg3d(topo, steps)),
                                    use_pallas=True), device="cpu")


def _port_ds(topo=None, steps=16):
    return TSim(dataclasses.replace(to_port(_cfg3d(topo, steps)),
                                    use_pallas=True, dtype="float32x2"),
                device="cpu")


def _full_psi(sim):
    """A port sim's state (the reference's form) with psi expanded to
    the full axis from its topology's layout."""
    from fdtd3d_torch.solver import slab_axes
    return tio.reshard_psi_tree(convert.state_to_reference(sim.state),
                                sim.static.grid_shape, sim.topology,
                                slab_axes(sim.static), (1, 1, 1), {})


def _assert_trees_equal(want, got, what):
    assert set(want) == set(got), what
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_trees_equal(v, got[k], f"{what}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=f"{what}/{k}")


@pytest.mark.parametrize("dst_topo", [None, (1, 2, 2)])
def test_float32x2_checkpoint_crosses_topology_bit_exact(tmp_path,
                                                         dst_topo):
    ck = str(tmp_path / "ck.npz")
    a = _port_ds((2, 2, 1))
    assert a.step_kind == "packed_ds_plain" and a.mesh is not None
    a.advance(8)
    a.checkpoint(ck)
    a.advance(8)
    b = _port_ds(dst_topo)
    b.restore(ck)
    assert b.t == 8
    ref = RSim(dataclasses.replace(_cfg3d(dst_topo), dtype="float32x2",
                                   use_pallas=True))
    ref.restore(ck)
    _assert_trees_equal(_np_state(ref), convert.state_to_reference(b.state),
                        f"restored on {dst_topo}")
    b.advance(8)
    _assert_trees_equal(_full_psi(a), _full_psi(b), f"on {dst_topo}")


def _slab_like(n=24, m=4, other=(6, 5)):
    rng = np.random.default_rng(0)
    full = np.zeros((n,) + other, np.float32)
    full[:m] = rng.standard_normal((m,) + other)
    full[n - m:] = rng.standard_normal((m,) + other)
    return full


@pytest.mark.parametrize("p", [1, 2, 3])
def test_psi_expand_compact_equal_reference_and_roundtrip(p):
    full = _slab_like()
    for m in (4, None):
        got = tio.psi_slab_compact(full, 0, p, m)
        np.testing.assert_array_equal(got, rio.psi_slab_compact(full, 0,
                                                                p, m))
        back = tio.psi_slab_expand(got, 0, 24, p, m)
        np.testing.assert_array_equal(back, rio.psi_slab_expand(got, 0,
                                                                24, p, m))
        np.testing.assert_array_equal(back, full)


def test_psi_refusals_equal_reference():
    full = _slab_like()
    for mod in (tio, rio):
        with pytest.raises(ValueError, match="disagree"):
            mod.psi_slab_expand(np.zeros((7, 6, 5)), 0, 24, 2, 4)
        with pytest.raises(ValueError, match="lossy"):
            mod.psi_slab_compact(full, 0, 2, 2)
        with pytest.raises(ValueError, match="divide"):
            mod.reshard_psi_tree({"t": 0}, (24, 24, 24), (5, 1, 1), {},
                                 (1, 1, 1), {})


@pytest.mark.parametrize("dst_topo", [(1, 2, 2), None, (2, 1, 1)])
def test_checkpoint_crosses_topology_bit_exact(tmp_path, dst_topo):
    ck = str(tmp_path / "ck.npz")
    a = _port((2, 2, 2))
    a.advance(8)
    a.checkpoint(ck)
    a.advance(8)
    b = _port(dst_topo)
    b.restore(ck)
    assert b.t == 8
    b.advance(8)
    want, got = a.fields(), b.fields()
    for comp, v in want.items():
        np.testing.assert_array_equal(got[comp], v,
                                      err_msg=f"{comp} on {dst_topo}")


def test_ckpt_meta_records_layout_and_forgery_is_refused(tmp_path):
    ck = str(tmp_path / "ck.npz")
    _port((2, 2, 2), 0).checkpoint(ck)
    meta = tio.read_checkpoint_meta(ck)
    assert meta["topology"] == [2, 2, 2]
    assert meta["psi_slabs"] == {"x": 4, "y": 4, "z": 4}
    state, extra = tio.load_checkpoint(ck)
    assert state["psi_E"]["Ey_x"].shape == (16, 24, 24)
    extra["psi_slabs"] = {"x": 2, "y": 4, "z": 4}
    forged = str(tmp_path / "forged.npz")
    tio.save_checkpoint(state, forged, extra=extra)
    with pytest.raises(tio.CheckpointCorrupt, match="slab layout"):
        _port(None, 0).restore(forged)


def _np_state(sim):
    import jax
    return jax.tree.map(np.asarray, sim.state)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_each_package_restores_the_others_sharded_npz(tmp_path, writer):
    ck = str(tmp_path / "ck.npz")
    if writer == "ref":
        src = RSim(_cfg3d((2, 2, 2)))
        src.advance(6)
    else:
        src = _port((2, 2, 2))
        src.advance(6)
    src.checkpoint(ck)
    for topo in ((1, 2, 2), None):
        ref = RSim(_cfg3d(topo))
        ref.restore(ck)
        port = _port(topo)
        port.restore(ck)
        want = _np_state(ref)
        got = convert.state_to_reference(port.state)
        assert set(want) == set(got)
        for grp, leaves in want.items():
            if not isinstance(leaves, dict):
                assert int(got[grp]) == int(leaves) == 6
                continue
            for k, v in leaves.items():
                np.testing.assert_array_equal(got[grp][k], v,
                                              err_msg=f"{grp}/{k} {topo}")


def _cli_argv(save_dir, topo="2x2x2", steps=24):
    argv = ["--3d", "--same-size", "24", "--time-steps", str(steps),
            "--pml-size", "3", "--use-pml", "--point-source", "Ez",
            "--courant-factor", "0.4", "--wavelength", "0.008",
            "--checkpoint-every", "8", "--save-dir", str(save_dir),
            "--log-level", "0", "--device", "cpu", "--use-pallas", "on"]
    if topo is not None:
        argv += ["--manual-topology", topo]
    return argv


def _expand(arr, key, extra):
    ax = "xyz".index(key.rsplit("_", 1)[1])
    m = (extra.get("psi_slabs") or {}).get("xyz"[ax])
    return tio.psi_slab_expand(np.asarray(arr), ax, 24,
                               extra["topology"][ax],
                               int(m) if m is not None else None)


def test_cli_resume_across_topologies_bit_identical(tmp_path, monkeypatch):
    d_ref = tmp_path / "ref"
    assert tcli.main(_cli_argv(d_ref)) == 0
    ref, ref_extra = tio.load_checkpoint(
        os.path.join(str(d_ref), "ckpt_t000024.npz"))
    assert ref_extra["topology"] == [2, 2, 2]
    for tag, topo in (("shrunk", "1x2x2"), ("unsharded", None)):
        d = tmp_path / tag
        monkeypatch.setenv("FDTD3D_FAULT_PLAN", "preempt@t=16")
        with pytest.raises(tfaults.SimulatedPreemption):
            tcli.main(_cli_argv(d))
        monkeypatch.delenv("FDTD3D_FAULT_PLAN")
        tfaults.clear()
        assert tcli.main(_cli_argv(d, topo=topo)
                         + ["--resume", "auto"]) == 0, tag
        got, extra = tio.load_checkpoint(
            os.path.join(str(d), "ckpt_t000024.npz"))
        assert extra["topology"] == ([1, 2, 2] if topo else [1, 1, 1])
        for grp in ("E", "H"):
            for comp, v in ref[grp].items():
                np.testing.assert_array_equal(got[grp][comp], v,
                                              err_msg=f"{tag} {comp}")
        for grp in ("psi_E", "psi_H"):
            for key, v in ref[grp].items():
                np.testing.assert_array_equal(
                    _expand(got[grp][key], key, extra),
                    _expand(v, key, ref_extra), err_msg=f"{tag} {key}")


def test_resume_oversized_topology_is_friendly_systemexit(tmp_path):
    assert tcli.main(_cli_argv(tmp_path, steps=8)) == 0
    ck = os.path.join(str(tmp_path), "ckpt_t000008.npz")
    with pytest.raises(SystemExit,
                       match=r"needs 64 devices.*topology-portable"):
        tcli.main(_cli_argv(tmp_path, topo="4x4x4", steps=8)
                  + ["--resume", ck])
    with pytest.raises(SystemExit, match="invalid decomposition"):
        tcli.main(_cli_argv(tmp_path, topo="5x1x1", steps=8)
                  + ["--resume", ck])

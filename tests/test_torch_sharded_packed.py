"""The sharded packed step (B1(e)) against the reference on its 8-device
virtual CPU mesh, mirroring tests/test_pallas_sharded.py and
tests/test_packed_sourced_sharded.py.

* sources, Drude J, coefficient grids whose boxes cross shard edges,
  magnetic Drude K and compensated mode (where the reference's sharded
  packed kernel takes them, tests/test_packed_sourced_sharded.py:149,
  :178), and bf16 storage: the port's sharded run against the
  reference's sharded jnp run from the same seeded fields, every leaf
  at 2e-6 of its family max (bf16 2e-2), and against the port's own
  unsharded packed run bit for bit;
* the health counters of a sharded run (local partials finished by sum
  and max over the shards; div·E over each shard's interior) and its
  ``per_chip`` vectors against the reference's under its mesh, through
  both packages' telemetry files (1e-6 on maxima, 1e-5 on sums);
* what the slice does not run refuses, naming its ROADMAP.md item: a
  shard too thin for slab psi on x (float32x2's on any axis), 2D
  modes, float64, the plain step, ``--ntff``, batches and supervised
  runs (A11(b)); complex fields on the paired route raise the
  reference's ValueError. A source inside the absorber and the ladder
  below packed leave the sharded packed step for the sharded two-pass
  step (``pallas3d_plain`` here; tests/test_torch_sharded_family.py
  holds its numbers), as the reference's dispatch leaves its packed
  kernel for its two-pass kernels.
"""

import dataclasses
import json

import numpy as np
import pytest
from torch_parity import (BASE, assert_state_close, np_state,
                          seed_reference, to_port)

from fdtd3d_torch import SimConfig as TConfig
from fdtd3d_torch import convert
from fdtd3d_torch import io as tio
from fdtd3d_torch import solver as tsolver
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu.config import (MaterialsConfig, OutputConfig,
                               ParallelConfig, PmlConfig, PointSourceConfig,
                               SimConfig, SphereConfig, TfsfConfig)
from fdtd3d_tpu.sim import Simulation as RSim

TOL = 2e-6
BF16_TOL = 2e-2
N = 24
STEPS = 5
K_MAT = dict(use_drude_m=True, mu_inf=1.5, omega_pm=1e11, gamma_m=1e10,
             drude_m_sphere=SphereConfig(enabled=True, center=(12, 12, 12),
                                         radius=4))

CASES = {
    # eps and mu spheres whose boxes cross every shard edge, Drude J
    "grids_j": dict(materials=MaterialsConfig(
        eps=1.5, eps_sphere=SphereConfig(enabled=True, center=(12, 11, 12),
                                         radius=6, value=3.0),
        mu_sphere=SphereConfig(enabled=True, center=(11, 12, 13),
                               radius=5, value=2.0),
        use_drude=True, eps_inf=2.0, omega_p=2e11, gamma=1e10,
        drude_sphere=SphereConfig(enabled=True, center=(12, 12, 12),
                                  radius=3))),
    "k": dict(materials=MaterialsConfig(**K_MAT)),
    "compensated": dict(compensated=True),
    "bf16": dict(dtype="bfloat16", materials=MaterialsConfig(**K_MAT)),
}


def cfg_of(case, topo=None, **kw) -> SimConfig:
    par = ParallelConfig() if topo is None else ParallelConfig(
        topology="manual", manual_topology=topo)
    base = dict(pml=PmlConfig(size=(3, 3, 3)),
                tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2),
                                angle_teta=20.0, angle_phi=30.0),
                point_source=PointSourceConfig(enabled=True,
                                               component="Ey",
                                               position=(12, 11, 13)),
                parallel=par, use_pallas=False)
    base.update(CASES.get(case, {}))
    base.update(kw)
    return SimConfig(**dict(BASE, size=(N, N, N), time_steps=STEPS),
                     **base)


def port_cfg(cfg) -> TConfig:
    """The port's configuration of a reference one, with the packed
    step wanted (a sharded run takes no other)."""
    return dataclasses.replace(to_port(cfg), use_pallas=True)


_UNSHARDED = {}


def unsharded(case):
    """The port's unsharded packed run of ``case`` from the seeded
    fields (numpy, and its static), cached per case."""
    if case not in _UNSHARDED:
        mp = pytest.MonkeyPatch()
        mp.setenv("FDTD3D_NO_TEMPORAL", "1")
        try:
            ref = RSim(cfg_of(case))
            seed_reference(ref, 3)
            port = TSim(port_cfg(cfg_of(case)), device="cpu")
            assert port.step_kind == "packed_plain", port.step_kind
            port.state = convert.state_from_reference(np_state(ref))
            port.advance(STEPS)
            _UNSHARDED[case] = (convert.state_to_reference(port.state),
                                port.static)
        finally:
            mp.undo()
    return _UNSHARDED[case]


@pytest.mark.parametrize("case,topo", [
    ("grids_j", (2, 2, 1)), ("grids_j", (1, 2, 2)), ("k", (2, 1, 2)),
    ("compensated", (2, 2, 2)), ("bf16", (2, 2, 1))])
def test_sharded_packed_matches_reference(case, topo, monkeypatch):
    # the sharded packed step, where the sharded tb pass would take the
    # case (tests/test_torch_sharded_tb.py holds that)
    monkeypatch.setenv("FDTD3D_NO_TEMPORAL", "1")
    ref = RSim(cfg_of(case, topo))
    seed_reference(ref, 3)
    port = TSim(port_cfg(cfg_of(case, topo)), device="cpu")
    assert port.mesh is not None and port.step_kind == "packed_plain"
    port.adopt_state(convert.state_from_reference(np_state(ref)))
    ref.advance(STEPS)
    port.advance(STEPS)
    got = convert.state_to_reference(port.state)
    want = np_state(ref)
    if case == "compensated":
        # the residuals are bf16 roundings of f32 differences: one ulp
        # of a field moves them wholly (the reference's compensated
        # gates compare fields, tests/test_packed_sourced_sharded.py:178)
        for k in ("rE", "rH"):
            want.pop(k)
            got.pop(k)
    assert_state_close(want, got, BF16_TOL if case == "bf16" else TOL)
    uwant, ustatic = unsharded(case)
    moved = tio.reshard_psi_tree(
        convert.state_to_reference(port.state), ustatic.grid_shape, topo,
        tsolver.slab_axes(port.static), (1, 1, 1),
        tsolver.slab_axes(ustatic))
    for grp in uwant:
        if isinstance(uwant[grp], dict):
            for k in uwant[grp]:
                np.testing.assert_array_equal(
                    moved[grp][k], uwant[grp][k],
                    err_msg=f"{case} {topo}: {grp}/{k}")


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_health_counters_and_per_chip_match_reference(tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("FDTD3D_NO_TEMPORAL", "1")   # the sharded packed step
    topo = (2, 2, 2)
    out = {}
    for who in ("ref", "port"):
        path = str(tmp_path / f"{who}.jsonl")
        cfg = dataclasses.replace(
            cfg_of("grids_j", topo), time_steps=4,
            output=OutputConfig(telemetry_path=path, per_chip_telemetry=True,
                                save_dir=str(tmp_path / who)))
        if who == "ref":
            sim = RSim(cfg)
            seed_reference(sim, 4)
            sim.run(time_steps=4, on_interval=lambda s: None, interval=2)
        else:
            sim = TSim(port_cfg(cfg), device="cpu")
            r2 = RSim(dataclasses.replace(cfg, output=OutputConfig()))
            seed_reference(r2, 4)
            sim.adopt_state(convert.state_from_reference(np_state(r2)))
            sim.run(time_steps=4, on_interval=lambda s: None, interval=2)
        sim.close()
        out[who] = _records(path)
    start = [r for r in out["port"] if r["type"] == "run_start"][0]
    assert start["topology"] == list(topo)
    for kind in ("chunk", "per_chip"):
        want = [r for r in out["ref"] if r["type"] == kind]
        got = [r for r in out["port"] if r["type"] == kind]
        assert len(want) == len(got) == 2, kind
        for w, g in zip(want, got):
            src_w = w if kind == "chunk" else w["counters"]
            src_g = g if kind == "chunk" else g["counters"]
            for key in ("energy", "max_e", "max_h", "div_l2", "div_linf"):
                if key not in src_w:
                    continue
                a = np.asarray(src_w[key], np.float64)
                b = np.asarray(src_g[key], np.float64)
                assert a.shape == b.shape, (kind, key)
                rel = 1e-5 if key in ("energy", "div_l2") else 1e-6
                np.testing.assert_allclose(b, a, rtol=rel, atol=0,
                                           err_msg=f"{kind}/{key}")
    imb = [r for r in out["port"] if r["type"] == "imbalance"]
    assert len(imb) == 2


def _item(pattern):
    return pattern.replace("(", r"\(").replace(")", r"\)")


@pytest.mark.parametrize("kw,item", [
    (dict(topo=(4, 1, 1)), "A11(b)"),                   # local 6 <= 8
    # a source inside the absorber: the sharded two-pass step runs it
    (dict(topo=(2, 2, 2), point_source=PointSourceConfig(
        enabled=True, component="Ez", position=(2, 9, 7))), None),
    (dict(topo=(4, 1, 1), dtype="float32x2"), "A11(b)"),  # thin ds shard
    (dict(topo=(2, 1, 1), dtype="float64"), "A11(b)"),
    (dict(topo=(1, 2, 1), use_pallas=False), "A11(b)"),
    (dict(topo=(2, 2, 1), compensated=True, materials=MaterialsConfig(
        **K_MAT)), "A11(b)"),
])
def test_out_of_scope_sharded_raises_naming_its_item(kw, item):
    topo = kw.pop("topo")
    flag = kw.pop("use_pallas", True)
    cfg = dataclasses.replace(to_port(cfg_of("grids_j", topo, **kw)),
                              use_pallas=flag)
    if item is None:
        sim = TSim(cfg, device="cpu")
        assert sim.step_kind == "pallas3d_plain"
        assert sim.step_diag["tb_fallback"]["reason"] == "packed_ineligible"
        return
    with pytest.raises(NotImplementedError, match=_item(item)):
        TSim(cfg, device="cpu")


@pytest.mark.parametrize("name", ["FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED"])
def test_ladder_below_packed_sharded_raises(name, monkeypatch):
    """The ladder variables on a topology raised until the sharded
    two-pass step (B3(c)) came: they now run it, as the reference's
    dispatch does (its fused kernel is unsharded only); the token is
    the reference's (the K sphere's ``magnetic_drude`` first)."""
    monkeypatch.setenv(name, "1")
    sim = TSim(port_cfg(cfg_of("k", (2, 1, 1))), device="cpu")
    assert sim.step_kind == "pallas3d_plain"
    assert sim.step_diag["tb_fallback"]["reason"] == "magnetic_drude"
    sim.advance(1)


def test_2d_mode_ntff_batch_and_supervisor_sharded_raise():
    from fdtd3d_torch import config as tc
    from fdtd3d_torch.batch import BatchSimulation
    from fdtd3d_torch.supervisor import Supervisor
    two_d = tc.SimConfig(scheme="2D_TMz", size=(32, 32, 1),
                         parallel=tc.ParallelConfig(
                             topology="manual", manual_topology=(2, 2, 1)))
    with pytest.raises(NotImplementedError, match=_item("A11(b)")):
        TSim(two_d, device="cpu")
    cfg = port_cfg(cfg_of("grids_j", (2, 1, 1)))
    with pytest.raises(NotImplementedError, match=_item("A11(b)")):
        TSim(dataclasses.replace(cfg, ntff=tc.NtffConfig(enabled=True)),
             device="cpu")
    with pytest.raises(NotImplementedError, match=_item("A11(b)")):
        BatchSimulation([cfg, cfg], device="cpu")
    sup = Supervisor(cfg=cfg, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match=_item("A11(b)")):
            sup.ensure_sim()
    finally:
        sup._restore_env()


def test_paired_complex_sharded_raises_as_the_reference(monkeypatch):
    monkeypatch.setenv("FDTD3D_FORCE_PAIRED_COMPLEX", "1")
    cfg = dataclasses.replace(port_cfg(cfg_of("k", (2, 1, 1))),
                              complex_fields=True)
    with pytest.raises(ValueError, match="paired-real"):
        TSim(cfg, device="cpu")
    monkeypatch.delenv("FDTD3D_FORCE_PAIRED_COMPLEX")
    with pytest.raises(NotImplementedError, match=_item("A11(b)")):
        TSim(cfg, device="cpu")

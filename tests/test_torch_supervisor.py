"""The PyTorch port's durable-run supervisor on the CPU (the cases of
tests/test_supervisor.py without the topology ladder, which waits for
ROADMAP.md item A11; the supervisor's telemetry records are held in
tests/test_torch_telemetry.py).

* ``run_with_retry``: attempts and errors recorded, exhaustion keeps the
  record, non-transient errors propagate at once.
* ``degrade_plan`` on the port's kinds, rung for rung the reference's
  map on the reference's kinds.
* Transient errors are retried with backoff on an injected clock and a
  rollback; exhaustion re-raises; a simulated preemption is never
  swallowed.
* A NaN rolls back to the last committed checkpoint and degrades one
  rung, bit-valid against a clean continuation of the degraded kind from
  the same snapshot; NaNs walk every rung of the ladder, in f32
  (``packed_tb_plain`` -> ``packed_plain`` -> ``fused_plain`` ->
  ``pallas3d_plain`` -> ``plain``) and in bf16 (whose ``fused_preferred``
  goes from packed straight to the two-pass step), and a trip at the
  bottom re-raises.
* Stale newer snapshots are never rolled back onto; interval callbacks
  fire once a boundary; a supervised resume adopts the persisted ladder
  pins and counters, and ignores a foreign run's snapshot; a run
  without a cadence rolls back to its initial snapshot.
"""

import dataclasses
import os
import weakref

import numpy as np
import pytest

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import faults, io
from fdtd3d_torch.config import (OutputConfig, PmlConfig,
                                 PointSourceConfig, SimConfig, TfsfConfig)
from fdtd3d_torch.sim import Simulation
from fdtd3d_torch.supervisor import (RetryPolicy, Supervisor, degrade_plan,
                                     run_with_retry)
from fdtd3d_tpu import supervisor as rsup

LADDER_ENV = ("FDTD3D_NO_TEMPORAL", "FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED",
              "FDTD3D_FORCE_FUSED")


@pytest.fixture(autouse=True)
def _isolated_plan(monkeypatch):
    monkeypatch.delenv("FDTD3D_FAULT_PLAN", raising=False)
    for k in LADDER_ENV:
        monkeypatch.delenv(k, raising=False)
    faults.clear()
    yield
    faults.clear()


def _cfg(save_dir, use_pallas=None, dtype="float32", steps=24, **out_kw):
    """16^3 with CPML and a point source; on the CPU ``use_pallas=None``
    runs the plain step (the ladder's bottom), True the tb pass."""
    out_kw.setdefault("checkpoint_every", 8)
    return SimConfig(
        scheme="3D", size=(16, 16, 16), time_steps=steps, dx=1e-3,
        courant_factor=0.4, wavelength=8e-3, use_pallas=use_pallas,
        dtype=dtype, pml=PmlConfig(size=(3, 3, 3)),
        point_source=PointSourceConfig(enabled=True, component="Ez",
                                       position=(8, 8, 8)),
        output=OutputConfig(save_dir=str(save_dir), **out_kw))


def _sup(cfg, **kw):
    kw.setdefault("policy", RetryPolicy(sleep=lambda _s: None))
    return Supervisor(cfg, device="cpu", **kw)


# -------------------------------------------------------------------------
# run_with_retry
# -------------------------------------------------------------------------

def test_run_with_retry_records_attempts():
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError(f"transient #{calls['n']}")
        return "done"

    rec = {}
    out = run_with_retry(flaky, policy=RetryPolicy(
        max_retries=3, sleep=sleeps.append), label="stage", record=rec)
    assert out == "done"
    assert rec["ok"] is True and rec["attempts"] == 3
    assert len(rec["errors"]) == 2
    assert sleeps == [1.0, 2.0]


def test_run_with_retry_exhaustion_keeps_record():
    rec = {}
    with pytest.raises(RuntimeError):
        run_with_retry(lambda: (_ for _ in ()).throw(
            RuntimeError("always")), policy=RetryPolicy(
                max_retries=2, sleep=lambda _s: None), record=rec)
    assert rec["ok"] is False and rec["attempts"] == 3


def test_run_with_retry_nontransient_propagates_immediately():
    rec = {}
    with pytest.raises(KeyError):
        run_with_retry(lambda: (_ for _ in ()).throw(KeyError("nope")),
                       policy=RetryPolicy(sleep=lambda _s: None),
                       record=rec)
    assert rec["attempts"] == 1


# -------------------------------------------------------------------------
# the ladder map
# -------------------------------------------------------------------------

# the port's kind (both devices) -> the reference's kind of that rung
KINDS = {"packed_tb": "pallas_packed_tb", "packed": "pallas_packed",
         "packed_ds": "pallas_packed_ds", "fused": "pallas_fused",
         "pallas3d": "pallas"}


@pytest.mark.parametrize("base", sorted(KINDS))
@pytest.mark.parametrize("device", ["cuda", "plain"])
def test_degrade_plan_matches_reference(base, device):
    pins, fn = degrade_plan(f"{base}_{device}")
    want_pins, want_fn = rsup.degrade_plan(KINDS[base])
    assert pins == want_pins
    assert (fn is None) == (want_fn is None)
    if fn is not None:
        cfg = _cfg("x", use_pallas=True)
        assert fn(cfg).use_pallas is False


@pytest.mark.parametrize("kind", ["plain", "plain_ds"])
def test_degrade_plan_bottom(kind):
    assert degrade_plan(kind) is None
    assert rsup.degrade_plan({"plain": "jnp", "plain_ds": "jnp_ds"}[kind]) \
        is None


# -------------------------------------------------------------------------
# transient errors and preemption
# -------------------------------------------------------------------------

def test_transient_errors_retried_with_rollback(tmp_path):
    faults.install("error@t=8,times=2")
    sleeps = []
    sup = _sup(_cfg(tmp_path), policy=RetryPolicy(max_retries=3,
                                                  sleep=sleeps.append))
    sim = sup.run(interval=8)
    assert sim.t == 24
    assert sup.retries == 2 and sup.rollbacks == 2
    assert sleeps == [1.0, 2.0]
    for comp, v in sim.fields().items():
        assert np.isfinite(v).all(), comp


def test_transient_retry_exhaustion_reraises(tmp_path):
    faults.install("error@t=8,times=5")
    sup = _sup(_cfg(tmp_path), policy=RetryPolicy(
        max_retries=2, sleep=lambda _s: None))
    with pytest.raises(faults.InjectedTransientError):
        sup.run(interval=8)
    assert sup.retries == 2


def test_preemption_is_never_swallowed(tmp_path):
    faults.install("preempt@t=8")
    sup = _sup(_cfg(tmp_path), policy=RetryPolicy(
        max_retries=5, sleep=lambda _s: None))
    with pytest.raises(faults.SimulatedPreemption):
        sup.run(interval=8)


# -------------------------------------------------------------------------
# NaN -> rollback -> the kernel ladder
# -------------------------------------------------------------------------

def test_nan_rollback_degrades_tb_to_packed_bit_valid(tmp_path):
    d = tmp_path / "run"
    cfg = _cfg(d, use_pallas=True)
    faults.install("nan@t=8,field=Ez")
    sup = _sup(cfg)
    sim = sup.run(interval=8)
    faults.clear()
    assert sim.step_kind == "packed_plain", sim.step_kind
    assert sim.t == 24
    assert sup.degrades == 1 and sup.rollbacks == 1
    assert "FDTD3D_NO_TEMPORAL" not in os.environ  # the pin is undone
    newest = io.read_checkpoint_meta(io.find_latest_checkpoint(str(d)))
    assert newest["supervisor"]["env_pins"] == {"FDTD3D_NO_TEMPORAL": "1"}
    assert newest["step_kind"] == "packed_plain"

    # bit-valid: a clean continuation of the degraded kind from the same
    # committed snapshot (the NaN never fires again)
    os.environ["FDTD3D_NO_TEMPORAL"] = "1"
    try:
        ref = Simulation(dataclasses.replace(cfg, output=OutputConfig()),
                         device="cpu")
        assert ref.step_kind == "packed_plain"
        ref.restore(os.path.join(str(d), "ckpt_t000008.npz"))
        ref.advance(8)
        ref.advance(8)
    finally:
        del os.environ["FDTD3D_NO_TEMPORAL"]
    got = sim.fields()
    for comp, v in ref.fields().items():
        assert np.array_equal(v, got[comp]), comp


LADDERS = {
    "float32": ["packed_tb_plain", "packed_plain", "fused_plain",
                "pallas3d_plain", "plain"],
    "bfloat16": ["packed_tb_plain", "packed_plain", "pallas3d_plain",
                 "plain"],
}


@pytest.mark.parametrize("dtype", sorted(LADDERS))
def test_nans_walk_every_rung_then_the_bottom_reraises(tmp_path, dtype):
    """One NaN a rung: each trip rolls back to the snapshot before it
    and steps one rung down; the kinds the run passes through are the
    ladder's, and one more NaN on the plain step re-raises."""
    rungs = LADDERS[dtype]
    cfg = dataclasses.replace(
        _cfg(tmp_path, use_pallas=True, dtype=dtype,
             steps=6 * len(rungs), checkpoint_every=3),
        tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2)))
    nans = "; ".join(f"nan@t={6 * (i + 1)}" for i in range(len(rungs) - 1))
    faults.install(nans)
    seen = []
    sup = _sup(cfg)
    sim = sup.run(interval=3, on_interval=lambda s: seen.append(s.step_kind))
    assert sim.t == cfg.time_steps and sim.step_kind == "plain"
    assert sorted(set(seen), key=seen.index) == rungs
    assert sup.degrades == sup.rollbacks == len(rungs) - 1
    for comp, v in sim.fields().items():
        assert np.isfinite(v).all(), comp
    assert not any(k in os.environ for k in LADDER_ENV)

    faults.install(nans + f"; nan@t={6 * len(rungs)}")
    sup = _sup(dataclasses.replace(
        cfg, time_steps=6 * len(rungs) + 6,
        output=dataclasses.replace(cfg.output,
                                   save_dir=str(tmp_path / "again"))))
    with pytest.raises(FloatingPointError):
        sup.run(interval=3)
    assert sup.degrades == len(rungs) - 1
    assert sup.sim.step_kind == "plain"


def test_nan_on_plain_bottom_of_ladder_reraises(tmp_path):
    """On the plain step the blow-up is physics: no rung below it."""
    faults.install("nan@t=8")
    sup = _sup(_cfg(tmp_path))
    with pytest.raises(FloatingPointError):
        sup.run(interval=8)
    assert sup.degrades == 0


def test_escape_hatch_without_effect_reraises(tmp_path):
    """A degrade whose rebuilt sim runs the same kind re-raises the trip
    rather than looping at that rung."""
    faults.install("nan@t=8")
    cfg = _cfg(tmp_path, use_pallas=True, check_finite=True)
    same = Simulation(cfg, device="cpu")
    sup = _sup(cfg, sim_factory=lambda _c: same)
    with pytest.raises(FloatingPointError):
        sup.run(interval=8)
    assert sup.degrades == 0


def test_rollback_ignores_stale_newer_checkpoint(tmp_path):
    """save_dir still holds a finished previous run's snapshots (same
    config): a rollback never fast-forwards onto the old run's state."""
    Simulation(_cfg(tmp_path), device="cpu").advance(24)
    assert io.find_latest_checkpoint(str(tmp_path)).endswith(
        "ckpt_t000024.npz")
    faults.install("error@t=8,times=1")
    restored = []
    sup = _sup(_cfg(tmp_path))
    real = sup._rollback

    def spy(reason, t_max):
        src = real(reason, t_max)
        restored.append((t_max, sup.sim.t, os.path.basename(src)))
        return src

    sup._rollback = spy
    sim = sup.run(interval=8)
    assert sim.t == 24 and sup.rollbacks == 1
    assert restored == [(8, 8, "ckpt_t000008.npz")]


def test_on_interval_not_refired_after_rollback(tmp_path):
    """The NaN lands at boundary 12; the chunk to 16 trips and rolls
    back to t=8; boundary 12 is passed again without its callback."""
    faults.install("nan@t=10,field=Ez")
    seen = []
    sup = _sup(_cfg(tmp_path / "run", use_pallas=True))
    sim = sup.run(interval=4, on_interval=lambda s: seen.append(s.t))
    assert sim.t == 24 and sup.degrades == 1
    assert seen == [4, 8, 12, 16, 20, 24], seen


def test_boundary_callbacks_fire_after_same_t_rollback(tmp_path):
    """An error after a boundary's cadence checkpoint committed but
    before its callbacks ran: the rollback restores that boundary and
    its callbacks fire then."""
    faults.install("error@t=8,times=1")
    seen = []
    sup = _sup(_cfg(tmp_path))
    sim = sup.run(interval=8, on_interval=lambda s: seen.append(s.t))
    assert sim.t == 24
    assert seen == [8, 16, 24], seen


def test_degraded_build_failure_keeps_the_old_sim(tmp_path):
    """If building the degraded Simulation fails, the error propagates
    with the ladder pins restored; the old sim is not kept past the
    build: it is released before the next rung is built (one carry on
    the device), so a failed build leaves the supervisor without one."""
    faults.install("nan@t=8,field=Ez")
    calls = {"n": 0}

    def factory(c):
        calls["n"] += 1
        if calls["n"] > 1:
            assert first() is None, "the tripped sim is still alive"
            raise RuntimeError("degraded build failed (injected)")
        return Simulation(c, device="cpu")

    sup = _sup(_cfg(tmp_path / "run", use_pallas=True),
               sim_factory=factory)
    first = weakref.ref(sup.ensure_sim())
    assert first().step_kind == "packed_tb_plain"
    with pytest.raises(RuntimeError, match="degraded build failed"):
        sup.run(interval=8)
    assert calls["n"] == 2 and sup.sim is None and first() is None
    assert "FDTD3D_NO_TEMPORAL" not in os.environ


def test_cli_degrades_hold_one_sim_at_a_time(tmp_path, monkeypatch):
    """Through the CLI, every rung's Simulation is built after the
    tripped one is gone (nothing, the CLI's own reference included,
    keeps it alive), so a degrade never holds two carries."""
    built = []

    def factory(sup, c):
        assert all(r() is None for r in built), \
            "a tripped sim is alive while the next rung is built"
        sim = Simulation(c, device="cpu")
        built.append(weakref.ref(sim))
        return sim

    monkeypatch.setattr(Supervisor, "_default_factory", factory)
    monkeypatch.setenv("FDTD3D_FAULT_PLAN", "nan@t=8; nan@t=16")
    assert tcli.main(_argv(tmp_path / "run")) == 0
    meta = io.read_checkpoint_meta(
        io.find_latest_checkpoint(str(tmp_path / "run")))
    assert meta["t"] == 24 and meta["step_kind"] == "fused_plain"
    assert len(built) == 3


# -------------------------------------------------------------------------
# supervised resume
# -------------------------------------------------------------------------

def _argv(d):
    return ["--3d", "--same-size", "16", "--time-steps", "24",
            "--use-pml", "--pml-size", "3", "--point-source", "Ez",
            "--courant-factor", "0.4", "--wavelength", "0.008",
            "--checkpoint-every", "8", "--save-dir", str(d), "--supervise",
            "--use-pallas", "on", "--log-level", "0", "--device", "cpu"]


def test_supervised_resume_adopts_persisted_degraded_state(tmp_path,
                                                           monkeypatch):
    """A preemption mid-degrade: the next supervised --resume reads the
    persisted pins and counters from the snapshot and resumes degraded
    rather than on the temporal-blocked pass."""
    d = tmp_path / "run"
    # the NaN at t=8 trips at 16 -> packed + rollback to t=8; the
    # re-advanced boundary at t=16 commits a snapshot with the
    # supervisor state, then the preemption kills the run
    monkeypatch.setenv("FDTD3D_FAULT_PLAN", "nan@t=8,field=Ez; preempt@t=16")
    with pytest.raises(faults.SimulatedPreemption):
        tcli.main(_argv(d))
    monkeypatch.delenv("FDTD3D_FAULT_PLAN")
    faults.clear()
    assert "FDTD3D_NO_TEMPORAL" not in os.environ
    meta = io.read_checkpoint_meta(io.find_latest_checkpoint(str(d)))
    assert meta["t"] == 16 and meta["step_kind"] == "packed_plain"
    assert meta["supervisor"]["env_pins"] == {"FDTD3D_NO_TEMPORAL": "1"}

    assert tcli.main(_argv(d) + ["--resume", "auto"]) == 0
    assert "FDTD3D_NO_TEMPORAL" not in os.environ
    _state, extra = io.load_checkpoint(os.path.join(str(d),
                                                    "ckpt_t000024.npz"))
    assert extra["t"] == 24
    assert extra["step_kind"] == "packed_plain"     # resumed degraded
    assert extra["supervisor"]["degrades"] == 1     # counters seeded
    assert extra["supervisor"]["rollbacks"] == 1    # nothing new fired


def test_supervised_resume_peek_ignores_foreign_snapshot(tmp_path):
    foreign = {"t": 8, "scheme": "3D", "size": [32, 32, 32],
               "dtype": "float32",
               "supervisor": {"topology": [1, 1, 1], "env_pins":
                              {"FDTD3D_NO_TEMPORAL": "1"}}}
    io.save_checkpoint({"E": {"Ez": np.zeros((4, 4), np.float32)}},
                       str(tmp_path / "ckpt_t000008.npz"), extra=foreign)
    cfg = _cfg(tmp_path)          # (16, 16, 16): incompatible
    state, path = tcli._peek_supervisor_state(cfg, "auto")
    assert state is None and path is None
    compatible = {**foreign, "size": list(cfg.size)}
    io.save_checkpoint({"E": {"Ez": np.zeros((4, 4), np.float32)}},
                       str(tmp_path / "ckpt_t000016.npz"), extra=compatible)
    state, path = tcli._peek_supervisor_state(cfg, "auto")
    assert state == compatible["supervisor"]
    assert path.endswith("ckpt_t000016.npz")


def test_rollback_without_checkpoints_uses_initial_snapshot(tmp_path):
    faults.install("error@t=8,times=1")
    restored = []
    sup = _sup(_cfg(tmp_path, checkpoint_every=0))
    real = sup._rollback
    sup._rollback = lambda r, t: restored.append(real(r, t)) or restored[-1]
    sim = sup.run(interval=8)
    assert sim.t == 24 and restored == ["initial-snapshot"]
    assert not io.find_checkpoints(str(tmp_path))
    clean = Simulation(_cfg(tmp_path, checkpoint_every=0), device="cpu")
    clean.advance(24)
    for comp, v in clean.fields().items():
        assert np.array_equal(v, sim.fields()[comp]), comp


def test_batch_supervise_forces_the_finite_check(tmp_path):
    """--batch --supervise: each lane's verdict is measured (the finite
    check is on), as the reference's supervised batch does."""
    paths = []
    for i, amp in enumerate((1.0, 2.0)):
        p = tmp_path / f"lane{i}.txt"
        p.write_text("--3d\n--same-size 16\n--time-steps 4\n--use-pml\n"
                     "--pml-size 3\n--point-source Ez\n"
                     f"--point-source-amplitude {amp}\n--log-level 1\n")
        paths.append(str(p))
    import contextlib
    import io as _io
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main(["--batch", *paths, "--supervise",
                          "--device", "cpu"]) == 0
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("batch lane")]
    assert lines == ["batch lane 0: healthy", "batch lane 1: healthy"]
    for flag in (["--checkpoint-every", "2"], ["--resume", "auto"]):
        with pytest.raises(NotImplementedError, match=r"A13\(b\)"):
            tcli.main(["--batch", *paths, "--device", "cpu"] + flag)

"""Deterministic fault injection in the PyTorch port, on the CPU (the
cases of tests/test_faults.py without the chip- and host-scoped faults,
which wait for ROADMAP.md item A11; the telemetry records of a trip are
held in tests/test_torch_telemetry.py).

* The plan grammar parses as the reference's; the kinds and scopes the
  port does not fire raise NotImplementedError naming their item when
  installed (programmatically or through ``FDTD3D_FAULT_PLAN``), never a
  silent no-op.
* An injected write failure never leaves a torn or partial file, and a
  failed checkpoint write keeps the older snapshot.
* A NaN trips the next chunk; the snapshot of its boundary stays clean.
* Kill and ``--resume auto`` through ``fdtd3d_torch.cli.main`` finish
  bit-identical to an uninterrupted run (on the plain step and on the
  temporal-blocked schedule with an odd chunk length); snapshots past
  the horizon are skipped; a corrupt newest snapshot falls back to the
  older one; the friendly exits; the SIGTERM/SIGINT handlers (143/130)
  are installed and restored, and end a real process with those codes.
* The chaos cocktails of fixed seeds 0-3: a supervised run either
  completes bit-identical to the clean run or fails with a named error,
  and every committed snapshot stays loadable unless the plan itself
  damaged it.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import faults, io
from fdtd3d_torch.config import (OutputConfig, PmlConfig,
                                 PointSourceConfig, SimConfig)
from fdtd3d_torch.sim import Simulation
from fdtd3d_tpu import faults as rfaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated_plan(monkeypatch):
    monkeypatch.delenv("FDTD3D_FAULT_PLAN", raising=False)
    faults.clear()
    yield
    faults.clear()


def _cfg(save_dir, steps=24, every=8, keep=3, **out_kw):
    return SimConfig(
        scheme="3D", size=(16, 16, 16), time_steps=steps, dx=1e-3,
        courant_factor=0.4, wavelength=8e-3,
        pml=PmlConfig(size=(3, 3, 3)),
        point_source=PointSourceConfig(enabled=True, component="Ez",
                                       position=(8, 8, 8)),
        output=OutputConfig(save_dir=str(save_dir), checkpoint_every=every,
                            checkpoint_keep=keep, **out_kw))


def _cli_argv(save_dir, steps=24, every=8, pallas="off"):
    return ["--3d", "--same-size", "16", "--time-steps", str(steps),
            "--use-pml", "--pml-size", "3", "--point-source", "Ez",
            "--courant-factor", "0.4", "--wavelength", "0.008",
            "--checkpoint-every", str(every), "--save-dir", str(save_dir),
            "--use-pallas", pallas, "--log-level", "0", "--device", "cpu"]


def _sim(cfg):
    return Simulation(cfg, device="cpu")


# -------------------------------------------------------------------------
# plan parsing
# -------------------------------------------------------------------------

SPEC = ("nan@t=8,field=Ey; preempt@t=16; fail_write@n=2; "
        "corrupt_ckpt@n=1,mode=zero; error@t=4,times=3")


def test_fault_plan_parse():
    plan = faults.FaultPlan.parse(SPEC)
    kinds = [f.kind for f in plan.faults]
    assert kinds == ["nan", "preempt", "fail_write", "corrupt_ckpt",
                     "error"]
    assert plan.faults[0].field == "Ey" and plan.faults[0].t == 8
    assert plan.faults[2].n == 2
    assert plan.faults[3].mode == "zero"
    assert plan.faults[4].times == 3
    want = rfaults.FaultPlan.parse(SPEC)
    assert [vars(f) for f in plan.faults] == [vars(f) for f in want.faults]


@pytest.mark.parametrize("spec,match", [
    ("explode@t=3", "unknown fault kind"),
    ("nan@t=soon", "must be an integer"),
    ("nan@step=3", "unknown fault-plan key"),
    ("corrupt_ckpt@n=1,mode=shred", "mode"),
    ("nan@t=8,chip=three", "must be an integer"),
    ("fail_write@n=2,chip=1", "does not apply"),
    ("preempt@t=8,times=2", "does not apply"),
    ("sched_crash@t=1", "does not apply"),
    ("sched_crash@between=acquire,commit", "between must be"),
    ("lease_expire@t=1", "does not apply"),
])
def test_fault_plan_parse_rejects_junk(spec, match):
    with pytest.raises(ValueError, match=match) as got:
        faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as want:
        rfaults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec,item", [
    ("nan@t=8,chip=3", "A11"), ("nan@t=8,lane=1", "A13(b)"),
    ("host_lost@n=2", "A11"), ("fail_write@n=1,host=1", "A11"),
    ("sched_crash@job=1", "A15"),
    ("sched_crash@between=acquire,dispatch", "A15"),
    ("lease_expire@job=2", "A15"),
])
def test_unported_kinds_raise_naming_their_item(spec, item, monkeypatch,
                                                tmp_path):
    plan = faults.FaultPlan.parse("preempt@t=4; " + spec)  # it parses
    assert len(plan.faults) == 2
    with pytest.raises(NotImplementedError, match=item.replace("(", r"\(")
                       .replace(")", r"\)")):
        faults.install(plan)
    assert faults.active() is None
    monkeypatch.setenv("FDTD3D_FAULT_PLAN", spec)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue"):
        _sim(_cfg(tmp_path))


def test_batch_with_a_fault_plan_raises(monkeypatch):
    from fdtd3d_torch.batch import BatchSimulation
    monkeypatch.setenv("FDTD3D_FAULT_PLAN", "preempt@t=2")
    cfg = _cfg("unused", steps=2, every=0)
    with pytest.raises(NotImplementedError, match=r"A13\(b\)"):
        BatchSimulation([cfg, cfg], device="cpu")


# -------------------------------------------------------------------------
# the atomic writer under injected write failures
# -------------------------------------------------------------------------

def test_failed_write_leaves_no_partial_file(tmp_path):
    faults.install("fail_write@n=1")
    target = str(tmp_path / "out.json")
    with pytest.raises(faults.InjectedWriteError):
        with io.atomic_open(target) as f:
            f.write("half-written")
    assert not os.path.exists(target)
    assert not any(".tmp." in n for n in os.listdir(tmp_path))
    with io.atomic_open(target) as f:   # one-shot: the retry succeeds
        f.write("complete")
    assert open(target).read() == "complete"


def test_failed_write_keeps_previous_version(tmp_path):
    target = str(tmp_path / "out.json")
    with io.atomic_open(target) as f:
        f.write("version 1")
    faults.install("fail_write@n=1")
    with pytest.raises(faults.InjectedWriteError):
        with io.atomic_open(target) as f:
            f.write("version 2, torn")
    assert open(target).read() == "version 1"


def test_failed_dump_publishes_nothing(tmp_path):
    """A DAT dump (atomic_publish) failed before its rename."""
    faults.install("fail_write@n=1")
    target = str(tmp_path / "Ez.dat")
    with pytest.raises(faults.InjectedWriteError):
        io.dump_dat(np.ones((2, 2), np.float32), target)
    assert os.listdir(tmp_path) == []


def test_failed_checkpoint_write_keeps_older_snapshot(tmp_path):
    sim = _sim(_cfg(tmp_path))
    sim.advance(8)                      # ckpt_t000008 commits
    faults.install("fail_write@n=1")
    with pytest.raises(faults.InjectedWriteError):
        sim.advance(8)                  # ckpt_t000016's write fails
    faults.clear()
    assert [t for t, _ in io.find_checkpoints(str(tmp_path))] == [8]
    _state, extra = io.load_checkpoint(
        os.path.join(str(tmp_path), "ckpt_t000008.npz"))
    assert extra["t"] == 8


# -------------------------------------------------------------------------
# a NaN trips the next chunk
# -------------------------------------------------------------------------

def test_nan_fault_trips_next_chunk(tmp_path):
    faults.install("nan@t=8,field=Ez")
    sim = _sim(_cfg(tmp_path, check_finite=True))
    sim.advance(8)
    assert np.isnan(sim.field("Ez")[8, 8, 8])
    assert np.isfinite(sim.field("Ez")).sum() == 16 ** 3 - 1
    with pytest.raises(FloatingPointError, match=r"\(8, 16\]"):
        sim.advance(8)
    state, _ = io.load_checkpoint(
        os.path.join(str(tmp_path), "ckpt_t000008.npz"))
    assert np.isfinite(state["E"]["Ez"]).all()


# -------------------------------------------------------------------------
# kill between chunks -> --resume auto -> bit-identical
# -------------------------------------------------------------------------

@pytest.mark.parametrize("pallas,steps,every,kill", [
    ("off", 24, 8, 16), ("on", 15, 5, 10)])
def test_kill_and_resume_auto_bit_identical(tmp_path, monkeypatch, pallas,
                                            steps, every, kill):
    """``on``: the temporal-blocked schedule, 5-step chunks (two passes
    and a packed tail step each)."""
    killed, clean = tmp_path / "killed", tmp_path / "clean"
    argv = lambda d: _cli_argv(d, steps, every, pallas)  # noqa: E731
    monkeypatch.setenv("FDTD3D_FAULT_PLAN", f"preempt@t={kill}")
    with pytest.raises(faults.SimulatedPreemption):
        tcli.main(argv(killed))
    monkeypatch.delenv("FDTD3D_FAULT_PLAN")
    faults.clear()
    assert [t for t, _ in io.find_checkpoints(str(killed))] == \
        list(range(kill, 0, -every))[:3]
    assert tcli.main(argv(killed) + ["--resume", "auto"]) == 0
    assert tcli.main(argv(clean)) == 0
    name = f"ckpt_t{steps:06d}.npz"
    a, ea = io.load_checkpoint(os.path.join(str(killed), name))
    b, _ = io.load_checkpoint(os.path.join(str(clean), name))
    assert ea["step_kind"] == ("packed_tb_plain" if pallas == "on"
                               else "plain")

    def eq(x, y, path=""):
        if isinstance(x, dict):
            for k in x:
                eq(x[k], y[k], f"{path}/{k}")
        else:
            assert np.array_equal(x, y), path

    eq(a, b)


def test_resume_auto_skips_past_horizon_checkpoint(tmp_path, monkeypatch):
    argv48 = _cli_argv(tmp_path, steps=48)
    assert tcli.main(argv48) == 0        # leaves ckpt_t000048/40/32
    assert [t for t, _ in io.find_checkpoints(str(tmp_path))] == \
        [48, 40, 32]
    monkeypatch.setenv("FDTD3D_FAULT_PLAN", "preempt@t=8")
    with pytest.raises(faults.SimulatedPreemption):
        tcli.main(_cli_argv(tmp_path))   # the 24-step run killed at t=8
    monkeypatch.delenv("FDTD3D_FAULT_PLAN")
    faults.clear()
    assert tcli.main(_cli_argv(tmp_path) + ["--resume", "auto"]) == 0
    ts = [t for t, _ in io.find_checkpoints(str(tmp_path))]
    assert {8, 16, 24} <= set(ts), ts   # the live snapshots survived
    _state, extra = io.load_checkpoint(
        os.path.join(str(tmp_path), "ckpt_t000024.npz"))
    assert extra["t"] == 24             # resumed from t=8, not t=48


def test_resume_auto_without_checkpoints_is_friendly(tmp_path):
    with pytest.raises(SystemExit, match="no committed checkpoint"):
        tcli.main(_cli_argv(tmp_path) + ["--resume", "auto"])


def test_resume_explicit_corrupt_is_friendly(tmp_path):
    assert tcli.main(_cli_argv(tmp_path)) == 0
    ck = os.path.join(str(tmp_path), "ckpt_t000024.npz")
    with open(ck, "r+b") as fh:
        fh.truncate(os.path.getsize(ck) // 2)
    with pytest.raises(SystemExit, match="structure check failed"):
        tcli.main(_cli_argv(tmp_path) + ["--resume", ck])


def test_resume_and_load_checkpoint_are_exclusive(tmp_path):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        tcli.main(_cli_argv(tmp_path) + ["--resume", "auto",
                                         "--load-checkpoint", "x.npz"])


def test_load_checkpoint_runs_the_remaining_steps(tmp_path):
    assert tcli.main(_cli_argv(tmp_path / "a")) == 0
    ck = os.path.join(str(tmp_path / "a"), "ckpt_t000016.npz")
    assert tcli.main(_cli_argv(tmp_path / "b")
                     + ["--load-checkpoint", ck]) == 0
    assert [t for t, _ in io.find_checkpoints(str(tmp_path / "b"))] == [24]
    a, _ = io.load_checkpoint(os.path.join(str(tmp_path / "a"),
                                           "ckpt_t000024.npz"))
    b, _ = io.load_checkpoint(os.path.join(str(tmp_path / "b"),
                                           "ckpt_t000024.npz"))
    for c in a["E"]:
        assert np.array_equal(a["E"][c], b["E"][c]), c


def test_corrupt_newest_skipped_older_used(tmp_path):
    assert tcli.main(_cli_argv(tmp_path)) == 0
    newest = os.path.join(str(tmp_path), "ckpt_t000024.npz")
    with open(newest, "r+b") as fh:
        fh.truncate(os.path.getsize(newest) // 2)
    sim = _sim(_cfg(tmp_path, every=0))
    with pytest.raises(io.CheckpointCorrupt,
                       match=r"ckpt_t000024\.npz.*structure check"):
        sim.restore(newest)
    assert tcli.main(_cli_argv(tmp_path) + ["--resume", "auto"]) == 0
    _state, extra = io.load_checkpoint(newest)
    assert extra["t"] == 24


def test_corrupt_ckpt_fault_detected_by_checksum(tmp_path):
    faults.install("corrupt_ckpt@n=1,mode=zero")
    sim = _sim(_cfg(tmp_path))
    rng = np.random.RandomState(2)
    for c in ("Ex", "Ey", "Ez"):
        # no zero run in the payload: zeroed bytes change it
        sim.set_field(c, 1.0 + rng.random_sample((16, 16, 16)))
    sim.advance(8)
    sim.advance(8)
    faults.clear()
    fresh = _sim(_cfg(tmp_path, every=0))
    with pytest.raises(io.CheckpointCorrupt):
        fresh.restore(os.path.join(str(tmp_path), "ckpt_t000008.npz"))
    fresh.restore(os.path.join(str(tmp_path), "ckpt_t000016.npz"))
    assert fresh.t == 16


# -------------------------------------------------------------------------
# SIGTERM / SIGINT
# -------------------------------------------------------------------------

def test_cli_registers_and_restores_sigint_sigterm(tmp_path, monkeypatch):
    calls = []

    def fake_signal(sig, handler):
        calls.append((sig, handler))
        return signal.SIG_DFL

    monkeypatch.setattr(signal, "signal", fake_signal)
    assert tcli.main(_cli_argv(tmp_path)) == 0
    for sig, code in ((signal.SIGTERM, 143), (signal.SIGINT, 130)):
        ours = [h for s, h in calls if s == sig]
        assert len(ours) == 2, f"register + restore expected for {sig}"
        with pytest.raises(SystemExit) as ei:
            ours[0](sig, None)
        assert ei.value.code == code
        assert ours[-1] is signal.SIG_DFL


@pytest.mark.parametrize("sig,code", [(signal.SIGINT, 130),
                                      (signal.SIGTERM, 143)])
def test_signal_ends_a_real_run_with_its_code(tmp_path, sig, code):
    """Mid-run (a cadence snapshot already committed) the signal ends the
    process with the handler's exit code."""
    d = tmp_path / "out"
    argv = [sys.executable, "-m", "fdtd3d_torch.cli"] + _cli_argv(
        d, steps=2000000, every=2)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(argv, env=env, cwd=ROOT,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and proc.poll() is None:
            if io.find_checkpoints(str(d)):
                break
            time.sleep(0.1)
        assert proc.poll() is None, "run ended before the signal"
        proc.send_signal(sig)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == code, rc
    for _t, path in io.find_checkpoints(str(d)):
        io.load_checkpoint(path)       # every committed snapshot loads


# -------------------------------------------------------------------------
# deterministic chaos: fixed-seed fault cocktails (tests/test_faults.py)
# -------------------------------------------------------------------------

_NAMED_FAILURES = (faults.SimulatedPreemption, FloatingPointError,
                   faults.InjectedTransientError,
                   faults.InjectedWriteError, io.CheckpointCorrupt)


def _draw_plan(rng) -> str:
    """1-3 bounded faults drawn from the plan grammar the port fires."""
    entries = []
    for _ in range(int(rng.integers(1, 4))):
        kind = ["error", "nan", "preempt", "fail_write",
                "corrupt_ckpt"][int(rng.integers(0, 5))]
        if kind == "error":
            entries.append(f"error@t={int(rng.integers(4, 20))},"
                           f"times={int(rng.integers(1, 3))}")
        elif kind == "nan":
            field = ["Ez", "Hx", "Hy"][int(rng.integers(0, 3))]
            entries.append(f"nan@t={int(rng.integers(4, 20))},"
                           f"field={field}")
        elif kind == "preempt":
            entries.append(f"preempt@t={int(rng.integers(8, 24))}")
        elif kind == "fail_write":
            entries.append(f"fail_write@n={int(rng.integers(1, 4))}")
        else:
            entries.append(
                f"corrupt_ckpt@n={int(rng.integers(1, 3))},"
                f"mode={'zero' if rng.random() < 0.5 else 'truncate'}")
    return "; ".join(entries)


@pytest.fixture(scope="module")
def chaos_reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("chaos_ref")
    sim = _sim(_cfg(d, steps=24))
    sim.advance(24)
    return sim.fields()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_chaos_bounded_fixed_seed(tmp_path, seed, chaos_reference):
    from fdtd3d_torch.supervisor import RetryPolicy, Supervisor
    rng = np.random.default_rng(seed)
    spec = _draw_plan(rng)
    assert spec == _reference_draw(seed)
    faults.install(spec)
    sup = Supervisor(_cfg(tmp_path / "run", steps=24), device="cpu",
                     policy=RetryPolicy(max_retries=2,
                                        sleep=lambda _s: None))
    try:
        sim = sup.run(interval=8)
        assert sim.t == 24, spec
        for comp, ref in chaos_reference.items():
            assert np.array_equal(sim.fields()[comp], ref), (spec, comp)
    except _NAMED_FAILURES as exc:
        assert str(exc), spec
    finally:
        faults.clear()
    for _t, path in io.find_checkpoints(str(tmp_path / "run")):
        try:
            io.load_checkpoint(path)
        except io.CheckpointCorrupt:
            assert "corrupt_ckpt" in spec, (spec, path)


def _reference_draw(seed):
    """The reference's chaos test draws the same cocktail for a seed."""
    import test_faults
    return test_faults._draw_plan(np.random.default_rng(seed))

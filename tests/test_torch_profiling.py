"""The PyTorch port's StepClock, trace capture and finite guards on the
CPU (the cases of tests/test_profiling.py, and the trace spans of
tests/test_telemetry.py).

``OutputConfig.profile`` attaches a StepClock that ``Simulation.advance``
feeds; ``--trace DIR`` / ``--profile DIR`` write a torch.profiler Chrome
trace holding the ``fdtd3d/*`` spans, finalised on every exit (a
non-finite trip included, with the sink's run_end); check_finite trips
on NaN; the clock's summary is the reference's on the same records.
"""

import json
import os

import numpy as np
import pytest

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import faults, profiling
from fdtd3d_torch import telemetry as ttel
from fdtd3d_torch.config import (OutputConfig, PmlConfig, PointSourceConfig,
                                 SimConfig)
from fdtd3d_torch.sim import Simulation
from fdtd3d_tpu import profiling as rprof


def _cfg(**out):
    return SimConfig(
        scheme="2D_TMz", size=(32, 32, 1), time_steps=8, dx=1e-3,
        courant_factor=0.5, wavelength=10e-3,
        pml=PmlConfig(size=(4, 4, 0)),
        point_source=PointSourceConfig(enabled=True, component="Ez",
                                       position=(16, 16, 0)),
        output=OutputConfig(**out))


@pytest.fixture(autouse=True)
def _no_plan(monkeypatch):
    monkeypatch.delenv("FDTD3D_FAULT_PLAN", raising=False)
    faults.clear()
    yield
    faults.clear()


def test_step_clock_records_profiled_chunks():
    sim = Simulation(_cfg(profile=True), device="cpu")
    assert sim.clock is not None
    sim.advance(4)
    sim.advance(4)
    s = sim.clock.summary()
    assert s["steps"] == 8 and s["chunks"] == 2
    assert s["seconds"] > 0.0 and s["mcells_per_s"] > 0.0
    assert s["best_mcells_per_s"] >= s["mcells_per_s"] * 0.99
    assert "Mcells/s" in sim.clock.report()
    assert len(sim.clock.records) == 2


def test_clock_absent_without_profile():
    sim = Simulation(_cfg(), device="cpu")
    assert sim.clock is None and sim.tracer is None
    sim.advance(2)


def test_check_finite_trips_on_nan():
    sim = Simulation(_cfg(check_finite=True), device="cpu")
    sim.advance(2)
    sim.set_field("Ez", np.full((32, 32, 1), np.nan, np.float32))
    with pytest.raises(FloatingPointError, match="Ez"):
        sim.advance(1)


def test_step_clock_summary_matches_reference():
    """The same chunk records give the reference's summary and report."""
    mine, ref = profiling.StepClock(), rprof.StepClock()
    for steps, sec in ((4, 0.5), (4, 0.25), (2, 0.3), (6, 0.9)):
        mine.record(steps, sec, 1000.0)
        ref.record(steps, sec, 1000.0)
    assert mine.summary() == ref.summary()
    assert mine.report() == ref.report()
    assert profiling.StepClock().summary() == rprof.StepClock().summary()
    vals = [3.0, 1.0, 2.0, 7.5]
    assert ttel.pct_summary(vals) == rprof.pct_summary(vals)


def test_finite_check_names_the_leaves():
    sim = Simulation(_cfg(), device="cpu")
    sim.advance(2)
    assert all(profiling.finite_check(sim.state).values())
    profiling.assert_finite(sim.state)
    view = sim._dict_view()
    view["H"]["Hy"][3, 4, 0] = float("inf")
    bad = [k for k, ok in profiling.finite_check(view).items() if not ok]
    assert bad == ["['H']['Hy']"]
    with pytest.raises(FloatingPointError, match="Hy"):
        profiling.assert_finite(view, "t=2")


def test_cli_profile_flag(capsys):
    rc = tcli.main(["--2d", "TMz", "--sizex", "24", "--sizey", "24",
                    "--time-steps", "4", "--point-source", "Ez",
                    "--profile", "--check-finite", "--device", "cpu"])
    assert rc == 0
    assert "profile: 4 steps in " in capsys.readouterr().out


def _trace_names(path):
    with open(path) as f:
        return {ev.get("name") for ev in json.load(f)["traceEvents"]}


def test_cli_trace_writes_the_spans(tmp_path, capsys):
    """--trace DIR writes DIR/trace.json holding the chunk, health,
    readback, prepare and io-dump spans."""
    trace_dir = tmp_path / "trace"
    rc = tcli.main(["--3d", "--same-size", "16", "--time-steps", "4",
                    "--point-source", "Ez", "--use-pallas", "on",
                    "--save-res", "2", "--save-dir", str(tmp_path),
                    "--telemetry", str(tmp_path / "t.jsonl"),
                    "--trace", str(trace_dir), "--device", "cpu"])
    assert rc == 0
    assert f"trace -> {trace_dir}" in capsys.readouterr().out
    names = _trace_names(trace_dir / profiling.TRACE_FILE)
    for span in ("chunk", "health", "telemetry-readback", "prepare",
                 "io-dump"):
        assert f"fdtd3d/{span}" in names, span


def test_trace_and_sink_finalised_on_a_trip(tmp_path, monkeypatch):
    """A non-finite trip through the CLI (check_finite, no supervisor)
    raises, and the finally still writes the trace and the sink's
    run_end with the first-unhealthy bound."""
    monkeypatch.setenv("FDTD3D_FAULT_PLAN", "nan@t=4")
    with pytest.raises(FloatingPointError):
        tcli.main(["--3d", "--same-size", "16", "--time-steps", "8",
                   "--point-source", "Ez", "--save-res", "4",
                   "--save-dir", str(tmp_path), "--check-finite",
                   "--telemetry", str(tmp_path / "t.jsonl"),
                   "--profile", str(tmp_path / "trace"),
                   "--device", "cpu", "--log-level", "0"])
    assert os.path.exists(tmp_path / "trace" / profiling.TRACE_FILE)
    recs = ttel.read_jsonl(str(tmp_path / "t.jsonl"))
    assert recs[-1]["type"] == "run_end"
    assert recs[-1]["first_unhealthy_t"] == 8


def test_device_trace_finalised_when_the_block_raises(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with profiling.device_trace(str(tmp_path)) as cap:
            assert cap.ok
            raise RuntimeError("boom")
    assert not cap.ok
    assert os.path.exists(tmp_path / profiling.TRACE_FILE)
    cap.stop()   # idempotent

"""Per-chunk timing, trace capture and finite guards of the PyTorch port.

Counterpart of ``fdtd3d_tpu/profiling.py``:

* ``StepClock`` -- wall time per ``Simulation.advance`` chunk and its
  throughput. ``Simulation`` attaches one as ``sim.clock`` when
  ``OutputConfig.profile`` is set (CLI ``--profile``); ``advance`` then
  brackets every chunk with a device sync, so the times are honest (the
  same bracket the telemetry chunk record uses).
* ``trace``, ``TraceCapture`` and ``device_trace`` -- a
  ``torch.profiler`` capture (host and, on the card, CUDA activity)
  around a block, written as a Chrome trace (``trace.json``) into a
  directory. ``TraceCapture`` starts at the first ``advance`` of a sim
  with ``OutputConfig.profile_dir`` (CLI ``--profile DIR`` or
  ``--trace DIR``) and stops in ``Simulation.close``, which the CLI
  holds in a ``finally``, so every exit writes the trace; a profiler
  that cannot start degrades to a warned no-op. The spans of
  ``telemetry.span``/``named`` (``fdtd3d/chunk``, ``fdtd3d/health``,
  ...) name the phases in it.
* ``finite_check`` / ``assert_finite`` -- NaN/Inf guards over every
  floating leaf of a dict-form state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List

import torch

from fdtd3d_torch import log as _log
from fdtd3d_torch.telemetry import pct_summary

TRACE_FILE = "trace.json"


@dataclasses.dataclass
class ChunkRecord:
    steps: int
    seconds: float
    cells: float

    @property
    def mcells_per_s(self) -> float:
        return self.cells * self.steps / self.seconds / 1e6


class StepClock:
    """Wall clock per advance() chunk (the reference Clock's successor)."""

    def __init__(self):
        self.records: List[ChunkRecord] = []

    def record(self, steps: int, seconds: float, cells: float):
        self.records.append(ChunkRecord(steps, seconds, cells))

    @property
    def total_steps(self) -> int:
        return sum(r.steps for r in self.records)

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.records)

    def summary(self) -> Dict[str, float]:
        """Aggregate and per-chunk Mcells/s percentiles (p50/p95/max):
        a slowdown confined to a few chunks shows as a p95/max gap while
        the mean barely moves."""
        if not self.records:
            return {"steps": 0, "seconds": 0.0, "mcells_per_s": 0.0,
                    "best_mcells_per_s": 0.0, "chunks": 0,
                    "p50_mcells_per_s": 0.0, "p95_mcells_per_s": 0.0,
                    "max_mcells_per_s": 0.0}
        pct = pct_summary([r.mcells_per_s for r in self.records])
        return {
            "steps": self.total_steps,
            "seconds": self.total_seconds,
            "chunks": len(self.records),
            "mcells_per_s": (sum(r.cells * r.steps for r in self.records)
                             / self.total_seconds / 1e6),
            "best_mcells_per_s": max(r.mcells_per_s for r in self.records),
            "p50_mcells_per_s": pct["p50"],
            "p95_mcells_per_s": pct["p95"],
            "max_mcells_per_s": pct["max"],
        }

    def report(self) -> str:
        s = self.summary()
        return (f"{s['steps']} steps in {s['seconds']:.3f}s — "
                f"{s['mcells_per_s']:.1f} Mcells/s over {s['chunks']} "
                f"chunks (p50 {s['p50_mcells_per_s']:.1f} / p95 "
                f"{s['p95_mcells_per_s']:.1f} / max "
                f"{s['max_mcells_per_s']:.1f})")


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class TraceCapture:
    """A ``torch.profiler`` capture into ``log_dir`` with degrade-to-skip.

    ``start`` begins the capture, ``stop`` ends it and writes
    ``log_dir/trace.json`` (a Chrome trace; Perfetto and
    chrome://tracing read it). Both are idempotent, and both degrade to
    a warned no-op when the profiler cannot attach: a simulation never
    dies because its observability could not (``ok`` says whether a
    capture is live)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.ok = False
        self.path = os.path.join(log_dir, TRACE_FILE)
        self._prof = None
        self._failed = False

    def start(self) -> bool:
        if self.ok or self._failed:
            return self.ok
        try:
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.__enter__()
            self.ok = True
        except (RuntimeError, OSError) as exc:
            self._failed = True
            self._prof = None
            _log.warn(f"trace capture unavailable ({str(exc)[:120]}); "
                      f"continuing without a trace")
        return self.ok

    def stop(self) -> None:
        if not self.ok:
            return
        self.ok = False
        prof, self._prof = self._prof, None
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(self.path)
            _log.log(f"trace -> {self.path}")
        except (RuntimeError, OSError) as exc:
            self._failed = True
            _log.warn(f"trace stop failed ({str(exc)[:120]})")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """try/finally around a :class:`TraceCapture`: the capture is always
    finalised (or cleanly skipped), even when the block raises."""
    cap = TraceCapture(log_dir)
    cap.start()
    try:
        yield cap
    finally:
        cap.stop()


@contextlib.contextmanager
def trace(log_dir: str):
    """A trace of the block into ``log_dir/trace.json``."""
    with device_trace(log_dir):
        yield


def _floating_leaves(tree: Any, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _floating_leaves(v, f"{path}['{k}']")
    elif isinstance(tree, torch.Tensor) and tree.is_floating_point():
        yield path, tree


def finite_check(state) -> Dict[str, bool]:
    """{path: all finite} over every floating leaf of a dict-form state
    (one host readback a leaf: a failure-path diagnostic)."""
    return {name: bool(torch.isfinite(leaf).all())
            for name, leaf in _floating_leaves(state)}


def assert_finite(state, context: str = ""):
    """Raise FloatingPointError naming the offending leaves."""
    bad = [k for k, ok in finite_check(state).items() if not ok]
    if bad:
        where = f" at {context}" if context else ""
        raise FloatingPointError(
            f"non-finite field values{where}: {', '.join(sorted(bad))} "
            f"(check the Courant factor / Drude stability bound)")

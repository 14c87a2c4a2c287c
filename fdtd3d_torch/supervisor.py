"""Durable-run supervisor of the PyTorch port: retry, rollback, the kernel
ladder.

Counterpart of ``fdtd3d_tpu/supervisor.py`` for one unsharded device
(the recovery half of the durable-run layer; ``io.py``'s atomic writer
and checkpoint integrity are the persistence half).
:class:`Supervisor` wraps the ``Simulation.advance`` loop:

* **transient errors** (``RuntimeError``, which CUDA launch failures
  and ``torch.cuda.OutOfMemoryError`` are, and ``OSError``) get bounded
  retry with exponential backoff (the clock is injectable,
  ``RetryPolicy.sleep``), each retry after a rollback to the last good
  snapshot. When the retries run out the error is raised: unsharded,
  there is no topology to shed (the reference's topology ladder is
  ROADMAP.md item A11).
* **health trips** (``FloatingPointError`` from the chunk's finite
  check) roll back to the last committed checkpoint at or before the
  failing step (or the initial in-memory snapshot of a run without a
  cadence) and resume one rung down the kernel ladder, through the
  kernels' escape hatches, pinned for the rest of the supervised run:
  ``packed_tb_*`` -> ``FDTD3D_NO_TEMPORAL`` -> ``packed_*`` ->
  ``FDTD3D_NO_PACKED`` -> ``fused_*`` (or, where the port's
  ``fused_preferred`` names it, as for bf16 and coefficient grids,
  straight to ``pallas3d_*``) -> ``FDTD3D_NO_FUSED`` -> ``pallas3d_*`` ->
  ``use_pallas=False`` -> ``plain``; float32x2 ``packed_ds_*`` (with
  or without magnetic Drude K, which both carry) -> ``plain_ds``; a
  paired complex run the same rungs with its ``complex2x_`` prefix
  (complex float32x2: ``complex2x_packed_ds_*`` ->
  ``complex2x_plain_ds``). A kind is ``*_cuda`` on the card and
  ``*_plain`` on the CPU. A trip at the bottom (``plain``/``plain_ds``,
  the reference's jnp rung) is physics, not a kernel fault, and is
  raised; so is a trip whose escape hatch did not change the kind.
* **simulated preemptions** (``faults.SimulatedPreemption``, a
  ``BaseException``) propagate untouched: the committed checkpoints and
  the CLI's ``--resume auto`` are the recovery. The supervisor persists
  its recovery state (ladder pins, counters) into every cadence
  snapshot (``Simulation.extra_ckpt_meta``), so a supervised resume
  adopts it and a preemption mid-degrade resumes degraded.

A degrade drops the tripped ``Simulation`` before it builds the next
rung's (the rollback restores from a committed snapshot or the host
snapshot, so the tripped state is never read again): the device holds
one carry at a time (``chip_smoke.py`` records the memory while each
rung is built). Every recovery is logged through ``fdtd3d_torch/log.py``
and, when the run has a telemetry sink, written as a ``retry``,
``rollback`` or ``degrade`` record (``chip``/``host`` null: unsharded).
The sink follows the run across a rung swap (handed to the new sim
before the old one is dropped), so a supervised run writes one
``run_start``/``run_end`` pair; the trace capture ends at the first swap,
as the reference's does. Heartbeats and trace-plane spans are ROADMAP.md
item A15.

:func:`run_with_retry` is the stage-shaped flavour of the same bounded
retry (the reference's benchmark harness wraps its stages in it).
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Callable, Dict, Optional

from fdtd3d_torch import log as _log

# Errors treated as transient (retryable). Never FloatingPointError (a
# health trip has its own ladder path) nor faults.SimulatedPreemption
# (a BaseException: a kill is a kill).
TRANSIENT_ERRORS = (RuntimeError, OSError)


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff and an injectable clock.

    ``delay_s(attempt)`` for attempt = 0, 1, 2 ... is
    ``min(backoff_base_s * backoff_factor**attempt, backoff_max_s)``.
    Tests pass ``sleep=`` a fake so no test sleeps."""

    max_retries: int = 3
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    sleep: Callable[[float], None] = time.sleep

    def delay_s(self, attempt: int) -> float:
        return min(self.backoff_base_s * self.backoff_factor ** attempt,
                   self.backoff_max_s)


def run_with_retry(fn, policy: Optional[RetryPolicy] = None,
                   label: str = "", record: Optional[Dict] = None,
                   transient=TRANSIENT_ERRORS):
    """Bounded retry around one stage-shaped callable.

    ``record`` (optional dict) is updated in place with the verdict,
    ``{label, attempts, ok, errors}``, also when the last attempt
    raises. Non-transient exceptions propagate at once."""
    policy = policy or RetryPolicy()
    rec = record if record is not None else {}
    rec.update(label=label, attempts=0, ok=False, errors=[])
    while True:
        rec["attempts"] += 1
        try:
            out = fn()
            rec["ok"] = True
            return out
        except transient as exc:
            rec["errors"].append(
                f"{type(exc).__name__}: {str(exc)[:200]}")
            failed = rec["attempts"] - 1
            if failed >= policy.max_retries:
                raise
            delay = policy.delay_s(failed)
            _log.warn(f"retrying {label or 'stage'} in {delay:.1f}s "
                      f"(attempt {rec['attempts']} failed: "
                      f"{str(exc)[:120]})")
            policy.sleep(delay)


def degrade_plan(kind: str):
    """One rung down the kernel ladder for a sim at ``kind`` (the port's
    kinds, ``*_cuda`` or ``*_plain``).

    -> (environment pins to set, config transform or None), or None at
    the bottom. The pins are the kernels' escape hatches, the levers an
    operator would pull by hand. A paired complex run
    (``complex2x_<leg kind>``) walks its legs' ladder: both legs are
    rebuilt one rung down, so ``complex2x_packed_cuda`` goes to
    ``complex2x_fused_cuda`` or ``complex2x_pallas3d_cuda``, and so on to
    ``complex2x_plain``; ``complex2x_packed_ds_cuda`` (float32x2 legs)
    to ``complex2x_plain_ds``. (The reference's ladder names no complex2x
    kind, so its supervisor raises a complex run's trip without a
    rollback; ROADMAP.md §C.)"""
    kind = kind.replace("complex2x_", "", 1)
    base = kind.rsplit("_", 1)[0] if kind.endswith(("_cuda", "_plain")) \
        else kind
    if base == "packed_tb":
        return {"FDTD3D_NO_TEMPORAL": "1"}, None
    if base in ("packed", "packed_ds"):
        return {"FDTD3D_NO_PACKED": "1"}, None
    if base == "fused":
        return {"FDTD3D_NO_FUSED": "1"}, None
    if base == "pallas3d":
        return {}, lambda cfg: dataclasses.replace(cfg, use_pallas=False)
    return None  # plain / plain_ds: the plain step is the bottom


class Supervisor:
    """Owns a Simulation and drives its horizon durably.

    The supervisor builds the sim from ``cfg`` with ``check_finite``
    forced on (the chunks' finite check is what trips the ladder),
    through ``sim_factory`` when given. ``device`` is the Simulation's
    (cuda unless the caller asks for the CPU).

    After :meth:`run` returns, ``self.sim`` is the current simulation,
    possibly a ladder-degraded replacement of the one it started with."""

    def __init__(self, cfg, policy: Optional[RetryPolicy] = None,
                 sim_factory=None, device=None,
                 resume_state: Optional[Dict] = None):
        self.sim = None
        # the supervisor consumes the finite check: force it on
        self._cfg = dataclasses.replace(cfg, output=dataclasses.replace(
            cfg.output, check_finite=True))
        self.policy = policy or RetryPolicy()
        self._device = device
        self._factory = sim_factory or self._default_factory
        self._saved_env: Dict[str, Optional[str]] = {}
        self._snapshot = None   # initial host-side state (no-cadence runs)
        self.retries = 0
        self.rollbacks = 0
        self.degrades = 0
        if resume_state:
            self._adopt_resume_state(resume_state)

    def _default_factory(self, cfg):
        from fdtd3d_torch.sim import Simulation
        return Simulation(cfg, device=self._device)

    def _adopt_resume_state(self, rs: Dict):
        """Adopt the recovery state a previous supervised run persisted
        into its snapshots (``io.read_checkpoint_meta`` -> "supervisor"):
        re-pin the kernel ladder's escape hatches and seed the counters,
        so a preemption mid-degrade resumes degraded. The port runs
        unsharded, so a persisted topology is not adopted."""
        pins = {k: str(v) for k, v in (rs.get("env_pins") or {}).items()}
        if pins:
            self._pin_env(pins)
            _log.warn(f"supervisor: resuming with persisted "
                      f"kernel-ladder pins {sorted(pins)}")
        self.retries = int(rs.get("retries", 0))
        self.rollbacks = int(rs.get("rollbacks", 0))
        self.degrades = int(rs.get("degrades", 0))

    @property
    def cfg(self):
        """The effective config (check_finite forced on)."""
        return self._cfg

    def ensure_sim(self):
        """Build (once) and return the supervised Simulation; callers
        that need the sim before run() (the CLI restores checkpoints
        into it) go through here, after the resume state is applied."""
        if self.sim is None:
            sim = self._factory(self._cfg)
            if getattr(sim, "mesh", None) is not None:
                raise NotImplementedError(
                    f"a supervised run on the sharded topology "
                    f"{sim.topology} (the supervisor's topology ladder) is "
                    f"not ported to fdtd3d_torch yet (ROADMAP.md queue "
                    f"A11(b)); run it with the reference package fdtd3d_tpu")
            self.sim = sim
            self._persist()
        return self.sim

    # -- durable recovery state -------------------------------------------

    def state_dict(self) -> Dict:
        """The durable recovery state (ladder pins, topology, counters),
        in the reference's keys (its topology rung, always 0 here,
        left out), persisted into every cadence snapshot
        through ``Simulation.extra_ckpt_meta``."""
        pins = {k: os.environ[k] for k in self._saved_env
                if k in os.environ}
        return {
            "env_pins": pins,
            "topology": (list(self.sim.topology)
                         if self.sim is not None else None),
            "step_kind": (self.sim.step_kind
                          if self.sim is not None else None),
            "retries": int(self.retries),
            "rollbacks": int(self.rollbacks),
            "degrades": int(self.degrades),
        }

    def _persist(self):
        if self.sim is not None:
            self.sim.extra_ckpt_meta["supervisor"] = self.state_dict()

    # -- recovery ----------------------------------------------------------

    def _pin_env(self, pins: Dict[str, str]):
        """Set kernel escape hatches for the rest of the supervised run
        (restored in run()'s finally)."""
        for k, v in pins.items():
            if k not in self._saved_env:
                self._saved_env[k] = os.environ.get(k)
            os.environ[k] = v

    def _restore_env(self):
        for k, old in self._saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        self._saved_env.clear()

    def _rollback(self, reason: str, t_max: int) -> str:
        """Restore the current sim to the last good state at or before
        step ``t_max`` (the failure step); returns the source (a
        checkpoint path, or 'initial-snapshot').

        The ``t_max`` guard matters when save_dir still holds snapshots
        of a previous run: a stale one at t > t_max passes every
        metadata guard and would fast-forward this run to the old
        run's state."""
        from fdtd3d_torch.sim import restore_newest
        out = self._cfg.output
        if out.checkpoint_every:
            path = restore_newest(self.sim, out.save_dir, t_max)
            if path is not None:
                return path
        if self._snapshot is None:
            raise RuntimeError(
                f"supervisor: no rollback target for {reason} (no "
                f"committed checkpoint, no initial snapshot)")
        self.sim.adopt_state(self._snapshot)
        return "initial-snapshot"

    def _emit(self, rec_type: str, **fields):
        sink = self.sim.telemetry if self.sim is not None else None
        if sink is not None:
            sink.emit(rec_type, **fields)

    def _swap_sim(self, cfg):
        """Replace the supervised sim by one built on ``cfg`` (the pins
        set, no sink and no trace of its own). The sink is taken from the
        old sim first and handed to the new one (one run_start/run_end
        pair a supervised run), the old sim's trace capture is stopped,
        and the old sim is dropped before the build, so the device holds
        one carry: a degrade's rollback restores from a committed
        snapshot or the host snapshot, never from the tripped state. If
        the build fails, the sink is closed with its run_end."""
        old = self.sim
        sink, old.telemetry = old.telemetry, None
        if old.tracer is not None:
            old.tracer.stop()
        t = old.t
        del old
        self.sim = None
        try:
            self.sim = self._factory(cfg)
        except BaseException:
            if sink is not None:
                sink.close(t=t)
            raise
        self.sim.telemetry = sink

    def _handle_trip(self, exc: FloatingPointError):
        """Health trip: rollback and one rung down the kernel ladder;
        at the bottom, the trip is raised."""
        old_kind = self.sim.step_kind
        plan = degrade_plan(old_kind)
        if plan is None:
            raise exc  # the plain step reproduces it: physics
        pins, cfg_fn = plan
        t_failed = self.sim.t
        reason = f"{type(exc).__name__}: {str(exc)[:200]}"
        self._pin_env(pins)
        cfg = cfg_fn(self._cfg) if cfg_fn is not None else self._cfg
        # the sink follows the run (_swap_sim); the trace ends here
        out = dataclasses.replace(cfg.output, check_finite=True,
                                  telemetry_path=None, profile_dir=None)
        cfg = dataclasses.replace(cfg, output=out, require_pallas=False)
        # the trip's traceback frames (advance's self) would keep the
        # tripped sim alive through the swap: clear their locals
        traceback.clear_frames(exc.__traceback__)
        self._swap_sim(cfg)
        if self.sim.step_kind == old_kind:
            # the escape hatch had no effect: degrading again would loop
            # at this rung forever
            raise exc
        self._cfg = cfg
        self.degrades += 1
        src = self._rollback(reason, t_failed)
        self.rollbacks += 1
        self._emit("rollback", t_failed=int(t_failed),
                   t_restored=int(self.sim.t), source=str(src),
                   reason=reason, chip=None, host=None)
        self._emit("degrade", t=int(self.sim.t), old_kind=old_kind,
                   new_kind=self.sim.step_kind, reason=reason, chip=None,
                   host=None)
        _log.warn(f"supervisor: health trip at t<={t_failed} "
                  f"({str(exc)[:120]}); rolled back to t={self.sim.t} "
                  f"({src}) and degraded {old_kind} -> "
                  f"{self.sim.step_kind}")
        self._persist()

    def _handle_transient(self, exc, consec: int):
        """Transient error: bounded retry with backoff and rollback;
        raised once the retries run out (unsharded: no topology to
        shed)."""
        if consec > self.policy.max_retries:
            raise exc
        t = self.sim.t
        delay = self.policy.delay_s(consec - 1)
        reason = f"{type(exc).__name__}: {str(exc)[:200]}"
        _log.warn(f"supervisor: transient error at t={t} "
                  f"({str(exc)[:120]}); retry {consec}/"
                  f"{self.policy.max_retries} in {delay:.1f}s")
        self._emit("retry", t=int(t), attempt=int(consec),
                   delay_s=float(delay), error=reason, chip=None, host=None)
        self.policy.sleep(delay)
        self.retries += 1
        src = self._rollback(reason, t)
        self.rollbacks += 1
        self._emit("rollback", t_failed=int(t), t_restored=int(self.sim.t),
                   source=str(src), reason=reason, chip=None, host=None)
        self._persist()

    # -- the loop ----------------------------------------------------------

    def run(self, time_steps: Optional[int] = None, interval: int = 0,
            on_interval: Optional[Callable] = None):
        """Advance to the absolute horizon ``time_steps`` durably;
        returns the current sim.

        ``interval``/``on_interval`` mirror ``Simulation.run`` (host work
        between chunks). Recovery granularity is the chunk."""
        total = (time_steps if time_steps is not None
                 else self._cfg.time_steps)
        try:
            self.ensure_sim()
            self._seed_rollback_floor()
            self._persist()
            consec = 0
            # high-water mark of on_interval callbacks: each boundary's
            # callbacks fire exactly once. A rollback re-advancing
            # through boundaries already called must not fire them
            # again, and a failure after a boundary's cadence checkpoint
            # but before its callbacks still gets them (the restored
            # state there is bit-exact).
            done_t = self.sim.t
            while self.sim.t < total:
                n = total - self.sim.t
                if interval:
                    n = min(interval, n)
                try:
                    self.sim.advance(n)
                    consec = 0
                except FloatingPointError as exc:
                    self._handle_trip(exc)
                except TRANSIENT_ERRORS as exc:
                    consec += 1
                    self._handle_transient(exc, consec)
                if on_interval is not None and self.sim.t > done_t:
                    on_interval(self.sim)
                done_t = max(done_t, self.sim.t)
            return self.sim
        finally:
            self._restore_env()

    def _seed_rollback_floor(self):
        """Guarantee a rollback target before the first chunk: a
        committed cadence-style checkpoint at the starting step for a
        cadence run (unless one at t <= start exists), else (or if
        that write fails transiently) an in-memory host snapshot."""
        from fdtd3d_torch import convert, io
        out = self._cfg.output
        if out.checkpoint_every:
            t0 = self.sim.t
            if any(t <= t0 for t, _p in io.find_checkpoints(
                    out.save_dir)):
                return
            try:
                self.sim.checkpoint_now()
                return
            except TRANSIENT_ERRORS as exc:
                _log.warn(f"supervisor: seeding checkpoint failed "
                          f"({exc}); keeping an in-memory snapshot")

        def host(tree):
            if isinstance(tree, dict):
                return {k: host(v) for k, v in tree.items()}
            return tree if isinstance(tree, int) else convert.to_host(tree)

        self._snapshot = host(self.sim._dict_view())

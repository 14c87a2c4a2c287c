"""Deterministic fault injection of the PyTorch port.

A copy of ``fdtd3d_tpu/faults.py`` (its module docstring is the spec)
for the port's one-process, one-device runs. The durable-run layer
(io.py's atomic writes, the checkpoint cadence of ``Simulation`` and the
supervisor's rollback and kernel ladder) is only trustworthy if every
recovery path is provable end to end, so faults fire as deterministic
functions of the run itself (step and write counters), never the wall
clock. A **fault plan** is an ordered list of one-shot faults parsed
from a spec string, installed programmatically (``install``) or through
``FDTD3D_FAULT_PLAN`` in the environment (adopted once per process by
``Simulation.__init__``), in the reference's grammar:

    nan@t=8,field=Ez; preempt@t=16; fail_write@n=2; corrupt_ckpt@n=1

The kinds this port fires:

``nan@t=T[,field=COMP]``
    One NaN at the centre of COMP, written into the live carry at the
    first chunk boundary with ``t >= T`` (after the cadence checkpoint
    of that boundary, so the snapshot stays clean); the next chunk's
    health check raises ``FloatingPointError``.
``preempt@t=T``
    :class:`SimulatedPreemption` (a ``BaseException``, never swallowed by
    ``except Exception``) at the first chunk boundary with ``t >= T``.
``error@t=T[,times=K]``
    :class:`InjectedTransientError` (a ``RuntimeError``) at chunk
    boundaries with ``t >= T``, K times in all.
``fail_write@n=N``
    The Nth write through the atomic writer raises
    :class:`InjectedWriteError` before the file is published.
``corrupt_ckpt@n=N[,mode=truncate|zero]``
    After the Nth committed checkpoint, damage it on disk.

The other kinds and scopes of the grammar parse, and installing a plan
that holds one raises ``NotImplementedError`` naming the ROADMAP.md
item that brings it (never a silent no-op): ``nan ...,chip=``,
``fail_write ...,host=`` and ``host_lost`` need the sharded, multi-host
runs (A11), ``nan ...,lane=`` fault plans on a batch (A13(b)),
``sched_crash`` and ``lease_expire`` the job queue (A15).

All faults are one-shot (``times`` generalises that for ``error``), so a
rolled-back run does not fire them again: a real incident happens once.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

from fdtd3d_torch import log as _log


class SimulatedPreemption(BaseException):
    """Simulated kill between chunks (fault plan ``preempt@t=T``).

    BaseException, not Exception: recovery code that catches broad
    ``Exception`` must not absorb a simulated kill; the fault ends the
    process as a preemption would, leaving only committed
    checkpoints."""


class InjectedTransientError(RuntimeError):
    """Deterministic stand-in for a transient dispatch/runtime error."""


class InjectedWriteError(OSError):
    """The fault plan failed this write before it was published."""


_KINDS = ("nan", "preempt", "error", "fail_write", "corrupt_ckpt",
          "host_lost", "sched_crash", "lease_expire")

# Keys each kind reads: a key the kind would silently ignore is a plan
# that "proves" a scenario that never ran, rejected as loudly as a typo.
_KIND_KEYS = {
    "nan": ("t", "field", "chip", "lane"),
    "preempt": ("t",),
    "error": ("t", "times"),
    "fail_write": ("n", "host"),
    "corrupt_ckpt": ("n", "mode"),
    "host_lost": ("n",),
    "sched_crash": ("job", "between"),
    "lease_expire": ("job",),
}

# the lease-boundary windows of sched_crash@between= (parsed only)
_BETWEEN_WINDOWS = ("acquire,dispatch", "renew,commit")


@dataclasses.dataclass
class Fault:
    kind: str
    t: int = 0            # step threshold (nan / preempt / error)
    field: str = "Ez"     # target component (nan)
    n: int = 0            # ordinal (fail_write: Nth write; corrupt_ckpt:
    #                       Nth committed checkpoint; host_lost: host id)
    times: int = 1        # firings before the fault is spent (error)
    mode: str = "truncate"  # corrupt_ckpt damage mode: truncate | zero
    chip: Optional[int] = None
    host: Optional[int] = None
    lane: Optional[int] = None
    job: Optional[int] = None
    between: Optional[str] = None
    fired: int = 0        # firings so far (one-shot bookkeeping)


def unported_reason(f: Fault) -> Optional[Tuple[str, str]]:
    """(what, ROADMAP.md item) of a fault this port does not fire yet,
    or None when it fires it."""
    if f.kind == "nan" and f.chip is not None:
        return "nan ...,chip= (a chip-scoped fault on a sharded run)", "A11"
    if f.kind == "nan" and f.lane is not None:
        return "nan ...,lane= (a fault plan on a batch)", "A13(b)"
    if f.kind == "fail_write" and f.host is not None:
        return "fail_write ...,host= (multi-writer commits)", "A11"
    if f.kind == "host_lost":
        return "host_lost (multi-writer commits)", "A11"
    if f.kind in ("sched_crash", "lease_expire"):
        return f"{f.kind} (the job queue's scheduler)", "A15"
    return None


class FaultPlan:
    """An ordered list of one-shot faults and the process-wide counters
    the ordinal faults key on."""

    def __init__(self, faults: List[Fault]):
        self.faults = list(faults)
        self.write_count = 0   # atomic writes seen (fail_write)
        self.ckpt_count = 0    # committed checkpoints seen (corrupt_ckpt)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """``kind@k=v,k=v; kind@...`` -> FaultPlan (the reference's
        grammar, every kind and key included)."""
        faults = []
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            kind, _, rest = entry.partition("@")
            kind = kind.strip()
            if kind not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} in plan entry "
                    f"{entry!r} (valid: {', '.join(_KINDS)})")
            f = Fault(kind=kind)
            tokens = [kv.strip() for kv in rest.split(",")]
            i = 0
            while i < len(tokens):
                kv = tokens[i]
                i += 1
                if not kv:
                    continue
                key, _, val = kv.partition("=")
                key, val = key.strip(), val.strip()
                if key == "between" and i < len(tokens) \
                        and "=" not in tokens[i]:
                    # the window pair's second half was split off by
                    # the comma (between=acquire,dispatch): rejoin it
                    val = f"{val},{tokens[i]}"
                    i += 1
                if key in ("t", "n", "times", "chip", "host", "lane",
                           "job", "field", "mode", "between") \
                        and key not in _KIND_KEYS[kind]:
                    raise ValueError(
                        f"fault-plan key {key!r} does not apply to "
                        f"kind {kind!r} in {entry!r} (valid for "
                        f"{kind}: {', '.join(_KIND_KEYS[kind])})")
                if key in ("t", "n", "times", "chip", "host", "lane",
                           "job"):
                    try:
                        setattr(f, key, int(val))
                    except ValueError:
                        raise ValueError(
                            f"fault plan entry {entry!r}: {key} must be "
                            f"an integer, got {val!r}")
                elif key == "between":
                    if val not in _BETWEEN_WINDOWS:
                        raise ValueError(
                            f"fault plan entry {entry!r}: between must "
                            f"be one of "
                            f"{' | '.join(sorted(_BETWEEN_WINDOWS))}, "
                            f"got {val!r}")
                    f.between = val
                elif key in ("field", "mode"):
                    setattr(f, key, val)
                else:
                    raise ValueError(
                        f"unknown fault-plan key {key!r} in {entry!r} "
                        f"(valid: t, n, times, field, mode, chip, "
                        f"host, lane, job, between)")
            if f.mode not in ("truncate", "zero"):
                raise ValueError(
                    f"fault plan entry {entry!r}: mode must be "
                    f"truncate|zero, got {f.mode!r}")
            if kind == "sched_crash" and (f.job is None) \
                    == (f.between is None):
                raise ValueError(
                    f"fault plan entry {entry!r}: sched_crash needs "
                    f"exactly one of job=N or between=<window>")
            if kind == "lease_expire" and f.job is None:
                raise ValueError(
                    f"fault plan entry {entry!r}: lease_expire needs "
                    f"job=N (the dispatch ordinal the zombie window "
                    f"opens at)")
            faults.append(f)
        return cls(faults)


_PLAN: Optional[FaultPlan] = None


def install(plan) -> FaultPlan:
    """Install a plan (spec string or FaultPlan) process-wide. A fault
    this port does not fire raises NotImplementedError naming its
    ROADMAP.md item, and nothing is installed."""
    global _PLAN
    parsed = FaultPlan.parse(plan) if isinstance(plan, str) else plan
    for f in parsed.faults:
        reason = unported_reason(f)
        if reason is not None:
            raise NotImplementedError(
                f"fault plan: {reason[0]} is not ported to fdtd3d_torch "
                f"yet (ROADMAP.md queue {reason[1]})")
    _PLAN = parsed
    return _PLAN


def clear() -> None:
    global _PLAN
    _PLAN = None


def active() -> Optional[FaultPlan]:
    return _PLAN


def load_env() -> Optional[FaultPlan]:
    """Adopt ``FDTD3D_FAULT_PLAN`` once per process (Simulation calls
    this at construction). A plan already installed wins: its fired
    flags record that the incident already happened."""
    spec = os.environ.get("FDTD3D_FAULT_PLAN")
    if spec and _PLAN is None:
        install(spec)
        _log.warn(f"fault plan active (FDTD3D_FAULT_PLAN): {spec}")
    return _PLAN


# --------------------------------------------------------------------------
# hooks (each a no-op when no plan is installed)
# --------------------------------------------------------------------------

def on_write(path: str) -> None:
    """From io's atomic writers, immediately before publish: a
    fail_write fault fires here, so the target is never touched."""
    if _PLAN is None:
        return
    _PLAN.write_count += 1
    for f in _PLAN.faults:
        if f.kind == "fail_write" and not f.fired \
                and _PLAN.write_count == f.n:
            f.fired = 1
            raise InjectedWriteError(
                f"fault plan: atomic write #{f.n} ({path}) failed "
                f"(injected)")


def on_checkpoint(path: str) -> None:
    """From Simulation.checkpoint, after a snapshot committed."""
    if _PLAN is None:
        return
    _PLAN.ckpt_count += 1
    for f in _PLAN.faults:
        if f.kind == "corrupt_ckpt" and not f.fired \
                and _PLAN.ckpt_count == f.n:
            f.fired = 1
            _damage(path, f.mode)


def _damage(path: str, mode: str) -> None:
    """Deliberately corrupt a committed checkpoint on disk."""
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        if mode == "zero":
            fh.seek(size // 2)
            fh.write(b"\0" * min(64, size - size // 2))
        else:
            fh.truncate(max(1, size // 2))
    _log.warn(f"fault plan: corrupted checkpoint {path} ({mode})")


def on_chunk_boundary(sim) -> None:
    """From Simulation.advance, after each chunk (and after the cadence
    checkpoint, so a snapshot at the same ``t`` is clean): fires nan /
    error / preempt faults whose step threshold has been reached."""
    if _PLAN is None:
        return
    t = sim.t
    for f in _PLAN.faults:
        if f.kind == "nan" and not f.fired and t >= f.t:
            f.fired = 1
            _inject_nan(sim, f.field)
        elif f.kind == "error" and f.fired < f.times and t >= f.t:
            f.fired += 1
            raise InjectedTransientError(
                f"fault plan: injected transient error "
                f"#{f.fired}/{f.times} at t={t}")
        elif f.kind == "preempt" and not f.fired and t >= f.t:
            f.fired = 1
            raise SimulatedPreemption(
                f"fault plan: simulated preemption at t={t}")


def _inject_nan(sim, comp: str) -> None:
    """One NaN at the centre of ``comp``, written into the live carry
    through ``Simulation.set_field`` (one cell; no copy of the field)."""
    shape = tuple(sim.component_legs()[0][comp].shape)
    idx = tuple(s // 2 for s in shape)
    sim.set_field(comp, float("nan"), at=idx)
    _log.warn(f"fault plan: injected NaN into {comp} at t={sim.t}")


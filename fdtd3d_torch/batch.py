"""Batched scenario execution: B same-shape runs, one launch per kernel.

Counterpart of ``fdtd3d_tpu/batch.py::BatchSimulation`` on one device.
Many tenants' same-shape jobs share the card by stacking their states
and coefficients under a leading lane axis: the lane-capable kernels
(``csrc/packed_tb.cu``, ``csrc/packed_eh.cu``) advance every lane in one
launch, so a pass costs B lanes' bytes and the host's ops of one. Health
is per lane (``telemetry.make_lane_health_fn``: one pass over the
lane-stacked state and one readback per chunk), so one tenant's NaN
flips only its own lane's flag and never raises. With a telemetry sink
(lane 0's ``OutputConfig.telemetry_path``) each chunk writes one
``batch_lane`` record per lane (that lane's energy, div·E, max |E|/|H|
and finite flag), with ``per_chip_telemetry`` a ``per_chip`` record per
lane, and one aggregate ``chunk`` record; ``run_start`` carries
``batch`` and ``batch_fallback``.

Eligibility, as in the reference: every lane shares the step-shaping
config (``ScenarioSpec.batch_fingerprint``: grid, scheme, dtype, steps,
PML, TFSF geometry, source position and waveform, topology...); lanes
may differ in material values (per-lane coefficient grids) and in the
point-source amplitude (a per-lane device value). The dispatch authority
``solver.batch_fallback_reason`` sends an in-scope batch to the
lane-capable kernels; a batch it gives a token runs the plain step lane
by lane (kind ``plain``), and the token is kept as
``batch_fallback = "batch_unsupported:<token>"``, never silently.
Structure-level divergence between lanes (a sphere turning a scalar
coefficient into a grid in one lane only, a Drude flag adding J) is
caught leaf by leaf with the offending key named. ``FDTD3D_BATCH_MAX``
bounds the lane count.

Not here yet (ROADMAP.md): heartbeats, the run registry and metrics
(A15; ``metrics_path`` raises), the executable cache
(A13), checkpoint/restore of a batch and fault plans on a batch
(A13(b): a batch under ``FDTD3D_FAULT_PLAN`` raises, and so do the CLI's
``--batch`` with the checkpoint and resume flags) and meshes (A11).
The reference's VMEM ladder has no counterpart: the kernels' shared
memory does not depend on the lane count.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from fdtd3d_torch import convert, telemetry
from fdtd3d_torch import log as _log
from fdtd3d_torch.scenario import ScenarioSpec, batch_fingerprint_diff
from fdtd3d_torch.sim import _map_tensors, resolve_device
from fdtd3d_torch.solver import (batch_fallback_reason, build_static,
                                 coeffs_to_device, init_state,
                                 make_chunk_runner)

BATCH_MAX_DEFAULT = 16

# Scalar coefficients that may differ between the lanes of a lane-capable
# batch: the point-source amplitude, a (B,) device tensor. Every other
# scalar is one value for all lanes (the dispatch authority refuses a
# batch whose lanes differ in one with scalar_coeff_divergence).
PER_LANE_SCALARS = ("ps_amp",)


def batch_max() -> int:
    """Lane-count bound (``FDTD3D_BATCH_MAX``; default 16): device memory
    is linear in lanes. Non-numeric values are a named config error."""
    v = os.environ.get("FDTD3D_BATCH_MAX")
    if not v:
        return BATCH_MAX_DEFAULT
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"FDTD3D_BATCH_MAX={v!r}: must be an "
                         f"integer lane count") from None


def _structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def _leaves(tree: Any, keys: tuple = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, keys + (k,))
    else:
        yield keys, tree


def _path(keys) -> str:
    return "".join(f"[{k!r}]" for k in keys)


def _stack_trees(trees: List[Dict], what: str,
                 stack: Callable[[str, List[Any]], Any]) -> Dict:
    """Stack a list of lane trees (nested dicts of numpy leaves) leaf by
    leaf with ``stack(path, lane_values)``, naming the first structurally
    divergent leaf: the batch eligibility backstop for everything shapes
    can catch."""
    t0 = _structure(trees[0])
    for i, t in enumerate(trees[1:], start=1):
        ti = _structure(t)
        if ti != t0:
            raise ValueError(
                f"batch lanes are not same-shape: lane {i}'s {what} "
                f"tree structure differs from lane 0's ({sorted(ti)} vs "
                f"{sorted(t0)}) — material/source STRUCTURE (Drude "
                f"flags, grids vs scalars) must match across the batch")
    leaves = [list(_leaves(t)) for t in trees]
    for i in range(1, len(trees)):
        for (keys, a), (_k, b) in zip(leaves[0], leaves[i]):
            if np.shape(a) != np.shape(b) or \
                    np.asarray(a).dtype != np.asarray(b).dtype:
                raise ValueError(
                    f"batch lanes are not same-shape: {what} leaf "
                    f"{_path(keys)} "
                    f"is {np.shape(b)}/{np.asarray(b).dtype} in lane {i} "
                    f"vs {np.shape(a)}/{np.asarray(a).dtype} in lane 0 "
                    f"(a sphere/file turning a scalar coefficient into a "
                    f"grid must do so in EVERY lane)")
    out: Dict = {}
    for n, (keys, _) in enumerate(leaves[0]):
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = stack(_path(keys), [lv[n][1] for lv in leaves])
    return out


def stack_lane_coeffs(lane_coeffs: List[Dict[str, Any]],
                      device) -> Dict[str, Any]:
    """The lanes' host coefficient dicts -> the lane-capable step's
    device coefficients: a scalar of ``PER_LANE_SCALARS`` becomes a (B,)
    tensor, any other scalar (equal in every lane) a host float (as
    ``coeffs_to_device`` keeps it), a grid a (B, n1, n2, n3) tensor
    filled lane by lane, and a 1-D array (geometry, CPML profiles, the
    incident line's coefficients: step-shaping) one tensor, which must be
    equal in every lane."""

    def stack(path: str, vals: List[Any]):
        v0 = vals[0]
        if np.ndim(v0) == 0:
            if path in [_path((k,)) for k in PER_LANE_SCALARS]:
                return torch.tensor(
                    np.asarray(vals, dtype=np.asarray(v0).dtype),
                    device=device)
            if any(not np.array_equal(v, v0) for v in vals[1:]):
                raise ValueError(
                    f"batch lanes differ in the scalar coefficient {path}, "
                    f"which the lane-capable kernels share between lanes "
                    f"(solver.batch_fallback_reason: "
                    f"scalar_coeff_divergence)")
            return float(v0)
        if np.ndim(v0) >= 3:
            out = torch.empty((len(vals),) + np.shape(v0),
                              dtype=torch.from_numpy(np.asarray(v0)).dtype,
                              device=device)
            for lane, v in enumerate(vals):
                out[lane].copy_(torch.from_numpy(np.ascontiguousarray(v)))
            return out
        if any(not np.array_equal(v, v0) for v in vals[1:]):
            raise ValueError(
                f"batch lanes differ in the coefficient {path}, which the "
                f"step shares between lanes (geometry, CPML or incident "
                f"line)")
        return torch.from_numpy(np.ascontiguousarray(v0)).to(device)

    return _stack_trees(lane_coeffs, "coeffs", stack)


def _lane_tree(tree: Dict[str, Any], lane: int) -> Dict[str, Any]:
    """One lane of a lane-stacked dict-form state (views; ``t`` as is)."""
    if isinstance(tree, dict):
        return {k: _lane_tree(v, lane) for k, v in tree.items()}
    return tree[lane] if isinstance(tree, torch.Tensor) else tree


def _copy_into(dst: Any, src: Any) -> None:
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_into(v, src[k])
        elif isinstance(v, torch.Tensor):
            v.copy_(src[k])


def make_plain_lane_runner(static, device, health: bool = False,
                           per_chip: bool = False):
    """The token path: run_chunk(state, lane_coeffs, n) runs the plain
    step (the port's oracle) over each lane of a lane-stacked dict-form
    state in turn, with each lane's own coefficients; health as the
    lane-capable runner's."""
    solo = make_chunk_runner(static, device)
    health_fn = telemetry.make_lane_health_fn(static, per_chip=per_chip) \
        if health else None

    def run_chunk(state, lane_coeffs, n: int):
        for lane, coeffs in enumerate(lane_coeffs):
            view = _lane_tree(state, lane)
            _copy_into(view, solo(view, coeffs, n))
        state["t"] = state["t"] + n
        if health_fn is not None:
            return state, health_fn(state)
        return state

    run_chunk.health = health_fn is not None
    run_chunk.kind = solo.kind
    run_chunk.diag = solo.diag
    run_chunk.packed = False
    return run_chunk


class BatchSimulation:
    """B same-shape scenarios advancing together on one device.

    The state carries a leading lane axis on every leaf;
    ``lane_state(i)`` is one tenant's view. Health is per lane:
    ``lane_finite[i]`` / ``lane_first_unhealthy_t[i]``; a NaN in one
    lane never raises (the other tenants' results must survive), it
    flips that lane's flag and the run goes on.
    """

    def __init__(self, cfgs, device=None):
        from fdtd3d_torch import faults
        if faults.load_env() is not None:
            raise NotImplementedError(
                "fault plans on a batch (per-lane fault scopes and "
                "hooks) are not ported to fdtd3d_torch yet (ROADMAP.md "
                "queue A13(b))")
        specs = [c if isinstance(c, ScenarioSpec) else ScenarioSpec(c)
                 for c in cfgs]
        if not specs:
            raise ValueError("batch needs at least one scenario")
        limit = batch_max()
        if len(specs) > limit:
            raise ValueError(
                f"batch of {len(specs)} lanes exceeds the "
                f"FDTD3D_BATCH_MAX bound ({limit}); split the batch "
                f"or raise the knob")
        fp0 = specs[0].batch_fingerprint()
        for i, sp in enumerate(specs[1:], start=1):
            diff = batch_fingerprint_diff(fp0, sp.batch_fingerprint())
            if diff:
                raise ValueError(
                    f"batch lanes 0 and {i} differ in the "
                    f"graph-shaping config field {diff}; only "
                    f"material values, source amplitude and output "
                    f"settings may vary across a batch")
        self.specs = specs
        self.batch_size = B = len(specs)
        cfg0 = specs[0].cfg
        self.cfg = cfg0
        if cfg0.ds_fields:
            raise ValueError(
                "float32x2 scenarios do not batch: the double-single "
                "step has no lane-capable kernel (the reference refuses "
                "them too) — run ds scenarios solo")
        if cfg0.complex_fields:
            # the reference's message (fdtd3d_tpu/batch.py:158); the port
            # rejects native complex lanes too: no lane-capable step
            # runs complex arithmetic
            raise ValueError(
                "batched execution does not support the paired-"
                "complex path (its complex<->paired conversion routes "
                "through host numpy, which cannot run under vmap); "
                "run complex batches on a backend with native complex")
        out0 = cfg0.output
        if out0.metrics_path:
            raise NotImplementedError(
                "the metrics exposition of a batch is not ported to "
                "fdtd3d_torch yet (ROADMAP.md queue A15)")
        self.device = resolve_device(device)
        self.static = specs[0].static
        self.topology = tuple(self.static.topology)
        if max(self.topology) > 1:
            raise NotImplementedError(
                f"a batch on the sharded topology {self.topology} is not "
                f"ported to fdtd3d_torch yet (ROADMAP.md queue A11(b)); "
                f"run it with the reference package fdtd3d_tpu")
        self._check_finite = out0.check_finite
        health = bool(out0.telemetry_path) or out0.check_finite
        per_chip = health and bool(out0.per_chip_telemetry) \
            and bool(out0.telemetry_path)

        # every lane's coefficients from ITS config (material values and
        # ps_amp differ); the dispatch authority's scalar sweep reads them
        lane_coeffs = [sp.build_coeffs(sp.static) for sp in specs]
        token = batch_fallback_reason(self.static, self.device,
                                      lane_coeffs=lane_coeffs, batch=B)
        self.batch_fallback: Optional[str] = \
            None if token is None else f"batch_unsupported:{token}"
        if token is None:
            self._runner = make_chunk_runner(
                self.static, self.device, health=health, batch=B,
                per_chip=per_chip)
            self._coeffs: Any = stack_lane_coeffs(lane_coeffs, self.device)
        else:
            self.static = build_static(
                dataclasses.replace(cfg0, use_pallas=False))
            self._runner = make_plain_lane_runner(
                self.static, self.device, health=health, per_chip=per_chip)
            _stack_trees(lane_coeffs, "coeffs", lambda path, vals: None)
            self._coeffs = [coeffs_to_device(lc, self.device)
                            for lc in lane_coeffs]
        del lane_coeffs
        self.step_kind: str = self._runner.kind
        self.step_diag = self._runner.diag
        self._packed = bool(self._runner.packed)
        # zeros made directly in the carry's form (lane-leading)
        shapes = _map_tensors(init_state(self.static, "meta"),
                              lambda t: torch.empty((B,) + tuple(t.shape),
                                                    dtype=t.dtype,
                                                    device="meta"))
        if self._packed:
            shapes = self._runner.pack(shapes)
        self._carry = _map_tensors(shapes, lambda t: torch.zeros(
            t.shape, dtype=t.dtype, device=self.device))
        # per-lane health: None = never measured, True/False = the last
        # chunk's finite flag; the first unhealthy t bound per lane
        self.lane_finite: List[Optional[bool]] = [None] * B
        self.lane_first_unhealthy_t: List[Optional[int]] = [None] * B
        self._cells = float(np.prod([self.static.grid_shape[a] for a in
                                     self.static.mode.active_axes]))
        self._chunk_idx = 0
        self._closed = False
        self.telemetry: Optional[telemetry.TelemetrySink] = None
        if out0.telemetry_path:
            self.telemetry = telemetry.TelemetrySink(
                out0.telemetry_path, run_meta=telemetry.provenance(self))

    # -- stepping ----------------------------------------------------------

    def advance(self, n_steps: int):
        """One chunk for every lane at once. Never raises on a lane's
        NaN: per-lane flags carry the verdict; ``check_finite`` turns a
        trip into a per-lane warning."""
        if n_steps <= 0:
            return self
        t_prev = self.t
        timed = self.telemetry is not None
        if timed:
            self.block_until_ready()
            t0 = time.perf_counter()
        with telemetry.span("chunk"):
            out = self._runner(self._carry, self._coeffs, n_steps)
        health = None
        if self._runner.health:
            out, health = out
        self._carry = out
        wall = 0.0
        if timed:
            self.block_until_ready()
            wall = time.perf_counter() - t0
        self._chunk_idx += 1
        if health is not None:
            self._readback(health, t_prev, n_steps, wall)
        return self

    def _readback(self, health, t_prev: int, n_steps: int,
                  wall: float) -> None:
        """ONE device->host transfer of the per-lane health counters:
        the lanes' verdicts, and with a sink their batch_lane rows (and
        per-chip rows) and the aggregate chunk record."""
        hv = telemetry.readback(health)
        tripped = []
        for lane, finite in enumerate(hv["finite"]):
            self.lane_finite[lane] = finite
            if not finite and self.lane_first_unhealthy_t[lane] is None:
                self.lane_first_unhealthy_t[lane] = self.t
                tripped.append(lane)
        if self.telemetry is not None:
            self._emit_lanes(hv, n_steps, wall)
        if tripped and self._check_finite:
            _log.warn(
                f"batch: non-finite fields in lane(s) {tripped} (first "
                f"bad step in ({t_prev}, {self.t}]); the other "
                f"{self.batch_size - len(tripped)} lane(s) continue — "
                f"per-lane verdicts in lane_finite")

    def _emit_lanes(self, hv: Dict[str, Any], n_steps: int,
                    wall: float) -> None:
        sink, idx, t = self.telemetry, self._chunk_idx, self.t
        per = hv.get("per_chip")
        for lane in range(self.batch_size):
            sink.emit("batch_lane", chunk=idx, t=t, lane=lane,
                      **{k: hv[k][lane] for k in
                         ("energy", "div_l2", "div_linf", "max_e",
                          "max_h")},
                      finite=bool(hv["finite"][lane]))
            if per is not None:
                chips = {k: per[k][lane] for k in per}
                sink.emit("per_chip", chunk=idx, t=t, lane=lane,
                          n_chips=len(chips["energy"]), counters=chips)
                imb = telemetry.imbalance_summary(chips)
                if imb is not None:
                    sink.emit("imbalance", chunk=idx, t=t, lane=lane,
                              **imb)
        # one aggregate chunk record beside the lane rows, so the
        # reference's report tools read a batch's throughput unchanged
        energies = [v for v in hv["energy"] if v is not None]
        agg = {"energy": math.fsum(energies) if energies else None,
               "finite": all(hv["finite"])}
        for k in ("div_l2", "div_linf", "max_e", "max_h"):
            vals = [v for v in hv[k] if v is not None]
            agg[k] = max(vals) if vals else None
        sink.emit_chunk(chunk=idx, t=t, steps=n_steps, wall_s=wall,
                        cells=self._cells * self.batch_size, health=agg)

    def close_telemetry(self):
        """Write the sink's run_end (aggregate Mcells/s) and close it;
        idempotent, a no-op without a sink."""
        if self.telemetry is None:
            return self
        w = self.telemetry.wall_total
        mcps = self._cells * self.batch_size * self.telemetry.steps_total \
            / w / 1e6 if w > 0 else 0.0
        self.telemetry.close(t=self.t, mcells_per_s=mcps)
        return self

    def close(self):
        """Close the sink (run_end); idempotent."""
        if not self._closed:
            self._closed = True
            self.close_telemetry()
        return self

    def run(self, time_steps: Optional[int] = None, chunk: int = 0):
        """Advance every lane ``time_steps`` (default: the shared
        cfg.time_steps) in ``chunk``-step chunks (0 = one chunk)."""
        total = time_steps if time_steps is not None \
            else self.cfg.time_steps
        step = chunk if chunk and chunk > 0 else total
        done = 0
        while done < total:
            n = min(step, total - done)
            self.advance(n)
            done += n
        return self

    # -- access ------------------------------------------------------------

    def _dict_view(self) -> Dict[str, Any]:
        """The lane-stacked dict-form view of the live carry (views)."""
        if self._packed:
            return self._runner.unpack(self._carry)
        return self._carry

    @property
    def state(self) -> Dict[str, Any]:
        """The lane-stacked dict-form state, every leaf lane-leading, as
        a snapshot (copies)."""
        return _map_tensors(self._dict_view(), torch.clone)

    def lane_state(self, lane: int) -> Dict[str, Any]:
        """One tenant's dict-form state (copies), comparable leaf for
        leaf with a solo Simulation's ``state``."""
        if not 0 <= lane < self.batch_size:
            raise IndexError(f"lane {lane} out of range "
                             f"(batch of {self.batch_size})")
        return _map_tensors(_lane_tree(self._dict_view(), lane),
                            torch.clone)

    def lane_field(self, lane: int, comp: str) -> np.ndarray:
        """One lane's field component as a host numpy array (bf16
        storage widened exactly to float32, as ``Simulation.field``)."""
        group = "E" if comp[0] == "E" else "H"
        return convert.to_host(self._dict_view()[group][comp][lane])

    def set_field(self, comp: str, value):
        """Overwrite one component across the WHOLE batch (``value``
        carries the leading lane axis). It writes through the dict-form
        views into the live carry, so a packed carry holds it at once."""
        view = self._dict_view()
        group = "E" if comp[0] == "E" else "H"
        if comp not in view[group]:
            raise KeyError(f"{comp} not active in scheme "
                           f"{self.cfg.scheme}")
        dst = view[group][comp]
        src = convert.from_host(value)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(
                f"set_field on a batch needs the lane-leading shape "
                f"{tuple(dst.shape)}, got {tuple(src.shape)}")
        dst.copy_(src.to(dtype=dst.dtype))
        return self

    def verify_final_lanes(self):
        """Finite sweep of the FINAL fields per lane, the end-of-run
        verdict: damage after the last chunk's measurement (or with the
        health reduction off) is recorded too. One reduction per field
        stack (the carry's own contiguous tensors, so nothing the size of
        a field is copied) and one readback."""
        if self._packed:
            stacks = [self._carry["E"], self._carry["H"]]
        else:
            stacks = [v for g in ("E", "H") for v in self._carry[g].values()]
        health = torch.stack([telemetry.lane_max_abs(v)
                              for v in stacks]).amax(dim=0)
        for lane, good in enumerate(telemetry.lanes_finite(health)):
            if not good:
                self.lane_finite[lane] = False
                if self.lane_first_unhealthy_t[lane] is None:
                    self.lane_first_unhealthy_t[lane] = self.t
            elif self.lane_finite[lane] is None:
                self.lane_finite[lane] = True
        return self

    @property
    def t(self) -> int:
        return int(self._carry["t"])

    def block_until_ready(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

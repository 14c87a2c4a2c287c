"""High-level Simulation of the PyTorch port.

Counterpart of ``fdtd3d_tpu/sim.py::Simulation``: owns the state and
the coefficients and advances the leapfrog in chunks, on one device or,
on a sharded topology, one shard a device of a list (``devices``; the
class docstring).
With ``OutputConfig.check_finite`` or a telemetry sink
(``OutputConfig.telemetry_path``) every chunk ends with the health pass
of ``fdtd3d_torch/telemetry.py`` (energy, div·E, max |E|/|H| and the
non-finite flag over every floating leaf, float32x2 lo words and J/K
included) and one readback of its scalars; check_finite raises on a
non-finite chunk, the sink records a ``chunk`` record (and with
``per_chip_telemetry`` the ``per_chip`` vectors and their
``imbalance``). ``OutputConfig.profile`` attaches a
``profiling.StepClock`` (``sim.clock``), and ``profile_dir`` a
``profiling.TraceCapture`` started at the first ``advance``; a timed
chunk is bracketed by device syncs. ``close`` finalises both and writes
the sink's ``run_end``: callers hold it in a ``finally``.

The device is an explicit argument: ``Simulation(cfg)`` runs on the
current CUDA device and raises when there is none;
``Simulation(cfg, device="cpu")`` runs on the CPU. The live carry is
updated in place by the packed steps, and the temporal-blocked pass
swaps its buffers with a spare set every pass, so ``state`` returns a
snapshot (copies), ``set_field`` writes into the live carry, and a view
from ``component_views`` holds until the next ``advance``.

Checkpoints (``checkpoint``/``restore``, the ``checkpoint_every``
cadence with its keep-K rotation) are the reference's npz files, which
either package restores (``fdtd3d_torch/io.py``). ``checkpoint`` streams
the live carry's leaves to the file one at a time, and ``restore``
copies the loaded leaves into the live carry in place (as ``set_field``
does), so neither holds a second copy of the state on the device. A
resumed run is bit-equal to the uninterrupted one when its chunks end
at the same steps: the temporal-blocked pass advances two steps a call
and an odd chunk ends with a packed step (the CLI's chunk interval
includes ``checkpoint_every``, as the reference's does). The chunk
boundary's hooks run in the reference's order: the cadence checkpoint,
then the fault plan (``fdtd3d_torch/faults.py``, adopted from
``FDTD3D_FAULT_PLAN`` at construction).
"""

from __future__ import annotations

import os
import time
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from fdtd3d_torch import convert, io, profiling, telemetry
from fdtd3d_torch import faults as _faults
from fdtd3d_torch import log as _log
from fdtd3d_torch.parallel import mesh as pmesh
from fdtd3d_torch.solver import (StaticSetup, build_coeffs, build_static,
                                 coeffs_to_device, config_topology,
                                 init_state, make_chunk_runner, slab_axes)

_AXES_STR = "xyz"


def ckpt_meta_mismatch(cfg, extra) -> Optional[str]:
    """The configuration-level snapshot guards (scheme, grid size,
    dtype): None when compatible, else the message
    (``fdtd3d_tpu/sim.py::ckpt_meta_mismatch``). One predicate shared by
    :meth:`Simulation._check_ckpt_meta` (which raises it) and the CLI's
    supervised-resume peek (which skips the snapshot); the carry-family
    guard needs a live sim and stays in ``_check_ckpt_meta``."""
    if extra.get("scheme") not in (None, cfg.scheme):
        return (f"checkpoint scheme {extra.get('scheme')!r} != "
                f"config scheme {cfg.scheme!r}")
    if "size" in extra and tuple(extra["size"]) != tuple(cfg.size):
        return (f"checkpoint grid size {tuple(extra['size'])} != "
                f"config size {tuple(cfg.size)}")
    if extra.get("dtype") not in (None, cfg.dtype):
        return (f"checkpoint dtype {extra.get('dtype')!r} != config "
                f"dtype {cfg.dtype!r}; resume on the same dtype "
                f"(the state carries dtype-specific companions — ds lo "
                f"words, compensated residuals — that do not convert)")
    return None


# what makes a committed snapshot unusable for a resume or a rollback:
# damaged bytes, a failed guard, a file gone between listing and reading
CKPT_UNUSABLE = (io.CheckpointCorrupt, ValueError, OSError)


def checkpoint_candidates(cfg, save_dir: str, t_max: int):
    """The committed snapshots in ``save_dir`` a run of ``cfg`` may
    resume from, newest first, as (path, metadata): those at
    t <= ``t_max`` (a later one is a previous run's leftover; it passes
    every guard, time_steps is not in the metadata, and would
    fast-forward this run to the old run's state) whose metadata reads
    and passes :func:`ckpt_meta_mismatch`. The walk of ``--resume auto``,
    of the supervised resume's peek and of the supervisor's rollback."""
    for t, path in io.find_checkpoints(save_dir):
        if t > t_max:
            _log.warn(f"skipping {path}: t={t} is past the horizon "
                      f"({t_max})")
            continue
        try:
            meta = io.read_checkpoint_meta(path)
            reason = ckpt_meta_mismatch(cfg, meta)
        except CKPT_UNUSABLE as exc:
            reason = str(exc)
        if reason:
            _log.warn(f"skipping unusable checkpoint {path}: {reason}")
            continue
        yield path, meta


def restore_newest(sim, save_dir: str, t_max: int) -> Optional[str]:
    """Restore ``sim`` from the newest usable committed snapshot at
    t <= ``t_max`` (:func:`checkpoint_candidates`, then the full load's
    integrity and carry-family checks); -> its path, or None when no
    snapshot is usable."""
    for path, _meta in checkpoint_candidates(sim.cfg, save_dir, t_max):
        try:
            sim.restore(path)
            return path
        except CKPT_UNUSABLE as exc:
            _log.warn(f"skipping unusable checkpoint {path}: {exc}")
    return None


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; a CUDA device
    that is not there is an error, never a quiet run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fdtd3d_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' (CLI: --device cpu) to "
                "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def _map_tensors(tree: Any, fn: Callable) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _install(dsts, src: torch.Tensor) -> None:
    """Copy ``src`` into the live carry: into ``dsts[0]`` as it is, or
    for the two legs of a paired complex run its real part into the re
    leg and its imaginary part (zero for a real ``src``) into the im
    leg."""
    if len(dsts) == 1:
        dsts[0].copy_(src.to(dtype=dsts[0].dtype))
        return
    re, im = dsts
    if src.is_complex():
        re.copy_(src.real)
        im.copy_(src.imag)
    else:
        re.copy_(src.to(dtype=re.dtype))
        im.zero_()


class _JoinedViews(Mapping):
    """The component views of a paired complex run: each component
    joined from its re and im leg views (``torch.complex``) when it is
    read, so a reader holds one joined component at a time."""

    def __init__(self, re: Dict[str, torch.Tensor],
                 im: Dict[str, torch.Tensor]):
        self._re, self._im = re, im

    def __getitem__(self, comp):
        return torch.complex(self._re[comp], self._im[comp])

    def __iter__(self):
        return iter(self._re)

    def __len__(self):
        return len(self._re)


class _ShardedComponents(Mapping):
    """The field components of a decomposed run, each joined from the
    shards' pieces onto the first shard's device when it is read (new
    tensors: read them, write through ``set_field``)."""

    def __init__(self, sim):
        self._sim = sim
        mode = sim.static.mode
        self._names = list(mode.e_components) + list(mode.h_components)

    def __getitem__(self, comp):
        views = self._sim._shard_views()
        grp = "E" if comp in views[0]["E"] else "H"
        return self._sim.mesh.join_leaf(
            comp, [v[grp][comp] for v in views], self._sim.device)

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)


class Simulation:
    """Owns solver state + coefficients; advances the leapfrog in chunks.

    ``devices`` (a list of devices, repeats allowed) places one shard of
    a decomposed run on each entry, in the mesh's order: the topology is
    the configuration's (``ParallelConfig``; "auto" over the list's
    length, or the configuration's ``n_devices``). Without it a sharded
    configuration takes the visible CUDA cards, or on the CPU
    ``parallel.mesh.CPU_SHARDS`` shards ("auto" without a count: the
    visible cards, one on the CPU). A sharded
    run holds each shard's state and coefficients on its device
    (``self.mesh``, ``self.coeffs`` a list of per-shard dicts), steps
    through ``ops/packed.py::make_sharded_packed_step`` (float32x2:
    ``ops/packed_ds.py::make_sharded_packed_ds_step``; where the
    reference takes its two-pass kernels,
    ``ops/pallas3d.py::make_sharded_pallas_step``), and reads and
    writes the global view: ``field``/``fields``/``sample``/
    ``set_field``, ``state`` (a joined copy), ``checkpoint`` (the
    reference's sharded layout, joined leaf by leaf) and ``restore``/
    ``adopt_state`` (resharding a snapshot of another topology)."""

    def __init__(self, cfg, device=None, devices=None):
        self.cfg = cfg
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
            if not devices:
                raise ValueError("devices: an empty list")
            self.device = devices[0]
        else:
            self.device = resolve_device(device)
        # the deterministic fault plan (fdtd3d_torch/faults.py): adopt
        # FDTD3D_FAULT_PLAN once per process; a no-op otherwise
        _faults.load_env()
        avail = len(devices) if devices is not None \
            else pmesh.auto_count(self.device.type)
        topo = config_topology(cfg, n_devices=avail)
        self.static: StaticSetup = build_static(cfg, self.device,
                                                topology=topo)
        # the checkpoint metadata's topology, and the one the supervisor
        # persists
        self.topology = tuple(self.static.topology)
        self.mesh: Optional[pmesh.ShardMesh] = None
        coeffs_np = build_coeffs(self.static)
        if max(self.topology) > 1:
            self.mesh = pmesh.ShardMesh(
                self.topology, self.static.grid_shape,
                devices if devices is not None
                else pmesh.default_devices(self.device))
            self.coeffs = [coeffs_to_device(piece, self.mesh.devices[r])
                           for r, piece in enumerate(
                               self.mesh.split(coeffs_np, coeff=True))]
        else:
            self.coeffs = coeffs_to_device(coeffs_np, self.device)
        out = cfg.output
        self._check_finite = out.check_finite
        # the health pass rides every chunk when the finite check or a
        # sink wants it: one reduction and one readback a chunk
        health = bool(out.telemetry_path) or out.check_finite
        self._runner = make_chunk_runner(
            self.static, self.device, health=health,
            per_chip=health and bool(out.per_chip_telemetry)
            and bool(out.telemetry_path), mesh=self.mesh)
        self.step_kind: str = self._runner.kind
        # kernel diagnostics: the temporal-blocking depth, or why the
        # temporal-blocked pass did not engage (tb_fallback)
        self.step_diag = self._runner.diag
        if cfg.require_pallas and self.step_kind.replace(
                "complex2x_", "", 1) not in (
                "packed_tb_cuda", "packed_cuda", "packed_ds_cuda",
                "fused_cuda", "pallas3d_cuda"):
            raise ValueError(
                f"require_pallas is set but the CUDA kernels did not "
                f"engage (step_kind={self.step_kind}, device="
                f"{self.device})")
        self._chunk_idx = 0
        self._ckpt_last_t = 0
        # durable per-run facts riding every checkpoint's metadata (the
        # supervisor persists its recovery state here)
        self.extra_ckpt_meta: Dict[str, Any] = {}
        # zeros made directly in the carry's form: building the dict
        # form first and packing it would hold the fields twice
        with telemetry.span("pack"):
            if self.mesh is not None:
                self._carry = self._sharded_zeros()
            else:
                shapes = init_state(self.static, "meta")
                if self._runner.packed:
                    shapes = self._runner.pack(shapes)
                self._carry = _map_tensors(shapes, lambda t: torch.zeros(
                    t.shape, dtype=t.dtype, device=self.device))
        self._cells = float(np.prod([self.static.grid_shape[a] for a in
                                     self.static.mode.active_axes]))
        self.clock = profiling.StepClock() if out.profile else None
        self.telemetry: Optional[telemetry.TelemetrySink] = None
        if out.telemetry_path:
            self.telemetry = telemetry.TelemetrySink(
                out.telemetry_path, run_meta=telemetry.provenance(self))
        # the trace capture starts at the first advance (a construction
        # failure leaves no profiler session) and stops in close()
        self.tracer: Optional[profiling.TraceCapture] = None
        if out.profile_dir:
            self.tracer = profiling.TraceCapture(out.profile_dir)
        self._closed = False

    # -- state representation ---------------------------------------------

    def _sharded_zeros(self) -> Dict[str, Any]:
        """The zero carry of a decomposed run: the step's form (packed,
        or the two-pass step's dict form), made shard by shard on each
        shard's device."""
        return {"shards": pmesh.sharded_zeros(self.static, self.mesh,
                                              self._runner.pack_shard),
                "t": 0}

    def _shard_views(self):
        """The shards' dict-form views of the live carry (a list)."""
        return self._runner.unpack(self._carry)

    def _dict_view(self) -> Dict[str, Any]:
        """Dict-form view of the live carry (no copies); of a paired
        complex carry, the complex state joined from its legs, of a
        decomposed run the global state joined from the shards (new
        tensors: read it, do not write into it)."""
        if self.mesh is not None:
            return self._runner.join(self._carry, self.device)
        if self._runner.packed:
            return self._runner.unpack(self._carry)
        return self._carry

    def _leg_views(self):
        """The dict-form views of the live carry's real legs: two for a
        paired complex run (re, im), else the one dict form."""
        if self._runner.legs is not None:
            return self._runner.legs(self._carry)
        return [self._dict_view()]

    def component_legs(self):
        """Every stored field component (E then H) of each leg
        (:meth:`_leg_views`) as views of the live carry: ``[re, im]``
        of a paired complex run, else ``[component_views()]``; of a
        decomposed run the components joined as they are read."""
        if self.mesh is not None:
            return [_ShardedComponents(self)]
        return [{c: v for g in ("E", "H") for c, v in view[g].items()}
                for view in self._leg_views()]

    @property
    def state(self) -> Dict[str, Any]:
        """The solver state in dict form, as a snapshot (copies)."""
        return _map_tensors(self._dict_view(), torch.clone)

    @state.setter
    def state(self, value: Dict[str, Any]):
        """Install a dict-form state (tensors or numpy arrays, with the
        keys and shapes of ``init_state``) into the live carry in place
        (:meth:`adopt_state`)."""
        self.adopt_state(value)

    def component_views(self):
        """Every stored field component (E then H) as a view of the live
        carry: with float32x2 fields, the hi words (as the reference's
        ``field``/``fields`` return them). A paired complex run's
        components are joined from its legs one at a time, as each is
        read (new tensors: read them, write through ``set_field``)."""
        legs = self.component_legs()
        if len(legs) == 1:
            return legs[0]
        return _JoinedViews(*legs)

    # -- stepping ----------------------------------------------------------

    def advance(self, n_steps: int):
        """Advance n_steps. A timed chunk (a clock or a sink) is
        bracketed by device syncs; the health pass is read back once,
        after the wall is taken. With check_finite, a chunk whose fields
        went non-finite raises FloatingPointError naming the components
        and the first-bad-step bound (after its chunk record)."""
        if n_steps <= 0:
            return self
        if self.tracer is not None:
            self.tracer.start()   # idempotent; degrades to a no-op
        t_prev = self.t
        timed = self.clock is not None or self.telemetry is not None
        if timed:
            self.block_until_ready()
            t0 = time.perf_counter()
        with telemetry.span("chunk"):
            out = self._runner(self._carry, self.coeffs, n_steps)
        health = None
        if self._runner.health:
            out, health = out
        self._carry = out
        wall = 0.0
        if timed:
            self.block_until_ready()
            wall = time.perf_counter() - t0
            if self.clock is not None:
                self.clock.record(n_steps, wall, self._cells)
        hv = telemetry.readback(health) if health is not None else None
        self._chunk_idx += 1
        if self.telemetry is not None and hv is not None:
            self._emit_chunk(n_steps, wall, hv)
        if hv is not None and not hv["finite"] and self._check_finite:
            bad = sorted(self._nonfinite_leaves())
            names = ", ".join(bad) if bad else "unknown"
            err = FloatingPointError(
                f"non-finite field values tripped the health "
                f"reduction in chunk {self._chunk_idx}: first bad "
                f"step in ({t_prev}, {self.t}]; components: {names} "
                f"(check the Courant factor / Drude stability bound)")
            err.bad_components = bad
            raise err
        # the chunk boundary's hooks, after the health check (a tripped
        # chunk never commits its state as a good snapshot): the cadence
        # checkpoint, then the fault plan (a snapshot at this t stays
        # clean of an injected NaN, and a preemption leaves it committed)
        self._maybe_auto_checkpoint()
        if _faults.active() is not None:
            _faults.on_chunk_boundary(self)
        return self

    def _emit_chunk(self, n_steps: int, wall: float, hv: Dict[str, Any]):
        """The chunk record, and the per-chip vectors with their
        imbalance summary, from one readback."""
        self.telemetry.emit_chunk(chunk=self._chunk_idx, t=self.t,
                                  steps=n_steps, wall_s=wall,
                                  cells=self._cells, health=hv)
        per_chip = hv.get("per_chip")
        if per_chip is not None:
            self.telemetry.emit(
                "per_chip", chunk=self._chunk_idx, t=self.t,
                n_chips=len(next(iter(per_chip.values()))),
                counters=per_chip)
            imb = telemetry.imbalance_summary(per_chip)
            if imb is not None:
                self.telemetry.emit("imbalance", chunk=self._chunk_idx,
                                    t=self.t, **imb)

    def close_telemetry(self):
        """Write the sink's run_end record (Mcells/s over the recorded
        chunks) and close it; idempotent, a no-op without a sink."""
        if self.telemetry is None:
            return self
        w = self.telemetry.wall_total
        mcps = self._cells * self.telemetry.steps_total / w / 1e6 \
            if w > 0 else 0.0
        self.telemetry.close(t=self.t, mcells_per_s=mcps)
        return self

    def close(self):
        """Finalise the observability lanes: stop the trace capture
        (writing its file) and close the sink with its run_end record.
        Idempotent: safe on every exit path."""
        if self._closed:
            return self
        self._closed = True
        if self.tracer is not None:
            self.tracer.stop()
        self.close_telemetry()
        return self

    def _nonfinite_leaves(self):
        """Names of the state leaves holding non-finite values in any
        leg or shard (failure path only: a host pass over the state)."""
        seen = set()
        views = self._shard_views() if self.mesh is not None \
            else self._leg_views()
        for view in views:
            for grp, sub in view.items():
                if not isinstance(sub, dict):
                    continue
                for k, v in sub.items():
                    name = k if grp in ("E", "H") else f"{grp}/{k}"
                    if name not in seen \
                            and not bool(torch.isfinite(v).all()):
                        seen.add(name)
                        yield name

    def run(self, time_steps: Optional[int] = None,
            on_interval: Optional[Callable] = None, interval: int = 0):
        """Run the loop; call on_interval(sim) every `interval` steps."""
        total = time_steps if time_steps is not None \
            else self.cfg.time_steps
        if not interval or on_interval is None:
            return self.advance(total)
        done = 0
        while done < total:
            n = min(interval, total - done)
            self.advance(n)
            done += n
            on_interval(self)
        return self

    # -- access ------------------------------------------------------------

    @property
    def t(self) -> int:
        return int(self._carry["t"])

    def sample(self, comp: str, idx):
        """One field value as a python float, or complex for complex
        fields (one small readback a leg; of a decomposed run, from the
        shard that owns the cell)."""
        if self.mesh is not None:
            r, local = self.mesh.owner(idx)
            view = self._shard_views()[r]
            grp = "E" if comp in view["E"] else "H"
            return float(view[grp][comp][local].item())
        vals = [leg[comp][tuple(idx)].item()
                for leg in self.component_legs()]
        if len(vals) == 2:
            return complex(vals[0], vals[1])
        return vals[0] if isinstance(vals[0], complex) else float(vals[0])

    def field(self, comp: str) -> np.ndarray:
        """One field component as a host numpy array: with bf16 storage
        widened exactly to float32 (the reference returns an
        ``ml_dtypes`` bfloat16 array, a type the port does not use)."""
        return convert.to_host(self.component_views()[comp])

    def fields(self) -> Dict[str, np.ndarray]:
        return {c: convert.to_host(v)
                for c, v in self.component_views().items()}

    def set_field(self, comp: str, value, at=None):
        """Overwrite one field component of the live carry, or with
        ``at`` (an index into the component) only those cells; a paired
        complex run takes the value's real part into its re leg and its
        imaginary part (0 for a real value) into its im leg."""
        legs = self.component_legs()
        if comp not in legs[0]:
            raise KeyError(f"{comp} not active in scheme {self.cfg.scheme}")
        if self.mesh is not None:
            # the global component, written and cut back onto the shards
            full = legs[0][comp]
            dst = full if at is None else full[at]
            _install([dst], convert.from_host(np.broadcast_to(
                np.asarray(value), dst.shape)))
            views = self._shard_views()
            grp = "E" if comp in views[0]["E"] else "H"
            for view, piece in zip(views, self.mesh.split({comp: full})):
                view[grp][comp].copy_(piece[comp])
            return self
        dsts = [leg[comp] if at is None else leg[comp][at] for leg in legs]
        src = convert.from_host(np.broadcast_to(np.asarray(value),
                                                dsts[0].shape))
        _install(dsts, src)
        for view in self._leg_views():
            lo = view.get("lo" + comp[0])
            if lo is not None:
                # the pair's value is hi + lo: a stale lo word (of
                # either leg of a paired run) would perturb the value
                # just set
                (lo[comp] if at is None else lo[comp][at]).zero_()
        return self

    # -- checkpoints -------------------------------------------------------

    def _ckpt_meta(self) -> Dict[str, Any]:
        """The snapshot's metadata, in the reference's keys: the
        topology and its psi slab layout (``solver.slab_axes``), so
        either package restores (and reshards) the file; ``step_kind``
        holds the port's kind."""
        meta = {"t": self.t, "scheme": self.cfg.scheme,
                "size": list(self.cfg.size),
                "topology": list(self.topology),
                "psi_slabs": {_AXES_STR[a]: int(m) for a, m in
                              slab_axes(self.static).items()},
                "dtype": self.cfg.dtype,
                "step_kind": self.step_kind,
                "state_keys": self._state_keys()}
        meta.update(self.extra_ckpt_meta)
        return meta

    def _check_ckpt_meta(self, extra):
        reason = ckpt_meta_mismatch(self.cfg, extra)
        if reason:
            raise ValueError(reason)
        if "state_keys" in extra:
            want = self._state_keys()
            got = list(extra["state_keys"])
            if got != want:
                raise ValueError(
                    f"checkpoint carry family {got} != this run's "
                    f"{want}; the step-kind family (ds/compensated/"
                    f"Drude companions) must match — resume with the "
                    f"same physics/dtype configuration")

    def _state_keys(self):
        """The dict-form state's top-level keys, sorted (the carry
        family a snapshot must match)."""
        view = self._shard_views()[0] if self.mesh is not None \
            else self._leg_views()[0]
        return sorted(view.keys())

    def checkpoint(self, path: str):
        """Bit-exact snapshot of the whole state as one npz file (the
        reference's format), streamed from the live carry one leaf at a
        time (``io.save_checkpoint``): no copy of the state on the
        device."""
        with telemetry.span("checkpoint"):
            io.save_checkpoint(self._ckpt_tree(), path,
                               extra=self._ckpt_meta())
        _faults.on_checkpoint(path)  # committed: the fault plan's hook
        return self

    def _ckpt_tree(self):
        """The tree a checkpoint writes: the dict view, or for a paired
        complex run the complex state with each leaf joined from the
        legs only when ``io.save_checkpoint`` reaches it (a callable
        leaf), so one leaf at a time is on the device twice."""
        if self.mesh is not None:
            return self._sharded_ckpt_tree()
        legs = self._leg_views()
        if len(legs) == 1:
            return legs[0]

        def lazy(re, im):
            if isinstance(re, dict):
                return {k: lazy(v, im[k]) for k, v in re.items()}
            if isinstance(re, torch.Tensor):
                return lambda: torch.complex(re, im)
            return re
        tree = lazy(*legs)
        tree["t"] = self.t      # the legs' t is synced only as they step
        return tree

    def _sharded_ckpt_tree(self):
        """The global tree of a decomposed run with each leaf joined on
        the host from the shards' pieces only when the writer reaches
        it (a callable leaf): the reference's sharded layout (psi
        ``2 m p`` planes along its axis), one leaf at a time."""
        views = self._shard_views()

        def lazy(nodes):
            first = nodes[0]
            if isinstance(first, dict):
                return {k: lazy([n[k] for n in nodes]) for k in first}
            if isinstance(first, torch.Tensor):
                return lambda: self.mesh.join_leaf(
                    "", [convert.to_host(n) for n in nodes])
            return first
        tree = lazy(views)
        tree["t"] = self.t
        return tree

    def restore(self, path: str):
        """Load a checkpoint (this package's or the reference's npz) into
        this sim's live carry. A snapshot failing its integrity checks
        raises :class:`fdtd3d_torch.io.CheckpointCorrupt`; one of another
        scheme, size, dtype or carry family a ValueError naming the
        guard."""
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path} is an orbax checkpoint directory: only npz "
                f"checkpoints are ported to fdtd3d_torch yet (ROADMAP.md "
                f"queue A11(b))")
        loaded, extra = io.load_checkpoint(path)
        self._check_ckpt_meta(extra)
        return self.adopt_state(loaded,
                                src_topology=extra.get("topology"),
                                src_meta=extra)

    def _reshard(self, tree, src_topology, src_meta=None):
        """The psi of a tree from ``src_topology``'s slab layout onto
        this run's (``io.reshard_psi_tree``), checking the layout the
        snapshot declares (``psi_slabs``) against its topology's."""
        import dataclasses

        from fdtd3d_torch import log as _log
        src_static = dataclasses.replace(self.static,
                                         topology=tuple(src_topology))
        src_slabs = slab_axes(src_static)
        dst_slabs = slab_axes(self.static)
        if src_meta and "psi_slabs" in src_meta:
            recorded = {_AXES_STR.index(k): int(v)
                        for k, v in src_meta["psi_slabs"].items()}
            if recorded != src_slabs:
                raise io.CheckpointCorrupt(
                    f"checkpoint psi slab layout {recorded} does not "
                    f"match the layout its topology {tuple(src_topology)} "
                    f"implies {src_slabs}: the snapshot was written by an "
                    f"incompatible build or damaged")
        _log.log(f"resharding checkpoint: topology {tuple(src_topology)} "
                 f"-> {self.topology} (psi slabs {src_slabs} -> "
                 f"{dst_slabs})")
        return io.reshard_psi_tree(tree, self.static.grid_shape,
                                   tuple(src_topology), src_slabs,
                                   self.topology, dst_slabs)

    def adopt_state(self, tree, src_topology=None, src_meta=None):
        """Install a dict-form state tree (numpy or tensor leaves, the
        keys and shapes of ``init_state``) as the live state, leaf by
        leaf into the live carry (``copy_``, as ``set_field`` does): no
        second carry on the device. The one install path of the
        ``state`` setter, :meth:`restore` and the supervisor's rollback
        to an in-memory snapshot. A tree from another topology
        (``src_topology``) has its psi resharded onto this run's layout
        first; a decomposed run takes each shard's piece of the global
        tree."""
        if src_topology is not None and \
                tuple(int(p) for p in src_topology) != self.topology:
            tree = self._reshard(tree, tuple(int(p) for p in src_topology),
                                 src_meta)
        pairs = []

        def walk(dsts, new, path):
            if not isinstance(new, dict) or set(new) != set(dsts[0]):
                raise ValueError(f"state structure mismatch at "
                                 f"{path or 'top'}")
            for k, v in dsts[0].items():
                if isinstance(v, dict):
                    walk([d[k] for d in dsts], new[k], f"{path}/{k}")
                elif k != "t":
                    src = new[k] if isinstance(new[k], torch.Tensor) \
                        else convert.from_host(np.asarray(new[k]))
                    if tuple(src.shape) != tuple(v.shape):
                        raise ValueError(
                            f"{path}/{k}: shape {tuple(src.shape)} != "
                            f"{tuple(v.shape)}")
                    pairs.append(([d[k] for d in dsts], src))

        if self.mesh is not None:
            for view, piece in zip(self._shard_views(),
                                   self.mesh.split(tree)):
                walk([view], piece, "")
        else:
            walk(self._leg_views(), tree, "")
        for dsts, src in pairs:
            _install(dsts, src)
        self._carry["t"] = int(tree["t"])
        self._ckpt_last_t = self.t
        return self

    def _maybe_auto_checkpoint(self):
        """The ``checkpoint_every`` cadence with its keep-K rotation: a
        committed snapshot at the first chunk boundary past each cadence
        multiple."""
        ce = self.cfg.output.checkpoint_every
        if not ce or self.t // ce <= self._ckpt_last_t // ce:
            return
        self.checkpoint_now()

    def checkpoint_now(self):
        """Write a committed cadence-style snapshot (``ckpt_tNNNNNN.npz``
        in save_dir) of the current state and prune to the newest
        keep-K at t <= now: the cadence's path and rotation, callable
        off the cadence (the supervisor seeds its rollback floor with
        it)."""
        out = self.cfg.output
        t = self.t
        os.makedirs(out.save_dir, exist_ok=True)
        self.checkpoint(os.path.join(out.save_dir, f"ckpt_t{t:06d}.npz"))
        self._ckpt_last_t = t
        if out.checkpoint_keep > 0:
            io.prune_checkpoints(out.save_dir, out.checkpoint_keep,
                                 t_max=t)
        return self

    def block_until_ready(self):
        devices = self.mesh.distinct_devices() if self.mesh is not None \
            else [self.device]
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self

    @staticmethod
    def run_batch(cfgs, time_steps: Optional[int] = None, device=None,
                  chunk: int = 0):
        """Run B same-shape scenarios as one batch
        (:class:`fdtd3d_torch.batch.BatchSimulation`): in-scope batches
        ride the lane-capable kernels, one launch for every lane; a
        batch the dispatch authority gives a token runs the plain step
        lane by lane, with ``batch_unsupported:<token>`` recorded.
        Returns the finished batch, after its end-of-run
        ``verify_final_lanes`` sweep; per-lane results via
        ``lane_state(i)`` / ``lane_field(i, comp)``, verdicts via
        ``lane_finite`` / ``lane_first_unhealthy_t``. ``chunk`` advances
        the batch that many steps per chunk (0 = one chunk); a
        telemetry sink is closed (run_end) on every exit."""
        from fdtd3d_torch.batch import BatchSimulation
        bsim = BatchSimulation(cfgs, device=device)
        try:
            bsim.run(time_steps, chunk=chunk)
            bsim.verify_final_lanes()
        finally:
            bsim.close()
        return bsim


"""Flight recorder of the PyTorch port: health counters, trace spans, the
telemetry sink.

Counterpart of ``fdtd3d_tpu/telemetry.py`` for one unsharded device:

* **Health counters** -- ``make_health_fn`` builds one reduction over
  the dict-form view of the live carry (``solver.make_chunk_runner``
  calls it at the end of every chunk): per stored component one
  ``torch.aminmax`` pass (max |E|, max |H|; NaN propagates) and one
  per-x-plane sum of squares (``torch.linalg.vector_norm`` over (y, z),
  which also widens bf16 without a temporary), the interior div·E over
  x-slabs of bounded depth (``diag.div_e_parts``), and one
  ``torch.aminmax`` of every other floating leaf (the non-finite flag:
  psi, J/K, the ds lo words, the compensated residuals, the incident
  line). Every partial lands in one small tensor that the caller reads
  back once (``readback``): one device-to-host transfer a chunk, never a
  field. The check_finite path and the sink read the same pass.
  ``make_lane_health_fn`` is the same reduction per lane of a
  lane-stacked batch.
* **Named spans** -- ``span`` (``torch.profiler.record_function`` plus
  an NVTX range on the card) and ``named`` give torch.profiler traces
  the reference's domain names (``fdtd3d/chunk``, ``fdtd3d/health``...).
* **The sink** -- ``TelemetrySink`` appends schema-v11 JSONL records:
  ``run_start`` provenance, one ``chunk`` record a chunk (health and wall
  time), ``per_chip``/``imbalance``, the supervisor's ``retry``/
  ``rollback``/``degrade`` and the batch's ``batch_lane`` rows. The
  schema tables, ``validate_record`` and the readers are a copy of the
  reference's, so the reference's tools (``tools/telemetry_report.py``)
  read the port's files unchanged. ``run_start.jax_version`` is ``"n/a"``
  (the port imports no JAX); ``torch_version`` and ``cuda_version`` ride
  as extra keys; ``vmem_rung`` is always 0 (the port has no VMEM
  ladder).

Counter definitions (f32 partials, combined on the host in double):

``energy``
    0.5 * sum cell * (eps0 |E|^2 + mu0 |H|^2), vacuum-weighted (the
    material-weighted energy is ``diag.metrics``).
``div_l2`` / ``div_linf``
    RMS and max of the discrete div E over interior cells
    (``diag.div_e_parts``).
``max_e`` / ``max_h``
    max over the components of max |comp| (float32x2: the hi words;
    complex: the modulus; the paired legs of a complex run: the max
    over the legs, as the reference combines them).
``nonfinite``
    1.0 when any floating leaf of the state holds a NaN or an Inf.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

SCHEMA_VERSION = 11
READ_VERSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11)

HEALTH_KEYS = ("energy", "div_l2", "div_linf", "max_e", "max_h",
               "nonfinite")

# the per-chip counters (unsharded: vectors of length 1)
PER_CHIP_KEYS = ("energy", "max_e", "max_h")

# each x-slab of the div·E pass holds at most this many cells (its
# temporaries are a few slabs of f32: ~64 MB each at 1024^3)
DIV_SLAB_CELLS = 1 << 24


class _Span:
    """``torch.profiler.record_function`` and, on the card, an NVTX
    range of the same name."""

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        self._rf.__exit__(*exc)
        return False


def span(name: str) -> _Span:
    """Host-side trace span ``fdtd3d/<name>``: a torch.profiler range
    (and NVTX on the card), so traces show the host loop's phases in the
    reference's terms (chunk, pack, checkpoint, telemetry-readback,
    ntff-sample, io-dump)."""
    return _Span(f"fdtd3d/{name}")


def named(name: str) -> _Span:
    """The scope of a phase inside a chunk (health, prepare; the
    reference's ``jax.named_scope``): the same torch.profiler range."""
    return _Span(f"fdtd3d/{name}")


# --------------------------------------------------------------------------
# health counters
# --------------------------------------------------------------------------

def max_abs(x: torch.Tensor) -> torch.Tensor:
    """max |x| in one pass; NaN propagates (torch.aminmax keeps NaN); a
    complex tensor through its modulus."""
    if x.is_complex():
        x = x.abs()
    lo, hi = torch.aminmax(x.reshape(-1))
    return torch.maximum(hi, -lo).float()


def lane_max_abs(x: torch.Tensor) -> torch.Tensor:
    """max |x| of each lane of a lane-leading tensor, (B,); NaN
    propagates."""
    lo, hi = lane_minmax(x)
    return torch.maximum(hi, -lo).float()


def lane_minmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, max) of each lane of a lane-leading tensor, (B,) each, in
    one pass where the lane's cells flatten to a view (else a min and a
    max pass); nothing the size of ``x`` is copied. NaN propagates. A
    complex tensor is read through its modulus (a real copy of it): its
    max |x| and its finiteness are what the counters take."""
    if x.is_complex():
        x = x.abs()
    try:
        flat = x.view(x.shape[0], -1)
    except RuntimeError:
        dims = tuple(range(1, x.dim()))
        return x.amin(dims), x.amax(dims)
    return torch.aminmax(flat, dim=1)


def plane_norms(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """sqrt of the sum of squares of each x-plane of a lane-leading
    (B, n1, n2, n3) tensor, (B, n1), in ``dtype`` or ``x``'s own dtype
    where that is wider (float64 fields): the two-level reduction of the
    reference (per-plane partials), without a squared temporary."""
    return torch.linalg.vector_norm(
        x, dim=(-2, -1), dtype=torch.promote_types(x.dtype, dtype))


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


class Parts:
    """Named device partials of one reduction pass, concatenated into one
    tensor (a row per lane) and read back in one transfer. ``add`` takes
    (B, k) segments; ``finish`` returns the device tensor and the
    decoder of its rows (name -> list of floats)."""

    def __init__(self):
        self._segs: List[Tuple[str, torch.Tensor]] = []

    def add(self, name: str, seg: torch.Tensor) -> None:
        self._segs.append((name, seg.reshape(seg.shape[0], -1)))

    def finish(self) -> Tuple[torch.Tensor, Callable]:
        wide = torch.float64 if any(s.dtype == torch.float64
                                    for _n, s in self._segs) \
            else torch.float32
        spans, off = {}, 0
        for name, s in self._segs:
            spans[name] = (off, off + s.shape[1])
            off += s.shape[1]
        parts = torch.cat([s.to(wide) for _n, s in self._segs], dim=1)

        def decode(row: List[float]) -> Dict[str, List[float]]:
            return {k: row[a:b] for k, (a, b) in spans.items()}
        return parts, decode


def _fmax(vals) -> float:
    """max that propagates NaN (Python's max does not)."""
    out = -math.inf
    for v in vals:
        if math.isnan(v):
            return math.nan
        out = max(out, v)
    return out


class Health:
    """One chunk's health partials on the device and their decoder
    (``readback`` reads them); ``lanes``: a batch's per-lane rows."""

    def __init__(self, parts: torch.Tensor, decode: Callable, lanes: bool):
        self.parts = parts
        self._decode = decode
        self.lanes = lanes

    def decode(self, rows: List[List[float]]):
        vals = [self._decode(r) for r in rows]
        return vals if self.lanes else vals[0]


def _health_parts(static, views, lanes: bool):
    """The partials of every leg of ``views`` (one dict-form view, or
    the two real legs of a paired complex run) in one tensor, and the
    function that turns a row of it into the view's sums: the E and H
    sums of squares, div·E's sum of squares, interior count and max,
    ``max_e``/``max_h`` and the finite flag, combined over the legs as
    the reference's ``make_health_fn`` combines them (energies and
    div·E sums of squares add, maxima take the max, the interior count
    is one leg's)."""
    from fdtd3d_torch import diag
    mode = static.mode
    lead = (lambda t: t) if lanes else (lambda t: t.unsqueeze(0))
    parts = Parts()
    n_others = []
    count = 1.0
    for g, view in enumerate(views):
        for grp, comps in (("E", mode.e_components),
                           ("H", mode.h_components)):
            for c in comps:
                v = lead(view[grp][c])
                lo, hi = lane_minmax(v)
                parts.add(f"lo:{g}:{c}", lo)
                parts.add(f"hi:{g}:{c}", hi)
                parts.add(f"sq:{g}:{c}", plane_norms(v))
        e = {c: lead(view["E"][c]) for c in mode.e_components}
        sumsq, count, linf = diag.div_e_parts(
            e, mode.e_components, mode.active_axes, 1.0 / static.dx,
            div_cast(static, e))
        parts.add(f"div_sumsq:{g}", sumsq)
        parts.add(f"div_linf:{g}", linf)
        others = [lead(t) for k, t in _leaves(view)
                  if isinstance(t, torch.Tensor)
                  and (t.is_floating_point() or t.is_complex())
                  and k.split("/")[0] not in ("E", "H")]
        for i, t in enumerate(others):
            lo, hi = lane_minmax(t)
            parts.add(f"lo:{g}:{i}", lo)
            parts.add(f"hi:{g}:{i}", hi)
        n_others.append(len(others))
    tensor, dec = parts.finish()

    def sums(row) -> Dict[str, Any]:
        p = dec(row)
        mx = {"E": [], "H": []}
        sq = {"E": 0.0, "H": 0.0}
        div_sumsq, div_linf = 0.0, []
        ok = True
        for g, n in enumerate(n_others):
            for grp, comps in (("E", mode.e_components),
                               ("H", mode.h_components)):
                for c in comps:
                    lo, hi = p[f"lo:{g}:{c}"][0], p[f"hi:{g}:{c}"][0]
                    ok = ok and math.isfinite(lo) and math.isfinite(hi)
                    mx[grp].append(_fmax((hi, -lo)))
                    sq[grp] += math.fsum(x * x for x in p[f"sq:{g}:{c}"])
            for i in range(n):
                ok = ok and math.isfinite(p[f"lo:{g}:{i}"][0]) \
                    and math.isfinite(p[f"hi:{g}:{i}"][0])
            div_sumsq += p[f"div_sumsq:{g}"][0]
            div_linf.append(p[f"div_linf:{g}"][0])
        return {"sq_e": sq["E"], "sq_h": sq["H"], "div_sumsq": div_sumsq,
                "count": count, "div_linf": _fmax(div_linf),
                "max_e": _fmax(mx["E"]) if mx["E"] else 0.0,
                "max_h": _fmax(mx["H"]) if mx["H"] else 0.0, "ok": ok}

    return tensor, sums


def _finish(static, shards: List[Dict[str, Any]], per_chip: bool
            ) -> Dict[str, Any]:
    """The health counters of the sums of one or more shards (the
    reference's local reductions finished by sum and max over the mesh:
    energies and div·E sums of squares and counts add, maxima take the
    max), with ``per_chip`` the shards' own energy and maxima."""
    cell = float(static.dx ** static.mode.ndim)
    from fdtd3d_torch import physics

    def energy(sq_e, sq_h):
        return 0.5 * cell * (physics.EPS0 * sq_e + physics.MU0 * sq_h)
    count = sum(s["count"] for s in shards)
    out = {"energy": energy(math.fsum(s["sq_e"] for s in shards),
                            math.fsum(s["sq_h"] for s in shards)),
           "div_l2": math.sqrt(sum(s["div_sumsq"] for s in shards)
                               / max(count, 1.0)),
           "div_linf": _fmax(s["div_linf"] for s in shards),
           "max_e": _fmax(s["max_e"] for s in shards),
           "max_h": _fmax(s["max_h"] for s in shards),
           "nonfinite": 0.0 if all(s["ok"] for s in shards) else 1.0}
    if per_chip:
        out["per_chip"] = {
            "energy": [energy(s["sq_e"], s["sq_h"]) for s in shards],
            "max_e": [s["max_e"] for s in shards],
            "max_h": [s["max_h"] for s in shards]}
    return out


def _health_pass(static, views, lanes: bool, per_chip: bool) -> Health:
    """The partials of ``views`` (``_health_parts``) and their decoder."""
    tensor, sums = _health_parts(static, views, lanes)
    return Health(tensor, lambda row: _finish(static, [sums(row)],
                                              per_chip), lanes)


def div_cast(static, e_view) -> torch.dtype:
    """The dtype div·E is differenced in: the reference's cast rule
    (telemetry.py:230-243). Complex fields stay complex (native
    complex runs); real legs of a complex run (the paired route) take
    the real dtype, never a complex cast; real fields the compute dtype
    (bf16 storage widens to f32)."""
    from fdtd3d_torch.ops.tfsf import real_dtype
    first = next(iter(e_view.values()))
    if first.is_complex():
        return first.dtype
    return real_dtype(static.compute_dtype)


def make_health_fn(static, per_chip: bool = False):
    """health(views) -> :class:`Health` of the dict-form state ``views``
    (a view of the live carry: nothing is cloned), or of a sequence of
    them, the two real legs of a paired complex run (the reference's
    ``states`` sequence: energies add, maxima take the max).
    ``readback`` turns it into ``HEALTH_KEYS`` floats (``nonfinite`` as
    ``finite``), plus ``per_chip`` length-1 vectors with ``per_chip``."""

    def health(views) -> Health:
        if isinstance(views, dict):
            views = [views]
        with named("health"):
            return _health_pass(static, views, False, per_chip)

    return health


def make_sharded_health_fn(static, mesh, per_chip: bool = False):
    """health(views) -> :class:`Health` of a decomposed run, ``views``
    the shards' dict-form views (a list, in the mesh's order): each
    shard's local partials (div·E over its own interior, as the
    reference's ``div_e_parts`` under a mesh sees it: the planes at a
    shard's edges are left out) in one tensor on the first shard's
    device, one readback, finished by sum and max over the shards; with
    ``per_chip`` the shards' energies and maxima as vectors."""

    def health(views) -> Health:
        with named("health"):
            tensors, fns = [], []
            dev = views[0]["E"][next(iter(views[0]["E"]))].device
            for view in views:
                t, fn = _health_parts(static, [view], False)
                tensors.append(t.to(dev))
                fns.append(fn)
            widths = [t.shape[1] for t in tensors]
            wide = torch.float64 if any(t.dtype == torch.float64
                                        for t in tensors) \
                else torch.float32
            tensor = torch.cat([t.to(wide) for t in tensors], dim=1)

        def decode(row):
            shards, at = [], 0
            for w, fn in zip(widths, fns):
                shards.append(fn(row[at:at + w]))
                at += w
            return _finish(static, shards, per_chip)
        return Health(tensor, decode, False)

    return health


def make_lane_health_fn(static, per_chip: bool = False):
    """health(view) -> :class:`Health` of a lane-stacked dict-form state
    (every leaf lane-leading): the counters of each lane, from one pass
    and one readback (``readback``: lists over the lanes)."""

    def health(view: Dict[str, Any]) -> Health:
        with named("health"):
            return _health_pass(static, [view], True, per_chip)

    return health


def readback(health: Health) -> Dict[str, Any]:
    """The one device-to-host transfer of a chunk's health partials ->
    floats: ``HEALTH_KEYS`` with ``nonfinite`` turned into ``finite``,
    and ``per_chip`` when the pass carries it. Never a field array."""
    with span("telemetry-readback"):
        rows = health.parts.tolist()
    out = health.decode(rows)
    if health.lanes:
        return _lane_rows(out)
    out = dict(out)
    out["finite"] = out.pop("nonfinite") == 0.0
    return out


def _lane_rows(lanes: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-lane counter dicts -> the batch's readback form: each key a
    list over lanes, non-finite values as None, ``finite`` flags, and
    ``per_chip`` as per-lane vectors."""
    def fin(v):
        return v if math.isfinite(v) else None
    out: Dict[str, Any] = {k: [fin(d[k]) for d in lanes]
                           for k in HEALTH_KEYS if k != "nonfinite"}
    out["finite"] = [d["nonfinite"] == 0.0 for d in lanes]
    if lanes and "per_chip" in lanes[0]:
        out["per_chip"] = {k: [[fin(x) for x in d["per_chip"][k]]
                               for d in lanes] for k in PER_CHIP_KEYS}
    return out


def lanes_finite(health: torch.Tensor) -> List[bool]:
    """Finite flag per lane of a (B,) max |x| tensor (one readback)."""
    return [math.isfinite(v) for v in health.tolist()]


def imbalance_summary(per_chip: Dict[str, list],
                      metric: str = "energy") -> Optional[Dict[str, Any]]:
    """Per-chunk load-asymmetry summary of a per-chip counter vector:
    max, mean, max/mean and the argmax chip (a non-finite chip is named
    as the argmax with ratio null and ``nonfinite_chips``). None for a
    single chip (every unsharded run) or a missing metric."""
    vals = per_chip.get(metric)
    if not vals or len(vals) < 2:
        return None
    vals = [v if v is not None else float("nan") for v in vals]
    bad = [i for i, v in enumerate(vals) if not np.isfinite(v)]
    finite = [v for v in vals if np.isfinite(v)]
    mx = max(finite) if finite else 0.0
    mean = sum(finite) / len(finite) if finite else 0.0
    if bad:
        return {"metric": metric, "max": float(mx), "mean": float(mean),
                "ratio": None, "argmax": bad[0], "n_chips": len(vals),
                "nonfinite_chips": bad}
    return {"metric": metric, "max": float(mx), "mean": float(mean),
            "ratio": (float(mx / mean) if mean > 0 else None),
            "argmax": int(np.argmax(vals)), "n_chips": len(vals)}


# --------------------------------------------------------------------------
# provenance + schema
# --------------------------------------------------------------------------

_git_sha_cache: Optional[str] = None


def git_sha() -> str:
    """The checkout's HEAD sha (short), cached; 'unknown' outside a git
    checkout."""
    global _git_sha_cache
    if _git_sha_cache is None:
        try:
            _git_sha_cache = subprocess.run(
                ["git", "rev-parse", "--short=12", "HEAD"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=10,
            ).stdout.strip() or "unknown"
        except (OSError, subprocess.SubprocessError):
            _git_sha_cache = "unknown"
    return _git_sha_cache


def provenance(sim=None) -> Dict[str, Any]:
    """The run_start record's fields: git sha, versions, the device, and
    with ``sim`` its scheme, grid, dtype, topology, step kind, the
    temporal-blocking depth or why it did not engage, and a batch's lane
    count and fallback token."""
    dev = torch.device(sim.device if sim is not None else "cpu")
    rec: Dict[str, Any] = {
        "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "git_sha": git_sha(),
        "jax_version": "n/a",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device_kind": torch.cuda.get_device_name(dev)
        if dev.type == "cuda" else "cpu",
        "hbm_gbps": None,
    }
    if sim is None:
        return rec
    nlanes = getattr(sim, "batch_size", None)
    if nlanes:
        rec["batch"] = int(nlanes)
    bfb = getattr(sim, "batch_fallback", None)
    if bfb:
        rec["batch_fallback"] = str(bfb)
    cfg = sim.cfg
    rec.update(scheme=cfg.scheme, grid=list(cfg.grid_shape),
               dtype=cfg.dtype, topology=list(sim.topology),
               step_kind=sim.step_kind, vmem_rung=0)
    diag = sim.step_diag or {}
    if diag.get("temporal_block") is not None:
        rec["ghost_depth"] = int(diag["temporal_block"])
    if diag.get("tb_fallback") is not None:
        rec["tb_fallback"] = dict(diag["tb_fallback"])
    return rec


# Required keys (and accepted types) per record type; extra keys are
# always allowed. A copy of the reference's table: the schema version
# bumps only when a required key changes meaning or disappears.
_NUM = (int, float)
_OPT_NUM = (int, float, type(None))
RECORD_SCHEMA: Dict[str, Dict[str, tuple]] = {
    "run_start": {
        "wall_time": (str,), "git_sha": (str,), "jax_version": (str,),
        "platform": (str,),
        # v2 additions (skipped when validating a v1 record)
        "device_kind": (str,), "hbm_gbps": _OPT_NUM,
    },
    "attribution": {
        "source": (str,), "sections": (dict,),
        "measured_total_ms": _OPT_NUM, "coverage_bytes": _OPT_NUM,
    },
    # counters are _OPT_NUM: a non-finite value is written as null
    # (NaN/Infinity literals are not JSON)
    "chunk": {
        "chunk": (int,), "t": (int,), "steps": (int,),
        "wall_s": _NUM, "mcells_per_s": _NUM,
        "energy": _OPT_NUM, "div_l2": _OPT_NUM, "div_linf": _OPT_NUM,
        "max_e": _OPT_NUM, "max_h": _OPT_NUM, "finite": (bool,),
        "vmem_rung": (int,),
    },
    "ladder_downgrade": {
        "t": (int,), "old_budget_mb": _OPT_NUM,
        "new_budget_mb": _OPT_NUM,
        "old_tile": _OPT_NUM, "new_tile": _OPT_NUM, "vmem_rung": (int,),
    },
    "run_end": {
        "t": (int,), "steps": (int,), "wall_s": _NUM,
        "mcells_per_s": _NUM, "first_unhealthy_t": _OPT_NUM,
    },
    # v3: the supervisor's recovery records; v5 stamps each with the
    # chip/host the failure was attributed to (null unsharded)
    "retry": {
        "t": (int,), "attempt": (int,), "delay_s": _NUM,
        "error": (str,), "chip": _OPT_NUM, "host": _OPT_NUM,
    },
    "rollback": {
        "t_failed": (int,), "t_restored": (int,), "source": (str,),
        "reason": (str,), "chip": _OPT_NUM, "host": _OPT_NUM,
    },
    "degrade": {
        "t": (int,), "old_kind": (str,), "new_kind": (str,),
        "reason": (str,), "chip": _OPT_NUM, "host": _OPT_NUM,
    },
    "topology_change": {
        "t": (int,), "old_topology": (list,), "new_topology": (list,),
        "reason": (str,), "chip": _OPT_NUM, "host": _OPT_NUM,
    },
    # v4: the per-chip lane
    "per_chip": {
        "chunk": (int,), "t": (int,), "n_chips": (int,),
        "counters": (dict,),
    },
    "imbalance": {
        "chunk": (int,), "t": (int,), "metric": (str,),
        "max": _NUM, "mean": _NUM, "ratio": _OPT_NUM, "argmax": (int,),
        "n_chips": (int,),
    },
    # v6: one record per lane per chunk of a batch
    "batch_lane": {
        "chunk": (int,), "t": (int,), "lane": (int,),
        "energy": _OPT_NUM, "div_l2": _OPT_NUM, "div_linf": _OPT_NUM,
        "max_e": _OPT_NUM, "max_h": _OPT_NUM, "finite": (bool,),
    },
    # v7: SLO alerts and the run-registry rows
    "alert": {
        "rule": (str,), "t_start": (int,), "t_end": (int,),
        "value": _OPT_NUM, "threshold": _OPT_NUM, "message": (str,),
    },
    "run_begin": {
        "run_id": (str,), "status": (str,), "kind": (str,),
        "wall_time": (str,), "git_sha": (str,), "platform": (str,),
    },
    "run_final": {
        "run_id": (str,), "status": (str,), "t": (int,),
        "steps": (int,), "wall_s": _NUM, "mcells_per_s": _NUM,
    },
    # v8: the job queue's journal rows
    "job_submit": {
        "job_id": (str,), "tenant": (str,), "status": (str,),
        "priority": (int,), "wall_time": (str,), "spec": (str,),
        "cells": _NUM,
    },
    "job_state": {
        "job_id": (str,), "tenant": (str,), "status": (str,),
    },
    # v9: the causal trace plane's spans
    "span": {
        "name": (str,), "trace_id": (str,), "span_id": (str,),
        "t0": _NUM, "t1": _NUM,
    },
    # v10: heartbeats and the watcher's liveness verdicts
    "heartbeat": {
        "emitter": (str,), "pid": (int,), "host": (str,),
        "seq": (int,), "unix": _NUM, "t": _OPT_NUM,
    },
    "liveness": {
        "emitter": (str,), "status": (str,), "last_unix": _NUM,
        "last_t": _OPT_NUM, "deadline_s": _NUM, "silent_s": _NUM,
        "message": (str,),
    },
    # v11: the multi-scheduler lease rows
    "lease_acquire": {
        "sched": (str,), "pid": (int,), "host": (str,),
        "start": _NUM, "token": (int,), "unix": _NUM, "ttl_s": _NUM,
    },
    "lease_renew": {
        "sched": (str,), "pid": (int,), "host": (str,),
        "start": _NUM, "token": (int,), "unix": _NUM, "ttl_s": _NUM,
    },
    "lease_release": {
        "sched": (str,), "pid": (int,), "host": (str,),
        "start": _NUM, "token": (int,), "unix": _NUM, "ttl_s": _NUM,
    },
}

# Documented optional keys per record type (the reference's table; the
# port's writers add torch_version/cuda_version to run_start, which the
# validator allows as extra keys).
RECORD_OPTIONAL: Dict[str, tuple] = {
    "run_start": ("scheme", "grid", "dtype", "topology", "step_kind",
                  "vmem_rung", "tile", "comm_strategy", "ghost_depth",
                  "aot_cache", "batch", "run_id", "tb_fallback",
                  "job_id", "batch_fallback", "trace_id", "span_id",
                  "parent_span_id"),
    "run_end": ("compile_ms", "aot_cache"),
    "ladder_downgrade": ("old_ghost_depth", "new_ghost_depth"),
    "attribution": ("host_spans_ms", "per_core", "imbalance",
                    "ledger_step_kind", "roofline"),
    "imbalance": ("nonfinite_chips", "lane", "group"),
    "per_chip": ("lane", "group"),
    "run_begin": ("scheme", "grid", "dtype", "topology", "step_kind",
                  "ghost_depth", "batch", "jax_version",
                  "device_kind", "config_fp", "exec_key_comparable",
                  "telemetry_path", "metrics_path", "save_dir",
                  "trace_dir", "job_id", "tenant", "trace_id"),
    "run_final": ("recovery_events", "unhealthy_lanes",
                  "first_unhealthy_t", "compile_ms", "aot_cache",
                  "exit_reason", "trace_id"),
    "batch_lane": ("trace_id", "span_id", "parent_span_id"),
    "job_submit": ("unix", "resume", "time_steps", "trace_id",
                   "span_id", "age_base"),
    "job_state": ("run_id", "reason", "wait_s", "topology", "group",
                  "lane", "t", "excluded_chips", "unix",
                  "resumed_from", "trace_id", "span_id",
                  "parent_span_id", "fence", "sched"),
    "span": ("parent_span_id", "attrs", "job_id", "tenant", "run_id",
             "lane", "group"),
    "heartbeat": ("run_id", "trace_id", "job_id", "cadence_s"),
    "liveness": ("run_id", "trace_id", "job_id", "pid", "host"),
    "lease_acquire": ("takeover_from", "reason"),
    "lease_renew": ("takeover_from", "reason"),
    "lease_release": ("takeover_from", "reason"),
}

# keys/record types that exist only from a schema version on: skipped
# (keys) or rejected (types) when validating an older record
_V2_ONLY_KEYS = {"run_start": ("device_kind", "hbm_gbps")}
_V5_ONLY_KEYS = {"retry": ("chip", "host"),
                 "rollback": ("chip", "host"),
                 "degrade": ("chip", "host")}
_SINCE = {2: ("attribution",), 3: ("retry", "rollback", "degrade"),
          4: ("per_chip", "imbalance"), 5: ("topology_change",),
          6: ("batch_lane",), 7: ("alert", "run_begin", "run_final"),
          8: ("job_submit", "job_state"), 9: ("span",),
          10: ("heartbeat", "liveness"),
          11: ("lease_acquire", "lease_renew", "lease_release")}


def validate_record(rec: Dict[str, Any]) -> None:
    """Raise ValueError when a record violates its declared schema
    version (writers emit v11; v1-v10 files remain readable)."""
    if not isinstance(rec, dict):
        raise ValueError(f"record is not an object: {rec!r}")
    v = rec.get("v")
    if v not in READ_VERSIONS:
        raise ValueError(f"record schema version {v!r} not in "
                         f"{READ_VERSIONS}")
    rtype = rec.get("type")
    if rtype not in RECORD_SCHEMA or any(
            v < since and rtype in types for since, types in _SINCE.items()):
        raise ValueError(f"unknown record type {rtype!r}")
    for key, types in RECORD_SCHEMA[rtype].items():
        if v == 1 and key in _V2_ONLY_KEYS.get(rtype, ()):
            continue
        if v < 5 and key in _V5_ONLY_KEYS.get(rtype, ()):
            continue
        if key not in rec:
            raise ValueError(f"{rtype} record missing {key!r}: {rec}")
        val = rec[key]
        # bool is an int subclass: only accept it where bool is listed
        if isinstance(val, bool) and bool not in types:
            raise ValueError(f"{rtype}.{key} is bool, expected "
                             f"{types}: {rec}")
        if not isinstance(val, types):
            raise ValueError(f"{rtype}.{key} has type "
                             f"{type(val).__name__}, expected {types}")


# --------------------------------------------------------------------------
# the sink
# --------------------------------------------------------------------------

# the recovery record types the sink tallies
RECOVERY_TYPES = ("retry", "rollback", "degrade", "topology_change")


def _scrub(v):
    """Non-finite floats -> None, recursively: NaN/Infinity literals are
    not JSON and would break strict readers on exactly the unhealthy
    runs the recorder exists for (``finite`` carries the state)."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, (list, tuple)):
        return [_scrub(x) for x in v]
    if isinstance(v, dict):
        return {k: _scrub(x) for k, x in v.items()}
    return v


class TelemetrySink:
    """Append-only JSONL writer of the flight recorder.

    Every record is validated at write time (a malformed record is a bug
    of the writer, not of the reader) and flushed. The file is opened in
    append mode, so several runs can share one path, each delimited by
    its own run_start/run_end pair. ``path=None`` is a file-less sink
    that validates and tallies only."""

    def __init__(self, path: Optional[str],
                 run_meta: Optional[Dict] = None):
        self.path = path
        self._fh = None
        self.n_records = 0
        self.steps_total = 0
        self.wall_total = 0.0
        self.first_unhealthy_t: Optional[int] = None
        self.recovery_counts: Dict[str, int] = {
            k: 0 for k in RECOVERY_TYPES}
        self._closed = False
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._fh = open(path, "a")
        if run_meta is not None:
            self.emit("run_start", **run_meta)

    def emit(self, rec_type: str, **fields) -> Dict[str, Any]:
        rec = {"v": SCHEMA_VERSION, "type": rec_type,
               **{k: _scrub(v) for k, v in fields.items()}}
        validate_record(rec)
        if rec_type == "chunk":
            self.steps_total += rec["steps"]
            self.wall_total += rec["wall_s"]
            if not rec["finite"] and self.first_unhealthy_t is None:
                # a bound: the first bad step is in (t - steps, t]
                self.first_unhealthy_t = rec["t"]
        if rec_type in self.recovery_counts:
            self.recovery_counts[rec_type] += 1
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        self.n_records += 1
        return rec

    def emit_chunk(self, chunk: int, t: int, steps: int, wall_s: float,
                   cells: float, health: Dict[str, Any],
                   vmem_rung: int = 0) -> Dict[str, Any]:
        """The per-chunk record from a ``readback`` dict and the wall."""
        mcps = cells * steps / wall_s / 1e6 if wall_s > 0 else 0.0
        return self.emit(
            "chunk", chunk=chunk, t=t, steps=steps,
            wall_s=float(wall_s), mcells_per_s=float(mcps),
            energy=health["energy"], div_l2=health["div_l2"],
            div_linf=health["div_linf"],
            max_e=health["max_e"], max_h=health["max_h"],
            finite=bool(health["finite"]), vmem_rung=int(vmem_rung))

    def abandon(self) -> None:
        """Drop the sink without a run_end record (the stream then ends
        as a killed process leaves it), releasing the file."""
        self._closed = True
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def close(self, t: int = 0, **extra) -> None:
        """Write run_end (idempotent) and close the file."""
        if self._closed:
            return
        self._closed = True
        mcps = extra.pop("mcells_per_s", None) or 0.0
        self.emit("run_end", t=int(t), steps=self.steps_total,
                  wall_s=self.wall_total, mcells_per_s=float(mcps),
                  first_unhealthy_t=self.first_unhealthy_t, **extra)
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def pct_summary(vals) -> Dict[str, float]:
    """``{"p50", "p95", "max"}`` of a value list (zeros when empty): the
    per-chunk statistics of ``profiling.StepClock.summary`` and of the
    reference's report tools."""
    if not vals:
        return {"p50": 0.0, "p95": 0.0, "max": 0.0}
    arr = np.asarray(list(vals), dtype=np.float64)
    return {"p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "max": float(arr.max())}


def split_runs(records):
    """Group a validated record list into runs at run_start markers (a
    truncated head without a run_start still forms a run)."""
    runs, cur = [], None
    for rec in records:
        if rec["type"] == "run_start":
            if cur:
                runs.append(cur)
            cur = [rec]
        else:
            if cur is None:
                cur = []
            cur.append(rec)
    if cur:
        runs.append(cur)
    return runs


def read_jsonl(path: str):
    """Parse and validate a telemetry JSONL file -> list of records."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}:{i + 1}: not JSON: {exc}")
            validate_record(rec)
            out.append(rec)
    return out

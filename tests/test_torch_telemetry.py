"""The PyTorch port's health counters, metrics and telemetry sink against
the JAX reference on the CPU (the cases of tests/test_telemetry.py and
tests/test_per_chip_telemetry.py that hold without a mesh).

* The same numpy-seeded state goes through the reference's
  ``telemetry.make_health_fn`` and the port's, on every carry the port
  reads it from: the plain step's dict, the packed and temporal-blocked
  carries' views, float32x2 (hi words; lo words in the non-finite flag),
  bf16 storage, compensated residuals, magnetic Drude K, float64, 1D
  and 2D modes. Gates: max_e, max_h and div_linf at 1e-6 relative, energy and
  div_l2 at 1e-5.
* ``diag.metrics`` of both packages on a Mie sphere (material-weighted
  energy; eps and mu spheres), at the same gates.
* A NaN in any floating leaf sets the non-finite flag in both packages.
* A chunk with health on reads back once; the sink scrubs non-finite
  values to null; the reference's fixture corpus reads back unchanged
  through the port's readers; the validator refuses what the
  reference's refuses.
* Every record the port's CLI, supervisor and batch write passes the
  reference's ``validate_record``, and the reference's
  ``tools/telemetry_report.py --json`` summarises the port's file with
  the keys of its summary of the reference CLI's file for the same
  argv and counters within the gates.
"""

import dataclasses
import glob
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import ref_config, to_port

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import convert
from fdtd3d_torch import diag as tdiag
from fdtd3d_torch import faults
from fdtd3d_torch import telemetry as ttel
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu import cli as rcli
from fdtd3d_tpu import diag as rdiag
from fdtd3d_tpu import telemetry as rtel
from fdtd3d_tpu.config import (MaterialsConfig, PmlConfig,
                               PointSourceConfig, SimConfig, SphereConfig,
                               TfsfConfig)
from fdtd3d_tpu.sim import Simulation as RSim
from fdtd3d_tpu.solver import build_static as r_build_static

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "Examples", "vacuum3D_tfsf.txt")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
REL_TIGHT = 1e-6     # max_e, max_h, div_linf
REL_SUM = 1e-5       # energy, div_l2


def _mode_cfg(name, n):
    size = (n, 1, 1) if name.startswith("1D") else (n, n, 1)
    active = [a for a in range(3) if size[a] > 1]
    return SimConfig(
        scheme=name, size=size, time_steps=8, dx=1e-3, courant_factor=0.5,
        wavelength=12e-3,
        pml=PmlConfig(size=tuple(4 if a in active else 0 for a in range(3))),
        point_source=PointSourceConfig(
            enabled=True, component="Ez",
            position=tuple(s // 2 for s in size)))


# case -> (reference config, the port's use_pallas, environment, kinds)
HEALTH_CASES = {
    "plain": (ref_config("kitchen_sink"), False, {}, ("plain",)),
    "packed_plain": (ref_config("kitchen_sink"), True,
                     {"FDTD3D_NO_TEMPORAL": "1"}, ("packed_plain",)),
    "tb_plain": (ref_config("kitchen_sink"), True, {},
                 ("packed_tb_plain",)),
    "ds": (ref_config("point_source", dtype="float32x2"), True, {},
           ("packed_ds_plain",)),
    "bf16": (ref_config("kitchen_sink", dtype="bfloat16"), True, {},
             ("packed_tb_plain",)),
    "compensated": (ref_config("compensated_point"), True, {},
                    ("packed_plain",)),
    "k_sphere": (ref_config("k_sphere"), True, {}, ("packed_plain",)),
    "f64": (ref_config("kitchen_sink", dtype="float64"), None, {},
            ("plain",)),
    "1d": (_mode_cfg("1D_EzHy", 48), None, {}, ("plain",)),
    "2d": (_mode_cfg("2D_TMz", 24), None, {}, ("plain",)),
}


def _seeded_port(ref_cfg, use_pallas, seed):
    """The port's sim of ``ref_cfg`` with every E/H component (and the
    float32x2 lo words) seeded from numpy, two steps in (psi, J, K and
    the incident line then hold values too)."""
    sim = TSim(dataclasses.replace(to_port(ref_cfg), use_pallas=use_pallas),
               device="cpu")
    rng = np.random.RandomState(seed)
    view = sim._dict_view()
    for grp in ("E", "H"):
        for c, v in view[grp].items():
            sim.set_field(c, 0.01 * rng.standard_normal(tuple(v.shape))
                          .astype(np.float32))
        lo = view.get("lo" + grp)
        for v in (lo or {}).values():
            v.copy_(torch.from_numpy(1e-10 * rng.standard_normal(
                tuple(v.shape)).astype(np.float32)))
    sim.advance(2)
    return sim


def _reference_state(sim, ref_cfg):
    """The port's live state in the reference's form (jnp leaves; bf16
    fields as jnp bfloat16, exact)."""
    st = convert.state_to_reference(sim.state)
    bf16 = ref_cfg.dtype == "bfloat16"

    def to_jnp(tree, grp=None):
        if isinstance(tree, dict):
            return {k: to_jnp(v, grp or k) for k, v in tree.items()}
        if bf16 and grp in ("E", "H"):
            return jnp.asarray(tree, dtype=jnp.bfloat16)
        return jnp.asarray(tree)
    return to_jnp(st)


def _reference_health(sim, ref_cfg):
    hfn = rtel.make_health_fn(r_build_static(ref_cfg))
    vals = jax.device_get(hfn([_reference_state(sim, ref_cfg)]))
    return {k: float(np.asarray(v)) for k, v in vals.items()}


def _close(got, want, rel, what):
    if want is None or not math.isfinite(want):
        assert got is None or not math.isfinite(got), what
        return
    scale = max(abs(want), 1e-30)
    assert abs(got - want) <= rel * scale, \
        f"{what}: {got!r} vs {want!r} (rel {abs(got - want) / scale:.2e})"


def _assert_counters(got, want, what="", div_abs=None):
    """The gates; ``div_abs``: div·E compared in absolute terms against
    this bound (a vacuum TFSF run, whose div·E is roundoff)."""
    for k in ("max_e", "max_h") + (("div_linf",) if div_abs is None
                                   else ()):
        _close(got[k], want[k], REL_TIGHT, f"{what}{k}")
    for k in ("energy",) + (("div_l2",) if div_abs is None else ()):
        _close(got[k], want[k], REL_SUM, f"{what}{k}")
    if div_abs is not None:
        for k in ("div_l2", "div_linf"):
            assert abs(got[k] - want[k]) <= div_abs, \
                f"{what}{k}: {got[k]!r} vs {want[k]!r}"


@pytest.fixture
def _env(monkeypatch):
    for k in ("FDTD3D_NO_TEMPORAL", "FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED",
              "FDTD3D_FORCE_FUSED", "FDTD3D_FAULT_PLAN"):
        monkeypatch.delenv(k, raising=False)
    faults.clear()
    yield monkeypatch
    faults.clear()


@pytest.mark.parametrize("case", list(HEALTH_CASES))
def test_health_counters_match_reference(case, _env):
    ref_cfg, use_pallas, env, kinds = HEALTH_CASES[case]
    for k, v in env.items():
        _env.setenv(k, v)
    sim = _seeded_port(ref_cfg, use_pallas, seed=len(case))
    assert sim.step_kind in kinds
    got = ttel.readback(ttel.make_health_fn(sim.static)(sim._dict_view()))
    want = _reference_health(sim, ref_cfg)
    assert got["finite"] and want["nonfinite"] == 0.0
    assert got["max_e"] > 0 and got["energy"] > 0
    _assert_counters(got, want, f"{case}: ")


# leaf -> the case whose state holds it
NAN_LEAVES = {"loE": "ds", "J": "plain", "K": "k_sphere", "psi_H": "plain",
              "rE": "compensated", "inc": "tb_plain", "Hz": "bf16"}


@pytest.mark.parametrize("leaf", list(NAN_LEAVES))
def test_nonfinite_flag_covers_every_leaf(leaf, _env):
    """A NaN in any floating leaf (the ds lo words, J, K, psi, the
    compensated residuals, the incident line, a bf16 field) sets the
    flag, in both packages; the counters of a NaN-free E/H stay as the
    reference's."""
    ref_cfg, use_pallas, env, _k = HEALTH_CASES[NAN_LEAVES[leaf]]
    for k, v in env.items():
        _env.setenv(k, v)
    sim = _seeded_port(ref_cfg, use_pallas, seed=3)
    view = sim._dict_view()
    if leaf == "Hz":
        view["H"]["Hz"][1, 2, 3] = float("nan")
    else:
        next(iter(view[leaf].values())).view(-1)[5] = float("nan")
    got = ttel.readback(ttel.make_health_fn(sim.static)(sim._dict_view()))
    want = _reference_health(sim, ref_cfg)
    assert not got["finite"] and want["nonfinite"] == 1.0
    if leaf != "Hz":
        _assert_counters(got, want)


def test_per_chip_vectors_unsharded():
    """per_chip carries length-1 vectors equal to the global counters
    (the reference's unsharded shape); no imbalance for one chip."""
    sim = _seeded_port(ref_config("xyz_cpml"), None, seed=4)
    got = ttel.readback(ttel.make_health_fn(sim.static, per_chip=True)(
        sim._dict_view()))
    assert got["per_chip"] == {"energy": [got["energy"]],
                               "max_e": [got["max_e"]],
                               "max_h": [got["max_h"]]}
    assert ttel.imbalance_summary(got["per_chip"]) is None
    vec = {"energy": [1.0, 3.0, float("nan")]}
    assert ttel.imbalance_summary(vec) == rtel.imbalance_summary(vec)
    vec = {"energy": [1.0, 3.0, 2.0]}
    assert ttel.imbalance_summary(vec) == rtel.imbalance_summary(vec)


def _mie_cfg(mu_sphere):
    mat = MaterialsConfig(
        eps=1.5, eps_sphere=SphereConfig(enabled=True, center=(10, 9, 10),
                                         radius=5, value=4.0),
        mu_sphere=SphereConfig(enabled=mu_sphere, center=(9, 10, 9),
                               radius=4, value=2.5))
    return SimConfig(scheme="3D", size=(20, 20, 20), time_steps=6, dx=1e-3,
                     courant_factor=0.4, wavelength=8e-3,
                     pml=PmlConfig(size=(3, 3, 3)),
                     tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2)),
                     materials=mat)


@pytest.mark.parametrize("mu_sphere", [False, True])
def test_metrics_match_reference_mie(mu_sphere):
    """diag.metrics of both packages on one seeded Mie-sphere state: the
    material-weighted energy (the port's box weights against the
    reference's whole grids), per-component max norms, div·E (a real
    interface charge: relative gates), e_scale."""
    ref_cfg = _mie_cfg(mu_sphere)
    port = _seeded_port(ref_cfg, True, seed=7)
    ref = RSim(ref_cfg)
    ref.state = jax.tree.map(jnp.asarray,
                             convert.state_to_reference(port.state))
    got, want = tdiag.metrics(port), rdiag.metrics(ref)
    assert list(got) == list(want)
    assert got["t"] == want["t"] == 2.0
    for k in want:
        rel = REL_SUM if k in ("energy", "div_l2") else REL_TIGHT
        _close(got[k], want[k], rel, k)
    # the norms reuse the cached pass at this step
    assert tdiag.field_norms(port) == {
        c: got[f"max_{c}"] for c in port.component_views()}
    assert tdiag.em_energy(port) == got["energy"]
    assert tdiag.divergence_e(port) == {
        k: got[k] for k in ("div_l2", "div_linf", "e_scale")}


def test_error_norms_match_reference():
    rng = np.random.RandomState(0)
    a, b = rng.standard_normal((2, 5, 6, 7))
    assert tdiag.error_norms(a, b) == rdiag.error_norms(a, b)


@pytest.mark.parametrize("kind", ["plain", "tb_plain", "finite_only"])
def test_one_readback_per_chunk(kind, _env, tmp_path):
    """A chunk with health on makes exactly one device-to-host transfer
    of scalars: every host extraction of a tensor is counted around the
    second chunk (the first builds the packed steps' prepared
    operands)."""
    out = {"telemetry_path": str(tmp_path / "t.jsonl")} \
        if kind != "finite_only" else {"check_finite": True}
    cfg = to_port(ref_config("kitchen_sink"))
    cfg = dataclasses.replace(cfg, use_pallas=kind == "tb_plain",
                              output=dataclasses.replace(cfg.output, **out))
    sim = TSim(cfg, device="cpu")
    sim.advance(2)
    counts = {}

    def counting(name, orig):
        def fn(self, *a, **k):
            counts[name] = counts.get(name, 0) + 1
            return orig(self, *a, **k)
        return fn

    for name in ("tolist", "item", "numpy", "__float__", "__int__",
                 "__bool__"):
        _env.setattr(torch.Tensor, name,
                     counting(name, getattr(torch.Tensor, name)))
    sim.advance(4)
    _env.undo()
    assert counts == {"tolist": 1}, counts
    sim.close()


def test_sink_scrubs_nonfinite(tmp_path):
    """Non-finite counters (nested per-chip vectors too) are written as
    null, every record validates in both packages, and first_unhealthy_t
    bounds the first non-finite chunk."""
    path = str(tmp_path / "t.jsonl")
    sink = ttel.TelemetrySink(path, run_meta=ttel.provenance())
    ok = {"energy": 1.0, "div_l2": 0.0, "div_linf": 0.0, "max_e": 1.0,
          "max_h": 1.0, "finite": True}
    bad = dict(ok, energy=float("nan"), max_e=float("inf"), finite=False)
    sink.emit_chunk(chunk=1, t=4, steps=4, wall_s=0.5, cells=8.0, health=ok)
    sink.emit_chunk(chunk=2, t=8, steps=4, wall_s=0.5, cells=8.0,
                    health=bad)
    sink.emit("per_chip", chunk=2, t=8, n_chips=1,
              counters={"energy": [float("nan")], "max_e": [float("inf")],
                        "max_h": [1.0]})
    sink.close(t=8, mcells_per_s=1.0)
    sink.close(t=9)   # idempotent
    text = open(path).read()
    assert "NaN" not in text and "Infinity" not in text
    recs = ttel.read_jsonl(path)
    assert recs == rtel.read_jsonl(path)
    assert recs[2]["energy"] is None and recs[2]["max_e"] is None
    assert recs[3]["counters"] == {"energy": [None], "max_e": [None],
                                   "max_h": [1.0]}
    assert recs[-1]["type"] == "run_end"
    assert recs[-1]["first_unhealthy_t"] == 8 and recs[-1]["steps"] == 8
    assert recs[0]["jax_version"] == "n/a" and recs[0]["platform"] == "cpu"
    assert sink.n_records == 5


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(FIXTURES,
                                                        "*.jsonl"))))
def test_fixture_corpus_reads_back(name):
    """The reference's schema fixtures (v2-v11 telemetry, registry and
    queue journals) read through the port's reader as through the
    reference's, and split into the same runs."""
    path = os.path.join(FIXTURES, name)
    got = ttel.read_jsonl(path)
    assert got == rtel.read_jsonl(path)
    assert ttel.split_runs(got) == rtel.split_runs(got)


@pytest.mark.parametrize("rec,match", [
    ({"v": 11, "type": "chunk"}, "missing"),
    ({"v": 12, "type": "run_end"}, "version"),
    ({"v": 11, "type": "nope"}, "unknown record type"),
    ({"v": 2, "type": "retry"}, "unknown record type"),
    ({"v": 11, "type": "run_end", "t": True, "steps": 1, "wall_s": 1.0,
      "mcells_per_s": 1.0, "first_unhealthy_t": None}, "bool"),
    ({"v": 11, "type": "run_end", "t": "1", "steps": 1, "wall_s": 1.0,
      "mcells_per_s": 1.0, "first_unhealthy_t": None}, "type str"),
])
def test_validate_record_rejects_what_the_reference_rejects(rec, match):
    with pytest.raises(ValueError, match=match):
        ttel.validate_record(rec)
    with pytest.raises(ValueError):
        rtel.validate_record(rec)
    assert ttel.RECORD_SCHEMA == rtel.RECORD_SCHEMA
    assert ttel.RECORD_OPTIONAL == rtel.RECORD_OPTIONAL
    assert (ttel.SCHEMA_VERSION, ttel.READ_VERSIONS, ttel.HEALTH_KEYS,
            ttel.PER_CHIP_KEYS) == (rtel.SCHEMA_VERSION, rtel.READ_VERSIONS,
                                    rtel.HEALTH_KEYS, rtel.PER_CHIP_KEYS)


def _records(path):
    recs = [json.loads(ln) for ln in open(path).read().splitlines()]
    for r in recs:
        rtel.validate_record(r)
    return recs


def _report(path):
    """The reference's tools/telemetry_report.py --json summary."""
    import contextlib
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", os.path.join(ROOT, "tools",
                                         "telemetry_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main([path, "--json"]) == 0
    return json.loads(buf.getvalue())


# summary keys left out of the comparison: the wall times, and what the
# port does not write yet (the executable cache, ROADMAP.md A13(b))
_WALL_KEYS = ("wall_s", "wall_s_per_chunk", "mcells_per_s",
              "throughput_trend", "compile_ms", "aot_cache_at_start")


def test_cli_file_matches_reference_cli(tmp_path, capsys):
    """vacuum3D_tfsf at 32^3 through both CLIs with --telemetry
    --per-chip-telemetry --metrics-every --profile: every port record
    passes the reference's validator, the reference's report tool
    summarises both files with the same keys, and the counters (chunk
    records, metrics.jsonl) hold the reference's: the max norms against
    their family's max (at normal incidence the cross-polarised
    components hold roundoff), div·E in absolute terms against
    1e-5 e_scale / dx."""
    argv = ["--cmd-from-file", EXAMPLE, "--same-size", "32",
            "--time-steps", "20", "--per-chip-telemetry",
            "--metrics-every", "10", "--norms-every", "10", "--profile"]
    tp, tr = tmp_path / "port", tmp_path / "ref"
    assert tcli.main(argv + ["--telemetry", str(tp / "t.jsonl"),
                             "--save-dir", str(tp), "--trace",
                             str(tp / "trace"), "--device", "cpu"]) == 0
    assert rcli.main(argv + ["--telemetry", str(tr / "t.jsonl"),
                             "--save-dir", str(tr)]) == 0
    out = capsys.readouterr().out
    assert "profile: 20 steps" in out
    got, want = _records(tp / "t.jsonl"), _records(tr / "t.jsonl")
    assert [r["type"] for r in got] == [r["type"] for r in want]
    assert set(want[0]) - {"aot_cache"} <= set(got[0])
    parser = tcli.build_parser()
    dx = tcli.args_to_config(parser.parse_args(
        tcli.read_cmd_file(EXAMPLE) + argv[2:])).dx
    for g, w in zip(got, want):
        if g["type"] == "chunk":
            assert (g["t"], g["steps"], g["finite"]) == \
                (w["t"], w["steps"], w["finite"])
            _assert_counters(g, w, f"t={g['t']}: ",
                             div_abs=1e-5 * w["max_e"] / dx)
    sg, sw = _report(str(tp / "t.jsonl")), _report(str(tr / "t.jsonl"))
    for a, b in zip(sg, sw):
        assert set(a) - set(_WALL_KEYS) == set(b) - set(_WALL_KEYS)
        assert set(a["provenance"]) == set(b["provenance"])
        assert (a["chunks"], a["steps"], a["complete"],
                a["first_unhealthy_t"]) == (b["chunks"], b["steps"],
                                            b["complete"],
                                            b["first_unhealthy_t"])
        _close(a["final_energy"], b["final_energy"], REL_SUM, "energy")
        assert abs(a["max_div_l2"] - b["max_div_l2"]) <= \
            1e-5 * [r for r in want if r["type"] == "chunk"][-1]["max_e"] \
            / dx
    mg = [json.loads(ln) for ln in open(tp / "metrics.jsonl")]
    mw = [json.loads(ln) for ln in open(tr / "metrics.jsonl")]
    assert [list(r) for r in mg] == [list(r) for r in mw]
    for g, w in zip(mg, mw):
        fam = {f: max(w[k] for k in w if k.startswith(f"max_{f}"))
               for f in "EH"}
        for k in w:
            if k.startswith("max_"):
                assert abs(g[k] - w[k]) <= REL_TIGHT * fam[k[4]], k
            elif k.startswith("div_"):
                assert abs(g[k] - w[k]) <= 1e-5 * w["e_scale"] / dx, k
            else:
                _close(g[k], w[k], REL_SUM, k)


def test_supervised_records(tmp_path, _env, capsys):
    """A supervised run with NaNs through the port's CLI: one
    run_start/run_end pair, a rollback and a degrade record for each trip
    naming the ladder's kinds, chip/host null, a first_unhealthy_t bound;
    every record passes the reference's validator and its report tool
    lists the recoveries."""
    _env.setenv("FDTD3D_FAULT_PLAN", "nan@t=8; nan@t=16")
    path = tmp_path / "t.jsonl"
    assert tcli.main(["--3d", "--same-size", "16", "--time-steps", "24",
                      "--use-pml", "--pml-size", "3", "--point-source",
                      "Ez", "--courant-factor", "0.4", "--wavelength",
                      "0.008", "--checkpoint-every", "8", "--save-dir",
                      str(tmp_path), "--supervise", "--use-pallas", "on",
                      "--telemetry", str(path), "--device", "cpu"]) == 0
    recs = _records(path)
    types = [r["type"] for r in recs]
    assert types.count("run_start") == 1 and types[-1] == "run_end"
    assert types.count("run_end") == 1
    deg = [(r["old_kind"], r["new_kind"]) for r in recs
           if r["type"] == "degrade"]
    assert deg == [("packed_tb_plain", "packed_plain"),
                   ("packed_plain", "fused_plain")]
    rb = [r for r in recs if r["type"] == "rollback"]
    assert [(r["t_failed"], r["t_restored"]) for r in rb] == [(16, 8),
                                                              (24, 16)]
    assert all(r["chip"] is None and r["host"] is None
               for r in recs if r["type"] in ("rollback", "degrade"))
    assert recs[-1]["first_unhealthy_t"] == 16
    bad = [r["t"] for r in recs if r["type"] == "chunk" and not r["finite"]]
    assert bad == [16, 24]
    summary = _report(str(path))[0]
    assert len(summary["recoveries"]["degrades"]) == 2
    assert summary["first_unhealthy_bound"] == [8, 16]


def test_batch_records_match_reference_lanes(tmp_path):
    """A batch through both CLIs with --telemetry --per-chip-telemetry:
    the port writes one batch_lane row per lane per chunk and a per_chip
    row per lane, each record passes the reference's validator, and each
    lane's counters hold the reference's."""
    paths = []
    for i, amp in enumerate((1.0, -2.0)):
        p = tmp_path / f"lane{i}.txt"
        p.write_text("--3d\n--same-size 12\n--time-steps 6\n"
                     "--courant-factor 0.4\n--wavelength 8e-3\n--use-pml\n"
                     "--pml-size 3\n--point-source Ez\n"
                     f"--point-source-amplitude {amp}\n")
        paths.append(str(p))
    flags = ["--batch", *paths, "--batch-chunk", "3",
             "--per-chip-telemetry", "--check-finite"]
    tp, tr = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    assert tcli.main(flags + [f"--telemetry={tp}", "--device", "cpu"]) == 0
    assert rcli.main(flags + [f"--telemetry={tr}"]) == 0
    got, want = _records(tp), _records(tr)
    assert [r["type"] for r in got] == [r["type"] for r in want]
    assert got[0]["batch"] == want[0]["batch"] == 2
    for g, w in zip(got, want):
        if g["type"] in ("batch_lane", "chunk"):
            assert g["t"] == w["t"] and g.get("lane") == w.get("lane")
            _assert_counters(g, w, f"{g['type']} {g.get('lane')}: ")
        if g["type"] == "per_chip":
            assert g["lane"] == w["lane"] and g["n_chips"] == 1
            for k in ttel.PER_CHIP_KEYS:
                _close(g["counters"][k][0], w["counters"][k][0],
                       REL_SUM, k)

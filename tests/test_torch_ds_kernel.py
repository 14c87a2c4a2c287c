"""The CUDA float32x2 step's host-side schedule, checked on the CPU.

The CUDA step (``ops/packed_ds.py``, kind ``packed_ds_cuda``) moves the
step's host part onto the card: the ds incident line advances in one
kernel from the carry's line buffer into a second one, and the pass
computes the TFSF record terms at the record planes from both buffers
(E records sample the first buffer's Hinc, H records the second's
Einc). Its plain versions keep that schedule, so the CPU checks it here,
bit for bit, against the reference schedule the port had before
(``tfsf.advance_einc``, ``record_terms`` between the two advances,
``tfsf.advance_hinc``, the in-place family updates) and against the JAX
reference's line:

* the per-cell record-term formula the kernel mirrors
  (``record_term_cell``) equals ``record_terms`` on the oblique case of
  tests/torch_parity.py, over every record cell at once and cell by
  cell;
* the double-buffered line equals the reference's ``advance_einc`` /
  ``advance_hinc`` over 50 steps, and the two buffers give every record
  the line the in-place schedule gives it;
* the whole step on the kernel's schedule (out of place, with the
  spare set swapped in) equals the in-place plain step, on every leaf of
  the carry, with oblique TFSF, a point source, Drude J and an eps
  sphere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import ref_config, to_port

from fdtd3d_torch import solver as tsolver
from fdtd3d_torch.ops import ds as tds
from fdtd3d_torch.ops import packed_ds
from fdtd3d_torch.ops import tfsf as ttfsf
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu import solver as rsolver
from fdtd3d_tpu.config import (MaterialsConfig, PointSourceConfig,
                               SphereConfig)
from fdtd3d_tpu.ops import tfsf as rtfsf


def _bits(t: torch.Tensor) -> np.ndarray:
    """A float32 tensor's bit patterns (so -0 and +0 differ)."""
    return t.contiguous().view(torch.int32).numpy()


def _same_bits(got, want, what):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _oblique(**kw):
    """The oblique TFSF case of tests/torch_parity.py in float32x2: the
    port's static set-up, its CPU coefficients and a prepared step."""
    cfg = to_port(ref_config("oblique_tfsf", dtype="float32x2", **kw))
    static = tsolver.build_static(cfg)
    coeffs = tsolver.coeffs_to_device(tsolver.build_coeffs(static), "cpu")
    step = packed_ds.make_packed_ds_step(static, "cpu")
    return static, coeffs, step


def _seeded_line(n, seed):
    rng = np.random.default_rng(seed)
    line = {}
    for key in ("Einc", "Hinc"):
        hi, lo = tds.from_f64(0.1 * rng.standard_normal(n))
        line[key] = torch.from_numpy(np.array(hi, np.float32))
        line[f"{key}_lo"] = torch.from_numpy(np.array(lo, np.float32))
    return line


def test_record_term_cell_matches_record_terms():
    static, coeffs, step = _oblique()
    cc = step.prepare(coeffs)
    plan = cc["plan"]
    assert plan is not None and cc["h_first"] < plan.total
    n = static.tfsf_setup.n_inc
    src = _seeded_line(n, 3)
    dst = {k: torch.empty_like(v) for k, v in src.items()}
    pair = (0.25, 1e-9)
    packed_ds.line_advance_plain(src, dst, cc, pair)
    # the in-place schedule's line between the two advances
    mid = ttfsf.advance_einc(dict(src), coeffs, 0, static.dt, static.omega,
                             static.tfsf_setup, source=lambda _t: pair)
    want = packed_ds.record_terms(plan, mid)
    got = packed_ds.plan_terms(cc, src, dst)
    _same_bits(got, want, "every record cell")
    assert float(want[0].abs().max()) > 0
    # cell by cell, on 0-d operands, over cells of every record
    geo, i0 = cc["geo"], cc["geo_i0"]
    cells = sorted({off + d for off in plan.offsets.values()
                    for d in (0, 5, 17)})
    for q in cells:
        line = src if q < cc["h_first"] else dst
        key = "Hinc" if q < cc["h_first"] else "Einc"
        v = [(line[key][int(i0[q]) + s], line[f"{key}_lo"][int(i0[q]) + s])
             for s in (0, 1)]
        th, tl = packed_ds.record_term_cell(
            v[0], v[1], (geo[0, q], geo[1, q]), (geo[2, q], geo[3, q]),
            (geo[4, q], geo[5, q]), geo[6, q])
        _same_bits(torch.stack([th, tl]), want[:, q], f"cell {q}")


def test_double_buffered_line_50_steps_bit_exact():
    cfg = ref_config("oblique_tfsf", dtype="float32x2")
    rs = rsolver.build_static(cfg)
    rc = {k: jnp.asarray(v) for k, v in rsolver.build_coeffs(rs).items()}
    static, coeffs, step = _oblique()
    cc = step.prepare(coeffs)
    n = static.tfsf_setup.n_inc
    src = _seeded_line(n, 11)
    dst = {k: torch.empty_like(v) for k, v in src.items()}
    rinc = {k: jnp.asarray(v.numpy()) for k, v in src.items()}
    tinc = {k: v.clone() for k, v in src.items()}
    table = ttfsf.line_source(static.tfsf_setup, static.omega, static.dt)
    for t in range(50):
        packed_ds.line_advance_plain(src, dst, cc, table(t))
        tinc = ttfsf.advance_einc(tinc, coeffs, t, static.dt, static.omega,
                                  static.tfsf_setup, source=table)
        # what the records read: Hinc before this step's advance from the
        # first buffer, the advanced Einc from the second
        for key in ("Einc", "Einc_lo"):
            _same_bits(dst[key], tinc[key], f"step {t}: {key}")
        for key in ("Hinc", "Hinc_lo"):
            _same_bits(src[key], tinc[key], f"step {t}: {key}")
        tinc = ttfsf.advance_hinc(tinc, coeffs, static.tfsf_setup)
        rinc = rtfsf.advance_hinc(rtfsf.advance_einc(
            rinc, rc, jnp.int32(t), rs.dt, rs.omega, rs.tfsf_setup), rc,
            rs.tfsf_setup)
        src, dst = dst, src
    for key in src:
        _same_bits(src[key], tinc[key], key)
        np.testing.assert_array_equal(src[key].numpy(),
                                      np.asarray(rinc[key]), err_msg=key)
    assert float(src["Einc"].abs().max()) > 1e-3


@pytest.mark.parametrize("case", ["oblique_point", "drude_sphere"])
def test_kernel_schedule_step_matches_plain_step(case):
    kw = dict(point_source=PointSourceConfig(enabled=True, component="Ez",
                                             position=(5, 9, 7)))
    if case == "drude_sphere":
        kw["materials"] = MaterialsConfig(
            eps=1.5, eps_sphere=SphereConfig(enabled=True, center=(8, 7, 8),
                                             radius=4, value=3.0),
            use_drude=True, eps_inf=1.0, omega_p=2e11, gamma=1e10)
    cfg = to_port(ref_config("oblique_tfsf", dtype="float32x2",
                             use_pallas=True, **kw))
    sim = TSim(cfg, device="cpu")
    sim.advance(3)                       # a wave on the line and grid
    rng = np.random.default_rng(7)
    carry = sim._carry
    for key in ("E", "H"):
        hi, lo = tds.from_f64(0.01 * rng.standard_normal(
            tuple(carry[key][:3].shape)))
        carry[key][:3] = torch.from_numpy(np.array(hi, np.float32))
        carry[key][3:] = torch.from_numpy(np.array(lo, np.float32))
    if "J" in carry:
        carry["J"].normal_(generator=torch.Generator().manual_seed(3))
    k_step = packed_ds.make_packed_ds_step(sim.static, "cpu")
    p_step = packed_ds.make_packed_ds_step(sim.static, "cpu", plain=True)
    cc = k_step.prepare(sim.coeffs)
    ck = carry
    cp = {k: ({a: v.clone() for a, v in x.items()} if isinstance(x, dict)
              else x.clone() if isinstance(x, torch.Tensor) else x)
          for k, x in carry.items()}
    for _ in range(4):
        ck = k_step(ck, cc)
        cp = p_step(cp, cc)
    assert ck["t"] == cp["t"]
    for key, want in cp.items():
        if isinstance(want, dict):
            for sub, w in want.items():
                _same_bits(ck[key][sub], w, f"{key}[{sub}]")
        elif isinstance(want, torch.Tensor):
            _same_bits(ck[key], want, key)
    assert float(cp["E"][:3].abs().max()) > 0

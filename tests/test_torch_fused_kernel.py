"""The recompute-fused CUDA pass's schedule, emulated item by item on the
CPU (``ops/pallas_fused.py``, ``csrc/fused_eh.cu``).

The kernel cannot run here, so this file emulates what it does with the
plain version's own per-family arithmetic: for each work item of
``plan_items``, E on the cells the item computes (its owned box and the
hi-side halo plane, row and column) with only the terms its section's
kernel has compiled in (the slab psi of the section's axes, the TFSF
record terms from ``tfsf.record_terms`` and the point source in every
section but the inner one, the coefficient grids only where the plan
row says the item reads them, else their background value); then H on
the owned box from THAT E (the halo included, as the block computes it,
not its owner's copy), and the owned cells' E, H, psi (of every slab
axis, x included) and J stored. Cells nobody stores stay NaN.

* The emulation equals ``fused_eh_plain`` (E with every term, then H
  from that E) exactly, on the ladder's four cases, a point source, a
  Drude sphere with a grid box and no CPML on x, and a magnetic Drude K
  sphere (K read and written by the H half), with the y and z
  axes cut whole and band by band, at tiles and segments small enough
  to give every axis several items; in float32 and with bf16 storage
  (each block computes in float32 from the widened fields, H from its
  own unrounded E, and the owned cells' E and H are rounded to bf16
  where they are stored).
* The emulated step (E-incident advance, record terms, the emulated
  pass, H-incident advance) against the reference's interpret-mode
  recompute-fused step and its jnp step, 8 steps at 16^3 from one
  seeded state, at 2e-6 of each family's max (E, H, psi, J, each
  incident line), on the ladder's four cases (``tfsf_in_slab``: TFSF
  faces inside the CPML slabs).
"""

import numpy as np
import pytest
import torch
from test_torch_ladder import LADDER_CASES, assert_family_close, case_config
from torch_parity import (BASE, CASES, MODE_CASES, np_state, seed_reference,
                          to_port)

from fdtd3d_torch import convert
from fdtd3d_torch.ops import packed_tb, pallas3d, pallas_fused, tfsf
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_torch.solver import (build_coeffs, build_static,
                                 coeffs_to_device, init_state)
from fdtd3d_tpu.config import SimConfig
from fdtd3d_tpu.sim import Simulation as RSim

TILE = (5, 6)        # owned (y, z) cells: several items an axis at 16^3
SEGMENTS = (3,)


def _variant(fc, axes, grid, background):
    """A family's operands as one section's kernel sees them: the slab
    psi of ``axes`` only (bit a for axis a), and without ``grid`` each E
    grid in ``background`` replaced by its background value."""
    out = dict(fc)
    out["m"] = {a: m for a, m in fc["m"].items() if (axes >> a) & 1}
    out["psi"] = {c: [(t, k) for t, k in v
                      if ((axes >> "xyz".index(k[-1])) & 1)]
                  for c, v in fc["psi"].items()}
    if not grid and fc["family"] == "E":
        for key in ("a", "b"):
            out[key] = [background.get((key, ci), v)
                        for ci, v in enumerate(fc[key])]
    return out


def _slab_rows(n, m):
    return torch.cat([torch.arange(m), torch.arange(n - m, n)])


def _full_psi(psi, key, shape, m):
    """A compact slab psi spread to the full grid (NaN off the slabs)."""
    a = "xyz".index(key[-1])
    full = torch.full(shape, float("nan"))
    return full.index_copy(a, _slab_rows(shape[a], m), psi)


def emulate(E, H, psi_e, psi_h, J, fp, terms, drive, K=None, tile=TILE,
            segments=SEGMENTS, bands=False):
    """The pass as the kernel schedules it (see the module docstring):
    (E', H', psi_E', psi_H', J' or None, K' or None)."""
    shape = fp["shape"]
    m, recs, point = packed_tb.plan_geometry(fp)
    grids, background = packed_tb.material(fp)
    rows, counts = pallas_fused.plan_items(shape, m, recs, point, tile=tile,
                                           grids=grids, segments=segments,
                                           bands=bands)
    nan = lambda: torch.full(shape, float("nan"))  # noqa: E731
    out_e = {c: nan() for c in E}
    out_h = {c: nan() for c in H}
    out_j = None if J is None else {c: nan() for c in J}
    out_k = None if K is None else {c: nan() for c in K}
    out_pe = {k: nan() for k in psi_e}
    out_ph = {k: nan() for k in psi_h}
    bounds = np.cumsum((0,) + tuple(counts))
    e_cache = {}
    for q, row in enumerate(rows):
        sec = int(np.searchsorted(bounds, q, side="right")) - 1
        axes = pallas_fused.SECTION_AXES[sec]
        src = pallas_fused.SECTIONS[sec] != "inner"
        grid = bool(row[7])
        fe = _variant(fp["E"], axes, grid, background)
        fh = _variant(fp["H"], axes, grid, background)
        key = (axes, src, grid)
        if key not in e_cache:
            rec = pallas3d.record_adder(fp, "E", terms) \
                if src and terms is not None else None
            pt = pallas3d.point_adder(fp, drive) \
                if src and drive is not None else None
            e_cache[key] = pallas3d._family_plain(
                E, H, {k: psi_e[k] for v in fe["psi"].values()
                       for _, k in v}, J, fe, True, rec, pt)
        new_e, pe, new_j = e_cache[key]
        j0, k0, ny, nz, x0, x1 = (int(v) for v in row[:6])
        own = (slice(x0, x1), slice(j0, j0 + ny), slice(k0, k0 + nz))
        box = (slice(x0, x1 + 1), slice(j0, j0 + ny + 1),
               slice(k0, k0 + nz + 1))
        # H reads only the E the item computed itself
        local = {c: torch.zeros(shape) for c in new_e}
        for c in new_e:
            local[c][box] = new_e[c][box]
        rec_h = pallas3d.record_adder(fp, "H", terms) \
            if src and terms is not None else None
        new_h, ph, new_k = pallas3d._family_plain(
            H, local, {k: psi_h[k] for v in fh["psi"].values()
                       for _, k in v}, K, fh, False, rec_h)
        for outs, new in ((out_e, new_e), (out_h, new_h), (out_j, new_j),
                          (out_k, new_k)):
            for c in outs or ():
                outs[c][own] = new[c][own]
        for outs, new in ((out_pe, pe), (out_ph, ph)):
            for k, v in new.items():
                mm = fp["E"]["m"]["xyz".index(k[-1])]
                outs[k][own] = _full_psi(v, k, shape, mm)[own]
    for outs in (out_pe, out_ph):
        for k in outs:
            a = "xyz".index(k[-1])
            outs[k] = outs[k].index_select(
                a, _slab_rows(shape[a], fp["E"]["m"][a]))
    # the stores: the fields in their storage dtype
    return (pallas3d.stored(out_e, E), pallas3d.stored(out_h, H), out_pe,
            out_ph, out_j, out_k)


EMU_CASES = dict(LADDER_CASES, point_source=CASES["point_source"],
                 drude_sphere=CASES["drude_sphere"],
                 k_sphere=MODE_CASES["k_sphere"])


def seeded(case, seed=5, dtype="float32"):
    """(static, prepared operands, state) of a case, every leaf of the
    state seeded: E, H, psi, J and the incident line (E and H rounded
    to the storage ``dtype``)."""
    static = build_static(to_port(SimConfig(**dict(BASE, dtype=dtype),
                                            **EMU_CASES[case])))
    coeffs = coeffs_to_device(build_coeffs(static), "cpu")
    state = init_state(static, "cpu")
    rng = np.random.RandomState(seed)
    for grp in ("E", "H", "J", "K", "psi_E", "psi_H", "inc"):
        for v in state.get(grp, {}).values():
            v.copy_(torch.from_numpy(0.01 * rng.standard_normal(
                v.shape).astype(np.float32)))
    return static, pallas_fused.prepare(static, coeffs), state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bands", [False, True], ids=["whole", "bands"])
@pytest.mark.parametrize("case", sorted(EMU_CASES))
def test_emulated_schedule_equals_the_plain_pass(case, bands, dtype):
    static, fp, st = seeded(case, dtype=dtype)
    terms = drive = None
    if static.tfsf_setup is not None:
        inc = tfsf.advance_einc(st["inc"], fp["coeffs"], 3, static.dt,
                                static.omega, static.tfsf_setup)
        terms = tfsf.record_terms(fp["plan"], inc)
    drive = pallas_fused.point_drive(static, fp, 3)
    names = {fam: [k for v in pallas3d.kernel_psi_terms(
        static, fam).values() for _, k in v]
        for fam in ("E", "H")}
    args = (st["E"], st["H"], {k: st["psi_E"][k] for k in names["E"]},
            {k: st["psi_H"][k] for k in names["H"]}, st.get("J"), fp, terms,
            drive, st.get("K"))
    want = pallas_fused.fused_eh_plain(*args)
    got = emulate(*args, bands=bands)
    for w, g, what in zip(want, got, ("E", "H", "psi_E", "psi_H", "J",
                                      "K")):
        if w is None:
            assert g is None
            continue
        assert set(w) == set(g), what
        for k in w:
            assert torch.equal(w[k], g[k]), f"{case}: {what}/{k}"


@pytest.mark.parametrize("ref_pallas", [True, False],
                         ids=["interpret_kernel", "jnp"])
@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_emulated_step_matches_the_reference(case, ref_pallas, monkeypatch):
    """The port's fused step with the emulated pass in place of the
    plain one, against the reference's recompute-fused step in
    interpret mode (``use_pallas=True`` under ``FDTD3D_NO_PACKED`` and
    ``FDTD3D_FORCE_FUSED``) and its jnp step."""
    for k in ("FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED"):
        monkeypatch.setenv(k, "1")
    monkeypatch.setattr(pallas_fused, "fused_eh_plain", emulate)
    ref = RSim(case_config(case, use_pallas=ref_pallas))
    seed_reference(ref, 7)
    port = TSim(to_port(case_config(case, use_pallas=True)), device="cpu")
    port.state = convert.state_from_reference(np_state(ref))
    ref.advance(8)
    port.advance(8)
    assert ref.step_kind == ("pallas_fused" if ref_pallas else "jnp")
    assert port.step_kind == "fused_plain"
    assert_family_close(np_state(ref),
                        convert.state_to_reference(port.state))

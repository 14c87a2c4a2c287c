"""The work plan of the two-pass CUDA step's launches
(``ops/pallas3d.py``: ``plan_items``, ``material``) and the kernel's
march, checked on the CPU.

``csrc/family.cu`` runs each family's update as a march along x over the
plan's (y, z) tiles: the other family's planes pass through a
shared-memory ring (the tile, a 1-cell halo row and a halo column word,
PEC ghosts as cells never loaded), the x neighbour is the plane before
in the march (E marches up, H down), each section's kernel has only its
class's code compiled in (SLAB: the CPML psi of every axis and the
sources; SOURCE: the TFSF records and the point source; PLAIN:
neither), and the coefficient grids are read only by the items that
reach their box; the others take each grid's background. None of that
shows in a CPU run of the plain version, so:

* at the ladder's main-path geometries (``Examples/vacuum3D_tfsf.txt``
  at 256^3, ``Examples/sphere3D_mie.txt`` at 512^3 with its sphere's
  box, an odd 100x90x71 grid, TFSF planes inside the CPML slabs, no
  CPML on x with a point source), for each family: the owned boxes
  cover every cell once, z cut at multiples of 32 V, each item's class,
  section and grid flag agree with a per-cell predicate over the cells
  it owns, the sections in launch order, each longest first;
* the grid flag's box is the one where the port's ``build_coeffs``
  grids differ from their background, per family;
* an emulation of the march, item by item and plane by plane through the
  ring, each item with its section's code only (the plain version's
  per-cell operations: ``_slab_fix``'s recursion, ``record_adder``'s
  adds, ``packed.family_value``), computes E and then H from that E bit
  for bit as ``e_family_plain`` and ``h_family_plain`` do, in float32
  and bf16, with CPML on every axis, oblique TFSF (records in the
  interior and inside the slabs), Drude J, magnetic Drude K, grids, a
  point source and an odd n3 (one cell a thread, else two); at the
  kernel's tile, at a small one that puts many tiles, halos and ghosts
  in a small grid, and with another ring depth;
* the parameter block (built on CPU tensors, no launch) carries the
  plan, the record table, the point source and each grid's background.

Tolerance: bit-equal (``torch.equal``) throughout.
"""

import numpy as np
import pytest
import torch

from fdtd3d_torch import cli
from fdtd3d_torch.config import (MaterialsConfig, PmlConfig,
                                 PointSourceConfig, SimConfig, SphereConfig,
                                 TfsfConfig)
from fdtd3d_torch.ops import packed, packed_tb, pallas3d, tfsf
from fdtd3d_torch.solver import (build_coeffs, build_static,
                                 coeffs_to_device, init_state, slab_axes)

AXES = "xyz"

# --------------------------------------------------------------------------
# the plan at the main paths' geometries
# --------------------------------------------------------------------------

VACUUM = "Examples/vacuum3D_tfsf.txt"
MIE = "Examples/sphere3D_mie.txt"

# name -> (command file or None, flags, grid box source, bf16)
CONFIGS = {
    "vacuum256": (VACUUM, ["--same-size", "256"], None, False),
    "vacuum256_bf16": (VACUUM, ["--same-size", "256"], None, True),
    "mie512": (MIE, [], "sphere", False),
    "odd_100x90x71_bf16": (VACUUM, ["--same-size", "0", "--sizex", "100",
                                    "--sizey", "90", "--sizez", "71"],
                           None, True),
    "tfsf_in_slab": (None, ["--3d", "--same-size", "16", "--use-pml",
                            "--pml-size", "3", "--use-tfsf", "--tfsf-margin",
                            "1", "--angle-teta", "30", "--angle-phi", "40",
                            "--angle-psi", "15"], None, False),
    "no_x_cpml_point": (None, [
        "--3d", "--sizex", "40", "--sizey", "36", "--sizez", "30",
        "--use-pml", "--pml-sizex", "0", "--pml-sizey", "4", "--pml-sizez",
        "4", "--point-source", "Ey", "--eps-sphere", "3.0",
        "--eps-sphere-center-x", "20", "--eps-sphere-center-y", "18",
        "--eps-sphere-center-z", "15", "--eps-sphere-radius", "6"],
        "sphere", True),
}


def cli_static(path, flags):
    argv = (cli.read_cmd_file(path) if path else []) + list(flags)
    return build_static(cli.args_to_config(cli.build_parser().parse_args(
        argv)))


def geometry(name, family):
    """(shape, m per axis, the family's records as (axis, plane), the
    point source's cell (E) or None, the grids' box, tile) of a
    configuration, from its static set-up."""
    path, flags, box, bf16 = CONFIGS[name]
    static = cli_static(path, flags)
    m = [0, 0, 0]
    for a, size in slab_axes(static).items():
        m[a] = size
    recs = [(r.axis, r.plane)
            for r in packed_tb.tfsf_records(static)[family]]
    ps = static.cfg.point_source
    point = tuple(ps.position) if ps.enabled and family == "E" else None
    grids = None
    if box == "sphere":
        sph = static.cfg.materials.eps_sphere
        grids = tuple((c - sph.radius, c + sph.radius) for c in sph.center)
    shape = tuple(static.grid_shape)
    tile = pallas3d.default_tile(bf16, shape[2])
    return shape, tuple(m), recs, point, grids, tile


@pytest.fixture(scope="module",
                params=[(n, f) for n in sorted(CONFIGS) for f in "EH"],
                ids=lambda p: f"{p[0]}-{p[1]}")
def planned(request):
    shape, m, recs, point, grids, tile = geometry(*request.param)
    rows, counts = pallas3d.plan_items(shape, m, recs, point, tile[:2],
                                       sms=132, grids=grids)
    return shape, m, recs, point, grids, tile, rows, counts


def test_owned_boxes_cover_the_grid_once(planned):
    shape, m, _, _, _, tile, rows, counts = planned
    assert rows.shape == (sum(counts), pallas3d.PLAN_COLS)
    assert len(counts) == len(pallas3d.SECTIONS)
    j0, k0, ny, nz, x0, x1 = rows[:, :6].T
    assert (ny >= 1).all() and (ny <= tile[0]).all()
    assert (nz >= 1).all() and (nz <= tile[1]).all()
    # z cut at multiples of the tile's width: whole aligned rows, a
    # narrower tile only where z ends; pairs only where n3 is even
    assert (k0 % tile[1] == 0).all()
    assert ((nz == tile[1]) | (k0 + nz == shape[2])).all()
    assert not tile[2] or shape[2] % 2 == 0
    seen = np.zeros(shape, np.int8)
    for r in rows:
        seen[r[4]:r[5], r[0]:r[0] + r[2], r[1]:r[1] + r[3]] += 1
    assert seen.min() == 1 and seen.max() == 1
    # x is cut along its CPML bands: an interior segment has no x slab
    if m[0]:
        assert not ((x0 < m[0]) & (x1 > m[0])).any()
        assert not ((x0 < shape[0] - m[0]) & (x1 > shape[0] - m[0])).any()
    assert (x1 - x0).max() <= max(pallas3d.SEGMENTS)


def test_class_section_and_grid_flag_match_the_cells(planned):
    shape, m, recs, point, grids, _, rows, counts = planned
    in_slab = [np.zeros(n, bool) for n in shape]
    for a in range(3):
        if m[a]:
            in_slab[a][:m[a]] = in_slab[a][shape[a] - m[a]:] = True
    on_rec = [np.zeros(n, bool) for n in shape]
    for axis, plane in recs:
        on_rec[axis][plane] = True
    bounds = np.cumsum((0,) + tuple(counts))
    for q, row in enumerate(rows):
        j0, k0, ny, nz, x0, x1 = (int(v) for v in row[:6])
        idx = (np.arange(x0, x1), np.arange(j0, j0 + ny),
               np.arange(k0, k0 + nz))
        slab = any(in_slab[a][idx[a]].any() for a in range(3))
        source = any(on_rec[a][idx[a]].any() for a in range(3)) or (
            point is not None and all(point[a] in idx[a] for a in range(3)))
        want = pallas3d.SLAB if slab else (
            pallas3d.SOURCE if source else pallas3d.PLAIN)
        assert row[6] == want, (q, tuple(row))
        sec = int(np.searchsorted(bounds, q, side="right")) - 1
        assert pallas3d.SECTIONS[sec] == {
            pallas3d.SLAB: "slab", pallas3d.SOURCE: "source",
            pallas3d.PLAIN: "plain"}[want]
        if grids in (None, ()):
            want_grid = False
        else:
            want_grid = all(idx[a].min() <= grids[a][1]
                            and grids[a][0] <= idx[a].max()
                            for a in range(3))
        assert row[7] == int(want_grid), tuple(row)
    if any(m):
        assert counts[0] > 0, "no slab item"
    if recs or point is not None:
        assert counts[0] + counts[1] > 0
    if min(shape) >= 128:       # small grids: every tile reaches a slab
        assert counts[2] > 0, "no plain item"


def test_sections_longest_first_and_every_sm_fed(planned):
    shape, _, _, _, _, _, rows, counts = planned
    bounds = np.cumsum((0,) + tuple(counts))
    for q in range(len(counts)):
        planes = rows[bounds[q]:bounds[q + 1], 5] \
            - rows[bounds[q]:bounds[q + 1], 4]
        assert (np.diff(planes) <= 0).all(), pallas3d.SECTIONS[q]
    if len(rows) < pallas3d.ITEMS_PER_SM * 132:
        assert (rows[:, 5] - rows[:, 4]).max() <= pallas3d.SEGMENTS[-1]


# --------------------------------------------------------------------------
# small cases: the grid box, the emulated march, the parameter block
# --------------------------------------------------------------------------

BASE = dict(scheme="3D", time_steps=8, dx=1e-3, courant_factor=0.4,
            wavelength=8e-3)
J_MAT = dict(use_drude=True, eps_inf=2.0, omega_p=1e11, gamma=1e10)
K_MAT = dict(use_drude_m=True, mu_inf=1.5, omega_pm=1e11, gamma_m=1e10)
OBLIQUE = dict(enabled=True, angle_teta=30.0, angle_phi=40.0,
               angle_psi=15.0)


def sphere(center, radius, value=1.0):
    return SphereConfig(enabled=True, center=center, radius=radius,
                        value=value)


CASES = {
    # CPML on every axis, an oblique wave: records in the interior
    "cpml_tfsf": dict(size=(20, 18, 22), pml=PmlConfig(size=(3, 3, 3)),
                      tfsf=TfsfConfig(margin=(2, 2, 2), **OBLIQUE)),
    # margin 1 pushes the TFSF planes into the CPML slabs
    "tfsf_in_slab": dict(size=(16, 16, 16), pml=PmlConfig(size=(3, 3, 3)),
                         tfsf=TfsfConfig(margin=(1, 1, 1), **OBLIQUE)),
    # eps and Drude spheres (ca/cb, kj/bj grids, J), a point source, no
    # CPML on y
    "grids_j_point": dict(
        size=(18, 20, 16), pml=PmlConfig(size=(3, 0, 3)),
        point_source=PointSourceConfig(enabled=True, component="Ey",
                                       position=(9, 10, 7)),
        materials=MaterialsConfig(eps_sphere=sphere((9, 10, 8), 4, 3.0),
                                  drude_sphere=sphere((8, 9, 8), 3),
                                  **J_MAT)),
    # double negative: J and K on one sphere, TFSF, a point source
    "dng": dict(size=(16, 18, 20), pml=PmlConfig(size=(3, 3, 3)),
                tfsf=TfsfConfig(margin=(2, 2, 2), **OBLIQUE),
                point_source=PointSourceConfig(enabled=True, component="Ez",
                                               position=(5, 9, 7)),
                materials=MaterialsConfig(
                    drude_sphere=sphere((8, 9, 10), 3),
                    drude_m_sphere=sphere((8, 9, 10), 3), **J_MAT, **K_MAT)),
    # an odd n3: one cell a thread in every build
    "odd_n3": dict(size=(16, 14, 17), pml=PmlConfig(size=(3, 3, 3)),
                   tfsf=TfsfConfig(margin=(2, 2, 2), **OBLIQUE),
                   materials=MaterialsConfig(
                       eps_sphere=sphere((8, 7, 9), 4, 2.5))),
}


def static_of(case, dtype="float32"):
    return build_static(SimConfig(**dict(BASE, dtype=dtype), **CASES[case]))


def seeded(case, dtype="float32", seed=7):
    """(static, prepared operands, state) with every leaf of the state
    seeded from numpy at 0.01 (E and H rounded to the storage dtype)."""
    static = static_of(case, dtype)
    coeffs = coeffs_to_device(build_coeffs(static), "cpu")
    state = init_state(static, "cpu")
    rng = np.random.RandomState(seed)
    for grp in ("E", "H", "J", "K", "psi_E", "psi_H", "inc"):
        for v in state.get(grp, {}).values():
            v.copy_(torch.from_numpy(0.01 * rng.standard_normal(
                v.shape).astype(np.float32)))
    return static, pallas3d.prepare(static, coeffs), state


def grid_keys(static, family):
    mode = static.mode
    if family == "E":
        comps = mode.e_components
        keys = ["ca", "cb"] + (["kj", "bj"] if static.use_drude else [])
    else:
        comps = mode.h_components
        keys = ["da", "db"] + (["km", "bm"] if static.use_drude_m else [])
    return [f"{k}_{c}" for k in keys for c in comps]


@pytest.mark.parametrize("case", ["grids_j_point", "dng", "odd_n3"])
def test_grid_flag_marks_the_items_reaching_the_box(case):
    """Per family, the box is where the port's grids differ from their
    background; the plan flags exactly the items whose owned cells
    reach it."""
    static, fp, _ = seeded(case)
    np_coeffs = build_coeffs(static)
    for family in "EH":
        arrays = [np.asarray(np_coeffs[k]) for k in grid_keys(static, family)
                  if np.ndim(np_coeffs[k]) == 3]
        grids, background = pallas3d.material(fp, family)
        if not arrays:
            assert grids is None and background == {}
            continue
        differs = np.zeros(static.grid_shape, bool)
        for arr in arrays:
            differs |= arr != arr[0, 0, 0]
        box = tuple((int(v.min()), int(v.max())) for v in np.nonzero(differs))
        assert grids == box and len(background) == len(arrays)
        inside = np.zeros(static.grid_shape, bool)
        inside[tuple(slice(lo, hi + 1) for lo, hi in box)] = True
        m, recs, point = pallas3d.plan_geometry(fp, family)
        rows, _ = pallas3d.plan_items(static.grid_shape, m, recs, point,
                                      (3, 4), grids=grids)
        for r in rows:
            own = tuple(slice(lo, hi + 1) for lo, hi in packed.item_box(r))
            assert bool(r[7]) == bool(inside[own].any())


# --------------------------------------------------------------------------
# the march, emulated
# --------------------------------------------------------------------------

def _slab_plane(ia, n, m):
    return ia if ia < m else (ia - (n - 2 * m) if ia >= n - m else -1)


def _coef(v, grid, bg, cut):
    """A coefficient on a tile: its grid where the item reads grids, else
    its scalar or its grid's background."""
    if not isinstance(v, torch.Tensor):
        return v
    return v[cut] if grid else bg


def _slab_fix(fc, psi, out_psi, key, a, sgn, dfa, i, j0, k0, ny, nz):
    """The CPML slab correction of a curl term along axis a on a tile
    (zero off the slab), the new compact psi written into ``out_psi``
    where the slab is, in ``solver._slab_delta``'s operations."""
    shape, m = fc["shape"], fc["m"][a]
    js = torch.arange(j0, j0 + ny).reshape(ny, 1).expand(ny, nz)
    ks = torch.arange(k0, k0 + nz).reshape(1, nz).expand(ny, nz)
    along = ([i], range(j0, j0 + ny), range(k0, k0 + nz))[a]
    q = torch.tensor([_slab_plane(v, shape[a], m) for v in along])
    q = q.reshape((1, 1) if a == 0 else (ny, 1) if a == 1 else (1, nz))
    q = q.expand(ny, nz)
    mask = q >= 0
    fix = torch.zeros_like(dfa)
    if not bool(mask.any()):
        return fix
    qm = q[mask]
    idx = [torch.full_like(qm, i), js[mask], ks[mask]]
    idx[a] = qm
    b, cc, ik = (fc["prof"][a][r][qm] for r in range(3))
    d = dfa[0][mask]
    p = b * psi[key][tuple(idx)] + cc * d
    out_psi[key][tuple(idx)] = p
    fix[0][mask] = sgn * ((ik - 1.0) * d + p)
    return fix


def emulate(F, S, psi, J, fp, family, terms, drive, tile, pipe=2, sms=132):
    """One family's update as the kernels schedule it: (new fields, new
    psi, new ADE current or None). The plan's items in order, each with
    its section's code only; in each, the planes of its x segment in the
    march's direction, the other family's plane loaded into a ring of
    pipe + 1 slots (the tile, the halo row, the halo column word; ring
    cells never loaded stay 0, the PEC ghosts), the x neighbour from the
    plane before in the march. Cells no item writes stay NaN."""
    fc = fp[family]
    backward = family == "E"
    shape = fc["shape"]
    n1, n2, n3 = shape
    other = "H" if backward else "E"
    s = torch.stack([S[other + ax] for ax in AXES])
    fd = F[fc["comps"][0]].dtype
    v_cells = 2 if pallas3d.pairs_for(fd == torch.bfloat16, n3) else 1
    ty, tz = tile[0], tile[1] * v_cells
    grids, background = pallas3d.material(fp, family)
    m, recs, point = pallas3d.plan_geometry(fp, family)
    rows, counts = pallas3d.plan_items(shape, m, recs, point, (ty, tz), sms,
                                       grids)
    bounds = np.cumsum((0,) + tuple(counts))
    nan = float("nan")
    out = {c: torch.full(shape, nan) for c in fc["comps"]}
    out_j = None if J is None else {c: torch.full(shape, nan) for c in J}
    out_psi = {k: torch.full_like(v, nan) for k, v in psi.items()}
    rw, slots = tz + v_cells, pipe + 1
    col0 = v_cells if backward else 0
    hcol = 0 if backward else tz
    r0 = 1 if backward else 0
    for q, row in enumerate(rows):
        j0, k0, ny, nz, x0, x1, _, grid = (int(v) for v in row)
        sec = int(np.searchsorted(bounds, q, side="right")) - 1
        slab_code, src = sec == 0, sec != 2
        ring = torch.zeros((slots, 3, ty + 1, rw), dtype=s.dtype)
        hj = j0 - 1 if backward else j0 + ny
        hrow = 0 if backward else ny
        hk = k0 - v_cells if backward else k0 + tz
        hcol_in = k0 > 0 if backward else (nz == tz and k0 + tz < n3)
        ys, zs = slice(j0, j0 + ny), slice(k0, k0 + nz)

        def load(i, slot):
            ring[slot, :, r0:r0 + ny, col0:col0 + nz] = s[:, i, ys, zs]
            if 0 <= hj < n2:
                ring[slot, 0::2, hrow, col0:col0 + nz] = s[0::2, i, hj, zs]
            if hcol_in:
                ring[slot, :2, r0:r0 + ny, hcol:hcol + v_cells] = \
                    s[:2, i, ys, hk:hk + v_cells]

        d = 1 if backward else -1
        start, count = (x0 if backward else x1 - 1), x1 - x0
        xi = start - d
        xn = s[1:3, xi, ys, zs].float() if 0 <= xi < n1 \
            else torch.zeros((2, ny, nz))
        for p in range(pipe):
            if p < count:
                load(start + p * d, p % slots)
        for step in range(count):
            i = start + step * d
            if step + pipe < count:
                load(i + pipe * d, (step + pipe) % slots)
            rg = ring[step % slots].float()
            here = rg[:, r0:r0 + ny, col0:col0 + nz]
            dy = -1 if backward else 1
            ynb = rg[:, r0 + dy:r0 + dy + ny, col0:col0 + nz]
            znb = rg[:, r0:r0 + ny, col0 + dy:col0 + dy + nz]
            cut = (slice(i, i + 1), ys, zs)
            walls = [fc["wall"][0][i:i + 1], fc["wall"][1][ys],
                     fc["wall"][2][zs]]
            for ci, c in enumerate(fc["comps"]):
                psi_of = dict(fc["psi"][c])
                acc = None
                for t in range(2):
                    a, dd = (ci + 1 + t) % 3, (ci + 2 - t) % 3
                    sgn = 1.0 if t == 0 else -1.0
                    nb = (xn[dd - 1], ynb[dd], znb[dd])[a]
                    d0 = here[dd] - nb if backward else nb - here[dd]
                    dfa = d0.unsqueeze(0) * fc["inv_dx"]
                    term = sgn * dfa
                    if slab_code and t in psi_of:
                        term = term + _slab_fix(fc, psi, out_psi, psi_of[t],
                                                a, sgn, dfa, i, j0, k0, ny,
                                                nz)
                    acc = term if acc is None else acc + term
                if src and terms is not None:
                    for comp, axis, plane, off in fp[f"rec_{family}"]:
                        lo, n = (i, j0, k0)[axis], (1, ny, nz)[axis]
                        if comp != ci or not lo <= plane < lo + n:
                            continue
                        ps = tfsf.plane_shape(shape, axis)
                        on_tile = list(cut)
                        on_tile[axis] = slice(0, 1)
                        term = terms.narrow(0, off, int(np.prod(ps)))
                        acc.narrow(axis, plane - lo, 1).add_(
                            term.reshape(ps)[tuple(on_tile)])
                hook = None
                if src and backward and drive is not None \
                        and fp["point"][0] == ci:
                    pi, pj, pk = fp["point"][1]
                    if pi == i and j0 <= pj < j0 + ny and k0 <= pk < k0 + nz:
                        def hook(v, pj=pj, pk=pk):
                            v[0:1, pj - j0:pj - j0 + 1,
                              pk - k0:pk - k0 + 1] += drive
                            return v
                drude = None
                if J is not None:
                    drude = (J[c][cut],
                             _coef(fc["kj"][ci], grid,
                                   background.get(("kj", ci)), cut),
                             _coef(fc["bj"][ci], grid,
                                   background.get(("bj", ci)), cut))
                val, jn, _ = packed.family_value(
                    ci, F[c][cut].float(), acc,
                    _coef(fc["a"][ci], grid, background.get(("a", ci)), cut),
                    _coef(fc["b"][ci], grid, background.get(("b", ci)), cut),
                    walls, backward, drude, hook)
                out[c][cut] = val
                if jn is not None:
                    out_j[c][cut] = jn
            xn = here[1:3].clone()
    return pallas3d.stored(out, F), out_psi, out_j


def kernel_inputs(static, fp, st, t=3):
    """The two launches' sources at step t: the record terms after the
    E-incident advance, the point source's drive, each family's psi."""
    terms = None
    if static.tfsf_setup is not None:
        inc = tfsf.advance_einc(st["inc"], fp["coeffs"], t, static.dt,
                                static.omega, static.tfsf_setup)
        terms = tfsf.record_terms(fp["plan"], inc)
    psi = {fam: {k: st[f"psi_{fam}"][k] for v in fp[fam]["psi"].values()
                 for _, k in v} for fam in "EH"}
    return terms, pallas3d.point_drive(static, fp, t), psi


def assert_outputs_equal(got, want, what):
    for g, w, name in zip(got, want, ("fields", "psi", "ADE current")):
        if w is None:
            assert g is None, (what, name)
            continue
        assert set(g) == set(w), (what, name)
        for k in w:
            assert g[k].dtype == w[k].dtype, (what, name, k)
            assert torch.equal(g[k], w[k]), \
                f"{what}: {name} {k} max |diff| " \
                f"{float((g[k].float() - w[k].float()).abs().max())}"


def run_both(case, dtype, tile, pipe=2):
    """E and then H from that E, by the emulation and by the plain
    versions."""
    static, fp, st = seeded(case, dtype)
    terms, drive, psi = kernel_inputs(static, fp, st)
    want_e = pallas3d.e_family_plain(st["E"], st["H"], psi["E"],
                                     st.get("J"), fp, terms, drive)
    got_e = emulate(st["E"], st["H"], psi["E"], st.get("J"), fp, "E", terms,
                    drive, tile, pipe)
    assert_outputs_equal(got_e, want_e, f"{case} {dtype} E")
    want_h = pallas3d.h_family_plain(st["H"], want_e[0], psi["H"], fp,
                                     st.get("K"), terms)
    got_h = emulate(st["H"], want_e[0], psi["H"], st.get("K"), fp, "H",
                    terms, None, tile, pipe)
    assert_outputs_equal(got_h, want_h, f"{case} {dtype} H")
    return fp


@pytest.mark.parametrize("tile", [(pallas3d.TILE_ROWS, pallas3d.WARP),
                                  (3, 4)], ids=["kernel_tile", "small_tile"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_march_equals_the_plain_update(case, dtype, tile):
    run_both(case, dtype, tile)


@pytest.mark.parametrize("pipe", [1, 3])
def test_emulated_march_with_another_ring_depth(pipe):
    """Planes fewer or more ahead, in a ring of fewer or more slots,
    leave the result as it is (the build knob PIPE; as built: 2)."""
    run_both("dng", "bfloat16", (3, 4), pipe)


def test_small_tiles_exercise_every_section():
    """The small-tile emulation above runs items of all three sections
    in each family, over the cases (so each section's compiled-out code
    is tested)."""
    seen = {"E": [0, 0, 0], "H": [0, 0, 0]}
    for case in CASES:
        static, fp, _ = seeded(case)
        for family in "EH":
            m, recs, point = pallas3d.plan_geometry(fp, family)
            _, counts = pallas3d.plan_items(static.grid_shape, m, recs,
                                            point, (3, 4))
            seen[family] = [a + b for a, b in zip(seen[family], counts)]
    assert all(n > 0 for v in seen.values() for n in v), seen


@pytest.mark.parametrize("case,dtype,pairs", [
    ("grids_j_point", "float32", True), ("grids_j_point", "bfloat16", True),
    ("odd_n3", "bfloat16", False), ("odd_n3", "float32", False),
    ("dng", "float32", True)])
def test_parameter_blocks_carry_plan_records_and_backgrounds(case, dtype,
                                                             pairs):
    """The launch parameter block of each family (on CPU tensors, no
    launch): the plan of the tile (two cells a thread where n3 is even),
    its section counts, the family's record table, the point
    source on E only, each grid's pointer with its background as the
    scalar, and fresh outputs."""
    static, fp, st = seeded(case, dtype)
    terms, drive, psi = kernel_inputs(static, fp, st)
    for family, F, S, J in (("E", st["E"], st["H"], st.get("J")),
                            ("H", st["H"], st["E"], st.get("K"))):
        prm, new_f, new_psi, new_j = pallas3d._params(
            F, S, psi[family], J, fp, family, terms,
            drive if family == "E" else None)
        assert prm.pairs == int(pairs)
        rows, counts = fp[f"_plan_{family}"][1]
        assert prm.plan == rows.data_ptr()
        assert tuple(prm.n_item) == counts and len(rows) == sum(counts)
        assert (rows[:, 1].numpy() % (64 if pairs else 32) == 0).all()
        table = fp[f"rec_{family}"]
        assert prm.n_rec == len(table)
        for r, (comp, axis, plane, off) in enumerate(table):
            assert (prm.rec[r].comp, prm.rec[r].axis, prm.rec[r].plane,
                    prm.rec[r].off) == (comp, axis, plane, off)
        if table:
            assert prm.terms == terms.data_ptr()
        if family == "E" and fp["point"] is not None:
            assert (prm.pc, (prm.pi, prm.pj, prm.pk)) == fp["point"]
            assert prm.drive == np.float32(drive)
        else:
            assert prm.pc == -1
        fc = fp[family]
        for (key, c), value in pallas3d.material(fp, family)[1].items():
            blk = prm.dr if key in ("kj", "bj") else prm.f
            assert getattr(blk, key)[c].val == np.float32(value)
            assert getattr(blk, key)[c].grid == fc[key][c].data_ptr()
        assert set(new_f) == set(F) and all(
            new_f[c].data_ptr() != F[c].data_ptr() for c in F)
        assert set(new_psi) == set(psi[family])
        assert (new_j is None) == (J is None)
        assert list(prm.g.m) == [fc["m"].get(a, 0) for a in range(3)]

"""The work plan of the packed CUDA step's two launches
(``ops/packed.py``: ``plan_items``, ``material``) and the kernel's march,
checked on the CPU.

``csrc/packed_eh.cu`` runs each family's update as a march along x over
the plan's (y, z) tiles: the other family's planes pass through a
shared-memory ring (the tile, a 1-cell halo row and a halo column word,
PEC ghosts as cells never loaded), the x neighbour is the plane before
in the march (E marches up, H down), and the coefficient grids are read
only by the items that reach their box; the others take each grid's
background. None of that shows in a CPU run of the plain version, so:

* the plan covers every owned cell of every lane exactly once, with
  z cuts at multiples of the tile's width (whole aligned rows), the slab
  items first, each section's items longest first;
* the grid flag is set exactly on the items whose cells reach the box
  outside which every grid of the family holds its background value,
  computed here on the port's ``build_coeffs`` output (held bit-equal to
  the reference's by tests/test_torch_setup.py);
* an emulation of the march, item by item and plane by plane through the
  ring (with the plain version's per-cell arithmetic:
  ``packed.scaled_diff``, the slab recursion of ``solver._slab_delta``,
  ``packed.family_value``), updates E and then H in place bit for bit as
  ``e_update_plain`` and ``h_update_plain`` do, in float32, bf16 and
  compensated mode, with J, K, grids, CPML on all three axes, an odd n3
  (one cell a thread) and 3 lanes; at the kernel's tile and at a small
  one that puts many tiles, halos and ghosts in a small grid.

Tolerance: bit-equal (``torch.equal``) throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fdtd3d_torch.config import (MaterialsConfig, PmlConfig,
                                 PointSourceConfig, SimConfig, SphereConfig,
                                 TfsfConfig)
from fdtd3d_torch.ops import packed
from fdtd3d_torch.solver import (build_coeffs, build_static,
                                 coeffs_to_device, init_state, slab_axes)

BASE = dict(scheme="3D", time_steps=8, dx=1e-3, courant_factor=0.4,
            wavelength=8e-3)
K_MAT = dict(use_drude_m=True, mu_inf=1.5, omega_pm=1e11, gamma_m=1e10)
J_MAT = dict(use_drude=True, eps_inf=2.0, omega_p=1e11, gamma=1e10)


def sphere(center, radius, value=1.0):
    return SphereConfig(enabled=True, center=center, radius=radius,
                        value=value)


CASES = {
    # CPML on every axis, an oblique TFSF wave (no grid)
    "cpml_xyz": dict(size=(20, 18, 22), pml=PmlConfig(size=(3, 3, 3)),
                     tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2),
                                     angle_teta=30.0, angle_phi=40.0)),
    # an eps sphere and a Drude sphere: ca/cb and kj/bj grids, J
    "grids_j": dict(size=(18, 20, 16), pml=PmlConfig(size=(3, 0, 3)),
                    materials=MaterialsConfig(
                        eps_sphere=sphere((9, 10, 8), 4, 3.0),
                        drude_sphere=sphere((8, 9, 8), 3), **J_MAT)),
    # a K sphere: da/db and km/bm grids on H, K
    "k_sphere": dict(size=(16, 16, 16), pml=PmlConfig(size=(3, 3, 3)),
                     materials=MaterialsConfig(
                         drude_m_sphere=sphere((8, 8, 8), 3), **K_MAT)),
    # double negative: J and K on one sphere, a point source
    "dng": dict(size=(16, 18, 20), pml=PmlConfig(size=(3, 3, 3)),
                point_source=PointSourceConfig(enabled=True, component="Ez",
                                               position=(5, 9, 7)),
                materials=MaterialsConfig(
                    drude_sphere=sphere((8, 9, 10), 3),
                    drude_m_sphere=sphere((8, 9, 10), 3), **J_MAT, **K_MAT)),
    # an odd n3: one cell a thread in every build
    "odd_n3": dict(size=(16, 14, 17), pml=PmlConfig(size=(3, 3, 3)),
                   materials=MaterialsConfig(
                       eps_sphere=sphere((8, 7, 9), 4, 2.5))),
}
# compensated mode takes scalar coefficients only
COMP_CASES = {
    "comp_cpml": dict(size=(18, 16, 20), pml=PmlConfig(size=(3, 3, 3)),
                      point_source=PointSourceConfig(
                          enabled=True, component="Ez", position=(9, 8, 10)),
                      compensated=True),
    "comp_odd": dict(size=(17, 17, 17), compensated=True),
}
EPS_LANES = (2.0, 4.0, 6.0)   # the eps sphere of each of 3 lanes


def static_of(case, dtype="float32", **kw):
    spec = dict(CASES, **COMP_CASES)[case]
    return build_static(SimConfig(**dict(BASE, dtype=dtype),
                                  **dict(spec, **kw)))


def families(static):
    """The packed step's per-family operands on the CPU."""
    coeffs = coeffs_to_device(build_coeffs(static), "cpu")
    return (packed.prepare_family(static, coeffs, "E"),
            packed.prepare_family(static, coeffs, "H"))


def seeded_carry(static, seed):
    """A packed carry with every leaf seeded from numpy (E, H, J, K and
    psi at 0.01, the bf16 residuals at 1e-10), fields rounded to the
    storage dtype."""
    carry = packed.pack(init_state(static, "cpu"), static)
    rng = np.random.RandomState(seed)
    for key in ("E", "H", "J", "K", "rE", "rH", "psE", "psH"):
        vals = carry.get(key)
        if vals is None:
            continue
        for v in (vals.values() if isinstance(vals, dict) else [vals]):
            scale = 1e-10 if key in ("rE", "rH") else 0.01
            v.copy_(torch.from_numpy(scale * rng.standard_normal(
                v.shape).astype(np.float32)))
    return carry


def lane_stack(items):
    """Stack per-lane operands: tensors along a new lane axis, dicts key
    by key; equal host scalars stay one scalar."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, dict):
        return {k: lane_stack([it[k] for it in items]) for k in first}
    assert all(it == first for it in items[1:])
    return first


def lanes_of(case, dtype):
    """(fe, fh, carry) of 3 lanes: per-lane eps-sphere grids (or, in
    compensated mode, scalar coefficients shared by every lane), every
    carry leaf seeded per lane."""
    comp = case in COMP_CASES
    fams, carries = [], []
    for q, eps in enumerate(EPS_LANES):
        kw = {}
        if not comp:
            kw["materials"] = dataclasses.replace(
                dict(CASES, **COMP_CASES)[case]["materials"],
                eps_sphere=sphere((8, 9, 8), 4, eps))
        static = static_of(case, dtype, **kw)
        fams.append(families(static))
        carries.append(seeded_carry(static, 100 + q))
    fe, fh = ({**f[0], **{k: [lane_stack([x[k][c] for x in f])
                               for c in range(3)]
                          for k in ("a", "b", "kj", "bj")
                          if f[0][k] is not None}}
              for f in ([x[0] for x in fams], [x[1] for x in fams]))
    carry = {k: lane_stack([c[k] for c in carries])
             for k in carries[0] if k not in ("t", "inc")}
    return fe, fh, carry


def m_of(fc):
    return [fc["m"].get(a, 0) for a in range(3)]


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

# name -> (shape, m per axis, lanes, tile)
GEOMETRIES = {
    "vacuum256_f32": ((256, 256, 256), (11, 11, 11), 1, (8, 32)),
    "vacuum256_pairs": ((256, 256, 256), (11, 11, 11), 1, (8, 64)),
    "mie512_4lanes": ((512, 512, 512), (11, 11, 11), 4, (8, 32)),
    "odd_100x90x70": ((100, 90, 70), (11, 11, 11), 1, (8, 32)),
    "no_x_cpml": ((40, 36, 30), (0, 5, 5), 3, (8, 64)),
    "cavity17": ((17, 17, 17), (0, 0, 0), 1, (8, 32)),
    "small_tile": ((20, 18, 22), (4, 4, 4), 2, (3, 4)),
}


def one_d_cuts(rows, cols):
    return sorted({tuple(int(v) for v in r[list(cols)]) for r in rows})


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_plan_tiles_every_lane_once(geom):
    shape, m, lanes, tile = GEOMETRIES[geom]
    rows, counts = packed.plan_items(shape, m, lanes, tile)
    assert rows.shape == (sum(counts), packed.PLAN_COLS)
    j0, k0, ny, nz, x0, x1, lane, flags = rows.T
    assert (ny >= 1).all() and (ny <= tile[0]).all()
    assert (nz >= 1).all() and (nz <= tile[1]).all()
    # z cut at multiples of the tile's width: whole aligned rows, a
    # narrower tile only where z ends
    assert (k0 % tile[1] == 0).all()
    assert ((nz == tile[1]) | (k0 + nz == shape[2])).all()
    # every lane's owned boxes tile its grid exactly once: each axis's
    # cuts partition it, and every lane has every product of them once
    for lo, n, size in ((x0, shape[0], x1 - x0), (j0, shape[1], ny),
                        (k0, shape[2], nz)):
        cuts = sorted(set(zip(lo.tolist(), size.tolist())))
        assert cuts[0][0] == 0 and sum(s for _, s in cuts) == n
        assert all(a + s == b for (a, s), (b, _) in zip(cuts, cuts[1:]))
    boxes = [tuple(r) for r in rows[:, :7].tolist()]
    assert len(set(boxes)) == len(boxes)
    per_lane = len(one_d_cuts(rows, (4, 5))) * len(one_d_cuts(rows, (0, 2))) \
        * len(one_d_cuts(rows, (1, 3)))
    assert sorted(np.bincount(lane, minlength=lanes).tolist()) \
        == [per_lane] * lanes
    if np.prod(shape) * lanes <= 10 ** 6:      # and cell by cell
        seen = np.zeros((lanes,) + tuple(shape), np.int32)
        for r in rows:
            seen[r[6], r[4]:r[5], r[0]:r[0] + r[2], r[1]:r[1] + r[3]] += 1
        assert (seen == 1).all()
    # the slab items first; each section longest first; the slab flag
    # is a CPML slab cell in the owned box
    for q, r in enumerate(rows):
        box = packed.item_box(r)
        slab = any(m[a] > 0 and (box[a][0] < m[a]
                                 or box[a][1] >= shape[a] - m[a])
                   for a in range(3))
        assert bool(r[7] & packed.SLAB) == slab
        assert (q < counts[0]) == slab
    for sec in (rows[:counts[0]], rows[counts[0]:]):
        planes = sec[:, 5] - sec[:, 4]
        assert (np.diff(planes) <= 0).all()
    # x is cut along its CPML bands: an interior segment has no x slab
    if m[0]:
        assert not ((x0 < m[0]) & (x1 > m[0])).any()
        assert not ((x0 < shape[0] - m[0]) & (x1 > shape[0] - m[0])).any()
    # without sections every item runs the slab kernel
    flat, flat_counts = packed.plan_items(shape, m, lanes, tile,
                                          sections=False)
    assert flat_counts == (len(rows), 0)


def test_plan_gives_every_sm_its_items():
    """The x segments are the longest of ``SEGMENTS`` that give the card's
    SMs ``ITEMS_PER_SM`` items each."""
    rows, _ = packed.plan_items((256, 256, 256), (11, 11, 11), 1, (8, 32))
    assert len(rows) >= packed.ITEMS_PER_SM * 132
    assert (rows[:, 5] - rows[:, 4]).max() == packed.SEGMENTS[0]
    few, _ = packed.plan_items((32, 32, 32), (0, 0, 0), 1, (8, 32))
    assert (few[:, 5] - few[:, 4]).max() == packed.SEGMENTS[-1]


def grid_keys(static, family):
    mode = static.mode
    if family == "E":
        comps = mode.e_components
        keys = ["ca", "cb"] + (["kj", "bj"] if static.use_drude else [])
    else:
        comps = mode.h_components
        keys = ["da", "db"] + (["km", "bm"] if static.use_drude_m else [])
    return [f"{k}_{c}" for k in keys for c in comps]


@pytest.mark.parametrize("case", ["grids_j", "k_sphere", "dng", "odd_n3",
                                  "cpml_xyz"])
def test_grid_flag_marks_the_items_reaching_the_box(case):
    static = static_of(case)
    np_coeffs = build_coeffs(static)
    fe, fh = families(static)
    for family, fc in (("E", fe), ("H", fh)):
        arrays = [np.asarray(np_coeffs[k]) for k in grid_keys(static, family)
                  if np.ndim(np_coeffs[k]) == 3]
        grids, background = packed.material(fc)
        if not arrays:
            assert grids is None and background == {}
            continue
        # the box from the port's coefficients, cell by cell in numpy
        differs = np.zeros(static.grid_shape, bool)
        for arr in arrays:
            differs |= arr != arr[0, 0, 0]
        idx = np.nonzero(differs)
        box = tuple((int(v.min()), int(v.max())) for v in idx)
        assert grids == box
        assert len(background) == len(arrays)
        # every grid holds its background outside the box
        inside = np.zeros(static.grid_shape, bool)
        inside[tuple(slice(lo, hi + 1) for lo, hi in box)] = True
        for (key, c), value in background.items():
            arr = fc[key][c].numpy()
            assert arr[0, 0, 0] == np.float32(value)
            assert (arr[~inside] == np.float32(value)).all()
        rows, _ = packed.plan_items(static.grid_shape, m_of(fc), 1, (4, 8),
                                    grids=grids)
        for r in rows:
            own = tuple(slice(lo, hi + 1) for lo, hi in packed.item_box(r))
            assert bool(r[7] & packed.GRID) == bool(inside[own].any())
        # the launch block carries each grid's background as its scalar
        carry = packed.pack(init_state(static, "cpu"), static)
        F, S, J = ("E", "H", "J") if family == "E" else ("H", "E", "K")
        prm = packed._params(carry[F], carry[S], carry.get(J),
                             carry["ps" + family], fc)
        for (key, c), value in background.items():
            assert getattr(prm, key)[c].val == np.float32(value)
            assert getattr(prm, key)[c].grid == fc[key][c].data_ptr()


def test_lanes_take_the_union_of_their_boxes():
    fe, _, _ = lanes_of("grids_j", "float32")
    grids, background = packed.material(fe)
    lanes = [packed.material(packed.lane_fc(fe, q))[0]
             for q in range(len(EPS_LANES))]
    assert grids == tuple((min(b[a][0] for b in lanes),
                           max(b[a][1] for b in lanes)) for a in range(3))
    # a grid whose corner differs between lanes is read everywhere
    bad = dict(fe, a=[fe["a"][0].clone()] + fe["a"][1:])
    bad["a"][0][1, 0, 0, 0] += 1.0
    assert packed.material(bad) == ("all", {})


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


def _slab_term(fc, psi, a, c, sgn, dfa, i, j0, k0, ny, nz):
    """The CPML slab term of component c's curl term along axis a on a
    tile (zero off the slab), psi updated in place where the slab is, in
    ``solver._slab_delta``'s operations."""
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
    row = psi[a][packed.psi_row(c, a)]
    b, cc, ik = (fc["prof"][a][r][qm] for r in range(3))
    d = dfa[0][mask]
    p = b * row[tuple(idx)] + cc * d
    row[tuple(idx)] = p
    fix[0][mask] = sgn * ((ik - 1.0) * d + p)
    return fix


def emulate(F, S, J, psi, fc, R, backward, tile, pipe=2, sms=132):
    """One family's update as the kernel schedules it, in place: the
    plan's items in order; in each, the planes of its x segment in the
    march's direction, the other family's plane loaded into a ring of
    pipe + 1 slots (the tile, the halo row, the halo column word; ring
    cells never loaded stay 0, the PEC ghosts), the x neighbour from the
    plane before in the march."""
    shape = fc["shape"]
    n1, n2, n3 = shape
    lanes, _ = packed.carry_lanes(F)
    pairs = packed.pairs_for(F.dtype == torch.bfloat16,
                             fc["comp"] is not None, n3)
    ty, tz = tile
    v_cells = 2 if pairs else 1
    tz *= v_cells
    grids, background = packed.material(fc)
    rows, _ = packed.plan_items(shape, m_of(fc), lanes, (ty, tz), sms, grids)
    rw, slots = tz + v_cells, pipe + 1
    col0 = v_cells if backward else 0
    hcol = 0 if backward else tz
    r0 = 1 if backward else 0
    for row in rows:
        j0, k0, ny, nz, x0, x1, lane, flags = (int(v) for v in row)
        grid = bool(flags & packed.GRID)
        if F.dim() == 5:
            f, s, jj, ps = F[lane], S[lane], \
                None if J is None else J[lane], \
                {a: v[lane] for a, v in psi.items()}
            r = None if R is None else R[lane]
            fl = packed.lane_fc(fc, lane)
        else:
            f, s, jj, ps, r, fl = F, S, J, psi, R, fc
        ring = torch.zeros((slots, 3, ty + 1, rw), dtype=S.dtype)
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
        for q in range(pipe):
            if q < count:
                load(start + q * d, q % slots)
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
            walls = [fl["wall"][0][i:i + 1], fl["wall"][1][ys],
                     fl["wall"][2][zs]]
            for c in range(3):
                acc = None
                for t in range(2):
                    a, dd = (c + 1 + t) % 3, (c + 2 - t) % 3
                    sgn = 1.0 if t == 0 else -1.0
                    nb = (xn[dd - 1], ynb[dd], znb[dd])[a]
                    d0 = (here[dd] - nb if backward else nb - here[dd])
                    dfa = packed.scaled_diff(d0.unsqueeze(0), fl)
                    if a in fl["m"]:
                        fix = _slab_term(fl, ps, a, c, sgn, dfa, i, j0, k0,
                                         ny, nz)
                        acc = fix if acc is None else acc + fix
                    acc = sgn * dfa if acc is None else acc + sgn * dfa
                drude = None
                if jj is not None:
                    drude = (jj[c][cut],
                             _coef(fl["kj"][c], grid,
                                   background.get(("kj", c)), cut),
                             _coef(fl["bj"][c], grid,
                                   background.get(("bj", c)), cut))
                comp = None if fl["comp"] is None else (
                    fl["comp"]["a_lo"][c], fl["comp"]["b_lo"][c], r[c][cut])
                val, jn, rn = packed.family_value(
                    c, f[c][cut].float(), acc,
                    _coef(fl["a"][c], grid, background.get(("a", c)), cut),
                    _coef(fl["b"][c], grid, background.get(("b", c)), cut),
                    walls, backward, drude, None, comp)
                f[c][cut].copy_(val)
                if jn is not None:
                    jj[c][cut].copy_(jn)
                if rn is not None:
                    r[c][cut].copy_(rn)
            xn = here[1:3].clone()


def clone(carry):
    return {k: ({a: t.clone() for a, t in v.items()} if isinstance(v, dict)
                else v.clone()) for k, v in carry.items()
            if isinstance(v, (dict, torch.Tensor))}


def run_step(carry, fe, fh, e_fn, h_fn):
    e_fn(carry["E"], carry["H"], carry.get("J"), carry["psE"], fe,
         carry.get("rE"))
    h_fn(carry["H"], carry["E"], carry.get("K"), carry["psH"], fh,
         carry.get("rH"))


def assert_carries_equal(got, want, what):
    for k, v in want.items():
        pairs = v.items() if isinstance(v, dict) else [(None, v)]
        for a, w in pairs:
            g = got[k] if a is None else got[k][a]
            assert g.dtype == w.dtype, (what, k, a)
            assert torch.equal(g, w), f"{what}: {k}{'' if a is None else a} " \
                f"max |diff| {float((g.float() - w.float()).abs().max())}"


EMU = [(c, d) for c in sorted(CASES) for d in ("float32", "bfloat16")] \
    + [(c, "float32") for c in sorted(COMP_CASES)]


@pytest.mark.parametrize("tile", [(packed.TILE_ROWS, packed.WARP), (3, 4)],
                         ids=["kernel_tile", "small_tile"])
@pytest.mark.parametrize("case,dtype", EMU)
def test_emulated_march_equals_the_plain_update(case, dtype, tile):
    static = static_of(case, dtype)
    fe, fh = families(static)
    carry = seeded_carry(static, 7)
    want, got = clone(carry), clone(carry)
    run_step(want, fe, fh, packed.e_update_plain,
             lambda H, E, K, psi, fc, R: packed.h_update_plain(
                 H, E, psi, fc, K, R))
    run_step(got, fe, fh,
             lambda E, H, J, psi, fc, R: emulate(E, H, J, psi, fc, R, True,
                                                 tile),
             lambda H, E, K, psi, fc, R: emulate(H, E, K, psi, fc, R, False,
                                                 tile))
    assert_carries_equal(got, want, f"{case} {dtype} {tile}")


@pytest.mark.parametrize("case,dtype", [("grids_j", "float32"),
                                        ("grids_j", "bfloat16"),
                                        ("comp_cpml", "float32")])
def test_emulated_march_over_three_lanes(case, dtype):
    """3 lanes in one plan (the lane a column of its rows), per-lane
    grids (their boxes' union) or compensated lanes with scalar
    coefficients, against the plain version lane by lane."""
    fe, fh, carry = lanes_of(case, dtype)
    want, got = clone(carry), clone(carry)
    run_step(want, fe, fh, packed.e_update_plain,
             lambda H, E, K, psi, fc, R: packed.h_update_plain(
                 H, E, psi, fc, K, R))
    run_step(got, fe, fh,
             lambda E, H, J, psi, fc, R: emulate(E, H, J, psi, fc, R, True,
                                                 (3, 4)),
             lambda H, E, K, psi, fc, R: emulate(H, E, K, psi, fc, R, False,
                                                 (3, 4)))
    assert_carries_equal(got, want, f"3 lanes {case} {dtype}")


@pytest.mark.parametrize("pipe", [1, 3])
def test_emulated_march_with_another_ring_depth(pipe):
    """Planes fewer or more ahead, in a ring of fewer or more slots,
    leave the result as it is (the build knob PIPE; as built: 2)."""
    static = static_of("dng", "bfloat16")
    fe, fh = families(static)
    carry = seeded_carry(static, 9)
    want, got = clone(carry), clone(carry)
    run_step(want, fe, fh, packed.e_update_plain,
             lambda H, E, K, psi, fc, R: packed.h_update_plain(
                 H, E, psi, fc, K, R))
    run_step(got, fe, fh,
             lambda E, H, J, psi, fc, R: emulate(E, H, J, psi, fc, R, True,
                                                 (3, 4), pipe),
             lambda H, E, K, psi, fc, R: emulate(H, E, K, psi, fc, R, False,
                                                 (3, 4), pipe))
    assert_carries_equal(got, want, f"PIPE={pipe}")


def test_launch_blocks_follow_the_tile():
    """The parameter block (on CPU tensors, no launch) carries the plan of
    its tile: two z cells a thread in bf16 and compensated mode where n3
    is even, one in float32 and where n3 is odd."""
    for case, dtype, pairs in (("grids_j", "float32", False),
                               ("grids_j", "bfloat16", True),
                               ("odd_n3", "bfloat16", False),
                               ("comp_cpml", "float32", True),
                               ("comp_odd", "float32", False)):
        static = static_of(case, dtype)
        fe, _ = families(static)
        carry = packed.pack(init_state(static, "cpu"), static)
        prm = packed._params(carry["E"], carry["H"], carry.get("J"),
                             carry["psE"], fe, carry.get("rE"))
        assert prm.pairs == int(pairs), case
        rows, counts = fe["_params"][2].numpy(), tuple(prm.n_item)
        assert len(rows) == sum(counts)
        assert (rows[:, 1] % (64 if pairs else 32) == 0).all()
        assert prm.plan == fe["_params"][2].data_ptr()
        assert slab_axes(static) == fe["m"]

"""The work plan of the temporal-blocked CUDA pass (``ops/packed_tb.py``:
``plan_items``, ``material``), checked on the CPU.

The kernel (``csrc/packed_tb.cu``) runs the plan's items and nothing
else, so a wrong plan is a wrong pass that no CPU run of the plain
version would show. At the main paths' shapes (256^3 TFSF + xyz CPML,
the Mie example's 512^3, 100x90x70, 96^3 with an oblique wave, a point
source and no x CPML), for the card's 132 SMs:

* the owned boxes cover every cell of the grid exactly once (the plan is
  the same for every lane, so once per lane);
* each item's class and section agree with a brute-force per-cell
  predicate over the cells it computes (its owned box and the
  generation-1 halo): SLAB if one lies in a CPML slab, else SOURCE if
  one lies on a record's plane or is the point source's cell, else
  PLAIN; a grid section if one lies in the coefficient grids' box;
* each section runs its heaviest items first, and every item fits its
  block (tile and x planes);
* ``material`` finds the box where the coefficient grids differ from
  their background, and ``plan_geometry`` reads the same slabs, records
  and point source as the static configuration.
"""

import numpy as np
import pytest

from fdtd3d_torch import cli
from fdtd3d_torch.ops import packed_tb
from fdtd3d_torch.sim import Simulation
from fdtd3d_torch.solver import build_static, slab_axes

EXAMPLE = "Examples/vacuum3D_tfsf.txt"
MIE = "Examples/sphere3D_mie.txt"

CONFIGS = {
    "256": (EXAMPLE, ["--same-size", "256"]),
    "mie512": (MIE, []),
    "100x90x70": (EXAMPLE, ["--same-size", "0", "--sizex", "100",
                            "--sizey", "90", "--sizez", "70"]),
    "96_no_x_cpml": (EXAMPLE, ["--same-size", "96", "--pml-sizex", "0",
                               "--angle-teta", "30", "--angle-phi", "40",
                               "--angle-psi", "15", "--point-source",
                               "Ez"]),
}
# the Mie example's sphere (radius 64 at the centre) grown by a cell: the
# box outside which its coefficient grids hold their background
MIE_BOX = ((191, 321), (191, 321), (191, 321))


def config(path, extra):
    return cli.args_to_config(cli.build_parser().parse_args(
        cli.read_cmd_file(path) + list(extra)))


def geometry(name):
    """(shape, m per axis, records as (axis, plane), point or None) of a
    configuration, from its static set-up."""
    static = build_static(config(*CONFIGS[name]))
    m = [0, 0, 0]
    for a, size in slab_axes(static).items():
        m[a] = size
    records = [(r.axis, r.plane) for fam in ("E", "H")
               for r in packed_tb.tfsf_records(static)[fam]]
    ps = static.cfg.point_source
    point = tuple(ps.position) if ps.enabled else None
    return tuple(static.grid_shape), tuple(m), records, point


def plan(name, grids=None):
    shape, m, records, point = geometry(name)
    rows, counts = packed_tb.plan_items(shape, m, records, point,
                                        sms=132, grids=grids)
    return shape, m, records, point, rows, counts


def sections(rows, counts):
    bounds = np.cumsum((0,) + tuple(counts))
    return [rows[bounds[q]:bounds[q + 1]] for q in range(len(counts))]


def cell_masks(shape, m, records, point):
    """Per-cell predicates as boolean volumes: in the CPML slab of axis a
    (one volume per axis); on a record's plane or the point source's
    cell."""
    slab = np.zeros((3,) + tuple(shape), bool)
    source = np.zeros(shape, bool)
    for a in range(3):
        idx = [a] + [slice(None)] * 3
        if m[a]:
            idx[1 + a] = slice(0, m[a])
            slab[tuple(idx)] = True
            idx[1 + a] = slice(shape[a] - m[a], shape[a])
            slab[tuple(idx)] = True
    for axis, plane in records:
        idx = [slice(None)] * 3
        idx[axis] = plane
        source[tuple(idx)] = True
    if point is not None:
        source[point] = True
    return slab, source


def computed(row, shape):
    """Slices of the cells an item computes: its owned box, one cell
    below it and two above on every axis, inside the grid."""
    j0, k0, ny, nz, x0, x1 = (int(v) for v in row[:6])
    return (slice(max(x0 - 1, 0), min(x1 + 2, shape[0])),
            slice(max(j0 - 1, 0), min(j0 + ny + 2, shape[1])),
            slice(max(k0 - 1, 0), min(k0 + nz + 2, shape[2])))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_owned_boxes_cover_every_cell_once(name):
    shape, _, _, _, rows, counts = plan(name)
    assert sum(counts) == len(rows)
    # sweep x: between consecutive cut planes every item covers the same
    # planes, so one (y, z) count per interval decides
    cuts = sorted({0, shape[0]} | set(rows[:, 4].tolist())
                  | set(rows[:, 5].tolist()))
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        cover = np.zeros(shape[1:], np.int32)
        for j0, k0, ny, nz, x0, x1 in rows[:, :6]:
            if x0 <= lo and hi <= x1:
                cover[j0:j0 + ny, k0:k0 + nz] += 1
            else:
                assert hi <= x0 or x1 <= lo   # no item splits an interval
        assert (cover == 1).all(), (name, lo, hi, cover.min(), cover.max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_item_class_matches_cell_predicate(name):
    shape, m, records, point, rows, counts = plan(name)
    slab, source = cell_masks(shape, m, records, point)
    names = packed_tb.SECTIONS
    for q, sec in enumerate(sections(rows, counts)):
        for row in sec:
            box = computed(row, shape)
            axes = [a for a in range(3) if slab[(a,) + box].any()]
            want = packed_tb.SLAB if axes else \
                packed_tb.SOURCE if source[box].any() else packed_tb.PLAIN
            assert row[6] == want, (name, row)
            # the edge kernels' sections hold the SLAB items, only they,
            # and a single-axis section the items of that axis's slab
            assert names[q].startswith("edge") == bool(axes), (name, q, row)
            single = {(0,): "edge_x", (1,): "edge_y", (2,): "edge_z"}
            assert names[q] == (single.get(tuple(axes), "edge") if axes
                                else "inner"), (name, q, row, axes)
    grid = [names.index("edge_grid"), names.index("inner_grid")]
    assert all(counts[q] == 0 for q in grid)   # no coefficient grid given


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_heaviest_first_and_items_fit_their_block(name):
    _, _, _, _, rows, counts = plan(name)
    tile = packed_tb.TILE
    wide = packed_tb.transposed_tile(tile)
    for sec in sections(rows, counts):
        cost = [packed_tb.item_cost(r) for r in sec]
        assert all(a >= b for a, b in zip(cost, cost[1:])), name
    for j0, k0, ny, nz, x0, x1, cls, layout in rows:
        limit = wide if layout else tile
        assert 0 < ny <= limit[0] and 0 < nz <= limit[1]
        assert 0 < x1 - x0 <= packed_tb.MAX_PLANES
        assert layout == 0 or cls == packed_tb.SLAB


def test_grid_sections_follow_the_material_box():
    shape, m, records, point, rows, counts = plan("mie512", grids=MIE_BOX)
    inside = np.zeros(shape, bool)
    inside[tuple(slice(lo, hi + 1) for lo, hi in MIE_BOX)] = True
    names = packed_tb.SECTIONS
    assert counts[names.index("inner_grid")] > 0
    for q, sec in enumerate(sections(rows, counts)):
        for row in sec:
            assert inside[computed(row, shape)].any() == \
                names[q].endswith("_grid"), (names[q], row)
    # grids everywhere (Drude J, H grids): every item reads them
    counts = packed_tb.plan_items(shape, m, records, point,
                                  grids="all")[1]
    assert all(n == 0 for q, n in enumerate(counts)
               if not names[q].endswith("_grid")) and sum(counts) > 0


def small_tb(extra):
    """A prepared pass on the CPU at 40^3 (the Mie example shrunk)."""
    cfg = config(MIE, ["--same-size", "40", "--eps-sphere-center-x", "20",
                       "--eps-sphere-center-y", "20",
                       "--eps-sphere-center-z", "20",
                       "--eps-sphere-radius", "5"] + extra)
    sim = Simulation(cfg, device="cpu")
    step = packed_tb.make_packed_tb_step(sim.static, "cpu")
    return sim, step.prepare(sim.coeffs)["tb"]


def test_material_box_and_backgrounds():
    sim, tb = small_tb([])
    box, bg = packed_tb.material(tb)
    fe = tb["E"]
    differ = np.zeros(tb["shape"], bool)
    for (key, c), value in bg.items():
        grid = fe[key][c].numpy()
        assert grid[0, 0, 0] == np.float32(value)
        differ |= grid != np.float32(value)
    assert differ.any()
    want = tuple((int(i.min()), int(i.max())) for i in np.nonzero(differ))
    assert box == want
    # Drude J reads everywhere; uniform coefficients need no grid
    assert packed_tb.material(small_tb(
        ["--use-drude", "--eps-inf", "4.0", "--omega-p", "1e12",
         "--gamma-d", "5e10", "--drude-sphere-center-x", "20",
         "--drude-sphere-center-y", "20", "--drude-sphere-center-z", "20",
         "--drude-sphere-radius", "4"])[1])[0] == "all"
    sim, tb = small_tb(["--eps-sphere", "1.0"])
    assert packed_tb.material(tb)[0] in (None, ())


def test_plan_geometry_reads_the_static_set_up():
    sim, tb = small_tb(["--point-source", "Ez"])
    m, records, point = packed_tb.plan_geometry(tb)
    static = sim.static
    want_m = [0, 0, 0]
    for a, size in slab_axes(static).items():
        want_m[a] = size
    assert m == tuple(want_m)
    assert sorted(records) == sorted(
        (r.axis, r.plane) for fam in ("E", "H")
        for r in packed_tb.tfsf_records(static)[fam])
    assert point == tuple(static.cfg.point_source.position)

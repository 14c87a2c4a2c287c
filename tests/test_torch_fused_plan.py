"""The work plan of the recompute-fused CUDA pass (``ops/pallas_fused.py``:
``plan_items``), checked on the CPU.

The pass (``csrc/fused_eh.cu``) runs the plan's items and nothing else.
Its inner kernel has no CPML, record or point-source code, and a block
computes E on a hi-side halo (one x plane, one y row and one z column
beyond what it owns) whose cells other blocks own: a halo cell computed
without a term its owner adds gives H at the block's edge another E
than the one stored, which no CPU run of the plain version would show.
At the ladder's main-path geometries (``Examples/vacuum3D_tfsf.txt`` at
256^3, ``Examples/sphere3D_mie.txt`` at 512^3 with its sphere's grid
box), a thin CPML slab, TFSF planes inside the CPML slabs, and no CPML
on x with a point source and a material grid's box (from the port's own
coefficients), each with the y and z axes cut whole and band by band:

* the owned boxes cover every cell of the grid exactly once;
* each item's class, section and grid flag agree with a per-cell
  predicate over the cells it computes (E on the owned box grown by one
  cell above on every axis, H on the owned box): no inner item, halo
  included, touches a slab, record or point-source cell, and an edge
  kernel specialised to one axis sees no slab cell of another;
* sections run in order of their class's cost, each section's items
  heaviest first, and every tile fits the block.
"""

import numpy as np
import pytest

from fdtd3d_torch import cli
from fdtd3d_torch.ops import packed_tb, pallas_fused
from fdtd3d_torch.solver import (build_coeffs, build_static,
                                 coeffs_to_device, slab_axes)

VACUUM = "Examples/vacuum3D_tfsf.txt"
MIE = "Examples/sphere3D_mie.txt"

# name -> (command file or None, flags, grid box source)
CONFIGS = {
    "vacuum256": (VACUUM, ["--same-size", "256"], None),
    "mie512": (MIE, [], "sphere"),
    "thin_slab": (None, ["--3d", "--same-size", "24", "--use-pml",
                         "--pml-size", "1", "--use-tfsf", "--tfsf-margin",
                         "2", "--angle-teta", "30", "--angle-phi", "40"],
                  None),
    "tfsf_in_slab": (None, ["--3d", "--same-size", "16", "--use-pml",
                            "--pml-size", "3", "--use-tfsf", "--tfsf-margin",
                            "1", "--angle-teta", "30", "--angle-phi", "40",
                            "--angle-psi", "15"], None),
    "no_x_cpml_point_grid": (None, [
        "--3d", "--sizex", "40", "--sizey", "36", "--sizez", "30",
        "--use-pml", "--pml-sizex", "0", "--pml-sizey", "4", "--pml-sizez",
        "4", "--point-source", "Ey", "--eps-sphere", "3.0",
        "--eps-sphere-center-x", "20", "--eps-sphere-center-y", "18",
        "--eps-sphere-center-z", "15", "--eps-sphere-radius", "6"],
        "coeffs"),
}


def static_of(path, flags):
    argv = (cli.read_cmd_file(path) if path else []) + list(flags)
    return build_static(cli.args_to_config(cli.build_parser().parse_args(
        argv)))


def geometry(name):
    """(shape, m per axis, records as (axis, plane), point or None, the
    grids' box) of a configuration, from its static set-up (and, where
    the box comes from the coefficients, from ``packed_tb.material``)."""
    path, flags, box = CONFIGS[name]
    static = static_of(path, flags)
    m = [0, 0, 0]
    for a, size in slab_axes(static).items():
        m[a] = size
    records = packed_tb.tfsf_records(static)
    recs = [(r.axis, r.plane) for fam in ("E", "H") for r in records[fam]]
    ps = static.cfg.point_source
    point = tuple(ps.position) if ps.enabled else None
    grids = None
    if box == "sphere":
        sph = static.cfg.materials.eps_sphere
        grids = tuple((c - sph.radius, c + sph.radius) for c in sph.center)
    elif box == "coeffs":
        coeffs = coeffs_to_device(build_coeffs(static), "cpu")
        grids = packed_tb.material(pallas_fused.prepare(static, coeffs))[0]
        assert grids not in (None, (), "all")
    return tuple(static.grid_shape), tuple(m), recs, point, grids


@pytest.fixture(scope="module", params=[(n, b) for n in sorted(CONFIGS)
                                        for b in (False, True)],
                ids=lambda p: f"{p[0]}-{'bands' if p[1] else 'whole'}")
def planned(request):
    name, bands = request.param
    shape, m, recs, point, grids = geometry(name)
    rows, counts = pallas_fused.plan_items(shape, m, recs, point, sms=132,
                                           grids=grids, bands=bands)
    return shape, m, recs, point, grids, rows, counts


def test_owned_boxes_cover_the_grid_once(planned):
    shape, _, _, _, _, rows, counts = planned
    assert len(rows) == sum(counts) and len(counts) == len(
        pallas_fused.SECTIONS)
    seen = np.zeros(shape, np.int16)
    for j0, k0, ny, nz, x0, x1 in rows[:, :6]:
        assert ny > 0 and nz > 0 and x1 > x0
        seen[x0:x1, j0:j0 + ny, k0:k0 + nz] += 1
    assert seen.min() == 1 and seen.max() == 1


def computed(shape, row):
    """Index ranges of the cells an item computes: E one cell above its
    owned box on every axis."""
    j0, k0, ny, nz, x0, x1 = (int(v) for v in row[:6])
    return (np.arange(x0, min(x1 + 1, shape[0])),
            np.arange(j0, min(j0 + ny + 1, shape[1])),
            np.arange(k0, min(k0 + nz + 1, shape[2])))


def test_class_section_and_grid_flag_match_the_cells(planned):
    shape, m, recs, point, grids, rows, counts = planned
    in_slab = [np.zeros(n, bool) for n in shape]
    for a in range(3):
        if m[a]:
            in_slab[a][:m[a]] = in_slab[a][shape[a] - m[a]:] = True
    on_rec = [np.zeros(n, bool) for n in shape]
    for axis, plane in recs:
        on_rec[axis][plane] = True
    bounds = np.cumsum((0,) + tuple(counts))
    for q, row in enumerate(rows):
        xs, ys, zs = computed(shape, row)
        axes = sum(1 << a for a, idx in enumerate((xs, ys, zs))
                   if in_slab[a][idx].any())
        source = any(on_rec[a][idx].any() for a, idx in
                     enumerate((xs, ys, zs))) or (
            point is not None and all(
                point[a] in idx for a, idx in enumerate((xs, ys, zs))))
        want = pallas_fused.SLAB if axes else (
            pallas_fused.SOURCE if source else pallas_fused.PLAIN)
        assert row[6] == want, (q, tuple(row))
        sec = int(np.searchsorted(bounds, q, side="right")) - 1
        name = pallas_fused.SECTIONS[sec]
        compiled = pallas_fused.SECTION_AXES[sec]
        # the section's kernel has every slab axis the item touches
        assert axes & ~compiled == 0, (name, tuple(row))
        if name == "inner":
            assert not axes and not source, tuple(row)
        if name.startswith("edge_"):
            assert axes == compiled, (name, tuple(row))
        if grids in (None, ()):
            want_grid = False
        else:
            want_grid = all(idx.min() <= grids[a][1]
                            and grids[a][0] <= idx.max()
                            for a, idx in enumerate((xs, ys, zs)))
        assert row[7] == int(want_grid), tuple(row)
    if any(m):
        assert sum(counts[:4]) > 0, "no edge item"
    if min(shape) >= 128:       # small grids: every tile reaches a slab
        assert counts[5] > 0, "no item in the inner kernel"


def test_sections_heaviest_first_and_tiles_fit(planned):
    shape, m, _, _, _, rows, counts = planned
    ty, tz = pallas_fused.TILE
    assert (rows[:, 2] <= ty).all() and (rows[:, 3] <= tz).all()
    bounds = np.cumsum((0,) + tuple(counts))
    last = None
    for q in range(len(counts)):
        sec = rows[bounds[q]:bounds[q + 1]]
        cost = [pallas_fused.item_cost(r) for r in sec]
        assert cost == sorted(cost, reverse=True), pallas_fused.SECTIONS[q]
        if len(sec):
            level = max(pallas_fused.CLASS_COST[int(c)] for c in sec[:, 6])
            assert last is None or level <= last, pallas_fused.SECTIONS[q]
            last = level
    inner = rows[rows[:, 6] != pallas_fused.SLAB]
    assert (inner[:, 5] - inner[:, 4] <= max(pallas_fused.SEGMENTS)).all()

"""The work plan of the float32x2 CUDA pass (``ops/packed_ds.py``:
``plan_items``), checked on the CPU.

The pass (``csrc/packed_ds.cu``) runs the plan's items and nothing else,
and its inner kernel has no CPML code, so a wrong plan is a wrong step
that no CPU run of the plain version would show. At the float32x2 main
path's shapes (``Examples/precision3D_float32x2.txt`` at 128^3 and at
256^3), with no CPML on x at 96^3, on a grid the tile does not divide
(100x90x70), with the tiles aligned to 8 cells along z and with the axes
cut band by band (the plan's ``bands`` option), for the card's 132 SMs:

* the owned boxes cover every cell of the grid exactly once;
* each item's class and section agree with a per-cell predicate over
  the cells it computes (E on its owned box grown by one cell above on
  every axis, H on the owned box): SLAB (the edge kernel) if one lies in
  a CPML slab, else PLAIN (the inner kernel);
* each section runs its heaviest items first, every item's window (the
  owned box and one halo cell on each side) fits the block, and the x
  segments hold at most the plan's segment length in the interior.
"""

import numpy as np
import pytest

from fdtd3d_torch import cli
from fdtd3d_torch.ops import packed_ds
from fdtd3d_torch.solver import build_static, slab_axes

PRECISION = "Examples/precision3D_float32x2.txt"

# name -> (flags, zalign, bands)
CONFIGS = {
    "128": ([], 1, False),
    "256": (["--same-size", "256"], 1, False),
    "96_no_x_cpml": (["--same-size", "96", "--pml-sizex", "0",
                      "--point-source", "Ez"], 1, False),
    "100x90x70": (["--same-size", "0", "--sizex", "100", "--sizey", "90",
                   "--sizez", "70"], 1, False),
    "128_aligned": ([], 8, False),
    "128_bands": ([], 1, True),
    "100x90x70_bands": (["--same-size", "0", "--sizex", "100", "--sizey",
                         "90", "--sizez", "70"], 1, True),
}


def geometry(extra):
    """(shape, m per axis) of the precision example with ``extra``
    flags, from its static set-up."""
    cfg = cli.args_to_config(cli.build_parser().parse_args(
        cli.read_cmd_file(PRECISION) + list(extra)))
    static = build_static(cfg)
    m = [0, 0, 0]
    for a, size in slab_axes(static).items():
        m[a] = size
    return tuple(static.grid_shape), tuple(m)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def planned(request):
    extra, zalign, bands = CONFIGS[request.param]
    shape, m = geometry(extra)
    rows, counts = packed_ds.plan_items(shape, m, sms=132, zalign=zalign,
                                        bands=bands)
    return shape, m, rows, counts


def test_owned_boxes_cover_the_grid_once(planned):
    shape, _, rows, counts = planned
    assert len(rows) == sum(counts)
    seen = np.zeros(shape, np.int16)
    for j0, k0, ny, nz, x0, x1 in rows[:, :6]:
        assert ny > 0 and nz > 0 and x1 > x0
        seen[x0:x1, j0:j0 + ny, k0:k0 + nz] += 1
    assert seen.min() == 1 and seen.max() == 1


def test_class_and_section_match_the_cells(planned):
    shape, m, rows, counts = planned
    in_slab = [np.zeros(n, bool) for n in shape]
    for a in range(3):
        if m[a]:
            in_slab[a][:m[a]] = in_slab[a][shape[a] - m[a]:] = True
    for q, (j0, k0, ny, nz, x0, x1, cls, _) in enumerate(rows):
        # the cells the item computes: E one cell above the owned box
        xs = np.arange(x0, min(x1 + 1, shape[0]))
        ys = np.arange(j0, min(j0 + ny + 1, shape[1]))
        zs = np.arange(k0, min(k0 + nz + 1, shape[2]))
        touches = (in_slab[0][xs][:, None, None]
                   | in_slab[1][ys][None, :, None]
                   | in_slab[2][zs][None, None, :]).any()
        want = packed_ds.SLAB if touches else packed_ds.PLAIN
        assert cls == want, (q, tuple(rows[q]))
        section = 0 if q < counts[0] else 1
        assert section == (0 if cls == packed_ds.SLAB else 1), q
    assert counts[1] > 0, "no item in the inner kernel"


def test_items_fit_and_run_heaviest_first(planned):
    shape, m, rows, counts = planned
    ty, tz = packed_ds.TILE
    assert (rows[:, 2] <= ty).all() and (rows[:, 3] <= tz).all()
    bounds = np.cumsum((0,) + tuple(counts))
    for q in range(len(counts)):
        cost = [packed_ds.item_cost(r) for r in rows[bounds[q]:bounds[q + 1]]]
        assert cost == sorted(cost, reverse=True), packed_ds.SECTIONS[q]
    inner = rows[rows[:, 6] == packed_ds.PLAIN]
    assert (inner[:, 5] - inner[:, 4] <= max(packed_ds.SEGMENTS)).all()
    assert len(rows) >= 4 * 132 or shape[0] <= 128

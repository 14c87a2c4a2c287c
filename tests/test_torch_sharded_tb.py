"""The sharded temporal-blocked pass (B2(d): ``ops/packed_tb.py::
make_sharded_packed_tb_step``, the sharded builds of ``csrc/packed_tb.cu``)
against the port's unsharded tb run and the reference on its 8-device
virtual CPU mesh, mirroring tests/test_pallas_packed_tb.py's sharded
cases.

A decomposed real f32/bf16 run inside the pass's scope takes it; each
shard runs its two generations on its frame (its box grown by two cells
on each side with a neighbour), reading the neighbours' generation-0
planes from the exchanged ghost buffers and computing generation 1 in
its own halo. From the same numpy-seeded fields:

* (2,2,1), (1,2,2) and (2,1,1), with oblique TFSF and a point source,
  Drude J with eps grids whose boxes cross every shard edge, bf16, an
  odd horizon (the sharded packed tail) and a run in two chunks: bit
  for bit equal to the port's unsharded tb run on every leaf (psi moved
  to the unsharded layout, ``io.reshard_psi_tree``);
* the same runs against the reference's sharded jnp run at 2e-6 of each
  family's max (bf16 2e-2), and one against its sharded tb kernel at
  depth 2 (``FDTD3D_TB_DEPTH=2``, interpret mode) at the pass's gate;
* the step kind and ``tb_fallback`` token on a topology against the
  reference's dispatch: ``FDTD3D_NO_TEMPORAL``, a source inside the
  absorber, compensated mode and magnetic Drude K; a shard too thin for
  its ghost planes takes the sharded packed step with
  ``no_viable_depth`` (the reference's tb wedge fits it: ROADMAP §C);
* checkpoints between sharded tb, sharded packed and unsharded tb runs
  continue bit-equal to the uninterrupted run;
* the pass's host side: the frame (offsets, open sides, widened slabs),
  the work plan over the frame (owned boxes tile the shard's box once,
  classes against a per-cell predicate over the frame), the exchange
  (every ghost buffer holds the global state's cells, corners
  included), and the CUDA kernel's addressing of generation-0 cells
  (``gcol``/``field_at``/``psi_load`` in csrc/packed_tb.cu) mirrored on
  the CPU: it reads the frame's values from the shard's buffers and
  its ghosts;
* the CLI prints ``step_kind=packed_tb_plain`` on a topology with no
  ``tb_fallback``, and ``--dry-run`` names ``packed_tb``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch_parity import (assert_state_close, np_state, seed_reference,
                          to_port)

from fdtd3d_torch import cli as tcli
from fdtd3d_torch import convert
from fdtd3d_torch import io as tio
from fdtd3d_torch import plan as tplan
from fdtd3d_torch import solver as tsolver
from fdtd3d_torch.ops import packed_tb, stencil
from fdtd3d_torch.sim import Simulation as TSim
from fdtd3d_tpu.config import (MaterialsConfig, OutputConfig,
                               ParallelConfig, PmlConfig, PointSourceConfig,
                               SimConfig, SphereConfig, TfsfConfig)
from fdtd3d_tpu.sim import Simulation as RSim

TOL = 2e-6
BF16_TOL = 2e-2
N = 24
STEPS = 6
ENV = ("FDTD3D_NO_TEMPORAL", "FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED",
       "FDTD3D_NO_FUSED", "FDTD3D_TB_DEPTH")
GRIDS_J = MaterialsConfig(
    eps=1.5, eps_sphere=SphereConfig(enabled=True, center=(12, 11, 12),
                                     radius=6, value=3.0),
    use_drude=True, eps_inf=2.0, omega_p=2e11, gamma=1e10,
    drude_sphere=SphereConfig(enabled=True, center=(12, 12, 12), radius=3))

# name -> (topology, steps, configuration)
CASES = {
    "tfsf_221": ((2, 2, 1), STEPS, {}),
    "grids_j_122": ((1, 2, 2), STEPS, dict(materials=GRIDS_J)),
    "bf16_211": ((2, 1, 1), STEPS, dict(dtype="bfloat16")),
    "odd_221": ((2, 2, 1), STEPS + 1, dict(materials=GRIDS_J)),
    "grids_j_222": ((2, 2, 2), STEPS, dict(materials=GRIDS_J)),
}


def cfg_of(case, topo=None, **kw) -> SimConfig:
    """24^3, pml 3 (a local extent of 12 holds the slab and the two
    ghost planes), an oblique plane wave and a point source, the case's
    configuration; ``topo`` None: unsharded."""
    par = ParallelConfig() if topo is None else ParallelConfig(
        topology="manual", manual_topology=topo)
    base = dict(scheme="3D", size=(N, N, N), dx=1e-3, courant_factor=0.4,
                wavelength=8e-3, pml=PmlConfig(size=(3, 3, 3)),
                time_steps=CASES[case][1] if case in CASES else STEPS,
                tfsf=TfsfConfig(enabled=True, margin=(2, 2, 2),
                                angle_teta=30.0, angle_phi=40.0,
                                angle_psi=15.0),
                point_source=PointSourceConfig(enabled=True, component="Ez",
                                               position=(11, 13, 12)),
                parallel=par, use_pallas=True)
    base.update(CASES[case][2] if case in CASES else {})
    base.update(kw)
    return SimConfig(**base)


def set_env(mp, names=(), **values):
    for k in ENV:
        mp.delenv(k, raising=False)
    for k in names:
        mp.setenv(k, "1")
    for k, v in values.items():
        mp.setenv(k, v)


def moved(state, sim, ustatic):
    """A port state in the reference's form with psi moved onto the
    unsharded layout."""
    return tio.reshard_psi_tree(
        convert.state_to_reference(state), ustatic.grid_shape, sim.topology,
        tsolver.slab_axes(sim.static), (1, 1, 1),
        tsolver.slab_axes(ustatic))


def assert_bit_equal(got, want, what):
    for grp, leaves in want.items():
        if not isinstance(leaves, dict):
            continue
        for k in leaves:
            np.testing.assert_array_equal(got[grp][k], leaves[k],
                                          err_msg=f"{what}: {grp}/{k}")


_RUNS = {}


def runs(case):
    """(the reference's sharded jnp final state, the port's sharded
    run's (the reference's form), the port's Simulation, its unsharded
    tb run's state and static) of ``case`` from one seeded state, cached
    per module."""
    if case not in _RUNS:
        topo, steps, _ = CASES[case]
        mp = pytest.MonkeyPatch()
        try:
            set_env(mp)
            ref = RSim(cfg_of(case, topo, use_pallas=False))
            seed_reference(ref, 5)
            seeded = np_state(ref)
            port = TSim(to_port(cfg_of(case, topo)), device="cpu")
            assert port.step_kind == "packed_tb_plain", port.step_kind
            port.adopt_state(convert.state_from_reference(seeded))
            one = TSim(to_port(cfg_of(case)), device="cpu")
            assert one.step_kind == "packed_tb_plain"
            one.state = convert.state_from_reference(tio.reshard_psi_tree(
                seeded, one.static.grid_shape, topo,
                tsolver.slab_axes(port.static), (1, 1, 1),
                tsolver.slab_axes(one.static)))
            ref.advance(steps)
            if case == "odd_221":       # two chunks: a pass, then the tail
                port.advance(steps - 3)
                port.advance(3)
            else:
                port.advance(steps)
            one.advance(steps)
        finally:
            mp.undo()
        _RUNS[case] = (np_state(ref), convert.state_to_reference(port.state),
                       port, convert.state_to_reference(one.state),
                       one.static)
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_tb_equals_unsharded_tb_bit_for_bit(case):
    _, _, port, uwant, ustatic = runs(case)
    assert port.step_diag.get("tb_fallback") is None
    assert port.step_diag["temporal_block"] == 2
    assert port.step_diag["topology"] == list(CASES[case][0])
    assert_bit_equal(moved(port.state, port, ustatic), uwant, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_tb_matches_reference_jnp(case):
    want, got, _, _, _ = runs(case)
    assert_state_close(want, got, BF16_TOL if "bf16" in case else TOL)


@pytest.mark.parametrize("topo,steps", [((2, 2, 1), 4)])
def test_sharded_tb_matches_reference_tb_kernel(topo, steps, monkeypatch):
    """Against the reference's sharded tb kernel at depth 2 (interpret
    mode, its wedge pre-pass and ghost generations): the pass's gate."""
    set_env(monkeypatch, FDTD3D_TB_DEPTH="2")
    cfg = cfg_of("tfsf_221", topo, size=(16, 16, 16), pml=PmlConfig(
        size=(2, 2, 2)), point_source=PointSourceConfig(
            enabled=True, component="Ez", position=(7, 9, 8)))
    ref = RSim(cfg)
    assert ref.step_kind == "pallas_packed_tb", ref.step_kind
    assert (ref.step_diag or {}).get("tb_fallback") is None
    seed_reference(ref, 6)
    port = TSim(to_port(cfg), device="cpu")
    assert port.step_kind == "packed_tb_plain"
    port.adopt_state(convert.state_from_reference(np_state(ref)))
    ref.advance(steps)
    port.advance(steps)
    assert_state_close(np_state(ref), convert.state_to_reference(port.state),
                       TOL)


@pytest.mark.parametrize("names,values,kw,token,kind", [
    (("FDTD3D_NO_TEMPORAL",), {}, {}, "env:FDTD3D_NO_TEMPORAL",
     "packed_plain"),
    ((), {}, dict(point_source=PointSourceConfig(
        enabled=True, component="Ez", position=(2, 13, 12))),
     "packed_ineligible", "pallas3d_plain"),
    ((), {}, dict(compensated=True), "compensated", "packed_plain"),
    ((), {}, dict(materials=MaterialsConfig(
        use_drude_m=True, mu_inf=1.5, omega_pm=1e11, gamma_m=1e10,
        drude_m_sphere=SphereConfig(enabled=True, center=(12, 12, 12),
                                    radius=4))), "magnetic_drude",
     "packed_plain"),
])
def test_tb_fallback_tokens_on_a_topology_follow_reference(
        names, values, kw, token, kind, monkeypatch):
    set_env(monkeypatch, names, **values)
    cfg = cfg_of("tfsf_221", (2, 2, 1), **kw)
    port = TSim(to_port(cfg), device="cpu")
    assert port.step_kind == kind
    assert port.step_diag["tb_fallback"]["reason"] == token
    ref = RSim(cfg)
    assert (ref.step_diag or {}).get("tb_fallback", {}).get(
        "reason") == token
    assert ref.step_kind != "pallas_packed_tb"
    port.advance(1)


def test_a_shard_too_thin_for_its_ghosts_takes_the_sharded_packed_step(
        monkeypatch):
    """(1,4,1) of 36 cells with pml 3: a local y of 9 holds slab psi (9 >
    8) but not the frame's widened slab and two ghost planes beside a
    closed side (9 < 2 (pml + 1) + 2): the sharded packed step with the
    reference's ``no_viable_depth``. The reference's boundary wedge fits
    a local extent of 1 at depth 2, so it runs its tb pass there."""
    set_env(monkeypatch)
    cfg = cfg_of("tfsf_221", (1, 4, 1), size=(16, 36, 16),
                 pml=PmlConfig(size=(2, 3, 2)),
                 point_source=PointSourceConfig(enabled=True,
                                                component="Ez",
                                                position=(7, 17, 8)))
    port = TSim(to_port(cfg), device="cpu")
    assert port.step_kind == "packed_plain"
    assert port.step_diag["tb_fallback"]["reason"] == "no_viable_depth"
    assert not packed_tb.shards_fit(port.static)
    ref = RSim(cfg)
    assert ref.step_kind == "pallas_packed_tb"
    port.advance(2)


@pytest.mark.parametrize("first,second,env", [
    ((2, 2, 1), (2, 2, 1), ("FDTD3D_NO_TEMPORAL",)),   # tb -> packed
    ((2, 1, 1), None, ()),                              # tb -> unsharded
    (None, (1, 2, 2), ()),                              # unsharded -> tb
    ((2, 2, 1), (1, 2, 2), ()),                         # tb -> tb, reshard
])
def test_checkpoints_between_tb_packed_and_unsharded_continue_bit_equal(
        first, second, env, tmp_path, monkeypatch):
    """A sharded tb run checkpointed after 3 steps (a pass and a tail)
    restores into a sharded packed run (``env`` on the second run), an
    unsharded tb run or another topology's tb run, and the reverse; the
    continued run equals the uninterrupted unsharded tb run on every
    leaf (the packed run E and H only: its psi differs by psi's own
    roundoff, ROADMAP §C)."""
    path = str(tmp_path / "ckpt.npz")

    def sim_on(topo):
        cfg = to_port(cfg_of("grids_j_122", topo, time_steps=9,
                             output=OutputConfig(save_dir=str(tmp_path))))
        return TSim(cfg, device="cpu")

    set_env(monkeypatch)
    whole = sim_on(None)
    whole.advance(3)     # the same chunks: a pass and a tail, three passes
    whole.advance(6)
    a = sim_on(first)
    assert a.step_kind == "packed_tb_plain"
    a.advance(3)
    a.checkpoint(path)
    set_env(monkeypatch, env)
    b = sim_on(second)
    b.restore(path)
    assert b.t == 3
    b.advance(6)
    packed_run = bool(env)
    assert b.step_kind == ("packed_plain" if packed_run
                           else "packed_tb_plain")
    got = moved(b.state, b, whole.static)
    want = convert.state_to_reference(whole.state)
    for grp in ("E", "H", "J") + (() if packed_run else ("psi_E",
                                                          "psi_H")):
        for k in want[grp]:
            if packed_run:
                np.testing.assert_allclose(got[grp][k], want[grp][k],
                                           rtol=0, atol=1e-6 * max(
                                               1.0, float(np.abs(
                                                   want[grp][k]).max())))
            else:
                np.testing.assert_array_equal(got[grp][k], want[grp][k],
                                              err_msg=f"{grp}/{k}")


# ---------------------------------------------------------------------------
# the host side of the pass
# ---------------------------------------------------------------------------

def _sharded_sim(topo, case="grids_j_222", seed=9):
    """A port Simulation on ``topo`` with seeded E, H, J and psi (every
    leaf non-zero, so that a misplaced read shows); a three-way split
    takes a thinner PML on its axis (a local extent of 8 holds a 3-plane
    slab and the ghosts)."""
    pml = tuple(2 if p > 2 else 3 for p in topo)
    sim = TSim(to_port(cfg_of(case, topo, pml=PmlConfig(size=pml))),
               device="cpu")
    assert sim.step_kind == "packed_tb_plain"
    g = torch.Generator().manual_seed(seed)
    for ps in sim._carry["shards"]:
        for t in stencil_leaves(ps):
            t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    return sim


def stencil_leaves(ps):
    out = [ps["E"], ps["H"]] + [ps[k] for k in ("J",) if k in ps]
    return out + [v for fam in ("psE", "psH") for v in ps[fam].values()]


def _global(sim, key, b=None):
    """A leaf of every shard joined into the global stack (psi: along
    its own axis the shards' slab stacks side by side, else joined)."""
    mesh = sim.mesh
    pieces = [ps[key] if b is None else ps[key][b]
              for ps in sim._carry["shards"]]
    shape = list(pieces[0].shape)
    for a in range(3):
        shape[1 + a] *= mesh.topology[a]
    out = torch.empty(shape, dtype=pieces[0].dtype)
    for r, p in enumerate(pieces):
        idx = [slice(None)]
        for a in range(3):
            n = p.shape[1 + a]
            c = mesh.coords[r][a]
            idx.append(slice(c * n, (c + 1) * n))
        out[tuple(idx)] = p
    return out


@pytest.mark.parametrize("topo", [(2, 2, 2), (1, 2, 2), (3, 1, 1)])
def test_exchange_fills_every_ghost_with_the_global_cells(topo):
    """Each shard's stack grown by its ghost buffers
    (``stencil.extend_stack``) equals the global stack cut to the
    shard's frame, corners included; a psi stack's own axis is not
    exchanged, so it is compared shard by shard along it."""
    sim = _sharded_sim(topo)
    mesh = sim.mesh
    exchange, _ = packed_tb.make_deep_exchange(mesh)
    gh = exchange(sim._carry["shards"])
    for r, ps in enumerate(sim._carry["shards"]):
        fr = packed_tb.shard_frame(sim.static, mesh, r)
        for key in ("E", "H", "J"):
            glob = _global(sim, key)
            idx = [slice(None)] + [slice(fr["base"][a],
                                         fr["base"][a] + fr["shape"][a])
                                   for a in range(3)]
            torch.testing.assert_close(
                stencil.extend_stack(ps[key], gh[r][key]),
                glob[tuple(idx)], rtol=0, atol=0)
        for fam in ("psE", "psH"):
            for b, v in ps[fam].items():
                glob = _global(sim, fam, b)
                idx = [slice(None)]
                for a in range(3):
                    if a == b:
                        n = v.shape[1 + a]
                        c = mesh.coords[r][a]
                        idx.append(slice(c * n, (c + 1) * n))
                    else:
                        idx.append(slice(fr["base"][a],
                                         fr["base"][a] + fr["shape"][a]))
                torch.testing.assert_close(
                    stencil.extend_stack(v, gh[r][fam][b]),
                    glob[tuple(idx)], rtol=0, atol=0)


def _slab_plane(i, n, m):
    return i if i < m else (i - (n - 2 * m) if i >= n - m else -1)


def kernel_field(ps_local, ghost, fr, x, j, k):
    """The kernel's read of a field's three components at frame cell
    (x, j, k): ``gcol`` and ``field_at`` of csrc/packed_tb.cu, on the
    flat buffers."""
    G = packed_tb.GHOST
    lo, nl, ne = fr["lo"], fr["nl"], fr["shape"]
    lj, lk = j - lo[1], k - lo[2]
    n3 = nl[2]
    if lk < 0 or lk >= nl[2]:
        sel, side = 2, int(lk >= 0)
        base = j * G + (lk - nl[2] if side else lk + G)
        ps = ne[1] * G
        cs = ne[0] * ps
    elif lj < 0 or lj >= nl[1]:
        sel, side = 1, int(lj >= 0)
        base = (lj - nl[1] if side else lj + G) * n3 + lk
        ps = G * n3
        cs = ne[0] * ps
    else:
        sel, side = 0, 0
        base = lj * n3 + lk
        ps = nl[1] * n3
    if sel:
        buf, at = ghost[sel][side], base + x * ps
    else:
        lx = x - lo[0]
        if lx < 0 or lx >= nl[0]:
            buf = ghost[0][int(lx >= 0)]
            at = (lx + G if lx < 0 else lx - nl[0]) * ps + base
            cs = G * ps
        else:
            buf, at, cs = ps_local, lx * ps + base, nl[0] * ps
    flat = buf.reshape(-1)
    return [float(flat[at + c * cs]) for c in range(3)]


def kernel_psi(local, ghosts, fr, a, row, q, x, j, k):
    """The kernel's read of psi (``psi_load``, its own stack's offset by
    ``psi_own``) at frame cell (x, j, k) of global slab plane q of axis
    a."""
    G = packed_tb.GHOST
    lx, lj, lk = x - fr["lo"][0], j - fr["lo"][1], k - fr["lo"][2]
    nl, ne = fr["nl"], fr["shape"]
    ox, oy, oz = (not 0 <= v < n for v, n in zip((lx, lj, lk), nl))
    gx = lx + G if lx < 0 else lx - nl[0]
    gy = lj + G if lj < 0 else lj - nl[1]
    gz = lk + G if lk < 0 else lk - nl[2]
    m2 = 2 * fr["ml"][a]
    at = None
    if a == 0:
        if oz:
            at = 2, lk >= 0, ((row * m2 + q) * ne[1] + j) * G + gz
        elif oy:
            at = 1, lj >= 0, ((row * m2 + q) * G + gy) * nl[2] + lk
    elif a == 1:
        if oz:
            at = 2, lk >= 0, ((row * ne[0] + x) * m2 + q) * G + gz
        elif ox:
            at = 0, lx >= 0, ((row * G + gx) * m2 + q) * nl[2] + lk
    else:
        if oy:
            at = 1, lj >= 0, ((row * ne[0] + x) * G + gy) * m2 + q
        elif ox:
            at = 0, lx >= 0, ((row * G + gx) * nl[1] + lj) * m2 + q
    if at is not None:
        c, side, off = at
        return float(ghosts[c][int(side)].reshape(-1)[off])
    own = (((row * m2 + q) * nl[1] + lj) * nl[2] + lk if a == 0 else
           ((row * nl[0] + lx) * m2 + q) * nl[2] + lk if a == 1 else
           ((row * nl[0] + lx) * nl[1] + lj) * m2 + q)
    return float(local.reshape(-1)[own])


@pytest.mark.parametrize("topo", [(2, 2, 2), (1, 2, 2), (3, 1, 2)])
def test_kernel_addressing_reads_the_frame(topo):
    """The kernel's generation-0 reads (fields and psi) over cells of
    each shard's frame, mirrored on the CPU, return ``frame_carry``'s
    values: the carry inside the box, the ghost buffers beyond it, the
    corners from the later axis's buffer; psi where the cell lies in a
    global CPML slab (the kernel's slab decision), which the frame's
    widened slab rows hold too."""
    sim = _sharded_sim(topo)
    mesh = sim.mesh
    exchange, _ = packed_tb.make_deep_exchange(mesh)
    shards = sim._carry["shards"]
    gh = exchange(shards)
    rng = np.random.default_rng(3)
    for r, ps in enumerate(shards):
        fr = packed_tb.shard_frame(sim.static, mesh, r)
        frame = packed_tb.frame_carry(ps, gh[r], fr)
        ne = fr["shape"]
        # every cell of the frame's boundary shell, and a sample inside
        cells = [(x, j, k) for x in range(ne[0]) for j in range(ne[1])
                 for k in range(ne[2])
                 if min(x, j, k) < 3 or x > ne[0] - 4 or j > ne[1] - 4
                 or k > ne[2] - 4]
        cells = [cells[i] for i in rng.choice(len(cells), 600,
                                              replace=False)]
        for key in ("E", "H", "J"):
            g = {a: v for a, v in gh[r][key].items()}
            for x, j, k in cells:
                got = kernel_field(ps[key], g, fr, x, j, k)
                want = [float(frame[key][c, x, j, k]) for c in range(3)]
                assert got == want, (key, r, (x, j, k))
        for fam in ("psE", "psH"):
            for a, stack in ps[fam].items():
                me, ml = fr["me"][a], fr["ml"][a]
                for x, j, k in cells:
                    cell = (x, j, k)
                    q = _slab_plane(cell[a] + fr["base"][a], fr["grid"][a],
                                    ml)
                    if q < 0:
                        continue
                    qe = _slab_plane(cell[a], ne[a], me)
                    assert qe >= 0, (fam, a, r, cell)
                    for row in range(2):
                        got = kernel_psi(stack, gh[r][fam][a], fr, a, row,
                                         q, x, j, k)
                        idx = [row, x, j, k]
                        idx[1 + a] = qe
                        want = float(frame[fam][a][tuple(idx)])
                        assert got == want, (fam, a, r, cell)


@pytest.mark.parametrize("topo", [(2, 2, 1), (1, 2, 2), (2, 1, 1)])
def test_frame_plan_tiles_the_shard_and_classes_its_cells(topo):
    """Each shard's work plan over its frame (``plan_rows``, at a small
    tile, many items on the shard's edges): the owned boxes cover the
    shard's box once and nothing beyond it; an item is SLAB iff a cell
    it computes lies in a global CPML slab, and its section reads grids
    iff such a cell lies in the frame's grid box; the frame records the
    shard's offset, open sides and widened slabs."""
    eps = MaterialsConfig(eps=1.5, eps_sphere=GRIDS_J.eps_sphere)
    sim = TSim(to_port(cfg_of("grids_j_222", topo, materials=eps)),
               device="cpu")
    mesh = sim.mesh
    step = tsolver.make_step(sim.static, "cpu", mesh=mesh)
    cc = step.prepare(sim.coeffs)
    for r in range(mesh.n):
        tb = cc[r]["tb"]
        fr = tb["frame"]
        assert fr["base"] == tuple(o - lo for o, lo in zip(
            mesh.offset(r), fr["lo"]))
        assert fr["open"] == mesh.open_sides(r)
        for a in range(3):
            assert fr["lo"][a] == (2 if mesh.open_sides(r)[a][0] else 0)
            if mesh.topology[a] > 1:
                assert fr["me"][a] == fr["ml"][a] + 2
                assert tuple(tb["E"]["prof"][a].shape) == (3, 2 * fr["me"][a])
        grids = packed_tb.material(tb)[0]
        own = tuple((fr["lo"][a], fr["lo"][a] + fr["nl"][a])
                    for a in range(3))
        rows, counts = packed_tb.plan_rows(tb, tile=(4, 6), sms=4)
        cover = np.zeros(tb["shape"], np.int32)
        for row in rows:
            j0, k0, ny, nz, x0, x1 = (int(v) for v in row[:6])
            cover[x0:x1, j0:j0 + ny, k0:k0 + nz] += 1
        inner = tuple(slice(o[0], o[1]) for o in own)
        assert (cover[inner] == 1).all()
        assert cover.sum() == int(np.prod(fr["nl"]))
        shape = tb["shape"]
        # the grids' box over the frame, by brute force on the frame's
        # grids: where any differs from its value at the frame's corner
        fe = packed_tb.frame_family(tb["E"])
        diff = torch.zeros(shape, dtype=torch.bool)
        for key in ("a", "b"):
            for v in fe[key]:
                if isinstance(v, torch.Tensor):
                    diff |= v != v[0, 0, 0]
        idx = torch.nonzero(diff)
        want = tuple((int(idx[:, a].min()), int(idx[:, a].max()))
                     for a in range(3)) if len(idx) else ()
        assert grids == want
        first = 0
        for sec, n in enumerate(counts):
            for row in rows[first:first + n]:
                box = packed_tb.computed_box(row, shape)
                # on the global grid: the computed cells there
                g = [(max(box[a][0] + fr["base"][a], 0),
                      min(box[a][1] + fr["base"][a], fr["grid"][a] - 1))
                     for a in range(3)]
                ml, n_g = fr["ml"], fr["grid"]
                slab = any(ml[a] and (g[a][0] < ml[a]
                                      or g[a][1] >= n_g[a] - ml[a])
                           for a in range(3))
                assert (row[6] == packed_tb.SLAB) == slab
                reads = bool(want) and all(
                    box[a][0] <= want[a][1] and want[a][0] <= box[a][1]
                    for a in range(3))
                assert (packed_tb.SECTIONS[sec] in ("edge_grid",
                                                    "inner_grid")) == reads
            first += n
        assert sum(counts) == len(rows)


def test_frame_coefficients_hold_the_global_grids():
    """``frame_coeffs``: a shard's grids grown by their ghost buffers
    and its axis vectors over its frame are the global ones cut to it;
    its slab profiles are the shard's rows with identity rows where the
    frame widens them; the families' grids over the frame
    (``frame_family``) and their box (``frame_material``) follow."""
    sim = TSim(to_port(cfg_of("grids_j_222", (2, 2, 2))), device="cpu")
    mesh = sim.mesh
    glob = mesh.join(sim.coeffs, coeff=True)
    frames = packed_tb.frame_coeffs(sim.static, mesh, sim.coeffs)
    n_grids = 0
    for r, fc in enumerate(frames):
        fr = packed_tb.shard_frame(sim.static, mesh, r)
        cut = tuple(slice(fr["base"][a], fr["base"][a] + fr["shape"][a])
                    for a in range(3))
        for key, v in glob.items():
            if isinstance(v, torch.Tensor) and v.dim() == 3:
                assert fc[key] is sim.coeffs[r][key]
                grown = stencil.extend_stack(fc[key].unsqueeze(0),
                                             fc["_frame_ghosts"][key])[0]
                torch.testing.assert_close(grown, v[cut], rtol=0, atol=0)
                n_grids += 1
        tb = packed_tb.prepare_shard(sim.static, mesh, r, fc)
        fe = packed_tb.frame_family(tb["E"])
        for c, comp in enumerate(("Ex", "Ey", "Ez")):
            torch.testing.assert_close(fe["a"][c], glob[f"ca_{comp}"][cut],
                                       rtol=0, atol=0)
        # Drude J: every item reads the grids
        assert packed_tb.material(tb) == ("all", {})
        for a, ax in enumerate("xyz"):
            torch.testing.assert_close(fc[f"g{ax}"], glob[f"g{ax}"][cut[a]],
                                       rtol=0, atol=0)
            m = fr["ml"][a]
            prof = fc[f"pml_slab_ike_{ax}"]
            assert prof.shape[0] == 2 * fr["me"][a]
            back = packed_tb.unpad_slab(prof.unsqueeze(0), 1, m,
                                        fr["open"][a])[0]
            torch.testing.assert_close(back, sim.coeffs[r][
                f"pml_slab_ike_{ax}"], rtol=0, atol=0)
            assert float(prof.sum()) == float(back.sum()) + 4.0
    assert n_grids > 0


def test_plan_counts_the_spare_set_the_ghosts_and_the_frame(monkeypatch):
    """``plan``'s bytes of a sharded tb run: kind ``packed_tb``, ghost
    depth 2, the spare set, the deep ghosts beside the tail's, and the
    frame's grids, each equal to what the run allocates on its busiest
    shard (tests/test_torch_plan.py holds the rest of the run)."""
    set_env(monkeypatch)
    cfg = to_port(cfg_of("grids_j_222", (2, 2, 1)))
    sim = TSim(cfg, device="cpu")
    sim.run(3)
    p = tplan.plan(cfg)
    assert p.step_kind == "packed_tb"
    assert p.comm_strategy.ghost_depth == 2
    assert "tb spare set" in p.report()
    run = sim._runner
    spares = run.spare["shards"]
    nbytes = [sum(t.numel() * t.element_size()
                  for t in stencil_leaves(sp)) for sp in spares]
    assert max(nbytes) == p.spare_bytes
    frame = max(sum(b.numel() * b.element_size()
                    for gh in fc["_frame_ghosts"].values()
                    for pair in gh.values() for b in pair if b is not None)
                for fc in packed_tb.frame_coeffs(sim.static, sim.mesh,
                                                 sim.coeffs))
    assert frame == p.frame_bytes > 0


def test_cli_prints_the_sharded_tb_step(capsys, tmp_path, monkeypatch):
    from fdtd3d_torch import log as tlog
    set_env(monkeypatch)
    saved = tlog._level
    tlog.set_level(1)
    try:
        argv = ["--cmd-from-file", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "Examples", "vacuum3D_tfsf.txt"), "--same-size", "32",
            "--pml-size", "4", "--tfsf-margin", "3", "--time-steps", "5",
            "--device", "cpu", "--use-pallas", "on", "--manual-topology",
            "2x2x1", "--save-dir", str(tmp_path)]
        assert tcli.main(argv) == 0
        out = capsys.readouterr().out
        assert "step_kind=packed_tb_plain" in out
        assert "tb_fallback" not in out
        assert tcli.main(argv[:-2] + ["--dry-run"]) == 0
        out = capsys.readouterr().out
        assert "packed_tb" in out and "ghost depth 2" in out
    finally:
        tlog.set_level(saved)


def test_sharded_tb_carries_the_live_views_through_health(tmp_path,
                                                          monkeypatch):
    """``--check-finite``'s health pass reads the shards' live buffers
    after every swap: a NaN written into shard 1's live E between
    chunks trips it in the next chunk, whichever buffer the pass left
    live."""
    set_env(monkeypatch)
    cfg = to_port(cfg_of("tfsf_221", (2, 2, 1), time_steps=8))
    cfg = dataclasses.replace(cfg, output=dataclasses.replace(
        cfg.output, check_finite=True, save_dir=str(tmp_path)))
    sim = TSim(cfg, device="cpu")
    assert sim.step_kind == "packed_tb_plain"
    sim.advance(2)
    sim.advance(2)
    sim._shard_views()[1]["E"]["Ex"][5, 5, 5] = float("nan")
    with pytest.raises(FloatingPointError, match="Ex"):
        sim.advance(2)

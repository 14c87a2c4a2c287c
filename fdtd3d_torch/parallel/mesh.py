"""Topology selection and the shard layout of a decomposed run.

Counterpart of ``fdtd3d_tpu/parallel/mesh.py`` for one process.
``choose_topology`` (:46) and ``resolve_topology`` (:83) are the
reference's, the one topology authority of ``Simulation``, the CLI and
the planner. Where the reference builds a ``jax.sharding.Mesh`` and lets
``shard_map`` slice its trees by ``coeff_specs``/``state_specs``
(:163/:181), the port keeps a :class:`ShardMesh` (the topology, one
torch device per shard, repeats allowed, so several shards may sit on
one card) and splits and joins the global trees itself, by the same
rules:

* a rank-3 leaf is cut into ``topology[a]`` equal pieces along every
  axis a: fields, J and K, coefficient grids, and the CPML psi, whose
  slab-compact storage holds ``2 m topology[a]`` planes along its own
  axis (``solver.slab_axes``), ``2 m`` a shard: the piece is the
  shard's (lo ++ hi) slab, as in the reference's layout;
* a 1D coefficient whose key ends in ``_x``/``_y``/``_z`` (or is
  ``gx``/``gy``/``gz``) is cut along that axis: the wall vectors, the
  global cell indices, the CPML profiles (the slab profiles of length
  ``2 m topology[a]`` give each shard its own rows, identity on an
  interior shard);
* everything else (the incident line and its profiles, scalars, ``t``)
  is replicated.

Shards are numbered in C order of their coordinates (x slowest), as
the reference's mesh lays its devices out.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = "xyz"

# shards of a run on the CPU when the caller names no device list: the
# reference's test mesh (tests/conftest.py) has this many devices
CPU_SHARDS = 8


def _factorizations(n: int, k: int):
    """All ordered k-tuples of positive ints with product n."""
    if k == 1:
        yield (n,)
        return
    for f in range(1, n + 1):
        if n % f == 0:
            for rest in _factorizations(n // f, k - 1):
                yield (f,) + rest


def choose_topology(n_devices: int, grid_shape: Tuple[int, int, int],
                    active_axes: Tuple[int, ...]) -> Tuple[int, int, int]:
    """Minimal-halo-surface factorization of n_devices onto the active
    axes (the reference's rule): cost = per-shard ghost-plane area a
    half-step, the sum over sharded axes a of 2 local cells / local n_a;
    ties prefer more sharded axes; sharded axes divide evenly."""
    act = list(active_axes)
    best, best_cost = None, None
    for fac in _factorizations(n_devices, len(act)):
        topo = [1, 1, 1]
        ok = True
        for a, f in zip(act, fac):
            if grid_shape[a] % f != 0:
                ok = False
                break
            topo[a] = f
        if not ok:
            continue
        local = [grid_shape[a] / topo[a] for a in range(3)]
        local_cells = float(np.prod([local[a] for a in act]))
        cost = sum(2.0 * local_cells / local[a] for a in act if topo[a] > 1)
        n_sharded = sum(1 for a in act if topo[a] > 1)
        key = (cost, -n_sharded)
        if best is None or key < best_cost:
            best, best_cost = tuple(topo), key
    if best is None:
        raise ValueError(
            f"cannot factor {n_devices} devices onto grid {grid_shape} "
            f"active axes {active_axes} with even division")
    return best


def resolve_topology(parallel_cfg, grid_shape: Tuple[int, int, int],
                     active_axes: Tuple[int, ...],
                     n_devices: Optional[int] = None
                     ) -> Tuple[int, int, int]:
    """(px, py, pz) from a ParallelConfig: the topology authority. A
    manual topology names only active axes and divides the grid; "auto"
    needs a device count (``n_devices`` of the config, else the
    caller's)."""
    if parallel_cfg.topology == "none":
        return (1, 1, 1)
    if parallel_cfg.topology == "manual":
        if parallel_cfg.manual_topology is None:
            raise ValueError("manual topology requires manual_topology")
        topo = tuple(int(p) for p in parallel_cfg.manual_topology)
        for a in range(3):
            if topo[a] > 1 and a not in active_axes:
                raise ValueError(f"cannot shard inactive axis {a}")
            if grid_shape[a] % topo[a] != 0:
                raise ValueError(
                    f"axis {a} ({grid_shape[a]} cells) not divisible "
                    f"by topology {topo[a]}")
        return topo
    if parallel_cfg.topology == "auto":
        n = parallel_cfg.n_devices or n_devices
        if not n:
            raise ValueError("auto topology needs a device count")
        return choose_topology(n, grid_shape, active_axes)
    raise ValueError(f"unknown topology {parallel_cfg.topology!r}")


def default_devices(device) -> List[torch.device]:
    """The devices a run may shard over when its caller names none: the
    visible CUDA cards, or ``CPU_SHARDS`` shards on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * CPU_SHARDS


def device_count(device_type: str) -> int:
    """How many shards a run on ``device_type`` may have without an
    explicit device list (the CLI's ``_check_topology_fits`` count): the
    visible cards, or ``CPU_SHARDS``."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return CPU_SHARDS


def auto_count(device_type: str) -> int:
    """The device count "auto" shards over when neither the caller's
    device list nor the configuration's ``n_devices`` gives one: the
    visible cards; on the CPU one (an auto run stays unsharded there
    unless a count is given: shards of one CPU buy no speed)."""
    return torch.cuda.device_count() if device_type == "cuda" else 1


def _axis_suffix(key: str) -> Optional[int]:
    if key in ("gx", "gy", "gz"):
        return AXES.index(key[1])
    if len(key) > 2 and key[-2] == "_" and key[-1] in AXES:
        return AXES.index(key[-1])
    return None


class ShardMesh:
    """A topology (px, py, pz) over a grid, one device per shard (a
    device may hold several shards), each shard's coordinates, global
    offset and local box."""

    def __init__(self, topology: Sequence[int],
                 grid_shape: Sequence[int], devices: Sequence):
        self.topology = tuple(int(p) for p in topology)
        self.grid_shape = tuple(int(n) for n in grid_shape)
        n = int(np.prod(self.topology))
        if len(devices) < n:
            raise ValueError(f"topology {self.topology} needs {n} shards, "
                             f"given {len(devices)} devices")
        for a in range(3):
            if self.grid_shape[a] % self.topology[a]:
                raise ValueError(
                    f"axis {AXES[a]} ({self.grid_shape[a]} cells) not "
                    f"divisible by topology {self.topology[a]}")
        self.devices = [torch.device(d) for d in list(devices)[:n]]
        self.local_shape = tuple(self.grid_shape[a] // self.topology[a]
                                 for a in range(3))
        self.coords = list(itertools.product(
            *(range(p) for p in self.topology)))

    @property
    def n(self) -> int:
        return len(self.coords)

    def offset(self, r: int) -> Tuple[int, int, int]:
        """Global index of shard r's first cell, per axis."""
        return tuple(self.coords[r][a] * self.local_shape[a]
                     for a in range(3))

    def index(self, coord) -> int:
        px, py, pz = self.topology
        return (coord[0] * py + coord[1]) * pz + coord[2]

    def neighbor(self, r: int, a: int, side: int) -> Optional[int]:
        """The shard beside shard r on axis a (side -1: below, +1:
        above), or None at the global edge."""
        c = list(self.coords[r])
        c[a] += side
        if not 0 <= c[a] < self.topology[a]:
            return None
        return self.index(c)

    def open_sides(self, r: int) -> Tuple[Tuple[bool, bool], ...]:
        """Per axis, whether shard r has a neighbour below and above:
        there its edge is no PEC wall and its ghost plane comes from
        the neighbour."""
        return tuple((self.neighbor(r, a, -1) is not None,
                      self.neighbor(r, a, 1) is not None)
                     for a in range(3))

    def owner(self, cell) -> Tuple[int, Tuple[int, int, int]]:
        """(shard, local index) of a global cell."""
        coord = [int(cell[a]) // self.local_shape[a] for a in range(3)]
        local = tuple(int(cell[a]) - coord[a] * self.local_shape[a]
                      for a in range(3))
        return self.index(coord), local

    def distinct_devices(self) -> List[torch.device]:
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    # -- split and join of the global trees ------------------------------

    def _piece(self, leaf, r: int, axes):
        """Shard r's piece of a leaf cut along ``axes`` (a view)."""
        idx = [slice(None)] * len(leaf.shape)
        for a, dim in axes:
            size = leaf.shape[dim] // self.topology[a]
            c = self.coords[r][a]
            idx[dim] = slice(c * size, (c + 1) * size)
        return leaf[tuple(idx)]

    def _cut_axes(self, key: str, leaf, coeff: bool):
        """[(axis, dim)] along which a leaf is cut, [] if replicated."""
        nd = len(getattr(leaf, "shape", ()))
        if nd == 3:
            return [(a, a) for a in range(3) if self.topology[a] > 1]
        if nd == 1 and coeff:
            a = _axis_suffix(key)
            if a is not None and self.topology[a] > 1:
                return [(a, 0)]
        return []

    def split(self, tree: Dict[str, Any], coeff: bool = False
              ) -> List[Dict[str, Any]]:
        """Per-shard trees of views (numpy or torch) of a global state
        tree, or with ``coeff`` of a coefficient dict; replicated leaves
        are shared, not copied."""
        def walk(t, r):
            out = {}
            for k, v in t.items():
                if isinstance(v, dict):
                    out[k] = walk(v, r)
                    continue
                axes = self._cut_axes(k, v, coeff)
                out[k] = self._piece(v, r, axes) if axes else v
            return out
        return [walk(tree, r) for r in range(self.n)]

    def join_leaf(self, key: str, pieces: Sequence, device=None,
                  coeff: bool = False):
        """The global leaf from the shards' pieces (numpy, or torch on
        ``device``, the first piece's by default)."""
        first = pieces[0]
        axes = self._cut_axes(key, first, coeff)
        if not axes:
            if isinstance(first, torch.Tensor) and device is not None:
                return first.to(device)
            return first
        shape = list(first.shape)
        for a, dim in axes:
            shape[dim] *= self.topology[a]
        if isinstance(first, torch.Tensor):
            out = torch.empty(shape, dtype=first.dtype,
                              device=device or first.device)
            for r, p in enumerate(pieces):
                self._piece(out, r, axes).copy_(p)
            return out
        out = np.empty(shape, dtype=first.dtype)
        for r, p in enumerate(pieces):
            self._piece(out, r, axes)[...] = p
        return out

    def join(self, trees: Sequence[Dict[str, Any]], device=None,
             coeff: bool = False) -> Dict[str, Any]:
        """The global tree from per-shard trees (every rank-3 leaf
        joined, replicated leaves taken from shard 0)."""
        def walk(ts):
            out = {}
            for k, v in ts[0].items():
                if isinstance(v, dict):
                    out[k] = walk([t[k] for t in ts])
                else:
                    out[k] = self.join_leaf(k, [t[k] for t in ts], device,
                                            coeff)
            return out
        return walk(list(trees))


def sharded_zeros(static, mesh: ShardMesh, pack=None) -> List[Dict[str, Any]]:
    """Zero states, one a shard, each made on its own device (never a
    global array staged on one device first): the dict form, or the
    form ``pack(dict_form, shard_static)`` gives (built on the meta
    device, so nothing is allocated twice). The shards of one device
    share one incident line."""
    from fdtd3d_torch.solver import init_state, shard_static
    local = shard_static(static, mesh)
    out, line = [], {}
    for dev in mesh.devices:
        meta = init_state(local, "meta")
        if pack is not None:
            meta = pack(meta, local)
        zero = _zeros_like(meta, dev)
        if "inc" in zero:
            zero["inc"] = line.setdefault(dev, zero["inc"])
        out.append(zero)
    return out


def _zeros_like(tree, device):
    if isinstance(tree, dict):
        return {k: _zeros_like(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    return tree

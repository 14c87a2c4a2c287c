"""Difference stencils and the halo exchange of the PyTorch port.

Counterpart of ``fdtd3d_tpu/ops/stencil.py``: ``make_diff_ops`` (at the
domain edge the missing neighbor plane is zero, which is the PEC ghost
value), ``diff_ghost`` (the same difference with a neighbour shard's
plane in place of that zero), and ``exchange_stack`` (reference
``exchange_stack`` :46; ``exchange_components`` for the dict-form state
of the two-pass step): the boundary planes a decomposed run's shards
send each other between the launches, each into a ghost buffer of the
receiving shard, one plane, or with ``depth`` 2 the temporal-blocked
pass's two planes of every row, corners included
(``deep_ghost_buffers``, ``extend_stack``). A shard at the global edge
has no buffer on that side: its ghost is the PEC zero.

Sign/time conventions (leapfrog):
  E-update uses BACKWARD differences of H:  (H[i] - H[i-1]) / d
  H-update uses FORWARD  differences of E:  (E[i+1] - E[i]) / d
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


def make_diff_ops() -> Tuple[Callable, Callable]:
    """Build (diff_b, diff_f) difference ops.

    diff_b(f, axis): f[i] - f[i-1]  (zero ghost below index 0)
    diff_f(f, axis): f[i+1] - f[i]  (zero ghost above index n-1)

    A size-1 (inactive) axis yields exactly zero, as in the reference.
    """

    def diff_b(f: torch.Tensor, axis: int) -> torch.Tensor:
        n = f.shape[axis]
        if n == 1:
            return torch.zeros_like(f)
        out = f.clone()
        out.narrow(axis, 1, n - 1).sub_(f.narrow(axis, 0, n - 1))
        return out

    def diff_f(f: torch.Tensor, axis: int) -> torch.Tensor:
        n = f.shape[axis]
        if n == 1:
            return torch.zeros_like(f)
        out = torch.empty_like(f)
        torch.sub(f.narrow(axis, 1, n - 1), f.narrow(axis, 0, n - 1),
                  out=out.narrow(axis, 0, n - 1))
        torch.neg(f.narrow(axis, n - 1, 1), out=out.narrow(axis, n - 1, 1))
        return out

    return diff_b, diff_f


def diff_ghost(f: torch.Tensor, axis: int, backward: bool,
               ghost: Optional[torch.Tensor]) -> torch.Tensor:
    """``diff_b`` (``backward``) or ``diff_f`` of ``f`` along ``axis``
    with ``ghost`` (the neighbour shard's plane, the shape of ``f``
    without ``axis``) in place of the zero beyond the edge: the edge
    plane is ``f[0] - ghost`` or ``ghost - f[n-1]``, the subtraction the
    unsharded difference makes there. ``ghost`` None: the PEC zero."""
    diff_b, diff_f = make_diff_ops()
    out = (diff_b if backward else diff_f)(f, axis)
    if ghost is None or f.shape[axis] == 1:
        return out
    n = f.shape[axis]
    g = ghost.unsqueeze(axis)
    if backward:
        torch.sub(f.narrow(axis, 0, 1), g, out=out.narrow(axis, 0, 1))
    else:
        torch.sub(g, f.narrow(axis, n - 1, 1), out=out.narrow(axis, n - 1, 1))
    return out


def ghost_components(axis: int) -> Tuple[int, ...]:
    """The components a ghost plane of ``axis`` carries: the two with a
    curl term along it (every component but ``axis``'s own)."""
    return tuple(c for c in range(3) if c != axis)


def copy_plane(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; between two cards the copy goes on the
    destination's stream, after the source's stream has reached it
    (an event), and the source's stream waits for the copy (so no later
    launch there overwrites what is being read)."""
    if dst.device == src.device or not (dst.is_cuda and src.is_cuda):
        dst.copy_(src)
        return
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(src.device))
    with torch.cuda.device(dst.device):
        stream = torch.cuda.current_stream(dst.device)
        stream.wait_event(ready)
        dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    torch.cuda.current_stream(src.device).wait_event(done)


def exchange_stack(stacks: Sequence[torch.Tensor], ghosts, mesh,
                   side: int, depth: int = 1) -> None:
    """Fill every shard's ghost planes from its neighbours' stacked
    fields: (3, n1, n2, n3), or float32x2 pairs (6, n1, n2, n3), the hi
    words in rows [0, 3) and the lo words in [3, 6). ``side`` -1 (lo ->
    hi, E's ghosts): shard r receives, on each axis where ``ghosts[r]``
    has a buffer, the last plane of its lower neighbour's stack (old H);
    +1 (hi -> lo, H's ghosts): the first plane of its upper neighbour's
    (new E). Only the two components with a curl term along the axis are
    copied (of a pair stack their hi rows c, then their lo rows 3 + c).

    ``depth`` > 1 (the temporal-blocked pass's ghosts, whose generation
    1 is computed again in the receiving shard's halo): ``side`` is not
    used; ``ghosts[r]`` maps each exchanged axis to its [below, above]
    buffers (``deep_ghost_buffers``), and both sides are filled with
    ``depth`` planes of every row of any leading-row stack (fields, J,
    a psi stack), axis by axis in order: the buffers of a later axis
    span the earlier axes' ghost planes as well, copied from the
    neighbour's own buffers, so a corner cell reaches its shard without
    a diagonal message."""
    if depth > 1:
        run_copies(deep_copies(stacks, ghosts, mesh, depth))
        return
    for r, bufs in enumerate(ghosts):
        for a, buf in bufs.items():
            src = stacks[mesh.neighbor(r, a, side)]
            n = src.shape[1 + a]
            plane = src.select(1 + a, n - 1 if side < 0 else 0)
            comps = ghost_components(a)
            for base in range(0, src.shape[0], 3):
                if comps == (0, 1) or comps == (1, 2):
                    c0 = base + comps[0]
                    copy_plane(buf[c0:c0 + 2], plane[c0:c0 + 2])
                else:
                    for c in comps:
                        copy_plane(buf[base + c], plane[base + c])


def exchange_components(fields: Sequence[Dict[str, torch.Tensor]],
                        names: Sequence[str],
                        ghosts: Sequence[Dict[int, torch.Tensor]], mesh,
                        side: int) -> None:
    """``exchange_stack`` for dict-form shards: ``fields[r]`` maps the
    family's component ``names[c]`` to shard r's (n1, n2, n3) tensor;
    the same planes go into the same (3, plane) ghost buffers, one
    ``copy_plane`` a component."""
    for r, bufs in enumerate(ghosts):
        for a, buf in bufs.items():
            src = fields[mesh.neighbor(r, a, side)]
            for c in ghost_components(a):
                f = src[names[c]]
                copy_plane(buf[c], f.select(a, f.shape[a] - 1 if side < 0
                                            else 0))


def ghost_buffers(mesh, stacks: Sequence[torch.Tensor], side: int
                  ) -> List[Dict[int, torch.Tensor]]:
    """Zeroed ghost buffers of every shard, (3, plane) or a pair stack's
    (6, plane), in the stacks' dtype, on the axes where it has a
    neighbour on ``side`` (-1: E's ghosts from below, +1: H's from
    above)."""
    out: List[Dict[int, torch.Tensor]] = []
    for r, st in enumerate(stacks):
        bufs = {}
        for a in range(3):
            if mesh.neighbor(r, a, side) is not None:
                shape = list(st.shape)
                del shape[1 + a]
                bufs[a] = torch.zeros(shape, dtype=st.dtype,
                                      device=st.device)
        out.append(bufs)
    return out


def deep_ghost_buffers(mesh, stacks: Sequence[torch.Tensor], depth: int,
                       skip: Optional[int] = None
                       ) -> List[Dict[int, List[Optional[torch.Tensor]]]]:
    """Zeroed ``depth``-plane ghost buffers of every shard for
    ``exchange_stack(..., depth=depth)``: axis -> [below, above] (None
    where the shard has no neighbour), on every sharded axis but
    ``skip`` (a psi stack's own, slab-compact axis), in the stacks'
    dtype. A buffer holds every row of ``depth`` planes along its axis,
    the shard's extent along the later axes and, along each earlier
    exchanged axis, the extent grown by ``depth`` on every side with a
    neighbour (the corners)."""
    axes = [a for a in range(3) if mesh.topology[a] > 1 and a != skip]
    out = []
    for r, st in enumerate(stacks):
        grown = {c: sum(mesh.neighbor(r, c, s) is not None for s in (-1, 1))
                 for c in axes}
        bufs: Dict[int, List[Optional[torch.Tensor]]] = {}
        for a in axes:
            shape = deep_ghost_shape(st.shape, a, grown, depth)
            bufs[a] = [torch.zeros(shape, dtype=st.dtype, device=st.device)
                       if mesh.neighbor(r, a, s) is not None else None
                       for s in (-1, 1)]
        out.append(bufs)
    return out


def deep_ghost_shape(shape, a: int, grown: Dict[int, int],
                     depth: int) -> List[int]:
    """The shape of one of ``deep_ghost_buffers``' buffers along axis
    ``a`` of a leading-row stack of ``shape``: ``depth`` planes along
    ``a``, and along each earlier exchanged axis c of ``grown`` (c -> the
    shard's neighbours on c) the extent grown by ``depth`` a neighbour
    (the corners). The planner counts the buffers by it too."""
    out = list(shape)
    out[1 + a] = depth
    for c, n in grown.items():
        if c < a:
            out[1 + c] += depth * n
    return out


def deep_copies(stacks: Sequence[torch.Tensor], ghosts, mesh, depth: int
                ) -> Dict[int, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """The copies of ``exchange_stack(..., depth=depth)`` as (destination,
    source) views, by the axis whose buffers they fill: each buffer of
    axis a takes the neighbour's ``depth`` boundary planes along a,
    along each earlier exchanged axis from the neighbour's own stack
    and, beyond it, from the neighbour's buffers of that axis (the
    corners), so the copies of an axis read only the stacks and the
    buffers of earlier axes."""
    out: Dict[int, List[Tuple[torch.Tensor, torch.Tensor]]] = {}
    for a in sorted({a for g in ghosts for a in g}):
        pairs = out[a] = []
        for r, bufs in enumerate(ghosts):
            for s, buf in enumerate(bufs.get(a, ())):
                if buf is None:
                    continue
                nb = mesh.neighbor(r, a, 2 * s - 1)
                n = stacks[nb].shape[1 + a]
                _fill(pairs, buf, stacks[nb], ghosts[nb],
                      [c for c in sorted(ghosts[nb]) if c < a], a,
                      n - depth if s == 0 else 0, depth)
    return out


def _fill(pairs, dst, stack, gh, earlier, a: int, start: int,
          depth: int) -> None:
    """The copies that fill ``dst`` with planes [start, start + depth)
    along ``a`` of a shard's stack grown along the axes ``earlier`` by its
    ghost buffers ``gh``."""
    if not earlier:
        pairs.append((dst, stack.narrow(1 + a, start, depth)))
        return
    c = earlier[-1]
    lo, hi = gh[c]
    at = 0
    if lo is not None:
        pairs.append((dst.narrow(1 + c, 0, depth),
                      lo.narrow(1 + a, start, depth)))
        at = depth
    n = stack.shape[1 + c]
    _fill(pairs, dst.narrow(1 + c, at, n), stack, gh, earlier[:-1], a,
          start, depth)
    if hi is not None:
        pairs.append((dst.narrow(1 + c, at + n, depth),
                      hi.narrow(1 + a, start, depth)))


def run_copies(copies: Dict[int, List[Tuple[torch.Tensor, torch.Tensor]]]
               ) -> None:
    """``deep_copies``' copies, axis by axis: those within one card in one
    ``_foreach_copy_`` a card and axis (one call instead of a Python
    round trip a copy), those between cards by ``copy_plane``."""
    for a in sorted(copies):
        local: Dict[torch.device, Tuple[list, list]] = {}
        for dst, src in copies[a]:
            if dst.device == src.device:
                d, s = local.setdefault(dst.device, ([], []))
                d.append(dst)
                s.append(src)
            else:
                copy_plane(dst, src)
        for dev, (d, s) in local.items():
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    torch._foreach_copy_(d, s)
            else:
                torch._foreach_copy_(d, s)


def extend_stack(stack: torch.Tensor, gh) -> torch.Tensor:
    """A shard's stack grown by its ``deep_ghost_buffers`` on every
    exchanged axis (a new tensor): the values its frame holds."""
    out = stack
    for a in sorted(gh):
        lo, hi = gh[a]
        out = torch.cat([t for t in (lo, out, hi) if t is not None], 1 + a)
    return out

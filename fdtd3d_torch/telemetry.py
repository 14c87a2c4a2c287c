"""Health reduction of the PyTorch port (what ``check_finite`` needs).

Counterpart of ``fdtd3d_tpu/telemetry.py::make_health_fn`` reduced to
the finite flag: one min/max reduction per state tensor at the end of a
chunk, folded into one device scalar that the caller reads back once.
The energy, divergence and per-chip counters and the telemetry sink
come with ROADMAP.md item A5.

A batch (fdtd3d_torch/batch.py) reduces per lane: one (B,) tensor from
one reduction over the lane-stacked state, read back once per chunk, so
a NaN in one lane flips only that lane's flag.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List

import torch


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def max_abs(x: torch.Tensor) -> torch.Tensor:
    """max |x| in one pass; NaN propagates (torch.aminmax keeps NaN)."""
    lo, hi = torch.aminmax(x.reshape(-1))
    return torch.maximum(hi, -lo).float()


def make_health_fn():
    """health(state) -> device scalar max |x| over every floating tensor
    of the state (either form, dict or packed): finite iff the whole
    state is finite."""

    def health(state: Dict[str, Any]) -> torch.Tensor:
        return torch.stack([max_abs(t) for t in _tensors(state)
                            if t.is_floating_point()]).max()

    return health


def is_finite(health: torch.Tensor) -> bool:
    """The one host readback of a chunk's health scalar."""
    return math.isfinite(health.item())


def lane_max_abs(x: torch.Tensor) -> torch.Tensor:
    """max |x| of each lane of a lane-leading tensor, (B,); NaN
    propagates."""
    lo, hi = torch.aminmax(x.reshape(x.shape[0], -1), dim=1)
    return torch.maximum(hi, -lo).float()


def make_lane_health_fn():
    """health(state) -> (B,) device tensor: per lane, max |x| over every
    floating tensor of a lane-stacked state (dict or packed form, every
    leaf lane-leading)."""

    def health(state: Dict[str, Any]) -> torch.Tensor:
        return torch.stack([lane_max_abs(t) for t in _tensors(state)
                            if t.is_floating_point()]).amax(dim=0)

    return health


def lanes_finite(health: torch.Tensor) -> List[bool]:
    """The one host readback of a chunk's per-lane health: finite flag
    per lane."""
    return [math.isfinite(v) for v in health.tolist()]

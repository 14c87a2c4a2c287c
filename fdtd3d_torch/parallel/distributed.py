"""Gather of a decomposed run's values to the host.

Counterpart of ``fdtd3d_tpu/parallel/distributed.py``. This slice of the
port runs every shard in one process, so the gather is a join of the
shards' pieces copied to the host. Several processes meeting through
``torch.distributed`` (the reference's ``initialize`` and its
``--coordinator-address``/``--num-processes``/``--process-id`` flags)
are ROADMAP.md item A11(b).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Multi-process runs are not ported yet."""
    raise NotImplementedError(
        "multi-process runs (torch.distributed, --coordinator-address / "
        "--num-processes / --process-id) are not ported to fdtd3d_torch "
        "yet (ROADMAP.md queue A11(b)); one process drives every shard "
        "(Simulation(cfg, devices=[...]))")


def gather_to_host(arr, mesh=None, key: str = "") -> np.ndarray:
    """The global value of a leaf as a host numpy array: a tensor is
    copied (bf16 widened exactly to float32); a sequence of per-shard
    pieces is joined by ``mesh`` (``ShardMesh.join_leaf``) first."""
    from fdtd3d_torch.convert import to_host
    if isinstance(arr, torch.Tensor):
        return to_host(arr)
    if mesh is None or not isinstance(arr, Sequence):
        return np.asarray(arr)
    return mesh.join_leaf(key, [to_host(p) for p in arr])

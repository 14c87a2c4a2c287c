"""Leveled logging of the PyTorch port.

Counterpart of ``fdtd3d_tpu/log.py`` (one process-global level set from
``OutputConfig.log_level``: 0 = silent, 1 = progress lines, 2+ =
verbose), without the multi-process rank gate: the port runs one
process on one device.
"""

from __future__ import annotations

import sys

_level = 1


def set_level(level: int) -> None:
    global _level
    _level = int(level)


def log(msg: str, level: int = 1) -> None:
    """Print ``msg`` when the configured level is >= ``level``."""
    if _level >= level:
        print(msg, flush=True)


def warn(msg: str) -> None:
    """Warnings always print (to stderr), at any level."""
    print(f"WARNING: {msg}", file=sys.stderr, flush=True)

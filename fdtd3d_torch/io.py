"""Field dumps of the PyTorch port: DAT files and the atomic writer.

Counterpart of the DAT half of ``fdtd3d_tpu/io.py`` (numpy path): a DAT
file is the bare little-endian C-order values of one component, with a
``.manifest.json`` sidecar recording shape, dtype and step; both files
are byte-identical to the reference's. Every file is written through
the atomic writer (tmp file + fsync + ``os.replace``), so a crash
mid-write never leaves a torn file under the final name. Checkpoints
and the TXT/BMP dumpers come with ROADMAP.md items A6 and A7.

A bf16 field is dumped as its 2-byte words with the manifest dtype
``"<V2"``, which is what the reference's writer records for an
``ml_dtypes`` bfloat16 array; ``load_dat`` reads such a dump back as
bf16 widened to float32.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
from typing import Optional

import numpy as np


def _tmp_name(path: str) -> str:
    return f"{path}.tmp.{os.getpid()}"


def _fsync_dir(path: str) -> None:
    """fsync the parent directory so the rename itself is durable."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # platform without directory fsync
        pass


@contextlib.contextmanager
def atomic_open(path: str, mode: str = "w"):
    """Crash-safe whole-file write: tmp + flush + fsync + ``os.replace``.
    Modes 'w'/'wb'/'x'/'xb' only."""
    if any(c in mode for c in "ra+"):
        raise ValueError(
            f"atomic_open is for whole-file writes ('w'/'wb'/'x'), "
            f"got mode {mode!r}")
    tmp = _tmp_name(path)
    try:
        with open(tmp, mode) as fh:
            yield fh
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        _fsync_dir(path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_publish(path: str, write_fn) -> None:
    """Atomic publish for writers that need a filesystem path:
    ``write_fn(tmp)`` writes the complete file, which is then fsync'd
    and renamed into place."""
    tmp = _tmp_name(path)
    try:
        write_fn(tmp)
        with open(tmp, "rb") as fh:
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        _fsync_dir(path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


BF16_DTYPE = "<V2"   # the manifest dtype of a bf16 dump


def dump_dat(arr: np.ndarray, path: str, step: Optional[int] = None,
             bf16: bool = False):
    """Bare binary dump (little-endian, C order) + .manifest.json sidecar.
    ``bf16``: ``arr`` holds the 2-byte words of a bf16 field (its int16
    bits), recorded as ``BF16_DTYPE``."""
    arr = np.asarray(arr)
    le = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
    atomic_publish(path, le.tofile)
    manifest = {"shape": list(arr.shape),
                "dtype": BF16_DTYPE if bf16 else le.dtype.str,
                "order": "C", "endian": "little"}
    if step is not None:
        manifest["step"] = int(step)
    with atomic_open(path + ".manifest.json", "w") as f:
        json.dump(manifest, f)


def load_dat(path: str) -> np.ndarray:
    """Load a DAT dump with the shape and dtype of its sidecar."""
    with open(path + ".manifest.json") as f:
        manifest = json.load(f)
    if manifest["dtype"] == BF16_DTYPE:
        words = np.fromfile(path, dtype="<u2").astype(np.uint32)
        return (words << 16).view(np.float32).reshape(manifest["shape"])
    return np.fromfile(path, dtype=np.dtype(manifest["dtype"])).reshape(
        manifest["shape"])


def write_outputs(sim, step: int):
    """Dump every stored field component (DAT) into the save dir."""
    out = sim.cfg.output
    other = [f for f in out.formats if f != "dat"]
    if other:
        raise NotImplementedError(
            f"dump formats {other} are not ported to fdtd3d_torch yet "
            f"(ROADMAP.md queue A7); use --save-formats dat")
    import torch

    from fdtd3d_torch import convert
    os.makedirs(out.save_dir, exist_ok=True)
    for comp, v in sim.component_views().items():
        base = os.path.join(out.save_dir, f"{comp}_t{step:06d}")
        if v.dtype == torch.bfloat16:
            dump_dat(convert.bf16_words(v), base + ".dat", step=step,
                     bf16=True)
        else:
            dump_dat(convert.to_host(v), base + ".dat", step=step)


def load_bmp_gray(path: str) -> np.ndarray:
    """24-bit uncompressed BMP -> float64 (H, W) luminance in [0, 1]
    (material-init input; ``fdtd3d_tpu/io.py::load_bmp_gray``)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    w, h = struct.unpack_from("<ii", data, 18)
    (bpp,) = struct.unpack_from("<H", data, 28)
    (compression,) = struct.unpack_from("<I", data, 30)
    if bpp != 24 or compression != 0:
        raise ValueError(
            f"{path}: only 24-bit uncompressed BMP supported "
            f"(got {bpp}bpp, compression {compression})")
    top_down = h < 0
    h = abs(h)
    row = w * 3
    stride = row + (4 - row % 4) % 4
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: bad BMP dimensions {w}x{h}")
    if offset + (h - 1) * stride + row > len(data):
        raise ValueError(f"{path}: truncated BMP ({len(data)} bytes)")
    out = np.empty((h, w, 3), dtype=np.uint8)
    for y in range(h):
        line = np.frombuffer(data, np.uint8, row,
                             offset + y * stride).reshape(w, 3)
        out[y if top_down else h - 1 - y] = line[:, ::-1]  # BGR -> RGB
    return out.mean(axis=2) / 255.0

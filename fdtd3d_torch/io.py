"""Field dumps and checkpoints of the PyTorch port, and the atomic writer.

Counterpart of the DAT and npz-checkpoint halves of ``fdtd3d_tpu/io.py``
(numpy path): a DAT file is the bare little-endian C-order values of one
component, with a ``.manifest.json`` sidecar recording shape, dtype and
step; both files are byte-identical to the reference's. TXT dumps are
``i j k %.9e`` lines (``format_e9``, a vectorised formatter byte-equal
to C's printf, stands in for the reference's native writer); BMP dumps
a colormapped central cut (the reference's encoder and colormap, in
numpy). Every file is written through the atomic writer (tmp file +
fsync + ``os.replace``; the fault plan's ``fail_write`` fires just
before the rename), so a crash mid-write never leaves a torn file under
the final name.

A checkpoint is the reference's format: one ``.npz`` holding every leaf
of the dict-form state under its ``/``-joined key (``E/Ex``,
``psi_E/Ex_y``, ``inc/Einc``, ``t`` as an int32 scalar; float32x2 lo
words and compensated residuals included), plus a zlib-compressed JSON
``__meta__`` carrying the run's metadata, a per-array ``_manifest``
(shape, dtype) and a crc32 ``_checksum`` over the sorted keys and raw
bytes. bf16 leaves are stored widened to f32, as the reference stores
them, and a restore casts them back, so the bits return unchanged.
``save_checkpoint`` streams: it takes the leaves as they are (device
tensors included), brings one at a time to the host and writes it as a
zip member in sorted-key order, ``__meta__`` last; so a checkpoint of a
carry on the card holds one leaf on the host at a time and none extra
on the device. Either package loads the other's files.

A bf16 field is dumped as its 2-byte words with the manifest dtype
``"<V2"``, which is what the reference's writer records for an
``ml_dtypes`` bfloat16 array; ``load_dat`` reads such a dump back as
bf16 widened to float32.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import struct
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from fdtd3d_torch import faults as _faults
from fdtd3d_torch import log as _log


class CheckpointCorrupt(ValueError):
    """A checkpoint failed an integrity check.

    The message names the path and which check failed (zip/npz
    structure, manifest, checksum). Resume paths (CLI ``--resume auto``,
    the supervisor's rollback) catch this and fall back to an older
    committed snapshot."""


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


def _publish_tmp(path: str, tmp: str) -> None:
    """The publish epilogue of both atomic writers: the fault plan's
    fail-the-Nth-write hook first (the final name is never touched on an
    injected failure), then the rename and the directory fsync."""
    _faults.on_write(path)
    os.replace(tmp, path)
    _fsync_dir(path)


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
        _publish_tmp(path, tmp)
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
        _publish_tmp(path, tmp)
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

    def _write(tmp):
        if le.flags.c_contiguous or le.ndim == 0:
            le.tofile(tmp)
            return
        # a strided or broadcast view (a uniform material grid): one
        # contiguous copy of a leading slice at a time, not tofile's
        # value-by-value walk nor a copy of the whole
        with open(tmp, "wb") as f:
            for part in le:
                f.write(np.ascontiguousarray(part).tobytes())

    atomic_publish(path, _write)
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


# --------------------------------------------------------------------------
# TXT: "i j k value" lines, one per cell, the value as "%.9e"
# --------------------------------------------------------------------------

# one value's "%.9e" bytes at fixed columns, 0 where a byte is absent
# (the compaction below drops them): sign, the first digit, ".", nine
# digits, "e", the exponent's sign, its hundreds (0 when |exp| < 100),
# tens and units
_E9_WIDTH = 17
# a value whose scaled mantissa lies this close to a rounding tie is
# formatted exactly (by Python, whose "%.9e" is correctly rounded, as
# C's printf is); the float64 scaling errs by a few ulp, ~4e-6 at 1e10
_E9_TIE_MARGIN = 1e-4
# lines formatted per vectorised chunk (bounds each thread's
# temporaries to ~25 MB whatever the array's size)
_TXT_CHUNK = 1 << 18


def _e9_exact(v: float) -> bytes:
    """'%.9e' of one value, as C's printf writes it (a NaN with its sign
    bit set as ``-nan``)."""
    if v != v:
        return b"-nan" if np.signbit(v) else b"nan"
    return f"{v:.9e}".encode()


_E9_RANGE = 280          # |decimal exponent| the vectorised path covers
# the five-digit groups "00000".."99999", the exponent fields
# (sign, hundreds or 0, tens, units) of -_E9_RANGE-1..+_E9_RANGE+1, and
# the powers of ten the mantissa is scaled by
_DIGITS5 = (np.arange(100000)[:, None] // 10 ** np.arange(4, -1, -1)
            % 10 + ord("0")).astype(np.uint8)
_EXPS = np.arange(-_E9_RANGE - 1, _E9_RANGE + 2)
_EXP_FIELD = np.array(
    [[ord("-" if e < 0 else "+"),
      abs(e) // 100 + ord("0") if abs(e) >= 100 else 0,
      abs(e) // 10 % 10 + ord("0"), abs(e) % 10 + ord("0")]
     for e in _EXPS], dtype=np.uint8)
_POW10 = np.power(10.0, (9 - _EXPS).astype(np.float64))


def format_e9(values: np.ndarray) -> np.ndarray:
    """``"%.9e"`` of every value of a float array, as a (n, 17) uint8
    matrix of the text's bytes at fixed columns, 0 where a byte is
    absent. Byte-equal to C's printf (and Python's format), which round
    the decimal value correctly: the 10 significant digits come from the
    value scaled by 10^(9-E) in float64, and a value whose scaled
    mantissa falls within ``_E9_TIE_MARGIN`` of a rounding tie, or
    outside the exponent range the scaling covers, or non-finite, is
    formatted one at a time by Python."""
    x = np.asarray(values, dtype=np.float64).reshape(-1)
    n = x.size
    out = np.zeros((n, _E9_WIDTH), dtype=np.uint8)
    if n == 0:
        return out
    a = np.abs(x)
    nz = np.isfinite(x) & (a > 0)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        e = np.floor(np.log10(np.where(nz, a, 1.0))).astype(np.int64)
        slow = ~np.isfinite(x) | (e < -_E9_RANGE) | (e > _E9_RANGE)
        e[slow] = 0
        k = e + _E9_RANGE + 1                # row of e in the tables
        y = a * _POW10[k]
        for step in (1, -1):                 # log10 can miss by one at 10^k
            fix = nz & ~slow & ((y >= 1e10) if step > 0 else (y < 1e9))
            k[fix] += step
            y[fix] = a[fix] * _POW10[k[fix]]
        q = np.floor(y + 0.5)
        up = q >= 1e10
        q[up] = 1e9
        k[up] += 1
        slow |= nz & ((np.abs(y - np.floor(y) - 0.5) < _E9_TIE_MARGIN)
                      | (q < 1e9) | (k >= len(_EXPS)))
    k[~nz | slow] = _E9_RANGE + 1            # exponent 0 (zero, or slow)
    qi = np.where(nz & ~slow, q, 0.0).astype(np.int64)
    hi5 = _DIGITS5[qi // 100000]
    out[:, 0] = np.where(np.signbit(x), ord("-"), 0)
    out[:, 1] = hi5[:, 0]
    out[:, 2] = ord(".")
    out[:, 3:7] = hi5[:, 1:]
    out[:, 7:12] = _DIGITS5[qi % 100000]
    out[:, 12] = ord("e")
    out[:, 13:17] = _EXP_FIELD[k]
    for i in np.flatnonzero(slow):
        text = _e9_exact(float(x[i]))
        out[i] = 0
        out[i, :len(text)] = np.frombuffer(text, np.uint8)
    return out


def _index_table(n: int) -> np.ndarray:
    """(n, width) uint8: the bytes of ``f"{i} "`` for i < n, zero-padded."""
    text = np.array([f"{i} " for i in range(n)], dtype=f"S{len(str(n)) + 1}")
    return text.view(np.uint8).reshape(n, -1)


def txt_bytes(arr: np.ndarray, start: int = 0, stop: int = None) -> bytes:
    """The TXT dump's lines ``start`` to ``stop`` (C order) of ``arr``:
    each ``"i j k %.9e\n"`` (one index per dimension), or for a complex
    array ``"i j k %.9e %.9e\n"`` (real, imaginary), the reference's
    format (``fdtd3d_tpu/io.py::dump_txt``), built without a Python loop
    over the values."""
    arr = np.asarray(arr)
    stop = arr.size if stop is None else min(stop, arr.size)
    if stop <= start:
        return b""
    tables = [_index_table(n) for n in arr.shape]
    cplx = np.iscomplexobj(arr)
    width = sum(t.shape[1] for t in tables) + _E9_WIDTH + 1
    if cplx:
        width += _E9_WIDTH + 1
    lines = np.empty((stop - start, width), dtype=np.uint8)
    idx = np.unravel_index(np.arange(start, stop), arr.shape)
    col = 0
    for t, i in zip(tables, idx):
        lines[:, col:col + t.shape[1]] = t[i]
        col += t.shape[1]
    # the values gathered by index: a broadcast grid is never copied whole
    vals = arr[idx]
    if cplx:
        lines[:, col:col + _E9_WIDTH] = format_e9(vals.real)
        col += _E9_WIDTH
        lines[:, col] = ord(" ")
        col += 1
        vals = vals.imag
    lines[:, col:col + _E9_WIDTH] = format_e9(vals)
    lines[:, -1] = ord("\n")
    return lines[lines != 0].tobytes()


def dump_txt(arr: np.ndarray, path: str):
    """Human-readable dump: one ``i j k value`` line per cell, the value
    as ``%.9e`` (the reference's format, byte for byte), written in
    vectorised chunks, formatted on a few threads (numpy releases the
    interpreter lock), through the atomic writer."""
    from concurrent.futures import ThreadPoolExecutor
    arr = np.asarray(arr)
    starts = range(0, arr.size, _TXT_CHUNK)
    workers = max(1, min(8, os.cpu_count() or 1, len(starts)))

    def _write(tmp):
        with open(tmp, "wb") as f, ThreadPoolExecutor(workers) as pool:
            for text in pool.map(
                    lambda s: txt_bytes(arr, s, s + _TXT_CHUNK), starts):
                f.write(text)

    atomic_publish(path, _write)


def load_txt(path: str, shape: Tuple[int, ...],
             dtype=np.float64) -> np.ndarray:
    """A TXT dump back into an array of ``shape``: each line's value
    placed at its indices (a complex ``dtype`` reads the real and
    imaginary columns)."""
    out = np.zeros(shape, dtype=dtype)
    data = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if data.size:
        nd = len(shape)
        vals = data[:, nd]
        if np.iscomplexobj(out):
            vals = vals + 1j * data[:, nd + 1]
        out[tuple(data[:, :nd].astype(np.int64).T)] = vals
    return out


# --------------------------------------------------------------------------
# BMP: a colormapped 2D cut, 24-bit uncompressed
# --------------------------------------------------------------------------

def bmp_encode(rgb: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB -> 24-bit uncompressed BMP bytes (rows
    bottom-up, BGR, each padded to 4 bytes; the reference's header)."""
    h, w, _ = rgb.shape
    row = w * 3
    pad = (4 - row % 4) % 4
    body = np.zeros((h, row + pad), dtype=np.uint8)
    body[:, :row] = np.ascontiguousarray(rgb[::-1, :, ::-1]).reshape(h, row)
    header = struct.pack("<2sIHHI", b"BM", 54 + body.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, body.size,
                       2835, 2835, 0, 0)
    return header + info + body.tobytes()


def colormap_diverging(v: np.ndarray) -> np.ndarray:
    """Symmetric blue-white-red map on [-max|v|, +max|v|] -> uint8 RGB."""
    v = np.asarray(v, dtype=np.float64)
    scale = np.max(np.abs(v)) or 1.0
    x = np.clip(v / scale, -1.0, 1.0)
    rgb = np.empty(v.shape + (3,), dtype=np.uint8)
    up = np.clip(1.0 + x, 0.0, 1.0)     # 0 at -1 .. 1 at >=0
    dn = np.clip(1.0 - x, 0.0, 1.0)     # 1 at <=0 .. 0 at +1
    rgb[..., 0] = np.round(255 * np.where(x >= 0, 1.0, up))
    rgb[..., 1] = np.round(255 * np.minimum(up, dn))
    rgb[..., 2] = np.round(255 * np.where(x <= 0, 1.0, dn))
    return rgb


def bmp_image(arr: np.ndarray, active_axes=(0, 1)) -> np.ndarray:
    """The (rows, cols) image ``dump_bmp`` colours: the central cut of a
    rank-3 grid spanned by the first two active axes (rows = the second,
    cols = the first), or for one active axis its line repeated in 24
    rows. A complex field shows its real part, as the reference's."""
    arr = np.asarray(arr)
    if np.iscomplexobj(arr):
        arr = arr.real
    axes = list(active_axes) or [0, 1]
    if len(axes) == 1:
        a = axes[0]
        line = np.moveaxis(arr, a, 0).reshape(arr.shape[a], -1)[:, 0]
        return np.tile(line[None, :], (24, 1))
    a, b = axes[0], axes[1]
    sl = [slice(None)] * arr.ndim
    for r in range(arr.ndim):
        if r not in (a, b):
            sl[r] = arr.shape[r] // 2
    cut = arr[tuple(sl)]
    if a > b:  # keep (a, b) order as (rows, cols)
        cut = cut.T
    return cut.T


def dump_bmp(arr: np.ndarray, path: str, active_axes=(0, 1)):
    """Central 2D cut of a rank-3 grid -> colormapped BMP
    (``bmp_image``, ``colormap_diverging``), through the atomic writer."""
    data = bmp_encode(colormap_diverging(bmp_image(arr, active_axes)))

    def _write(tmp):
        with open(tmp, "wb") as f:
            f.write(data)

    atomic_publish(path, _write)


def load_bmp(path: str) -> np.ndarray:
    """Decode a 24-bit uncompressed BMP -> uint8 (H, W, 3) RGB, bottom-up
    (positive height) or top-down (negative height) rows."""
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
        raise ValueError(
            f"{path}: truncated BMP ({len(data)} bytes; header claims "
            f"{w}x{h} 24-bit rows ending at byte "
            f"{offset + (h - 1) * stride + row})")
    rows = np.frombuffer(data, np.uint8, (h - 1) * stride + row, offset)
    rows = np.lib.stride_tricks.as_strided(
        rows, (h, row), (stride, 1)).reshape(h, w, 3)[:, :, ::-1]
    return np.ascontiguousarray(rows if top_down else rows[::-1])


def load_bmp_gray(path: str) -> np.ndarray:
    """BMP -> float64 (H, W) luminance in [0, 1] (material-init input)."""
    return load_bmp(path).mean(axis=2) / 255.0


# --------------------------------------------------------------------------
# periodic output and the material dump
# --------------------------------------------------------------------------

def _dump_formats(arr: np.ndarray, base: str, formats, axes,
                  step: Optional[int] = None, bf16_words=None):
    """``arr`` in each of ``formats`` (dat, txt, bmp; others are
    ignored, as the reference ignores them) under ``base`` + suffix. A
    bf16 field's DAT holds its 2-byte words (``bf16_words``); its TXT and
    BMP its values widened exactly, as the reference formats them."""
    if "dat" in formats:
        if bf16_words is not None:
            dump_dat(bf16_words, base + ".dat", step=step, bf16=True)
        else:
            dump_dat(arr, base + ".dat", step=step)
    if "txt" in formats:
        dump_txt(arr, base + ".txt")
    if "bmp" in formats:
        dump_bmp(arr, base + ".bmp", axes)


def write_outputs(sim, step: int):
    """Dump every stored field component into the save dir, in each
    configured format (``fdtd3d_tpu/io.py::write_outputs``)."""
    import torch

    from fdtd3d_torch import convert
    out = sim.cfg.output
    os.makedirs(out.save_dir, exist_ok=True)
    axes = sim.static.mode.active_axes
    for comp, v in sim.component_views().items():
        base = os.path.join(out.save_dir, f"{comp}_t{step:06d}")
        bf16 = v.dtype == torch.bfloat16
        words = convert.bf16_words(v) if bf16 and "dat" in out.formats \
            else None
        arr = convert.to_host(v) \
            if not bf16 or {"txt", "bmp"} & set(out.formats) else None
        _dump_formats(arr, base, out.formats, axes, step=step,
                      bf16_words=words)


def write_materials(sim):
    """One-time dump of every material grid (``--save-materials``,
    ``fdtd3d_tpu/io.py::write_materials``) in each configured format,
    each as a float64 grid of the run's shape: eps at each E component's
    staggered positions, mu at each H component's, the Drude omega_p and
    gamma (magnetic: omega_pm, gamma_m) when that dispersion is on, and
    the uniform sigma_e and sigma_m, in the reference's order and
    names."""
    from fdtd3d_torch import materials as mats
    out = sim.cfg.output
    os.makedirs(out.save_dir, exist_ok=True)
    mode = sim.static.mode
    mat = sim.cfg.materials
    shape = sim.static.grid_shape
    grids: Dict[str, Any] = {}
    for comp in mode.e_components:
        grids[f"eps_{comp}"] = mats.scalar_or_grid(
            comp, shape, mode.active_axes, mat.eps, mat.eps_sphere,
            mat.eps_file)
        if mat.use_drude:
            wp, gamma, _ = mats.drude_params(comp, shape,
                                             mode.active_axes, mat)
            grids[f"omega_p_{comp}"] = wp
            grids[f"gamma_{comp}"] = gamma
    for comp in mode.h_components:
        grids[f"mu_{comp}"] = mats.scalar_or_grid(
            comp, shape, mode.active_axes, mat.mu, mat.mu_sphere,
            mat.mu_file)
        if mat.use_drude_m:
            wpm, gm, _ = mats.drude_params(comp, shape, mode.active_axes,
                                           mat, magnetic=True)
            grids[f"omega_pm_{comp}"] = wpm
            grids[f"gamma_m_{comp}"] = gm
    grids["sigma_e"] = mat.sigma_e
    grids["sigma_m"] = mat.sigma_m
    for name, val in grids.items():
        arr = np.broadcast_to(np.asarray(val, dtype=np.float64), shape)
        _dump_formats(arr, os.path.join(out.save_dir, name), out.formats,
                      sim.static.mode.active_axes)


# --------------------------------------------------------------------------
# checkpoints (the whole dict-form state)
# --------------------------------------------------------------------------

def _flat_leaves(prefix: str, tree, out: Dict[str, Any]) -> Dict[str, Any]:
    """``/``-joined key -> leaf, leaves as they are (no copies)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_leaves(f"{prefix}/{k}" if prefix else k, v, out)
    else:
        out[prefix] = tree
    return out


def _host_leaf(leaf) -> np.ndarray:
    """One leaf as the host array the file stores: a tensor through
    ``convert.to_host`` (bf16 widened exactly to f32, the reference's
    rule for non-native dtypes; complex as complex, the reference's
    ``<c8``/``<c16`` members), the host step counter as an int32 scalar
    (the reference's ``t``), a numpy leaf as it is. A callable leaf is
    called first (a paired complex run joins each leaf from its legs
    only when the writer reaches it)."""
    import torch
    if callable(leaf):
        leaf = leaf()
    if isinstance(leaf, torch.Tensor):
        from fdtd3d_torch import convert
        return convert.to_host(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _crc_update(crc: int, key: str, arr: np.ndarray) -> int:
    crc = zlib.crc32(key.encode(), crc)
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8),
                      crc)


def _state_checksum(flat: Dict[str, np.ndarray]) -> int:
    """crc32 over every array's name and raw bytes, in sorted-key order
    (``fdtd3d_tpu/io.py::_state_checksum``)."""
    crc = 0
    for key in sorted(flat):
        crc = _crc_update(crc, key, flat[key])
    return crc


def _write_member(zf: zipfile.ZipFile, key: str, arr: np.ndarray) -> None:
    """One array as the npz member ``key.npy`` (what ``np.savez``
    writes)."""
    with zf.open(key + ".npy", "w", force_zip64=True) as fid:
        np.lib.format.write_array(fid, np.asanyarray(arr),
                                  allow_pickle=False)


def save_checkpoint(state, path: str, extra: Optional[Dict] = None):
    """Bit-exact .npz snapshot of the whole state tree.

    Crash-safe: written through :func:`atomic_open`, so an .npz under its
    final name is committed by construction. The leaves (tensors on any
    device, numpy arrays or the host step counter) are brought to the
    host one at a time in sorted-key order, each written and checksummed
    before the next; the metadata blob (``extra`` plus ``_manifest`` and
    ``_checksum``) goes last."""
    flat = _flat_leaves("", state, {})
    manifest: Dict[str, List] = {}
    crc = 0
    with atomic_open(path, "wb") as fh:
        with zipfile.ZipFile(fh, mode="w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key in sorted(flat):
                arr = _host_leaf(flat[key])
                manifest[key] = [list(arr.shape), arr.dtype.str]
                crc = _crc_update(crc, key, arr)
                _write_member(zf, key, arr)
                del arr
            meta = dict(extra or {})
            meta["_manifest"] = manifest
            meta["_checksum"] = crc
            blob = zlib.compress(json.dumps(meta).encode())
            _write_member(zf, "__meta__",
                          np.frombuffer(blob, dtype=np.uint8))


_READ_ERRORS = (zipfile.BadZipFile, ValueError, OSError, EOFError,
                KeyError, zlib.error, json.JSONDecodeError)


def load_checkpoint(path: str, verify: bool = True) -> Tuple[Dict, Dict]:
    """-> (state tree of numpy arrays, extra metadata dict).

    Integrity: a truncated or corrupt .npz, a manifest mismatch or a
    payload-checksum failure raises :class:`CheckpointCorrupt` naming the
    path and the failed check, never a raw numpy/zipfile traceback. Files
    without ``_checksum``/``_manifest`` load without those checks."""
    flat: Dict[str, np.ndarray] = {}
    extra: Dict = {}
    try:
        with np.load(path, allow_pickle=False) as z:
            for key in z.files:
                if key == "__meta__":
                    extra = json.loads(zlib.decompress(z[key].tobytes()))
                    continue
                flat[key] = z[key]
    except _READ_ERRORS as exc:
        raise CheckpointCorrupt(
            f"{path}: unreadable checkpoint (npz/zip structure check "
            f"failed: {type(exc).__name__}: {exc})") from exc
    manifest = extra.pop("_manifest", None)
    checksum = extra.pop("_checksum", None)
    if verify and manifest is not None:
        want = {k: (tuple(s), d) for k, (s, d) in manifest.items()}
        got = {k: (v.shape, v.dtype.str) for k, v in flat.items()}
        if want != got:
            missing = sorted(set(want) - set(got))
            extra_k = sorted(set(got) - set(want))
            changed = sorted(k for k in set(want) & set(got)
                             if want[k] != got[k])
            raise CheckpointCorrupt(
                f"{path}: manifest check failed (missing arrays: "
                f"{missing or 'none'}; unexpected: {extra_k or 'none'}; "
                f"shape/dtype changed: {changed or 'none'})")
    if verify and checksum is not None:
        actual = _state_checksum(flat)
        if actual != checksum:
            raise CheckpointCorrupt(
                f"{path}: payload checksum check failed (stored "
                f"{checksum:#010x}, computed {actual:#010x}) — the "
                f"snapshot was damaged after it was committed")
    state: Dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = state
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return state, extra


def read_checkpoint_meta(path: str) -> Dict:
    """Metadata of a snapshot without loading its arrays (the
    ``__meta__`` member only): what resume paths peek at to decide how
    to resume. The payload's integrity is load_checkpoint's job."""
    try:
        with np.load(path, allow_pickle=False) as z:
            if "__meta__" not in z.files:
                return {}
            extra = json.loads(zlib.decompress(z["__meta__"].tobytes()))
    except _READ_ERRORS as exc:
        raise CheckpointCorrupt(
            f"{path}: unreadable checkpoint metadata "
            f"({type(exc).__name__}: {exc})") from exc
    extra.pop("_manifest", None)
    extra.pop("_checksum", None)
    return extra


# --------------------------------------------------------------------------
# reshard on resume: the CPML psi layout between topologies
# --------------------------------------------------------------------------

# A snapshot's arrays are topology-independent except the CPML psi,
# stored slab-compact per shard (solver.slab_axes: 2 m planes a shard
# along its own axis). A snapshot of one topology becomes another's by
# expanding psi to the full axis and compacting it onto the target
# layout (``fdtd3d_tpu/io.py`` :530-650, the same rules): both exact
# data movement, the compact step checking that every dropped plane is
# zero (psi is zero outside the absorbing slabs, so a nonzero drop means
# the snapshot and its declared layout disagree).

_PSI_GROUPS = ("psi_E", "psi_H", "lopsi_E", "lopsi_H")
_AXES = "xyz"


def _along(a: int, lo: int, hi: int, ndim: int):
    sl = [slice(None)] * ndim
    sl[a] = slice(lo, hi)
    return tuple(sl)


def psi_slab_expand(arr: np.ndarray, axis: int, n_global: int,
                    topo_a: int, m: Optional[int],
                    key: str = "psi") -> np.ndarray:
    """Stored psi (slab-compact, or full storage when ``m`` is None) ->
    the full global axis. Shard i of ``topo_a`` holds planes
    [i 2m, i 2m + m) (its local lo edge) and [i 2m + m, (i + 1) 2m)
    (its local hi edge)."""
    arr = np.asarray(arr)
    if m is None:
        if arr.shape[axis] != n_global:
            raise ValueError(
                f"reshard: {key} has {arr.shape[axis]} planes along "
                f"axis {_AXES[axis]} but the declared layout is full "
                f"storage of {n_global}: snapshot and layout disagree")
        return arr
    want = 2 * m * topo_a
    if arr.shape[axis] != want:
        raise ValueError(
            f"reshard: {key} has {arr.shape[axis]} planes along axis "
            f"{_AXES[axis]} but the declared slab layout (m={m} x "
            f"{topo_a} shards) stores {want}: snapshot and layout "
            f"disagree")
    shape = list(arr.shape)
    shape[axis] = n_global
    out = np.zeros(shape, dtype=arr.dtype)
    ln = n_global // topo_a
    nd = arr.ndim
    for i in range(topo_a):
        out[_along(axis, i * ln, i * ln + m, nd)] = \
            arr[_along(axis, 2 * i * m, 2 * i * m + m, nd)]
        out[_along(axis, (i + 1) * ln - m, (i + 1) * ln, nd)] = \
            arr[_along(axis, 2 * i * m + m, 2 * (i + 1) * m, nd)]
    return out


def psi_slab_compact(full: np.ndarray, axis: int, topo_a: int,
                     m: Optional[int], key: str = "psi") -> np.ndarray:
    """Full-length psi -> the target layout (slab-compact, or full when
    ``m`` is None), refusing to drop a nonzero plane."""
    full = np.asarray(full)
    if m is None:
        return full
    n_global = full.shape[axis]
    ln = n_global // topo_a
    shape = list(full.shape)
    shape[axis] = 2 * m * topo_a
    out = np.zeros(shape, dtype=full.dtype)
    nd = full.ndim
    kept = np.zeros(n_global, dtype=bool)
    for i in range(topo_a):
        out[_along(axis, 2 * i * m, 2 * i * m + m, nd)] = \
            full[_along(axis, i * ln, i * ln + m, nd)]
        out[_along(axis, 2 * i * m + m, 2 * (i + 1) * m, nd)] = \
            full[_along(axis, (i + 1) * ln - m, (i + 1) * ln, nd)]
        kept[i * ln:i * ln + m] = True
        kept[(i + 1) * ln - m:(i + 1) * ln] = True
    dropped = np.where(~kept)[0]
    if dropped.size and np.any(np.take(full, dropped, axis=axis) != 0):
        raise ValueError(
            f"reshard would drop non-zero psi planes of {key} (axis "
            f"{_AXES[axis]}, planes outside the target slab layout m={m} "
            f"x {topo_a} shards hold non-zero recursion state): the "
            f"snapshot does not match its declared layout; refusing a "
            f"lossy reshard")
    return out


def reshard_psi_tree(state: Dict, grid_shape: Tuple[int, int, int],
                     src_topology: Tuple[int, int, int],
                     src_slabs: Dict[int, int],
                     dst_topology: Tuple[int, int, int],
                     dst_slabs: Dict[int, int]) -> Dict:
    """Every psi leaf of a state tree converted from ``src_topology``'s
    slab layout to ``dst_topology``'s (``*_slabs``: axis -> planes a
    side, ``solver.slab_axes`` of each); the other leaves pass through.
    Tensor psi leaves are brought to the host first."""
    from fdtd3d_torch import convert
    for label, topo in (("source", src_topology),
                        ("target", dst_topology)):
        for a in range(3):
            if topo[a] < 1 or grid_shape[a] % topo[a]:
                raise ValueError(
                    f"reshard: {label} topology {tuple(topo)} does not "
                    f"divide grid {tuple(grid_shape)} evenly on axis "
                    f"{_AXES[a]}")
    out = dict(state)
    for group in _PSI_GROUPS:
        if group not in state:
            continue
        newg = {}
        for key, arr in state[group].items():
            if not isinstance(arr, np.ndarray):
                arr = convert.to_host(arr)
            a = _AXES.index(key.rsplit("_", 1)[1])
            full = psi_slab_expand(arr, a, grid_shape[a], src_topology[a],
                                   src_slabs.get(a), key=f"{group}/{key}")
            newg[key] = psi_slab_compact(full, a, dst_topology[a],
                                         dst_slabs.get(a),
                                         key=f"{group}/{key}")
        out[group] = newg
    return out


# the cadence writer's naming scheme: ckpt_t000123.npz (npz backend) or
# the directory ckpt_t000123 (the reference's orbax backend)
_CKPT_NAME_RE = re.compile(r"^ckpt_t(\d+)(\.npz)?$")


def find_checkpoints(save_dir: str) -> List[Tuple[int, str]]:
    """Committed snapshots in ``save_dir`` -> [(t, path)], newest first.

    Committed means an ``.npz`` under its final name (the atomic writer
    never publishes a partial file). A directory of that name (the
    reference's orbax backend) is skipped with a warning: this port
    reads npz only (A11(b)). Integrity beyond commit is checked at load
    time; resume paths try candidates newest first and fall back past a
    :class:`CheckpointCorrupt` one."""
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(save_dir)
    except OSError:
        return []
    for name in names:
        m = _CKPT_NAME_RE.match(name)
        if not m:
            continue
        path = os.path.join(save_dir, name)
        if os.path.isdir(path):
            _log.warn(f"skipping {path}: an orbax checkpoint directory "
                      f"(only npz is ported to fdtd3d_torch yet, "
                      f"ROADMAP.md queue A11)")
            continue
        if not m.group(2):
            continue  # a file without .npz is not one of ours
        out.append((int(m.group(1)), path))
    out.sort(key=lambda kv: (-kv[0], kv[1]))
    return out


def find_latest_checkpoint(save_dir: str) -> Optional[str]:
    """Path of the newest committed snapshot in save_dir, or None."""
    found = find_checkpoints(save_dir)
    return found[0][1] if found else None


def prune_checkpoints(save_dir: str, keep: int,
                      t_max: Optional[int] = None) -> List[str]:
    """Keep the newest ``keep`` committed snapshots, delete the rest.
    Returns the pruned paths.

    ``t_max`` (the cadence writer passes the current step) restricts the
    rotation to snapshots at t <= t_max: leftovers of a previous longer
    run in the same save_dir sort newest and would otherwise crowd the
    live run's own snapshots out of the keep-K window."""
    pruned: List[str] = []
    if keep <= 0:
        return pruned
    found = find_checkpoints(save_dir)
    if t_max is not None:
        found = [(t, p) for t, p in found if t <= t_max]
    for _t, path in found[keep:]:
        try:
            os.remove(path)
            pruned.append(path)
        except OSError:
            pass  # a prune failure must never kill the run
    return pruned

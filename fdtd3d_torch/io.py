"""Field dumps and checkpoints of the PyTorch port, and the atomic writer.

Counterpart of the DAT and npz-checkpoint halves of ``fdtd3d_tpu/io.py``
(numpy path): a DAT file is the bare little-endian C-order values of one
component, with a ``.manifest.json`` sidecar recording shape, dtype and
step; both files are byte-identical to the reference's. Every file is
written through the atomic writer (tmp file + fsync + ``os.replace``;
the fault plan's ``fail_write`` fires just before the rename), so a
crash mid-write never leaves a torn file under the final name. The
TXT/BMP dumpers come with ROADMAP.md item A7.

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
    rule for non-native dtypes), the host step counter as an int32
    scalar (the reference's ``t``), a numpy leaf as it is."""
    import torch
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


# the cadence writer's naming scheme: ckpt_t000123.npz (npz backend) or
# the directory ckpt_t000123 (the reference's orbax backend)
_CKPT_NAME_RE = re.compile(r"^ckpt_t(\d+)(\.npz)?$")


def find_checkpoints(save_dir: str) -> List[Tuple[int, str]]:
    """Committed snapshots in ``save_dir`` -> [(t, path)], newest first.

    Committed means an ``.npz`` under its final name (the atomic writer
    never publishes a partial file). A directory of that name (the
    reference's orbax backend) is skipped with a warning: this port
    reads npz only (A11). Integrity beyond commit is checked at load
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

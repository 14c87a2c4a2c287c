"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/*.cu`` file is compiled by ``nvcc`` at first use into a
shared library with a plain C interface, under ``build/fdtd3d_torch/``
at the root of the checkout (``.gitignore`` lists ``build/``), and
loaded with ``ctypes``. The library's file name carries a hash of its
source, of the headers in ``csrc/`` (``*.cuh``, which sources include
by their bare name) and of its nvcc flags (``flags``: the common ``NVCC_FLAGS`` and the
library's own ``LIBRARY_FLAGS``), so an edited source or a changed flag
builds anew and a stale library is never loaded. Nothing here runs at
import time: the CPU tests import every module on machines with no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "fdtd3d_torch")

# Hopper only: the kernels are built for sm_90a and nothing else.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# Flags of one library on top of NVCC_FLAGS. packed_ds carries
# error-free transforms, which a contracted a*b+c breaks: no FMA
# contraction, and never fast math (it would flush the subnormal low
# words to zero). fused_eh computes redundant halo cells that must have
# their owner's bits whichever section kernel computes them: no FMA
# contraction either. family computes each cell once, and is built
# without contraction so that it reproduces its plain version's bits.
LIBRARY_FLAGS: Dict[str, Tuple[str, ...]] = {
    "packed_eh": (),
    "packed_ds": ("--fmad=false",),
    "packed_tb": (),
    "family": ("--fmad=false",),
    "fused_eh": ("--fmad=false",),
}


def flags(name: str) -> Tuple[str, ...]:
    """The full nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + LIBRARY_FLAGS.get(name, ())


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under the CUDA toolkit torch found."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of fdtd3d_torch are built from "
        "source at first use and need the CUDA toolkit (nvcc on PATH or "
        "CUDA_HOME set)")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, addressed by the hash of its
    source, of the headers in ``csrc/`` and of its flags: a library built
    from another header or with other flags is never loaded in place of
    this one."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, path), "rb") as f:
            h.update(path.encode() + b"\0" + f.read())
    h.update("\0".join(flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, verbose: bool):
    """Start nvcc on ``csrc/<name>.cu`` unless its library exists:
    (library path, temporary output, process or None)."""
    out = library_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd: List[str] = [find_nvcc(), *flags(name), "-I", CSRC]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return out, tmp, proc


def _finish(name: str, out: str, tmp: Optional[str],
            proc: Optional[subprocess.Popen]) -> Dict[str, object]:
    if proc is None:
        return {"path": out, "built": False, "log": ""}
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{stderr}")
    os.replace(tmp, out)
    return {"path": out, "built": True, "log": stderr + stdout}


def build_many(names, verbose: bool = False) -> Dict[str, Dict[str, object]]:
    """Compile several ``csrc/<name>.cu`` at once, one nvcc process per
    source, all started together; name -> ``build``'s result. Every
    process is waited for before the first failure is raised."""
    started = {n: _start(n, verbose) for n in names}
    results, errors = {}, []
    for n, st in started.items():
        try:
            results[n] = _finish(n, *st)
        except RuntimeError as exc:
            errors.append(exc)
    if errors:
        raise errors[0]
    return results


def build(name: str, verbose: bool = False) -> Dict[str, object]:
    """Compile ``csrc/<name>.cu`` unless its library exists.

    Returns {"path", "built", "log"}: ``log`` holds the compiler's
    output (with ``verbose``, ptxas's register and spill report)."""
    return build_many([name], verbose)[name]


_LIBS: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)["path"])
        _LIBS[name] = lib
    return lib

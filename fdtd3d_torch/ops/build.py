"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/*.cu`` file is compiled by ``nvcc`` at first use into a
shared library with a plain C interface, under ``build/fdtd3d_torch/``
at the root of the checkout (``.gitignore`` lists ``build/``), and
loaded with ``ctypes``. The library's file name carries a hash of its
source, so an edited source builds anew and a stale library is never
loaded. Nothing here runs at import time: the CPU tests import every
module on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "fdtd3d_torch")

# Hopper only: the kernels are built for sm_90a and nothing else.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


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
    """Where ``csrc/<name>.cu`` builds to (content-addressed)."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str, verbose: bool = False) -> Dict[str, object]:
    """Compile ``csrc/<name>.cu`` unless its library exists.

    Returns {"path", "built", "log"}: ``log`` holds the compiler's
    output (with ``verbose``, ptxas's register and spill report)."""
    out = library_path(name)
    if os.path.exists(out):
        return {"path": out, "built": False, "log": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd: List[str] = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": out, "built": True, "log": proc.stderr + proc.stdout}


_LIBS: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib: Optional[ctypes.CDLL] = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)["path"])
        _LIBS[name] = lib
    return lib

"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles ``respmon_tpu_torch/csrc/<name>.cu`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
named by a hash of the source and flags, under ``build/respmon_tpu_torch/``
at the root of the checkout.  The library is loaded with ``ctypes``.

Importing this module needs no CUDA toolkit: the build runs only when a
CUDA tensor first reaches a kernel (``load``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "respmon_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "respmon_tpu_torch need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib

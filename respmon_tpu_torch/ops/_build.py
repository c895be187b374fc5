"""Build and load the port's native libraries at first use.

``nvcc`` compiles ``respmon_tpu_torch/csrc/<name>.cu`` (the CUDA kernels)
and the host C++ compiler ``respmon_tpu_torch/csrc/<name>.cpp`` (the frame
ring of ``io/native``) into shared libraries with a plain C interface (no
PyTorch headers, so a build takes seconds), each named by a hash of its
source and flags, under ``build/respmon_tpu_torch/`` at the root of the
checkout.  A library is loaded with ``ctypes``.

Importing this module needs no toolchain: a CUDA build runs only when a
CUDA tensor first reaches a kernel (``load``), the host build when the
frame ring is first made (``load("resp_native", ".cpp")``).

A CUDA library's wrapper declares its C functions once, in a ``Kernels``
table, and launches through it: the table binds the functions at the first
launch, passes the current stream, turns a failed launch into
``RuntimeError`` and counts each launch in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "respmon_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
# No -march=native: a library is named by source and flags only, so it must
# run on any x86-64 host that finds it.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra")
FLAGS = {".cu": NVCC_FLAGS, ".cpp": CXX_FLAGS}

_LOADED: dict = {}

# Launches of each counted kernel since ``reset_launches``, by the name its
# wrapper counts it under; a wrapper's names are present from its import.
LAUNCHES: Dict[str, int] = {}

_ARGTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "d": ctypes.c_double}


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


def find_cxx() -> str:
    """Path of the host C++ compiler: $CXX, then ``c++`` (the one ``nvcc``
    calls), then ``g++``."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found (c++, g++): the frame ring of "
                       "respmon_tpu_torch needs one")


def library_path(name: str, source: str = ".cu") -> Path:
    src = (CSRC / f"{name}{source}").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS[source]).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str, source: str = ".cu") -> Path:
    """Compile ``csrc/<name><source>`` (``.cu`` with nvcc, ``.cpp`` with the
    host C++ compiler) unless a library of the same hash exists."""
    out = library_path(name, source)
    if out.is_file():
        return out
    compiler = find_nvcc() if source == ".cu" else find_cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, *FLAGS[source], "-o", str(tmp),
           str(CSRC / f"{name}{source}")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, source: str = ".cu") -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name><source>``, once per
    process."""
    lib = _LOADED.get((name, source))
    if lib is None:
        lib = ctypes.CDLL(str(build(name, source)))
        _LOADED[(name, source)] = lib
    return lib


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Kernels:
    """The C functions of ``csrc/<name>.cu`` and the names their launches
    are counted under (``counted``).  ``signatures`` maps each function to
    its arguments before the stream, a letter each: ``p`` a pointer (a
    ``data_ptr()`` or None), ``i`` an int, ``d`` a double.  Every function
    takes a ``cudaStream_t`` last and returns a ``cudaError_t``."""

    def __init__(self, name: str, signatures: Dict[str, str],
                 counted: Iterable[str]):
        self.name = name
        self.signatures = signatures
        self.counted = tuple(counted)
        for k in self.counted:
            LAUNCHES.setdefault(k, 0)
        self._lib = None

    def bind(self) -> ctypes.CDLL:
        """The library, built, loaded and its functions typed at the first
        call."""
        if self._lib is None:
            lib = load(self.name)
            for symbol, args in self.signatures.items():
                fn = getattr(lib, symbol)
                fn.argtypes = [_ARGTYPES[a] for a in args] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, symbol: str, device: torch.device, *args,
               count: str) -> None:
        """``symbol(*args)`` on ``device``'s current stream, no synchronise;
        a non-zero ``cudaError_t`` raises ``RuntimeError``, else the launch
        counts under ``count``."""
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(self.bind(), symbol)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{symbol} launch failed: cudaError_t {err}")
        LAUNCHES[count] += 1

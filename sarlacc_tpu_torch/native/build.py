"""Build-at-first-use for the port's native code, cached by content hash.

Two kinds of shared object land in ``sarlacc_tpu_torch/_build/``:

* the host library, compiled by ``g++`` from the JAX package's own
  ``sarlacc_tpu/native/msa_host.cpp`` (read by path, never copied);
* one library per hand-written CUDA kernel in ``sarlacc_tpu_torch/csrc/``,
  compiled by ``nvcc`` for ``sm_90a`` with a plain C interface and called
  through ctypes (no PyTorch headers, so a build takes seconds).

The cache key is a hash of the sources and the full command line, so a
changed flag rebuilds.  Builds write to a per-process temporary name and
rename into place, so concurrent test workers never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = [
    "BUILD_DIR", "CSRC_DIR", "build_library", "check_tensor", "CudaKernel", "nvcc_path",
]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

#: nvcc flags for every kernel.  ``--fmad=false`` is load-bearing: both DPs
#: depend on an exact association (``(mv - go) + k*ge``; ``cum - (k-1)*ge``)
#: and a contracted FMA changes the last bit, which flips direction ties.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()


def build_library(name: str, sources: list[str], command: list[str]) -> str:
    """Compile ``sources`` with ``command + [-o, out]`` unless cached."""
    h = hashlib.sha256(" ".join(command).encode())
    for src in sources:
        with open(src, "rb") as fh:
            h.update(fh.read())
    so = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(
        command + ["-o", tmp], capture_output=True, text=True, timeout=600
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({' '.join(command)}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so)
    return so


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def check_tensor(t, name: str, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and ``shape``."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_cuda:
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)} on CUDA, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class CudaKernel:
    """One hand-written CUDA kernel behind a plain C entry point.

    The library is built on the first :meth:`launch`, never at import, so
    the CPU-only test environment imports every module cleanly.  The entry
    point returns ``cudaGetLastError()`` after its launch; non-zero raises.
    ``launches`` counts successful launches and nothing else.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = os.path.join(CSRC_DIR, source)
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def build(self) -> str:
        name = os.path.splitext(os.path.basename(self.source))[0]
        return build_library(
            name, [self.source], [nvcc_path(), *NVCC_FLAGS, self.source]
        )

    def _entry(self):
        if self._fn is None:
            with _LOCK:
                if self._fn is None:
                    lib = ctypes.CDLL(self.build())
                    fn = getattr(lib, self.symbol)
                    fn.restype = ctypes.c_int
                    fn.argtypes = self.argtypes
                    self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._entry()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1

"""Build-at-first-use for the port's native code, cached by content hash.

Two kinds of shared object land in ``sarlacc_tpu_torch/_build/``:

* the host library, compiled by ``g++`` from the port's own copy of the
  host C++, ``sarlacc_tpu_torch/native/msa_host.cpp``;
* one library per hand-written CUDA kernel in ``sarlacc_tpu_torch/csrc/``,
  compiled by ``nvcc`` for ``sm_90a`` with a plain C interface and called
  through ctypes (no PyTorch headers, so a build takes seconds).

The cache key is a hash of the sources (a kernel's source and every file
it includes by a quoted path) and the full command line, so a changed
flag or header rebuilds.  Builds write to a per-thread temporary name and
rename into place, so concurrent builds never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

__all__ = [
    "BUILD_DIR", "CSRC_DIR", "build_library", "check_tensor", "CudaKernel", "kernel_resources",
    "local_sources", "nvcc_path",
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
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


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
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(
        command + ["-o", tmp], capture_output=True, text=True, timeout=600
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({' '.join(command)}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so)
    return so


def local_sources(source: str) -> list[str]:
    """``source`` and every file it includes by a quoted path, transitively
    (paths relative to the including file, as nvcc resolves them)."""
    found, todo = [], [source]
    while todo:
        path = os.path.normpath(todo.pop())
        if path in found:
            continue
        found.append(path)
        with open(path) as fh:
            todo += [os.path.join(os.path.dirname(path), inc) for inc in _INCLUDE.findall(fh.read())]
    return found


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
    ``launches`` counts successful launches and nothing else.  ``defines``
    (``NAME=VALUE`` strings, passed as ``-D``) give another build of the
    same source, cached apart: a measurement tool's variant.
    """

    def __init__(self, source: str, symbol: str, argtypes: list, defines=()):
        self.source = os.path.join(CSRC_DIR, source)
        self.symbol = symbol
        self.argtypes = argtypes
        self.defines = tuple(defines)
        self.launches = 0
        self._fn = None

    def command(self, nvcc: str) -> list[str]:
        return [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in self.defines), self.source]

    def build(self) -> str:
        name = os.path.splitext(os.path.basename(self.source))[0]
        return build_library(name, local_sources(self.source), self.command(nvcc_path()))

    def function(self, symbol: str, argtypes: list):
        """Another ``int``-returning C function of the same library (not a
        launch: nothing is counted)."""
        fn = getattr(ctypes.CDLL(self.build()), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        return fn

    def _entry(self):
        if self._fn is None:
            with _LOCK:
                if self._fn is None:
                    self._fn = self.function(self.symbol, self.argtypes)
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point with ``args``, whose last is the
        ``torch.cuda.Stream`` to launch on: the runtime launches on the
        current device, so the stream's device is made current for the
        call (shards on several cards each launch on their own)."""
        import torch

        *head, stream = args
        with torch.cuda.device(stream.device):
            rc = self._entry()(*head, stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1


def kernel_resources(fn, *args) -> dict:
    """One kernel's compiled resources from an attributes entry point ``fn``
    (``fn(*args, int out[5])``: registers a thread, static shared bytes a
    block, spill bytes a thread, resident blocks an SM, threads a block),
    with the theoretical occupancy (resident warps over the SM's 64)."""
    buf = (ctypes.c_int * 5)()
    rc = fn(*args, ctypes.cast(buf, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"kernel attributes {args} failed: CUDA error {rc}")
    regs, smem, spill, blocks, threads = list(buf)
    return {
        "registers": regs, "shared_bytes": smem, "spill_bytes": spill,
        "blocks_per_sm": blocks, "threads": threads,
        "occupancy": blocks * threads / 32 / 64,
    }

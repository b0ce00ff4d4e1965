"""The port stands alone: nothing of JAX or of the JAX package.

Every ``.py`` file of ``sarlacc_tpu_torch/`` and ``chip_smoke.py`` is parsed
and none may import ``jax``, ``jaxlib`` or ``sarlacc_tpu``, or name the JAX
package's directory as a path component; the host library's source and
every CUDA kernel's source lie inside the port; and in a fresh interpreter
where those three packages cannot be imported, every module of the port
imports and the host library builds from the port's own copy.
"""

import ast
import importlib
import os
import pathlib
import pkgutil
import subprocess
import sys

import pytest

import sarlacc_tpu_torch
from sarlacc_tpu_torch import native
from sarlacc_tpu_torch.native.build import CudaKernel

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "sarlacc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sarlacc_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    # A path into the JAX package would be built from its directory name.
    parts = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and n.value == "sarlacc_tpu"]
    assert not parts, f"{path.relative_to(ROOT)} names the JAX package's directory"


def _port_kernels():
    """Every CudaKernel the port's modules define (alone or in a dict)."""
    found = {}
    for info in pkgutil.walk_packages(sarlacc_tpu_torch.__path__, "sarlacc_tpu_torch."):
        mod = importlib.import_module(info.name)
        for value in vars(mod).values():
            for k in value.values() if isinstance(value, dict) else (value,):
                if isinstance(k, CudaKernel):
                    found[k.symbol] = k
    return found


def test_native_and_kernel_sources_lie_in_the_port():
    port = os.path.realpath(PORT)
    host = os.path.realpath(native.HOST_SOURCE)
    assert host == os.path.join(port, "native", "msa_host.cpp")
    assert os.path.isfile(host)
    kernels = _port_kernels()
    assert {"sarlacc_dir_kernel", "sarlacc_pair_kernel", "sarlacc_score_kernel",
            "sarlacc_segments_kernel", "sarlacc_merge_kernel", "sarlacc_walk_kernel"} <= set(kernels)
    for symbol, k in kernels.items():
        src = os.path.realpath(k.source)
        assert src.startswith(port + os.sep) and os.path.isfile(src), (symbol, src)


BLOCKED_RUN = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import sarlacc_tpu_torch
for info in pkgutil.walk_packages(sarlacc_tpu_torch.__path__, "sarlacc_tpu_torch."):
    importlib.import_module(info.name)
from sarlacc_tpu_torch.native import HOST_SOURCE, get_lib, greedy_cluster_native
get_lib()
print("ok", HOST_SOURCE)
"""


def test_port_imports_and_builds_without_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok ") and "sarlacc_tpu_torch" in out.stdout


#: The parallel layer and the oracles the port copied: each must be among
#: the parsed sources and import under the blocked interpreter.
PARALLEL_AND_ORACLES = (
    "sarlacc_tpu_torch.parallel",
    "sarlacc_tpu_torch.parallel.context",
    "sarlacc_tpu_torch.parallel.distributed",
    "sarlacc_tpu_torch.parallel.mesh",
    "sarlacc_tpu_torch.parallel.shuffle",
    "sarlacc_tpu_torch.refimpl.consensus",
    "sarlacc_tpu_torch.refimpl.levenshtein",
)

QUIET_IMPORT = """
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import torch
for name in {modules!r}:
    importlib.import_module(name)
import torch.distributed as dist
assert not (dist.is_available() and dist.is_initialized()), "a process group was initialised"
assert not torch.cuda.is_initialized(), "CUDA was initialised"
print("ok")
"""


def test_parallel_and_oracles_are_checked_and_import_quietly():
    """parallel/ and the copied oracles are among the parsed sources;
    importing them without the JAX package initialises no process group
    and touches no card."""
    parsed = {str(p.relative_to(ROOT)) for p in SOURCES}
    for name in PARALLEL_AND_ORACLES:
        rel = name.replace(".", "/")
        assert f"{rel}.py" in parsed or f"{rel}/__init__.py" in parsed, name
    out = subprocess.run(
        [sys.executable, "-c", QUIET_IMPORT.format(forbidden=set(FORBIDDEN),
                                                    modules=PARALLEL_AND_ORACLES)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"

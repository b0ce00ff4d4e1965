"""Kernel I: doubled Levenshtein distances, one thread a pair, on the card.

:func:`lev2_cross` and :func:`lev2_paired` launch ``csrc/lev2_kernel.cu``,
replacing ``sarlacc_tpu/ops/levenshtein.py::_lev2_tile_kernel`` and the
tile DP of ``::_lev2_rowblock_sparse``.  Both take CUDA tensors only and
raise on anything else; their plain PyTorch version is
``ops/levenshtein.py::_lev2_scan``, which ``ops/levenshtein.py``'s
``_lev2_block`` and ``_lev2_pairs`` run on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..native.build import CudaKernel, check_tensor, kernel_resources

__all__ = ["LEV2_KERNEL", "LEV2_ROUTES", "lev2_cross", "lev2_kernel_resources", "lev2_paired",
           "lev2_route"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: ``csrc/lev2_kernel.cu``: replaces ``sarlacc_tpu/ops/levenshtein.py::_lev2_tile_kernel``.
LEV2_KERNEL = CudaKernel(
    "lev2_kernel.cu",
    "sarlacc_lev2_kernel",
    [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _I, _P, _P],
)

#: Kernel I's routes, in the kernel's numbering: the column in registers
#: for L <= 32, else in a device scratch.
LEV2_ROUTES = ("reg32", "scratch")

#: Pairs in flight on the scratch route: its column scratch, (L + 1) int32
#: a pair, stays within this many bytes.
SCRATCH_BYTES = 1 << 28


def lev2_route(L: int) -> str:
    """Kernel I's route for code rows of ``L`` positions."""
    return "reg32" if L <= 32 else "scratch"


def _launch(a, la, b, lb, ia, ib, TJ: int, P: int, out):
    L = int(a.shape[1])
    route = lev2_route(L)
    scratch, blocks = None, 0
    if route == "scratch":
        blocks = max(1, min(-(-P // 128), SCRATCH_BYTES // (4 * (L + 1) * 128)))
        scratch = torch.empty((L + 1) * blocks * 128, dtype=torch.int32, device=a.device)
    if P:
        LEV2_KERNEL.launch(
            a.data_ptr(), la.data_ptr(), b.data_ptr(), lb.data_ptr(),
            None if ia is None else ia.data_ptr(), None if ib is None else ib.data_ptr(),
            TJ, P, L, LEV2_ROUTES.index(route),
            None if scratch is None else scratch.data_ptr(), blocks, out.data_ptr(),
            torch.cuda.current_stream(a.device),
        )
    return out


def _table(codes, lengths, name):
    n, L = codes.shape
    codes = codes.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    check_tensor(codes, f"{name} codes", torch.int32, (n, L))
    check_tensor(lengths, f"{name} lengths", torch.int32, (n,))
    return codes, lengths


def lev2_cross(a, la, b, lb):
    """Doubled distances of every row of ``a`` [TI, L] against every row of
    ``b`` [TJ, L] (integer codes, pad 5; lengths [TI] and [TJ]): int32 [TI,
    TJ], bit-equal to ``ops/levenshtein.py::_lev2_scan`` on the broadcast
    rows."""
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"kernel I: code widths {a.shape[1]} and {b.shape[1]} differ")
    a, la = _table(a, la, "a")
    b, lb = _table(b, lb, "b")
    TI, TJ = a.shape[0], b.shape[0]
    out = torch.empty((TI, TJ), dtype=torch.int32, device=a.device)
    return _launch(a, la, b, lb, None, None, max(TJ, 1), TI * TJ, out)


def lev2_paired(codes, lengths, ia, ib):
    """Doubled distances of the pairs (``ia[p]``, ``ib[p]``) of one code
    table ``codes`` [n, L] with ``lengths`` [n]: int32 [P], bit-equal to
    ``_lev2_scan(codes[ia], lengths[ia], codes[ib], lengths[ib])``."""
    codes, lengths = _table(codes, lengths, "table")
    ia = ia.to(torch.int64).contiguous()
    ib = ib.to(torch.int64).contiguous()
    P = ia.shape[0]
    check_tensor(ia, "ia", torch.int64, (P,))
    check_tensor(ib, "ib", torch.int64, (P,))
    out = torch.empty(P, dtype=torch.int32, device=codes.device)
    return _launch(codes, lengths, codes, lengths, ia, ib, 1, P, out)


def lev2_kernel_resources() -> dict:
    """Kernel I's routes as compiled (keys ``"I:reg32"`` and ``"I:scratch"``;
    values as ``ops/cuda_align.py::score_kernel_resources``'s)."""
    fn = LEV2_KERNEL.function("sarlacc_lev2_attrs", [_I, _P])
    return {f"I:{name}": kernel_resources(fn, i) for i, name in enumerate(LEV2_ROUTES)}

"""Kernel H: the device library's consistency extension, on the card.

:func:`extend_chunk` launches ``csrc/extend_kernel.cu`` on one chunk of
output pairs, replacing ``sarlacc_tpu/ops/msa.py::_extend_chunk_kernel``:
a counting pass with a device scan of each pair's kept count, one readback
of the total (the output's size), then a writing pass.  It takes CUDA
tensors only and raises on anything else; its plain PyTorch version is
``ops/msa.py::_extend_chunk_plain``, which ``ops/msa.py::_extend_chunk_kernel``
runs on CPU tensors.  This module does not import ``ops/msa.py`` (which
imports it).
"""

from __future__ import annotations

import ctypes

import torch

from ..native.build import CudaKernel, check_tensor, kernel_resources

__all__ = ["EXTEND_KERNEL", "MAX_SLOTS", "extend_chunk", "extend_kernel_resources"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: ``csrc/extend_kernel.cu``: replaces ``sarlacc_tpu/ops/msa.py::_extend_chunk_kernel``.
#: One entry point for both passes (its first argument), so a chunk counts
#: two launches.
EXTEND_KERNEL = CudaKernel(
    "extend_kernel.cu",
    "sarlacc_extend_kernel",
    [_I, _P, _L, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
)

#: Slots a pair a warp holds: one lane a slot.
MAX_SLOTS = 32


def extend_chunk(arena, xz_rows, zy_rows, w_slots, pair_ids, counts, w_scale, strc: int):
    """Kernel H on one chunk, with ``ops/msa.py::_extend_chunk_plain``'s
    arguments: ``arena`` int16 [rows, STR]; ``xz_rows``, ``zy_rows``
    (integer) and ``w_slots`` float32 [CP, SL], SL <= :data:`MAX_SLOTS`;
    ``pair_ids`` [CP] into ``counts`` int64, which gains each pair's kept
    count; ``w_scale`` a float32 scalar tensor.  Returns int32 [n, 3] rows
    (a, b, round(wsum * w_scale)), pair by pair, then by a and b, bit-equal
    to the plain version."""
    CP, SL = xz_rows.shape
    rows, STR = arena.shape
    strc = int(strc)
    if not 1 <= SL <= MAX_SLOTS or not 0 <= strc <= STR:
        raise ValueError(f"kernel H takes 1-{MAX_SLOTS} slots and strc <= {STR}: SL {SL}, "
                         f"strc {strc}")
    if CP * strc * SL >= 2**31:
        raise ValueError(f"kernel H: a chunk of {CP} x {strc} x {SL} slots exceeds 2^31")
    check_tensor(arena, "arena", torch.int16, (rows, STR))
    dev = arena.device
    xz = xz_rows.to(torch.int64).contiguous()
    zy = zy_rows.to(torch.int64).contiguous()
    pid = pair_ids.to(torch.int64).contiguous()
    scale = w_scale.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    check_tensor(xz, "xz_rows", torch.int64, (CP, SL))
    check_tensor(zy, "zy_rows", torch.int64, (CP, SL))
    check_tensor(w_slots, "w_slots", torch.float32, (CP, SL))
    check_tensor(pid, "pair_ids", torch.int64, (CP,))
    check_tensor(counts, "counts", torch.int64, (counts.shape[0],))
    cnt = torch.empty(CP * strc, dtype=torch.int32, device=dev)
    pair_tot = torch.empty(CP, dtype=torch.int32, device=dev)
    off = torch.empty(CP + 1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev)
    args = (arena.data_ptr(), STR, xz.data_ptr(), zy.data_ptr(), w_slots.data_ptr(), CP, SL,
            strc, pid.data_ptr(), counts.data_ptr(), scale.data_ptr(), cnt.data_ptr(),
            pair_tot.data_ptr(), off.data_ptr())
    EXTEND_KERNEL.launch(0, *args, None, stream)
    total = int(off[CP])  # the one readback: the output's size
    out = torch.empty((total, 3), dtype=torch.int32, device=dev)
    if total:
        EXTEND_KERNEL.launch(1, *args, out.data_ptr(), stream)
    return out


def extend_kernel_resources() -> dict:
    """Kernel H's passes as compiled (keys ``"H:count"``, ``"H:write"``,
    ``"H:scan"``; values as ``ops/cuda_align.py::score_kernel_resources``'s)."""
    fn = EXTEND_KERNEL.function("sarlacc_extend_attrs", [_I, _P])
    return {f"H:{name}": kernel_resources(fn, i)
            for i, name in enumerate(("count", "write", "scan"))}

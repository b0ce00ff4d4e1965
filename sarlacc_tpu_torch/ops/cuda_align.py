"""Kernel A: the direction-emitting fitting DP on the card.

Counterpart of ``sarlacc_tpu/ops/pallas_align.py`` for the adaptor path.
:func:`build_cost_planes` lays the reads out position-major with reads on
the last axis ([l1, n_pad]) and precomputes the per-position match/mismatch
costs for all four degeneracy modes.  :func:`fit_dirs` then runs the DP:
on a CUDA tensor it launches the hand-written kernel in
``csrc/dir_kernel.cu``; on a CPU tensor it runs the plain
:func:`..ops.align.dp_align`.  Both produce scores and int16 run-length
direction planes [R, l1, n_pad] that :func:`..ops.backtrack.qmap_walk`
consumes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..native.build import CudaKernel, check_tensor
from .align import dp_align

__all__ = [
    "DIR_KERNEL",
    "build_cost_planes",
    "dir_kernel",
    "encode_mask",
    "fit_dirs",
    "plane_dims",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: ``csrc/dir_kernel.cu``: replaces ``sarlacc_tpu/ops/pallas_align.py::_dir_kernel``.
DIR_KERNEL = CudaKernel(
    "dir_kernel.cu",
    "sarlacc_dir_kernel",
    [_P, _P, _I, _F, _F, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
)


def plane_dims(N: int, L: int) -> tuple[int, int]:
    """(l1, n_pad): the direction planes' DP height (L+1 rounded up to 32,
    as the Pallas kernel's) and batch width (N rounded up to 512)."""
    l1 = ((L + 1 + 31) // 32) * 32
    n_pad = ((N + 511) // 512) * 512
    return l1, n_pad


def encode_mask(matched: torch.Tensor) -> torch.Tensor:
    """matched [R, 5] bool -> [R] int32 bitmask (bit b = base b matches)."""
    bits = torch.arange(5, dtype=torch.int32, device=matched.device)
    return (matched.to(torch.int32) << bits).sum(dim=1, dtype=torch.int32)


def build_cost_planes(codes, qidx, match_tab, mismatch_tab, l1: int, n_pad: int):
    """[4, l1, n_pad] match/mismatch cost planes + kernel-layout codes.

    Row i holds read position i-1; row 0 carries code 0 and quality index
    0, rows past the read carry code 5 (never matches).  Everything stays on
    the device of ``codes``.
    """
    N, L = codes.shape
    dev = codes.device
    qidx_k = torch.zeros((l1, n_pad), dtype=torch.int64, device=dev)
    qidx_k[1 : L + 1, :N] = qidx.to(torch.int64).T
    codes_k = torch.full((l1, n_pad), 5, dtype=torch.int32, device=dev)
    codes_k[0] = 0
    codes_k[1 : L + 1, :N] = codes.to(torch.int32).T
    costm = match_tab.to(torch.float32)[:, qidx_k]
    costmm = mismatch_tab.to(torch.float32)[:, qidx_k]
    return costm, costmm, codes_k


def dir_kernel(modes, mask, gap_open, gap_ext, costm, costmm, codes_k, local=True):
    """Launch kernel A; same contract as :func:`..ops.align.dp_align`.

    Returns (S f32 [l1, n_pad], dirs int16 [R, l1, n_pad]) on the card.
    """
    dev = codes_k.device
    l1, n_pad = codes_k.shape
    R = int(modes.shape[0])
    check_tensor(modes, "modes", torch.int32, (R,))
    check_tensor(mask, "mask", torch.int32, (R,))
    check_tensor(costm, "costm", torch.float32, (4, l1, n_pad))
    check_tensor(costmm, "costmm", torch.float32, (4, l1, n_pad))
    check_tensor(codes_k, "codes_k", torch.int32, (l1, n_pad))
    S = torch.empty((l1, n_pad), dtype=torch.float32, device=dev)
    H = torch.empty_like(S)
    was_left = torch.empty((l1, n_pad), dtype=torch.uint8, device=dev)
    ljp = torch.empty((l1, n_pad), dtype=torch.int32, device=dev)
    dirs = torch.empty((R, l1, n_pad), dtype=torch.int16, device=dev)
    go = float(np.float32(gap_open) + np.float32(gap_ext))
    DIR_KERNEL.launch(
        modes.data_ptr(), mask.data_ptr(), R, go, float(np.float32(gap_ext)),
        int(bool(local)), costm.data_ptr(), costmm.data_ptr(),
        codes_k.data_ptr(), l1, n_pad, S.data_ptr(), H.data_ptr(),
        was_left.data_ptr(), ljp.data_ptr(), dirs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return S, dirs


def fit_dirs(
    codes,  # [N, L] int8 tensor
    qidx,  # [N, L] int8 tensor
    lengths,  # [N] int32 tensor
    modes,  # [R] int32 tensor
    matched,  # [R, 5] bool tensor
    match_tab,  # [4, Q] f32 tensor
    mismatch_tab,
    gap_opening: float,
    gap_extension: float,
    local: bool = True,
):
    """Scores + run-length direction planes for every read.

    Returns (scores f32 [N], dirs int16 [R, l1, n_pad], l1), on the device
    of ``codes``: kernel A on CUDA, the plain :func:`dp_align` on the CPU.
    """
    N, L = codes.shape
    l1, n_pad = plane_dims(N, L)
    costm, costmm, codes_k = build_cost_planes(
        codes, qidx, match_tab, mismatch_tab, l1, n_pad
    )
    modes = modes.to(torch.int32).contiguous()
    mask = encode_mask(matched)
    run = dir_kernel if codes.is_cuda else dp_align
    S, dirs = run(
        modes, mask, gap_opening, gap_extension, costm, costmm, codes_k, local
    )
    scores = S[:, :N].gather(0, lengths.to(torch.int64)[None, :])[0]
    return scores, dirs, l1

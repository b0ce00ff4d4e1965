"""Kernel B: the banded pairwise Gotoh DP of the MSA library, on the card.

Counterpart of ``sarlacc_tpu/ops/pallas_msa.py``.  :func:`banded_pair`
aligns P read pairs in band coordinates ``j = i + lo + k`` (``0 <= k <=
kmax``): on a CUDA tensor it launches the hand-written kernel in
``csrc/pair_kernel.cu``; on a CPU tensor it runs :func:`banded_pair_plain`,
the PyTorch twin of ``sarlacc_tpu/ops/msa.py::_banded_pair_kernel``.  Both
emit the score at ``k = lb - la - lo`` and int8 direction bits in the
[rows, P, W] layout that :func:`..ops.msa._pair_walk` reads: bits 0-1 the
choice (0 diagonal, 1 horizontal, 2 vertical; ties resolve in that order),
bit 2 a horizontal extend, bit 3 a vertical extend (a tie extends).

Sequence A contributes code 5 past its stored width; B cells outside
``[1, lb]`` score ``NEG``, so pads never match.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..native.build import CudaKernel, check_tensor

__all__ = ["NEG", "PAIR_KERNEL", "banded_pair", "banded_pair_plain", "pair_kernel"]

NEG = -1.0e9  # integer-ish scores stay far from this

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: ``csrc/pair_kernel.cu``: replaces ``sarlacc_tpu/ops/pallas_msa.py::_kernel``.
PAIR_KERNEL = CudaKernel(
    "pair_kernel.cu",
    "sarlacc_pair_kernel",
    [_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _P, _P],
)

#: Widest band the kernel takes: 256 threads of at most 16 band cells each.
MAX_WIDTH = 4096


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """Column k takes column k+1; the last column becomes NEG."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], NEG)], dim=1)


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """Column k takes column k-1; column 0 becomes NEG."""
    return torch.cat([torch.full_like(x[:, :1], NEG), x[:, :-1]], dim=1)


def banded_pair_plain(
    codes_a, codes_b, lens_a, lens_b, lo, kmax,
    match, mismatch, gap_open, gap_ext, rows: int, width: int,
):
    """Plain PyTorch banded Gotoh over [P, W] band planes, one row per step.

    ``codes_a`` int8 [P, LA], ``codes_b`` int8 [P, LB] (LB >= max lb);
    ``lens_*``, ``lo``, ``kmax`` int32 [P].  Runs on the device of its inputs.
    Returns (scores f32 [P], dirs int8 [rows, P, W]).
    """
    dev = codes_a.device
    f32 = torch.float32
    P, LA = codes_a.shape
    W = width
    mt, mm, go, ge = (
        torch.tensor(np.float32(v), dtype=f32, device=dev)
        for v in (match, mismatch, gap_open, gap_ext)
    )
    karr = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    kf = karr.to(f32)
    lo_c = lo[:, None]
    lb_c = lens_b[:, None]
    in_band = karr <= kmax[:, None]

    # Row 0: S[0][j] = 0 if j == 0 else -(go + (j-1)*ge) for 1 <= j <= lb.
    j0 = lo_c + karr
    s0 = torch.where(
        j0 == 0,
        torch.zeros((), dtype=f32, device=dev),
        torch.where(
            (j0 >= 1) & (j0 <= lb_c) & in_band,
            -(go + (j0.to(f32) - 1.0) * ge),
            torch.tensor(NEG, dtype=f32, device=dev),
        ),
    )
    S = s0
    V = torch.full((P, W), NEG, dtype=f32, device=dev)

    ca = torch.full((P, rows), 5, dtype=torch.int32, device=dev)
    take = min(rows, LA)
    ca[:, :take] = codes_a[:, :take].to(torch.int32)
    cb = codes_b.to(torch.int32)
    LB = cb.shape[1]
    kstep = kf * ge
    kclose = (kf - 1.0) * ge
    dirs = torch.empty((rows, P, W), dtype=torch.int8, device=dev)

    for i in range(1, rows + 1):
        j = i + lo_c + karr
        valid = (j >= 0) & (j <= lb_c) & in_band
        alive = (i <= lens_a)[:, None]
        in_b = (j >= 1) & (j <= lb_c)

        b_j = cb.gather(1, (j - 1).clamp(0, max(LB - 1, 0)).to(torch.int64))
        sub = torch.where(in_b, torch.where(ca[:, i - 1 : i] == b_j, mt, mm), NEG)

        M = S + sub  # diagonal: (i-1, j-1) is the same k one row up
        S_up = _shift_up(S)  # vertical: (i-1, j) is k+1 one row up
        V_up = _shift_up(V)
        Vn = torch.maximum(S_up - go, V_up - ge)
        v_ext = (V_up - ge) >= (S_up - go)  # tie -> extend

        # Horizontal: within-row prefix max, exact association.
        mv = torch.maximum(M, Vn)
        cum = torch.cummax((mv - go) + kstep, dim=1).values
        Hn = _shift_right(cum) - kclose
        Hn = torch.where((karr == 0) | ~valid, NEG, Hn)

        M = torch.where(valid, M, NEG)
        Vn = torch.where(valid, Vn, NEG)
        Sn = torch.maximum(M, torch.maximum(Hn, Vn))

        choice = torch.where(M >= Sn, 0, torch.where(Hn >= Sn, 1, 2))
        h_ext = (_shift_right(Hn) - ge) >= (_shift_right(mv) - go)
        dirs[i - 1] = (choice + (h_ext.to(torch.int64) << 2) + (v_ext.to(torch.int64) << 3)).to(torch.int8)

        S = torch.where(alive, Sn, S)
        V = torch.where(alive, Vn, V)

    kfin = (lens_b - lens_a - lo).to(torch.int64)
    at = karr.to(torch.int64) == kfin[:, None]
    scores = torch.where(at, S, NEG).amax(dim=1)
    return scores, dirs


def pair_kernel(
    codes_a, codes_b, lens_a, lens_b, lo, kmax,
    match, mismatch, gap_open, gap_ext, rows: int, width: int,
):
    """Launch kernel B; same contract as :func:`banded_pair_plain`."""
    P, LA = codes_a.shape
    LB = codes_b.shape[1]
    if not 32 <= width <= MAX_WIDTH or width & (width - 1):
        raise ValueError(
            f"band width {width}: kernel B takes a power of two from 32 to {MAX_WIDTH}"
        )
    check_tensor(codes_a, "codes_a", torch.int8, (P, LA))
    check_tensor(codes_b, "codes_b", torch.int8, (P, LB))
    for name, t in (("lens_a", lens_a), ("lens_b", lens_b), ("lo", lo), ("kmax", kmax)):
        check_tensor(t, name, torch.int32, (P,))
    dev = codes_a.device
    dirs = torch.empty((rows, P, width), dtype=torch.int8, device=dev)
    scores = torch.empty(P, dtype=torch.float32, device=dev)
    PAIR_KERNEL.launch(
        codes_a.data_ptr(), LA, codes_b.data_ptr(), LB,
        lens_a.data_ptr(), lens_b.data_ptr(), lo.data_ptr(), kmax.data_ptr(),
        P, rows, width,
        float(np.float32(match)), float(np.float32(mismatch)),
        float(np.float32(gap_open)), float(np.float32(gap_ext)),
        dirs.data_ptr(), scores.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return scores, dirs


def banded_pair(
    codes_a, codes_b, lens_a, lens_b, lo, kmax,
    match, mismatch, gap_open, gap_ext, rows: int, width: int,
):
    """Kernel B on CUDA tensors, the plain version on CPU tensors."""
    run = pair_kernel if codes_a.is_cuda else banded_pair_plain
    return run(
        codes_a, codes_b, lens_a, lens_b, lo, kmax,
        match, mismatch, gap_open, gap_ext, rows, width,
    )

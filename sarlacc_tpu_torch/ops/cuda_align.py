"""Kernels A, C and D: the fitting DPs on the card, and their wrappers.

Counterpart of ``sarlacc_tpu/ops/pallas_align.py``.
:func:`build_cost_planes` lays the reads out position-major with reads on
the last axis ([l1, n_pad]) and precomputes the per-position match/mismatch
costs for all four degeneracy modes; one plane build serves every kernel.

* :func:`fit_dirs` runs the direction-emitting DP (kernel A,
  ``csrc/dir_kernel.cu``; plain :func:`..ops.align.dp_align`) and returns
  int16 run-length direction planes [R, l1, n_pad] that
  :func:`..ops.backtrack.qmap_walk` and :func:`..ops.backtrack.string_walk`
  consume.
* :func:`fit_scores_from_planes` scores a batch against one reference
  (kernel C, ``csrc/score_kernel.cu``; plain :func:`..ops.align.dp_scores`).
* :func:`fit_scores_segments` scores a batch against many
  ``(reference, penalties, mode)`` segments in one launch (kernel D, same
  source; plain :func:`..ops.align.dp_scores_segments`).

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
the plain version.  Nothing catches a build or launch failure.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..native.build import CudaKernel, check_tensor
from .align import dp_align, dp_scores, dp_scores_segments

__all__ = [
    "DIR_KERNEL",
    "SCORE_KERNEL",
    "SEGMENTS_KERNEL",
    "build_cost_planes",
    "dir_kernel",
    "encode_mask",
    "fit_dirs",
    "fit_scores",
    "fit_scores_from_planes",
    "fit_scores_segments",
    "pack_segments",
    "plane_dims",
    "score_kernel",
    "segments_kernel",
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

#: ``csrc/score_kernel.cu``: replaces ``sarlacc_tpu/ops/pallas_align.py::_kernel``.
SCORE_KERNEL = CudaKernel(
    "score_kernel.cu",
    "sarlacc_score_kernel",
    [_P, _P, _I, _F, _F, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
)

#: ``csrc/score_kernel.cu``: replaces ``sarlacc_tpu/ops/pallas_align.py::_segments_kernel``.
SEGMENTS_KERNEL = CudaKernel(
    "score_kernel.cu",
    "sarlacc_segments_kernel",
    [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
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


def _gap_pair(gap_open, gap_ext) -> tuple[float, float]:
    """(open + ext, ext) rounded as the kernels' float32 sums them."""
    return float(np.float32(gap_open) + np.float32(gap_ext)), float(np.float32(gap_ext))


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
    go, ge = _gap_pair(gap_open, gap_ext)
    DIR_KERNEL.launch(
        modes.data_ptr(), mask.data_ptr(), R, go, ge,
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


def score_kernel(modes, mask, gap_open, gap_ext, costm, costmm, codes_k, lengths, local=True):
    """Launch kernel C: scores f32 [N] = ``S[lengths[i], i]`` after the last
    column; the same numbers as :func:`..ops.align.dp_scores` gathered at
    ``lengths``.  ``modes`` must not be empty."""
    dev = codes_k.device
    l1, n_pad = codes_k.shape
    R = int(modes.shape[0])
    N = int(lengths.shape[0])
    if R == 0 or N > n_pad:
        raise ValueError(f"kernel C needs R >= 1 and N <= n_pad (R={R}, N={N}, n_pad={n_pad})")
    check_tensor(modes, "modes", torch.int32, (R,))
    check_tensor(mask, "mask", torch.int32, (R,))
    check_tensor(costm, "costm", torch.float32, (4, l1, n_pad))
    check_tensor(costmm, "costmm", torch.float32, (4, l1, n_pad))
    check_tensor(codes_k, "codes_k", torch.int32, (l1, n_pad))
    check_tensor(lengths, "lengths", torch.int32, (N,))
    out = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0:
        return out
    S = torch.empty((l1, n_pad), dtype=torch.float32, device=dev)
    H = torch.empty_like(S)
    go, ge = _gap_pair(gap_open, gap_ext)
    SCORE_KERNEL.launch(
        modes.data_ptr(), mask.data_ptr(), R, go, ge, int(bool(local)),
        costm.data_ptr(), costmm.data_ptr(), codes_k.data_ptr(),
        lengths.data_ptr(), N, l1, n_pad, S.data_ptr(), H.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    return out


def segments_kernel(modes, mask, segs, costm, costmm, codes_k, lens_k):
    """Launch kernel D; same contract as :func:`..ops.align.dp_scores_segments`.

    Returns f32 [nseg, n_pad] on the card.
    """
    dev = codes_k.device
    l1, n_pad = codes_k.shape
    rtot = int(modes.shape[0])
    nseg = len(segs)
    check_tensor(modes, "modes", torch.int32, (rtot,))
    check_tensor(mask, "mask", torch.int32, (rtot,))
    check_tensor(costm, "costm", torch.float32, (4, l1, n_pad))
    check_tensor(costmm, "costmm", torch.float32, (4, l1, n_pad))
    check_tensor(codes_k, "codes_k", torch.int32, (l1, n_pad))
    check_tensor(lens_k, "lens_k", torch.int32, (n_pad,))
    for start, rlen, *_ in segs:
        if start < 0 or rlen < 0 or start + rlen > rtot:
            raise ValueError(f"segment ({start}, {rlen}) outside the {rtot} columns")
    out = torch.empty((nseg, n_pad), dtype=torch.float32, device=dev)
    if nseg == 0 or n_pad == 0:
        return out
    seg_i = torch.tensor(
        [[start, rlen, int(bool(local))] for start, rlen, local, _, _ in segs],
        dtype=torch.int32,
    ).to(dev)
    seg_f = torch.tensor(
        [_gap_pair(go, ge) for *_, go, ge in segs], dtype=torch.float32
    ).to(dev)
    S = torch.empty((l1, n_pad), dtype=torch.float32, device=dev)
    H = torch.empty_like(S)
    SEGMENTS_KERNEL.launch(
        modes.data_ptr(), mask.data_ptr(), seg_i.data_ptr(), seg_f.data_ptr(),
        nseg, costm.data_ptr(), costmm.data_ptr(), codes_k.data_ptr(),
        lens_k.data_ptr(), l1, n_pad, S.data_ptr(), H.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    return out


def _check_planes(planes, l1: int, n_pad: int):
    costm, costmm, codes_k = planes
    if tuple(codes_k.shape) != (l1, n_pad):
        raise ValueError(f"planes are {tuple(codes_k.shape)}, not ({l1}, {n_pad})")
    return costm, costmm, codes_k


def fit_scores_from_planes(
    planes,  # (costm, costmm, codes_k) from build_cost_planes
    lengths,  # [N] int32 tensor
    modes,  # [R] int32 tensor
    matched,  # [R, 5] bool tensor
    gap_opening: float,
    gap_extension: float,
    l1: int,
    n_pad: int,
    local: bool = True,
):
    """Scores f32 [N] from prebuilt cost planes, on the planes' device.

    Kernel C on CUDA, the plain :func:`dp_scores` on the CPU.  An empty
    reference returns column 0 without a launch: zeros when fitting, the
    gap ramp when global (``pallas_align.py:539-546``, float64 then
    float32, as there).
    """
    costm, costmm, codes_k = _check_planes(planes, l1, n_pad)
    dev = codes_k.device
    lengths = lengths.to(device=dev, dtype=torch.int32)
    if int(modes.shape[0]) == 0:
        if local:
            return torch.zeros(lengths.shape[0], dtype=torch.float32, device=dev)
        l = lengths.cpu().numpy()
        ramp = np.where(l == 0, 0.0, -(gap_opening + gap_extension) - gap_extension * (l - 1))
        return torch.as_tensor(ramp.astype(np.float32), device=dev)
    modes = modes.to(torch.int32).contiguous()
    mask = encode_mask(matched)
    if codes_k.is_cuda:
        return score_kernel(
            modes, mask, gap_opening, gap_extension, costm, costmm, codes_k,
            lengths.contiguous(), local,
        )
    S = dp_scores(modes, mask, gap_opening, gap_extension, costm, costmm, codes_k, local)
    return S[:, : lengths.shape[0]].gather(0, lengths.to(torch.int64)[None, :])[0]


def pack_segments(segments, device):
    """``[(modes, matched, open, ext, local), ...]`` -> the kernels' layout.

    Returns (modes int32 [Rtot], mask int32 [Rtot], segs) with every
    segment's columns end to end and ``segs`` a list of
    ``(start, rlen, local, open, ext)``.
    """
    modes_parts, mask_parts, segs = [], [], []
    at = 0
    for modes, matched, go, ge, local in segments:
        r = int(modes.shape[0])
        modes_parts.append(modes.to(device=device, dtype=torch.int32))
        mask_parts.append(encode_mask(matched.to(device)))
        segs.append((at, r, bool(local), float(go), float(ge)))
        at += r
    if not segs:
        empty = torch.zeros(0, dtype=torch.int32, device=device)
        return empty, empty, segs
    return torch.cat(modes_parts), torch.cat(mask_parts), segs


def fit_scores_segments(
    planes,  # (costm, costmm, codes_k) from build_cost_planes
    lengths,  # [N] int32 tensor
    segments,  # list of (modes [R], matched [R, 5], open, ext, local)
    l1: int,
    n_pad: int,
):
    """Scores f32 [nseg, N], one launch for all segments.

    Each segment is an independent (reference, penalties, mode) scoring of
    the same prepared batch; row s equals :func:`fit_scores_from_planes` for
    segment s bit for bit.  Kernel D on CUDA, the plain
    :func:`dp_scores_segments` on the CPU.
    """
    costm, costmm, codes_k = _check_planes(planes, l1, n_pad)
    dev = codes_k.device
    N = int(lengths.shape[0])
    lens_k = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    lens_k[:N] = lengths.to(device=dev, dtype=torch.int32)
    modes, mask, segs = pack_segments(segments, dev)
    run = segments_kernel if codes_k.is_cuda else dp_scores_segments
    return run(modes, mask, segs, costm, costmm, codes_k, lens_k)[:, :N]


def fit_scores(
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
    """Batch scores f32 [N]: one plane build and one kernel-C launch.

    Callers that score one batch many times build the planes once
    (:class:`..api.align_internal.PreparedReads`) and call
    :func:`fit_scores_from_planes` or :func:`fit_scores_segments`.
    """
    N, L = codes.shape
    l1, n_pad = plane_dims(N, L)
    planes = build_cost_planes(codes, qidx, match_tab, mismatch_tab, l1, n_pad)
    return fit_scores_from_planes(
        planes, lengths, modes, matched, gap_opening, gap_extension, l1, n_pad, local
    )

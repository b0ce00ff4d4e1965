"""Kernels A, C and D: the fitting DPs on the card, and their wrappers.

Counterpart of ``sarlacc_tpu/ops/pallas_align.py``.
:func:`build_cost_planes` lays the reads out position-major with reads on
the last axis ([l1, n_pad]) and precomputes the per-position match/mismatch
costs for all four degeneracy modes; one plane build serves every kernel.

* :func:`fit_dirs` runs the direction-emitting DP (kernel A,
  ``csrc/dir_kernel.cu``; plain :func:`..ops.align.dp_align`) and returns
  int16 run-length direction planes [R, l1, n_pad] that
  :func:`..ops.backtrack.qmap_walk` and :func:`..ops.backtrack.string_walk`
  consume.  Kernel A runs each read in G lanes over column tiles of
  :data:`DIR_TILES` width, in a wavefront (:func:`dir_plan` picks both);
  a reference with more tiles than lanes takes several passes through one
  [3, l1, n_pad] hand-off scratch.
* :func:`fit_scores_from_planes` scores a batch against one reference
  (kernel C, ``csrc/score_kernel.cu``; plain :func:`..ops.align.dp_scores`).
* :func:`fit_scores_segments` scores a batch against many
  ``(reference, penalties, mode)`` segments in one launch (kernel D, same
  source; plain :func:`..ops.align.dp_scores_segments`).

Kernels C and D keep no DP state in device memory.  Each launch runs at
the narrowest tile width of :data:`SCORE_TILES` that holds its widest
segment (:func:`score_tile`); a segment wider than the tile hands each
column tile's last column to the next through a scratch slot of
[2, l1, n_pad] floats, which the wrappers allocate.  Kernel D's segments
run concurrently, so each wide segment of a launch holds its own slot;
:func:`launch_groups` splits a call into launches that need at most
:data:`MAX_SCRATCH_BYTES` of slots (and at most :data:`MAX_SEGMENTS`
segments), and the launches reuse one scratch buffer.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
the plain version.  Nothing catches a build or launch failure.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..native.build import CudaKernel, check_tensor, kernel_resources
from .align import dp_align, dp_scores, dp_scores_segments

__all__ = [
    "DIR_KERNEL",
    "DIR_TILES",
    "SCORE_KERNEL",
    "SCORE_TILES",
    "SEGMENTS_KERNEL",
    "build_cost_planes",
    "cost_slots",
    "dir_kernel",
    "dir_kernel_resources",
    "dir_plan",
    "encode_mask",
    "fit_dirs",
    "fit_scores",
    "fit_scores_from_planes",
    "fit_scores_segments",
    "launch_groups",
    "pack_segments",
    "plane_dims",
    "score_kernel",
    "score_kernel_resources",
    "score_tile",
    "segments_kernel",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: ``csrc/dir_kernel.cu``: replaces ``sarlacc_tpu/ops/pallas_align.py::_dir_kernel``.
#: As for :data:`SCORE_KERNEL`, the last pointer before the stream is the
#: per-block timer stamps, for measurement only (set by :func:`_launch_dirs`).
DIR_KERNEL = CudaKernel(
    "dir_kernel.cu",
    "sarlacc_dir_kernel",
    [_P, _P, _I, _F, _F, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
)

#: ``csrc/score_kernel.cu``: replaces ``sarlacc_tpu/ops/pallas_align.py::_kernel``.
#: The last pointer before the stream (here and in :data:`SEGMENTS_KERNEL`)
#: is the per-block timer stamps, for measurement only: the public wrappers
#: pass null, and only :func:`_launch_score` / :func:`_launch_segments` set it.
SCORE_KERNEL = CudaKernel(
    "score_kernel.cu",
    "sarlacc_score_kernel",
    [_P, _P, _I, _F, _F, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
)

#: ``csrc/score_kernel.cu``: replaces ``sarlacc_tpu/ops/pallas_align.py::_segments_kernel``.
SEGMENTS_KERNEL = CudaKernel(
    "score_kernel.cu",
    "sarlacc_segments_kernel",
    [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
)

#: The tile widths kernels C and D are compiled for (``TJ`` in
#: ``csrc/score_kernel.cu``; the entry points refuse any other value).
SCORE_TILES = (15, 31, 63)

#: The tile widths kernel A is compiled for (``TJ`` in ``csrc/dir_kernel.cu``).
DIR_TILES = (7, 15, 31)

#: Threads a kernel-A launch aims for: 8 warps on each of the H100's 132
#: SMs.  More lanes a read cost more than they fill: a warp's direction
#: store covers 32 / G reads of one row, a full 32-byte sector at G = 2 and
#: less beyond, and at 19 968 reads 2 lanes beat 4 (tools/dir_tiles.py).
DIR_FILL = 132 * 8 * 32

#: Fewest ordinary columns a kernel-A lane keeps when the plan doubles the
#: lanes of a read: below it the hand-off and the row's cost loads outweigh
#: the cells.
DIR_MIN_COLS = 6

#: Most segments one kernel-D launch takes (the grid's y extent); a call
#: with more takes several launches.
MAX_SEGMENTS = 65535

#: Most bytes of tile hand-off scratch a kernel-D call allocates: one
#: [2, l1, n_pad] float32 slot for each segment of a launch wider than the
#: tile (205 MB a slot at 100 000 reads x l1 256, 41 MB at 19 968), so
#: wider calls are split into launches of fewer wide segments.  A segment
#: takes a slot whatever the budget, so a call always makes progress
#: (kernel C, one segment, takes at most one slot).
MAX_SCRATCH_BYTES = 512 << 20


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


def dir_plan(rlen: int, local: bool, n_pad: int) -> tuple[int, int, int]:
    """Kernel A's launch shape for a reference of ``rlen`` columns over
    ``n_pad`` reads: (tile width, lanes a read G, passes).

    G doubles (to at most 32) while the launch has fewer than
    :data:`DIR_FILL` threads and each lane would keep at least
    :data:`DIR_MIN_COLS` ordinary columns; the tile is the narrowest of
    :data:`DIR_TILES` that holds a lane's share, and a reference wider than
    G tiles of the widest takes several passes."""
    rn = _ordinary(rlen, local)
    G = 1
    while G < 32 and n_pad * G < DIR_FILL and -(-rn // (2 * G)) >= DIR_MIN_COLS:
        G *= 2
    share = -(-rn // G)
    tj = next((t for t in DIR_TILES if share <= t), DIR_TILES[-1])
    return tj, G, max(1, -(-rn // (tj * G)))


def dir_kernel(modes, mask, gap_open, gap_ext, costm, costmm, codes_k, local=True):
    """Launch kernel A; same contract as :func:`..ops.align.dp_align`.

    Returns (S f32 [l1, n_pad], dirs int16 [R, l1, n_pad]) on the card.
    """
    return _launch_dirs(modes, mask, gap_open, gap_ext, costm, costmm, codes_k, local)


def _launch_dirs(modes, mask, gap_open, gap_ext, costm, costmm, codes_k, local=True,
                 stamps=None, kernel=DIR_KERNEL, plan=None):
    """:func:`dir_kernel`, with what only measurement sets: ``stamps``,
    int64 [n_pad * G / 128, 3] on the card, filled per block as for
    :func:`_launch_score`; another build of the source (``kernel``); a
    forced ``(tile width, G, passes)`` (``plan``)."""
    dev = codes_k.device
    l1, n_pad = codes_k.shape
    R = int(modes.shape[0])
    check_tensor(modes, "modes", torch.int32, (R,))
    check_tensor(mask, "mask", torch.int32, (R,))
    check_tensor(costm, "costm", torch.float32, (4, l1, n_pad))
    check_tensor(costmm, "costmm", torch.float32, (4, l1, n_pad))
    check_tensor(codes_k, "codes_k", torch.int32, (l1, n_pad))
    tj, G, passes = dir_plan(R, bool(local), n_pad) if plan is None else plan
    if stamps is not None:
        check_tensor(stamps, "stamps", torch.int64, (n_pad * G // 128, 3))
    S = torch.empty((l1, n_pad), dtype=torch.float32, device=dev)
    dirs = torch.empty((R, l1, n_pad), dtype=torch.int16, device=dev)
    scratch = None
    if passes > 1:
        scratch = torch.empty((3, l1, n_pad), dtype=torch.float32, device=dev)
    go, ge = _gap_pair(gap_open, gap_ext)
    kernel.launch(
        modes.data_ptr(), mask.data_ptr(), R, go, ge,
        int(bool(local)), costm.data_ptr(), costmm.data_ptr(),
        codes_k.data_ptr(), l1, n_pad, tj, G, passes, _ptr(scratch), S.data_ptr(),
        dirs.data_ptr(), _ptr(stamps), torch.cuda.current_stream(dev),
    )
    return S, dirs


def dir_kernel_resources(kernel=DIR_KERNEL) -> dict:
    """Kernel A as compiled at each tile width, keyed ``"A@15"`` and so
    on, with the keys of :func:`score_kernel_resources`.  ``kernel``: a
    build of ``csrc/dir_kernel.cu`` (another one only for measurement)."""
    fn = kernel.function("sarlacc_dir_attrs", [_I, _P])
    return {f"A@{tj}": kernel_resources(fn, tj) for tj in DIR_TILES}


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


def _ordinary(rlen: int, local: bool) -> int:
    """A segment's columns in the tiles: fitting mode peels off the last."""
    return rlen - (1 if local and rlen > 0 else 0)


def score_tile(segs) -> int:
    """The narrowest tile width that holds every ``(start, rlen, local,
    ...)`` segment, else the widest (and several tiles)."""
    widest = max((_ordinary(rlen, local) for _, rlen, local, *_ in segs), default=0)
    return next((tj for tj in SCORE_TILES if widest <= tj), SCORE_TILES[-1])


def launch_groups(segs, tj: int, l1: int, n_pad: int) -> list:
    """Kernel D's launches for ``(start, rlen, local, ...)`` segments at
    tile width ``tj``: consecutive groups ``(s0, s1, slots)``, each at most
    :data:`MAX_SEGMENTS` segments and at most as many segments wider than
    the tile as :data:`MAX_SCRATCH_BYTES` holds slots of [2, l1, n_pad]
    float32 (at least one).  ``slots`` gives each segment of the group its
    hand-off slot, numbered from 0 in the group, or -1 when its columns fit
    one tile."""
    cap = max(1, MAX_SCRATCH_BYTES // (2 * l1 * n_pad * 4))
    groups, s0, slots, wide_n = [], 0, [], 0
    for s, (_, rlen, local, *_) in enumerate(segs):
        wide = _ordinary(rlen, local) > tj
        if len(slots) == MAX_SEGMENTS or (wide and wide_n == cap):
            groups.append((s0, s, slots))
            s0, slots, wide_n = s, [], 0
        slots.append(wide_n if wide else -1)
        wide_n += wide
    if slots:
        groups.append((s0, len(segs), slots))
    return groups


def cost_slots(modes, mask) -> list[int]:
    """The slots of the [4, l1, n_pad] match (0-3) and mismatch (4-7) cost
    planes that columns ``modes`` / ``mask`` select over the read codes
    0-7: what kernels C and D load a row (their ``need``), so the planes'
    only compulsory reads."""
    m = modes.cpu().to(torch.int64).clamp(1, 4) - 1
    hit = (mask.cpu().to(torch.int64)[:, None] >> torch.arange(8)) & 1
    return sorted(set(torch.where(hit.bool(), m[:, None], m[:, None] + 4).flatten().tolist()))


def _scratch(nslots: int, l1: int, n_pad: int, dev):
    if nslots == 0:
        return None
    return torch.empty((nslots, 2, l1, n_pad), dtype=torch.float32, device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def score_kernel(modes, mask, gap_open, gap_ext, costm, costmm, codes_k, lengths, local=True):
    """Launch kernel C: scores f32 [N] = ``S[lengths[i], i]`` after the last
    column; the same numbers as :func:`..ops.align.dp_scores` gathered at
    ``lengths``.  ``modes`` must not be empty."""
    return _launch_score(modes, mask, gap_open, gap_ext, costm, costmm, codes_k, lengths, local)


def _launch_score(modes, mask, gap_open, gap_ext, costm, costmm, codes_k, lengths, local=True,
                  stamps=None, kernel=SCORE_KERNEL, tj=None):
    """:func:`score_kernel`, with what only measurement sets: ``stamps``,
    int64 [ceil(N / 128), 3] on the card, filled per block with its start
    and end (ns, the global timer) and its SM; another build of the source
    (``kernel``); a forced tile width ``tj``."""
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
    if stamps is not None:
        check_tensor(stamps, "stamps", torch.int64, (-(-N // 128), 3))
    tj = score_tile([(0, R, bool(local))]) if tj is None else tj
    scratch = _scratch(int(_ordinary(R, bool(local)) > tj), l1, n_pad, dev)
    go, ge = _gap_pair(gap_open, gap_ext)
    kernel.launch(
        modes.data_ptr(), mask.data_ptr(), R, go, ge, int(bool(local)),
        costm.data_ptr(), costmm.data_ptr(), codes_k.data_ptr(),
        lengths.data_ptr(), N, l1, n_pad, tj, _ptr(scratch),
        out.data_ptr(), _ptr(stamps), torch.cuda.current_stream(dev),
    )
    return out


def segments_kernel(modes, mask, segs, costm, costmm, codes_k, lens_k):
    """Launch kernel D; same contract as :func:`..ops.align.dp_scores_segments`.

    Returns f32 [nseg, n_pad] on the card, from one launch for each group of
    :func:`launch_groups` (one for every call of the bench's paths).
    """
    return _launch_segments(modes, mask, segs, costm, costmm, codes_k, lens_k)


def _launch_segments(modes, mask, segs, costm, costmm, codes_k, lens_k, stamps=None,
                     kernel=SEGMENTS_KERNEL, tj=None):
    """:func:`segments_kernel`, with what only measurement sets: ``stamps``,
    int64 [nseg * n_pad / 128, 3], as for :func:`_launch_score`; another
    build of the source (``kernel``); a forced tile width ``tj``."""
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
    if stamps is not None:
        check_tensor(stamps, "stamps", torch.int64, (nseg * n_pad // 128, 3))
    tj = score_tile(segs) if tj is None else tj
    groups = launch_groups(segs, tj, l1, n_pad)
    slots = [k for _, _, g in groups for k in g]
    seg_i = torch.tensor(
        [[start, rlen, int(bool(local)), slot]
         for (start, rlen, local, _, _), slot in zip(segs, slots)],
        dtype=torch.int32,
    ).to(dev)
    seg_f = torch.tensor(
        [_gap_pair(go, ge) for *_, go, ge in segs], dtype=torch.float32
    ).to(dev)
    scratch = _scratch(max(max(g) + 1 for _, _, g in groups), l1, n_pad, dev)
    blocks = n_pad // 128
    stream = torch.cuda.current_stream(dev)
    for s0, s1, _ in groups:  # one stream: the launches share the scratch in turn
        kernel.launch(
            modes.data_ptr(), mask.data_ptr(), seg_i[s0].data_ptr(), seg_f[s0].data_ptr(),
            s1 - s0, costm.data_ptr(), costmm.data_ptr(), codes_k.data_ptr(),
            lens_k.data_ptr(), l1, n_pad, tj, _ptr(scratch), out[s0].data_ptr(),
            None if stamps is None else stamps[s0 * blocks].data_ptr(), stream,
        )
    return out


def score_kernel_resources(kernel=SCORE_KERNEL) -> dict:
    """Kernels C and D as compiled at each tile width, from
    ``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``: registers a thread,
    static shared bytes a block, spill bytes a thread, resident blocks an
    SM, threads a block, and the theoretical occupancy (resident warps over
    the SM's 64).  Keyed ``"C@63"``, ``"D@15"`` and so on.  ``kernel``: a
    build of ``csrc/score_kernel.cu`` (another one only for measurement)."""
    fn = kernel.function("sarlacc_score_attrs", [_I, _I, _P])
    return {f"{name}@{tj}": kernel_resources(fn, which, tj)
            for which, name in ((0, "C"), (1, "D")) for tj in SCORE_TILES}


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

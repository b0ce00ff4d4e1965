"""Kernel I: doubled Levenshtein distances, one thread a pair, on the card.

:func:`lev2_cross` and :func:`lev2_paired` launch ``csrc/lev2_kernel.cu``'s
full-DP forms, replacing ``sarlacc_tpu/ops/levenshtein.py::_lev2_tile_kernel``;
their plain PyTorch version is ``ops/levenshtein.py::_lev2_scan``, which
``ops/levenshtein.py``'s ``_lev2_block`` and ``_lev2_pairs`` run on CPU
tensors.  :func:`lev2_hits` launches its thresholded form on the whole
row-block scan of one ``_neighbor_pairs_rowblock`` call, replacing the tile
DP of ``::_lev2_rowblock_sparse``: banded DPs that stop early, and only the
hits written, with a device count (its plain version is
``ops/levenshtein.py::_rowblock_hits_plain``).  All take CUDA tensors only
and raise on anything else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import memory_budget
from ..native.build import CudaKernel, check_tensor, kernel_resources

__all__ = ["HITS_KERNEL", "LEV2_KERNEL", "LEV2_ROUTES", "hits_route", "lev2_cross", "lev2_hits",
           "fit_hits", "lev2_kernel_resources", "lev2_paired", "lev2_route", "rowblock_jobs"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: ``csrc/lev2_kernel.cu``: replaces ``sarlacc_tpu/ops/levenshtein.py::_lev2_tile_kernel``.
LEV2_KERNEL = CudaKernel(
    "lev2_kernel.cu",
    "sarlacc_lev2_kernel",
    [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _P, _I, _P, _P],
)

#: ``csrc/lev2_kernel.cu``'s thresholded form: replaces the tile DP of
#: ``sarlacc_tpu/ops/levenshtein.py::_lev2_rowblock_sparse`` (its launches
#: count apart from the full-DP forms').
HITS_KERNEL = CudaKernel(
    "lev2_kernel.cu",
    "sarlacc_lev2_hits",
    [_P, _P, _I, _L, _I, _P, _I, _P, _L, _P, _P, _I, _P, _I, _P],
)

#: Kernel I's routes, in the kernel's numbering: the column in registers
#: for L <= 32, else in a device scratch.
LEV2_ROUTES = ("reg32", "scratch")

#: The thresholded form's job shape: rows a job (one thread a row) and
#: columns a job (staged in shared memory on the register route).
HIT_ROWS, HIT_COLS = 128, 256
#: Its register route's widest row and half-band (thr / 2).
HIT_REG_W, HIT_REG_H = 64, 15

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


def hits_route(W: int, thr: int) -> str:
    """The thresholded form's route for rows of ``W`` positions at doubled
    threshold ``thr``: the band in registers, or in a device scratch."""
    return "band_reg" if W <= HIT_REG_W and thr // 2 <= HIT_REG_H else "band_scratch"


def rowblock_jobs(s_len, limit: int, tile: int) -> np.ndarray:
    """The thresholded form's jobs int32 [n_jobs, 4] (r0, r1, c0, c1) for
    lengths ``s_len`` sorted ascending: the pairs of
    ``ops/levenshtein.py::_neighbor_pairs_rowblock``'s loop (row blocks of
    ``tile`` rows, each against columns from its first row up to the length
    prune ``hi_len + limit``), cut into :data:`HIT_ROWS` x :data:`HIT_COLS`
    jobs whose columns start at their first row (j >= i)."""
    s_len = np.asarray(s_len)
    n = s_len.shape[0]
    TI = max(1, min(int(tile), n))
    i0 = np.arange(0, n, TI)
    i1 = np.minimum(i0 + TI, n)
    j_end = np.searchsorted(s_len, s_len[i1 - 1] + int(limit), side="right") if n else i1
    j_end = np.minimum(np.maximum(j_end, i0 + 1), n)
    parts = []
    for b0, b1, je in zip(i0.tolist(), i1.tolist(), j_end.tolist()):
        r0 = np.arange(b0, b1, HIT_ROWS)
        cols = -(-(je - r0) // HIT_COLS)  # column tiles from each row tile's first row
        r0s = np.repeat(r0, cols)
        c0 = r0s + (np.arange(cols.sum()) - np.repeat(np.cumsum(cols) - cols, cols)) * HIT_COLS
        parts.append(np.stack([r0s, np.minimum(r0s + HIT_ROWS, b1), c0,
                               np.minimum(c0 + HIT_COLS, je)], axis=1))
    return np.concatenate(parts + [np.zeros((0, 4), np.int64)]).astype(np.int32)


def lev2_hits(codes, lens, s_len, thr: int, limit: int, tile: int, cells=None, cap=None):
    """The thresholded form on one row-block scan: ``codes`` [n, W]
    (integer codes, pad 5) and ``lens`` int32 [n] on the card, sorted by
    length, with ``s_len`` the same lengths on the host (for the jobs, see
    :func:`rowblock_jobs`).  Returns int64 [hits] keys ``i * n + j``, sorted
    (row-major, ascending j within a row), of every pair j >= i of the scan
    with doubled distance <= ``thr``, equal to
    ``ops/levenshtein.py::_rowblock_hits_plain``'s.  ``cells`` (an int64 [1]
    CUDA tensor, measurement only) gains the DP cells evaluated.  The hit
    buffer holds ``cap`` keys (by default max(2^16, 8 n)); the count is read
    back, and once more on overflow after a re-run with a buffer of that
    size (:func:`fit_hits`); the caller reads the keys.  Hits beyond the
    memory budget (24 bytes a hit: the buffer and the sort's values and
    indices) are found in parts of whole row tiles, a count readback
    each, and then come back on the host."""
    n, W = codes.shape
    codes = codes.to(torch.int8).contiguous()
    check_tensor(codes, "codes", torch.int8, (n, W))
    check_tensor(lens, "lengths", torch.int32, (n,))
    if cells is not None:
        check_tensor(cells, "cells", torch.int64, (1,))
    dev = codes.device
    thr = int(thr)
    if thr < 0 or n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    jobs_np = rowblock_jobs(s_len, limit, tile)
    n_jobs = jobs_np.shape[0]
    jobs = torch.as_tensor(jobs_np, device=dev)
    route = hits_route(W, thr)
    scratch, blocks = None, 0
    if route == "band_scratch":
        bw = 2 * (thr // 2) + 1
        blocks = max(1, min(n_jobs, SCRATCH_BYTES // (4 * bw * HIT_ROWS)))
        scratch = torch.empty(bw * blocks * HIT_ROWS, dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev)

    def run(j0, j1, cap_, cells_):
        hits = torch.empty(cap_, dtype=torch.int64, device=dev)
        count.zero_()
        HITS_KERNEL.launch(
            codes.data_ptr(), lens.data_ptr(), W, n, thr, jobs.data_ptr() + 16 * j0, j1 - j0,
            hits.data_ptr(), cap_, count.data_ptr(), None if cells_ is None else cells_.data_ptr(),
            ("band_reg", "band_scratch").index(route), None if scratch is None else
            scratch.data_ptr(), blocks, stream)
        return hits, int(count)  # a readback: the exact count

    # Row tiles (the jobs of one r0) are the unit of a split: a part's rows
    # all follow the previous part's, so the parts' sorted keys concatenate
    # in order.
    starts = np.append(np.flatnonzero(np.diff(jobs_np[:, 0], prepend=-1)), n_jobs).tolist()
    most = memory_budget(dev, 1 / 16, 1 << 30, "lev2_hits") // 24
    keys = []
    for j0, j1, hits, total in fit_hits(run, starts, max(1 << 16, 8 * n) if cap is None
                                        else int(cap), most, cells):
        part = torch.sort(hits[:total]).values
        del hits
        keys.append(part if (j0, j1) == (0, n_jobs) else part.cpu())
    return keys[0] if len(keys) == 1 else torch.cat(keys)


def fit_hits(run, starts, cap: int, most: int, cells=None):
    """Yield (j0, j1, buffer, exact hit count) for consecutive job ranges
    that cover the scan in order.  ``run(j0, j1, cap, cells)`` scans jobs
    [j0, j1) into a buffer of ``cap`` keys and returns (buffer, exact
    count); ``starts`` holds the job indices where a row tile begins, then
    the job count.  One run of every job with a buffer of min(``cap``,
    ``most``) keys; on overflow one re-run with a buffer of the count where
    it is at most ``most`` keys (or the range is one row tile), else the
    row tiles split in two halves, each fitted so.  Only the first run
    gains ``cells``."""

    def fit(a, b, cells_):
        buf = min(cap, most)
        hits, total = run(starts[a], starts[b], buf, cells_)
        if total <= buf:
            yield starts[a], starts[b], hits, total
        elif total <= most or b - a == 1:
            del hits
            yield starts[a], starts[b], *run(starts[a], starts[b], total, None)
        else:
            del hits
            m = (a + b) // 2
            yield from fit(a, m, None)
            yield from fit(m, b, None)

    yield from fit(0, len(starts) - 1, cells)


def lev2_kernel_resources() -> dict:
    """Kernel I's routes as compiled (keys ``"I:reg32"``, ``"I:scratch"`` and
    the thresholded form's ``"I:band_reg"`` (at half-band 2) and
    ``"I:band_scratch"``; values as
    ``ops/cuda_align.py::score_kernel_resources``'s)."""
    fn = LEV2_KERNEL.function("sarlacc_lev2_attrs", [_I, _P])
    names = LEV2_ROUTES + ("band_reg", "band_scratch")
    return {f"I:{name}": kernel_resources(fn, i) for i, name in enumerate(names)}

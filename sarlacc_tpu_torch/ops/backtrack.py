"""Batched replay of the template backtrack over run-length directions.

Counterpart of ``sarlacc_tpu/ops/backtrack.py`` (``qmap_walk_device``,
``string_walk_device``, ``query_windows`` and ``assemble_strings``).
:func:`qmap_walk` and :func:`string_walk` walk every read at once, on the
device of the direction planes: on CUDA tensors kernel G
(:mod:`.cuda_backtrack`, one thread a read, one launch), on CPU tensors
the plain versions :func:`_qmap_walk_plain` and :func:`_string_walk_plain`,
one backtrack step per iteration for every read.  Only the [N, R+1]
mapping arrays, or the [N, T] emission arrays, leave the card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_backtrack

__all__ = ["assemble_strings", "qmap_walk", "query_windows", "string_walk"]

#: Walk steps between checks for finished reads (each check syncs the host).
_STEPS_PER_CHECK = 8


def qmap_walk(dirs: torch.Tensor, lengths: torch.Tensor):
    """Query maps from kernel-layout directions ``dirs`` [R, l1, n_pad]:
    kernel G on CUDA tensors, :func:`_qmap_walk_plain` on CPU ones."""
    if dirs.is_cuda:
        return cuda_backtrack.qmap_walk(dirs, lengths)
    return _qmap_walk_plain(dirs, lengths)


def _kinds(counts, fetching, up, col, R, diag, left, d):
    """Add one step's fetching steps by kind to ``counts`` (tensors)."""
    if counts is None:
        return
    steps = {"fetches": fetching, "up_last": up & (col == R), "up_inner": up & (col < R),
             "diag": diag, "left": left, "other": fetching & ~up & (d < 0)}
    for k, m in steps.items():
        counts[k] = counts.get(k, 0) + m.sum()


def _counted(counts):
    """``counts``' tensors as ints, in place."""
    if counts is not None:
        for k, v in counts.items():
            counts[k] = int(v)


def _qmap_walk_plain(dirs: torch.Tensor, lengths: torch.Tensor, counts: dict | None = None):
    """Kernel G's plain version, one backtrack step an iteration.

    Returns (is_match bool [n_pad, R+1], dp_row int32 [n_pad, R+1]), the
    ``fill_map`` mapping (reference_align.cpp:280-305): position 0 is
    (False, 0); diagonal cells record (True, row); left-run cells record
    (False, row+1); up-runs record nothing.  Lanes past ``lengths`` walk
    trivially from length 0.  ``counts``, a dict (measurement only), gains
    the walk's fetching steps, in all and by kind, under kernel G's names
    (``cuda_backtrack.COUNTS`` but ``rounds``, which is the kernel's own).
    """
    R, l1, N = dirs.shape
    dev = dirs.device
    flat = dirs.reshape(R * l1, N)
    narr = torch.arange(N, device=dev)

    col = torch.full((N,), R, dtype=torch.int64, device=dev)
    row = torch.zeros(N, dtype=torch.int64, device=dev)
    row[: lengths.shape[0]] = lengths.to(torch.int64)
    rc = torch.zeros(N, dtype=torch.int64, device=dev)
    om = torch.zeros((N, R + 2), dtype=torch.bool, device=dev)
    orow = torch.zeros((N, R + 2), dtype=torch.int32, device=dev)

    max_steps = R + l1 + 4
    it = 0
    while it < max_steps and bool((col > 0).any()):
        for _ in range(_STEPS_PER_CHECK):
            active = col > 0
            idx = ((col - 1) * l1 + row).clamp(0, R * l1 - 1)
            d = flat.gather(0, idx[None, :])[0].to(torch.int64)

            fresh = active & (rc == 0)
            up = fresh & (row > 0) & (d < 0)
            diag = fresh & ~up & (d == 0)
            left_new = fresh & ~up & (d > 0)
            left_cont = active & (rc > 0)
            write = diag | left_new | left_cont
            _kinds(counts, fresh, up, col, R, diag, left_new, d)

            wcol = torch.where(write, col, R + 1)  # R+1 is a scratch bin
            om[narr, wcol] = diag
            orow[narr, wcol] = torch.where(diag, row, row + 1).to(torch.int32)

            row = torch.where(up, row + d, torch.where(diag, row - 1, row))
            rc = torch.where(left_new, d - 1, torch.where(left_cont, rc - 1, rc))
            col = torch.where(write, col - 1, col)
        it += _STEPS_PER_CHECK
    _counted(counts)
    return om[:, : R + 1], orow[:, : R + 1]


def string_walk(dirs: torch.Tensor, lengths: torch.Tensor):
    """Gapped-alignment emissions from kernel-layout directions [R, l1,
    n_pad]: kernel G on CUDA tensors, :func:`_string_walk_plain` on CPU
    ones."""
    if dirs.is_cuda:
        return cuda_backtrack.string_walk(dirs, lengths)
    return _string_walk_plain(dirs, lengths)


def _string_walk_plain(dirs: torch.Tensor, lengths: torch.Tensor, counts: dict | None = None):
    """Kernel G's plain version, one backtrack step an iteration.

    The template backtrack of reference_align.cpp:353-389, replayed for
    every read at once.  Per read, position t of the two [T] arrays
    (T = R + l1 + 1) holds the reference position (0 = gap) and the query
    position (0 = gap) of the t-th alignment column FROM THE END; ``ncols``
    counts the columns.  Decode with :func:`assemble_strings`.  Positions
    are int32 (the JAX package's int16 holds the same values below 32767).

    Returns (a_pos int32 [n_pad, T], b_pos int32 [n_pad, T], ncols int32
    [n_pad]); lanes past ``lengths`` walk from length 0.  ``counts`` as
    :func:`_qmap_walk_plain`'s.
    """
    R, l1, N = dirs.shape
    dev = dirs.device
    flat = dirs.reshape(R * l1, N)
    narr = torch.arange(N, device=dev)
    T = R + l1 + 1

    col = torch.full((N,), R, dtype=torch.int64, device=dev)
    row = torch.zeros(N, dtype=torch.int64, device=dev)
    row[: lengths.shape[0]] = lengths.to(torch.int64)
    rc = torch.zeros(N, dtype=torch.int64, device=dev)
    uc = torch.zeros(N, dtype=torch.int64, device=dev)
    t = torch.zeros(N, dtype=torch.int64, device=dev)
    oa = torch.zeros((N, T + 1), dtype=torch.int32, device=dev)  # T is a scratch slot
    ob = torch.zeros((N, T + 1), dtype=torch.int32, device=dev)

    it = 0
    while it < T + 8 and bool(((col > 0) | (row > 0)).any()):
        for _ in range(_STEPS_PER_CHECK):
            active = (col > 0) | (row > 0)
            idx = ((col - 1) * l1 + row).clamp(0, R * l1 - 1)
            d = flat.gather(0, idx[None, :])[0].to(torch.int64)

            fresh = active & (rc == 0) & (uc == 0)
            tailq = fresh & (col == 0)  # reference exhausted: the remaining query rows
            see_up = fresh & ~tailq & (row > 0) & (d < 0)
            diag = fresh & ~tailq & ~see_up & (d == 0)
            newl = fresh & ~tailq & ~see_up & (d > 0)
            _kinds(counts, fresh & ~tailq, see_up, col, R, diag, newl, d)

            uc = torch.where(see_up, -d, uc)
            rc = torch.where(newl, d, rc)
            emit_up = active & (uc > 0) & ~diag & ~newl & ~tailq
            emit_left = active & (rc > 0) & ~emit_up & ~diag & ~tailq

            # Exactly one emission per active read per step.
            slot = torch.where(active, t.clamp(0, T), T)
            oa[narr, slot] = torch.where(emit_left | diag, col, 0).to(torch.int32)
            ob[narr, slot] = torch.where(emit_up | tailq | diag, row, 0).to(torch.int32)

            row = row - (emit_up | tailq | diag).to(torch.int64)
            col = col - (emit_left | diag).to(torch.int64)
            uc = uc - emit_up.to(torch.int64)
            rc = rc - emit_left.to(torch.int64)
            t = t + active.to(torch.int64)
        it += _STEPS_PER_CHECK
    _counted(counts)
    return oa[:, :T], ob[:, :T], t.to(torch.int32)


def assemble_strings(a_pos, b_pos, ncols, refseq: str, seqs: list[str]):
    """Emission arrays -> gapped (reference, query) strings + edit counts.

    One fancy-index per side builds [N, T] byte planes; per read the first
    ``ncols`` bytes, reversed, are the alignment (the walk emits back to
    front).  Edits count differing columns (general_align.cpp:47-52).
    Host numpy; takes numpy arrays or tensors.
    """
    a_pos = np.asarray(a_pos, dtype=np.int64)
    b_pos = np.asarray(b_pos, dtype=np.int64)
    ncols = np.asarray(ncols, dtype=np.int64)
    N, T = a_pos.shape
    rbytes = np.frombuffer(("-" + refseq).encode(), dtype=np.uint8)
    ra = rbytes[a_pos]  # [N, T] uint8
    maxq = max((len(s) for s in seqs), default=0)
    qmat = np.full((N, maxq + 1), ord("-"), np.uint8)
    for i, s in enumerate(seqs):
        if s:
            qmat[i, 1 : len(s) + 1] = np.frombuffer(s.encode(), dtype=np.uint8)
    qa = qmat[np.arange(N)[:, None], np.clip(b_pos, 0, maxq)]
    qa[b_pos == 0] = ord("-")

    live = np.arange(T)[None, :] < ncols[:, None]
    edits = ((ra != qa) & live).sum(axis=1).astype(np.int64)
    refalign = [ra[i, : ncols[i]][::-1].tobytes().decode() for i in range(N)]
    qalign = [qa[i, : ncols[i]][::-1].tobytes().decode() for i in range(N)]
    return refalign, qalign, edits


def query_windows(
    is_match: np.ndarray,
    dp_row: np.ndarray,
    nrows: np.ndarray,
    ref_start: int,
    ref_end: int,
    include_gaps: bool = False,
):
    """Vectorized ``querymap::operator()`` over all reads
    (reference_align.cpp:307-351).  Returns (starts, ends), 0-based."""
    R = is_match.shape[1] - 1
    if R == 0:
        z = np.zeros(is_match.shape[0], np.int64)
        return z, z
    if not include_gaps:
        curstart = dp_row[:, ref_start + 1].astype(np.int64)
        curend = dp_row[:, ref_end].astype(np.int64) + is_match[:, ref_end]
        return curstart - 1, curend - 1
    if ref_start == 0:
        curstart = np.ones(is_match.shape[0], np.int64)
    else:
        curstart = dp_row[:, ref_start].astype(np.int64) + is_match[:, ref_start]
    e2 = ref_end + 1
    if e2 == R + 1:
        curend = np.asarray(nrows, np.int64)
    else:
        curend = dp_row[:, e2].astype(np.int64)
    return curstart - 1, curend - 1

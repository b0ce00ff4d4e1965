"""Batched replay of the template backtrack over run-length directions.

Counterpart of ``sarlacc_tpu/ops/backtrack.py`` (``qmap_walk_device`` and
``query_windows``).  :func:`qmap_walk` walks every read at once, on the
device of the direction planes, one backtrack step per iteration: plain
PyTorch, so each step is a handful of small launches.  Only the
[N, R+1] mapping arrays leave the card.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["qmap_walk", "query_windows"]

#: Walk steps between checks for finished reads (each check syncs the host).
_STEPS_PER_CHECK = 8


def qmap_walk(dirs: torch.Tensor, lengths: torch.Tensor):
    """Query maps from kernel-layout directions ``dirs`` [R, l1, n_pad].

    Returns (is_match bool [n_pad, R+1], dp_row int32 [n_pad, R+1]), the
    ``fill_map`` mapping (reference_align.cpp:280-305): position 0 is
    (False, 0); diagonal cells record (True, row); left-run cells record
    (False, row+1); up-runs record nothing.  Lanes past ``lengths`` walk
    trivially from length 0.
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

            wcol = torch.where(write, col, R + 1)  # R+1 is a scratch bin
            om[narr, wcol] = diag
            orow[narr, wcol] = torch.where(diag, row, row + 1).to(torch.int32)

            row = torch.where(up, row + d, torch.where(diag, row - 1, row))
            rc = torch.where(left_new, d - 1, torch.where(left_cont, rc - 1, rc))
            col = torch.where(write, col - 1, col)
        it += _STEPS_PER_CHECK
    return om[:, : R + 1], orow[:, : R + 1]


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

"""Plain reference of the calibration and demultiplexing arithmetic:
per-read scrambles (``R/getAdaptorThresholds.R:68-92``), the scramble-FDR
threshold (``:94-103``), ``filterReads``' mask and trim points
(``R/filterReads.R:11-41``), ``median - nmads * MAD`` thresholds
(``R/getBarcodeThresholds.R:10-14``) and the best and second-best barcode
(``src/barcode_align.cpp``, first maximum on ties)."""

from __future__ import annotations

import numpy as np

__all__ = ["scramble", "fdr_threshold", "filter_mask", "mad_thresholds", "best_two"]


def scramble(codes, lengths, quals, rng: np.random.Generator):
    """A uniform random permutation of each read's bases and qualities,
    drawn as one argsort of i.i.d. uniform keys with padding sorted last."""
    codes = np.asarray(codes)
    N, L = codes.shape
    keys = rng.random((N, L))
    pad = np.arange(L)[None, :] >= np.asarray(lengths)[:, None]
    keys[pad] = 2.0
    order = np.argsort(keys, axis=1)
    c = np.take_along_axis(codes, order, axis=1)
    c[pad] = 5
    q = np.take_along_axis(np.asarray(quals), order, axis=1)
    q[pad] = 0
    return c, q


def fdr_threshold(real, scrambled, error: float) -> float:
    """The smallest real score whose scramble-estimated FDR is <= ``error``."""
    real = np.sort(np.asarray(real, np.float64))
    scrambled = np.sort(np.asarray(scrambled, np.float64))
    n = real.size
    denom = n - np.arange(1, n + 1, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        fdr = (scrambled.size - np.searchsorted(scrambled, real, side="right")) / denom
    ok = np.flatnonzero(fdr <= error)
    if ok.size == 0:
        raise ValueError("no score threshold achieves the requested error")
    return float(real[ok[0]])


def filter_mask(score1, score2, end1, end2, width, t1, t2):
    """(kept bool [n], trim start, trim end of the kept reads)."""
    score1, score2 = np.asarray(score1), np.asarray(score2)
    keep = (score1 >= t1) & (score2 >= t2)
    start = np.where(score1 >= t1, np.asarray(end1, np.int64) + 1, 1)
    stop = np.where(score2 >= t2, np.asarray(end2, np.int64) - 1, np.asarray(width, np.int64))
    keep &= start < stop
    return keep, start[keep], stop[keep]


def mad_thresholds(score, gap, nmads: float):
    def one(x):
        x = np.asarray(x, np.float64)
        med = float(np.median(x))
        return med - 1.4826 * float(np.median(np.abs(x - med))) * nmads

    return one(score), one(gap)


def best_two(stack):
    """(best index, best score, gap to the runner-up) over axis 0 of
    ``stack`` [B, n]."""
    stack = np.asarray(stack, np.float64)
    best = np.argmax(stack, axis=0)
    top = stack[best, np.arange(stack.shape[1])]
    rest = stack.copy()
    rest[best, np.arange(stack.shape[1])] = -np.inf
    return best, top, top - rest.max(axis=0)

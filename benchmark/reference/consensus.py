"""Plain NumPy reference of ``consensus_read_seq``'s quality mode
(upstream ``src/create_consensus.cpp:178-272``), vectorised over columns.

Per column and base, natural-log probabilities summed over the rows in row
order: ``log(eps / 3)`` to every base, then ``log1p(-eps) - log(eps / 3)``
to the observed one, with ``eps`` clamped to [1e-8, 0.99999999]; columns
kept where at least ``min_cov`` of the rows hold a base; the first maximum
wins; the error is ``logsumexp(all but the best) - logsumexp(all)`` by the
C++'s sorted ``log1pexp`` accumulation; Phred+33 by ``std::round``, capped
at 93.  ``rnd`` rounds every arithmetic result, as in :mod:`.align`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["consensus", "edit_distance"]

MAX_ERROR = 0.99999999
MIN_ERROR = 0.00000001
_CODE = np.full(256, 4, np.int8)
for _i, _b in enumerate("ACGT-"):
    _CODE[ord(_b)] = _i


def _log1pexp(x, f):
    out = np.where(x <= -37.0, np.exp(np.minimum(x, -37.0)), 0.0)
    mid = (x > -37.0) & (x <= 18.0)
    out = np.where(mid, np.log1p(np.exp(np.clip(x, -37.0, 18.0))), out)
    hi = (x > 18.0) & (x <= 33.3)
    out = np.where(hi, x + np.exp(-np.clip(x, 18.0, 33.3)), out)
    return f(np.where(x > 33.3, x, out).astype(x.dtype))


def consensus(rows: list[str], quals: list[str], min_cov=0.6, offset=33, rnd=None):
    """(consensus bases, Phred+33 qualities, each column's lead of the best
    base over the second) of one group's MSA ``rows`` and its reads'
    de-gapped ``quals``.  A lead of zero is a tie, which the sums' order
    decides."""
    f = (lambda v: v) if rnd is None else rnd
    dt = np.float64 if rnd is None else np.float32
    g = len(rows)
    raw = np.frombuffer("".join(rows).encode(), np.uint8).reshape(g, -1)
    codes = _CODE[raw]
    w = codes.shape[1]
    nongap = codes != 4
    scores = np.zeros((w, 4), dt)
    for r in range(g):
        q = np.frombuffer(quals[r].encode(), np.uint8).astype(np.int64) - offset
        if q.size != int(nongap[r].sum()):
            raise ValueError("quality and alignment lengths differ")
        eps = np.clip(10.0 ** (-q / 10.0), MIN_ERROR, MAX_ERROR)
        right, wrong = f(np.log1p(-eps).astype(dt)), f(np.log(eps / 3.0).astype(dt))
        cols = np.flatnonzero(nongap[r])
        scores[cols] = f(scores[cols] + wrong[:, None])
        b = codes[r, cols].astype(np.int64)
        scores[cols, b] = f(scores[cols, b] + f(right - wrong))
    keep = nongap.sum(0) >= g * min_cov
    sc = scores[keep]
    best = np.argmax(sc, axis=1)
    vals = np.sort(sc, axis=1)
    margin = (vals[:, 3] - vals[:, 2]).astype(np.float64)
    denom = vals[:, 0]
    err = np.zeros_like(denom)
    for k in range(1, 4):
        denom = f(denom + _log1pexp(f(vals[:, k] - denom), f))
        if k == 2:
            err = denom
    e = f(err - denom).astype(np.float64)
    phred = np.minimum(np.floor(-10.0 * e / np.log(10.0) + 0.5), 93.0).astype(np.int64)
    seq = np.frombuffer(b"ACGT", np.uint8)[best].tobytes().decode()
    return seq, (phred + 33).astype(np.uint8).tobytes().decode(), margin


def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Levenshtein distance of two code arrays, a row of the DP at a time
    (the insertion chain of a row as a running minimum)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    prev = np.arange(b.size + 1, dtype=np.int64)
    j = np.arange(b.size + 1, dtype=np.int64)
    for i in range(1, a.size + 1):
        t = np.empty_like(prev)
        t[0] = i
        t[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]))
        prev = np.minimum.accumulate(t - j) + j
    return int(prev[-1])

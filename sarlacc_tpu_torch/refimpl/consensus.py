"""Oracle consensus calling, mirroring ``src/create_consensus.cpp`` exactly.

Both modes operate on equal-width gapped MSA strings:

* **basic** (create_consensus.cpp:61-135): per-column A/C/G/T counts with a
  separate incidence count ('-' excluded, 'N' counted as present only);
  columns kept iff incidences >= naligns * min_cov; consensus base is the
  first max count; error prob = log1p(-(max + pseudo/4) / (total + pseudo)).

* **quality** (create_consensus.cpp:178-272): per-column per-base natural-log
  probability sums with right = log1p(-eps), wrong = log(eps/3), eps clamped
  to [1e-8, 0.99999999]; consensus base is the first argmax; error =
  logsumexp(non-max) - logsumexp(all), evaluated by sorting the four values
  ascending and accumulating log1pexp increments exactly as the C++ does.

Qualities index into the *de-gapped* read positions; mismatched lengths raise
the same errors as the reference.

Copied unchanged from ``sarlacc_tpu/refimpl/consensus.py`` (numpy only, no JAX).
"""

from __future__ import annotations

import math

import numpy as np

from ..core.quality import QualityEncoding

__all__ = ["consensus_basic", "consensus_quality", "log1pexp"]

MAX_ERROR = 0.99999999
MIN_ERROR = 0.00000001
BASES = "ACGT"


def log1pexp(x: float) -> float:
    """R's log1pexp: numerically careful log(1 + exp(x))."""
    if x <= -37.0:
        return math.exp(x)
    if x <= 18.0:
        return math.log1p(math.exp(x))
    if x <= 33.3:
        return x + math.exp(-x)
    return x


def _check_width(alignments: list[str]) -> int:
    if not alignments:
        raise ValueError("alignment set must be non-empty")
    width = len(alignments[0])
    for a in alignments:
        if len(a) != width:
            raise ValueError("alignment strings should have equal width")
    return width


def consensus_basic(alignments: list[str], min_cov: float, pseudo_count: float):
    """Returns (consensus str, per-position ln error probs)."""
    naligns = len(alignments)
    width = _check_width(alignments)
    pseudo_num = pseudo_count / 4.0

    counts = np.zeros((width, 4), dtype=np.float64)
    incidences = np.zeros(width, dtype=np.int64)

    for aln in alignments:
        for i, ch in enumerate(aln):
            if ch == "-":
                continue
            incidences[i] += 1
            if ch == "N":
                continue
            b = BASES.find(ch)
            if b < 0:
                raise ValueError(f"unknown character '{ch}' in alignment string")
            counts[i, b] += 1

    cons: list[str] = []
    errs: list[float] = []
    for i in range(width):
        if incidences[i] < naligns * min_cov:
            continue
        b = int(np.argmax(counts[i]))  # first max, like std::max_element
        cons.append(BASES[b])
        total = counts[i].sum()
        correct_prob = (counts[i, b] + pseudo_num) / (total + pseudo_count)
        errs.append(math.log1p(-correct_prob))
    return "".join(cons), np.array(errs, dtype=np.float64)


def consensus_quality(
    alignments: list[str],
    min_cov: float,
    qualities: list[str],
    encoding: QualityEncoding,
):
    """Returns (consensus str, per-position ln error probs)."""
    naligns = len(alignments)
    width = _check_width(alignments)
    if len(qualities) != naligns:
        raise ValueError("alignments and qualities have different numbers of entries")

    scores = np.zeros((width, 4), dtype=np.float64)
    incidences = np.zeros(width, dtype=np.int64)

    for aln, qual in zip(alignments, qualities):
        position = 0
        qlen = len(qual)
        for i, ch in enumerate(aln):
            if ch == "-":
                continue
            incidences[i] += 1
            if position >= qlen:
                raise ValueError("quality vector is shorter than the alignment sequence")
            if ch == "N":
                position += 1
                continue
            eps = float(encoding.to_error(np.array([ord(qual[position])]))[0])
            eps = min(max(eps, MIN_ERROR), MAX_ERROR)
            right = math.log1p(-eps)
            wrong = math.log(eps / 3.0)
            position += 1
            # NB: unlike the basic mode, the quality mode never rejects odd
            # characters — an unknown char simply scores `wrong` against every
            # base (create_consensus.cpp:229-232).
            scores[i] += wrong
            b = BASES.find(ch)
            if b >= 0:
                scores[i, b] += right - wrong
        if position != qlen:
            raise ValueError("quality vector is longer than the alignment sequence")

    cons: list[str] = []
    errs: list[float] = []
    for i in range(width):
        if incidences[i] < naligns * min_cov:
            continue
        b = int(np.argmax(scores[i]))  # first max
        cons.append(BASES[b])

        vals = np.sort(scores[i])  # ascending, like std::sort
        denom = float(vals[0])
        error = 0.0
        for k in range(1, 4):
            denom += log1pexp(float(vals[k]) - denom)
            if k == 2:
                error = denom
        errs.append(error - denom)
    return "".join(cons), np.array(errs, dtype=np.float64)

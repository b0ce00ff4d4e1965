"""The true alignment of a group of reads, and how far an MSA departs from it.

The generator records, for every read base, the template base it copies
(``Reads.origin``).  Two read bases belong in one column of the true
alignment where they copy the same template base.  A homopolymer run of the
template is taken as one unit: an indel inside a run can sit at any of its
bases with the same score, so bases that copy one run may share a column.

:func:`column_pairs` gives the sum-of-pairs measure of MSA accuracy against a
reference alignment: of all pairs of bases that an MSA puts in one column,
the share that copy different runs of the template.  Plain numpy; it reads the program's MSA rows only to
judge them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["run_ids", "row_runs", "column_pairs"]


def run_ids(templates: np.ndarray, template_off: np.ndarray) -> np.ndarray:
    """int64 [T]: the homopolymer run of every template base, numbered over
    all templates (a run never spans two templates)."""
    t = np.asarray(templates)
    new = np.ones(t.size, bool)
    new[1:] = t[1:] != t[:-1]
    new[np.asarray(template_off[:-1], np.int64)] = True
    return np.cumsum(new) - 1


def row_runs(row: str, origin: np.ndarray, reversed_: bool, runs: np.ndarray) -> np.ndarray:
    """int64 [len(row)]: the template run each base of one MSA row copies,
    -1 at a gap.  ``origin`` holds the read's bases' template indices as the
    read was sequenced; ``reversed_`` says whether the row holds it reverse
    complemented."""
    r = np.frombuffer(row.encode(), np.uint8)
    out = np.full(r.size, -1, np.int64)
    base = np.flatnonzero(r != ord("-"))
    src = origin[::-1] if reversed_ else origin
    out[base] = runs[src[:base.size]]
    return out


def column_pairs(cols: np.ndarray) -> tuple[int, int]:
    """(pairs of bases in one column that copy different runs, all pairs of
    bases in one column) of an MSA given as int64 [rows, width] runs, -1 at
    gaps."""
    cols = np.asarray(cols, np.int64)
    base = cols >= 0
    per_col = base.sum(0)
    total = int((per_col * (per_col - 1) // 2).sum())
    wrong = 0
    for i in range(cols.shape[0] - 1):
        wrong += int((base[i] & base[i + 1:] & (cols[i + 1:] != cols[i])).sum())
    return wrong, total

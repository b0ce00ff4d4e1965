"""Per-position error profiling over pairwise alignments (src/find_errors.cpp).

Host-side walk; this module is both the oracle and the production
implementation.  The first alignment's reference string defines the de-gapped
reference (find_errors.cpp:20-42); substitutions/deletions are tallied per
reference position and insertions recorded as (position-of-next-ref-base,
length) pairs, where the position may be one past the end.

Copied unchanged from ``sarlacc_tpu/refimpl/errors.py`` (numpy only, no JAX).
"""

from __future__ import annotations

import numpy as np

__all__ = ["find_errors"]


def find_errors(ref_align: list[str], read_align: list[str]):
    """Returns dict with keys base, A, C, G, T, deletion, insertion_pos, insertion_len.

    Positions in ``insertion_pos`` are 0-based de-gapped reference indices
    (the R layer adds 1; find_errors.cpp:114-116).
    """
    if len(ref_align) != len(read_align):
        raise ValueError("lengths of alignment vectors should match up")

    standard_len = 0
    bases: list[str] = []
    if ref_align:
        for ch in ref_align[0]:
            if ch != "-":
                standard_len += 1
                bases.append(ch)

    to = {b: np.zeros(standard_len, dtype=np.int64) for b in "ACGT"}
    deletions = np.zeros(standard_len, dtype=np.int64)
    insertion_pos: list[int] = []
    insertion_len: list[int] = []

    for refstr, readstr in zip(ref_align, read_align):
        if len(refstr) != len(readstr):
            raise ValueError("read and reference alignment strings should have equal length")
        if not refstr:
            continue
        cur_pos = 0
        nonbases = 0
        reflen = len(refstr)
        while cur_pos < reflen:
            ref_base = refstr[cur_pos]
            read_base = readstr[cur_pos]
            if ref_base != "-":
                true_pos = cur_pos - nonbases
                if true_pos >= standard_len:
                    raise ValueError("reference sequence should be the same for all alignments")
                if read_base == "-":
                    deletions[true_pos] += 1
                elif read_base in to:
                    to[read_base][true_pos] += 1
                else:
                    raise ValueError(
                        f"unknown character '{read_base}' in alignment string"
                    )
                cur_pos += 1
            else:
                previous = cur_pos
                cur_pos += 1
                nonbases += 1
                while cur_pos < reflen and refstr[cur_pos] == "-":
                    cur_pos += 1
                    nonbases += 1
                insertion_pos.append(cur_pos - nonbases)
                insertion_len.append(cur_pos - previous)

    return {
        "base": bases,
        "A": to["A"],
        "C": to["C"],
        "G": to["G"],
        "T": to["T"],
        "deletion": deletions,
        "insertion_pos": np.array(insertion_pos, dtype=np.int64),
        "insertion_len": np.array(insertion_len, dtype=np.int64),
    }

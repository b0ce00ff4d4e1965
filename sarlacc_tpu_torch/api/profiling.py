"""Error/homopolymer profiling — ``error_finder``, ``homopolymer_finder``,
``homopolymer_matcher``.

Parity with R/errorFinder.R + src/find_errors.cpp and
R/homopolymerFinder.R / R/homopolymerMatcher.R + src/homopolymer.cpp.  These
are cheap host-side RLE walks over pairwise alignment strings (the heavy
alignment itself comes from :func:`.quality_align`).

Copied unchanged from ``sarlacc_tpu/api/profiling.py`` (numpy only, no JAX).
"""

from __future__ import annotations

import numpy as np

from ..core.frame import Frame
from ..refimpl.errors import find_errors
from ..refimpl.homopolymer import find_homopolymers, match_homopolymers

__all__ = ["error_finder", "homopolymer_finder", "homopolymer_matcher"]

_BASE_ORDER = "ACGT"


def _extract_alignment_strings(alignments) -> tuple[list[str], list[str]]:
    """Accepts a Frame with reference/query columns (quality_align output)
    or a pair of string lists."""
    if isinstance(alignments, Frame):
        if "reference" not in alignments or "query" not in alignments:
            raise ValueError(
                "alignments must carry 'reference' and 'query' strings; "
                "run quality_align with edit_only=False"
            )
        return list(alignments["reference"]), list(alignments["query"])
    ref, qry = alignments
    return list(ref), list(qry)


def error_finder(alignments) -> Frame:
    """Per-reference-position substitution/deletion/insertion profile.

    Returns a Frame with one row per de-gapped reference position **plus a
    one-past-the-end row** (R/errorFinder.R:20-38) holding base identity,
    A/C/G/T/deletion counts, and per-row insertion length lists; metadata
    carries the 4x4 ``transition`` matrix (base -> observed counts,
    R/errorFinder.R:39-44).
    """
    ref_align, read_align = _extract_alignment_strings(alignments)
    res = find_errors(ref_align, read_align)

    npos = len(res["base"])
    # One-past-end row for insertions at the end of the reference.
    base = list(res["base"]) + [""]
    cols = {"base": base}
    for b in _BASE_ORDER:
        cols[b] = np.concatenate([res[b], [0]]).astype(np.int64)
    cols["deletion"] = np.concatenate([res["deletion"], [0]]).astype(np.int64)

    insertions: list[list[int]] = [[] for _ in range(npos + 1)]
    for pos, ln in zip(res["insertion_pos"], res["insertion_len"]):
        insertions[int(pos)].append(int(ln))
    cols["insertion"] = insertions

    out = Frame(cols)

    # Transition matrix: true base (rows) x observed base (columns).
    trans = np.zeros((4, 4), dtype=np.int64)
    for i, b in enumerate(res["base"]):
        r = _BASE_ORDER.find(b)
        if r >= 0:
            for c, ob in enumerate(_BASE_ORDER):
                trans[r, c] += res[ob][i]
    out.metadata["transition"] = trans
    return out


def homopolymer_finder(seqs) -> list[Frame]:
    """Per sequence, runs of length >= 2 with 1-based de-gapped start/width/base."""
    if hasattr(seqs, "seq_strings"):
        strs = seqs.seq_strings()
    else:
        strs = list(seqs)
    idx, pos, size, base = find_homopolymers(strs)
    out = []
    for i in range(len(strs)):
        sel = [k for k, s in enumerate(idx) if s == i]
        out.append(
            Frame(
                start=np.asarray([pos[k] for k in sel], dtype=np.int64),
                width=np.asarray([size[k] for k in sel], dtype=np.int64),
                base=[base[k] for k in sel],
            )
        )
    return out


def homopolymer_matcher(alignments) -> Frame:
    """Reference homopolymers with observed per-read run lengths.

    Returns one row per reference homopolymer occurrence over all reads:
    start position (1-based, de-gapped), and the sorted observed lengths
    aggregated per position in metadata-free columns
    (R/homopolymerMatcher.R:19-34 collapses to unique positions with an
    observed-length list; we do the same).
    """
    ref_align, read_align = _extract_alignment_strings(alignments)
    idx, pos, rlen = match_homopolymers(ref_align, read_align)

    # Unique reference runs keyed by (start position); base/width from the
    # first alignment's reference.
    uniq = sorted(set(pos))
    observed: dict[int, list[int]] = {p: [] for p in uniq}
    for p, l in zip(pos, rlen):
        observed[p].append(int(l))
    for p in uniq:
        observed[p].sort()

    # Base and width from the de-gapped reference of the first alignment.
    bases, widths = {}, {}
    if ref_align:
        degapped = ref_align[0].replace("-", "")
        at = 0
        while at < len(degapped):
            run = at
            while run < len(degapped) and degapped[run] == degapped[at]:
                run += 1
            if run - at >= 2:
                bases[at + 1] = degapped[at]
                widths[at + 1] = run - at
            at = run

    return Frame(
        start=np.asarray(uniq, dtype=np.int64),
        width=np.asarray([widths.get(p, 0) for p in uniq], dtype=np.int64),
        base=[bases.get(p, "") for p in uniq],
        observed=[observed[p] for p in uniq],
    )

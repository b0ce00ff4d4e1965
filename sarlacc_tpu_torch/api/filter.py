"""``filter_reads`` / ``realize_reads`` — adaptor-based filtering and read
materialization (R/filterReads.R, R/realizeReads.R — both host logic).

Counterpart of ``sarlacc_tpu/api/filter.py``.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..device import resolve_device
from ..io.fastq import stream_fastq

__all__ = ["filter_reads", "realize_reads"]


def filter_reads(
    aligned: Frame,
    score1: float,
    score2: float,
    essential1: bool = True,
    essential2: bool = True,
    device=None,
) -> Frame:
    """Keep reads whose essential adaptors hit; add trim.start/trim.end.

    Mirrors R/filterReads.R:11-41, including dropping reads whose adaptors
    overlap (trim interval empty).  Host work; ``device`` is checked like
    every entry point's.
    """
    resolve_device(device)
    n = len(aligned)
    s1 = np.asarray(aligned["adaptor1"]["score"])
    s2 = np.asarray(aligned["adaptor2"]["score"])

    id1 = s1 >= score1 if essential1 else np.ones(n, bool)
    id2 = s2 >= score2 if essential2 else np.ones(n, bool)
    aligned = aligned.take(id1 & id2)

    m = len(aligned)
    start_point = np.ones(m, dtype=np.int64)
    has1 = np.asarray(aligned["adaptor1"]["score"]) >= score1
    start_point[has1] = np.asarray(aligned["adaptor1"]["end"], dtype=np.int64)[has1] + 1

    end_point = np.asarray(aligned["read.width"], dtype=np.int64).copy()
    has2 = np.asarray(aligned["adaptor2"]["score"]) >= score2
    end_point[has2] = np.asarray(aligned["adaptor2"]["end"], dtype=np.int64)[has2] - 1

    keep = start_point < end_point
    out = aligned.take(keep)
    out["trim.start"] = start_point[keep].astype(np.int32)
    out["trim.end"] = end_point[keep].astype(np.int32)
    return out


def realize_reads(
    aligned: Frame,
    number: int = 100_000,
    trim: bool = True,
    reads: SeqBatch | None = None,
    device=None,
) -> SeqBatch:
    """Materialize canonical-orientation (optionally trimmed) reads.

    Re-streams the FASTQ named in ``aligned``'s metadata (or uses ``reads``),
    selects/reorders by rownames, reverse-complements the ``reversed`` rows,
    and trims to [trim.start, trim.end] (R/realizeReads.R:8-45).  All host
    work; ``device`` is checked like every entry point's.
    """
    resolve_device(device)
    if reads is None:
        filepath = aligned.metadata.get("filepath")
        if filepath is None:
            raise ValueError("aligned frame metadata carries no filepath")
        wanted = set(aligned.rownames or [])
        parts = []
        for chunk in stream_fastq(filepath, chunk_size=number):
            keep = [i for i, nm in enumerate(chunk.names or []) if nm in wanted]
            if keep:
                parts.append(chunk.take(np.asarray(keep)))
        reads = SeqBatch.concat(parts)

    name_to_idx = {nm: i for i, nm in enumerate(reads.names or [])}
    try:
        order = np.asarray([name_to_idx[nm] for nm in (aligned.rownames or [])])
    except KeyError:
        raise ValueError("read names in 'aligned' not present in FASTQ file")
    reads = reads.take(order)

    reversed_ = np.asarray(aligned["reversed"], dtype=bool)
    if reversed_.any():
        rc = reads.take(np.flatnonzero(reversed_)).reverse_complement()
        codes = reads.codes.copy()
        quals = reads.quals.copy() if reads.quals is not None else None
        codes[reversed_] = rc.codes
        if quals is not None:
            quals[reversed_] = rc.quals
        reads = SeqBatch(codes, reads.lengths.copy(), quals, reads.names)

    if trim:
        if "trim.start" in aligned:
            reads = reads.subseq(
                np.asarray(aligned["trim.start"], dtype=np.int64),
                np.asarray(aligned["trim.end"], dtype=np.int64),
            )
        else:
            warnings.warn("no 'trim.start' detected, run 'filter_reads' first")
    return reads

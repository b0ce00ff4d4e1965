"""``realize_reads`` — read materialization (R/realizeReads.R, host logic).

Counterpart of ``sarlacc_tpu/api/filter.py::realize_reads``.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..device import resolve_device
from ..io.fastq import stream_fastq

__all__ = ["realize_reads"]


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

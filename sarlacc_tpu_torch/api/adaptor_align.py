"""``adaptor_align`` — align both adaptors to every read, canonical orientation.

Counterpart of ``sarlacc_tpu/api/adaptor_align.py`` (R/adaptorAlign.R:7-77):
reads stream in chunks of ``number // 2``; per chunk the first/last
``tolerance`` bases (back reverse-complemented) are aligned against adaptor1
and adaptor2 in both orientations — one kernel-A launch per adaptor on the
stacked front+back batch — the strand is resolved by clamped combined
score, rows swap into canonical orientation, and adaptor2 coordinates flip
onto the forward strand.  Every read is aligned independently, so the
output does not depend on the chunk size.
"""

from __future__ import annotations

import numpy as np

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..device import resolve_device
from ..io.fastq import stream_fastq
from .align_internal import align_and_extract, prepare_adaptor, resolve_strand

__all__ = ["adaptor_align"]

QUAL_TYPES = ("phred", "solexa", "illumina")


def adaptor_align(
    adaptor1: str,
    adaptor2: str,
    filepath: str | None = None,
    reads: SeqBatch | None = None,
    tolerance: int = 250,
    gap_opening: float = 5,
    gap_extension: float = 1,
    qual_type: str = "phred",
    number: int = 100_000,
    device=None,
) -> Frame:
    """Align adaptors to read ends and standardize read orientation.

    Either ``filepath`` (streamed, R/adaptorAlign.R:26-36) or an in-memory
    ``reads`` batch must be given.  ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    if qual_type not in QUAL_TYPES:
        raise ValueError(f"qual_type must be one of {QUAL_TYPES}")
    adaptor1 = adaptor1.upper()
    adaptor2 = adaptor2.upper()
    a1 = prepare_adaptor(adaptor1, qual_type, device=dev)
    a2 = prepare_adaptor(adaptor2, qual_type, device=dev)

    if (filepath is None) == (reads is None):
        raise ValueError("exactly one of filepath or reads must be supplied")

    # Each chunk launches on the stacked front+back batch (2x the chunk),
    # so chunks hold number // 2 reads to keep launches `number` wide.
    stride = max(1, number // 2)
    if reads is not None and len(reads) <= stride:
        chunks = [reads]
    elif reads is not None:
        chunks = (
            reads.take(np.arange(c0, min(c0 + stride, len(reads))))
            for c0 in range(0, len(reads), stride)
        )
    else:
        chunks = stream_fastq(filepath, chunk_size=stride)

    starts_parts: list[Frame] = []
    ends_parts: list[Frame] = []
    rev_parts: list[np.ndarray] = []
    width_parts: list[np.ndarray] = []
    names: list[str] = []

    nchunks = 0
    for batch in chunks:
        nchunks += 1
        front, back = batch.front_and_back(tolerance)
        nb = len(batch)

        # Both orientations of one adaptor share the reference: ONE launch.
        res1 = align_and_extract(
            a1, SeqBatch.concat([front, back]), gap_opening, gap_extension
        )
        res2 = align_and_extract(
            a2, SeqBatch.concat([back, front]), gap_opening, gap_extension
        )
        lo = np.arange(nb)
        hi = np.arange(nb, 2 * nb)
        cur_starts = res1.take(lo)
        cur_rc_starts = res1.take(hi)
        cur_ends = res2.take(lo)
        cur_rc_ends = res2.take(hi)

        is_reverse, _ = resolve_strand(
            cur_starts["score"],
            cur_ends["score"],
            cur_rc_starts["score"],
            cur_rc_ends["score"],
        )
        ridx = np.flatnonzero(is_reverse)
        fidx = np.flatnonzero(~is_reverse)
        order = np.argsort(np.concatenate([fidx, ridx]), kind="stable")
        if len(ridx):
            cur_starts = Frame.rbind(
                [cur_starts.take(fidx), cur_rc_starts.take(ridx)]
            ).take(order)
            cur_ends = Frame.rbind(
                [cur_ends.take(fidx), cur_rc_ends.take(ridx)]
            ).take(order)

        starts_parts.append(cur_starts)
        ends_parts.append(cur_ends)
        rev_parts.append(is_reverse)
        width_parts.append(batch.lengths.astype(np.int64))
        names.extend(batch.names or [f"read_{len(names) + i + 1}" for i in range(len(batch))])

    if nchunks == 0:
        empty = SeqBatch.from_strings([], [])
        return adaptor_align(
            adaptor1,
            adaptor2,
            reads=empty,
            tolerance=tolerance,
            gap_opening=gap_opening,
            gap_extension=gap_extension,
            qual_type=qual_type,
            device=dev,
        )

    align_start = Frame.rbind(starts_parts)
    align_end = Frame.rbind(ends_parts)
    widths = np.concatenate(width_parts)
    reversed_ = np.concatenate(rev_parts)

    details = {"gapOpening": gap_opening, "gapExtension": gap_extension}
    align_start.metadata = {"sequence": adaptor1, **details}
    align_end.metadata = {"sequence": adaptor2, **details}

    # Adaptor2 coordinates onto the forward strand (R/adaptorAlign.R:66-71).
    old_start = align_end["start"].astype(np.int64)
    old_end = align_end["end"].astype(np.int64)
    align_end["start"] = (widths - old_start + 1).astype(np.int32)
    align_end["end"] = (widths - old_end + 1).astype(np.int32)

    return Frame(
        {
            "read.width": widths.astype(np.int32),
            "adaptor1": align_start,
            "adaptor2": align_end,
            "reversed": reversed_,
        },
        metadata={
            "filepath": filepath,
            "qual.type": qual_type,
            "tolerance": tolerance,
        },
        rownames=names,
    )

"""``extract_subseq`` — re-extract arbitrary adaptor-coordinate subsequences.

Counterpart of ``sarlacc_tpu/api/extract.py`` (R/extractSubseq.R): the
pipeline stores only coordinates, so arbitrary subsequences require
realignment, but only in the known orientation (half the work of
``adaptor_align``): one kernel-A launch per adaptor, or one a shard under
a ``mesh``.  Realigned scores are checked against the stored ones as a
consistency guard (:59-74).
"""

from __future__ import annotations

import numpy as np

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..parallel.context import mesh_device
from ..io.fastq import stream_fastq
from .align_internal import align_and_extract, prepare_adaptor

__all__ = ["extract_subseq"]


def _mix(a: SeqBatch, b: SeqBatch, flipped: np.ndarray) -> SeqBatch:
    """Rows of ``a``, with the ``flipped`` rows taken from ``b`` instead."""
    codes = a.codes.copy()
    lengths = a.lengths.copy()
    quals = a.quals.copy() if a.quals is not None else None
    if b.width > a.width:
        pad = np.full((len(a), b.width - a.width), 5, np.int8)
        codes = np.concatenate([codes, pad], axis=1)
        if quals is not None:
            quals = np.concatenate(
                [quals, np.zeros((len(a), b.width - a.width), np.uint8)], axis=1
            )
    codes[flipped, : b.width] = b.codes[flipped]
    codes[flipped, b.width :] = 5
    lengths[flipped] = b.lengths[flipped]
    if quals is not None:
        quals[flipped, : b.width] = b.quals[flipped]
    return SeqBatch(codes, lengths, quals, a.names)


def extract_subseq(
    aligned: Frame,
    subseq1: tuple[list[int], list[int]] | None = None,
    subseq2: tuple[list[int], list[int]] | None = None,
    number: int = 100_000,
    reads: SeqBatch | None = None,
    device=None,
    mesh=None,
) -> dict:
    """Extract adaptor-coordinate subsequences (1-based inclusive ranges).

    ``subseq1``/``subseq2`` are (starts, ends) lists of adaptor positions; at
    least one must be given.  Returns a dict with 'adaptor1' / 'adaptor2'
    Frames of extracted subsequence batches.  Raises ``ValueError`` when a
    realigned score differs from the stored one.  ``device=None`` means CUDA;
    a ``mesh`` splits the realignment's rows over its shards.
    """
    dev = mesh_device(mesh, device)
    if subseq1 is None and subseq2 is None:
        raise ValueError("at least one of subseq1 or subseq2 must be specified")

    meta = aligned.metadata
    qual_type = meta.get("qual.type", "phred")
    tolerance = meta["tolerance"]
    a1meta = aligned["adaptor1"].metadata
    a2meta = aligned["adaptor2"].metadata
    go = a1meta["gapOpening"]
    ge = a1meta["gapExtension"]

    if reads is None:
        filepath = meta.get("filepath")
        if filepath is None:
            raise ValueError("aligned frame metadata carries no filepath")
        parts = []
        wanted = set(aligned.rownames or [])
        for chunk in stream_fastq(filepath, chunk_size=number):
            keep = [i for i, nm in enumerate(chunk.names or []) if nm in wanted]
            if keep:
                parts.append(chunk.take(np.asarray(keep)))
        reads = SeqBatch.concat(parts)

    name_to_row = {nm: i for i, nm in enumerate(aligned.rownames or [])}
    m = np.asarray([name_to_row[nm] for nm in (reads.names or []) if nm in name_to_row])
    keep = np.asarray([i for i, nm in enumerate(reads.names or []) if nm in name_to_row])
    reads = reads.take(keep)

    # Known orientation: flipped reads have adaptor1 on the (RC'd) back.
    flipped = np.asarray(aligned["reversed"], dtype=bool)[m]
    front, back = reads.front_and_back(tolerance)
    actual_starts = _mix(front, back, flipped)
    actual_ends = _mix(back, front, flipped)

    output: dict[str, Frame] = {}
    for key, sections, batch, ameta, stored in (
        ("adaptor1", subseq1, actual_starts, a1meta, aligned["adaptor1"]),
        ("adaptor2", subseq2, actual_ends, a2meta, aligned["adaptor2"]),
    ):
        if sections is None:
            continue
        prep = prepare_adaptor(ameta["sequence"], qual_type, device=dev)
        prep.sec_starts = [int(s) for s in sections[0]]
        prep.sec_ends = [int(e) for e in sections[1]]
        res = align_and_extract(prep, batch, go, ge, mesh=mesh)
        stored_scores = np.asarray(stored["score"], dtype=np.float64)[m]
        if not np.allclose(res["score"], stored_scores, rtol=1.5e-8, atol=1.5e-8):
            raise ValueError(f"score mismatch from 'aligned' for {key}")
        output[key] = res["subseq"]
    return output

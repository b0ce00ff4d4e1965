"""Streaming FASTQ I/O.

TPU-native replacement for the reference's ShortRead usage: chunked streaming
(``FastqStreamer``, R/adaptorAlign.R:26-36) bounds memory for arbitrarily
large files, and reservoir sampling (``FastqSampler``,
R/tuneAlignment.R:21-23) backs the calibration paths.  Gzip transparently
supported by suffix.  Chunks come back as padded :class:`SeqBatch` tensors
ready for device kernels.

Copied unchanged from ``sarlacc_tpu/io/fastq.py`` (numpy only, no JAX).
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, Sequence

import numpy as np

from ..core.encode import SeqBatch

__all__ = [
    "stream_fastq",
    "read_fastq",
    "sample_fastq",
    "write_fastq",
    "count_fastq",
    "fastq_shard_range",
]


def _open(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _iter_records(path: str) -> Iterator[tuple[str, str, str]]:
    """Yields (name, sequence, quality)."""
    with _open(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            header = header.rstrip("\n")
            if not header:
                continue
            if not header.startswith("@"):
                raise ValueError(f"malformed FASTQ header line: {header!r}")
            seq = fh.readline().rstrip("\n")
            plus = fh.readline()
            if not plus.startswith("+"):
                raise ValueError("malformed FASTQ record: missing '+' line")
            qual = fh.readline().rstrip("\n")
            if len(qual) != len(seq):
                raise ValueError("FASTQ quality and sequence lengths differ")
            yield header[1:].split()[0] if header[1:] else "", seq, qual


def _batch_from_bytes(buf: bytes, pad_to: int | None = None) -> SeqBatch:
    """Vectorized FASTQ block -> SeqBatch (no per-line Python loop).

    The block must contain complete 4-line records.
    """
    from ..core.encode import GAP_CODE, _ENC

    arr = np.frombuffer(buf, dtype=np.uint8)
    if arr.size == 0:
        return SeqBatch.from_strings([], [], [])
    nl = np.flatnonzero(arr == 10)
    if arr[-1] != 10:
        nl = np.concatenate([nl, [arr.size]])
    nlines = nl.size
    if arr[0] != ord("@"):
        raise ValueError(f"malformed FASTQ header line: {buf[:int(nl[0])]!r}")
    if nlines % 4:
        raise ValueError("malformed FASTQ: record truncated")
    line_starts = np.concatenate([[0], nl[:-1] + 1])
    line_ends = nl.copy()
    # Tolerate \r\n.
    crlf = (line_ends > line_starts) & (arr[np.minimum(line_ends - 1, arr.size - 1)] == 13)
    line_ends = line_ends - crlf

    n = nlines // 4
    hs, ss, ps, qs = (line_starts[k::4] for k in range(4))
    he, se, _, qe = (line_ends[k::4] for k in range(4))
    if n and (arr[hs] != ord("@")).any():
        raise ValueError("malformed FASTQ header line")
    if n and (arr[ps] != ord("+")).any():
        raise ValueError("malformed FASTQ record: missing '+' line")
    seq_lens = (se - ss).astype(np.int64)
    qual_lens = (qe - qs).astype(np.int64)
    if (seq_lens != qual_lens).any():
        raise ValueError("FASTQ quality and sequence lengths differ")

    width = int(pad_to if pad_to is not None else (seq_lens.max() if n else 0))
    codes = np.full((n, width), GAP_CODE, dtype=np.int8)
    quals = np.zeros((n, width), dtype=np.uint8)
    total = int(seq_lens.sum())
    if total:
        rows = np.repeat(np.arange(n), seq_lens)
        cols = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(seq_lens)[:-1]]), seq_lens
        )
        src_seq = np.repeat(ss, seq_lens) + cols
        src_qual = np.repeat(qs, seq_lens) + cols
        enc = _ENC[arr[src_seq]]
        if enc.min(initial=0) < 0:
            bad = chr(int(arr[src_seq][np.argmin(enc)]))
            raise ValueError(f"unrecognised base {bad!r} in sequence")
        codes[rows, cols] = enc
        quals[rows, cols] = arr[src_qual]

    mv = memoryview(buf)
    names = [
        bytes(mv[int(s) + 1 : int(e)]).split()[0].decode() if e > s + 1 else ""
        for s, e in zip(hs, he)
    ]
    return SeqBatch(codes, seq_lens.astype(np.int32), quals, names)


def read_fastq(path: str, pad_to: int | None = None) -> SeqBatch:
    """Read an entire FASTQ into one batch (vectorized parser)."""
    with _open(path, "rb") as fh:
        buf = fh.read()
    return _batch_from_bytes(buf, pad_to=pad_to)


_SEQ_BYTES = frozenset(b"ACGTNUMRWSYKVHDBacgtnumrwsykvhdb.-")


def _is_record_start(lines: list[bytes], k: int) -> bool:
    """True if ``lines[k]`` begins a FASTQ record.

    A quality line can itself start with ``@`` (Phred 31), so the header
    test alone is ambiguous; require the full 4-line shape: header ``@``,
    plausible sequence characters, ``+`` separator, equal-length quality.
    """
    if k + 3 >= len(lines):
        return False
    l0, l1, l2, l3 = lines[k : k + 4]
    if not l0.startswith(b"@") or not l2.startswith(b"+"):
        return False
    if len(l3.rstrip(b"\r")) != len(l1.rstrip(b"\r")):
        return False
    return all(c in _SEQ_BYTES for c in l1.rstrip(b"\r"))


def _resolve_record_start(fh, nominal: int, size: int, window: int = 1 << 20) -> int:
    """First record-start byte offset >= the first line start at/after
    ``nominal``.  Pure function of ``nominal`` so adjacent shards computed
    independently tile the file exactly (SURVEY.md §7.2(5): per-host FASTQ
    shard ranges)."""
    if nominal <= 0:
        return 0
    if nominal >= size:
        return size
    at = nominal - 1
    fh.seek(at)
    buf = fh.read(min(window, size - at))
    while b"\n" not in buf[: len(buf) - 1] and at + len(buf) < size:
        buf += fh.read(window)
    # Line starts within the buffer (absolute offsets).
    if buf[:1] == b"\n":
        first = at + 1
    else:
        nlpos = buf.find(b"\n")
        if nlpos == -1:
            return size
        first = at + nlpos + 1
    while True:
        rel = first - at
        lines = buf[rel:].split(b"\n")
        for k in range(min(len(lines) - 3, 8)):
            if _is_record_start(lines, k):
                return first + sum(len(l) + 1 for l in lines[:k])
        if at + len(buf) >= size:
            return size
        buf += fh.read(window)


def fastq_shard_range(path: str, rank: int, nshards: int) -> tuple[int, int]:
    """Byte range [start, end) of host ``rank``'s contiguous shard.

    Each host resolves only its own boundaries (two seeks + small probes);
    the ranges tile the file, so the concatenation over ranks in rank order
    is byte-identical to the whole file.  Plain files only — gzip has no
    random access (use record striding or decompress first).
    """
    if str(path).endswith(".gz"):
        raise ValueError("byte-range sharding requires an uncompressed FASTQ")
    if not (0 <= rank < nshards):
        raise ValueError("rank must be in [0, nshards)")
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        start = _resolve_record_start(fh, size * rank // nshards, size)
        end = (
            size
            if rank == nshards - 1
            else _resolve_record_start(fh, size * (rank + 1) // nshards, size)
        )
    return start, end


def stream_fastq(
    path: str,
    chunk_size: int = 100_000,
    pad_to: int | None = None,
    shard: tuple[int, int] | None = None,
) -> Iterator[SeqBatch]:
    """Yield SeqBatch chunks of at most ``chunk_size`` reads.

    Reads byte blocks and splits on record boundaries, so parsing stays
    vectorized while memory is bounded by the chunk size.

    ``shard=(rank, nshards)`` streams only host ``rank``'s contiguous byte
    range (:func:`fastq_shard_range`) — the multi-host input path
    (SURVEY.md §7.2(5)): each host reads its slice of the file and the
    rank-ordered concatenation of shard streams reproduces the
    single-host stream record-for-record.
    """
    start, limit = 0, None
    if shard is not None:
        start, end = fastq_shard_range(path, int(shard[0]), int(shard[1]))
        limit = end - start
        if limit <= 0:
            return
    approx_bytes = 64 * 1024 * 1024
    with _open(path, "rb") as fh:
        if start:
            fh.seek(start)
        pending = b""
        got = 0
        while True:
            want = approx_bytes if limit is None else min(approx_bytes, limit - got)
            block = fh.read(want) if want > 0 else b""
            if not block:
                break
            got += len(block)
            pending += block
            # Find the last complete 4-line record boundary.
            count = pending.count(b"\n")
            keep_lines = (count // 4) * 4
            if keep_lines == 0:
                continue
            # Locate the byte offset after the keep_lines-th newline.
            arr = np.frombuffer(pending, dtype=np.uint8)
            nl = np.flatnonzero(arr == 10)
            cut = int(nl[keep_lines - 1]) + 1
            batch = _batch_from_bytes(pending[:cut])
            pending = pending[cut:]
            for at in range(0, len(batch), chunk_size):
                yield batch.take(
                    np.arange(at, min(at + chunk_size, len(batch)))
                )
        if pending.strip():
            batch = _batch_from_bytes(pending)
            for at in range(0, len(batch), chunk_size):
                yield batch.take(np.arange(at, min(at + chunk_size, len(batch))))


def sample_fastq(path: str, n: int, seed: int = 0) -> SeqBatch:
    """Uniform reservoir sample of ``n`` reads (FastqSampler equivalent)."""
    rng = np.random.default_rng(seed)
    reservoir: list[tuple[str, str, str]] = []
    for i, rec in enumerate(_iter_records(path)):
        if i < n:
            reservoir.append(rec)
        else:
            j = int(rng.integers(0, i + 1))
            if j < n:
                reservoir[j] = rec
    names = [r[0] for r in reservoir]
    seqs = [r[1] for r in reservoir]
    quals = [r[2] for r in reservoir]
    return SeqBatch.from_strings(seqs, quals, names)


def count_fastq(path: str) -> int:
    return sum(1 for _ in _iter_records(path))


def write_fastq(
    path: str,
    batch: SeqBatch | None = None,
    *,
    seqs: Sequence[str] | None = None,
    quals: Sequence[str] | None = None,
    names: Sequence[str] | None = None,
    append: bool = False,
) -> None:
    """Write reads to FASTQ (writeXStringSet equivalent)."""
    if batch is not None:
        seqs = batch.seq_strings()
        quals = batch.qual_strings()
        names = batch.names
    if seqs is None:
        raise ValueError("either batch or seqs must be given")
    if quals is None:
        raise ValueError("quality strings are required for FASTQ output")
    if names is None:
        names = [f"read_{i + 1}" for i in range(len(seqs))]
    mode = "at" if append else "wt"
    with _open(path, mode) as fh:
        for nm, sq, ql in zip(names, seqs, quals):
            fh.write(f"@{nm}\n{sq}\n+\n{ql}\n")

"""Base encodings and padded batch containers.

The TPU framework works on dense, padded integer tensors instead of the
reference's per-read C strings (``src/DNA_input.cpp``).  Bases are coded

    A=0  C=1  G=2  T=3  N=4  '-'=5

Padding uses code 5 with an explicit length vector; kernels mask with the
lengths, never with sentinel comparisons.

IUPAC degeneracy is only legal in *reference* strings (adaptors/barcodes),
matching ``reference_align.cpp:184-212``.  Each reference position is
described by a degeneracy ``mode`` (1, 2, 3 or 4) plus a 5-wide boolean
``matched`` row over the observed base — including the reference's quirk that
2-fold codes always score as mismatches and 3-fold codes always as matches
(the C++ compares *ref* rather than the observed base against the
constituents; see SURVEY.md §2 C1).

Numpy only, no JAX.  The same containers and codes as
``sarlacc_tpu/core/encode.py``, whose per-row loops the row-cutting methods
(``subseq``, ``front_and_back``, the reverse complements) replace with one
gather over the whole batch; their outputs are byte for byte the loops'.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

__all__ = [
    "BASES",
    "GAP_CODE",
    "N_CODE",
    "encode_seq",
    "decode_seq",
    "encode_batch",
    "decode_batch",
    "reverse_complement_codes",
    "SeqBatch",
    "iupac_reference",
]

BASES = "ACGTN-"
GAP_CODE = 5
N_CODE = 4

_ENC = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate(BASES):
    _ENC[ord(_b)] = _i
    _ENC[ord(_b.lower())] = _i

_DEC = np.frombuffer(BASES.encode(), dtype=np.uint8)


def encode_seq(seq: str) -> np.ndarray:
    raw = np.frombuffer(seq.encode(), dtype=np.uint8)
    codes = _ENC[raw]
    if codes.size and codes.min() < 0:
        bad = chr(int(raw[np.argmin(codes)]))
        raise ValueError(f"unrecognised base {bad!r} in sequence")
    return codes


def decode_seq(codes: np.ndarray, length: int | None = None) -> str:
    codes = np.asarray(codes, dtype=np.int8)
    if length is not None:
        codes = codes[:length]
    return _DEC[codes].tobytes().decode()


def encode_batch(seqs: Sequence[str], pad_to: int | None = None):
    """List of strings -> (codes int8 [N, L], lengths int32 [N])."""
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    width = int(pad_to if pad_to is not None else (lengths.max() if len(seqs) else 0))
    codes = np.full((len(seqs), width), GAP_CODE, dtype=np.int8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_seq(s)
    return codes, lengths


def decode_batch(codes: np.ndarray, lengths: np.ndarray) -> list[str]:
    return [decode_seq(c, int(l)) for c, l in zip(codes, lengths)]


def _row_windows(arr: np.ndarray, first: np.ndarray, width: int,
                 reverse: bool = False) -> np.ndarray:
    """Row ``i``'s ``width`` columns from ``first[i]`` up (``reverse``: down).

    One gather over the whole batch: the rows are read as one flat buffer
    through a sliding window, so a window may run past its row into the next
    or the previous one, and callers blank what lies past each row's length.
    A window that leaves the buffer itself (of a non-empty row, only the
    first row's reversed or the last row's forward) takes its columns through
    a clipped index instead.
    """
    rows, cols = arr.shape
    if rows == 0 or width == 0:
        return np.empty((rows, width), dtype=arr.dtype)
    flat = np.ascontiguousarray(arr).reshape(-1)
    lo = np.asarray(first, dtype=np.int64) - (width - 1 if reverse else 0)
    pos = np.arange(rows, dtype=np.int64) * cols + lo
    inside = np.clip(pos, 0, flat.size - width)
    windows = sliding_window_view(flat, width)
    out = (windows[:, ::-1] if reverse else windows)[inside]
    edge = np.flatnonzero(pos != inside)
    if edge.size:
        step = np.arange(width)
        cells = pos[edge, None] + (step[::-1] if reverse else step)
        out[edge] = np.take(flat, cells, mode="clip")
    return out


def _past(lengths: np.ndarray, width: int) -> np.ndarray:
    """Mask of the columns at or past each row's length."""
    return np.arange(width, dtype=np.int32) >= np.asarray(lengths, dtype=np.int32)[:, None]


def _complement(codes: np.ndarray) -> np.ndarray:
    """Complement in code space, A<->T, C<->G, N->N, '-'->'-', in two
    whole-array passes (a table lookup takes several times as long)."""
    out = 3 - codes
    np.copyto(out, codes, where=codes > 3)
    return out


def reverse_complement_codes(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Reverse-complement each row of a padded code matrix in place of its length."""
    codes = np.asarray(codes)
    lengths = np.asarray(lengths, dtype=np.int64)
    rc = _complement(_row_windows(codes, lengths - 1, codes.shape[1], reverse=True))
    rc[_past(lengths, rc.shape[1])] = GAP_CODE
    return rc


@dataclass
class SeqBatch:
    """A padded batch of (optionally quality-scaled) sequences.

    ``quals`` holds raw ASCII char codes (uint8); interpretation is deferred
    to a :class:`~sarlacc_tpu.core.quality.QualityEncoding`.
    """

    codes: np.ndarray  # int8 [N, L]
    lengths: np.ndarray  # int32 [N]
    quals: np.ndarray | None = None  # uint8 [N, L] or None
    names: list[str] | None = None

    @classmethod
    def from_strings(
        cls,
        seqs: Sequence[str],
        quals: Sequence[str] | None = None,
        names: Iterable[str] | None = None,
        pad_to: int | None = None,
    ) -> "SeqBatch":
        codes, lengths = encode_batch(seqs, pad_to=pad_to)
        qarr = None
        if quals is not None:
            if len(quals) != len(seqs):
                raise ValueError("sequence and quality vectors should have the same length")
            qarr = np.zeros(codes.shape, dtype=np.uint8)
            for i, q in enumerate(quals):
                if len(q) != lengths[i]:
                    raise ValueError(
                        "sequence and quality strings should have the same length"
                    )
                qarr[i, : len(q)] = np.frombuffer(q.encode(), dtype=np.uint8)
        return cls(codes, lengths, qarr, list(names) if names is not None else None)

    def __len__(self) -> int:
        return self.codes.shape[0]

    @property
    def width(self) -> int:
        return self.codes.shape[1]

    def seq_strings(self) -> list[str]:
        return decode_batch(self.codes, self.lengths)

    def qual_strings(self) -> list[str] | None:
        if self.quals is None:
            return None
        return [
            self.quals[i, : int(n)].tobytes().decode()
            for i, n in enumerate(self.lengths)
        ]

    @classmethod
    def concat(cls, batches: Sequence["SeqBatch"]) -> "SeqBatch":
        """Row-concatenate batches (re-padding to the widest)."""
        batches = list(batches)
        if not batches:
            return cls(np.zeros((0, 0), np.int8), np.zeros(0, np.int32))
        width = max(b.width for b in batches)
        total = sum(len(b) for b in batches)
        codes = np.full((total, width), GAP_CODE, dtype=np.int8)
        has_q = all(b.quals is not None for b in batches)
        quals = np.zeros((total, width), dtype=np.uint8) if has_q else None
        has_names = all(b.names is not None for b in batches)
        names: list[str] | None = [] if has_names else None
        lengths = np.concatenate([b.lengths for b in batches]).astype(np.int32)
        at = 0
        for b in batches:
            codes[at : at + len(b), : b.width] = b.codes
            if quals is not None:
                quals[at : at + len(b), : b.width] = b.quals
            if names is not None:
                names.extend(b.names)  # type: ignore[arg-type]
            at += len(b)
        return cls(codes, lengths, quals, names)

    def take(self, idx) -> "SeqBatch":
        idx = np.asarray(idx)
        return SeqBatch(
            self.codes[idx],
            self.lengths[idx],
            self.quals[idx] if self.quals is not None else None,
            [self.names[int(i)] for i in idx] if self.names is not None else None,
        )

    def reverse_complement(self) -> "SeqBatch":
        rc = reverse_complement_codes(self.codes, self.lengths)
        rq = None
        if self.quals is not None:
            last = self.lengths.astype(np.int64) - 1
            rq = _row_windows(self.quals, last, self.width, reverse=True)
            rq[_past(self.lengths, self.width)] = 0
        return SeqBatch(rc, self.lengths.copy(), rq, self.names)

    def subseq(self, starts: np.ndarray, ends: np.ndarray) -> "SeqBatch":
        """Per-row 1-based inclusive [start, end] slices (Biostrings subseq).

        A non-empty slice must lie inside its row's columns.
        """
        first = np.asarray(starts, dtype=np.int64) - 1
        ends = np.asarray(ends, dtype=np.int64)
        new_lens = np.maximum(ends - first, 0).astype(np.int32)
        width = int(new_lens.max()) if len(self) else 0
        if np.any((new_lens > 0) & ((first < 0) | (first + new_lens > self.width))):
            raise ValueError("a subsequence runs outside its read's columns")
        codes = _row_windows(self.codes, first, width).astype(np.int8, copy=False)
        quals = None
        if self.quals is not None:
            quals = _row_windows(self.quals, first, width).astype(np.uint8, copy=False)
        return SeqBatch(*_blanked(codes, quals, new_lens), self.names)

    def front_and_back(self, tolerance: int):
        """Reference ``.get_front_and_back`` (R/adaptorAlign.R:86-95).

        Returns (front, back) where ``front`` is the first ``tolerance`` bases
        and ``back`` the reverse complement of the last ``tolerance`` bases,
        both clipped to the read length.  The back is gathered reversed.
        """
        lens = self.lengths.astype(np.int64)
        front = self.subseq(np.ones(len(self), dtype=np.int64), np.minimum(tolerance, lens))
        last = lens - 1
        codes = _complement(_row_windows(self.codes, last, front.width, reverse=True))
        quals = None
        if self.quals is not None:
            quals = _row_windows(self.quals, last, front.width, reverse=True)
        back = _blanked(codes.astype(np.int8, copy=False),
                        None if quals is None else quals.astype(np.uint8, copy=False),
                        front.lengths.copy())
        return front, SeqBatch(*back, self.names)


def _blanked(codes: np.ndarray, quals: np.ndarray | None, lengths: np.ndarray):
    """(codes, lengths, quals) with the columns past each length set to the
    padding: ``GAP_CODE`` in the codes, 0 in the qualities."""
    past = _past(lengths, codes.shape[1])
    codes[past] = GAP_CODE
    if quals is not None:
        quals[past] = 0
    return codes, lengths, quals


# ---------------------------------------------------------------------------
# IUPAC reference descriptors (reference_align.cpp:184-212, quirks included).
# ---------------------------------------------------------------------------

# code -> (mode, matched-row over obs A,C,G,T,N) where matched-row may be
# ``None`` to mean "matched iff obs == ref".
_IUPAC = {
    "A": (1, None),
    "C": (1, None),
    "G": (1, None),
    "T": (1, None),
    # 2-fold: the C++ tests ref (e.g. 'M') against 'A'/'C' -> always False.
    "M": (2, [False] * 5),
    "R": (2, [False] * 5),
    "W": (2, [False] * 5),
    "S": (2, [False] * 5),
    "Y": (2, [False] * 5),
    "K": (2, [False] * 5),
    # 3-fold: the C++ tests ref (e.g. 'V') != 'T' -> always True.
    "V": (3, [True] * 5),
    "H": (3, [True] * 5),
    "D": (3, [True] * 5),
    "B": (3, [True] * 5),
    "N": (4, [True] * 5),
}


@dataclass
class IUPACReference:
    """A reference (adaptor/barcode) string prepared for the aligner."""

    seq: str
    modes: np.ndarray  # int8 [R], degeneracy mode 1..4
    matched: np.ndarray  # bool [R, 5], matched-ness per observed base code

    def __len__(self) -> int:
        return len(self.seq)


def iupac_reference(seq: str) -> IUPACReference:
    seq = seq.upper()
    modes = np.zeros(len(seq), dtype=np.int8)
    matched = np.zeros((len(seq), 5), dtype=bool)
    for i, ch in enumerate(seq):
        if ch not in _IUPAC:
            raise ValueError("unrecognized base in reference sequence")
        mode, row = _IUPAC[ch]
        modes[i] = mode
        if row is None:
            matched[i, "ACGT".index(ch)] = True
        else:
            matched[i] = row
    return IUPACReference(seq, modes, matched)

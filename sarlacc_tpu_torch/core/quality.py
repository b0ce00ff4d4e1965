"""Quality-score encodings and error-probability tables.

The reference derives a per-character error-probability table from Biostrings'
``encoding()`` on the quality class (``R/qualityMask.R:19-28`` in the
reference) and feeds it to every quality-aware kernel through the
``quality_encoding`` C++ class (``src/quality_encoding.cpp``).  We reproduce
the same tables natively:

* ``phred``     — offset 33, scores 0..93  (chars ``!``..``~``), err = 10^(-Q/10)
* ``solexa``    — offset 59, scores -5..62 (chars ``;``..``~``),
                  err = 10^(-Q/10) / (1 + 10^(-Q/10))
* ``illumina``  — offset 64, scores 0..62  (chars ``@``..``~``), err = 10^(-Q/10)

The table is a dense float64 vector indexed by ``ord(char) - offset``.
Out-of-range lookups reproduce the reference's clamping quirk
(``src/quality_encoding.cpp:38-47``): a character *below* the offset raises,
and an index ``i > len(table)`` clamps to the last entry.  Note the reference
tests ``i > size`` (not ``>=``), so the index exactly equal to ``size`` reads
one past the table; since that can't be reproduced safely we clamp at
``>= size`` which matches for every real input (the encodings end at ``~`` =
0x7E, the largest printable char, so the off-by-one slot is unreachable from
valid ASCII qualities).

Copied unchanged from ``sarlacc_tpu/core/quality.py`` (numpy only, no JAX).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "QualityEncoding",
    "get_encoding",
    "QUAL_TYPES",
]

QUAL_TYPES = ("phred", "solexa", "illumina")


class QualityEncoding:
    """A char -> error-probability table, mirroring ``quality_encoding.cpp``."""

    def __init__(self, offset: int, errors: np.ndarray, name: str = "custom"):
        errors = np.asarray(errors, dtype=np.float64)
        if errors.size == 0:
            raise ValueError("encoding vector must be non-empty")
        if np.any(np.diff(errors) > 0):
            # quality_encoding.cpp:22-23 — probabilities must decrease.
            raise ValueError("error probabilities should decrease")
        self.offset = int(offset)
        self.errors = errors
        self.name = name

    @property
    def size(self) -> int:
        return self.errors.size

    def to_error(self, qual: np.ndarray) -> np.ndarray:
        """Vectorised char-code -> error probability (quality_encoding.cpp:38-47)."""
        qual = np.asarray(qual)
        if qual.dtype.kind in "SU":
            raise TypeError("pass integer char codes, not strings")
        if qual.size and qual.min() < self.offset:
            raise ValueError("quality cannot be lower than smallest encoded value")
        idx = np.minimum(qual - self.offset, self.size - 1)
        return self.errors[idx]

    def to_error_scalar(self, char: str) -> float:
        return float(self.to_error(np.array([ord(char)]))[0])

    def lowest(self) -> int:
        return self.offset

    def full_table(self, table_size: int = 128) -> np.ndarray:
        """Dense table indexed by raw char code 0..table_size-1.

        Entries below ``offset`` are NaN (invalid); entries past the end of the
        encoding clamp to the final error probability, matching ``to_error``.
        """
        out = np.full(table_size, np.nan, dtype=np.float64)
        codes = np.arange(self.offset, table_size)
        out[codes] = self.errors[np.minimum(codes - self.offset, self.size - 1)]
        return out


def _phred_errors(n: int) -> np.ndarray:
    q = np.arange(n, dtype=np.float64)
    return 10.0 ** (-q / 10.0)


@functools.lru_cache(maxsize=None)
def get_encoding(qual_type: str = "phred") -> QualityEncoding:
    """Built-in encodings matching Biostrings' quality classes.

    ``adaptorAlign``'s ``qual.type`` argument (``R/adaptorAlign.R:8``) selects
    among PhredQuality / SolexaQuality / IlluminaQuality; the error tables are
    as produced by ``.create_encoding_vector`` (``R/qualityMask.R:19-28``).
    """
    if qual_type == "phred":
        # '!' (33) .. '~' (126): scores 0..93.
        return QualityEncoding(33, _phred_errors(94), "phred")
    if qual_type == "solexa":
        # ';' (59) .. '~' (126): scores -5..62.
        q = np.arange(-5, 63, dtype=np.float64)
        p = 10.0 ** (-q / 10.0)
        return QualityEncoding(59, p / (1.0 + p), "solexa")
    if qual_type == "illumina":
        # '@' (64) .. '~' (126): scores 0..62.
        return QualityEncoding(64, _phred_errors(63), "illumina")
    raise ValueError(f"unknown quality type {qual_type!r}; use one of {QUAL_TYPES}")


def errors_to_phred_string(errorprobs: np.ndarray) -> str:
    """Log error probabilities -> Phred+33 string (create_consensus.cpp:18-32).

    ``errorprobs`` are natural-log error probabilities.  The reference uses
    ``std::round`` (half away from zero); the operand is always >= 0 here so
    this equals floor(x + 0.5).
    """
    errorprobs = np.asarray(errorprobs, dtype=np.float64)
    to_ascii = np.minimum(np.floor(-10.0 * errorprobs / np.log(10.0) + 0.5), 93.0)
    return "".join(chr(int(v) + 33) for v in to_ascii)

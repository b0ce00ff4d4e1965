"""Quality-aware substitution score tables.

Reproduces ``reference_align::create_qualities`` (reference_align.cpp:21-52):
for an m-fold degenerate reference base (gamma = 1/m, n = 4 bases) and an
observed base with error probability epsilon,

    match    = log2(gamma * (1 - eps) * n + (1 - gamma) * eps * n/(n-1))
    mismatch = log2((1 - gamma) * (1 - eps) * n + gamma * eps * n/(n-1))

The tables are indexed [mode-1, qual - offset] with the quality index clamped
to the last available entry (reference_align.cpp:214-225).

Copied unchanged from ``sarlacc_tpu/core/scoring.py`` (numpy only, no JAX).
"""

from __future__ import annotations

import numpy as np

from .quality import QualityEncoding, get_encoding

__all__ = ["ScoreTables", "build_score_tables"]


class ScoreTables:
    def __init__(self, encoding: QualityEncoding):
        self.encoding = encoding
        eps = encoding.errors  # float64 [Q]
        n = 4.0
        modes = np.arange(1, 5, dtype=np.float64)  # m = 1..4
        gamma = (1.0 / modes)[:, None]
        with np.errstate(divide="ignore"):
            # eps == 1 (quality 0) legitimately yields -inf, as in the C++.
            self.match = np.log2(
                gamma * (1.0 - eps) * n + (1.0 - gamma) * eps * (n / (n - 1.0))
            )
            self.mismatch = np.log2(
                (1.0 - gamma) * (1.0 - eps) * n + gamma * eps * (n / (n - 1.0))
            )
        self.offset = encoding.offset
        self.navail = eps.size

    def qual_index(self, qual_codes: np.ndarray) -> np.ndarray:
        """Raw char codes -> clamped table index (reference_align.cpp:214-224)."""
        qual_codes = np.asarray(qual_codes)
        if qual_codes.size and qual_codes.min() < self.offset:
            raise ValueError("quality cannot be lower than smallest encoded value")
        return np.minimum(qual_codes - self.offset, self.navail - 1).astype(np.int32)

    def cost(self, mode: int, matched: bool, qual_code: int) -> float:
        idx = int(self.qual_index(np.array([qual_code]))[0])
        tab = self.match if matched else self.mismatch
        return float(tab[mode - 1, idx])


_cache: dict[str, ScoreTables] = {}


def build_score_tables(qual_type: str = "phred") -> ScoreTables:
    if qual_type not in _cache:
        _cache[qual_type] = ScoreTables(get_encoding(qual_type))
    return _cache[qual_type]

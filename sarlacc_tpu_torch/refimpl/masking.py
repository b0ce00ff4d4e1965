"""Base masking and alignment unmasking (src/mask_bad_bases.cpp, src/unmask_alignment.cpp).

These are cheap elementwise/RLE host operations; this module is both the
oracle and the production implementation (vectorised where it matters).

Copied unchanged from ``sarlacc_tpu/refimpl/masking.py`` (numpy only, no JAX).
"""

from __future__ import annotations

import numpy as np

from ..core.encode import N_CODE, SeqBatch
from ..core.quality import QualityEncoding

__all__ = ["mask_bad_bases", "unmask_alignment"]


def mask_bad_bases(batch: SeqBatch, encoding: QualityEncoding, threshold: float) -> SeqBatch:
    """Replace bases whose error probability exceeds ``threshold`` with N
    (mask_bad_bases.cpp:43-45).  Returns a new quality-less batch."""
    if batch.quals is None:
        raise ValueError("sequences must carry qualities to be masked")
    codes = batch.codes.copy()
    if len(batch):
        width = batch.width
        pos = np.arange(width)[None, :]
        valid = pos < batch.lengths[:, None]
        q = np.where(valid, batch.quals, encoding.offset)
        err = encoding.to_error(q)
        codes = np.where(valid & (err > threshold), np.int8(N_CODE), codes)
    return SeqBatch(codes, batch.lengths.copy(), None, batch.names)


def unmask_alignment(alignments: list[str], originals: list[str]) -> list[str]:
    """Restore original bases at N/n positions of gapped alignment strings
    (unmask_alignment.cpp:36-53)."""
    if len(alignments) != len(originals):
        raise ValueError(
            "alignment and original sequences should have the same number of entries"
        )
    width = None
    for a in alignments:
        if width is None:
            width = len(a)
        elif len(a) != width:
            raise ValueError("alignment strings should have equal width")

    out = []
    for masked, origin in zip(alignments, originals):
        buf = list(masked)
        pos_nominal = 0
        for pos, ch in enumerate(buf):
            if ch != "-":
                if ch in ("N", "n"):
                    if pos_nominal >= len(origin):
                        raise ValueError(
                            "sequence in alignment string is longer than the original"
                        )
                    buf[pos] = origin[pos_nominal]
                pos_nominal += 1
        if pos_nominal != len(origin):
            raise ValueError(
                "original sequence and that in the alignment string have different lengths"
            )
        out.append("".join(buf))
    return out

"""SAM text parsing — ``sam2ranges`` (R/sam2ranges.R:8-95).

Plain-text SAM (ONT CIGARs overflow BAM fields, hence no BAM); emits a
Frame of mapped reads with reference-space widths and clip lengths, used to
build pre-grouping factors for ``umi_group``.

Copied unchanged from ``sarlacc_tpu/io/sam.py`` (numpy only, no JAX).
"""

from __future__ import annotations

import re

import numpy as np

from ..core.frame import Frame

__all__ = ["sam2ranges", "cigar_ref_width", "clip_length"]

_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")
_REF_OPS = set("MDN=X")


def cigar_ref_width(cigar: str) -> int:
    """Width along the reference (ops M/D/N/=/X), as
    GenomicAlignments::cigarWidthAlongReferenceSpace."""
    w = 0
    for n, op in _CIG_RE.findall(cigar):
        if op in _REF_OPS:
            w += int(n)
    return w


def clip_length(cigar: str, start: bool = True) -> int:
    """Total H+S clip length at one end (R/sam2ranges.R:80-95: hard clips
    stripped before soft clips, both summed)."""
    total = 0
    for op in ("H", "S"):
        if start:
            m = re.match(rf"^(\d+){op}", cigar)
            if m:
                total += int(m.group(1))
                cigar = cigar[m.end():]
        else:
            m = re.search(rf"(\d+){op}$", cigar)
            if m:
                total += int(m.group(1))
                cigar = cigar[: m.start()]
    return total


def sam2ranges(sam: str, minq: int | None = 10, restricted=None) -> Frame:
    """Parse a SAM file into a Frame of mapped-read ranges.

    Columns: name, rname, start (1-based POS), width (reference space),
    strand, left.clip, right.clip.  Metadata carries the @SQ sequence
    lengths.  Filters unmapped (FLAG 0x4), low-MAPQ, and off-target reads.
    """
    ref_len: dict[str, int] = {}
    rows = []
    with open(sam) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    sn = re.search(r"\tSN:([^\t]+)", line)
                    ln = re.search(r"\tLN:([^\t]+)", line)
                    if sn and ln:
                        ref_len[sn.group(1)] = int(ln.group(1))
                continue
            fields = line.split("\t")
            if len(fields) < 6:
                continue
            qname, flag, rname, pos, mapq, cigar = fields[:6]
            flag = int(flag)
            if flag & 0x4:
                continue
            if minq is not None and int(mapq) < minq:
                continue
            if restricted is not None and rname not in restricted:
                continue
            rows.append(
                (
                    qname,
                    rname,
                    int(pos),
                    cigar_ref_width(cigar),
                    "-" if flag & 0x10 else "+",
                    clip_length(cigar, True),
                    clip_length(cigar, False),
                )
            )
    ref_len["*"] = 0

    out = Frame(
        {
            "rname": [r[1] for r in rows],
            "start": np.asarray([r[2] for r in rows], dtype=np.int64),
            "width": np.asarray([r[3] for r in rows], dtype=np.int64),
            "strand": [r[4] for r in rows],
            "left.clip": np.asarray([r[5] for r in rows], dtype=np.int64),
            "right.clip": np.asarray([r[6] for r in rows], dtype=np.int64),
        },
        rownames=[r[0] for r in rows],
        metadata={"seqlengths": ref_len},
    )
    return out

"""``consensus_read_seq`` — one consensus sequence per MSA group.

Counterpart of ``sarlacc_tpu/api/consensus.py`` (R/consensusReadSeq.R:5-26
+ src/create_consensus.cpp), on the flat layout: quality mode when the MSA
frame carries qualities, basic mode otherwise; the output is a
quality-scaled batch whose Phred strings follow ``errorsToString``
(create_consensus.cpp:18-32).  Groups bucket by padded (members, width)
and each bucket runs in bounded chunks on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..core.quality import get_encoding
from ..device import resolve_device
from ..ops.consensus import consensus_basic_flat, consensus_quality_flat, quality_lut

__all__ = ["consensus_read_seq"]

_CODE = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate("ACGTN-"):
    _CODE[ord(_b)] = _i
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

#: Padded cells per launch: bounds the [B, G, W(, 4)] float64 temporaries.
_CHUNK_CELLS = 1 << 24


def _encode_msa(alignments: list[str], allow_unknown: bool):
    """MSA strings -> [G, W] int8 codes; unknown chars -> 6 or an error."""
    g = len(alignments)
    if g == 0:
        raise ValueError("alignment set must be non-empty")
    w = len(alignments[0])
    for a in alignments:
        if len(a) != w:
            raise ValueError("alignment strings should have equal width")
    raw = np.frombuffer("".join(alignments).encode(), dtype=np.uint8).reshape(g, w)
    codes = _CODE[raw]
    bad = codes < 0
    if bad.any():
        if not allow_unknown:
            ch = chr(int(raw[bad][0]))
            raise ValueError(f"unknown character '{ch}' in alignment string")
        codes = np.where(bad, np.int8(6), codes)
    return codes


def _qual_chars(codes: np.ndarray, quals: list[str], encoding) -> np.ndarray:
    """Per-read de-gapped quality chars -> per-gapped-column uint8 plane.

    Every non-gap column consumes one quality char (N included); length
    mismatches raise the reference's errors, as does a char below the
    encoding offset (quality_encoding.cpp:38-41).  Gap cells take the 255
    sentinel (-> error probability 0.5).
    """
    g, w = codes.shape
    out = np.full((g, w), 255, dtype=np.uint8)
    nongap = codes != 5
    counts = nongap.sum(axis=1)
    qlens = np.fromiter((len(q) for q in quals), np.int64, count=g)
    bad = np.flatnonzero(counts != qlens)
    if bad.size:
        if counts[bad[0]] > qlens[bad[0]]:
            raise ValueError("quality vector is shorter than the alignment sequence")
        raise ValueError("quality vector is longer than the alignment sequence")
    if counts.any():
        qmat = np.full((g, max(int(qlens.max()), 1)), encoding.offset, np.uint8)
        for i, q in enumerate(quals):
            qmat[i, : qlens[i]] = np.frombuffer(q.encode(), dtype=np.uint8)
        if int(qmat.min()) < encoding.offset:
            raise ValueError("quality cannot be lower than smallest encoded value")
        qidx = np.cumsum(nongap, axis=1) - 1
        rows = np.broadcast_to(np.arange(g)[:, None], (g, w))
        out[nongap] = qmat[rows[nongap], qidx[nongap]]
    return out


def _bucket_up(x: int) -> int:
    b = 8
    while b < x:
        b *= 2
    return b


def consensus_read_seq(
    alignments: Frame | list[list[str]],
    pseudo_count: float = 1.0,
    min_coverage: float = 0.6,
    qual_type: str = "phred",
    qualities: list[list[str]] | None = None,
    device=None,
) -> SeqBatch:
    """Consensus per group; returns a quality-scaled SeqBatch (Phred+33).

    ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    if isinstance(alignments, Frame):
        groups = list(alignments["alignments"])
        quals = list(alignments["qualities"]) if "qualities" in alignments else None
        names = alignments.rownames
    else:
        groups = list(alignments)
        quals = qualities
        names = None
    has_quals = quals is not None
    encoding = get_encoding(qual_type)
    lut = torch.as_tensor(quality_lut(encoding), device=dev)

    ngroups = len(groups)
    enc = [_encode_msa(g, allow_unknown=has_quals) for g in groups]
    qch = (
        [_qual_chars(c, q, encoding) for c, q in zip(enc, quals)]
        if has_quals
        else [None] * ngroups
    )

    buckets: dict[tuple[int, int], list[int]] = {}
    for i, c in enumerate(enc):
        key = (_bucket_up(c.shape[0]), _bucket_up(max(c.shape[1], 1)))
        buckets.setdefault(key, []).append(i)

    inflight = []
    for (gpad, wpad), all_idxs in buckets.items():
        step = max(1, _CHUNK_CELLS // (gpad * wpad))
        for c0 in range(0, len(all_idxs), step):
            idxs = all_idxs[c0 : c0 + step]
            inflight.append(
                (idxs, _launch_chunk(
                    idxs, gpad, wpad, enc, qch, has_quals, lut,
                    min_coverage, pseudo_count, dev,
                ))
            )

    seqs: list[str] = [""] * ngroups
    phreds: list[str] = [""] * ngroups
    for idxs, (keep_d, best_d, qc_d) in inflight:
        keep = keep_d.cpu().numpy()
        best = best_d.cpu().numpy()
        qc = qc_d.cpu().numpy()
        for k, i in enumerate(idxs):
            w = enc[i].shape[1]
            cols = np.flatnonzero(keep[k, :w])
            seqs[i] = _BASES[best[k, cols]].tobytes().decode()
            phreds[i] = qc[k, cols].tobytes().decode()
    return SeqBatch.from_strings(seqs, phreds, names)


def _launch_chunk(
    idxs, gpad, wpad, enc, qch, has_quals, lut, min_coverage, pseudo_count, dev
):
    """Pack one chunk of groups into the flat layout and launch its tally."""
    b = len(idxs)
    gstart = np.zeros(b, np.int64)
    widths = np.zeros(b, np.int64)
    naligns = np.zeros(b, np.int64)
    at = 0
    for k, i in enumerate(idxs):
        g, w = enc[i].shape
        gstart[k], widths[k], naligns[k] = at, w, g
        at += g * w
    flat_c = np.concatenate([enc[i].reshape(-1) for i in idxs] + [np.full(1, 5, np.int8)])

    def _t(a):
        return torch.as_tensor(a, device=dev)

    if has_quals:
        flat_q = np.concatenate(
            [qch[i].reshape(-1) for i in idxs] + [np.full(1, 255, np.uint8)]
        )
        return consensus_quality_flat(
            _t(flat_c), _t(flat_q), lut, _t(gstart), _t(widths), _t(naligns),
            float(min_coverage), G=gpad, W=wpad,
        )
    return consensus_basic_flat(
        _t(flat_c), _t(gstart), _t(widths), _t(naligns),
        float(min_coverage), float(pseudo_count), G=gpad, W=wpad,
    )

"""Internal batched alignment routine shared by the adaptor-facing APIs.

Counterpart of ``sarlacc_tpu/api/align_internal.py`` (the adaptor path):
one kernel-A launch covers the whole batch, the backtrack walks every read
on the same device, and only the [N, R+1] query maps come back to the host.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from ..core.encode import SeqBatch, iupac_reference
from ..core.frame import Frame
from ..core.scoring import ScoreTables, build_score_tables
from ..ops.align import prepare_reads, prepare_reference
from ..ops.backtrack import qmap_walk, query_windows
from ..ops.cuda_align import fit_dirs

__all__ = [
    "PreparedAdaptor",
    "prepare_adaptor",
    "setup_subseqs",
    "align_and_extract",
    "resolve_strand",
]


def setup_subseqs(adaptor: str):
    """Ambiguous stretches ``[^ACTG]+`` of the adaptor (R/adaptorAlign.R:136-143).

    Returns (starts, ends), both 1-based inclusive.
    """
    starts, ends = [], []
    for m in re.finditer("[^ACTG]+", adaptor):
        starts.append(m.start() + 1)
        ends.append(m.end())
    return starts, ends


@dataclass
class PreparedAdaptor:
    """An adaptor with its device-side scoring tensors and section layout."""

    seq: str
    modes: torch.Tensor
    matched: torch.Tensor
    match_tab: torch.Tensor
    mismatch_tab: torch.Tensor
    sec_starts: list[int]
    sec_ends: list[int]
    tables: ScoreTables

    def __len__(self):
        return len(self.seq)


def prepare_adaptor(adaptor: str, qual_type: str = "phred", device=None) -> PreparedAdaptor:
    """Float32 score tables on ``device`` (default CPU), as the JAX default."""
    adaptor = adaptor.upper()
    tables = build_score_tables(qual_type)
    modes, matched, mt, mmt = prepare_reference(
        iupac_reference(adaptor), tables, device=device
    )
    starts, ends = setup_subseqs(adaptor)
    return PreparedAdaptor(adaptor, modes, matched, mt, mmt, starts, ends, tables)


def align_and_extract(
    adaptor: PreparedAdaptor,
    batch: SeqBatch,
    gap_opening: float,
    gap_extension: float,
) -> Frame:
    """Scores, read-coordinate spans, and per-section subsequences.

    Runs on the device that holds ``adaptor``'s tensors.  Mirrors
    src/adaptor_align.cpp:45-75 + R/adaptorAlign.R:151-175: spans are
    1-based inclusive; empty alignments report start=end=0; section
    subsequences include flanking gaps (querymap include_gaps=True).
    """
    n = len(batch)
    dev = adaptor.modes.device
    codes, qidx, lengths = prepare_reads(batch, adaptor.tables, device=dev)
    scores, dirs, _ = fit_dirs(
        codes,
        qidx,
        lengths,
        adaptor.modes,
        adaptor.matched,
        adaptor.match_tab,
        adaptor.mismatch_tab,
        float(gap_opening),
        float(gap_extension),
        local=True,
    )
    scores = scores.cpu().numpy()[:n].astype(np.float64)

    rlen = len(adaptor)
    om_d, orow_d = qmap_walk(dirs, lengths)
    del dirs
    is_match = om_d[:n].cpu().numpy()
    dp_row = orow_d[:n].cpu().numpy()
    nrows = batch.lengths.astype(np.int64) + 1

    s0, e0 = query_windows(is_match, dp_row, nrows, 0, rlen)
    ok = s0 < e0  # empty-sequence guard (adaptor_align.cpp:59)
    starts = np.where(ok, s0 + 1, 0).astype(np.int32)
    ends = np.where(ok, e0, 0).astype(np.int32)

    nsec = len(adaptor.sec_starts)
    sec_start = np.zeros((nsec, n), dtype=np.int32)
    sec_width = np.zeros((nsec, n), dtype=np.int32)
    for k in range(nsec):
        cs, ce = query_windows(
            is_match, dp_row, nrows,
            adaptor.sec_starts[k] - 1, adaptor.sec_ends[k], include_gaps=True,
        )
        sec_start[k] = cs + 1
        sec_width[k] = ce - cs

    out = Frame(score=scores, start=starts, end=ends)
    if nsec:
        segs = {}
        for k in range(nsec):
            s1 = sec_start[k].astype(np.int64)
            segs[f"Sub{k + 1}"] = batch.subseq(s1, s1 + sec_width[k] - 1)
        out["subseq"] = Frame(segs)
    else:
        out["subseq"] = Frame(nrow=n)
    return out


def resolve_strand(
    start_score: np.ndarray,
    end_score: np.ndarray,
    rc_start_score: np.ndarray,
    rc_end_score: np.ndarray,
):
    """R/adaptorAlign.R:112-122: orientation by clamped combined score."""
    fscore = np.maximum(start_score, 0) + np.maximum(end_score, 0)
    rscore = np.maximum(rc_start_score, 0) + np.maximum(rc_end_score, 0)
    is_reverse = fscore < rscore
    final = np.where(is_reverse, rscore, fscore)
    return is_reverse, final

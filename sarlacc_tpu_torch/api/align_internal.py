"""Internal batched alignment routines shared by the adaptor-facing APIs.

Counterpart of ``sarlacc_tpu/api/align_internal.py``.  The adaptor path
(:func:`align_and_extract`): one kernel-A launch covers the whole batch, the
backtrack walks every read on the same device, and only the [N, R+1] query
maps come back to the host.  The score-only path (:func:`align_scores_only`,
:class:`PreparedReads`): one upload and one cost-plane build per batch,
shared by every adaptor, barcode and penalty pair scored against it
(kernels C and D).

With a ``mesh`` (:mod:`..parallel`), the batch splits into per-shard row
blocks of the full batch's width; each shard runs the kernel the solo path
runs on its own device, and the results are concatenated in row order on
the first shard's device.  Every read is aligned alone, so the results
equal the solo run's bit for bit; unlike the JAX package, no padding to a
multiple of the mesh size is needed.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass

import numpy as np
import torch

from ..core.encode import SeqBatch, iupac_reference
from ..core.frame import Frame
from ..core.scoring import ScoreTables, build_score_tables
from ..ops.align import prepare_reads, prepare_reference
from ..ops.backtrack import qmap_walk, query_windows
from ..ops.cuda_align import build_cost_planes, fit_dirs, fit_scores_from_planes, plane_dims
from ..parallel.context import shard_bounds

__all__ = [
    "PreparedAdaptor",
    "PreparedReads",
    "ShardedReads",
    "prepare_adaptor",
    "prepare_scores_input",
    "setup_subseqs",
    "align_and_extract",
    "align_scores_only",
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


class PreparedReads:
    """A device-resident read batch for repeated score-only launches.

    The cost planes depend only on the reads and the quality encoding
    (reference_align.cpp:21-52), not on the reference, so they are built
    once here and shared by every adaptor, barcode and penalty launch
    against this batch.  Unpacks as ``(codes, qidx, lengths), n``, as the
    JAX package's does.
    """

    def __init__(self, codes, qidx, lengths, n: int, tables: ScoreTables):
        self.codes = codes
        self.qidx = qidx
        self.lengths = lengths
        self.n = n
        self.tables = tables
        self._planes = None

    def __iter__(self):  # ((codes, qidx, lengths), n)
        yield (self.codes, self.qidx, self.lengths)
        yield self.n

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def parts(self) -> list["PreparedReads"]:
        """The batch's row blocks in order: itself."""
        return [self]

    def plane_geometry(self) -> tuple[int, int]:
        return plane_dims(int(self.codes.shape[0]), int(self.codes.shape[1]))

    def planes(self):
        """Cached (costm, costmm, codes_k) planes on the batch's device."""
        if self._planes is None:
            dev = self.codes.device
            l1, n_pad = self.plane_geometry()
            self._planes = build_cost_planes(
                self.codes,
                self.qidx,
                torch.as_tensor(np.asarray(self.tables.match, np.float32), device=dev),
                torch.as_tensor(np.asarray(self.tables.mismatch, np.float32), device=dev),
                l1,
                n_pad,
            )
        return self._planes


class ShardedReads:
    """A read batch split over a mesh: one :class:`PreparedReads` for each
    non-empty shard, on the shard's device, rows in order.  Results gather
    on ``device``, the first shard's."""

    def __init__(self, parts: list[PreparedReads], n: int, device: torch.device):
        self._parts = parts
        self.n = n
        self.device = device

    def parts(self) -> list[PreparedReads]:
        return self._parts


def _on(adaptor: PreparedAdaptor, device) -> PreparedAdaptor:
    """``adaptor`` with its tensors on ``device``."""
    if adaptor.modes.device == torch.device(device):
        return adaptor
    return dataclasses.replace(
        adaptor, **{k: getattr(adaptor, k).to(device)
                    for k in ("modes", "matched", "match_tab", "mismatch_tab")}
    )


def _row_blocks(n: int, mesh):
    """(device, rows) of each shard that holds rows; one empty block on the
    first shard when none does."""
    blocks = [(d, np.arange(r0, r1)) for (r0, r1), d in zip(shard_bounds(n, mesh.size), mesh.devices)
              if r1 > r0]
    return blocks or [(mesh.devices[0], np.arange(0))]


def prepare_scores_input(adaptor: PreparedAdaptor, batch: SeqBatch, mesh=None):
    """Upload a batch once, to ``adaptor``'s device, for repeated scoring;
    with a ``mesh``, one row block to each shard's device
    (:class:`ShardedReads`)."""
    if mesh is not None:
        parts = [prepare_scores_input(_on(adaptor, d), batch.take(rows))
                 for d, rows in _row_blocks(len(batch), mesh)]
        return ShardedReads(parts, len(batch), mesh.devices[0])
    codes, qidx, lengths = prepare_reads(batch, adaptor.tables, device=adaptor.modes.device)
    return PreparedReads(codes, qidx, lengths, len(batch), adaptor.tables)


def align_scores_only(
    adaptor: PreparedAdaptor,
    batch: SeqBatch | None,
    gap_opening: float,
    gap_extension: float,
    prepared: PreparedReads | ShardedReads | None = None,
    local: bool = True,
    as_device: bool = False,
    mesh=None,
):
    """Batch fitting-mode (or global) scores (src/adaptor_align.cpp:79-110).

    Kernel C on the card, the plain :func:`..ops.align.dp_scores` on the
    CPU.  Pass ``prepared`` from :func:`prepare_scores_input` to reuse one
    upload and one plane build across many launches (a ``mesh`` splits a
    ``batch`` prepared here).  ``as_device=True`` returns the f32 [n] tensor
    on the (first shard's) device; the default returns float64 numpy.
    """
    if prepared is None:
        prepared = prepare_scores_input(adaptor, batch, mesh)
    parts = []
    for part in prepared.parts():
        ad = _on(adaptor, part.device)
        l1, n_pad = part.plane_geometry()
        parts.append(fit_scores_from_planes(
            part.planes(),
            part.lengths,
            ad.modes,
            ad.matched,
            float(gap_opening),
            float(gap_extension),
            l1,
            n_pad,
            local=local,
        )[: part.n].to(prepared.device))
    scores = parts[0] if len(parts) == 1 else torch.cat(parts)
    if as_device:
        return scores
    return scores.cpu().numpy().astype(np.float64)


def _fit_maps(adaptor: PreparedAdaptor, batch: SeqBatch, gap_opening, gap_extension):
    """Kernel A and the backtrack walk on ``adaptor``'s device: (scores
    float64 [n], is_match [n, R+1], dp_row [n, R+1]) on the host."""
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
    om_d, orow_d = qmap_walk(dirs, lengths)
    del dirs
    return scores, om_d[:n].cpu().numpy(), orow_d[:n].cpu().numpy()


def align_and_extract(
    adaptor: PreparedAdaptor,
    batch: SeqBatch,
    gap_opening: float,
    gap_extension: float,
    mesh=None,
) -> Frame:
    """Scores, read-coordinate spans, and per-section subsequences.

    Runs on the device that holds ``adaptor``'s tensors, or with a ``mesh``
    one row block on each shard's device.  Mirrors
    src/adaptor_align.cpp:45-75 + R/adaptorAlign.R:151-175: spans are
    1-based inclusive; empty alignments report start=end=0; section
    subsequences include flanking gaps (querymap include_gaps=True).
    """
    n = len(batch)
    if mesh is None:
        scores, is_match, dp_row = _fit_maps(adaptor, batch, gap_opening, gap_extension)
    else:
        blocks = [_fit_maps(_on(adaptor, d), batch.take(rows), gap_opening, gap_extension)
                  for d, rows in _row_blocks(n, mesh)]
        scores, is_match, dp_row = (np.concatenate(x) for x in zip(*blocks))

    rlen = len(adaptor)
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

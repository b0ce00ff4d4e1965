"""Calibration — ``tune_alignment`` and ``get_adaptor_thresholds``.

Counterpart of ``sarlacc_tpu/api/tune.py`` (R/tuneAlignment.R and
R/getAdaptorThresholds.R): a grid search over integer gap penalties
maximizes the tied-rank separation between real and per-read-scrambled
alignment scores, and the adaptor score thresholds are the smallest real
scores whose scramble-estimated FDR falls below ``error``.  Both run on the
score-only path: the grid takes two kernel-D launches per batch (one for
the real reads, one for the scrambles), the thresholds one kernel-C launch
per adaptor.  A ``mesh`` splits the batches over its shards: the grid runs
kernel D on each shard's rows, and the thresholds run through
:func:`..parallel.mesh.sharded_adaptor_scores`, whose summed histograms
come back under ``histogram1``/``histogram2``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..parallel.context import mesh_device
from ..io.fastq import sample_fastq, stream_fastq
from ..ops.cuda_align import fit_scores_segments
from .align_internal import (
    align_scores_only,
    prepare_adaptor,
    prepare_scores_input,
    resolve_strand,
)

__all__ = ["tune_alignment", "get_adaptor_thresholds"]


def scramble_input(batch: SeqBatch, rng: np.random.Generator) -> SeqBatch:
    """Per-read permutation of bases and qualities (R/getAdaptorThresholds.R:68-92).

    One batched argsort of iid uniform keys (a uniform random permutation per
    read); pad positions sort last so each read's valid prefix permutes in
    place.  Draws exactly what the JAX package draws from ``rng``.
    """
    N, L = batch.codes.shape
    if N == 0 or L == 0:
        quals = np.zeros_like(batch.quals) if batch.quals is not None else None
        return SeqBatch(
            np.full_like(batch.codes, 5), batch.lengths.copy(), quals, batch.names
        )
    keys = rng.random((N, L))
    pad = np.arange(L)[None, :] >= batch.lengths[:, None]
    keys[pad] = 2.0  # uniforms are < 1, so padding sorts strictly last
    order = np.argsort(keys, axis=1)
    codes = np.take_along_axis(batch.codes, order, axis=1)
    codes[pad] = 5
    quals = None
    if batch.quals is not None:
        quals = np.take_along_axis(batch.quals, order, axis=1)
        quals[pad] = 0
    return SeqBatch(codes, batch.lengths.copy(), quals, batch.names)


def _prep_four(a1, front, back, mesh=None):
    """One upload of each stacked orientation batch: front+back, back+front."""
    return (
        prepare_scores_input(a1, SeqBatch.concat([front, back]), mesh),
        prepare_scores_input(a1, SeqBatch.concat([back, front]), mesh),
        len(front),
    )


def _four_scores(a1, a2, front, back, go, ge, prep=None):
    """START/END/RSTART/REND score vectors (R/tuneAlignment.R:99-112).

    Each adaptor's two orientations stack into one kernel-C launch; both
    adaptors share the prepared planes (the quality tables are per
    qual_type).
    """
    if prep is None:
        prep = _prep_four(a1, front, back)
    pfb, pbf, n = prep
    s1 = align_scores_only(a1, None, go, ge, prepared=pfb)
    s2 = align_scores_only(a2, None, go, ge, prepared=pbf)
    return s1[:n], s2[:n], s1[n:], s2[n:]


def _grid_four_scores(a1, a2, combos, prep):
    """Every grid point's START/END/RSTART/REND vectors in TWO kernel-D
    launches, one per stacked batch (R/tuneAlignment.R:54-72)."""
    pfb, pbf, n = prep

    def grid(prepared, ad):
        segs = [(ad.modes, ad.matched, go, ge, True) for go, ge in combos]
        return torch.cat([
            fit_scores_segments(part.planes(), part.lengths, segs, *part.plane_geometry())
            [:, : part.n].cpu() for part in prepared.parts()
        ], dim=1).numpy().astype(np.float64)

    s1 = grid(pfb, a1)
    s2 = grid(pbf, a2)
    return [
        (s1[i, :n], s2[i, :n], s1[i, n:], s2[i, n:])
        for i in range(len(combos))
    ]


def tied_overlap(real: np.ndarray, fake: np.ndarray) -> float:
    """Tie-averaged rank overlap (R/tuneAlignment.R:78-85)."""
    fake = np.sort(fake)
    upper = np.searchsorted(fake, real, side="right")
    lower = np.searchsorted(fake, real, side="left")
    return float((upper + lower).sum() / 2.0 / (real.size * fake.size))


def tune_alignment(
    adaptor1: str,
    adaptor2: str,
    filepath: str | None = None,
    reads: SeqBatch | None = None,
    tolerance: int = 200,
    number: int = 10_000,
    gap_op_range: tuple[int, int] = (4, 10),
    gap_ext_range: tuple[int, int] = (1, 5),
    qual_type: str = "phred",
    seed: int = 0,
    device=None,
    mesh=None,
) -> dict:
    """Grid-search integer gap penalties maximizing real/scrambled separation.

    Gap opening is the outer loop and a point replaces the best only when
    strictly better, so the first best point wins.  ``device=None`` means
    CUDA; a ``mesh`` splits the reads over its shards.
    """
    dev = mesh_device(mesh, device)
    a1 = prepare_adaptor(adaptor1.upper(), qual_type, device=dev)
    a2 = prepare_adaptor(adaptor2.upper(), qual_type, device=dev)

    if reads is None:
        if filepath is None:
            raise ValueError("either filepath or reads must be supplied")
        reads = sample_fastq(filepath, number, seed=seed)

    if len(reads) == 0:
        return {
            "parameters": {"gapOpening": None, "gapExtension": None},
            "scores": {"reads": np.zeros(0), "scrambled": np.zeros(0)},
        }

    rng = np.random.default_rng(seed)
    front, back = reads.front_and_back(tolerance)
    sfront = scramble_input(front, rng)
    sback = scramble_input(back, rng)

    lo_op, hi_op = np.maximum.accumulate(np.asarray(gap_op_range, dtype=int))
    lo_ext, hi_ext = np.maximum.accumulate(np.asarray(gap_ext_range, dtype=int))
    combos = [
        (go, ge)
        for go in range(int(lo_op), int(hi_op) + 1)
        for ge in range(int(lo_ext), int(hi_ext) + 1)
    ]
    rs_all = _grid_four_scores(a1, a2, combos, _prep_four(a1, front, back, mesh))
    ss_all = _grid_four_scores(a1, a2, combos, _prep_four(a1, sfront, sback, mesh))

    max_score = 0.0
    best = {"gapOpening": None, "gapExtension": None}
    best_scores = {"reads": None, "scrambled": None}
    for (go, ge), rs, ss in zip(combos, rs_all, ss_all):
        _, read_scores = resolve_strand(*rs)
        _, scram_scores = resolve_strand(*ss)
        cur = tied_overlap(read_scores, scram_scores)
        if max_score < cur:
            max_score = cur
            best = {"gapOpening": go, "gapExtension": ge}
            best_scores = {"reads": read_scores, "scrambled": scram_scores}
    return {"parameters": best, "scores": best_scores}


def compute_threshold(real: np.ndarray, scrambled: np.ndarray, error: float) -> float:
    """Smallest real score with scramble-FDR <= error (R/getAdaptorThresholds.R:94-103)."""
    real = np.sort(real)
    scrambled = np.sort(scrambled)
    n = real.size
    denom = n - np.arange(1, n + 1, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        fdr = (scrambled.size - np.searchsorted(scrambled, real, side="right")) / denom
    ok = np.flatnonzero(fdr <= error)
    if ok.size == 0:
        raise ValueError("no score threshold achieves the requested error")
    return float(real[ok[0]])


def get_adaptor_thresholds(
    aligned: Frame,
    error: float = 0.01,
    number: int = 100_000,
    reads: SeqBatch | None = None,
    seed: int = 0,
    device=None,
    mesh=None,
) -> dict:
    """Scramble-FDR adaptor score thresholds (R/getAdaptorThresholds.R:6-64).

    The reads come from ``reads`` or are re-streamed from the FASTQ named in
    ``aligned``'s metadata; their scrambles are scored with kernel C, one
    launch per adaptor on the stacked orientations.  ``device=None`` means
    CUDA.  With a ``mesh`` the scrambles are scored shard by shard through
    :func:`..parallel.mesh.sharded_adaptor_scores`, whose summed 64-bin
    score histograms come back under ``histogram1``/``histogram2``; the
    thresholds use the exact scores, so they equal the solo run's.
    """
    dev = mesh_device(mesh, device)
    meta = aligned.metadata
    a1meta = aligned["adaptor1"].metadata
    a2meta = aligned["adaptor2"].metadata
    go, ge = a1meta["gapOpening"], a1meta["gapExtension"]
    tolerance = meta["tolerance"]
    qual_type = meta.get("qual.type", "phred")
    a1 = prepare_adaptor(a1meta["sequence"], qual_type, device=dev)
    a2 = prepare_adaptor(a2meta["sequence"], qual_type, device=dev)

    if reads is None:
        filepath = meta.get("filepath")
        if filepath is None:
            raise ValueError("aligned frame metadata carries no filepath")
        parts = []
        wanted = np.asarray(aligned.rownames or [], dtype=object)
        for chunk in stream_fastq(filepath, chunk_size=number):
            names = np.asarray(chunk.names or [], dtype=object)
            keep = np.flatnonzero(np.isin(names, wanted))
            if keep.size:
                parts.append(chunk.take(keep))
        reads = SeqBatch.concat(parts)

    rng = np.random.default_rng(seed)
    name_to_row = {nm: i for i, nm in enumerate(aligned.rownames or [])}
    m = np.asarray([name_to_row[nm] for nm in (reads.names or [])])

    front, back = reads.front_and_back(tolerance)
    sfront = scramble_input(front, rng)
    sback = scramble_input(back, rng)
    hist1 = hist2 = None
    if mesh is not None:
        scram1, scram2, hist1, hist2 = _sharded_scrambled_scores(
            a1, a2, sfront, sback, go, ge, mesh
        )
    else:
        s_start, s_end, s_rstart, s_rend = _four_scores(a1, a2, sfront, sback, go, ge)
        is_rev, _ = resolve_strand(s_start, s_end, s_rstart, s_rend)
        scram1 = np.where(is_rev, s_rstart, s_start)
        scram2 = np.where(is_rev, s_rend, s_end)

    real1 = np.asarray(aligned["adaptor1"]["score"], dtype=np.float64)[m]
    real2 = np.asarray(aligned["adaptor2"]["score"], dtype=np.float64)[m]
    out = {
        "threshold1": compute_threshold(real1, scram1, error),
        "threshold2": compute_threshold(real2, scram2, error),
        "scores1": {"reads": real1, "scrambled": scram1},
        "scores2": {"reads": real2, "scrambled": scram2},
    }
    if hist1 is not None:
        out["histogram1"] = hist1
        out["histogram2"] = hist2
    return out


def _sharded_scrambled_scores(a1, a2, sfront, sback, go, ge, mesh):
    """Shard-parallel scrambled scores (float64) and summed histograms (int32)."""
    from ..ops.align import prepare_reads
    from ..parallel.mesh import sharded_adaptor_scores

    s1, s2, _, h1, h2 = sharded_adaptor_scores(
        mesh,
        prepare_reads(sfront, a1.tables),
        prepare_reads(sback, a1.tables),
        (a1.modes, a1.matched, a1.match_tab, a1.mismatch_tab),
        (a2.modes, a2.matched, a2.match_tab, a2.mismatch_tab),
        float(go),
        float(ge),
    )
    return (
        s1.cpu().numpy().astype(np.float64),
        s2.cpu().numpy().astype(np.float64),
        h1.cpu().numpy(),
        h2.cpu().numpy(),
    )

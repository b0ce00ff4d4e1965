"""Barcode demultiplexing — ``barcode_align`` / ``get_barcode_thresholds``.

Counterpart of ``sarlacc_tpu/api/barcode.py`` (R/barcodeAlign.R +
src/barcode_align.cpp): every observed barcode subsequence is **globally**
aligned (quality-aware) against each reference barcode in one kernel-D
launch (one a shard under a ``mesh``); best and second-best scores give the
assignment and its gap.
Thresholds are median − nmads·MAD (R/getBarcodeThresholds.R).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..device import resolve_device
from ..parallel.context import mesh_device
from ..ops.cuda_align import fit_scores_segments
from .align_internal import prepare_adaptor, prepare_scores_input

__all__ = ["barcode_align", "get_barcode_thresholds"]


def barcode_align(
    sequences: SeqBatch,
    barcodes: list[str],
    gap_opening: float = 5,
    gap_extension: float = 1,
    qual_type: str = "phred",
    device=None,
    mesh=None,
) -> Frame:
    """Assign each sequence to its best-scoring barcode.

    Returns Frame(barcode, score, gap) where ``barcode`` is the 0-based index
    of the winner (the reference reports 1-based), ``gap`` the margin over the
    runner-up; metadata carries penalties and the barcode list.  One barcode
    gives ``gap = +inf``; no barcodes give id -1, score ``-inf`` and gap
    ``nan``.  ``device=None`` means CUDA; a ``mesh`` splits the sequences
    over its shards, each scored against every barcode on its device.
    """
    dev = mesh_device(mesh, device)
    n = len(sequences)
    current_score = np.full(n, -np.inf)
    next_best = np.full(n, -np.inf)
    current_id = np.full(n, -1, dtype=np.int64)

    preps = [prepare_adaptor(str(seq).upper(), qual_type, device=dev) for seq in barcodes]
    if preps:
        # One upload and one plane build for every barcode (the quality
        # table is per qual_type, not per barcode), one launch, and a
        # device-side best/second-best so three [n] vectors come back.
        prepared = prepare_scores_input(preps[0], sequences, mesh=mesh)
        segs = [(p.modes, p.matched, gap_opening, gap_extension, False) for p in preps]
        stack = torch.cat([
            fit_scores_segments(part.planes(), part.lengths, segs, *part.plane_geometry())
            [:, : part.n].to(dev) for part in prepared.parts()
        ], dim=1).to(torch.float64)  # [B, n]
        # The first maximum wins ties, as the sequential
        # `scores > current_score` walk did (R/barcodeAlign.R:27-38).
        best_id = torch.argmax(stack, dim=0)
        best = stack.gather(0, best_id[None, :])[0]
        rows = torch.arange(len(preps), device=dev)[:, None]
        second = torch.where(rows == best_id[None, :], -torch.inf, stack).max(dim=0).values
        packed = torch.stack([best_id.to(torch.float64), best, second]).cpu().numpy()
        current_id = packed[0].astype(np.int64)
        current_score = packed[1]
        next_best = packed[2]

    out = Frame(
        barcode=current_id,
        score=current_score,
        gap=current_score - next_best,
    )
    out.metadata = {
        "gapOpening": gap_opening,
        "gapExtension": gap_extension,
        "barcodes": list(barcodes),
    }
    return out


def _mad(x: np.ndarray, center: float) -> float:
    """R's mad() with the default 1.4826 consistency constant."""
    return 1.4826 * float(np.median(np.abs(x - center)))


def get_barcode_thresholds(baligned: Frame, nmads: float = 3, device=None) -> dict:
    """median − nmads·MAD thresholds on score and gap (R/getBarcodeThresholds.R:10-14).

    Host work; ``device`` is checked like every entry point's.
    """
    resolve_device(device)
    score = np.asarray(baligned["score"], dtype=np.float64)
    gap = np.asarray(baligned["gap"], dtype=np.float64)
    med_s = float(np.median(score))
    med_g = float(np.median(gap))
    return {
        "score": med_s - _mad(score, med_s) * nmads,
        "gap": med_g - _mad(gap, med_g) * nmads,
    }

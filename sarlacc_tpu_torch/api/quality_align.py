"""``quality_align`` — batch global quality-aware alignment to one reference.

Counterpart of ``sarlacc_tpu/api/quality_align.py`` (R/qualityAlign.R +
src/general_align.cpp): global mode, returns scores, edit distances (count
of differing alignment columns, gaps included), and optionally the gapped
reference/query strings.  One kernel-A launch in global mode gives scores
and directions; the walk runs on the same device and only the [N, T]
emission arrays come back.
"""

from __future__ import annotations

import numpy as np

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..device import resolve_device
from ..ops.align import prepare_reads
from ..ops.backtrack import assemble_strings, string_walk
from ..ops.cuda_align import fit_dirs
from .align_internal import prepare_adaptor

__all__ = ["quality_align"]


def quality_align(
    sequences: SeqBatch,
    reference: str,
    gap_opening: float = 5,
    gap_extension: float = 1,
    edit_only: bool = False,
    qual_type: str = "phred",
    device=None,
) -> Frame:
    """Globally align every sequence to ``reference``.

    Returns Frame(score, edit[, reference, query]) with metadata carrying
    the penalties and the reference.  ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    n = len(sequences)
    ref = str(reference).upper()
    prep = prepare_adaptor(ref, qual_type, device=dev)
    codes, qidx, lengths = prepare_reads(sequences, prep.tables, device=dev)
    scores, dirs, _ = fit_dirs(
        codes,
        qidx,
        lengths,
        prep.modes,
        prep.matched,
        prep.match_tab,
        prep.mismatch_tab,
        float(gap_opening),
        float(gap_extension),
        local=False,
    )
    scores = scores.cpu().numpy().astype(np.float64)

    a_pos, b_pos, ncols = string_walk(dirs, lengths)
    del dirs
    refalign, qalign, edits = assemble_strings(
        a_pos[:n].cpu().numpy(),
        b_pos[:n].cpu().numpy(),
        ncols[:n].cpu().numpy(),
        ref,
        sequences.seq_strings(),
    )

    cols = {"score": scores, "edit": edits}
    if not edit_only:
        cols["reference"] = refalign
        cols["query"] = qalign
    out = Frame(cols)
    out.metadata = {
        "gapOpening": gap_opening,
        "gapExtension": gap_extension,
        "reference": reference,
    }
    return out

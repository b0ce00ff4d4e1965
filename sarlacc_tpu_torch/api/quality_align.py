"""``quality_align`` — batch global quality-aware alignment to one reference.

Counterpart of ``sarlacc_tpu/api/quality_align.py`` (R/qualityAlign.R +
src/general_align.cpp): global mode, returns scores, edit distances (count
of differing alignment columns, gaps included), and optionally the gapped
reference/query strings.

Kernel A's direction planes take 2 R bytes a DP cell, [R, l1, n_pad] for a
launch, so the reads run in chunks under a memory plan
(:func:`chunk_plan`): grouped by length, longest first, each chunk as many
reads as :data:`PLAN_SHARE` of the card's free memory holds at the chunk's
height.  Each chunk is one kernel-A launch in global mode and one string
walk (kernel G) on the same device; its columns go, front to back, into
[N, W] byte planes of the gapped reference and read strings, in input
order.  Every read is aligned alone, and rows past a read's length never
reach its score or its walk, so the result does not depend on the
chunking.  The edits are counted on the device, and only the strings'
bytes come back.  The frame's ``device`` attribute names the device, where ``error_finder``
and ``homopolymer_matcher`` then tally.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.encode import BASES, GAP_CODE, SeqBatch
from ..core.frame import Frame
from ..device import memory_budget, resolve_device
from ..ops.align import prepare_reads
from ..ops.backtrack import string_walk
from ..ops.cuda_align import fit_dirs, plane_dims
from .align_internal import prepare_adaptor
from ..utils.profiling import count, profiled, profiler

__all__ = ["PLAN_SHARE", "chunk_plan", "lane_bytes", "quality_align"]

#: Share of the card's free memory (at its first probe, less the reserve)
#: that one chunk's planes may take.
PLAN_SHARE = 0.75

#: Lanes of a launch: kernel A pads the reads to a multiple of this.
_LANES = 512


def lane_bytes(rlen: int, l1: int) -> int:
    """Device bytes one read of a chunk holds while it is aligned at DP
    height ``l1`` against ``rlen`` reference bases: kernel A's int16
    directions (2 rlen a row), its float32 match and mismatch planes (32 a
    row), codes, quality indices, S and the pass hand-off (28 a row), and
    the walk's two int32 emission rows with their front-to-back copies (T =
    rlen + l1 + 1 columns, 48 bytes each)."""
    return l1 * (2 * rlen + 60) + 48 * (rlen + l1 + 1)


def chunk_plan(lengths, rlen: int, budget: int) -> list[np.ndarray]:
    """The reads' indices in chunks, longest reads first: each chunk as many
    reads as ``budget`` bytes hold at its longest read's DP height
    (:func:`lane_bytes`), a multiple of 512 where it holds 512 or more, and
    at least one read."""
    lengths = np.asarray(lengths, np.int64)
    order = np.argsort(-lengths, kind="stable")
    chunks, at = [], 0
    while at < order.size:
        l1, _ = plane_dims(1, int(lengths[order[at]]))
        lanes = budget // lane_bytes(rlen, l1)
        if lanes >= _LANES:
            lanes -= lanes % _LANES
        chunks.append(order[at:at + max(int(lanes), 1)])
        at += chunks[-1].size
    return chunks


def _plan_budget(dev: torch.device) -> int:
    return memory_budget(dev, PLAN_SHARE, 1 << 30, "qalign_chunk")


@profiled("quality_align")
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
    R = len(ref)
    prep = prepare_adaptor(ref, qual_type, device=dev)
    with profiler("qalign.plan", items=n):
        lengths_np = np.asarray(sequences.lengths, np.int64)
        chunks = chunk_plan(lengths_np, R, _plan_budget(dev))
    with profiler("qalign.prepare", items=n):
        codes, qidx, lengths = prepare_reads(sequences, prep.tables, device=dev)
    width = R + int(lengths_np.max(initial=0))  # the most columns an alignment has
    scores = torch.zeros(n, dtype=torch.float32, device=dev)
    # The gapped strings' bytes, '-' past each alignment's end.
    ra = torch.full((n, width), ord("-"), dtype=torch.uint8, device=dev)
    qa = torch.full((n, width), ord("-"), dtype=torch.uint8, device=dev)
    ref_bytes = torch.tensor(list(("-" + ref).encode()), dtype=torch.uint8, device=dev)
    read_bytes = torch.tensor(list(BASES.encode()), dtype=torch.uint8, device=dev)
    ncols = torch.zeros(n, dtype=torch.int32, device=dev)
    count("qalign.chunks", len(chunks))
    for idx in chunks:
        with profiler("qalign.prepare", items=idx.size):
            sel = torch.as_tensor(idx, device=dev)
            L = int(lengths_np[idx].max())
            c, q, ln = codes[sel, :L], qidx[sel, :L], lengths[sel]
        cells = R * int((lengths_np[idx] + 1).sum())
        with profiler("qalign.dirs", items=idx.size, cells=cells):
            s, dirs, _ = fit_dirs(c, q, ln, prep.modes, prep.matched, prep.match_tab,
                                  prep.mismatch_tab, float(gap_opening), float(gap_extension),
                                  local=False)
        count("qalign.cells", cells)
        count("qalign.dir_bytes", dirs.numel() * dirs.element_size())
        with profiler("qalign.walk", items=idx.size):
            a_pos, b_pos, nc = string_walk(dirs, ln)
            del dirs
            a_pos, b_pos, nc = a_pos[:idx.size], b_pos[:idx.size], nc[:idx.size].to(torch.int64)
            T = int(nc.max())
            # The walk emits back to front: column f is emission nc - 1 - f.
            f = torch.arange(T, device=dev)[None, :]
            back = (nc[:, None] - 1 - f).clamp(min=0)
            live = f < nc[:, None]
            a = torch.where(live, a_pos.gather(1, back), 0).to(torch.int64)
            b = torch.where(live, b_pos.gather(1, back), 0).to(torch.int64)
            gap = torch.full((idx.size, 1), GAP_CODE, dtype=c.dtype, device=dev)
            ra[sel, :T] = ref_bytes[a]
            qa[sel, :T] = read_bytes[torch.cat([gap, c], 1).gather(1, b).to(torch.int64)]
            ncols[sel] = nc.to(torch.int32)
            scores[sel] = s
    count("qalign.columns", int(ncols.sum()))

    with profiler("qalign.strings", items=n):
        W = int(ncols.max()) if n else 0
        ra, qa = ra[:, :W], qa[:, :W]
        edits = (ra != qa).sum(dim=1).cpu().numpy().astype(np.int64)
        cols = {"score": scores.cpu().numpy().astype(np.float64), "edit": edits}
        if not edit_only:
            nc_h = ncols.cpu().numpy()
            ra_h, qa_h = ra.cpu().numpy(), qa.cpu().numpy()
            cols["reference"] = [ra_h[i, :nc_h[i]].tobytes().decode() for i in range(n)]
            cols["query"] = [qa_h[i, :nc_h[i]].tobytes().decode() for i in range(n)]
    out = Frame(cols)
    out.metadata = {
        "gapOpening": gap_opening,
        "gapExtension": gap_extension,
        "reference": reference,
    }
    out.device = dev
    return out

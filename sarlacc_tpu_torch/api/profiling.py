"""Error/homopolymer profiling — ``error_finder``, ``homopolymer_finder``,
``homopolymer_matcher``.

Parity with R/errorFinder.R + src/find_errors.cpp and
R/homopolymerFinder.R / R/homopolymerMatcher.R + src/homopolymer.cpp.
``error_finder`` and ``homopolymer_matcher`` put the alignments' gapped
strings on a device as byte planes and tally from those with whole-array
operations (:mod:`..ops.profile`): on the card that ran ``quality_align``
for its frames, else on the CPU, or on the ``device`` given.  They give
the frames of ``refimpl/errors.py`` and ``refimpl/homopolymer.py``, which
stay as the tests' oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.frame import Frame
from ..device import resolve_device
from ..ops.profile import Planes, alignment_planes, walk_errors, walk_homopolymers
from ..refimpl.homopolymer import find_homopolymers
from ..utils.profiling import count, profiler

__all__ = ["error_finder", "homopolymer_finder", "homopolymer_matcher"]

_BASE_ORDER = "ACGT"


def _extract_alignment_strings(alignments) -> tuple[list[str], list[str]]:
    """Accepts a Frame with reference/query columns (quality_align output)
    or a pair of string lists."""
    if isinstance(alignments, Frame):
        if "reference" not in alignments or "query" not in alignments:
            raise ValueError(
                "alignments must carry 'reference' and 'query' strings; "
                "run quality_align with edit_only=False"
            )
        return list(alignments["reference"]), list(alignments["query"])
    ref, qry = alignments
    return list(ref), list(qry)


def _planes(alignments, device) -> Planes:
    """The alignments' strings as byte planes on ``device``; None: the
    device of the ``quality_align`` call that made the frame, else the CPU."""
    if device is None:
        device = getattr(alignments, "device", None) or "cpu"
    return alignment_planes(*_extract_alignment_strings(alignments), resolve_device(device))


def error_finder(alignments, device=None) -> Frame:
    """Per-reference-position substitution/deletion/insertion profile.

    Returns a Frame with one row per de-gapped reference position **plus a
    one-past-the-end row** (R/errorFinder.R:20-38) holding base identity,
    A/C/G/T/deletion counts, and per-row insertion length lists; metadata
    carries the 4x4 ``transition`` matrix (base -> observed counts,
    R/errorFinder.R:39-44).  ``device``: where to tally (see the module).
    """
    with profiler("profile.errors"):
        res = walk_errors(_planes(alignments, device))

        npos = len(res["base"])
        # One-past-end row for insertions at the end of the reference.
        cols = {"base": list(res["base"]) + [""]}
        for b in _BASE_ORDER:
            cols[b] = np.concatenate([res[b], [0]]).astype(np.int64)
        cols["deletion"] = np.concatenate([res["deletion"], [0]]).astype(np.int64)

        # Each row's insertion lengths in the order find_errors lists them.
        pos = np.asarray(res["insertion_pos"], np.int64)
        flat = np.asarray(res["insertion_len"], np.int64)[np.argsort(pos, kind="stable")].tolist()
        ends = np.cumsum(np.bincount(pos, minlength=npos + 1)).tolist()
        cols["insertion"] = [flat[e0:e1] for e0, e1 in zip([0] + ends[:-1], ends)]
        out = Frame(cols)

        # Transition matrix: true base (rows) x observed base (columns).
        points = np.frombuffer("".join(res["base"]).encode("utf-32-le"), np.uint32)
        row = np.full(points.size, -1, np.int64)
        for r, b in enumerate(_BASE_ORDER):
            row[points == ord(b)] = r
        known = row >= 0
        trans = np.zeros((4, 4), dtype=np.int64)
        for c, ob in enumerate(_BASE_ORDER):
            np.add.at(trans[:, c], row[known], np.asarray(res[ob], np.int64)[known])
        out.metadata["transition"] = trans
    return out


def homopolymer_finder(seqs) -> list[Frame]:
    """Per sequence, runs of length >= 2 with 1-based de-gapped start/width/base."""
    if hasattr(seqs, "seq_strings"):
        strs = seqs.seq_strings()
    else:
        strs = list(seqs)
    idx, pos, size, base = find_homopolymers(strs)
    out = []
    for i in range(len(strs)):
        sel = [k for k, s in enumerate(idx) if s == i]
        out.append(
            Frame(
                start=np.asarray([pos[k] for k in sel], dtype=np.int64),
                width=np.asarray([size[k] for k in sel], dtype=np.int64),
                base=[base[k] for k in sel],
            )
        )
    return out


def homopolymer_matcher(alignments, device=None) -> Frame:
    """Reference homopolymers with observed per-read run lengths.

    Returns one row per reference homopolymer occurrence over all reads:
    start position (1-based, de-gapped), and the sorted observed lengths
    aggregated per position in metadata-free columns
    (R/homopolymerMatcher.R:19-34 collapses to unique positions with an
    observed-length list; we do the same).  Base and width are the first
    alignment's reference's.  ``device``: where to tally (see the module).
    """
    with profiler("profile.homopolymers"):
        planes = _planes(alignments, device)
        _, pos, rlen = walk_homopolymers(planes)
        count("profile.runs", pos.numel())
        uniq, inv, per = torch.unique(pos, sorted=True, return_inverse=True, return_counts=True)
        rlen = rlen[torch.argsort(inv * ((int(rlen.max()) if rlen.numel() else 0) + 1) + rlen)]
        flat = rlen.cpu().tolist()
        ends = np.cumsum(per.cpu().numpy()).tolist()
        observed = [flat[a:b] for a, b in zip([0] + ends[:-1], ends)]
        starts = uniq.cpu().numpy().astype(np.int64)

        runs = _reference_runs(planes.reference)
        hit = [runs.get(p, ("", 0)) for p in starts.tolist()]
        return Frame(start=starts, width=np.asarray([w for _, w in hit], dtype=np.int64),
                     base=[b for b, _ in hit], observed=observed)


def _reference_runs(reference: str) -> dict:
    """1-based start -> (base, width) of each homopolymer of ``reference``."""
    ref = np.frombuffer(reference.encode(), np.uint8)
    starts = np.flatnonzero(np.concatenate([[True], ref[1:] != ref[:-1]])) if ref.size else ref
    widths = np.diff(np.append(starts, ref.size))
    return {int(s) + 1: (reference[s], int(w)) for s, w in zip(starts, widths) if w >= 2}

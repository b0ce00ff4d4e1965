"""Error and homopolymer tallies of gapped alignment strings, on a device.

:func:`alignment_planes` puts pairs of gapped reference and read strings on
a device as two [N, W] byte planes, one upload of their bytes.
:func:`walk_errors` and :func:`walk_homopolymers` compute
``refimpl/errors.py::find_errors`` and
``refimpl/homopolymer.py::match_homopolymers`` from those planes with
whole-array PyTorch operations (bincounts, cumulative sums and maxima, one
search over sorted keys and one segment maximum), with no loop over
alignments or characters.  Their results are the refimpl's, in its order,
and so are their errors.

Homopolymers in position space.  In each alignment give each read base the
key ``2 a`` when its column holds the alignment's ``a``-th reference base
and ``2 a + 1`` when it is inserted after that base (0: before the first).
Keys rise along the read.  A reference run of ``w`` bases from 0-based
``s`` has the window ``[farleft, farright)`` of ``homopolymer.cpp`` at keys
``2 s + 1 .. 2 s + 2 w + 1`` (its bases and the insertions on both sides)
and the span ``[left, right)`` at keys ``2 s + 2 .. 2 s + 2 w``; so a run's
read positions are ``[p0, p1)`` and its span's ``[c0, c1)``, four searches
in the read's keys.  The read walker's runs inside the window are the
read's runs of equal bases cut to ``[p0, p1)``; one overlaps the span when
it starts before ``c1`` and ends after ``c0``, that is when it holds a
position in ``[c0, c1)``.  The observed length is the longest cut run of
the reference run's base among those positions' runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Planes", "alignment_planes", "walk_errors", "walk_homopolymers"]

_GAP = ord("-")

#: A read byte's column in find_errors' table: A, C, G, T, a gap, else 5.
_KIND = np.full(256, 5, np.int64)
_KIND[np.frombuffer(b"ACGT-", np.uint8)] = np.arange(5)

#: Candidate positions one block of :func:`walk_homopolymers` holds at most.
_BLOCK = 1 << 24


@dataclass
class Planes:
    """Pairs of gapped alignment strings as byte planes on one device."""

    reference: str  # the first alignment's reference, de-gapped
    ref: torch.Tensor  # uint8 [N, W]: the reference strings' bytes, 0 past each one's end
    read: torch.Tensor  # uint8 [N, W]: the read strings' bytes, 0 past each one's end
    ncols: torch.Tensor  # int64 [N]: the strings' lengths

    def live(self) -> torch.Tensor:
        """bool [N, W]: the columns inside each alignment."""
        W = self.ref.shape[1]
        return torch.arange(W, device=self.ref.device)[None, :] < self.ncols[:, None]


def _bytes(strings) -> torch.Tensor:
    try:
        flat = bytearray("".join(strings).encode("ascii"))
    except UnicodeEncodeError:
        raise ValueError("alignment strings should be ASCII") from None
    if not flat:
        return torch.zeros(0, dtype=torch.uint8)
    return torch.frombuffer(flat, dtype=torch.uint8)


def alignment_planes(ref_align, read_align, device) -> Planes:
    """The gapped strings ``ref_align`` and ``read_align`` (equal lengths
    pair by pair) as :class:`Planes` on ``device``."""
    if len(ref_align) != len(read_align):
        raise ValueError("lengths of alignment vectors should match up")
    n = len(ref_align)
    lens = np.fromiter(map(len, ref_align), np.int64, n)
    if not np.array_equal(lens, np.fromiter(map(len, read_align), np.int64, n)):
        raise ValueError("read and reference alignment strings should have equal length")
    dev = torch.device(device)
    W = int(lens.max(initial=0))
    ncols = torch.as_tensor(lens, device=dev)
    live = torch.arange(W, device=dev)[None, :] < ncols[:, None]
    planes = []
    for strings in (ref_align, read_align):
        plane = torch.zeros((n, W), dtype=torch.uint8, device=dev)
        plane[live] = _bytes(strings).to(dev)
        planes.append(plane)
    reference = ref_align[0].replace("-", "") if n else ""
    return Planes(reference, planes[0], planes[1], ncols)


def walk_errors(p: Planes) -> dict:
    """``find_errors(refs, queries)`` from the planes: the same dict, the
    insertions in its order (alignments in turn, each left to right)."""
    dev = p.ref.device
    R = len(p.reference)
    live = p.live()
    at_ref = live & (p.ref != _GAP)
    pos = torch.cumsum(at_ref, dim=1)  # the alignment's reference bases up to each column
    kind = torch.as_tensor(_KIND, device=dev)[p.read.to(torch.int64)]
    bad = at_ref & ((pos > R) | (kind == 5))
    if bool(bad.any()):
        i, j = (int(x) for x in bad.nonzero()[0])  # the first column find_errors refuses
        if int(pos[i, j]) > R:
            raise ValueError("reference sequence should be the same for all alignments")
        raise ValueError(f"unknown character '{chr(int(p.read[i, j]))}' in alignment string")
    key = (pos[at_ref] - 1) * 6 + kind[at_ref]
    tab = torch.bincount(key, minlength=6 * R).reshape(R, 6).cpu().numpy()

    gap = live & ~at_ref
    before = torch.zeros_like(gap)
    before[:, 1:] = gap[:, :-1]
    after = torch.zeros_like(gap)
    after[:, :-1] = gap[:, 1:]
    first = (gap & ~before).nonzero()
    last = (gap & ~after).nonzero()
    out = {"base": list(p.reference)}
    for k, b in enumerate("ACGT"):
        out[b] = tab[:, k].astype(np.int64)
    out["deletion"] = tab[:, 4].astype(np.int64)
    out["insertion_pos"] = pos[first[:, 0], first[:, 1]].cpu().numpy().astype(np.int64)
    out["insertion_len"] = (last[:, 1] - first[:, 1] + 1).cpu().numpy().astype(np.int64)
    return out


def _runs(x: torch.Tensor):
    """[N, L] first and one-past-last position of the run of equal values
    each position lies in."""
    N, L = x.shape
    pos = torch.arange(L, device=x.device).expand(N, L)
    new = torch.ones_like(x, dtype=torch.bool)
    new[:, 1:] = x[:, 1:] != x[:, :-1]
    end = torch.ones_like(new)
    end[:, :-1] = new[:, 1:]
    rs = torch.cummax(torch.where(new, pos, 0), dim=1).values
    re = torch.where(end, pos + 1, L).flip(1).cummin(dim=1).values.flip(1)
    return rs, re


def _degapped(plane: torch.Tensor, keep: torch.Tensor, values=None):
    """Each row's entries at ``keep`` moved to its front, in order, with one
    column of 0 past the longest row: ([N, K + 1], kept a row int64 [N])."""
    n_keep = keep.sum(dim=1)
    K = int(n_keep.max()) if n_keep.numel() else 0
    src = plane if values is None else values
    out = torch.zeros((plane.shape[0], K + 1), dtype=src.dtype, device=plane.device)
    out[torch.arange(K + 1, device=plane.device)[None, :] < n_keep[:, None]] = src[keep]
    return out, n_keep


def walk_homopolymers(p: Planes):
    """``match_homopolymers(refs, queries)`` from the planes: (idx, pos,
    rlen) int64 [P] on the planes' device, one entry per homopolymer of two
    bases or more in each alignment's own reference, in its order."""
    dev = p.ref.device
    N = p.ref.shape[0]
    live = p.live()
    at_ref = live & (p.ref != _GAP)
    at_read = live & (p.read != _GAP)
    refd, n_ref = _degapped(p.ref, at_ref)
    readd, _ = _degapped(p.read, at_read)

    # Each alignment's reference runs of two bases or more, row-major.
    rs, re = _runs(refd)
    col = torch.arange(refd.shape[1], device=dev)[None, :]
    width = torch.minimum(re, n_ref[:, None]) - col
    idx, s = ((rs == col) & (col < n_ref[:, None]) & (width >= 2)).nonzero(as_tuple=True)
    w = width[idx, s]
    base = refd[idx, s]
    P = idx.numel()
    rlen = torch.zeros(P, dtype=torch.int64, device=dev)
    if P == 0:
        return idx, s + 1, rlen

    # Each read base's key, in read order, rows offset so that one search serves all.
    a = torch.cumsum(at_ref, dim=1)
    keys, _ = _degapped(p.read, at_read, 2 * a + (~at_ref).to(torch.int64))
    L1 = keys.shape[1]
    big = 2 * refd.shape[1] + 4  # above every key of a row, and its padding
    keys[torch.arange(L1, device=dev)[None, :] >= at_read.sum(dim=1)[:, None]] = big - 1
    flat = (keys + torch.arange(N, device=dev)[:, None] * big).reshape(-1)
    bounds = torch.stack([2 * s + 1, 2 * s + 2, 2 * s + 2 * w + 1, 2 * s + 2 * w + 2])
    p0, c0, c1, p1 = torch.searchsorted(flat, bounds + idx * big) - idx * L1
    cnt = (c1 - c0).clamp(min=0)
    qs, qe = _runs(readd)

    # Blocks of whole runs, each at most _BLOCK candidate positions.
    ends = torch.cumsum(cnt, 0).cpu().numpy()
    k0 = 0
    while k0 < P:
        k1 = max(int(np.searchsorted(ends, (ends[k0 - 1] if k0 else 0) + _BLOCK, "right")),
                 k0 + 1)
        n_b = cnt[k0:k1]
        pair = torch.repeat_interleave(torch.arange(k1 - k0, device=dev), n_b)
        if pair.numel():
            g = pair + k0
            i = idx[g]
            q = c0[g] + torch.arange(pair.numel(), device=dev) - (torch.cumsum(n_b, 0) - n_b)[pair]
            x0 = torch.maximum(qs[i, q], p0[g])
            x1 = torch.minimum(qe[i, q], p1[g])
            ok = readd[i, q] == base[g]
            best = torch.zeros(k1 - k0, dtype=torch.int64, device=dev)
            best.scatter_reduce_(0, pair, torch.where(ok, x1 - x0, 0), "amax")
            rlen[k0:k1] = best
        k0 = k1
    return idx, s + 1, rlen

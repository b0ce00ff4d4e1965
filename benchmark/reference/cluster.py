"""Plain reference of ``umi_group``, each pre-group apart: doubled Levenshtein
distances (match 0, N against anything 1, mismatch or indel 2) between
every pair of UMIs in blocks of plain ``torch`` operations, neighbours
within ``2 * threshold``, then the upstream greedy clusterer
(``src/cluster_umis.cpp:7-112``): singletons first in index order; then
repeatedly the live read with the most remaining neighbours, ties to the
highest index, claims its live neighbours, and each claimed read lowers
its neighbours' counts."""

from __future__ import annotations

import heapq

import numpy as np
import torch

__all__ = ["lev2_neighbours", "greedy_clusters", "umi_groups"]


def lev2_neighbours(codes, lengths, threshold: int, device="cpu", block_cells=None):
    """(i, j) int64 arrays of every ordered pair with doubled distance
    <= 2 * threshold, self pairs included."""
    dev = torch.device(device)
    c = torch.as_tensor(np.asarray(codes, np.int64), device=dev)
    ln = torch.as_tensor(np.asarray(lengths, np.int64), device=dev)
    n, w = c.shape
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lim = 2 * int(threshold)
    if block_cells is None:  # int16 DP rows: ~0.5 GiB a block on a card
        block_cells = 1 << (28 if dev.type == "cuda" else 22)
    block = max(1, block_cells // max(n * (w + 1), 1))
    out_i, out_j = [], []
    for r0 in range(0, n, block):
        a, la = c[r0:r0 + block], ln[r0:r0 + block]
        b = a.shape[0]
        # prev[j] = D[i][j] of every (a, b) pair of the block; row 0 first.
        prev = (2 * torch.arange(w + 1, device=dev, dtype=torch.int16))[:, None, None].expand(
            w + 1, b, n).clone()
        best = torch.where(la[:, None] == 0, 2 * ln[None, :], 0)
        for i in range(1, w + 1):
            cur = torch.empty_like(prev)
            cur[0] = 2 * i
            ai = a[:, i - 1][:, None]
            for j in range(1, w + 1):
                bj = c[:, j - 1][None, :]
                sub = torch.where((ai == 4) | (bj == 4), 1, torch.where(ai == bj, 0, 2))
                cur[j] = torch.minimum(torch.minimum(prev[j] + 2, cur[j - 1] + 2),
                                       prev[j - 1] + sub)
            prev = cur
            at_i = la[:, None] == i
            if bool(at_i.any()):
                val = torch.gather(prev.permute(1, 2, 0), 2, ln.expand(b, n)[..., None])[..., 0]
                best = torch.where(at_i, val.to(best.dtype), best)
        ii, jj = torch.nonzero(best <= lim, as_tuple=True)
        out_i.append((ii + r0).cpu().numpy())
        out_j.append(jj.cpu().numpy())
    return np.concatenate(out_i), np.concatenate(out_j)


def greedy_clusters(n: int, ii: np.ndarray, jj: np.ndarray) -> list[frozenset]:
    """The greedy clusterer over the neighbour lists ``ii -> jj`` (which
    hold every read's self pair), as sets of read indices."""
    order = np.argsort(ii, kind="stable")
    ii, jj = ii[order], jj[order]
    off = np.concatenate([[0], np.cumsum(np.bincount(ii, minlength=n))])
    nb = [jj[off[a]:off[a + 1]].tolist() for a in range(n)]
    remaining = [len(x) for x in nb]
    out: list[frozenset] = []
    heap = []
    for a in range(n):
        if remaining[a] == 1:
            if nb[a][0] != a:
                raise ValueError("single-read groups should contain only the read itself")
            out.append(frozenset([a]))
        elif remaining[a] > 1:
            heap.append((-remaining[a], -a))
        else:
            raise ValueError("zero length read group")
    heapq.heapify(heap)
    live = [remaining[a] > 1 for a in range(n)]
    while heap:
        r, a = heapq.heappop(heap)
        a = -a
        if not live[a] or remaining[a] == 0:
            continue
        if -r != remaining[a]:  # stale: counts only fall, so push the current one
            heapq.heappush(heap, (-remaining[a], -a))
            continue
        live[a] = False
        cl = []
        for x in nb[a]:
            if remaining[x] == 0:
                continue
            cl.append(x)
            remaining[x] = 0
            live[x] = False
            for y in nb[x]:
                if remaining[y] > 0:
                    remaining[y] -= 1
        out.append(frozenset(cl))
    return out


def umi_groups(codes, lengths, threshold: int, device="cpu", pregroups=None) -> list[frozenset]:
    """Every UMI group, of one pre-group holding all reads or, with
    ``pregroups`` (a label a read), of each pre-group apart."""
    codes, lengths = np.asarray(codes), np.asarray(lengths)
    labels = np.zeros(len(lengths), np.int64) if pregroups is None else np.asarray(pregroups)
    out: list[frozenset] = []
    for v in np.unique(labels):
        idx = np.flatnonzero(labels == v)
        ii, jj = lev2_neighbours(codes[idx], lengths[idx], threshold, device)
        out.extend(frozenset(int(idx[k]) for k in g)
                   for g in greedy_clusters(idx.size, ii, jj))
    return out

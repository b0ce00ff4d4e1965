"""Plain reference of ``umi_group`` with two UMIs and no pre-groups
(``src/umi_group.cpp:35-112``): two reads are neighbours when the doubled
Levenshtein distance of their first UMIs is at most ``2 * threshold1`` and
that of their second UMIs at most ``2 * threshold2`` (match 0, N against
anything 1, mismatch or indel 2); the neighbour lists, each read's own
included, go to the upstream greedy clusterer
(:func:`benchmark.reference.cluster.greedy_clusters`).

The first UMIs' distances are worked out in blocks of plain ``torch``
operations on the device, between the distinct strings only; the second
UMI is evaluated only on the pairs that pass the first, after a length
prune (every length difference costs an indel, 2 units).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.cluster import greedy_clusters

__all__ = ["lev2", "cross_hits", "dual_neighbours", "dual_groups"]

#: Pad code past a string's end.
PAD = 5


def lev2(a, la, b, lb):
    """Doubled masked Levenshtein distances (int16) between the rows of
    ``a`` and ``b`` (int64 codes [..., w], pad 5) with lengths ``la`` and
    ``lb``, their leading shapes broadcast against each other."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1], la.shape, lb.shape)
    w = a.shape[-1]
    dev = a.device
    # col[i] = D[i][j] over a's positions i for b's position j; column 0 first.
    col = (2 * torch.arange(w + 1, device=dev, dtype=torch.int16)).view(
        -1, *([1] * len(shape))).expand(w + 1, *shape).clone()
    ans = (2 * la).to(torch.int16).expand(shape).clone()  # lb == 0: la deletions
    at_la = la.expand(shape).to(torch.int64)[None]
    for j in range(1, w + 1):
        bj = b[..., j - 1]
        new = torch.empty_like(col)
        new[0] = 2 * j
        for i in range(1, w + 1):
            ai = a[..., i - 1]
            sub = torch.where((ai == 4) | (bj == 4), 1, torch.where(ai == bj, 0, 2))
            new[i] = torch.minimum(torch.minimum(col[i], new[i - 1]) + 2,
                                   col[i - 1] + sub.to(torch.int16))
        col = new
        done = lb == j
        if bool(done.any()):
            ans = torch.where(done, col.gather(0, at_la)[0], ans)
    return ans


def _table(codes, lengths):
    """Codes as int64, pad 5 past each length, cut to the longest length;
    the lengths as int64."""
    codes = np.asarray(codes)
    lengths = np.asarray(lengths, np.int64)
    w = max(int(lengths.max(initial=0)), 1)
    c = np.full((codes.shape[0], w), PAD, np.int64)
    k = min(w, codes.shape[1])
    c[:, :k] = codes[:, :k]
    c[np.arange(w)[None, :] >= lengths[:, None]] = PAD
    return c, lengths


def cross_hits(qc, ql, c, cl, limit: int, device="cpu"):
    """(qi, j) int64 arrays of every query row ``qi`` of ``qc`` and table
    row ``j`` of ``c`` (int64 codes, pad 5) whose doubled distance is at
    most ``2 * limit``."""
    dev = torch.device(device)
    q = torch.as_tensor(qc, device=dev)
    qlen = torch.as_tensor(ql, device=dev)
    t = torch.as_tensor(c, device=dev)
    tlen = torch.as_tensor(cl, device=dev)
    n = t.shape[0]
    # Query rows a block: ~2^24 pairs on a card (an int16 DP state of ~1 GiB
    # at 30 positions), 2^18 on the CPU.
    block = max(1, (1 << (24 if dev.type == "cuda" else 18)) // max(n, 1))
    out_i, out_j = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for q0 in range(0, q.shape[0], block):
        d = lev2(q[q0:q0 + block, None, :], qlen[q0:q0 + block, None], t[None], tlen[None])
        ii, jj = torch.nonzero(d <= 2 * int(limit), as_tuple=True)
        out_i.append((ii + q0).cpu().numpy())
        out_j.append(jj.cpu().numpy())
    return np.concatenate(out_i), np.concatenate(out_j)


#: Pairs a block of :func:`_paired_ok`.
_PAIR_CHUNK = 1 << 20


def _paired_ok(c, cl, ia, ib, limit: int, device):
    """Whether each pair (``ia[p]``, ``ib[p]``) of rows of ``c`` lies within
    doubled distance ``2 * limit``: pairs whose lengths differ by more than
    ``limit`` fail unevaluated, the others by the DP."""
    ok = np.abs(cl[ia] - cl[ib]) <= int(limit)
    idx = np.flatnonzero(ok)
    dev = torch.device(device)
    t = torch.as_tensor(c, device=dev)
    tlen = torch.as_tensor(cl, device=dev)
    for p0 in range(0, idx.size, _PAIR_CHUNK):
        sel = idx[p0:p0 + _PAIR_CHUNK]
        a = torch.as_tensor(ia[sel], device=dev)
        b = torch.as_tensor(ib[sel], device=dev)
        d = lev2(t[a], tlen[a], t[b], tlen[b])
        ok[sel] = (d <= 2 * int(limit)).cpu().numpy()
    return ok


def _ranges(starts, counts):
    """(owner, index): the indices ``starts[k] .. starts[k] + counts[k] - 1``
    of every ``k`` in turn, each beside its ``k``."""
    owner = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    return owner, np.arange(owner.size, dtype=np.int64) - first[owner] + starts[owner]


def dual_neighbours(c1, l1, c2, l2, threshold1: int, threshold2: int, queries, device="cpu"):
    """(qi, j) int64 arrays, sorted: read ``j`` is a neighbour of read
    ``queries[qi]`` by both UMIs (codes [n, w] and lengths [n] of each;
    every read of the table a candidate)."""
    c1, l1 = _table(c1, l1)
    c2, l2 = _table(c2, l2)
    queries = np.asarray(queries, np.int64)
    # The first UMI between distinct strings: the queries' against all.
    u1, inv = np.unique(c1, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    ulen = (u1 != PAD).sum(axis=1)
    uq, q_inv = np.unique(inv[queries], return_inverse=True)
    hi, hj = cross_hits(u1[uq], ulen[uq], u1, ulen, threshold1, device)
    # Unique-level hits to read pairs: each query against every read of
    # each unique string it reaches.
    by_u = np.argsort(inv, kind="stable")
    u_cnt = np.bincount(inv, minlength=u1.shape[0])
    u_off = np.concatenate([[0], np.cumsum(u_cnt)])
    h_cnt = np.bincount(hi, minlength=uq.size)
    h_off = np.concatenate([[0], np.cumsum(h_cnt)])
    k, hk = _ranges(h_off[q_inv], h_cnt[q_inv])  # each query's hits
    x = hj[hk]
    p, rk = _ranges(u_off[x], u_cnt[x])  # each hit's reads
    qi, j = k[p], by_u[rk]
    # The second UMI on those pairs alone.
    keep = _paired_ok(c2, l2, queries[qi], j, threshold2, device)
    qi, j = qi[keep], j[keep]
    order = np.lexsort((j, qi))
    return qi[order], j[order]


def dual_groups(c1, l1, c2, l2, threshold1: int, threshold2: int, device="cpu"):
    """Every group of the reads, in the greedy clusterer's emission order,
    as sets of read indices."""
    n = np.asarray(l1).shape[0]
    ii, jj = dual_neighbours(c1, l1, c2, l2, threshold1, threshold2, np.arange(n), device)
    return greedy_clusters(n, ii, jj)

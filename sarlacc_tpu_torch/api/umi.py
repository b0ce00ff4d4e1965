"""UMI masking and grouping.

Counterpart of ``sarlacc_tpu/api/umi.py`` (``quality_mask``,
``expected_dist`` — R/expectedDist.R — and ``umi_group``; R/umiGroup.R +
src/umi_group.cpp:35-112).  Small pre-groups take the dense distance matrix
on the device (:func:`..ops.levenshtein.lev2_matrix`); from
:data:`SPARSE_MIN` sequences up, duplicates collapse and the sparse search
(:func:`..ops.levenshtein.lev2_neighbor_pairs`: the native symmetric-delete
filter, or the row-block scan on the device where the filter's heuristics
fail) emits only surviving pairs.  Neighbour lists follow
the trie's DFS order (lexicographic over A<C<G<T<N, prefixes first,
insertion order within duplicates — sorted_trie.cpp:285-296), so the native
greedy clusterer produces the reference's clusters.  Indices are 0-based.
With a ``mesh``, pre-groups are shuffled so each lands wholly on one shard
and grouped there (:func:`..parallel.shuffle.sharded_umi_group`); the merged
output equals the solo run's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.encode import SeqBatch
from ..core.quality import get_encoding
from ..device import env_number, resolve_device
from ..native import greedy_cluster_csr, greedy_cluster_weighted_csr
from ..ops.levenshtein import _unique_rows, lev2_condensed, lev2_matrix, lev2_neighbor_pairs
from ..parallel.context import mesh_device
from ..refimpl.masking import mask_bad_bases

__all__ = ["quality_mask", "expected_dist", "umi_group"]

#: Below this many sequences the dense distance matrix is built; above it
#: the sparse native search keeps memory O(neighbours) instead of O(n^2).
#: ``SARLACC_SPARSE_MIN`` overrides it at import, as in the JAX package (a
#: malformed value warns and keeps 2048).
SPARSE_MIN = env_number("SARLACC_SPARSE_MIN", int, 2048)


def _as_batch(seqs) -> SeqBatch:
    if isinstance(seqs, SeqBatch):
        return seqs
    return SeqBatch.from_strings(list(seqs))


def quality_mask(seqs, max_err: float | None = None, qual_type: str = "phred") -> SeqBatch:
    """Mask low-quality bases with N; ``max_err=None`` just drops qualities."""
    batch = _as_batch(seqs)
    if max_err is None or (isinstance(max_err, float) and np.isnan(max_err)):
        return SeqBatch(batch.codes.copy(), batch.lengths.copy(), None, batch.names)
    return mask_bad_bases(batch, get_encoding(qual_type), float(max_err))


def expected_dist(
    seqs, max_err: float | None = None, qual_type: str = "phred", device=None,
) -> np.ndarray:
    """Condensed all-pairs masked Levenshtein distances (float, N = 0.5).

    ``device=None`` means CUDA (the distance DP runs there).
    """
    dev = resolve_device(device)
    batch = quality_mask(seqs, max_err, qual_type)
    d2 = lev2_condensed(batch.codes.astype(np.int32), batch.lengths, device=dev)
    return d2.astype(np.float64) / 2.0


def _dfs_order(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Trie DFS emission order: lexicographic with prefixes first, stable.

    Padding must sort *before* real bases for prefix-first semantics, so the
    sort key remaps pad(5) -> -1.
    """
    key = codes.astype(np.int8).copy()
    width = codes.shape[1]
    pos = np.arange(width)[None, :]
    key[pos >= lengths[:, None]] = -1
    # np.lexsort: last key is primary -> feed columns right-to-left.
    return np.lexsort(tuple(key[:, c] for c in range(width - 1, -1, -1)))


def _neighbor_csr(
    codes: np.ndarray, lengths: np.ndarray, limit: int, device
) -> tuple[np.ndarray, np.ndarray]:
    """Thresholded neighbour lists as CSR (flat int32, offsets int64).

    Small n: the dense distance matrix (one threshold pass).  Large n:
    duplicate strings collapse first, then the sparse search emits only
    surviving (i, j) pairs; the n x n matrix never exists.
    """
    n = codes.shape[0]
    if n < SPARSE_MIN:
        mat = lev2_matrix(codes, lengths, device=device)
        adj = mat <= 2 * int(limit)
        order = _dfs_order(codes, lengths)
        A = adj[order].T  # [query, rank]
        q_arr, rank_arr = np.nonzero(A)  # row-major: q asc, rank asc
        flat = order[rank_arr].astype(np.int32)
        offsets = np.concatenate(
            [[0], np.cumsum(A.sum(axis=1, dtype=np.int64))]
        )
        return flat, offsets

    u_codes, first_idx, inv, cnt = _unique_rows(codes)
    inv = inv.reshape(-1)
    u_lens = lengths[first_idx].astype(np.int32)
    m = u_codes.shape[0]
    qi, qj = lev2_neighbor_pairs(
        u_codes.astype(np.int32), u_lens, limit, assume_unique=True, device=device
    )

    off_diag = qi != qj
    ua = np.concatenate([qi, qj[off_diag]]).astype(np.int64)
    va = np.concatenate([qj, qi[off_diag]]).astype(np.int64)

    uorder = _dfs_order(u_codes, u_lens)
    urank = np.empty(m, np.int64)
    urank[uorder] = np.arange(m)

    sortk = np.lexsort((urank[va], ua))
    ua, va = ua[sortk], va[sortk]
    u_deg = np.bincount(ua, minlength=m)
    u_off = np.concatenate([[0], np.cumsum(u_deg)])

    # Reads per unique, index order (== DFS order within a duplicate block:
    # the stable lexsort keeps equal strings in index order).
    order_by_uid = np.argsort(inv, kind="stable").astype(np.int64)
    uid_off = np.concatenate([[0], np.cumsum(cnt)])

    # Expand each unique-level neighbour v to its reads R_v.
    lens_e = cnt[va]
    e_cum = np.concatenate([[0], np.cumsum(lens_e)])
    total = int(e_cum[-1])
    offs = np.repeat(uid_off[va] - e_cum[:-1], lens_e)
    L_flat = order_by_uid[offs + np.arange(total)].astype(np.int32)
    exp_start_u = e_cum[u_off[:-1]]
    exp_end_u = e_cum[u_off[1:]]

    # Every read of unique u shares u's expanded list.
    deg_r = (exp_end_u - exp_start_u)[inv]
    offsets = np.concatenate([[0], np.cumsum(deg_r)])
    offs_r = np.repeat(exp_start_u[inv] - offsets[:-1], deg_r)
    flat = L_flat[offs_r + np.arange(int(offsets[-1]))]
    return flat, offsets


def _group_large_single(
    codes: np.ndarray, lengths: np.ndarray, limit: int, device
) -> list[np.ndarray]:
    """Large-n single-UMI grouping on the collapsed unique-string graph.

    Identical reads share a neighbour list, so the read-level greedy
    clusterer (cluster_umis.cpp:7-112) acts on whole duplicate blocks; the
    weighted unique-level clusterer (msa_host.cpp::greedy_cluster_weighted)
    reproduces it exactly — W(u) = sum of duplicate counts over unclaimed
    DFS neighbours, ties to the largest member read index.
    """
    u_codes, first_idx, inv, cnt = _unique_rows(codes)
    inv = inv.reshape(-1)
    u_lens = lengths[first_idx].astype(np.int32)
    m = u_codes.shape[0]
    qi, qj = lev2_neighbor_pairs(
        u_codes.astype(np.int32), u_lens, limit, assume_unique=True, device=device
    )

    off_diag = qi != qj
    ua = np.concatenate([qi, qj[off_diag]]).astype(np.int64)
    va = np.concatenate([qj, qi[off_diag]]).astype(np.int64)

    uorder = _dfs_order(u_codes, u_lens)
    urank = np.empty(m, np.int64)
    urank[uorder] = np.arange(m)
    sortk = np.lexsort((urank[va], ua))
    ua, va = ua[sortk], va[sortk]
    u_off = np.concatenate([[0], np.cumsum(np.bincount(ua, minlength=m))])

    order_by_uid = np.argsort(inv, kind="stable").astype(np.int64)
    uid_off = np.concatenate([[0], np.cumsum(cnt)])
    maxidx = order_by_uid[uid_off[1:] - 1]  # stable sort: block max is last

    members, offs = greedy_cluster_weighted_csr(
        va.astype(np.int32), u_off, cnt.astype(np.int64), maxidx
    )
    # Expand unique members back to read indices (reads of each unique in
    # ascending index order, matching the read-level claim loop).
    lens_m = cnt[members]
    e_cum = np.concatenate([[0], np.cumsum(lens_m)])
    total = int(e_cum[-1])
    offs_flat = np.repeat(uid_off[members] - e_cum[:-1], lens_m)
    flat_reads = order_by_uid[offs_flat + np.arange(total)]
    read_offs = e_cum[offs]
    return [
        flat_reads[read_offs[c] : read_offs[c + 1]]
        for c in range(offs.size - 1)
    ]


def _group_one(
    c1: np.ndarray,
    l1: np.ndarray,
    threshold1: int,
    device,
    c2: np.ndarray | None = None,
    l2: np.ndarray | None = None,
    threshold2: int | None = None,
) -> list[np.ndarray]:
    """One pre-group of two or more reads, grouped on ``device``: its
    clusters as index arrays into the pre-group, in greedy emission order.
    The solo path and the mesh path
    (:func:`..parallel.shuffle.sharded_umi_group`) both group through it."""
    curn = c1.shape[0]
    if c2 is None and curn >= SPARSE_MIN:
        # Single-UMI scale path: cluster on the collapsed unique graph.
        return _group_large_single(c1, l1, threshold1, device)

    flat, offs = _neighbor_csr(c1, l1, threshold1, device)
    if c2 is not None:
        flat2, offs2 = _neighbor_csr(c2, l2, threshold2, device)
        # UMI2-query emission order, membership-tested against UMI1
        # (umi_group.cpp:85-100) — vectorized as (query, member) key
        # intersection over the two CSR lists.
        rq1 = np.repeat(np.arange(curn, dtype=np.int64), np.diff(offs))
        rq2 = np.repeat(np.arange(curn, dtype=np.int64), np.diff(offs2))
        keep = np.isin(
            rq2 * curn + flat2.astype(np.int64),
            rq1 * curn + flat.astype(np.int64),
        )
        flat = flat2[keep]
        offs = np.concatenate(
            [[0], np.cumsum(np.bincount(rq2[keep], minlength=curn))]
        )
    return [np.asarray(cl, dtype=np.int64) for cl in greedy_cluster_csr(flat, offs)]


def umi_group(
    umi1,
    threshold1: int = 3,
    umi2=None,
    threshold2: int | None = None,
    max_err: float | None = None,
    groups: Sequence | None = None,
    qual_type: str = "phred",
    device=None,
    mesh=None,
) -> list[np.ndarray]:
    """Group reads by UMI similarity; returns a list of 0-based index arrays.

    ``device=None`` means CUDA (the dense distance matrices and the
    row-block neighbour scan run there).  With a ``mesh`` each pre-group
    is grouped on one shard's device.
    """
    dev = mesh_device(mesh, device)
    if threshold2 is None:
        threshold2 = threshold1
    b1 = quality_mask(umi1, max_err, qual_type)
    b2 = quality_mask(umi2, max_err, qual_type) if umi2 is not None else None
    if b2 is not None and len(b2) != len(b1):
        raise ValueError("'umi1' and 'umi2' should have the same length")

    n = len(b1)
    if groups is None:
        by_group = [np.arange(n, dtype=np.int64)]
    elif isinstance(groups, (list, tuple)) and groups and isinstance(
        groups[0], (list, tuple, np.ndarray)
    ):
        by_group = [np.asarray(g, dtype=np.int64) for g in groups]
    else:
        # Factor-style vector: split indices by value, R split() order
        # (sorted unique values).
        groups = np.asarray(groups)
        if groups.shape[0] != n:
            raise ValueError("'groups' length must match the number of UMIs")
        by_group = [
            np.flatnonzero(groups == v).astype(np.int64)
            for v in np.unique(groups)
        ]

    if mesh is not None:
        from ..parallel.shuffle import sharded_umi_group

        return sharded_umi_group(mesh, b1, int(threshold1), by_group, b2, int(threshold2))

    output: list[np.ndarray] = []
    for g in by_group:
        if g.size == 1:
            output.append(g.copy())
            continue
        c2 = b2.codes[g].astype(np.int32) if b2 is not None else None
        l2 = b2.lengths[g] if b2 is not None else None
        for cl in _group_one(b1.codes[g].astype(np.int32), b1.lengths[g], threshold1, dev,
                             c2, l2, threshold2):
            output.append(g[cl])
    return output

"""Masked Levenshtein distances for UMI grouping (PyTorch + native host).

Counterpart of ``sarlacc_tpu/ops/levenshtein.py`` for the grouping path.
Costs are doubled integers (match 0, N-vs-anything 1, mismatch/indel 2 —
sorted_trie.cpp:13-21), so ``d2 <= 2*limit`` reproduces the reference trie's
neighbour sets exactly.

* :func:`lev2_matrix` — the dense all-pairs matrix for small groups, as a
  plain PyTorch column DP on the device: the within-column recurrence
  ``col[i] = min(prev[i]+2, col[i-1]+2, prev[i-1]+ms)`` unrolls to a shifted
  prefix-min (``cummin``), so pairs and positions stay parallel.
* :func:`lev2_neighbor_pairs` — thresholded neighbours at scale through the
  native symmetric-delete search.  Where the JAX package would take its
  device row-block scan (the filter's heuristics fail) this port raises
  ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["lev2_matrix", "lev2_neighbor_pairs"]

#: Query rows per distance tile: bounds the [TI, n, L+1] DP state.
_TILE_CELLS = 1 << 24


def _lev2_block(a, la, b, lb):
    """Doubled distances between every row of ``a`` and every row of ``b``.

    a [TI, L], b [n, L] int32 codes (pad 5); la [TI], lb [n] int32.
    Returns int32 [TI, n].
    """
    TI, L = a.shape
    n = b.shape[0]
    dev = a.device
    idx2 = 2 * torch.arange(L + 1, dtype=torch.int32, device=dev)
    prev = idx2.expand(TI, n, L + 1)
    ans = (2 * la)[:, None].expand(TI, n)  # lb == 0 answer
    a_is_n = (a == 4)[:, None, :]
    a3 = a[:, None, :]
    la_idx = la.to(torch.int64)[:, None, None].expand(TI, n, 1)
    for jx in range(L):
        bj = b[:, jx][None, :, None]
        ms = torch.where(
            (bj == 4) | a_is_n, 1, torch.where(a3 == bj, 0, 2)
        ).to(torch.int32)
        cand = torch.cat(
            [
                torch.full((TI, n, 1), 2 * (jx + 1), dtype=torch.int32, device=dev),
                torch.minimum(prev[..., 1:] + 2, prev[..., :-1] + ms),
            ],
            dim=-1,
        )
        col = torch.cummin(cand - idx2, dim=-1).values + idx2
        got = col.gather(-1, la_idx)[..., 0]
        ans = torch.where((jx + 1 == lb)[None, :], got, ans)
        prev = col
    return ans


def lev2_matrix(codes: np.ndarray, lengths: np.ndarray, device=None) -> np.ndarray:
    """Full symmetric doubled-distance matrix [n, n] int32 (host numpy).

    The diagonal is computed, not assumed zero: an ``N`` matches nothing,
    itself included, so self-distances of N-containing sequences are
    positive.
    """
    n = codes.shape[0]
    dev = torch.device("cpu" if device is None else device)
    c = torch.as_tensor(np.asarray(codes, np.int32), device=dev)
    lens = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
    L = c.shape[1]
    tile = max(1, _TILE_CELLS // max(n * (L + 1), 1))
    out = np.zeros((n, n), dtype=np.int32)
    for i0 in range(0, n, tile):
        blk = _lev2_block(c[i0 : i0 + tile], lens[i0 : i0 + tile], c, lens)
        out[i0 : i0 + tile] = blk.cpu().numpy()
    return out


def _unique_rows(codes: np.ndarray):
    """np.unique(codes, axis=0) with all four returns, but ~20x faster for
    short code rows: rows pack into one big-endian base-6 uint64 key (codes
    are 0..5 incl. pad), preserving np.unique's row-lexicographic order, so
    the sort runs on scalars instead of void views."""
    n, W = codes.shape
    if n == 0 or W > 24 or (W and (codes.min() < 0 or codes.max() > 5)):
        return np.unique(
            codes, axis=0, return_index=True, return_inverse=True,
            return_counts=True,
        )
    w6 = np.power(np.uint64(6), np.arange(W - 1, -1, -1, dtype=np.uint64))
    keys = codes.astype(np.uint64) @ w6
    _, first_idx, inv, cnt = np.unique(
        keys, return_index=True, return_inverse=True, return_counts=True
    )
    return codes[first_idx], first_idx, inv, cnt


#: Max packed variant length for the symmetric-delete filter: base-5 digits
#: plus a leading sentinel must fit uint64 (5^25 * 2 < 2^64).
_FILTER_MAX_LEN = 24
#: Max deletion variants per string before the filter costs more than it saves.
_FILTER_MAX_VARIANTS = 512


def _neighbor_pairs_filtered(
    codes: np.ndarray, lengths: np.ndarray, limit: int, thr: int
) -> tuple[np.ndarray, np.ndarray]:
    """Exact neighbour pairs in unique-string space via the native
    symmetric-delete search (candidate hashing + banded verification).

    Exactness: for N-free pairs every edit costs exactly 2 doubled units, so
    any pair within ``limit`` shares a ``<=limit``-deletion variant; every
    candidate is then verified by the exact banded DP.  Strings containing
    N skip the filter and verify against *all* strings.  Where the filter's
    heuristics do not hold the JAX package scans row blocks on the device;
    this port raises instead.
    """
    n = codes.shape[0]
    Lmax = int(lengths.max(initial=0))
    k = int(limit)
    if Lmax > _FILTER_MAX_LEN:
        raise NotImplementedError(
            f"UMIs longer than {_FILTER_MAX_LEN} need the device row-block "
            "neighbour scan, which the PyTorch port does not have yet"
        )
    nvar = sum(
        int(np.prod(np.arange(Lmax - d + 1, Lmax + 1)) // np.prod(np.arange(1, d + 1)))
        if d else 1
        for d in range(min(k, Lmax) + 1)
    )
    if nvar > _FILTER_MAX_VARIANTS:
        raise NotImplementedError(
            f"{nvar} deletion variants per UMI exceed {_FILTER_MAX_VARIANTS}; "
            "the device row-block neighbour scan is not ported yet"
        )

    pos = np.arange(codes.shape[1])[None, :]
    has_n = ((codes == 4) & (pos < lengths[:, None])).any(axis=1)
    n_rows = np.flatnonzero(has_n)
    a_rows = np.flatnonzero(~has_n)
    if n_rows.size * n > max(1 << 26, n):
        raise NotImplementedError(
            "too many N-containing UMIs for the symmetric-delete filter; the "
            "device row-block neighbour scan is not ported yet"
        )

    from ..native import ABORTED, sym_delete_verify_native, verify_pairs_native

    fused = sym_delete_verify_native(
        codes[a_rows], lengths[a_rows], k, int(limit), thr, raw_cap=1 << 31
    )
    if fused is ABORTED:
        raise NotImplementedError(
            "candidate volume exceeded the symmetric-delete cap; the device "
            "row-block neighbour scan is not ported yet"
        )
    sa = a_rows[(fused >> np.uint64(32)).astype(np.int64)]
    sb = a_rows[(fused & np.uint64(0xFFFFFFFF)).astype(np.int64)]

    parts_a = [sa]
    parts_b = [sb]
    if n_rows.size:
        # N rows vs every row (self included — the diagonal is not free for
        # them), upper-triangle normalized, deduped against double-counting
        # N-vs-N pairs.
        ra = np.repeat(n_rows, n)
        rb = np.tile(np.arange(n, dtype=np.int64), n_rows.size)
        lo = np.minimum(ra, rb)
        hi = np.maximum(ra, rb)
        key = (lo.astype(np.uint64) << np.uint64(32)) | hi.astype(np.uint64)
        uk = np.unique(key)
        na = (uk >> np.uint64(32)).astype(np.int64)
        nb = (uk & np.uint64(0xFFFFFFFF)).astype(np.int64)
        ok = verify_pairs_native(codes, lengths, na, nb, int(limit), thr)
        parts_a.append(na[ok])
        parts_b.append(nb[ok])
    ua = np.concatenate(parts_a)
    ub = np.concatenate(parts_b)
    # Diagonal for N-free strings is always distance 0.
    ua = np.concatenate([ua, a_rows])
    ub = np.concatenate([ub, a_rows])
    return ua.astype(np.int64), ub.astype(np.int64)


def lev2_neighbor_pairs(
    codes: np.ndarray, lengths: np.ndarray, limit: int, assume_unique: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Sparse thresholded neighbours: all (i, j), i <= j, with doubled
    distance <= 2*limit — including the diagonal, which is NOT free when a
    sequence contains N (sorted_trie.cpp:13-21).

    Identical rows share one search (``assume_unique=True`` skips that dedup
    when the caller already collapsed duplicates).  Returns (qi, qj) int32
    arrays in original index space.
    """
    n_reads = codes.shape[0]
    if n_reads == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    lengths = np.asarray(lengths, np.int32)
    if assume_unique:
        n = n_reads
        ucnt = np.ones(n, np.int64)
        mem_order = np.arange(n, dtype=np.int64)
        mem_start = np.arange(n, dtype=np.int64)
    else:
        uniq, _, uid, _ = _unique_rows(codes)
        uid = uid.ravel().astype(np.int64)
        n = uniq.shape[0]
        ucnt = np.bincount(uid, minlength=n).astype(np.int64)
        mem_order = np.argsort(uid, kind="stable").astype(np.int64)
        mem_start = np.concatenate([[0], np.cumsum(ucnt)[:-1]])
        ulen = np.zeros(n, np.int32)
        ulen[uid] = lengths
        codes, lengths = uniq, ulen

    ua, ub = _neighbor_pairs_filtered(codes, lengths, int(limit), 2 * int(limit))
    if ua.size == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    if assume_unique:
        return (
            np.minimum(ua, ub).astype(np.int32),
            np.maximum(ua, ub).astype(np.int32),
        )

    # Unique ids -> read space.  Each unique pair (a, b) expands to the
    # cross product of its member read sets; for a == b keep one
    # orientation per unordered read pair.
    ca = ucnt[ua]
    cb = ucnt[ub]
    sz = ca * cb
    starts = np.concatenate([[0], np.cumsum(sz)[:-1]])
    total = int(sz.sum())
    pid = np.repeat(np.arange(ua.size), sz)
    o = np.arange(total, dtype=np.int64) - starts[pid]
    x = mem_order[mem_start[ua][pid] + o // cb[pid]]
    y = mem_order[mem_start[ub][pid] + o % cb[pid]]
    keep = (ua[pid] != ub[pid]) | (x <= y)
    x, y = x[keep], y[keep]
    return (
        np.minimum(x, y).astype(np.int32),
        np.maximum(x, y).astype(np.int32),
    )

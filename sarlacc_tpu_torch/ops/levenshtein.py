"""Masked Levenshtein distances for UMI grouping (PyTorch + native host).

Counterpart of ``sarlacc_tpu/ops/levenshtein.py`` for the grouping path.
Costs are doubled integers (match 0, N-vs-anything 1, mismatch/indel 2 —
sorted_trie.cpp:13-21), so ``d2 <= 2*limit`` reproduces the reference trie's
neighbour sets exactly.

* :func:`lev2_matrix` — the dense all-pairs matrix for small groups.  The
  distance DP runs on the device: kernel I (:mod:`.cuda_lev2`, one thread
  a pair, its column in registers) on CUDA tensors; on CPU tensors its
  plain version :func:`_lev2_scan`, a column DP whose within-column
  recurrence ``col[i] = min(prev[i]+2, col[i-1]+2, prev[i-1]+ms)`` unrolls
  to a shifted prefix-min, so pairs and positions stay parallel.
* :func:`lev2_neighbor_pairs` — thresholded neighbours at scale through one
  of the JAX package's two exact engines: the native symmetric-delete
  search where its heuristics hold, else the row-block scan
  (:func:`_neighbor_pairs_rowblock`) on the caller's device.
* :func:`lev2_condensed` — all pairs, condensed (i < j, i-major), for
  ``expected_dist``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import count
from . import cuda_lev2

__all__ = ["lev2_condensed", "lev2_matrix", "lev2_neighbor_pairs"]

#: Query rows per distance tile: bounds the [TI, n, L+1] DP state.
_TILE_CELLS = 1 << 24


def _lev2_scan(a, la, b, lb):
    """Doubled distances between code rows ``a`` and ``b``, broadcasting.

    a [..., L] and b [..., L] int32 codes (pad 5) whose leading shapes
    broadcast to the result's; la and lb int32 of those leading shapes.
    The counterpart of the JAX ``_pairs_scan`` / ``_tile_d2`` (one column of
    ``b`` per step).  Returns int32 of the broadcast leading shape.

    The DP position is the leading axis of the state, so each position is
    one contiguous plane, and the state is the column minus its ramp,
    ``q[k] = col[k] - 2k``: ``q' = prefix-min([2(j+1), min(q[1:] + 2,
    q[:-1] + ms - 2)])``, with the prefix min as L in-place minimums over
    planes.  ``ms - 2`` for each code of ``b`` comes from a table of ``a``
    ([6, L, ...]: 0 mismatch, -2 match, -1 N).
    """
    L = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1], la.shape, lb.shape)
    dev = a.device
    at = a.movedim(-1, 0)  # [L, ...]
    codes = torch.arange(6, dtype=torch.int32, device=dev).view(6, *([1] * at.dim()))
    table = torch.where(
        (codes == 4) | (at == 4), -1, torch.where(at == codes, -2, 0)
    ).to(torch.int32).expand(6, L, *shape)
    q = torch.zeros((L + 1, *shape), dtype=torch.int32, device=dev)
    cand = torch.empty_like(q)
    ans = (2 * la).expand(shape)  # lb == 0 answer
    la_idx = la.to(torch.int64)[None].expand(1, *shape)
    for jx in range(L):
        bj = b[..., jx].to(torch.int64)[None, None].expand(1, L, *shape)
        ms2 = table.gather(0, bj)[0]
        cand[0] = 2 * (jx + 1)
        torch.minimum(q[1:] + 2, q[:-1] + ms2, out=cand[1:])
        for k in range(1, L + 1):
            torch.minimum(cand[k], cand[k - 1], out=cand[k])
        q, cand = cand, q
        got = q.gather(0, la_idx)[0] + 2 * la
        ans = torch.where(jx + 1 == lb, got, ans)
    return ans


def _lev2_block(a, la, b, lb):
    """Doubled distances between every row of ``a`` and every row of ``b``.

    a [TI, L], b [n, L] int32 codes (pad 5); la [TI], lb [n] int32.
    Returns int32 [TI, n]: kernel I (:func:`.cuda_lev2.lev2_cross`) on
    CUDA tensors, :func:`_lev2_scan` on CPU ones.
    """
    if a.is_cuda:
        return cuda_lev2.lev2_cross(a, la, b, lb)
    return _lev2_scan(a[:, None, :], la[:, None], b[None], lb[None])


def _lev2_pairs(codes, lengths, ia, ib):
    """Doubled distances of the pairs (``ia[p]``, ``ib[p]``) of one code
    table [n, L] (int64 index tensors [P]).  Returns int32 [P]: kernel I
    (:func:`.cuda_lev2.lev2_paired`) on CUDA tensors, :func:`_lev2_scan`
    on the gathered rows on CPU ones."""
    if codes.is_cuda:
        return cuda_lev2.lev2_paired(codes, lengths, ia, ib)
    return _lev2_scan(codes[ia], lengths[ia], codes[ib], lengths[ib])


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


#: Largest n whose condensed distances come from the dense matrix; above
#: it the pairs run in bounded chunks and no n x n array exists.
_CONDENSED_DENSE_MAX = 8192


def lev2_condensed(
    codes: np.ndarray, lengths: np.ndarray, max_pairs: int = 1 << 22, device=None,
) -> np.ndarray:
    """All-pairs doubled distances, condensed (i < j, i-major), int32.

    The counterpart of the JAX ``lev2_condensed`` and of
    compute_lev_masked.cpp's emission order (:44-55); divide by 2.0 for the
    float masked distance.  Up to :data:`_CONDENSED_DENSE_MAX` strings the
    dense tiles of :func:`lev2_matrix` serve; above, rows are taken in
    chunks of at most ``max_pairs`` pairs (at least one row), each one
    per-pair DP on ``device``.
    """
    n = codes.shape[0]
    codes = np.asarray(codes, np.int32)
    lengths = np.asarray(lengths, np.int32)
    if 2 <= n <= _CONDENSED_DENSE_MAX:
        mat = lev2_matrix(codes, lengths, device=device)
        iu, ju = np.triu_indices(n, k=1)
        return mat[iu, ju].astype(np.int32)
    dev = torch.device("cpu" if device is None else device)
    c = torch.as_tensor(codes, device=dev)
    lens = torch.as_tensor(lengths, device=dev)
    out = np.zeros(n * (n - 1) // 2, dtype=np.int32)
    per_row = np.arange(n - 1, -1, -1, dtype=np.int64)  # pairs of row i
    row_end = np.cumsum(per_row)
    at = i0 = 0
    while i0 < n - 1:
        i1 = max(int(np.searchsorted(row_end, at + max_pairs, side="right")), i0 + 1)
        i1 = min(i1, n - 1)
        rows = np.arange(i0, i1, dtype=np.int64)
        cnt = per_row[i0:i1]
        total = int(cnt.sum())
        ia = np.repeat(rows, cnt)
        ja = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt) + ia + 1
        ia_t = torch.as_tensor(ia, device=dev)
        ja_t = torch.as_tensor(ja, device=dev)
        d2 = _lev2_pairs(c, lens, ia_t, ja_t)
        out[at : at + total] = d2.cpu().numpy()
        at += total
        i0 = i1
    return out


#: Base-6 positions a uint64 word holds (6^24 < 2^64).
_PACK_POSITIONS = 24


def _unique_rows(codes: np.ndarray):
    """np.unique(codes, axis=0) with all four returns, but ~10-20x faster:
    each row packs into ceil(W / 24) big-endian base-6 uint64 words (codes
    are 0..5 incl. pad), word 0 holding positions 0-23, so comparing the
    words left to right is np.unique's row-lexicographic order and the sort
    runs on scalars instead of void views.  One stable np.lexsort, word 0
    primary, sorts them; its first row of each run is the first occurrence.
    Codes outside 0..5, or no rows, take np.unique itself.  Counts
    ``unique_rows.packed`` or ``unique_rows.fallback`` a call."""
    n, W = codes.shape
    if n == 0 or (W and (codes.min() < 0 or codes.max() > 5)):
        count("unique_rows.fallback")
        return np.unique(
            codes, axis=0, return_index=True, return_inverse=True,
            return_counts=True,
        )
    count("unique_rows.packed")
    words = []
    six = np.uint64(6)
    for s in range(0, max(W, 1), _PACK_POSITIONS):  # W == 0: one zero word
        word = np.zeros(n, np.uint64)
        for j in range(s, min(s + _PACK_POSITIONS, W)):  # Horner, big-endian
            word *= six
            word += codes[:, j].astype(np.uint64)
        words.append(word)
    order = np.lexsort(words[::-1])  # the last key is the primary one
    new_run = np.zeros(n, bool)
    new_run[0] = True
    for word in words:
        sw = word[order]
        new_run[1:] |= sw[1:] != sw[:-1]
    starts = np.flatnonzero(new_run)
    first_idx = order[starts]
    inv = np.empty(n, np.intp)
    inv[order] = np.cumsum(new_run) - 1
    cnt = np.diff(np.append(starts, n))
    return codes[first_idx], first_idx, inv, cnt


#: Max packed variant length for the symmetric-delete filter: base-5 digits
#: plus a leading sentinel must fit uint64 (5^25 * 2 < 2^64).
_FILTER_MAX_LEN = 24
#: Max deletion variants per string before the filter costs more than it saves.
_FILTER_MAX_VARIANTS = 512


def _neighbor_pairs_filtered(
    codes: np.ndarray, lengths: np.ndarray, limit: int, thr: int
) -> tuple[np.ndarray, np.ndarray] | None:
    """Exact neighbour pairs in unique-string space via the native
    symmetric-delete search (candidate hashing + banded verification);
    None where the filter's heuristics do not hold and the caller takes
    the row-block scan, at the same four points as the JAX function.

    Exactness: for N-free pairs every edit costs exactly 2 doubled units, so
    any pair within ``limit`` shares a ``<=limit``-deletion variant; every
    candidate is then verified by the exact banded DP.  Strings containing
    N skip the filter and verify against *all* strings.
    """
    n = codes.shape[0]
    Lmax = int(lengths.max(initial=0))
    k = int(limit)
    if Lmax > _FILTER_MAX_LEN:
        return None
    nvar = sum(
        int(np.prod(np.arange(Lmax - d + 1, Lmax + 1)) // np.prod(np.arange(1, d + 1)))
        if d else 1
        for d in range(min(k, Lmax) + 1)
    )
    if nvar > _FILTER_MAX_VARIANTS:
        return None

    pos = np.arange(codes.shape[1])[None, :]
    has_n = ((codes == 4) & (pos < lengths[:, None])).any(axis=1)
    n_rows = np.flatnonzero(has_n)
    a_rows = np.flatnonzero(~has_n)
    # N-containing strings pair against everything: bail out if that cross
    # product alone rivals the dense scan.
    if n_rows.size * n > max(1 << 26, n):
        return None

    from ..native import ABORTED, sym_delete_verify_native, verify_pairs_native

    fused = sym_delete_verify_native(
        codes[a_rows], lengths[a_rows], k, int(limit), thr, raw_cap=1 << 31
    )
    if fused is ABORTED:
        return None
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


#: DP cells (rows x cols x (L+1) int32 entries) per launch group of the
#: plain row-block scan: 256 MiB per copy of the state, of which a group
#: holds about five.
_SCAN_CELLS = 1 << 26


def _rowblock_hits_plain(c, lens, s_len, thr: int, limit: int, tile: int):
    """The thresholded row-block scan's plain version (kernel I's
    thresholded form, :func:`.cuda_lev2.lev2_hits`, on the same inputs):
    row blocks of ``tile`` rows of the length-sorted codes ``c`` [n, W]
    against columns ``j >= i`` up to the exact length prune ``hi_len +
    limit``, several column tiles a launch group (bounded by
    :data:`_SCAN_CELLS`), each group's distances by :func:`_lev2_scan`,
    thresholded and compacted with ``torch.nonzero``.  Returns int64 keys
    ``i * n + j`` of the hits, sorted (row-major, ascending j)."""
    n, W = c.shape
    dev = c.device
    c = c.to(torch.int32)
    TI = max(1, min(int(tile), n))
    cols_per_group = max(TI, _SCAN_CELLS // (TI * (W + 1)) // TI * TI)
    keys = [torch.zeros(0, dtype=torch.int64, device=dev)]
    for i0 in range(0, n, TI):
        i1 = min(i0 + TI, n)
        hi_len = int(s_len[i1 - 1])
        j_end = min(max(int(np.searchsorted(s_len, hi_len + int(limit), side="right")), i0 + 1), n)
        ig = torch.arange(i0, i1, device=dev)[:, None]
        for j0 in range(i0, j_end, cols_per_group):
            j1 = min(j0 + cols_per_group, j_end)
            d2 = _lev2_scan(c[i0:i1, None, :], lens[i0:i1, None], c[None, j0:j1], lens[None, j0:j1])
            jg = torch.arange(j0, j1, device=dev)[None, :]
            hit = torch.nonzero((d2 <= thr) & (jg >= ig))
            keys.append((hit[:, 0] + i0) * n + hit[:, 1] + j0)
    return torch.sort(torch.cat(keys)).values


def _rowblock_hits(c, lens, s_len, thr: int, limit: int, tile: int):
    """The hits of one row-block scan as sorted int64 keys ``i * n + j``:
    kernel I's thresholded form (:func:`.cuda_lev2.lev2_hits`) on CUDA
    tensors, :func:`_rowblock_hits_plain` on CPU ones."""
    run = cuda_lev2.lev2_hits if c.is_cuda else _rowblock_hits_plain
    return run(c, lens, s_len, thr, limit, tile)


def _neighbor_pairs_rowblock(
    codes: np.ndarray, lengths: np.ndarray, thr: int, limit: int, tile: int,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense row-block scan (unique-string space), the counterpart of the
    JAX ``_neighbor_pairs_rowblock`` (``sarlacc_tpu/ops/levenshtein.py:592``).

    Strings sort by length (stable); a block of ``tile`` rows scans only
    columns ``j >= i`` up to the exact length prune ``hi_len + limit`` (any
    pair costs at least 2 per length difference, so no pair beyond it can
    pass).  The diagonal is computed, not assumed: it is not free for rows
    with N.  The code table lives on ``device``; :func:`_rowblock_hits`
    decides every pair of the scan at once (on the card kernel I's
    thresholded form, which writes only the hits and their count: no
    distance matrix, no compaction, one readback of the count and one of
    the hits) and returns them row-major, ascending j within a row.  The
    JAX kernel's fixed-capacity lane-sort compaction with its overflow
    retry, and its two program classes, answer a TPU's costly scatter and
    recompiles; here they have nothing to do.  Returns (i, j) int64 in the
    input's index space.
    """
    n = codes.shape[0]
    dev = torch.device("cpu" if device is None else device)
    lengths = np.asarray(lengths, np.int32)
    perm = np.argsort(lengths, kind="stable").astype(np.int64)
    s_len = lengths[perm]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # DP columns: the longest string (positions past it are padding in
    # every row, and a row's distance never reads past its own length).
    W = int(s_len[-1])
    c = torch.as_tensor(np.ascontiguousarray(codes[perm][:, :W], np.int8), device=dev)
    lens = torch.as_tensor(s_len, device=dev)
    keys = _rowblock_hits(c, lens, s_len, thr, limit, tile).cpu().numpy()  # the hits' readback
    return perm[keys // n], perm[keys % n]


def lev2_neighbor_pairs(
    codes: np.ndarray, lengths: np.ndarray, limit: int,
    tile: int = 512, kcap: int = 64, assume_unique: bool = False, device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Sparse thresholded neighbours: all (i, j), i <= j, with doubled
    distance <= 2*limit — including the diagonal, which is NOT free when a
    sequence contains N (sorted_trie.cpp:13-21).

    Identical rows share one search (``assume_unique=True`` skips that dedup
    when the caller already collapsed duplicates).  Unique strings then go
    through one of the JAX package's two exact engines: the native
    symmetric-delete filter where its heuristics hold
    (:func:`_neighbor_pairs_filtered`), else the row-block scan on
    ``device`` (default CPU) in row blocks of ``tile``
    (:func:`_neighbor_pairs_rowblock`); the profiler's counter
    ``umi.route.filter`` or ``umi.route.rowblock`` gains the call.
    ``kcap`` is accepted for the JAX signature and ignored: it sizes the
    JAX kernel's per-row hit buffer, and the port's scan appends its hits
    to one buffer with an exact count instead.  Returns (qi, qj) int32
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

    thr = 2 * int(limit)
    pairs = _neighbor_pairs_filtered(codes, lengths, int(limit), thr)
    count("umi.route.filter" if pairs is not None else "umi.route.rowblock")
    if pairs is None:
        pairs = _neighbor_pairs_rowblock(codes, lengths, thr, int(limit), tile, device)
    ua, ub = pairs
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

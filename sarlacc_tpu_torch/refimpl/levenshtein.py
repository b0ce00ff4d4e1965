"""Oracle masked-Levenshtein distances and thresholded neighbour search.

Two distance flavours exist in the reference:

* ``compute_lev_masked`` (src/compute_lev_masked.cpp): double-valued distance
  where an ``N`` on either side contributes 0.5 regardless of partner; unit
  indel/substitution costs; emitted as the lower-triangle condensed vector.

* the sorted trie (src/sorted_trie.cpp): integer distances scaled by 2
  (match 0, N-vs-anything 1, mismatch/indel 2) with the threshold doubled, so
  thresholding is exact.  ``find_neighbors`` reproduces the trie's *results*:
  for each sequence, all sequence indices within the scaled threshold, in the
  trie's DFS emission order — lexicographic over the alphabet A<C<G<T<N with
  shorter prefixes first, ties broken by insertion index.

Copied unchanged from ``sarlacc_tpu/refimpl/levenshtein.py`` (numpy only, no JAX).
"""

from __future__ import annotations

import numpy as np

from ..core.encode import encode_seq

__all__ = ["lev_masked_condensed", "lev2_int", "find_neighbors", "trie_dfs_order"]


def _codes(seqs) -> list[np.ndarray]:
    return [encode_seq(s) if isinstance(s, str) else np.asarray(s) for s in seqs]


def lev_masked_condensed(seqs) -> np.ndarray:
    """All-pairs masked Levenshtein, condensed (i<j, i-major) per C5."""
    cs = _codes(seqs)
    n = len(cs)
    out = np.zeros(n * (n - 1) // 2, dtype=np.float64)
    k = 0
    for i in range(n):
        for j in range(i + 1, n):
            out[k] = _lev_masked_pair(cs[i], cs[j])
            k += 1
    return out


def _lev_masked_pair(a: np.ndarray, b: np.ndarray) -> float:
    """One masked distance, mirroring compute_lev_masked.cpp:44-55.

    ``a`` plays the role of the i-sequence (DP columns), ``b`` the j-sequence.
    """
    ilen, jlen = a.size, b.size
    prev = np.arange(ilen + 1, dtype=np.float64)
    col = np.zeros(ilen + 1, dtype=np.float64)
    for jx in range(jlen):
        col[0] = jx + 1
        jb = int(b[jx])
        for ix in range(ilen):
            ib = int(a[ix])
            ms = 0.5 if (jb == 4 or ib == 4) else (0.0 if jb == ib else 1.0)
            col[ix + 1] = min(prev[ix + 1] + 1, col[ix] + 1, prev[ix] + ms)
        col, prev = prev, col
    return float(prev[ilen])


def lev2_int(a: np.ndarray | str, b: np.ndarray | str) -> int:
    """Integer doubled masked Levenshtein (sorted_trie.cpp:13-21 cost model)."""
    if isinstance(a, str):
        a = encode_seq(a)
    if isinstance(b, str):
        b = encode_seq(b)
    ilen, jlen = a.size, b.size
    prev = 2 * np.arange(ilen + 1, dtype=np.int64)
    col = np.zeros(ilen + 1, dtype=np.int64)
    for jx in range(jlen):
        col[0] = 2 * (jx + 1)
        jb = int(b[jx])
        for ix in range(ilen):
            ib = int(a[ix])
            ms = 1 if (jb == 4 or ib == 4) else (0 if jb == ib else 2)
            col[ix + 1] = min(prev[ix + 1] + 2, col[ix] + 2, prev[ix] + ms)
        col, prev = prev, col
    return int(prev[ilen])


def trie_dfs_order(seqs) -> np.ndarray:
    """Indices in the trie's DFS emission order.

    The trie stores children in the order A, C, G, T, N
    (sorted_trie.cpp:10,178-183) and emits a node's indices before recursing,
    so emission order is lexicographic over that alphabet with prefixes first
    and insertion order within duplicates.  Our base codes (A=0..N=4) already
    sort that way, so a stable sort over padded code tuples suffices.
    """
    cs = _codes(seqs)
    keyed = sorted(range(len(cs)), key=lambda i: tuple(int(c) for c in cs[i]))
    return np.asarray(keyed, dtype=np.int64)


def find_neighbors(seqs, limit: int) -> list[list[int]]:
    """For each sequence, indices within doubled-distance 2*limit, DFS order.

    Result-equivalent to ``sorted_trie::find`` with threshold ``limit``
    (sorted_trie.cpp:189-226): the un-doubled ``limit`` is scaled by 2
    internally.
    """
    cs = _codes(seqs)
    n = len(cs)
    order = trie_dfs_order(cs)
    lim2 = 2 * int(limit)
    out: list[list[int]] = [[] for _ in range(n)]
    for q in range(n):
        hits = [int(o) for o in order if lev2_int(cs[int(o)], cs[q]) <= lim2]
        out[q] = hits
    return out

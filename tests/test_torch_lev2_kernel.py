"""Kernel I (doubled Levenshtein, one thread a pair) on the CPU.

The plain version ``_lev2_scan`` in both of kernel I's forms (cross:
``_lev2_block``; paired: ``_lev2_pairs``, both of which run it on CPU
tensors) against the JAX package's ``_lev2_tile_kernel(wide=True)``,
``_lev2_rowblock_sparse`` and ``lev2_pairs`` on the same numpy codes, with
N codes, reads of length 0 and widths above the register route (L = 100);
and a numpy transliteration of ``csrc/lev2_kernel.cu``'s threads (the
register route's unrolled column of 32 rows with a's codes as bit masks,
the scratch route's column to la) against the plain version.
Tolerance 0: the distances are integers.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from sarlacc_tpu.ops import levenshtein as jax_lev  # noqa: E402
from sarlacc_tpu_torch.ops import cuda_lev2, levenshtein  # noqa: E402


def _codes(n, L, seed, n_rate=0.06, min_len=0):
    """n rows of L codes (pad 5 past each length), N at ``n_rate``; a few
    rows of length 0 and of full length."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_len, L + 1, n).astype(np.int32)
    lengths[:2] = [0, L]
    p = [(1 - n_rate) / 4] * 4 + [n_rate]
    codes = rng.choice(5, (n, L), p=p).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    return codes, lengths


def _threads(a, la, b, lb, ia, ib, L):
    """csrc/lev2_kernel.cu's threads, all pairs at once (each pair's column
    advances only while jx < lb).  Cross form when ``ia`` is None."""
    if ia is None:
        TI, TJ = a.shape[0], b.shape[0]
        ia = np.repeat(np.arange(TI), TJ)
        ib = np.tile(np.arange(TJ), TI)
    A, B = a[ia].astype(np.int64), b[ib].astype(np.int64)
    LA, LB = la[ia].astype(np.int64), lb[ib].astype(np.int64)
    P = ia.size
    out = 2 * LA
    live = (LB > 0) & (LB <= L)
    route = cuda_lev2.lev2_route(L)
    if route != "scratch":
        LM = 32
        codes = np.full((P, LM), 5, np.int64)
        codes[:, :L] = A
        eq = [sum(((codes[:, r] == v).astype(np.uint64) << np.uint64(r)) for r in range(LM))
              for v in range(6)]
        col = np.tile(2 * np.arange(LM + 1, dtype=np.int64), (P, 1))
        full = np.uint64(2**LM - 1)
        for jx in range(L):
            go = live & (jx < LB)
            c = B[:, jx]
            eqc = np.zeros(P, np.uint64)
            for v in range(6):
                eqc = np.where(c == v, eq[v], eqc)
            nc = np.where(c == 4, full, eq[4])
            eqc = np.where(c == 4, np.uint64(0), eqc)
            new = col.copy()
            new[:, 0] = 2 * (jx + 1)
            for r in range(1, LM + 1):
                sh = np.uint64(r - 1)
                ms = 2 - 2 * ((eqc >> sh) & np.uint64(1)).astype(np.int64) \
                    - ((nc >> sh) & np.uint64(1)).astype(np.int64)
                new[:, r] = np.minimum(np.minimum(col[:, r] + 2, col[:, r - 1] + ms),
                                       new[:, r - 1] + 2)
            col = np.where(go[:, None], new, col)
        got = np.where(LA <= LM, col[np.arange(P), np.minimum(LA, LM)], 2 * LA)
        return np.where(live, got, out).astype(np.int32)
    # The scratch route: rows 0 .. min(la, L), in place, one pair at a time.
    for p in np.flatnonzero(live):
        rows = int(min(max(LA[p], 0), L))
        colp = 2 * np.arange(rows + 1, dtype=np.int64)
        left = 0
        for jx in range(int(LB[p])):
            c = B[p, jx]
            diag = colp[0]
            left = 2 * (jx + 1)
            colp[0] = left
            for r in range(1, rows + 1):
                ac = A[p, r - 1]
                ms = 1 if (c == 4 or ac == 4) else (0 if ac == c else 2)
                old = colp[r]
                left = min(old + 2, diag + ms, left + 2)
                colp[r] = left
                diag = old
        out[p] = left
    return out.astype(np.int32)


def _plain_cross(a, la, b, lb):
    return levenshtein._lev2_block(*(torch.tensor(x) for x in (a, la, b, lb))).numpy()


@pytest.mark.parametrize("L,seed", [(10, 0), (30, 1), (33, 2), (100, 3)])
def test_lev2_cross_matches_jax_tile(L, seed):
    """One [TI, TJ] tile of the all-pairs matrix: the plain cross form, the
    JAX tile program (int32 readback) and kernel I's threads agree."""
    codes, lengths = _codes(40, L, seed)
    TI, TJ, i0, j0 = 16, 24, 8, 16
    want = np.asarray(jax_lev._lev2_tile_kernel(
        jnp.asarray(codes), jnp.asarray(lengths), i0, j0, TI=TI, TJ=TJ, L=L, wide=True))
    a, la = codes[i0 : i0 + TI], lengths[i0 : i0 + TI]
    b, lb = codes[j0 : j0 + TJ], lengths[j0 : j0 + TJ]
    got = _plain_cross(a, la, b, lb)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_threads(a, la, b, lb, None, None, L).reshape(TI, TJ), got)


@pytest.mark.parametrize("L,thr,seed", [(12, 4, 4), (30, 4, 5), (100, 20, 6)])
def test_lev2_cross_matches_jax_rowblock(L, thr, seed):
    """The row-block scan's hits (d2 <= thr, j >= i, ascending j per row) from
    the plain cross form equal ``_lev2_rowblock_sparse``'s buffers."""
    codes, lengths = _codes(48, L, seed, n_rate=0.1)
    n = codes.shape[0]
    # Near neighbours: rows 24-47 are rows 0-23 with one substitution.
    codes[24:] = codes[:24]
    lengths[24:] = lengths[:24]
    rng = np.random.default_rng(seed)
    for r in range(24, n):
        if lengths[r]:
            codes[r, rng.integers(0, lengths[r])] = rng.integers(0, 4)
    TI, TJ, KCAP = 16, 16, 64
    for i0 in (0, 16, 32):
        buf, cnt = jax_lev._lev2_rowblock_sparse(
            jnp.asarray(codes), jnp.asarray(lengths), n, i0, 0, n // TJ, thr,
            TI=TI, TJ=TJ, NJT=n // TJ, L=L, KCAP=KCAP)
        buf, cnt = np.asarray(buf), np.asarray(cnt)
        d2 = _plain_cross(codes[i0 : i0 + TI], lengths[i0 : i0 + TI], codes, lengths)
        for r in range(TI):
            hits = np.flatnonzero((d2[r] <= thr) & (np.arange(n) >= i0 + r))
            assert cnt[r] == hits.size <= KCAP
            np.testing.assert_array_equal(buf[r, : cnt[r]], hits)
    assert (cnt > 1).any()


@pytest.mark.parametrize("L,seed", [(20, 7), (64, 8), (100, 9)])
def test_lev2_paired_matches_jax_pairs(L, seed):
    codes, lengths = _codes(30, L, seed)
    rng = np.random.default_rng(seed)
    ia = rng.integers(0, 30, 200)
    ib = rng.integers(0, 30, 200)
    want = np.asarray(jax_lev.lev2_pairs(
        jnp.asarray(codes[ia]), jnp.asarray(lengths[ia]), jnp.asarray(codes[ib]),
        jnp.asarray(lengths[ib])))
    got = levenshtein._lev2_pairs(torch.tensor(codes), torch.tensor(lengths),
                                  torch.tensor(ia), torch.tensor(ib)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_threads(codes, lengths, codes, lengths, ia, ib, L), got)


@pytest.mark.parametrize("L", [1, 32, 33, 64, 100])
def test_lev2_threads_match_plain_at_route_edges(L):
    """Each route at its edges: the register route at exactly 32 rows, the
    scratch route from 33; lengths 0 and L on both sides."""
    codes, lengths = _codes(20, L, 10 + L, n_rate=0.2)
    got = _plain_cross(codes[:10], lengths[:10], codes, lengths)
    np.testing.assert_array_equal(
        _threads(codes[:10], lengths[:10], codes, lengths, None, None, L).reshape(10, 20), got)


def test_lev2_wrappers_take_cuda_tensors_only():
    codes, lengths = _codes(6, 12, 0)
    c, ln = torch.tensor(codes), torch.tensor(lengths)
    before = cuda_lev2.LEV2_KERNEL.launches
    levenshtein._lev2_block(c, ln, c, ln)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lev2.lev2_cross(c, ln, c, ln)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lev2.lev2_paired(c, ln, torch.arange(6), torch.arange(6))
    assert cuda_lev2.LEV2_KERNEL.launches == before
    assert [cuda_lev2.lev2_route(x) for x in (30, 32, 33, 64, 65)] == \
        ["reg32", "reg32", "scratch", "scratch", "scratch"]

"""Kernel I's thresholded form (the row-block scan's hits) on the CPU.

The scan as the port runs it on the CPU (``_neighbor_pairs_rowblock``,
whose plain version ``_rowblock_hits_plain`` thresholds ``_lev2_scan``'s
distances and compacts them) against the JAX package's
``_neighbor_pairs_rowblock`` on the same numpy codes, pair for pair and in
the same order (row-major, ascending j); a numpy transliteration of
``csrc/lev2_kernel.cu``'s thresholded form (its jobs from
``rowblock_jobs``; each pair's band of 2 (thr / 2) + 1 cells, the register
route's code masks shifted a column at a time or the scratch route's codes;
a pair skipped when its lengths differ by more than thr / 2, stopped when a
whole band column exceeds thr; the DP cells inside the matrix counted) against the plain
version; and the overflow re-run.  With N bases, mixed lengths, limits
1-4, rows above 32 and 64 positions and a half-band above the register
route.  Tolerance 0: pairs and counts are integers.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from sarlacc_tpu.ops import levenshtein as jax_lev  # noqa: E402
from sarlacc_tpu_torch.ops import cuda_lev2, levenshtein  # noqa: E402

INF = 1 << 20


def _umi_codes(n, L, seed, n_rate=0.03, n_centres=None, min_len=None):
    """``n`` UMIs of up to ``L`` codes (pad 5) around random centres: each a
    centre with a few substitutions, insertions or deletions and N at
    ``n_rate``, so that the scan finds neighbours at every distance; unique
    rows, as the scan takes them."""
    rng = np.random.default_rng(seed)
    n_centres = n_centres or max(2, n // 6)
    lo = L - 4 if min_len is None else min_len
    centres = [rng.integers(0, 4, rng.integers(lo, L + 1)) for _ in range(n_centres)]
    rows = set()
    out = []
    while len(out) < n:
        s = list(centres[rng.integers(n_centres)])
        for _ in range(rng.integers(0, 4)):
            op, at = rng.integers(3), rng.integers(len(s) + 1)
            if op == 0 and at < len(s):
                s[at] = int(rng.integers(4))
            elif op == 1 and len(s) < L:
                s.insert(at, int(rng.integers(4)))
            elif op == 2 and at < len(s) and len(s) > 1:
                del s[at]
        s = [4 if rng.random() < n_rate else c for c in s]
        if tuple(s) not in rows:
            rows.add(tuple(s))
            out.append(s)
    lengths = np.asarray([len(s) for s in out], np.int32)
    codes = np.full((n, L), 5, np.int32)
    for i, s in enumerate(out):
        codes[i, : len(s)] = s
    return codes, lengths


def _sorted_inputs(codes, lengths):
    perm = np.argsort(lengths, kind="stable")
    s_len = lengths[perm]
    W = int(s_len[-1])
    return codes[perm][:, :W].astype(np.int8), s_len, perm


def _band(c, s_len, I, J, thr, masks):
    """The band DP of every pair (I[p], J[p]) at once, as the kernel's
    threads run it: (hit, DP cells evaluated: the band cells with
    1 <= r <= la, to each pair's exit)."""
    H = thr // 2
    BW = 2 * H + 1
    la, lb = s_len[I].astype(np.int64), s_len[J].astype(np.int64)
    P = I.size
    cells = np.zeros(P, np.int64)
    live = np.abs(la - lb) <= H  # the others are skipped outright
    k = np.arange(BW)[None, :]
    band = np.where((k - H >= 0) & (k - H <= la[:, None]), 2 * (k - H), INF)
    W = c.shape[1]
    if masks:  # the register route: a's codes as one 64-bit mask a value
        bits = (np.uint64(1) << np.arange(W, dtype=np.uint64))
        eq = [((c[I].astype(np.int64) == v) * bits).sum(axis=1, dtype=np.uint64) for v in range(6)]
    for col in range(1, W + 1):
        go = live & (col <= lb)
        if not go.any():
            break
        bc = c[J, col - 1].astype(np.int64)
        r = col - H + k  # [1, BW]
        if masks:
            eqc = np.zeros(P, np.uint64)
            for v in range(6):
                eqc = np.where(bc == v, eq[v], eqc)
            nc = np.where(bc == 4, ~np.uint64(0), eq[4])
            eqc = np.where(bc == 4, np.uint64(0), eqc)
            sh = col - H - 1
            shift = (lambda m: m >> np.uint64(sh)) if sh >= 0 else (lambda m: m << np.uint64(-sh))
            we, wn = shift(eqc), shift(nc)
            bit = lambda m: ((m[:, None] >> np.arange(BW, dtype=np.uint64)[None, :])  # noqa: E731
                             & np.uint64(1)).astype(np.int64)
            ms = 2 - 2 * bit(we) - bit(wn)
        else:  # the scratch route: the codes themselves
            ac = np.where((r >= 1) & (r <= la[:, None]),
                          c[I[:, None], np.clip(r - 1, 0, W - 1)].astype(np.int64), 5)
            ms = np.where((bc[:, None] == 4) | (ac == 4), 1, np.where(ac == bc[:, None], 0, 2))
        new = band.copy()
        up = np.full(P, INF, np.int64)
        for kk in range(BW):
            left = band[:, kk + 1] if kk + 1 < BW else np.full(P, INF, np.int64)
            v = np.minimum(np.minimum(left + 2, band[:, kk] + ms[:, kk]), up + 2)
            rr = col - H + kk
            v = np.where(rr == 0, 2 * col, v)
            v = np.where((rr < 0) | (rr > la), INF, v)
            new[:, kk] = v
            up = v
        band = np.where(go[:, None], new, band)
        # The DP cells of the band column inside the matrix (1 <= r <= la).
        inside = np.clip(np.minimum(col + H, la) - max(col - H, 1) + 1, 0, None)
        cells += go * inside
        live &= ~(go & (band.min(axis=1) > thr))  # a whole band column above thr: stop
    at = np.clip(la - lb + H, 0, BW - 1)
    hit = live & (band[np.arange(P), at] <= thr)
    return hit, cells


def _transliteration(c, s_len, thr, limit, tile):
    """csrc/lev2_kernel.cu's thresholded form over its jobs: (sorted keys,
    exact hit count, DP cells)."""
    n, W = c.shape
    jobs = cuda_lev2.rowblock_jobs(s_len, limit, tile)
    I, J = [], []
    for r0, r1, c0, c1 in jobs.tolist():
        i = np.repeat(np.arange(r0, r0 + cuda_lev2.HIT_ROWS), c1 - c0)
        j = np.tile(np.arange(c0, c1), cuda_lev2.HIT_ROWS)
        keep = (i < r1) & (j >= i)
        I.append(i[keep])
        J.append(j[keep])
    I, J = np.concatenate(I), np.concatenate(J)
    masks = cuda_lev2.hits_route(W, thr) == "band_reg"
    hit, cells = _band(c, s_len, I, J, thr, masks)
    keys = np.sort(I[hit] * n + J[hit])
    return keys, int(hit.sum()), int(cells.sum())


CASES = [  # (L, limit, n, tile, n_rate)
    (12, 1, 220, 64, 0.05),
    (30, 2, 300, 64, 0.03),
    (20, 3, 260, 100, 0.03),
    (30, 4, 240, 64, 0.02),
    (40, 2, 200, 64, 0.03),    # above 32 positions: the register route's 64-bit masks
    (70, 3, 150, 48, 0.03),    # above 64: the scratch route
]


@pytest.mark.parametrize("L,limit,n,tile,n_rate", CASES)
def test_rowblock_scan_matches_jax_in_order(L, limit, n, tile, n_rate):
    """The port's scan on the CPU returns JAX's pairs in JAX's order."""
    codes, lengths = _umi_codes(n, L, 7 * L + limit, n_rate=n_rate)
    thr = 2 * limit
    wi, wj = jax_lev._neighbor_pairs_rowblock(codes, lengths, thr, limit, tile, 64)
    gi, gj = levenshtein._neighbor_pairs_rowblock(codes, lengths, thr, limit, tile, device="cpu")
    np.testing.assert_array_equal(gi, np.asarray(wi, np.int64))
    np.testing.assert_array_equal(gj, np.asarray(wj, np.int64))
    assert gi.size > n  # the diagonal and neighbours beyond it


@pytest.mark.parametrize("L,limit,n,tile,n_rate", CASES + [(20, 16, 60, 32, 0.05)])
def test_thresholded_form_matches_plain(L, limit, n, tile, n_rate):
    """The kernel's thresholded form, transliterated, gives the plain
    version's hits; it counts at most a band column for each column of b of
    each pair it scans, and at limits 1-4 fewer than a quarter of the
    cells full DPs of the scan's pairs would compute."""
    codes, lengths = _umi_codes(n, L, 3 * L + limit, n_rate=n_rate,
                                min_len=1 if limit == 16 else None)
    c, s_len, _ = _sorted_inputs(codes, lengths)
    thr = 2 * limit
    want = levenshtein._rowblock_hits_plain(torch.tensor(c), torch.tensor(s_len), s_len, thr,
                                            limit, tile).numpy()
    keys, count, cells = _transliteration(c, s_len, thr, limit, tile)
    np.testing.assert_array_equal(keys, want)
    assert count == want.size
    lb_sum = sum(int(s_len[i:].sum()) for i in range(n))  # every pair j >= i
    assert 0 < cells <= (2 * limit + 1) * lb_sum
    full = sum(int(s_len[i]) * int(s_len[i:].sum()) for i in range(n))
    assert cells <= full
    assert limit > 4 or cells < full // 4


def test_band_verdicts_at_the_threshold():
    """Pairs at distance exactly thr and thr + 1 (N costs 1, a mismatch or
    an indel 2), with the band's edge at the length difference: the
    verdict is the full DP's."""
    L = 16
    base = [0, 1, 2, 3] * 4
    rows = [
        base,
        base[:-2],                          # two deletions: 4
        base[:-2] + [4],                    # one deletion, an N: 3 (odd)
        [1] + base[1:],                     # one mismatch: 2
        [1, 0] + base[2:-1],                # two mismatches, a deletion: 6
        [4, 4, 4, 4, 4] + base[5:],         # five N: 5
        base[1:] + [3],                     # a deletion and an insertion: 4
        base[:8],                           # eight deletions: 16, skipped by length
    ]
    n = len(rows)
    codes = np.full((n, L), 5, np.int32)
    for i, r in enumerate(rows):
        codes[i, : len(r)] = r
    lengths = np.asarray([len(r) for r in rows], np.int32)
    c, s_len, perm = _sorted_inputs(codes, lengths)
    full = levenshtein._lev2_scan(torch.tensor(c[:, None, :]), torch.tensor(s_len[:, None]),
                                  torch.tensor(c[None]), torch.tensor(s_len[None])).numpy()
    for thr in (2, 3, 4, 5, 6):
        keys, count, _ = _transliteration(c, s_len, thr, thr // 2, 8)
        want = [i * n + j for i in range(n) for j in range(i, n) if full[i, j] <= thr]
        assert keys.tolist() == want and count == len(want), thr
        assert levenshtein._rowblock_hits_plain(torch.tensor(c), torch.tensor(s_len), s_len, thr,
                                                thr // 2, 8).tolist() == want


@pytest.mark.parametrize("masks", [True, False])
def test_cells_count_the_matrix_only(masks):
    """The cell count takes each band column's cells with 1 <= r <= la:
    not the row-0 boundary, not rows off the matrix.  Two equal 5-mers at
    half-band 1 run all five columns: 2 + 3 + 3 + 3 + 2 = 13 cells (BW x 5
    = 15 with the boundary and the rows past la); two 5-mers with no base
    in common at thr 2 stop after column 2 (2 + 3 cells)."""
    c = np.asarray([[0, 1, 2, 3, 0], [0, 1, 2, 3, 0], [2, 2, 2, 2, 2]], np.int8)
    s_len = np.full(3, 5, np.int32)
    hit, cells = _band(c, s_len, np.asarray([0, 0]), np.asarray([1, 2]), 2, masks)
    assert hit.tolist() == [True, False]
    assert cells.tolist() == [13, 5]


@pytest.mark.parametrize("n,tile,limit", [(700, 200, 2), (300, 128, 1), (1, 512, 3), (130, 1, 2)])
def test_rowblock_jobs_cover_the_loop_pairs(n, tile, limit):
    """The jobs hold every pair j >= i of the loop's row blocks up to each
    block's length prune, once, within 128 rows x 256 columns a job."""
    rng = np.random.default_rng(n + tile)
    s_len = np.sort(rng.integers(5, 40, n)).astype(np.int32)
    jobs = cuda_lev2.rowblock_jobs(s_len, limit, tile)
    assert (jobs[:, 1] - jobs[:, 0] <= 128).all() and (jobs[:, 3] - jobs[:, 2] <= 256).all()
    got = []
    for r0, r1, c0, c1 in jobs.tolist():
        got += [(i, j) for i in range(r0, r1) for j in range(max(c0, i), c1)]
    want = []
    for i0 in range(0, n, tile):
        i1 = min(i0 + tile, n)
        j_end = min(max(int(np.searchsorted(s_len, s_len[i1 - 1] + limit, side="right")), i0 + 1), n)
        want += [(i, j) for i in range(i0, i1) for j in range(i, j_end)]
    assert sorted(got) == want


def test_overflow_reruns_once_at_the_exact_count():
    """A buffer smaller than the hits: the first run's count is exact, the
    re-run gets a buffer of that size and no cell counter."""
    calls = []

    def run(j0, j1, cap, cells):
        calls.append((j0, j1, cap, cells))
        return f"buffer of {cap}", 1234

    starts = [0, 3, 7]
    assert list(cuda_lev2.fit_hits(run, starts, 100, 10**6, "cells")) == \
        [(0, 7, "buffer of 1234", 1234)]
    assert calls == [(0, 7, 100, "cells"), (0, 7, 1234, None)]
    calls.clear()
    assert list(cuda_lev2.fit_hits(run, starts, 5000, 10**6, "cells")) == \
        [(0, 7, "buffer of 5000", 1234)]
    assert calls == [(0, 7, 5000, "cells")]


def test_hits_beyond_the_budget_split_by_row_tiles():
    """More hits than the budget's ``most`` keys: the row tiles split in
    halves until each part fits (a single row tile re-runs at its count
    whatever it is); the parts cover the jobs in order, and only the first
    run gains the cells."""
    tile_hits = [5, 40, 7, 9, 30]  # hits of each row tile's jobs
    starts = [0, 2, 3, 6, 8, 9]

    def run(j0, j1, cap, cells):
        total = sum(h for h, a, b in zip(tile_hits, starts, starts[1:]) if j0 <= a and b <= j1)
        calls.append((j0, j1, cap, cells))
        return (j0, j1, min(cap, total)), total

    calls = []
    parts = list(cuda_lev2.fit_hits(run, starts, 16, 25, "cells"))
    assert [(j0, j1, n) for j0, j1, _, n in parts] == [(0, 2, 5), (2, 3, 40), (3, 6, 7),
                                                      (6, 8, 9), (8, 9, 30)]
    assert parts[1][2] == (2, 3, 40)  # the single tile's re-run at its count
    assert [c for c in calls if c[3] is not None] == [(0, 9, 16, "cells")]
    assert all(c[2] <= 25 or c[:2] == (2, 3) or c[:2] == (8, 9) for c in calls)


def test_hits_wrapper_takes_cuda_tensors_only():
    codes, lengths = _umi_codes(40, 20, 1)
    c, s_len, _ = _sorted_inputs(codes, lengths)
    before = cuda_lev2.HITS_KERNEL.launches
    keys = levenshtein._rowblock_hits(torch.tensor(c), torch.tensor(s_len), s_len, 4, 2, 16)
    assert keys.numel() >= 40
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lev2.lev2_hits(torch.tensor(c), torch.tensor(s_len), s_len, 4, 2, 16)
    assert cuda_lev2.HITS_KERNEL.launches == before
    assert [cuda_lev2.hits_route(W, t) for W, t in ((30, 4), (64, 30), (65, 4), (30, 32))] == \
        ["band_reg", "band_reg", "band_scratch", "band_scratch"]


def _emulated_launch(codes, lens, thr, jobs, hits, found, cells, route, scratch, blocks):
    """One launch of csrc/lev2_kernel.cu's thresholded form by the
    transliteration, on CPU tensors: hits appended up to the buffer, the
    exact count into ``found``, the DP cells added to ``cells``."""
    c, s_len = codes.numpy(), lens.numpy()
    n = c.shape[0]
    I, J = [], []
    for r0, r1, c0, c1 in jobs.tolist():
        i = np.repeat(np.arange(r0, r1), c1 - c0)
        j = np.tile(np.arange(c0, c1), r1 - r0)
        I.append(i[j >= i])
        J.append(j[j >= i])
    I, J = np.concatenate(I), np.concatenate(J)
    hit, cl = _band(c, s_len, I, J, thr, route == "band_reg")
    keys = I[hit] * n + J[hit]
    k = min(keys.size, hits.numel())
    hits[:k] = torch.as_tensor(keys[:k])
    found[0] = keys.size
    if cells is not None:
        cells += int(cl.sum())


@pytest.mark.parametrize("cap", [None, 1])
def test_wrapper_counts_cells_hits_and_reruns(monkeypatch, cap):
    """The wrapper around launches emulated on the CPU: the plain
    version's hits, and the profiler's ``lev2.*`` counters: the DP cells
    once (not again on the re-run a buffer of one key forces), the hits,
    the inputs' bytes, and one re-run."""
    from sarlacc_tpu_torch.utils import profiling

    codes, lengths = _umi_codes(260, 20, 5, n_rate=0.03)
    c, s_len, _ = _sorted_inputs(codes, lengths)
    n, thr, limit, tile = c.shape[0], 6, 3, 100
    monkeypatch.setattr(cuda_lev2, "check_tensor", lambda *a: None)
    monkeypatch.setattr(cuda_lev2, "_launch_hits", _emulated_launch)
    prof = profiling.PipelineProfiler()
    monkeypatch.setattr(profiling, "_GLOBAL", prof)
    cells = torch.zeros(1, dtype=torch.int64)
    got = cuda_lev2.lev2_hits(torch.tensor(c), torch.tensor(s_len), s_len, thr, limit, tile,
                              cells=cells, cap=cap)
    want, count, n_cells = _transliteration(c, s_len, thr, limit, tile)
    plain = levenshtein._rowblock_hits_plain(torch.tensor(c), torch.tensor(s_len), s_len, thr,
                                             limit, tile)
    assert got.tolist() == want.tolist() == plain.tolist()
    n_jobs = cuda_lev2.rowblock_jobs(s_len, limit, tile).shape[0]
    assert prof.counters == {"lev2.cells": n_cells, "lev2.hits": count,
                             "lev2.in_bytes": c.size + 4 * n + 16 * n_jobs,
                             **({"lev2.reruns": 1} if cap else {})}
    assert int(cells) == n_cells > 0 and count > n


def test_fit_counts_reruns_and_splits(monkeypatch):
    """``fit_hits`` counts every run after the first, re-runs and the runs
    of split parts alike, and every part's hits."""
    from sarlacc_tpu_torch.utils import profiling

    prof = profiling.PipelineProfiler()
    monkeypatch.setattr(profiling, "_GLOBAL", prof)
    tile_hits = [5, 40, 7, 9, 30]
    starts = [0, 2, 3, 6, 8, 9]

    def run(j0, j1, cap, cells):
        total = sum(h for h, a, b in zip(tile_hits, starts, starts[1:]) if j0 <= a and b <= j1)
        calls.append((j0, j1))
        return None, total

    calls = []
    list(cuda_lev2.fit_hits(run, starts, 16, 25, "cells"))
    assert prof.counters == {"lev2.reruns": len(calls) - 1, "lev2.hits": sum(tile_hits)}
    assert len(calls) > 5

"""Kernel B's wide route, proven on the CPU.

``csrc/pair_kernel.cu`` runs a pair of band width W > 4096 on a
thread-block cluster: ``W / 8192`` blocks (1, 2, 4 or 8) of up to 512
threads, block r holding the contiguous slice [r W / C, (r + 1) W / C),
IT <= 16 consecutive cells a thread, S, V and B's codes in registers.  A
warp's 32 x IT cells are a segment; inside it the lanes talk by shuffles
(as on the warp route).  Each row every warp publishes a summary (the
maximum of B = (mv - go) + k*ge over its cells and over all but its last
cell, mv at its last cell, M and Vn at its first) into the shared memory of
every block of the cluster, in the slot of the row's parity; after the
row's one cluster barrier a segment reads, from its own block's copy, the
scan's carries (the maxima of the segments before it), H and mv at the cell
before its first, and recomputes S and V at the cell after its last (a halo
kept by lane 31) from the next segment's M and Vn.  Each direction byte is
formed once.

:func:`wide_pair` transliterates that schedule in float32 numpy, vectorised
over the pairs, with the blocks' copies of the summaries, the lanes and
every shuffle written out, and the tests hold it bit for bit (tolerance 0),
scores and direction bytes, to the port's ``banded_pair_plain`` and to the
JAX package's XLA ``_banded_pair_kernel`` (the function JAX runs for bands
too wide for its Pallas kernel).  The route's plan by band width and its
refusals are tested here too.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from sarlacc_tpu.ops.msa import _banded_pair_kernel  # noqa: E402
from sarlacc_tpu_torch.ops import cuda_msa  # noqa: E402
from sarlacc_tpu_torch.ops.cuda_msa import banded_pair_plain, pair_route, wide_plan  # noqa: E402

NEG = np.float32(-1.0e9)
F_MAX, F_XL, F_MVL, F_M0, F_V0 = range(5)  # a warp's summary, in the kernel's order


def _shfl_down(x, d=1):
    """``__shfl_down_sync`` over the lane axis (2): lanes past the end keep
    their own value."""
    out = x.copy()
    out[:, :, : 32 - d] = x[:, :, d:]
    return out


def _shfl_up(x, d=1):
    """``__shfl_up_sync`` over the lane axis (2): the first d lanes keep
    their own value."""
    out = x.copy()
    out[:, :, d:] = x[:, :, : 32 - d]
    return out


def wide_pair(codes_a, codes_b, lens_a, lens_b, lo, kmax, match, mismatch,
              gap_open, gap_ext, rows, width):
    """The wide route's schedule in float32 numpy: (scores f32 [P], dirs
    int8 [rows, P, W]).  Arguments as ``banded_pair_plain`` (numpy)."""
    f32 = np.float32
    P, LA = codes_a.shape
    W = width
    threads, IT, C = wide_plan(W)
    nwarps = threads // 32
    NSEG, SEG = C * nwarps, 32 * IT
    mt, mm, go, ge = (f32(v) for v in (match, mismatch, gap_open, gap_ext))
    seg = np.arange(NSEG)
    k = (seg[:, None, None] * SEG + np.arange(32)[None, :, None] * IT
         + np.arange(IT)[None, None, :])[None]  # [1, NSEG, 32, IT]
    kf = k.astype(f32)
    k0w = seg * SEG
    kw = k0w + SEG - 1
    rank = seg // nwarps  # the block that holds each segment
    la, lb, lo_, km = (np.asarray(x, np.int64) for x in (lens_a, lens_b, lo, kmax))
    ca = np.asarray(codes_a, np.int64)
    cb = np.asarray(codes_b, np.int64)
    pidx = np.arange(P)

    def e(x, n):  # a [P] array against n trailing axes
        return x.reshape((P,) + (1,) * n)

    def b_code(j, n):  # B's code at column j ([P, ...] with n trailing axes), -1 outside [1, lb]
        inside = (j >= 1) & (j <= e(lb, n))
        return np.where(inside, cb[e(pidx, n), np.clip(j - 1, 0, cb.shape[1] - 1)], -1)

    def row0(kk, n):  # row 0's S at cells kk
        j0 = e(lo_, n) + kk
        return np.where(j0 == 0, f32(0.0), np.where(
            (j0 >= 1) & (j0 <= e(lb, n)) & (kk <= e(km, n)),
            -(go + (j0.astype(f32) - f32(1.0)) * ge), NEG)).astype(f32)

    last = seg == NSEG - 1
    S = row0(k, 3)
    V = np.full(S.shape, NEG, f32)
    Sh = np.where(last[None, :], NEG, row0(kw[None, :] + 1, 1)).astype(f32)  # the halo
    Vh = np.full(Sh.shape, NEG, f32)
    bw = b_code(1 + e(lo_, 3) + k, 3)
    summ = np.zeros((P, C, 2, 5, NSEG), f32)  # each block's shared copy, by row parity
    lanes = np.arange(32)[None, None, :]
    dirs = np.zeros((rows, P, W), np.int8)
    for i in range(1, rows + 1):
        par = i & 1
        ai = e(np.where(i - 1 < LA, ca[:, min(i - 1, LA - 1)], 5), 3)
        alive = i <= la
        kv0, kv1 = -(i + lo_), np.minimum(lb - i - lo_, km)
        s_nb, v_nb = _shfl_down(S[..., 0]), _shfl_down(V[..., 0])
        s_nb[:, :, 31], v_nb[:, :, 31] = Sh, Vh
        s_up = np.concatenate([S[..., 1:], s_nb[..., None]], axis=3)
        v_up = np.concatenate([V[..., 1:], v_nb[..., None]], axis=3)
        sub = np.where(bw < 0, NEG, np.where(ai == bw, mt, mm))
        M = S + sub
        open_v, ext_v = s_up - go, v_up - ge
        Vn = np.maximum(open_v, ext_v)
        vext = ext_v >= open_v
        mv = np.maximum(M, Vn)
        B = (mv - go) + kf * ge
        # Pass 1: the lane's running maximum of B from NEG (t2: all but the
        # last cell).
        run = np.maximum.accumulate(
            np.concatenate([np.full(B.shape[:3] + (1,), NEG, f32), B], axis=3), axis=3)
        tmax, t2 = run[..., IT], run[..., IT - 1]
        mvL = mv[..., IT - 1]
        x = tmax.copy()
        for off in (1, 2, 4, 8, 16):
            x = np.where(lanes >= off, np.maximum(x, _shfl_up(x, off)), x)
        lane_excl = _shfl_up(x, 1)
        lane_excl[:, :, 0] = NEG
        summary = (x[:, :, 31], np.maximum(lane_excl, t2)[:, :, 31], mvL[:, :, 31],
                   M[:, :, 0, 0], Vn[:, :, 0, 0])
        for r in range(C):  # lane r writes the warp's summary into block r
            for f, val in enumerate(summary):
                summ[:, r, par, f] = val
        # -- the row's one cluster barrier; each segment reads its block's copy --
        sm = summ[:, rank, par]  # [P, NSEG (reader), 5, NSEG]
        prev, nxt = np.maximum(seg - 1, 0), np.minimum(seg + 1, NSEG - 1)

        def field(f, q):  # segment g's copy of field f of segment q[g]
            return sm[pidx[:, None], seg[None, :], f, q[None, :]]

        before = seg[None, :] - 1  # carry_m1: the segments before g - 1
        carry_m1 = np.where(np.arange(NSEG)[None, None, :] < before[..., None],
                            sm[:, :, F_MAX, :], NEG).max(axis=2, initial=NEG)
        carry = np.where(seg[None, :] > 0, np.maximum(carry_m1, field(F_MAX, prev)), NEG)
        excl = np.maximum(carry[:, :, None], lane_excl)
        kL = k[..., IT - 1]
        valid_l = (kL >= e(kv0, 2)) & (kL <= e(kv1, 2))
        h_last = np.where((kL > 0) & valid_l,
                          np.maximum(excl, t2) - (kf[..., IT - 1] - f32(1.0)) * ge, NEG)
        h_nb, mv_nb = _shfl_up(h_last), _shfl_up(mvL)
        kk = k0w - 1
        valid_kk = (kk[None, :] >= e(kv0, 1)) & (kk[None, :] <= e(kv1, 1))
        h_nb[:, :, 0] = np.where(
            (seg[None, :] > 0) & (kk[None, :] > 0) & valid_kk,
            np.maximum(carry_m1, field(F_XL, prev)) - (kk.astype(f32) - f32(1.0)) * ge, NEG)
        mv_nb[:, :, 0] = np.where(seg[None, :] > 0, field(F_MVL, prev), NEG)
        # Pass 2: the running max restarts from the lane's carry-in.
        cprev = np.maximum.accumulate(np.concatenate([excl[..., None], B], axis=3), axis=3)[..., :IT]
        valid = (k >= e(kv0, 3)) & (k <= e(kv1, 3))
        h = np.where((k > 0) & valid, cprev - (kf - f32(1.0)) * ge, NEG)
        m = np.where(valid, M, NEG)
        v = np.where(valid, Vn, NEG)
        sn = np.maximum(m, np.maximum(h, v))
        choice = np.where(m >= sn, 0, np.where(h >= sn, 1, 2))
        hp = np.concatenate([h_nb[..., None], h[..., :-1]], axis=3)
        mvp = np.concatenate([mv_nb[..., None], mv[..., :-1]], axis=3)
        hext = (hp - ge) >= (mvp - go)
        byte = choice | (hext << 2) | (vext << 3)
        dirs[i - 1] = byte.reshape(P, W)  # each lane's IT bytes at once
        # The halo: segment g + 1's first cell as g + 1 computes it.
        c = kw + 1
        valid_c = (c[None, :] >= e(kv0, 1)) & (c[None, :] <= e(kv1, 1))
        h_c = np.where((c[None, :] > 0) & valid_c,
                       np.maximum(carry, summary[F_MAX]) - (c.astype(f32) - f32(1.0)) * ge, NEG)
        v_c = np.where(valid_c, field(F_V0, nxt), NEG)
        s_c = np.maximum(np.where(valid_c, field(F_M0, nxt), NEG), np.maximum(h_c, v_c))
        upd = e(alive, 1) & ~last[None, :]
        Sh, Vh = np.where(upd, s_c, Sh), np.where(upd, v_c, Vh)
        S = np.where(e(alive, 3), sn, S)
        V = np.where(e(alive, 3), v, V)
        # Slide B's window; lane 31 takes the code its prefetch holds.
        b_nb = _shfl_down(bw[..., 0])
        bw = np.concatenate([bw[..., 1:], b_nb[..., None]], axis=3)
        bw[:, :, 31, -1] = b_code(i + 1 + e(lo_, 1) + kw[None, :], 1)
    kfin = lb - la - lo_
    flat = S.reshape(P, W)
    inside = (kfin >= 0) & (kfin < W)
    scores = np.where(inside, flat[pidx, np.clip(kfin, 0, W - 1)], NEG)
    return scores.astype(np.float32), dirs


def _wide_pairs(seed, P, rows, W):
    """P pairs at band width W (the first P of five kinds): A ``rows`` - 3
    bases against a B that puts the end cell kfin in the last block of the
    cluster (rows past ``la``); an empty A (la = 0); a band whose last cell
    is the first cell of the next block's slice (of the next warp's when
    the cluster is one block); kfin in a middle block and, at bandwidth 4,
    the band's last cell a warp's last, inside B for most rows, so the next
    warp's first horizontal-extend bit reads a live H; A longer than B (a
    narrow band, every later segment past it).  Bandwidth 100 but for the
    fourth.  A is planted, 85% kept, at the end of B."""
    rng = np.random.default_rng(seed)
    _, IT, C = wide_plan(W)
    n = W // C if C > 1 else 32 * IT
    bw = np.array([100, 100, 100, 4, 100], np.int64)[:P]
    mid = (W // 2 + W // (4 * C)) // (32 * IT) * (32 * IT)  # a warp's first cell
    la = np.array([rows - 3, 0, rows - 1, rows // 2, rows], np.int64)[:P]
    diff = np.array([W - n // 2 - 200, W // 3, n - 200, mid - 1 - 8, -rows // 2], np.int64)[:P]
    lb = la + diff
    lb[4:] = np.maximum(lb[4:], 1)
    LB = int(lb.max()) + 8
    ca = rng.integers(0, 4, (P, rows)).astype(np.int8)
    cb = rng.integers(0, 4, (P, LB)).astype(np.int8)
    for p in range(P):
        n_a = int(min(la[p], lb[p]))
        keep = rng.random(n_a) < 0.85
        cb[p, lb[p] - n_a : lb[p]] = np.where(keep, ca[p, :n_a], cb[p, lb[p] - n_a : lb[p]])
    diffs = lb - la
    lo = (np.minimum(0, diffs) - bw).astype(np.int32)
    kmax = (np.maximum(0, diffs) + bw - lo).astype(np.int32)
    assert int(kmax.max()) < W
    return ca, cb, la.astype(np.int32), lb.astype(np.int32), lo, kmax


#: (W, rows, P): every cluster size the proof can afford, few rows.
SHAPES = [(8192, 40, 5), (16384, 24, 4), (65536, 8, 3)]
PENALTIES = (0.0, -1.0, 5.0, 1.0)


@functools.lru_cache(maxsize=None)
def _case(W, rows, P):
    arrays = _wide_pairs(W + rows, P, rows, W)
    s_p, d_p = banded_pair_plain(*(torch.as_tensor(a) for a in arrays), *PENALTIES, rows, W)
    ca, cb, la, lb, lo, km = arrays
    s_j, d_j = _banded_pair_kernel(
        jnp.asarray(ca, jnp.int32), jnp.asarray(cb, jnp.int32), jnp.asarray(la), jnp.asarray(lb),
        jnp.asarray(lo), jnp.asarray(km), *PENALTIES, rows=rows, width=W)
    return arrays, (s_p.numpy(), d_p.numpy()), (np.asarray(s_j), np.asarray(d_j))


@pytest.mark.parametrize("W,rows,P", SHAPES, ids=[f"W{w}-rows{r}-P{p}" for w, r, p in SHAPES])
def test_wide_schedule_equals_plain_and_jax(W, rows, P):
    """Scores and every direction byte (rows past ``la`` and the empty pair
    included) equal to ``banded_pair_plain`` and to JAX's XLA
    ``_banded_pair_kernel``."""
    arrays, (s_plain, d_plain), (s_jax, d_jax) = _case(W, rows, P)
    scores, dirs = wide_pair(*arrays, *PENALTIES, rows, W)
    np.testing.assert_array_equal(dirs, d_plain)
    np.testing.assert_array_equal(scores, s_plain)
    np.testing.assert_array_equal(dirs, d_jax)
    np.testing.assert_array_equal(scores, s_jax)
    assert (scores > NEG).all()


def test_wide_case_shapes_reach_every_block():
    """The cases put kfin in a block other than the first (the last one for
    pair 0), end pair 2's band on the first cell of the next slice and pair
    3's on a warp's last cell."""
    for W, rows, P in SHAPES:
        ca, cb, la, lb, lo, km = _wide_pairs(W + rows, P, rows, W)
        _, IT, C = wide_plan(W)
        n = W // C if C > 1 else 32 * IT
        kfin = lb.astype(np.int64) - la - lo
        assert kfin[0] >= W - n  # the last block (the last warp of one block)
        assert la[1] == 0 and km[2] == n
        if P > 3:
            assert kfin[3] // (W // C) > 0 or C == 1
            assert (km[3] + 1) % (32 * IT) == 0  # the band ends on a warp's last cell


@pytest.mark.parametrize("W", [256, 1024])
def test_wide_schedule_below_its_widths(W):
    """The route forced below 8192 (one block of W / IT threads), with the
    warp route's adversarial pairs: end cells at, past and before the band's
    edges, an empty A, A past its stored width."""
    from test_torch_pair_warp import _pairs

    rows = 48
    arrays = _pairs(W, 19, rows, W, min(W // 2 - 14, 100))
    scores, dirs = wide_pair(*arrays, 2.0, -3.0, 4.0, 2.0, rows, W)
    s_p, d_p = banded_pair_plain(*(torch.as_tensor(a) for a in arrays), 2.0, -3.0, 4.0, 2.0, rows, W)
    np.testing.assert_array_equal(dirs, d_p.numpy())
    np.testing.assert_array_equal(scores, s_p.numpy())


def test_wide_plan_by_width():
    """One block of up to 8192 cells (512 threads of 16), a cluster of W /
    8192 blocks above: 2, 4 and 8 at W 16 384, 32 768 and 65 536."""
    assert [pair_route(w) for w in (8192, 16384, 32768, 65536)] == ["wide"] * 4
    assert wide_plan(256) == (256, 1, 1) and wide_plan(512) == (512, 1, 1)
    assert wide_plan(1024) == (512, 2, 1) and wide_plan(4096) == (512, 8, 1)
    assert [wide_plan(w) for w in (8192, 16384, 32768, 65536)] == [
        (512, 16, 1), (512, 16, 2), (512, 16, 4), (512, 16, 8)]


@pytest.mark.parametrize("width", [131072, 12288, 128, 200])
def test_wide_plan_refuses_what_the_kernel_lacks(width):
    """Widths past 65 536, not a power of two or under 256: refused before
    any launch."""
    with pytest.raises(ValueError, match="wide route"):
        wide_plan(width)
    args = [torch.zeros((2, 8), dtype=torch.int8)] * 2 + [torch.zeros(2, dtype=torch.int32)] * 4
    before = cuda_msa.PAIR_KERNEL.launches
    with pytest.raises(ValueError, match="band width"):
        cuda_msa._launch_pair(*args, 0.0, -1.0, 5.0, 1.0, 8, width, route="wide")
    assert cuda_msa.PAIR_KERNEL.launches == before


@pytest.mark.parametrize("active", [15, 0])
def test_wide_resources_report_the_cluster_and_refuse_none(active):
    """The wide route's attributes: its plan's threads and cluster, the
    clusters the card holds at once; a card that holds none raises."""
    import ctypes

    calls = []

    class Fake:
        def function(self, symbol, argtypes):
            assert symbol in ("sarlacc_pair_attrs", "sarlacc_pair_wide_attrs")

            def fn(w, buf):
                assert symbol == "sarlacc_pair_wide_attrs"  # no warp or block route above 4096
                calls.append(w)
                out = ctypes.cast(buf, ctypes.POINTER(ctypes.c_int))
                for i, v in enumerate((128, 5120, 0, 1, 512, w // 8192, active)):
                    out[i] = v
                return 0
            return fn

    if active:
        res = cuda_msa.pair_kernel_resources((65536,), Fake())
        assert sorted(res) == ["B:wide@65536"] and calls == [65536]
        r = res["B:wide@65536"]
        assert r["cluster"] == 8 and r["active_clusters"] == 15 and r["threads"] == 512
        assert r["dynamic_shared_bytes"] == 0 and r["occupancy"] == 0.25
    else:
        with pytest.raises(RuntimeError, match="no cluster of 8 blocks"):
            cuda_msa.pair_kernel_resources((65536,), Fake())

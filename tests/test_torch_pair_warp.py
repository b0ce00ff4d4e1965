"""Kernel B's warp route, proven on the CPU.

``csrc/pair_kernel.cu`` runs a pair of band width W <= 512 in one warp: lane
l keeps band cells [l*IT, (l+1)*IT) (IT = W / 32) in registers, takes the
previous row's S and V at k+1 from lane l + 1 for its last cell
(``__shfl_down_sync``), completes the horizontal cummax with a lane-local
running max and a 5-step warp scan (exclusive by one more shuffle), takes H
and mv at k-1 from lane l - 1 for its first cell (``__shfl_up_sync``),
reads sequence A's code from a 32-row register chunk by a broadcast
shuffle, and keeps sequence B's codes in a register window that slides one
cell a row (its last cell from lane l + 1, lane 31 loading the new one).

:func:`warp_pair` transliterates that schedule in float32 numpy, vectorised
over the pairs, with the lanes and every shuffle written out, and the tests
hold it bit for bit (tolerance 0), scores and direction bytes, to the
port's plain ``banded_pair_plain`` and to the Pallas ``_kernel`` in
interpret mode.  The wrapper's route by band width is tested here too.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402,F401  (JAX before the Pallas module)

from sarlacc_tpu.ops.pallas_msa import banded_pair_pallas  # noqa: E402
from sarlacc_tpu_torch.ops import cuda_msa  # noqa: E402
from sarlacc_tpu_torch.ops.cuda_msa import (  # noqa: E402
    BLOCK_MAX_WIDTH,
    MAX_WIDTH,
    PAIR_ROUTES,
    WARP_MAX_WIDTH,
    banded_pair_plain,
    pair_route,
)

NEG = np.float32(-1.0e9)


def _shfl_down(x, d=1):
    """``__shfl_down_sync`` over the lane axis (1): lanes past the end keep
    their own value."""
    out = x.copy()
    out[:, : 32 - d] = x[:, d:]
    return out


def _shfl_up(x, d=1):
    """``__shfl_up_sync`` over the lane axis (1): the first d lanes keep
    their own value."""
    out = x.copy()
    out[:, d:] = x[:, : 32 - d]
    return out


def warp_pair(codes_a, codes_b, lens_a, lens_b, lo, kmax, match, mismatch,
              gap_open, gap_ext, rows, width):
    """The warp route's schedule in float32 numpy: (scores f32 [P], dirs
    int8 [rows, P, W]).  Arguments as ``banded_pair_plain`` (numpy)."""
    f32 = np.float32
    P, LA = codes_a.shape
    W = width
    IT = W // 32
    mt, mm, go, ge = (f32(v) for v in (match, mismatch, gap_open, gap_ext))
    k = (np.arange(32)[:, None] * IT + np.arange(IT)[None, :])[None]  # [1, 32, IT]
    kf = k.astype(f32)
    la, lb, lo_, km = (np.asarray(x, np.int64)[:, None, None] for x in (lens_a, lens_b, lo, kmax))
    ca = np.asarray(codes_a, np.int64)
    cb = np.asarray(codes_b, np.int64)
    pidx = np.arange(P)[:, None, None]

    def b_code(j):  # B's code at column j, -1 outside [1, lb]
        inside = (j >= 1) & (j <= lb)
        return np.where(inside, cb[pidx, np.clip(j - 1, 0, cb.shape[1] - 1)], -1)

    j0 = lo_ + k
    S = np.where(j0 == 0, f32(0.0), np.where(
        (j0 >= 1) & (j0 <= lb) & (k <= km), -(go + (j0.astype(f32) - f32(1.0)) * ge), NEG
    )).astype(f32)
    V = np.full(S.shape, NEG, f32)
    bw = b_code(1 + lo_ + k)
    areg = np.full((P, 32), 5, np.int64)
    dirs = np.zeros((rows, P, W), np.int8)
    for i in range(1, rows + 1):
        if (i - 1) % 32 == 0:  # a lane per row of the next 32
            r = i - 1 + np.arange(32)
            areg = np.where(r < LA, ca[:, np.clip(r, 0, LA - 1)], 5)
        ai = areg[:, (i - 1) % 32][:, None, None]
        alive = (i <= la)
        s_nb, v_nb = _shfl_down(S[:, :, 0]), _shfl_down(V[:, :, 0])
        s_nb[:, 31] = v_nb[:, 31] = NEG
        s_up = np.concatenate([S[:, :, 1:], s_nb[:, :, None]], axis=2)
        v_up = np.concatenate([V[:, :, 1:], v_nb[:, :, None]], axis=2)
        sub = np.where(bw < 0, NEG, np.where(ai == bw, mt, mm))
        M = S + sub
        open_v, ext_v = s_up - go, v_up - ge
        Vn = np.maximum(open_v, ext_v)
        vext = ext_v >= open_v
        mv = np.maximum(M, Vn)
        B = (mv - go) + kf * ge
        start = np.full(B.shape[:2] + (1,), NEG, f32)
        run = np.maximum.accumulate(np.concatenate([start, B], axis=2), axis=2)[:, :, 1:]
        x = run[:, :, -1]
        lanes = np.arange(32)[None, :]
        for off in (1, 2, 4, 8, 16):
            x = np.where(lanes >= off, np.maximum(x, _shfl_up(x, off)), x)
        excl = _shfl_up(x, 1)
        excl[:, 0] = NEG
        cprev = np.concatenate(
            [excl[:, :, None], np.maximum(excl[:, :, None], run[:, :, :-1])], axis=2
        )
        j = i + lo_ + k
        valid = (j >= 0) & (j <= lb) & (k <= km)
        h = np.where((k > 0) & valid, cprev - (kf - f32(1.0)) * ge, NEG)
        m = np.where(valid, M, NEG)
        v = np.where(valid, Vn, NEG)
        sn = np.maximum(m, np.maximum(h, v))
        choice = np.where(m >= sn, 0, np.where(h >= sn, 1, 2))
        h_nb, mv_nb = _shfl_up(h[:, :, -1]), _shfl_up(mv[:, :, -1])
        h_nb[:, 0] = mv_nb[:, 0] = NEG
        h_prev = np.concatenate([h_nb[:, :, None], h[:, :, :-1]], axis=2)
        mv_prev = np.concatenate([mv_nb[:, :, None], mv[:, :, :-1]], axis=2)
        hext = (h_prev - ge) >= (mv_prev - go)
        dirs[i - 1] = (choice | (hext << 2) | (vext << 3)).reshape(P, W)
        S = np.where(alive, sn, S)
        V = np.where(alive, v, V)
        b_nb = _shfl_down(bw[:, :, 0])
        bw = np.concatenate([bw[:, :, 1:], b_nb[:, :, None]], axis=2)
        bw[:, 31, -1] = b_code(i + 1 + lo_ + W - 1)[:, 0, 0]
    kfin = np.asarray(lens_b, np.int64) - lens_a - lo
    flat = S.reshape(P, W)
    inside = (kfin >= 0) & (kfin < W)
    scores = np.where(inside, flat[np.arange(P), np.clip(kfin, 0, W - 1)], NEG)
    return scores.astype(f32), dirs


def _pairs(seed, P, rows, W, bw):
    """P pairs whose A is at most ``rows`` long (some much shorter, so the
    rows past ``la`` run frozen), B a noisy copy; the last pairs put the end
    cell at the band's last cell (k = W - 1), past its end, before its
    start, and make A empty or longer than its stored width."""
    rng = np.random.default_rng(seed)
    LA, LB = rows - 8, rows + 24
    codes_a = rng.integers(0, 5, (P, LA)).astype(np.int8)
    codes_b = rng.integers(0, 5, (P, LB)).astype(np.int8)
    codes_b[:, :LA] = np.where(rng.random((P, LA)) < 0.8, codes_a, codes_b[:, :LA])
    lens_a = rng.integers(rows // 4, LA + 1, P).astype(np.int32)
    lens_b = np.clip(lens_a + rng.integers(-12, 13, P), 1, LB).astype(np.int32)
    lens_a[-4], lens_b[-4] = 0, 5
    lens_a[-5], lens_b[-5] = rows, rows + 2  # past A's stored width: code 5 there
    lens_b[-1] = lens_a[-1] + 3
    diffs = lens_b.astype(np.int64) - lens_a
    lo = (np.minimum(0, diffs) - bw).astype(np.int32)
    kmax = (np.maximum(0, diffs) + bw - lo).astype(np.int32)
    assert int(kmax.max()) < W
    # The end cell at the band's last cell, past it, before its start.
    lo[-1], kmax[-1] = diffs[-1] - (W - 1), W - 1
    lo[-2] = diffs[-2] - W
    lo[-3] = diffs[-3] + 1
    return codes_a, codes_b, lens_a, lens_b, lo, kmax


#: (rows, W, band half-width): every warp-route width, la below rows.
SHAPES = [(64, 32, 6), (64, 64, 20), (96, 128, 40), (64, 256, 100), (64, 512, 200)]
PENALTIES = [(0.0, -1.0, 5.0, 1.0), (2.0, -3.0, 4.0, 2.0)]


@functools.lru_cache(maxsize=None)
def _case(rows, W, bw, pen):
    """A shape's pairs, the plain version's and the Pallas kernel's outputs
    (interpret mode; it takes pairs in lane tiles of 128, so it gets empty
    pairs to fill one), computed once."""
    P = 37
    arrays = _pairs(rows + W + bw, P, rows, W, bw)
    want = banded_pair_plain(*(torch.as_tensor(a) for a in arrays), *pen, rows, W)

    def pad(a, fill):
        out = np.full((128,) + a.shape[1:], fill, a.dtype)
        out[:P] = a
        return out

    ca, cb, la, lb, lo, km = arrays
    s_p, d_p = banded_pair_pallas(
        pad(ca, 5), pad(cb, 5), pad(la, 0), pad(lb, 0), pad(lo, -6), pad(km, 12),
        *pen, rows=rows, width=W, interpret=True,
    )
    pal = (np.asarray(s_p)[:P], np.asarray(d_p).transpose(0, 2, 1)[:, :P])
    return arrays, (want[0].numpy(), want[1].numpy()), pal


@pytest.mark.parametrize("pen", PENALTIES, ids=["mt0-mm-1-go5-ge1", "mt2-mm-3-go4-ge2"])
@pytest.mark.parametrize("rows,W,bw", SHAPES, ids=[f"rows{r}-W{w}" for r, w, _ in SHAPES])
def test_warp_schedule_equals_plain_and_pallas(rows, W, bw, pen):
    """Scores and every direction byte (rows past ``la`` included) equal
    to ``banded_pair_plain`` and to the Pallas ``_kernel``."""
    arrays, (s_plain, d_plain), (s_pal, d_pal) = _case(rows, W, bw, pen)
    scores, dirs = warp_pair(*arrays, *pen, rows, W)
    np.testing.assert_array_equal(dirs, d_plain)
    np.testing.assert_array_equal(scores, s_plain)
    np.testing.assert_array_equal(dirs, d_pal)
    np.testing.assert_array_equal(scores, s_pal)
    assert scores[-2] == scores[-3] == NEG and scores[-1] > NEG  # end cell out of / at the edge


@pytest.mark.parametrize("W", [32, 128, 512])
def test_warp_schedule_with_rows_past_every_read(W):
    """More rows than any A and codes past B's stored end: the frozen rows
    still write their directions, equal to the plain version's."""
    rows = 2 * W if W < 512 else 96
    arrays = list(_pairs(W, 19, rows // 2, W, min(W // 2 - 14, 60)))
    scores, dirs = warp_pair(*arrays, 0.0, -1.0, 5.0, 1.0, rows, W)
    s_plain, d_plain = banded_pair_plain(*(torch.as_tensor(a) for a in arrays),
                                         0.0, -1.0, 5.0, 1.0, rows, W)
    np.testing.assert_array_equal(dirs, d_plain.numpy())
    np.testing.assert_array_equal(scores, s_plain.numpy())


def test_route_follows_the_band_width():
    """The warp route up to 512 cells (every bucket of the pipeline: W 64 to
    512), the block route up to 4096, the wide route above; the kernel's
    numbering."""
    assert PAIR_ROUTES == ("warp", "block", "wide")
    assert WARP_MAX_WIDTH == 512 and BLOCK_MAX_WIDTH == 4096 and MAX_WIDTH == 65536
    assert [pair_route(w) for w in (32, 64, 128, 256, 512)] == ["warp"] * 5
    assert [pair_route(w) for w in (1024, 2048, 4096)] == ["block"] * 3
    assert [pair_route(w) for w in (8192, 16384, 32768, 65536)] == ["wide"] * 4


@pytest.mark.parametrize(
    "width,route",
    [(1024, "warp"), (256, "lane"), (96, None), (131072, None), (8192, "block"), (128, "wide")],
)
def test_launch_refuses_a_route_or_width_it_has_not(width, route):
    """A forced route must exist at the width, and the width must be a
    power of two the kernel takes; both raise before any launch."""
    args = [torch.zeros((2, 8), dtype=torch.int8)] * 2 + [torch.zeros(2, dtype=torch.int32)] * 4
    before = cuda_msa.PAIR_KERNEL.launches
    with pytest.raises(ValueError, match="route|power of two"):
        cuda_msa._launch_pair(*args, 0.0, -1.0, 5.0, 1.0, 8, width, route=route)
    assert cuda_msa.PAIR_KERNEL.launches == before


def test_pair_kernel_resources_keys():
    """Attributes are asked for the warp route up to 512 and the block route
    at every width."""
    calls = []

    class Fake:
        def function(self, symbol, argtypes):
            assert symbol == "sarlacc_pair_attrs"

            def fn(route, w, buf):
                import ctypes

                calls.append((route, w))
                out = ctypes.cast(buf, ctypes.POINTER(ctypes.c_int))
                for i, v in enumerate((100, 0, 0, 4, 128)):
                    out[i] = v
                return 0
            return fn

    res = cuda_msa.pair_kernel_resources((256, 512, 1024), Fake())
    assert sorted(res) == ["B:block@1024", "B:block@256", "B:block@512", "B:warp@256", "B:warp@512"]
    assert (0, 1024) not in calls and res["B:warp@256"]["occupancy"] == 0.25

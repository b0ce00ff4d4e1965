"""Kernels E and F's schedules, proven on the CPU.

``csrc/merge_kernel.cu`` (E) runs a merge wave's DP and walk in one launch.
Its warp route (W <= 512) keeps IT = W / 32 consecutive cells a lane, takes
S at a lane's last cell + 1 from lane + 1 (``__shfl_down_sync``), keeps a
running max of max(M, S_up) over the lane's cells and completes the row's
running max with a 5-step warp scan, exclusive by one more shuffle; its
block route (W above 512) takes the row in chunks of 256 cells, one a
thread, a chunk's running max being a warp scan, the earlier warps' maxima and the
carry of the chunks before.  Rows past a merge's ``la`` are skipped (their
choice bytes are never written).  The walk finds, per row, the first cell
at or below k whose choice is not 1 by ballots over 32 cells at a time,
scanning down.  ``csrc/walk_kernel.cu`` (F) walks kernel B's direction bytes
a pair a warp: ``pz_h`` by the same ballots over the horizontal-extend bit,
the hop chain inside the warp, and the identity's counts as it emits.

:func:`warp_merge_dp`, :func:`block_merge_dp`, :func:`merge_walk` and
:func:`pair_walk_lanes` transliterate those schedules in float32 numpy
(lanes, shuffles and ballots written out), and the tests hold them bit for
bit (tolerance 0) to the port's plain versions (``_profile_merge_kernel`` +
``_merge_walk_kernel``, ``_pair_walk_kernel`` + ``_pair_ident_kernel``) and
to JAX's ``_merge_dp_walk``, ``_pair_walk_kernel`` and ``_pair_ident_kernel``
(JAX pinned to float32), on real DP output and on adversarial planes.  The
dispatch by tensor device and the wrappers' checks are tested here too.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarlacc_tpu.ops import msa as jax_msa  # noqa: E402
from sarlacc_tpu_torch.ops import cuda_walk  # noqa: E402
from sarlacc_tpu_torch.ops import msa as port_msa  # noqa: E402
from sarlacc_tpu_torch.ops.cuda_msa import banded_pair_plain  # noqa: E402

F32 = np.float32
NEG = F32(-1.0e9)
LANES = np.arange(32)


def _shfl_down(x, d=1):
    """``__shfl_down_sync`` over axis 1: lanes past the end keep their own value."""
    out = x.copy()
    out[:, : 32 - d] = x[:, d:]
    return out


def _shfl_up(x, d=1):
    """``__shfl_up_sync`` over the last axis: the first d lanes keep their own value."""
    out = x.copy()
    out[..., d:] = x[..., : 32 - d]
    return out


def _warp_scan(x):
    """The kernels' 5-step inclusive max-scan over the last (lane) axis."""
    for off in (1, 2, 4, 8, 16):
        x = np.where(LANES >= off, np.maximum(x, _shfl_up(x, off)), x)
    return x


def _run_end(hit, c):
    """``run_end``: from cell ``c`` down, 32 cells a ballot (lane l tests
    cell base - l); the lowest set lane of the first non-empty ballot, or -1."""
    base = c
    while base >= 0:
        idx = base - LANES
        m = (idx >= 0) & hit[np.clip(idx, 0, None)]
        if m.any():
            return base - int(np.flatnonzero(m)[0])
        base -= 32
    return -1


def _clamp(k, W):
    return min(max(k, 0), W - 1)


def _row0(lo, kmax, k):
    return np.where((lo + k >= 0) & (k <= kmax), F32(0.0), NEG).astype(F32)


def warp_merge_dp(cost, la, lb, lo, kmax):
    """E's warp route's DP: the [rows, Pp, W] choice bytes, -1 on rows it
    skips (past each merge's ``la``)."""
    Pp, rows, W = cost.shape
    IT = W // 32
    k = (LANES[:, None] * IT + np.arange(IT)[None, :])[None]  # [1, 32, IT]
    la_, lb_, lo_, km_ = (np.asarray(x, np.int64)[:, None, None] for x in (la, lb, lo, kmax))
    S = np.broadcast_to(_row0(lo_, km_, k), (Pp, 32, IT)).copy()
    top = np.minimum(np.asarray(la, np.int64), rows)
    choices = np.full((rows, Pp, W), -1, np.int8)
    for i in range(1, int(top.max(initial=0)) + 1):
        live = i <= top
        c = cost[:, i - 1, :].reshape(Pp, 32, IT)
        s_nb = _shfl_down(S[:, :, 0])
        s_nb[:, 31] = NEG
        j = i + lo_ + k
        M = S + np.where((j >= 1) & (j <= lb_), c, NEG)
        sup = np.concatenate([S[:, :, 1:], s_nb[:, :, None]], axis=2)
        start = np.full((Pp, 32, 1), NEG, F32)
        run = np.maximum.accumulate(np.concatenate([start, np.maximum(M, sup)], axis=2), axis=2)[:, :, 1:]
        excl = _shfl_up(_warp_scan(run[:, :, -1]), 1)
        excl[:, 0] = NEG
        valid = (j >= 0) & (j <= lb_) & (k <= km_)
        sn = np.where(valid, np.maximum(excl[:, :, None], run), NEG)
        ch = np.where(M >= sn, 0, np.where(sup >= sn, 2, 1)).astype(np.int8)
        S = np.where(live[:, None, None], sn, S)
        choices[i - 1, live] = ch.reshape(Pp, W)[live]
    return choices


def block_merge_dp(cost, la, lb, lo, kmax):
    """E's block route's DP (256 threads a merge, W a multiple of 256): the
    choice bytes as :func:`warp_merge_dp` gives them."""
    Pp, rows, W = cost.shape
    T = 256
    nw = T // 32
    la_, lb_, lo_, km_ = (np.asarray(x, np.int64)[:, None] for x in (la, lb, lo, kmax))
    S = np.broadcast_to(_row0(lo_, km_, np.arange(W)[None]), (Pp, W)).copy()
    top = np.minimum(np.asarray(la, np.int64), rows)
    choices = np.full((rows, Pp, W), -1, np.int8)
    for i in range(1, int(top.max(initial=0)) + 1):
        live = i <= top
        nxt = np.empty_like(S)
        carry = np.full(Pp, NEG, F32)
        for c0 in range(0, W, T):
            k = c0 + np.arange(T)[None]
            j = i + lo_ + k
            m = S[:, c0 : c0 + T] + np.where((j >= 1) & (j <= lb_), cost[:, i - 1, c0 : c0 + T], NEG)
            sup = np.concatenate([S[:, 1:], np.full((Pp, 1), NEG, F32)], axis=1)[:, c0 : c0 + T]
            x = _warp_scan(np.maximum(m, sup).reshape(Pp, nw, 32))
            sw = x[:, :, 31]  # each warp's lane 31, through shared memory
            before = np.maximum.accumulate(np.concatenate([carry[:, None], sw], axis=1), axis=1)
            pre = before[:, :nw]  # carry and the warps below
            incl = np.maximum(pre[:, :, None], x).reshape(Pp, T)
            valid = (j >= 0) & (j <= lb_) & (k <= km_)
            sn = np.where(valid, incl, NEG)
            nxt[:, c0 : c0 + T] = sn
            choices[i - 1, live, c0 : c0 + T] = np.where(m >= sn, 0, np.where(sup >= sn, 2, 1))[live]
            carry = before[:, -1]
        S = np.where(live[:, None], nxt, S)
    return choices


def merge_walk(choices, la, lb, lo):
    """E's walk, a merge at a time, each row's run end by ballots."""
    rows, Pp, W = choices.shape
    jmat = np.zeros((rows, Pp), np.int32)
    for p in range(Pp):
        a, b, o = int(la[p]), int(lb[p]), int(lo[p])
        k = 0
        for r in range(min(a, rows), 0, -1):
            if r == a:
                k = b - a - o
            if r + o + k <= 0 or b <= 0:
                break
            row = choices[r - 1, p]
            kf = _run_end(row != 1, _clamp(k, W))
            if kf <= -(r + o) or kf < 0:
                break
            if row[kf] == 0:
                jmat[r - 1, p] = r + o + kf
                k = kf
            elif row[kf] == 2:
                k = kf + 1
    return jmat


def pair_walk_lanes(dirs, lens_a, lens_b, lo, codes_a, codes_b):
    """F's warp walk, a pair at a time: (jmat int32 [rows, P], identity
    float32 [P]).  A choice of 3 ends the row's chain unresolved."""
    rows, P, W = dirs.shape
    LA, LB = codes_a.shape[1], codes_b.shape[1]
    jmat = np.zeros((rows, P), np.int32)
    ident = np.zeros(P, F32)
    for p in range(P):
        a, b, o = int(lens_a[p]), int(lens_b[p]), int(lo[p])
        k, vstate, cnt, eq = 0, False, 0, 0
        for r in range(min(a, rows), 0, -1):
            if r == a:
                k, vstate = b - a - o, False
            if r + o + k <= 0 or b <= 0:
                break
            row = dirs[r - 1, p].astype(np.int64)
            if vstate:
                vstate = bool((row[_clamp(k, W)] >> 3) & 1)
                k += 1
                continue
            kz, kk, died, d, ch = -(r + o), k, False, 0, 0
            for _ in range(W + 1):
                c = _clamp(kk, W)
                d = row[c]
                ch = d & 3
                if ch != 1:
                    break
                kk = _run_end(((row >> 2) & 1) == 0, c) - 1
                if kk <= kz or kk < 0:
                    died = True
                    break
            if died:
                break
            if ch == 0:
                j = r + o + kk
                jmat[r - 1, p] = j
                ai = int(codes_a[p, r - 1]) if r - 1 < LA else 0
                cnt += 1
                eq += ai == int(codes_b[p, min(max(j - 1, 0), LB - 1)])
            elif ch == 2:
                vstate = bool((d >> 3) & 1)
                kk += 1
            k = kk
        ident[p] = F32(eq) / F32(max(cnt, 1))
    return jmat, ident


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


# --------------------------------------------------------------------------
# Kernel E
# --------------------------------------------------------------------------


def _merges(seed, Pp, rows, W, float_costs=False):
    """A wave of ``Pp`` merges (the last four padded, la = 0) with ``la``
    well below ``rows``, bands inside W, tie-heavy integer costs (or float32
    ones), and the walk's first lookup clamped at both edges of the band on
    two merges; blank cells and rows past ``la`` are NEG, as
    ``_merge_cost_init`` leaves them."""
    rng = np.random.default_rng(seed)
    la = rng.integers(rows // 4, rows - 7, Pp)
    bw = max(2, min(40, (W - 26) // 2))
    lb = np.clip(la + rng.integers(-10, 11, Pp), 1, None)
    diff = lb - la
    lo = np.minimum(0, diff) - bw
    kmax = np.maximum(0, diff) + bw - lo
    assert int(kmax.max()) < W
    lo[0] = diff[0] - W - 3  # k0 = lb - la - lo past the band's last cell
    lo[1] = diff[1] + 5  # k0 below 0
    kmax[:2] = W - 1
    la[-4:] = 0  # _bkt(P, 16) pads the wave with empty merges
    lb[-4:] = lo[-4:] = kmax[-4:] = 0
    k = np.arange(W)
    live = (np.arange(1, rows + 1)[None, :, None] <= la[:, None, None]) & (
        k[None, None, :] <= kmax[:, None, None]
    )
    if float_costs:
        w = (rng.random((Pp, rows, W)) * 100).astype(F32) / F32(3.0)
    else:
        w = (rng.integers(0, 4, (Pp, rows, W)) * 25.0).astype(F32)
    cost = np.where(live, w, NEG).astype(F32)
    return cost, *(x.astype(np.int32) for x in (la, lb, lo, kmax))


@functools.lru_cache(maxsize=None)
def _merge_case(rows, W, seed, float_costs=False):
    """A wave's inputs, the plain version's choices and jmat, and JAX's
    ``_merge_dp_walk`` (float32), computed once."""
    arrays = _merges(seed, 20, rows, W, float_costs)
    dirs = port_msa._profile_merge_kernel(*_t(*arrays))
    jm = port_msa._merge_walk_kernel(dirs, *_t(*arrays[1:4]))
    with jax.enable_x64(False):
        want = np.asarray(jax_msa._merge_dp_walk(*(jnp.asarray(a) for a in arrays)))
    return arrays, dirs.numpy(), jm.numpy(), want


def _check_merge(arrays, choices, d_plain, jm_plain, jm_jax):
    la = arrays[1]
    for p in range(la.size):  # every row the walk may read, every cell
        np.testing.assert_array_equal(choices[: la[p], p], d_plain[: la[p], p], err_msg=str(p))
        assert (choices[la[p]:, p] == -1).all(), p  # rows past la: no work
    jm = merge_walk(choices, *arrays[1:4])
    np.testing.assert_array_equal(jm, jm_plain)
    np.testing.assert_array_equal(jm, jm_jax.astype(np.int32))
    for p in range(la.size):
        assert not jm[la[p]:, p].any(), p  # nothing emitted past la
    assert jm[:, :-4].any() and not jm[:, -4:].any()  # padded merges emit nothing


@pytest.mark.parametrize("rows,W", [(64, 32), (64, 64), (96, 128), (64, 256), (64, 512)])
def test_merge_warp_route_equals_plain_and_jax(rows, W):
    """Choices on every live row and jmat, tolerance 0, at every warp-route
    width, with tie-heavy integer costs."""
    arrays, d_plain, jm_plain, jm_jax = _merge_case(rows, W, rows + W)
    assert cuda_walk.merge_route(W) == "warp"
    _check_merge(arrays, warp_merge_dp(*arrays), d_plain, jm_plain, jm_jax)


@pytest.mark.parametrize("rows,W", [(64, 1024), (96, 1024), (32, 2048), (40, 4096)])
def test_merge_block_route_equals_plain_and_jax(rows, W):
    """The block route at the widths it takes (four to sixteen chunks of 256
    cells, eight warps a chunk), with tie-heavy integer costs."""
    arrays, d_plain, jm_plain, jm_jax = _merge_case(rows, W, rows + W)
    assert cuda_walk.merge_route(W) == "block"
    _check_merge(arrays, block_merge_dp(*arrays), d_plain, jm_plain, jm_jax)


@pytest.mark.parametrize("route,W", [("warp", 256), ("block", 1024)])
def test_merge_routes_with_float_costs(route, W):
    """Non-integer float32 costs: M is one float add, the running max exact."""
    arrays, d_plain, jm_plain, jm_jax = _merge_case(64, W, 7, float_costs=True)
    assert cuda_walk.merge_route(W) == route
    dp = warp_merge_dp if route == "warp" else block_merge_dp
    _check_merge(arrays, dp(*arrays), d_plain, jm_plain, jm_jax)


def test_merge_walk_on_adversarial_choices():
    """The ballot walk against the plain walk on random choice planes (0-2)
    with long horizontal runs across 32-cell ballots, ``la`` below rows and
    the first lookup clamped at both edges."""
    rng = np.random.default_rng(21)
    rows, P, W = 64, 24, 128
    dirs = np.where(rng.random((rows, P, W)) < 0.85, 1, rng.integers(0, 3, (rows, P, W))).astype(np.int8)
    la = rng.integers(1, rows // 2, P).astype(np.int32)
    lb = rng.integers(1, rows // 2, P).astype(np.int32)
    lo = (np.minimum(0, lb - la) - 8).astype(np.int32)
    lo[0] = lb[0] - la[0] - W - 5
    lo[1] = lb[1] - la[1] + 2
    want = port_msa._merge_walk_kernel(*_t(dirs, la, lb, lo)).numpy()
    got = merge_walk(dirs, la, lb, lo)
    np.testing.assert_array_equal(got, want)
    with jax.enable_x64(False):
        np.testing.assert_array_equal(got, np.asarray(jax_msa._merge_walk_kernel(jnp.asarray(dirs), la, lb, lo)))
    assert got.any()


# --------------------------------------------------------------------------
# Kernel F
# --------------------------------------------------------------------------


def _pairs(seed, P, rows, W, bw):
    """P read pairs (B a noisy copy of A, some much shorter than ``rows``)
    and their bands, as ``ops/msa.py::_pair_bucket_on`` pads them."""
    rng = np.random.default_rng(seed)
    LA, LB = rows, rows + 24
    ca = rng.integers(0, 4, (P, LA)).astype(np.int8)
    cb = rng.integers(0, 4, (P, LB)).astype(np.int8)
    cb[:, :LA] = np.where(rng.random((P, LA)) < 0.8, ca, cb[:, :LA])
    la = rng.integers(rows // 4, rows - 7, P).astype(np.int32)
    lb = np.clip(la + rng.integers(-12, 13, P), 1, LB).astype(np.int32)
    diff = lb.astype(np.int64) - la
    lo = (np.minimum(0, diff) - bw).astype(np.int32)
    km = (np.maximum(0, diff) + bw - lo).astype(np.int32)
    assert int(km.max()) < W
    for a, L, n in ((ca, la, LA), (cb, lb, LB)):  # code 5 past each read's end
        a[np.arange(n)[None, :] >= L[:, None]] = 5
    return ca, cb, la, lb, lo, km


def _want_pair(dirs, la, lb, lo, ca, cb):
    """(plain jmat, plain identity, JAX jmat, JAX identity)."""
    jm = port_msa._pair_walk_kernel(*_t(dirs, la, lb, lo))
    ident = port_msa._pair_ident_kernel(jm, *_t(ca, cb))
    with jax.enable_x64(False):
        jj = jax_msa._pair_walk_kernel(jnp.asarray(dirs), la, lb, lo)
        ij = jax_msa._pair_ident_kernel(jj, jnp.asarray(ca, jnp.int32), jnp.asarray(cb, jnp.int32))
    return jm.numpy(), ident.numpy(), np.asarray(jj).astype(np.int32), np.asarray(ij)


def _check_pair(args, la):
    jm, ident = pair_walk_lanes(*args)
    jm_p, id_p, jm_j, id_j = _want_pair(*args)
    np.testing.assert_array_equal(jm, jm_p)
    np.testing.assert_array_equal(jm, jm_j)
    assert ident.dtype == id_p.dtype == id_j.dtype == np.float32
    np.testing.assert_array_equal(ident, id_p)
    np.testing.assert_array_equal(ident, id_j)
    for p in range(la.size):
        assert not jm[la[p]:, p].any(), p  # nothing emitted past la
    return jm, ident


@pytest.mark.parametrize("pen", [(0.0, -1.0, 5.0, 1.0), (2.0, -3.0, 4.0, 2.0)], ids=["mt0", "mt2"])
@pytest.mark.parametrize("rows,W,bw", [(64, 32, 6), (64, 64, 20), (96, 128, 40), (64, 256, 100)])
def test_pair_walk_on_dp_output(rows, W, bw, pen):
    """F's walk over kernel B's plain directions: jmat and identities equal
    to the plain walk + identity and to JAX's, tolerance 0."""
    ca, cb, la, lb, lo, km = _pairs(rows + W, 37, rows, W, bw)
    _, dirs = banded_pair_plain(*_t(ca, cb, la, lb, lo, km), *pen, rows, W)
    jm, ident = _check_pair((dirs.numpy(), la, lb, lo, ca, cb), la)
    assert (ident > 0.5).mean() > 0.5  # real alignments


def _adversarial_dirs(rng, rows, P, W):
    """Legal direction planes (choice 0-2, random extend bits) with long
    horizontal runs: most horizontal-extend bits set, and rows that are
    mostly horizontal choices."""
    choice = rng.integers(0, 3, (rows, P, W))
    horiz = rng.random((rows, P, 1)) < 0.4
    choice = np.where(horiz & (rng.random((rows, P, W)) < 0.9), 1, choice)
    hext = rng.random((rows, P, W)) < 0.93
    vext = rng.integers(0, 2, (rows, P, W))
    return (choice + (hext.astype(np.int64) << 2) + (vext << 3)).astype(np.int8)


@pytest.mark.parametrize("rows,W", [(64, 32), (64, 128), (48, 1024)])
def test_pair_walk_on_adversarial_planes(rows, W):
    """Random legal planes, ``la`` well below ``rows``, the start cell
    clamped at both edges (k0 past W - 1 and below 0), A's codes narrower
    than the rows (code 0 past them) and B's index clamped."""
    rng = np.random.default_rng(rows + W)
    P = 30
    dirs = _adversarial_dirs(rng, rows, P, W)
    la = rng.integers(1, rows // 2, P).astype(np.int32)
    lb = rng.integers(1, rows // 2, P).astype(np.int32)
    lo = (np.minimum(0, lb - la) - 8).astype(np.int32)
    lo[0] = lb[0] - la[0] - W - 4
    lo[1] = lb[1] - la[1] + 3
    ca = rng.integers(0, 4, (P, rows // 3)).astype(np.int8)
    cb = rng.integers(0, 4, (P, rows // 4)).astype(np.int8)
    jm, _ = _check_pair((dirs, la, lb, lo, ca, cb), la)
    assert jm.any()


def test_pair_walk_choice_three_ends_the_chain():
    """A choice of 3 (kernel B never writes one; the reference's loop would
    spin) ends that row's chain unresolved: nothing emitted there, the pair
    stays in S at its column, and the walk goes on below."""
    rows, W = 8, 32
    dirs = np.zeros((rows, 1, W), np.int8)  # all diagonal
    la, lb, lo = (np.array([v], np.int32) for v in (6, 6, -3))
    dirs[4, 0, 3] = 3  # row 5, at the start column k0 = 3
    jm, ident = pair_walk_lanes(dirs, la, lb, lo, np.zeros((1, rows), np.int8), np.zeros((1, 8), np.int8))
    assert jm[:, 0].tolist() == [1, 2, 3, 4, 0, 6, 0, 0]
    assert ident[0] == 1.0


# --------------------------------------------------------------------------
# Dispatch and the wrappers' checks
# --------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors ``ops/msa.py``'s dispatchers run the plain versions
    (equal to their direct calls) and launch nothing; the kernels' wrappers
    refuse CPU tensors before any launch."""
    arrays, _, jm_plain, _ = _merge_case(64, 64, 128)
    ca, cb, la, lb, lo, km = _pairs(5, 9, 64, 64, 20)
    _, dirs = banded_pair_plain(*_t(ca, cb, la, lb, lo, km), 0.0, -1.0, 5.0, 1.0, 64, 64)
    counts = (cuda_walk.MERGE_KERNEL.launches, cuda_walk.WALK_KERNEL.launches)
    jm = port_msa._merge_dp_walk(*_t(*arrays))
    np.testing.assert_array_equal(jm.numpy(), jm_plain)
    pj, pi = port_msa._pair_walk(dirs, *_t(la, lb, lo, ca, cb))
    want = port_msa._pair_walk_kernel(dirs, *_t(la, lb, lo))
    assert torch.equal(pj, want) and torch.equal(pi, port_msa._pair_ident_kernel(want, *_t(ca, cb)))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_walk.merge_dp_walk(*_t(*arrays))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_walk.pair_walk(dirs, *_t(la, lb, lo, ca, cb))
    assert (cuda_walk.MERGE_KERNEL.launches, cuda_walk.WALK_KERNEL.launches) == counts


def test_entry_steps_reach_the_dispatchers(monkeypatch):
    """``merge_wave_from_library`` hands its cost planes and int32 bands to
    ``_merge_dp_walk``, and ``_pair_bucket_on`` kernel B's directions to
    ``_pair_walk``."""
    seen = []
    real_merge, real_pair = port_msa._merge_dp_walk, port_msa._pair_walk

    def merge_spy(cost, *bands):
        seen.append(("E", tuple(cost.shape), [b.dtype for b in bands]))
        return real_merge(cost, *bands)

    def pair_spy(dirs, *args):
        seen.append(("F", tuple(dirs.shape), [a.dtype for a in args]))
        return real_pair(dirs, *args)

    monkeypatch.setattr(port_msa, "_merge_dp_walk", merge_spy)
    monkeypatch.setattr(port_msa, "_pair_walk", pair_spy)
    lib = (torch.tensor([[1, 1, 40000], [2, 2, 40000]], dtype=torch.int32), F32(1 / 400))
    desc = {"la": 2, "lb": 2, "lo": -3, "kmax": 6, "segments": [(0, 2, 0, 0, 0)],
            "p2ca": np.array([0, 1, 2], np.int32), "p2cb": np.array([0, 1, 2], np.int32)}
    jm = port_msa.merge_wave_from_library(lib, [desc], 64, 64)
    assert jm[:2, 0].tolist() == [1, 2]
    ca, cb, la, lb, lo, km = _pairs(3, 5, 64, 64, 20)
    port_msa._pair_bucket_on(ca, la, cb, lb, lo, lo + km, 0.0, -1.0, 5.0, 1.0, 64, 64, torch.device("cpu"))
    assert seen == [("E", (16, 64, 64), [torch.int32] * 4),
                    ("F", (64, 5, 64), [torch.int32] * 3 + [torch.int8] * 2)]


@pytest.mark.parametrize("W,why", [(8, "power of two"), (16, "power of two"), (96, "power of two"),
                                   (1000, "power of two"), (131072, "CUDA"), (262144, "CUDA")])
def test_merge_launch_checks_the_width(W, why):
    """The band width must be a power of two from 32, with no upper limit (a
    merge of a long profile with a short one gives W 131 072): a wide band
    passes the width check and is refused here only for lying on the CPU.
    Nothing launches."""
    before = cuda_walk.MERGE_KERNEL.launches
    cost = torch.zeros((2, 4, W), dtype=torch.float32)
    bands = [torch.zeros(2, dtype=torch.int32)] * 4
    with pytest.raises(ValueError, match=why):
        cuda_walk._launch_merge(cost, *bands)
    assert cuda_walk.MERGE_KERNEL.launches == before


def test_routes_and_resources_keys(monkeypatch):
    """E's warp route up to 512 cells, its block route above; resources are
    asked for F once and for E at each width on its own route."""
    assert cuda_walk.MERGE_ROUTES == ("warp", "block") and cuda_walk.WARP_MAX_WIDTH == 512
    assert [cuda_walk.merge_route(w) for w in (32, 64, 128, 256, 512)] == ["warp"] * 5
    assert [cuda_walk.merge_route(w) for w in (1024, 4096, 65536, 131072)] == ["block"] * 4
    calls = []

    class Fake:
        def __init__(self, symbol):
            self.symbol = symbol

        def function(self, symbol, argtypes):
            assert symbol == self.symbol

            def fn(*args):
                import ctypes

                calls.append((symbol, args[:-1]))
                out = ctypes.cast(args[-1], ctypes.POINTER(ctypes.c_int))
                for i, v in enumerate((40, 0, 0, 16, 128)):
                    out[i] = v
                return 0
            return fn

    monkeypatch.setattr(cuda_walk, "WALK_KERNEL", Fake("sarlacc_walk_attrs"))
    monkeypatch.setattr(cuda_walk, "MERGE_KERNEL", Fake("sarlacc_merge_attrs"))
    res = cuda_walk.walk_kernel_resources((256, 1024, 131072))
    assert sorted(res) == ["E:block@1024", "E:block@131072", "E:warp@256", "F"]
    assert [c for c in calls if c[0] == "sarlacc_merge_attrs"] == [
        ("sarlacc_merge_attrs", (0, 256)), ("sarlacc_merge_attrs", (1, 1024)),
        ("sarlacc_merge_attrs", (1, 131072))]
    assert res["F"]["occupancy"] == 1.0

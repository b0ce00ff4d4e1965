"""Kernels E and F's schedules, proven on the CPU.

``csrc/merge_kernel.cu`` (E) runs a merge wave from its library entries to
jmat in one launch.  The entries come sorted by cell with row pointers; a
live row's costs are staged before the row is computed: the blank (0 up to
kmax, NEG past it), then each cell's run of entries summed from 0.0 in
entry order by the thread holding the run's first entry, the entries taken
32 (a warp) or 256 (a block) at a time, the entry before a chunk's first
carried by a shuffle (warp route) or read from memory (block routes).  Its
warp route (W <= 512) keeps IT = W / 32 consecutive cells a lane, takes S at
a lane's last cell + 1 from lane + 1 (``__shfl_down_sync``); pass 1 keeps a
running max of max(M, S_up) over the lane's cells and a 5-step warp scan,
exclusive by one more shuffle, completes the row's; pass 2 recomputes M and
S_up for each cell's S and choice.  Its block route (W 1 024-8 192) does the
same over 256 threads of CT = W / 256 cells, S_up across a warp boundary
from the next warp's first S, the running max completed by the earlier
warps' maxima; its wide route (above 8 192) takes the row in chunks of 256
cells, one a thread, a chunk's running max being a warp scan, the earlier
warps' maxima and the carry of the chunks before.  Choices are two bits a
cell, sixteen a word (threads of fewer cells merge their bits by xor
shuffles).  Rows past a merge's ``la`` are skipped (their words are never
written).  The walk reads each row through a window: at a window's first
row the 64 cells around the column of the next 32 rows, a row a lane; it
opens a new one when the column leaves it, and a lookup outside it reads
the row itself; per row it finds the first cell at or below k whose choice
is not 1 by ballots over 32 cells at a time, scanning down.
``csrc/walk_kernel.cu`` (F) walks kernel B's direction bytes a pair a warp
through windows of 64 bytes the same way: ``pz_h`` by the same ballots over
the horizontal-extend bit, the hop chain inside the warp; a diagonal exit
notes its j in the lane of its row, and when the window closes each lane
writes its row's jmat and compares its codes.

:func:`stage_wave`, :func:`warp_merge_dp`, :func:`block_merge_dp`,
:func:`wide_merge_dp`, :func:`merge_walk` and :func:`pair_walk_lanes`
transliterate those schedules in float32 numpy (lanes, shuffles, ballots and
windows written out), and the tests hold them bit for bit (tolerance 0) to
the port's plain versions (``_merge_cost_init`` + ``_ordered_add_`` +
``_profile_merge_kernel`` + ``_merge_walk_kernel``, ``_pair_walk_kernel`` +
``_pair_ident_kernel``) and to JAX's ``_merge_dp_walk``,
``_pair_walk_kernel`` and ``_pair_ident_kernel`` (JAX pinned to float32),
on real DP output and on adversarial planes (a plane's live in-band cells
given as one entry each).  ``tests/test_torch_merge_fused.py`` holds the
fused E to whole library waves.  The dispatch by tensor device and the
wrappers' checks are tested here too.
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
WIN = 64  # cells of a walk window row (E: four words, F: 64 bytes)


def _shfl_down(x, d=1):
    """``__shfl_down_sync`` over the last (lane) axis: lanes past the end keep their own value."""
    out = x.copy()
    out[..., : 32 - d] = x[..., d:]
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
    cell base - l); the lowest set lane of the first non-empty ballot, or -1.
    ``hit(idx)`` tests an array of cells (all >= 0)."""
    base = c
    while base >= 0:
        idx = base - LANES
        m = np.zeros(32, bool)
        m[idx >= 0] = hit(idx[idx >= 0])
        if m.any():
            return base - int(np.flatnonzero(m)[0])
        base -= 32
    return -1


def _clamp(k, W):
    return min(max(k, 0), W - 1)


def _row0(lo, kmax, k):
    return np.where((lo + k >= 0) & (k <= kmax), F32(0.0), NEG).astype(F32)


def _blank(kmax, W):
    """Every live row's costs before its entries: 0 up to kmax, NEG past."""
    return np.where(np.arange(W)[None, :] <= np.asarray(kmax, np.int64)[:, None], F32(0.0), NEG)


# --------------------------------------------------------------------------
# Kernel E: staging, the three DP routes, the packed choices, the walk
# --------------------------------------------------------------------------


def stage_wave(cols, w, rowptr, kmax, rows, W, threads):
    """E's cost staging for every row of a wave: [Pp, rows, W] float32.

    Each row starts blank; its entries go ``threads`` at a time, entry idx
    (lane ``(idx - b) % threads`` of its step) opening its cell's run when
    its cell differs from the row's entry before's: on the warp route lane 0
    takes the step's carry (lane 31's cell of the step before, -1 on the
    row's first) and the others the shuffled cell of the lane below; on the
    block routes the entry before is read from the table (-1 at the row's
    start).  A run's opener adds the run from 0.0 in entry order, reading on
    past its step to the row's end, and writes the cell."""
    cols = np.asarray(cols, np.int64)
    w = np.asarray(w, F32)
    rowptr = np.asarray(rowptr, np.int64)
    Pp = len(kmax)
    plane = np.repeat(_blank(kmax, W)[:, None, :], rows, axis=1)
    n = int(rowptr[-1])
    if n == 0:
        return plane
    idx = np.arange(n)
    row = np.searchsorted(rowptr, idx, side="right") - 1
    b, e = rowptr[row], rowptr[row + 1]
    col = cols[idx]
    before = np.where(idx > 0, cols[np.maximum(idx - 1, 0)], -1)
    if threads == 32:
        lane = (idx - b) % 32
        carry = np.where(idx - b >= 32, before, -1)  # lane 31's cell, one step back
        prev = np.where(lane == 0, carry, before)  # __shfl_up_sync of the cell
    else:
        prev = np.where(idx > b, before, -1)
    head = np.flatnonzero(col != prev)
    acc = np.zeros(head.size, F32) + w[head]  # 0.0 + w, in float32
    q = head + 1
    open_ = np.ones(head.size, bool)
    while True:
        open_ &= (q < e[head]) & (cols[np.minimum(q, cols.size - 1)] == col[head])
        if not open_.any():
            break
        acc[open_] = acc[open_] + w[q[open_]]
        q += 1
    plane.reshape(Pp * rows, W)[row[head], col[head]] = acc
    return plane


def pack_bits(bits, C):
    """``store_bits``: threads' choice bits ([..., T], C cells a thread, two
    bits a cell; for C == 32 a pair (lo, hi)) as the row's words [..., W / 16].
    Below 16 cells a thread, the 16 / C threads of a word or their bits by
    xor shuffles (offsets L / 2 .. 1) and the first writes."""
    if C == 32:
        lo, hi = bits
        return np.stack([lo, hi], axis=-1).reshape(*lo.shape[:-1], -1)
    if C == 16:
        return bits
    L = 16 // C
    T = bits.shape[-1]
    t = np.arange(T)
    x = bits << (2 * C * (t % L)).astype(np.uint64)
    off = L // 2
    while off >= 1:
        x = x | x[..., t ^ off]
        off //= 2
    return x[..., ::L]


def _two_bits(choices):
    """Per-cell choices [..., C] as the thread's bit field (u-th cell at 2u)."""
    C = choices.shape[-1]
    sh = (2 * np.arange(C)).astype(np.uint64)
    return (choices.astype(np.uint64) << sh).sum(axis=-1, dtype=np.uint64)


def warp_merge_dp(plane, la, lb, lo, kmax):
    """E's warp route's DP over the staged plane: the [rows, Pp, W / 16]
    packed choice words (uint64 holding 32 bits) and which rows were written."""
    Pp, rows, W = plane.shape
    IT = W // 32
    k = (LANES[:, None] * IT + np.arange(IT)[None, :])[None]  # [1, 32, IT]
    la_, lb_, lo_, km_ = (np.asarray(x, np.int64)[:, None, None] for x in (la, lb, lo, kmax))
    S = np.broadcast_to(_row0(lo_, km_, k), (Pp, 32, IT)).copy()
    top = np.minimum(np.asarray(la, np.int64), rows)
    words = np.zeros((rows, Pp, W // 16), np.uint64)
    written = np.zeros((rows, Pp), bool)
    for i in range(1, int(top.max(initial=0)) + 1):
        live = i <= top
        c = plane[:, i - 1, :].reshape(Pp, 32, IT)
        s_nb = _shfl_down(S[:, :, 0])
        s_nb[:, 31] = NEG
        j = i + lo_ + k
        cm = np.where((j >= 1) & (j <= lb_), c, NEG)
        tmax = np.full((Pp, 32), NEG, F32)
        for u in range(IT):  # pass 1
            sup = S[:, :, u + 1] if u + 1 < IT else s_nb
            tmax = np.maximum(tmax, np.maximum(S[:, :, u] + cm[:, :, u], sup))
        run = _shfl_up(_warp_scan(tmax), 1)
        run[:, 0] = NEG
        Sn = np.empty_like(S)
        ch = np.empty(S.shape, np.int64)
        valid = (j >= 0) & (j <= lb_) & (k <= km_)
        for u in range(IT):  # pass 2: M and S_up again, S from the old row
            M = S[:, :, u] + cm[:, :, u]
            sup = S[:, :, u + 1] if u + 1 < IT else s_nb
            run = np.maximum(run, np.maximum(M, sup))
            Sn[:, :, u] = np.where(valid[:, :, u], run, NEG)
            ch[:, :, u] = np.where(M >= Sn[:, :, u], 0, np.where(sup >= Sn[:, :, u], 2, 1))
        S = np.where(live[:, None, None], Sn, S)
        words[i - 1, live] = pack_bits(_two_bits(ch), IT)[live]
        written[i - 1] = live
    return words, written


def block_merge_dp(plane, la, lb, lo, kmax):
    """E's block route's DP (256 threads of CT = W / 256 cells, eight warps):
    packed words and written rows as :func:`warp_merge_dp` gives them."""
    Pp, rows, W = plane.shape
    T, CT = 256, W // 256
    t = np.arange(T)
    lane, warp = t % 32, t // 32
    k = (t[:, None] * CT + np.arange(CT)[None, :])[None]  # [1, T, CT]
    la_, lb_, lo_, km_ = (np.asarray(x, np.int64)[:, None, None] for x in (la, lb, lo, kmax))
    S = np.broadcast_to(_row0(lo_, km_, k), (Pp, T, CT)).copy()
    top = np.minimum(np.asarray(la, np.int64), rows)
    words = np.zeros((rows, Pp, W // 16), np.uint64)
    written = np.zeros((rows, Pp), bool)
    for i in range(1, int(top.max(initial=0)) + 1):
        live = i <= top
        c = plane[:, i - 1, :].reshape(Pp, T, CT)
        first = S[:, ::32, 0]  # sFirst: each warp's lane 0, the row before
        s_nb = _shfl_down(S[:, :, 0].reshape(Pp, 8, 32)).reshape(Pp, T)
        nxt_first = np.concatenate([first[:, 1:], np.full((Pp, 1), NEG, F32)], axis=1)
        s_nb = np.where(lane == 31, nxt_first[:, warp], s_nb)
        j = i + lo_ + k
        cm = np.where((j >= 1) & (j <= lb_), c, NEG)
        tmax = np.full((Pp, T), NEG, F32)
        for u in range(CT):
            sup = S[:, :, u + 1] if u + 1 < CT else s_nb
            tmax = np.maximum(tmax, np.maximum(S[:, :, u] + cm[:, :, u], sup))
        x = _warp_scan(tmax.reshape(Pp, 8, 32))
        s_warp = x[:, :, 31]
        run = _shfl_up(x, 1)
        run[:, :, 0] = NEG
        run = run.reshape(Pp, T)
        for wi in range(8):  # the earlier warps' maxima, from shared memory
            run = np.where(warp > wi, np.maximum(run, s_warp[:, wi : wi + 1]), run)
        Sn = np.empty_like(S)
        ch = np.empty(S.shape, np.int64)
        valid = (j >= 0) & (j <= lb_) & (k <= km_)
        for u in range(CT):
            M = S[:, :, u] + cm[:, :, u]
            sup = S[:, :, u + 1] if u + 1 < CT else s_nb
            run = np.maximum(run, np.maximum(M, sup))
            Sn[:, :, u] = np.where(valid[:, :, u], run, NEG)
            ch[:, :, u] = np.where(M >= Sn[:, :, u], 0, np.where(sup >= Sn[:, :, u], 2, 1))
        S = np.where(live[:, None, None], Sn, S)
        if CT == 32:
            bits = (_two_bits(ch[:, :, :16]), _two_bits(ch[:, :, 16:]))
        else:
            bits = _two_bits(ch)
        words[i - 1, live] = pack_bits(bits, CT)[live]
        written[i - 1] = live
    return words, written


def wide_merge_dp(plane, la, lb, lo, kmax):
    """E's wide route's DP (chunks of 256 cells, one a thread, eight warps a
    chunk): packed words and written rows as :func:`warp_merge_dp` gives
    them."""
    Pp, rows, W = plane.shape
    T = 256
    nw = T // 32
    la_, lb_, lo_, km_ = (np.asarray(x, np.int64)[:, None] for x in (la, lb, lo, kmax))
    S = np.broadcast_to(_row0(lo_, km_, np.arange(W)[None]), (Pp, W)).copy()
    top = np.minimum(np.asarray(la, np.int64), rows)
    words = np.zeros((rows, Pp, W // 16), np.uint64)
    written = np.zeros((rows, Pp), bool)
    for i in range(1, int(top.max(initial=0)) + 1):
        live = i <= top
        nxt = np.empty_like(S)
        carry = np.full(Pp, NEG, F32)
        row_words = np.zeros((Pp, W // 16), np.uint64)
        for c0 in range(0, W, T):
            k = c0 + np.arange(T)[None]
            j = i + lo_ + k
            m = S[:, c0 : c0 + T] + np.where((j >= 1) & (j <= lb_), plane[:, i - 1, c0 : c0 + T], NEG)
            sup = np.concatenate([S[:, 1:], np.full((Pp, 1), NEG, F32)], axis=1)[:, c0 : c0 + T]
            x = _warp_scan(np.maximum(m, sup).reshape(Pp, nw, 32))
            sw = x[:, :, 31]  # each warp's lane 31, through shared memory
            before = np.maximum.accumulate(np.concatenate([carry[:, None], sw], axis=1), axis=1)
            pre = before[:, :nw]  # carry and the warps below
            incl = np.maximum(pre[:, :, None], x).reshape(Pp, T)
            valid = (j >= 0) & (j <= lb_) & (k <= km_)
            sn = np.where(valid, incl, NEG)
            nxt[:, c0 : c0 + T] = sn
            ch = np.where(m >= sn, 0, np.where(sup >= sn, 2, 1))
            row_words[:, c0 // 16 : (c0 + T) // 16] = pack_bits(ch.astype(np.uint64), 1)
            carry = before[:, -1]
        S = np.where(live[:, None], nxt, S)
        words[i - 1, live] = row_words[live]
        written[i - 1] = live
    return words, written


MERGE_DP = {"warp": warp_merge_dp, "block": block_merge_dp, "wide": wide_merge_dp}


def unpack(words, W):
    """Packed words [..., W / 16] as one choice a cell [..., W]."""
    sh = (2 * np.arange(16)).astype(np.uint64)
    return ((words[..., None] >> sh) & np.uint64(3)).reshape(*words.shape[:-1], W).astype(np.int8)


def _window_base(c, W, wc):
    lowest = (c - 24) & ~15
    return min(max(lowest, 0), W - wc)


def merge_walk(words, la, lb, lo, W, stats=None):
    """E's walk over packed words, a merge at a time, through windows of
    ``min(4, W / 16)`` words a row (``stats`` counts window loads and
    lookups that fell outside the window)."""
    rows, Pp, NW = words.shape
    ww = min(NW, 4)
    wc = 16 * ww
    jmat = np.zeros((rows, Pp), np.int32)
    stats = {} if stats is None else stats
    for p in range(Pp):
        a, b, o = int(la[p]), int(lb[p]), int(lo[p])
        top = 0 if b <= 0 else min(a, rows)  # lb <= 0: no row is active
        k = b - a - o if a <= rows else 0  # enters at (la, lb) if la is a row
        wtop, wbase = 0, 0  # wtop 0: no window yet
        win = np.zeros((32, 4), np.uint64)
        for r in range(top, 0, -1):
            if r + o + k <= 0:
                break
            c = _clamp(k, W)
            if not 0 <= wtop - r < 32 or not 0 <= c - wbase < wc:
                wtop, wbase = r, _window_base(c, W, wc)
                for lane in range(32):
                    if r - lane >= 1:
                        win[lane, :ww] = words[r - lane - 1, p, wbase // 16 : wbase // 16 + ww]
                stats["windows"] = stats.get("windows", 0) + 1
            wrow, grow = win[wtop - r], words[r - 1, p]

            def choice(x, wrow=wrow, grow=grow, wbase=wbase):
                x = np.asarray(x)
                d = x - wbase
                inside = (d >= 0) & (d < wc)
                stats["outside"] = stats.get("outside", 0) + int((~inside).sum())
                word = np.where(inside, wrow[np.clip(d, 0, wc - 1) >> 4], grow[x >> 4])
                return ((word >> (2 * (x & 15)).astype(np.uint64)) & np.uint64(3)).astype(np.int64)

            kf = _run_end(lambda idx: choice(idx) != 1, c)
            if kf <= -(r + o) or kf < 0:
                break
            ch = int(choice(kf))
            if ch == 0:
                jmat[r - 1, p] = r + o + kf
                k = kf
            elif ch == 2:
                k = kf + 1
    return jmat


def fused_merge(keys, w, rowptr, la, lb, lo, kmax, rows, W, stats=None):
    """The whole of kernel E on its inputs: (staged plane, packed words,
    written rows, jmat), each step on its route's schedule."""
    route = cuda_walk.merge_route(W)
    plane = stage_wave(keys, w, rowptr, kmax, rows, W, 32 if route == "warp" else 256)
    words, written = MERGE_DP[route](plane, la, lb, lo, kmax)
    return plane, words, written, merge_walk(words, la, lb, lo, W, stats)


def pair_walk_lanes(dirs, lens_a, lens_b, lo, codes_a, codes_b, stats=None):
    """F's warp walk, a pair at a time, through windows of 64 bytes a row:
    (jmat int32 [rows, P], identity float32 [P]).  A choice of 3 ends the
    row's chain unresolved.  ``stats`` counts window loads and lookups
    that fell outside the window."""
    rows, P, W = dirs.shape
    LA, LB = codes_a.shape[1], codes_b.shape[1]
    wc = min(W, WIN)
    jmat = np.zeros((rows, P), np.int32)
    ident = np.zeros(P, F32)
    stats = {} if stats is None else stats
    for p in range(P):
        a, b, o = int(lens_a[p]), int(lens_b[p]), int(lo[p])
        top = 0 if b <= 0 else min(a, rows)  # lb <= 0: inactive on every row
        k, vstate = (b - a - o if a <= rows else 0), False  # enters at (la, lb) if la is a row
        cnt = np.zeros(32, np.int64)  # each lane's share of the counts
        eq = np.zeros(32, np.int64)
        jpend = np.zeros(32, np.int64)  # j noted at each lane's window row
        wtop, wbase = 0, 0  # wtop 0: no window yet
        win = np.zeros((32, WIN), np.int64)

        def flush():
            for lane in np.flatnonzero(jpend > 0):
                r, j = wtop - lane, int(jpend[lane])
                jmat[r - 1, p] = j
                ai = int(codes_a[p, r - 1]) if r - 1 < LA else 0
                cnt[lane] += 1
                eq[lane] += ai == int(codes_b[p, min(j - 1, LB - 1)])
            jpend[:] = 0

        for r in range(top, 0, -1):
            if r + o + k <= 0:
                break
            c = _clamp(k, W)
            if not 0 <= wtop - r < 32 or not 0 <= c - wbase < wc:
                flush()
                if 0 <= wtop - r < 32:  # the column left the window
                    stats["left"] = stats.get("left", 0) + 1
                wtop, wbase = r, _window_base(c, W, wc)
                for lane in range(32):
                    if r - lane >= 1:
                        win[lane, :wc] = dirs[r - lane - 1, p, wbase : wbase + wc]
                stats["windows"] = stats.get("windows", 0) + 1
            wrow, grow = win[wtop - r], dirs[r - 1, p].astype(np.int64)

            def cell(x, wrow=wrow, grow=grow, wbase=wbase):
                x = np.asarray(x)
                d = x - wbase
                inside = (d >= 0) & (d < wc)
                stats["outside"] = stats.get("outside", 0) + int((~inside).sum())
                return np.where(inside, wrow[np.clip(d, 0, wc - 1)], grow[x])

            if vstate:
                vstate = bool((int(cell(c)) >> 3) & 1)
                k += 1
                continue
            kz, kk, x, died, d, ch = -(r + o), k, c, False, 0, 0
            for _ in range(W + 1):
                d = int(cell(x))
                ch = d & 3
                if ch != 1:
                    break
                kk = _run_end(lambda idx: ((cell(idx) >> 2) & 1) == 0, x) - 1
                if kk <= kz or kk < 0:
                    died = True
                    break
                x = _clamp(kk, W)
            if died:
                break
            if ch == 0:
                jpend[wtop - r] = r + o + kk
            elif ch == 2:
                vstate = bool((d >> 3) & 1)
                kk += 1
            k = kk
        flush()
        ident[p] = F32(eq.sum()) / F32(max(int(cnt.sum()), 1))
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


def _plane_entries(cost, la, kmax, seed, split):
    """Kernel E's inputs for a cost plane: one library entry a live in-band
    cell (row <= la, k <= kmax) of its value, in a shuffled entry order;
    with ``split`` (integer planes) some cells as two entries whose
    in-order sum is exact, plus entries outside the band that the decode
    drops (keyed past every row).  Returns (cols, w, rowptr) as
    ``ops/msa.py::_merge_entries`` gives them."""
    rng = np.random.default_rng(seed)
    Pp, rows, W = cost.shape
    live = (np.arange(1, rows + 1)[None, :, None] <= la[:, None, None]) & (
        np.arange(W)[None, None, :] <= kmax[:, None, None])
    cells = np.flatnonzero(live.reshape(-1))
    vals = cost.reshape(-1)[cells]
    keys, w = [cells], [vals]
    if split:
        two = rng.random(cells.size) < 0.3
        part = (np.floor(vals[two] / 25 * rng.random(int(two.sum()))) * 25).astype(F32)
        w[0] = vals.copy()
        w[0][two] = part
        keys.append(cells[two])
        w.append((vals[two] - part).astype(F32))
    keys.append(np.full(7, Pp * rows * W))  # dropped entries
    w.append(np.ones(7, F32))
    keys, w = np.concatenate(keys), np.concatenate(w).astype(F32)
    order = rng.permutation(keys.size)
    out = port_msa._sorted_entries(torch.as_tensor(keys[order]), torch.as_tensor(w[order]), Pp, rows, W)
    return tuple(x.numpy() for x in out)


@functools.lru_cache(maxsize=None)
def _merge_case(rows, W, seed, float_costs=False):
    """A wave's plane, its entries, the plain version's choices and jmat,
    and JAX's ``_merge_dp_walk`` (float32), computed once.  The plain
    version on the entries (``_merge_entries_plain``) rebuilds the plane
    bit for bit."""
    arrays = _merges(seed, 20, rows, W, float_costs)
    entries = _plane_entries(arrays[0], arrays[1], arrays[4], seed, not float_costs)
    dirs = port_msa._profile_merge_kernel(*_t(*arrays))
    jm = port_msa._merge_walk_kernel(dirs, *_t(*arrays[1:4]))
    np.testing.assert_array_equal(
        port_msa._merge_entries_plain(*_t(*entries, *arrays[1:]), rows, W).numpy(), jm.numpy())
    with jax.enable_x64(False):
        want = np.asarray(jax_msa._merge_dp_walk(*(jnp.asarray(a) for a in arrays)))
    return arrays, entries, dirs.numpy(), jm.numpy(), want


def _check_merge(arrays, entries, d_plain, jm_plain, jm_jax, stats=None):
    """Kernel E's schedule on the entries: the staged live rows equal the
    plane, every choice of every live row and jmat equal the plain version's
    and JAX's; nothing is written past la or emitted by padded merges."""
    cost, la, lb, lo, kmax = arrays
    Pp, rows, W = cost.shape
    plane, words, written, jm = fused_merge(*entries, la, lb, lo, kmax, rows, W, stats)
    choices = unpack(words, W)
    for p in range(la.size):  # every row the walk may read, every cell
        n = min(int(la[p]), rows)
        np.testing.assert_array_equal(plane[p, :n], cost[p, :n], err_msg=str(p))
        np.testing.assert_array_equal(choices[:n, p], d_plain[:n, p], err_msg=str(p))
        assert written[:n, p].all() and not written[n:, p].any(), p  # rows past la: no work
    np.testing.assert_array_equal(jm, jm_plain)
    np.testing.assert_array_equal(jm, jm_jax.astype(np.int32))
    for p in range(la.size):
        assert not jm[la[p]:, p].any(), p  # nothing emitted past la
    assert jm[:, :-4].any() and not jm[:, -4:].any()  # padded merges emit nothing


@pytest.mark.parametrize("rows,W", [(64, 32), (64, 64), (96, 128), (64, 256), (64, 512)])
def test_merge_warp_route_equals_plain_and_jax(rows, W):
    """Staged costs, choices on every live row and jmat, tolerance 0, at
    every warp-route width, with tie-heavy integer costs (some cells two
    entries)."""
    case = _merge_case(rows, W, rows + W)
    assert cuda_walk.merge_route(W) == "warp"
    _check_merge(*case)


@pytest.mark.parametrize("rows,W", [(64, 1024), (96, 1024), (32, 2048), (40, 4096), (16, 8192)])
def test_merge_block_route_equals_plain_and_jax(rows, W):
    """The block route at the widths it takes (256 threads of 4 to 32
    cells, eight warps), with tie-heavy integer costs."""
    case = _merge_case(rows, W, rows + W)
    assert cuda_walk.merge_route(W) == "block"
    _check_merge(*case)


@pytest.mark.parametrize("route,W", [("warp", 256), ("block", 1024), ("wide", 16384)])
def test_merge_routes_with_float_costs(route, W):
    """Non-integer float32 costs: M is one float add, the running max exact."""
    case = _merge_case(64 if route != "wide" else 16, W, 7, float_costs=True)
    assert cuda_walk.merge_route(W) == route
    _check_merge(*case)


def pack_plane(dirs):
    """One choice a cell [rows, P, W] (0-2) as E's packed words."""
    rows, P, W = dirs.shape
    sh = (2 * np.arange(16)).astype(np.uint64)
    cells = dirs.astype(np.uint64).reshape(rows, P, W // 16, 16)
    return (cells << sh).sum(axis=-1, dtype=np.uint64)


def test_merge_walk_on_adversarial_choices():
    """The windowed ballot walk against the plain walk on random choice
    planes (0-2) with long horizontal runs across 32-cell ballots and past
    the window, ``la`` below rows and the first lookup clamped at both
    edges."""
    rng = np.random.default_rng(21)
    rows, P, W = 96, 24, 128
    dirs = np.where(rng.random((rows, P, W)) < 0.85, 1, rng.integers(0, 3, (rows, P, W))).astype(np.int8)
    dirs[:, 2:12] = np.where(rng.random((rows, 10, W)) < 0.97, 0, dirs[:, 2:12])  # long diagonals
    la = rng.integers(1, rows - 5, P).astype(np.int32)
    lb = rng.integers(1, rows - 5, P).astype(np.int32)
    lo = (np.minimum(0, lb - la) - 8).astype(np.int32)
    lo[0] = lb[0] - la[0] - W - 5
    lo[1] = lb[1] - la[1] + 2
    want = port_msa._merge_walk_kernel(*_t(dirs, la, lb, lo)).numpy()
    stats = {}
    got = merge_walk(pack_plane(dirs), la, lb, lo, W, stats)
    np.testing.assert_array_equal(got, want)
    with jax.enable_x64(False):
        np.testing.assert_array_equal(got, np.asarray(jax_msa._merge_walk_kernel(jnp.asarray(dirs), la, lb, lo)))
    assert got.any()
    assert stats["windows"] > P and stats["outside"] > 0  # new windows and reads past them


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


def _check_pair(args, la, stats=None):
    jm, ident = pair_walk_lanes(*args, stats=stats)
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


@pytest.mark.parametrize("mix", ["hops", "drift"])
def test_pair_walk_windows_follow_the_column(mix):
    """F's windows when the column leaves them: horizontal runs that hop
    about 90 cells down past the window's edge (``hops``), or vertical runs
    that move the column up a cell a row for dozens of rows (``drift``),
    with ``la`` below rows; jmat and identities equal to the plain walk +
    identity and to JAX's, tolerance 0, and new windows opened mid-window
    and lookups read past the window on the way."""
    rng = np.random.default_rng(8 if mix == "hops" else 9)
    rows, P, W = 160, 12, 512
    p_rows = [0.6, 0.1, 0.3] if mix == "hops" else [0.35, 0.6, 0.05]
    mode = rng.choice(3, size=(rows, P, 1), p=p_rows)  # diagonal, vertical, horizontal rows
    k = np.arange(W)[None, None, :]
    choice = np.where(mode == 0, 0, np.where(mode == 1, 2, 1))
    choice = np.where((mode == 2) & (k % 90 == 89), 0, choice)  # each hop lands on a diagonal
    choice = np.where(rng.random((rows, P, W)) < 0.05, rng.integers(0, 3, (rows, P, W)), choice)
    hext = np.where(mode == 2, k % 90 != 0, rng.random((rows, P, W)) < 0.5)
    vext = np.where(mode == 1, rng.random((rows, P, W)) < 0.95, rng.random((rows, P, W)) < 0.2)
    dirs = (choice + (hext.astype(np.int64) << 2) + (vext.astype(np.int64) << 3)).astype(np.int8)
    la = (rows - rng.integers(0, 24, P)).astype(np.int32)
    lb = (la + rng.integers(-20, 21, P)).astype(np.int32)
    lo = (lb - la - W // 2 + rng.integers(-40, 41, P)).astype(np.int32)  # start mid-band
    ca = rng.integers(0, 4, (P, rows)).astype(np.int8)
    cb = rng.integers(0, 4, (P, rows + 24)).astype(np.int8)
    stats = {}
    jm, ident = _check_pair((dirs, la, lb, lo, ca, cb), la, stats)
    assert (jm > 0).sum() > P * 20
    assert stats["left"] > 0 and stats["outside"] > 0 and stats["windows"] > P


# --------------------------------------------------------------------------
# Dispatch and the wrappers' checks
# --------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors ``ops/msa.py``'s dispatchers run the plain versions
    (equal to their direct calls) and launch nothing; the kernels' wrappers
    refuse CPU tensors before any launch."""
    arrays, entries, _, jm_plain, _ = _merge_case(64, 64, 128)
    ca, cb, la, lb, lo, km = _pairs(5, 9, 64, 64, 20)
    _, dirs = banded_pair_plain(*_t(ca, cb, la, lb, lo, km), 0.0, -1.0, 5.0, 1.0, 64, 64)
    counts = (cuda_walk.MERGE_KERNEL.launches, cuda_walk.WALK_KERNEL.launches)
    jm = port_msa._merge_dp_walk(*_t(*arrays))
    np.testing.assert_array_equal(jm.numpy(), jm_plain)
    pj, pi = port_msa._pair_walk(dirs, *_t(la, lb, lo, ca, cb))
    want = port_msa._pair_walk_kernel(dirs, *_t(la, lb, lo))
    assert torch.equal(pj, want) and torch.equal(pi, port_msa._pair_ident_kernel(want, *_t(ca, cb)))
    np.testing.assert_array_equal(
        port_msa._merge_entries_plain(*_t(*entries, *arrays[1:]), 64, 64).numpy(), jm_plain)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_walk.merge_dp_walk(*_t(*entries, *arrays[1:]), 64, 64)
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
    keys = torch.zeros(3, dtype=torch.int64)
    w = torch.ones(3, dtype=torch.float32)
    rowptr = torch.zeros(2 * 4 + 1, dtype=torch.int64)
    bands = [torch.zeros(2, dtype=torch.int32)] * 4
    with pytest.raises(ValueError, match=why):
        cuda_walk._launch_merge(keys, w, rowptr, *bands, 4, W)
    assert cuda_walk.MERGE_KERNEL.launches == before


def test_routes_and_resources_keys(monkeypatch):
    """E's warp route up to 512 cells, its shared-memory block route up to
    8 192, its wide route above; resources are asked for F once and for E
    at each width on its own route."""
    assert cuda_walk.MERGE_ROUTES == ("warp", "block", "wide")
    assert (cuda_walk.WARP_MAX_WIDTH, cuda_walk.BLOCK_MAX_WIDTH) == (512, 8192)
    assert [cuda_walk.merge_route(w) for w in (32, 64, 128, 256, 512)] == ["warp"] * 5
    assert [cuda_walk.merge_route(w) for w in (1024, 2048, 4096, 8192)] == ["block"] * 4
    assert [cuda_walk.merge_route(w) for w in (16384, 65536, 131072)] == ["wide"] * 3
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
    assert sorted(res) == ["E:block@1024", "E:warp@256", "E:wide@131072", "F"]
    assert [c for c in calls if c[0] == "sarlacc_merge_attrs"] == [
        ("sarlacc_merge_attrs", (0, 256)), ("sarlacc_merge_attrs", (1, 1024)),
        ("sarlacc_merge_attrs", (2, 131072))]
    assert res["F"]["occupancy"] == 1.0

"""Plain NumPy reference of the quality-aware affine-gap aligner and of
``adaptor_align``'s calls, vectorised over reads.

The semantics are those of the upstream ``src/reference_align.cpp``:
``gap_open`` is stored as ``go + ge``; fitting mode zeroes the first
column and frees vertical gaps in the last; the diagonal wins only when
strictly better than both gaps, the horizontal gap only when strictly
better than the vertical; an extended earlier gap replaces the fresh one
only when strictly better, and directions record run lengths; 2-fold IUPAC
codes always score as mismatches, 3-fold codes and N always as matches.
The backtrack, the query map and the strand rule follow
``reference_align.cpp:231-351`` and ``R/adaptorAlign.R:66-175``.

The DP runs in float32, the precision the configuration states (the
port's and the JAX package's default).  ``rnd`` rounds every arithmetic
result: the control runs with :func:`round_bf16`, bfloat16 after every
operation.
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["score_tables", "iupac", "align_batch", "query_map", "adaptor_calls", "round_bf16",
           "fit_scores", "front_and_back"]

_IUPAC_MODE = {"A": 1, "C": 1, "G": 1, "T": 1, "M": 2, "R": 2, "W": 2, "S": 2, "Y": 2, "K": 2,
               "V": 3, "H": 3, "D": 3, "B": 3, "N": 4}


def round_bf16(x):
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    a = np.asarray(x, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32).reshape(a.shape)


def score_tables(offset: int = 33, nq: int = 94):
    """(match, mismatch) float64 [4, nq]: log2 odds of an observed base with
    Phred error 10^(-q/10) against a reference base of degeneracy 1..4
    (``reference_align.cpp:21-52``)."""
    eps = 10.0 ** (-np.arange(nq, dtype=np.float64) / 10.0)
    n = 4.0
    gamma = (1.0 / np.arange(1, 5, dtype=np.float64))[:, None]
    with np.errstate(divide="ignore"):
        match = np.log2(gamma * (1.0 - eps) * n + (1.0 - gamma) * eps * (n / (n - 1.0)))
        mismatch = np.log2((1.0 - gamma) * (1.0 - eps) * n + gamma * eps * (n / (n - 1.0)))
    return match, mismatch


def iupac(ref: str):
    """(modes int [R], matched bool [R, 6]) with the C++'s IUPAC quirks;
    code 5 (padding) matches nothing."""
    ref = ref.upper()
    modes = np.array([_IUPAC_MODE[c] for c in ref], np.int64)
    matched = np.zeros((len(ref), 6), bool)
    for i, c in enumerate(ref):
        if modes[i] == 1:
            matched[i, "ACGT".index(c)] = True
        elif modes[i] >= 3:
            matched[i, :5] = True
    return modes, matched


#: A finite stand-in for minus infinity that survives further subtraction.
NEG = np.float32(-3.0e38)


def _down(x, fill):
    """Row i takes row i - 1; row 0 takes ``fill``."""
    out = np.empty_like(x)
    out[0] = fill
    out[1:] = x[:-1]
    return out


def align_batch(ref: str, codes, lengths, quals, gap_opening, gap_extension, local=True,
                rnd=None, offset: int = 33):
    """Align every read of ``codes`` [S, L] (int8, pad 5) with ``quals``
    [S, L] (Phred+33) against ``ref`` in float32.  Returns (scores float64
    [S], dirs int16 [R + 1, L + 1, S]): the score at each read's last row
    and the run-length directions the backtrack walks (column 0 all -1).

    Columns are a loop; within a column the vertical gap
    ``V[i] = max(S[i-1] - open, V[i-1] - ext)`` is the running maximum of
    ``(max(M, H) - open) + i * ext`` less ``(i - 1) * ext``: the float32
    association the configuration's scores are defined in."""
    codes = np.asarray(codes)
    nr, L = codes.shape
    f32 = np.float32
    f = (lambda v: v) if rnd is None else rnd
    modes, matched = iupac(ref)
    mt, mmt = score_tables(offset)
    mt, mmt = f(mt.astype(f32)), f(mmt.astype(f32))
    l1 = L + 1
    q = np.where(np.arange(L)[None, :] < np.asarray(lengths)[:, None], quals, offset)
    qk = np.zeros((l1, nr), np.int64)
    qk[1:] = np.minimum(np.asarray(q, np.int64) - offset, mt.shape[1] - 1).T
    ck = np.full((l1, nr), 5, np.int64)
    ck[0] = 0
    ck[1:] = np.clip(codes.astype(np.int64), 0, 5).T
    R = len(ref)
    go = f(f32(f32(gap_opening) + f32(gap_extension)))
    ge = f32(gap_extension)
    zero = f32(0)
    rows = np.arange(l1)[:, None]
    row0 = rows == 0
    rge = f((rows * ge).astype(f32))
    rge1 = f(((rows - 1) * ge).astype(f32))
    if local:
        S = np.zeros((l1, nr), f32)
    else:
        S = np.broadcast_to(np.where(row0, zero, f(-go - rge1)), (l1, nr)).astype(f32)
    H = np.full((l1, nr), NEG, f32)
    was_left = np.zeros((l1, nr), bool)
    ljp = np.zeros((l1, nr), np.int64)
    dirs = np.zeros((R + 1, l1, nr), np.int16)
    dirs[0] = -1
    for j in range(R):
        free = local and j == R - 1  # trailing read bases cost nothing in fitting mode
        vgo, vge = (zero, zero) if free else (go, ge)
        m = modes[j] - 1
        cost = np.where(matched[j][ck], mt[m][qk], mmt[m][qk])
        M = f(_down(S, NEG) + cost)
        cand_h = f(S - np.where(was_left, ge, go))
        jump_h = f(H - ge)
        cond_h = cand_h >= jump_h
        Hn = np.where(cond_h, cand_h, jump_h)
        mv = np.maximum(M, Hn)
        cum = mv if free else f(f(mv - go) + rge)
        V = _down(np.maximum.accumulate(cum, axis=0), NEG)
        if not free:
            V = f(V - rge1)
        Sn = np.where(row0, Hn, np.maximum(mv, V))
        diag = (M > Hn) & (M > V)
        left = ~diag & (Hn > V)
        lstep = np.where(cond_h, 1, 1 + j - ljp)
        ljp = np.where(cond_h, j, ljp)
        up_prev = _down(~(diag | left), False)
        cand_v = f(_down(Sn, NEG) - np.where(up_prev, vge, vgo))
        jump_v = f(_down(V, NEG) - vge)
        cond_v = cand_v >= jump_v
        pnt = np.maximum.accumulate(np.where(cond_v, rows, 0), axis=0)
        ustep = np.where(cond_v, 1, 1 + rows - _down(pnt, 0))
        d = np.where(diag, 0, np.where(left, lstep, -ustep))
        d[0] = 1
        dirs[j + 1] = d
        S, H = Sn, Hn
        was_left = left | row0
    lengths = np.asarray(lengths, np.int64)
    return S[lengths, np.arange(nr)].astype(np.float64), dirs


def _fill_map(dirs, R: int, nrows: int):
    """[(is_match, dp_row)] for reference positions 0..R of one read's
    directions ``dirs`` [R + 1, L + 1] (``reference_align.cpp:231-278``)."""
    mapping = [(False, 0)] * (R + 1)
    col, currow, i = R, nrows - 1, R
    while i > 0:
        while currow > 0:
            d = int(dirs[col, currow])
            if d >= 0:
                break
            while d < 0:
                currow -= 1
                d += 1
        d = int(dirs[col, currow])
        if d == 0:
            mapping[i] = (True, currow)
            currow -= 1
            col -= 1
            i -= 1
        else:
            mapping[i] = (False, currow + 1)
            col -= 1
            d -= 1
            while d > 0:
                i -= 1
                mapping[i] = (False, currow + 1)
                col -= 1
                d -= 1
            i -= 1
    return mapping


def query_map(mapping, nrows: int, ref_start: int, ref_end: int, include_gaps=False):
    """0-based [ref_start, ref_end) -> 0-based query positions
    (``reference_align.cpp:307-351``)."""
    if len(mapping) <= 1:
        return 0, 0
    if not include_gaps:
        s = mapping[ref_start + 1][1]
        is_m, e = mapping[ref_end]
        return s - 1, (e + 1 if is_m else e) - 1
    if ref_start == 0:
        s = 1
    else:
        is_m, s = mapping[ref_start]
        s = s + 1 if is_m else s
    ref_end += 1
    e = nrows if ref_end == len(mapping) else mapping[ref_end][1]
    return s - 1, e - 1


def _sections(ref: str):
    """0-based [start, end) of every ``[^ACTG]+`` stretch (``R/adaptorAlign.R:136-143``)."""
    return [(m.start(), m.end()) for m in re.finditer("[^ACTG]+", ref.upper())]


def front_and_back(codes, lengths, quals, tolerance: int):
    """The first ``tolerance`` bases, and the reverse complement of the last
    ``tolerance`` (qualities reversed), each clipped to the read
    (``R/adaptorAlign.R:86-95``)."""
    codes = np.asarray(codes)
    S = codes.shape[0]
    lengths = np.asarray(lengths, np.int64)
    tol = np.minimum(tolerance, lengths)
    w = int(tol.max(initial=1))
    j = np.arange(w)[None, :]
    valid = j < tol[:, None]
    fi = np.where(valid, j, 0)
    front = np.where(valid, np.take_along_axis(codes, fi, 1), 5).astype(np.int8)
    fq = np.where(valid, np.take_along_axis(quals, fi, 1), 0).astype(np.uint8)
    bi = np.where(valid, lengths[:, None] - 1 - j, 0)
    bc = np.take_along_axis(codes, bi, 1)
    back = np.where(valid, np.where(bc < 4, 3 - bc, bc), 5).astype(np.int8)
    bq = np.where(valid, np.take_along_axis(quals, bi, 1), 0).astype(np.uint8)
    return (front, tol, fq), (back, tol.copy(), bq)


def _fit(ref, batch, go, ge, rnd):
    """Scores, spans and section windows of ``ref`` fitted to ``batch``."""
    codes, lengths, quals = batch
    scores, dirs = align_batch(ref, codes, lengths, quals, go, ge, True, rnd)
    R = len(ref)
    secs = _sections(ref)
    out = []
    for s in range(codes.shape[0]):
        nrows = int(lengths[s]) + 1
        mp = _fill_map(dirs[:, :, s], R, nrows)
        s0, e0 = query_map(mp, nrows, 0, R)
        span = (s0 + 1, e0) if s0 < e0 else (0, 0)
        subs = []
        for a, b in secs:
            cs, ce = query_map(mp, nrows, a, b, include_gaps=True)
            subs.append(bytes(np.where(codes[s, cs:ce] < 4, codes[s, cs:ce], 4).astype(np.int64)))
        out.append((span, subs))
    return scores, out


def _stack(a, b):
    w = max(a[0].shape[1], b[0].shape[1])

    def pad(x, fill):
        return np.pad(x, ((0, 0), (0, w - x.shape[1])), constant_values=fill)

    return (np.concatenate([pad(a[0], 5), pad(b[0], 5)]), np.concatenate([a[1], b[1]]),
            np.concatenate([pad(a[2], 0), pad(b[2], 0)]))


def adaptor_calls(adaptor1: str, adaptor2: str, codes, lengths, quals, tolerance=250,
                  go=5.0, ge=1.0, rnd=None):
    """``adaptor_align``'s answer for each read, worked out again: a dict of
    ``reversed`` [S], ``score1``/``score2`` [S], and a list of ``calls``:
    (reversed, (start1, end1), (start2, end2), section bytes of adaptor1)
    with adaptor2's span on the forward strand."""
    front, back = front_and_back(codes, lengths, quals, tolerance)
    S = len(lengths)
    s1, f1 = _fit(adaptor1, _stack(front, back), go, ge, rnd)
    s2, f2 = _fit(adaptor2, _stack(back, front), go, ge, rnd)
    start, rstart, end, rend = s1[:S], s1[S:], s2[:S], s2[S:]
    fscore = np.maximum(start, 0) + np.maximum(end, 0)
    rscore = np.maximum(rstart, 0) + np.maximum(rend, 0)
    rev = fscore < rscore
    calls = []
    width = np.asarray(lengths, np.int64)
    for s in range(S):
        a1 = f1[S + s] if rev[s] else f1[s]
        a2 = f2[S + s] if rev[s] else f2[s]
        (st2, en2) = a2[0]
        calls.append((bool(rev[s]), a1[0], (int(width[s] - st2 + 1), int(width[s] - en2 + 1)),
                      tuple(a1[1])))
    return {"reversed": rev, "score1": np.where(rev, rstart, start),
            "score2": np.where(rev, rend, end), "calls": calls}


def fit_scores(ref: str, codes, lengths, quals, go, ge, local=True, rnd=None):
    """Scores only (kernels C and D's answer)."""
    return align_batch(ref, codes, lengths, quals, go, ge, local, rnd)[0]

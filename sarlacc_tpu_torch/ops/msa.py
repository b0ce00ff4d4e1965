"""Device steps of the multiple-sequence-alignment subsystem (PyTorch).

Counterpart of ``sarlacc_tpu/ops/msa.py`` for the host-library path:

* :func:`banded_pair_align` — the pairwise library workload: read pairs
  bucketed by (rows, band width), kernel B per bucket chunk
  (:func:`..ops.cuda_msa.banded_pair`), then the Gotoh walk
  (:func:`_pair_walk_kernel`) on the device; only the per-row matched
  positions come back.
* :func:`merge_wave_from_library` — one wave of progressive profile merges:
  blank banded cost planes (:func:`_merge_cost_init`), the library weights
  added in through the position->column maps (:func:`_merge_accum_kernel`),
  the gapless max-weight-trace DP (:func:`_profile_merge_kernel`) and its
  walk (:func:`_merge_walk_kernel`).

The walks, the merge DP and the accumulation are plain PyTorch on the
device: one small launch per row or step.  The JAX package's scans become
Python loops here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import memory_budget
from .cuda_msa import NEG, banded_pair

__all__ = [
    "banded_pair_align",
    "band_halfwidth",
    "merge_wave_from_library",
    "MERGE_ENTRY_CHUNK",
]


def band_halfwidth(la: int, lb: int, bandwidth: int) -> tuple[int, int]:
    """(lo, hi) diagonal offsets guaranteeing corner-to-corner feasibility."""
    diff = lb - la
    return (min(0, diff) - bandwidth, max(0, diff) + bandwidth)


def _bkt(x: int, base: int) -> int:
    b = base
    while b < x:
        b *= 2
    return b


def _gather_k(mat: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """mat [P, W] at column k [P] (clipped into the band plane)."""
    W = mat.shape[1]
    return mat.gather(1, k.clamp(0, W - 1)[:, None])[:, 0]


def _pair_walk_kernel(dirs, lens_a, lens_b, lo):
    """Gotoh walk over [rows, P, W] direction bits, one DP row per step.

    The walker sits at row ``r`` at step ``r`` because every row exit (diag
    or vert) decrements the row by one; horizontal runs resolve within the
    row through ``pz_h`` (the last cell at or below k whose extend bit is 0),
    one hop per run.  Returns jmat int32 [rows, P]: for DP row i (stored at
    i-1) the matched B-position j if the path aligned (i, j), else 0.
    """
    rows, P, W = dirs.shape
    dev = dirs.device
    lens_a = lens_a.to(torch.int64)
    lens_b = lens_b.to(torch.int64)
    lo = lo.to(torch.int64)
    karr = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    k0 = lens_b - lens_a - lo  # band coordinate at (la, lb)

    k = torch.zeros(P, dtype=torch.int64, device=dev)
    st = torch.zeros(P, dtype=torch.int64, device=dev)  # 0 = S, 2 = V
    dead = torch.zeros(P, dtype=torch.bool, device=dev)
    jmat = torch.zeros((rows, P), dtype=torch.int32, device=dev)
    for r in range(rows, 0, -1):
        d_row = dirs[r - 1].to(torch.int64)
        kz = -(r + lo)  # band coordinate where j == 0 on this row

        start = lens_a == r
        k = torch.where(start, k0, k)
        st = torch.where(start, 0, st)
        j_in = r + lo + k
        act = (r <= lens_a) & ~dead & (j_in > 0) & (lens_b > 0)

        hext = (d_row >> 2) & 1
        pz_h = torch.cummax(torch.where(hext == 0, karr, -1), dim=1).values
        # One packed plane: bits 0-1 choice, bit 2 vext, bits 3+ pz_h + 1.
        pack = (d_row & 3) | (((d_row >> 3) & 1) << 2) | ((pz_h + 1) << 3)

        # V-state pairs: exactly one vertical move this row.
        is_v = act & (st == 2)
        v_vext = (_gather_k(pack, k) >> 2) & 1

        # S-state pairs: resolve the within-row choice / H-run chain.
        is_s = act & (st == 0)
        unresolved = is_s
        kk = k
        exit_diag = torch.zeros_like(is_s)
        exit_vert = torch.zeros_like(is_s)
        died = torch.zeros_like(is_s)
        pk_s = torch.zeros_like(k)
        while True:
            for _ in range(2):  # hops per host check; extra hops are no-ops
                pk = _gather_k(pack, kk)
                ch = pk & 3
                dg = unresolved & (ch == 0)
                vt = unresolved & (ch == 2)
                hz = unresolved & (ch == 1)
                knew = torch.where(hz, (pk >> 3) - 2, kk)
                dd = hz & ((knew <= kz) | (knew < 0))
                pk_s = torch.where(unresolved, pk, pk_s)
                exit_diag |= dg
                exit_vert |= vt
                died |= dd
                unresolved = unresolved & ~dg & ~vt & ~dd
                kk = knew
            if not bool(unresolved.any()):
                break

        jmat[r - 1] = torch.where(exit_diag, r + lo + kk, 0).to(torch.int32)
        s_vext = (pk_s >> 2) & 1
        k_after_s = torch.where(exit_vert, kk + 1, kk)
        st_after_s = torch.where(exit_vert & (s_vext == 1), 2, 0)
        k = torch.where(is_v, k + 1, torch.where(is_s, k_after_s, k))
        st = torch.where(
            is_v, torch.where(v_vext == 1, 2, 0), torch.where(is_s, st_after_s, st)
        )
        dead = dead | died
    return jmat


def _compact_jmat(jmat: np.ndarray, n: int) -> list:
    """[(ai, bi)] matched-position pairs (ascending) from a walk's jmat."""
    out = []
    for q in range(n):
        col = jmat[:, q]
        rr = np.flatnonzero(col)
        out.append(((rr + 1).astype(np.int32), col[rr].astype(np.int32)))
    return out


def _pair_chunk(rows_b: int, W_b: int, budget: int) -> int:
    """Max pairs per kernel-B launch so its [rows, P, W] int8 directions
    stay under ``budget`` bytes (a power of two, at least 128)."""
    p = budget // max(rows_b * W_b, 1)
    c = 128
    while c * 2 <= p:
        c *= 2
    return c


def _run_pair_bucket(
    codes_a, lens_a, codes_b, lens_b, lo, hi,
    match, mismatch, gap_open, gap_ext, rows_b, W_b, device,
):
    """One shape-bucketed launch: kernel B + the device walk.

    Code rows pad with 5 to the bucket widths (A exactly to ``rows_b``).
    Returns (scores f32 [P], jmat int32 [rows_b, P]) on ``device``.
    """
    P = codes_a.shape[0]
    lb_b = _bkt(max(int(lens_b.max()), 1), 64)

    def _pad2(a, w):
        out = np.full((P, w), 5, np.int8)
        out[:, : min(a.shape[1], w)] = a[:, :w]
        return torch.as_tensor(out, device=device)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    lens_a_d, lens_b_d, lo_d = dev(lens_a), dev(lens_b), dev(lo)
    scores, dirs = banded_pair(
        _pad2(np.asarray(codes_a), rows_b), _pad2(np.asarray(codes_b), lb_b),
        lens_a_d, lens_b_d, lo_d, dev(np.asarray(hi) - np.asarray(lo)),
        match, mismatch, gap_open, gap_ext, rows_b, W_b,
    )
    jmat = _pair_walk_kernel(dirs, lens_a_d, lens_b_d, lo_d)
    return scores, jmat


def banded_pair_align(
    codes_a: np.ndarray,
    lens_a: np.ndarray,
    codes_b: np.ndarray,
    lens_b: np.ndarray,
    match: float,
    mismatch: float,
    gap_open: float,
    gap_ext: float,
    bandwidth: int,
    device=None,
):
    """Batch of banded global pairwise alignments on ``device`` (default CPU).

    Pairs are partitioned into (rows, band-width) shape classes so that one
    ragged batch doesn't inflate everyone's DP to the worst case; each class
    is chunked by memory.  Returns (scores [P] float64, paths: list of
    (ai, bi) matched-position arrays, 1-based).
    """
    device = torch.device("cpu" if device is None else device)
    P = codes_a.shape[0]
    lens_a = np.asarray(lens_a, np.int32)
    lens_b = np.asarray(lens_b, np.int32)
    if P == 0:
        return np.zeros(0), []
    diffs = lens_b.astype(np.int64) - lens_a.astype(np.int64)
    lo = (np.minimum(0, diffs) - bandwidth).astype(np.int32)
    hi = (np.maximum(0, diffs) + bandwidth).astype(np.int32)

    def _bkt_arr(x, base):
        out = np.full_like(x, base)
        while True:
            small = out < x
            if not small.any():
                return out
            out[small] *= 2

    rows_c = _bkt_arr(np.maximum(lens_a.astype(np.int64), 1), 64)
    W_c = _bkt_arr((hi - lo + 1).astype(np.int64), 64)

    # Direction bytes per launch: 1/8 of the card's free memory (the walk's
    # per-row temporaries are small beside them), 1 GiB on the CPU.
    budget = memory_budget(device, 1 / 8, 1 << 30)
    scores = np.zeros(P, np.float64)
    paths: list = [None] * P
    pending = []
    for key in sorted(set(zip(rows_c.tolist(), W_c.tolist()))):
        idx = np.flatnonzero((rows_c == key[0]) & (W_c == key[1]))
        step = _pair_chunk(int(key[0]), int(key[1]), budget)
        for c0 in range(0, idx.size, step):
            sub = idx[c0 : c0 + step]
            sc, jmat = _run_pair_bucket(
                codes_a[sub], lens_a[sub], codes_b[sub], lens_b[sub],
                lo[sub], hi[sub], match, mismatch, gap_open, gap_ext,
                int(key[0]), int(key[1]), device,
            )
            pending.append((sub, sc, jmat))
    for sub, sc, jmat in pending:
        scores[sub] = sc.cpu().numpy().astype(np.float64)[: sub.size]
        pt = _compact_jmat(jmat.cpu().numpy(), sub.size)
        for k, i in enumerate(sub):
            paths[i] = pt[k]
    return scores, paths


def _profile_merge_kernel(cost, lens_a, lens_b, lo, kmax):
    """Gapless maximal-weighted-trace DP over banded column-score planes.

    cost: [P, rows, W] f32 — cost[p, i-1, k] is the column score of aligning
    profile-A column i with profile-B column j = i + lo + k.  Returns dirs
    int8 [rows, P, W]: 0 diag, 1 horiz, 2 vert.
    """
    P, rows, W = cost.shape
    dev = cost.device
    karr = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    lo_c = lo.to(torch.int64)[:, None]
    lb_c = lens_b.to(torch.int64)[:, None]
    in_band = karr <= kmax.to(torch.int64)[:, None]
    S = torch.where((lo_c + karr >= 0) & in_band, 0.0, NEG).to(torch.float32)
    dirs = torch.empty((rows, P, W), dtype=torch.int8, device=dev)
    neg_col = torch.full((P, 1), NEG, dtype=torch.float32, device=dev)
    for i in range(1, rows + 1):
        j = i + lo_c + karr
        valid = (j >= 0) & (j <= lb_c) & in_band
        alive = (i <= lens_a)[:, None]
        M = S + torch.where((j >= 1) & (j <= lb_c), cost[:, i - 1], NEG)
        S_up = torch.cat([S[:, 1:], neg_col], dim=1)  # vertical
        # Horizontal closes the row: running max along k.
        Sn = torch.cummax(torch.maximum(M, S_up), dim=1).values
        Sn = torch.where(valid, Sn, NEG)
        dirs[i - 1] = torch.where(
            M >= Sn, 0, torch.where(S_up >= Sn, 2, 1)
        ).to(torch.int8)
        S = torch.where(alive, Sn, S)
    return dirs


def _merge_walk_kernel(dirs, lens_a, lens_b, lo):
    """Walk of the merge choices (0 diag, 1 horiz, 2 vert), one row per step.

    A horizontal run is the consecutive ``choice == 1`` cells below the
    entry column and ends on the first non-horizontal cell, which exits the
    row.  Returns jmat int32 [rows, P] (see :func:`_pair_walk_kernel`).
    """
    rows, P, W = dirs.shape
    dev = dirs.device
    lens_a = lens_a.to(torch.int64)
    lens_b = lens_b.to(torch.int64)
    lo = lo.to(torch.int64)
    karr = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    k0 = lens_b - lens_a - lo
    k = torch.zeros(P, dtype=torch.int64, device=dev)
    dead = torch.zeros(P, dtype=torch.bool, device=dev)
    jmat = torch.zeros((rows, P), dtype=torch.int32, device=dev)
    for r in range(rows, 0, -1):
        d_row = dirs[r - 1].to(torch.int64)
        kz = -(r + lo)
        k = torch.where(lens_a == r, k0, k)
        j_in = r + lo + k
        act = (r <= lens_a) & ~dead & (j_in > 0) & (lens_b > 0)

        # First k' <= k with choice != 1: where the horizontal run ends.
        pz = torch.cummax(torch.where(d_row != 1, karr, -1), dim=1).values
        kf = _gather_k(pz, k)
        died = act & ((kf <= kz) | (kf < 0))
        ok = act & ~died
        ch = _gather_k(d_row, kf)
        dg = ok & (ch == 0)
        vt = ok & (ch == 2)
        jmat[r - 1] = torch.where(dg, r + lo + kf, 0).to(torch.int32)
        k = torch.where(dg, kf, torch.where(vt, kf + 1, k))
        dead = dead | died
    return jmat


def _merge_cost_init(la, kmax, rows: int, width: int):
    """NEG outside the band/live rows, 0 inside — the DP's blank planes."""
    dev = la.device
    karr = torch.arange(width, dtype=torch.int64, device=dev)
    in_band = karr[None, None, :] <= kmax.to(torch.int64)[:, None, None]
    live_rows = (
        torch.arange(1, rows + 1, dtype=torch.int64, device=dev)[None, :, None]
        <= la.to(torch.int64)[:, None, None]
    )
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return torch.where(in_band & live_rows, zero, NEG).to(torch.float32)


def _ordered_add_(flat: torch.Tensor, target: torch.Tensor, w: torch.Tensor) -> None:
    """``flat[target] += w`` with duplicates summed in entry order.

    A float scatter-add through atomics adds duplicates in a varying order,
    which moves last bits and can flip merge ties.  Here a stable sort by
    target gives each entry its rank among the entries of its target, and
    one plain indexed add per rank applies them in entry order: the same
    sequence of float additions on every device.
    """
    if target.numel() == 0:
        return
    tgt, perm = torch.sort(target, stable=True)
    w = w[perm]
    n = tgt.numel()
    pos = torch.arange(n, device=tgt.device)
    new_run = torch.ones(n, dtype=torch.bool, device=tgt.device)
    new_run[1:] = tgt[1:] != tgt[:-1]
    run_start = torch.cummax(torch.where(new_run, pos, 0), dim=0).values
    rank = pos - run_start
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        idx = tgt[sel]
        flat[idx] = flat[idx] + w[sel]


def _merge_accum_kernel(lib_tab, w_inv, cost, seg, p2ca, p2cb, e0: int, e1: int):
    """Add library entries [e0, e1) of this wave into its cost planes.

    ``seg`` holds per-segment int64 tensors: ``bound`` (first entry of each
    segment in the wave's entry order), ``start`` (its first library row),
    ``m`` (its merge), ``aoff``/``boff`` (its members' offsets into the flat
    position->column maps), ``swap``, ``lo`` and ``kmax`` (its merge's band).
    Entry ``e`` of segment s reads library row ``start[s] + e - bound[s]``
    and lands at ``cost[m, ci - 1, cj - ci - lo]``.
    """
    P, rows, width = cost.shape
    dev = cost.device
    e = torch.arange(e0, e1, dtype=torch.int64, device=dev)
    s = torch.searchsorted(seg["bound"], e, right=True) - 1
    t = seg["start"][s] + (e - seg["bound"][s])
    lr = lib_tab[t]
    pa_raw, pb_raw, wq = lr[:, 0], lr[:, 1], lr[:, 2]
    sw = seg["swap"][s] == 1
    pa_e = torch.where(sw, pb_raw, pa_raw)  # position on the A-side member
    pb_e = torch.where(sw, pa_raw, pb_raw)
    w_e = wq.to(torch.float32) * w_inv
    ci = p2ca[(seg["aoff"][s] + pa_e).clamp(0, p2ca.shape[0] - 1)].to(torch.int64)
    cj = p2cb[(seg["boff"][s] + pb_e).clamp(0, p2cb.shape[0] - 1)].to(torch.int64)
    m = seg["m"][s]
    k = cj - ci - seg["lo"][s]
    ok = (
        (ci >= 1) & (cj >= 1) & (k >= 0) & (k <= seg["kmax"][s])
        & (k < width) & (ci <= rows)
    )
    target = (m * rows + (ci - 1)) * width + k
    _ordered_add_(cost.view(-1), target[ok], w_e[ok])


#: Library entries per accumulation step: bounds the per-entry temporaries.
MERGE_ENTRY_CHUNK = 1 << 21


def merge_wave_from_library(lib_dev, merges_desc, rows_b, W_b):
    """Run one shape-class wave of profile merges against the device library.

    ``lib_dev`` = (int32 [T, 3] device table of (pa, pb, quantized w),
    float32 dequantization factor).  ``merges_desc`` is a list of dicts with
    keys ``la, lb, lo, kmax, segments, p2ca, p2cb`` where ``segments`` lists
    (start, length, aoff, boff, swap) tuples into the library and the
    merge-local column maps.  Returns the device jmat int32 [rows_b, Pp]
    (column m is merge m).
    """
    P = len(merges_desc)
    if P == 0:
        return None
    lib_tab, w_inv = lib_dev
    dev = lib_tab.device
    Pp = _bkt(P, 16)
    la = np.zeros(Pp, np.int64)
    lb = np.zeros(Pp, np.int64)
    lo = np.zeros(Pp, np.int64)
    kmax = np.zeros(Pp, np.int64)
    cols = {k: [] for k in ("bound", "start", "m", "aoff", "boff", "swap", "lo", "kmax")}
    p2ca_parts, p2cb_parts = [], []
    aoff_global = boff_global = 0
    at = 0
    for m, d in enumerate(merges_desc):
        la[m], lb[m], lo[m], kmax[m] = d["la"], d["lb"], d["lo"], d["kmax"]
        for (start, length, aoff, boff, swap) in d["segments"]:
            for key, v in (
                ("bound", at), ("start", start), ("m", m),
                ("aoff", aoff_global + aoff), ("boff", boff_global + boff),
                ("swap", swap), ("lo", d["lo"]), ("kmax", d["kmax"]),
            ):
                cols[key].append(v)
            at += length
        p2ca_parts.append(d["p2ca"])
        p2cb_parts.append(d["p2cb"])
        aoff_global += d["p2ca"].size
        boff_global += d["p2cb"].size
    total = at

    def _t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    seg = {k: _t(v) for k, v in cols.items()}
    # A trailing 0 ("unmapped") catches any out-of-range lookup.
    p2ca = _t(np.concatenate(p2ca_parts + [np.zeros(1, np.int32)]), torch.int32)
    p2cb = _t(np.concatenate(p2cb_parts + [np.zeros(1, np.int32)]), torch.int32)
    la_d, lb_d, lo_d, km_d = _t(la), _t(lb), _t(lo), _t(kmax)

    cost = _merge_cost_init(la_d, km_d, rows_b, W_b)
    w_inv_t = torch.tensor(np.float32(w_inv), dtype=torch.float32, device=dev)
    for c0 in range(0, total, MERGE_ENTRY_CHUNK):
        _merge_accum_kernel(
            lib_tab, w_inv_t, cost, seg, p2ca, p2cb,
            c0, min(c0 + MERGE_ENTRY_CHUNK, total),
        )
    dirs = _profile_merge_kernel(cost, la_d, lb_d, lo_d, km_d)
    del cost
    return _merge_walk_kernel(dirs, la_d, lb_d, lo_d)

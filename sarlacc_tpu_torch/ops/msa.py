"""Device steps of the multiple-sequence-alignment subsystem (PyTorch).

Counterpart of ``sarlacc_tpu/ops/msa.py``:

* :func:`banded_pair_align` — the pairwise library workload of the
  host-library route: read pairs bucketed by (rows, band width), kernel B
  per bucket chunk (:func:`..ops.cuda_msa.banded_pair`), then the Gotoh
  walk (:func:`_pair_walk`) on the device; only the per-row matched
  positions come back.
* :func:`pair_maps_device`, :func:`_extend_library` — the device
  library (the JAX package's default route): the same launches, but each
  walk's matched positions stay on the device as forward and reverse
  position maps (:func:`_arena_place_kernel`) beside a float32 identity per
  pair (computed by the same walk), and the consistency extension composes
  those maps into the packed entry table: kernel H (:mod:`.cuda_extend`,
  which derives each pair's slots from per-job tables on chip) on CUDA
  tensors, the slot tables by torch ops (:func:`_slot_tables`) and gathers
  and small sorts (:func:`_extend_chunk_plain`) on CPU ones.
* :func:`merge_wave_from_library` — one wave of progressive profile merges:
  the library entries decoded through the position->column maps
  (:func:`_merge_entry_targets`), then on CUDA tensors kernel E on them
  sorted by cell (:func:`_merge_entries`, :func:`_sorted_entries`), which
  builds each live row's costs on chip and runs the gapless
  max-weight-trace DP and its walk; on CPU tensors blank banded cost
  planes (:func:`_merge_cost_init`), the weights added in
  (:func:`_merge_accum_kernel`), then the DP and walk
  (:func:`_merge_dp_walk`).

The pair walk with its identities and the merge wave are hand-written
kernels on CUDA tensors (F and E, :mod:`.cuda_walk`); on CPU tensors they
run their plain versions, :func:`_pair_walk_kernel` +
:func:`_pair_ident_kernel` and the cost planes +
:func:`_profile_merge_kernel` + :func:`_merge_walk_kernel`, which are
Python loops over the DP rows, as the JAX package's scans are (:func:`_merge_entries_plain` is E's plain
version on E's own inputs).  The entry decode and sort and the arena
placement are plain PyTorch on the device.

Under an active mesh (:mod:`..parallel.context`) each kernel-B launch's
pairs split over the shards: kernel B, the walk and the identities run on
each shard's device, and the jmat and identities gather back to the
primary device in pair order.  Segments, merge waves and the host
orchestration are unchanged, so the results equal the solo run's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import memory_budget, resolve_device
from ..parallel.context import active_mesh, shard_bounds
from ..utils.profiling import StageStats, get_profiler
from . import cuda_extend, cuda_walk
from .cuda_msa import NEG, banded_pair

__all__ = [
    "banded_pair_align",
    "band_halfwidth",
    "merge_wave_from_library",
    "pair_maps_device",
    "ARENA_ZERO_ROW",
    "ARENA_IDENT_ROW",
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
    stay under ``budget`` bytes: a power of two, down to one pair a launch
    for the widest bands.  Raises when one pair's directions alone exceed
    the budget."""
    p = budget // max(rows_b * W_b, 1)
    if p < 1:
        raise MemoryError(
            f"one pair's kernel-B directions ({rows_b} rows x band {W_b} = "
            f"{rows_b * W_b / 2**30:.2f} GiB) exceed the {budget / 2**30:.2f} GiB "
            f"budget; use a narrower bandwidth or shorter reads"
        )
    c = 1
    while c * 2 <= p:
        c *= 2
    return c


def _run_pair_bucket(
    codes_a, lens_a, codes_b, lens_b, lo, hi,
    match, mismatch, gap_open, gap_ext, rows_b, W_b, device,
):
    """One shape-bucketed launch: kernel B, the device walk and the pairs'
    identities, on ``device``, or under an active mesh on each shard's
    device for its share of the pairs.

    Returns (scores f32 [P], jmat int32 [rows_b, P], ident f32 [P]) on
    ``device``, pairs in order.
    """
    mesh = active_mesh()
    if mesh is None:
        return _pair_bucket_on(
            codes_a, lens_a, codes_b, lens_b, lo, hi,
            match, mismatch, gap_open, gap_ext, rows_b, W_b, device,
        )
    parts = [
        _pair_bucket_on(
            codes_a[p0:p1], lens_a[p0:p1], codes_b[p0:p1], lens_b[p0:p1], lo[p0:p1],
            hi[p0:p1], match, mismatch, gap_open, gap_ext, rows_b, W_b, shard,
        )
        for (p0, p1), shard in zip(shard_bounds(codes_a.shape[0], mesh.size), mesh.devices)
        if p1 > p0
    ]
    scores, jmat, ident = zip(*parts)
    return (
        torch.cat([x.to(device) for x in scores]),
        torch.cat([x.to(device) for x in jmat], dim=1),
        torch.cat([x.to(device) for x in ident]),
    )


def _pair_bucket_on(
    codes_a, lens_a, codes_b, lens_b, lo, hi,
    match, mismatch, gap_open, gap_ext, rows_b, W_b, device,
):
    """:func:`_run_pair_bucket` on one device.

    Code rows pad with 5 to the bucket widths (A exactly to ``rows_b``).
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
    ca, cb = _pad2(np.asarray(codes_a), rows_b), _pad2(np.asarray(codes_b), lb_b)
    scores, dirs = banded_pair(
        ca, cb, lens_a_d, lens_b_d, lo_d, dev(np.asarray(hi) - np.asarray(lo)),
        match, mismatch, gap_open, gap_ext, rows_b, W_b,
    )
    jmat, ident = _pair_walk(dirs, lens_a_d, lens_b_d, lo_d, ca, cb)
    del dirs
    return scores, jmat, ident


def _pair_walk(dirs, lens_a, lens_b, lo, codes_a, codes_b):
    """(jmat int32 [rows, P], identity float32 [P]) of one kernel-B launch:
    kernel F (:func:`.cuda_walk.pair_walk`) on CUDA tensors,
    :func:`_pair_walk_kernel` then :func:`_pair_ident_kernel` on CPU ones."""
    if dirs.is_cuda:
        return cuda_walk.pair_walk(dirs, lens_a, lens_b, lo, codes_a, codes_b)
    jmat = _pair_walk_kernel(dirs, lens_a, lens_b, lo)
    return jmat, _pair_ident_kernel(jmat, codes_a, codes_b)


def _pair_ident_kernel(jmat, codes_a, codes_b):
    """Fractional identity per pair from the walk's jmat, on the device.

    jmat [rows, P] (row r-1 = matched B-position of A-position r, 0 =
    none); codes_* [P, L].  frac = (#matched positions with equal bases) /
    max(#matched, 1), divided in float32 as the JAX package's default route
    divides it.
    """
    rows, P = jmat.shape
    jm = jmat.t().to(torch.int64)  # [P, rows]
    matched = jm > 0
    take = min(rows, codes_a.shape[1])
    ca = torch.zeros((P, rows), dtype=torch.int64, device=jm.device)
    ca[:, :take] = codes_a[:, :take]
    lb = codes_b.shape[1]
    cb = codes_b.to(torch.int64).gather(1, (jm - 1).clamp(0, lb - 1))
    eq = matched & (ca == cb)
    cnt = matched.sum(dim=1)
    return eq.sum(dim=1).to(torch.float32) / cnt.clamp(min=1).to(torch.float32)


def _bkt_arr(x, base):
    out = np.full_like(x, base)
    while True:
        small = out < x
        if not small.any():
            return out
        out[small] *= 2


def _pair_buckets(lens_a, lens_b, bandwidth):
    """Per pair: band (lo, hi) and its (rows, band width) launch bucket.
    Counts the pairs and DP cells on the ``msa.pair_library`` stage."""
    diffs = lens_b.astype(np.int64) - lens_a.astype(np.int64)
    lo = (np.minimum(0, diffs) - bandwidth).astype(np.int32)
    hi = (np.maximum(0, diffs) + bandwidth).astype(np.int32)
    rows_c = _bkt_arr(np.maximum(lens_a.astype(np.int64), 1), 64)
    W_c = _bkt_arr((hi - lo + 1).astype(np.int64), 64)
    dpstat = get_profiler().stages.setdefault("msa.pair_library", StageStats())
    dpstat.items += lens_a.size
    dpstat.cells += int((rows_c * W_c).sum())
    return lo, hi, rows_c, W_c


def _pair_launches(rows_c, W_c, device):
    """(rows, W, pair indices) of each kernel-B launch: one per shape
    bucket, chunked so a launch's int8 directions stay within 1/8 of the
    card's free memory (1 GiB on the CPU)."""
    budget = memory_budget(device, 1 / 8, 1 << 30, "pair_dirs")
    for key in sorted(set(zip(rows_c.tolist(), W_c.tolist()))):
        idx = np.flatnonzero((rows_c == key[0]) & (W_c == key[1]))
        step = _pair_chunk(int(key[0]), int(key[1]), budget)
        for c0 in range(0, idx.size, step):
            yield int(key[0]), int(key[1]), idx[c0 : c0 + step]


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
    """Batch of banded global pairwise alignments on ``device`` (``None``
    means CUDA).

    Pairs are partitioned into (rows, band-width) shape classes so that one
    ragged batch doesn't inflate everyone's DP to the worst case; each class
    is chunked by memory.  Returns (scores [P] float64, paths: list of
    (ai, bi) matched-position arrays, 1-based).
    """
    device = resolve_device(device)
    P = codes_a.shape[0]
    lens_a = np.asarray(lens_a, np.int32)
    lens_b = np.asarray(lens_b, np.int32)
    if P == 0:
        return np.zeros(0), []
    lo, hi, rows_c, W_c = _pair_buckets(lens_a, lens_b, bandwidth)

    scores = np.zeros(P, np.float64)
    paths: list = [None] * P
    pending = []
    for rows_b, W_b, sub in _pair_launches(rows_c, W_c, device):
        sc, jmat, _ = _run_pair_bucket(
            codes_a[sub], lens_a[sub], codes_b[sub], lens_b[sub],
            lo[sub], hi[sub], match, mismatch, gap_open, gap_ext,
            rows_b, W_b, device,
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


def _merge_dp_walk(cost, la, lb, lo, kmax):
    """jmat int32 [rows, P] of one merge wave's finished cost planes:
    :func:`_profile_merge_kernel` then :func:`_merge_walk_kernel`, the plain
    DP and walk (kernel E builds its costs from the library entries
    instead, :func:`merge_wave_from_library`).  ``la``, ``lb``, ``lo``,
    ``kmax`` int32 [P]."""
    return _merge_walk_kernel(_profile_merge_kernel(cost, la, lb, lo, kmax), la, lb, lo)


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


def _merge_entry_targets(lib_tab, w_inv, seg, p2ca, p2cb, e0: int, e1: int, rows: int, width: int):
    """Library entries [e0, e1) of a wave as cells of its [P, rows, width]
    cost planes: (flat cell int64, weight float32, kept bool), one each.

    ``seg`` holds per-segment int64 tensors: ``bound`` (first entry of each
    segment in the wave's entry order), ``start`` (its first library row),
    ``m`` (its merge), ``aoff``/``boff`` (its members' offsets into the flat
    position->column maps), ``swap``, ``lo`` and ``kmax`` (its merge's band).
    Entry ``e`` of segment s reads library row ``start[s] + e - bound[s]``
    and lands at ``cost[m, ci - 1, cj - ci - lo]``, flat cell
    ``(m * rows + ci - 1) * width + k`` (int64: a wave can span 2^31
    cells); an entry outside the band or the rows is not kept.
    """
    dev = lib_tab.device
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
    return (m * rows + (ci - 1)) * width + k, w_e, ok


def _merge_accum_kernel(lib_tab, w_inv, cost, seg, p2ca, p2cb, e0: int, e1: int):
    """Add library entries [e0, e1) of this wave into its cost planes
    (:func:`_merge_entry_targets`), each cell's entries in entry order."""
    P, rows, width = cost.shape
    target, w_e, ok = _merge_entry_targets(lib_tab, w_inv, seg, p2ca, p2cb, e0, e1, rows, width)
    _ordered_add_(cost.view(-1), target[ok], w_e[ok])


#: Library entries per accumulation step: bounds the per-entry temporaries.
MERGE_ENTRY_CHUNK = 1 << 21


def _sorted_entries(key, w, Pp: int, rows: int, width: int):
    """A wave's entries by cell: ``key`` int64 [N] flat cells ``(m * rows
    + i - 1) * width + k`` in entry order (``Pp * rows * width`` for an
    entry that is not kept), ``w`` float32 [N].  One stable sort, so each
    cell's entries keep entry order and the dropped ones go last.  Returns
    kernel E's inputs: (cols int32 [N], each entry's band cell k; the
    weights float32 [N] in that order; row pointers int32 [Pp * rows + 1],
    row r's entries at ``rowptr[r]`` up to ``rowptr[r + 1]``).  No step
    waits on the host: the row pointers are a ``searchsorted`` of the row
    boundaries (a ``bincount`` would read its size back)."""
    key, perm = torch.sort(key, stable=True)
    bounds = torch.arange(Pp * rows + 1, dtype=torch.int64, device=key.device) * width
    rowptr = torch.searchsorted(key, bounds, out_int32=True)
    return (key % width).to(torch.int32), w[perm], rowptr


def _merge_entries(lib_tab, w_inv, seg, p2ca, p2cb, total: int, Pp: int, rows: int, width: int):
    """Kernel E's inputs for a wave's ``total`` library entries, decoded
    :data:`MERGE_ENTRY_CHUNK` at a time (:func:`_merge_entry_targets`) and
    sorted by cell (:func:`_sorted_entries`); entries not kept stay in the
    arrays past the last row, so no shape depends on the data."""
    dev = lib_tab.device
    dropped = Pp * rows * width
    keys, ws = [], []
    for c0 in range(0, total, MERGE_ENTRY_CHUNK):
        target, w_e, ok = _merge_entry_targets(
            lib_tab, w_inv, seg, p2ca, p2cb, c0, min(c0 + MERGE_ENTRY_CHUNK, total), rows, width)
        keys.append(torch.where(ok, target, dropped))
        ws.append(w_e)
    key = torch.cat(keys) if keys else torch.zeros(0, dtype=torch.int64, device=dev)
    w = torch.cat(ws) if ws else torch.zeros(0, dtype=torch.float32, device=dev)
    return _sorted_entries(key, w, Pp, rows, width)


def _merge_entries_plain(cols, w, rowptr, la, lb, lo, kmax, rows: int, width: int):
    """Kernel E's plain version on its own inputs (:func:`_sorted_entries`):
    :func:`_merge_cost_init`, the kept entries added in order
    (:func:`_ordered_add_`), then :func:`_merge_dp_walk`."""
    cost = _merge_cost_init(la, kmax, rows, width)
    n = int(rowptr[-1])
    idx = torch.arange(n, dtype=torch.int64, device=cols.device)
    row = torch.searchsorted(rowptr.to(torch.int64), idx, right=True) - 1
    _ordered_add_(cost.view(-1), row * width + cols[:n].to(torch.int64), w[:n])
    return _merge_dp_walk(cost, la, lb, lo, kmax)


def _wave_tables(lib_dev, merges_desc):
    """The device tables of one merge wave (``merges_desc`` non-empty):
    (Pp, the bands (la, lb, lo, kmax) int32 [Pp] with the merges past
    ``len(merges_desc)`` padded empty, the per-segment tensors ``seg`` of
    :func:`_merge_entry_targets`, the flat position->column maps, the
    wave's library entry count, the float32 dequantization factor)."""
    lib_tab, w_inv = lib_dev
    dev = lib_tab.device
    Pp = _bkt(len(merges_desc), 16)
    bands = np.zeros((4, Pp), np.int64)  # la, lb, lo, kmax
    cols = {k: [] for k in ("bound", "start", "m", "aoff", "boff", "swap", "lo", "kmax")}
    p2ca_parts, p2cb_parts = [], []
    aoff_global = boff_global = 0
    at = 0
    for m, d in enumerate(merges_desc):
        bands[:, m] = d["la"], d["lb"], d["lo"], d["kmax"]
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

    def _t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    seg = {k: _t(v) for k, v in cols.items()}
    # A trailing 0 ("unmapped") catches any out-of-range lookup.
    p2ca = _t(np.concatenate(p2ca_parts + [np.zeros(1, np.int32)]), torch.int32)
    p2cb = _t(np.concatenate(p2cb_parts + [np.zeros(1, np.int32)]), torch.int32)
    w_inv_t = torch.tensor(np.float32(w_inv), dtype=torch.float32, device=dev)
    return Pp, tuple(_t(x, torch.int32) for x in bands), seg, p2ca, p2cb, at, w_inv_t


def merge_wave_from_library(lib_dev, merges_desc, rows_b, W_b):
    """Run one shape-class wave of profile merges against the device library.

    ``lib_dev`` = (int32 [T, 3] device table of (pa, pb, quantized w),
    float32 dequantization factor).  ``merges_desc`` is a list of dicts with
    keys ``la, lb, lo, kmax, segments, p2ca, p2cb`` where ``segments`` lists
    (start, length, aoff, boff, swap) tuples into the library and the
    merge-local column maps.  Returns the device jmat int32 [rows_b, Pp]
    (column m is merge m): on a CUDA library from kernel E, with no cost
    plane and no host sync; on a CPU one from the plain cost planes, DP
    and walk.
    """
    if not merges_desc:
        return None
    lib_tab = lib_dev[0]
    Pp, bands, seg, p2ca, p2cb, total, w_inv = _wave_tables(lib_dev, merges_desc)
    if lib_tab.is_cuda:  # kernel E builds each live row's costs on chip
        entries = _merge_entries(lib_tab, w_inv, seg, p2ca, p2cb, total, Pp, rows_b, W_b)
        return cuda_walk.merge_dp_walk(*entries, *bands, rows_b, W_b)
    la, _, _, kmax = bands
    cost = _merge_cost_init(la, kmax, rows_b, W_b)
    for c0 in range(0, total, MERGE_ENTRY_CHUNK):
        _merge_accum_kernel(
            lib_tab, w_inv, cost, seg, p2ca, p2cb,
            c0, min(c0 + MERGE_ENTRY_CHUNK, total),
        )
    return _merge_dp_walk(cost, *bands)


# ---------------------------------------------------------------------------
# Device-resident T-Coffee library (the JAX package's default route): the
# pair walks' jmats are the dense position maps, so the consistency
# extension is gather and small-sort work on the device, and the extended
# library never crosses to the host.
# ---------------------------------------------------------------------------

ARENA_ZERO_ROW = 0  # all zeros: composing through it yields dead entries
ARENA_IDENT_ROW = 1  # identity map: the base x~y entries reuse the
# composition (x->y composed with the identity)

#: Candidate slots (pairs x slots x positions) one extension launch takes:
#: bounds its int64 temporaries to a few hundred MB each.
EXTEND_CHUNK_ELEMS = 1 << 24


def pair_maps_device(
    codes, lengths, ga, gb, match, mismatch, gap_open, gap_ext, bandwidth, device,
):
    """Align every (ga[i], gb[i]) read pair and keep its path on ``device``.

    Returns (arena int16 [2 + 2J, stride], fracs float64 [J], fracs_dev
    float32 [J]): pair i's forward map (A-position -> matched B-position, 0
    = none) is arena row ``2 + 2i`` and its reverse map row ``3 + 2i``; row 0
    is all zeros and row 1 the identity.  ``stride`` is the pow2 (>= 128)
    above the longest read.  ``fracs_dev`` is each pair's float32 identity
    on ``device`` (kernel H's weights), ``fracs`` the same read back once and
    held as float64 (it feeds the guide tree).  Pairs and DP cells count on
    the ``msa.pair_library`` stage.
    """
    ga = np.asarray(ga, np.int64)
    gb = np.asarray(gb, np.int64)
    J = ga.size
    lengths = np.asarray(lengths)
    lens_a = lengths[ga].astype(np.int32)
    lens_b = lengths[gb].astype(np.int32)
    lmax = int(max(lens_a.max(initial=1), lens_b.max(initial=1)))
    stride = _bkt(lmax + 1, 128)
    arena = torch.zeros((2 + 2 * J, stride), dtype=torch.int16, device=device)
    arena[ARENA_IDENT_ROW] = torch.arange(stride, dtype=torch.int16, device=device)
    fracs_dev = torch.zeros(J, dtype=torch.float32, device=device)
    if J == 0:
        return arena, np.zeros(0, np.float64), fracs_dev
    lo, hi, rows_c, W_c = _pair_buckets(lens_a, lens_b, bandwidth)
    codes = np.asarray(codes)
    for rows_b, W_b, sub in _pair_launches(rows_c, W_c, device):
        _, jmat, ident = _run_pair_bucket(
            codes[ga[sub]], lens_a[sub], codes[gb[sub]], lens_b[sub],
            lo[sub], hi[sub], match, mismatch, gap_open, gap_ext,
            rows_b, W_b, device,
        )
        sub_t = torch.as_tensor(sub, device=device)
        _arena_place_kernel(arena, jmat, 2 + 2 * sub_t)
        fracs_dev[sub_t] = ident.to(fracs_dev.device)
    return arena, fracs_dev.cpu().numpy().astype(np.float64), fracs_dev


def _arena_place_kernel(arena, jmat, arow):
    """Write one launch's position maps into ``arena`` in place.

    ``jmat`` [rows, P] is the walk's output; pair q's forward map goes to
    row ``arow[q]`` (column a holds the B-position matched to A-position a)
    and its reverse map to row ``arow[q] + 1``.  A path is monotone, so each
    matched B-position occurs once per pair and the reverse map is one
    scatter; unmatched entries all write 0 into column 0.  DP rows past
    ``stride - 1`` are padding (no read is that long) and are dropped.
    """
    P = arow.shape[0]
    stride = arena.shape[1]
    take = min(jmat.shape[0], stride - 1)
    cols = jmat[:take, :P].t().to(torch.int64)  # matched b per a, 0 = none
    fwd = torch.zeros((P, stride), dtype=arena.dtype, device=arena.device)
    fwd[:, 1 : take + 1] = cols.to(arena.dtype)
    a = torch.arange(1, take + 1, device=arena.device).expand(P, take)
    rev = torch.zeros((P, stride), dtype=torch.int64, device=arena.device)
    rev.scatter_(1, cols, torch.where(cols > 0, a, 0))
    arena[arow] = fwd
    arena[arow + 1] = rev.to(arena.dtype)


def _extend_library(arena, jobs, first_job, fracs, order, chunks, w_scale):
    """Consistency-extend every output pair of one library build; returns
    (int32 [T, 3] entries, int64 numpy [J + 1] offsets): kernel H
    (:func:`.cuda_extend.extend_library`) on a CUDA arena,
    :func:`_extend_library_plain` on a CPU one."""
    run = cuda_extend.extend_library if arena.is_cuda else _extend_library_plain
    return run(arena, jobs, first_job, fracs, order, chunks, w_scale)


def _slot_tables(jobs, first_job, fracs, jids, SL: int):
    """The [CP, SL] slot tables of the jobs ``jids`` (kernel H derives the
    same on chip): arena rows ``xz`` and ``zy`` (int64) and weights ``ws``
    (float32).  ``jobs`` int64 [J, 4] (group, x, y, g), ``first_job`` int64
    [groups], ``fracs`` the float32 identities, all on one device.

    Slot 0 is the pair's own forward map through the identity row, weight
    ident(x, y) * 100; slot s >= 1 is middle sequence z = s - 1 stepped past
    x, then past y (z ascending, x and y skipped), rows x -> z and z -> y,
    weight min(ident(x, z), ident(z, y)) * 100; slots s >= g - 1 are dead
    (row 0, row 0, weight 0).  The row of u -> v is 2 + 2 jobid(u, v) for u <
    v and 3 + 2 jobid(v, u) otherwise, jobid(u, v) = first + u g - u (u + 1)
    / 2 + v - u - 1.  Weights round as the host's numpy did: float64 min
    (the second only where smaller) times 100.0, then float32."""
    grp, x, y, g = (c[:, None] for c in jobs[jids].unbind(1))
    first = first_job[grp]
    s = torch.arange(SL, device=jobs.device)[None, :]
    z = s - 1
    z = z + (z >= x)
    z = z + (z >= y)

    def row(u, v):
        lo, hi = torch.minimum(u, v), torch.maximum(u, v)
        return 2 + 2 * (first + lo * g - lo * (lo + 1) // 2 + hi - lo - 1) + (u > v)

    live = s < g - 1
    rxz = torch.where(s == 0, 2 + 2 * jids[:, None], row(x, z))
    rzy = torch.where(s == 0, ARENA_IDENT_ROW, row(z, y))
    f64 = fracs.to(torch.float64)
    ixz = f64[torch.where(live, (rxz - 2) // 2, 0)]
    izy = f64[torch.where(live, (rzy - 2) // 2, 0)]
    w = torch.where(s == 0, ixz, torch.where(izy < ixz, izy, ixz)) * 100.0
    xz = torch.where(live, rxz, ARENA_ZERO_ROW)
    zy = torch.where(live, rzy, ARENA_ZERO_ROW)
    return xz, zy, torch.where(live, w.to(torch.float32), 0.0)


def _extend_library_plain(arena, jobs, first_job, fracs, order, chunks, w_scale):
    """Kernel H's plain version on its own inputs
    (:func:`.cuda_extend.extend_library`'s): each chunk's slot tables by
    :func:`_slot_tables`, its entries by :func:`_extend_chunk_plain`,
    concatenated in chunk order; returns (int32 [T, 3] entries, int64 numpy
    [J + 1] exclusive offsets of each pair's entries in ``order``)."""
    dev = arena.device
    cuda_extend.check_chunks(jobs, order, chunks, arena.shape[1])
    jobs_t = torch.as_tensor(np.asarray(jobs, np.int64), device=dev)
    first_t = torch.as_tensor(np.asarray(first_job, np.int64), device=dev)
    order_t = torch.as_tensor(np.asarray(order, np.int64), device=dev)
    scale = torch.tensor(np.float32(w_scale), device=dev)
    J = int(order_t.shape[0])
    counts = torch.zeros(J, dtype=torch.int64, device=dev)
    parts = [torch.zeros((0, 3), dtype=torch.int32, device=dev)]
    for q0, q1, sl, strc in chunks:
        jids = order_t[q0:q1]
        xz, zy, ws = _slot_tables(jobs_t, first_t, fracs, jids, sl)
        parts.append(_extend_chunk_plain(
            arena, xz, zy, ws, torch.arange(q0, q1, device=dev), counts, scale, strc))
    off = np.zeros(J + 1, np.int64)
    np.cumsum(counts.cpu().numpy(), out=off[1:])
    return torch.cat(parts), off


def _extend_chunk_plain(arena, xz_rows, zy_rows, w_slots, pair_ids, counts, w_scale, strc: int):
    """Kernel H's plain version: one chunk's entries by gathers, a sort
    along the slots and unrolled masked adds.

    For output pair p and slot s (slot 0 the base x~y map through the
    identity row, each other slot one middle sequence z):
    ``k = arena[xz_rows[p, s], a]``, ``b = arena[zy_rows[p, s], k]`` (0
    where k is 0), weight ``w_slots[p, s]``.  Per (p, a) the slots' b's
    sort stably (dead ones last, key ``1 << 20``); duplicate b's sum their
    weights in float32 in slot order, starting from 0.0, by masked adds
    (no scatter or cumsum, which could reorder float adds); the first of
    each run at a > 0 is kept, with weight ``round(wsum * w_scale)`` (half
    to even).  ``strc`` bounds the A-positions (the chunk's longest x plus
    one, pow2 from 128); ``w_scale`` is a float32 scalar tensor.

    Returns int32 [n, 3] rows (a, b, quantized weight), pair by pair in
    chunk order and within a pair by a, then b, ascending; each pair's kept
    count is added to ``counts[pair_ids[p]]`` (a pad pair, with zero rows
    and slot weights, keeps nothing and points at a spare slot).
    """
    CP, SL = xz_rows.shape
    STR = arena.shape[1]
    XZ = arena[:, :strc][xz_rows].to(torch.int64)  # [CP, SL, strc]
    b = arena.reshape(-1)[zy_rows[:, :, None] * STR + XZ].to(torch.int64)
    b = torch.where(XZ > 0, b, 0)
    del XZ

    bt = b.transpose(1, 2)  # [CP, strc, SL]
    DEAD = 1 << 20
    key = torch.where(bt > 0, bt, DEAD)
    del b, bt
    key_s, perm = torch.sort(key, dim=2, stable=True)
    del key
    w_s = w_slots.gather(1, perm.reshape(CP, -1)).reshape(perm.shape)
    del perm
    valid = key_s < DEAD
    first = valid.clone()
    first[..., 1:] &= key_s[..., 1:] != key_s[..., :-1]
    w_live = torch.where(valid, w_s, 0.0)
    wsum = torch.zeros_like(w_s)
    for j in range(SL):
        wsum = wsum + torch.where(key_s == key_s[..., j : j + 1], w_live[..., j : j + 1], 0.0)

    a_idx = torch.arange(strc, device=arena.device)[None, :, None]
    keep = first & (a_idx > 0)
    p, a, j = keep.nonzero(as_tuple=True)
    wq = torch.round(wsum[p, a, j] * w_scale)
    counts.index_add_(0, pair_ids, keep.sum(dim=(1, 2)).to(counts.dtype))
    return torch.stack([a, key_s[p, a, j], wq.to(torch.int64)], dim=1).to(torch.int32)

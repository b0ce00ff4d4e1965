"""``multi_read_align`` — per-group multiple sequence alignment.

Counterpart of ``sarlacc_tpu/api/msa.py``, routed as it is: each segment
of groups builds its library on the device (:func:`_build_library_device`)
unless ``SARLACC_HOST_LIB`` is set or :func:`_device_lib_ok` refuses it,
and then on the host (:func:`_build_library_host`).  T-Coffee-style
progressive MSA with the structure of the reference's SeqAn call
(src/quick_msa.cpp:25-75):

1. **Pairwise library** — banded global affine alignments of every pair in
   every group (kernel B + the device walk), each decomposed into matched
   residue pairs weighted by the alignment's percent identity (float32 on
   the device route, float64 on the host route, as in the JAX package).
2. **Triplet extension** — the consistency transform: on the device
   (:func:`..ops.msa._extend_library`: kernel H), or in the native host library
   (``triplet_extend``), one group per thread.
3. **Merge order** — a neighbour-joining tree on ``1 - identity`` distances.
4. **Progressive merges** — profile-profile maximal-weighted-trace DP with
   library-sum column scores and zero gap cost, banded, on the device
   (:func:`..ops.msa.merge_wave_from_library`), batched across groups into
   waves of merges whose operands are ready.

Deviations shared with the JAX package: ``max_error`` masking is wired
(low-quality bases align as N and are restored unless ``keep_mask``), and
the pairwise band widens by each pair's length difference.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.encode import SeqBatch
from ..core.frame import Frame
from ..device import env_number, finite_float, memory_budget, record_budget
from ..native import take_triplet_timing, triplet_extend_native
from ..ops.msa import (
    EXTEND_CHUNK_ELEMS,
    _bkt,
    _bkt_arr,
    _extend_library,
    banded_pair_align,
    merge_wave_from_library,
    pair_maps_device,
)
from ..ops.cuda_extend import MAX_SLOTS
from ..parallel.context import mesh_device, use_mesh
from ..refimpl.masking import unmask_alignment
from ..utils.profiling import count, profiled, profiler
from .umi import quality_mask

__all__ = ["multi_read_align", "MAX_MSA_READ_LEN"]

#: Worker threads of the host library route's triplet extension.
TRIPLET_WORKERS = 8

#: Longest read the MSA subsystem accepts: positions ride 16-bit library
#: rows, so lengths beyond this would wrap silently.  Margin below 32767
#: covers the +1 one-past-end conventions.
MAX_MSA_READ_LEN = 32000


def _split_groups(n: int, groups) -> tuple[list[np.ndarray], list | None]:
    if groups is None:
        return [np.arange(n, dtype=np.int64)], None
    if isinstance(groups, (list, tuple)) and (
        len(groups) == 0 or isinstance(groups[0], (list, tuple, np.ndarray))
    ):
        return [np.asarray(g, dtype=np.int64) for g in groups], None
    groups = np.asarray(groups)
    if groups.shape[0] != n:
        raise ValueError("length of 'reads' and 'groups' should be the same")
    keys = np.unique(groups)
    return [np.flatnonzero(groups == k).astype(np.int64) for k in keys], [
        str(k) for k in keys
    ]


def _pair_libraries(codes, lengths, by_group, match, mismatch, go, ge, bandwidth, device):
    """All-pairs alignments for ALL groups in one batched set of launches.

    Returns per-group (lib, ident) lists, where lib[(x, y)] = (pa, pb, w)
    arrays for x < y (local indices) and ident[x, y] = fractional identity.
    """
    jobs: list[tuple[int, int, int]] = []  # (group #, local x, local y)
    for gi, idx in enumerate(by_group):
        xs, ys = np.triu_indices(idx.size, k=1)
        jobs.extend((gi, int(x), int(y)) for x, y in zip(xs, ys))

    libs = [dict() for _ in by_group]
    idents = [np.ones((idx.size, idx.size)) for idx in by_group]
    if not jobs:
        return libs, idents

    ga = np.asarray([by_group[g][x] for g, x, y in jobs])
    gb = np.asarray([by_group[g][y] for g, x, y in jobs])
    _, paths = banded_pair_align(
        codes[ga], lengths[ga], codes[gb], lengths[gb],
        match, mismatch, go, ge, bandwidth, device=device,
    )
    with profiler("msa.pair_postprocess"):
        return _pair_post(jobs, paths, codes, ga, gb, libs, idents)


def _pair_post(jobs, paths, codes, ga, gb, libs, idents):
    for p, (gi, x, y) in enumerate(jobs):
        pa, pb = paths[p]
        if pa.size:
            eq = codes[ga[p]][pa - 1] == codes[gb[p]][pb - 1]
            frac = float(eq.sum()) / pa.size
        else:
            frac = 0.0
        w = np.full(pa.size, frac * 100.0, dtype=np.float32)
        libs[gi][(x, y)] = (pa, pb, w)
        idents[gi][x, y] = idents[gi][y, x] = frac
    return libs, idents


def _nj_tree(dist: np.ndarray) -> list[tuple[int, int]]:
    """Neighbour-joining merge order; returns [(node_a, node_b), ...] where
    leaves are 0..g-1 and internal nodes get indices g, g+1, ...
    """
    g = dist.shape[0]
    if g == 1:
        return []
    active = list(range(g))
    d = dist.astype(np.float64).copy()
    nodes = {i: i for i in range(g)}
    merges: list[tuple[int, int]] = []
    nxt = g
    while len(active) > 2:
        n = len(active)
        sub = d[np.ix_(active, active)]
        r = sub.sum(axis=1)
        q = (n - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(q, np.inf)
        a, b = np.unravel_index(np.argmin(q), q.shape)
        if a > b:
            a, b = b, a
        ia, ib = active[a], active[b]
        merges.append((nodes[ia], nodes[ib]))
        # distances to the new node.
        dnew = 0.5 * (d[ia, :] + d[ib, :] - d[ia, ib])
        d = np.pad(d, ((0, 1), (0, 1)))
        d[-1, : d.shape[1] - 1] = dnew
        d[: d.shape[0] - 1, -1] = dnew
        inew = d.shape[0] - 1
        nodes[inew] = nxt
        nxt += 1
        active = [v for v in active if v not in (ia, ib)] + [inew]
    if len(active) == 2:
        merges.append((nodes[active[0]], nodes[active[1]]))
    return merges


class _Profile:
    """members: local sequence indices; c2p[m, c] = 1-based seq position
    or 0 for gap, for member m at column c ([nmembers, ncols] int32)."""

    def __init__(self, members: list[int], c2p: np.ndarray):
        self.members = members
        self.c2p = c2p

    @property
    def ncols(self) -> int:
        return self.c2p.shape[1]

    @classmethod
    def leaf(cls, m: int, length: int) -> "_Profile":
        return cls([m], np.arange(1, length + 1, dtype=np.int32)[None, :])


def _merge_columns(la: int, lb: int, ai, bi):
    """Merged column layout for matched pairs (ai, bi) (1-based ascending).

    Returns (acol, bcol): for each merged column, the source column in A/B
    (1-based) or 0 for a gap.  Vectorized form of the reference merge walk
    (a-gap run, then b-gap run, then the match): match t lands at
    ai[t]+bi[t]-t-2; an unmatched a-column ca after m matches lands at
    ca-1-m+bi[m-1]; an unmatched b-column cb before match m lands at
    ai[m]-1-m+cb-1 (trailing run uses ai[M] = la+1).
    """
    ai = np.asarray(ai, dtype=np.int64)
    bi = np.asarray(bi, dtype=np.int64)
    M = ai.size
    ncols = la + lb - M
    acol = np.zeros(ncols, dtype=np.int32)
    bcol = np.zeros(ncols, dtype=np.int32)
    if M:
        mpos = ai + bi - np.arange(M) - 2
        acol[mpos] = ai
        bcol[mpos] = bi
    a_hit = np.zeros(la + 1, dtype=bool)
    a_hit[ai] = True
    ua = np.flatnonzero(~a_hit[1:]).astype(np.int64) + 1
    if ua.size:
        m = np.searchsorted(ai, ua)
        bprev = np.concatenate([[0], bi])[m]
        acol[ua - 1 - m + bprev] = ua
    b_hit = np.zeros(lb + 1, dtype=bool)
    b_hit[bi] = True
    ub = np.flatnonzero(~b_hit[1:]).astype(np.int64) + 1
    if ub.size:
        m = np.searchsorted(bi, ub)
        anext = np.concatenate([ai, [la + 1]])[m]
        bcol[anext - 1 - m + ub - 1] = ub
    return acol, bcol


def _apply_merge(pa: _Profile, pb: _Profile, ai, bi) -> _Profile:
    acol, bcol = _merge_columns(pa.ncols, pb.ncols, ai, bi)
    za = np.zeros((pa.c2p.shape[0], 1), dtype=np.int32)
    zb = np.zeros((pb.c2p.shape[0], 1), dtype=np.int32)
    new_c2p = np.concatenate(
        [
            np.concatenate([za, pa.c2p], axis=1)[:, acol],
            np.concatenate([zb, pb.c2p], axis=1)[:, bcol],
        ],
        axis=0,
    )
    return _Profile(pa.members + pb.members, new_c2p)


def _merge_descriptor(gi, pa: _Profile, pb: _Profile, pair_seg, bandwidth: int):
    """Wave-input descriptor for one profile merge (see merge_wave_from_library)."""
    la, lb = pa.ncols, pb.ncols
    diff = lb - la
    lo = min(0, diff) - bandwidth
    hi = max(0, diff) + bandwidth

    def flat_maps(prof: _Profile):
        """Inverse (position -> column) maps for every member, flattened.

        One scatter builds all members' maps: member rows are disjoint
        windows of the flat array, and positions within a member are unique.
        """
        c2p = prof.c2p
        nm, nc = c2p.shape
        if nm == 0:
            return np.zeros(1, np.int32), []
        sizes = c2p.max(axis=1, initial=0).astype(np.int64) + 1
        offs64 = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        flat = np.zeros(int(sizes.sum()), np.int32)
        nz = c2p > 0
        idx = (offs64[:, None] + c2p)[nz]
        cols = np.broadcast_to(np.arange(1, nc + 1, dtype=np.int32), c2p.shape)
        flat[idx] = cols[nz]
        return flat, [int(o) for o in offs64]

    p2ca, aoffs = flat_maps(pa)
    p2cb, boffs = flat_maps(pb)

    segments = []
    for mi, a in enumerate(pa.members):
        for mj, b in enumerate(pb.members):
            if a < b:
                key, swap = (gi, a, b), 0
            else:
                key, swap = (gi, b, a), 1
            seg = pair_seg.get(key)
            if seg is None or seg[1] == 0:
                continue
            segments.append((seg[0], seg[1], aoffs[mi], boffs[mj], swap))
    return {
        "la": la,
        "lb": lb,
        "lo": lo,
        "kmax": hi - lo,
        "segments": segments,
        "p2ca": p2ca,
        "p2cb": p2cb,
    }


def _run_merge_wave(lib_dev, descs):
    """Run one wave of merges (possibly none): launch every row class, then
    read back.

    Classes go by rows only (the DP's sequential axis); merges of different
    widths share a launch at the widest bucket.
    """
    classes: dict = {}
    for i, d in enumerate(descs):
        classes.setdefault(_bkt(max(d["la"], 1), 64), []).append(i)
    inflight = []
    for rb, idxs in classes.items():
        wb = _bkt(max(descs[i]["kmax"] + 1 for i in idxs), 64)
        jmat = merge_wave_from_library(lib_dev, [descs[i] for i in idxs], rb, wb)
        inflight.append((idxs, jmat))

    paths: list = [None] * len(descs)
    with profiler("msa.merge_readback"):
        for idxs, jmat_dev in inflight:
            jmat = jmat_dev.cpu().numpy()
            for k, i in enumerate(idxs):
                seg = jmat[: descs[i]["la"], k]
                rr = np.flatnonzero(seg)
                paths[i] = ((rr + 1).astype(np.int32), seg[rr].astype(np.int32))
    return paths


def _lib_w_scale(by_group, active) -> float:
    """uint16 fixed-point scale for library weights.

    An extended entry's weight is bounded a priori by 100*(g-1) (base + one
    min-composition per middle sequence, each <= 100), so one global scale
    is exact to ~wbound/65535.
    """
    gmax = max((by_group[gi].size for gi in active), default=2)
    return 65535.0 / (100.0 * max(gmax - 1, 1) + 1.0)


def _build_library_host(
    codes, lengths, by_group, active, match, mismatch, go, ge, bandwidth, device
):
    """Pair library on the card, triplet extension in the native host
    library, packed entry table uploaded once per segment.

    Returns (lib_dev = (int32 [T, 3] table on ``device``, dequantization
    factor), pair_seg {(group, x, y): (start, length)}, idents per group).
    """
    with profiler("msa.pair_library"):
        libs, idents = _pair_libraries(
            codes, lengths, [by_group[gi] for gi in active],
            match, mismatch, go, ge, bandwidth, device,
        )

    pair_seg: dict = {}
    w_scale = _lib_w_scale(by_group, active)

    # Triplet extension per group in a thread pool (the C++ call releases
    # the GIL, so groups extend concurrently).  A worker returns its own
    # wall, its seconds inside the C call and its reruns; the counters are
    # summed here, on the calling thread.
    def _extend_and_pack(pos):
        t0 = time.perf_counter()
        take_triplet_timing()
        lib = triplet_extend_native(int(by_group[active[pos]].size), libs[pos])
        keys = sorted(lib)
        sizes = [lib[k][0].size for k in keys]
        n = int(sum(sizes))
        tab = np.zeros((n, 3), np.uint16)
        if n:
            tab[:, 0] = np.concatenate([lib[k][0] for k in keys])
            tab[:, 1] = np.concatenate([lib[k][1] for k in keys])
            tab[:, 2] = np.rint(
                np.concatenate([lib[k][2] for k in keys]) * w_scale
            )
        return keys, sizes, tab, (time.perf_counter() - t0, *take_triplet_timing())

    parts = []
    lib_at = 0
    worker_s = call_s = slowest = 0.0
    reruns = 0
    with profiler("msa.triplet"), ThreadPoolExecutor(max_workers=TRIPLET_WORKERS) as pool:
        t0 = time.perf_counter()
        for pos, (keys, sizes, tab, (wall, c_s, rr)) in enumerate(
            pool.map(_extend_and_pack, range(len(active)))
        ):
            gi = active[pos]
            if tab.size:
                parts.append(tab)
            for k, sz in zip(keys, sizes):
                pair_seg[(gi, k[0], k[1])] = (lib_at, sz)
                lib_at += sz
            worker_s += wall
            call_s += c_s
            reruns += rr
            slowest = max(slowest, wall)
        count("native.triplet.pool_s", time.perf_counter() - t0)
    count("native.triplet.calls", len(active))
    count("native.triplet.reruns", reruns)
    count("native.triplet.call_s", call_s)
    count("native.triplet.python_s", worker_s - call_s)
    count("native.triplet.straggler_s", slowest)

    with profiler("msa.lib_upload"):
        table = np.concatenate(parts) if parts else np.zeros((1, 3), np.uint16)
        lib_tab = torch.as_tensor(table.astype(np.int32), device=device)
    return (lib_tab, np.float32(1.0 / w_scale)), pair_seg, idents


def _slot_bucket(g: int) -> int:
    """A group of ``g`` reads' slot bucket: the pow2 bucket of g - 1 (the
    base slot plus one per middle sequence)."""
    return _bkt(max(g - 1, 1), 2)


def _fits_slots(g: int) -> bool:
    """Whether a group of ``g`` reads fits kernel H's slots: a segment that
    holds one that does not takes the host library route."""
    return _slot_bucket(g) <= MAX_SLOTS


def _device_lib_ok(lengths, by_group, active, device, budget_bytes: int | None = None) -> bool:
    """Size guard for the device library route.

    The extension's duplicate sum runs over at most :data:`MAX_SLOTS` slots
    (:func:`_fits_slots`), and the JAX package's packed table grows as
    O(#pairs * SL * stride); a segment with a group too large for either
    takes the host route, as there.  ``budget_bytes`` defaults to 1/8 of the
    card's free memory (2 GiB on the CPU).
    """
    if budget_bytes is None:
        budget_bytes = memory_budget(device, 0.125, 1 << 31, "lib_table")
    npairs_sl = 0  # sum over pairs of their slot bucket
    for gi in active:
        g = by_group[gi].size
        if not _fits_slots(g):
            return False
        npairs_sl += (g * (g - 1) // 2) * _slot_bucket(g)
    lmax = (
        int(lengths[np.concatenate([by_group[gi] for gi in active])].max(initial=1))
        if active else 1
    )
    stride = _bkt(lmax + 1, 128)
    return npairs_sl * stride * 6 <= budget_bytes


#: Slot classes of the extension's launches (SL >= g - 1: the base slot
#: plus one per middle sequence), finer than pow2 so that g - 1 = 10 (a
#: common family size) does not pay for 16 slots.
_SL_LADDER = (2, 4, 6, 8, 10, 12, 16, 20, 24, MAX_SLOTS)


def _sl_class(v: int) -> int:
    for s in _SL_LADDER:
        if v <= s:
            return s
    return _SL_LADDER[-1]


def _library_jobs(by_group, active):
    """The device library's job tables, in the JAX package's job order
    (group by group, each group's pairs x < y by ``np.triu_indices``):
    (jobs int32 [J, 4] (position in ``active``, x, y, g), first_job int32
    [len(active)], read indices ga and gb [J], each job's slot class SL).
    Numpy over whole arrays, one ``np.triu_indices`` a group size."""
    sizes = np.asarray([by_group[gi].size for gi in active], np.int64)
    npairs = sizes * (sizes - 1) // 2
    first = np.zeros(len(active), np.int64)
    np.cumsum(npairs[:-1], out=first[1:])
    tri = {g: np.triu_indices(g, k=1) for g in np.unique(sizes).tolist()}
    xs = np.concatenate([tri[g][0] for g in sizes.tolist()] + [np.zeros(0, np.int64)])
    ys = np.concatenate([tri[g][1] for g in sizes.tolist()] + [np.zeros(0, np.int64)])
    grp = np.repeat(np.arange(len(active)), npairs)
    g_j = sizes[grp]
    members = np.concatenate([by_group[gi] for gi in active] + [np.zeros(0, np.int64)])
    mstart = np.zeros(len(active), np.int64)
    np.cumsum(sizes[:-1], out=mstart[1:])
    ga = members[mstart[grp] + xs]
    gb = members[mstart[grp] + ys]
    lut = np.asarray([_sl_class(max(g - 1, 1)) for g in range(int(sizes.max(initial=0)) + 1)],
                     np.int64)  # the slot class of each group size
    sl = lut[g_j]
    jobs = np.stack([grp, xs, ys, g_j], axis=1).astype(np.int32)
    return jobs, first.astype(np.int32), ga, gb, sl


def _library_chunks(sl, strc):
    """Kernel H's launch order: the jobs sorted stably by (SL, strc) class,
    each class cut into chunks of at most ``min(1024, EXTEND_CHUNK_ELEMS /
    (SL strc))`` pairs.  Returns (order int32 [J], [(q0, q1, SL, strc)])."""
    order = np.lexsort((strc, sl))
    chunks = []
    cls_sl, cls_strc = sl[order], strc[order]
    edges = np.flatnonzero((np.diff(cls_sl) != 0) | (np.diff(cls_strc) != 0)) + 1
    for c0, c1 in zip(np.r_[0, edges].tolist(), np.r_[edges, order.size].tolist()):
        s, w = int(cls_sl[c0]), int(cls_strc[c0])
        cp = min(1024, max(1, EXTEND_CHUNK_ELEMS // (s * w)))
        chunks += [(q, min(q + cp, c1), s, w) for q in range(c0, c1, cp)]
    return order.astype(np.int32), chunks


def _build_library_device(
    codes, lengths, by_group, active, match, mismatch, go, ge, bandwidth, device
):
    """Extended T-Coffee library built on ``device``.

    The pair walks' matched positions stay on the device as position maps
    (:func:`..ops.msa.pair_maps_device`), beside the float32 identities;
    the consistency extension composes them (:func:`..ops.msa._extend_library`:
    kernel H on the card, which derives every pair's slots itself from the
    per-job and per-group tables) in launches classed by (slot count,
    x-length bucket), with one readback of the pairs' entry counts.  The
    host side is numpy over whole arrays.

    Returns (lib_dev = (int32 [T, 3] table on ``device``, dequantization
    factor), pair_seg {(group, x, y): (start, length)} for every pair,
    idents per group).  Identities, weights and each pair's entries (a, then
    b, ascending) equal the JAX package's default route.
    """
    w_scale = _lib_w_scale(by_group, active)
    idents = [np.ones((by_group[gi].size, by_group[gi].size)) for gi in active]
    jobs, first_job, ga, gb, sl = _library_jobs(by_group, active)
    if not jobs.shape[0]:
        table = torch.zeros((1, 3), dtype=torch.int32, device=device)
        return (table, np.float32(1.0 / w_scale)), {}, idents

    with profiler("msa.pair_library"):
        arena, fracs, fracs_dev = pair_maps_device(
            codes, lengths, ga, gb, match, mismatch, go, ge, bandwidth, device,
        )
    at = 0
    for pos, gi in enumerate(active):
        n = jobs.shape[0] if pos + 1 == len(active) else int(first_job[pos + 1])
        xs, ys = jobs[at:n, 1], jobs[at:n, 2]
        idents[pos][xs, ys] = idents[pos][ys, xs] = fracs[at:n]
        at = n

    # A-positions a pair composes: its x-length plus one, pow2 from 128.
    strc = np.minimum(_bkt_arr(np.asarray(lengths)[ga].astype(np.int64) + 1, 128), arena.shape[1])
    order, chunks = _library_chunks(sl, strc)
    with profiler("msa.triplet"):
        table, off = _extend_library(
            arena, jobs, first_job, fracs_dev, order, chunks, np.float32(w_scale))

    active_l = np.asarray(active)[jobs[order, 0]].tolist()
    keys = zip(active_l, jobs[order, 1].tolist(), jobs[order, 2].tolist())
    pair_seg = dict(zip(keys, zip(off[:-1].tolist(), np.diff(off).tolist())))
    if not off[-1]:
        table = torch.zeros((1, 3), dtype=torch.int32, device=device)
    return (table, np.float32(1.0 / w_scale)), pair_seg, idents


def _segment_lib_budget(device) -> int:
    """Estimated-library byte budget per MSA segment: 1/16 of the card's
    free memory at first probe, 1 GiB on the CPU.  Segments bound peak
    memory (library table, cost planes) while keeping launches thousands of
    pairs wide.  ``SARLACC_MSA_SEG_BUDGET_GB`` (float GiB, floored at 64
    MiB) replaces it, as in the JAX package; it changes the segment packing,
    never the alignments.  A malformed value warns and keeps the default."""
    gib = env_number("SARLACC_MSA_SEG_BUDGET_GB", finite_float, None)
    if gib is not None:
        return record_budget("lib_segment", device, max(int(gib * (1 << 30)), 64 << 20))
    return memory_budget(device, 1 / 16, 1 << 30, "lib_segment")


def _group_lib_bytes(lengths, idx) -> int:
    """Estimated packed extended-library bytes for one group ([T, 3] uint16
    rows ~ pairs * slot-bucket * stride)."""
    g = idx.size
    if g < 2:
        return 0
    stride = _bkt(int(lengths[idx].max(initial=1)) + 1, 128)
    return (g * (g - 1) // 2) * _slot_bucket(g) * stride * 6


def _segments(lengths, by_group, active, seg_budget) -> list[list[int]]:
    """Pack the active groups, in order, into segments whose estimated
    library fits ``seg_budget``.  Groups that do not fit kernel H's slots
    (:func:`_fits_slots`) segment separately, so that one oversized group (which
    :func:`_device_lib_ok` sends to the host route) does not take its
    neighbours with it."""
    segments: list[list[int]] = []
    for eligible in (True, False):
        cur: list[int] = []
        cur_bytes = 0
        for gi in active:
            if _fits_slots(by_group[gi].size) != eligible:
                continue
            b = _group_lib_bytes(lengths, by_group[gi])
            if cur and cur_bytes + b > seg_budget:
                segments.append(cur)
                cur, cur_bytes = [], 0
            cur.append(gi)
            cur_bytes += b
        if cur:
            segments.append(cur)
    return segments


def _msa_groups(codes, lengths, by_group, match, mismatch, go, ge, bandwidth, device):
    """MSA for all groups, batching launches across groups in segments.

    Groups pack into **segments** (:func:`_segments`) whose estimated
    library fits :func:`_segment_lib_budget`; each segment builds its
    library in one batched set of launches and runs its merges in
    cross-group waves.
    """
    decode = np.frombuffer(b"ACGTN-", dtype=np.uint8)
    results: list[list[str] | None] = [None] * len(by_group)

    active: list[int] = []
    for gi, idx in enumerate(by_group):
        g = idx.size
        if g == 0:
            results[gi] = []
        elif g == 1:
            n = int(lengths[idx[0]])
            results[gi] = [decode[codes[idx[0], :n]].tobytes().decode()]
        else:
            active.append(gi)

    segments = _segments(lengths, by_group, active, _segment_lib_budget(device))
    count("msa.segments", len(segments))
    for seg in segments:
        _msa_segment(
            codes, lengths, by_group, seg, match, mismatch, go, ge,
            bandwidth, decode, results, device,
        )
    return results


def _msa_segment(
    codes, lengths, by_group, active, match, mismatch, go, ge, bandwidth,
    decode, results, device,
):
    """Library + neighbour-joining trees + merge waves for one segment of groups."""
    if os.environ.get("SARLACC_HOST_LIB") or not _device_lib_ok(
        lengths, by_group, active, device
    ):
        build = _build_library_host
        count("msa.segments.host")
    else:
        build = _build_library_device
    lib_dev, pair_seg, idents = build(
        codes, lengths, by_group, active, match, mismatch, go, ge, bandwidth, device
    )

    state = {}
    with profiler("msa.guide_tree"):
        for pos, gi in enumerate(active):
            idx = by_group[gi]
            g = idx.size
            merges = _nj_tree(1.0 - idents[pos])
            lens_local = lengths[idx]
            profiles = {m: _Profile.leaf(m, int(lens_local[m])) for m in range(g)}
            state[gi] = {
                "merges": merges,
                "profiles": profiles,
                "node_of_merge": {k: g + k for k in range(len(merges))},
                "todo": list(range(len(merges))),
            }

    # Readiness-scheduled waves: each wave batches EVERY merge (across all
    # groups) whose operand profiles both exist, so the number of waves is
    # the deepest tree depth, not the merge count.
    pending = [gi for gi in active if state[gi]["todo"]]
    while pending:
        wave, descs = [], []
        trivial = []  # merges with an empty side need no DP
        for gi in pending:
            st = state[gi]
            for k in list(st["todo"]):
                a, b = st["merges"][k]
                if a not in st["profiles"] or b not in st["profiles"]:
                    continue
                pa, pb = st["profiles"][a], st["profiles"][b]
                if pa.ncols == 0 or pb.ncols == 0:
                    trivial.append((gi, k, a, b))
                else:
                    with profiler("msa.merge_cost"):
                        descs.append(_merge_descriptor(gi, pa, pb, pair_seg, bandwidth))
                    wave.append((gi, k, a, b))

        with profiler("msa.merge_kernel"):
            paths = _run_merge_wave(lib_dev, descs)
        with profiler("msa.apply_merge"):
            for (gi, k, a, b), (ai, bi) in zip(wave, paths):
                st = state[gi]
                st["profiles"][st["node_of_merge"][k]] = _apply_merge(
                    st["profiles"][a], st["profiles"][b], ai, bi
                )
                del st["profiles"][a], st["profiles"][b]
                st["todo"].remove(k)
        for gi, k, a, b in trivial:
            st = state[gi]
            pa, pb = st["profiles"][a], st["profiles"][b]
            if pa.ncols == 0:
                merged = _Profile(
                    pa.members + pb.members,
                    np.concatenate(
                        [np.zeros((len(pa.members), pb.ncols), np.int32), pb.c2p]
                    ),
                )
            else:
                merged = _Profile(
                    pa.members + pb.members,
                    np.concatenate(
                        [pa.c2p, np.zeros((len(pb.members), pa.ncols), np.int32)]
                    ),
                )
            st["profiles"][st["node_of_merge"][k]] = merged
            del st["profiles"][a], st["profiles"][b]
            st["todo"].remove(k)
        pending = [gi for gi in pending if state[gi]["todo"]]

    with profiler("msa.reconstruct"):
        _reconstruct(state, active, by_group, codes, decode, results)


def _reconstruct(state, active, by_group, codes, decode, results):
    for gi in active:
        st = state[gi]
        idx = by_group[gi]
        g = idx.size
        final_id = (
            st["node_of_merge"][len(st["merges"]) - 1]
            if st["merges"]
            else 0
        )
        final = st["profiles"][final_id]
        inv = np.empty(g, np.int64)
        inv[np.asarray(final.members)] = np.arange(g)
        c2p = final.c2p[inv]  # [g, ncols] in member order
        seqs = codes[idx]  # [g, L]
        rows = np.full(c2p.shape, 5, dtype=np.int8)
        nz = c2p > 0
        rows[nz] = seqs[np.nonzero(nz)[0], (c2p - 1)[nz]]
        chars = decode[rows]
        results[gi] = [chars[m].tobytes().decode() for m in range(g)]
    return results


@profiled("multi_read_align")
def multi_read_align(
    reads: SeqBatch,
    groups=None,
    max_error: float | None = None,
    match: float = 0,
    mismatch: float = -1,
    gap_opening: float = 5,
    gap_extension: float = 1,
    bandwidth: int = 100,
    keep_mask: bool = False,
    qual_type: str = "phred",
    device=None,
    mesh=None,
) -> Frame:
    """MSA per read group; returns Frame(alignments=List, qualities=List).

    ``device=None`` means CUDA.  The library is built on the device unless
    ``SARLACC_HOST_LIB`` is set in the environment or a segment is too large
    for it (:func:`_device_lib_ok`), as in the JAX package.  A ``mesh``
    (BPPARAM analog, R/multiReadAlign.R:7) splits each kernel-B launch's
    pairs over its shards; segments, merge waves and the host work run as
    without it, on the first shard's device, so the results are the same.
    """
    dev = mesh_device(mesh, device)
    n = len(reads)
    by_group, names = _split_groups(n, groups)

    # Library rows store read positions in 16 bits; the reference accepts
    # arbitrary lengths (src/DNA_input.cpp:106-116), so guard the boundary
    # explicitly rather than wrapping silently on >32 kb reads.
    max_len = int(reads.lengths.max(initial=0))
    if max_len > MAX_MSA_READ_LEN:
        raise ValueError(
            f"multi_read_align supports reads up to {MAX_MSA_READ_LEN} bases "
            f"(got {max_len}); split longer reads or raise the int32 path"
        )

    use_mask = max_error is not None and not (
        isinstance(max_error, float) and np.isnan(max_error)
    )
    if use_mask:
        masked = quality_mask(reads, max_error, qual_type)
        codes = masked.codes
    else:
        codes = reads.codes
    lengths = reads.lengths

    with use_mesh(mesh):
        alignments = _msa_groups(
            codes,
            lengths,
            by_group,
            float(match),
            float(mismatch),
            float(gap_opening),
            float(gap_extension),
            int(bandwidth),
            dev,
        )
    if use_mask and not keep_mask:
        dec = np.frombuffer(b"ACGTN-", dtype=np.uint8)
        for gi, idx in enumerate(by_group):
            if not alignments[gi]:
                continue
            orig_strs = [
                dec[reads.codes[i, : int(lengths[i])]].tobytes().decode()
                for i in idx
            ]
            alignments[gi] = unmask_alignment(alignments[gi], orig_strs)

    out = Frame(nrow=len(by_group))
    out["alignments"] = alignments
    if reads.quals is not None:
        qstrs = reads.qual_strings()
        out["qualities"] = [[qstrs[int(i)] for i in idx] for idx in by_group]
    if names is not None:
        out.rownames = names
    return out

"""Kernel G (the template backtrack walks) on the CPU.

The plain versions ``_qmap_walk_plain`` and ``_string_walk_plain`` (which
``qmap_walk`` and ``string_walk`` run on CPU tensors) against the JAX
package's ``qmap_walk_device`` and ``string_walk_device`` in the plane
layout, on kernel A's directions (the Pallas kernel in interpret mode) and
on random planes that strand lanes until the step cap; and a numpy
transliteration of ``csrc/backtrack_kernel.cu``'s schedule (qmap a warp
at a time: the slab climb up the fitting column, then each lane's walk,
one fetch a fetching step; each lane walked to its end or to the plain
loop's cap of whole 8-step blocks) against the plain versions and JAX's,
on planes built to hit the schedule's edges (``torch_walk_planes.py``),
with its fetching steps counted and held equal to the plain walks' own
count.  Tolerance 0: positions and counts are integers.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from sarlacc_tpu.api.align_internal import prepare_adaptor as jax_prepare_adaptor  # noqa: E402
from sarlacc_tpu.core.encode import SeqBatch  # noqa: E402
from sarlacc_tpu.ops.align import prepare_reads as jax_prepare_reads  # noqa: E402
from sarlacc_tpu.ops.backtrack import qmap_walk_device, string_walk_device  # noqa: E402
from sarlacc_tpu.ops.pallas_align import fit_dirs_pallas  # noqa: E402
from sarlacc_tpu_torch.ops import backtrack, cuda_backtrack  # noqa: E402

import torch_walk_planes as walk_planes  # noqa: E402

ADAPTOR = "ACGCTAGCATCAGTCNNNNCACAGCTACGANNNNNNNNCGTACGCAT"
QUALITY_REF = "ACGTTGCAAGCTTACGGATCCATGCAAGTCCGATAGCTTGACA"


def _kernel_a_plane(ref, n, minl, maxl, local, seed):
    """Kernel A's directions [R, l1, n_pad] (the Pallas kernel, interpret
    mode) for ``n`` random reads of ``minl``-``maxl`` bases, and their
    lengths."""
    rng = np.random.default_rng(seed)
    seqs, quals = [], []
    for _ in range(n):
        ln = int(rng.integers(minl, maxl + 1))
        seqs.append("".join(rng.choice(list("ACGTN"), ln)))
        quals.append("".join(chr(int(c)) for c in rng.integers(35, 90, ln)))
    jad = jax_prepare_adaptor(ref)
    codes, qidx, lengths = jax_prepare_reads(SeqBatch.from_strings(seqs, quals), jad.tables)
    _, dirs, _ = fit_dirs_pallas(
        np.asarray(codes), np.asarray(qidx), np.asarray(lengths), jad.modes, jad.matched,
        jad.match_tab, jad.mismatch_tab, 5.0, 1.0, local=local, interpret=True,
    )
    return np.asarray(dirs), np.asarray(lengths, np.int32)


def _random_plane(R, l1, n_pad, n, seed, spread=3):
    """Directions drawn from [-spread, spread]: up-runs at row 0 and runs
    past the plane strand lanes, which then walk until the step cap."""
    rng = np.random.default_rng(seed)
    dirs = rng.integers(-spread, spread + 1, (R, l1, n_pad)).astype(np.int16)
    lengths = rng.integers(0, l1, n).astype(np.int32)
    lengths[: min(n, 3)] = 0  # length-0 reads
    return dirs, lengths


_cap = walk_planes.cap


#: csrc/backtrack_kernel.cu's schedule: a warp's lanes and the rows a slab
#: holds.
WARP, SLAB = 32, 32


class _Plane:
    """The plane as the kernel reads it: ``at`` is the plain gather's cell
    (flat index clamped), ``raw`` a cell of plane column c - 1 unclamped."""

    def __init__(self, dirs):
        self.R, self.l1, self.n_pad = dirs.shape
        self.flat = dirs.reshape(-1).astype(np.int64)

    def at(self, col, row, n):
        idx = min(max((col - 1) * self.l1 + row, 0), self.R * self.l1 - 1)
        return int(self.flat[idx * self.n_pad + n])

    def raw(self, col, row, n):
        return int(self.flat[((col - 1) * self.l1 + row) * self.n_pad + n])


def _fetch(plane, col, row, n, cnt):
    """The kernel's ``fetch``: the plain gather's cell, one round trip."""
    cnt["rounds"] += 1
    return plane.at(col, row, n)


def _count(cnt, key, k=1):
    cnt[key] += k
    if key != "rounds" and key != "fetches":
        cnt["fetches"] += k


def _totals(lanes):
    """The launch's counters from each lane's: ``rounds`` the maximum, the
    others the sum."""
    out = dict.fromkeys(cuda_backtrack.COUNTS, 0)
    for cnt in lanes:
        for k, v in cnt.items():
            out[k] = max(out[k], v) if k == "rounds" else out[k] + v
    return out


def _qmap_warps(dirs, lengths, slab=SLAB):
    """csrc/backtrack_kernel.cu's qmap_kernel, a warp of 32 lanes at a time:
    the steps in column R from slabs (rows [hi - slab + 1, hi] of plane
    column R - 1 below the highest climbing row, clamped to l1 - 1) -- the
    climb, then the step that leaves the column -- then each lane's walk,
    one fetch a fetching step; each column stored as the walk leaves it,
    the columns it never left zeroed at its end.  Returns (is_match,
    dp_row, steps walked a lane, counters, stats: ``carried`` climbs that
    went on into a later slab, ``capped_climbs``)."""
    p = _Plane(dirs)
    R, l1, n_pad = dirs.shape
    om = np.full((n_pad, R + 1), 7, np.int64)  # not zeroed: every cell is written
    orow = np.full((n_pad, R + 1), -7, np.int64)
    walked = np.zeros(n_pad, np.int64)
    steps = _cap(R + l1 + 4)
    counts, stats = [], {"carried": 0, "capped_climbs": 0}
    for n0 in range(0, n_pad, WARP):
        lanes = range(n0, min(n0 + WARP, n_pad))
        st = {n: dict(col=R, row=int(lengths[n]) if n < len(lengths) else 0, rc=0, it=0)
              for n in lanes}
        cnt = {n: dict.fromkeys(cuda_backtrack.COUNTS, 0) for n in lanes}
        climbing = {n: R > 0 and st[n]["row"] > 0 for n in lanes}
        while any(climbing.values()):
            hi = max(min(st[n]["row"], l1 - 1) for n in lanes if climbing[n])
            lo = max(0, hi - slab + 1)
            rows = {n: [p.raw(R, r, n) for r in range(lo, hi + 1)] for n in lanes}
            for n in lanes:
                s, c = st[n], cnt[n]
                if not climbing[n]:
                    continue
                c["rounds"] += 1
                stepped = False
                while climbing[n] and s["it"] < steps and s["row"] >= lo:
                    d = rows[n][min(s["row"], l1 - 1) - lo]
                    s["it"] += 1
                    stepped = True
                    if s["row"] > 0 and d < 0:
                        _count(c, "up_last")
                        s["row"] += d
                        climbing[n] = s["row"] >= 0
                    elif d == 0:
                        _count(c, "diag")
                        om[n, R], orow[n, R] = True, s["row"]
                        s["col"], s["row"] = R - 1, s["row"] - 1
                        climbing[n] = False
                    elif d > 0:
                        _count(c, "left")
                        om[n, R], orow[n, R] = False, s["row"] + 1
                        s["col"], s["rc"] = R - 1, d - 1
                        climbing[n] = False
                    else:  # row 0, d < 0: nothing moves
                        _count(c, "other")
                if climbing[n] and s["it"] >= steps:
                    climbing[n] = False
                    stats["capped_climbs"] += 1
                stats["carried"] += climbing[n] and stepped
        for n in lanes:
            s, c = st[n], cnt[n]
            col, r, rc, it = s["col"], s["row"], s["rc"], s["it"]
            while it < steps and col > 0:
                it += 1
                if rc > 0:
                    om[n, col], orow[n, col] = False, r + 1
                    col, rc = col - 1, rc - 1
                    continue
                d = _fetch(p, col, r, n, c)
                if r > 0 and d < 0:
                    _count(c, "up_last" if col == R else "up_inner")
                    r += d
                elif d == 0:
                    _count(c, "diag")
                    om[n, col], orow[n, col] = True, r
                    col, r = col - 1, r - 1
                elif d > 0:
                    _count(c, "left")
                    om[n, col], orow[n, col] = False, r + 1
                    col, rc = col - 1, d - 1
                else:  # nothing moves: the next step fetches this cell again
                    _count(c, "other")
            walked[n] = it
            om[n, : col + 1], orow[n, : col + 1] = False, 0  # the columns it never left
        counts += cnt.values()
    return om.astype(bool), orow.astype(np.int32), walked, _totals(counts), stats


def _string_warps(dirs, lengths):
    """csrc/backtrack_kernel.cu's string_kernel, one lane at a time: its
    steps, one fetch a fetching step, each emission stored as it is made, the
    columns past its count zeroed at its end.  Returns
    (a_pos, b_pos, ncols, counters, stats)."""
    p = _Plane(dirs)
    R, l1, n_pad = dirs.shape
    T = R + l1 + 1
    oa = np.full((n_pad, T), -7, np.int64)  # not zeroed: every cell is written
    ob = np.full((n_pad, T), -7, np.int64)
    ncols = np.full(n_pad, -7, np.int64)
    steps = _cap(T + 8)
    counts, stats = [], {"stuck": 0}
    for n in range(n_pad):
        c = dict.fromkeys(cuda_backtrack.COUNTS, 0)
        col, row = R, int(lengths[n]) if n < len(lengths) else 0
        rc = uc = t = 0
        while t < steps and (col > 0 or row > 0):
            fresh = rc == 0 and uc == 0
            tailq = fresh and col == 0
            see_up = diag = newl = False
            if fresh and not tailq:
                d = _fetch(p, col, row, n, c)
                see_up = row > 0 and d < 0
                diag = not see_up and d == 0
                newl = not see_up and d > 0
                if see_up:
                    _count(c, "up_last" if col == R else "up_inner")
                    uc = -d
                elif newl:
                    _count(c, "left")
                    rc = d
                elif diag:
                    _count(c, "diag")
                else:  # emits (0, 0); the next step fetches this cell again
                    _count(c, "other")
            emit_up = uc > 0 and not diag and not newl and not tailq
            emit_left = rc > 0 and not emit_up and not diag and not tailq
            step_q = emit_up or tailq or diag
            step_r = emit_left or diag
            if t < T:
                oa[n, t] = col if step_r else 0
                ob[n, t] = row if step_q else 0
            row -= step_q
            col -= step_r
            uc -= emit_up
            rc -= emit_left
            t += 1
        oa[n, t:] = 0
        ob[n, t:] = 0
        ncols[n] = t
        stats["stuck"] += c["other"] > 0
        counts.append(c)
    return (oa.astype(np.int32), ob.astype(np.int32), ncols.astype(np.int32), _totals(counts),
            stats)


def _port_qmap(dirs, lengths):
    om, orow = backtrack.qmap_walk(torch.tensor(dirs), torch.tensor(lengths))
    return om.numpy(), orow.numpy()


def _port_string(dirs, lengths):
    return tuple(x.numpy() for x in backtrack.string_walk(torch.tensor(dirs), torch.tensor(lengths)))


@pytest.mark.parametrize("ref,local,seed", [
    (ADAPTOR, True, 1), (ADAPTOR, False, 2), (QUALITY_REF, False, 3), ("A", False, 4),
])
def test_string_walk_matches_jax_device_walk(ref, local, seed):
    dirs, lengths = _kernel_a_plane(ref, 21, 0, 60, local, seed)
    wa, wb, wn = string_walk_device(dirs, lengths, plane_layout=True)
    a, b, n = _port_string(dirs, lengths)
    np.testing.assert_array_equal(a, np.asarray(wa))
    np.testing.assert_array_equal(b, np.asarray(wb))
    np.testing.assert_array_equal(n, np.asarray(wn))
    got = _string_warps(dirs, lengths)[:3]
    for x, y in zip(got, (a, b, n)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["short_lengths", "zero_lengths", "R1"])
def test_qmap_walk_edge_cases_match_jax(case):
    """n_pad > n (lanes past the lengths walk from row 0), reads of length
    0, and a one-base reference."""
    ref = "A" if case == "R1" else ADAPTOR
    dirs, lengths = _kernel_a_plane(ref, 13, 0, 40, True, 11)
    if case == "short_lengths":
        lengths = lengths[:5]
    elif case == "zero_lengths":
        lengths = np.where(np.arange(lengths.size) % 2, lengths, 0).astype(np.int32)
    assert dirs.shape[2] > lengths.size
    wm, wr = qmap_walk_device(dirs, lengths, plane_layout=True)
    om, orow = _port_qmap(dirs, lengths)
    np.testing.assert_array_equal(om, np.asarray(wm))
    np.testing.assert_array_equal(orow, np.asarray(wr))
    got = _qmap_warps(dirs, lengths)[:3]
    np.testing.assert_array_equal(got[0], om)
    np.testing.assert_array_equal(got[1], orow)


@pytest.mark.parametrize("R,l1,n_pad,n,seed", [(7, 9, 40, 33, 0), (1, 5, 16, 16, 1),
                                               (30, 12, 24, 20, 2)])
def test_walks_on_malformed_planes_stop_at_the_cap(R, l1, n_pad, n, seed):
    """Random planes: stranded lanes walk until the plain loop's step cap,
    in the plain versions, in JAX and in the transliteration alike."""
    dirs, lengths = _random_plane(R, l1, n_pad, n, seed)
    wm, wr = qmap_walk_device(dirs, lengths, plane_layout=True)
    om, orow = _port_qmap(dirs, lengths)
    np.testing.assert_array_equal(om, np.asarray(wm))
    np.testing.assert_array_equal(orow, np.asarray(wr))
    tm, trow, walked = _qmap_warps(dirs, lengths)[:3]
    np.testing.assert_array_equal(tm, om)
    np.testing.assert_array_equal(trow, orow)
    assert walked.max() == _cap(R + l1 + 4)  # some lane hit the cap

    wa, wb, wn = string_walk_device(dirs, lengths, plane_layout=True)
    a, b, nc = _port_string(dirs, lengths)
    np.testing.assert_array_equal(a, np.asarray(wa))
    np.testing.assert_array_equal(b, np.asarray(wb))
    np.testing.assert_array_equal(nc, np.asarray(wn))
    got = _string_warps(dirs, lengths)[:3]
    for x, y in zip(got, (a, b, nc)):
        np.testing.assert_array_equal(x, y)
    assert nc.max() == _cap(R + l1 + 1 + 8)  # a stranded lane emits until the cap


@pytest.mark.parametrize("plane,slab", [
    ("climb", 4), ("climb", SLAB), ("runs", 4), ("runs", SLAB),
    ("clamped", 4), ("clamped", SLAB), ("clamped_R1", SLAB), ("all_up", 4), ("all_up", SLAB),
])
def test_walk_schedule_on_adversarial_planes(plane, slab):
    """The kernel's schedule (the slab climb, one fetch a fetching step
    off the column, qmap's columns never left and the string walk's tail
    zeroed at the end, the step cap) transliterated, at the kernel's slab
    and at a small one that puts every slab edge inside a small plane,
    against the plain walks and JAX's: outputs bit-equal, and the
    transliteration's fetching steps, in all and by kind, equal to the
    plain walks' own count."""
    dirs, lengths = walk_planes.adversarial_plane(plane)
    R, l1, _ = dirs.shape

    plain = {}
    om, orow = (x.numpy() for x in backtrack._qmap_walk_plain(
        torch.tensor(dirs), torch.tensor(lengths), counts=plain))
    wm, wr = qmap_walk_device(dirs, lengths, plane_layout=True)
    np.testing.assert_array_equal(om, np.asarray(wm))
    np.testing.assert_array_equal(orow, np.asarray(wr))
    tm, trow, walked, counts, stats = _qmap_warps(dirs, lengths, slab)
    np.testing.assert_array_equal(tm, om)
    np.testing.assert_array_equal(trow, orow)
    assert {k: counts[k] for k in plain} == plain
    assert plain["fetches"] == sum(plain[k] for k in ("up_last", "up_inner", "diag", "left",
                                                      "other"))

    splain = {}
    got = backtrack._string_walk_plain(torch.tensor(dirs), torch.tensor(lengths), counts=splain)
    a, b, nc = (x.numpy() for x in got)
    for x, y in zip((a, b, nc), string_walk_device(dirs, lengths, plane_layout=True)):
        np.testing.assert_array_equal(x, np.asarray(y))
    ta, tb, tn, scounts, sstats = _string_warps(dirs, lengths)
    for x, y in zip((ta, tb, tn), (a, b, nc)):
        np.testing.assert_array_equal(x, y)
    assert {k: scounts[k] for k in splain} == splain

    # Each plane reaches the edge it was built for.
    if plane == "climb":
        assert stats["carried"] > 0 and plain["up_last"] > 4 * len(lengths)
    elif plane == "runs":
        assert plain["diag"] > walk_planes.RUN * len(lengths)
    elif plane.startswith("clamped"):
        assert (lengths >= l1).any() and plain["other"] > 0
    else:
        assert stats["capped_climbs"] > 0 and walked.max() == _cap(R + l1 + 4)
        assert sstats["stuck"] > 0 and nc.max() == _cap(R + l1 + 1 + 8)


def test_walk_wrappers_take_cuda_tensors_only():
    """On CPU tensors the walks run the plain versions; kernel G's wrappers
    raise and launch nothing."""
    dirs, lengths = _random_plane(3, 4, 8, 8, 5)
    before = (cuda_backtrack.QMAP_KERNEL.launches, cuda_backtrack.STRING_KERNEL.launches)
    d, ln = torch.tensor(dirs), torch.tensor(lengths)
    backtrack.qmap_walk(d, ln)
    backtrack.string_walk(d, ln)
    for fn in (cuda_backtrack.qmap_walk, cuda_backtrack.string_walk):
        with pytest.raises(ValueError, match="CUDA"):
            fn(d, ln)
    assert (cuda_backtrack.QMAP_KERNEL.launches, cuda_backtrack.STRING_KERNEL.launches) == before


def test_schedule_constants_match_the_kernel():
    """The transliteration's warp and slab are the kernel's."""
    source = open(cuda_backtrack.QMAP_KERNEL.source).read()
    for name, value in (("WALK_THREADS", WARP), ("SLAB_ROWS", SLAB)):
        assert f"constexpr int {name} = {value};" in source

"""Kernel G (the template backtrack walks) on the CPU.

The plain versions ``_qmap_walk_plain`` and ``_string_walk_plain`` (which
``qmap_walk`` and ``string_walk`` run on CPU tensors) against the JAX
package's ``qmap_walk_device`` and ``string_walk_device`` in the plane
layout, on kernel A's directions (the Pallas kernel in interpret mode) and
on random planes that strand lanes until the step cap; and a numpy
transliteration of ``csrc/backtrack_kernel.cu``'s per-thread loop (each
lane walked to its end or to the plain loop's cap of whole 8-step blocks)
against the plain versions.  Tolerance 0: positions are integers.
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


def _cap(limit):
    """Steps the plain loop runs at most: whole blocks of 8 below ``limit``."""
    return -(-limit // 8) * 8 if limit > 0 else 0


def _qmap_threads(dirs, lengths):
    """csrc/backtrack_kernel.cu's qmap_kernel, one lane at a time.  Returns
    (is_match, dp_row, steps walked a lane)."""
    R, l1, n_pad = dirs.shape
    flat = dirs.reshape(-1).astype(np.int64)
    om = np.zeros((n_pad, R + 1), bool)
    orow = np.zeros((n_pad, R + 1), np.int32)
    walked = np.zeros(n_pad, np.int64)
    steps = _cap(R + l1 + 4)
    for n in range(n_pad):
        col, row, rc = R, int(lengths[n]) if n < len(lengths) else 0, 0
        it = 0
        while it < steps and col > 0:
            it += 1
            if rc > 0:  # a left run's later cell: no fetch
                om[n, col], orow[n, col] = False, row + 1
                col, rc = col - 1, rc - 1
                continue
            idx = min(max((col - 1) * l1 + row, 0), R * l1 - 1)
            d = int(flat[idx * n_pad + n])
            up = row > 0 and d < 0
            diag = not up and d == 0
            left_new = not up and d > 0
            if diag or left_new:
                om[n, col] = diag
                orow[n, col] = row if diag else row + 1
                col -= 1
            row = row + d if up else (row - 1 if diag else row)
            rc = d - 1 if left_new else 0
        walked[n] = it
    return om, orow, walked


def _string_threads(dirs, lengths):
    """csrc/backtrack_kernel.cu's string_kernel, one lane at a time."""
    R, l1, n_pad = dirs.shape
    T = R + l1 + 1
    flat = dirs.reshape(-1).astype(np.int64)
    oa = np.zeros((n_pad, T), np.int32)
    ob = np.zeros((n_pad, T), np.int32)
    ncols = np.zeros(n_pad, np.int32)
    steps = _cap(T + 8)
    for n in range(n_pad):
        col, row = R, int(lengths[n]) if n < len(lengths) else 0
        rc = uc = t = 0
        it = 0
        while it < steps and (col > 0 or row > 0):
            fresh = rc == 0 and uc == 0
            tailq = fresh and col == 0
            see_up = diag = newl = False
            if fresh and not tailq:
                idx = min(max((col - 1) * l1 + row, 0), R * l1 - 1)
                d = int(flat[idx * n_pad + n])
                see_up = row > 0 and d < 0
                diag = not see_up and d == 0
                newl = not see_up and d > 0
                if see_up:
                    uc = -d
                if newl:
                    rc = d
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
            it += 1
        ncols[n] = t
    return oa, ob, ncols


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
    got = _string_threads(dirs, lengths)
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
    got = _qmap_threads(dirs, lengths)
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
    tm, trow, walked = _qmap_threads(dirs, lengths)
    np.testing.assert_array_equal(tm, om)
    np.testing.assert_array_equal(trow, orow)
    assert walked.max() == _cap(R + l1 + 4)  # some lane hit the cap

    wa, wb, wn = string_walk_device(dirs, lengths, plane_layout=True)
    a, b, nc = _port_string(dirs, lengths)
    np.testing.assert_array_equal(a, np.asarray(wa))
    np.testing.assert_array_equal(b, np.asarray(wb))
    np.testing.assert_array_equal(nc, np.asarray(wn))
    got = _string_threads(dirs, lengths)
    for x, y in zip(got, (a, b, nc)):
        np.testing.assert_array_equal(x, y)
    assert nc.max() == _cap(R + l1 + 1 + 8)  # a stranded lane emits until the cap


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

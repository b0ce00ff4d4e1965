"""Kernel H (the device library's consistency extension) on the CPU.

The plain version ``_extend_chunk_plain`` (which ``_extend_chunk_kernel``
runs on CPU tensors) against the JAX package's ``_extend_chunk_kernel`` on
the same numpy inputs, and a numpy transliteration of
``csrc/extend_kernel.cu``'s schedule (one lane a slot: runs found by
matching keys, the first of a run kept, its weights summed in slot order
from 0.0 one float32 add at a time; a counting pass, a scan of the pair
totals, a writing pass that scans each pair's item counts in 256-item
chunks) against the plain version.  Tolerance 0: entries, weights and
counts are integers.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from sarlacc_tpu.ops import msa as jax_ops_msa  # noqa: E402
from sarlacc_tpu_torch.ops import cuda_extend  # noqa: E402
from sarlacc_tpu_torch.ops import msa as port_ops_msa  # noqa: E402

DEAD = 1 << 20
THREADS = 256  # extend_kernel.cu's EXT_THREADS: eight warps a pair
SCAN_THREADS = 1024


def _chunk(seed, CP, SL, STR, strc, n_rows=14, positions=40):
    """A random arena (row 0 zeros, row 1 the identity, the others maps onto
    ``positions`` positions with zeros) and slot tables: some slots dead
    (the zero row, weight 0), the last pair a pad pair (zero rows and
    weights, counted into the spare slot ``CP``)."""
    rng = np.random.default_rng(seed)
    arena = np.where(rng.random((n_rows, STR)) < 0.25, 0,
                     rng.integers(1, positions, (n_rows, STR))).astype(np.int16)
    arena[0] = 0
    arena[1] = np.arange(STR)
    xz = rng.integers(2, n_rows, (CP, SL)).astype(np.int64)
    zy = rng.integers(1, n_rows, (CP, SL)).astype(np.int64)
    ws = (rng.random((CP, SL)) * 100).astype(np.float32)
    dead = rng.random((CP, SL)) < 0.2
    xz[dead], ws[dead] = 0, 0.0
    xz[-1], zy[-1], ws[-1] = 0, 0, 0.0
    pid = np.arange(CP, dtype=np.int64)
    pid[-1] = CP
    return arena, xz, zy, ws, pid


def _tree_flip(arena, xz, zy, ws, STR):
    """Pair 0's first four slots compose one map (every b reached four
    times) with weights 2.5, 2^-23, 2^-23, 2^-23, its other slots dead: in
    slot order each tiny add ties to even and the sum stays 2.5 (rounds to
    2); a pairwise tree sum is 2.5 + 2^-22 + 2^-23 (rounds to 3)."""
    arena[2] = np.where(np.arange(STR) % 3, 7, 0)
    xz[0, :4], zy[0, :4] = 2, 1
    ws[0, :4] = [2.5, 2.0 ** -23, 2.0 ** -23, 2.0 ** -23]
    xz[0, 4:], ws[0, 4:] = 0, 0.0
    f = np.float32
    seq = f(f(f(f(0) + ws[0, 0]) + ws[0, 1]) + ws[0, 2]) + ws[0, 3]
    tree = f(ws[0, 0] + ws[0, 1]) + f(ws[0, 2] + ws[0, 3])
    assert np.rint(seq) == 2 and np.rint(tree) == 3


def _plain(arena, xz, zy, ws, pid, scale, strc):
    counts = torch.zeros(xz.shape[0] + 1, dtype=torch.int64)
    rows = port_ops_msa._extend_chunk_kernel(
        torch.tensor(arena), torch.tensor(xz), torch.tensor(zy), torch.tensor(ws),
        torch.tensor(pid), counts, torch.tensor(np.float32(scale)), strc,
    )
    return rows.numpy(), counts.numpy()


def _jax(arena, xz, zy, ws, pid, scale, strc):
    CP, SL = xz.shape
    STR = arena.shape[1]
    M2 = strc * SL
    table, counts, _ = jax_ops_msa._extend_chunk_kernel(
        jnp.asarray(arena), jnp.asarray(arena[:, :strc]), xz.astype(np.int32),
        zy.astype(np.int32), ws, jnp.zeros((CP * M2, 3), jnp.uint16),
        jnp.zeros(CP + 1, jnp.int32), pid.astype(np.int32), jnp.int32(0), np.float32(scale),
        SL=SL, STR=STR, STRC=strc, TCAP=CP * M2,
    )
    table, counts = np.asarray(table).astype(np.int64), np.asarray(counts).astype(np.int64)
    rows = [table[p * M2 : p * M2 + counts[pid[p]]] for p in range(CP)]
    return np.concatenate(rows).astype(np.int32), counts


def _compose(arena, xz, zy, SL, p, a):
    """One warp at (p, a): each lane's key, run mask and kept flag."""
    STR = arena.shape[1]
    flat = arena.reshape(-1).astype(np.int64)
    key = np.full(32, DEAD, np.int64)
    for s in range(SL):
        k = int(flat[xz[p, s] * STR + a])
        b = int(flat[zy[p, s] * STR + k]) if k > 0 else 0
        key[s] = b if b > 0 else DEAD
    run = np.array([sum(1 << t for t in range(32) if key[t] == key[s]) for s in range(32)],
                   np.int64)
    first = (run & ((1 << np.arange(32)) - 1)) == 0
    kept = (key < DEAD) & first & (a > 0)
    return key, run, kept


def _schedule(arena, xz, zy, ws, pid, scale, strc):
    """csrc/extend_kernel.cu in numpy: pass 0, the scan, pass 1."""
    CP, SL = xz.shape
    f32 = np.float32
    counts = np.zeros(CP + 1, np.int64)
    cnt = np.zeros(CP * strc, np.int64)
    pair_tot = np.zeros(CP, np.int64)
    for p in range(CP):  # pass 0: one block a pair
        for a in range(strc):
            _, _, kept = _compose(arena, xz, zy, SL, p, a)
            cnt[p * strc + a] = int(kept.sum())
        pair_tot[p] = cnt[p * strc : (p + 1) * strc].sum()
        if pair_tot[p]:
            counts[pid[p]] += pair_tot[p]
    # The scan: per-thread sequential sums, an inclusive scan over threads.
    per = -(-CP // SCAN_THREADS)
    part = np.array([pair_tot[t * per : min(t * per + per, CP)].sum()
                     for t in range(SCAN_THREADS)], np.int64)
    incl = np.cumsum(part)
    off = np.zeros(CP + 1, np.int64)
    for t in range(SCAN_THREADS):
        run = incl[t] - part[t]
        for i in range(t * per, min(t * per + per, CP)):
            off[i] = run
            run += pair_tot[i]
    off[CP] = incl[-1]
    out = np.full((off[CP], 3), -1, np.int64)
    for p in range(CP):  # pass 1
        base = off[p]
        for chunk in range(0, strc, THREADS):
            c = np.zeros(THREADS, np.int64)
            m = min(THREADS, strc - chunk)
            c[:m] = cnt[p * strc + chunk : p * strc + chunk + m]
            inc = np.cumsum(c.reshape(8, 32), axis=1)  # the warps' shuffle scans
            warp_sum = inc[:, -1]
            before = np.concatenate([[0], np.cumsum(warp_sum)[:-1]])
            excl = (base + before[:, None] + inc - c.reshape(8, 32)).reshape(-1)
            for w in range(8):
                for k in range(32):
                    a = chunk + w * 32 + k
                    if a >= strc:
                        break
                    key, run, kept = _compose(arena, xz, zy, SL, p, a)
                    if not kept.any():
                        continue
                    for s in np.flatnonzero(kept):
                        wsum = f32(0.0)
                        below = 0
                        for t in range(SL):
                            if (run[s] >> t) & 1:
                                wsum = f32(wsum + ws[p, t])
                            below += int(kept[t] and key[t] < key[s])
                        out[excl[w * 32 + k] + below] = (a, key[s],
                                                         int(np.rint(f32(wsum * f32(scale)))))
            base += warp_sum.sum()
    return out.astype(np.int32), counts


@pytest.mark.parametrize("seed,CP,SL,STR,strc", [
    (0, 6, 6, 128, 128),
    (1, 5, 10, 512, 512),  # two 256-item chunks a pair
    (2, 4, 32, 256, 200),  # 32 slots, strc below the stride
])
def test_extend_plain_matches_jax(seed, CP, SL, STR, strc):
    arena, xz, zy, ws, pid = _chunk(seed, CP, SL, STR, strc)
    _tree_flip(arena, xz, zy, ws, STR)
    scale = np.float32(1.0 if seed == 0 else 0.37)
    rows, counts = _plain(arena, xz, zy, ws, pid, scale, strc)
    want_rows, want_counts = _jax(arena, xz, zy, ws, pid, scale, strc)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(rows, want_rows)
    assert counts[CP] == 0 and rows.shape[0] > 0  # the pad pair keeps nothing
    if seed == 0:  # the crafted run kept the slot-order sum
        pair0 = rows[: counts[0]]
        assert set(pair0[pair0[:, 1] == 7, 2].tolist()) == {2}


def test_extend_runs_of_32_equal_keys():
    """Every slot of every pair reaches one b at each A-position: runs of 32
    lanes, each summed in slot order."""
    CP, SL, STR = 3, 32, 128
    rng = np.random.default_rng(11)
    arena = np.zeros((4, STR), np.int16)
    arena[1] = np.arange(STR)
    arena[2] = np.where(rng.random(STR) < 0.8, rng.integers(1, 60, STR), 0)
    xz = np.full((CP, SL), 2, np.int64)
    zy = np.ones((CP, SL), np.int64)
    ws = (rng.random((CP, SL)) * 3).astype(np.float32) * np.float32(0.1)
    pid = np.asarray([2, 0, 1], np.int64)
    scale = np.float32(1000.0)
    rows, counts = _plain(arena, xz, zy, ws, pid, scale, STR)
    want_rows, want_counts = _jax(arena, xz, zy, ws, pid, scale, STR)
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(rows, want_rows)
    got, got_counts = _schedule(arena, xz, zy, ws, pid, scale, STR)
    np.testing.assert_array_equal(got, rows)
    np.testing.assert_array_equal(got_counts, counts)
    f = np.float32
    seq = f(0.0)
    for w in ws[0]:  # row 0 is chunk pair 0's first kept entry
        seq = f(seq + w)
    assert rows.shape[0] == 3 * counts[0] and rows[0, 2] == int(np.rint(f(seq * scale)))


@pytest.mark.parametrize("seed,CP,SL,STR,strc", [
    (3, 5, 6, 128, 128),
    (4, 3, 10, 512, 300),  # a ragged second chunk
])
def test_extend_schedule_matches_plain(seed, CP, SL, STR, strc):
    arena, xz, zy, ws, pid = _chunk(seed, CP, SL, STR, strc)
    _tree_flip(arena, xz, zy, ws, STR)
    scale = np.float32(0.73)
    rows, counts = _plain(arena, xz, zy, ws, pid, scale, strc)
    got, got_counts = _schedule(arena, xz, zy, ws, pid, scale, strc)
    np.testing.assert_array_equal(got_counts, counts)
    np.testing.assert_array_equal(got, rows)


def test_extend_wrapper_takes_cuda_tensors_only():
    """On CPU tensors ``_extend_chunk_kernel`` runs the plain version; the
    kernel's wrapper itself raises and launches nothing."""
    arena, xz, zy, ws, pid = _chunk(5, 3, 4, 128, 128)
    before = cuda_extend.EXTEND_KERNEL.launches
    args = (torch.tensor(arena), torch.tensor(xz), torch.tensor(zy), torch.tensor(ws),
            torch.tensor(pid), torch.zeros(4, dtype=torch.int64), torch.tensor(np.float32(1)), 128)
    port_ops_msa._extend_chunk_kernel(*args)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_extend.extend_chunk(*args)
    with pytest.raises(ValueError, match="slots"):
        cuda_extend.extend_chunk(args[0], *(torch.zeros((3, 33), dtype=t.dtype) for t in args[1:4]),
                                 *args[4:])
    assert cuda_extend.EXTEND_KERNEL.launches == before

"""Kernel H (the device library's consistency extension) on the CPU.

The chunk plain version ``_extend_chunk_plain`` against the JAX package's
``_extend_chunk_kernel`` on the same numpy inputs; kernel H's own inputs
(per-job and per-group tables, the float32 identities) turned into slot
tables by ``_slot_tables`` against the host loop that built them before
(slot order, dead slots, weights rounded as numpy rounds them); and a numpy
transliteration of ``csrc/extend_kernel.cu``'s schedule (each lane's slot
derived from the job tables; one lane a slot: runs found by matching keys,
the first of a run kept, its weights summed in slot order from 0.0 one
float32 add at a time; every chunk's counting pass, the block-wide scan of
all pair totals, every chunk's writing pass scanning each pair's byte
counts in 256-item tiles) against ``_extend_library_plain``.  Tolerance 0:
entries, weights and counts are integers.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from sarlacc_tpu.ops import msa as jax_ops_msa  # noqa: E402
from sarlacc_tpu_torch.api import msa as port_api_msa  # noqa: E402
from sarlacc_tpu_torch.ops import cuda_extend  # noqa: E402
from sarlacc_tpu_torch.ops import msa as port_ops_msa  # noqa: E402

DEAD = 1 << 20
THREADS = 256  # extend_kernel.cu's EXT_THREADS: eight warps a pair
SCAN_THREADS, SCAN_ITEMS = 1024, 4
f32, f64 = np.float32, np.float64


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
    seq = f32(f32(f32(f32(0) + ws[0, 0]) + ws[0, 1]) + ws[0, 2]) + ws[0, 3]
    tree = f32(ws[0, 0] + ws[0, 1]) + f32(ws[0, 2] + ws[0, 3])
    assert np.rint(seq) == 2 and np.rint(tree) == 3


def _plain(arena, xz, zy, ws, pid, scale, strc):
    counts = torch.zeros(xz.shape[0] + 1, dtype=torch.int64)
    rows = port_ops_msa._extend_chunk_plain(
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


def _host_slot_tables(sizes, fracs, chunk_jobs, SL):
    """The slot tables as ``_build_library_device`` built them on the host
    before kernel H took over: a dict of job ids, float64 identity
    matrices, and the triple loop over pairs, slots and middle sequences."""
    jobid, at = {}, 0
    idents = []
    for gi, g in enumerate(sizes):
        ident = np.ones((g, g))
        for x, y in zip(*np.triu_indices(g, k=1)):
            jobid[(gi, int(x), int(y))] = at
            ident[x, y] = ident[y, x] = f64(fracs[at])
            at += 1
        idents.append(ident)
    jobs = {v: k for k, v in jobid.items()}

    def dir_row(gi, u, v):
        return 2 + 2 * jobid[(gi, u, v)] if u < v else 3 + 2 * jobid[(gi, v, u)]

    xz = np.zeros((len(chunk_jobs), SL), np.int64)
    zy = np.zeros((len(chunk_jobs), SL), np.int64)
    ws = np.zeros((len(chunk_jobs), SL), np.float32)
    for r, j in enumerate(chunk_jobs):
        gi, x, y = jobs[int(j)]
        ident = idents[gi]
        xz[r, 0], zy[r, 0], ws[r, 0] = dir_row(gi, x, y), 1, ident[x, y] * 100.0
        s = 1
        for z in range(sizes[gi]):
            if z == x or z == y:
                continue
            xz[r, s], zy[r, s] = dir_row(gi, x, z), dir_row(gi, z, y)
            ws[r, s] = min(ident[x, z], ident[z, y]) * 100.0
            s += 1
    return xz, zy, ws


def _library(sizes, seed, fracs=None):
    """Kernel H's host tables for groups of ``sizes`` reads (as
    ``_build_library_device`` builds them) and random float32 identities."""
    by_group = []
    at = 0
    for g in sizes:
        by_group.append(np.arange(at, at + g))
        at += g
    jobs, first_job, _, _, sl = port_api_msa._library_jobs(by_group, list(range(len(sizes))))
    if fracs is None:
        rng = np.random.default_rng(seed)
        fracs = rng.random(jobs.shape[0]).astype(np.float32)
    return jobs, first_job, sl, fracs


@pytest.mark.parametrize("sizes,SL", [
    ([2, 2], 2),            # g = 2: slot 0 only, the dead slot of class 2
    ([5, 3, 7], 6),         # dead slots past each group's g - 1
    ([33], 32),             # the largest slot class, no dead slot
    ([11, 2, 33, 4], 32),   # every group of a 32-slot chunk
])
def test_slot_tables_match_the_host_loop(sizes, SL):
    """``_slot_tables`` (kernel H's slot derivation, as torch ops) builds
    bit for bit the rows and weights of the host's triple loop, in slot
    order, with dead slots (row 0, row 0, weight 0)."""
    jobs, first_job, _, fracs = _library(sizes, sum(sizes))
    jids = np.arange(jobs.shape[0])
    want = _host_slot_tables(sizes, fracs, jids, SL)
    got = port_ops_msa._slot_tables(
        torch.tensor(jobs, dtype=torch.int64), torch.tensor(first_job, dtype=torch.int64),
        torch.tensor(fracs), torch.tensor(jids), SL)
    for g_, w_, name in zip(got, want, ("xz", "zy", "ws")):
        np.testing.assert_array_equal(g_.numpy(), w_, err_msg=name)
    dead = jobs[:, 3:4] - 1 <= np.arange(SL)[None, :]
    assert (got[0].numpy()[dead] == 0).all() and (got[2].numpy()[dead] == 0).all()


def _rounding_edge_fracs(n, seed):
    """float32 identities whose exact product with 100 lies at a float32
    rounding edge: half of them exactly halfway between two float32 values
    (ties, which round to the even neighbour), the others one float64 step
    of the product's excess bits beside such a tie."""
    rng = np.random.default_rng(seed)
    ties, near = [], []
    while len(ties) < n // 2 or len(near) < n - n // 2:
        f = f32(rng.random())
        p = f64(f) * 100.0  # exact: 24 + 7 significant bits
        r = f64(f32(p))
        lo = r if r <= p else f64(np.nextafter(f32(r), f32(0)))
        hi = f64(np.nextafter(f32(lo), f32(np.inf)))
        if p - lo == hi - p and len(ties) < n // 2:
            ties.append(f)
        elif abs((p - lo) - (hi - p)) <= 2 * np.spacing(p) * 2 ** 8 and len(near) < n - n // 2:
            near.append(f)
    return np.asarray(ties + near, np.float32), len(ties)


def test_slot_weights_round_at_float32_edges():
    """Weights round as the host rounded them: float64 min(ident(x, z),
    ident(z, y)) times 100.0, then one rounding to float32, half to even,
    on identities whose products sit on or beside a float32 tie."""
    sizes = [6, 5]
    n = sum(g * (g - 1) // 2 for g in sizes)
    fracs, n_ties = _rounding_edge_fracs(n, 1)
    jobs, first_job, _, _ = _library(sizes, 0, fracs)
    jids = np.arange(n)
    _, _, want = _host_slot_tables(sizes, fracs, jids, 6)
    _, _, got = port_ops_msa._slot_tables(
        torch.tensor(jobs, dtype=torch.int64), torch.tensor(first_job, dtype=torch.int64),
        torch.tensor(fracs), torch.tensor(jids), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    slot0 = got.numpy()[:, 0]
    np.testing.assert_array_equal(slot0, (fracs.astype(np.float64) * 100.0).astype(np.float32))
    # Each tie went to the neighbour with an even last significand bit.
    assert ((slot0[:n_ties].view(np.int32) & 1) == 0).all()
    exact = fracs[:n_ties].astype(np.float64) * 100.0
    assert (slot0[:n_ties].astype(np.float64) != exact).all()


def _identity_arena(n_jobs, STR, rng):
    """Every pair's maps the identity on the first positions (every slot of
    a pair composes the same b at each A-position: runs of g - 1 lanes),
    zeros past a random length."""
    arena = np.zeros((2 + 2 * n_jobs, STR), np.int16)
    arena[1] = np.arange(STR)
    for r in range(2, arena.shape[0]):
        n = int(rng.integers(STR // 2, STR))
        arena[r, :n] = np.arange(n)
    return arena


def _random_arena(n_jobs, STR, rng, positions):
    arena = np.where(rng.random((2 + 2 * n_jobs, STR)) < 0.25, 0,
                     rng.integers(1, positions, (2 + 2 * n_jobs, STR))).astype(np.int16)
    arena[0] = 0
    arena[1] = np.arange(STR)
    return arena


def _lib_plain(arena, jobs, first_job, fracs, order, chunks, scale):
    rows, off = port_ops_msa._extend_library_plain(
        torch.tensor(arena), jobs, first_job, torch.tensor(fracs), order, chunks, scale)
    return rows.numpy(), off


def _lane_slot(jobs, first_job, fracs, job, lane):
    """extend_kernel.cu's load_slot: (first-hop row, second-hop row,
    weight, live) of lane ``lane`` for job ``job``."""
    grp, x, y, g = (int(v) for v in jobs[job])
    if lane >= g - 1:
        return 0, 0, f32(0.0), False
    if lane == 0:
        return 2 + 2 * job, 1, f32(f64(fracs[job]) * 100.0), True
    z = lane - 1
    z += z >= x
    z += z >= y

    def map_row(u, v):
        lo, hi = min(u, v), max(u, v)
        jid = int(first_job[grp]) + lo * g - lo * (lo + 1) // 2 + hi - lo - 1
        return 2 + 2 * jid + (u > v)

    rxz, rzy = map_row(x, z), map_row(z, y)
    ixz, izy = f64(fracs[(rxz - 2) // 2]), f64(fracs[(rzy - 2) // 2])
    return rxz, rzy, f32((izy if izy < ixz else ixz) * 100.0), True


def _compose(arena, slots, strc):
    """One warp at each A-position a < ``strc``: each lane's key, run mask
    (the lanes holding its key) and kept flag, [strc, 32] each."""
    xz = np.asarray([sl[0] for sl in slots])
    zy = np.asarray([sl[1] for sl in slots])
    live = np.asarray([sl[3] for sl in slots])
    k = arena[xz, :strc].astype(np.int64)  # [32, strc]
    b = np.where(k > 0, arena[zy[:, None], k].astype(np.int64), 0)
    key = np.where(live[:, None] & (b > 0), b, DEAD).T  # [strc, 32]
    bits = (1 << np.arange(32)).astype(np.int64)
    run = ((key[:, :, None] == key[:, None, :]) * bits).sum(axis=2)
    first = (run & (bits - 1)) == 0
    kept = (key < DEAD) & first & (np.arange(strc) > 0)[:, None]
    return key, run, kept


def _scan(pair_tot):
    """Pass 2: tiles of 1 024 threads x 4 consecutive totals, each thread's
    sum scanned across the block, the tiles carried in order; the total
    last."""
    J = pair_tot.shape[0]
    off = np.zeros(J + 1, np.int64)
    carry = 0
    for t0 in range(0, J, SCAN_THREADS * SCAN_ITEMS):
        v = np.zeros(SCAN_THREADS * SCAN_ITEMS, np.int64)
        m = min(J - t0, v.size)
        v[:m] = pair_tot[t0 : t0 + m]
        per = v.reshape(SCAN_THREADS, SCAN_ITEMS)
        below = np.cumsum(per.sum(axis=1)) - per.sum(axis=1)
        off[t0 : t0 + m] = (carry + below[:, None] + np.cumsum(per, axis=1) - per).reshape(-1)[:m]
        carry += v.sum()
    off[J] = carry
    return off


def _schedule(arena, jobs, first_job, fracs, order, chunks, scale):
    """csrc/extend_kernel.cu in numpy: every chunk's pass 0, the pass-2
    scan, every chunk's pass 1."""
    J = order.shape[0]
    comp, ws = {}, {}
    pair_tot = np.zeros(J, np.int64)
    cnt = {}
    for q0, q1, SL, strc in chunks:  # pass 0: one block a pair
        for q in range(q0, q1):
            slots = [_lane_slot(jobs, first_job, fracs, int(order[q]), s) for s in range(32)]
            ws[q] = [sl[2] for sl in slots]
            comp[q] = _compose(arena, slots, strc)
            cnt[q] = comp[q][2].sum(axis=1)
            assert cnt[q].max(initial=0) <= 32  # one byte
            pair_tot[q] = cnt[q].sum()
    off = _scan(pair_tot)
    out = np.full((off[J], 3), -1, np.int64)
    for q0, q1, SL, strc in chunks:  # pass 1
        for q in range(q0, q1):
            base = 0
            keys, runs, kepts = comp[q]
            for tile in range(0, strc, THREADS):
                c = np.zeros(THREADS, np.int64)
                m = min(THREADS, strc - tile)
                c[:m] = cnt[q][tile : tile + m]
                inc = np.cumsum(c.reshape(8, 32), axis=1)  # the warps' shuffle scans
                warp_sum = inc[:, -1]
                before = np.concatenate([[0], np.cumsum(warp_sum)[:-1]])
                excl = (base + before[:, None] + inc - c.reshape(8, 32)).reshape(-1)
                for i in np.flatnonzero(c):  # items that keep something
                    a = tile + i
                    key, run, kept = keys[a], runs[a], kepts[a]
                    for s in np.flatnonzero(kept):
                        wsum = f32(0.0)
                        for t in range(SL):  # the run's weights in slot order
                            if (run[s] >> t) & 1:
                                wsum = f32(wsum + ws[q][t])
                        below = int((kept[:SL] & (key[:SL] < key[s])).sum())
                        out[off[q] + excl[i] + below] = (
                            a, key[s], int(np.rint(f32(wsum * f32(scale)))))
                base += warp_sum.sum()
    return out.astype(np.int32), off


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
    """A group of 33 reads whose maps are all the identity: every slot of a
    pair reaches one b at each A-position, runs of 32 lanes, each summed in
    slot order; kernel H's plain version and schedule equal JAX's
    extension fed the host's slot tables."""
    STR = 128
    rng = np.random.default_rng(11)
    jobs, first_job, _, fracs = _library([33], 0)
    fracs = (rng.random(fracs.size) * 3).astype(np.float32) * np.float32(0.1)
    J = jobs.shape[0]
    arena = _identity_arena(J, STR, rng)
    order = np.arange(3, dtype=np.int32)  # three pairs, one chunk
    chunks = [(0, 3, 32, STR)]
    scale = np.float32(60.0)  # 32 weights of at most 30: within JAX's uint16 table
    rows, off = _lib_plain(arena, jobs, first_job, fracs, order, chunks, scale)
    xz, zy, ws = _host_slot_tables([33], fracs, order, 32)
    want_rows, want_counts = _jax(arena, xz, zy, ws, order.astype(np.int64), scale, STR)
    np.testing.assert_array_equal(np.diff(off), want_counts[:3])
    np.testing.assert_array_equal(rows, want_rows)
    got, got_off = _schedule(arena, jobs, first_job, fracs, order, chunks, scale)
    np.testing.assert_array_equal(got_off, off)
    np.testing.assert_array_equal(got, rows)
    seq = f32(0.0)
    for w in ws[0]:  # row 0 is pair 0's first kept entry: all 32 slots
        seq = f32(seq + w)
    assert rows[0, 2] == int(np.rint(f32(seq * scale)))
    assert (rows[: off[1], 0] == rows[: off[1], 1]).all()  # b = a through every slot


@pytest.mark.parametrize("sizes,STR,positions", [
    ([5, 3, 7, 2], 128, 40),
    ([4, 11, 6], 512, 300),  # strc 512 and 300: two 256-item tiles, a ragged one
])
def test_extend_schedule_matches_plain(sizes, STR, positions):
    """Kernel H's schedule, every chunk of a build (chunk order, slot
    classes and A-positions as ``_library_chunks`` cuts them, one chunk
    limit forced down to 3 pairs) against the plain version."""
    rng = np.random.default_rng(STR + len(sizes))
    jobs, first_job, sl, fracs = _library(sizes, STR)
    J = jobs.shape[0]
    arena = _random_arena(J, STR, rng, positions)
    strc = np.where(np.arange(J) % 3 == 0, STR, min(STR, 300)).astype(np.int64)
    order, chunks = port_api_msa._library_chunks(sl, strc)
    chunks = [(q, min(q + 3, q1), s, w) for q0, q1, s, w in chunks for q in range(q0, q1, 3)]
    scale = np.float32(0.73)
    rows, off = _lib_plain(arena, jobs, first_job, fracs, order, chunks, scale)
    got, got_off = _schedule(arena, jobs, first_job, fracs, order, chunks, scale)
    np.testing.assert_array_equal(got_off, off)
    np.testing.assert_array_equal(got, rows)
    assert rows.shape[0] > 0


def test_extend_scan_carries_across_tiles():
    """The pass-2 scan over more pair totals than one 4 096-item tile."""
    rng = np.random.default_rng(2)
    tot = rng.integers(0, 500, 10_000)
    np.testing.assert_array_equal(_scan(tot), np.concatenate([[0], np.cumsum(tot)]))


def test_library_chunks_follow_the_host_classes():
    """``_library_chunks`` orders the jobs as the host's class dict did:
    classes by (SL, strc) ascending, each in job order, cut into chunks of
    min(1 024, 2^24 / (SL strc)) pairs."""
    rng = np.random.default_rng(4)
    sl = rng.choice([2, 6, 10, 32], 3000)
    strc = rng.choice([128, 256, 1024], 3000)
    order, chunks = port_api_msa._library_chunks(sl, strc)
    classes = {}
    for j in range(3000):
        classes.setdefault((int(sl[j]), int(strc[j])), []).append(j)
    want_order, want_chunks, at = [], [], 0
    for s, w in sorted(classes):
        prs = classes[(s, w)]
        cp = min(1024, max(1, port_ops_msa.EXTEND_CHUNK_ELEMS // (s * w)))
        for c0 in range(0, len(prs), cp):
            part = prs[c0 : c0 + cp]
            want_chunks.append((at, at + len(part), s, w))
            want_order += part
            at += len(part)
    assert order.tolist() == want_order and chunks == want_chunks


def test_extend_wrapper_takes_cuda_tensors_only():
    """On CPU tensors ``_extend_library`` runs the plain version; the
    kernel's wrapper itself raises and launches nothing, as it does on a
    chunk whose groups outgrow its slot class."""
    rng = np.random.default_rng(5)
    jobs, first_job, sl, fracs = _library([4, 3], 0)
    arena = torch.tensor(_random_arena(jobs.shape[0], 128, rng, 40))
    order = np.arange(jobs.shape[0], dtype=np.int32)
    args = (arena, jobs, first_job, torch.tensor(fracs), order, [(0, 9, 4, 128)],
            np.float32(1.0))
    before = cuda_extend.EXTEND_KERNEL.launches
    rows, off = port_ops_msa._extend_library(*args)
    assert rows.shape[0] == off[-1] > 0
    with pytest.raises(ValueError, match="CUDA"):
        cuda_extend.extend_library(*args)
    with pytest.raises(ValueError, match="groups of 3-4 reads"):
        cuda_extend.extend_library(*args[:5], [(0, 9, 2, 128)], args[6])
    with pytest.raises(ValueError, match="cover"):
        port_ops_msa._extend_library(*args[:5], [(0, 8, 4, 128)], args[6])
    assert cuda_extend.EXTEND_KERNEL.launches == before

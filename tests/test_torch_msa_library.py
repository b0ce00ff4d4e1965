"""PyTorch port, MSA device library: parity with the JAX package's default
route on the CPU.

Each device-library step against its JAX counterpart on the same numpy
inputs (identity, arena placement, consistency extension), the whole
library against ``_build_library_device``, the size guard and the route it
picks, and ``multi_read_align``'s default route against JAX's on the
workload where JAX's two routes differ (the port's host route differs
there too, which is the fault this route closes).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from sarlacc_tpu.api import msa as jax_api_msa  # noqa: E402
from sarlacc_tpu.api.msa import multi_read_align as jax_multi_read_align  # noqa: E402
from sarlacc_tpu.core.encode import SeqBatch as JSeqBatch  # noqa: E402
from sarlacc_tpu.ops import msa as jax_ops_msa  # noqa: E402
from sarlacc_tpu_torch.api import msa as port_api_msa  # noqa: E402
from sarlacc_tpu_torch.api.msa import multi_read_align  # noqa: E402
from sarlacc_tpu_torch.core.encode import SeqBatch  # noqa: E402
from sarlacc_tpu_torch.ops import msa as port_ops_msa  # noqa: E402
from test_torch_msa import noisy_copies  # noqa: E402

CPU = torch.device("cpu")


def _monotone_jmat(rng, rows, P, lens_a, lens_b):
    """[rows, P] walk-shaped jmats: per pair, A-positions <= lens_a matched
    to strictly increasing B-positions <= lens_b (0 = unmatched)."""
    jm = np.zeros((rows, P), np.int32)
    for p in range(P):
        n = int(min(lens_a[p], lens_b[p]))
        k = int(rng.integers(0, n + 1))
        a = np.sort(rng.choice(np.arange(1, lens_a[p] + 1), k, replace=False))
        b = np.sort(rng.choice(np.arange(1, lens_b[p] + 1), k, replace=False))
        jm[a - 1, p] = b
    return jm


def test_pair_ident_kernel_matches_jax():
    rng = np.random.default_rng(1)
    rows, P, L = 128, 40, 140
    lens_a = rng.integers(1, rows + 1, P)
    lens_b = rng.integers(1, L + 1, P)
    jm = _monotone_jmat(rng, rows, P, lens_a, lens_b)
    jm[:, 0] = 0  # a pair with no match: identity 0
    ca = rng.integers(0, 5, (P, rows)).astype(np.int8)
    cb = rng.integers(0, 5, (P, L)).astype(np.int8)
    cb[:, :rows] = np.where(rng.random((P, rows)) < 0.7, ca, cb[:, :rows])
    want = np.asarray(jax_ops_msa._pair_ident_kernel(
        jnp.asarray(jm.astype(np.int16)), jnp.asarray(ca, jnp.int32), jnp.asarray(cb, jnp.int32)
    ))
    got = port_ops_msa._pair_ident_kernel(
        torch.tensor(jm), torch.tensor(ca), torch.tensor(cb)
    ).numpy()
    assert want.dtype == got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0


def test_arena_place_kernel_matches_jax():
    rng = np.random.default_rng(2)
    rows, Pb, stride, row0 = 128, 24, 256, 6
    lens_a = rng.integers(1, rows + 1, Pb)
    lens_b = rng.integers(1, stride, Pb)
    jm = _monotone_jmat(rng, rows, Pb, lens_a, lens_b)
    R = row0 + 2 * Pb + 4
    base = np.zeros((R, stride), np.int16)
    base[1] = np.arange(stride)
    want = np.asarray(jax_ops_msa._arena_place_kernel(
        jnp.asarray(base), jnp.asarray(jm.astype(np.int16)), np.int32(row0), rows=rows
    ))
    arena = torch.tensor(base)
    port_ops_msa._arena_place_kernel(arena, torch.tensor(jm), torch.tensor(row0 + 2 * np.arange(Pb)))
    np.testing.assert_array_equal(arena.numpy(), want)


def _group_reads(rng, sizes, length):
    seqs, groups = [], []
    for n in sizes:
        ref = "".join(rng.choice(list("ACGT"), length))
        groups.append(np.arange(len(seqs), len(seqs) + n))
        seqs += noisy_copies(rng, ref, n, sub=0.08, indel=0.04)
    return SeqBatch.from_strings(seqs), groups


def _chunk_inputs(idx, arena_and_fracs):
    """xz / zy / slot weights of every pair of one group (as
    ``_build_library_device`` builds them), plus one pad pair."""
    arena, fracs = arena_and_fracs
    g = idx.size
    pairs = [(int(x), int(y)) for x, y in zip(*np.triu_indices(g, k=1))]
    jid = {p: i for i, p in enumerate(pairs)}
    ident = np.ones((g, g))
    for (x, y), i in jid.items():
        ident[x, y] = ident[y, x] = fracs[i]

    def row(u, v):
        return 2 + 2 * jid[(u, v)] if u < v else 3 + 2 * jid[(v, u)]

    sl = g - 1
    CP = len(pairs) + 1  # the last row is a pad pair
    xz = np.zeros((CP, sl), np.int32)
    zy = np.zeros((CP, sl), np.int32)
    ws = np.zeros((CP, sl), np.float32)
    pid = np.full(CP, len(pairs), np.int32)
    for r, (x, y) in enumerate(pairs):
        pid[r] = jid[(x, y)]
        xz[r, 0], zy[r, 0], ws[r, 0] = row(x, y), 1, ident[x, y] * 100.0
        s = 1
        for z in range(g):
            if z not in (x, y):
                xz[r, s], zy[r, s] = row(x, z), row(z, y)
                ws[r, s] = min(ident[x, z], ident[z, y]) * 100.0
                s += 1
    return xz, zy, ws, pid


def test_extend_chunk_kernel_matches_jax():
    rng = np.random.default_rng(3)
    batch, groups = _group_reads(rng, [5], 90)
    idx = groups[0]
    xs, ys = np.triu_indices(idx.size, k=1)
    arena, fracs, fracs_dev = port_ops_msa.pair_maps_device(
        batch.codes, batch.lengths, idx[xs], idx[ys], 0.0, -1.0, 5.0, 1.0, 20, CPU,
    )
    np.testing.assert_array_equal(fracs_dev.numpy().astype(np.float64), fracs)
    xz, zy, ws, pid = _chunk_inputs(idx, (arena, fracs))
    CP, SL = xz.shape
    STR = arena.shape[1]
    strc = STR
    w_scale = np.float32(65535.0 / (100.0 * (idx.size - 1) + 1.0))

    # The chunk composes one b through three or more slots somewhere.
    a_np = arena.numpy().astype(np.int64)
    XZ = a_np[:, :strc][xz]
    b = np.where(XZ > 0, a_np.reshape(-1)[zy[:, :, None] * STR + XZ], 0)
    reach = [np.unique(col[col > 0], return_counts=True)[1].max(initial=0)
             for col in b.transpose(0, 2, 1).reshape(-1, SL)]
    assert max(reach) >= 3

    M2 = strc * SL
    table, counts, _ = jax_ops_msa._extend_chunk_kernel(
        jnp.asarray(arena.numpy()), jnp.asarray(arena.numpy()[:, :strc]),
        xz, zy, ws, jnp.zeros((CP * M2, 3), jnp.uint16), jnp.zeros(CP + 1, jnp.int32),
        pid, jnp.int32(0), w_scale, SL=SL, STR=STR, STRC=strc, TCAP=CP * M2,
    )
    table, counts = np.asarray(table).astype(np.int64), np.asarray(counts)

    got_counts = torch.zeros(CP + 1, dtype=torch.int64)
    rows = port_ops_msa._extend_chunk_plain(
        arena, *(torch.tensor(a) for a in (xz.astype(np.int64), zy.astype(np.int64), ws,
                                           pid.astype(np.int64))),
        got_counts, torch.tensor(w_scale), strc,
    ).numpy()
    np.testing.assert_array_equal(got_counts.numpy(), counts)
    assert counts[CP - 1] == 0 and counts[-1] == 0  # the pad pair keeps nothing
    want = np.concatenate([table[p * M2 : p * M2 + counts[pid[p]]] for p in range(CP)])
    np.testing.assert_array_equal(rows, want)

    # Kernel H's plain version on its own inputs (the per-job tables and the
    # float32 identities, one chunk of the group's pairs) gives the same.
    jobs, first_job, _, _, _ = port_api_msa._library_jobs([idx], [0])
    P = jobs.shape[0]
    lib, off = port_ops_msa._extend_library_plain(
        arena, jobs, first_job, fracs_dev, np.arange(P, dtype=np.int32), [(0, P, SL, strc)],
        w_scale)
    np.testing.assert_array_equal(np.diff(off), counts[:P])
    np.testing.assert_array_equal(lib.numpy(), want)


def test_extend_chunk_kernel_matches_jax_on_synthetic_maps():
    """Maps with few distinct positions (every b reached through many slots)
    and non-zero column 0 (the a > 0 guard), random slot weights, and one
    pair whose three slots reach one b with weights 2.5, 2^-23, 2^-23: in
    slot order the float32 sum stays 2.5 (rounds to 2, half to even);
    added in any other order it is 2.5 + 2^-22 (rounds to 3)."""
    rng = np.random.default_rng(7)
    R, STR, CP, SL, strc = 12, 128, 9, 6, 128
    arena = np.where(rng.random((R, STR)) < 0.3, 0, rng.integers(1, 8, (R, STR))).astype(np.int16)
    arena[1] = np.arange(STR)
    xz = rng.integers(0, R, (CP, SL)).astype(np.int32)
    zy = rng.integers(0, R, (CP, SL)).astype(np.int32)
    ws = (rng.random((CP, SL)) * 100).astype(np.float32)
    xz[0, :3], zy[0, :3] = 2, 1  # pair 0: slots 0-2 compose the same map
    ws[0, :3] = [2.5, 2.0 ** -23, 2.0 ** -23]
    arena[2] = np.where(np.arange(STR) % 2, 5, 0)
    pid = np.asarray([0, 1, 2, 3, 4, 5, 6, 7, CP], np.int32)  # the last a pad slot
    w_scale = np.float32(1.0)

    M2 = strc * SL
    table, counts, _ = jax_ops_msa._extend_chunk_kernel(
        jnp.asarray(arena), jnp.asarray(arena[:, :strc]), xz, zy, ws,
        jnp.zeros((CP * M2, 3), jnp.uint16), jnp.zeros(CP + 1, jnp.int32),
        pid, jnp.int32(0), w_scale, SL=SL, STR=STR, STRC=strc, TCAP=CP * M2,
    )
    table, counts = np.asarray(table).astype(np.int64), np.asarray(counts)
    got_counts = torch.zeros(CP + 1, dtype=torch.int64)
    rows = port_ops_msa._extend_chunk_plain(
        torch.tensor(arena), *(torch.tensor(a) for a in (xz.astype(np.int64), zy.astype(np.int64),
                                                          ws, pid.astype(np.int64))),
        got_counts, torch.tensor(w_scale), strc,
    ).numpy()
    np.testing.assert_array_equal(got_counts.numpy(), counts)
    want = np.concatenate([table[p * M2 : p * M2 + counts[pid[p]]] for p in range(CP)])
    np.testing.assert_array_equal(rows, want)
    pair0 = rows[: counts[0]]
    assert (pair0[pair0[:, 1] == 5, 2] == 2).any()  # the crafted triple kept 2


def _jax_args(batch, groups, active, bw):
    return (batch.codes, batch.lengths, groups, active, 0.0, -1.0, 5.0, 1.0, bw)


def test_build_library_device_matches_jax():
    """Identities bit-equal, the same pairs, each pair's entries equal in
    order and weights exact."""
    rng = np.random.default_rng(4)
    batch, groups = _group_reads(rng, [6, 2, 5], 120)
    args = _jax_args(batch, groups, [0, 1, 2], 40)
    (jtab, jinv), jseg, jid = jax_api_msa._build_library_device(*args)
    (ptab, pinv), pseg, pid = port_api_msa._build_library_device(*args, CPU)
    assert jinv == pinv
    for a, b in zip(jid, pid):
        np.testing.assert_array_equal(a, b)
    assert set(jseg) == set(pseg)
    jtab, ptab = np.asarray(jtab).astype(np.int64), ptab.numpy()
    for key, (js, jn) in jseg.items():
        ps, pn = pseg[key]
        assert jn == pn > 0, key
        np.testing.assert_array_equal(ptab[ps : ps + pn], jtab[js : js + jn], err_msg=str(key))


def test_device_lib_size_guard():
    """The cases of the JAX package's guard test, with the budget pinned."""
    ok = port_api_msa._device_lib_ok
    lengths = np.full(100, 200, np.int64)
    small = [np.arange(0, 8), np.arange(8, 20)]
    assert ok(lengths, small, [0, 1], CPU, budget_bytes=1 << 31)
    assert ok(lengths, small, [0, 1], CPU)  # the CPU's default budget, 2 GiB
    big = [np.arange(0, 40)]  # g-1 = 39 -> slot bucket 64 > 32
    assert not ok(lengths, big, [0], CPU, budget_bytes=1 << 31)
    lengths_long = np.full(66, 60000, np.int64)
    wide = [np.arange(0, 33)]  # 32 slots, but 528 pairs * 32 * 65536 * 6 B
    assert not ok(lengths_long, wide, [0], CPU, budget_bytes=1 << 31)
    for args in ((lengths, small, [0, 1]), (lengths, big, [0]), (lengths_long, wide, [0])):
        assert ok(*args, CPU, budget_bytes=1 << 31) == jax_api_msa._device_lib_ok(
            *args, budget_bytes=1 << 31
        )


def _routes(monkeypatch):
    """Record which library route each segment takes."""
    taken = []
    for name in ("_build_library_device", "_build_library_host"):
        orig = getattr(port_api_msa, name)

        def wrapped(*a, _orig=orig, _name=name):
            taken.append((_name, list(a[3])))
            return _orig(*a)

        monkeypatch.setattr(port_api_msa, name, wrapped)
    return taken


def test_oversized_group_takes_the_host_route(monkeypatch):
    """A group of 34 reads (slot bucket 64) segments alone onto the host
    route, the other onto the device route, with JAX's strings."""
    monkeypatch.delenv("SARLACC_HOST_LIB", raising=False)
    rng = np.random.default_rng(5)
    batch, groups = _group_reads(rng, [4, 34], 24)
    seqs = batch.seq_strings()
    taken = _routes(monkeypatch)
    got = multi_read_align(SeqBatch.from_strings(seqs), groups=[g.tolist() for g in groups],
                           bandwidth=10, device="cpu")
    assert taken == [("_build_library_device", [0]), ("_build_library_host", [1])]
    want = jax_multi_read_align(JSeqBatch.from_strings(seqs), groups=[g.tolist() for g in groups],
                                bandwidth=10)
    assert got["alignments"] == want["alignments"]


def test_device_route_raises_without_fallback(monkeypatch):
    monkeypatch.delenv("SARLACC_HOST_LIB", raising=False)
    taken = _routes(monkeypatch)

    def broken(*a, **kw):
        raise RuntimeError("extension failed")

    monkeypatch.setattr(port_api_msa, "_extend_library", broken)
    batch = SeqBatch.from_strings(["ACGTACGTAA", "ACGTACGTAC", "ACGAACGTAA"])
    with pytest.raises(RuntimeError, match="extension failed"):
        multi_read_align(batch, device="cpu")
    assert [name for name, _ in taken] == ["_build_library_device"]


def fault_workload(seed):
    """6 seeds x 12 groups of 2-11 noisy copies (80-260 bp, 8% substitutions,
    4% indels, Phred chars 40-73)."""
    rng = np.random.default_rng(seed)
    seqs, groups = [], []
    for _ in range(12):
        L = int(rng.integers(80, 261))
        n = int(rng.integers(2, 12))
        ref = "".join(rng.choice(list("ACGT"), L))
        groups.append(list(range(len(seqs), len(seqs) + n)))
        seqs += noisy_copies(rng, ref, n, sub=0.08, indel=0.04)
    quals = ["".join(chr(int(c)) for c in rng.integers(40, 74, len(s))) for s in seqs]
    return seqs, quals, groups


#: (seed, the one group where JAX's default and host routes differ).
FAULT_SEEDS = [(0, 8), (1, 2), (2, 10), (3, 2), (4, 9), (5, 7)]


@pytest.mark.parametrize("seed,group", FAULT_SEEDS)
def test_multi_read_align_matches_jax_default_route(monkeypatch, seed, group):
    """On each seed JAX's default and host routes differ on one group (a
    float32 against a float64 identity re-plans its guide tree).  The
    port's default route equals JAX's default on every group; its host
    route differs from it on that group."""
    monkeypatch.delenv("SARLACC_HOST_LIB", raising=False)
    seqs, quals, groups = fault_workload(seed)
    kw = dict(groups=groups, bandwidth=30, max_error=0.05)
    want = jax_multi_read_align(JSeqBatch.from_strings(seqs, quals), **kw)["alignments"]
    taken = _routes(monkeypatch)
    got = multi_read_align(SeqBatch.from_strings(seqs, quals), device="cpu", **kw)
    assert [name for name, _ in taken] == ["_build_library_device"]
    assert got["alignments"] == want
    monkeypatch.setenv("SARLACC_HOST_LIB", "1")
    host = multi_read_align(SeqBatch.from_strings(seqs, quals), device="cpu", **kw)["alignments"]
    assert [i for i in range(12) if host[i] != want[i]] == [group]

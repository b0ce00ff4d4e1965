"""Kernel E fused with its cost build, proven on the CPU.

On the card ``merge_wave_from_library`` decodes a wave's library entries,
sorts them by cell once (``ops/msa.py::_merge_entries``,
``::_sorted_entries``) and hands kernel E each entry's band cell, its
weight and int32 row pointers; E stages each live row's costs on chip (the
blank, then each cell's entries summed from 0.0 in entry order) and runs
the DP and walk.  ``test_torch_walk_kernels.py::fused_merge`` transliterates
that schedule in numpy; here it is held bit for bit (tolerance 0) to the
plain composition the CPU runs (``_merge_cost_init`` ->
``_merge_accum_kernel`` -> ``_profile_merge_kernel`` ->
``_merge_walk_kernel``) and to JAX's ``merge_wave_from_library``
(``_merge_cost_init`` + ``_merge_accum_kernel`` + ``_merge_dp_walk``, float32
under ``jax.enable_x64(False)``), on whole waves: the waves of
``multi_read_align`` on the library fault workload, a wave whose one cell's
tree-ordered sum would flip a merge tie, and synthetic waves with dropped
entries, padded merges and ``la`` below rows on each route from W 32 to
131 072.  The int64 cell keys of a wave past 2^31 cells are checked at the
index level, without a cost plane.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarlacc_tpu.ops import msa as jax_msa  # noqa: E402
from sarlacc_tpu_torch.api import msa as port_api_msa  # noqa: E402
from sarlacc_tpu_torch.core.encode import SeqBatch  # noqa: E402
from sarlacc_tpu_torch.ops import cuda_walk  # noqa: E402
from sarlacc_tpu_torch.ops import msa as port_msa  # noqa: E402
from test_torch_msa_library import fault_workload  # noqa: E402
from test_torch_walk_kernels import F32, fused_merge, unpack  # noqa: E402


def _kernel_inputs(lib, descs, rows, W):
    """Kernel E's inputs as ``merge_wave_from_library`` builds them on the
    card (``_wave_tables``, then ``_merge_entries``), built here on the
    CPU: (cols, w, rowptr, la, lb, lo, kmax) as numpy arrays."""
    Pp, bands, seg, p2ca, p2cb, total, w_inv = port_msa._wave_tables(lib, descs)
    entries = port_msa._merge_entries(lib[0], w_inv, seg, p2ca, p2cb, total, Pp, rows, W)
    return tuple(t.numpy() for t in (*entries, *bands))


def _jax_wave(lib, descs, rows, W):
    lib_tab, w_inv = lib
    with jax.enable_x64(False):
        out = jax_msa.merge_wave_from_library(
            (jnp.asarray(lib_tab.numpy().astype(np.uint16)), np.float32(w_inv)), descs, rows, W)
        return np.asarray(out).astype(np.int32)


def _plain_plane(lib, descs, rows, W):
    """The plain cost planes of a wave (``_merge_cost_init`` then
    ``_merge_accum_kernel``), as the CPU path builds them."""
    planes = {}
    real = port_msa._merge_dp_walk

    def spy(cost, *bands):
        planes["cost"] = cost.clone()
        return real(cost, *bands)

    port_msa._merge_dp_walk = spy
    try:
        jm = port_msa.merge_wave_from_library(lib, descs, rows, W)
    finally:
        port_msa._merge_dp_walk = real
    return planes["cost"].numpy(), jm.numpy()


def _hold_wave(lib, descs, rows, W, stats=None):
    """The fused transliteration on a wave's kernel inputs against the
    plain composition (staged rows equal its cost planes on every live row;
    jmat equal) and JAX's wave (jmat equal).  Returns the inputs and jmat."""
    args = _kernel_inputs(lib, descs, rows, W)
    cols, w, rowptr, la, lb, lo, kmax = args
    plane, words, written, jm = fused_merge(*args, rows, W, stats)
    cost, jm_plain = _plain_plane(lib, descs, rows, W)
    for p in range(la.size):
        n = min(int(la[p]), rows)
        np.testing.assert_array_equal(plane[p, :n], cost[p, :n], err_msg=str(p))
        assert written[:n, p].all() and not written[n:, p].any(), p
    np.testing.assert_array_equal(jm, jm_plain)
    np.testing.assert_array_equal(jm, _jax_wave(lib, descs, rows, W))
    np.testing.assert_array_equal(
        port_msa._merge_entries_plain(*(torch.as_tensor(a) for a in args), rows, W).numpy(), jm_plain)
    return args, jm


# --------------------------------------------------------------------------
# Real waves: multi_read_align on the library fault workload
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _recorded_waves(seed):
    """Every merge wave ``multi_read_align`` (device library route, on the
    CPU) ran on the fault workload of ``seed``: (lib, descs, rows, W)."""
    waves = []
    real = port_api_msa.merge_wave_from_library

    def record(lib, descs, rows, W):
        waves.append((lib, descs, rows, W))
        return real(lib, descs, rows, W)

    seqs, quals, groups = fault_workload(seed)
    port_api_msa.merge_wave_from_library = record
    try:
        port_api_msa.multi_read_align(SeqBatch.from_strings(seqs, quals), groups=groups,
                                      bandwidth=30, max_error=0.05, device="cpu")
    finally:
        port_api_msa.merge_wave_from_library = real
    return waves


@pytest.mark.parametrize("seed", [0, 3])
def test_fused_merge_on_real_waves(seed):
    """Each wave of the fault workload (up to tens of thousands of library
    entries, cells of several entries, padded merges, ``la`` below rows)
    through the fused schedule, equal to the plain composition and to
    JAX."""
    waves = _recorded_waves(seed)
    assert len(waves) > 10
    multi = 0
    for lib, descs, rows, W in waves:
        (cols, w, rowptr, la, *_), _ = _hold_wave(lib, descs, rows, W)
        n = int(rowptr[-1])
        key = np.searchsorted(rowptr, np.arange(n), side="right") - 1
        multi += int((np.diff(key * W + cols[:n]) == 0).sum())
    assert multi > 1000  # cells summed from several entries


# --------------------------------------------------------------------------
# Synthetic waves
# --------------------------------------------------------------------------


def _seq_sum(x):
    """The in-order float32 sum from 0.0, as ``_ordered_add_`` adds."""
    acc = F32(0.0)
    for v in x:
        acc = F32(acc + F32(v))
    return acc


def _tree_sum(x):
    """A pairwise (tree) float32 sum."""
    x = [F32(v) for v in x]
    while len(x) > 1:
        x = [F32(x[i] + x[i + 1]) if i + 1 < len(x) else x[i] for i in range(0, len(x), 2)]
    return x[0]


def _ordered_wave():
    """One merge (la 1, lb 2, lo -2, so row 1's cells j = 1, 2 sit at k = 2,
    3) whose two cells tie only when each cell's entries are added in entry
    order.  Cell A holds 600 quantised weights of 30 000-65 535 whose sum
    passes 2^24, where float32 rounds: in order they give one value, in a
    tree another.  Cell B holds even weights (65 534 each and an even
    rest) with the in-order sum of A, exact in any order below 2^25.  A
    sits at j = 1 when its tree sum is the larger (so the tree moves the
    match from j = 2 down to j = 1), else at j = 2 (so the tree moves it
    to B at j = 1).  The two cells' entries interleave in the library.
    Returns (lib, descs, A's weights, A's column)."""
    rng = np.random.default_rng(2024)
    a = rng.integers(30000, 65536, 600)
    total = int(_seq_sum(a))
    assert 2**24 < total < 2**25 and total % 2 == 0
    b = [65534] * (total // 65534) + [total % 65534]
    col_a = 1 if _tree_sum(a) > _seq_sum(a) else 2
    rows = []
    for i in range(max(len(a), len(b))):
        if i < len(b):
            rows.append((1, 3 - col_a, b[i]))
        if i < len(a):
            rows.append((1, col_a, a[i]))
    tab = torch.tensor(rows, dtype=torch.int32)
    desc = {"la": 1, "lb": 2, "lo": -2, "kmax": 5, "segments": [(0, len(rows), 0, 0, 0)],
            "p2ca": np.arange(2, dtype=np.int32), "p2cb": np.arange(3, dtype=np.int32)}
    assert _seq_sum(b) == _tree_sum(b) == _seq_sum(a)
    return (tab, F32(1.0)), [desc], a, col_a


def test_fused_merge_sums_each_cell_in_entry_order():
    """In entry order cell A's sum ties cell B's, so the walk takes the
    diagonal at j = 2; a tree sum of A's entries differs in the last bits
    and would move the match to j = 1.  The fused schedule, the plain
    composition and JAX all give j = 2."""
    lib, descs, a, col_a = _ordered_wave()
    assert _tree_sum(a) != _seq_sum(a)
    _, jm = _hold_wave(lib, descs, 64, 64)
    assert jm[0, 0] == 2
    # The tree order flips the tie: the plain DP + walk on a plane holding
    # A's tree sum matches j = 1.
    cost, _ = _plain_plane(lib, descs, 64, 64)
    bands = [torch.as_tensor(x) for x in _kernel_inputs(lib, descs, 64, 64)[3:]]
    k_a = col_a - 1 - descs[0]["lo"]
    assert cost[0, 0, k_a] == _seq_sum(a)
    tree = cost.copy()
    tree[0, 0, k_a] = _tree_sum(a)
    assert port_msa._merge_dp_walk(torch.as_tensor(tree), *bands).numpy()[0, 0] == 1


def _synthetic_wave(rng, P, rows, W, n_entries):
    """A wave of P merges over one library: ``la`` from rows / 3 to rows,
    bands as wide as W allows (up to a bandwidth of W / 2, so the columns
    stay small while the band spans W), columns drawn near the diagonal so
    cells collect several entries, positions 0 and swapped segments, and
    entries that fall outside the band (dropped)."""
    descs, tab, at = [], [], 0
    for m in range(P):
        la = int(rng.integers(max(rows // 3, 1), rows + 1))
        lb = int(np.clip(la + rng.integers(-8, 9), 1, None))
        bw = (W - abs(lb - la) - 2) // 2
        lo = min(0, lb - la) - bw
        kmax = max(0, lb - la) + bw - lo
        n = int(rng.integers(n_entries // 2, n_entries))
        pa = rng.integers(0, la + 1, n)
        pb = np.clip(pa + rng.integers(-3, 4, n), 0, lb)
        far = rng.random(n) < 0.05  # outside a narrow band: dropped there
        pb[far] = rng.integers(0, lb + 1, int(far.sum()))
        swap = m % 3 == 1
        if swap:
            pa, pb = pb, pa
        tab.append(np.stack([pa, pb, rng.integers(0, 65536, n)], axis=1))
        descs.append({"la": la, "lb": lb, "lo": lo, "kmax": kmax,
                      "segments": [(at, n, 0, 0, int(swap))],
                      "p2ca": np.arange(la + 1, dtype=np.int32),
                      "p2cb": np.arange(lb + 1, dtype=np.int32)})
        at += n
    return (torch.as_tensor(np.concatenate(tab).astype(np.int32)), F32(1 / 4096)), descs


@pytest.mark.parametrize("W,rows,P", [
    (32, 64, 7), (256, 96, 20), (512, 64, 9),  # warp route
    (1024, 40, 5), (8192, 16, 3),  # block route
    (16384, 16, 3), (131072, 8, 2),  # wide route
])
def test_fused_merge_on_synthetic_waves(W, rows, P):
    """Synthetic waves on every route: staged rows, choices and jmat equal
    to the plain composition and to JAX, with padded merges (P below the
    wave's 16), dropped entries and ``la`` below rows; the walk's windows
    are exercised."""
    rng = np.random.default_rng(W + rows + P)
    lib, descs = _synthetic_wave(rng, P, rows, W, 40 * rows)
    assert cuda_walk.merge_route(W) == ("warp" if W <= 512 else "block" if W <= 8192 else "wide")
    stats = {}
    (cols, w, rowptr, la, *_), jm = _hold_wave(lib, descs, rows, W, stats)
    assert cols.size > int(rowptr[-1])  # some entries dropped
    assert (la[:P] < rows).any() and not la[P:].any() and not jm[:, P:].any()
    assert jm.any() and stats["windows"] >= P


def test_fused_choices_match_the_plain_dp_on_every_live_row():
    """The packed choice words of one real wave, unpacked, equal the plain
    DP's choice bytes on every live row of every merge (the walk's clamped
    lookups may read any of them)."""
    lib, descs, rows, W = max(_recorded_waves(3), key=lambda x: len(x[1]))
    args = _kernel_inputs(lib, descs, rows, W)
    _, words, _, _ = fused_merge(*args, rows, W)
    cost, _ = _plain_plane(lib, descs, rows, W)
    la = args[3]
    dirs = port_msa._profile_merge_kernel(torch.as_tensor(cost), *(torch.as_tensor(a) for a in args[3:])).numpy()
    choices = unpack(words, W)
    for p in range(la.size):
        n = min(int(la[p]), rows)
        np.testing.assert_array_equal(choices[:n, p], dirs[:n, p], err_msg=str(p))


# --------------------------------------------------------------------------
# The keys and row pointers
# --------------------------------------------------------------------------


def test_keys_past_two_to_the_31():
    """A wave of 4 096 merges x 1 024 rows x W 1 024 spans 2^32 cells: the
    decode keys its entries in int64, exactly, and the sort's row pointers
    place them (only the entries, the row pointers and no cost plane are
    allocated)."""
    Pp, rows, W = 4096, 1024, 1024
    lib_tab = torch.tensor([[1, 1, 7], [1024, 1020, 9], [500, 530, 11], [3, 2000, 5]], dtype=torch.int32)
    seg = {k: torch.tensor(v, dtype=torch.int64) for k, v in {
        "bound": [0, 2], "start": [0, 2], "m": [4095, 2100], "aoff": [0, 0], "boff": [0, 0],
        "swap": [0, 0], "lo": [-10, -40], "kmax": [1000, 900]}.items()}
    p2c = torch.arange(2048, dtype=torch.int32)
    target, w, ok = port_msa._merge_entry_targets(lib_tab, torch.tensor(F32(0.5)), seg, p2c, p2c,
                                                  0, 4, rows, W)
    want = [(4095 * rows + 0) * W + 10, (4095 * rows + 1023) * W + (1020 - 1024 + 10),
            (2100 * rows + 499) * W + (530 - 500 + 40), None]
    assert ok.tolist() == [True, True, True, False]  # the last lands past kmax
    assert target[:3].tolist() == want[:3] and target.dtype == torch.int64
    assert min(want[:3]) > 2**31
    key = torch.where(ok, target, Pp * rows * W)
    cols, ws, rowptr = port_msa._sorted_entries(key, w, Pp, rows, W)
    assert rowptr.dtype == torch.int32 and rowptr.shape == (Pp * rows + 1,)
    assert cols.tolist()[:3] == [530 - 500 + 40, 10, 1020 - 1024 + 10]
    assert ws.tolist() == [5.5, 3.5, 4.5, 2.5]
    r_a, r_b, r_c = 2100 * rows + 499, 4095 * rows, 4095 * rows + 1023
    assert int(rowptr[r_a]) == 0 and int(rowptr[r_a + 1]) == 1
    assert int(rowptr[r_b]) == 1 and int(rowptr[r_b + 1]) == 2
    assert int(rowptr[r_c]) == 2 and int(rowptr[r_c + 1]) == 3 == int(rowptr[-1])


def test_row_pointers_and_dropped_entries():
    """``_sorted_entries`` against numpy: kept entries by cell, stable (a
    cell's entries in entry order), the dropped ones last and outside every
    row, row r's entries between ``rowptr[r]`` and ``rowptr[r + 1]``."""
    rng = np.random.default_rng(11)
    Pp, rows, W = 16, 32, 64
    n = 5000
    key = rng.integers(0, Pp * rows * W // 50, n) * 50 % (Pp * rows * W)
    key[rng.random(n) < 0.1] = Pp * rows * W
    w = rng.random(n).astype(F32)
    cols, ws, rowptr = port_msa._sorted_entries(torch.as_tensor(key), torch.as_tensor(w), Pp, rows, W)
    order = np.argsort(key, kind="stable")
    kept = int((key < Pp * rows * W).sum())
    np.testing.assert_array_equal(cols.numpy()[:kept], (key[order] % W)[:kept])
    np.testing.assert_array_equal(ws.numpy(), w[order])
    want = np.searchsorted(key[order], np.arange(Pp * rows + 1) * W)
    np.testing.assert_array_equal(rowptr.numpy(), want)
    assert int(rowptr[-1]) == kept

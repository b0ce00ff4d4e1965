"""PyTorch port, UMI grouping: parity with the JAX package on the CPU.

The dense doubled-Levenshtein matrix (plain PyTorch DP) must equal the JAX
tiles exactly; the sparse neighbour search and the grouping must produce
the same pairs and the same groups, below and above ``SPARSE_MIN``, through
either engine: the native symmetric-delete filter, or the row-block scan
that both packages take for UMIs longer than 24 bases, for more than 512
deletion variants, or for many N-containing UMIs.  ``lev2_condensed`` and
``expected_dist`` equal the JAX ones and the golden ``expected_dist``
vector.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import sarlacc_tpu.api.umi as jax_umi_mod  # noqa: E402
import sarlacc_tpu_torch.api.umi as umi_mod  # noqa: E402
import sarlacc_tpu_torch.ops.levenshtein as lev_mod  # noqa: E402
from sarlacc_tpu.api.umi import expected_dist as jax_expected_dist  # noqa: E402
from sarlacc_tpu.api.umi import umi_group as jax_umi_group  # noqa: E402
from sarlacc_tpu.ops.levenshtein import lev2_condensed as jax_lev2_condensed  # noqa: E402
from sarlacc_tpu.ops.levenshtein import lev2_matrix as jax_lev2_matrix  # noqa: E402
from sarlacc_tpu.ops.levenshtein import lev2_neighbor_pairs as jax_neighbor_pairs  # noqa: E402
from sarlacc_tpu.ops.levenshtein import _unique_rows as jax_unique_rows  # noqa: E402
from sarlacc_tpu_torch.api.umi import SPARSE_MIN, expected_dist, quality_mask, umi_group  # noqa: E402
from sarlacc_tpu_torch.core.encode import SeqBatch, encode_batch  # noqa: E402
from sarlacc_tpu_torch.native import greedy_cluster_native  # noqa: E402
from sarlacc_tpu_torch.ops.levenshtein import (  # noqa: E402
    _neighbor_pairs_filtered,
    _neighbor_pairs_rowblock,
    lev2_condensed,
    lev2_matrix,
    lev2_neighbor_pairs,
)
from sarlacc_tpu_torch.refimpl.cluster import cluster_umis  # noqa: E402
from sarlacc_tpu_torch.utils import profiling  # noqa: E402
from sarlacc_tpu_torch.utils.profiling import PipelineProfiler  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _umis(rng, n_centres, copies, length=12, n_rate=0.0, err=0.08):
    """Clustered UMIs: noisy copies (substitutions, indels) of random centres."""
    out = []
    for _ in range(n_centres):
        centre = "".join(rng.choice(list("ACGT"), length))
        for _ in range(int(rng.integers(1, copies + 1))):
            s = []
            for ch in centre:
                r = rng.random()
                if r < err / 3:
                    continue  # deletion
                if r < 2 * err / 3:
                    s.append(str(rng.choice(list("ACGT"))))  # insertion
                s.append(str(rng.choice(list("ACGT"))) if rng.random() < err / 3 else ch)
            s = "".join(s)
            if n_rate:
                s = "".join("N" if rng.random() < n_rate else c for c in s)
            out.append(s)
    return out


@pytest.mark.parametrize("n_rate", [0.0, 0.05])
def test_lev2_matrix_equal(n_rate):
    rng = np.random.default_rng(11)
    seqs = _umis(rng, 20, 4, length=10, n_rate=n_rate)
    codes, lengths = encode_batch(seqs)
    want = np.asarray(jax_lev2_matrix(codes.astype(np.int32), lengths))
    got = lev2_matrix(codes.astype(np.int32), lengths, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_lev2_neighbor_pairs_equal():
    rng = np.random.default_rng(12)
    seqs = _umis(rng, 60, 5, n_rate=0.02)
    codes, lengths = encode_batch(seqs)
    for limit in (1, 2, 3):
        wi, wj = jax_neighbor_pairs(codes.astype(np.int32), lengths, limit)
        gi, gj = lev2_neighbor_pairs(codes.astype(np.int32), lengths, limit)
        want = sorted(zip(np.asarray(wi).tolist(), np.asarray(wj).tolist()))
        got = sorted(zip(gi.tolist(), gj.tolist()))
        assert got == want, limit


def _pair_set(qi, qj):
    return sorted(zip(np.asarray(qi).tolist(), np.asarray(qj).tolist()))


@pytest.mark.parametrize(
    "length,limit", [(30, 1), (30, 2), (30, 3), (20, 3)],
)
def test_rowblock_pairs_equal_jax(length, limit):
    """UMIs past the filter's length (30 bp) or its variant budget (20 bp at
    limit 3: 1 351 variants) take the row-block scan in both packages; the
    pair sets are equal, N rows and mixed lengths (indels) included."""
    rng = np.random.default_rng(100 + length + limit)
    # The last row's self-distance is 7 (one per N): above every threshold.
    seqs = _umis(rng, 30, 5, length=length, n_rate=0.03) + ["ACGT" * 4 + "NNNNNNN" + "ACG"]
    codes, lengths = encode_batch(seqs)
    codes = codes.astype(np.int32)
    assert _neighbor_pairs_filtered(codes, lengths, limit, 2 * limit) is None
    wi, wj = jax_neighbor_pairs(codes, lengths, limit)
    gi, gj = lev2_neighbor_pairs(codes, lengths, limit, tile=16, device="cpu")
    got = _pair_set(gi, gj)
    assert got == _pair_set(wi, wj)
    # The diagonal: present for every N-free row, and for an N row exactly
    # when its self-distance passes.
    mat = lev2_matrix(codes, lengths, device="cpu")
    diag = {i for i, j in got if i == j}
    assert diag == {i for i in range(len(seqs)) if mat[i, i] <= 2 * limit}
    has_n = [("N" in x) for x in seqs]
    assert any(has_n) and any(i not in diag for i in range(len(seqs)) if has_n[i])


@pytest.mark.parametrize("limit", [0, 1, 2, 3])
def test_rowblock_equals_filter_and_dense(limit):
    """Both engines give the same unique-space pairs on short UMIs (mixed
    lengths, N rows, the empty string), and they are the dense matrix's."""
    rng = np.random.default_rng(60 + limit)
    seqs = _umis(rng, 25, 3, length=9, n_rate=0.04) + ["", "N", "ACGTACGT"]
    codes, lengths = encode_batch(seqs)
    uniq, first, _, _ = lev_mod._unique_rows(codes)
    codes, lengths = uniq.astype(np.int32), lengths[first].astype(np.int32)
    fi, fj = _neighbor_pairs_filtered(codes, lengths, limit, 2 * limit)
    ri, rj = _neighbor_pairs_rowblock(codes, lengths, 2 * limit, limit, tile=8, device="cpu")
    norm = lambda a, b: sorted(zip(np.minimum(a, b).tolist(), np.maximum(a, b).tolist()))  # noqa: E731
    mat = lev2_matrix(codes, lengths, device="cpu")
    want = [(i, j) for i in range(len(codes)) for j in range(i, len(codes)) if mat[i, j] <= 2 * limit]
    assert norm(ri, rj) == want
    assert norm(fi, fj) == want


def _np_unique_rows(codes):
    return np.unique(codes, axis=0, return_index=True, return_inverse=True, return_counts=True)


def _code_rows(rng, kind, width):
    """int8 code rows of one ``kind``: ``dup`` (300 rows of 12 strings,
    pads (5) past each row's length, N (4) sprinkled, six of them copies of
    the others but at the last position or at position 24, the first of
    the second base-6 word), ``equal`` (one padded row 40 times),
    ``distinct`` (no two rows alike), ``n0``, ``n1``."""
    if kind == "n0":
        return np.zeros((0, width), np.int8)
    if kind == "distinct":
        if width == 1:
            return rng.permutation(6).astype(np.int8)[:, None]
        rows = np.unique(rng.integers(0, 6, (200, width)), axis=0)
        return rows[rng.permutation(len(rows))].astype(np.int8)
    base = rng.integers(0, 4, (12, width)).astype(np.int8)
    lens = rng.integers(max(width - 6, 0), width + 1, 12)
    base[np.arange(width)[None, :] >= lens[:, None]] = 5
    base[rng.random((12, width)) < 0.05] = 4
    base[6:] = base[:6]
    base[6:9, width - 1] = (base[6:9, width - 1] + 1) % 6
    base[9:, min(24, width - 1)] = (base[9:, min(24, width - 1)] + 1) % 6
    take = {"dup": rng.integers(0, 12, 300), "equal": np.zeros(40, int), "n1": [3]}[kind]
    return np.ascontiguousarray(base[take])


@pytest.mark.parametrize("kind", ["dup", "equal", "distinct", "n0", "n1"])
@pytest.mark.parametrize("width", [1, 23, 24, 25, 30, 47, 48, 49, 60])
def test_unique_rows_equal_np_unique(monkeypatch, width, kind):
    """``_unique_rows`` returns what ``np.unique(axis=0)`` and the JAX
    package's ``_unique_rows`` return (unique rows, first indices, inverse,
    counts, dtypes included) on one base-6 word (W <= 24) and on several
    (W > 24), and counts the packed route for every non-empty input."""
    prof = PipelineProfiler()
    monkeypatch.setattr(profiling, "_GLOBAL", prof)
    codes = _code_rows(np.random.default_rng(width * 10 + len(kind)), kind, width)
    if kind == "distinct":
        assert len(np.unique(codes, axis=0)) == len(codes)
    got = lev_mod._unique_rows(codes)
    for want in (_np_unique_rows(codes), jax_unique_rows(codes)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.reshape(g.shape))
            assert g.dtype == w.dtype
        assert got[0].shape == want[0].shape and got[2].shape == (len(codes),)
    route = "unique_rows.fallback" if kind == "n0" else "unique_rows.packed"
    assert prof.counters == {route: 1}


@pytest.mark.parametrize("bad", [-1, 6])
def test_unique_rows_fallback_outside_codes(monkeypatch, bad):
    """A code outside 0..5 cannot pack into base-6 words: the rows take
    ``np.unique(axis=0)`` itself, and count the fallback."""
    prof = PipelineProfiler()
    monkeypatch.setattr(profiling, "_GLOBAL", prof)
    codes = _code_rows(np.random.default_rng(9), "dup", 30)
    codes[7, 2] = bad
    got = lev_mod._unique_rows(codes)
    for g, w in zip(got, _np_unique_rows(codes)):
        np.testing.assert_array_equal(g, w)
    assert prof.counters == {"unique_rows.fallback": 1}


def test_unique_rows_zero_width(monkeypatch):
    """Rows of no positions pack into one zero word: all of them are one
    row, as ``np.unique(axis=0)`` and the JAX package's ``_unique_rows``
    say."""
    prof = PipelineProfiler()
    monkeypatch.setattr(profiling, "_GLOBAL", prof)
    codes = np.zeros((5, 0), np.int8)
    got = lev_mod._unique_rows(codes)
    for want in (_np_unique_rows(codes), jax_unique_rows(codes)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.reshape(g.shape))
            assert g.dtype == w.dtype and g.shape == w.shape
    assert prof.counters == {"unique_rows.packed": 1}


def test_umi_group_dual_wide_equal_np_unique(monkeypatch):
    """Two UMIs of 30 bases on the sparse path (``SPARSE_MIN`` forced low
    on both sides), rows up to 30-odd positions wide: the groups equal the
    JAX ``umi_group``'s on the same input, and those of the same call with
    the duplicate collapse done by ``np.unique(axis=0)``."""
    rng = np.random.default_rng(90)
    u1 = _umis(rng, 40, 6, length=30, n_rate=0.01)
    u2 = _umis(rng, 40, 6, length=30, n_rate=0.01)
    n = min(len(u1), len(u2))
    u1, u2 = u1[:n] + [u1[2]] * 5, u2[:n] + [u2[2]] * 5
    assert encode_batch(u1)[0].shape[1] > 24 and encode_batch(u2)[0].shape[1] > 24
    monkeypatch.setattr(jax_umi_mod, "SPARSE_MIN", 16)
    monkeypatch.setattr(umi_mod, "SPARSE_MIN", 16)
    got = umi_group(u1, threshold1=3, umi2=u2, threshold2=2, device="cpu")
    jax_want = jax_umi_group(u1, threshold1=3, umi2=u2, threshold2=2)
    monkeypatch.setattr(umi_mod, "_unique_rows", _np_unique_rows)
    want = umi_group(u1, threshold1=3, umi2=u2, threshold2=2, device="cpu")
    assert sorted(int(i) for g in got for i in g) == list(range(len(u1)))
    assert [g.tolist() for g in got] == [np.asarray(g).tolist() for g in jax_want]
    assert [g.tolist() for g in got] == [g.tolist() for g in want]


def _dual_inputs(rng, width, kind):
    """Two UMIs of about ``width`` bases for the same ~400 reads: families
    with heavy duplicates (whole reads repeated, and UMI1 strings shared by
    reads of other UMI2 strings), a few UMIs with 7 Ns (a doubled
    self-distance of 7, past 2 x threshold for thresholds up to 3, so not
    their own neighbours); ``kind="isolated"`` gives UMI1 strings so far
    apart that UMI1's search emits no off-diagonal pair."""
    u1 = _umis(rng, 30, 8, length=width, n_rate=0.01)
    u2 = _umis(rng, 30, 8, length=width, n_rate=0.01)
    n = min(len(u1), len(u2))
    if kind == "isolated":
        u1 = ["".join(rng.choice(list("ACGT"), width)) for _ in range(n // 6)] * 6
        n = len(u1)
    pick = rng.integers(0, n, 150)
    u1 = u1[:n] + [u1[i] for i in pick] + [u1[i] for i in rng.integers(0, n, 40)]
    u2 = u2[:n] + [u2[i] for i in pick] + [u2[i] for i in rng.integers(0, n, 40)]
    for u in (u1, u2):
        for i in rng.integers(0, len(u), 6):
            u[i] = "N" * 7 + u[i][7:]
    perm = rng.permutation(len(u1))
    return [u1[i] for i in perm], [u2[i] for i in perm]


def _np_dual_csr(c1, l1, t1, c2, l2, t2):
    """The two-UMI sparse neighbour lists in numpy, read by read: each
    UMI's duplicates collapsed by ``np.unique(axis=0)``, the unique pairs
    from the sparse search, a string's neighbours in trie DFS order, each
    expanded to its reads in index order, every read sharing its string's
    list; then UMI2's list of each read kept where UMI1's list of that
    read holds the entry.  (flat int32, offsets int64)."""
    n = c1.shape[0]
    lists = []
    for codes, lengths, t in ((c1, l1, t1), (c2, l2, t2)):
        u, first, inv, _ = _np_unique_rows(codes)
        inv = inv.reshape(-1)
        ul = lengths[first].astype(np.int32)
        qi, qj = lev2_neighbor_pairs(u.astype(np.int32), ul, t, assume_unique=True, device="cpu")
        off = qi != qj
        ua = np.concatenate([qi, qj[off]]).astype(np.int64)
        va = np.concatenate([qj, qi[off]]).astype(np.int64)
        urank = np.empty(len(u), np.int64)
        urank[umi_mod._dfs_order(u, ul)] = np.arange(len(u))
        reads_of = [np.flatnonzero(inv == v) for v in range(len(u))]
        of_string = [
            np.concatenate([reads_of[v] for v in sorted(va[ua == w], key=lambda v: urank[v])]
                           + [np.zeros(0, np.int64)])
            for w in range(len(u))
        ]
        lists.append([of_string[inv[r]] for r in range(n)])
    kept = [b[np.isin(b, a)] for a, b in zip(*lists)]
    flat = np.concatenate(kept).astype(np.int32)
    return flat, np.concatenate([[0], np.cumsum([k.size for k in kept])]).astype(np.int64)


@pytest.mark.parametrize("width", [18, 30])
@pytest.mark.parametrize("t1,t2,kind", [(3, 3, "families"), (3, 2, "families"),
                                        (1, 1, "families"), (1, 1, "isolated")])
def test_dual_sparse_csr_equals_numpy(width, t1, t2, kind):
    """The two-UMI sparse path's lists, built and intersected with torch on
    the CPU, equal a numpy transliteration of read-level lists and their
    intersection, element for element: duplicates, N strings that are not
    their own neighbours, and a UMI1 with no off-diagonal hits."""
    rng = np.random.default_rng(width * 100 + t1 * 10 + t2 + len(kind))
    u1, u2 = _dual_inputs(rng, width, kind)
    c1, l1 = encode_batch(u1)
    c2, l2 = encode_batch(u2)
    if kind == "isolated":
        u, first, _, _ = _np_unique_rows(c1)
        qi, qj = lev2_neighbor_pairs(u.astype(np.int32), l1[first], t1, assume_unique=True,
                                     device="cpu")
        assert (qi == qj).all() and qi.size
    flat, offs = umi_mod._dual_sparse_csr(c1.astype(np.int32), l1, t1, c2.astype(np.int32), l2,
                                          t2, torch.device("cpu"))
    want_flat, want_offs = _np_dual_csr(c1, l1, t1, c2, l2, t2)
    assert flat.dtype == np.int32 and offs.dtype == np.int64
    np.testing.assert_array_equal(offs, want_offs)
    np.testing.assert_array_equal(flat, want_flat)
    assert np.diff(offs).min() == 0  # an N read that is no one's neighbour keeps an empty list


@pytest.mark.parametrize("length,threshold", [(30, 2), (20, 3)])
def test_umi_group_rowblock_equal(monkeypatch, length, threshold):
    """The sparse path forced (``SPARSE_MIN`` = 1 on both sides, as
    tests/test_levenshtein.py:116-170 does) on UMIs that take the row-block
    scan: the groups equal the JAX ``umi_group``'s."""
    rng = np.random.default_rng(70 + length)
    seqs = _umis(rng, 40, 6, length=length, n_rate=0.01)
    seqs += [seqs[3]] * 4  # duplicates collapse before the scan
    monkeypatch.setattr(jax_umi_mod, "SPARSE_MIN", 1)
    monkeypatch.setattr(umi_mod, "SPARSE_MIN", 1)
    want = jax_umi_group(seqs, threshold1=threshold)
    got = umi_group(seqs, threshold1=threshold, device="cpu")
    assert [g.tolist() for g in got] == [np.asarray(g).tolist() for g in want]


@pytest.mark.parametrize("dense_max", [8192, 0])
def test_lev2_condensed_equal(monkeypatch, dense_max):
    """The dense tiles and the chunked per-pair path (forced by lowering the
    dense limit, with chunks smaller than one row and spanning rows) give
    the JAX ``lev2_condensed``, i < j in i-major order."""
    rng = np.random.default_rng(80)
    seqs = _umis(rng, 15, 4, length=11, n_rate=0.05) + [""]
    codes, lengths = encode_batch(seqs)
    codes = codes.astype(np.int32)
    want = np.asarray(jax_lev2_condensed(codes, lengths))
    monkeypatch.setattr(lev_mod, "_CONDENSED_DENSE_MAX", dense_max)
    for max_pairs in (7, 1 << 22):
        got = lev2_condensed(codes, lengths, max_pairs=max_pairs, device="cpu")
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_expected_dist_equal_jax_and_golden():
    """``expected_dist`` on the golden dual-UMI draw (first 40 UMI1s,
    tests/test_golden_suite.py:53-90) equals the golden vector and the JAX
    function, also with quality masking."""
    golden = json.loads((ROOT / "tests" / "golden" / "dual_umi.json").read_text())
    seqs = golden["umi1"][:40]
    got = expected_dist(seqs, device="cpu")
    assert got.dtype == np.float64
    assert got.tolist() == golden["expected_dist"]
    np.testing.assert_array_equal(got, np.asarray(jax_expected_dist(seqs)))
    rng = np.random.default_rng(81)
    quals = ["".join(chr(int(q)) for q in rng.integers(35, 60, len(x))) for x in seqs]
    jb = jax_umi_mod._as_batch(jax_umi_mod.SeqBatch.from_strings(seqs, quals))
    tb = SeqBatch.from_strings(seqs, quals)
    np.testing.assert_array_equal(
        expected_dist(tb, max_err=0.01, device="cpu"),
        np.asarray(jax_expected_dist(jb, max_err=0.01)),
    )


@pytest.mark.parametrize("threshold", [1, 2, 3])
def test_umi_group_dense_equal(threshold):
    rng = np.random.default_rng(20 + threshold)
    seqs = _umis(rng, 40, 6, n_rate=0.01)
    assert len(seqs) < SPARSE_MIN
    want = jax_umi_group(seqs, threshold1=threshold)
    got = umi_group(seqs, threshold1=threshold, device="cpu")
    assert [g.tolist() for g in got] == [np.asarray(g).tolist() for g in want]


def test_umi_group_sparse_equal():
    """About 2500 12-bp UMIs: the native scale path on both sides."""
    rng = np.random.default_rng(31)
    seqs = _umis(rng, 500, 9)
    seqs = seqs[:2600]
    assert len(seqs) >= SPARSE_MIN
    want = jax_umi_group(seqs, threshold1=2)
    got = umi_group(seqs, threshold1=2, device="cpu")
    assert [g.tolist() for g in got] == [np.asarray(g).tolist() for g in want]


def test_umi_group_dual_and_pregroups_equal():
    rng = np.random.default_rng(41)
    u1 = _umis(rng, 25, 5)
    u2 = _umis(rng, 25, 5)[: len(u1)]
    u2 += ["ACGTACGTACGT"] * (len(u1) - len(u2))
    pre = rng.integers(0, 3, len(u1))
    want = jax_umi_group(u1, threshold1=2, umi2=u2, threshold2=1, groups=pre)
    got = umi_group(u1, threshold1=2, umi2=u2, threshold2=1, groups=pre, device="cpu")
    assert [g.tolist() for g in got] == [np.asarray(g).tolist() for g in want]


def test_quality_mask_and_native_clusterer():
    seqs = ["ACGTAC", "ACGTAA", "TTTTTT"]
    quals = ["II#III", "IIIIII", "######"]
    masked = quality_mask(SeqBatch.from_strings(seqs, quals), max_err=0.01)
    assert masked.seq_strings() == ["ACNTAC", "ACGTAA", "NNNNNN"]
    neighbours = [[0, 1], [1, 0], [2]]
    assert greedy_cluster_native(neighbours) == cluster_umis(neighbours)


def test_native_bindings_match_jax_bindings():
    """Every ported binding returns what the JAX package's binding returns
    for the same inputs (same C++ source, independently declared argtypes)."""
    import sarlacc_tpu.native as jn
    import sarlacc_tpu_torch.native as tn
    from sarlacc_tpu.ops.levenshtein import _delete_variant_entries

    rng = np.random.default_rng(14)
    seqs = _umis(rng, 30, 4)
    codes, lengths = encode_batch(seqs)
    h, owner = _delete_variant_entries(codes, lengths, 1)
    np.testing.assert_array_equal(
        tn.candidate_pairs_native(h, owner, 1 << 10, 1 << 20),
        jn.candidate_pairs_native(h, owner, 1 << 10, 1 << 20),
    )
    np.testing.assert_array_equal(
        tn.candidate_verify_native(h, owner, codes, lengths, 1, 2, 1 << 20),
        jn.candidate_verify_native(h, owner, codes, lengths, 1, 2, 1 << 20),
    )
    ua, ub = rng.integers(0, len(seqs), 200), rng.integers(0, len(seqs), 200)
    np.testing.assert_array_equal(
        tn.verify_pairs_native(codes, lengths, ua, ub, 2, 4),
        jn.verify_pairs_native(codes, lengths, ua, ub, 2, 4),
    )
    ci = rng.integers(0, 20, 500).astype(np.int32)
    cj = ci + rng.integers(-6, 7, 500).astype(np.int32)
    w = rng.random(500).astype(np.float32)
    got = np.zeros((20, 16), np.float32)
    want = np.zeros((20, 16), np.float32)
    tn.accumulate_cost_native(ci, cj, w, -8, 20, 16, got)
    jn.accumulate_cost_native(ci, cj, w, -8, 20, 16, want)
    np.testing.assert_array_equal(got, want)

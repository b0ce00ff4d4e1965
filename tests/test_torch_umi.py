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

"""PyTorch port, UMI grouping: parity with the JAX package on the CPU.

The dense doubled-Levenshtein matrix (plain PyTorch DP) must equal the JAX
tiles exactly; the sparse neighbour search and the grouping must produce
the same pairs and the same groups, below and above ``SPARSE_MIN``.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from sarlacc_tpu.api.umi import umi_group as jax_umi_group  # noqa: E402
from sarlacc_tpu.ops.levenshtein import lev2_matrix as jax_lev2_matrix  # noqa: E402
from sarlacc_tpu.ops.levenshtein import lev2_neighbor_pairs as jax_neighbor_pairs  # noqa: E402
from sarlacc_tpu_torch.api.umi import SPARSE_MIN, quality_mask, umi_group  # noqa: E402
from sarlacc_tpu_torch.core.encode import SeqBatch, encode_batch  # noqa: E402
from sarlacc_tpu_torch.native import greedy_cluster_native  # noqa: E402
from sarlacc_tpu_torch.ops.levenshtein import lev2_matrix, lev2_neighbor_pairs  # noqa: E402
from sarlacc_tpu_torch.refimpl.cluster import cluster_umis  # noqa: E402


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


def test_long_umis_raise_not_implemented():
    """The JAX package scans row blocks on the device for UMIs past the
    symmetric-delete filter's length; the port raises instead."""
    rng = np.random.default_rng(13)
    seqs = ["".join(rng.choice(list("ACGT"), 30)) for _ in range(10)]
    codes, lengths = encode_batch(seqs)
    with pytest.raises(NotImplementedError, match="row-block"):
        lev2_neighbor_pairs(codes.astype(np.int32), lengths, 2)


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

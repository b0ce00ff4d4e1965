"""PyTorch port, MSA: parity with the JAX package on the CPU.

The plain banded pair DP (the CPU side of kernel B) against the XLA
``_banded_pair_kernel`` and the Pallas ``_kernel`` in interpret mode, the
Gotoh walk and the merge DP + walk against their JAX forms, the ordered
accumulation against a sequential add, ``multi_read_align`` against the JAX
host-library path, and the hand-derived MSA goldens of test_msa.py.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from sarlacc_tpu.api.msa import multi_read_align as jax_multi_read_align  # noqa: E402
from sarlacc_tpu.core.encode import SeqBatch as JSeqBatch  # noqa: E402
from sarlacc_tpu.ops.msa import _banded_pair_kernel, _merge_dp_walk, _pair_walk_kernel as jax_pair_walk  # noqa: E402
from sarlacc_tpu.ops.pallas_msa import banded_pair_pallas  # noqa: E402
from sarlacc_tpu_torch.api.msa import MAX_MSA_READ_LEN, multi_read_align  # noqa: E402
from sarlacc_tpu_torch.core.encode import SeqBatch, encode_batch  # noqa: E402
from sarlacc_tpu_torch.ops.cuda_msa import PAIR_KERNEL, banded_pair, banded_pair_plain, pair_kernel  # noqa: E402
from sarlacc_tpu_torch.ops.msa import (  # noqa: E402
    _merge_walk_kernel,
    _ordered_add_,
    _pair_walk_kernel,
    _profile_merge_kernel,
    band_halfwidth,
    banded_pair_align,
)


def noisy_copies(rng, ref, n, sub=0.05, indel=0.01):
    out = []
    for _ in range(n):
        s = []
        for ch in ref:
            r = rng.random()
            if r < indel / 2:
                continue
            if r < indel:
                s.append(ch)
                s.append(ch)
            s.append(str(rng.choice(list("ACGT"))) if rng.random() < sub else ch)
        out.append("".join(s))
    return out


def _pairs(rng, P, rows, W, bw=6):
    LA = rows
    LB = rows + 16
    codes_a = rng.integers(0, 4, (P, LA)).astype(np.int8)
    codes_b = rng.integers(0, 4, (P, LB)).astype(np.int8)
    codes_b[:, :LA] = np.where(rng.random((P, LA)) < 0.8, codes_a, codes_b[:, :LA])
    lens_a = rng.integers(rows // 2, LA + 1, P).astype(np.int32)
    lens_b = np.clip(lens_a + rng.integers(-12, 13, P), 1, LB).astype(np.int32)
    diffs = lens_b.astype(np.int64) - lens_a
    lo = (np.minimum(0, diffs) - bw).astype(np.int32)
    hi = (np.maximum(0, diffs) + bw).astype(np.int32)
    assert int((hi - lo).max()) + 1 <= W
    return codes_a, codes_b, lens_a, lens_b, lo, hi - lo


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def test_banded_pair_plain_matches_xla_and_pallas():
    rng = np.random.default_rng(3)
    P, rows, W = 8, 64, 64
    ca, cb, la, lb, lo, km = _pairs(rng, P, rows, W)
    s_x, d_x = _banded_pair_kernel(
        jnp.asarray(ca, jnp.int32), jnp.asarray(cb, jnp.int32), jnp.asarray(la),
        jnp.asarray(lb), jnp.asarray(lo), jnp.asarray(km),
        0.0, -1.0, 5.0, 1.0, rows=rows, width=W,
    )
    # The Pallas kernel takes pairs in lane tiles of 128: pad with empty pairs.
    Pq = 128

    def pad(a, fill):
        out = np.full((Pq,) + a.shape[1:], fill, a.dtype)
        out[:P] = a
        return out

    s_p, d_p = banded_pair_pallas(
        pad(ca, 5), pad(cb, 5), pad(la, 0), pad(lb, 0), pad(lo, -6), pad(km, 12),
        0.0, -1.0, 5.0, 1.0, rows=rows, width=W, interpret=True,
    )
    s_t, d_t = banded_pair(*_t(ca, cb, la, lb, lo, km), 0.0, -1.0, 5.0, 1.0, rows, W)
    assert d_t.dtype == torch.int8 and tuple(d_t.shape) == (rows, P, W)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_x))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_x))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_p)[:P])
    np.testing.assert_array_equal(
        d_t.numpy(), np.asarray(d_p).transpose(0, 2, 1)[:, :P]
    )


def test_pair_walk_matches_jax():
    rng = np.random.default_rng(4)
    rows, P, W = 64, 16, 32
    # Walks over real DP output ...
    ca, cb, la, lb, lo, km = _pairs(rng, P, rows, W, bw=4)
    _, dirs = banded_pair_plain(*_t(ca, cb, la, lb, lo, km), 0.0, -1.0, 5.0, 1.0, rows, W)
    want = jax_pair_walk(jnp.asarray(dirs.numpy()), la, lb, lo)
    got = _pair_walk_kernel(dirs, *_t(la, lb, lo))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # ... and over adversarial direction planes (all legal encodings).
    choice = rng.integers(0, 3, (rows, P, W))
    dirs_g = (
        choice
        + (rng.integers(0, 2, (rows, P, W)) << 2)
        + (rng.integers(0, 2, (rows, P, W)) << 3)
    ).astype(np.int8)
    lens_a = rng.integers(1, rows // 2, P).astype(np.int32)
    lens_b = rng.integers(1, rows // 2, P).astype(np.int32)
    lo_g = (np.minimum(0, lens_b - lens_a) - 8).astype(np.int32)
    want = jax_pair_walk(jnp.asarray(dirs_g), lens_a, lens_b, lo_g)
    got = _pair_walk_kernel(*_t(dirs_g, lens_a, lens_b, lo_g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for p in range(P):
        assert not got.numpy()[lens_a[p]:, p].any(), p


def test_merge_dp_walk_matches_jax():
    rng = np.random.default_rng(5)
    P, rows, W = 12, 64, 64
    la = rng.integers(10, rows + 1, P).astype(np.int32)
    lb = np.clip(la + rng.integers(-10, 11, P), 1, None).astype(np.int32)
    diff = lb.astype(np.int64) - la
    lo = (np.minimum(0, diff) - 8).astype(np.int32)
    kmax = (np.maximum(0, diff) + 8 - lo).astype(np.int32)
    karr = np.arange(W)
    live = (np.arange(1, rows + 1)[None, :, None] <= la[:, None, None]) & (
        karr[None, None, :] <= kmax[:, None, None]
    )
    # Integer-ish weights make ties common: the tie rules must agree.
    cost = np.where(live, rng.integers(0, 4, (P, rows, W)) * 25.0, -1.0e9).astype(np.float32)
    want = _merge_dp_walk(
        jnp.asarray(cost), jnp.asarray(la), jnp.asarray(lb), jnp.asarray(lo),
        jnp.asarray(kmax),
    )
    c, la_t, lb_t, lo_t, km_t = _t(cost, la, lb, lo, kmax)
    dirs = _profile_merge_kernel(c, la_t, lb_t, lo_t, km_t)
    got = _merge_walk_kernel(dirs, la_t, lb_t, lo_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ordered_add_is_sequential():
    """Duplicate targets add in entry order: bit-equal to a sequential loop."""
    rng = np.random.default_rng(6)
    target = rng.integers(0, 50, 4000)
    w = (rng.random(4000) * 100).astype(np.float32) / np.float32(3.0)
    want = np.zeros(50, np.float32)
    for t, x in zip(target, w):
        want[t] = np.float32(want[t] + x)
    got = torch.zeros(50, dtype=torch.float32)
    _ordered_add_(got, torch.tensor(target), torch.tensor(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_banded_pair_align_scores():
    codes = np.zeros((2, 8), np.int8)
    codes[0] = [0, 1, 2, 3, 0, 1, 2, 3]
    codes[1] = codes[0]
    lens = np.full(2, 8, np.int32)
    sub = codes.copy()
    sub[1, 3] = 0
    scores, paths = banded_pair_align(codes, lens, sub, lens, 0, -1, 5, 1, 4)
    assert scores[0] == 0.0 and scores[1] == -1.0
    assert paths[0][0].tolist() == list(range(1, 9))
    assert paths[0][1].tolist() == list(range(1, 9))

    rng = np.random.default_rng(8)
    a = "".join(rng.choice(list("ACGT"), 60))
    codes, lengths = encode_batch([a, a[:20] + a[40:]])  # one 20-base deletion
    scores, _ = banded_pair_align(codes[:1], lengths[:1], codes[1:], lengths[1:], 0, -1, 5, 1, 5)
    assert scores[0] == -(5 + 19)
    assert band_halfwidth(60, 40, 5) == (-25, 5)


def test_multi_read_align_matches_jax_host_library(monkeypatch):
    monkeypatch.setenv("SARLACC_HOST_LIB", "1")
    rng = np.random.default_rng(9)
    seqs, groups = [], []
    for g, (length, n) in enumerate([(150, 5), (120, 4), (180, 6), (90, 1)]):
        ref = "".join(rng.choice(list("ACGT"), length))
        groups.append(list(range(len(seqs), len(seqs) + n)))
        seqs += noisy_copies(rng, ref, n)
    quals = ["".join(chr(int(c)) for c in rng.integers(40, 74, len(s))) for s in seqs]
    want = jax_multi_read_align(
        JSeqBatch.from_strings(seqs, quals), groups=groups, bandwidth=30, max_error=0.05
    )
    got = multi_read_align(
        SeqBatch.from_strings(seqs, quals), groups=groups, bandwidth=30,
        max_error=0.05, device="cpu",
    )
    assert got["alignments"] == want["alignments"]
    assert got["qualities"] == want["qualities"]


HAND_DERIVED = [
    (["ACGTTGCA"] * 3, ["ACGTTGCA"] * 3),
    (["ACGTTGCA", "ACGATGCA", "ACGTTGCA"], ["ACGTTGCA", "ACGATGCA", "ACGTTGCA"]),
    (["ACGTAGCT", "ACGTGCT", "ACGTAGCT"], ["ACGTAGCT", "ACGT-GCT", "ACGTAGCT"]),
    (["ACGTGCT", "ACGTGCT", "ACGTAGCT"], ["ACGT-GCT", "ACGT-GCT", "ACGTAGCT"]),
    (["ACGTAGCT", "ACGTGCT", "CGTAGCT"], ["ACGTAGCT", "ACGT-GCT", "-CGTAGCT"]),
    (["ACGATCGT", "ACGCGT", "ACGATCGT"], ["ACGATCGT", "ACG--CGT", "ACGATCGT"]),
    (
        ["ACGTGCAT", "ACGTGCAT", "ACGTAGCAT", "ACGTGCAT"],
        ["ACGT-GCAT", "ACGT-GCAT", "ACGTAGCAT", "ACGT-GCAT"],
    ),
    (
        ["ACGTAGCTA", "ACGTGCTA", "ACGTAGCTA", "ACGTAGTA", "ACGTAGCTA"],
        ["ACGTAGCTA", "ACGT-GCTA", "ACGTAGCTA", "ACGTAG-TA", "ACGTAGCTA"],
    ),
    (
        ["ACGTAGCAT", "ACGTGCAT", "ACGTAGCAT", "ACGTCGCAT", "ACGTAGCAT", "ACGTAGCAT"],
        ["ACGTAGCAT", "ACGT-GCAT", "ACGTAGCAT", "ACGTCGCAT", "ACGTAGCAT", "ACGTAGCAT"],
    ),
    (
        ["ACGTAGCAT", "ACGTAGCAT", "TCGTGCAT", "TCGTGCAT"],
        ["ACGTAGCAT", "ACGTAGCAT", "TCGT-GCAT", "TCGT-GCAT"],
    ),
    (
        ["ACGTAGCAT", "GTAGCAT", "ACGTAGCAT", "ACGTAGC"],
        ["ACGTAGCAT", "--GTAGCAT", "ACGTAGCAT", "ACGTAGC--"],
    ),
]


@pytest.mark.parametrize("case", range(len(HAND_DERIVED)))
def test_hand_derived_msa_goldens(case):
    """The curated unique-optimum groups of test_msa.py, through the port."""
    seqs, want = HAND_DERIVED[case]
    out = multi_read_align(SeqBatch.from_strings(seqs), device="cpu")
    assert out["alignments"][0] == want


def test_groups_guard_and_masking():
    batch = SeqBatch.from_strings(["ACGTACGT", "ACGTACGA", "TTTT"])
    out = multi_read_align(batch, groups=[[2], [], [0, 1]], device="cpu")
    assert out["alignments"][0] == ["TTTT"] and out["alignments"][1] == []
    assert [a.replace("-", "") for a in out["alignments"][2]] == ["ACGTACGT", "ACGTACGA"]
    with pytest.raises(ValueError, match="same"):
        multi_read_align(batch, groups=np.array([0, 0, 1, 1]), device="cpu")

    rng = np.random.default_rng(10)
    long_read = "".join(rng.choice(list("ACGT"), MAX_MSA_READ_LEN + 100))
    with pytest.raises(ValueError, match="32000"):
        multi_read_align(SeqBatch.from_strings([long_read, long_read[:-5]]), device="cpu")

    seqs, quals = ["ACGTACGT", "ACGTACGT"], ["II#IIIII", "IIIIIIII"]
    masked = SeqBatch.from_strings(seqs, quals)
    aln = multi_read_align(masked, max_error=0.01, device="cpu")["alignments"][0]
    assert all(a.replace("-", "") == s for a, s in zip(aln, seqs))
    kept = multi_read_align(masked, max_error=0.01, keep_mask=True, device="cpu")
    assert "N" in kept["alignments"][0][0]


def test_pair_kernel_rejects_cpu_tensors():
    rng = np.random.default_rng(12)
    args = _t(*_pairs(rng, 2, 64, 64))
    before = PAIR_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        pair_kernel(*args, 0.0, -1.0, 5.0, 1.0, 64, 64)
    assert PAIR_KERNEL.launches == before

"""PyTorch port, consensus: parity with the JAX package on the CPU.

Quality mode (float64) and basic mode (float32, as the JAX path computes
it) must give the same sequences and Phred strings; the reference's error
messages come through verbatim.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from sarlacc_tpu.api.consensus import consensus_read_seq as jax_consensus  # noqa: E402
from sarlacc_tpu_torch.api.consensus import consensus_read_seq  # noqa: E402
from sarlacc_tpu_torch.ops.consensus import log1pexp  # noqa: E402


def _msas(rng, ngroups, unknown=False):
    """Random gapped MSAs of varying depth and width, with per-read quals."""
    groups, quals = [], []
    alphabet = list("ACGTN-") + (["X"] if unknown else [])
    for _ in range(ngroups):
        g = int(rng.integers(1, 12))
        w = int(rng.integers(1, 70))
        centre = rng.choice(list("ACGT"), w)
        rows = []
        for _ in range(g):
            noise = rng.random(w) < 0.25
            row = np.where(noise, rng.choice(alphabet, w), centre)
            rows.append("".join(row))
        groups.append(rows)
        quals.append([
            "".join(chr(int(c)) for c in rng.integers(33, 75, len(r.replace("-", ""))))
            for r in rows
        ])
    return groups, quals


@pytest.mark.parametrize("unknown", [False, True])
def test_quality_mode_matches_jax(unknown):
    rng = np.random.default_rng(50 + unknown)
    groups, quals = _msas(rng, 40, unknown=unknown)
    want = jax_consensus(groups, qualities=quals)
    got = consensus_read_seq(groups, qualities=quals, device="cpu")
    assert got.seq_strings() == want.seq_strings()
    assert got.qual_strings() == want.qual_strings()


@pytest.mark.parametrize("pseudo,cov", [(1.0, 0.6), (0.5, 0.3)])
def test_basic_mode_matches_jax(pseudo, cov):
    rng = np.random.default_rng(60)
    groups, _ = _msas(rng, 40)
    want = jax_consensus(groups, pseudo_count=pseudo, min_coverage=cov)
    got = consensus_read_seq(groups, pseudo_count=pseudo, min_coverage=cov, device="cpu")
    assert got.seq_strings() == want.seq_strings()
    assert got.qual_strings() == want.qual_strings()


def test_log1pexp_branches():
    x = torch.tensor([-50.0, -37.0, -1.0, 0.0, 18.0, 20.0, 33.3, 40.0], dtype=torch.float64)
    want = [np.exp(-50.0), np.exp(-37.0), np.log1p(np.exp(-1.0)), np.log1p(1.0),
            np.log1p(np.exp(18.0)), 20.0 + np.exp(-20.0), 33.3 + np.exp(-33.3), 40.0]
    np.testing.assert_allclose(log1pexp(x).numpy(), want, rtol=1e-15)


@pytest.mark.parametrize(
    "groups,quals,message",
    [
        ([["ACXT"]], None, "unknown character 'X' in alignment string"),
        ([["AC-T"]], [["III"]], None),
        ([["ACGT"]], [["III"]], "quality vector is shorter than the alignment sequence"),
        ([["AC-T"]], [["IIII"]], "quality vector is longer than the alignment sequence"),
        ([["ACGT"]], [["II I"]], "quality cannot be lower than smallest encoded value"),
        ([["ACG", "AC"]], None, "alignment strings should have equal width"),
    ],
)
def test_errors_verbatim(groups, quals, message):
    if message is None:
        out = consensus_read_seq(groups, qualities=quals, device="cpu")
        assert out.seq_strings() == jax_consensus(groups, qualities=quals).seq_strings()
        return
    with pytest.raises(ValueError) as want:
        jax_consensus(groups, qualities=quals)
    with pytest.raises(ValueError) as got:
        consensus_read_seq(groups, qualities=quals, device="cpu")
    assert str(got.value) == str(want.value) == message

"""PyTorch port, a long-read UMI group: parity with the JAX package on the CPU.

The UMI group of a 4-5-kb cDNA molecule holds full-length reads and reads
truncated to a few hundred bases from the UMI end.  Each full x truncated
pair differs in length by ~4 kb, so its band, |la - lb| + 2 * 100 + 1
cells, buckets to W 8 192: kernel B's wide route on the card, its plain
version here.  The group (a 260-bp read cut from the start of a 4.3-kb
read, the read and a noisy copy of it; the cut read first, so both wide
pairs run 512 rows and the full pair 8 192 rows of W 256) goes through
``multi_read_align(device="cpu")`` on both library routes, each equal to
JAX's same route, then ``consensus_read_seq`` equal to JAX's.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402,F401

from sarlacc_tpu.api.consensus import consensus_read_seq as jax_consensus  # noqa: E402
from sarlacc_tpu.api.msa import multi_read_align as jax_multi_read_align  # noqa: E402
from sarlacc_tpu.core.encode import SeqBatch as JSeqBatch  # noqa: E402
from sarlacc_tpu_torch.api import msa as port_api_msa  # noqa: E402
from sarlacc_tpu_torch.api.consensus import consensus_read_seq  # noqa: E402
from sarlacc_tpu_torch.api.msa import multi_read_align  # noqa: E402
from sarlacc_tpu_torch.core.encode import SeqBatch  # noqa: E402
from sarlacc_tpu_torch.ops import msa as port_ops_msa  # noqa: E402
from test_torch_msa import noisy_copies  # noqa: E402


def long_read_group(seed=13, length=4300, cut=260):
    """(seqs, quals): a read of ``cut`` bases cut from the start of a
    ``length``-base molecule, then two noisy full-length reads of it."""
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT"), length))
    full, copy = noisy_copies(rng, ref, 2)
    short = noisy_copies(rng, ref[:cut], 1)[0]
    seqs = [short, full, copy]
    quals = ["".join(chr(int(c)) for c in rng.integers(40, 74, len(s))) for s in seqs]
    return seqs, quals


def test_long_read_group_takes_the_wide_band():
    """Both full x cut pairs bucket to W 8 192 (the wide route's width) at 512
    rows; the full x full pair to 8 192 rows of W 256."""
    seqs, _ = long_read_group()
    lens = np.array([len(s) for s in seqs])
    x, y = np.triu_indices(3, 1)  # pairs x < y, as api/msa.py forms them
    _, _, rows, W = port_ops_msa._pair_buckets(lens[x], lens[y], 100)
    assert list(zip(rows.tolist(), W.tolist())) == [(512, 8192), (512, 8192), (8192, 256)]


@pytest.mark.parametrize("route", ["device", "host"])
def test_long_read_group_matches_jax(monkeypatch, route):
    """``multi_read_align`` on each library route (the device route as
    ``_device_lib_ok`` gives it, the host route by ``SARLACC_HOST_LIB=1``)
    equal to JAX's same route, alignments and qualities; the consensus
    equal to JAX's consensus of JAX's alignment."""
    if route == "host":
        monkeypatch.setenv("SARLACC_HOST_LIB", "1")
    else:
        monkeypatch.delenv("SARLACC_HOST_LIB", raising=False)
    seqs, quals = long_read_group()
    lens = np.array([len(s) for s in seqs])
    groups = [[0, 1, 2]]
    assert port_api_msa._device_lib_ok(lens, [np.arange(3)], [0], torch.device("cpu"))
    want = jax_multi_read_align(JSeqBatch.from_strings(seqs, quals), groups=groups)
    got = multi_read_align(SeqBatch.from_strings(seqs, quals), groups=groups, device="cpu")
    assert got["alignments"] == want["alignments"]
    assert got["qualities"] == want["qualities"]
    assert len({len(s) for s in got["alignments"][0]}) == 1 and len(got["alignments"][0][0]) >= 4300
    cons = consensus_read_seq(got, device="cpu")
    jcons = jax_consensus(want)
    assert cons.seq_strings() == jcons.seq_strings()
    assert cons.qual_strings() == jcons.qual_strings()
    assert len(cons.seq_strings()[0]) > 4000

"""PyTorch port, the pure-host exports: parity with the JAX package.

``error_finder``, ``homopolymer_finder``, ``homopolymer_matcher`` and
``sam2ranges`` are numpy copies in the port; each is held against the JAX
function on the inputs of tests/test_error_homopolymer.py and
tests/test_frame_io.py:110-126.  Then the port's export list is checked
against the JAX package's 19 names.
"""

import numpy as np

import sarlacc_tpu.api as jax_api
import sarlacc_tpu_torch as tst
from sarlacc_tpu.api.profiling import error_finder as jax_error_finder
from sarlacc_tpu.api.profiling import homopolymer_finder as jax_homopolymer_finder
from sarlacc_tpu.api.profiling import homopolymer_matcher as jax_homopolymer_matcher
from sarlacc_tpu.io.sam import sam2ranges as jax_sam2ranges


def _frame_equal(got, want):
    assert got.colnames == want.colnames
    assert got.rownames == want.rownames
    for col in want.colnames:
        g, w = got[col], want[col]
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert list(g) == list(w), col
    assert sorted(got.metadata) == sorted(want.metadata)
    for key, w in want.metadata.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got.metadata[key], w)
        else:
            assert got.metadata[key] == w, key


def test_error_finder_equal():
    for pair in (
        (["ACGT"] * 3, ["ACGT", "TCGT", "AAGT"]),
        (["AC-GT", "ACGT-"], ["ACAG-", "AC-TA"]),
        (["ACGT", "ACGT"], ["ACTT", "GCGT"]),
    ):
        _frame_equal(tst.error_finder(pair), jax_error_finder(pair))


def test_homopolymer_finder_equal():
    rng = np.random.default_rng(42)
    seqs = ["AAACCGT", "ACGT", "AA--A"] + [
        "".join(rng.choice(list("ACGT-"), int(rng.integers(5, 40)), p=[0.3, 0.2, 0.2, 0.2, 0.1]))
        for _ in range(20)
    ]
    got, want = tst.homopolymer_finder(seqs), jax_homopolymer_finder(seqs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _frame_equal(g, w)


def test_homopolymer_matcher_equal():
    for pair in (
        (["AAACC", "AAACC"], ["AAACC", "AA-CC"]),
        (["AAA-TCGG-"], ["AA--TCGGG"]),
        (["AAAA"], ["CCCC"]),
        (["AAATCGG"], ["AAATCGG"]),
    ):
        _frame_equal(tst.homopolymer_matcher(pair), jax_homopolymer_matcher(pair))


def test_sam2ranges_equal(tmp_path):
    fp = tmp_path / "reads.sam"
    fp.write_text(
        "@HD\tVN:1.6\n@SQ\tSN:chrA\tLN:500\n@SQ\tSN:chrB\tLN:300\n"
        "r1\t0\tchrA\t10\t60\t50M\t*\t0\t0\t*\t*\n"
        "r2\t16\tchrB\t20\t60\t5H10S40M3S\t*\t0\t0\t*\t*\n"
        "r3\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n"
        "r4\t0\tchrA\t5\t2\t30M2D4N\t*\t0\t0\t*\t*\n"
    )
    for kw in ({"minq": 10}, {"minq": None}, {"minq": None, "restricted": ["chrB"]}):
        _frame_equal(tst.sam2ranges(str(fp), **kw), jax_sam2ranges(str(fp), **kw))


def test_port_exports_every_jax_name():
    assert len(jax_api.__all__) == 19
    assert set(jax_api.__all__) <= set(tst.__all__)
    assert set(tst.__all__) - set(jax_api.__all__) == {"read_fastq"}

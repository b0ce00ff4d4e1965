"""PyTorch port, demultiplexing and calibration: parity with the JAX package.

The port's plain score-only DPs (the CPU sides of kernels C and D) against
the Pallas ``_kernel`` and ``_segments_kernel`` in interpret mode, bit for
bit; then the entry points (``barcode_align``, ``get_barcode_thresholds``,
``tune_alignment``, ``get_adaptor_thresholds``, ``filter_reads``,
``extract_subseq``, ``quality_align``) against the JAX ones on the same
inputs.  Inputs are made with numpy from a seed; the JAX side runs in
float32, as its ``prepare_adaptor`` default.  Scores agree within 2e-4 (the
JAX tests' tolerance class, ``tests/test_adaptor_api.py:258-260``); ids,
parameters, thresholds, strings and edits exactly.  The golden demux
snapshot also runs on the card (its ``cuda`` case); on a machine without
JAX the file is collected for that case alone, with ``-m cuda``.
"""

import json
import os
import pathlib
import tempfile

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

try:
    import jax.numpy as jnp
    import sarlacc_tpu as jst
    from sarlacc_tpu.api.align_internal import align_scores_only as jax_align_scores_only
    from sarlacc_tpu.api.align_internal import prepare_adaptor as jax_prepare_adaptor
    from sarlacc_tpu.core.encode import SeqBatch
    from sarlacc_tpu.io import fastq as jax_fastq
    from sarlacc_tpu.ops import pallas_align as pa
    from sarlacc_tpu.ops.align import dp_align as jax_dp_align
    from sarlacc_tpu.ops.align import prepare_reads as jax_prepare_reads
    from sarlacc_tpu.ops.backtrack import string_walk_device
except ImportError:  # a card's machine has no JAX: collect the file for its cuda case (-m cuda)
    pass

import sarlacc_tpu_torch as tst  # noqa: E402
from sarlacc_tpu_torch.api.align_internal import (  # noqa: E402
    align_scores_only,
    prepare_adaptor,
    prepare_scores_input,
)
from sarlacc_tpu_torch.api.tune import scramble_input  # noqa: E402
from sarlacc_tpu_torch.core.encode import SeqBatch as TSeqBatch  # noqa: E402
from sarlacc_tpu_torch.io import fastq as port_fastq  # noqa: E402
from sarlacc_tpu_torch.ops.align import (  # noqa: E402
    dp_scores,
    dp_scores_segments,
    prepare_reads,
    prepared_from_numpy,
    segments_from_numpy,
)
from sarlacc_tpu_torch.ops.backtrack import string_walk  # noqa: E402
from sarlacc_tpu_torch.ops.cuda_align import (  # noqa: E402
    build_cost_planes,
    encode_mask,
    fit_dirs,
    fit_scores,
    fit_scores_from_planes,
    fit_scores_segments,
    pack_segments,
    plane_dims,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ADAPTOR1 = "ACGCTAGCATCAGTC" + "NNNN" + "CACAGCTACGA" + "NNNNNNNN" + "CGTACGCAT"
ADAPTOR2 = "TGCATCGATCGCAT"
BARCODE = "ACGTTGCACGTA"
REFS = {0: "", 12: BARCODE, 14: ADAPTOR2, 51: ADAPTOR1 + "NNNN"}
ATOL = 2e-4


def _strings(rng, n, minl, maxl, alphabet="ACGTN"):
    seqs, quals = [], []
    for _ in range(n):
        ln = int(rng.integers(minl, maxl + 1))
        seqs.append("".join(rng.choice(list(alphabet), ln)))
        quals.append("".join(chr(int(c)) for c in rng.integers(33, 91, ln)))
    return seqs, quals


def _both(seqs, quals, names=None):
    return SeqBatch.from_strings(seqs, quals, names), TSeqBatch.from_strings(seqs, quals, names)


def _jax_planes(jb, tables):
    """The JAX package's planes for ``jb`` (its own l1 rounding, to 8)."""
    codes, qidx, lengths = jax_prepare_reads(jb, tables)
    l1, n_pad = pa.plane_dims(*codes.shape)
    planes = pa.build_cost_planes(
        jnp.asarray(codes, jnp.int8), jnp.asarray(qidx, jnp.int8),
        jnp.asarray(tables.match, jnp.float32), jnp.asarray(tables.mismatch, jnp.float32),
        l1=l1, n_pad=n_pad,
    )
    return planes, jnp.asarray(lengths, jnp.int32), l1, n_pad


def _port_planes(tb, tables):
    codes, qidx, lengths = prepare_reads(tb, tables)
    l1, n_pad = plane_dims(*codes.shape)
    mt = torch.as_tensor(np.asarray(tables.match, np.float32))
    mmt = torch.as_tensor(np.asarray(tables.mismatch, np.float32))
    return build_cost_planes(codes, qidx, mt, mmt, l1, n_pad), lengths, l1, n_pad


# ---------------------------------------------------------------- kernels C, D


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("R", sorted(REFS))
def test_fit_scores_from_planes_matches_pallas(local, R):
    """Kernel C's plain side against the Pallas ``_kernel`` (interpret),
    bit for bit, reads of length 0 included; R = 0 takes the early return
    of ``pallas_align.py:539-546`` on both sides."""
    rng = np.random.default_rng(300 + R + local)
    seqs, quals = _strings(rng, 37, 0, 59)
    seqs[:2], quals[:2] = ["", ""], ["", ""]
    jb, tb = _both(seqs, quals)
    jad = jax_prepare_adaptor(REFS[R])
    jplanes, jlens, jl1, jn_pad = _jax_planes(jb, jad.tables)
    want = np.asarray(pa.fit_scores_from_planes(
        jplanes, jlens, jad.modes, jad.matched, 5.0, 1.0,
        l1=jl1, n_pad=jn_pad, local=local, interpret=True,
    ))
    modes, matched, _, _ = prepared_from_numpy(jad.modes, jad.matched, jad.match_tab, jad.mismatch_tab)
    planes, lengths, l1, n_pad = _port_planes(tb, jad.tables)
    got = fit_scores_from_planes(planes, lengths, modes, matched, 5.0, 1.0, l1, n_pad, local)
    assert got.dtype == torch.float32 and got.shape == (37,)
    np.testing.assert_array_equal(got.numpy(), want)
    # The one-call form builds its own planes and agrees bit for bit.
    codes, qidx, _ = prepare_reads(tb, jad.tables)
    mt, mmt = (torch.as_tensor(np.asarray(t, np.float32)) for t in (jad.match_tab, jad.mismatch_tab))
    again = fit_scores(codes, qidx, lengths, modes, matched, mt, mmt, 5.0, 1.0, local)
    np.testing.assert_array_equal(again.numpy(), want)


def _segment_list():
    ads = [jax_prepare_adaptor(r) for r in (BARCODE, ADAPTOR2, REFS[51], "GATTACA")]
    return [
        (ads[0].modes, ads[0].matched, 5.0, 1.0, False),
        (ads[1].modes, ads[1].matched, 4.0, 2.0, True),
        (ads[2].modes, ads[2].matched, 6.0, 1.0, True),
        (ads[3].modes, ads[3].matched, 3.0, 1.5, False),
        (ads[0].modes, ads[0].matched, 7.0, 3.0, True),
    ]


def test_segments_match_pallas():
    """Kernel D's plain side against ``_segments_kernel`` (interpret): mixed
    local/global segments of different R and penalties in one call."""
    rng = np.random.default_rng(7)
    seqs, quals = _strings(rng, 29, 0, 40)
    jb, tb = _both(seqs, quals)
    segs = _segment_list()
    tables = jax_prepare_adaptor(BARCODE).tables
    jplanes, jlens, jl1, jn_pad = _jax_planes(jb, tables)
    want = np.asarray(pa.fit_scores_segments(jplanes, jlens, segs, l1=jl1, n_pad=jn_pad, interpret=True))
    planes, lengths, l1, n_pad = _port_planes(tb, tables)
    got = fit_scores_segments(planes, lengths, segments_from_numpy(segs), l1, n_pad)
    assert got.shape == (len(segs), 29)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segments_equal_single_launches_with_empty_segment():
    """Each row equals the one-reference call for its segment, an empty
    reference first included.  (The JAX ``fit_scores_segments`` does not
    hold this: its ``_encode_mask`` gives an empty segment one mask entry,
    ``pallas_align.py:451-457,720``, shifting the later segments' masks.)"""
    rng = np.random.default_rng(8)
    seqs, quals = _strings(rng, 21, 0, 14, "ACGT")
    _, tb = _both(seqs, quals)
    empty, bc = prepare_adaptor(""), prepare_adaptor(BARCODE)
    planes, lengths, l1, n_pad = _port_planes(tb, bc.tables)
    segs = [(empty.modes, empty.matched, 5.0, 1.0, False), (bc.modes, bc.matched, 5.0, 1.0, False),
            (empty.modes, empty.matched, 5.0, 1.0, True)]
    got = fit_scores_segments(planes, lengths, segs, l1, n_pad)
    for s, (modes, matched, go, ge, local) in enumerate(segs):
        one = fit_scores_from_planes(planes, lengths, modes, matched, go, ge, l1, n_pad, local)
        np.testing.assert_array_equal(got[s].numpy(), one.numpy())


def test_dp_scores_segments_padded_lanes_read_row_zero():
    """Lanes past N carry length 0; their output is row 0 of the last column."""
    rng = np.random.default_rng(9)
    seqs, quals = _strings(rng, 5, 1, 12)
    _, tb = _both(seqs, quals)
    bc = prepare_adaptor(BARCODE)
    (costm, costmm, codes_k), lengths, l1, n_pad = _port_planes(tb, bc.tables)
    modes, mask, segs = pack_segments([(bc.modes, bc.matched, 5.0, 1.0, False)], "cpu")
    lens_k = torch.zeros(n_pad, dtype=torch.int32)
    lens_k[:5] = lengths
    out = dp_scores_segments(modes, mask, segs, costm, costmm, codes_k, lens_k)
    S = dp_scores(modes, mask, 5.0, 1.0, costm, costmm, codes_k, False)
    np.testing.assert_array_equal(out[0, 5:].numpy(), S[0, 5:].numpy())
    np.testing.assert_array_equal(out[0, :5].numpy(), S[lengths.long(), torch.arange(5)].numpy())
    assert encode_mask(bc.matched).shape == (12,)


def test_align_scores_only_matches_jax():
    """The score-only entry point, with and without a prepared batch, and
    the ``((codes, qidx, lengths), n)`` unpacking."""
    rng = np.random.default_rng(10)
    seqs, quals = _strings(rng, 17, 0, 70)
    jb, tb = _both(seqs, quals)
    want = jax_align_scores_only(jax_prepare_adaptor(ADAPTOR1), jb, 5.0, 1.0)
    ad = prepare_adaptor(ADAPTOR1, device="cpu")
    got = align_scores_only(ad, tb, 5.0, 1.0)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    prepared = prepare_scores_input(ad, tb)
    (codes, qidx, lengths), n = prepared
    assert n == 17 and tuple(codes.shape) == tuple(tb.codes.shape)
    again = align_scores_only(ad, None, 5.0, 1.0, prepared=prepared, as_device=True)
    assert isinstance(again, torch.Tensor) and again.dtype == torch.float32
    np.testing.assert_array_equal(again.numpy().astype(np.float64), got)


# ---------------------------------------------------------------- barcodes


@pytest.mark.parametrize("nbc", [6, 1, 0])
def test_barcode_align_matches_jax(nbc):
    rng = np.random.default_rng(20 + nbc)
    barcodes = ["".join(rng.choice(list("ACGT"), 8)) for _ in range(nbc)]
    seqs, quals = _strings(rng, 40, 0, 11)
    seqs[3:3 + nbc] = barcodes  # exact hits
    quals[3:3 + nbc] = ["I" * 8] * nbc
    jb, tb = _both(seqs, quals)
    want = jst.barcode_align(jb, barcodes)
    got = tst.barcode_align(tb, barcodes, device="cpu")
    np.testing.assert_array_equal(got["barcode"], want["barcode"])
    np.testing.assert_allclose(got["score"], want["score"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["gap"], want["gap"], atol=ATOL, rtol=0)
    assert got.metadata == want.metadata
    if nbc == 1:
        assert np.all(np.isposinf(got["gap"]))
    if nbc == 0:
        assert np.all(got["barcode"] == -1) and np.all(np.isneginf(got["score"]))
        assert np.all(np.isnan(got["gap"]))
    if nbc > 1:
        thr_w = jst.get_barcode_thresholds(want, nmads=3)
        thr_g = tst.get_barcode_thresholds(got, nmads=3, device="cpu")
        assert thr_g == pytest.approx(thr_w, abs=ATOL)


def test_barcode_align_ties_and_empty_barcode():
    """Duplicate barcodes tie exactly: the first wins and the gap is 0.  An
    empty barcode scores the global gap ramp (R = 0)."""
    rng = np.random.default_rng(30)
    seqs, quals = _strings(rng, 25, 0, 9, "ACGT")
    jb, tb = _both(seqs, quals)
    barcodes = ["ACGTAC", "", "ACGTAC", "TTGACA"]
    want = jst.barcode_align(jb, barcodes)
    got = tst.barcode_align(tb, barcodes, device="cpu")
    np.testing.assert_array_equal(got["barcode"], want["barcode"])
    np.testing.assert_allclose(got["score"], want["score"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["gap"], want["gap"], atol=ATOL, rtol=0)
    assert not np.any(got["barcode"] == 2)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_golden_barcode_demux_through_port(device):
    """tests/golden/barcode_demux.json (test_golden_suite.py:127-156) through
    the port's adaptor_align -> barcode_align -> get_barcode_thresholds, on
    the CPU and (``cuda`` case) through kernels A, D and G on the card."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    rng = np.random.default_rng(11)
    barcodes = ["".join(rng.choice(list("ACGT"), 4)) for _ in range(6)]
    fp = tempfile.mktemp(suffix=".fastq")
    try:
        tst.mock_reads(ADAPTOR1, ADAPTOR2, fp, all_barcodes=barcodes, nmolecules=12,
                       nreads_range=(3, 6), seqlen_range=(300, 500), seed=42)
        batch = tst.read_fastq(fp)
    finally:
        os.remove(fp)
    aligned = tst.adaptor_align(ADAPTOR1, ADAPTOR2, reads=batch, tolerance=200, device=device)
    observed = aligned["adaptor1"]["subseq"]["Sub1"]
    baligned = tst.barcode_align(observed, barcodes, device=device)
    thr = tst.get_barcode_thresholds(baligned, nmads=3, device=device)
    snap = {
        "barcodes": barcodes,
        "observed": observed.seq_strings(),
        "assigned": [int(b) for b in baligned["barcode"]],
        "score": [round(float(s), 4) for s in baligned["score"]],
        "gap": [round(float(g), 4) for g in baligned["gap"]],
        "thr_score": round(thr["score"], 4),
        "thr_gap": round(thr["gap"], 4),
    }
    want = json.loads((ROOT / "tests" / "golden" / "barcode_demux.json").read_text())
    assert sorted(snap) == sorted(want)
    for key in want:
        assert snap[key] == want[key], f"golden mismatch in {key!r}"


# ---------------------------------------------------------------- calibration


@pytest.fixture(scope="module")
def mock_fastq():
    fp = tempfile.mktemp(suffix=".fastq")
    jst.mock_reads(ADAPTOR1, ADAPTOR2, fp, nmolecules=3, nreads_range=(5, 9),
                   seqlen_range=(120, 200), seed=3)
    yield fp
    os.remove(fp)


@pytest.fixture(scope="module")
def aligned_pair(mock_fastq):
    want = jst.adaptor_align(ADAPTOR1, ADAPTOR2, filepath=mock_fastq, tolerance=80, number=50)
    got = tst.adaptor_align(ADAPTOR1, ADAPTOR2, filepath=mock_fastq, tolerance=80,
                            number=50, device="cpu")
    return want, got


def test_sample_and_stream_fastq_equal_jax(mock_fastq):
    for want, got in (
        (jax_fastq.sample_fastq(mock_fastq, 7, seed=4), port_fastq.sample_fastq(mock_fastq, 7, seed=4)),
        *zip(jax_fastq.stream_fastq(mock_fastq, chunk_size=5),
             port_fastq.stream_fastq(mock_fastq, chunk_size=5)),
    ):
        assert got.names == want.names
        assert got.seq_strings() == want.seq_strings()
        assert got.qual_strings() == want.qual_strings()


def test_scramble_input_draws_as_jax():
    from sarlacc_tpu.api.tune import scramble_input as jax_scramble

    rng = np.random.default_rng(40)
    seqs, quals = _strings(rng, 12, 0, 30)
    jb, tb = _both(seqs, quals)
    want = jax_scramble(jb, np.random.default_rng(1))
    got = scramble_input(tb, np.random.default_rng(1))
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.quals, want.quals)
    np.testing.assert_array_equal(got.lengths, want.lengths)


def test_tune_alignment_matches_jax(mock_fastq):
    kw = dict(filepath=mock_fastq, tolerance=60, number=20, gap_op_range=(4, 6), gap_ext_range=(1, 2))
    want = jst.tune_alignment(ADAPTOR1, ADAPTOR2, **kw)
    got = tst.tune_alignment(ADAPTOR1, ADAPTOR2, device="cpu", **kw)
    assert got["parameters"] == want["parameters"]
    for key in ("reads", "scrambled"):
        np.testing.assert_allclose(got["scores"][key], want["scores"][key], atol=ATOL, rtol=0)


def test_tune_alignment_empty_and_reversed_ranges():
    empty = tst.tune_alignment(ADAPTOR1, ADAPTOR2, reads=TSeqBatch.from_strings([], []), device="cpu")
    assert empty["parameters"] == {"gapOpening": None, "gapExtension": None}
    rng = np.random.default_rng(41)
    seqs, quals = _strings(rng, 9, 20, 60, "ACGT")
    seqs = [ADAPTOR1.replace("N", "A") + s + "ATGCGATCGATGCA" for s in seqs]
    quals = [q + "I" * (len(s) - len(q)) for s, q in zip(seqs, quals)]
    jb, tb = _both(seqs, quals)
    # An upper bound below the lower one collapses to the lower (maximum.accumulate).
    kw = dict(tolerance=40, gap_op_range=(6, 3), gap_ext_range=(2, 1))
    want = jst.tune_alignment(ADAPTOR1, ADAPTOR2, reads=jb, **kw)
    got = tst.tune_alignment(ADAPTOR1, ADAPTOR2, reads=tb, device="cpu", **kw)
    assert got["parameters"] == want["parameters"] == {"gapOpening": 6, "gapExtension": 2}


def test_get_adaptor_thresholds_matches_jax(mock_fastq, aligned_pair):
    jal, tal = aligned_pair
    want = jst.get_adaptor_thresholds(jal, error=0.05)
    got = tst.get_adaptor_thresholds(tal, error=0.05, device="cpu")
    assert got["threshold1"] == want["threshold1"]
    assert got["threshold2"] == want["threshold2"]
    for key in ("scores1", "scores2"):
        np.testing.assert_array_equal(got[key]["reads"], want[key]["reads"])
        np.testing.assert_allclose(got[key]["scrambled"], want[key]["scrambled"], atol=ATOL, rtol=0)


def test_filter_reads_matches_jax(aligned_pair):
    jal, tal = aligned_pair
    for args in ((2.0, 3.0), (1e9, 1e9, False, False), (5.0, -1e9, True, False)):
        want = jst.filter_reads(jal, *args)
        got = tst.filter_reads(tal, *args, device="cpu")
        assert got.rownames == want.rownames
        np.testing.assert_array_equal(got["trim.start"], want["trim.start"])
        np.testing.assert_array_equal(got["trim.end"], want["trim.end"])


def test_extract_subseq_matches_jax(mock_fastq, aligned_pair):
    jal, tal = aligned_pair
    sections = (([1, 31], [15, 38]), ([3], [9]))
    want = jst.extract_subseq(jal, *sections, number=50)
    got = tst.extract_subseq(tal, *sections, number=50, device="cpu")
    for key in ("adaptor1", "adaptor2"):
        assert got[key].colnames == want[key].colnames
        for col in want[key].colnames:
            assert got[key][col].seq_strings() == want[key][col].seq_strings()
            assert got[key][col].qual_strings() == want[key][col].qual_strings()
    # A stored score that the realignment cannot reproduce raises.
    tal["adaptor1"]["score"] = np.asarray(tal["adaptor1"]["score"]) + 1.0
    with pytest.raises(ValueError, match="score mismatch"):
        tst.extract_subseq(tal, subseq1=([1], [5]), number=50, device="cpu")


# ---------------------------------------------------------------- quality_align


def test_string_walk_matches_jax():
    rng = np.random.default_rng(50)
    seqs, quals = _strings(rng, 15, 0, 40)
    jb, tb = _both(seqs, quals)
    ref = "ACGTTGCAGGACTNACGTAC"
    jad = jax_prepare_adaptor(ref)
    codes, qidx, lengths = jax_prepare_reads(jb, jad.tables)
    _, jdirs = jax_dp_align(codes, qidx, lengths, jad.modes, jad.matched, jad.match_tab,
                            jad.mismatch_tab, 5.0, 1.0, local=False, need_directions=True)
    wa, wb, wn = (np.asarray(x) for x in string_walk_device(jdirs, lengths))
    tad = prepare_adaptor(ref)
    tc, tq, tl = prepare_reads(tb, tad.tables)
    _, dirs, _ = fit_dirs(tc, tq, tl, tad.modes, tad.matched, tad.match_tab, tad.mismatch_tab,
                          5.0, 1.0, local=False)
    ga, gb, gn = string_walk(dirs, tl)
    np.testing.assert_array_equal(gn[:15].numpy(), wn)
    for i in range(15):
        k = int(wn[i])
        np.testing.assert_array_equal(ga[i, :k].numpy(), wa[i, :k])
        np.testing.assert_array_equal(gb[i, :k].numpy(), wb[i, :k])


@pytest.mark.parametrize("edit_only", [False, True])
def test_quality_align_matches_jax(edit_only):
    rng = np.random.default_rng(51 + edit_only)
    ref = "ACGTACGTACGTGGCCANNTTGCA"
    seqs, quals = _strings(rng, 23, 0, 35)
    seqs[5] = ref.replace("N", "C")
    quals[5] = "I" * len(seqs[5])
    jb, tb = _both(seqs, quals)
    want = jst.quality_align(jb, ref, edit_only=edit_only)
    got = tst.quality_align(tb, ref, edit_only=edit_only, device="cpu")
    assert got.colnames == want.colnames
    np.testing.assert_allclose(got["score"], want["score"], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got["edit"], want["edit"])
    if not edit_only:
        assert list(got["reference"]) == list(want["reference"])
        assert list(got["query"]) == list(want["query"])
    assert got.metadata == want.metadata


# ---------------------------------------------------------------- device


def test_new_entry_points_need_cuda_by_default(aligned_pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    _, tal = aligned_pair
    tb = TSeqBatch.from_strings(["ACGT"], ["IIII"])
    calls = [
        lambda: tst.barcode_align(tb, [BARCODE]),
        lambda: tst.get_barcode_thresholds(tst.barcode_align(tb, [BARCODE], device="cpu")),
        lambda: tst.tune_alignment(ADAPTOR1, ADAPTOR2, reads=tb),
        lambda: tst.get_adaptor_thresholds(tal),
        lambda: tst.filter_reads(tal, 0.0, 0.0),
        lambda: tst.extract_subseq(tal, subseq1=([1], [4])),
        lambda: tst.quality_align(tb, BARCODE),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

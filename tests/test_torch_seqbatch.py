"""PyTorch port, ``SeqBatch``'s row cuts against the JAX package's loops.

The port cuts reads into ends and sections with one gather over the whole
batch (``core/encode.py``); the JAX package's ``SeqBatch`` keeps the per-row
Python loops, numpy only.  Both run here on the same arrays and must agree
byte for byte: codes, int32 lengths, qualities or ``None``, names, widths
and dtypes.  ``adaptor_align`` cuts its input into chunks of row views, so
its output must not depend on ``number`` and its input must come back
unchanged.
"""

import hashlib
import os

import numpy as np
import pytest

from sarlacc_tpu.core.encode import SeqBatch as JaxSeqBatch
from sarlacc_tpu.core.encode import reverse_complement_codes as jax_reverse_complement_codes
from sarlacc_tpu_torch import adaptor_align
from sarlacc_tpu_torch.core.encode import GAP_CODE, SeqBatch, reverse_complement_codes
from sarlacc_tpu_torch.core.frame import Frame
from sarlacc_tpu_torch.io.fastq import read_fastq
from sarlacc_tpu_torch.io.mock import mock_reads

ADAPTOR1 = "ACGCTAGCATCAGTC" + "NNNN" + "CACAGCTACGA" + "NNNNNNNN" + "CGTACGCAT"
ADAPTOR2 = "TGCATCGATCGCAT"
TOL = 12


def _batch(lengths, width, quals, rng):
    """Random codes 0-5 (N and '-' included) up to each length, padding past it."""
    lengths = np.asarray(lengths, dtype=np.int32)
    n = len(lengths)
    live = np.arange(width) < lengths[:, None]
    codes = np.where(live, rng.integers(0, 6, (n, width)), GAP_CODE).astype(np.int8)
    q = np.where(live, rng.integers(33, 75, (n, width)), 0).astype(np.uint8) if quals else None
    return codes, lengths, q, [f"read{i}" for i in range(n)]


def _sections(lengths, width, rng):
    """(starts, ends), 1-based inclusive: a random stretch of each row,
    reaching into the padding up to the batch width."""
    starts = rng.integers(1, width + 2, len(lengths))
    ends = starts - 1 + rng.integers(0, width + 2 - starts)
    return starts, ends


def _case(name, quals, rng):
    """(codes, lengths, quals, names), tolerance, (starts, ends)."""
    if name == "empty":
        return _batch([], 0, quals, rng), TOL, (np.zeros(0, int), np.zeros(0, int))
    if name == "zero_lengths":
        lens, width = [0, 5, 0, 30, 0], 30
    elif name == "around_tolerance":
        lens, width = [TOL - 1, TOL, TOL + 1, 3, 40, TOL - 1], 40
    elif name == "full_width":
        lens, width = [25, 7, 25, 25], 25
    elif name == "zero_width_sections":
        lens, width = [9, 0, 16, 4, 16], 16
        batch = _batch(lens, width, quals, rng)
        # Width 0 at the first base and just past the row's last one.
        starts = np.array([1, 1, 17, 5, 1])
        return batch, TOL, (starts, starts - 1)
    else:  # random: short rows first, the last row's section up to the width
        lens = np.sort(rng.integers(0, 60, 40))
        width = int(lens.max())
        starts, ends = _sections(lens, width, rng)
        starts[-1], ends[-1] = width - 2, width
        return _batch(lens, width, quals, rng), TOL, (starts, ends)
    return _batch(lens, width, quals, rng), TOL, _sections(lens, width, rng)


def _same_array(got, want):
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def _same_batch(got, want):
    _same_array(got.codes, want.codes)
    _same_array(got.lengths, want.lengths)
    _same_array(got.quals, want.quals)
    assert got.names == want.names
    assert got.width == want.width


@pytest.mark.parametrize("quals", [True, False], ids=["quals", "no_quals"])
@pytest.mark.parametrize(
    "case", ["zero_lengths", "around_tolerance", "full_width", "zero_width_sections", "empty", "random"]
)
def test_row_cuts_match_jax_loops(case, quals):
    rng = np.random.default_rng(sum(map(ord, case)) + quals)
    arrays, tol, (starts, ends) = _case(case, quals, rng)
    got, want = SeqBatch(*arrays), JaxSeqBatch(*arrays)

    _same_batch(got.subseq(starts, ends), want.subseq(starts, ends))
    _same_batch(got.reverse_complement(), want.reverse_complement())
    _same_array(reverse_complement_codes(arrays[0], arrays[1]),
                jax_reverse_complement_codes(arrays[0], arrays[1]))
    for t in (tol, 0, arrays[0].shape[1] + 3):
        for g, w in zip(got.front_and_back(t), want.front_and_back(t)):
            _same_batch(g, w)


@pytest.mark.parametrize("start, end", [(0, 3), (9, 12)])
def test_subseq_refuses_a_slice_outside_its_row(start, end):
    """Both the loops and the gather refuse a slice that leaves the row's
    ten columns, before or after them."""
    arrays = _batch([10, 10], 10, True, np.random.default_rng(0))
    starts, ends = np.array([1, start]), np.array([4, end])
    with pytest.raises(ValueError):
        JaxSeqBatch(*arrays).subseq(starts, ends)
    with pytest.raises(ValueError):
        SeqBatch(*arrays).subseq(starts, ends)


def _same_frame(got, want):
    assert got.colnames == want.colnames
    assert got.metadata == want.metadata and got.rownames == want.rownames
    assert len(got) == len(want)
    for name in want.colnames:
        g, w = got[name], want[name]
        if isinstance(w, Frame):
            _same_frame(g, w)
        elif isinstance(w, SeqBatch):
            _same_batch(g, w)
        else:
            _same_array(g, w)


def _digest(batch):
    h = hashlib.sha256()
    for a in (batch.codes, batch.lengths, batch.quals):
        h.update(a.tobytes())
    h.update("\n".join(batch.names).encode())
    return h.hexdigest()


@pytest.fixture(scope="module")
def mock_batch(tmp_path_factory):
    fp = os.path.join(tmp_path_factory.mktemp("seqbatch"), "reads.fastq")
    mock_reads(ADAPTOR1, ADAPTOR2, fp, nmolecules=6, nreads_range=(2, 4),
               seqlen_range=(150, 300), seed=23)
    return read_fastq(fp)


@pytest.mark.parametrize("number", [2, 7])
def test_adaptor_align_is_the_same_in_chunks(mock_batch, number):
    """Chunks of ``number // 2`` row views give the one-chunk ``Frame`` and
    leave the input's arrays as they were."""
    before = _digest(mock_batch)
    whole = adaptor_align(ADAPTOR1, ADAPTOR2, reads=mock_batch, tolerance=100, device="cpu")
    chunked = adaptor_align(ADAPTOR1, ADAPTOR2, reads=mock_batch, tolerance=100,
                            number=number, device="cpu")
    assert len(mock_batch) > number // 2
    _same_frame(chunked, whole)
    assert _digest(mock_batch) == before

"""PyTorch port, adaptor path: parity with the JAX package on the CPU.

The port's plain DP (the CPU side of kernel A) against the JAX scan
``dp_align`` and the Pallas ``_dir_kernel`` in interpret mode, the device
walk against ``qmap_walk_device``, and the adaptor API end to end.  Inputs
are made with numpy from a seed and handed to both sides; the JAX side runs
in float32 as its ``prepare_adaptor`` default.  Scores agree within 2e-4
(the JAX tests' tolerance class), directions and walks bit for bit.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import sarlacc_tpu_torch as tst  # noqa: E402
from sarlacc_tpu.api.align_internal import align_and_extract as jax_align_and_extract  # noqa: E402
from sarlacc_tpu.api.align_internal import prepare_adaptor as jax_prepare_adaptor  # noqa: E402
from sarlacc_tpu.core.encode import SeqBatch  # noqa: E402
from sarlacc_tpu.ops.align import dp_align as jax_dp_align  # noqa: E402
from sarlacc_tpu.ops.align import prepare_reads as jax_prepare_reads  # noqa: E402
from sarlacc_tpu.ops.backtrack import qmap_walk_device  # noqa: E402
from sarlacc_tpu.ops.pallas_align import fit_dirs_pallas  # noqa: E402
from sarlacc_tpu_torch.api.align_internal import align_and_extract, prepare_adaptor  # noqa: E402
from sarlacc_tpu_torch.core.encode import SeqBatch as TSeqBatch  # noqa: E402
from sarlacc_tpu_torch.ops.align import prepare_reads, prepared_from_numpy  # noqa: E402
from sarlacc_tpu_torch.ops.backtrack import qmap_walk  # noqa: E402
from sarlacc_tpu_torch.ops.cuda_align import (  # noqa: E402
    DIR_KERNEL,
    build_cost_planes,
    dir_kernel,
    encode_mask,
    fit_dirs,
    plane_dims,
)

ADAPTOR = "ACGCTAGCATCAGTCNNNNCACAGCTACGANNNNNNNNCGTACGCAT"
ADAPTOR2 = "TGCATCGATCGCAT"
BARCODE = "ACGTTGCACGTA"


def _strings(rng, n, minl, maxl):
    seqs, quals = [], []
    for _ in range(n):
        ln = int(rng.integers(minl, maxl + 1))
        seqs.append("".join(rng.choice(list("ACGTN"), ln)))
        quals.append("".join(chr(int(c)) for c in rng.integers(35, 90, ln)))
    return seqs, quals


def _both(seqs, quals):
    return SeqBatch.from_strings(seqs, quals), TSeqBatch.from_strings(seqs, quals)


@pytest.mark.parametrize("ref", [ADAPTOR, ADAPTOR2, BARCODE])
def test_prepared_tables_equal_jax(ref):
    """The port's prepared adaptor (modes, matched, score tables) equals the
    JAX package's, and prepared_from_numpy carries the JAX arrays over."""
    jad = jax_prepare_adaptor(ref)
    tad = prepare_adaptor(ref)
    for name in ("modes", "matched", "match_tab", "mismatch_tab"):
        np.testing.assert_array_equal(
            getattr(tad, name).numpy(), np.asarray(getattr(jad, name)), err_msg=name
        )
    carried = prepared_from_numpy(jad.modes, jad.matched, jad.match_tab, jad.mismatch_tab)
    assert carried[2].dtype == torch.float32
    for got, want in zip(carried, (jad.modes, jad.matched, jad.match_tab, jad.mismatch_tab)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tad.sec_starts == jad.sec_starts and tad.sec_ends == jad.sec_ends


@pytest.mark.parametrize("local,ref", [(True, ADAPTOR), (False, ADAPTOR), (True, BARCODE)])
def test_fit_dirs_matches_scan_and_pallas(local, ref):
    rng = np.random.default_rng(101)
    seqs, quals = _strings(rng, 19, 0, 50)
    jb, tb = _both(seqs, quals)
    jad = jax_prepare_adaptor(ref)
    codes, qidx, lengths = jax_prepare_reads(jb, jad.tables)
    want_scores, want_dirs = jax_dp_align(
        codes, qidx, lengths, jad.modes, jad.matched, jad.match_tab,
        jad.mismatch_tab, 5.0, 1.0, local=local, need_directions=True,
    )
    pal_scores, pal_dirs, pal_l1 = fit_dirs_pallas(
        np.asarray(codes), np.asarray(qidx), np.asarray(lengths),
        jad.modes, jad.matched, jad.match_tab, jad.mismatch_tab,
        5.0, 1.0, local=local, interpret=True,
    )

    modes, matched, mt, mmt = prepared_from_numpy(
        jad.modes, jad.matched, jad.match_tab, jad.mismatch_tab
    )
    tcodes, tqidx, tlengths = prepare_reads(tb, jad.tables)
    scores, dirs, l1 = fit_dirs(
        tcodes, tqidx, tlengths, modes, matched, mt, mmt, 5.0, 1.0, local=local
    )
    assert l1 == pal_l1 and dirs.dtype == torch.int16
    np.testing.assert_allclose(
        scores.numpy(), np.asarray(want_scores, np.float32), rtol=0, atol=2e-4
    )
    np.testing.assert_allclose(scores.numpy(), np.asarray(pal_scores), rtol=0, atol=2e-4)
    # Plane layout [R, l1, n_pad] == the Pallas kernel's, element for element.
    np.testing.assert_array_equal(dirs.numpy(), np.asarray(pal_dirs))
    R, N, L1 = np.asarray(want_dirs).shape
    live = dirs.numpy()[:, :L1, :N].transpose(0, 2, 1)
    np.testing.assert_array_equal(live, np.asarray(want_dirs))


@pytest.mark.parametrize("local", [True, False])
def test_qmap_walk_matches_device_walk(local):
    rng = np.random.default_rng(7 + local)
    seqs, quals = _strings(rng, 23, 0, 60)
    jb, _ = _both(seqs, quals)
    jad = jax_prepare_adaptor(ADAPTOR)
    codes, qidx, lengths = jax_prepare_reads(jb, jad.tables)
    _, pal_dirs, _ = fit_dirs_pallas(
        np.asarray(codes), np.asarray(qidx), np.asarray(lengths),
        jad.modes, jad.matched, jad.match_tab, jad.mismatch_tab,
        5.0, 1.0, local=local, interpret=True,
    )
    om_w, orow_w = qmap_walk_device(pal_dirs, lengths, plane_layout=True)
    om, orow = qmap_walk(
        torch.tensor(np.asarray(pal_dirs)), torch.tensor(np.asarray(lengths))
    )
    np.testing.assert_array_equal(om.numpy(), np.asarray(om_w))
    np.testing.assert_array_equal(orow.numpy(), np.asarray(orow_w))


def _mock(seed, n):
    from sarlacc_tpu_torch.io.mock import mock_reads
    from sarlacc_tpu_torch.io.fastq import read_fastq

    fp = tempfile.mktemp(suffix=".fastq")
    try:
        mock_reads(
            ADAPTOR, ADAPTOR2, fp, nmolecules=n, nreads_range=(2, 4),
            seqlen_range=(200, 400), seed=seed,
        )
        return read_fastq(fp)
    finally:
        os.remove(fp)


def _frame_equal(got, want, n):
    np.testing.assert_allclose(got["score"], want["score"], rtol=0, atol=2e-4)
    np.testing.assert_array_equal(got["start"], want["start"])
    np.testing.assert_array_equal(got["end"], want["end"])
    for key in want["subseq"].colnames:
        assert got["subseq"][key].seq_strings() == want["subseq"][key].seq_strings(), key
    assert len(got) == len(want) == n


def test_align_and_extract_matches_jax():
    tb = _mock(314, 8)
    jb = SeqBatch(tb.codes, tb.lengths, tb.quals, tb.names)
    front, back = tb.front_and_back(250)
    stacked = TSeqBatch.concat([front, back])
    jstacked = SeqBatch(stacked.codes, stacked.lengths, stacked.quals, stacked.names)
    for ref in (ADAPTOR, ADAPTOR2):
        want = jax_align_and_extract(jax_prepare_adaptor(ref), jstacked, 5.0, 1.0)
        got = align_and_extract(prepare_adaptor(ref), stacked, 5.0, 1.0)
        _frame_equal(got, want, len(stacked))
    assert len(jb) == len(tb)


@pytest.mark.parametrize("number", [100_000, 10])
def test_adaptor_align_matches_jax(number):
    """Chunking by ``number`` leaves the output unchanged."""
    import sarlacc_tpu as jst

    tb = _mock(2718, 7)
    jb = SeqBatch(tb.codes, tb.lengths, tb.quals, tb.names)
    want = jst.adaptor_align(ADAPTOR, ADAPTOR2, reads=jb, tolerance=250)
    got = tst.adaptor_align(
        ADAPTOR, ADAPTOR2, reads=tb, tolerance=250, number=number, device="cpu"
    )
    np.testing.assert_array_equal(got["reversed"], want["reversed"])
    np.testing.assert_array_equal(got["read.width"], want["read.width"])
    for side in ("adaptor1", "adaptor2"):
        _frame_equal(got[side], want[side], len(tb))
        assert got[side].metadata == want[side].metadata
    assert got.rownames == want.rownames


def test_dir_kernel_rejects_cpu_tensors():
    """A wrapper launches its kernel or raises; it never falls back."""
    ad = prepare_adaptor(ADAPTOR2)
    tb = TSeqBatch.from_strings(["ACGT"], ["IIII"])
    codes, qidx, _ = prepare_reads(tb, ad.tables)
    l1, n_pad = plane_dims(1, 4)
    planes = build_cost_planes(codes, qidx, ad.match_tab, ad.mismatch_tab, l1, n_pad)
    before = DIR_KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        dir_kernel(ad.modes, encode_mask(ad.matched), 5.0, 1.0, *planes, True)
    assert DIR_KERNEL.launches == before

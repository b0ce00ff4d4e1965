"""A whole run (on the CPU, the chip check skipped) with the timed path
broken underneath must come out not correct: a step that returns its
state unchanged, half of the batch left out, an answer altered where it is
produced.  Every cell runs on one chip, so there is no exchange between
chips to leave out."""

import numpy as np
import pytest

from benchmark import run

CORRECTION = ("umi_correction.deep_families", {"molecules": 2, "reads_per_molecule": [34, 40],
                                                "insert_length": [300, 400]})
#: Reads left on their sequenced strands make every alignment of a large
#: family garbage, which the CPU's plain versions take minutes over.
CORRECTION_FEW = (CORRECTION[0], {"molecules": 2, "reads_per_molecule": [4, 6],
                                  "insert_length": [300, 400]})
DEMUX = ("barcode_demux.run_chunk", {"molecules": 24, "reads_per_molecule": [3, 6],
                                     "insert_length": [300, 500]})
SEED = 2**31 + 4099


def _unchanged_realize(orig):
    def fault(aligned, reads=None, **kw):  # no reads turned to their canonical strand
        return reads
    return fault


def _half_consensus(orig):
    def fault(msa, **kw):
        out = orig(msa, **kw)
        return out.take(np.arange(len(out) // 2))
    return fault


def _altered_consensus(orig):
    def fault(msa, **kw):
        out = orig(msa, **kw)
        out.codes[:, 0] = np.where(out.codes[:, 0] < 4, (out.codes[:, 0] + 1) % 4, 0)
        return out
    return fault


def _unaligned_msa(orig):
    def fault(reads, groups=None, **kw):  # each read as it is, gaps appended: aligns nothing
        out = orig(reads, groups=groups, **kw)
        rows = []
        for aln in out["alignments"]:
            bare = [r.replace("-", "") for r in aln]
            w = max(len(r) for r in bare)
            rows.append([r + "-" * (w - len(r)) for r in bare])
        out["alignments"] = rows
        return out
    return fault


def _altered_scores(orig):
    def fault(*a, **kw):
        out = orig(*a, **kw)
        out["adaptor1"]["score"] = np.asarray(out["adaptor1"]["score"]) + 0.25
        return out
    return fault


def _unchanged_filter(orig):
    def fault(aligned, score1, score2, **kw):  # the reads go through unfiltered and untrimmed
        out = orig(aligned, -np.inf, -np.inf, **kw)
        return out
    return fault


def _half_barcodes(orig):
    def fault(seqs, barcodes, **kw):
        return orig(seqs.take(np.arange(len(seqs) // 2)), barcodes, **kw)
    return fault


def _altered_barcodes(orig):
    def fault(*a, **kw):
        out = orig(*a, **kw)
        out["barcode"] = (np.asarray(out["barcode"]) + 1) % 4
        return out
    return fault


FAULTS = [
    (CORRECTION_FEW, "realize_reads", _unchanged_realize),
    (CORRECTION, "multi_read_align", _unaligned_msa),
    (CORRECTION, "consensus_read_seq", _half_consensus),
    (CORRECTION, "consensus_read_seq", _altered_consensus),
    (CORRECTION, "adaptor_align", _altered_scores),
    (DEMUX, "filter_reads", _unchanged_filter),
    (DEMUX, "barcode_align", _half_barcodes),
    (DEMUX, "barcode_align", _altered_barcodes),
]


@pytest.mark.parametrize("cell, entry, make", FAULTS,
                         ids=[f"{c[0]}-{m.__name__.strip('_')}" for c, _, m in FAULTS])
def test_broken_path_is_not_correct(cell, entry, make, monkeypatch):
    from sarlacc_tpu_torch import api

    monkeypatch.setattr(api, entry, make(getattr(api, entry)))
    result = run.run_cell(cell[0], SEED, 0.0, False, device="cpu", mix_update=cell[1])
    assert result["correct"] is False
    assert list(result)[-1] == "check"


def test_sound_path_is_correct():
    result = run.run_cell(CORRECTION[0], SEED, 0.0, False, device="cpu", mix_update=CORRECTION[1])
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"peak_gib.correction", "setup_s"}

"""The port's environment knobs, and the indel golden suite on the port.

Port twins of the JAX package's tests of its two numeric knobs
(``tests/test_msa.py:143-167``: ``SARLACC_MSA_SEG_BUDGET_GB`` changes the
segment packing, never the alignments; ``tests/test_levenshtein.py:116-170``:
``SPARSE_MIN``, which ``SARLACC_SPARSE_MIN`` sets at import, changes the
neighbour engine, never the neighbour lists or the groups), each with a
malformed value, which warns with the variable's name and keeps the
default.  Then ``tests/golden/indel_suite.json`` (the JAX pin:
``tests/test_golden_suite.py:159-196``) through the port's ``adaptor_align``
on the CPU.
"""

import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import sarlacc_tpu.api.umi as jax_umi_mod  # noqa: E402
import sarlacc_tpu_torch as tst  # noqa: E402
import sarlacc_tpu_torch.api.msa as msa_mod  # noqa: E402
import sarlacc_tpu_torch.api.umi as umi_mod  # noqa: E402
from sarlacc_tpu.api.umi import _neighbor_lists as jax_neighbor_lists  # noqa: E402
from sarlacc_tpu.api.umi import umi_group as jax_umi_group  # noqa: E402
from sarlacc_tpu_torch.core.encode import SeqBatch, encode_batch  # noqa: E402
from sarlacc_tpu_torch.device import budget_report  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def rand_seqs(rng, n, minl=4, maxl=10, p_n=0.1):
    """tests/test_levenshtein.py::rand_seqs."""
    out = []
    for _ in range(n):
        L = int(rng.integers(minl, maxl + 1))
        s = rng.choice(list("ACGTN"), L, p=[(1 - p_n) / 4] * 4 + [p_n])
        out.append("".join(s))
    return out


# ----------------------------------------------------- SARLACC_MSA_SEG_BUDGET_GB


def test_segment_budget_env_override(monkeypatch):
    """SARLACC_MSA_SEG_BUDGET_GB sets the segment budget (float GiB, floor
    64 MiB) and with it the segment packing; the strings never change."""
    monkeypatch.delenv("SARLACC_HOST_LIB", raising=False)
    monkeypatch.delenv("SARLACC_MSA_SEG_BUDGET_GB", raising=False)
    seqs = [
        ["ACGTAGCTA", "ACGTGCTA", "ACGTAGCTA"],
        ["TTGCAGGAT", "TTGCAGAT", "TTGCAGGAT"],
        ["ACGTAGCAT", "ACGTAGCAT", "TCGTGCAT"],
    ]
    flat = [s for g in seqs for s in g]
    groups = [list(range(i * 3, i * 3 + 3)) for i in range(3)]
    builds = []
    real = msa_mod._build_library_device

    def counting(*a):
        builds.append(list(a[3]))
        return real(*a)

    monkeypatch.setattr(msa_mod, "_build_library_device", counting)
    base = tst.multi_read_align(SeqBatch.from_strings(flat), groups=groups, device="cpu")
    assert msa_mod._segment_lib_budget(CPU) == 1 << 30 and builds == [[0, 1, 2]]

    monkeypatch.setenv("SARLACC_MSA_SEG_BUDGET_GB", "2")
    assert msa_mod._segment_lib_budget(CPU) == 2 << 30
    out = tst.multi_read_align(SeqBatch.from_strings(flat), groups=groups, device="cpu")
    assert out["alignments"] == base["alignments"]

    # A tiny budget forces one group a segment; the output is the same.
    monkeypatch.setenv("SARLACC_MSA_SEG_BUDGET_GB", "0.0001")
    assert msa_mod._segment_lib_budget(CPU) == 64 << 20
    builds.clear()
    monkeypatch.setattr(msa_mod, "_group_lib_bytes", lambda lengths, idx: 64 << 20)
    out = tst.multi_read_align(SeqBatch.from_strings(flat), groups=groups, device="cpu")
    assert builds == [[0], [1], [2]]
    assert out["alignments"] == base["alignments"]
    assert "lib_segment=0.06 GiB (cpu)" in budget_report()


@pytest.mark.parametrize("value", ["abc", "nan", "inf", "1e400", "2 GiB"])
def test_segment_budget_malformed_warns_and_keeps_default(monkeypatch, value):
    monkeypatch.setenv("SARLACC_MSA_SEG_BUDGET_GB", value)
    with pytest.warns(RuntimeWarning, match="SARLACC_MSA_SEG_BUDGET_GB"):
        assert msa_mod._segment_lib_budget(CPU) == 1 << 30
    monkeypatch.setenv("SARLACC_MSA_SEG_BUDGET_GB", "")
    assert msa_mod._segment_lib_budget(CPU) == 1 << 30  # empty: the default, no warning


# ----------------------------------------------------------- SARLACC_SPARSE_MIN


def _reload_umi(monkeypatch, value):
    """api/umi.py imported afresh with SARLACC_SPARSE_MIN = ``value``;
    returns its SPARSE_MIN.  The module is imported again with the variable
    unset before the test ends."""
    monkeypatch.setenv("SARLACC_SPARSE_MIN", value)
    try:
        return importlib.reload(umi_mod).SPARSE_MIN
    finally:
        monkeypatch.delenv("SARLACC_SPARSE_MIN")
        importlib.reload(umi_mod)


def test_sparse_min_read_at_import(monkeypatch):
    assert umi_mod.SPARSE_MIN == 2048
    assert _reload_umi(monkeypatch, "1") == 1
    assert _reload_umi(monkeypatch, "100000") == 100000
    assert umi_mod.SPARSE_MIN == 2048


@pytest.mark.parametrize("value", ["many", "2.5", "0x10"])
def test_sparse_min_malformed_warns_and_keeps_default(monkeypatch, value):
    with pytest.warns(RuntimeWarning, match="SARLACC_SPARSE_MIN"):
        assert _reload_umi(monkeypatch, value) == 2048


def _csr_lists(flat, offs):
    return [flat[offs[i] : offs[i + 1]].tolist() for i in range(len(offs) - 1)]


@pytest.mark.parametrize("limit", [2, 5])
def test_sparse_neighbor_lists_match_dense_path(limit):
    """The CSR neighbour lists (dedup, expansion, DFS order) are the same
    on the sparse path as on the dense one, and JAX's.  The sparse lists
    come from the two-UMI sparse path given one UMI twice, whose
    intersection then keeps every entry."""
    rng = np.random.default_rng(42 + limit)
    seqs = rand_seqs(rng, 30, 4, 6, p_n=0.05) + ["ACGT"] * 8 + ["N", "N"]
    codes, lengths = encode_batch(seqs)
    codes = codes.astype(np.int32)
    dense = _csr_lists(*umi_mod._neighbor_csr(codes, lengths, limit, CPU))
    sparse = _csr_lists(*umi_mod._dual_sparse_csr(codes, lengths, limit, codes, lengths, limit,
                                                  CPU))
    assert sparse == dense
    assert sparse == [list(map(int, x)) for x in jax_neighbor_lists(codes, lengths, limit)]


def test_umi_group_collapsed_clusterer_parity(monkeypatch):
    """The unique-level clusterer (SPARSE_MIN = 1) groups as the read-level
    one does: duplicates, N, singleton order and tie-breaks."""
    rng = np.random.default_rng(7)
    for trial in range(4):
        base = rand_seqs(rng, 40, 5, 7, p_n=0.04)
        seqs = base + [base[i % len(base)] for i in range(60)] + ["ACGTA"] * 9
        seqs = [seqs[i] for i in rng.permutation(len(seqs))]
        dense = tst.umi_group(seqs, threshold1=2, device="cpu")
        monkeypatch.setattr(umi_mod, "SPARSE_MIN", 1)
        collapsed = tst.umi_group(seqs, threshold1=2, device="cpu")
        monkeypatch.setattr(umi_mod, "SPARSE_MIN", 2048)
        assert [g.tolist() for g in collapsed] == [g.tolist() for g in dense], trial


def test_umi_group_sparse_path_parity(monkeypatch):
    """umi_group with a second UMI is the same on the sparse path, and
    JAX's there."""
    rng = np.random.default_rng(9)
    u1 = rand_seqs(rng, 50, 5, 7, p_n=0.05) + ["ACGTA"] * 10
    u2 = rand_seqs(rng, 50, 5, 7, p_n=0.05) + ["TTGCA"] * 10
    dense = tst.umi_group(u1, threshold1=2, umi2=u2, threshold2=2, device="cpu")
    monkeypatch.setattr(umi_mod, "SPARSE_MIN", 1)
    monkeypatch.setattr(jax_umi_mod, "SPARSE_MIN", 1)
    sparse = tst.umi_group(u1, threshold1=2, umi2=u2, threshold2=2, device="cpu")
    want = jax_umi_group(u1, threshold1=2, umi2=u2, threshold2=2)
    assert [g.tolist() for g in sparse] == [g.tolist() for g in dense]
    assert [g.tolist() for g in sparse] == [np.asarray(g).tolist() for g in want]


# ------------------------------------------------------------------ indel suite


def test_golden_indel_suite():
    """tests/golden/indel_suite.json through the port: planted indels and
    substitutions in and around the adaptor's UMI, a truncated read at
    each end, an empty read and a reversed one; scores, spans, UMIs and
    strands equal the snapshot."""
    adaptor = "ACGTACGTAA" + "NNNNN" + "TTGCAGCATT"
    base = "ACGTACGTAA" + "GGCCA" + "TTGCAGCATT"
    cases = [
        base,                                    # exact
        base[:4] + base[5:],                     # deletion in adaptor prefix
        base[:7] + "TT" + base[7:],              # insertion in adaptor prefix
        base[:12] + base[13:],                   # deletion inside the UMI
        base[:12] + "A" + base[12:],             # insertion inside the UMI
        base[:22] + "C" + base[23:],             # substitution in suffix
        base[2:],                                # truncated front
        base[:-3],                               # truncated back
        "",                                      # empty read
        base[::-1],                              # garbage (reversed)
    ]
    reads = ["GGAT" + c + "CCTA" if c else "" for c in cases]
    quals = ["J" * len(r) for r in reads]
    batch = SeqBatch.from_strings(reads, quals=quals)
    aligned = tst.adaptor_align(adaptor, "TGCATCGATCGCAT", reads=batch, tolerance=40,
                                device="cpu")
    f = aligned["adaptor1"]
    snap = {
        "reads": reads,
        "score": [round(float(s), 4) for s in f["score"]],
        "start": [int(x) for x in f["start"]],
        "end": [int(x) for x in f["end"]],
        "umi": f["subseq"]["Sub1"].seq_strings(),
        "reversed": [bool(r) for r in aligned["reversed"]],
    }
    want = json.loads((ROOT / "tests" / "golden" / "indel_suite.json").read_text())
    assert sorted(snap) == sorted(want)
    for key in want:
        assert snap[key] == want[key], f"golden mismatch in indel_suite.json:{key!r}"

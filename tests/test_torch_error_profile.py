"""The port's error-profiling chain on the CPU: ``quality_align`` in chunks
of a memory plan, and ``error_finder`` / ``homopolymer_matcher`` tallied
from byte planes of the gapped strings.

* ``quality_align`` under a forced tiny budget (one read or a few a chunk)
  equals one launch over every read and the JAX package's
  ``quality_align``: scores, edits and gapped strings, with reads of length
  0 and reads longer than the reference among them.
* The tallies from the planes equal ``refimpl/errors.py::find_errors`` and
  ``refimpl/homopolymer.py::match_homopolymers`` on the strings, in their
  order, and the port's chain equals the JAX package's chain
  (``quality_align``, ``error_finder``, ``homopolymer_matcher``): insertions
  at both ends, all-gap reads, homopolymers at the reference's ends, runs
  read with the wrong base, N in the reads.  On a machine without JAX the
  comparisons with it are left out.
* The chain equals the benchmark's plain reference
  (``benchmark/reference/profile.py``) at 24 reads of a 300-bp template,
  and the benchmark's check refuses a chain whose alignment is broken.
"""

import importlib

import numpy as np
import pytest

import sarlacc_tpu_torch as tst
from benchmark import run
from benchmark.reference import profile as ref_profile
from benchmark.trace import Spans
from sarlacc_tpu_torch.core.encode import SeqBatch
from sarlacc_tpu_torch.ops.profile import alignment_planes, walk_errors, walk_homopolymers
from sarlacc_tpu_torch.refimpl.errors import find_errors
from sarlacc_tpu_torch.refimpl.homopolymer import match_homopolymers
from sarlacc_tpu_torch.utils import profiling

try:
    import sarlacc_tpu as jst
    from sarlacc_tpu.core.encode import SeqBatch as JaxSeqBatch
except ImportError:  # a machine without JAX
    jst = None

#: The module (the package's ``quality_align`` is the function).
qa_mod = importlib.import_module("sarlacc_tpu_torch.api.quality_align")
CELL = "error_profile.rrn_operon"
SEED = 2**31 + 24
_B = np.array(list("ACGT"))


def _mutate(rng, template: str, sub=0.05, indel=0.03, ends=0.3) -> str:
    """mockReads' errors on ``template``: substitutions, then each base
    deleted or repeated 2-4 times; with probability ``ends`` a few random
    bases before and after."""
    t = np.array(list(template)) if template else np.zeros(0, "<U1")
    t = np.where(rng.random(t.size) < sub, _B[rng.integers(0, 4, t.size)], t)
    reps = np.where(rng.random(t.size) < indel, rng.choice([0, 2, 3, 4], t.size), 1)
    s = "".join(np.repeat(t, reps))
    for side in (0, 1):
        if rng.random() < ends:
            extra = "".join(_B[rng.integers(0, 4, int(rng.integers(1, 6)))])
            s = extra + s if side == 0 else s + extra
    return s


def _strings(rng, seqs):
    return seqs, ["".join(chr(int(c)) for c in rng.integers(35, 75, len(s))) for s in seqs]


def _batch(rng, seqs):
    return SeqBatch.from_strings(*_strings(rng, seqs))


def _jax_chain(seqs, quals, template):
    """The JAX package's quality_align, error_finder and homopolymer_matcher
    on the same reads."""
    aligned = jst.quality_align(JaxSeqBatch.from_strings(seqs, quals), template)
    return aligned, jst.error_finder(aligned), jst.homopolymer_matcher(aligned)


#: JAX's scores against the port's (float32 on both sides; test_torch_demux's tolerance).
ATOL = 2e-4


def _template(rng, n, p=(0.4, 0.1, 0.1, 0.4)):
    return "".join(rng.choice(list("ACGT"), n, p=list(p)))


def _assert_frames_equal(got, want):
    assert got.colnames == want.colnames
    for col in want.colnames:
        g, w = got[col], want[col]
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert list(g) == list(w), col
    assert sorted(got.metadata) == sorted(want.metadata)
    for key, w in want.metadata.items():
        np.testing.assert_array_equal(got.metadata[key], w)


def _reads_with_edges(rng, template, n):
    seqs = [_mutate(rng, template) for _ in range(n)]
    return seqs + ["", template + "ACGTTGCA" * 4, template[: len(template) // 3], "T"]


@pytest.mark.parametrize("lanes", [1, 5, 13])
def test_chunked_quality_align_equals_one_launch(monkeypatch, lanes):
    rng = np.random.default_rng(100 + lanes)
    template = _template(rng, 40)
    seqs, quals = _strings(rng, _reads_with_edges(rng, template, 26))
    batch = SeqBatch.from_strings(seqs, quals)
    whole = tst.quality_align(batch, template, device="cpu")
    R = len(template)
    L = int(batch.lengths.max())
    budget = lanes * qa_mod.lane_bytes(R, ((L + 1 + 31) // 32) * 32)
    monkeypatch.setattr(qa_mod, "_plan_budget", lambda dev: budget)
    prof = profiling.PipelineProfiler()
    saved = profiling.get_profiler()
    profiling.set_profiler(prof)
    try:
        chunked = tst.quality_align(batch, template, device="cpu")
    finally:
        profiling.set_profiler(saved)
    assert prof.counters["qalign.chunks"] > 1
    _assert_frames_equal(chunked, whole)
    if jst is not None:
        want, _, _ = _jax_chain(seqs, quals, template)
        assert chunked.colnames == want.colnames
        np.testing.assert_allclose(chunked["score"], want["score"], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(chunked["edit"], want["edit"])
        assert list(chunked["reference"]) == list(want["reference"])
        assert list(chunked["query"]) == list(want["query"])


def test_chunk_plan():
    lengths = np.array([10, 300, 0, 299, 50, 300, 7])
    R = 100
    per = qa_mod.lane_bytes(R, 320)
    chunks = qa_mod.chunk_plan(lengths, R, 2 * per)
    assert [c.tolist() for c in chunks] == [[1, 5], [3, 4], [0, 6, 2]]
    big = qa_mod.chunk_plan(np.full(2000, 30), R, 1500 * qa_mod.lane_bytes(R, 32))
    assert [c.size for c in big] == [1024, 976]
    assert qa_mod.chunk_plan(np.zeros(0, np.int64), R, per) == []


def _cases():
    rng = np.random.default_rng(31)
    ends_t = "AAAAC" + _template(rng, 30) + "GTTTT"
    runs_t = "ACCCCGTTTAGGGGA"
    cases = {
        "random": (_template(rng, 80), lambda r, t: [_mutate(r, t) for _ in range(30)]),
        "ends": (ends_t, lambda r, t: ["GG" + t + "CC", "TTTT" + t, t + "AAAA", t[3:-3],
                                      "A" + t[2:]]),
        "all_gaps": (_template(rng, 25), lambda r, t: ["", "", "G", "CCCCCCCCCCCC"]),
        "wrong_base": (runs_t, lambda r, t: [t.replace("CCCC", "AAAA"), t.replace("GGGG", "GAGG"),
                                             t.replace("TTT", "TCCT"), t.replace("CCCC", "C"),
                                             t.replace("GGGG", "GGAGGGG"), t[::-1]]),
        "long_reads": (_template(rng, 30), lambda r, t: [t * 3, t + t[::-1], "A" * 70]),
    }
    return cases


def _assert_tallies_equal_refimpl(refs, queries):
    """walk_errors and walk_homopolymers on the strings' planes against
    find_errors and match_homopolymers, entry for entry."""
    planes = alignment_planes(refs, queries, "cpu")
    want = find_errors(refs, queries)
    got = walk_errors(planes)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    for got_col, want_col in zip(walk_homopolymers(planes), match_homopolymers(refs, queries)):
        assert got_col.tolist() == list(want_col)


@pytest.mark.parametrize("case", sorted(_cases()))
def test_tallies_from_the_walk_equal_the_refimpl(case):
    template, make = _cases()[case]
    rng = np.random.default_rng(len(case))
    seqs, quals = _strings(rng, make(rng, template))
    out = tst.quality_align(SeqBatch.from_strings(seqs, quals), template, device="cpu")
    refs, queries = list(out["reference"]), list(out["query"])
    _assert_tallies_equal_refimpl(refs, queries)
    errors, homopolymers = tst.error_finder(out), tst.homopolymer_matcher(out)
    if jst is not None:
        aligned, want_errors, want_homopolymers = _jax_chain(seqs, quals, template)
        assert list(aligned["reference"]) == refs and list(aligned["query"]) == queries
        np.testing.assert_array_equal(out["edit"], aligned["edit"])
        _assert_frames_equal(errors, want_errors)
        _assert_frames_equal(homopolymers, want_homopolymers)


def test_tallies_of_alignments_with_their_own_references():
    """Pairs of strings whose references differ from the first alignment's
    (shorter, other homopolymers, all gaps, empty) tally as the refimpl's
    walks do, each alignment's homopolymers from its own reference."""
    refs = ["AAC-CGTTT", "AAC", "GGG-GT--", "----", "", "A-AACC"]
    queries = ["AACCC-TTA", "A-C", "GG-GGTAA", "ACGT", "", "AGAACC"]
    _assert_tallies_equal_refimpl(refs, queries)
    rng = np.random.default_rng(8)
    refs, queries = [], []
    for _ in range(40):
        n = int(rng.integers(0, 30))
        r = "".join(rng.choice(list("AACGT-"), n))
        refs.append(r)
        queries.append("".join(rng.choice(list("ACGGT-"), n)))
    refs[0] = refs[0].replace("-", "") + "ACGT" * 8
    queries[0] = queries[0][:len(refs[0])].ljust(len(refs[0]), "A")
    _assert_tallies_equal_refimpl(refs, queries)
    if jst is not None:
        _assert_frames_equal(tst.homopolymer_matcher((refs, queries)),
                             jst.homopolymer_matcher((refs, queries)))


def test_tallies_follow_the_frame_strings():
    """A frame whose strings were edited in place, and a row subset, tally
    what they hold; an edit-only frame refuses as before; the refimpl's
    errors are raised, at the same first offending column."""
    rng = np.random.default_rng(3)
    template = _template(rng, 40)
    out = tst.quality_align(_batch(rng, [_mutate(rng, template) for _ in range(6)]), template,
                            device="cpu")
    refs, queries = list(out["reference"]), list(out["query"])
    edited = [r.replace("-", "A") for r in refs]
    out["query"][:] = edited
    _assert_frames_equal(tst.error_finder(out), tst.error_finder((refs, edited)))
    _assert_frames_equal(tst.homopolymer_matcher(out.take([1, 3])),
                         tst.homopolymer_matcher(([refs[1], refs[3]], [edited[1], edited[3]])))
    with pytest.raises(ValueError, match="edit_only=False"):
        tst.error_finder(tst.quality_align(_batch(rng, [template]), template, edit_only=True,
                                           device="cpu"))
    col = refs[0].index(template[0])
    bad = {
        "unknown character 'N'": ([refs[0]] * 2, [queries[0], queries[0][:col] + "N"
                                                   + queries[0][col + 1:]]),
        "unknown character 'x'": ([refs[0]], ["x" * len(refs[0])]),
        "should be the same": ([refs[0], refs[0] + "C"], [queries[0], queries[0] + "C"]),
        "equal length": ([refs[0]], [queries[0] + "A"]),
        "should match up": ([refs[0]], []),
    }
    for msg, pair in bad.items():
        for call in (lambda: find_errors(*pair), lambda: tst.error_finder(pair)):
            with pytest.raises(ValueError, match=msg):
                call()


def _small(monkeypatch, template_length=300, sample=24):
    orig = run.load_cell

    def load(workload, spec=None):
        cell, config, mix, chain_mod, e2e, layer = orig(workload, spec)
        config["template_length"] = template_length
        config["check"].update(score_sample=sample, workers=1)
        return cell, config, mix, chain_mod, e2e, layer

    monkeypatch.setattr(run, "load_cell", load)


SMALL = {"reads": 24, "warm_every": 4}


def test_chain_equals_the_plain_reference(monkeypatch):
    """24 reads of a 300-bp template: scores, edits and gapped strings equal
    the reference's alignment, the profile and homopolymer table the
    reference's tallies of those strings."""
    _small(monkeypatch)
    _, config, mix, chain_mod, _, _ = run.load_cell(CELL)
    mix.update(SMALL)
    inp = chain_mod.make_inputs(config, mix, SEED, "cpu")
    out = chain_mod.run_pass(inp, inp.batch, Spans(sync=False))
    r = inp.reads
    sc, refs, queries, edits = ref_profile.align(r.template, r.codes, r.lengths, r.quals, 5, 1)
    np.testing.assert_array_equal(out.aligned["score"], sc)
    np.testing.assert_array_equal(out.aligned["edit"], edits)
    assert list(out.aligned["reference"]) == refs and list(out.aligned["query"]) == queries
    base, counts, insertions, trans = ref_profile.error_profile(refs, queries)
    e = out.errors
    assert list(e["base"]) == base + [""]
    for k, col in enumerate(("A", "C", "G", "T", "deletion")):
        np.testing.assert_array_equal(e[col], counts[:, k])
    assert list(e["insertion"]) == insertions
    np.testing.assert_array_equal(e.metadata["transition"], trans)
    starts, widths, bases, observed = ref_profile.homopolymer_table(refs, queries)
    hp = out.homopolymers
    np.testing.assert_array_equal(hp["start"], starts)
    np.testing.assert_array_equal(hp["width"], widths)
    assert list(hp["base"]) == bases and list(hp["observed"]) == observed.tolist()
    numbers = chain_mod.check(inp, out, SEED, [out.digest()])
    assert [n for n, _, _ in numbers] == ["missing_outputs", "passes_differing", "score_gap",
                                          "edit_mismatch", "profile_mismatch",
                                          "homopolymer_sample_mismatch", "profile_truth_error"]
    for name, value, limit in numbers:
        assert value <= limit, (name, value, limit)
    control = dict(chain_mod.control(inp, out, SEED))
    assert control["score_gap"] > config["limits"]["score_gap"]


def _ungapped(orig):
    """Each read set against the reference base for base, no gaps but at
    the end: an alignment that places no indel."""
    def fault(batch, reference, **kw):
        out = orig(batch, reference, **kw)
        ref = str(reference)
        refs, queries = [], []
        for s in batch.seq_strings():
            w = max(len(s), len(ref))
            refs.append(ref.ljust(w, "-"))
            queries.append(s.ljust(w, "-"))
        out["reference"], out["query"] = refs, queries
        return out
    return fault


def _shifted_profile(orig):
    """The error profile's counts moved one base along the reference."""
    def fault(alignments, **kw):
        out = orig(alignments, **kw)
        for col in ("A", "C", "G", "T", "deletion"):
            out[col] = np.roll(np.asarray(out[col]), 1)
        return out
    return fault


def _longer_homopolymers(orig):
    """Every observed homopolymer length one base longer."""
    def fault(alignments, **kw):
        out = orig(alignments, **kw)
        out["observed"] = [[x + 1 for x in seen] for seen in out["observed"]]
        return out
    return fault


@pytest.mark.parametrize("fault,api_name,number", [
    (_ungapped, "quality_align", "profile_truth_error"),
    (_shifted_profile, "error_finder", "profile_mismatch"),
    (_longer_homopolymers, "homopolymer_matcher", "homopolymer_sample_mismatch"),
], ids=["ungapped_alignment", "shifted_profile", "longer_homopolymers"])
def test_broken_chain_is_not_correct(monkeypatch, fault, api_name, number):
    from sarlacc_tpu_torch import api

    _small(monkeypatch)
    monkeypatch.setattr(api, api_name, fault(getattr(api, api_name)))
    result = run.run_cell(CELL, SEED, 0.0, False, device="cpu", mix_update=SMALL)
    assert result["correct"] is False
    assert result["check"][number]["value"] > result["check"][number]["limit"]

"""The ``error_profile`` deployment: the upstream profiling vignette's chain,
``quality_align(reads, reference) -> error_finder -> homopolymer_matcher``,
over full-length reads of one amplicon against its known reference, as a
lab profiles the errors of a nanopore run of rRNA-operon amplicons (Karst
et al. 2021).

The reads: one template drawn from the seed, then per read mockReads'
errors as ``benchmark/generator.py::make_reads`` draws them (substitutions,
then indels that delete a base or repeat it), its qualities, no strand
flips, and each read base's true origin in the template.  A pass is one
chain of the three calls over every read; the warm-up runs it on every
``warm_every``-th read.

``check`` judges the last pass of the window: every output present; the
scores, edits and gapped strings of a sample of reads drawn from the seed
worked out again by the plain reference (:mod:`benchmark.reference.profile`:
``align_batch``'s float32 DP and its own walk); the whole pass's error
profile and homopolymer table worked out again from the program's gapped
strings; the program's homopolymer table of the sample against the
reference's walk of each alignment in turn (``homopolymer.cpp``'s loop);
and the share of the profile's tallies that differ from the tallies of the
reads' true alignment.
"""

from __future__ import annotations

import hashlib
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.generator import _CHUNK_BASES, _GAP
from benchmark.reference import profile as ref_profile

#: Kernels of ``benchmark/roofline.py`` whose launches the traced runs record.
KERNELS = "A"
_ACGT = np.frombuffer(b"ACGT", np.uint8)


@dataclass
class ProfileReads:
    """One pass's reads and the truth they came from."""

    codes: np.ndarray  # int8 [S, W], pad 5
    lengths: np.ndarray  # int32 [S]
    quals: np.ndarray  # uint8 [S, W], Phred+33, pad 0
    origin: np.ndarray  # int64 [S, W]: the template base each read base copies, pad -1
    template: str

    def __len__(self) -> int:
        return int(self.lengths.shape[0])


def make_profile_reads(template_length: int, mix: dict, seed: int, device="cuda") -> ProfileReads:
    """A template of ``template_length`` bases and ``mix["reads"]`` copies of
    it with mockReads' errors and qualities, drawn from ``seed`` on
    ``device``; returned on the host."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    tmpl = torch.randint(0, 4, (template_length,), generator=g, device=dev, dtype=torch.int8)
    S = int(mix["reads"])
    reps = torch.tensor([0] + list(range(2, int(mix["max_insert"]) + 1)), device=dev)
    sub_rate, indel_rate = float(mix["sub_rate"]), float(mix["indel_rate"])
    per_chunk = max(_CHUNK_BASES // max(template_length, 1), 1)
    parts = []
    lengths = np.zeros(S, np.int64)
    for c0 in range(0, S, per_chunk):
        c1 = min(c0 + per_chunk, S)
        rid = torch.arange(c1 - c0, device=dev).repeat_interleave(template_length)
        src = torch.arange(template_length, device=dev).repeat(c1 - c0)
        base = tmpl[src]
        n = base.numel()
        sub = torch.rand(n, generator=g, device=dev) < sub_rate
        newb = torch.randint(0, 4, (n,), generator=g, device=dev, dtype=torch.int8)
        base = torch.where(sub, newb, base)
        indel = torch.rand(n, generator=g, device=dev) < indel_rate
        cnt = torch.where(indel, reps[torch.randint(0, reps.numel(), (n,), generator=g,
                                                      device=dev)], 1)
        rb = torch.repeat_interleave(base, cnt)
        rrid = torch.repeat_interleave(rid, cnt)
        rl = torch.zeros(c1 - c0, dtype=torch.int64, device=dev).index_add_(0, rid, cnt)
        errs = torch.rand(rb.numel(), generator=g, device=dev,
                          dtype=torch.float64) * (sub_rate + indel_rate)
        phred = torch.clamp(torch.round(-10.0 * torch.log10(torch.clamp(errs, min=1e-10))), 0, 93)
        q = (phred + 33).to(torch.uint8)
        flip = torch.rand(c1 - c0, generator=g, device=dev) < float(mix["flip_share"])
        rstart = torch.cumsum(rl, 0) - rl
        rp = torch.arange(rb.numel(), device=dev) - rstart[rrid]
        fb = flip[rrid]
        rp = torch.where(fb, rl[rrid] - 1 - rp, rp)
        rb = torch.where(fb, 3 - rb, rb)
        org = torch.repeat_interleave(src, cnt)
        parts.append((c0, rrid.cpu().numpy(), rp.cpu().numpy(), rb.cpu().numpy(),
                      q.cpu().numpy(), org.cpu().numpy()))
        lengths[c0:c1] = rl.cpu().numpy()
    W = int(lengths.max(initial=1))
    codes = np.full((S, W), _GAP, np.int8)
    quals = np.zeros((S, W), np.uint8)
    origin = np.full((S, W), -1, np.int64)
    for c0, rrid, rp, rb, q, org in parts:
        rows = rrid.astype(np.int64) + c0
        codes[rows, rp] = rb
        quals[rows, rp] = q
        origin[rows, rp] = org
    template = _ACGT[tmpl.cpu().numpy().astype(np.int64)].tobytes().decode()
    return ProfileReads(codes, lengths.astype(np.int32), quals, origin, template)


@dataclass
class Inputs:
    reads: ProfileReads
    batch: object  # the program's SeqBatch of every read
    warm: object  # the warm-up slice
    config: dict
    mix: dict
    device: str
    chunks: list = field(default_factory=list)  # quality_align's chunks in each timed pass
    aligned_by_reference: dict = field(default_factory=dict)  # the sample's, by bfloat16 or not


@dataclass
class Output:
    aligned: object
    errors: object
    homopolymers: object

    def digest(self) -> str:
        a, e, hp = self.aligned, self.errors, self.homopolymers
        h = hashlib.sha256()
        h.update(np.asarray(a["score"], np.float64).tobytes())
        h.update(np.asarray(a["edit"], np.int64).tobytes())
        h.update(np.array([hash(s) for s in list(a["reference"]) + list(a["query"])]).tobytes())
        for col in ("A", "C", "G", "T", "deletion"):
            h.update(np.asarray(e[col], np.int64).tobytes())
        h.update(np.array([sum(x) for x in e["insertion"]] + [len(x) for x in e["insertion"]])
                 .tobytes())
        h.update(np.asarray(hp["start"], np.int64).tobytes())
        h.update(np.array([sum(x) for x in hp["observed"]], np.int64).tobytes())
        return h.hexdigest()


def make_inputs(config: dict, mix: dict, seed: int, device: str) -> Inputs:
    from sarlacc_tpu_torch.core.encode import SeqBatch

    reads = make_profile_reads(int(config["template_length"]), mix, seed, device)
    batch = SeqBatch(reads.codes, reads.lengths, reads.quals)
    warm = batch.take(np.arange(0, len(reads), int(mix["warm_every"])))
    return Inputs(reads, batch, warm, config, mix, device)


def run_pass(inp: Inputs, batch, span) -> Output:
    from sarlacc_tpu_torch import api
    from sarlacc_tpu_torch.utils.profiling import get_profiler

    cfg = inp.config
    before = get_profiler().counters.get("qalign.chunks", 0)
    with span("entry.quality_align"):
        aligned = api.quality_align(batch, inp.reads.template, gap_opening=cfg["gap_opening"],
                                    gap_extension=cfg["gap_extension"], device=inp.device)
    if batch is not inp.warm:
        inp.chunks.append(get_profiler().counters.get("qalign.chunks", 0) - before)
    with span("entry.error_finder"):
        errors = api.error_finder(aligned)
    with span("entry.homopolymer_matcher"):
        homopolymers = api.homopolymer_matcher(aligned)
    return Output(aligned, errors, homopolymers)


def warm_pass(inp: Inputs, span) -> Output:
    return run_pass(inp, inp.warm, span)


def _sample(inp: Inputs, seed: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed), 24])
    S = len(inp.reads)
    return np.sort(rng.choice(S, size=min(int(inp.config["check"]["score_sample"]), S),
                              replace=False))


def _reference_alignments(inp: Inputs, idx: np.ndarray, bf16=False):
    """The reference's alignments of the sample ``idx``, worked out once."""
    key = (bf16, idx.tobytes())
    if key not in inp.aligned_by_reference:
        r, cfg = inp.reads, inp.config
        inp.aligned_by_reference[key] = ref_profile.align(
            r.template, r.codes[idx], r.lengths[idx], r.quals[idx], cfg["gap_opening"],
            cfg["gap_extension"], bf16=bf16, workers=int(cfg["check"]["workers"]))
    return inp.aligned_by_reference[key]


def alignment_numbers(out: Output, idx: np.ndarray, want) -> tuple[float, int]:
    """(largest score gap, reads whose edits or gapped strings differ) of
    the reads ``idx`` against the reference's ``want = align(...)``."""
    sc, refs, queries, edits = want
    a = out.aligned
    gap = float(np.abs(np.asarray(a["score"], np.float64)[idx] - sc).max(initial=0.0))
    got_e = np.asarray(a["edit"], np.int64)[idx]
    bad = sum(int(got_e[k] != edits[k]) | (a["reference"][i] != refs[k])
              | (a["query"][i] != queries[k]) for k, i in enumerate(idx.tolist()))
    return gap, int(bad)


def _differ(a, b) -> int:
    """Entries of two sequences that differ, and the difference in length."""
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def profile_mismatch(inp: Inputs, out: Output) -> int:
    """Entries of the program's error profile and homopolymer table that
    differ from the reference's, worked out from the program's gapped
    strings."""
    refs, queries = list(out.aligned["reference"]), list(out.aligned["query"])
    base, counts, insertions, trans = ref_profile.error_profile(refs, queries, inp.device)
    e = out.errors
    bad = _differ(list(e["base"]), base + [""])
    for k, col in enumerate(("A", "C", "G", "T", "deletion")):
        bad += _differ(np.asarray(e[col]).tolist(), counts[:, k].tolist())
    bad += _differ(list(e["insertion"]), insertions)
    bad += int((np.asarray(e.metadata["transition"]) != trans).sum())
    starts, widths, bases, observed = ref_profile.homopolymer_table(refs, queries, inp.device)
    hp = out.homopolymers
    bad += _differ(np.asarray(hp["start"]).tolist(), starts.tolist())
    bad += _differ(np.asarray(hp["width"]).tolist(), widths.tolist())
    bad += _differ(list(hp["base"]), bases)
    bad += _differ(list(hp["observed"]), observed.tolist())
    return bad


def homopolymer_sample_mismatch(inp: Inputs, out: Output, idx: np.ndarray) -> int:
    """Entries of the program's homopolymer table of the reads ``idx`` (their
    gapped strings from the pass) that differ from the reference's walk of
    those strings alignment by alignment."""
    from sarlacc_tpu_torch import api

    refs = [out.aligned["reference"][i] for i in idx.tolist()]
    queries = [out.aligned["query"][i] for i in idx.tolist()]
    got = api.homopolymer_matcher((refs, queries), device=inp.device)
    table = {}
    for rows in ref_profile.homopolymer_rows(refs, queries):
        for start, width, base, seen in rows:
            table.setdefault(start, (width, base, []))[2].append(seen)
    starts = sorted(table)
    bad = _differ(np.asarray(got["start"]).tolist(), starts)
    bad += _differ(np.asarray(got["width"]).tolist(), [table[s][0] for s in starts])
    bad += _differ(list(got["base"]), [table[s][1] for s in starts])
    bad += _differ(list(got["observed"]), [sorted(table[s][2]) for s in starts])
    return bad


def true_tallies(reads: ProfileReads, idx=None):
    """Tallies of the reads' true alignment: counts int64 [R, 5] of A, C, G,
    T and deletions at each template base, and inserted bases int64 [R + 1]
    by the number of template bases before them.  A read base copies the
    template base its origin names; the first copy is aligned to it, the
    further copies are inserted after it."""
    org = reads.origin if idx is None else reads.origin[idx]
    codes = reads.codes if idx is None else reads.codes[idx]
    R = len(reads.template)
    prev = np.full_like(org, -1)
    prev[:, 1:] = org[:, :-1]
    valid = org >= 0
    first = valid & (org != prev)
    counts = np.bincount(org[first] * 5 + codes[first].astype(np.int64),
                         minlength=5 * R).reshape(R, 5)
    counts[:, 4] = org.shape[0] - counts[:, :4].sum(axis=1)
    inserted = np.bincount(org[valid & ~first] + 1, minlength=R + 1)
    return counts, inserted


def truth_error(reads: ProfileReads, counts, inserted, idx=None) -> float:
    """Share of tallies placed otherwise than by the reads' true alignment:
    the L1 distance between ``counts`` [R, 5] (A, C, G, T, deletions) with
    ``inserted`` [R + 1] (inserted bases by position) and the truth's, over
    the truth's total."""
    tc, ti = true_tallies(reads, idx)
    diff = np.abs(np.asarray(counts, np.int64) - tc).sum() + np.abs(
        np.asarray(inserted, np.int64) - ti).sum()
    return float(diff / max(tc.sum() + ti.sum(), 1))


def _program_tallies(errors):
    R = len(errors) - 1
    counts = np.stack([np.asarray(errors[c], np.int64)[:R]
                       for c in ("A", "C", "G", "T", "deletion")], axis=1)
    return counts, np.array([sum(x) for x in errors["insertion"]], np.int64)


def missing_outputs(inp: Inputs, out: Output) -> int:
    """Reads without a score, an edit count or gapped strings; error profile
    rows and homopolymer rows missing (one a template base and one past
    it; one a homopolymer of the template)."""
    S, R = len(inp.reads), len(inp.reads.template)
    a = out.aligned
    bad = sum(abs(len(a[c]) - S) if c in a else S for c in ("score", "edit", "reference",
                                                               "query"))
    bad += abs(len(out.errors) - (R + 1))
    t = np.frombuffer(inp.reads.template.encode(), np.uint8)
    runs = np.diff(np.append(np.flatnonzero(np.concatenate([[True], t[1:] != t[:-1]])), R))
    bad += abs(len(out.homopolymers) - int((runs >= 2).sum()))
    return int(bad)


def check(inp: Inputs, out: Output, seed: int, digests: list[str]) -> list[tuple]:
    """[(name, value, limit)] for the last pass of the window."""
    lim = inp.config["limits"]
    print(f"quality_align chunks in each timed pass: {inp.chunks}", file=sys.stderr)
    idx = _sample(inp, seed)
    gap, bad = alignment_numbers(out, idx, _reference_alignments(inp, idx))
    last = out.digest()
    return [
        ("missing_outputs", missing_outputs(inp, out), lim["missing_outputs"]),
        ("passes_differing", sum(d != last for d in digests), lim["passes_differing"]),
        ("score_gap", gap, lim["score_gap"]),
        ("edit_mismatch", bad, lim["edit_mismatch"]),
        ("profile_mismatch", profile_mismatch(inp, out), lim["profile_mismatch"]),
        ("homopolymer_sample_mismatch", homopolymer_sample_mismatch(inp, out, idx),
         lim["homopolymer_sample_mismatch"]),
        ("profile_truth_error", truth_error(inp.reads, *_program_tallies(out.errors)),
         lim["profile_truth_error"]),
    ]


def control(inp: Inputs, out: Output, seed: int) -> list[tuple]:
    """``check``'s sampled numbers with the plain reference in bfloat16 put
    in the program's place, against the float32 reference; and the truth
    error of the bfloat16 alignments' tallies on the sample (with the
    float32 reference's beside it)."""
    idx = _sample(inp, seed)
    lo = _reference_alignments(inp, idx, bf16=True)
    hi = _reference_alignments(inp, idx)
    gap = float(np.abs(lo[0] - hi[0]).max(initial=0.0))
    bad = sum(int(lo[3][k] != hi[3][k]) | (lo[1][k] != hi[1][k]) | (lo[2][k] != hi[2][k])
              for k in range(idx.size))
    out_numbers = [("score_gap", gap), ("edit_mismatch", bad)]
    for name, (_, refs, queries, _) in (("profile_truth_error", lo),
                                        ("profile_truth_error.float32_sample", hi)):
        _, counts, insertions, _ = ref_profile.error_profile(refs, queries, inp.device)
        out_numbers.append((name, truth_error(inp.reads, counts[:-1],
                                              [sum(x) for x in insertions], idx)))
    return out_numbers

"""The ``umi_correction`` deployment: the upstream vignette's correction
chain, ``adaptor_align -> umi_group -> realize_reads -> multi_read_align
-> consensus_read_seq``, over a chunk of mock reads held in memory.

The reads are pre-grouped by the molecule they came from before
``umi_group``: the vignette pre-groups by mapping each read to its locus
(minimap2 and ``sam2ranges``, ``vignettes/correction.Rmd:247-269``), and
mockReads' inserts are random, so every molecule is a locus of its own.

``check`` judges the last pass of the window: each read's adaptor calls on
a sample drawn from the seed, worked out again from the raw reads; the UMI
groups, worked out again from the program's UMIs; every MSA row against
its read; and, on a sample of groups with the largest and the longest in
it, the MSA against the reads' true alignment, the consensus worked out
again from the program's MSA and its distance from the molecule the reads
were drawn from.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import os
import sys
from dataclasses import dataclass

import numpy as np

from benchmark.generator import Reads, make_reads, revcomp_codes
from benchmark.reference import align as ref_align
from benchmark.reference import cluster as ref_cluster
from benchmark.reference import consensus as ref_cons
from benchmark.reference import msa as ref_msa

#: Kernels whose roofline this configuration's traced runs read.
KERNELS = "AB"
#: Families of more reads than this take multi_read_align's host library
#: route (the native triplet extension) instead of the device's.
HOST_ROUTE_READS = 33
#: A consensus column whose best base leads the second by no more than this
#: is a tie (float64 sums of at most a few hundred terms): either base is right.
TIE = 1e-9
_DEC = np.frombuffer(b"ACGTN-", np.uint8)


@dataclass
class Inputs:
    reads: Reads
    batch: object  # the program's SeqBatch of every read
    pregroups: np.ndarray  # each read's pre-group: its molecule
    warm: object  # the warm-up slice
    warm_pregroups: np.ndarray
    config: dict
    mix: dict
    device: str


@dataclass
class Output:
    aligned: object
    groups: list
    kept: list
    reads: object  # the reads realize_reads handed multi_read_align
    msa: object
    consensus: object

    def digest(self) -> str:
        h = hashlib.sha256()
        for s in self.consensus.seq_strings():
            h.update(s.encode())
            h.update(b"|")
        h.update(self.consensus.quals.tobytes())
        return h.hexdigest()


def make_inputs(config: dict, mix: dict, seed: int, device: str) -> Inputs:
    from sarlacc_tpu_torch.core.encode import SeqBatch

    reads = make_reads(config, mix, seed, device, origins=True)
    batch = SeqBatch(reads.codes, reads.lengths, reads.quals, reads.names)
    # The warm-up slice: every molecule whose index is a multiple of
    # ``warm_every``, and the smallest family on each of multi_read_align's
    # library routes (the host's takes families over HOST_ROUTE_READS
    # reads), so that every library the pass loads is built and loaded
    # before the window.
    nmol = int(reads.template_off.size - 1)
    sizes = np.bincount(reads.molecule, minlength=nmol)
    pick = set(range(0, nmol, int(mix["warm_every"])))
    for route in (sizes > HOST_ROUTE_READS, (sizes >= 2) & (sizes <= HOST_ROUTE_READS)):
        fam = np.flatnonzero(route)
        if fam.size:
            pick.add(int(fam[np.argmin(sizes[fam])]))
    idx = np.flatnonzero(np.isin(reads.molecule, sorted(pick)))
    warm = batch.take(idx)
    return Inputs(reads, batch, reads.molecule, warm, reads.molecule[idx], config, mix, device)


def run_pass(inp: Inputs, batch, span) -> Output:
    from sarlacc_tpu_torch import api

    cfg, dev = inp.config, inp.device
    pregroups = inp.warm_pregroups if batch is inp.warm else inp.pregroups
    with span("entry.adaptor_align"):
        aligned = api.adaptor_align(cfg["adaptor1"], cfg["adaptor2"], reads=batch,
                                    tolerance=cfg["tolerance"], device=dev)
    with span("entry.umi_group"):
        groups = api.umi_group(aligned["adaptor1"]["subseq"]["Sub2"],
                               threshold1=int(inp.mix["threshold1"]), groups=pregroups,
                               device=dev)
    kept = [g for g in groups if len(g) >= 2]
    with span("entry.realize_reads"):
        reads = api.realize_reads(aligned, reads=batch, trim=False, device=dev)
    with span("entry.multi_read_align"):
        msa = api.multi_read_align(reads, groups=kept, bandwidth=cfg["bandwidth"], device=dev)
    with span("entry.consensus_read_seq"):
        cons = api.consensus_read_seq(msa, device=dev)
    return Output(aligned, groups, kept, reads, msa, cons)


def warm_pass(inp: Inputs, span) -> Output:
    return run_pass(inp, inp.warm, span)



def _row_bytes(batch, i: int) -> bytes:
    n = int(batch.lengths[i])
    return bytes(np.where(batch.codes[i, :n] < 4, batch.codes[i, :n], 4).astype(np.int64))


def _string(codes) -> str:
    return _DEC[np.asarray(codes, np.int64)].tobytes().decode()


def samples(inp: Inputs, out: Output, seed: int):
    """(read sample, group sample): drawn from the seed; the group sample
    holds the largest group and the one with the longest reads."""
    cfg = inp.config["check"]
    rng = np.random.default_rng([int(seed), 17])
    R = len(inp.reads)
    reads = np.sort(rng.choice(R, size=min(int(cfg["adaptor_sample"]), R), replace=False))
    G = len(out.kept)
    if G == 0:
        return reads, np.zeros(0, np.int64)
    size = np.array([len(g) for g in out.kept])
    longest = np.array([int(inp.reads.lengths[np.asarray(g)].max()) for g in out.kept])
    rest = rng.choice(G, size=min(int(cfg["consensus_groups"]), G), replace=False)
    groups = np.unique(np.concatenate([[size.argmax(), longest.argmax()], rest]))
    return reads, groups


def realized(inp: Inputs, rev: np.ndarray, i: int):
    """Read ``i`` in the orientation ``rev`` says: (codes, Phred chars)."""
    n = int(inp.reads.lengths[i])
    c = inp.reads.codes[i, :n]
    q = inp.reads.quals[i, :n]
    if rev[i]:
        return revcomp_codes(c), q[::-1]
    return c, q


def adaptor_numbers(inp: Inputs, out: Output, idx: np.ndarray, rnd=None):
    """(max score gap, share of reads whose calls differ) on reads ``idx``."""
    cfg = inp.config
    r = inp.reads
    w = int(r.lengths[idx].max(initial=1))
    got = ref_align.adaptor_calls(cfg["adaptor1"], cfg["adaptor2"], r.codes[idx, :w],
                                  r.lengths[idx], r.quals[idx, :w], cfg["tolerance"], rnd=rnd)
    a1, a2 = out.aligned["adaptor1"], out.aligned["adaptor2"]
    s1 = np.asarray(a1["score"], np.float64)[idx]
    s2 = np.asarray(a2["score"], np.float64)[idx]
    gap = float(max(np.abs(s1 - got["score1"]).max(initial=0.0),
                    np.abs(s2 - got["score2"]).max(initial=0.0)))
    secs = a1["subseq"].colnames
    rev = np.asarray(out.aligned["reversed"], bool)
    bad = 0
    for k, i in enumerate(idx):
        mine = (bool(rev[i]), (int(a1["start"][i]), int(a1["end"][i])),
                (int(a2["start"][i]), int(a2["end"][i])),
                tuple(_row_bytes(a1["subseq"][s], i) for s in secs))
        bad += mine != got["calls"][k]
    return gap, bad / max(len(idx), 1)


def group_mismatch(inp: Inputs, out: Output) -> int:
    """Reads whose UMI group differs from the reference's grouping of the
    program's UMIs, plus reads missing from the groups."""
    umi = out.aligned["adaptor1"]["subseq"]["Sub2"]
    want = ref_cluster.umi_groups(umi.codes, umi.lengths, int(inp.mix["threshold1"]),
                                  device=inp.device, pregroups=inp.pregroups)
    got = [frozenset(int(x) for x in g) for g in out.groups]
    diff = set(got) ^ set(want)
    missing = len(inp.reads) - sum(len(g) for g in got)
    return sum(len(g) for g in diff) + abs(missing)


def msa_row_mismatch(inp: Inputs, out: Output) -> int:
    """MSA rows whose bases are not their read's, rows of another width
    than their group's, and groups with the wrong number of rows."""
    rev = np.asarray(out.aligned["reversed"], bool)
    rows = list(out.msa["alignments"])
    bad = abs(len(rows) - len(out.kept))
    for g, aln in zip(out.kept, rows):
        if len(aln) != len(g):
            bad += 1
            continue
        w = len(aln[0]) if aln else 0
        for i, row in zip(g, aln):
            c, _ = realized(inp, rev, int(i))
            bad += len(row) != w or row.replace("-", "") != _string(c)
    return bad


def msa_column_error(inp: Inputs, out: Output, groups: np.ndarray, alns=None) -> float:
    """Of all pairs of bases that the MSA of the sampled groups puts in one
    column, the share that copy different homopolymer runs of their
    molecule (:mod:`benchmark.reference.msa`).  ``alns`` maps a group to
    rows that stand in for the program's."""
    runs = ref_msa.run_ids(inp.reads.templates, inp.reads.template_off)
    rev = np.asarray(out.aligned["reversed"], bool)
    prog = list(out.msa["alignments"])
    wrong = total = 0
    for gi in groups:
        g = out.kept[int(gi)]
        rows = prog[int(gi)] if alns is None else alns[int(gi)]
        w = max(len(r) for r in rows)
        cols = np.full((len(rows), w), -1, np.int64)
        for k, (i, row) in enumerate(zip(g, rows)):
            n = int(inp.reads.lengths[int(i)])
            cols[k, :len(row)] = ref_msa.row_runs(row, inp.reads.origin[int(i), :n],
                                                  bool(rev[int(i)]), runs)
        bad, pairs = ref_msa.column_pairs(cols)
        wrong += bad
        total += pairs
    return wrong / max(total, 1)


def consensus_numbers(inp: Inputs, out: Output, groups: np.ndarray, rnd=None, msa_rows=None):
    """(share of consensus bases that differ from the reference consensus
    of the program's MSA, largest Phred gap where both have the base,
    share of the true molecules' bases the consensus gets wrong)."""
    rev = np.asarray(out.aligned["reversed"], bool)
    prog = out.consensus
    alns = list(out.msa["alignments"])
    diff = total = 0
    qgap = 0
    err = truth_len = 0
    for gi in groups:
        g = out.kept[int(gi)]
        quals = [realized(inp, rev, int(i))[1].tobytes().decode() for i in g]
        rows = msa_rows(inp, rev, g) if msa_rows is not None else alns[int(gi)]
        seq, qual, lead = ref_cons.consensus(rows, quals, rnd=rnd)
        n = int(prog.lengths[int(gi)])
        pseq = _string(prog.codes[int(gi), :n])
        pq = prog.quals[int(gi), :n]
        m = min(len(seq), n)
        a = np.frombuffer(seq.encode(), np.uint8)[:m]
        b = np.frombuffer(pseq.encode(), np.uint8)[:m]
        diff += int(((a != b) & (lead[:m] > TIE)).sum()) + abs(len(seq) - n)
        total += max(len(seq), n)
        same = a == b
        if same.any():
            qa = np.frombuffer(qual.encode(), np.uint8)[:m].astype(np.int64)
            qgap = max(qgap, int(np.abs(qa - pq[:m].astype(np.int64))[same].max()))
        mol = np.bincount(inp.reads.molecule[np.asarray(g)]).argmax()
        truth = inp.reads.template(int(mol))
        err += ref_cons.edit_distance(np.frombuffer(seq.encode(), np.uint8), _DEC[truth])
        truth_len += truth.size
    return diff / max(total, 1), float(qgap), err / max(truth_len, 1)


def unaligned_rows(inp: Inputs, rev, g):
    """Each read with gaps appended to the longest: a valid MSA that aligns
    nothing (the control that breaks the MSA's guarantee)."""
    rows = [_string(realized(inp, rev, int(i))[0]) for i in g]
    w = max(len(r) for r in rows)
    return [r + "-" * (w - len(r)) for r in rows]


def check(inp: Inputs, out: Output, seed: int, digests: list[str]) -> list[tuple]:
    """[(name, value, limit)] for the last pass of the window."""
    lim = inp.config["limits"]
    missing = abs(len(out.aligned) - len(inp.reads)) + abs(len(out.consensus) - len(out.kept))
    reads, groups = samples(inp, out, seed)
    mols = [np.unique(inp.reads.molecule[np.asarray(g)]) for g in out.kept]
    per_mol = np.bincount(np.concatenate(mols), minlength=int(inp.reads.template_off.size - 1))
    print(f"groups of two or more reads: {len(out.kept)}; holding reads of several molecules: "
          f"{sum(m.size > 1 for m in mols)}; molecules split over several: "
          f"{int((per_mol > 1).sum())}", file=sys.stderr)
    score_gap, call_mis = adaptor_numbers(inp, out, reads)
    base_mis, phred_gap, truth_err = consensus_numbers(inp, out, groups)
    col_err = msa_column_error(inp, out, groups)
    last = out.digest()
    return [
        ("missing_outputs", missing, lim["missing_outputs"]),
        ("passes_differing", sum(d != last for d in digests), lim["passes_differing"]),
        ("adaptor_score_gap", score_gap, lim["adaptor_score_gap"]),
        ("adaptor_call_mismatch", call_mis, lim["adaptor_call_mismatch"]),
        ("umi_group_mismatch", group_mismatch(inp, out), lim["umi_group_mismatch"]),
        ("msa_row_mismatch", msa_row_mismatch(inp, out), lim["msa_row_mismatch"]),
        ("msa_column_error", col_err, lim["msa_column_error"]),
        ("consensus_base_mismatch", base_mis, lim["consensus_base_mismatch"]),
        ("consensus_phred_gap", phred_gap, lim["consensus_phred_gap"]),
        ("consensus_truth_error", truth_err, lim["consensus_truth_error"]),
    ]


@contextlib.contextmanager
def _host_route(extend=None):
    """Every group on multi_read_align's host library route, its triplet
    extension replaced by ``extend`` where one is given."""
    mod = importlib.import_module("sarlacc_tpu_torch.api.msa")
    orig, env = mod.triplet_extend_native, os.environ.get("SARLACC_HOST_LIB")
    os.environ["SARLACC_HOST_LIB"] = "1"
    if extend is not None:
        mod.triplet_extend_native = extend
    try:
        yield
    finally:
        mod.triplet_extend_native = orig
        if env is None:
            del os.environ["SARLACC_HOST_LIB"]
        else:
            os.environ["SARLACC_HOST_LIB"] = env


def _no_consistency(g: int, lib: dict) -> dict:
    """A triplet extension that returns the direct pair library unchanged."""
    return lib


def msa_of(inp: Inputs, out: Output, groups: np.ndarray, extend=None) -> dict:
    """{group: rows}: the program's MSA of the sampled groups again, on the
    host library route, with its triplet extension replaced by ``extend``."""
    from sarlacc_tpu_torch import api

    with _host_route(extend):
        res = api.multi_read_align(out.reads, groups=[out.kept[int(gi)] for gi in groups],
                                   bandwidth=inp.config["bandwidth"], device=inp.device)
    return dict(zip((int(gi) for gi in groups), res["alignments"]))


def control(inp: Inputs, out: Output, seed: int) -> list[tuple]:
    """The numbers of ``check`` with the reference put in the program's
    place: the adaptor DP and the consensus in bfloat16; the MSA made with
    its consistency step left out (the program's triplet extension returning
    the direct pair library); and the MSA replaced by rows that align
    nothing (:func:`unaligned_rows`), for the consensus and, as
    ``msa_column_error.unaligned``, for the MSA."""
    reads, groups = samples(inp, out, seed)
    r = inp.reads
    w = int(r.lengths[reads].max(initial=1))
    cfg = inp.config
    lo = ref_align.adaptor_calls(cfg["adaptor1"], cfg["adaptor2"], r.codes[reads, :w],
                                 r.lengths[reads], r.quals[reads, :w], cfg["tolerance"],
                                 rnd=ref_align.round_bf16)
    hi = ref_align.adaptor_calls(cfg["adaptor1"], cfg["adaptor2"], r.codes[reads, :w],
                                 r.lengths[reads], r.quals[reads, :w], cfg["tolerance"])
    gap = float(max(np.abs(lo["score1"] - hi["score1"]).max(), np.abs(lo["score2"] -
                                                                     hi["score2"]).max()))
    calls = sum(a != b for a, b in zip(lo["calls"], hi["calls"])) / max(len(reads), 1)
    rev = np.asarray(out.aligned["reversed"], bool)
    bf_q = 0.0
    total = diff = 0
    for gi in groups:
        g = out.kept[int(gi)]
        quals = [realized(inp, rev, int(i))[1].tobytes().decode() for i in g]
        rows = list(out.msa["alignments"])[int(gi)]
        s64, q64, lead = ref_cons.consensus(rows, quals)
        s16, q16, _ = ref_cons.consensus(rows, quals, rnd=ref_align.round_bf16)
        a = np.frombuffer(s64.encode(), np.uint8)
        b = np.frombuffer(s16.encode(), np.uint8)
        diff += int(((a != b) & (lead > TIE)).sum())
        total += a.size
        same = a == b
        qa = np.frombuffer(q64.encode(), np.uint8).astype(np.int64)
        qb = np.frombuffer(q16.encode(), np.uint8).astype(np.int64)
        bf_q = max(bf_q, float(np.abs(qa - qb)[same].max(initial=0)))
    _, _, truth_err = consensus_numbers(inp, out, groups, msa_rows=unaligned_rows)
    flat = msa_of(inp, out, groups, _no_consistency)
    unaligned = {int(gi): unaligned_rows(inp, rev, out.kept[int(gi)]) for gi in groups}
    return [("adaptor_score_gap", gap), ("adaptor_call_mismatch", calls),
            ("consensus_base_mismatch", diff / max(total, 1)), ("consensus_phred_gap", bf_q),
            ("consensus_truth_error", truth_err),
            ("msa_column_error", msa_column_error(inp, out, groups, flat)),
            ("msa_column_error.unaligned", msa_column_error(inp, out, groups, unaligned))]

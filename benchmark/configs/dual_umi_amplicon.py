"""The ``dual_umi_amplicon`` deployment: ``umi_group`` by two UMIs over
every read of one amplicon run, as a lab using dual 18-nt UMIs (Karst et
al. 2021, ``longread_umi``) groups its reads with sarlacc's
``umiGroup(umi1, threshold1, umi2, threshold2)``.

An amplicon is one locus, so the vignette's locus pre-grouping leaves all
reads in one pre-group: the grouping takes the sparse neighbour search on
some 10^5 distinct UMIs a side, kernel I's thresholded row-block scan at
18-22 bases, the read-level neighbour lists, their intersection and the
greedy clusterer.

The reads come from mockReads' model with the molecule's barcode and first
UMI planted in adaptor1's N stretches and its second UMI in adaptor2's,
each UMI drawn by its pattern once a molecule, before the read's errors.
``make_inputs`` aligns the adaptors once, untimed, keeps each read's two
UMI subsequences and drops the reads; a pass is one ``umi_group`` call.

``check`` judges the last pass of the window: every read in one group;
the groups of 64 reads drawn from the seed (and the largest group) held to
the greedy clusterer's guarantee against the plain reference's exact
neighbour sets (:mod:`benchmark.reference.dual_cluster`); and the share of
reads the grouping keeps away from their molecule's largest pure group.
"""

from __future__ import annotations

import hashlib
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.generator import _CHUNK_BASES, _GAP, Reads, _stretches, encode, stratified
from benchmark.reference import dual_cluster as ref_dual

#: Kernels of ``benchmark/roofline.py`` whose launches the traced runs
#: record: none (kernel I's bound comes from the program's counters).
KERNELS = ""


def draw_umis(pattern: str, M: int, g, dev) -> np.ndarray:
    """``M`` UMIs int8 [M, len(pattern)] by the pattern: N uniform over
    ACGT, Y over CT, R over AG (codes A0 C1 G2 T3)."""
    r = torch.randint(0, 4, (M, len(pattern)), generator=g, device=dev,
                      dtype=torch.int8).cpu().numpy()
    kind = np.frombuffer(pattern.encode(), np.uint8)[None, :]
    return np.where(kind == ord("Y"), 1 + 2 * (r & 1),
                    np.where(kind == ord("R"), 2 * (r & 1), r)).astype(np.int8)


def make_dual_reads(config: dict, mix: dict, seed: int, device="cuda") -> Reads:
    """The reads of one pass: per molecule adaptor1 (barcode, UMI1) +
    insert + revcomp(adaptor2 with UMI2), then mockReads' errors, qualities
    and strand flips per read, as ``benchmark/generator.py::make_reads``
    draws them; returned on the host."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    a1, a2 = config["adaptor1"], config["adaptor2"]
    (b0, b1), (u0, u1) = _stretches(a1)
    (v0, v1), = _stretches(a2)
    barcodes = list(config["barcodes"])
    bc_codes = np.stack([encode(b) for b in barcodes])

    M = int(mix["molecules"])
    nreads = stratified(*mix["reads_per_molecule"], M, salt=1)
    ins = stratified(*mix["insert_length"], M, salt=2)
    barcode_of = torch.randint(0, len(barcodes), (M,), generator=g, device=dev).cpu().numpy()
    A1 = np.tile(encode(a1), (M, 1))
    A1[:, b0:b1] = bc_codes[barcode_of]
    A1[:, u0:u1] = draw_umis(config["umi_pattern"], M, g, dev)
    A2 = np.tile(encode(a2), (M, 1))
    A2[:, v0:v1] = draw_umis(config["umi_pattern"], M, g, dev)
    RC2 = np.where(A2 < 4, 3 - A2, A2)[:, ::-1]
    w1, w2 = A1.shape[1], RC2.shape[1]
    mol_len = w1 + ins + w2
    toff = np.concatenate([[0], np.cumsum(mol_len)])
    inserts = torch.randint(0, 4, (int(ins.sum()),), generator=g, device=dev,
                            dtype=torch.int8).cpu().numpy()
    templates = np.empty(int(toff[-1]), np.int8)
    mol_of_base = np.repeat(np.arange(M), mol_len)
    pos = np.arange(templates.size) - toff[mol_of_base]
    in_a1 = pos < w1
    templates[in_a1] = A1[mol_of_base[in_a1], pos[in_a1]]
    ioff = np.concatenate([[0], np.cumsum(ins)])
    in_ins = ~in_a1 & (pos < w1 + ins[mol_of_base])
    templates[in_ins] = inserts[ioff[mol_of_base[in_ins]] + pos[in_ins] - w1]
    in_a2 = ~in_a1 & ~in_ins
    templates[in_a2] = RC2[mol_of_base[in_a2], pos[in_a2] - (w1 + ins[mol_of_base[in_a2]])]
    del mol_of_base, pos, in_a1, in_ins, in_a2

    molecule = np.repeat(np.arange(M), nreads)
    R = molecule.size
    tmpl_d = torch.as_tensor(templates, device=dev)
    toff_d = torch.as_tensor(toff, device=dev)
    reps = torch.tensor([0] + list(range(2, int(mix["max_insert"]) + 1)), device=dev)
    sub_rate, indel_rate = float(mix["sub_rate"]), float(mix["indel_rate"])

    # Chunks of whole reads, each drawn in turn from the one generator.
    rlen_t = mol_len[molecule]
    ends = np.cumsum(rlen_t)
    bounds = [0]
    while bounds[-1] < R:
        start = ends[bounds[-1] - 1] if bounds[-1] else 0
        bounds.append(max(int(np.searchsorted(ends, start + _CHUNK_BASES, side="right")),
                          bounds[-1] + 1))
    parts = []
    lengths = np.zeros(R, np.int64)
    flipped = np.zeros(R, bool)
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        mol = torch.as_tensor(molecule[c0:c1], device=dev)
        tl = torch.as_tensor(rlen_t[c0:c1], device=dev)
        rid = torch.repeat_interleave(torch.arange(c1 - c0, device=dev), tl)
        start = torch.cumsum(tl, 0) - tl
        p = torch.arange(rid.numel(), device=dev) - start[rid]
        base = tmpl_d[toff_d[mol[rid]] + p]
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
        parts.append((c0, rrid.to(torch.int32).cpu(), rp.to(torch.int32).cpu(), rb.cpu(),
                      q.cpu()))
        lengths[c0:c1] = rl.cpu().numpy()
        flipped[c0:c1] = flip.cpu().numpy()
    del tmpl_d

    W = int(lengths.max(initial=1))
    codes = np.full((R, W), _GAP, np.int8)
    quals = np.zeros((R, W), np.uint8)
    for c0, rrid, rp, rb, q in parts:
        rows = rrid.numpy().astype(np.int64) + c0
        cols = rp.numpy().astype(np.int64)
        codes[rows, cols] = rb.numpy()
        quals[rows, cols] = q.numpy()
    within = np.arange(R) - np.repeat(np.concatenate([[0], np.cumsum(nreads)[:-1]]), nreads)
    names = [f"MOLECULE_{m + 1}:READ_{j + 1}" for m, j in zip(molecule.tolist(), within.tolist())]
    return Reads(codes, lengths.astype(np.int32), quals, names, molecule, flipped, templates,
                 toff, barcode_of.astype(np.int64), barcodes, a1, a2)


@dataclass
class Truth:
    """What the check keeps of the dropped reads: each read's molecule."""

    molecule: np.ndarray  # int64 [R]

    def __len__(self) -> int:
        return int(self.molecule.shape[0])


@dataclass
class Inputs:
    reads: Truth
    batch: tuple  # (umi1, umi2): the program's SeqBatches of every read's two UMIs
    warm: tuple  # the same of the warm-up slice
    config: dict
    mix: dict
    device: str
    reruns: list = field(default_factory=list)  # kernel I's re-runs in each timed pass


@dataclass
class Output:
    groups: list  # int64 index arrays, in the greedy clusterer's emission order

    def digest(self) -> str:
        h = hashlib.sha256()
        for g in self.groups:
            h.update(np.asarray(g, np.int64).tobytes())
            h.update(b"|")
        return h.hexdigest()


def make_inputs(config: dict, mix: dict, seed: int, device: str) -> Inputs:
    from sarlacc_tpu_torch import api
    from sarlacc_tpu_torch.core.encode import SeqBatch

    reads = make_dual_reads(config, mix, seed, device)
    aligned = api.adaptor_align(config["adaptor1"], config["adaptor2"],
                                reads=SeqBatch(reads.codes, reads.lengths, reads.quals,
                                               reads.names),
                                tolerance=config["tolerance"], device=device)
    umis = (aligned["adaptor1"]["subseq"]["Sub2"], aligned["adaptor2"]["subseq"]["Sub1"])
    truth = Truth(reads.molecule)
    del reads, aligned
    # The warm-up slice: every molecule whose index is a multiple of
    # ``warm_every``, past SPARSE_MIN reads, so that the row-block scan's
    # kernel is built and loaded before the window.
    idx = np.flatnonzero(truth.molecule % int(mix["warm_every"]) == 0)
    warm = tuple(u.take(idx) for u in umis)
    return Inputs(truth, umis, warm, config, mix, device)


def run_pass(inp: Inputs, batch, span) -> Output:
    from sarlacc_tpu_torch import api
    from sarlacc_tpu_torch.utils.profiling import get_profiler

    umi1, umi2 = batch
    t1, t2 = int(inp.mix["threshold1"]), int(inp.mix["threshold2"])
    before = get_profiler().counters.get("lev2.reruns", 0)
    with span("entry.umi_group"):
        groups = api.umi_group(umi1, threshold1=t1, umi2=umi2, threshold2=t2, device=inp.device)
    if batch is not inp.warm:
        inp.reruns.append(get_profiler().counters.get("lev2.reruns", 0) - before)
    return Output(groups)


def warm_pass(inp: Inputs, span) -> Output:
    return run_pass(inp, inp.warm, span)


def missing_outputs(inp: Inputs, out: Output) -> int:
    """Reads in no group or in several, plus indices that name no read."""
    R = len(inp.reads)
    flat = np.concatenate([np.asarray(g, np.int64) for g in out.groups] + [np.zeros(0, np.int64)])
    bad = int(((flat < 0) | (flat >= R)).sum())
    seen = np.bincount(flat[(flat >= 0) & (flat < R)], minlength=R)
    return bad + int((seen != 1).sum())


def truth_error(inp: Inputs, groups) -> float:
    """Share of reads outside their molecule's largest pure group (a group
    whose reads all copy one molecule)."""
    mol = inp.reads.molecule
    sizes = np.array([len(g) for g in groups], np.int64)
    flat = np.concatenate([np.asarray(g, np.int64) for g in groups] + [np.zeros(0, np.int64)])
    gid = np.repeat(np.arange(sizes.size), sizes)
    lo = np.full(sizes.size, np.iinfo(np.int64).max)
    hi = np.full(sizes.size, -1)
    np.minimum.at(lo, gid, mol[flat])
    np.maximum.at(hi, gid, mol[flat])
    pure = (lo == hi) & (sizes > 0)
    best = np.zeros(int(mol.max(initial=0)) + 1, np.int64)
    np.maximum.at(best, lo[pure], sizes[pure])
    return 1.0 - best.sum() / max(len(inp.reads), 1)


def seed_violations(inp: Inputs, groups, seed: int) -> int:
    """Sampled groups that break the greedy clusterer's guarantee against
    the reference's exact neighbour sets N (both UMIs): a group C passes if some member s has C within
    N(s) and N(s) outside C inside groups emitted before C.  Each sampled
    read x with N(x) = {x} must be a group of its own emitted before every
    larger group.  The sample: ``seed_sample`` reads drawn from the seed
    and the largest group's first read."""
    umi1, umi2 = inp.batch
    t1, t2 = int(inp.mix["threshold1"]), int(inp.mix["threshold2"])
    R = len(inp.reads)
    sizes = np.array([len(g) for g in groups], np.int64)
    pos = np.full(R, -1, np.int64)
    for k, g in enumerate(groups):
        pos[np.asarray(g, np.int64)] = k
    rng = np.random.default_rng([int(seed), 20])
    k = min(int(inp.config["check"]["seed_sample"]), R)
    sample = np.unique(np.append(rng.choice(R, size=k, replace=False),
                                 groups[int(sizes.argmax())][0] if sizes.size else 0))
    picked = np.unique(pos[sample])
    bad = int((picked < 0).sum())
    picked = picked[picked >= 0]
    queries = np.unique(np.concatenate([np.asarray(groups[c], np.int64) for c in picked]))
    qi, j = ref_dual.dual_neighbours(umi1.codes, umi1.lengths, umi2.codes, umi2.lengths, t1, t2,
                                     queries, inp.device)
    split = np.searchsorted(qi, np.arange(queries.size + 1))
    near = {int(q): set(j[split[a]:split[a + 1]].tolist()) for a, q in enumerate(queries)}
    for c in picked.tolist():
        C = set(np.asarray(groups[c], np.int64).tolist())
        bad += not any(C <= near[s] and all(pos[y] < c for y in near[s] - C) for s in C)
    larger = np.flatnonzero(sizes > 1)
    first_larger = int(larger[0]) if larger.size else len(groups)
    for x in sample.tolist():
        if near.get(x) == {x}:
            bad += not (sizes[pos[x]] == 1 and pos[x] < first_larger)
    return bad


def check(inp: Inputs, out: Output, seed: int, digests: list[str]) -> list[tuple]:
    """[(name, value, limit)] for the last pass of the window."""
    lim = inp.config["limits"]
    sizes = np.array([len(g) for g in out.groups])
    print(f"groups: {sizes.size}; of two or more reads: {int((sizes > 1).sum())}; largest: "
          f"{int(sizes.max(initial=0))}; kernel I re-runs a timed pass: {inp.reruns}",
          file=sys.stderr)
    last = out.digest()
    return [
        ("missing_outputs", missing_outputs(inp, out), lim["missing_outputs"]),
        ("passes_differing", sum(d != last for d in digests), lim["passes_differing"]),
        ("umi_seed_violations", seed_violations(inp, out.groups, seed),
         lim["umi_seed_violations"]),
        ("umi_truth_error", truth_error(inp, out.groups), lim["umi_truth_error"]),
    ]


def control(inp: Inputs, out: Output, seed: int) -> list[tuple]:
    """The numbers of ``check`` from groupings that break the program's
    answer: threshold 0 on both UMIs (families split at every error) for
    the truth error, and the second UMI left out for the seed check."""
    from sarlacc_tpu_torch import api

    umi1, umi2 = inp.batch
    exact = api.umi_group(umi1, threshold1=0, umi2=umi2, threshold2=0, device=inp.device)
    one = api.umi_group(umi1, threshold1=int(inp.mix["threshold1"]), device=inp.device)
    return [("umi_truth_error", truth_error(inp, exact)),
            ("umi_seed_violations.umi1_only", seed_violations(inp, one, seed))]

"""The benchmark's read generator: the generative model of the upstream
``mockReads`` (MarioniLab/sarlacc, ``R/mockReads.R``), vectorised over
whole arrays with ``torch`` on the device the run measures.

Per molecule: a barcode and a UMI planted into adaptor1's N stretches (the
first stretch holds the barcode, the second the UMI), then adaptor1 + a
random insert + revcomp(adaptor2).  Per read: i.i.d. substitutions (a base
drawn uniformly from ACGT, which may equal the original), i.i.d. indels (a
base deleted or repeated 2..max_insert times, uniform over those choices),
made-up error probabilities uniform on [0, sub_rate + indel_rate) turned
into Phred+33 qualities, and a strand flip with probability ``flip_share``
(reverse complement, qualities reversed).

Family sizes and insert lengths are a stratified draw of their uniform
ranges that depends on the mix alone, so that every seed asks the same work
of a pass; the seed draws the sequences, errors, qualities, strands, UMIs
(uniform, as mockReads draws them) and each molecule's barcode.  With
``origins`` each read base also records the template base it copies (an
inserted copy records its source), which is the true alignment of the
reads.  The same seed gives the same reads on one device type.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Reads", "stratified", "make_reads", "encode", "decode", "revcomp_codes"]

_ENC = np.full(256, -1, np.int8)
for _i, _b in enumerate("ACGTN"):
    _ENC[ord(_b)] = _i
_DEC = np.frombuffer(b"ACGTN-", np.uint8)
#: The repeat counts of an indel: a deletion, or 2..max_insert copies.
_GAP = 5
#: Bases a chunk of template holds at most, to bound the device's temporaries.
_CHUNK_BASES = 1 << 25


def encode(s: str) -> np.ndarray:
    return _ENC[np.frombuffer(s.encode(), np.uint8)]


def decode(codes: np.ndarray) -> str:
    return _DEC[np.asarray(codes, np.int64)].tobytes().decode()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of ACGT(N) codes."""
    return np.where(codes < 4, 3 - codes, codes)[::-1].astype(np.int8)


def stratified(lo: int, hi: int, n: int, salt: int) -> np.ndarray:
    """``n`` whole numbers covering ``int(uniform(lo, hi))`` in equal strata,
    in an order fixed by ``salt`` alone."""
    u = (np.arange(n) + 0.5) / n
    vals = (lo + u * (hi - lo)).astype(np.int64)
    return vals[np.random.default_rng(salt).permutation(n)]


@dataclass
class Reads:
    """One pass's reads as padded arrays, with the truth they came from."""

    codes: np.ndarray  # int8 [R, W], pad 5
    lengths: np.ndarray  # int32 [R]
    quals: np.ndarray  # uint8 [R, W], Phred+33, pad 0
    names: list[str]
    molecule: np.ndarray  # int64 [R]: the molecule each read copies
    flipped: np.ndarray  # bool [R]
    templates: np.ndarray  # int8, every molecule's true sequence, concatenated
    template_off: np.ndarray  # int64 [M + 1]
    barcode_of: np.ndarray  # int64 [M]: index into ``barcodes``
    barcodes: list[str]
    adaptor1: str
    adaptor2: str
    origin: np.ndarray | None = None  # int64 [R, W]: index into ``templates``, pad -1

    def __len__(self) -> int:
        return int(self.lengths.shape[0])

    def template(self, m: int) -> np.ndarray:
        return self.templates[self.template_off[m]:self.template_off[m + 1]]


def _stretches(adaptor: str) -> list[tuple[int, int]]:
    """0-based [start, end) of each N stretch (``R/mockReads.R:19-41``)."""
    return [(m.start(), m.end()) for m in re.finditer("N+", adaptor)]


def make_reads(config: dict, mix: dict, seed: int, device="cuda", origins=False) -> Reads:
    """The reads of one pass of ``mix`` under ``config``'s adaptors and
    barcodes (mockReads' homopolymers where it names none), drawn from
    ``seed`` on ``device``; returned on the host."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    a1, a2 = config["adaptor1"], config["adaptor2"]
    st = _stretches(a1)
    (b0, b1), (u0, u1) = st[0], st[1]
    bc_len, umi_len = b1 - b0, u1 - u0
    barcodes = list(config.get("barcodes") or [c * bc_len for c in "ACGT"])
    bc_codes = np.stack([encode(b) for b in barcodes])

    M = int(mix["molecules"])
    nreads = stratified(*mix["reads_per_molecule"], M, salt=1)
    ins = stratified(*mix["insert_length"], M, salt=2)
    barcode_of = torch.randint(0, len(barcodes), (M,), generator=g, device=dev).cpu().numpy()
    umis = torch.randint(0, 4, (M, umi_len), generator=g, device=dev,
                         dtype=torch.int8).cpu().numpy()

    # Every molecule's true sequence: adaptor1 (barcode, UMI) + insert + rc(adaptor2).
    A1 = np.tile(encode(a1), (M, 1))
    A1[:, b0:b1] = bc_codes[barcode_of]
    A1[:, u0:u1] = umis
    rc2 = revcomp_codes(encode(a2))
    mol_len = A1.shape[1] + ins + rc2.size
    toff = np.concatenate([[0], np.cumsum(mol_len)])
    inserts = torch.randint(0, 4, (int(ins.sum()),), generator=g, device=dev,
                            dtype=torch.int8).cpu().numpy()
    templates = np.empty(int(toff[-1]), np.int8)
    mol_of_base = np.repeat(np.arange(M), mol_len)
    pos = np.arange(templates.size) - toff[mol_of_base]
    in_a1 = pos < A1.shape[1]
    templates[in_a1] = A1[mol_of_base[in_a1], pos[in_a1]]
    ioff = np.concatenate([[0], np.cumsum(ins)])
    in_ins = ~in_a1 & (pos < A1.shape[1] + ins[mol_of_base])
    templates[in_ins] = inserts[ioff[mol_of_base[in_ins]] + pos[in_ins] - A1.shape[1]]
    in_a2 = ~in_a1 & ~in_ins
    templates[in_a2] = rc2[pos[in_a2] - (A1.shape[1] + ins[mol_of_base[in_a2]])]

    molecule = np.repeat(np.arange(M), nreads)
    R = molecule.size
    tmpl_d = torch.as_tensor(templates, device=dev)
    toff_d = torch.as_tensor(toff, device=dev)
    reps = torch.tensor([0] + list(range(2, int(mix["max_insert"]) + 1)), device=dev)
    sub_rate, indel_rate = float(mix["sub_rate"]), float(mix["indel_rate"])

    # Chunks of whole reads, each drawn in turn from the one generator.
    rlen_t = mol_len[molecule]
    bounds = [0]
    acc = 0
    for r in range(R):
        acc += int(rlen_t[r])
        if acc > _CHUNK_BASES:
            bounds.append(r)
            acc = int(rlen_t[r])
    bounds.append(R)
    parts = []
    lengths = np.zeros(R, np.int64)
    flipped = np.zeros(R, bool)
    for c0, c1 in zip(bounds[:-1], bounds[1:]):
        mol = torch.as_tensor(molecule[c0:c1], device=dev)
        tl = torch.as_tensor(rlen_t[c0:c1], device=dev)
        rid = torch.repeat_interleave(torch.arange(c1 - c0, device=dev), tl)
        start = torch.cumsum(tl, 0) - tl
        p = torch.arange(rid.numel(), device=dev) - start[rid]
        src = toff_d[mol[rid]] + p
        base = tmpl_d[src]
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
        org = torch.repeat_interleave(src, cnt).cpu() if origins else None
        parts.append((c0, rrid.to(torch.int32).cpu(), rp.to(torch.int32).cpu(),
                      rb.cpu(), q.cpu(), org))
        lengths[c0:c1] = rl.cpu().numpy()
        flipped[c0:c1] = flip.cpu().numpy()

    W = int(lengths.max(initial=1))
    codes = np.full((R, W), _GAP, np.int8)
    quals = np.zeros((R, W), np.uint8)
    origin = np.full((R, W), -1, np.int64) if origins else None
    for c0, rrid, rp, rb, q, org in parts:
        rows = rrid.numpy().astype(np.int64) + c0
        cols = rp.numpy().astype(np.int64)
        codes[rows, cols] = rb.numpy()
        quals[rows, cols] = q.numpy()
        if origins:
            origin[rows, cols] = org.numpy()
    within = np.arange(R) - np.repeat(np.concatenate([[0], np.cumsum(nreads)[:-1]]), nreads)
    names = [f"MOLECULE_{m + 1}:READ_{j + 1}" for m, j in zip(molecule.tolist(), within.tolist())]
    return Reads(codes, lengths.astype(np.int32), quals, names, molecule, flipped, templates,
                 toff, barcode_of.astype(np.int64), barcodes, a1, a2, origin)

"""Read simulator — fixture generator for tests, vignettes and benchmarks.

Same generative model as the reference's ``mockReads`` (R/mockReads.R:5-100):
per molecule, plant a barcode and UMI into adaptor1's N-stretches, build the
true molecule as adaptor1 + random insert + revcomp(adaptor2), then emit
``nreads`` noisy copies with iid substitutions and indels (a deletion or a
2..max_insert-fold repeat), uniform made-up error probabilities converted to
Phred qualities, and 50% strand flips.  Returns the true per-molecule
references.  Seed-deterministic via NumPy Generator.

Copied unchanged from ``sarlacc_tpu/io/mock.py`` (numpy only, no JAX).
"""

from __future__ import annotations

import re

import numpy as np

from ..core.encode import SeqBatch
from .fastq import write_fastq

__all__ = ["mock_reads"]

_NTS = np.array(list("ACGT"))


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]


def mock_reads(
    adaptor1: str,
    adaptor2: str,
    filepath: str,
    all_barcodes: list[str] | None = None,
    barcode_position: tuple[int, int] | str = "auto",
    umi_position: tuple[int, int] | str = "auto",
    nmolecules: int = 10,
    nreads_range: tuple[int, int] = (10, 50),
    seqlen_range: tuple[int, int] = (500, 5000),
    sub_rate: float = 0.05,
    indel_rate: float = 0.01,
    max_insert: int = 5,
    flip_strands: bool = True,
    seed: int = 0,
):
    """Returns (references list[str], names list[str]); writes FASTQ to filepath."""
    rng = np.random.default_rng(seed)
    rc2 = _revcomp(adaptor2)

    # Locate the barcode (first N-stretch) and UMI (second) in adaptor1
    # (R/mockReads.R:19-41).
    stretches = [(m.start() + 1, m.end()) for m in re.finditer("N+", adaptor1)]
    if not stretches:
        barcode_position = umi_position = (1, 0)
    else:
        if barcode_position == "auto":
            barcode_position = stretches[0]
        if len(stretches) == 1:
            umi_position = (1, 0)
        elif umi_position == "auto":
            umi_position = stretches[1]

    bc_len = barcode_position[1] - barcode_position[0] + 1
    umi_len = umi_position[1] - umi_position[0] + 1

    if all_barcodes is None:
        all_barcodes = [n * bc_len for n in "ACGT"]
    elif any(len(b) != bc_len for b in all_barcodes):
        raise ValueError("'barcodes' width must correspond to barcode position")

    references: list[str] = []
    refnames: list[str] = []
    first = True
    for i in range(nmolecules):
        nreads = int(rng.uniform(nreads_range[0], nreads_range[1]))
        seqlen = int(rng.uniform(seqlen_range[0], seqlen_range[1]))
        insert = "".join(rng.choice(_NTS, seqlen))

        a1 = list(adaptor1)
        barcode = str(rng.choice(all_barcodes))
        if bc_len > 0:
            a1[barcode_position[0] - 1 : barcode_position[1]] = list(barcode)
        umi = "".join(rng.choice(_NTS, umi_len))
        if umi_len > 0:
            a1[umi_position[0] - 1 : umi_position[1]] = list(umi)

        ref = "".join(a1) + insert + rc2
        references.append(ref)
        refnames.append(f"MOLECULE_{i + 1}")

        refarr = np.array(list(ref))
        seqs, quals, names = [], [], []
        for j in range(nreads):
            reref = refarr.copy()
            # Substitutions (R/mockReads.R:72-74).
            chosen = rng.random(reref.size) < sub_rate
            reref[chosen] = rng.choice(_NTS, int(chosen.sum()))
            # Indels: each chosen base deleted or repeated 2..max_insert
            # times (R/mockReads.R:76-79).
            chosen = rng.random(reref.size) < indel_rate
            pieces = reref.astype(object)
            reps = rng.choice([0] + list(range(2, max_insert + 1)), int(chosen.sum()))
            pieces[chosen] = [b * int(r) for b, r in zip(pieces[chosen], reps)]
            readseq = "".join(pieces)
            # Made-up qualities: uniform error probabilities
            # (R/mockReads.R:82), converted to Phred+33 chars.
            errs = rng.uniform(0, sub_rate + indel_rate, len(readseq))
            phred = np.clip(np.round(-10.0 * np.log10(np.maximum(errs, 1e-10))), 0, 93)
            quals.append("".join(chr(int(p) + 33) for p in phred))
            seqs.append(readseq)
            names.append(f"MOLECULE_{i + 1}:READ_{j + 1}")

        if flip_strands:
            flip = rng.random(nreads) < 0.5
            for j in np.flatnonzero(flip):
                seqs[j] = _revcomp(seqs[j])
                quals[j] = quals[j][::-1]

        write_fastq(filepath, seqs=seqs, quals=quals, names=names, append=not first)
        first = False

    return references, refnames

"""The ``barcode_demux`` deployment: the upstream vignette's calibration and
demultiplexing, ``adaptor_align -> get_adaptor_thresholds -> filter_reads
-> barcode_align -> get_barcode_thresholds`` and the assignment mask, over
a chunk of mock reads held in memory.

``check`` judges the last pass of the window: the adaptor calls of a read
sample, the scores of a sample of the scrambled reads and the barcode
calls of a sample of the kept reads, each worked out again by the plain
aligner; and the thresholds, the filter, the barcode thresholds and the
assignment worked out again from the program's scores.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from benchmark.configs.umi_correction import adaptor_numbers
from benchmark.generator import Reads, make_reads
from benchmark.reference import align as ref_align
from benchmark.reference import demux as ref_demux

KERNELS = "ACD"


@dataclass
class Inputs:
    reads: Reads
    batch: object
    calib: np.ndarray  # the reads the thresholds are calibrated on
    warm: object
    warm_calib: np.ndarray
    config: dict
    mix: dict
    device: str
    scramble_seed: int


@dataclass
class Output:
    aligned: object
    thresholds: dict
    kept: object
    barcodes: object
    barcode_thresholds: dict
    assigned: np.ndarray

    def digest(self) -> str:
        h = hashlib.sha256()
        h.update(np.asarray([self.thresholds["threshold1"], self.thresholds["threshold2"],
                             self.barcode_thresholds["score"],
                             self.barcode_thresholds["gap"]]).tobytes())
        h.update(np.asarray(self.barcodes["barcode"]).tobytes())
        h.update(self.assigned.tobytes())
        return h.hexdigest()


def make_inputs(config: dict, mix: dict, seed: int, device: str) -> Inputs:
    from sarlacc_tpu_torch.core.encode import SeqBatch

    reads = make_reads(config, mix, seed, device)
    batch = SeqBatch(reads.codes, reads.lengths, reads.quals, reads.names)
    rng = np.random.default_rng([int(seed), 29])
    R = len(reads)
    n = int(config["calibration_reads"])
    calib = np.sort(rng.choice(R, size=min(n, R), replace=False))
    wn = R // int(mix["warm_every"])
    warm_idx = np.arange(wn)
    warm = batch.take(warm_idx)
    warm_calib = np.arange(min(n // int(mix["warm_every"]), wn))
    return Inputs(reads, batch, calib, warm, warm_calib, config, mix, device,
                  int(seed) % (1 << 32))


def run_pass(inp: Inputs, batch, span, calib=None) -> Output:
    from sarlacc_tpu_torch import api

    cfg, dev = inp.config, inp.device
    calib = inp.calib if calib is None else calib
    with span("entry.adaptor_align"):
        aligned = api.adaptor_align(cfg["adaptor1"], cfg["adaptor2"], reads=batch,
                                    tolerance=cfg["tolerance"], device=dev)
    with span("entry.get_adaptor_thresholds"):
        thr = api.get_adaptor_thresholds(aligned, error=cfg["error"], reads=batch.take(calib),
                                         seed=inp.scramble_seed, device=dev)
    with span("entry.filter_reads"):
        kept = api.filter_reads(aligned, thr["threshold1"], thr["threshold2"], device=dev)
    with span("entry.barcode_align"):
        bal = api.barcode_align(kept["adaptor1"]["subseq"]["Sub1"], inp.reads.barcodes,
                                device=dev)
    with span("entry.get_barcode_thresholds"):
        bthr = api.get_barcode_thresholds(bal, nmads=cfg["nmads"], device=dev)
    assigned = ((np.asarray(bal["score"]) >= bthr["score"])
                & (np.asarray(bal["gap"]) >= bthr["gap"]))
    return Output(aligned, thr, kept, bal, bthr, assigned)


def warm_pass(inp: Inputs, span) -> Output:
    return run_pass(inp, inp.warm, span, calib=inp.warm_calib)



def _sample(rng, n: int, k: int) -> np.ndarray:
    return np.sort(rng.choice(n, size=min(k, n), replace=False)) if n else np.zeros(0, np.int64)


def _scrambles(inp: Inputs):
    """The calibration reads' scrambled fronts and backs, drawn as the
    program draws them from its seed."""
    r = inp.reads
    idx = inp.calib
    w = int(r.lengths[idx].max(initial=1))
    (f, fl, fq), (b, bl, bq) = ref_align.front_and_back(r.codes[idx, :w], r.lengths[idx],
                                                        r.quals[idx, :w], inp.config["tolerance"])
    rng = np.random.default_rng(inp.scramble_seed)
    sf, sfq = ref_demux.scramble(f, fl, fq, rng)
    sb, sbq = ref_demux.scramble(b, bl, bq, rng)
    return (sf, fl, sfq), (sb, bl, sbq)


def scramble_numbers(inp: Inputs, out: Output, idx: np.ndarray, rnd=None) -> float:
    """Largest gap between the program's and the reference's scores of the
    scrambled reads ``idx`` (indices into the calibration reads)."""
    if idx.size == 0:
        return 0.0
    cfg = inp.config
    (sf, fl, sfq), (sb, bl, sbq) = _scrambles(inp)

    def scores(ref, c, ln, q):
        return ref_align.fit_scores(ref, c[idx], ln[idx], q[idx], 5.0, 1.0, rnd=rnd)

    start, rstart = scores(cfg["adaptor1"], sf, fl, sfq), scores(cfg["adaptor1"], sb, bl, sbq)
    end, rend = scores(cfg["adaptor2"], sb, bl, sbq), scores(cfg["adaptor2"], sf, fl, sfq)
    rev = (np.maximum(start, 0) + np.maximum(end, 0)) < (np.maximum(rstart, 0)
                                                         + np.maximum(rend, 0))
    s1 = np.where(rev, rstart, start)
    s2 = np.where(rev, rend, end)
    p1 = np.asarray(out.thresholds["scores1"]["scrambled"], np.float64)[idx]
    p2 = np.asarray(out.thresholds["scores2"]["scrambled"], np.float64)[idx]
    return float(max(np.abs(s1 - p1).max(), np.abs(s2 - p2).max()))


def barcode_numbers(inp: Inputs, out: Output, idx: np.ndarray, rnd=None):
    """(largest score or gap difference, reads whose best barcode differs)
    over the kept reads ``idx``, from the program's barcode stretches."""
    if idx.size == 0:
        return 0.0, 0
    sub = out.kept["adaptor1"]["subseq"]["Sub1"]
    w = int(sub.lengths[idx].max(initial=1))
    stack = np.stack([ref_align.fit_scores(b, sub.codes[idx, :w], sub.lengths[idx],
                                           sub.quals[idx, :w], 5.0, 1.0, local=False, rnd=rnd)
                      for b in inp.reads.barcodes])
    best, top, gap = ref_demux.best_two(stack)
    ps = np.asarray(out.barcodes["score"], np.float64)[idx]
    pg = np.asarray(out.barcodes["gap"], np.float64)[idx]
    pb = np.asarray(out.barcodes["barcode"])[idx]
    return float(max(np.abs(top - ps).max(), np.abs(gap - pg).max())), int((best != pb).sum())


def state_mismatch(inp: Inputs, out: Output) -> int:
    """Answers the reference works out from the program's own scores that
    differ: the two adaptor thresholds, each read's filter call and trim
    points, the two barcode thresholds and each kept read's assignment; and
    reads missing from the outputs."""
    a = out.aligned
    thr = out.thresholds
    bad = abs(len(a) - len(inp.reads))
    t1 = ref_demux.fdr_threshold(thr["scores1"]["reads"], thr["scores1"]["scrambled"],
                                 inp.config["error"])
    t2 = ref_demux.fdr_threshold(thr["scores2"]["reads"], thr["scores2"]["scrambled"],
                                 inp.config["error"])
    bad += (t1 != thr["threshold1"]) + (t2 != thr["threshold2"])
    keep, ts, te = ref_demux.filter_mask(a["adaptor1"]["score"], a["adaptor2"]["score"],
                                         a["adaptor1"]["end"], a["adaptor2"]["end"],
                                         a["read.width"], thr["threshold1"], thr["threshold2"])
    names = np.asarray(a.rownames, dtype=object)[keep]
    got = np.asarray(out.kept.rownames, dtype=object)
    if got.size != names.size:
        bad += abs(got.size - names.size) + 1
    else:
        bad += int((got != names).sum())
        bad += int((np.asarray(out.kept["trim.start"]) != ts).sum())
        bad += int((np.asarray(out.kept["trim.end"]) != te).sum())
    bs, bg = ref_demux.mad_thresholds(out.barcodes["score"], out.barcodes["gap"],
                                      inp.config["nmads"])
    bad += (bs != out.barcode_thresholds["score"]) + (bg != out.barcode_thresholds["gap"])
    assigned = ((np.asarray(out.barcodes["score"]) >= bs) & (np.asarray(out.barcodes["gap"]) >= bg))
    bad += int((assigned != out.assigned).sum()) + abs(len(out.barcodes) - len(out.kept))
    return int(bad)


def _samples(inp: Inputs, out: Output, seed: int):
    c = inp.config["check"]
    rng = np.random.default_rng([int(seed), 31])
    return (_sample(rng, len(inp.reads), int(c["adaptor_sample"])),
            _sample(rng, inp.calib.size, int(c["scramble_sample"])),
            _sample(rng, len(out.kept), int(c["barcode_sample"])))


def check(inp: Inputs, out: Output, seed: int, digests: list[str]) -> list[tuple]:
    lim = inp.config["limits"]
    reads, scr, kept = _samples(inp, out, seed)
    gap, calls = adaptor_numbers(inp, out, reads)
    sgap = scramble_numbers(inp, out, scr)
    bgap, bcalls = barcode_numbers(inp, out, kept)
    last = out.digest()
    return [
        ("passes_differing", sum(d != last for d in digests), lim["passes_differing"]),
        ("state_mismatch", state_mismatch(inp, out), lim["state_mismatch"]),
        ("score_gap", max(gap, sgap, bgap), lim["score_gap"]),
        ("call_mismatch", (calls * reads.size + bcalls) / max(reads.size + kept.size, 1),
         lim["call_mismatch"]),
    ]


def control(inp: Inputs, out: Output, seed: int) -> list[tuple]:
    """``check``'s sampled numbers with the plain aligner in bfloat16 put
    in the program's place, against the float64 reference."""
    reads, scr, kept = _samples(inp, out, seed)
    cfg = inp.config
    r = inp.reads
    w = int(r.lengths[reads].max(initial=1))
    args = (cfg["adaptor1"], cfg["adaptor2"], r.codes[reads, :w], r.lengths[reads],
            r.quals[reads, :w], cfg["tolerance"])
    lo = ref_align.adaptor_calls(*args, rnd=ref_align.round_bf16)
    hi = ref_align.adaptor_calls(*args)
    gap = max(np.abs(lo["score1"] - hi["score1"]).max(), np.abs(lo["score2"] - hi["score2"]).max())
    calls = sum(a != b for a, b in zip(lo["calls"], hi["calls"]))
    (sf, fl, sfq), (sb, bl, sbq) = _scrambles(inp)
    for ref, c, ln, q in ((cfg["adaptor1"], sf, fl, sfq), (cfg["adaptor2"], sb, bl, sbq)):
        a = ref_align.fit_scores(ref, c[scr], ln[scr], q[scr], 5.0, 1.0, rnd=ref_align.round_bf16)
        b = ref_align.fit_scores(ref, c[scr], ln[scr], q[scr], 5.0, 1.0)
        gap = max(gap, np.abs(a - b).max(initial=0.0))
    sub = out.kept["adaptor1"]["subseq"]["Sub1"]
    if kept.size:
        w = int(sub.lengths[kept].max(initial=1))

        def stack(rnd):
            return np.stack([ref_align.fit_scores(b, sub.codes[kept, :w], sub.lengths[kept],
                                                  sub.quals[kept, :w], 5.0, 1.0, local=False,
                                                  rnd=rnd) for b in r.barcodes])

        b16, t16, g16 = ref_demux.best_two(stack(ref_align.round_bf16))
        b64, t64, g64 = ref_demux.best_two(stack(None))
        gap = max(gap, np.abs(t16 - t64).max(), np.abs(g16 - g64).max())
        calls += int((b16 != b64).sum())
    return [("score_gap", float(gap)),
            ("call_mismatch", calls / max(reads.size + kept.size, 1))]

"""Sweep kernels C and D's tile widths and register budgets on the card.

    python -m sarlacc_tpu_torch.tools.score_tiles [min_blocks ...]

``csrc/score_kernel.cu`` is compiled at three tile widths (15, 31 and 63
columns), each asking the compiler for a number of resident blocks an SM
(``SCORE_MIN_BLOCKS_15/31/63``; 7, 4 and 3 in the production build), and
the wrappers run a launch at the narrowest width that holds its widest
segment.  This tool measures both choices.  It builds the source once for
each count of the sweep (default 1 to 8, every width asked for the same
count; one nvcc each, all started together) and gives, per build and width,
registers, spill bytes and resident blocks, and the time of the launches
that width serves, all on random 250-bp ends (numpy seed 0):

* 15: tune_alignment's 35 (open, ext) points for adaptor2 (R = 14) over
  19 926 ends; 12 random 12-bp barcodes over 100 000 12-bp reads;
* 31: 12 random 24-bp barcodes over 100 000 24-bp reads;
* 63: tune's 35 points for adaptor1 (R = 51) over 19 926 ends, and kernel
  C for adaptor1 over the same ends.

Then the production build runs each launch at every width (a narrower one
in several column tiles, through the hand-off scratch).  Every variant's
scores must equal the production build's, bit for bit.  It needs the card.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..api.align_internal import prepare_adaptor, prepare_scores_input
from ..core.encode import SeqBatch
from ..device import resolve_device
from ..native.build import CudaKernel
from ..ops.cuda_align import (
    SCORE_KERNEL, SCORE_TILES, SEGMENTS_KERNEL, _launch_score, _launch_segments, encode_mask,
    pack_segments, score_kernel_resources, score_tile,
)
from .timing import device_label, event_ms

__all__ = ["PRODUCTION", "SWEEP", "make_cases", "measure", "variant_kernels"]

#: The production build's resident blocks an SM asked for at each width.
PRODUCTION = {15: 7, 31: 4, 63: 3}
#: The counts swept by default.
SWEEP = (1, 2, 3, 4, 5, 6, 7, 8)

ADAPTOR1 = "ACGCTAGCATCAGTC" + "NNNN" + "CACAGCTACGA" + "N" * 12 + "CGTACGCAT"  # bench.py:108
ADAPTOR2 = "TGCATCGATCGCAT"
TUNE_GRID = [(go, ge) for go in range(4, 11) for ge in range(1, 6)]


def variant_kernels(min_blocks: int):
    """(kernel C, kernel D) of a build that asks every width for
    ``min_blocks`` resident blocks an SM."""
    defines = [f"SCORE_MIN_BLOCKS_{tj}={int(min_blocks)}" for tj in SCORE_TILES]
    return tuple(
        CudaKernel("score_kernel.cu", k.symbol, k.argtypes, defines)
        for k in (SCORE_KERNEL, SEGMENTS_KERNEL)
    )


def _random_reads(n: int, length: int, rng) -> SeqBatch:
    codes = rng.integers(0, 4, (n, length)).astype(np.int8)
    quals = rng.integers(20, 60, (n, length)).astype(np.uint8) + 33
    return SeqBatch(codes, np.full(n, length, dtype=np.int64), quals, None)


def make_cases(device, n_tune: int = 19_926, n_barcodes: int = 100_000, seed: int = 0) -> dict:
    """name -> (kernel "C" or "D", its launch arguments, cells)."""
    rng = np.random.default_rng(seed)
    a1 = prepare_adaptor(ADAPTOR1, device=device)
    a2 = prepare_adaptor(ADAPTOR2, device=device)
    tune = prepare_scores_input(a1, _random_reads(n_tune, 250, rng))
    cases = {}

    def d_case(name, prepared, segments):
        l1, n_pad = prepared.plane_geometry()
        modes, mask, segs = pack_segments(segments, device)
        lens_k = torch.zeros(n_pad, dtype=torch.int32, device=device)
        lens_k[: prepared.n] = prepared.lengths
        cells = float((lens_k.double() + 1).sum()) * sum(r for _, r, *_ in segs)
        cases[name] = ("D", (modes, mask, segs, *prepared.planes(), lens_k), cells)

    d_case("tune:adaptor2", tune, [(a2.modes, a2.matched, go, ge, True) for go, ge in TUNE_GRID])
    for bc_len in (12, 24):
        bcs = [prepare_adaptor("".join(rng.choice(list("ACGT"), bc_len)), device=device)
               for _ in range(12)]
        observed = prepare_scores_input(bcs[0], _random_reads(n_barcodes, bc_len, rng))
        d_case(f"barcodes{bc_len}", observed, [(b.modes, b.matched, 5.0, 1.0, False) for b in bcs])
    d_case("tune:adaptor1", tune, [(a1.modes, a1.matched, go, ge, True) for go, ge in TUNE_GRID])
    lengths = tune.lengths
    cases["C:adaptor1"] = (
        "C", (a1.modes, encode_mask(a1.matched), 5.0, 1.0, *tune.planes(), lengths, True),
        float((lengths.double() + 1).sum()) * len(a1),
    )
    return cases


def _width(kind, args) -> int:
    if kind == "C":
        return score_tile([(0, int(args[0].shape[0]), args[-1])])
    return score_tile(args[2])


def _run(kind, args, kernels, tj):
    kc, kd = kernels
    if kind == "C":
        return _launch_score(*args, kernel=kc, tj=tj)
    return _launch_segments(*args, kernel=kd, tj=tj)


def measure(sweep=SWEEP, device=None, reps: int = 5, log=print) -> dict:
    """Build every variant, then time each case at its width in each build
    and at every width in the production build.  Returns ``{"builds":
    {min_blocks: {"resources": ..., "ms": {case: ms}}}, "widths": {case:
    {tj: ms}}, "cells": {case: cells}}``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("score_tiles measures compiled builds of the kernels: it needs the card")
    log(f"[score_tiles] {device_label(dev)}")
    builds = {mb: variant_kernels(mb) for mb in sweep}
    with ThreadPoolExecutor(len(builds) + 1) as pool:
        for job in [pool.submit(SCORE_KERNEL.build)] + [pool.submit(k[0].build)
                                                        for k in builds.values()]:
            job.result()
    cases = make_cases(dev)
    production = (SCORE_KERNEL, SEGMENTS_KERNEL)
    want = {name: _run(kind, args, production, None) for name, (kind, args, _) in cases.items()}
    out: dict = {"builds": {}, "widths": {}, "cells": {n: c[2] for n, c in cases.items()}}

    def timed(name, kind, args, kernels, tj):
        got = _run(kind, args, kernels, tj)
        torch.cuda.synchronize(dev)
        if not torch.equal(got, want[name]):
            raise AssertionError(f"score_tiles {name} at tile {tj}: scores differ from production")
        return event_ms(lambda: _run(kind, args, kernels, tj), reps, dev)

    for mb, kernels in builds.items():
        res = score_kernel_resources(kernels[0])
        row = {"resources": res, "ms": {}}
        for name, (kind, args, cells) in cases.items():
            tj = _width(kind, args)
            row["ms"][name] = ms = timed(name, kind, args, kernels, tj)
            r = res[f"{kind}@{tj}"]
            log(f"[score_tiles] min_blocks {mb}: {name} at tile {tj}: {ms:.3f} ms = "
                f"{cells / ms / 1e6:.1f} GCUPS; {r['registers']} registers, "
                f"{r['spill_bytes']} B spilled, {r['blocks_per_sm']} blocks an SM")
        out["builds"][mb] = row
    for name, (kind, args, cells) in cases.items():
        out["widths"][name] = {}
        for tj in SCORE_TILES:
            out["widths"][name][tj] = ms = timed(name, kind, args, production, tj)
            log(f"[score_tiles] production build: {name} at tile {tj}"
                f"{' (its own)' if tj == _width(kind, args) else ''}: {ms:.3f} ms = "
                f"{cells / ms / 1e6:.1f} GCUPS")
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    measure(tuple(int(a) for a in argv) or SWEEP)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sweep kernel A's tile widths, lanes a read and register budgets on the card.

    python -m sarlacc_tpu_torch.tools.dir_tiles [min_blocks ...]

``csrc/dir_kernel.cu`` is compiled at three tile widths (7, 15 and 31
columns), each asking the compiler for a number of resident blocks an SM
(``DIR_MIN_BLOCKS_7/15/31``; 4, 3 and 3 in the production build), and the
wrapper's :func:`..ops.cuda_align.dir_plan` picks a launch's tile width,
lanes a read (G) and passes.  This tool measures those choices.  It builds
the source once for each count of the sweep (default 1 to 8, every width
asked for the same count; one nvcc each, all started together) and gives,
per build and width, registers, spill bytes and resident blocks, and the
time of each case at its own plan; then the production build runs each case
at every (width, G) with the fewest passes that cover it (up to 8).  The
cases, on random reads (numpy seed 0):

* ``adaptor1`` / ``adaptor2``: adaptor_align's two launches, R = 51 and 14
  in fitting mode over 19 926 250-bp ends (the pipeline's stacked ends);
* ``quality``: quality_align's, 300 reads of 700 bp against 500 bp, global;
* ``multi-pass``: R = 150 global over the same ends, wider than G tiles.

Every variant's directions and S must equal the production build's at its
own plan, bit for bit.  Last, the production build's SASS opcode counts at
each width (``cuobjdump``, where the toolkit has it): a tile's ordinary
cells are unrolled twice (row 0 and the other rows), so the counts over
2 x TJ approximate the instructions of a cell.  It needs the card.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..api.align_internal import prepare_adaptor
from ..core.encode import SeqBatch
from ..device import resolve_device
from ..native.build import CudaKernel
from ..ops.align import prepare_reads
from ..ops.cuda_align import (
    DIR_KERNEL, DIR_TILES, _launch_dirs, _ordinary, build_cost_planes, dir_kernel_resources,
    dir_plan, encode_mask, plane_dims,
)
from .op_rates import census_of, sass_census
from .timing import device_label, event_ms

__all__ = ["LANES", "PRODUCTION", "SWEEP", "make_cases", "measure", "plans", "variant_kernel"]

#: The production build's resident blocks an SM asked for at each width.
PRODUCTION = {7: 4, 15: 3, 31: 3}
#: The counts swept by default.
SWEEP = (1, 2, 3, 4, 5, 6, 7, 8)
#: Lanes a read tried with the production build.
LANES = (1, 2, 4, 8, 16, 32)
#: Most passes a tried plan may take.
MAX_PASSES = 8

ADAPTOR1 = "ACGCTAGCATCAGTC" + "NNNN" + "CACAGCTACGA" + "N" * 12 + "CGTACGCAT"  # bench.py:108
ADAPTOR2 = "TGCATCGATCGCAT"
LONG = ("ACGTRYKMSWBDHVN" * 10)[:150]


def variant_kernel(min_blocks: int) -> CudaKernel:
    """Kernel A of a build that asks every width for ``min_blocks``
    resident blocks an SM."""
    defines = [f"DIR_MIN_BLOCKS_{tj}={int(min_blocks)}" for tj in DIR_TILES]
    return CudaKernel("dir_kernel.cu", DIR_KERNEL.symbol, DIR_KERNEL.argtypes, defines)


def _random_reads(n: int, length: int, rng) -> SeqBatch:
    codes = rng.integers(0, 4, (n, length)).astype(np.int8)
    quals = rng.integers(20, 60, (n, length)).astype(np.uint8) + 33
    return SeqBatch(codes, np.full(n, length, dtype=np.int64), quals, None)


def make_cases(device, n_ends: int = 19_926, n_quality: int = 300, seed: int = 0) -> dict:
    """name -> (kernel A's arguments, cells = R x l1 x n_pad)."""
    rng = np.random.default_rng(seed)
    ends = _random_reads(n_ends, 250, rng)
    queries = _random_reads(n_quality, 700, rng)
    ref = "".join(rng.choice(list("ACGT"), 500))
    cases = {}
    for name, reference, batch, local in (
        ("adaptor1", ADAPTOR1, ends, True), ("adaptor2", ADAPTOR2, ends, True),
        ("quality", ref, queries, False), ("multi-pass", LONG, ends, False),
    ):
        ad = prepare_adaptor(reference, device=device)
        codes, qidx, _ = prepare_reads(batch, ad.tables, device=device)
        l1, n_pad = plane_dims(*codes.shape)
        planes = build_cost_planes(codes, qidx, ad.match_tab, ad.mismatch_tab, l1, n_pad)
        args = (ad.modes, encode_mask(ad.matched), 5.0, 1.0, *planes, local)
        cases[name] = (args, float(len(reference) * l1 * n_pad))
    return cases


def own_plan(args):
    """The plan the wrapper gives a case."""
    return dir_plan(int(args[0].shape[0]), args[-1], int(args[-2].shape[1]))


def plans(args) -> list:
    """Every (width, G, fewest passes) of at most MAX_PASSES passes."""
    rn = _ordinary(int(args[0].shape[0]), args[-1])
    out = []
    for tj in DIR_TILES:
        for G in LANES:
            passes = max(1, -(-rn // (tj * G)))
            if passes <= MAX_PASSES:
                out.append((tj, G, passes))
    return out


def measure(sweep=SWEEP, device=None, reps: int = 5, log=print) -> dict:
    """Build every variant, then time each case at its own plan in each
    build and at every plan in the production build.  Returns ``{"builds":
    {min_blocks: {"resources": ..., "ms": {case: ms}}}, "plans": {case:
    {"tj/G/passes": ms}}, "own": {case: plan}, "cells": {case: cells}}``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("dir_tiles measures compiled builds of kernel A: it needs the card")
    log(f"[dir_tiles] {device_label(dev)}")
    builds = {mb: variant_kernel(mb) for mb in sweep}
    with ThreadPoolExecutor(len(builds) + 1) as pool:
        for job in [pool.submit(DIR_KERNEL.build)] + [pool.submit(k.build) for k in builds.values()]:
            job.result()
    cases = make_cases(dev)
    want = {name: _launch_dirs(*args) for name, (args, _) in cases.items()}
    own = {name: own_plan(args) for name, (args, _) in cases.items()}
    out: dict = {"builds": {}, "plans": {}, "own": own,
                 "cells": {name: c for name, (_, c) in cases.items()}}

    def timed(name, args, kernel, plan):
        S, dirs = _launch_dirs(*args, kernel=kernel, plan=plan)
        torch.cuda.synchronize(dev)
        if not (torch.equal(S, want[name][0]) and torch.equal(dirs, want[name][1])):
            raise AssertionError(f"dir_tiles {name} at {plan}: output differs from production")
        del S, dirs
        return event_ms(lambda: _launch_dirs(*args, kernel=kernel, plan=plan), reps, dev)

    for mb, kernel in builds.items():
        res = dir_kernel_resources(kernel)
        row = {"resources": res, "ms": {}}
        for name, (args, cells) in cases.items():
            plan = own[name]
            row["ms"][name] = ms = timed(name, args, kernel, plan)
            r = res[f"A@{plan[0]}"]
            log(f"[dir_tiles] min_blocks {mb}: {name} at {plan}: {ms:.3f} ms = "
                f"{cells / ms / 1e6:.1f} GCUPS; {r['registers']} registers, "
                f"{r['spill_bytes']} B spilled, {r['blocks_per_sm']} blocks an SM")
        out["builds"][mb] = row
    for name, (args, cells) in cases.items():
        out["plans"][name] = {}
        for plan in plans(args):
            ms = timed(name, args, DIR_KERNEL, plan)
            out["plans"][name]["/".join(map(str, plan))] = ms
            log(f"[dir_tiles] production build: {name} at tile {plan[0]}, G {plan[1]}, "
                f"{plan[2]} pass(es){' (its own)' if plan == own[name] else ''}: {ms:.3f} ms = "
                f"{cells / ms / 1e6:.1f} GCUPS")
    census = sass_census(DIR_KERNEL)
    out["sass"] = {}
    for tj in DIR_TILES if census is not None else ():
        counts = census_of(census, "dir_kernel", (tj + 1) // 2)
        out["sass"][tj] = counts
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:14]
        log(f"[dir_tiles] SASS at tile {tj}: {sum(counts.values())} instructions "
            f"({sum(counts.values()) / (2 * tj):.1f} per unrolled cell); "
            + ", ".join(f"{op} {n}" for op, n in top))
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    measure(tuple(int(a) for a in argv) or SWEEP)
    return 0


if __name__ == "__main__":
    sys.exit(main())

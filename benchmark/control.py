#!/usr/bin/env python3
"""Readings for a cell's limits: the program's and the control's.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, one process makes the cell's reads, runs one pass of the
program at the cell's own size and prints, as one JSON line, the numbers
``check`` compares (the program's readings) and the numbers the control
gives in the program's place: the plain reference in bfloat16 where the
configuration states float32, and, for a layer that states no precision
(the MSA), the program's MSA made without its consistency step and output
that aligns nothing.
Not part of a benchmark run; it sets and re-checks the limits in
``configs/<config>.json``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.run import load_cell  # noqa: E402
from benchmark.trace import Spans  # noqa: E402


def readings(workload: str, seeds, device="cuda", mix_update=None):
    """Yields {seed, program: {name: value}, control: {name: value}}."""
    _, config, mix, chain, _, _ = load_cell(workload)
    mix.update(mix_update or {})
    for seed in seeds:
        t0 = time.perf_counter()
        inp = chain.make_inputs(config, mix, seed, device)
        out = chain.run_pass(inp, inp.batch, Spans(sync=False))
        program = {n: float(v) for n, v, _ in chain.check(inp, out, seed, [out.digest()])}
        control = {n: float(v) for n, v in chain.control(inp, out, seed)}
        yield {"workload": workload, "seed": seed, "program": program, "control": control,
               "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for row in readings(args.workload, args.seeds):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

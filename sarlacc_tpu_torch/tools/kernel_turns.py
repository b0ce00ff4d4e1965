"""Kernels A, B, E, F and G of several checkouts of the port, timed in turns on one card.

    python -m sarlacc_tpu_torch.tools.kernel_turns [--shapes FILE] [--kernels ABEFGS] ROOT [ROOT ...]
    python -m sarlacc_tpu_torch.tools.kernel_turns --record FILE

Each ROOT is a directory that holds a ``sarlacc_tpu_torch`` package (this
checkout is ``.``; another is, say, a ``git archive`` of the parent
commit).  The roots run in the order given, each in a process of its own
that imports that root's package, builds its kernels and times them on the
same inputs, all made from seeds or read from FILE:

* kernel A at adaptor_align's stacked ends of the bench batch
  (``bench.py``'s mock reads, seed 7: 19 926 250-bp ends) against adaptor1
  (R = 51) and adaptor2 (R = 14), fitting; at quality_align's launch (300
  reads against 500 bp of read 0, global, R = 500); and at R = 150 global
  over the stacked ends;
* kernel B at one bucket of 4096 pipeline-shaped pairs x 1024 rows x W 256,
  on its wide route at two synthetic shapes (64 pairs of 128-256-bp reads
  in 4.0-4.6-kb ones, W 8192; 4 pairs in 31-32-kb ones at bandwidth
  16 500, W 65 536), and at each launch shape in FILE's ``"B"`` (the
  arguments of every distinct (P, rows, W) a pass of the pipeline sent to
  ``banded_pair``);
* kernel F (``pair_walk``) on the directions the root's kernel B gives for
  each of those buckets (kernel B is bit-identical across the roots);
* kernel E's whole wave path, ``ops/msa.py::merge_wave_from_library`` on
  each merge wave in FILE's ``"E"`` (a wave of each shape of a pass of the
  pipeline, with the library entries it reads): the host tables, the cost
  build and the kernel, whatever the root does for them, timed by the host
  clock around each call and a synchronise;
* kernel G's qmap walk (``G``) on the directions the root's kernel A gives
  at adaptor_align's stacked ends against each adaptor (fitting), and its
  string walk (``S``) on those at quality_align's launch (global); kernel
  A is bit-identical across the roots.

A, B and F are timed with CUDA events (5 calls after a warm-up).  G's
walks are shorter than their wrappers' host time, so they are timed with
CUDA events over 5 calls queued behind a sleep on the card after a warm-up
(``tools/timing.py::queued_ms``).  Where a root's
kernel G counts by kind (``cuda_backtrack.COUNTS``), its counters at each
G case are kept too.  Each
root's outputs are checked against its own plain versions once a shape
(bit for bit; E against the CPU route of ``merge_wave_from_library`` on
waves up to 2^27 band cells); the runs' outputs must also agree with each
other.  ``--kernels`` picks the kernels timed (kernel B still runs for F's
directions).  Giving roots as parent, change, change, parent measures the
versions within one call.  It needs the card.

``--record FILE`` writes FILE: one pass of ``tools/workload.py``'s
``run_pipeline`` on ``build_workload()`` (the bench batch) with this
checkout's package, recording kernel B's launch arguments and the merge
waves as it runs (:func:`record`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

__all__ = ["main", "record", "run_root", "wide_pair_args"]

ADAPTOR1 = "ACGCTAGCATCAGTC" + "NNNN" + "CACAGCTACGA" + "N" * 12 + "CGTACGCAT"  # bench.py:108
ADAPTOR2 = "TGCATCGATCGCAT"
LONG = ("ACGTRYKMSWBDHVN" * 10)[:150]


def wide_pair_args(torch, dev, P, rows, lb_range, bw, W, seed):
    """banded_pair arguments for P pairs whose A reads (``rows`` // 2 to
    ``rows`` bases) sit, 80% kept, inside B reads of ``lb_range`` bases:
    bands of |lb - la| + 2 ``bw`` + 1 cells, within ``W`` (kernel B's wide
    route)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    LB = lb_range[1]
    ca = rng.integers(0, 4, (P, rows)).astype(np.int8)
    cb = rng.integers(0, 4, (P, LB)).astype(np.int8)
    for p, off in enumerate(rng.integers(0, lb_range[0] - rows, P)):
        keep = rng.random(rows) < 0.8
        cb[p, off : off + rows] = np.where(keep, ca[p], cb[p, off : off + rows])
    la = rng.integers(rows // 2, rows + 1, P)
    lb = rng.integers(lb_range[0], LB + 1, P)
    lo = np.minimum(0, lb - la) - bw
    hi = np.maximum(0, lb - la) + bw
    if int((hi - lo).max()) + 1 > W:
        raise AssertionError(f"a band of {int((hi - lo).max()) + 1} cells exceeds W = {W}")

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    return (t(ca), t(cb), t(la, np.int32), t(lb, np.int32), t(lo, np.int32),
            t(hi - lo, np.int32), 0.0, -1.0, 5.0, 1.0, rows, W)


def _inputs(torch, st, dev, shapes, kernels):
    """name -> (kernel, arguments), the same for every root."""
    import tempfile

    import numpy as np

    from sarlacc_tpu_torch.api.align_internal import prepare_adaptor
    from sarlacc_tpu_torch.core.encode import SeqBatch
    from sarlacc_tpu_torch.ops.align import prepare_reads
    from sarlacc_tpu_torch.ops.cuda_align import (
        build_cost_planes, encode_mask, fit_dirs, plane_dims,
    )

    fd, fp = tempfile.mkstemp(suffix=".fastq")
    os.close(fd)
    try:
        st.mock_reads(ADAPTOR1, ADAPTOR2, fp, nmolecules=950, nreads_range=(8, 14),
                      seqlen_range=(400, 700), seed=7)
        batch = st.read_fastq(fp)
    finally:
        os.remove(fp)
    cases = {}
    stacked = SeqBatch.concat(list(batch.front_and_back(250)))
    for name, ref, reads, local in (
        ("A:adaptor1", ADAPTOR1, stacked, True), ("A:adaptor2", ADAPTOR2, stacked, True),
        ("A:quality_align", batch.seq_strings()[0][50:550], batch.take(np.arange(1, 301)), False),
        ("A:R150", LONG, stacked, False),
    ):
        if "A" not in kernels:
            break
        ad = prepare_adaptor(ref, device=dev)
        codes, qidx, _ = prepare_reads(reads, ad.tables, device=dev)
        l1, n_pad = plane_dims(*codes.shape)
        planes = build_cost_planes(codes, qidx, ad.match_tab, ad.mismatch_tab, l1, n_pad)
        cases[name] = ("A", (ad.modes, encode_mask(ad.matched), 5.0, 1.0, *planes, local))
    for name, ref, reads, local in (
        ("G:adaptor1", ADAPTOR1, stacked, True), ("G:adaptor2", ADAPTOR2, stacked, True),
        ("S:quality_align", batch.seq_strings()[0][50:550], batch.take(np.arange(1, 301)), False),
    ):
        if name[0] in kernels:
            ad = prepare_adaptor(ref, device=dev)
            codes, qidx, lengths = prepare_reads(reads, ad.tables, device=dev)
            _, dirs, _ = fit_dirs(codes, qidx, lengths, ad.modes, ad.matched, ad.match_tab,
                                  ad.mismatch_tab, 5.0, 1.0, local=local)
            cases[name] = (name[0], (dirs, lengths))

    # A pipeline-shaped bucket: 4096 length-sorted neighbours of 513-1024 bp.
    rows, W, bw = 1024, 256, 100
    lens = batch.lengths.astype(np.int64)
    cand = np.flatnonzero((lens > 512) & (lens <= rows))
    cand = cand[np.argsort(lens[cand], kind="stable")]
    ia, ib = cand[:-1], cand[1:]
    keep = np.abs(lens[ib] - lens[ia]) + 2 * bw + 1 <= W
    ia, ib = ia[keep][:4096], ib[keep][:4096]
    la, lb = lens[ia], lens[ib]
    lo = np.minimum(0, lb - la) - bw
    hi = np.maximum(0, lb - la) + bw
    w = min(batch.width, rows)
    ca = np.full((ia.size, rows), 5, np.int8)
    ca[:, :w] = batch.codes[ia][:, :w]
    cb = np.full((ia.size, rows), 5, np.int8)
    cb[:, :w] = batch.codes[ib][:, :w]

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    buckets = {f"P{ia.size}xR{rows}xW{W}": (
        t(ca), t(cb), t(la, np.int32), t(lb, np.int32), t(lo, np.int32),
        t(hi - lo, np.int32), 0.0, -1.0, 5.0, 1.0, rows, W,
    )}
    for P, lb_range, bw_, W_, seed in ((64, (4000, 4600), 100, 8192, 5),
                                       (4, (31000, 32000), 16500, 65536, 6)):
        buckets[f"wide:P{P}xR256xW{W_}"] = wide_pair_args(torch, dev, P, 256, lb_range, bw_, W_,
                                                          seed)
    saved = torch.load(shapes, weights_only=False) if shapes else {}
    for name, args in saved.get("B", {}).items():  # "pipeline:PxRxW"
        buckets[name] = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    for name, args in buckets.items():
        for which in "BF":
            if which in kernels:
                cases[f"{which}:{name}"] = (which, args)
    if "E" in kernels:
        for name, wave in saved.get("E", {}).items():
            cases[f"{name}:wave"] = ("E", wave)
    return cases


def record(path: str, device=None, workload=None) -> dict:
    """One pass of :func:`.workload.run_pipeline` on ``workload`` ((adaptor1,
    adaptor2, reads); ``build_workload()``'s by default) on ``device``
    (``None`` means CUDA), saved to ``path`` for ``--shapes``: under
    ``"B"``, for each distinct (P, rows, W) that ``ops/msa.py`` sent to
    ``banded_pair``, the first call's arguments on the host, named
    ``pipeline:P{P}xR{rows}xW{W}``; under ``"E"``, for each distinct (P,
    rows, W), the first merge wave that ``api/msa.py`` sent to
    ``merge_wave_from_library``, as (its library cut down to the entries the
    wave reads, its descriptors with their segments moved onto the cut,
    rows, W), named ``pipeline:E:P{P}xR{rows}xW{W}``.  Returns what it
    saved."""
    import torch

    from sarlacc_tpu_torch.api import msa as api_msa
    from sarlacc_tpu_torch.ops import msa as ops_msa
    from sarlacc_tpu_torch.tools.workload import build_workload, run_pipeline

    saved = {"B": {}, "E": {}}
    pair, wave = ops_msa.banded_pair, api_msa.merge_wave_from_library

    def recording_pair(*args):
        name = f"pipeline:P{int(args[0].shape[0])}xR{int(args[10])}xW{int(args[11])}"
        if name not in saved["B"]:
            saved["B"][name] = tuple(a.to("cpu", copy=True) if torch.is_tensor(a) else a
                                     for a in args)
        return pair(*args)

    def recording_wave(lib, descs, rows, W):
        name = f"pipeline:E:P{len(descs)}xR{rows}xW{W}"
        if name not in saved["E"]:
            tab, w_inv = lib
            parts, cut, at = [], [], 0
            for d in descs:
                segs = []
                for (start, length, aoff, boff, swap) in d["segments"]:
                    parts.append(tab[start : start + length])
                    segs.append((at, length, aoff, boff, swap))
                    at += length
                cut.append({**d, "segments": segs})
            saved["E"][name] = ((torch.cat(parts or [tab[:0]]).cpu(), w_inv), cut, rows, W)
        return wave(lib, descs, rows, W)

    ops_msa.banded_pair, api_msa.merge_wave_from_library = recording_pair, recording_wave
    try:
        run_pipeline(*(workload or build_workload()), device=device)
    finally:
        ops_msa.banded_pair, api_msa.merge_wave_from_library = pair, wave
    torch.save(saved, path)
    return saved


def _checksum(torch, t, chunk: int = 1 << 26) -> float:
    """A float64 sum of ``t`` taken in chunks, in a fixed order (a whole
    direction plane in float64 would not fit the card)."""
    flat = t.reshape(-1)
    return sum(float(flat[k : k + chunk].to(torch.float64).sum())
               for k in range(0, flat.numel(), chunk))


def _own_timing():
    """This file's ``timing`` module (not the root's, which may predate
    ``queued_ms``), so that every root is timed alike."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "timing.py")
    spec = importlib.util.spec_from_file_location("kernel_turns_timing", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_root(root: str, shapes=None, kernels="ABEFGS", reps: int = 5) -> dict:
    """In this process: import ``root``'s package, time its kernels at every
    case.  Returns {"root", "device", "ms": {case: ms}, "digest": {case:
    output checksums}}."""
    sys.path.insert(0, os.path.abspath(root))
    import time

    import torch

    import sarlacc_tpu_torch as st
    from sarlacc_tpu_torch.ops import backtrack, cuda_backtrack
    from sarlacc_tpu_torch.ops import msa as ops_msa
    from sarlacc_tpu_torch.ops.align import dp_align
    from sarlacc_tpu_torch.ops.cuda_align import dir_kernel
    from sarlacc_tpu_torch.ops.cuda_msa import banded_pair_plain, pair_kernel
    from sarlacc_tpu_torch.ops.cuda_walk import pair_walk

    if not st.__file__.startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {st.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_turns times the kernels on the card: no CUDA device")
    dev = torch.device("cuda")

    def walk_plain(dirs, la, lb, lo, ca, cb):
        jm = ops_msa._pair_walk_kernel(dirs, la, lb, lo)
        return jm, ops_msa._pair_ident_kernel(jm, ca, cb)

    def wave_plain(lib, descs, rows, W):
        return (ops_msa.merge_wave_from_library(lib, descs, rows, W),)

    queued_ms = _own_timing().queued_ms

    out = {"root": root, "device": torch.cuda.get_device_name(0), "ms": {}, "digest": {},
           "counts": {}}
    for name, (which, args) in _inputs(torch, st, dev, shapes, kernels).items():
        if which == "F":  # kernel F on this bucket's directions
            _, dirs = pair_kernel(*args)
            args = (dirs, args[2], args[3], args[4], args[0], args[1])
            fn, plain = (lambda a=args: pair_walk(*a)), (lambda a=args: walk_plain(*a))
        elif which == "E":  # the whole wave path on this wave
            (tab, w_inv), descs, rows, W = args
            lib = (tab.to(dev), w_inv)
            fn = lambda lib=lib, d=descs, r=rows, w=W: (ops_msa.merge_wave_from_library(lib, d, r, w),)
            plain = None
            if len(descs) * rows * W <= 2**27:
                plain = lambda t=tab, i=w_inv, d=descs, r=rows, w=W: wave_plain((t, i), d, r, w)
        else:
            kernel = {"A": dir_kernel, "B": pair_kernel, "G": cuda_backtrack.qmap_walk,
                      "S": cuda_backtrack.string_walk}[which]
            fn = lambda k=kernel, a=args: k(*a)
            plain = lambda a=args, p={"A": dp_align, "B": banded_pair_plain,
                                      "G": backtrack._qmap_walk_plain,
                                      "S": backtrack._string_walk_plain}[which]: p(*a)
        got = fn()
        if plain is not None:
            want = plain()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w_.to(g.device)) for g, w_ in zip(got, want)):
                raise AssertionError(f"{root}: kernel {which} at {name} differs from its plain version")
            del want
        out["digest"][name] = [_checksum(torch, g) for g in got]
        del got
        if which in "GS" and hasattr(cuda_backtrack, "COUNTS"):
            k = torch.zeros(len(cuda_backtrack.COUNTS), dtype=torch.int64, device=dev)
            kernel(*args, fetches=k)
            out["counts"][name] = dict(zip(cuda_backtrack.COUNTS, k.tolist()))
        fn()
        torch.cuda.synchronize()
        if which == "E":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
                torch.cuda.synchronize()
            out["ms"][name] = (time.perf_counter() - t0) * 1e3 / reps
            continue
        if which in "GS":
            out["ms"][name] = queued_ms(fn, reps, dev)
            continue
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out["ms"][name] = start.elapsed_time(end) / reps
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--worker"]:
        _, root, shapes, kernels = argv
        print(json.dumps(run_root(root, shapes or None, kernels)), flush=True)
        return 0
    if argv[:1] == ["--record"] and len(argv) == 2:
        saved = record(os.path.abspath(argv[1]))
        print(json.dumps({"recorded": argv[1], "B": sorted(saved["B"]), "E": sorted(saved["E"])}))
        return 0
    shapes, kernels = "", "ABEFGS"
    while argv[:1] in (["--shapes"], ["--kernels"]):
        if argv[0] == "--shapes":
            shapes = os.path.abspath(argv[1])
        else:
            kernels = argv[1]
        argv = argv[2:]
    if not argv:
        raise SystemExit(__doc__)
    runs = []
    for k, root in enumerate(argv):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", os.path.abspath(root), shapes,
             kernels],
            cwd=os.path.abspath(root), capture_output=True, text=True, timeout=1800,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"turn {k} ({root}) failed:\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"[kernel_turns] turn {k}: {root} on {runs[-1]['device']}: "
              + ", ".join(f"{n} {ms:.3f} ms" for n, ms in runs[-1]["ms"].items()), flush=True)
    for run in runs[1:]:
        if run["digest"] != runs[0]["digest"]:
            raise AssertionError(f"{run['root']} computes other outputs than {runs[0]['root']}")
    print(json.dumps({"turns": [r["root"] for r in runs],
                      "ms": {n: [r["ms"][n] for r in runs] for n in runs[0]["ms"]},
                      "counts": {r["root"]: r["counts"] for r in runs if r["counts"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

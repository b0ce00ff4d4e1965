"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its result on its own line:

1. environment: torch / CUDA / nvcc versions, card name and power limit;
2. build: both hand-written CUDA kernels and the native host library, from
   this checkout's sources;
3. kernels: kernel A (adaptor direction DP) and kernel B (banded pair DP)
   against their plain PyTorch versions on the card, at the pipeline's
   shapes; directions and scores must be equal; CUDA-event times for both;
4. golden: the seed-locked mock pipeline of tests/test_golden_pipeline.py
   through the port's five entry points on the card, compared key by key
   with tests/golden/pipeline_mock.json;
5. pipeline: the ~10k-read workload of bench.py (950 molecules, 8-14 reads
   each, 400-700 bp, seed 7, 12 bp UMI): one warm-up pass that also times
   the plain-PyTorch device steps, then one timed pass with per-stage
   seconds and the kernels' launch counts.

The second-to-last line is a JSON object describing the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; so does a machine without a CUDA device.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

ADAPTOR1_GOLDEN = "ACGCTAGCATCAGTC" + "NNNN" + "CACAGCTACGA" + "NNNNNNNN" + "CGTACGCAT"
ADAPTOR1_BENCH = "ACGCTAGCATCAGTC" + "NNNN" + "CACAGCTACGA" + "N" * 12 + "CGTACGCAT"
ADAPTOR2 = "TGCATCGATCGCAT"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(torch, what, dirs_k, dirs_p, s_k, s_p) -> float:
    """Directions must be bit-equal and scores equal (tolerance 0).

    Returns the largest absolute score difference over finite entries.
    """
    torch.cuda.synchronize()
    if not torch.equal(dirs_k, dirs_p):
        bad = int((dirs_k != dirs_p).sum())
        raise AssertionError(f"{what}: directions differ from the plain version in {bad} cells")
    if not torch.equal(s_k, s_p):
        raise AssertionError(f"{what}: scores differ from the plain version")
    fin = torch.isfinite(s_k) & torch.isfinite(s_p)
    return float((s_k[fin] - s_p[fin]).abs().max()) if bool(fin.any()) else 0.0


def mock_batch(st, adaptor1, **kw):
    fp = tempfile.mktemp(suffix=".fastq")
    try:
        st.mock_reads(adaptor1, ADAPTOR2, fp, **kw)
        return st.read_fastq(fp)
    finally:
        if os.path.exists(fp):
            os.remove(fp)


def phase_environment(torch):
    from sarlacc_tpu_torch.native.build import nvcc_path

    nvcc = subprocess.run(
        [nvcc_path(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | nvcc: {nvcc}")
    log(f"[env] card: {smi}")
    return smi


def phase_build():
    from sarlacc_tpu_torch.native import get_lib
    from sarlacc_tpu_torch.ops.cuda_align import DIR_KERNEL
    from sarlacc_tpu_torch.ops.cuda_msa import PAIR_KERNEL

    t0 = time.perf_counter()
    for kernel in (DIR_KERNEL, PAIR_KERNEL):
        kernel.build()
    t1 = time.perf_counter()
    get_lib()
    t2 = time.perf_counter()
    log(f"[build] cuda kernels {t1 - t0:.2f} s, host library {t2 - t1:.2f} s")


def phase_kernels(torch, st, batch, dev, max_pairs=4096):
    """Kernel A and kernel B against their plain versions, same inputs."""
    import numpy as np

    from sarlacc_tpu_torch.api.align_internal import prepare_adaptor
    from sarlacc_tpu_torch.core.encode import SeqBatch
    from sarlacc_tpu_torch.ops.align import dp_align, prepare_reads
    from sarlacc_tpu_torch.ops.cuda_align import (
        build_cost_planes, dir_kernel, encode_mask, plane_dims,
    )
    from sarlacc_tpu_torch.ops.cuda_msa import banded_pair_plain, pair_kernel

    rows_out = []

    # Kernel A: the stacked front+back batch of adaptor_align, L = 250.
    front, back = batch.front_and_back(250)
    stacked = SeqBatch.concat([front, back])
    for name, adaptor in (("adaptor1", ADAPTOR1_BENCH), ("adaptor2", ADAPTOR2)):
        ad = prepare_adaptor(adaptor, device=dev)
        codes, qidx, lengths = prepare_reads(stacked, ad.tables, device=dev)
        N, L = codes.shape
        l1, n_pad = plane_dims(N, L)
        planes = build_cost_planes(codes, qidx, ad.match_tab, ad.mismatch_tab, l1, n_pad)
        mask = encode_mask(ad.matched)
        args = (ad.modes, mask, 5.0, 1.0, *planes, True)
        S_k, D_k = dir_kernel(*args)
        S_p, D_p = dp_align(*args)
        err = compare(torch, f"kernel A ({name})", D_k, D_p, S_k, S_p)
        ms = cuda_ms(torch, lambda: dir_kernel(*args), 5)
        plain_ms = cuda_ms(torch, lambda: dp_align(*args), 3)
        log(f"[kernels] A {name}: N={N} L={L} R={len(adaptor)} l1={l1} n_pad={n_pad}: "
            f"dirs equal, max|dS|={err}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        rows_out.append(("A", name, err, ms, plain_ms))

    # Kernel B: one pipeline-shaped bucket, rows = 1024, W = 256.
    rows, W, bw = 1024, 256, 100
    lens = batch.lengths.astype(np.int64)
    cand = np.flatnonzero((lens > 512) & (lens <= rows))
    cand = cand[np.argsort(lens[cand], kind="stable")]
    ia, ib = cand[:-1], cand[1:]
    keep = np.abs(lens[ib] - lens[ia]) + 2 * bw + 1 <= W
    ia, ib = ia[keep][:max_pairs], ib[keep][:max_pairs]
    P = ia.size
    if P < min(1024, max_pairs):
        raise AssertionError(f"only {P} pipeline-shaped pairs in the mock batch")
    la, lb = lens[ia], lens[ib]
    diff = lb - la
    lo = np.minimum(0, diff) - bw
    hi = np.maximum(0, diff) + bw
    w = min(batch.width, rows)
    ca = np.full((P, rows), 5, np.int8)
    ca[:, :w] = batch.codes[ia][:, :w]
    cb = np.full((P, rows), 5, np.int8)
    cb[:, :w] = batch.codes[ib][:, :w]

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    bargs = (
        t(ca), t(cb), t(la, np.int32), t(lb, np.int32), t(lo, np.int32),
        t(hi - lo, np.int32), 0.0, -1.0, 5.0, 1.0, rows, W,
    )
    sk, dk = pair_kernel(*bargs)
    sp, dp = banded_pair_plain(*bargs)
    err = compare(torch, "kernel B", dk, dp, sk, sp)
    ms = cuda_ms(torch, lambda: pair_kernel(*bargs), 5)
    plain_ms = cuda_ms(torch, lambda: banded_pair_plain(*bargs), 1)
    log(f"[kernels] B pairs: P={P} rows={rows} W={W}: dirs equal, max|dscore|={err}, "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    rows_out.append(("B", "pairs", err, ms, plain_ms))
    return rows_out


def run_pipeline(torch, st, batch, adaptor1, dev, timings=None):

    def mark(name):
        if timings is not None:
            torch.cuda.synchronize()
            timings.append((name, time.perf_counter()))

    mark("start")
    aligned = st.adaptor_align(adaptor1, ADAPTOR2, reads=batch, tolerance=250, device=dev)
    mark("adaptor_align")
    umis = aligned["adaptor1"]["subseq"]["Sub2"]
    groups = st.umi_group(umis, threshold1=2, device=dev)
    mark("umi_group")
    filt = [g for g in groups if len(g) >= 2]
    reads = st.realize_reads(aligned, reads=batch, trim=False, device=dev)
    msa = st.multi_read_align(reads, groups=filt, bandwidth=100, device=dev)
    mark("multi_read_align")
    cons = st.consensus_read_seq(msa, device=dev)
    mark("consensus")
    return aligned, umis, groups, msa, cons


def phase_golden(torch, st, kernels, dev):
    batch = mock_batch(
        st, ADAPTOR1_GOLDEN, nmolecules=10, nreads_range=(4, 9),
        seqlen_range=(350, 600), seed=20240817,
    )
    for k in kernels:
        k.launches = 0
    aligned, umis, groups, msa, cons = run_pipeline(torch, st, batch, ADAPTOR1_GOLDEN, dev)
    counts = {k.symbol: k.launches for k in kernels}
    snap = {
        "n_reads": int(len(batch)),
        "adaptor1_score": [round(float(s), 4) for s in aligned["adaptor1"]["score"]],
        "adaptor1_start": [int(x) for x in aligned["adaptor1"]["start"]],
        "adaptor1_end": [int(x) for x in aligned["adaptor1"]["end"]],
        "adaptor2_score": [round(float(s), 4) for s in aligned["adaptor2"]["score"]],
        "adaptor2_start": [int(x) for x in aligned["adaptor2"]["start"]],
        "adaptor2_end": [int(x) for x in aligned["adaptor2"]["end"]],
        "reversed": [bool(r) for r in aligned["reversed"]],
        "umi": umis.seq_strings(),
        "groups": [[int(i) for i in g] for g in groups],
        "alignments": [list(a) for a in msa["alignments"]],
        "consensus_seq": cons.seq_strings(),
        "consensus_qual": cons.qual_strings(),
    }
    with open(os.path.join(HERE, "tests", "golden", "pipeline_mock.json")) as fh:
        want = json.load(fh)
    if sorted(snap) != sorted(want):
        raise AssertionError(f"golden keys differ: {sorted(snap)} vs {sorted(want)}")
    bad = [key for key in want if snap[key] != want[key]]
    if bad:
        raise AssertionError(f"golden mismatch on the card in {bad}")
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel never launched in the golden run: {counts}")
    log(f"[golden] {len(want)} keys equal tests/golden/pipeline_mock.json "
        f"({len(batch)} reads, {len(cons)} consensus reads); launches {counts}")


#: Steps timed in the warm-up pass, (module, name): the plain-PyTorch
#: device steps, the two kernels' wrappers, and the host-side work of the
#: MSA stage.  The triplet extension runs in a thread pool, so its total
#: is summed over threads and can exceed its share of the wall clock.
STEPS = (
    ("sarlacc_tpu_torch.api.align_internal", "qmap_walk"),
    ("sarlacc_tpu_torch.api.umi", "lev2_matrix"),
    ("sarlacc_tpu_torch.ops.msa", "_pair_walk_kernel"),
    ("sarlacc_tpu_torch.ops.msa", "_merge_cost_init"),
    ("sarlacc_tpu_torch.ops.msa", "_merge_accum_kernel"),
    ("sarlacc_tpu_torch.ops.msa", "_profile_merge_kernel"),
    ("sarlacc_tpu_torch.ops.msa", "_merge_walk_kernel"),
    ("sarlacc_tpu_torch.api.consensus", "consensus_quality_flat"),
    ("sarlacc_tpu_torch.ops.cuda_align", "dir_kernel"),
    ("sarlacc_tpu_torch.ops.msa", "banded_pair"),
    ("sarlacc_tpu_torch.ops.msa", "_compact_jmat"),
    ("sarlacc_tpu_torch.api.msa", "_pair_post"),
    ("sarlacc_tpu_torch.api.msa", "triplet_extend_native"),
    ("sarlacc_tpu_torch.api.msa", "_nj_tree"),
    ("sarlacc_tpu_torch.api.msa", "_merge_descriptor"),
    ("sarlacc_tpu_torch.api.msa", "_apply_merge"),
    ("sarlacc_tpu_torch.api.msa", "_reconstruct"),
)


def timed_steps(torch):
    """Wrap each step with synchronized wall timers; returns (totals, undo)."""
    import importlib

    totals: dict[str, list] = {}
    undo = []
    for mod_name, attr in STEPS:
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)
        totals[attr] = [0.0, 0]

        def wrapped(*a, _orig=orig, _acc=totals[attr], **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(*a, **kw)
            torch.cuda.synchronize()
            _acc[0] += time.perf_counter() - t0
            _acc[1] += 1
            return out

        setattr(mod, attr, wrapped)
        undo.append((mod, attr, orig))

    def restore():
        for mod, attr, orig in undo:
            setattr(mod, attr, orig)

    return totals, restore


def phase_pipeline(torch, st, batch, kernels, dev):
    totals, restore = timed_steps(torch)
    try:
        t0 = time.perf_counter()
        run_pipeline(torch, st, batch, ADAPTOR1_BENCH, dev)
        warm_s = time.perf_counter() - t0
    finally:
        restore()
    steps = ", ".join(
        f"{k} {v[0]:.3f} s/{v[1]} calls"
        for k, v in sorted(totals.items(), key=lambda kv: -kv[1][0])
    )
    log(f"[pipeline] warm-up pass {warm_s:.3f} s; synchronized step times: {steps}")

    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    timings: list = []
    _, _, groups, msa, cons = run_pipeline(torch, st, batch, ADAPTOR1_BENCH, dev, timings)
    counts = {k.symbol: k.launches for k in kernels}
    stages = {
        name: timings[i][1] - timings[i - 1][1] for i, (name, _) in enumerate(timings) if i
    }
    total = timings[-1][1] - timings[0][1]
    n_aligned = sum(len(a) for a in msa["alignments"])
    if len(cons) != len(msa["alignments"]) or n_aligned == 0:
        raise AssertionError("pipeline produced no alignments")
    empty = sum(1 for s in cons.seq_strings() if not s)
    if empty:
        raise AssertionError(f"{empty} empty consensus sequences")
    if min(counts.values()) == 0:
        raise AssertionError(f"a kernel never launched in the main path: {counts}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[pipeline] {len(batch)} reads, {len(groups)} UMI groups, {len(cons)} "
        f"consensus reads: {total:.3f} s = {len(batch) / total:.1f} reads/s; stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"; peak allocated {peak:.2f} GiB; launches {counts}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available (torch.cuda.is_available() "
              "is False); this script needs one NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import sarlacc_tpu_torch as st
    except ImportError as exc:
        print(f"chip_smoke: the sarlacc_tpu_torch package is not next to this "
              f"script ({exc})", file=sys.stderr)
        return 2
    from sarlacc_tpu_torch.ops.cuda_align import DIR_KERNEL
    from sarlacc_tpu_torch.ops.cuda_msa import PAIR_KERNEL

    kernels = (DIR_KERNEL, PAIR_KERNEL)
    smi = phase_environment(torch)
    phase_build()
    bench = mock_batch(
        st, ADAPTOR1_BENCH, nmolecules=950, nreads_range=(8, 14),
        seqlen_range=(400, 700), seed=7,
    )
    dev = torch.device("cuda")
    krows = phase_kernels(torch, st, bench, dev)
    phase_golden(torch, st, kernels, dev)
    counts = phase_pipeline(torch, st, bench, kernels, dev)

    desc = {
        "A": (DIR_KERNEL, "sarlacc_tpu/ops/pallas_align.py:193"),
        "B": (PAIR_KERNEL, "sarlacc_tpu/ops/pallas_msa.py:99"),
    }
    report = []
    for key, name, err, ms, plain_ms in krows:
        kern, replaces = desc[key]
        report.append({
            "name": f"{os.path.splitext(os.path.basename(kern.source))[0]}[{name}]",
            "route": "cuda",
            "source": os.path.relpath(kern.source, HERE),
            "replaces": replaces,
            "launches": counts[kern.symbol],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
        })
    print(smi)
    print(json.dumps({"kernels": report}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

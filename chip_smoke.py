"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--save-shapes FILE]

(``--save-shapes`` keeps the arguments of each kernel-B launch shape of the
pipeline's warm-up pass and of each (rows, W) of the long_reads phase's,
and each merge wave of both, with the library entries it reads, in FILE,
for ``python -m sarlacc_tpu_torch.tools.kernel_turns``.)  Phases, each printing its result
on its own line:

1. environment: torch / CUDA / nvcc versions, card name and power limit;
2. build: the hand-written CUDA kernels (one nvcc per source, all started
   together: the eight of the paths and the tools' two) and the native
   host library, from this checkout's sources;
3. kernels: kernel A (direction DP) at adaptor_align's stacked ends (R =
   51 and 14), at quality_align's launch (R = 500, global) and at a
   reference wider than its lanes' tiles (R = 150, two passes), with its
   plan (tile, lanes a read, passes), registers, spills and occupancy
   (theoretical, and achieved from block stamps); kernel B (banded pair DP)
   at a 4096 x 1024 x 256 bucket and, after phase 5, at each distinct
   (P, rows, W) the pipeline's warm-up pass launched, on its own route and
   the block route beside it, and on its wide route (a cluster of W / 8192
   blocks a pair, one block at W 8192) at W = 8192 (64
   pairs, reads of 4.0-4.6 kb against 128-256 bp) and W = 65 536 (4
   pairs, 31-32 kb reads, bandwidth 16 500), with its cluster size and the
   clusters the card holds at once; kernel C (score-only DP) at
   the demux shape of bench.py:207-240 and at calibration's (19 926 stacked ends); kernel D
   (multi-segment score-only DP) at the demux shapes, with 24-bp barcodes
   (so each of its three tile widths runs), at tune_alignment's
   (19 926 stacked ends x 35 penalty points, each adaptor) and with a
   global segment of R = 150 that crosses column tiles beside an empty
   one; each against its plain PyTorch version on the card (directions and
   scores must be equal), with CUDA-event times, GCUPS, kernel C and D's
   registers, shared memory and occupancy (theoretical, and achieved from
   per-block timer stamps); after phases 9 and 10, every kernel once more
   at each launch shape the mesh run and rank 0 of the distributed run
   launched (recorded as they ran; kernels B, E and F one shape a (rows,
   band width)), against its plain version; kernels G (the backtrack
   walks), H (the device library's consistency extension) and I (the
   Levenshtein DP) at every shape the golden, pipeline, msa_library,
   calibration, mesh and umi phases launched them, recorded as they ran
   and replayed against their plain versions (bit-equal), with G's
   fetching steps in all and by kind (equal to the plain walk's own
   count, or the run fails) and the round trips of its longest lane,
   H's entries (H a whole library build: every chunk's
   counting pass, the device scan, one readback, every writing pass) and
   I's DP cells, and I's thresholded form (the row-block scan's hits, in
   order, and its DP cells; a forced overflow re-runs once);
4. golden: the seed-locked mock pipeline of tests/test_golden_pipeline.py
   through the port's five entry points on the card, compared key by key
   with tests/golden/pipeline_mock.json; one call of kernels E and F for
   each (rows, band width) it launched, recorded as it ran, then replayed
   against its plain version (jmat and identities bit-equal);
5. pipeline: the ~10k-read workload of bench.py (950 molecules, 8-14 reads
   each, 400-700 bp, seed 7, 12 bp UMI): one warm-up pass that also times
   the plain-PyTorch device steps, the kernels' wrappers and both library
   routes' steps, prints the stage profiler's report and the merge waves'
   peak allocated memory, and records kernel B's launch shapes and one
   call of kernels E (a merge wave from its sorted library entries: cost
   rows built on chip, DP, walk) and F (pair walk + identity) for each
   (rows, band width), each then replayed against its plain version (jmat
   and identities bit-equal; E's plain version builds the float32 cost
   planes and adds the entries in order), then
   one timed pass (the default, device-library route of multi_read_align)
   with per-stage seconds, peak allocated memory and the kernels' launch
   counts, then multi_read_align on its reads and groups with
   SARLACC_HOST_LIB=1, timed, and once more with the step timers;
   msa_library: both libraries on the card for the first segment of those
   groups, held to the JAX package's device-vs-host tolerances (the same
   pairs and (a, b) entries, identities within 1e-6, weights within one
   quantum), then the device route on 20 groups of 2-10 reads on the card
   against ``device="cpu"`` with the segment budget pinned (table,
   identities and strings bit-equal);
   long_reads: ``mock_reads`` of 48 molecules of 4.3-5 kb inserts, 6-9
   reads each (seed 11, reads on their molecule's strand), 30% of each
   molecule's reads (at least one) cut to their first 150-400 bases, the
   molecules as groups: ``multi_read_align`` at the default bandwidth on
   the route ``_device_lib_ok`` gives (a warm-up pass recording kernels B,
   E, F and H one call a (rows, W), a timed pass), ``consensus_read_seq``;
   every full x cut pair must bucket to W 8192 and kernel B's wide route
   run at 8192 rows and at <= 512; two groups cut to one full read and the
   first cut read after it (an 8192-row wide pair) on the card against
   ``device="cpu"`` (alignments and consensus); then every recorded call
   replayed against its plain version (E's on runs of merges of at most
   2^31 band cells, every merge of the call), with stage seconds and peak
   memory;
6. golden demux: tests/golden/barcode_demux.json through adaptor_align ->
   barcode_align -> get_barcode_thresholds on the card;
7. demux: bench.py::bench_demux's pass (100 000 random 250-bp ends against
   both adaptors, one kernel-D launch per batch, strand resolution, then
   12 barcodes against 100 000 observed 12-bp reads in one kernel-D
   launch): one warm-up pass with synchronized step timers, one timed
   pass with reads/s and launch counts;
8. calibration: tune_alignment, get_adaptor_thresholds, filter_reads,
   extract_subseq and quality_align on the phase-5 batch and its aligned
   frame: one warm-up pass with synchronized step timers, one timed pass
   with the launch counts, then its outputs compared with the same calls on
   ``device="cpu"`` (tune_alignment on a 400-read slice: its plain CPU
   run at full size would take many minutes);
9. mesh: every entry point that takes ``mesh=`` on ``make_mesh(4)`` (four
   shards of ``cuda:0``) over the phase-5 batch: ``adaptor_align`` ->
   ``umi_group`` (16 pre-groups by the UMI's first two bases, so
   shuffle-by-pregroup runs) -> ``realize_reads`` -> ``multi_read_align`` ->
   ``consensus_read_seq`` (the padded layout), then ``tune_alignment``,
   ``get_adaptor_thresholds``, ``barcode_align`` (the demux barcodes on
   20 000 observed reads) and ``extract_subseq`` (on calibration's
   filtered frame); each output equal byte for byte to the same call
   without a mesh, each stage timed both ways (the solo ``adaptor_align``,
   ``tune_alignment``, ``get_adaptor_thresholds`` and ``extract_subseq``
   are phases 5 and 8's own calls, made with the same arguments);
10. distributed: two ranks (``torch.multiprocessing.spawn``, gloo, both on
    ``cuda:0``) stream their byte ranges of the phase-5 reads from a
    temporary FASTQ and score them with kernel C through
    ``sharded_adaptor_scores`` on a mesh that spans them; rank 0 holds the
    gathered scores and summed histograms to one process's, bit for bit;
    300 s limit;
11. umi: ``umi_group`` on three workloads from bench.py::bench_umi's
   generator (random centres, 30% of reads mutated by one base, one
   pre-group, seed 5): 100 000 10-bp UMIs at threshold 2 (the native
   filter path), 20 000 30-bp UMIs at threshold 2 and 20 000 20-bp UMIs at
   threshold 3 (both the row-block neighbour scan on the card, kernel I's
   thresholded form); each warmed on a quarter, then timed with the scan's
   synchronised step time and its host readbacks; for the two
   scan workloads the groups of a 2 500-UMI slice equal the same call on
   ``device="cpu"``;
12. tools: every new kernel (the five kernel-C ablations, the four op-mix
    and five op-rate classes) against its plain version on the card, bit
    for bit (the chains at 4 iterations), ``full`` against kernel C and the
    profile's pure kernel C against ``dp_scores``; then the four
    measurement tools (``sarlacc_tpu_torch.tools``) once each at their
    defaults with 2 reps, with the launch counts.

Every phase that drives an entry point sets all kernels' launch counts to 0
before it and reads them after.  The second-to-last line is a JSON object
describing the kernels: per row its CUDA-event ms, the plain version's ms,
max |diff|, its launches over those runs (``launches``, and per path in
``launches_by_path``), registers and spill bytes a thread, and
``bound_ms``: the larger of its compulsory bytes
(each input read once, each output written once; of the cost planes only
the slots the references select, at the rows the DP computes; for kernel E
its kept library entries, 4-byte cell and 4-byte weight each, its row
pointers and bands and jmat; for kernel F the direction byte of each cell
on each pair's path) over 3.35 TB/s and its float operations (for E six a
live cell and one add an entry; for I's thresholded form six a band cell
it evaluated, as the kernel counts them) over 67 TFLOP/s (the H100 SXM
data sheet),
with ``bound_by`` naming the larger; the walks' rows also give
``chain_rows``, the longest chain of dependent row steps, which bounds
them more than either.  ``library_ms`` is null: no single PyTorch call
computes these DPs, walks or chains.  The last line is ``{"ok": true,
"device": {...}}``.  Any failure raises and exits non-zero; so does a
machine without a CUDA device.  Imports no JAX.
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


def event_ms(fn, reps: int, dev) -> float:
    """Mean CUDA-event milliseconds per call, after one warm-up call."""
    from sarlacc_tpu_torch.tools.timing import event_ms as timed

    return timed(fn, reps, dev)


#: The card's peak rates the bounds use: HBM bytes/s and float32 ops/s
#: outside the tensor cores (H100 SXM data sheet).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

#: Float operations (adds, multiplies, maxes, compares and selects) a DP
#: cell, counted in each kernel's cell body: E 6 (``csrc/merge_kernel.cu``:
#: M's add, the two maxes, the choice's two compares, the valid select);
#: A 26 (``csrc/dir_kernel.cu``'s
#: ``cell``: M, the horizontal candidates and choice, V, B, S, the direction
#: compares, the next row's vertical test, cum, and the cost select the
#: plain version makes); B 21 (``csrc/pair_kernel.cu``'s per-cell loops:
#: substitution select, M,
#: the vertical gap, mv, B and its running max, the closed horizontal gap,
#: the masks, S and the choice); C and D 10 (``csrc/score_kernel.cu``'s
#: ordinary cell: 6 adds, 4 maxes); the ablation kernels 17, the column-outer
#: body (``tools/op_rates.py::COLUMN_BODY_CENSUS``: 10 adds, 4 maxes, 3 selects);
#: I 6 integer operations (``csrc/lev2_kernel.cu``'s cell: two adds, two
#: minimums, the substitution cost from two bits), held to the same rate.
OPS_PER_CELL = {"A": 26, "B": 21, "C": 10, "D": 10, "ablation": 17, "E": 6, "I": 6}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def score_bytes(modes, mask, rows, *tensors) -> int:
    """Compulsory bytes of a DP over the cost planes: for each DP row a lane
    computes, its code and the [l1, n_pad] cost slots the columns
    ``modes`` / ``mask`` select (``cost_slots``: the other slots of the two
    [4, l1, n_pad] planes are never read), plus the columns and ``tensors``
    once each."""
    from sarlacc_tpu_torch.ops.cuda_align import cost_slots

    return int(rows) * 4 * (1 + len(cost_slots(modes, mask))) + nbytes(modes, mask, *tensors)


def bound(n_bytes, ops):
    """(least ms the card could take, what bounds it): bytes over the HBM
    rate against operations over the float32 rate."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def achieved_occupancy(torch, stamps, warps_per_block=4, warps_per_sm=64):
    """Mean resident warps an SM over the launch, as a share of the SM's
    64: each block's warps times its lifetime (per-block global-timer
    stamps), summed, over SMs x the launch's span."""
    st = stamps.cpu().double()
    span = float(st[:, 1].max() - st[:, 0].min())
    busy = float((st[:, 1] - st[:, 0]).sum()) * warps_per_block
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return busy / (sms * warps_per_sm * span)


def equal_scores(torch, what, got, want) -> float:
    """Scores must be equal (tolerance 0); returns max |diff| over finite entries."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{what}: scores differ from the plain version ({bad} entries)")
    fin = torch.isfinite(got)
    return float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0


def compare(torch, what, dirs_k, dirs_p, s_k, s_p) -> float:
    """Directions must be bit-equal and scores equal (tolerance 0).

    Returns the largest absolute score difference over finite entries.
    """
    torch.cuda.synchronize()
    if not torch.equal(dirs_k, dirs_p):
        bad = int((dirs_k != dirs_p).sum())
        raise AssertionError(f"{what}: directions differ from the plain version in {bad} cells")
    return equal_scores(torch, what, s_k, s_p)


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


def phase_build(kernels):
    """Every build at once: one nvcc per CUDA source, and g++ for the host."""
    from concurrent.futures import ThreadPoolExecutor

    from sarlacc_tpu_torch.native import get_lib

    by_source = {k.source: k for k in kernels}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(by_source) + 1) as pool:
        jobs = [pool.submit(k.build) for k in by_source.values()] + [pool.submit(get_lib)]
        for job in jobs:
            job.result()
    names = ", ".join(os.path.basename(src) for src in by_source)
    log(f"[build] {names} and the host library, in parallel: "
        f"{time.perf_counter() - t0:.2f} s")


def timed_once(torch, fn):
    """(result, CUDA-event ms) of one call: the plain versions run once a
    shape, and that run both times them and gives the comparison's side."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_kernels(torch, st, batch, dev, max_pairs=4096):
    """Kernel A and kernel B against their plain versions, same inputs: A at
    adaptor_align's stacked ends (R = 51 and 14, fitting), at quality_align's
    launch (300 reads against 500 bp of read 0, global) and at a reference
    wider than its lanes' tiles (R = 150 global over the stacked ends: two
    passes through the hand-off scratch); B at one 4096 x 1024 x 256 bucket
    (the pipeline's own launch shapes follow phase 5: :func:`pair_rows`)."""
    import numpy as np

    from sarlacc_tpu_torch.api.align_internal import prepare_adaptor
    from sarlacc_tpu_torch.core.encode import SeqBatch
    from sarlacc_tpu_torch.ops.align import dp_align, prepare_reads
    from sarlacc_tpu_torch.ops.cuda_align import (
        _launch_dirs, build_cost_planes, dir_kernel, dir_kernel_resources, dir_plan,
        encode_mask, plane_dims,
    )

    rows_out = []
    res = dir_kernel_resources()
    for name, r in res.items():
        log(f"[kernels] {name}: {r['registers']} registers a thread, {r['shared_bytes']} B "
            f"shared a block, {r['spill_bytes']} B spilled, {r['blocks_per_sm']} blocks of "
            f"{r['threads']} an SM: occupancy {r['occupancy']:.4f}")

    def a_row(name, reference, reads, local):
        ad = prepare_adaptor(reference, device=dev)
        codes, qidx, _ = prepare_reads(reads, ad.tables, device=dev)
        N, L = codes.shape
        l1, n_pad = plane_dims(N, L)
        planes = build_cost_planes(codes, qidx, ad.match_tab, ad.mismatch_tab, l1, n_pad)
        mask = encode_mask(ad.matched)
        args = (ad.modes, mask, 5.0, 1.0, *planes, local)
        S_k, D_k = dir_kernel(*args)
        (S_p, D_p), plain_ms = timed_once(torch, lambda: dp_align(*args))
        err = compare(torch, f"kernel A ({name})", D_k, D_p, S_k, S_p)
        del S_p, D_p
        ms = event_ms(lambda: dir_kernel(*args), 5, dev)
        tj, G, passes = dir_plan(len(reference), local, n_pad)
        stamps = torch.zeros((n_pad * G // 128, 3), dtype=torch.int64, device=dev)
        _launch_dirs(*args, stamps=stamps)
        torch.cuda.synchronize()
        occ = achieved_occupancy(torch, stamps)
        cells = len(reference) * l1 * n_pad  # every row of every lane
        bms, by = bound(score_bytes(ad.modes, mask, l1 * n_pad, S_k, D_k),
                        cells * OPS_PER_CELL["A"])
        r = res[f"A@{tj}"]
        log(f"[kernels] A {name}: N={N} L={L} R={len(reference)} l1={l1} n_pad={n_pad} "
            f"{'fitting' if local else 'global'}: dirs equal, max|dS|={err}, kernel {ms:.3f} ms "
            f"= {cells / ms / 1e6:.1f} GCUPS, plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}, "
            f"{100 * bms / ms:.1f}%); tile {tj}, {G} lanes a read, {passes} pass(es), "
            f"{r['registers']} registers, {r['spill_bytes']} B spilled, occupancy "
            f"{r['occupancy']:.4f} theoretical, {occ:.4f} achieved")
        rows_out.append(dict(key="A", name=name, err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by, gcups=cells / ms / 1e6, tile=tj,
                             lanes=G, passes=passes, registers=r["registers"],
                             spill_bytes=r["spill_bytes"], achieved_occupancy=occ))
        del S_k, D_k, planes

    # adaptor_align's (and extract_subseq's) launches: the stacked front and
    # back ends, L = 250.
    front, back = batch.front_and_back(250)
    stacked = SeqBatch.concat([front, back])
    a_row("adaptor1", ADAPTOR1_BENCH, stacked, True)
    a_row("adaptor2", ADAPTOR2, stacked, True)
    a_row("quality_align", batch.seq_strings()[0][50:550], batch.take(np.arange(1, 301)), False)
    a_row("multi-pass", LONG_REF, stacked, False)

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
    cases = {"pairs": bargs}
    # The wide route: 128-256-bp reads against 4.0-4.6 kb ones at the
    # default bandwidth (W = 8192), and against 31-32 kb ones at bandwidth
    # 16 500 (W = 65 536, the widest bucket a legal input makes).
    from sarlacc_tpu_torch.tools.kernel_turns import wide_pair_args

    cases["wide@8192"] = wide_pair_args(torch, dev, 64, 256, (4000, 4600), 100, 8192, 5)
    cases["wide@65536"] = wide_pair_args(torch, dev, 4, 256, (31000, 32000), 16500, 65536, 6)
    rows_out += pair_rows(torch, cases, dev)
    return rows_out


#: Each kernel's wrapper where the entry points reach it: key -> (module,
#: name).  The module looks the wrapper up by name at each call.
WRAPPERS = {
    "A": ("sarlacc_tpu_torch.ops.cuda_align", "dir_kernel"),
    "B": ("sarlacc_tpu_torch.ops.cuda_msa", "pair_kernel"),
    "C": ("sarlacc_tpu_torch.ops.cuda_align", "score_kernel"),
    "D": ("sarlacc_tpu_torch.ops.cuda_align", "segments_kernel"),
    "E": ("sarlacc_tpu_torch.ops.cuda_walk", "merge_dp_walk"),
    "F": ("sarlacc_tpu_torch.ops.cuda_walk", "pair_walk"),
    "G": ("sarlacc_tpu_torch.ops.cuda_backtrack", "qmap_walk"),
    "S": ("sarlacc_tpu_torch.ops.cuda_backtrack", "string_walk"),  # kernel G's string walk
    "H": ("sarlacc_tpu_torch.ops.cuda_extend", "extend_library"),
    "I": ("sarlacc_tpu_torch.ops.cuda_lev2", "lev2_cross"),
    "T": ("sarlacc_tpu_torch.ops.cuda_lev2", "lev2_hits"),  # kernel I's thresholded form
}

#: Every key of :data:`WRAPPERS`.
ALL_KEYS = "ABCDEFGSHIT"


def call_shape(key, args, with_pairs=True) -> str:
    """The launch shape of one call of kernel ``key``'s wrapper, as a row
    name: what the kernel's plan and time depend on."""
    if key == "B":
        pairs = f"P{int(args[0].shape[0])}x" if with_pairs else ""
        return f"{pairs}R{int(args[10])}xW{int(args[11])}"
    if key in "GS":  # dirs [R, l1, n_pad], lengths
        R, l1, n_pad = args[0].shape
        return f"{key}:R{R}xl1{l1}" + (f"xN{n_pad}" if with_pairs else "")
    if key == "H":  # arena, jobs, first_job, fracs, order, chunks, w_scale: one library build
        chunks = args[5]
        return (f"H:J{int(args[4].shape[0])}xC{len(chunks)}xSL{min(c[2] for c in chunks)}-"
                f"{max(c[2] for c in chunks)}xS{int(args[0].shape[1])}") if chunks else "H:J0"
    if key == "T":  # codes [n, W], lens, s_len, thr, limit, tile
        n, W = args[0].shape
        return f"T:n{n}xW{W}xthr{int(args[3])}"
    if key == "I":  # a [TI, L], la, b [TJ, L], lb
        TI, L = args[0].shape
        return f"I:{TI}x" + (f"{int(args[2].shape[0])}x" if with_pairs else "") + f"L{L}"
    if key in "EF":  # E: cols, w, rowptr, 4 x [Pp], rows, W; F: dirs [rows, P, W] (B's shape)
        if key == "E":
            P, rows, W = args[3].shape[0], args[7], args[8]
        else:
            rows, P, W = args[0].shape
        pairs = f"P{int(P)}x" if with_pairs else ""
        return f"{key}:{pairs}R{int(rows)}xW{int(W)}"
    if key == "D":  # modes, mask, segs, costm, costmm, codes_k, lens_k
        l1, n_pad = args[5].shape
        return f"nseg{len(args[2])}xR{int(args[0].shape[0])}xl1{l1}xN{n_pad}"
    # A: modes, mask, go, ge, costm, costmm, codes_k, local;
    # C: the same with lengths before local.
    l1, n_pad = args[6].shape
    n, local = (n_pad, args[7]) if key == "A" else (int(args[7].shape[0]), args[8])
    return f"R{int(args[0].shape[0])}xl1{l1}xN{n}:{'fitting' if local else 'global'}"


def record_calls(torch, path, keys=ALL_KEYS, per_width=False):
    """Wrap the wrappers of kernels ``keys`` so that the first call of each
    distinct launch shape keeps a copy of its arguments (taken before the
    call: kernel H adds to its counts), named ``path:shape``; kernels E and
    F keep one call for each (rows, W) only, kernel I one for each (rows of
    a, L), and with ``per_width`` kernels B, G and H one for each shape
    without its pair or read count.  Kernel H's arena is kept, not copied:
    nothing writes to it after the pair walks, and it is the largest
    argument.  Returns ({name: (key, arguments)}, undo)."""
    import importlib

    calls, seen, undo = {}, set(), []
    for key in keys:
        mod_name, attr = WRAPPERS[key]
        owner = importlib.import_module(mod_name)
        orig = getattr(owner, attr)

        def recording(*args, _key=key, _orig=orig):
            sig = (_key, call_shape(_key, args, not (per_width or _key in "EFI")))
            name = f"{path}:{call_shape(_key, args)}"
            if _key == "H":  # every build: its chunks are its shapes
                sig = (_key, len(calls))
                name += f"#{sum(k == 'H' for k, _ in calls.values())}"
            if sig not in seen:
                seen.add(sig)
                calls[name] = (_key, tuple(
                    a.clone() if torch.is_tensor(a) and not (_key == "H" and i == 0) else a
                    for i, a in enumerate(args)))
            return _orig(*args)

        setattr(owner, attr, recording)
        undo.append((owner, attr, orig))

    def restore():
        for owner, attr, orig in undo:
            setattr(owner, attr, orig)

    return calls, restore


def replay_rows(torch, calls, dev):
    """Each recorded call (:func:`record_calls`) once more on the card,
    against its plain version on the same arguments (directions and scores
    equal, tolerance 0), with CUDA-event times and the bound: the kernels
    at the shapes a path launched them.  Kernel B's calls go through
    :func:`pair_rows`, kernels E and F's through :func:`walk_rows`, kernels
    G, H and I's (both forms) through :func:`scan_rows`."""
    from sarlacc_tpu_torch.ops.align import dp_align, dp_scores, dp_scores_segments
    from sarlacc_tpu_torch.ops.cuda_align import (
        dir_kernel, dir_kernel_resources, dir_plan, score_kernel, score_kernel_resources,
        score_tile, segments_kernel,
    )

    res = {**dir_kernel_resources(), **score_kernel_resources()}
    rows_out, pairs, walks, scans = [], {}, {}, {}
    for name, (key, args) in calls.items():
        args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
        if key == "B":
            pairs[name] = args
            continue
        if key in "EF":
            walks[name] = (key, args)
            continue
        if key in "GSHIT":
            scans[name] = (key, args)
            continue
        if key == "A":
            modes, mask, *_, codes_k, local = args
            l1, n_pad = codes_k.shape
            S_k, D_k = dir_kernel(*args)
            (S_p, D_p), plain_ms = timed_once(torch, lambda: dp_align(*args))
            err = compare(torch, f"kernel A ({name})", D_k, D_p, S_k, S_p)
            ms = event_ms(lambda: dir_kernel(*args), 5, dev)
            cells = int(modes.shape[0]) * l1 * n_pad  # every row of every lane
            bms, by = bound(score_bytes(modes, mask, l1 * n_pad, S_k, D_k),
                            cells * OPS_PER_CELL["A"])
            tj, G, passes = dir_plan(int(modes.shape[0]), bool(local), n_pad)
            extra = dict(tile=tj, lanes=G, passes=passes)
            detail = f"dirs equal; tile {tj}, {G} lanes a read, {passes} pass(es)"
            del S_k, D_k, S_p, D_p
        elif key == "C":
            modes, mask, go, ge, costm, costmm, codes_k, lengths, local = args
            n = int(lengths.shape[0])
            idx = lengths.to(torch.int64)[None, :]
            want, plain_ms = timed_once(torch, lambda: dp_scores(
                modes, mask, go, ge, costm, costmm, codes_k, local)[:, :n].gather(0, idx)[0])
            err = equal_scores(torch, f"kernel C ({name})", score_kernel(*args), want)
            ms = event_ms(lambda: score_kernel(*args), 5, dev)
            rws = float((lengths.double() + 1).sum())
            cells = rws * int(modes.shape[0])
            bms, by = bound(score_bytes(modes, mask, rws, lengths) + 4 * n,
                            cells * OPS_PER_CELL["C"])
            tj = score_tile([(0, int(modes.shape[0]), bool(local))])
            extra, detail = dict(tile=tj), f"scores equal; tile {tj}"
        else:
            modes, mask, segs, *_, lens_k = args
            want, plain_ms = timed_once(torch, lambda: dp_scores_segments(*args))
            err = equal_scores(torch, f"kernel D ({name})", segments_kernel(*args), want)
            ms = event_ms(lambda: segments_kernel(*args), 5, dev)
            rws = float((lens_k.double() + 1).sum())
            cells = rws * sum(r for _, r, *_ in segs)
            bms, by = bound(score_bytes(modes, mask, rws, lens_k) + 4 * len(segs) * lens_k.numel(),
                            cells * OPS_PER_CELL["D"])
            tj = score_tile(segs)
            extra, detail = dict(tile=tj), f"scores equal; tile {tj}"
        r = res[f"{key}@{tj}"]
        log(f"[kernels] {key} {name}: {detail}, max|dS|={err}, kernel {ms:.3f} ms = "
            f"{cells / ms / 1e6:.1f} GCUPS, plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}, "
            f"{100 * bms / ms:.1f}%); {r['registers']} registers, {r['spill_bytes']} B spilled")
        rows_out.append(dict(key=key, name=name, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, gcups=cells / ms / 1e6, registers=r["registers"],
                             spill_bytes=r["spill_bytes"], **extra))
    return (rows_out + (pair_rows(torch, pairs, dev) if pairs else [])
            + (walk_rows(torch, walks, dev) if walks else [])
            + (scan_rows(torch, scans, dev) if scans else []))


def pair_rows(torch, cases, dev):
    """Kernel B at each ``name -> banded_pair arguments`` against its plain
    version (run once a shape), on its own route, and the block route at the
    same shape (the previous design, kept for bands over 512) against it."""
    from sarlacc_tpu_torch.ops.cuda_msa import (
        _launch_pair, banded_pair_plain, pair_kernel, pair_kernel_resources, pair_route,
    )

    res = pair_kernel_resources(sorted({a[-1] for a in cases.values()}))
    out = []
    for name, bargs in cases.items():
        P, rows, W = int(bargs[0].shape[0]), bargs[-2], bargs[-1]
        route = pair_route(W)
        sk, dk = pair_kernel(*bargs)
        (sp, dp), plain_ms = timed_once(torch, lambda: banded_pair_plain(*bargs))
        err = compare(torch, f"kernel B ({name})", dk, dp, sk, sp)
        del sp, dp
        ms = event_ms(lambda: pair_kernel(*bargs), 5, dev)
        block_ms = None
        if route == "warp":
            s_b, d_b = _launch_pair(*bargs, route="block")
            compare(torch, f"kernel B block route ({name})", d_b, dk, s_b, sk)
            del s_b, d_b
            block_ms = event_ms(lambda: _launch_pair(*bargs, route="block"), 5, dev)
        cells = P * rows * W
        bms, by = bound(nbytes(*bargs[:6], sk, dk), cells * OPS_PER_CELL["B"])
        r = res[f"B:{route}@{W}"]
        extra = dict(block_ms=block_ms) if route == "warp" else {}
        what = f"{route} route"
        if route == "wide":
            extra = dict(cluster=r["cluster"], active_clusters=r["active_clusters"],
                         shared_bytes=r["shared_bytes"])
            what += (f", clusters of {r['cluster']} blocks of {r['threads']} threads, "
                     f"{r['active_clusters']} resident at once")
        log(f"[kernels] B {name}: P={P} rows={rows} W={W}: dirs equal, max|dscore|={err}, "
            f"kernel {ms:.3f} ms = {cells / ms / 1e6:.1f} GCUPS ({what}"
            + (f"; block route {block_ms:.3f} ms" if block_ms is not None else "")
            + f"), plain {plain_ms:.3f} ms, bound {bms:.3f} ms ({by}, {100 * bms / ms:.2f}%); "
            f"{r['registers']} registers, {r['spill_bytes']} B spilled, {r['shared_bytes']} B "
            f"shared, {r['blocks_per_sm']} blocks of {r['threads']} an SM")
        out.append(dict(key="B", name=name, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                        bound_by=by, gcups=cells / ms / 1e6, route=route, share=bms / ms,
                        registers=r["registers"], spill_bytes=r["spill_bytes"], **extra))
        del sk, dk
    return out


#: Band cells of one run of kernel E's plain replay at most (8 GiB of
#: float32 cost plane, the pipeline's largest wave whole): a call past it
#: (the long-read waves) is replayed a run of merges at a time, each run's
#: entries a slice of the call's (sorted by merge, then row).
E_PLAIN_CELLS = 1 << 31


def merge_entries_plain_runs(torch, args, q):
    """Kernel E's plain version on the call ``args`` (``merge_dp_walk``'s
    arguments), ``q`` merges at a time: merges are independent columns, so
    each run takes its slice of the bands and its entries with the row
    pointers rebased.  Returns jmat int32 [rows, Pp]."""
    from sarlacc_tpu_torch.ops.msa import _merge_entries_plain

    cols, w, rowptr, la, lb, lo, kmax, rows, W = args
    runs = []
    for m0 in range(0, la.shape[0], q):
        m1 = min(m0 + q, la.shape[0])
        ptr = rowptr[m0 * rows : m1 * rows + 1]
        base = int(ptr[0])
        runs.append(_merge_entries_plain(cols[base:], w[base:], ptr - base, la[m0:m1],
                                         lb[m0:m1], lo[m0:m1], kmax[m0:m1], rows, W))
    return torch.cat(runs, dim=1)


def walk_rows(torch, cases, dev):
    """Kernels E and F at each recorded ``name -> (key, arguments)`` call
    against their plain versions (run once a shape; jmat and identities
    bit-equal, tolerance 0; E's is ``_merge_entries_plain``: the blank cost
    planes, the entries added in order, the plain DP and walk, on runs of
    merges of at most :data:`E_PLAIN_CELLS` band cells, against the
    kernel's jmat), with
    CUDA-event times, the bound and the longest chain of dependent row
    steps: for E the DP's live rows then the walk's, for F the rows one
    pair walks."""
    from sarlacc_tpu_torch.ops import cuda_walk
    from sarlacc_tpu_torch.ops.msa import _pair_ident_kernel, _pair_walk_kernel

    widths = sorted({int(a[8]) for k, a in cases.values() if k == "E"})
    res = cuda_walk.walk_kernel_resources(widths or (256,))
    out = []
    for name, (key, args) in cases.items():
        if key == "E":
            _, _, rowptr, la, lb, lo, kmax, rows, W = args
            Pp = la.shape[0]
            jm = cuda_walk.merge_dp_walk(*args)
            q = max(1, E_PLAIN_CELLS // (rows * W))
            want, plain_ms = timed_once(torch, lambda: merge_entries_plain_runs(torch, args, q))
            torch.cuda.synchronize()
            if not torch.equal(jm, want):
                raise AssertionError(f"kernel E ({name}): jmat differs from the plain version in "
                                     f"{int((jm != want).sum())} cells")
            err = float((jm - want).abs().max())
            ms = event_ms(lambda: cuda_walk.merge_dp_walk(*args), 5, dev)
            top = la.clamp(0, rows).to(torch.int64)
            live = int(top.sum()) * W  # the cells of the rows the DP computes
            kept = int(rowptr[-1])
            # Each kept entry's cell and weight once (4 + 4 bytes), the row
            # pointers, the bands and jmat; one add an entry.
            bms, by = bound(8 * kept + nbytes(rowptr, la, lb, lo, kmax, jm),
                            live * OPS_PER_CELL["E"] + kept)
            chain = 2 * int(top.max())
            route = cuda_walk.merge_route(W)
            r = res[f"E:{route}@{W}"]
            detail = (f"Pp={Pp} rows={rows} W={W} ({route} route), {live} live cells, {kept} "
                      f"entries: jmat equal (plain in {-(-Pp // q)} runs of at most {q} "
                      f"merges), kernel {ms:.3f} ms = {live / ms / 1e6:.1f} GCUPS")
            extra = dict(merge_route=route, gcups=live / ms / 1e6, entries=kept)
        else:
            dirs, la, lb, lo, ca, cb = args
            rows, P, W = dirs.shape
            jm, ident = cuda_walk.pair_walk(*args)

            def plain():
                j = _pair_walk_kernel(dirs, la, lb, lo)
                return j, _pair_ident_kernel(j, ca, cb)

            (jp, ip), plain_ms = timed_once(torch, plain)
            if not (torch.equal(jm, jp) and torch.equal(ident, ip)):
                raise AssertionError(f"kernel F ({name}): jmat or identities differ from the "
                                     f"plain version ({int((jm != jp).sum())} jmat cells)")
            err = float((ident - ip).abs().max()) if P else 0.0
            ms = event_ms(lambda: cuda_walk.pair_walk(*args), 5, dev)
            matched = jm > 0
            at = torch.arange(1, rows + 1, device=jm.device)[:, None]
            lowest = torch.where(matched, at, rows + 1).amin(0)
            walked = (la.clamp(0, rows).to(torch.int64) - lowest + 1).clamp(min=0)
            # The path's cells, each direction byte once: from (la, lb) to
            # the lowest match (low_r, low_c), the rows and columns it spans
            # less one for each diagonal step, which takes a row and a
            # column at once.
            low_c = jm.gather(0, (lowest - 1).clamp(0, rows - 1)[None].to(torch.int64))[0]
            spans = walked + torch.where(walked > 0, lb.to(torch.int64) - low_c + 1, 0)
            path = int((spans - torch.where(walked > 0, matched.sum(0), 0)).sum())
            # The path's direction bytes, both codes of each match, jmat and
            # the identities once.
            n_bytes = (dirs.element_size() * path + 2 * int(matched.sum())
                       + nbytes(la, lb, lo, jm, ident))
            bms, by = bound(n_bytes, 0)
            chain = int(walked.max()) if P else 0
            r = res["F"]
            detail = (f"P={P} rows={rows} W={W}, {int(walked.sum())} walked rows, {path} path "
                      f"cells: jmat and identities equal, kernel {ms:.3f} ms")
            extra = dict(path_cells=path)
        log(f"[kernels] {key} {name}: {detail}, plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}, "
            f"{100 * bms / ms:.2f}%), chain of {chain} dependent row steps; {r['registers']} "
            f"registers, {r['spill_bytes']} B spilled, {r['blocks_per_sm']} blocks of "
            f"{r['threads']} an SM")
        out.append(dict(key=key, name=name, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                        bound_by=by, chain_rows=chain, registers=r["registers"],
                        spill_bytes=r["spill_bytes"], **extra))
    return out


def h_bytes(torch, args, table, off):
    """Kernel H's compulsory bytes on one library build: each distinct
    arena entry its gathers read once (every first-hop row to the widest
    ``strc`` it is read at; every distinct second-hop (row, position) cell
    where the first hop found a position), the per-job table (16 bytes a
    job), the order and identities (4 bytes a job each), the group table,
    12 bytes a kept entry and 8 an offset written.  The slot tables are
    built by the plain version's ``_slot_tables`` for the count only."""
    from sarlacc_tpu_torch.ops.msa import _slot_tables

    arena, jobs, first_job, fracs, order, chunks, _ = args
    dev = arena.device
    STR = arena.shape[1]
    jobs_t = torch.as_tensor(jobs, dtype=torch.int64, device=dev)
    first_t = torch.as_tensor(first_job, dtype=torch.int64, device=dev)
    order_t = torch.as_tensor(order, dtype=torch.int64, device=dev)
    widest = torch.zeros(arena.shape[0], dtype=torch.int64, device=dev)
    hops = []
    for q0, q1, sl, strc in chunks:
        xz, zy, _ = _slot_tables(jobs_t, first_t, fracs, order_t[q0:q1], sl)
        widest.scatter_reduce_(0, xz.reshape(-1), torch.full_like(xz.reshape(-1), strc), "amax")
        k = arena[:, :strc][xz].to(torch.int64)
        hops.append(torch.unique((zy[:, :, None] * STR + k)[k > 0]))
        del xz, zy, k
    widest[0] = 0  # dead slots' zero row: never gathered
    n_hops = int(torch.unique(torch.cat(hops)).numel()) if hops else 0
    n_bytes = (2 * (int(widest.sum()) + n_hops) + 24 * int(jobs.shape[0])
               + 4 * int(first_job.shape[0]) + 12 * int(table.shape[0]) + 8 * int(off.shape[0]))
    return n_bytes, int((widest > 0).sum()), n_hops


def scan_rows(torch, cases, dev):
    """Kernels G, H and I (both forms) at each recorded ``name -> (key,
    arguments)`` call against their plain versions (run once a shape, after
    one untimed run a kernel at its first shape; tolerance 0: G's maps or
    emissions, H's library entries and pair offsets, I's distances, its
    thresholded form's hit pairs in order), with CUDA-event times (G's over
    20 launches queued behind a sleep on the card, since a walk is shorter
    than its wrapper's host time) and the bound.  Bytes: G the 2-byte
    direction cell of each fetching step (counted by the kernel, and held
    equal to the plain walk's count, in all and by kind; each is a distinct
    entry of the plane) plus the lengths and outputs; H :func:`h_bytes` (a
    whole library build: every chunk's counting pass, the scan and every writing pass, timed queued
    back to back, the uploads and the readback outside the events; the
    whole build is timed beside it); I its inputs and output once; I's
    thresholded form the codes and lengths once and 8 bytes a hit.
    Operations: I six integer operations a DP cell (the cells to each
    pair's lengths) over the float32 rate; its thresholded form six a DP
    cell it counts (``cells=``: each pair's band cells inside the matrix,
    to its exit).  A bound above the measured time means a count is wrong
    and fails the run."""
    from sarlacc_tpu_torch.ops import backtrack, cuda_backtrack, cuda_extend, cuda_lev2
    from sarlacc_tpu_torch.ops.levenshtein import _lev2_scan, _rowblock_hits_plain
    from sarlacc_tpu_torch.ops.msa import _extend_library_plain
    from sarlacc_tpu_torch.tools.timing import queued_ms

    res = {**cuda_backtrack.backtrack_kernel_resources(), **cuda_extend.extend_kernel_resources(),
           **cuda_lev2.lev2_kernel_resources()}
    out, warmed = [], set()
    for name, (key, args) in cases.items():
        if key not in warmed:  # a kernel's first plain run also loads PyTorch's kernels
            warmed.add(key)
            if key == "H":
                _extend_library_plain(*args)
            elif key == "I":
                _lev2_scan(args[0][:, None, :], args[1][:, None], args[2][None], args[3][None])
            elif key == "T":
                _rowblock_hits_plain(*args)
            else:
                (backtrack._qmap_walk_plain if key == "G" else backtrack._string_walk_plain)(*args)
        if key in "GS":
            dirs, lengths = args
            kern = cuda_backtrack.qmap_walk if key == "G" else cuda_backtrack.string_walk
            plain = backtrack._qmap_walk_plain if key == "G" else backtrack._string_walk_plain
            counters = torch.zeros(len(cuda_backtrack.COUNTS), dtype=torch.int64, device=dev)
            got = kern(dirs, lengths, fetches=counters)
            want, plain_ms = timed_once(torch, lambda: plain(dirs, lengths))
            counted = {}
            plain(dirs, lengths, counts=counted)
            what = "maps" if key == "G" else "emissions"
            rname = "G:qmap" if key == "G" else "G:string"
            kc = dict(zip(cuda_backtrack.COUNTS, counters.tolist()))
            if {k: kc[k] for k in counted} != counted:
                raise AssertionError(f"kernel {key} ({name}): fetching steps {kc} differ from "
                                     f"the plain walk's {counted}")
            n_fetch = kc["fetches"]
            R, l1, n_pad = dirs.shape
            kinds = ", ".join(f"{k} {kc[k]}" for k in cuda_backtrack.COUNTS[2:])
            detail = (f"R={R} l1={l1} n_pad={n_pad}, {n_fetch} fetching steps ({kinds}; equal "
                      f"to the plain walk's), {kc['rounds']} round trips on the longest lane")
            extra = dict(kc)
            if key == "S":
                steps = int(got[2].to(torch.int64).sum())
                detail += f", {steps} steps"
                extra["steps"] = steps
            extra.update(shared_bytes=res[rname]["shared_bytes"],
                         blocks_per_sm=res[rname]["blocks_per_sm"])
            n_bytes = 2 * n_fetch + nbytes(lengths, *got)
            ops = 0
            run = lambda: kern(dirs, lengths)  # noqa: E731
        elif key == "H":
            table_k, off_k = cuda_extend.extend_library(*args)
            (table_p, off_p), plain_ms = timed_once(torch, lambda: _extend_library_plain(*args))
            got = (table_k, torch.as_tensor(off_k))
            want = (table_p, torch.as_tensor(off_p))
            what, rname = "entries and pair offsets", "H:write"
            chunks = args[5]
            n_bytes, first_rows, hops = h_bytes(torch, args, table_k, off_k)
            ops = 0
            kept = int(table_k.shape[0])
            classes = sorted({(c[2], c[3]) for c in chunks})
            detail = (f"{int(args[4].shape[0])} pairs in {len(chunks)} chunks of {len(classes)} "
                      f"(SL, strc) classes {classes[0]}-{classes[-1]}, {first_rows} distinct "
                      f"first-hop rows, {hops} distinct second-hop cells, {kept} entries")
            # The row's time is the queued passes alone (tables uploaded and
            # offsets read back outside the events); the whole build, with its
            # uploads, host checks and readback, is timed beside it.
            build_ms = event_ms(lambda: cuda_extend.extend_library(*args), 5, dev)
            build = cuda_extend.ExtendBuild(*args)
            queued = torch.empty_like(table_k)

            def run():
                build.count()
                build.write(off_k, queued)

            run()
            torch.cuda.synchronize()
            if not torch.equal(queued, table_k) or not torch.equal(build.off.cpu(), got[1]):
                raise AssertionError(f"kernel H ({name}): the queued passes differ from the build")
            detail += f"; the whole build {build_ms:.3f} ms"
            extra = dict(entries=kept, pairs=int(args[4].shape[0]), chunks=len(chunks),
                         first_rows=first_rows, second_cells=hops, build_ms=build_ms)
        elif key == "I":
            a, la, b, lb = args
            got = (cuda_lev2.lev2_cross(a, la, b, lb),)
            want, plain_ms = timed_once(torch, lambda: (_lev2_scan(
                a[:, None, :], la[:, None], b[None], lb[None]),))
            what = "distances"
            L = int(a.shape[1])
            rname = f"I:{cuda_lev2.lev2_route(L)}"
            live = (lb > 0) & (lb <= L)
            cells = int(la.to(torch.int64).clamp(0, L).sum()) * int(
                torch.where(live, lb, 0).to(torch.int64).sum())
            n_bytes = nbytes(a, la, b, lb, got[0])
            ops = OPS_PER_CELL["I"] * cells
            detail = f"TI={a.shape[0]} TJ={b.shape[0]} L={L} ({rname[2:]} route), {cells} cells"
            extra = dict(cells=cells, lev2_route=rname[2:])
            run = lambda: cuda_lev2.lev2_cross(a, la, b, lb)  # noqa: E731
        else:  # kernel I's thresholded form: one row-block scan
            codes, lens, s_len, thr, limit, tile = args
            n, W = codes.shape
            cells_t = torch.zeros(1, dtype=torch.int64, device=dev)
            before = cuda_lev2.HITS_KERNEL.launches
            got = (cuda_lev2.lev2_hits(*args, cells=cells_t),)
            launched = cuda_lev2.HITS_KERNEL.launches - before
            want, plain_ms = timed_once(torch, lambda: (_rowblock_hits_plain(*args),))
            # A buffer of one key: the count overflows, and the one re-run
            # at the exact count gives the same hits.
            before = cuda_lev2.HITS_KERNEL.launches
            again = cuda_lev2.lev2_hits(*args, cap=1)
            reruns = cuda_lev2.HITS_KERNEL.launches - before
            torch.cuda.synchronize()
            if launched != 1 or reruns != 1 + (got[0].numel() > 1) or not torch.equal(again, got[0]):
                raise AssertionError(f"kernel I thresholded ({name}): {launched} launches, "
                                     f"{reruns} with an overflowing buffer, hits equal "
                                     f"{torch.equal(again, got[0])}")
            what = "hit pairs (in order)"
            route = cuda_lev2.hits_route(W, thr)
            rname = f"I:{route}"
            cells = int(cells_t)
            hits = int(got[0].numel())
            n_bytes = nbytes(codes, lens) + 8 * hits
            ops = OPS_PER_CELL["I"] * cells
            jobs = cuda_lev2.rowblock_jobs(s_len, limit, tile)
            detail = (f"n={n} W={W} thr={thr} tile={tile} ({route} route, {jobs.shape[0]} jobs), "
                      f"{cells} DP cells, {hits} hits; an overflowing buffer re-ran once")
            extra = dict(cells=cells, hits=hits, lev2_route=route)
            run = lambda: cuda_lev2.lev2_hits(*args)  # noqa: E731
        torch.cuda.synchronize()
        if not all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"kernel {key} ({name}): {what} differ from the plain version")
        err = max((float((x.double() - y.double()).abs().max()) for x, y in zip(got, want)
                   if x.numel()), default=0.0)
        if key in "GS":  # shorter than its wrapper's host time: queued behind a sleep
            ms = queued_ms(run, 20, dev)
        else:
            ms = event_ms(run, 5, dev)
        bms, by = bound(n_bytes, ops)
        if bms > ms:
            raise AssertionError(f"kernel {key} ({name}): bound {bms:.4f} ms above the measured "
                                 f"{ms:.4f} ms: a byte or cell count is wrong")
        r = res[rname]
        log(f"[kernels] {key} {name}: {detail}: {what} equal, kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}, {100 * bms / ms:.2f}%); "
            f"{r['registers']} registers, {r['spill_bytes']} B spilled, {r['blocks_per_sm']} "
            f"blocks of {r['threads']} an SM")
        out.append(dict(key=key, name=name, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                        bound_by=by, registers=r["registers"], spill_bytes=r["spill_bytes"],
                        **extra))
        del got, want
    return out


def random_reads(n, length, seed):
    """bench.py::_random_reads, as a port SeqBatch."""
    import numpy as np

    from sarlacc_tpu_torch.core.encode import SeqBatch

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, length)).astype(np.int8)
    lengths = np.full(n, length, dtype=np.int64)
    quals = rng.integers(20, 60, (n, length)).astype(np.uint8) + 33
    return SeqBatch(codes, lengths, quals, None)


def demux_inputs(n_reads=100_000, tolerance=250, n_barcodes=12, bc_len=12, seed=3):
    """bench.py::bench_demux's inputs: two 250-bp end batches, 12 barcodes
    and 100 000 observed barcode reads, all from numpy seed 3."""
    import numpy as np

    rng = np.random.default_rng(seed + 2)
    barcodes = ["".join(rng.choice(list("ACGT"), bc_len)) for _ in range(n_barcodes)]
    return {
        "front": random_reads(n_reads, tolerance, seed),
        "back": random_reads(n_reads, tolerance, seed + 1),
        "barcodes": barcodes,
        "observed": random_reads(n_reads, bc_len, seed + 3),
    }


#: tune_alignment's default grid (gap_op_range (4, 10) x gap_ext_range (1, 5)).
TUNE_GRID = [(go, ge) for go in range(4, 11) for ge in range(1, 6)]
#: R = 150, every IUPAC class: a global segment that crosses column tiles.
LONG_REF = ("ACGTRYKMSWBDHVN" * 10)[:150]


def phase_score_kernels(torch, st, demux, bench, dev):
    """Kernels C and D against their plain versions at the demux shapes, at
    calibration's (the 19 926 stacked 250-bp ends of the bench batch: kernel
    C as get_adaptor_thresholds runs it, kernel D over tune_alignment's 35
    points for each adaptor) and with a multi-tile global segment."""
    import numpy as np

    from sarlacc_tpu_torch.api.align_internal import prepare_adaptor, prepare_scores_input
    from sarlacc_tpu_torch.core.encode import SeqBatch
    from sarlacc_tpu_torch.ops.align import dp_scores, dp_scores_segments
    from sarlacc_tpu_torch.ops.cuda_align import (
        _launch_score, _launch_segments, encode_mask, pack_segments, score_kernel,
        score_kernel_resources, score_tile, segments_kernel,
    )

    res = score_kernel_resources()
    for name, r in res.items():
        log(f"[kernels] {name}: {r['registers']} registers a thread, {r['shared_bytes']} B "
            f"shared a block, {r['spill_bytes']} B spilled, {r['blocks_per_sm']} blocks of "
            f"{r['threads']} an SM: occupancy {r['occupancy']:.4f}")
    rows_out = []

    def row(key, name, n, cells, kern, plain, stamped, n_bytes, tj, detail):
        err = equal_scores(torch, f"kernel {key} ({name})", kern(), plain())
        ms = event_ms(kern, 5, dev)
        plain_ms = event_ms(plain, 1, dev)
        stamps = stamped()
        torch.cuda.synchronize()
        occ = achieved_occupancy(torch, stamps)
        bms, by = bound(n_bytes, cells * OPS_PER_CELL[key])
        r = res[f"{key}@{tj}"]
        log(f"[kernels] {key} {name}: N={n} {detail}: scores equal, max|dS|={err}, kernel "
            f"{ms:.3f} ms = {cells / ms / 1e6:.1f} GCUPS, plain {plain_ms:.3f} ms, bound "
            f"{bms:.3f} ms ({by}, {100 * bms / ms:.1f}%); tile {tj}, {r['registers']} "
            f"registers, occupancy {r['occupancy']:.4f} theoretical, {occ:.4f} achieved")
        rows_out.append(dict(key=key, name=name, err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by, gcups=cells / ms / 1e6, tile=tj,
                             registers=r["registers"], spill_bytes=r["spill_bytes"],
                             achieved_occupancy=occ))

    def c_row(name, ad, prepared):  # fitting mode, as the entry points run it
        planes, lengths, N = prepared.planes(), prepared.lengths, prepared.n
        args = (ad.modes, encode_mask(ad.matched), 5.0, 1.0, *planes)
        idx = lengths.to(torch.int64)[None, :]
        nblk = -(-N // 128)

        def stamped():
            stamps = torch.zeros((nblk, 3), dtype=torch.int64, device=dev)
            _launch_score(*args, lengths, True, stamps=stamps)
            return stamps

        rows = float((lengths.double() + 1).sum())
        row("C", name, N, rows * len(ad), lambda: score_kernel(*args, lengths, True),
            lambda: dp_scores(*args, True)[:, :N].gather(0, idx)[0], stamped,
            score_bytes(*args[:2], rows, lengths) + 4 * N, score_tile([(0, len(ad), True)]),
            f"l1={planes[2].shape[0]} R={len(ad)} local")

    def d_row(name, prepared, segments):
        l1_, n_pad_ = prepared.plane_geometry()
        modes, mask, segs = pack_segments(segments, dev)
        lens_k = torch.zeros(n_pad_, dtype=torch.int32, device=dev)
        lens_k[: prepared.n] = prepared.lengths
        args = (modes, mask, segs, *prepared.planes(), lens_k)

        def stamped():
            stamps = torch.zeros((len(segs) * n_pad_ // 128, 3), dtype=torch.int64, device=dev)
            _launch_segments(*args, stamps=stamps)
            return stamps

        rows = float((lens_k.double() + 1).sum())
        rl = sorted({r for _, r, *_ in segs})
        row("D", name, prepared.n, rows * sum(r for _, r, *_ in segs),
            lambda: segments_kernel(*args), lambda: dp_scores_segments(*args), stamped,
            score_bytes(modes, mask, rows, lens_k) + 4 * len(segs) * n_pad_,
            score_tile(segs), f"l1={l1_} nseg={len(segs)} R in {rl} (padded lanes included)")

    a1 = prepare_adaptor(ADAPTOR1_BENCH, device=dev)
    a2 = prepare_adaptor(ADAPTOR2, device=dev)
    front = prepare_scores_input(a1, demux["front"])
    for name, ad in (("adaptor1", a1), ("adaptor2", a2)):
        c_row(name, ad, front)
    d_row("adaptors", front, [
        (a1.modes, a1.matched, 5.0, 1.0, True), (a2.modes, a2.matched, 5.0, 1.0, True),
    ])
    del front
    bcs = [prepare_adaptor(b, device=dev) for b in demux["barcodes"]]
    d_row("barcodes", prepare_scores_input(bcs[0], demux["observed"]),
          [(b.modes, b.matched, 5.0, 1.0, False) for b in bcs])
    # 24-bp barcodes take the 31-column tile (12- and 14-bp references the
    # 15-column one, adaptor1 the 63-column one).
    rng = np.random.default_rng(9)
    bcs = [prepare_adaptor("".join(rng.choice(list("ACGT"), 24)), device=dev) for _ in range(12)]
    d_row("barcodes24", prepare_scores_input(bcs[0], random_reads(100_000, 24, 10)),
          [(b.modes, b.matched, 5.0, 1.0, False) for b in bcs])

    # Calibration's shape: the stacked ends of the bench batch.
    stacked = prepare_scores_input(a1, SeqBatch.concat(list(bench.front_and_back(250))))
    c_row("adaptor1@calibration", a1, stacked)
    for name, ad in (("tune:adaptor1", a1), ("tune:adaptor2", a2)):
        d_row(name, stacked, [(ad.modes, ad.matched, go, ge, True) for go, ge in TUNE_GRID])
    long_ad, empty = prepare_adaptor(LONG_REF, device=dev), prepare_adaptor("", device=dev)
    d_row("multi-tile", stacked, [
        (long_ad.modes, long_ad.matched, 5.0, 1.0, False),
        (empty.modes, empty.matched, 5.0, 1.0, False),
        (a2.modes, a2.matched, 4.0, 2.0, True),
    ])
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
    return aligned, umis, groups, msa, cons, reads, filt


def reset(kernels) -> None:
    for k in kernels:
        k.launches = 0


def read_counts(kernels) -> dict:
    return {k.symbol: k.launches for k in kernels}


def phase_golden(torch, st, kernels, required, dev):
    """The golden pipeline on the card against its snapshot; kernels E and F
    are recorded one call a (rows, W), G, H and I one a launch shape, as it
    runs, and replayed against their plain versions after it.  Returns
    (launch counts, their rows)."""
    batch = mock_batch(
        st, ADAPTOR1_GOLDEN, nmolecules=10, nreads_range=(4, 9),
        seqlen_range=(350, 600), seed=20240817,
    )
    reset(kernels)
    recorded, unrecord = record_calls(torch, "golden", "EFGHI")
    try:
        aligned, umis, groups, msa, cons, _, _ = run_pipeline(
            torch, st, batch, ADAPTOR1_GOLDEN, dev)
    finally:
        unrecord()
    counts = read_counts(kernels)
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
    if min(counts[k.symbol] for k in required) == 0:
        raise AssertionError(f"a kernel never launched in the golden run: {counts}")
    log(f"[golden] {len(want)} keys equal tests/golden/pipeline_mock.json "
        f"({len(batch)} reads, {len(cons)} consensus reads); launches {counts}; kernel E, "
        f"F, G, H and I shapes {sorted(recorded)}")
    return counts, replay_rows(torch, recorded, dev)


#: Steps timed in the warm-up pass and in the host-route pass, (module,
#: name): the plain-PyTorch device steps (for a merge wave the entry decode,
#: sort and row pointers, ``_merge_entries``), the kernels' wrappers (E and
#: F's where ``ops/msa.py`` reaches them), the two library routes and their
#: steps, and the host-side work of the MSA stage.  The triplet extension
#: runs in a thread pool, so its total is summed over threads and can
#: exceed its share of the wall clock.
STEPS = (
    ("sarlacc_tpu_torch.api.align_internal", "qmap_walk"),
    ("sarlacc_tpu_torch.api.umi", "lev2_matrix"),
    ("sarlacc_tpu_torch.api.msa", "_build_library_device"),
    ("sarlacc_tpu_torch.api.msa", "_build_library_host"),
    ("sarlacc_tpu_torch.api.msa", "pair_maps_device"),
    ("sarlacc_tpu_torch.ops.msa", "_arena_place_kernel"),
    ("sarlacc_tpu_torch.api.msa", "_extend_library"),
    ("sarlacc_tpu_torch.ops.cuda_walk", "pair_walk"),
    ("sarlacc_tpu_torch.ops.msa", "_merge_entries"),
    ("sarlacc_tpu_torch.ops.cuda_walk", "merge_dp_walk"),
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


#: Steps timed in the calibration warm-up pass: the kernels' wrappers as
#: each entry point calls them, the plane builds and uploads, the walks and
#: the host statistics.
CAL_STEPS = (
    ("sarlacc_tpu_torch.api.tune", "scramble_input"),
    ("sarlacc_tpu_torch.api.tune", "fit_scores_segments"),
    ("sarlacc_tpu_torch.api.tune", "resolve_strand"),
    ("sarlacc_tpu_torch.api.tune", "tied_overlap"),
    ("sarlacc_tpu_torch.api.align_internal", "prepare_reads"),
    ("sarlacc_tpu_torch.api.align_internal", "PreparedReads.planes"),
    ("sarlacc_tpu_torch.api.align_internal", "fit_scores_from_planes"),
    ("sarlacc_tpu_torch.api.align_internal", "fit_dirs"),
    ("sarlacc_tpu_torch.api.align_internal", "qmap_walk"),
    ("sarlacc_tpu_torch.api.quality_align", "fit_dirs"),
    ("sarlacc_tpu_torch.api.quality_align", "string_walk"),
    ("sarlacc_tpu_torch.api.quality_align", "assemble_strings"),
)

#: Steps timed in the demux warm-up pass.
DEMUX_STEPS = (
    ("sarlacc_tpu_torch.ops.cuda_align", "fit_scores_segments"),
    ("sarlacc_tpu_torch.api.barcode", "fit_scores_segments"),
    ("sarlacc_tpu_torch.api.barcode", "prepare_scores_input"),
    ("sarlacc_tpu_torch.api.align_internal", "PreparedReads.planes"),
)


def timed_steps(torch, steps=STEPS, qualify=False):
    """Wrap each step with synchronized wall timers; returns (totals, undo).

    Totals are keyed by the step's name, or by ``module.name`` when
    ``qualify`` (two modules may import one function under one name).
    """
    import importlib

    totals: dict[str, list] = {}
    undo = []
    for mod_name, attr in steps:
        owner = importlib.import_module(mod_name)
        *path, name = attr.split(".")
        for part in path:
            owner = getattr(owner, part)
        orig = getattr(owner, name)
        key = f"{mod_name.rsplit('.', 1)[1]}.{attr}" if qualify else attr
        totals[key] = [0.0, 0]

        def wrapped(*a, _orig=orig, _acc=totals[key], **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(*a, **kw)
            torch.cuda.synchronize()
            _acc[0] += time.perf_counter() - t0
            _acc[1] += 1
            return out

        setattr(owner, name, wrapped)
        undo.append((owner, name, orig))

    def restore():
        for owner, name, orig in undo:
            setattr(owner, name, orig)

    return totals, restore


#: torch.Tensor methods that copy a tensor's values to the host.
READBACK_METHODS = ("cpu", "item", "tolist", "__int__", "__float__", "__bool__", "__index__",
                    "to")


def count_readbacks(torch, steps):
    """Wrap each step (module, name) so that each call records its host
    readbacks: a CUDA tensor's values brought to the host by one of
    :data:`READBACK_METHODS`, which are patched only while a wrapped call
    runs (nothing else, a step timer neither, runs patched).  Returns
    ({name: [readbacks a call]}, undo)."""
    import importlib

    calls: dict[str, list] = {}
    active = []  # the counters of the calls in progress
    originals = {meth: getattr(torch.Tensor, meth) for meth in READBACK_METHODS}

    def counted(meth):
        orig = originals[meth]

        def method(self, *a, **kw):
            out = orig(self, *a, **kw)
            if self.is_cuda and not (torch.is_tensor(out) and out.is_cuda):
                active[-1] += 1
            return out

        return method

    patched = {meth: counted(meth) for meth in READBACK_METHODS}
    undo = []
    for mod_name, attr in steps:
        owner = importlib.import_module(mod_name)
        orig = getattr(owner, attr)
        calls[attr] = []

        def wrapped(*a, _orig=orig, _calls=calls[attr], **kw):
            if not active:
                for meth, fn in patched.items():
                    setattr(torch.Tensor, meth, fn)
            active.append(0)
            try:
                return _orig(*a, **kw)
            finally:
                _calls.append(active.pop())
                if not active:
                    for meth, fn in originals.items():
                        setattr(torch.Tensor, meth, fn)

        setattr(owner, attr, wrapped)
        undo.append((owner, attr, orig))

    def restore():
        for owner, name, orig in reversed(undo):
            setattr(owner, name, orig)

    return calls, restore


def step_report(totals) -> str:
    return ", ".join(
        f"{k} {v[0]:.3f} s/{v[1]} calls"
        for k, v in sorted(totals.items(), key=lambda kv: -kv[1][0])
    )


def record_waves(torch, keep=False, path="pipeline"):
    """Wrap ``api/msa.py``'s ``merge_wave_from_library``: each wave's peak
    allocated memory (the peak counter reset before it), and with ``keep``
    a host copy of every wave, its library cut down to the entries the wave
    reads (for ``tools/kernel_turns.py``), named ``path:E:PxRxW``.  Returns
    (stats, {name: (lib, descs, rows, W)}, undo)."""
    import numpy as np

    from sarlacc_tpu_torch.api import msa as api_msa

    orig = api_msa.merge_wave_from_library
    stats = {"waves": 0, "peak": 0, "above": 0, "largest": None}
    kept = {}

    def recording(lib, descs, rows, W):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = orig(lib, descs, rows, W)
        peak = torch.cuda.max_memory_allocated()
        P = len(descs)
        stats["waves"] += 1
        stats["peak"] = max(stats["peak"], peak)
        stats["above"] = max(stats["above"], peak - base)
        if stats["largest"] is None or P * rows * W > np.prod(stats["largest"]):
            stats["largest"] = (P, rows, W)
        if keep:
            tab, w_inv = lib
            parts, cut, at = [], [], 0
            for d in descs:
                segs = []
                for (start, length, aoff, boff, swap) in d["segments"]:
                    parts.append(tab[start : start + length].cpu())
                    segs.append((at, length, aoff, boff, swap))
                    at += length
                cut.append({**d, "segments": segs})
            kept[f"{path}:E:P{P}xR{rows}xW{W}"] = ((torch.cat(parts), w_inv), cut, rows, W)
        return out

    api_msa.merge_wave_from_library = recording

    def restore():
        api_msa.merge_wave_from_library = orig

    return stats, kept, restore


def phase_pipeline(torch, st, batch, kernels, required, dev, keep_waves=False):
    """The warm-up pass (step timers and the stage profiler; it also records
    the arguments of each distinct kernel-B launch shape, one call of
    kernels E and F for each (rows, W) and of kernels G and H for each
    launch shape, which but B's are replayed against their plain versions
    right after it and dropped), the timed pass (the
    default, device-library route), then ``multi_read_align`` once more on
    the timed pass's reads and groups with ``SARLACC_HOST_LIB=1``, timed,
    then again with the step timers.  The warm-up pass also gives the merge
    waves' peak allocated memory (:func:`record_waves`).  Returns (launch
    counts, the aligned frame, the timed pass's stage seconds, {shape:
    banded_pair arguments}, realized reads, groups, kernel E-H's rows,
    the kept merge waves)."""
    from sarlacc_tpu_torch.utils import PipelineProfiler, get_profiler, set_profiler

    set_profiler(PipelineProfiler())
    # The recording wraps the step timers: E and F's steps hold no copy.
    totals, restore = timed_steps(torch)
    recorded, unrecord = record_calls(torch, "pipeline", "BEFGHI")
    wstats, waves, unwave = record_waves(torch, keep_waves)
    try:
        t0 = time.perf_counter()
        run_pipeline(torch, st, batch, ADAPTOR1_BENCH, dev)
        warm_s = time.perf_counter() - t0
    finally:
        unwave()
        unrecord()
        restore()
    P, rows, W = wstats["largest"]
    Pp = 16
    while Pp < P:
        Pp *= 2
    log(f"[pipeline] merge waves: {wstats['waves']} calls of merge_wave_from_library, peak "
        f"allocated {wstats['peak'] / 2**30:.2f} GiB ({wstats['above'] / 2**30:.2f} GiB above "
        f"what was live before the wave); the largest wave {P} merges (Pp {Pp}) x {rows} rows x "
        f"W {W}, whose float32 cost plane alone would be {4 * Pp * rows * W / 2**30:.2f} GiB")
    pair_calls = {name: args for name, (key, args) in recorded.items() if key == "B"}
    walk_calls = {name: call for name, call in recorded.items() if call[0] != "B"}
    del recorded
    log(f"[pipeline] warm-up pass {warm_s:.3f} s; synchronized step times: "
        f"{step_report(totals)}; kernel-B shapes {sorted(pair_calls)}; kernel E, F, G, H "
        f"and I shapes {sorted(walk_calls)}")
    lib_s, lib_n = totals["_build_library_device"]
    ext_s, ext_n = totals["_extend_library"]
    log(f"[pipeline] device library: _build_library_device {lib_s:.3f} s over {lib_n} builds "
        f"(synchronised), of it the extension (msa.triplet, _extend_library: kernel H) "
        f"{ext_s:.3f} s over {ext_n} calls")
    log("[pipeline] stage profiler after the warm-up pass:\n" + get_profiler().report())
    # E-I's copies (kernel F's are kernel B's direction tensors, H's keep the
    # library's arena) go before the timed pass, so they are not in its
    # peak memory.
    wrows = replay_rows(torch, walk_calls, dev)
    del walk_calls

    reset(kernels)
    torch.cuda.reset_peak_memory_stats()
    timings: list = []
    aligned, _, groups, msa, cons, reads, filt = run_pipeline(
        torch, st, batch, ADAPTOR1_BENCH, dev, timings)
    counts = read_counts(kernels)
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
    if min(counts[k.symbol] for k in required) == 0:
        raise AssertionError(f"a kernel never launched in the main path: {counts}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[pipeline] {len(batch)} reads, {len(groups)} UMI groups, {len(cons)} "
        f"consensus reads: {total:.3f} s = {len(batch) / total:.1f} reads/s; stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
        + f"; peak allocated {peak:.2f} GiB; launches {counts}")

    def host_route():
        os.environ["SARLACC_HOST_LIB"] = "1"
        try:
            return st.multi_read_align(reads, groups=filt, bandwidth=100, device=dev)
        finally:
            del os.environ["SARLACC_HOST_LIB"]

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = host_route()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    host_peak = torch.cuda.max_memory_allocated() / 2**30
    differ = sum(a != b for a, b in zip(host["alignments"], msa["alignments"]))
    log(f"[pipeline] multi_read_align on {len(filt)} groups: device-library route "
        f"{stages['multi_read_align']:.3f} s (peak allocated {peak:.2f} GiB over the pass), "
        f"SARLACC_HOST_LIB=1 route {host_s:.3f} s (peak allocated {host_peak:.2f} GiB); "
        f"{differ} groups' strings differ between the routes")
    totals, restore = timed_steps(torch)
    try:
        host_route()
    finally:
        restore()
    log(f"[pipeline] SARLACC_HOST_LIB=1 route with synchronized step times: "
        f"{step_report(totals)}")
    return counts, aligned, stages, pair_calls, reads, filt, wrows, waves


def phase_msa_library(torch, st, reads, filt, kernels, dev, n_slice=20):
    """Both libraries on the card for the first segment of the pipeline's
    groups (the same pairs, (a, b) entries and identities within 1e-6,
    weights within one quantum: the JAX package's own device-vs-host
    tolerances), then the device route on the card against ``device="cpu"``
    on the first ``n_slice`` groups of at most 10 reads, with the segment
    budget pinned on both (table, identities and strings bit-equal).
    Kernel H's calls on the card are recorded as they run and replayed
    against its plain version after the phase.  Returns (launch counts,
    H's rows)."""
    import numpy as np

    import sarlacc_tpu_torch.api.msa as msa

    reset(kernels)
    recorded, unrecord = record_calls(torch, "msa_library", "H")

    cpu = torch.device("cpu")
    by_group = [np.asarray(g, np.int64) for g in filt]
    codes, lengths = reads.codes, reads.lengths
    seg = msa._segments(lengths, by_group, list(range(len(by_group))),
                        msa._segment_lib_budget(dev))[0]
    args = (codes, lengths, by_group, seg, 0.0, -1.0, 5.0, 1.0, 100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (tab_d, _), seg_d, id_d = msa._build_library_device(*args, dev)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    dev_peak = torch.cuda.max_memory_allocated() / 2**30
    seg_args = args
    t0 = time.perf_counter()
    (tab_h, _), seg_h, id_h = msa._build_library_host(*args, dev)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    id_err = max(float(np.abs(a - b).max()) for a, b in zip(id_d, id_h))
    if id_err > 1e-6:
        raise AssertionError(f"msa_library: identities differ by {id_err} between the routes")
    if set(seg_d) != set(seg_h):
        raise AssertionError("msa_library: the routes' pair sets differ")
    tab_d, tab_h = tab_d.cpu().numpy(), tab_h.cpu().numpy()
    same, quantum = 0, 0
    for key, (hs, hn) in seg_h.items():
        ds, dn = seg_d[key]
        if hn != dn:
            raise AssertionError(f"msa_library: pair {key} has {dn} entries on the device "
                                 f"route, {hn} on the host route")
        d, h = tab_d[ds : ds + dn], tab_h[hs : hs + hn]
        d = d[np.lexsort((d[:, 1], d[:, 0]))]
        h = h[np.lexsort((h[:, 1], h[:, 0]))]
        if not np.array_equal(d[:, :2], h[:, :2]):
            raise AssertionError(f"msa_library: pair {key} has other (a, b) entries")
        gap = int(np.abs(d[:, 2].astype(np.int64) - h[:, 2]).max(initial=0))
        if gap > 1:
            raise AssertionError(f"msa_library: pair {key}'s weights differ by {gap} quanta")
        same += int(np.array_equal(d, h))
        quantum += int(np.count_nonzero(d[:, 2] != h[:, 2]))
    log(f"[msa_library] segment 1 of the pipeline's groups ({len(seg)} groups, {len(seg_h)} "
        f"pairs, {tab_h.shape[0]} entries): device route {dev_s:.3f} s synchronised (peak "
        f"allocated {dev_peak:.2f} GiB), host route {host_s:.3f} s; identities within "
        f"{id_err:.3g}, "
        f"{same} of {len(seg_h)} pairs bit-equal, {quantum} entries one quantum apart")

    # The card against the CPU on a slice, one pinned segment budget: the
    # first groups of at most 10 reads (slot classes 2-10; the plain DPs
    # make the CPU side cost ~30 ms a pair).
    sl = [i for i, g in enumerate(by_group) if g.size <= 10][:n_slice]
    if not msa._device_lib_ok(lengths, by_group, sl, cpu):
        raise AssertionError("msa_library: the slice would take the host route on the CPU")
    args = (codes, lengths, by_group, sl, 0.0, -1.0, 5.0, 1.0, 100)
    t0 = time.perf_counter()
    (tab_c, _), seg_c, id_c = msa._build_library_device(*args, dev)
    (tab_p, _), seg_p, id_p = msa._build_library_device(*args, cpu)
    if seg_c != seg_p or not torch.equal(tab_c.cpu(), tab_p):
        raise AssertionError("msa_library: the device table differs between the card and the CPU")
    if not all(np.array_equal(a, b) for a, b in zip(id_c, id_p)):
        raise AssertionError("msa_library: identities differ between the card and the CPU")
    groups = [filt[i] for i in sl]
    budget = msa._segment_lib_budget
    msa._segment_lib_budget = lambda device: 1 << 30
    try:
        card = st.multi_read_align(reads, groups=groups, bandwidth=100, device=dev)
        on_cpu = st.multi_read_align(reads, groups=groups, bandwidth=100, device="cpu")
    finally:
        msa._segment_lib_budget = budget
    if card["alignments"] != on_cpu["alignments"]:
        raise AssertionError("msa_library: strings differ between the card and the CPU")
    unrecord()
    counts = read_counts(kernels)
    if counts["sarlacc_extend_kernel"] == 0:
        raise AssertionError(f"kernel H never launched in the msa_library phase: {counts}")
    # The segment's host readbacks, on one more build outside the timed one
    # and the launch counts.
    builds, uncount = count_readbacks(torch, (("sarlacc_tpu_torch.api.msa",
                                               "_build_library_device"),))
    try:
        msa._build_library_device(*seg_args, dev)
    finally:
        uncount()
    log(f"[msa_library] segment 1's device build: {builds['_build_library_device'][0]} host "
        f"readbacks")
    log(f"[msa_library] {len(sl)} groups ({len(seg_c)} pairs, {tab_c.shape[0]} entries): "
        f"device route on the card equal to device='cpu' (table, identities, strings; "
        f"segment budget pinned at 1 GiB); comparison {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}; kernel-H shapes {sorted(recorded)}")
    return counts, replay_rows(torch, recorded, dev)


def long_reads_batch(st, seed=11, cut_share=0.3, cut_range=(150, 400), nmolecules=48):
    """The long-read workload: ``mock_reads`` of 48 molecules of 4.3-5 kb
    inserts, 6-9 reads each (seed 11, the bench's adaptors, every read on
    its molecule's strand, as ``realize_reads`` orients them), and in each
    molecule 30% of its reads (at least one) cut to their first 150-400
    bases (a numpy generator seeded 11): truncated cDNA reads, which keep
    the UMI end.  Returns (batch, groups: each molecule's reads, cut: bool
    [n])."""
    import numpy as np

    from sarlacc_tpu_torch.core.encode import SeqBatch

    full = mock_batch(st, ADAPTOR1_BENCH, nmolecules=nmolecules, nreads_range=(6, 10),
                      seqlen_range=(4300, 5000), seed=seed, flip_strands=False)
    rng = np.random.default_rng(seed)
    mol = np.array([int(n.split(":")[0].rsplit("_", 1)[1]) for n in full.names])
    seqs, quals = full.seq_strings(), full.qual_strings()
    cut = np.zeros(len(seqs), bool)
    groups = []
    for m in np.unique(mol):
        idx = np.flatnonzero(mol == m)
        groups.append([int(i) for i in idx])
        for i in rng.choice(idx, max(1, int(round(cut_share * idx.size))), replace=False):
            keep = int(rng.integers(cut_range[0], cut_range[1] + 1))
            seqs[i], quals[i] = seqs[i][:keep], quals[i][:keep]
            cut[i] = True
    return SeqBatch.from_strings(seqs, quals, full.names), groups, cut


def phase_long_reads(torch, st, kernels, dev, keep_waves=False, n_slice=2):
    """``multi_read_align`` and ``consensus_read_seq`` on the long-read
    workload (:func:`long_reads_batch`) at the default bandwidth, on the
    library route ``_device_lib_ok`` gives it: a warm-up pass that records
    kernels B, E, F and H one call a (rows, W) (H a build) and the merge
    waves, a timed pass, the consensus; every full x cut pair must bucket
    to W 8192, and kernel B's wide route must run at 8192 rows (the long
    read as A) and at 512 rows or fewer (the cut read as A).  Then
    ``n_slice`` groups, each cut to its first full read and the first cut
    read after it (one 8192-row pair on the wide route), on the card
    against ``device="cpu"`` with the segment budget pinned (alignments and
    consensus byte for byte).  The recorded calls are replayed against
    their plain versions after the phase.  Returns (launch counts, the
    replays' rows, the recorded B calls on the host, the kept waves)."""
    import numpy as np

    import sarlacc_tpu_torch.api.msa as msa
    from sarlacc_tpu_torch.ops.cuda_msa import BLOCK_MAX_WIDTH
    from sarlacc_tpu_torch.ops.msa import _bkt_arr

    t_phase = t0 = time.perf_counter()
    batch, groups, cut = long_reads_batch(st)
    make_s = time.perf_counter() - t0
    lens = batch.lengths.astype(np.int64)
    by_group = [np.asarray(g, np.int64) for g in groups]
    pairs = np.concatenate([np.stack([g[x], g[y]]) for g in by_group
                            for x, y in [np.triu_indices(g.size, 1)]], axis=1)
    la, lb = lens[pairs[0]], lens[pairs[1]]  # pairs x < y, as api/msa.py forms them
    W = _bkt_arr(np.abs(lb - la) + 2 * 100 + 1, 64)
    rows = _bkt_arr(np.maximum(la, 1), 64)
    mixed = cut[pairs[0]] != cut[pairs[1]]
    if not (W[mixed] == 8192).all():
        raise AssertionError(f"long_reads: full x cut pairs bucket to W {sorted(set(W[mixed]))}")
    wide = W > BLOCK_MAX_WIDTH
    device_lib = msa._device_lib_ok(lens, by_group, list(range(len(groups))), dev)
    log(f"[long_reads] {len(batch)} reads ({int(cut.sum())} cut to 150-400 bp, the rest "
        f"{int(lens[~cut].min())}-{int(lens[~cut].max())} bp) in {len(groups)} groups "
        f"(made in {make_s:.1f} s): {pairs.shape[1]} pairs, {int(wide.sum())} on kernel B's wide "
        f"route ({int((wide & (rows == 8192)).sum())} at 8192 rows, "
        f"{int((wide & (rows <= 512)).sum())} at <= 512); library route "
        f"{'device' if device_lib else 'host'} (_device_lib_ok)")

    reset(kernels)
    torch.cuda.reset_peak_memory_stats()
    recorded, unrecord = record_calls(torch, "long_reads", "BEFH", per_width=True)
    wstats, waves, unwave = record_waves(torch, keep_waves, "long_reads")
    try:
        t0 = time.perf_counter()
        st.multi_read_align(batch, groups=groups, device=dev)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        unwave()
        unrecord()
    shapes = {tuple(int(x) for x in (a[10], a[11])) for n, (k, a) in recorded.items() if k == "B"}
    if not any(r == 8192 and w == 8192 for r, w in shapes) or not any(
            r <= 512 and w == 8192 for r, w in shapes):
        raise AssertionError(f"long_reads: kernel B's (rows, W) {sorted(shapes)} lack the wide "
                             f"route at 8192 rows or at <= 512 rows")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aligned = st.multi_read_align(batch, groups=groups, device=dev)
    torch.cuda.synchronize()
    msa_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cons = st.consensus_read_seq(aligned, device=dev)
    torch.cuda.synchronize()
    cons_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = read_counts(kernels)
    seqs = cons.seq_strings()
    if len(seqs) != len(groups) or any(len({len(a) for a in al}) != 1
                                       for al in aligned["alignments"]):
        raise AssertionError("long_reads: ragged or missing alignments")
    short = [len(s) for s in seqs if len(s) < 4000]
    if short:
        raise AssertionError(f"long_reads: consensus reads under 4 kb: {short}")
    log(f"[long_reads] warm-up pass {warm_s:.3f} s, timed multi_read_align {msa_s:.3f} s "
        f"({len(batch) / msa_s:.1f} reads/s), consensus_read_seq {cons_s:.3f} s "
        f"({len(seqs)} reads of {min(map(len, seqs))}-{max(map(len, seqs))} bp); peak "
        f"allocated {peak:.2f} GiB (the merge waves' {wstats['peak'] / 2**30:.2f} GiB, "
        f"{wstats['waves']} waves, the largest {wstats['largest']}); launches {counts}; "
        f"kernel B, E, F and H shapes {sorted(recorded)}")

    # The card against the CPU: each slice group one full read and the first
    # cut read after it, so the pair runs 8192 rows on the wide route.
    sl = []
    for g in by_group:
        full = [i for i in g if not cut[i]]
        after = [i for i in g if cut[i] and full and i > full[0]]
        if after and len(sl) < n_slice:
            sl.append([int(full[0]), int(after[0])])
    if len(sl) < n_slice:
        raise AssertionError(f"long_reads: only {len(sl)} groups hold a full read before a cut one")
    budget = msa._segment_lib_budget
    msa._segment_lib_budget = lambda device: 1 << 30
    try:
        t0 = time.perf_counter()
        card = st.multi_read_align(batch, groups=sl, device=dev)
        card_cons = st.consensus_read_seq(card, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = st.multi_read_align(batch, groups=sl, device="cpu")
        cpu_cons = st.consensus_read_seq(on_cpu, device="cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        msa._segment_lib_budget = budget
    if card["alignments"] != on_cpu["alignments"] or card["qualities"] != on_cpu["qualities"]:
        raise AssertionError("long_reads: alignments differ between the card and the CPU")
    if (card_cons.seq_strings() != cpu_cons.seq_strings()
            or card_cons.qual_strings() != cpu_cons.qual_strings()):
        raise AssertionError("long_reads: consensus differs between the card and the CPU")
    counts = read_counts(kernels)
    log(f"[long_reads] {len(sl)} groups {sl} ({[int(lens[i]) for g in sl for i in g]} bp): "
        f"alignments and consensus on the card ({card_s:.2f} s) equal to device='cpu' "
        f"({cpu_s:.2f} s), segment budget pinned at 1 GiB; launches over the phase {counts}")
    pair_calls = {n: tuple(x.cpu() if torch.is_tensor(x) else x for x in a)
                  for n, (k, a) in recorded.items() if k == "B"}
    t0 = time.perf_counter()
    rows_out = replay_rows(torch, recorded, dev)
    log(f"[long_reads] replays {time.perf_counter() - t0:.1f} s; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts, rows_out, pair_calls, waves


def phase_golden_demux(torch, st, kernels, kernel_d, dev):
    """tests/golden/barcode_demux.json (tests/test_golden_suite.py:127-156)."""
    import numpy as np

    rng = np.random.default_rng(11)
    barcodes = ["".join(rng.choice(list("ACGT"), 4)) for _ in range(6)]
    fp = tempfile.mktemp(suffix=".fastq")
    try:
        st.mock_reads(ADAPTOR1_GOLDEN, ADAPTOR2, fp, all_barcodes=barcodes, nmolecules=12,
                      nreads_range=(3, 6), seqlen_range=(300, 500), seed=42)
        batch = st.read_fastq(fp)
    finally:
        os.remove(fp)
    reset(kernels)
    aligned = st.adaptor_align(ADAPTOR1_GOLDEN, ADAPTOR2, reads=batch, tolerance=200, device=dev)
    observed = aligned["adaptor1"]["subseq"]["Sub1"]
    baligned = st.barcode_align(observed, barcodes, device=dev)
    thr = st.get_barcode_thresholds(baligned, nmads=3, device=dev)
    counts = read_counts(kernels)
    launches = counts[kernel_d.symbol]
    snap = {
        "barcodes": barcodes,
        "observed": observed.seq_strings(),
        "assigned": [int(b) for b in baligned["barcode"]],
        "score": [round(float(s), 4) for s in baligned["score"]],
        "gap": [round(float(g), 4) for g in baligned["gap"]],
        "thr_score": round(thr["score"], 4),
        "thr_gap": round(thr["gap"], 4),
    }
    with open(os.path.join(HERE, "tests", "golden", "barcode_demux.json")) as fh:
        want = json.load(fh)
    if sorted(snap) != sorted(want):
        raise AssertionError(f"golden demux keys differ: {sorted(snap)} vs {sorted(want)}")
    bad = [key for key in want if snap[key] != want[key]]
    if bad:
        raise AssertionError(f"golden demux mismatch on the card in {bad}")
    if launches == 0:
        raise AssertionError("kernel D never launched in the golden demux run")
    log(f"[golden-demux] {len(want)} keys equal tests/golden/barcode_demux.json "
        f"({len(batch)} reads, {len(barcodes)} barcodes); launches {counts}")
    return counts


def phase_demux(torch, st, demux, kernels, dev):
    """bench.py::bench_demux's pass on the card: warm-up, then one timed pass."""
    import numpy as np

    import sarlacc_tpu_torch.ops.cuda_align as ca
    from sarlacc_tpu_torch.api.align_internal import (
        prepare_adaptor, prepare_scores_input, resolve_strand,
    )

    a1 = prepare_adaptor(ADAPTOR1_BENCH, device=dev)
    a2 = prepare_adaptor(ADAPTOR2, device=dev)
    # One upload and one plane build per batch, before the pass, as the bench.
    pfront = prepare_scores_input(a1, demux["front"])
    pback = prepare_scores_input(a1, demux["back"])
    l1, n_pad = pfront.plane_geometry()
    segs = [(a1.modes, a1.matched, 5.0, 1.0, True), (a2.modes, a2.matched, 5.0, 1.0, True)]
    n = pfront.n

    def one_pass():
        sf = ca.fit_scores_segments(pfront.planes(), pfront.lengths, segs, l1, n_pad)
        sb = ca.fit_scores_segments(pback.planes(), pback.lengths, segs, l1, n_pad)
        s = torch.cat([sf, sb]).cpu().numpy().astype(np.float64)  # one readback
        is_rev, final = resolve_strand(s[0], s[3], s[2], s[1])
        bal = st.barcode_align(demux["observed"], demux["barcodes"], device=dev)
        return s, is_rev, bal

    totals, restore = timed_steps(torch, DEMUX_STEPS, qualify=True)
    try:
        t0 = time.perf_counter()
        warm = one_pass()
        warm_s = time.perf_counter() - t0
    finally:
        restore()
    log(f"[demux] warm-up pass {warm_s:.3f} s (the planes of both end batches built "
        f"in it); synchronized step times: {step_report(totals)}")
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, is_rev, bal = one_pass()
    elapsed = time.perf_counter() - t0
    counts = read_counts(kernels)
    if counts["sarlacc_segments_kernel"] != 3:
        raise AssertionError(f"the demux pass should take 3 kernel-D launches: {counts}")
    if s.shape != (4, n) or not np.isfinite(s).all():
        raise AssertionError("demux scores are not finite [4, n]")
    ids = np.asarray(bal["barcode"])
    if ids.shape != (n,) or ids.min() < 0 or ids.max() >= len(demux["barcodes"]):
        raise AssertionError("barcode ids out of range")
    if not (np.array_equal(s, warm[0]) and np.array_equal(ids, warm[2]["barcode"])
            and np.array_equal(bal["gap"], warm[2]["gap"])):
        raise AssertionError("the timed demux pass differs from the warm-up pass")
    cells = n * 250 * 2 * (len(a1) + len(a2)) + n * 12 * 12 * len(demux["barcodes"])
    log(f"[demux] {n} reads x 2 ends x (R={len(a1)}, {len(a2)}) + {len(demux['barcodes'])} "
        f"barcodes: {elapsed:.3f} s = {n / elapsed:.1f} reads/s ({cells / elapsed / 1e9:.2f} "
        f"GCUPS over the pass); {int(is_rev.sum())} reversed; launches {counts}")
    return counts


def phase_calibration(torch, st, batch, aligned, kernels, dev):
    """The calibration entry points on the card, timed, each compared with
    the same call on the CPU (plain versions); tolerance 0.  Kernel G's
    walks are recorded in the warm-up pass and replayed against their plain
    versions at the end.  Returns (launch counts, the timed pass's outputs
    by entry point, its seconds, G's rows)."""
    import numpy as np

    def timed(name, fn, out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return res

    def same(what, got, want):
        ok = (
            np.array_equal(np.asarray(got), np.asarray(want), equal_nan=True)
            if isinstance(got, np.ndarray) else got == want
        )
        if not ok:
            raise AssertionError(f"calibration: {what} differs between the card and the CPU")

    sections = (([16, 31], [19, 42]), ([1], [14]))
    ref = batch.seq_strings()[0][50:550]
    queries = batch.take(np.arange(1, 301))

    def card_pass(secs):
        tuned = timed("tune_alignment", lambda: st.tune_alignment(
            ADAPTOR1_BENCH, ADAPTOR2, reads=batch, tolerance=250, device=dev), secs)
        thr = timed("get_adaptor_thresholds", lambda: st.get_adaptor_thresholds(
            aligned, reads=batch, device=dev), secs)
        filt = timed("filter_reads", lambda: st.filter_reads(
            aligned, thr["threshold1"], thr["threshold2"], device=dev), secs)
        ext = timed("extract_subseq", lambda: st.extract_subseq(
            filt, *sections, reads=batch, device=dev), secs)
        qal = timed("quality_align", lambda: st.quality_align(queries, ref, device=dev), secs)
        return tuned, thr, filt, ext, qal

    totals, restore = timed_steps(torch, CAL_STEPS, qualify=True)
    recorded, unrecord = record_calls(torch, "calibration", "GS")
    warm_secs: dict[str, float] = {}
    try:
        card_pass(warm_secs)
    finally:
        unrecord()
        restore()
    log(f"[calibration] warm-up pass {sum(warm_secs.values()):.3f} s; synchronized "
        f"step times: {step_report(totals)}")

    reset(kernels)
    secs: dict[str, float] = {}
    tuned, thr, filt, ext, qal = card_pass(secs)
    counts = read_counts(kernels)

    params = tuned["parameters"]
    if params["gapOpening"] is None or not (
        np.median(tuned["scores"]["reads"]) > np.median(tuned["scores"]["scrambled"])
    ):
        raise AssertionError(f"tune_alignment found no separating penalties: {params}")
    if len(filt) == 0 or len(ext["adaptor1"]["Sub2"]) != len(filt):
        raise AssertionError("filter_reads / extract_subseq kept no reads")
    if min(counts["sarlacc_score_kernel"], counts["sarlacc_segments_kernel"],
           counts["sarlacc_dir_kernel"], counts["sarlacc_qmap_kernel"],
           counts["sarlacc_string_kernel"]) == 0:
        raise AssertionError(f"a kernel never launched in the calibration run: {counts}")

    # The same calls on the CPU.  tune_alignment runs on a 400-read slice
    # (card and CPU alike): its plain run on all reads takes many minutes.
    t0 = time.perf_counter()
    small = batch.take(np.arange(400))
    kw = dict(reads=small, tolerance=250)
    t_card = st.tune_alignment(ADAPTOR1_BENCH, ADAPTOR2, device=dev, **kw)
    t_cpu = st.tune_alignment(ADAPTOR1_BENCH, ADAPTOR2, device="cpu", **kw)
    same("tune_alignment parameters", t_card["parameters"], t_cpu["parameters"])
    for key in ("reads", "scrambled"):
        same(f"tune_alignment {key} scores", t_card["scores"][key], t_cpu["scores"][key])
    thr_cpu = st.get_adaptor_thresholds(aligned, reads=batch, device="cpu")
    for key in ("threshold1", "threshold2"):
        same(key, thr[key], thr_cpu[key])
    for key in ("scores1", "scores2"):
        same(f"{key} scrambled", thr[key]["scrambled"], thr_cpu[key]["scrambled"])
    filt_cpu = st.filter_reads(aligned, thr["threshold1"], thr["threshold2"], device="cpu")
    same("filter_reads rows", filt.rownames, filt_cpu.rownames)
    same("filter_reads trim.start", filt["trim.start"], filt_cpu["trim.start"])
    same("filter_reads trim.end", filt["trim.end"], filt_cpu["trim.end"])
    ext_cpu = st.extract_subseq(filt, *sections, reads=batch, device="cpu")
    for key in ("adaptor1", "adaptor2"):
        for col in ext[key].colnames:
            same(f"extract_subseq {key} {col}", ext[key][col].seq_strings(),
                 ext_cpu[key][col].seq_strings())
    qal_cpu = st.quality_align(queries, ref, device="cpu")
    for col in ("score", "edit"):
        same(f"quality_align {col}", qal[col], qal_cpu[col])
    for col in ("reference", "query"):
        same(f"quality_align {col}", list(qal[col]), list(qal_cpu[col]))
    cpu_s = time.perf_counter() - t0

    log(f"[calibration] {len(batch)} reads on the card: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
        + f"; tune picked {params} over 35 points; thresholds "
        f"{thr['threshold1']:.4f} / {thr['threshold2']:.4f}; {len(filt)} reads kept; "
        f"quality_align {len(queries)} reads x R={len(ref)}; launches {counts}")
    log(f"[calibration] equal to device='cpu' (tolerance 0; tune_alignment on 400 "
        f"reads, picked {t_cpu['parameters']}); CPU comparison {cpu_s:.1f} s")
    outputs = {"tune_alignment": tuned, "get_adaptor_thresholds": thr, "filter_reads": filt,
               "extract_subseq": ext}
    return counts, outputs, secs, replay_rows(torch, recorded, dev)


def umi_batch(n, umi_len, n_clusters, seed=5):
    """bench.py::bench_umi's generator, as a port SeqBatch."""
    import numpy as np

    from sarlacc_tpu_torch.core.encode import SeqBatch

    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 4, (n_clusters, umi_len)).astype(np.int8)
    codes = centers[rng.integers(0, n_clusters, n)]
    mut = rng.random(n) < 0.3
    pos = rng.integers(0, umi_len, n)
    sub = rng.integers(0, 4, n).astype(np.int8)
    codes[mut, pos[mut]] = sub[mut]
    return SeqBatch(codes, np.full(n, umi_len, np.int64), None, None)


#: (name, UMIs, length, centres, threshold, takes the row-block scan).
UMI_WORKLOADS = (
    ("umi_100k", 100_000, 10, 20_000, 2, False),
    ("long_umis", 20_000, 30, 4_000, 2, True),
    ("many_variants", 20_000, 20, 4_000, 3, True),
)


def phase_umi(torch, st, kernels, hits_kernel, dev):
    """umi_group on the card: timed (the row-block scan with a synchronised
    step timer, its host readbacks counted; kernel I's
    thresholded form recorded a call), and the row-block workloads' slices
    compared with device='cpu' (tolerance 0: the same groups).  Returns
    (the launch counts of the timed calls, kernel I's rows)."""
    import numpy as np

    rows, counts, recorded = [], {}, {}
    scan = ("sarlacc_tpu_torch.ops.levenshtein", "_neighbor_pairs_rowblock")
    for name, n, umi_len, k, thr, scans in UMI_WORKLOADS:
        batch = umi_batch(n, umi_len, k)
        st.umi_group(batch.take(np.arange(n // 4)), threshold1=thr, device=dev)  # warm-up
        # The counter wraps the scan first, so the timer's synchronisations
        # stay outside what it counts (its patches are in place only while
        # the scan runs).
        scan_calls_rb, uncount = count_readbacks(torch, (scan,))
        totals, restore = timed_steps(torch, (scan,))
        calls, unrecord = record_calls(torch, f"umi:{name}", "T")
        reset(kernels)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            groups = st.umi_group(batch, threshold1=thr, device=dev)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        finally:
            unrecord()
            restore()
            uncount()
        for kern, c in read_counts(kernels).items():
            counts[kern] = counts.get(kern, 0) + c
        recorded.update(calls)
        if scans and hits_kernel.launches == 0:
            raise AssertionError(f"umi {name}: kernel I's thresholded form never launched in "
                                 f"the row-block scan")
        scan_s, scan_calls = totals["_neighbor_pairs_rowblock"]
        members = np.sort(np.concatenate(groups))
        if not np.array_equal(members, np.arange(n)):
            raise AssertionError(f"umi {name}: the groups do not partition the {n} UMIs")
        if (scan_calls > 0) != scans:
            raise AssertionError(f"umi {name}: row-block scan calls {scan_calls}, expected "
                                 f"{'some' if scans else 'none'}")
        rb = scan_calls_rb["_neighbor_pairs_rowblock"]
        if any(r > 3 for r in rb):
            raise AssertionError(f"umi {name}: a row-block scan read back more than three "
                                 f"times: {rb}")
        line = (f"[umi] {name}: {n} UMIs of {umi_len} bp, threshold {thr}: {elapsed:.3f} s = "
                f"{n / elapsed:.1f} UMIs/s, {len(groups)} groups; row-block scan "
                f"{scan_s:.3f} s synchronised over {scan_calls} calls (host readbacks a call: "
                f"{rb}; kernel I's thresholded form "
                f"{hits_kernel.launches} launches)")
        if scans:
            sl = batch.take(np.arange(2500))
            t0 = time.perf_counter()
            card = st.umi_group(sl, threshold1=thr, device=dev)
            cpu = st.umi_group(sl, threshold1=thr, device="cpu")
            if [g.tolist() for g in card] != [g.tolist() for g in cpu]:
                raise AssertionError(f"umi {name}: the 2 500-UMI slice groups differently on the CPU")
            line += (f"; 2 500-UMI slice: {len(card)} groups, equal to device='cpu' "
                     f"(comparison {time.perf_counter() - t0:.1f} s)")
        log(line)
        rows.append((name, n, elapsed, len(groups), scan_s))
    return counts, replay_rows(torch, recorded, dev)


#: The scripts' pallas_call lines each new kernel replaces.
TOOL_REPLACES = {
    "ablation": "scripts/microbench_score_ablation.py:123",
    "op_mix": "scripts/microbench_op_mix.py:59",
    "op_rates": "scripts/microbench_vpu_ops.py:67",
    "profile_demux": "scripts/profile_demux_tpu.py:122",
}


def phase_tools(torch, dev):
    """Every new kernel against its plain version (launches not counted),
    then the four tools at their defaults with the counts reset."""
    from sarlacc_tpu_torch.api.align_internal import prepare_adaptor, prepare_scores_input
    from sarlacc_tpu_torch.ops.align import dp_scores
    from sarlacc_tpu_torch.ops.cuda_align import SCORE_KERNEL, encode_mask
    from sarlacc_tpu_torch.tools import op_mix, op_rates, profile_demux, score_ablation
    from sarlacc_tpu_torch.tools.timing import event_ms

    checks = []  # (family, name, kernel, max_abs_err, ms, plain_ms, bound_ms, bound_by)
    args = score_ablation.make_inputs(100_000, 250, 51, dev)
    modes, mask, *_, lengths = args
    abl_rows = float((lengths.double() + 1).sum())
    abl_bound = bound(score_bytes(modes, mask, abl_rows, lengths) + 4 * lengths.numel(),
                      abl_rows * modes.numel() * OPS_PER_CELL["ablation"])
    for v, r in score_ablation.check(args).items():
        checks.append(("ablation", v, score_ablation.KERNELS[v], r["max_abs_err"], r["ms"],
                       r["plain_ms"], *abl_bound))
    log("[tools] ablation: the five variants equal their plain versions at N=100000 L=250 "
        f"R=51 (full also equals kernel C); bound {abl_bound[0]:.3f} ms ({abl_bound[1]})")
    rows = op_rates.grid_rows(dev)
    chain_bytes = 4 * rows * 32 * 4  # three inputs and one output of [rows, 32] float32
    for fam, mod in (("op_mix", op_mix), ("op_rates", op_rates)):
        res = mod.check(dev)
        for cls, r in res.items():
            it = r["iters"]
            per_thread = (it * op_mix.DEPTH * op_mix.CLASSES[cls][1] + it if fam == "op_mix"
                          else it * op_rates.CHAINS * op_rates.DEPTH)
            checks.append((fam, f"{cls}@{it}iters", mod.KERNELS[cls], r["max_abs_err"],
                           r["ms"], r["plain_ms"], *bound(chain_bytes, per_thread * rows * 32)))
        sass = "instruction counts intact" if all(r["sass_checked"] for r in res.values()) else \
            "cuobjdump missing, instruction counts not checked"
        log(f"[tools] {fam}: {len(res)} classes equal their plain versions at 4 iterations; {sass}")
    # The profile's pure kernel C at its shape, against dp_scores.
    import numpy as np

    from sarlacc_tpu_torch.core.encode import SeqBatch

    rng = np.random.default_rng(3)
    front = SeqBatch(rng.integers(0, 4, (100_000, 250)).astype(np.int8), np.full(100_000, 250),
                     rng.integers(20, 60, (100_000, 250)).astype(np.uint8) + 33, None)
    a1 = prepare_adaptor(profile_demux.ADAPTOR1, device=dev)
    prep = prepare_scores_input(a1, front)
    planes, lengths = prep.planes(), prep.lengths
    pargs = (a1.modes, encode_mask(a1.matched), 5.0, 1.0, *planes)
    idx = lengths.to(torch.int64)[None, :]
    got = profile_demux.pure_kernel(a1, planes, lengths)
    want = dp_scores(*pargs, True)[:, : lengths.shape[0]].gather(0, idx)[0]
    err = equal_scores(torch, "profile_demux pure kernel C", got, want)
    checks.append(("profile_demux", "a1", SCORE_KERNEL, err,
                   event_ms(lambda: profile_demux.pure_kernel(a1, planes, lengths), 3, dev),
                   event_ms(lambda: dp_scores(*pargs, True), 1, dev),
                   *bound(score_bytes(*pargs[:2], float((lengths.double() + 1).sum()), lengths)
                          + 4 * lengths.numel(),
                          float((lengths.double() + 1).sum()) * len(a1) * OPS_PER_CELL["C"])))
    del prep, planes, front

    kernels = [*score_ablation.KERNELS.values(), *op_mix.KERNELS.values(),
               *op_rates.KERNELS.values(), SCORE_KERNEL]
    reset(kernels)
    t0 = time.perf_counter()
    results = {
        "ablation": score_ablation.measure(reps=2, check_first=False, args=args, log=log),
        "op_mix": op_mix.measure(reps=2, check_first=False, log=log),
        "op_rates": op_rates.measure(reps=2, check_first=False, log=log),
        "profile_demux": profile_demux.measure(reps=2, log=log),
    }
    counts = read_counts(kernels)
    if min(counts.values()) == 0:
        raise AssertionError(f"a tool kernel never launched in the tools run: {counts}")
    log(f"[tools] four tools at their defaults in {time.perf_counter() - t0:.1f} s; launches {counts}")
    return checks, counts, results


def same_outputs(what, a, b) -> None:
    """Outputs equal byte for byte: frames and dicts key by key, batches by
    their strings, arrays exactly (NaN equal to NaN)."""
    import numpy as np

    if hasattr(a, "colnames"):
        if a.colnames != b.colnames or a.rownames != b.rownames:
            raise AssertionError(f"mesh: {what} has other columns or rows than the solo call")
        for c in a.colnames:
            same_outputs(f"{what}.{c}", a[c], b[c])
    elif hasattr(a, "seq_strings"):
        if a.seq_strings() != b.seq_strings() or a.qual_strings() != b.qual_strings():
            raise AssertionError(f"mesh: {what} strings differ from the solo call")
    elif isinstance(a, dict):
        for k in b:
            same_outputs(f"{what}.{k}", a[k], b[k])
    elif isinstance(a, list) and a and isinstance(a[0], np.ndarray):
        if len(a) != len(b) or not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"mesh: {what} differs from the solo call")
    elif isinstance(a, np.ndarray):
        if not np.array_equal(a, np.asarray(b), equal_nan=a.dtype.kind == "f"):
            raise AssertionError(f"mesh: {what} differs from the solo call")
    elif a != b:
        raise AssertionError(f"mesh: {what} differs from the solo call ({a!r} vs {b!r})")


def mesh_stages(torch, st, batch, observed, barcodes, filt, aligned=None, **kw):
    """The entry points that take ``mesh=``, each timed (host clock around
    work that ends in a synchronise), with ``kw`` (a mesh, or the device)
    passed to each.  Given the solo ``aligned`` frame, only the stages the
    pre-groups change (``umi_group`` to ``consensus_read_seq``) and
    ``barcode_align`` run: the pipeline and calibration phases made the
    other solo calls with the same arguments."""
    out, secs = {}, {}
    dev_kw = {"device": kw["device"]} if "device" in kw else {"device": kw["mesh"].devices[0]}
    full = aligned is None

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0

    if full:
        run("adaptor_align", lambda: st.adaptor_align(
            ADAPTOR1_BENCH, ADAPTOR2, reads=batch, tolerance=250, **kw))
        aligned = out["adaptor_align"]
    umis = aligned["adaptor1"]["subseq"]["Sub2"]
    # 16 pre-groups keyed by the UMI's first two bases: a molecule's reads
    # mostly share a key, so the families survive the pre-grouping.
    pre = (umis.codes[:, 0] % 4) * 4 + umis.codes[:, 1] % 4
    run("umi_group", lambda: st.umi_group(umis, threshold1=2, groups=pre, **kw))
    fams = [g for g in out["umi_group"] if len(g) >= 2]
    run("realize_reads", lambda: st.realize_reads(aligned, reads=batch, trim=False, **dev_kw))
    run("multi_read_align", lambda: st.multi_read_align(
        out["realize_reads"], groups=fams, bandwidth=100, **kw))
    run("consensus_read_seq", lambda: st.consensus_read_seq(out["multi_read_align"], **kw))
    run("barcode_align", lambda: st.barcode_align(observed, barcodes, **kw))
    if full:
        run("tune_alignment", lambda: st.tune_alignment(
            ADAPTOR1_BENCH, ADAPTOR2, reads=batch, tolerance=250, **kw))
        run("get_adaptor_thresholds", lambda: st.get_adaptor_thresholds(
            aligned, reads=batch, **kw))
        run("extract_subseq", lambda: st.extract_subseq(
            filt, ([16, 31], [19, 42]), ([1], [14]), reads=batch, **kw))
    return out, secs


#: The mesh phase's stages whose solo call an earlier phase made with the
#: same arguments: stage -> phase.
SOLO_FROM = {"adaptor_align": "pipeline", "tune_alignment": "calibration",
             "get_adaptor_thresholds": "calibration", "extract_subseq": "calibration"}


def phase_mesh(torch, st, batch, demux, kernels, dev, smi, earlier, earlier_s):
    """Every entry point that takes ``mesh=`` on four shards of the one card
    (``make_mesh(4)``), against the same calls without a mesh: outputs
    equal byte for byte, the histograms' sums the read count.  The solo
    outputs and seconds of :data:`SOLO_FROM`'s stages are ``earlier`` and
    ``earlier_s`` (the pipeline's timed pass and calibration's); the rest
    run here.  Launch counts are those of the mesh calls alone, and each
    kernel call of the mesh run is recorded for :func:`replay_rows`.
    Returns (counts, recorded calls)."""
    import numpy as np

    from sarlacc_tpu_torch.parallel import make_mesh

    mesh = make_mesh(4)
    if mesh.devices != (torch.device("cuda", 0),) * 4:
        raise AssertionError(f"make_mesh(4) on one card gave {mesh.devices}")
    observed = demux["observed"].take(np.arange(20_000))
    args = (torch, st, batch, observed, demux["barcodes"], earlier["filter_reads"])
    solo, solo_s = mesh_stages(*args, aligned=earlier["adaptor_align"], device=dev)
    solo.update({k: earlier[k] for k in SOLO_FROM})
    solo_s.update({k: earlier_s[k] for k in SOLO_FROM})
    reset(kernels)
    calls, unrecord = record_calls(torch, "mesh", per_width=True)
    try:
        meshed, mesh_s = mesh_stages(*args, mesh=mesh)
    finally:
        unrecord()
    counts = read_counts(kernels)
    for name in meshed:
        same_outputs(name, meshed[name], solo[name])
    thr = meshed["get_adaptor_thresholds"]
    for key in ("histogram1", "histogram2"):
        if int(thr[key].sum()) != len(batch):
            raise AssertionError(f"mesh: {key} sums to {int(thr[key].sum())}, not {len(batch)}")
    # Every kernel but kernel G's string walk (quality_align takes no mesh)
    # and kernel I's thresholded form (the mesh's 12-bp UMIs take the native
    # filter, not the row-block scan).
    if min(counts[k.symbol] for k in kernels
           if k.symbol not in ("sarlacc_string_kernel", "sarlacc_lev2_hits")) == 0:
        raise AssertionError(f"a kernel never launched in the mesh run: {counts}")
    log(f"[mesh] {len(batch)} reads on make_mesh(4) (4 shards of cuda:0), every output equal "
        f"to the solo call's; histograms sum to {len(batch)}; card {smi}; seconds mesh / solo: "
        + ", ".join(f"{k} {mesh_s[k]:.3f} / {solo_s[k]:.3f}"
                    + (f" ({SOLO_FROM[k]} phase)" if k in SOLO_FROM else "") for k in meshed)
        + f"; launches {counts}; {len(calls)} launch shapes recorded")
    return counts, calls


def dist_rank(rank, rendezvous, fastq, out_dir):
    """One of the distributed phase's two ranks (gloo, both on cuda:0)."""
    import numpy as np
    import torch

    from sarlacc_tpu_torch.api.align_internal import prepare_adaptor
    from sarlacc_tpu_torch.core.encode import SeqBatch
    from sarlacc_tpu_torch.io.fastq import read_fastq, stream_fastq
    from sarlacc_tpu_torch.ops.align import prepare_reads
    from sarlacc_tpu_torch.ops.cuda_align import SCORE_KERNEL
    from sarlacc_tpu_torch.parallel import (
        global_mesh, host_shard, init_distributed, make_mesh, sharded_adaptor_scores,
    )
    from sarlacc_tpu_torch.parallel.distributed import all_gather_rows

    init_distributed(rendezvous, 2, rank, backend="gloo")
    try:
        dev = torch.device("cuda")
        mesh = global_mesh(device=dev)
        a1 = prepare_adaptor(ADAPTOR1_BENCH, device=dev)
        a2 = prepare_adaptor(ADAPTOR2, device=dev)
        preps = [(a.modes, a.matched, a.match_tab, a.mismatch_tab) for a in (a1, a2)]

        def scores(m, batch):
            front, back = batch.front_and_back(250)
            return sharded_adaptor_scores(m, prepare_reads(front, a1.tables, device=dev),
                                          prepare_reads(back, a1.tables, device=dev),
                                          *preps, 5.0, 1.0)

        batch = SeqBatch.concat(list(stream_fastq(fastq, shard=host_shard())))
        SCORE_KERNEL.launches = 0
        calls, unrecord = record_calls(torch, "distributed", "C") if rank == 0 else ({}, None)
        try:
            t0 = time.perf_counter()
            s1, s2, rev, h1, h2 = scores(mesh, batch)
            h1.cpu()  # a synchronise
            elapsed = time.perf_counter() - t0
        finally:
            if unrecord is not None:
                unrecord()
        launches = SCORE_KERNEL.launches
        got = [all_gather_rows(x) for x in (s1, s2, rev)]
        out = {"rank": rank, "n_local": len(batch), "launches": launches, "seconds": elapsed}
        if rank == 0:
            whole = read_fastq(fastq)
            want = scores(make_mesh(1, device=dev), whole)
            for name, g, w in zip(("score1", "score2", "reversed"), got, want):
                if not torch.equal(g.cpu(), w.cpu()):
                    raise AssertionError(f"distributed: gathered {name} differs from one process")
            for name, g, w in (("histogram1", h1, want[3]), ("histogram2", h2, want[4])):
                if not torch.equal(g.cpu(), w.cpu()) or int(g.sum()) != len(whole):
                    raise AssertionError(f"distributed: {name} differs from one process")
            out.update(n_total=len(whole), hist1=h1.cpu().tolist())
            torch.save({name: (key, tuple(a.cpu() if torch.is_tensor(a) else a for a in args))
                        for name, (key, args) in calls.items()},
                       os.path.join(out_dir, "calls.pt"))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        torch.distributed.destroy_process_group()


def phase_distributed(torch, st, batch, kernel_c, limit_s=300.0):
    """Two real ranks (torch.multiprocessing.spawn, gloo, both on cuda:0)
    stream their byte ranges of the bench reads and score them with kernel
    C through ``sharded_adaptor_scores`` on a mesh that spans them; rank 0
    holds the gathered scores and summed histograms to one process's, bit
    for bit, and keeps its kernel-C calls (:func:`record_calls`).  Fails
    when a rank fails or ``limit_s`` passes.  Returns (counts, rank 0's
    recorded calls)."""
    import numpy as np
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        fq = os.path.join(tmp, "bench.fastq")
        from sarlacc_tpu_torch.io.fastq import write_fastq

        write_fastq(fq, batch)
        t0 = time.perf_counter()
        ctx = mp.spawn(dist_rank, args=(f"file://{os.path.join(tmp, 'rendezvous')}", fq, tmp),
                       nprocs=2, join=False)
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > limit_s:
                    raise AssertionError(f"distributed: the ranks did not finish in {limit_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        wall = time.perf_counter() - t0
        res = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(2)]
        calls = torch.load(os.path.join(tmp, "calls.pt"))
    launches = sum(r["launches"] for r in res)
    if min(r["launches"] for r in res) == 0:
        raise AssertionError(f"kernel C never launched on a rank: {res}")
    log(f"[distributed] 2 ranks (gloo, both on cuda:0): {res[0]['n_local']} + {res[1]['n_local']} "
        f"of {res[0]['n_total']} reads; gathered scores and summed histograms equal one "
        f"process's bit for bit; sharded_adaptor_scores {res[0]['seconds']:.3f} / "
        f"{res[1]['seconds']:.3f} s; kernel-C launches {[r['launches'] for r in res]}; "
        f"phase {wall:.1f} s (spawn, CUDA start-up and the check included); "
        f"histogram1 {np.asarray(res[0]['hist1']).tolist()}; {len(calls)} launch shapes "
        f"recorded on rank 0")
    return {kernel_c.symbol: launches}, calls


def main(argv=None) -> int:
    import torch

    argv = list(sys.argv[1:] if argv is None else argv)
    save_shapes = None
    if argv[:1] == ["--save-shapes"] and len(argv) == 2:
        save_shapes = os.path.abspath(argv[1])
    elif argv:
        print("usage: python3 chip_smoke.py [--save-shapes FILE]", file=sys.stderr)
        return 2

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
    from sarlacc_tpu_torch.ops.cuda_align import DIR_KERNEL, SCORE_KERNEL, SEGMENTS_KERNEL
    from sarlacc_tpu_torch.ops.cuda_backtrack import QMAP_KERNEL, STRING_KERNEL
    from sarlacc_tpu_torch.ops.cuda_extend import EXTEND_KERNEL
    from sarlacc_tpu_torch.ops.cuda_lev2 import HITS_KERNEL, LEV2_KERNEL
    from sarlacc_tpu_torch.ops.cuda_msa import PAIR_KERNEL
    from sarlacc_tpu_torch.ops.cuda_walk import MERGE_KERNEL, WALK_KERNEL

    from sarlacc_tpu_torch.tools import op_mix, op_rates, score_ablation

    kernels = (DIR_KERNEL, PAIR_KERNEL, SCORE_KERNEL, SEGMENTS_KERNEL, MERGE_KERNEL, WALK_KERNEL,
               QMAP_KERNEL, STRING_KERNEL, EXTEND_KERNEL, LEV2_KERNEL, HITS_KERNEL)
    main_path = (DIR_KERNEL, PAIR_KERNEL, MERGE_KERNEL, WALK_KERNEL, QMAP_KERNEL, EXTEND_KERNEL)
    smi = phase_environment(torch)
    phase_build(kernels + tuple(score_ablation.KERNELS.values()) + tuple(op_mix.KERNELS.values())
                + tuple(op_rates.KERNELS.values()))
    bench = mock_batch(
        st, ADAPTOR1_BENCH, nmolecules=950, nreads_range=(8, 14),
        seqlen_range=(400, 700), seed=7,
    )
    demux = demux_inputs()
    dev = torch.device("cuda")
    krows = phase_kernels(torch, st, bench, dev)
    krows += phase_score_kernels(torch, st, demux, bench, dev)
    # Each path runs with every count at 0 and reports every kernel.
    by_path = {}
    by_path["golden"], grows = phase_golden(torch, st, kernels, main_path, dev)
    krows += grows  # kernels E and F at the golden run's own shapes
    by_path["pipeline"], aligned, stages, pair_calls, reads, filt, wrows, waves = phase_pipeline(
        torch, st, bench, kernels, main_path, dev, keep_waves=bool(save_shapes))
    krows += pair_rows(torch, pair_calls, dev)  # kernel B at the pipeline's own shapes
    krows += wrows  # kernels E and F at the pipeline's own shapes
    saved = {"B": {n: tuple(x.cpu() if torch.is_tensor(x) else x for x in a)
                   for n, a in pair_calls.items()}, "E": waves} if save_shapes else None
    del pair_calls, waves
    by_path["msa_library"], mrows = phase_msa_library(torch, st, reads, filt, kernels, dev)
    krows += mrows  # kernel H at the msa_library phase's own shapes
    del reads, filt
    by_path["long_reads"], lrows, pair_calls, waves = phase_long_reads(
        torch, st, kernels, dev, keep_waves=bool(save_shapes))
    krows += lrows  # kernels B, E, F and H at the long-read shapes
    if save_shapes:
        saved["B"].update(pair_calls)
        saved["E"].update(waves)
        torch.save(saved, save_shapes)
        log(f"[long_reads] kernel-B launch arguments {sorted(saved['B'])} and merge waves "
            f"{sorted(saved['E'])} of the pipeline and long_reads phases saved to {save_shapes}")
    del saved, pair_calls, waves
    by_path["golden_demux"] = phase_golden_demux(torch, st, kernels, SEGMENTS_KERNEL, dev)
    by_path["demux"] = phase_demux(torch, st, demux, kernels, dev)
    by_path["calibration"], solo, solo_s, crows = phase_calibration(
        torch, st, bench, aligned, kernels, dev)
    krows += crows  # kernel G at calibration's own shapes
    # The mesh and distributed paths' kernels at their own launch shapes.
    by_path["mesh"], calls = phase_mesh(
        torch, st, bench, demux, kernels, dev, smi,
        {**solo, "adaptor_align": aligned}, {**solo_s, "adaptor_align": stages["adaptor_align"]})
    krows += replay_rows(torch, calls, dev)
    by_path["distributed"], calls = phase_distributed(torch, st, bench, SCORE_KERNEL)
    krows += replay_rows(torch, calls, dev)
    del bench, aligned, demux, solo, calls
    by_path["umi"], urows = phase_umi(torch, st, kernels, HITS_KERNEL, dev)
    krows += urows  # kernel I's thresholded form at the row-block scans' own shapes
    tool_checks, tool_counts, _ = phase_tools(torch, dev)
    by_path["tools"] = {k.symbol: tool_counts.get(k.symbol, 0) for k in kernels}

    def path_launches(symbol):
        each = {path: c.get(symbol, 0) for path, c in by_path.items()
                if c.get(symbol) or path in ("mesh", "distributed")}
        return sum(each.values()), each

    replaces = {
        "A": (DIR_KERNEL, "sarlacc_tpu/ops/pallas_align.py:193"),
        "B": (PAIR_KERNEL, "sarlacc_tpu/ops/pallas_msa.py:99"),
        "C": (SCORE_KERNEL, "sarlacc_tpu/ops/pallas_align.py:100"),
        "D": (SEGMENTS_KERNEL, "sarlacc_tpu/ops/pallas_align.py:564"),
        "E": (MERGE_KERNEL, "sarlacc_tpu/ops/msa.py:938"),
        "F": (WALK_KERNEL, "sarlacc_tpu/ops/msa.py:158"),
        "G": (QMAP_KERNEL, "sarlacc_tpu/ops/backtrack.py:77"),
        "S": (STRING_KERNEL, "sarlacc_tpu/ops/backtrack.py:167"),
        "H": (EXTEND_KERNEL, "sarlacc_tpu/ops/msa.py:1320"),
        "I": (LEV2_KERNEL, "sarlacc_tpu/ops/levenshtein.py:139"),
        "T": (HITS_KERNEL, "sarlacc_tpu/ops/levenshtein.py:249"),
    }
    report = []
    for r in krows:
        kern, repl = replaces[r["key"]]
        if r.get("route") == "wide":  # JAX runs its XLA DP for bands past the Pallas kernel's
            repl = "sarlacc_tpu/ops/msa.py:49"
        launches, each = path_launches(kern.symbol)
        extra = {k: r[k] for k in ("gcups", "tile", "lanes", "passes", "block_ms", "cluster",
                                   "active_clusters", "share",
                                   "merge_route",
                                   "entries", "pairs", "chunks", "chain_rows", "fetches",
                                   "rounds", "up_last", "up_inner", "diag", "left", "other",
                                   "steps", "cells", "hits", "path_cells", "lev2_route",
                                   "shared_bytes", "blocks_per_sm",
                                   "registers",
                                   "spill_bytes",
                                   "achieved_occupancy") if k in r}
        if "route" in r:  # kernel B's route within its CUDA source; "route" names the language
            extra["pair_route"] = r["route"]
        report.append({
            "name": f"{kern.symbol.removeprefix('sarlacc_')}[{r['name']}]",
            "route": "cuda",
            "source": os.path.relpath(kern.source, HERE),
            "replaces": repl,
            "launches": launches,
            "launches_by_path": each,
            "max_abs_err": r["err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            **extra,
        })
    for family, name, kern, err, ms, plain_ms, bms, by in tool_checks:
        report.append({
            "name": f"{kern.symbol.removeprefix('sarlacc_')}[{family}:{name}]",
            "route": "cuda",
            "source": os.path.relpath(kern.source, HERE),
            "replaces": TOOL_REPLACES[family],
            "launches": tool_counts[kern.symbol],
            "launches_by_path": {"tools": tool_counts[kern.symbol]},
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": None,
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

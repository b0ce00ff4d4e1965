"""The port's hand-written CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one.  The file imports no
JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)  Kernel A
and kernel B must give directions bit-identical and scores equal to their
plain PyTorch versions on the same card, kernels C and D scores equal
to theirs, kernels E and F jmat and identities equal to theirs, kernel G
its query maps and emissions, H its library entries and pair offsets, I
its distances and its thresholded form its hits, across the shapes each kernel's launch configuration branches
on; with the plain walks, extension and Levenshtein scan made to raise on
a CUDA tensor, the entry points that reach them still run on the card.
"""

import numpy as np
import pytest
import torch

from sarlacc_tpu_torch.api.align_internal import prepare_adaptor
from sarlacc_tpu_torch.core.encode import SeqBatch
from sarlacc_tpu_torch.ops.align import dp_align, dp_scores, dp_scores_segments, prepare_reads
from sarlacc_tpu_torch.ops import cuda_align
from sarlacc_tpu_torch.ops.cuda_align import (
    DIR_KERNEL,
    SCORE_KERNEL,
    SCORE_TILES,
    SEGMENTS_KERNEL,
    build_cost_planes,
    dir_kernel,
    encode_mask,
    fit_dirs,
    fit_scores_from_planes,
    fit_scores_segments,
    pack_segments,
    plane_dims,
    score_kernel,
    score_kernel_resources,
    score_tile,
    segments_kernel,
)
from sarlacc_tpu_torch.ops import cuda_msa, cuda_walk
from sarlacc_tpu_torch.ops import msa as port_msa
from sarlacc_tpu_torch.ops.cuda_msa import (
    PAIR_KERNEL,
    banded_pair,
    banded_pair_plain,
    pair_kernel,
    pair_route,
)

ADAPTOR = "ACGCTAGCATCAGTCNNNNCACAGCTACGANNNNNNNNCGTACGCAT"
ADAPTOR2 = "TGCATCGATCGCAT"
BARCODE = "ACGTTGCACGTA"
#: R = 150, every IUPAC class: a global segment of this length crosses
#: kernels C and D's column tiles (3 tiles of 64, the last partial).
LONG_REF = ("ACGTRYKMSWBDHVN" * 10)[:150]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _reads(rng, n, maxl):
    seqs, quals = [], []
    for _ in range(n):
        ln = int(rng.integers(0, maxl + 1))
        seqs.append("".join(rng.choice(list("ACGTN"), ln)))
        quals.append("".join(chr(int(c)) for c in rng.integers(33, 90, ln)))
    return SeqBatch.from_strings(seqs, quals)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "ref,local", [(ADAPTOR, True), (ADAPTOR, False), (ADAPTOR2, True), (BARCODE, False)]
)
def test_dir_kernel_matches_plain(cuda_device, ref, local):
    rng = np.random.default_rng(len(ref) + local)
    batch = _reads(rng, 700, 250)
    ad = prepare_adaptor(ref, device=cuda_device)
    codes, qidx, _ = prepare_reads(batch, ad.tables, device=cuda_device)
    l1, n_pad = plane_dims(*codes.shape)
    planes = build_cost_planes(codes, qidx, ad.match_tab, ad.mismatch_tab, l1, n_pad)
    args = (ad.modes, encode_mask(ad.matched), 5.0, 1.0, *planes, local)
    s_k, d_k = dir_kernel(*args)
    s_p, d_p = dp_align(*args)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p)
    assert torch.equal(s_k, s_p)


def _dir_plans(rlen, local, n_pad):
    """dir_plan's own choice, then one tile, G tiles and more tiles than
    lanes (several passes through the hand-off scratch) at each width."""
    rn = max(rlen - int(local), 0)
    plans = [cuda_align.dir_plan(rlen, local, n_pad)]
    for tj, G in [(31, 1), (15, 2), (7, 4), (15, 8), (31, 16), (7, 32)]:
        least = max(1, -(-rn // (tj * G)))
        plans += [(tj, G, least), (tj, G, least + 1)]
    return list(dict.fromkeys(plans))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "ref,local", [(ADAPTOR, True), (LONG_REF, False), (ADAPTOR2, True), ("A", True), ("", False)]
)
def test_dir_kernel_plans_match_plain(cuda_device, ref, local):
    """Every tile width, lanes a read from 1 to 32 and 1 to 12 passes (the
    scratch hand-off): directions and S equal to dp_align, and each block
    stamped with its start, end and SM."""
    rng = np.random.default_rng(len(ref) + 3 * local)
    batch = _reads(rng, 300, 250)
    ad = prepare_adaptor(ref, device=cuda_device)
    codes, qidx, _ = prepare_reads(batch, ad.tables, device=cuda_device)
    l1, n_pad = plane_dims(*codes.shape)
    planes = build_cost_planes(codes, qidx, ad.match_tab, ad.mismatch_tab, l1, n_pad)
    args = (ad.modes, encode_mask(ad.matched), 5.0, 1.0, *planes, local)
    s_p, d_p = dp_align(*args)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for plan in _dir_plans(len(ref), local, n_pad):
        stamps = torch.zeros((n_pad * plan[1] // 128, 3), dtype=torch.int64, device=cuda_device)
        s_k, d_k = cuda_align._launch_dirs(*args, stamps=stamps, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(d_k, d_p), plan
        assert torch.equal(s_k, s_p), plan
        st = stamps.cpu()
        assert bool((st[:, 0] > 0).all()) and bool((st[:, 1] >= st[:, 0]).all())
        assert bool((st[:, 2] >= 0).all()) and bool((st[:, 2] < sms).all())


@pytest.mark.cuda
def test_dir_kernel_at_quality_align_shape(cuda_device):
    """quality_align's launch: 300 reads up to 700 bp against 500 bp,
    global, 32 lanes a read."""
    rng = np.random.default_rng(11)
    batch = _reads(rng, 300, 700)
    ref = "".join(rng.choice(list("ACGT"), 500))
    ad = prepare_adaptor(ref, device=cuda_device)
    codes, qidx, _ = prepare_reads(batch, ad.tables, device=cuda_device)
    l1, n_pad = plane_dims(*codes.shape)
    assert cuda_align.dir_plan(500, False, n_pad) == (31, 32, 1)
    planes = build_cost_planes(codes, qidx, ad.match_tab, ad.mismatch_tab, l1, n_pad)
    args = (ad.modes, encode_mask(ad.matched), 5.0, 1.0, *planes, False)
    s_k, d_k = dir_kernel(*args)
    s_p, d_p = dp_align(*args)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p)
    assert torch.equal(s_k, s_p)


@pytest.mark.cuda
def test_dir_kernel_resources(cuda_device):
    res = cuda_align.dir_kernel_resources()
    assert sorted(res) == sorted(f"A@{tj}" for tj in cuda_align.DIR_TILES)
    for r in res.values():
        assert 0 < r["registers"] <= 255 and r["threads"] == 128
        assert r["blocks_per_sm"] >= 1 and 0 < r["occupancy"] <= 1


@pytest.mark.cuda
def test_fit_dirs_launches_kernel_once(cuda_device):
    batch = _reads(np.random.default_rng(1), 40, 60)
    ad = prepare_adaptor(ADAPTOR2, device=cuda_device)
    codes, qidx, lengths = prepare_reads(batch, ad.tables, device=cuda_device)
    before = DIR_KERNEL.launches
    scores, dirs, _ = fit_dirs(
        codes, qidx, lengths, ad.modes, ad.matched, ad.match_tab, ad.mismatch_tab, 5.0, 1.0
    )
    assert DIR_KERNEL.launches == before + 1
    assert scores.is_cuda and dirs.is_cuda and bool(torch.isfinite(scores).all())


def _pairs(rng, P, rows, W, bw):
    LA, LB = rows, rows + 16
    codes_a = rng.integers(0, 5, (P, LA)).astype(np.int8)
    codes_b = rng.integers(0, 5, (P, LB)).astype(np.int8)
    codes_b[:, :LA] = np.where(rng.random((P, LA)) < 0.8, codes_a, codes_b[:, :LA])
    lens_a = rng.integers(rows // 2, LA + 1, P).astype(np.int32)
    lens_b = np.clip(lens_a + rng.integers(-12, 13, P), 1, LB).astype(np.int32)
    diffs = lens_b.astype(np.int64) - lens_a
    lo = (np.minimum(0, diffs) - bw).astype(np.int32)
    hi = (np.maximum(0, diffs) + bw).astype(np.int32)
    assert int((hi - lo).max()) + 1 <= W
    return codes_a, codes_b, lens_a, lens_b, lo, hi - lo


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rows,W",
    # The warp route at W = 32, 64 and 256 (1, 2 and 8 cells a lane); the
    # block route at 1024 and 2048 (4 and 8 cells a thread) and at 4096 (16
    # cells, >48 KB of shared memory).
    [(64, 32), (64, 64), (256, 256), (512, 1024), (128, 2048), (64, 4096)],
)
def test_pair_kernel_matches_plain(cuda_device, rows, W):
    rng = np.random.default_rng(rows + W)
    arrays = _pairs(rng, 300, rows, W, bw=min(100, (W - 26) // 2))
    args = [torch.as_tensor(a, device=cuda_device) for a in arrays]
    before = PAIR_KERNEL.launches
    s_k, d_k = banded_pair(*args, 0.0, -1.0, 5.0, 1.0, rows, W)
    assert PAIR_KERNEL.launches == before + 1
    s_p, d_p = banded_pair_plain(*args, 0.0, -1.0, 5.0, 1.0, rows, W)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p)
    assert torch.equal(s_k, s_p)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["warp", "block"])
@pytest.mark.parametrize("rows,W", [(64, 32), (64, 64), (96, 128), (256, 256), (512, 512)])
def test_pair_kernel_routes_match_plain(cuda_device, rows, W, route):
    """Both routes at every width the warp route takes (W <= 512 runs the
    warp route unless measurement forces the block one)."""
    assert pair_route(W) == "warp"
    rng = np.random.default_rng(rows + W + len(route))
    arrays = _pairs(rng, 257, rows, W, bw=min(100, (W - 26) // 2))
    args = [torch.as_tensor(a, device=cuda_device) for a in arrays]
    before = PAIR_KERNEL.launches
    s_k, d_k = cuda_msa._launch_pair(*args, 2.0, -3.0, 4.0, 2.0, rows, W, route=route)
    assert PAIR_KERNEL.launches == before + 1
    s_p, d_p = banded_pair_plain(*args, 2.0, -3.0, 4.0, 2.0, rows, W)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p)
    assert torch.equal(s_k, s_p)


@pytest.mark.cuda
def test_pair_kernel_resources(cuda_device):
    res = cuda_msa.pair_kernel_resources((32, 256, 512, 1024, 4096))
    assert "B:warp@1024" not in res and "B:warp@512" in res and "B:block@4096" in res
    for name, r in res.items():
        assert 0 < r["registers"] <= 255 and r["blocks_per_sm"] >= 1, name
        assert r["threads"] == (128 if name.startswith("B:warp") else min(int(name.split("@")[1]), 256))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [96, 131072])
def test_pair_kernel_rejects_bad_width(cuda_device, W):
    args = [torch.as_tensor(a, device=cuda_device) for a in _pairs(np.random.default_rng(2), 4, 64, W, 6)]
    with pytest.raises(ValueError, match="power of two"):
        pair_kernel(*args, 0.0, -1.0, 5.0, 1.0, 64, W)


def _score_inputs(device, ref, n, maxl, zero_lengths=False):
    rng = np.random.default_rng(n + maxl + len(ref))
    batch = _reads(rng, n, maxl)
    if zero_lengths:
        batch = SeqBatch.from_strings([""] * n, [""] * n)
    ad = prepare_adaptor(ref, device=device)
    codes, qidx, lengths = prepare_reads(batch, ad.tables, device=device)
    # Fix the plane height at the longest read the shape allows, so l1
    # does not depend on the draw.
    l1, n_pad = plane_dims(n, maxl)
    full = torch.full((n, maxl), 5, dtype=torch.int8, device=device)
    full[:, : codes.shape[1]] = codes
    fullq = torch.zeros((n, maxl), dtype=torch.int8, device=device)
    fullq[:, : qidx.shape[1]] = qidx
    planes = build_cost_planes(full, fullq, ad.match_tab, ad.mismatch_tab, l1, n_pad)
    return ad, planes, lengths, l1, n_pad


# R = 1, 12, 51, 150 (several column tiles); l1 = 32 and 256; n off the
# 128-thread block and zero lengths.
SCORE_SHAPES = [
    ("A", 200, 31, True), ("A", 200, 31, False), (BARCODE, 300, 31, False),
    (BARCODE, 77, 250, True), (ADAPTOR, 1000, 250, True), (ADAPTOR, 129, 250, False),
    (LONG_REF, 300, 250, False), (LONG_REF, 131, 250, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("ref,n,maxl,local", SCORE_SHAPES)
@pytest.mark.parametrize("zero_lengths", [False, True])
def test_score_kernel_matches_plain(cuda_device, ref, n, maxl, local, zero_lengths):
    ad, planes, lengths, l1, n_pad = _score_inputs(cuda_device, ref, n, maxl, zero_lengths)
    assert l1 in (32, 256)
    mask = encode_mask(ad.matched)
    before = SCORE_KERNEL.launches
    got = score_kernel(ad.modes, mask, 5.0, 1.0, *planes, lengths, local)
    assert SCORE_KERNEL.launches == before + 1
    S = dp_scores(ad.modes, mask, 5.0, 1.0, *planes, local)
    want = S[:, :n].gather(0, lengths.long()[None, :])[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    via = fit_scores_from_planes(planes, lengths, ad.modes, ad.matched, 5.0, 1.0, l1, n_pad, local)
    assert torch.equal(via, want) and SCORE_KERNEL.launches == before + 2


def _grid_segments(ad, nseg):
    pairs = [(go, ge) for go in range(4, 11) for ge in range(1, 6)][:nseg]
    return [(ad.modes, ad.matched, go, ge, (go + ge) % 2 == 0) for go, ge in pairs]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "ref,n,maxl,nseg",
    [(BARCODE, 300, 31, 1), (BARCODE, 1000, 31, 12), (ADAPTOR, 257, 250, 35), (ADAPTOR2, 130, 250, 12),
     (LONG_REF, 300, 250, 6)],
)
@pytest.mark.parametrize("zero_lengths", [False, True])
def test_segments_kernel_matches_plain(cuda_device, ref, n, maxl, nseg, zero_lengths):
    ad, planes, lengths, l1, n_pad = _score_inputs(cuda_device, ref, n, maxl, zero_lengths)
    empty = prepare_adaptor("", device=cuda_device)
    segments = _grid_segments(ad, nseg)
    if nseg > 1:  # an empty reference among the others, global and local
        segments[1] = (empty.modes, empty.matched, 5.0, 1.0, False)
        segments[-1] = (empty.modes, empty.matched, 5.0, 1.0, True)
    if len(ref) > 63:  # a short local segment between the multi-tile ones
        short = prepare_adaptor(ADAPTOR2, device=cuda_device)
        segments[2] = (short.modes, short.matched, 4.0, 2.0, True)
    modes, mask, segs = pack_segments(segments, cuda_device)
    lens_k = torch.zeros(n_pad, dtype=torch.int32, device=cuda_device)
    lens_k[:n] = lengths
    before = SEGMENTS_KERNEL.launches
    got = segments_kernel(modes, mask, segs, *planes, lens_k)
    assert SEGMENTS_KERNEL.launches == before + 1
    want = dp_scores_segments(modes, mask, segs, *planes, lens_k)
    torch.cuda.synchronize()
    assert got.shape == (nseg, n_pad)
    assert torch.equal(got, want)  # padded lanes (length 0) included
    via = fit_scores_segments(planes, lengths, segments, l1, n_pad)
    assert torch.equal(via, want[:, :n])


@pytest.mark.cuda
def test_score_kernels_resources_and_stamps(cuda_device):
    """Every tile width of kernels C and D is queried from the runtime and
    fits the SM; a stamped launch gives every block a start, an end and an
    SM, and the same scores."""
    res = score_kernel_resources()
    assert sorted(res) == sorted(f"{k}@{tj}" for k in "CD" for tj in SCORE_TILES)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for r in res.values():
        assert 0 < r["registers"] <= 255 and r["threads"] == 128
        assert r["blocks_per_sm"] >= 1 and 0 < r["occupancy"] <= 1
    ad, planes, lengths, l1, n_pad = _score_inputs(cuda_device, ADAPTOR2, 300, 250)
    segments = _grid_segments(ad, 3)
    modes, mask, segs = pack_segments(segments, cuda_device)
    assert score_tile(segs) == 15
    lens_k = torch.zeros(n_pad, dtype=torch.int32, device=cuda_device)
    lens_k[:300] = lengths
    stamps = torch.zeros((3 * n_pad // 128, 3), dtype=torch.int64, device=cuda_device)
    got = cuda_align._launch_segments(modes, mask, segs, *planes, lens_k, stamps=stamps)
    want = segments_kernel(modes, mask, segs, *planes, lens_k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    st = stamps.cpu()
    assert bool((st[:, 1] >= st[:, 0]).all()) and bool((st[:, 0] > 0).all())
    assert bool((st[:, 2] >= 0).all()) and bool((st[:, 2] < sms).all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "max_segments,slot_budget,launches",
    [(65535, 1, 6), (65535, 4, 2), (2, 64, 4), (3, 2, 3)],
)
def test_segments_kernel_groups_launches(cuda_device, monkeypatch, max_segments, slot_budget,
                                         launches):
    """More wide (multi-tile) segments than the scratch budget's slots, or
    more segments than a launch takes: several launches that share one
    scratch buffer, with the scores and per-block stamps of one."""
    ad, planes, lengths, l1, n_pad = _score_inputs(cuda_device, LONG_REF, 300, 250)
    short = prepare_adaptor(ADAPTOR2, device=cuda_device)
    segments = _grid_segments(ad, 7)
    segments[3] = (short.modes, short.matched, 4.0, 2.0, True)  # one tile: no slot
    modes, mask, segs = pack_segments(segments, cuda_device)
    lens_k = torch.zeros(n_pad, dtype=torch.int32, device=cuda_device)
    lens_k[:300] = lengths
    monkeypatch.setattr(cuda_align, "MAX_SEGMENTS", max_segments)
    monkeypatch.setattr(cuda_align, "MAX_SCRATCH_BYTES", slot_budget * 2 * l1 * n_pad * 4)
    assert len(cuda_align.launch_groups(segs, score_tile(segs), l1, n_pad)) == launches
    stamps = torch.zeros((7 * n_pad // 128, 3), dtype=torch.int64, device=cuda_device)
    before = SEGMENTS_KERNEL.launches
    got = cuda_align._launch_segments(modes, mask, segs, *planes, lens_k, stamps=stamps)
    assert SEGMENTS_KERNEL.launches == before + launches
    want = dp_scores_segments(modes, mask, segs, *planes, lens_k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    st = stamps.cpu()
    assert bool((st[:, 0] > 0).all()) and bool((st[:, 1] >= st[:, 0]).all())


@pytest.mark.cuda
def test_barcode_and_tune_launch_kernel_d(cuda_device):
    import sarlacc_tpu_torch as st

    batch = _reads(np.random.default_rng(3), 50, 14)
    before = SEGMENTS_KERNEL.launches
    bc = st.barcode_align(batch, [BARCODE, "ACGTACGTACGT", "TTTTGGGGCCCC"])
    assert SEGMENTS_KERNEL.launches == before + 1
    cpu = st.barcode_align(batch, [BARCODE, "ACGTACGTACGT", "TTTTGGGGCCCC"], device="cpu")
    np.testing.assert_array_equal(bc["barcode"], cpu["barcode"])
    np.testing.assert_array_equal(bc["score"], cpu["score"])
    reads = _reads(np.random.default_rng(4), 30, 120)
    before = SEGMENTS_KERNEL.launches
    kw = dict(reads=reads, tolerance=60, gap_op_range=(4, 5), gap_ext_range=(1, 2))
    tuned = st.tune_alignment(ADAPTOR, ADAPTOR2, **kw)
    assert SEGMENTS_KERNEL.launches == before + 4
    assert tuned["parameters"] == st.tune_alignment(ADAPTOR, ADAPTOR2, device="cpu", **kw)["parameters"]


@pytest.mark.cuda
def test_calibration_on_card_equals_cpu(cuda_device, tmp_path):
    """get_adaptor_thresholds (kernel C on the scrambles), filter_reads,
    extract_subseq and quality_align (kernels A and G) on the card equal the
    same calls with ``device="cpu"`` on the same aligned frame, tolerance 0."""
    import sarlacc_tpu_torch as st

    fp = str(tmp_path / "reads.fastq")
    st.mock_reads(ADAPTOR, ADAPTOR2, fp, nmolecules=20, nreads_range=(4, 9),
                  seqlen_range=(350, 600), seed=7)
    batch = st.read_fastq(fp)
    aligned = st.adaptor_align(ADAPTOR, ADAPTOR2, reads=batch, tolerance=250, device=cuda_device)
    sections = (([16, 31], [19, 38]), ([1], [14]))
    ref = batch.seq_strings()[0][50:350]
    queries = batch.take(np.arange(1, 41))
    out = {}
    for dev in (cuda_device, "cpu"):
        before = (SCORE_KERNEL.launches, DIR_KERNEL.launches)
        thr = st.get_adaptor_thresholds(aligned, reads=batch, device=dev)
        filt = st.filter_reads(aligned, thr["threshold1"], thr["threshold2"], device=dev)
        ext = st.extract_subseq(filt, *sections, reads=batch, device=dev)
        qal = st.quality_align(queries, ref, device=dev)
        launched = (SCORE_KERNEL.launches > before[0], DIR_KERNEL.launches > before[1])
        assert launched == ((True, True) if dev == cuda_device else (False, False))
        out[str(dev)] = thr, filt, ext, qal
    (thr, filt, ext, qal), (thr_c, filt_c, ext_c, qal_c) = out.values()
    assert len(filt) > 0 and len(ext["adaptor1"]["Sub2"]) == len(filt)
    for key in ("threshold1", "threshold2"):
        assert thr[key] == thr_c[key], key
    for key in ("scores1", "scores2"):
        for part in ("reads", "scrambled"):
            np.testing.assert_array_equal(np.asarray(thr[key][part]), np.asarray(thr_c[key][part]))
    assert list(filt.rownames) == list(filt_c.rownames)
    _same_frames(filt, filt_c)
    for key in ("adaptor1", "adaptor2"):
        _same_frames(ext[key], ext_c[key])
    _same_frames(qal, qal_c)


# ------------------------------------------- the measurement tools' kernels


@pytest.mark.cuda
@pytest.mark.parametrize("R", [51, 70])
@pytest.mark.parametrize("local", [False, True])
def test_ablation_kernels_match_plain(cuda_device, local, R):
    """Each variant launches once and equals its plain version; ``full``
    equals kernel C (R = 70 takes two column tiles and the hand-off)."""
    from sarlacc_tpu_torch.tools import score_ablation as sa

    args = list(sa.make_inputs(700, 60, R, cuda_device, seed=4))
    lengths = torch.as_tensor(np.random.default_rng(5).integers(0, 61, 700), dtype=torch.int32)
    args[-1] = lengths.to(cuda_device)
    assert torch.equal(sa.ablation_kernel("full", *args, local=local),
                       score_kernel(*args, local=local))
    for variant, kern in sa.KERNELS.items():
        before = kern.launches
        got = sa.ablated_scores(variant, *args, local=local)
        assert kern.launches == before + 1
        want = sa.ablated_scores_plain(variant, *args, local=local)
        torch.cuda.synchronize()
        assert torch.equal(got, want), variant
    res = sa.ablation_resources(score_tile([(0, R, local)]))
    assert set(res) == set(sa.VARIANTS) and all(r["blocks_per_sm"] >= 1 for r in res.values())


@pytest.mark.cuda
def test_op_chain_kernels_match_plain(cuda_device):
    from sarlacc_tpu_torch.tools import op_mix, op_rates

    rng = np.random.default_rng(6)
    a, b1, b2 = (torch.as_tensor(rng.normal(size=(64, 32)).astype(np.float32), device=cuda_device)
                 for _ in range(3))
    for cls in op_rates.CLASSES:
        got = op_rates.op_rates(cls, a, b1, b2, 3, 5, 9)
        want = op_rates.op_rates_plain(cls, a, b1, b2, 3, op_rates.lane_mask(64, 5, cuda_device),
                                       op_rates.lane_mask(64, 9, cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(got, want), cls
    for cls in op_mix.CLASSES:
        got = op_mix.op_mix(cls, a, b1, b2, 3)
        want = op_mix.op_mix_plain(cls, a, b1, b2, 3)
        torch.cuda.synchronize()
        assert torch.equal(got, want), cls


@pytest.mark.cuda
def test_op_chains_did_not_fold(cuda_device):
    from sarlacc_tpu_torch.tools import op_mix, op_rates

    census = op_rates.sass_census(op_rates.KERNELS["add"])
    if census is None:
        pytest.skip("the toolkit has no cuobjdump")
    for i, cls in enumerate(op_rates.CLASSES):
        op_rates.require_ops(cls, op_rates.census_of(census, "op_rates_kernel", i), op_rates.RATE_OPS[cls])
    for i, cls in enumerate(op_mix.CLASSES):
        op_rates.require_ops(cls, op_rates.census_of(census, "op_mix_kernel", i), op_mix.MIX_OPS[cls])


@pytest.mark.cuda
def test_rowblock_scan_on_card_matches_cpu(cuda_device):
    from sarlacc_tpu_torch.core.encode import encode_batch
    from sarlacc_tpu_torch.ops.levenshtein import lev2_condensed, lev2_neighbor_pairs

    rng = np.random.default_rng(8)
    seqs = ["".join(rng.choice(list("ACGTN"), int(rng.integers(24, 33)), p=[.24] * 4 + [.04]))
            for _ in range(700)]
    codes, lengths = encode_batch(seqs)
    codes = codes.astype(np.int32)
    for limit in (2, 3):
        gi, gj = lev2_neighbor_pairs(codes, lengths, limit, tile=128, device=cuda_device)
        wi, wj = lev2_neighbor_pairs(codes, lengths, limit, tile=128, device="cpu")
        assert sorted(zip(gi.tolist(), gj.tolist())) == sorted(zip(wi.tolist(), wj.tolist()))
    np.testing.assert_array_equal(
        lev2_condensed(codes[:300], lengths[:300], device=cuda_device),
        lev2_condensed(codes[:300], lengths[:300], device="cpu"),
    )


@pytest.mark.cuda
def test_device_library_on_card_matches_cpu(cuda_device, monkeypatch):
    """The device-library route (kernel B, the walk, the position maps and
    the consistency extension) gives the same table, identities and strings
    on the card as on the CPU."""
    from sarlacc_tpu_torch.api import msa
    from sarlacc_tpu_torch.api.msa import multi_read_align

    monkeypatch.delenv("SARLACC_HOST_LIB", raising=False)
    rng = np.random.default_rng(9)
    seqs, groups = [], []
    for n, length in ((6, 150), (2, 90), (11, 240), (4, 60)):
        ref = rng.integers(0, 4, length)
        groups.append(list(range(len(seqs), len(seqs) + n)))
        for _ in range(n):
            s = ref.copy()
            mut = rng.random(length) < 0.08
            s[mut] = rng.integers(0, 4, int(mut.sum()))
            keep = rng.random(length) >= 0.03
            seqs.append("".join("ACGT"[c] for c in s[keep]))
    batch = SeqBatch.from_strings(seqs)
    by_group = [np.asarray(g) for g in groups]
    args = (batch.codes, batch.lengths, by_group, [0, 1, 2, 3], 0.0, -1.0, 5.0, 1.0, 30)
    (tab_c, inv_c), seg_c, id_c = msa._build_library_device(*args, cuda_device)
    (tab_p, inv_p), seg_p, id_p = msa._build_library_device(*args, torch.device("cpu"))
    assert inv_c == inv_p and seg_c == seg_p
    assert torch.equal(tab_c.cpu(), tab_p)
    for a, b in zip(id_c, id_p):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(msa, "_segment_lib_budget", lambda device: 1 << 30)
    card = multi_read_align(batch, groups=groups, bandwidth=30, device=cuda_device)
    cpu = multi_read_align(batch, groups=groups, bandwidth=30, device="cpu")
    assert card["alignments"] == cpu["alignments"]


def _wide_pairs(rng, P, rows, lb_range, bw):
    """Pairs whose B reads are kilobases longer than their A reads, A's
    bases planted in B at a random offset (80% kept)."""
    LA, LB = rows, lb_range[1]
    codes_a = rng.integers(0, 5, (P, LA)).astype(np.int8)
    codes_b = rng.integers(0, 5, (P, LB)).astype(np.int8)
    for p, off in enumerate(rng.integers(0, lb_range[0] - LA, P)):
        keep = rng.random(LA) < 0.8
        codes_b[p, off : off + LA] = np.where(keep, codes_a[p], codes_b[p, off : off + LA])
    lens_a = rng.integers(rows // 2, LA + 1, P).astype(np.int32)
    lens_b = rng.integers(lb_range[0], LB + 1, P).astype(np.int32)
    diffs = lens_b.astype(np.int64) - lens_a
    lo = (np.minimum(0, diffs) - bw).astype(np.int32)
    hi = (np.maximum(0, diffs) + bw).astype(np.int32)
    return codes_a, codes_b, lens_a, lens_b, lo, hi - lo


@pytest.mark.cuda
@pytest.mark.parametrize("P", [3, 300])
def test_pair_kernel_wide_route_matches_plain(cuda_device, P):
    """W = 8192 (reads 4-4.6 kb against 128-256 bp) takes the wide route;
    300 pairs are 300 clusters (of one block at this width) in one launch."""
    rng = np.random.default_rng(P)
    arrays = _wide_pairs(rng, P, 256, (4000, 4600), 100)
    assert int(arrays[5].max()) + 1 <= 8192 and pair_route(8192) == "wide"
    args = [torch.as_tensor(a, device=cuda_device) for a in arrays]
    before = PAIR_KERNEL.launches
    s_k, d_k = banded_pair(*args, 0.0, -1.0, 5.0, 1.0, 256, 8192)
    assert PAIR_KERNEL.launches == before + 1
    s_p, d_p = banded_pair_plain(*args, 0.0, -1.0, 5.0, 1.0, 256, 8192)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p)
    assert torch.equal(s_k, s_p)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,W", [(64, 256), (512, 1024), (64, 4096)])
def test_pair_kernel_wide_route_forced_matches_plain(cuda_device, rows, W):
    """The wide route forced below its own widths, against the plain version."""
    rng = np.random.default_rng(rows + W + 7)
    arrays = _pairs(rng, 70, rows, W, bw=min(100, (W - 26) // 2))
    args = [torch.as_tensor(a, device=cuda_device) for a in arrays]
    s_k, d_k = cuda_msa._launch_pair(*args, 2.0, -3.0, 4.0, 2.0, rows, W, route="wide")
    s_p, d_p = banded_pair_plain(*args, 2.0, -3.0, 4.0, 2.0, rows, W)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p)
    assert torch.equal(s_k, s_p)


#: (W, rows, B's length range): every cluster size of the wide route (1, 2,
#: 4, 8 blocks a pair), A reads of rows // 2 to rows bases, bandwidth 100.
WIDE_CLUSTER_SHAPES = [(8192, 256, (4000, 4600)), (16384, 128, (9000, 12000)),
                       (32768, 64, (20000, 28000)), (65536, 32, (40000, 60000))]


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 3, 300])
@pytest.mark.parametrize("W,rows,lb_range", WIDE_CLUSTER_SHAPES,
                         ids=[f"W{w}" for w, _, _ in WIDE_CLUSTER_SHAPES])
def test_pair_kernel_wide_clusters_match_plain(cuda_device, W, rows, lb_range, P):
    """The wide route on its own cluster of W / 8192 blocks a pair (one
    block at 8192), one launch, against the plain version bit for bit."""
    rng = np.random.default_rng(W + P)
    arrays = _wide_pairs(rng, P, rows, lb_range, 100)
    assert int(arrays[5].max()) < W and pair_route(W) == "wide"
    assert cuda_msa.wide_plan(W)[2] == W // 8192
    args = [torch.as_tensor(a, device=cuda_device) for a in arrays]
    before = PAIR_KERNEL.launches
    s_k, d_k = banded_pair(*args, 0.0, -1.0, 5.0, 1.0, rows, W)
    assert PAIR_KERNEL.launches == before + 1
    s_p, d_p = banded_pair_plain(*args, 0.0, -1.0, 5.0, 1.0, rows, W)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_p)
    assert torch.equal(s_k, s_p)


@pytest.mark.cuda
def test_pair_kernel_wide_resources(cuda_device):
    """The wide route's kernel at each width: 512 threads, the cluster of its
    plan, some clusters resident at once, nothing spilled."""
    res = cuda_msa.pair_kernel_resources((4096, 8192, 16384, 32768, 65536))
    assert "B:wide@4096" not in res
    for W in (8192, 16384, 32768, 65536):
        r = res[f"B:wide@{W}"]
        assert r["cluster"] == W // 8192 and r["threads"] == 512, (W, r)
        assert r["active_clusters"] > 0 and r["spill_bytes"] == 0, (W, r)
        assert 0 < r["registers"] <= 128 and r["blocks_per_sm"] >= 1, (W, r)


@pytest.mark.cuda
def test_wide_band_family_on_card_matches_cpu(cuda_device):
    """A 200-bp read and a 4.5-kb read: one kernel-B launch on the wide
    route, and the same alignment as on the CPU."""
    from sarlacc_tpu_torch.api.msa import multi_read_align

    rng = np.random.default_rng(12)
    long = "".join(rng.choice(list("ACGT"), 4500))
    short = list(long[2000:2200])
    for p in rng.integers(0, 200, 6):
        short[p] = "ACGT"[("ACGT".index(short[p]) + 1) % 4]
    batch = SeqBatch.from_strings(["".join(short), long])
    before = PAIR_KERNEL.launches
    card = multi_read_align(batch, groups=[[0, 1]], device=cuda_device)
    assert PAIR_KERNEL.launches > before
    cpu = multi_read_align(batch, groups=[[0, 1]], device="cpu")
    assert card["alignments"] == cpu["alignments"]


def _same_frames(a, b):
    assert a.colnames == b.colnames
    for c in a.colnames:
        x, y = a[c], b[c]
        if hasattr(x, "colnames"):
            _same_frames(x, y)
        elif hasattr(x, "seq_strings"):
            assert x.seq_strings() == y.seq_strings() and x.qual_strings() == y.qual_strings()
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.cuda
def test_mesh_equals_solo_on_card(cuda_device, tmp_path):
    """adaptor_align and multi_read_align on four shards of the one card
    equal the same calls without a mesh, bit for bit."""
    import sarlacc_tpu_torch as st
    from sarlacc_tpu_torch.parallel import make_mesh

    mesh = make_mesh(4)
    assert mesh.devices == (torch.device("cuda", 0),) * 4
    fp = str(tmp_path / "reads.fastq")
    st.mock_reads(ADAPTOR, ADAPTOR2, fp, nmolecules=10, nreads_range=(4, 9),
                  seqlen_range=(350, 600), seed=20240817)
    batch = st.read_fastq(fp)
    solo = st.adaptor_align(ADAPTOR, ADAPTOR2, reads=batch, tolerance=250, device=cuda_device)
    meshed = st.adaptor_align(ADAPTOR, ADAPTOR2, reads=batch, tolerance=250, mesh=mesh)
    _same_frames(meshed, solo)
    groups = [g for g in st.umi_group(solo["adaptor1"]["subseq"]["Sub2"], threshold1=2,
                                      device=cuda_device) if len(g) >= 2]
    reads = st.realize_reads(solo, reads=batch, trim=False, device=cuda_device)
    a = st.multi_read_align(reads, groups=groups, device=cuda_device)
    b = st.multi_read_align(reads, groups=groups, mesh=mesh)
    assert a["alignments"] == b["alignments"]


def _cards(n=2):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    return torch.cuda.device_count()


@pytest.mark.cuda
def test_mesh_across_cards_equals_solo(tmp_path):
    """One shard a card: adaptor_align and multi_read_align equal the
    calls on one card, bit for bit."""
    import sarlacc_tpu_torch as st
    from sarlacc_tpu_torch.parallel import make_mesh

    n = _cards()
    mesh = make_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(n))
    fp = str(tmp_path / "reads.fastq")
    st.mock_reads(ADAPTOR, ADAPTOR2, fp, nmolecules=10, nreads_range=(4, 9),
                  seqlen_range=(350, 600), seed=20240817)
    batch = st.read_fastq(fp)
    solo = st.adaptor_align(ADAPTOR, ADAPTOR2, reads=batch, tolerance=250, device="cuda:0")
    meshed = st.adaptor_align(ADAPTOR, ADAPTOR2, reads=batch, tolerance=250, mesh=mesh)
    _same_frames(meshed, solo)
    groups = [g for g in st.umi_group(solo["adaptor1"]["subseq"]["Sub2"], threshold1=2,
                                      device="cuda:0") if len(g) >= 2]
    reads = st.realize_reads(solo, reads=batch, trim=False, device="cuda:0")
    a = st.multi_read_align(reads, groups=groups, device="cuda:0")
    b = st.multi_read_align(reads, groups=groups, mesh=mesh)
    assert a["alignments"] == b["alignments"]


@pytest.mark.cuda
def test_ranks_with_a_card_each_equal_one_process(tmp_path):
    """A rank a card on the default backend (NCCL): the gathered scores and
    summed histograms equal one process's, bit for bit."""
    import json
    import pathlib
    import sys
    import time

    import torch.multiprocessing as mp

    from sarlacc_tpu_torch.io.fastq import write_fastq

    n = _cards()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import torch_distributed_worker as worker

    rng = np.random.default_rng(4)
    seqs = ["".join(rng.choice(list("ACGT"), int(rng.integers(20, 120)))) for _ in range(301)]
    fp = str(tmp_path / "reads.fastq")
    write_fastq(fp, seqs=seqs, quals=["I" * len(x) for x in seqs])
    ctx = mp.spawn(worker.run_cards, args=(f"file://{tmp_path / 'rendezvous'}", fp, str(tmp_path), n),
                   nprocs=n, join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the ranks did not finish within 240 s")
    res = json.loads((tmp_path / "cards.json").read_text())
    assert res == {"backend": "nccl", "device": "cuda:0", "equal": True}


def _merge_inputs(rng, Pp, rows, W, bw=100):
    """A merge wave as ``merge_wave_from_library`` hands it to kernel E:
    ``la`` near ``rows`` (some far below), bands inside W, weights that
    are sums of a few quantised library weights, NEG outside the band and
    past ``la``; the last merges padded (la = 0)."""
    spread = min(40, W // 8)
    la = rng.integers(rows // 4, rows + 1, Pp)
    lb = np.clip(la + rng.integers(-spread, spread + 1, Pp), 1, None)
    bw = min(bw, (W - 2 * spread - 2) // 2)
    diff = lb - la
    lo = np.minimum(0, diff) - bw
    kmax = np.maximum(0, diff) + bw - lo
    assert int(kmax.max()) < W
    la[-3:] = lb[-3:] = lo[-3:] = kmax[-3:] = 0
    live = (np.arange(1, rows + 1)[None, :, None] <= la[:, None, None]) & (
        np.arange(W)[None, None, :] <= kmax[:, None, None])
    w = (rng.integers(0, 6, (Pp, rows, W)) * np.float32(100 / 3)).astype(np.float32)
    cost = np.where(live, w, np.float32(-1.0e9)).astype(np.float32)
    return cost, *(x.astype(np.int32) for x in (la, lb, lo, kmax))


def _plane_entries(cost, la, kmax, seed):
    """Kernel E's inputs for a cost plane (on its device): one entry a live
    in-band cell of its value, about a third of the cells as two entries
    whose in-order float32 sum is the value (a multiple of 100 / 3 split on
    a multiple of it), entries the decode drops, sorted by cell and stable
    as ``ops/msa.py::_merge_entries`` leaves them, and the row pointers."""
    Pp, rows, W = cost.shape
    dev = cost.device
    g = torch.Generator(device="cpu").manual_seed(seed)
    live = ((torch.arange(1, rows + 1, device=dev)[None, :, None] <= la.to(torch.int64)[:, None, None])
            & (torch.arange(W, device=dev)[None, None, :] <= kmax.to(torch.int64)[:, None, None]))
    cells = torch.nonzero(live.reshape(-1))[:, 0]
    vals = cost.reshape(-1)[cells]
    part = torch.floor(vals * torch.rand(cells.numel(), generator=g).to(dev) / np.float32(100 / 3))
    part = part * np.float32(100 / 3)
    two = (torch.rand(cells.numel(), generator=g) < 0.3).to(dev) & (part + (vals - part) == vals)
    part = torch.where(two, part, vals)
    rest = vals[two] - part[two]
    keys = torch.cat([cells, cells[two], torch.full((5,), Pp * rows * W, device=dev)])
    w = torch.cat([part, rest, torch.ones(5, device=dev)])
    order = torch.randperm(keys.numel(), generator=g).to(dev)
    return port_msa._sorted_entries(keys[order], w[order], Pp, rows, W)


def _merge_plain(args):
    dirs = port_msa._profile_merge_kernel(*args)
    return dirs, port_msa._merge_walk_kernel(dirs, *args[1:4])


def _hold_merge(args, seed=0):
    """Kernel E on the plane's entries against its plain versions: jmat
    equal to ``_merge_entries_plain`` on the same entries and to the plain
    DP + walk on the plane, and every choice of every live row equal to the
    plain DP's."""
    cost, la, lb, lo, kmax = args
    Pp, rows, W = cost.shape
    entries = _plane_entries(cost, la, kmax, seed)
    before = cuda_walk.MERGE_KERNEL.launches
    jm, words = cuda_walk._launch_merge(*entries, la, lb, lo, kmax, rows, W)
    assert cuda_walk.MERGE_KERNEL.launches == before + 1
    want = port_msa._merge_entries_plain(*entries, la, lb, lo, kmax, rows, W)
    dirs, want_plane = _merge_plain(args)
    torch.cuda.synchronize()
    assert torch.equal(jm, want) and torch.equal(jm, want_plane)
    choices = cuda_walk.unpack_choices(words, W)
    for p, n in enumerate(la.clamp(max=rows).cpu().tolist()):
        assert torch.equal(choices[:n, p], dirs[:n, p]), p
    return jm


@pytest.mark.cuda
@pytest.mark.parametrize("rows,W,Pp", [(512, 256, 256), (1024, 256, 512), (1024, 512, 128),
                                       (1024, 1024, 32), (64, 32, 16), (128, 4096, 16)])
def test_merge_kernel_matches_plain(cuda_device, rows, W, Pp):
    """Kernel E at the pipeline's bucket shapes (rows 512 / 1024, W 256 /
    512 on the warp route, 1024 on the block route) and at the extremes of
    both routes, bit-equal to the plain DP + walk."""
    rng = np.random.default_rng(rows + W)
    args = [torch.as_tensor(a, device=cuda_device) for a in _merge_inputs(rng, Pp, rows, W)]
    jm = _hold_merge(args)
    assert bool(jm.any())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,W", [(256, 2048), (64, 8192), (32, 16384)])
def test_merge_kernel_block_route_wide_bands(cuda_device, rows, W):
    """The block route at wider bands (8 and 32 cells a thread) and the
    wide route above it (64 chunks a row), against the plain version."""
    rng = np.random.default_rng(rows + W + 1)
    args = [torch.as_tensor(a, device=cuda_device) for a in _merge_inputs(rng, 40, rows, W)]
    _hold_merge(args)


@pytest.mark.cuda
def test_merge_kernel_past_kernel_b_widths(cuda_device):
    """A wave of short profiles (19-32 columns) merged with long ones (60 000
    to 120 000 columns, as a group of a few unrelated ~32 kb reads gives):
    W = 131 072 over 32 rows, past kernel B's widest band, on the wide
    route, against the plain version."""
    rng = np.random.default_rng(131072)
    Pp, rows, W, bw = 16, 32, 131072, 100
    la = rng.integers(19, rows + 1, Pp)
    lb = rng.integers(60_000, 120_000, Pp)
    lo = np.minimum(0, lb - la) - bw
    kmax = np.maximum(0, lb - la) + bw - lo
    assert int(kmax.max()) < W and cuda_walk.merge_route(W) == "wide"
    la[-4:] = lb[-4:] = lo[-4:] = kmax[-4:] = 0
    live = (np.arange(1, rows + 1)[None, :, None] <= la[:, None, None]) & (
        np.arange(W)[None, None, :] <= kmax[:, None, None])
    w = rng.integers(0, 6, (Pp, rows, W), dtype=np.int8) * np.float32(100 / 3)
    cost = np.where(live, w, np.float32(-1.0e9)).astype(np.float32)
    args = [torch.as_tensor(cost, device=cuda_device)] + [
        torch.as_tensor(x.astype(np.int32), device=cuda_device) for x in (la, lb, lo, kmax)]
    jm = _hold_merge(args)
    assert bool(jm[:, :-4].any()) and not bool(jm[:, -4:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("W", [32, 512, 1024])
def test_merge_kernel_on_adversarial_waves(cuda_device, W):
    """Tie-heavy integer costs, the walk's first lookup clamped at both edges
    of the band (k0 past W - 1 and below 0), la far below rows."""
    rng = np.random.default_rng(W + 5)
    cost, la, lb, lo, kmax = _merge_inputs(rng, 24, 96, W, bw=8)
    cost = np.where(cost > -1e8, np.round(cost / 100) * 25, cost).astype(np.float32)
    lo[0], kmax[0] = lb[0] - la[0] - W - 3, W - 1
    lo[1], kmax[1] = lb[1] - la[1] + 4, W - 1
    la[2] = 5
    _hold_merge([torch.as_tensor(a, device=cuda_device) for a in (cost, la, lb, lo, kmax)])


def _library_wave(rng, P, rows, W, n_entries):
    """A merge wave as ``multi_read_align`` hands it to
    ``merge_wave_from_library``: a library table of (pa, pb, quantised
    weight) rows, one segment a merge (``swap`` on every third) over its
    members' position->column maps, ``la`` below ``rows`` on some merges,
    entries that land outside the band or on no column (dropped), and many
    entries on one cell (columns drawn near the diagonal)."""
    descs, tab, at = [], [], 0
    for m in range(P):
        la = int(rng.integers(rows // 3, rows + 1))
        lb = int(np.clip(la + rng.integers(-30, 31), 1, None))
        bw = min(60, (W - abs(lb - la) - 2) // 2)
        lo = min(0, lb - la) - bw
        kmax = max(0, lb - la) + bw - lo
        n = int(rng.integers(n_entries // 2, n_entries))
        pa = rng.integers(0, la + 1, n)
        pb = np.clip(pa + (lb - la) * pa // max(la, 1) + rng.integers(-bw - 4, bw + 5, n), 0, lb)
        swap = m % 3 == 0
        if swap:
            pa, pb = pb, pa
        tab.append(np.stack([pa, pb, rng.integers(1, 65536, n)], axis=1))
        descs.append({"la": la, "lb": lb, "lo": lo, "kmax": kmax,
                      "segments": [(at, n, 0, 0, int(swap))],
                      "p2ca": np.arange(la + 1, dtype=np.int32), "p2cb": np.arange(lb + 1, dtype=np.int32)})
        at += n
    return np.concatenate(tab).astype(np.int32), descs


@pytest.mark.cuda
@pytest.mark.parametrize("P,rows,W", [(300, 512, 256), (40, 1024, 512), (24, 512, 1024)])
def test_merge_wave_on_the_card_equals_the_cpu(cuda_device, monkeypatch, P, rows, W):
    """``merge_wave_from_library`` on a CUDA library runs kernel E on the
    sorted entries (never ``_merge_cost_init``, ``_ordered_add_`` or the
    plain DP) and equals the same wave on the CPU (the plain cost planes,
    DP and walk) bit for bit."""
    rng = np.random.default_rng(P + rows + W)
    tab, descs = _library_wave(rng, P, rows, W, 6000)
    w_inv = np.float32(1 / 4096)
    want = port_msa.merge_wave_from_library((torch.as_tensor(tab), w_inv), descs, rows, W)
    for name in ("_merge_cost_init", "_ordered_add_", "_merge_accum_kernel", "_merge_dp_walk"):
        def guard(*a, _name=name):
            raise AssertionError(f"{_name} reached on the card")
        monkeypatch.setattr(port_msa, name, guard)
    before = cuda_walk.MERGE_KERNEL.launches
    got = port_msa.merge_wave_from_library((torch.as_tensor(tab, device=cuda_device), w_inv), descs, rows, W)
    assert cuda_walk.MERGE_KERNEL.launches == before + 1
    assert torch.equal(got.cpu(), want) and bool(want.any())


@pytest.mark.cuda
def test_merge_wave_allocates_no_cost_plane(cuda_device):
    """At the pipeline's largest wave shape (4 096 merges x 1 024 rows x W
    512: a float32 cost plane would be 8.6 GB) the wave's peak allocation
    stays far below one plane: the entries, their sort and the row
    pointers, E's 2-bit choice scratch (0.54 GB) and jmat."""
    rng = np.random.default_rng(4096)
    P, rows, W = 4096, 1024, 512
    tab, descs = _library_wave(rng, P, rows, W, 400)
    lib = (torch.as_tensor(tab, device=cuda_device), np.float32(1 / 4096))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    jm = port_msa.merge_wave_from_library(lib, descs, rows, W)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    plane = P * rows * W * 4
    assert peak < plane // 8, (peak, plane)
    assert jm.shape == (rows, P) and bool(jm.any())


def _walk_plain(dirs, la, lb, lo, ca, cb):
    jm = port_msa._pair_walk_kernel(dirs, la, lb, lo)
    return jm, port_msa._pair_ident_kernel(jm, ca, cb)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,W,P", [(512, 256, 6078), (1024, 256, 32768), (1024, 512, 3886),
                                      (512, 1024, 2), (64, 32, 300)])
def test_walk_kernel_matches_plain(cuda_device, rows, W, P):
    """Kernel F over kernel B's directions at the pipeline's launch shapes
    (P x rows x W), jmat and identities bit-equal to the plain walk +
    identity."""
    rng = np.random.default_rng(rows + W + P)
    arrays = _pairs(rng, P, rows, W, bw=min(100, (W - 26) // 2))
    ca, cb, la, lb, lo, km = (torch.as_tensor(a, device=cuda_device) for a in arrays)
    _, dirs = pair_kernel(ca, cb, la, lb, lo, km, 0.0, -1.0, 5.0, 1.0, rows, W)
    before = cuda_walk.WALK_KERNEL.launches
    jm, ident = cuda_walk.pair_walk(dirs, la, lb, lo, ca, cb)
    assert cuda_walk.WALK_KERNEL.launches == before + 1
    jm_p, id_p = _walk_plain(dirs, la, lb, lo, ca, cb)
    torch.cuda.synchronize()
    assert torch.equal(jm, jm_p)
    assert torch.equal(ident, id_p)
    assert float(ident.mean()) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("W", [32, 1024])
def test_walk_kernel_on_adversarial_planes(cuda_device, W):
    """Random legal direction planes with long horizontal runs, the start
    cell clamped at both edges, A's codes narrower than the rows and B's
    index clamped."""
    rng = np.random.default_rng(W)
    rows, P = 64, 200
    choice = rng.integers(0, 3, (rows, P, W))
    choice = np.where((rng.random((rows, P, 1)) < 0.4) & (rng.random((rows, P, W)) < 0.9), 1, choice)
    hext = (rng.random((rows, P, W)) < 0.93).astype(np.int64)
    dirs = (choice + (hext << 2) + (rng.integers(0, 2, (rows, P, W)) << 3)).astype(np.int8)
    la = rng.integers(1, rows // 2, P).astype(np.int32)
    lb = rng.integers(1, rows // 2, P).astype(np.int32)
    lo = (np.minimum(0, lb - la) - 8).astype(np.int32)
    lo[0], lo[1] = lb[0] - la[0] - W - 4, lb[1] - la[1] + 3
    ca = rng.integers(0, 4, (P, rows // 3)).astype(np.int8)
    cb = rng.integers(0, 4, (P, rows // 4)).astype(np.int8)
    args = [torch.as_tensor(a, device=cuda_device) for a in (dirs, la, lb, lo, ca, cb)]
    jm, ident = cuda_walk.pair_walk(*args)
    jm_p, id_p = _walk_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(jm, jm_p) and torch.equal(ident, id_p)


@pytest.mark.cuda
def test_walk_kernel_ends_on_choice_three(cuda_device):
    """A choice of 3 (never written by kernel B; the plain loop would spin)
    ends its row's chain unresolved, and the launch finishes."""
    dirs = torch.zeros((8, 1, 32), dtype=torch.int8, device=cuda_device)
    dirs[4, 0, 3] = 3
    ints = [torch.tensor([v], dtype=torch.int32, device=cuda_device) for v in (6, 6, -3)]
    codes = [torch.zeros((1, n), dtype=torch.int8, device=cuda_device) for n in (8, 8)]
    jm, ident = cuda_walk.pair_walk(dirs, *ints, *codes)
    torch.cuda.synchronize()
    assert jm[:, 0].tolist() == [1, 2, 3, 4, 0, 6, 0, 0] and float(ident[0]) == 1.0


@pytest.mark.cuda
def test_walk_kernel_on_shards_equals_solo(cuda_device):
    """A kernel-B bucket split over four shards of the card (``make_mesh(4)``):
    kernel F on each shard's pairs, the gathered scores, jmat and identities
    equal to the solo call's."""
    from sarlacc_tpu_torch.parallel import make_mesh
    from sarlacc_tpu_torch.parallel.context import use_mesh

    rng = np.random.default_rng(77)
    ca, cb, la, lb, lo, km = _pairs(rng, 1001, 512, 256, bw=100)
    args = (ca, la, cb, lb, lo, lo + km, 0.0, -1.0, 5.0, 1.0, 512, 256)
    solo = port_msa._run_pair_bucket(*args, cuda_device)
    before = cuda_walk.WALK_KERNEL.launches
    with use_mesh(make_mesh(4)):
        meshed = port_msa._run_pair_bucket(*args, cuda_device)
    assert cuda_walk.WALK_KERNEL.launches == before + 4
    for a, b in zip(meshed, solo):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_plain_walks_never_see_a_card_tensor(cuda_device, monkeypatch):
    """``multi_read_align`` on the card (both library routes) launches
    kernels E and F, and the plain walks, merge DP and identity, the blank
    cost planes and the ordered accumulation, made to raise on a CUDA
    tensor, are never reached."""
    from sarlacc_tpu_torch.api.msa import multi_read_align
    for name in ("_pair_walk_kernel", "_pair_ident_kernel", "_profile_merge_kernel",
                 "_merge_walk_kernel", "_merge_cost_init", "_ordered_add_", "_merge_accum_kernel"):
        real = getattr(port_msa, name)

        def guard(first, *rest, _real=real, _name=name):
            if first.is_cuda:
                raise AssertionError(f"{_name} got a CUDA tensor")
            return _real(first, *rest)

        monkeypatch.setattr(port_msa, name, guard)
    rng = np.random.default_rng(3)
    seqs, groups = [], []
    for n, length in ((6, 150), (3, 90), (9, 240)):
        ref = rng.integers(0, 4, length)
        groups.append(list(range(len(seqs), len(seqs) + n)))
        for _ in range(n):
            s = ref.copy()
            mut = rng.random(length) < 0.06
            s[mut] = rng.integers(0, 4, int(mut.sum()))
            seqs.append("".join("ACGT"[c] for c in s[rng.random(length) >= 0.03]))
    batch = SeqBatch.from_strings(seqs)
    monkeypatch.delenv("SARLACC_HOST_LIB", raising=False)
    for host in ("", "1"):
        if host:
            monkeypatch.setenv("SARLACC_HOST_LIB", host)
        before = (cuda_walk.MERGE_KERNEL.launches, cuda_walk.WALK_KERNEL.launches)
        card = multi_read_align(batch, groups=groups, bandwidth=30, device=cuda_device)
        after = (cuda_walk.MERGE_KERNEL.launches, cuda_walk.WALK_KERNEL.launches)
        assert after[0] > before[0] and after[1] > before[1], host
        assert [len(a) for a in card["alignments"]] == [6, 3, 9]


@pytest.mark.cuda
def test_walk_kernel_resources(cuda_device):
    """Kernels F and E as compiled fit the SM and spill nothing; E's warp
    route at W 512 takes at most 64 registers a thread, and F keeps at least
    half the SM's warps resident."""
    res = cuda_walk.walk_kernel_resources((32, 256, 512, 1024, 8192, 131072))
    print({name: (r["registers"], r["spill_bytes"], r["blocks_per_sm"]) for name, r in res.items()})
    assert sorted(res) == sorted(["F", "E:warp@32", "E:warp@256", "E:warp@512", "E:block@1024",
                                  "E:block@8192", "E:wide@131072"])
    for name, r in res.items():
        assert 0 < r["registers"] <= 255 and r["blocks_per_sm"] >= 1, name
        assert r["spill_bytes"] == 0, (name, r)
    assert res["E:warp@512"]["registers"] <= 64  # 32 warps an SM: a 4 096-merge wave at once
    assert res["F"]["occupancy"] >= 0.5


def _walk_plane(device, ref, n, maxl, local, seed):
    """Kernel A's directions and the reads' lengths for ``n`` random reads
    of up to ``maxl`` bases against ``ref``."""
    batch = _reads(np.random.default_rng(seed), n, maxl)
    ad = prepare_adaptor(ref, device=device)
    codes, qidx, lengths = prepare_reads(batch, ad.tables, device=device)
    _, dirs, _ = fit_dirs(codes, qidx, lengths, ad.modes, ad.matched, ad.match_tab,
                          ad.mismatch_tab, 5.0, 1.0, local=local)
    return dirs, lengths


def _hold_walks(dirs, lengths):
    """Kernel G's two walks against the plain versions on the same card:
    outputs, and the kernel's fetching steps in all and by kind against the
    plain walks' count.  The allocator's free blocks are filled with 0xA5
    first, so a cell the kernel leaves unwritten shows."""
    from sarlacc_tpu_torch.ops import backtrack, cuda_backtrack

    for size in [64 << 20] + [1 << 20] * 32:  # the large and the small pool
        torch.empty(size, dtype=torch.uint8, device=dirs.device).fill_(0xA5)
    before = (cuda_backtrack.QMAP_KERNEL.launches, cuda_backtrack.STRING_KERNEL.launches)
    kq = torch.zeros(len(cuda_backtrack.COUNTS), dtype=torch.int64, device=dirs.device)
    ks = torch.zeros_like(kq)
    got_q = cuda_backtrack.qmap_walk(dirs, lengths, fetches=kq)
    got_s = cuda_backtrack.string_walk(dirs, lengths, fetches=ks)
    assert (cuda_backtrack.QMAP_KERNEL.launches, cuda_backtrack.STRING_KERNEL.launches) == \
        (before[0] + 1, before[1] + 1)
    pq, ps = {}, {}
    want_q = backtrack._qmap_walk_plain(dirs, lengths, counts=pq)
    want_s = backtrack._string_walk_plain(dirs, lengths, counts=ps)
    torch.cuda.synchronize()
    for got, want in zip(got_q + got_s, want_q + want_s):
        assert got.dtype == want.dtype and torch.equal(got, want)
    for k, plain in ((kq, pq), (ks, ps)):
        got = dict(zip(cuda_backtrack.COUNTS, k.tolist()))
        assert {n: got[n] for n in plain} == plain, (got, plain)
    return got_s[2]


@pytest.mark.cuda
@pytest.mark.parametrize("ref,local,n,maxl", [
    (ADAPTOR, True, 700, 250), (ADAPTOR2, True, 19926, 250), (BARCODE, False, 300, 60),
    ("quality_align", False, 300, 700),
])
def test_backtrack_walks_match_plain(cuda_device, ref, local, n, maxl):
    """Kernel G on kernel A's directions at small shapes, at adaptor_align's
    stacked ends (19 926 reads) and at quality_align's launch (300 reads
    up to 700 bp against 500 bp, global): query maps and emissions
    bit-equal to the plain walks."""
    if ref == "quality_align":
        ref = "".join(np.random.default_rng(5).choice(list("ACGT"), 500))
    dirs, lengths = _walk_plane(cuda_device, ref, n, maxl, local, n + maxl)
    ncols = _hold_walks(dirs, lengths)
    assert int(ncols.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("R,l1,n_pad,n", [(7, 9, 96, 70), (1, 5, 32, 32), (40, 64, 128, 0),
                                          (300, 260, 640, 600)])
def test_backtrack_walks_on_malformed_planes(cuda_device, R, l1, n_pad, n):
    """Random planes strand lanes until the plain loop's step cap; lanes
    past the lengths and reads of length 0 walk from row 0."""
    rng = np.random.default_rng(R + l1 + n)
    dirs = torch.as_tensor(rng.integers(-3, 4, (R, l1, n_pad)).astype(np.int16), device=cuda_device)
    lengths = rng.integers(0, l1, n).astype(np.int32)
    lengths[: min(n, 3)] = 0
    ncols = _hold_walks(dirs, torch.as_tensor(lengths, device=cuda_device))
    assert int(ncols.max()) == -(-(R + l1 + 9) // 8) * 8 or n == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["climb", "runs", "clamped", "clamped_R1", "all_up"])
def test_backtrack_walks_on_adversarial_planes(cuda_device, kind):
    """The planes that hold the schedule's transliteration on the CPU
    (``tests/torch_walk_planes.py``: slab-crossing climbs, diagonal runs
    of 7-9 cells, clamped indices, a climb capped inside the slab phase):
    kernel G against the plain walks, counters included."""
    import torch_walk_planes as walk_planes

    dirs, lengths = walk_planes.adversarial_plane(kind)
    _hold_walks(torch.as_tensor(dirs, device=cuda_device),
                torch.as_tensor(lengths, device=cuda_device))


def _extend_build(rng, sizes, STR, positions, identity=False):
    """Kernel H's inputs for one library build over groups of ``sizes``
    reads: the job tables as ``_build_library_device`` makes them, an arena
    of random position maps (or identity maps, so that every slot of a pair
    reaches one b: runs of g - 1 lanes), random float32 identities and the
    build's chunks (two A-position classes)."""
    from sarlacc_tpu_torch.api import msa as port_api_msa

    by_group, at = [], 0
    for g in sizes:
        by_group.append(np.arange(at, at + g))
        at += g
    jobs, first_job, _, _, sl = port_api_msa._library_jobs(by_group, list(range(len(sizes))))
    J = jobs.shape[0]
    rows = 2 + 2 * J
    if identity:
        arena = np.zeros((rows, STR), np.int16)
        for r in range(rows):
            n = int(rng.integers(STR // 2, STR))
            arena[r, :n] = np.arange(n)
    else:
        arena = np.where(rng.random((rows, STR)) < 0.25, 0,
                         rng.integers(1, positions, (rows, STR))).astype(np.int16)
        arena[0] = 0
    arena[1] = np.arange(STR)
    fracs = rng.random(J).astype(np.float32)
    strc = np.where(np.arange(J) % 3 == 0, STR, max(128, STR // 2)).astype(np.int64)
    order, chunks = port_api_msa._library_chunks(sl, strc)
    return arena, jobs, first_job, fracs, order, chunks


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,STR,positions,identity", [
    ([2, 2, 5, 3], 128, 40, False),      # g = 2 and dead slots
    ([7, 11, 4], 512, 200, False),       # two 256-item tiles a pair, strc 512 and 256
    ([33, 3], 256, 3, False),            # the 32-slot class, few positions: long runs
    ([33], 128, 0, True),                # identity maps: runs of 32 lanes
    ([17] * 8, 1024, 700, False),        # pipeline-sized: 1 088 pairs x 16 slots x 1 024
])
def test_extend_kernel_matches_plain(cuda_device, sizes, STR, positions, identity):
    """Kernel H against its plain version on the same card, on one library
    build: the entries (a, b, weight) and the pairs' offsets bit-equal, with
    2 C + 1 launches for C chunks."""
    from sarlacc_tpu_torch.ops import cuda_extend

    rng = np.random.default_rng(sum(sizes) + STR)
    arena, jobs, first_job, fracs, order, chunks = _extend_build(rng, sizes, STR, positions,
                                                                 identity)
    args = (torch.as_tensor(arena, device=cuda_device), jobs, first_job,
            torch.as_tensor(fracs, device=cuda_device), order, chunks, np.float32(0.61))
    before = cuda_extend.EXTEND_KERNEL.launches
    got, off = port_msa._extend_library(*args)
    writes = sum(off[q1] > off[q0] for q0, q1, _, _ in chunks)
    assert cuda_extend.EXTEND_KERNEL.launches == before + len(chunks) + 1 + writes
    want, want_off = port_msa._extend_library_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and np.array_equal(off, want_off)
    assert off[-1] > 0 and got.shape == (off[-1], 3)


@pytest.mark.cuda
def test_extend_kernel_weights_round_as_numpy(cuda_device):
    """Identities whose products with 100 sit on float32 ties: the kernel's
    entries equal the plain version's, whose weights are numpy's float64
    product rounded once to float32."""
    rng = np.random.default_rng(3)
    arena, jobs, first_job, _, order, chunks = _extend_build(rng, [6, 5], 128, 20)
    fracs = []
    while len(fracs) < jobs.shape[0]:
        f = np.float32(rng.random())
        p = np.float64(f) * 100.0
        lo = np.float64(np.float32(p)) if np.float64(np.float32(p)) <= p else \
            np.float64(np.nextafter(np.float32(p), np.float32(0)))
        hi = np.float64(np.nextafter(np.float32(lo), np.float32(np.inf)))
        if p - lo == hi - p:
            fracs.append(f)
    args = (torch.as_tensor(arena, device=cuda_device), jobs, first_job,
            torch.as_tensor(np.asarray(fracs, np.float32), device=cuda_device), order, chunks,
            np.float32(1.0))
    got, off = port_msa._extend_library(*args)
    want, want_off = port_msa._extend_library_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and np.array_equal(off, want_off)


def _lev_codes(rng, n, L, n_rate=0.06):
    lengths = rng.integers(0, L + 1, n).astype(np.int32)
    lengths[:2] = [0, L]
    codes = rng.choice(5, (n, L), p=[(1 - n_rate) / 4] * 4 + [n_rate]).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = 5
    return codes, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("TI,TJ,L", [(64, 500, 10), (64, 500, 30), (64, 300, 33), (48, 200, 64),
                                     (32, 100, 100), (8, 40, 300), (512, 3584, 30)])
def test_lev2_kernel_matches_plain(cuda_device, TI, TJ, L):
    """Kernel I's cross and paired forms on each route (registers up to 32
    rows, the scratch route above) against the plain scan on the same
    card, with N codes and reads of length 0; 512 x 3 584 x 30 is a
    row-block launch of long_umis."""
    from sarlacc_tpu_torch.ops import cuda_lev2, levenshtein

    rng = np.random.default_rng(TI + TJ + L)
    codes, lengths = _lev_codes(rng, TI + TJ, L)
    c = torch.as_tensor(codes, device=cuda_device)
    ln = torch.as_tensor(lengths, device=cuda_device)
    before = cuda_lev2.LEV2_KERNEL.launches
    got = levenshtein._lev2_block(c[:TI], ln[:TI], c[TI:], ln[TI:])
    want = levenshtein._lev2_scan(c[:TI, None, :], ln[:TI, None], c[None, TI:], ln[None, TI:])
    ia = torch.as_tensor(rng.integers(0, TI + TJ, 5000), device=cuda_device)
    ib = torch.as_tensor(rng.integers(0, TI + TJ, 5000), device=cuda_device)
    got_p = levenshtein._lev2_pairs(c, ln, ia, ib)
    want_p = levenshtein._lev2_scan(c[ia], ln[ia], c[ib], ln[ib])
    assert cuda_lev2.LEV2_KERNEL.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_p, want_p)


def _umi_rows(rng, n, L, n_rate, lo):
    """``n`` distinct UMIs of ``lo``-``L`` codes near random centres (a few
    substitutions and indels, N at ``n_rate``), pad 5, int32."""
    centres = [rng.integers(0, 4, rng.integers(lo, L + 1)) for _ in range(max(2, n // 8))]
    seen, rows = set(), []
    while len(rows) < n:
        s = list(centres[rng.integers(len(centres))])
        for _ in range(rng.integers(0, 4)):
            op, at = rng.integers(3), rng.integers(len(s) + 1)
            if op == 0 and at < len(s):
                s[at] = int(rng.integers(4))
            elif op == 1 and len(s) < L:
                s.insert(at, int(rng.integers(4)))
            elif op == 2 and at < len(s) and len(s) > 1:
                del s[at]
        s = [4 if rng.random() < n_rate else c for c in s]
        if tuple(s) not in seen:
            seen.add(tuple(s))
            rows.append(s)
    lengths = np.asarray([len(r) for r in rows], np.int32)
    codes = np.full((n, L), 5, np.int32)
    for i, r in enumerate(rows):
        codes[i, : len(r)] = r
    return codes, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,limit,tile,lo", [
    (3000, 30, 2, 512, 26), (2000, 20, 3, 512, 16), (1500, 12, 1, 200, 8), (1200, 40, 4, 512, 30),
    (800, 64, 2, 256, 60), (600, 90, 3, 512, 80), (400, 20, 16, 128, 1),
])
def test_lev2_hits_match_plain(cuda_device, n, L, limit, tile, lo):
    """Kernel I's thresholded form on each route (the band in registers for
    rows to 64 positions and half-bands to 15, the scratch route above)
    against the plain row-block scan on the same card: the same hits in
    the same order, one launch (two where the hits outgrow the default
    buffer), the band cells counted; with a buffer of one key the count
    overflows and one re-run at the exact count gives the same hits."""
    from sarlacc_tpu_torch.ops import cuda_lev2, levenshtein

    rng = np.random.default_rng(n + L + limit)
    codes, lengths = _umi_rows(rng, n, L, 0.03, lo)
    perm = np.argsort(lengths, kind="stable")
    s_len = lengths[perm]
    c = torch.as_tensor(codes[perm][:, : int(s_len[-1])].astype(np.int8), device=cuda_device)
    ln = torch.as_tensor(s_len, device=cuda_device)
    cells = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    want = levenshtein._rowblock_hits_plain(c, ln, s_len, 2 * limit, limit, tile)
    before = cuda_lev2.HITS_KERNEL.launches
    got = levenshtein._rowblock_hits(c, ln, s_len, 2 * limit, limit, tile)
    # One launch, two where the hits overflow the default buffer (limit 16
    # on 20-bp rows: every pair is a hit).
    assert cuda_lev2.HITS_KERNEL.launches == before + 1 + (want.numel() > max(1 << 16, 8 * n))
    cuda_lev2.lev2_hits(c, ln, s_len, 2 * limit, limit, tile, cells=cells)
    before = cuda_lev2.HITS_KERNEL.launches
    again = cuda_lev2.lev2_hits(c, ln, s_len, 2 * limit, limit, tile, cap=1)
    assert cuda_lev2.HITS_KERNEL.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    assert want.numel() > n and int(cells) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("route_L", [30, 90])
def test_lev2_hits_split_beyond_the_budget(cuda_device, monkeypatch, route_L):
    """A memory budget of fewer hits than the scan finds: the thresholded
    form runs in parts of whole row tiles and returns the plain version's
    hits, in order, on the host; its cell count is that of one whole run."""
    from sarlacc_tpu_torch.ops import cuda_lev2, levenshtein

    rng = np.random.default_rng(route_L)
    codes, lengths = _umi_rows(rng, 1500, route_L, 0.03, route_L - 4)
    perm = np.argsort(lengths, kind="stable")
    s_len = lengths[perm]
    c = torch.as_tensor(codes[perm][:, : int(s_len[-1])].astype(np.int8), device=cuda_device)
    ln = torch.as_tensor(s_len, device=cuda_device)
    want = levenshtein._rowblock_hits_plain(c, ln, s_len, 4, 2, 512)
    whole = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    cuda_lev2.lev2_hits(c, ln, s_len, 4, 2, 512, cells=whole)
    monkeypatch.setattr(cuda_lev2, "memory_budget", lambda *a: 24 * (want.numel() // 3))
    cells = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    before = cuda_lev2.HITS_KERNEL.launches
    got = cuda_lev2.lev2_hits(c, ln, s_len, 4, 2, 512, cells=cells)
    assert cuda_lev2.HITS_KERNEL.launches - before > 3 and not got.is_cuda
    assert torch.equal(got, want.cpu()) and int(cells) == int(whole)


@pytest.mark.cuda
def test_lev2_hits_counters(cuda_device, monkeypatch):
    """The profiler's ``lev2.*`` counters on the card: a buffer of one key
    forces one re-run; the cells are counted once, as the ``cells=``
    tensor counts them, and the hits are the plain version's."""
    from sarlacc_tpu_torch.ops import cuda_lev2, levenshtein
    from sarlacc_tpu_torch.utils import profiling

    rng = np.random.default_rng(18)
    codes, lengths = _umi_rows(rng, 2000, 22, 0.0, 16)
    perm = np.argsort(lengths, kind="stable")
    s_len = lengths[perm]
    c = torch.as_tensor(codes[perm][:, : int(s_len[-1])].astype(np.int8), device=cuda_device)
    ln = torch.as_tensor(s_len, device=cuda_device)
    want = levenshtein._rowblock_hits_plain(c, ln, s_len, 6, 3, 512)
    cells = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    prof = profiling.PipelineProfiler()
    monkeypatch.setattr(profiling, "_GLOBAL", prof)
    got = cuda_lev2.lev2_hits(c, ln, s_len, 6, 3, 512, cells=cells, cap=1)
    n_jobs = cuda_lev2.rowblock_jobs(s_len, 3, 512).shape[0]
    assert torch.equal(got, want)
    assert prof.counters == {"lev2.cells": int(cells), "lev2.hits": want.numel(),
                             "lev2.reruns": 1,
                             "lev2.in_bytes": c.numel() + 4 * c.shape[0] + 16 * n_jobs}


@pytest.mark.cuda
def test_rowblock_scan_reads_back_twice(cuda_device, monkeypatch):
    """``_neighbor_pairs_rowblock`` on the card: no [TI, TJ] distance
    matrix (kernel I's full-DP forms never launch), no ``torch.nonzero``,
    two host readbacks (the count with the cells, then the hits), and the
    CPU's pairs."""
    from sarlacc_tpu_torch.ops import cuda_lev2, levenshtein

    rng = np.random.default_rng(5)
    codes, lengths = _umi_rows(rng, 2500, 30, 0.02, 26)
    reads = []
    real_cpu, real_int, real_tolist = torch.Tensor.cpu, torch.Tensor.__int__, torch.Tensor.tolist

    def cpu(self, *a, **kw):
        reads.append("cpu") if self.is_cuda else None
        return real_cpu(self, *a, **kw)

    def to_int(self):
        reads.append("int") if self.is_cuda else None
        return real_int(self)

    def tolist(self):
        reads.append("tolist") if self.is_cuda else None
        return real_tolist(self)

    def no_nonzero(*a, **kw):
        raise AssertionError("torch.nonzero on the scan")

    full = cuda_lev2.LEV2_KERNEL.launches
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    monkeypatch.setattr(torch.Tensor, "__int__", to_int)
    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    monkeypatch.setattr(torch, "nonzero", no_nonzero)
    gi, gj = levenshtein._neighbor_pairs_rowblock(codes, lengths, 4, 2, 512, cuda_device)
    monkeypatch.undo()
    assert reads == ["tolist", "cpu"] and cuda_lev2.LEV2_KERNEL.launches == full
    wi, wj = levenshtein._neighbor_pairs_rowblock(codes, lengths, 4, 2, 512, "cpu")
    assert np.array_equal(gi, wi) and np.array_equal(gj, wj)


@pytest.mark.cuda
def test_dual_sparse_lists_on_card_match_cpu(cuda_device, monkeypatch):
    """Two UMIs over 3 000 reads of 600 strings each, past ``SPARSE_MIN``
    (forced to 64): the neighbour lists built and intersected on the card
    equal the same call's on the CPU element for element, the groups
    equal the CPU's, and the pre-group counts one device intersection."""
    from sarlacc_tpu_torch.api import umi
    from sarlacc_tpu_torch.utils import profiling

    rng = np.random.default_rng(23)
    batches = []
    for _ in range(2):
        codes, lengths = _umi_rows(rng, 600, 22, 0.02, 16)
        pick = rng.integers(0, 600, 3000)
        batches.append(SeqBatch(codes[pick].astype(np.int8), lengths[pick]))
    (c1, l1), (c2, l2) = ((b.codes.astype(np.int32), b.lengths) for b in batches)
    got = umi._dual_sparse_csr(c1, l1, 3, c2, l2, 3, cuda_device)
    want = umi._dual_sparse_csr(c1, l1, 3, c2, l2, 3, torch.device("cpu"))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert want[0].size > 3000

    monkeypatch.setattr(umi, "SPARSE_MIN", 64)
    prof = profiling.PipelineProfiler()
    monkeypatch.setattr(profiling, "_GLOBAL", prof)
    on_card = umi.umi_group(batches[0], 3, batches[1], 3, device=cuda_device)
    assert prof.counters["umi.intersect.device"] == 1
    assert prof.counters["umi.intersect.kept"] == want[0].size
    on_cpu = umi.umi_group(batches[0], 3, batches[1], 3, device="cpu")
    assert [g.tolist() for g in on_card] == [g.tolist() for g in on_cpu]


@pytest.mark.cuda
def test_plain_scans_never_see_a_card_tensor(cuda_device, monkeypatch):
    """adaptor_align, quality_align, multi_read_align (device library) and
    umi_group (the dense matrix and the row-block scan) on the card launch
    kernels G, H and I, and the plain walks, extension and Levenshtein
    scan, made to raise on a CUDA tensor, are never reached."""
    import sarlacc_tpu_torch as st
    from sarlacc_tpu_torch.ops import backtrack, cuda_backtrack, cuda_extend, cuda_lev2, levenshtein

    for owner, name in ((backtrack, "_qmap_walk_plain"), (backtrack, "_string_walk_plain"),
                        (port_msa, "_extend_chunk_plain"), (port_msa, "_extend_library_plain"),
                        (levenshtein, "_lev2_scan"), (levenshtein, "_rowblock_hits_plain")):
        real = getattr(owner, name)

        def guard(first, *rest, _real=real, _name=name):
            if first.is_cuda:
                raise AssertionError(f"{_name} got a CUDA tensor")
            return _real(first, *rest)

        monkeypatch.setattr(owner, name, guard)
    monkeypatch.delenv("SARLACC_HOST_LIB", raising=False)
    kernels = (cuda_backtrack.QMAP_KERNEL, cuda_backtrack.STRING_KERNEL,
               cuda_extend.EXTEND_KERNEL, cuda_lev2.LEV2_KERNEL, cuda_lev2.HITS_KERNEL)
    before = [k.launches for k in kernels]

    rng = np.random.default_rng(12)
    seqs, groups = [], []
    for n, length in ((6, 150), (3, 90), (9, 240)):
        ref = rng.integers(0, 4, length)
        groups.append(list(range(len(seqs), len(seqs) + n)))
        for _ in range(n):
            s = ref.copy()
            mut = rng.random(length) < 0.06
            s[mut] = rng.integers(0, 4, int(mut.sum()))
            seqs.append("".join("ACGT"[c] for c in s[rng.random(length) >= 0.03]))
    batch = SeqBatch.from_strings(seqs, ["I" * len(s) for s in seqs])
    aligned = st.adaptor_align(ADAPTOR, ADAPTOR2, reads=batch, tolerance=100, device=cuda_device)
    qal = st.quality_align(batch, seqs[0][:80], device=cuda_device)
    msa = st.multi_read_align(batch, groups=groups, bandwidth=30, device=cuda_device)
    small = SeqBatch.from_strings(
        ["".join(rng.choice(list("ACGTN"), 12, p=[0.24] * 4 + [0.04])) for _ in range(60)])
    dense = st.umi_group(small, threshold1=2, device=cuda_device)
    umis = SeqBatch.from_strings(["".join(rng.choice(list("ACGT"), 30)) for _ in range(2100)])
    scanned = st.umi_group(umis, threshold1=2, device=cuda_device)
    after = [k.launches for k in kernels]
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert len(aligned) == len(seqs) and len(qal) == len(seqs)
    assert [len(a) for a in msa["alignments"]] == [6, 3, 9]
    assert sum(len(g) for g in dense) == 60 and sum(len(g) for g in scanned) == 2100


@pytest.mark.cuda
def test_walk_extend_lev2_kernel_resources(cuda_device):
    """Kernels G, H and I as compiled fit the SM and spill nothing."""
    from sarlacc_tpu_torch.ops import cuda_backtrack, cuda_extend, cuda_lev2

    res = {**cuda_backtrack.backtrack_kernel_resources(), **cuda_extend.extend_kernel_resources(),
           **cuda_lev2.lev2_kernel_resources()}
    print({name: (r["registers"], r["spill_bytes"], r["blocks_per_sm"]) for name, r in res.items()})
    assert sorted(res) == sorted(["G:qmap", "G:string", "H:count", "H:write", "H:scan",
                                  "I:reg32", "I:scratch", "I:band_reg", "I:band_scratch"])
    for name, r in res.items():
        assert 0 < r["registers"] <= 255 and r["blocks_per_sm"] >= 1, name
        assert r["spill_bytes"] == 0, (name, r)


# ---------------------------------------------------------------- error profiling


def _amplicon_reads(rng, template: str, n: int):
    """``n`` reads copying ``template`` with mockReads' errors (5%
    substitutions, then 1% of bases deleted or repeated 2-5 times) and
    Phred+33 qualities, one of them empty and one longer than the template."""
    t = np.frombuffer(template.encode(), np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = []
    for _ in range(n - 2):
        s = np.where(rng.random(t.size) < 0.05, acgt[rng.integers(0, 4, t.size)], t)
        reps = np.where(rng.random(t.size) < 0.01, rng.choice([0, 2, 3, 4, 5], t.size), 1)
        seqs.append(np.repeat(s, reps).tobytes().decode())
    seqs += ["", template + "ACGT" * 40]
    quals = [np.full(len(s), 33, np.uint8) + rng.integers(2, 40, len(s)).astype(np.uint8)
             for s in seqs]
    return SeqBatch.from_strings(seqs, [q.tobytes().decode() for q in quals])


@pytest.mark.cuda
def test_quality_align_chunk_past_2_31_cells(cuda_device):
    """One kernel-A launch of quality_align's chunk shape at R 4 400 over
    ~110 reads: more than 2^31 direction cells, several passes through the
    hand-off scratch; directions and S equal to dp_align on the card, and
    kernel G's emissions equal the plain walk's on the CPU for a sample of
    lanes."""
    from sarlacc_tpu_torch.ops.backtrack import _string_walk_plain, string_walk

    rng = np.random.default_rng(24)
    template = "".join(rng.choice(list("ACGT"), 4400))
    batch = _amplicon_reads(rng, template, 110)
    ad = prepare_adaptor(template, device=cuda_device)
    codes, qidx, lengths = prepare_reads(batch, ad.tables, device=cuda_device)
    l1, n_pad = plane_dims(*codes.shape)
    assert 4400 * l1 * n_pad > 2**31 and cuda_align.dir_plan(4400, False, n_pad)[2] > 1
    planes = build_cost_planes(codes, qidx, ad.match_tab, ad.mismatch_tab, l1, n_pad)
    args = (ad.modes, encode_mask(ad.matched), 5.0, 1.0, *planes, False)
    s_k, d_k = dir_kernel(*args)
    s_p, d_p = dp_align(*args)
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_p)
    assert torch.equal(d_k, d_p)
    del d_p
    a_k, b_k, n_k = string_walk(d_k, lengths)
    lanes = torch.tensor([0, 1, 37, 64, 107, 108, 109, 300], device=cuda_device)
    a_p, b_p, n_p = _string_walk_plain(d_k[:, :, lanes].cpu(), lengths[lanes[:7]].cpu())
    assert torch.equal(n_k[lanes].cpu(), n_p)
    for k in range(lanes.numel()):
        m = int(n_p[k])
        assert torch.equal(a_k[lanes[k], :m].cpu(), a_p[k, :m]), k
        assert torch.equal(b_k[lanes[k], :m].cpu(), b_p[k, :m]), k


@pytest.mark.cuda
def test_quality_align_chunked_on_card_equals_one_launch(cuda_device, monkeypatch):
    """300 reads against 500 bp: one launch (the whole batch fits) and
    chunks of 64 lanes under a forced budget give the same frame."""
    import importlib

    import sarlacc_tpu_torch as st

    qa_mod = importlib.import_module("sarlacc_tpu_torch.api.quality_align")
    rng = np.random.default_rng(25)
    template = "".join(rng.choice(list("ACGT"), 500))
    batch = _amplicon_reads(rng, template, 300)
    whole = st.quality_align(batch, template, device=cuda_device)
    L = int(batch.lengths.max())
    budget = 64 * qa_mod.lane_bytes(500, plane_dims(1, L)[0])
    monkeypatch.setattr(qa_mod, "_plan_budget", lambda dev: budget)
    chunked = st.quality_align(batch, template, device=cuda_device)
    for col in ("score", "edit"):
        np.testing.assert_array_equal(chunked[col], whole[col])
    assert list(chunked["reference"]) == list(whole["reference"])
    assert list(chunked["query"]) == list(whole["query"])


@pytest.mark.cuda
def test_profile_tallies_on_card_equal_refimpl(cuda_device):
    """256 reads of the error-profiling cell's shape (4 400-bp template,
    mockReads' errors): the tallies from the strings' planes on the card
    equal find_errors and match_homopolymers, and error_finder and
    homopolymer_matcher give the same frames on the card (a quality_align
    frame tallies on its card) and on the CPU."""
    import sarlacc_tpu_torch as st
    from sarlacc_tpu_torch.ops.profile import alignment_planes, walk_errors, walk_homopolymers
    from sarlacc_tpu_torch.refimpl.errors import find_errors
    from sarlacc_tpu_torch.refimpl.homopolymer import match_homopolymers

    rng = np.random.default_rng(26)
    template = "".join(rng.choice(list("ACGT"), 4400))
    out = st.quality_align(_amplicon_reads(rng, template, 256), template, device=cuda_device)
    assert out.device.type == "cuda"
    refs, queries = list(out["reference"]), list(out["query"])
    planes = alignment_planes(refs, queries, cuda_device)
    want = find_errors(refs, queries)
    got = walk_errors(planes)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    for got_col, want_col in zip(walk_homopolymers(planes), match_homopolymers(refs, queries)):
        assert got_col.is_cuda and got_col.cpu().tolist() == list(want_col)
    for fn in (st.error_finder, st.homopolymer_matcher):
        a, b = fn(out), fn((refs, queries), device="cpu")
        assert a.colnames == b.colnames
        for col in a.colnames:
            x, y = a[col], b[col]
            assert (np.array_equal(x, y) if isinstance(y, np.ndarray) else list(x) == list(y)), col
        for key in b.metadata:
            np.testing.assert_array_equal(a.metadata[key], b.metadata[key])

"""Kernels C and D's loop order, proven on the CPU.

``csrc/score_kernel.cu`` runs each (read, segment) DP rows outer and
columns inner, inside column tiles of ``TJ`` columns: the previous row's S
and each column's running vertical-gap max per tile column, the left S and
H carried along the row, the fitting-mode last column peeled off the tiles,
a tile's last column handed to the next tile through a scratch slot, and
each cell's cost read from a per-row table at an offset staged per
(code, column).  The kernel's power-of-two column blocks only unroll the
tile's column loop in the same order.  :func:`tiled_scores` transliterates
that schedule in float32 numpy, vectorised over the reads (every read runs
the same scalar steps), and the tests hold it bit for bit (tolerance 0) to the port's plain
``dp_scores_segments`` / ``dp_scores`` and to the Pallas ``_segments_kernel``
/ ``_kernel`` in interpret mode.  The JAX side runs in float32.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from sarlacc_tpu.api.align_internal import prepare_adaptor as jax_prepare_adaptor  # noqa: E402
from sarlacc_tpu.core.encode import SeqBatch  # noqa: E402
from sarlacc_tpu.ops import pallas_align as pa  # noqa: E402
from sarlacc_tpu.ops.align import prepare_reads as jax_prepare_reads  # noqa: E402
from sarlacc_tpu_torch.api.align_internal import prepare_adaptor  # noqa: E402
from sarlacc_tpu_torch.core.encode import SeqBatch as TSeqBatch  # noqa: E402
from sarlacc_tpu_torch.ops.align import (  # noqa: E402
    dp_scores,
    dp_scores_segments,
    prepare_reads,
    segments_from_numpy,
)
from sarlacc_tpu_torch.ops import cuda_align  # noqa: E402
from sarlacc_tpu_torch.ops.cuda_align import (  # noqa: E402
    SCORE_TILES,
    build_cost_planes,
    cost_slots,
    encode_mask,
    launch_groups,
    pack_segments,
    plane_dims,
    score_tile,
)

NEG = np.float32(-3.0e38)
ADAPTOR1 = "ACGCTAGCATCAGTCNNNNCACAGCTACGANNNNNNNNCGTACGCAT" + "NNNN"  # R = 51
ADAPTOR2 = "TGCATCGATCGCAT"  # R = 14
BARCODE = "ACGTTGCACGTA"  # R = 12
LONG = "ACGTRYKMSWBDHVN" * 4 + "GATTACAGATTA"  # R = 72: every IUPAC class
L = 63  # l1 = 64: the longest read sits in row l1 - 1


def tiled_scores(modes, mask, segs, costm, costmm, codes_k, lens_k, tj):
    """The kernels' schedule in float32 numpy: f32 [nseg, n] of S at row
    ``lens_k`` after each segment's last column.  Arguments as
    ``dp_scores_segments`` (numpy), ``tj`` the tile width."""
    f32 = np.float32
    l1, n = codes_k.shape
    lens = np.clip(lens_k, 0, l1 - 1)
    lanes = np.arange(n)
    code_row = np.minimum(codes_k.astype(np.int64), 7)  # codes >= 5 never match
    out = np.zeros((len(segs), n), f32)
    for s, (start, rlen, local, gap_open, gap_ext) in enumerate(segs):
        go, ge = f32(gap_open) + f32(gap_ext), f32(gap_ext)
        md = np.clip(modes[start : start + rlen], 1, 4) - 1
        mk = mask[start : start + rlen]
        peel = local and rlen > 0
        rn = rlen - int(peel)
        ntiles = -(-rn // tj) if rn > tj else 1
        bS = np.zeros((l1, n), f32)  # the hand-off slot, overwritten in place
        bH = np.zeros((l1, n), f32)
        res = np.zeros(n, f32)
        for t in range(ntiles):
            j0 = t * tj
            tl = min(tj, rn - j0)
            last = t == ntiles - 1
            zv = peel and last
            cols = list(range(j0, j0 + tl)) + ([rlen - 1] if zv else [])
            # koff: the row-table slot of (code, tile column).
            koff = np.array(
                [[md[j] if (mk[j] >> c) & 1 else 4 + md[j] for j in cols] for c in range(8)],
                dtype=np.int64,
            ).reshape(8, len(cols))
            need = sorted(set(koff.ravel().tolist()))
            pS = [np.full(n, NEG) for _ in range(tl)]
            cum = [np.full(n, NEG) for _ in range(tl)]
            cumZ = np.full(n, NEG)
            dL = np.full(n, NEG)
            for i in range(int(lens.max()) + 1):
                fi = f32(i)
                rge = fi * ge
                rge1 = (fi - f32(1.0)) * ge
                if t == 0:
                    v0 = f32(0.0) if (local or i == 0) else (-go) - rge1
                    sL, hL = np.full(n, v0, f32), np.full(n, NEG)
                else:
                    sL, hL = bS[i].copy(), bH[i].copy()
                diag, dL = dL, sL
                tab = np.zeros((8, n), f32)
                for k in need:
                    tab[k] = (costm if k < 4 else costmm)[k & 3, i]
                kr = koff[code_row[i]]  # [n, tile columns]
                for jj in range(tl):
                    cost = tab[kr[:, jj], lanes]
                    Hn = np.maximum(sL - go, hL - ge)
                    mv = np.maximum(diag + cost, Hn)
                    V = cum[jj] - rge1
                    B = (mv - go) + rge
                    sv = np.maximum(mv, V)
                    diag, pS[jj] = pS[jj], sv
                    cum[jj] = np.maximum(cum[jj], B)
                    sL, hL = sv, Hn
                if zv:
                    cost = tab[kr[:, tl], lanes]
                    Hn = np.maximum(sL - go, hL - ge)
                    mv = np.maximum(diag + cost, Hn)
                    sL, hL = np.maximum(mv, cumZ), Hn
                    cumZ = np.maximum(cumZ, mv)
                if not last:
                    bS[i], bH[i] = sL, hL
                else:
                    res = np.where(lens == i, sL, res)
        out[s] = res
    return out


def _batch(seed, n=23):
    """n reads of 0..L bases (ACGTN) with qualities; one of length 0 and one
    of length L = l1 - 1."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, n)
    lens[0], lens[1] = 0, L
    seqs = ["".join(rng.choice(list("ACGTN"), int(k))) for k in lens]
    quals = ["".join(chr(int(c)) for c in rng.integers(33, 91, int(k))) for k in lens]
    return SeqBatch.from_strings(seqs, quals), TSeqBatch.from_strings(seqs, quals)


def _port_inputs(tb, tables):
    codes, qidx, lengths = prepare_reads(tb, tables)
    l1, n_pad = plane_dims(tb.codes.shape[0], L)
    full = torch.full((codes.shape[0], L), 5, dtype=torch.int8)
    full[:, : codes.shape[1]] = codes
    fullq = torch.zeros((codes.shape[0], L), dtype=torch.int8)
    fullq[:, : qidx.shape[1]] = qidx
    mt = torch.as_tensor(np.asarray(tables.match, np.float32))
    mmt = torch.as_tensor(np.asarray(tables.mismatch, np.float32))
    planes = build_cost_planes(full, fullq, mt, mmt, l1, n_pad)
    assert l1 == L + 1
    lens_k = torch.zeros(n_pad, dtype=torch.int32)
    lens_k[: lengths.shape[0]] = lengths
    return planes, lengths, lens_k, l1, n_pad


def _jax_planes(jb, tables):
    codes, qidx, lengths = jax_prepare_reads(jb, tables)
    l1, n_pad = pa.plane_dims(*codes.shape)
    planes = pa.build_cost_planes(
        jnp.asarray(codes, jnp.int8), jnp.asarray(qidx, jnp.int8),
        jnp.asarray(tables.match, jnp.float32), jnp.asarray(tables.mismatch, jnp.float32),
        l1=l1, n_pad=n_pad,
    )
    return planes, jnp.asarray(lengths, jnp.int32), l1, n_pad


#: (reference, gap open, gap extension, fitting mode): mixed penalties and
#: modes; R = 72 and 51 cross tiles of 32 or less with a partial last tile,
#: R = 1 in fitting mode is the peeled column alone.
SEGMENTS = [
    (LONG, 5.0, 1.0, False),
    (ADAPTOR1, 6.0, 1.0, True),
    (ADAPTOR2, 4.0, 2.0, True),
    (BARCODE, 3.0, 1.5, False),
    ("G", 5.0, 1.0, True),
    (LONG, 7.0, 3.0, True),
]


def _jax_segments(segments):
    out = []
    for ref, go, ge, local in segments:
        ad = jax_prepare_adaptor(ref)
        out.append((ad.modes, ad.matched, go, ge, local))
    return out


@pytest.fixture(scope="module")
def segment_case():
    """The reads, the port's packed segments and planes, and the Pallas
    ``_segments_kernel``'s scores (interpret mode), computed once."""
    jb, tb = _batch(41)
    tables = jax_prepare_adaptor(BARCODE).tables
    jsegs = _jax_segments(SEGMENTS)
    jplanes, jlens, jl1, jn_pad = _jax_planes(jb, tables)
    want_jax = np.asarray(pa.fit_scores_segments(
        jplanes, jlens, jsegs, l1=jl1, n_pad=jn_pad, interpret=True,
    ))
    planes, lengths, lens_k, l1, n_pad = _port_inputs(tb, tables)
    modes, mask, segs = pack_segments(segments_from_numpy(jsegs), "cpu")
    return planes, lengths, lens_k, modes, mask, segs, want_jax


def _numpy(*tensors):
    return [t.numpy() for t in tensors]


@pytest.mark.parametrize("tj", [1, 3, 32, *SCORE_TILES])
def test_tiled_order_equals_plain_and_pallas_segments(segment_case, tj):
    """Kernel D's schedule: every segment, every read (padded lanes
    included) equal to ``dp_scores_segments``; the reads equal to the Pallas
    ``_segments_kernel``."""
    (costm, costmm, codes_k), lengths, lens_k, modes, mask, segs, want_jax = segment_case
    got = tiled_scores(*_numpy(modes, mask), segs, *_numpy(costm, costmm, codes_k, lens_k), tj)
    plain = dp_scores_segments(modes, mask, segs, costm, costmm, codes_k, lens_k).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got[:, : lengths.shape[0]], want_jax)


@pytest.mark.parametrize("tj", [1, 3, 32])
def test_tiled_order_with_empty_segments(tj):
    """An empty segment first (global: column 0's ramp) and another later
    (fitting: zeros) leave the other segments' scores alone.  No JAX side:
    the Pallas ``fit_scores_segments`` shifts later masks after an empty
    segment (ROADMAP Queue 3)."""
    _, tb = _batch(43)
    empty, bc, a2 = prepare_adaptor(""), prepare_adaptor(BARCODE), prepare_adaptor(ADAPTOR2)
    (costm, costmm, codes_k), _, lens_k, _, _ = _port_inputs(tb, bc.tables)
    segments = [
        (empty.modes, empty.matched, 5.0, 1.0, False),
        (a2.modes, a2.matched, 4.0, 2.0, True),
        (empty.modes, empty.matched, 5.0, 1.0, True),
        (bc.modes, bc.matched, 3.0, 1.0, False),
    ]
    modes, mask, segs = pack_segments(segments, "cpu")
    got = tiled_scores(*_numpy(modes, mask), segs, *_numpy(costm, costmm, codes_k, lens_k), tj)
    plain = dp_scores_segments(modes, mask, segs, costm, costmm, codes_k, lens_k).numpy()
    np.testing.assert_array_equal(got, plain)
    assert not got[2].any()  # fitting mode, no columns: zeros


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("tj", [1, 3, 32])
def test_tiled_order_equals_plain_and_pallas_kernel(local, tj):
    """Kernel C's schedule (one segment, R = 72) against ``dp_scores`` and
    the Pallas ``_kernel`` (interpret)."""
    jb, tb = _batch(47 + local, n=17)
    jad = jax_prepare_adaptor(LONG)
    jplanes, jlens, jl1, jn_pad = _jax_planes(jb, jad.tables)
    want_jax = np.asarray(pa.fit_scores_from_planes(
        jplanes, jlens, jad.modes, jad.matched, 6.0, 2.0,
        l1=jl1, n_pad=jn_pad, local=local, interpret=True,
    ))
    ad = prepare_adaptor(LONG)
    (costm, costmm, codes_k), lengths, lens_k, _, _ = _port_inputs(tb, ad.tables)
    mask = encode_mask(ad.matched)
    segs = [(0, len(LONG), local, 6.0, 2.0)]
    got = tiled_scores(*_numpy(ad.modes, mask), segs, *_numpy(costm, costmm, codes_k, lens_k), tj)[0]
    S = dp_scores(ad.modes, mask, 6.0, 2.0, costm, costmm, codes_k, local)
    plain = S.gather(0, lens_k.long()[None, :])[0].numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got[: lengths.shape[0]], want_jax)


def test_tile_width_and_slots_follow_the_ordinary_columns():
    """A launch takes the narrowest compiled tile that holds its widest
    segment's ordinary columns (fitting mode peels the last); only wider
    segments get a hand-off slot, numbered in order."""
    assert SCORE_TILES == (15, 31, 63)
    assert score_tile([]) == 15
    assert score_tile([(0, 12, False), (0, 16, True)]) == 15  # barcodes; 15 + peeled
    assert score_tile([(0, 14, True), (0, 16, False)]) == 31
    assert score_tile([(0, 51, True), (0, 14, True)]) == 63  # the adaptors
    segs = [(0, 63, False), (0, 64, True), (0, 64, False), (0, 0, True), (0, 200, True)]
    assert score_tile(segs) == 63
    assert launch_groups(segs, 63, 256, 19_968) == [(0, 5, [-1, -1, 0, -1, 1])]
    assert launch_groups([(0, 20, False), (0, 16, True)], 15, 32, 512) == [(0, 2, [0, -1])]
    assert launch_groups([], 15, 32, 512) == []


@pytest.mark.parametrize(
    "max_segments,slot_budget,want",
    [
        # 35 wide segments at 100 000 reads x l1 256: the default 512 MiB
        # holds two 205 MB slots a launch.
        (65535, None, [(2 * k, min(2 * k + 2, 35)) for k in range(18)]),
        (65535, 1, [(k, k + 1) for k in range(35)]),
        (65535, 13, [(0, 13), (13, 26), (26, 35)]),
        (10, 64, [(0, 10), (10, 20), (20, 30), (30, 35)]),
    ],
)
def test_launch_groups_bound_the_scratch(monkeypatch, max_segments, slot_budget, want):
    """Kernel D's wide segments run concurrently, one hand-off slot each:
    a call splits into launches whose slots fit MAX_SCRATCH_BYTES (one at
    least) and whose segments fit MAX_SEGMENTS, numbering slots from 0 in
    each launch so that every launch reuses the same buffer."""
    l1, n_pad = 256, 100_352
    slot = 2 * l1 * n_pad * 4
    monkeypatch.setattr(cuda_align, "MAX_SEGMENTS", max_segments)
    if slot_budget is not None:
        monkeypatch.setattr(cuda_align, "MAX_SCRATCH_BYTES", slot_budget * slot)
    segs = [(0, 150, k % 2 == 0) for k in range(35)]
    groups = launch_groups(segs, 63, l1, n_pad)
    assert [(s0, s1) for s0, s1, _ in groups] == want
    for s0, s1, slots in groups:
        assert slots == list(range(s1 - s0))
        assert len(slots) * slot <= max(slot, cuda_align.MAX_SCRATCH_BYTES)
    # Narrow segments take no slot and do not count against the budget.
    mixed = [(0, 14, True), (0, 150, False), (0, 12, False), (0, 150, True)]
    monkeypatch.setattr(cuda_align, "MAX_SEGMENTS", 65535)
    monkeypatch.setattr(cuda_align, "MAX_SCRATCH_BYTES", slot)
    assert launch_groups(mixed, 63, l1, n_pad) == [(0, 3, [-1, 0, -1]), (3, 4, [0])]


@pytest.mark.parametrize("ref,nslots", [(ADAPTOR2, 2), (BARCODE, 2), (ADAPTOR1, 4), (LONG, 7)])
def test_cost_slots_are_all_the_planes_the_dp_reads(ref, nslots):
    """The cost slots that chip_smoke.py counts as the kernels' compulsory
    reads: with every other slot of both planes poisoned, the plain DP
    gives the same bits.  A reference of ACGT selects one match and one
    mismatch slot."""
    _, tb = _batch(len(ref), n=40)
    ad = prepare_adaptor(ref)
    (costm, costmm, codes_k), *_ = _port_inputs(tb, ad.tables)
    mask = encode_mask(ad.matched)
    slots = cost_slots(ad.modes, mask)
    assert len(slots) == nslots and all(0 <= k < 8 for k in slots)
    planes = torch.cat([costm, costmm])
    poisoned = torch.full_like(planes, float("nan"))
    poisoned[slots] = planes[slots]
    for local in (True, False):
        want = dp_scores(ad.modes, mask, 5.0, 1.0, costm, costmm, codes_k, local)
        got = dp_scores(ad.modes, mask, 5.0, 1.0, poisoned[:4], poisoned[4:], codes_k, local)
        assert torch.equal(got, want)

"""Kernel A's schedule, proven on the CPU.

``csrc/dir_kernel.cu`` runs each read's direction DP in G lanes of a warp:
the reference's ordinary columns are cut into passes x G column tiles of
near-equal width, lane g owns tile p*G + g of pass p and computes row s - g
at step s (rows outer, its tile's columns inner), and at the end of a step
hands its tile's last column (S, H, the left jump point and left-step
flag) to lane g + 1, which uses it one step later; lane 0 of a later pass
reads the boundary lane G - 1 of the pass before wrote to an in-place
scratch.  Per column the lane keeps the previous row's S, the running max of
B and the vertical run's jump point packed with the next row's vertical
test; the fitting-mode last column is peeled off the tiles.  Each cell's
cost comes from a per-row table at an offset staged per (tile, code,
column).

:func:`tiled_dirs` transliterates that schedule in float32 numpy,
vectorised over the reads (every read runs the same scalar steps), with the
lanes, the step skew, the one-step hand-off and the scratch written out, and
the tests hold it bit for bit (tolerance 0), directions and scores, to the
port's plain ``dp_align`` and to the Pallas ``_dir_kernel`` in interpret
mode.  The JAX side runs in float32.
"""

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402,F401  (JAX before the Pallas module)

from sarlacc_tpu.api.align_internal import prepare_adaptor as jax_prepare_adaptor  # noqa: E402
from sarlacc_tpu.core.encode import SeqBatch  # noqa: E402
from sarlacc_tpu.ops.align import prepare_reads as jax_prepare_reads  # noqa: E402
from sarlacc_tpu.ops.pallas_align import fit_dirs_pallas  # noqa: E402
from sarlacc_tpu_torch.api.align_internal import prepare_adaptor  # noqa: E402
from sarlacc_tpu_torch.core.encode import SeqBatch as TSeqBatch  # noqa: E402
from sarlacc_tpu_torch.ops.align import dp_align, prepare_reads, prepared_from_numpy  # noqa: E402
from sarlacc_tpu_torch.ops import cuda_align  # noqa: E402
from sarlacc_tpu_torch.ops.cuda_align import (  # noqa: E402
    DIR_TILES,
    build_cost_planes,
    dir_plan,
    encode_mask,
    plane_dims,
)

NEG = np.float32(-3.0e38)
ADAPTOR1 = "ACGCTAGCATCAGTCNNNNCACAGCTACGANNNNNNNNCGTACGCAT" + "NNNN"  # R = 51
ADAPTOR2 = "TGCATCGATCGCAT"  # R = 14
LONG = "ACGTRYKMSWBDHVN" * 4 + "GATTACAGATTA"  # R = 72: every IUPAC class
L = 50  # read lengths 0..L; l1 = 64


def tiled_dirs(modes, mask, gap_open, gap_ext, costm, costmm, codes_k, local, tj, G, passes):
    """Kernel A's schedule in float32 numpy: (S f32 [l1, n] after the last
    column, dirs int16 [R, l1, n]).  Arguments as ``dp_align`` (numpy) and
    the launch's (tile width, lanes a read, passes)."""
    f32 = np.float32
    l1, n = codes_k.shape
    R = len(modes)
    go, ge = f32(gap_open) + f32(gap_ext), f32(gap_ext)
    md = np.clip(modes, 1, 4) - 1
    peel = bool(local) and R > 0
    rn = R - int(peel)
    T = passes * G
    assert T * tj >= rn, "the tiles do not cover the columns"
    start = [t * rn // T for t in range(T + 1)]
    code_row = np.minimum(codes_k.astype(np.int64), 7)  # codes >= 5 never match
    lanes = np.arange(n)
    S_out = np.zeros((l1, n), f32)
    dirs = np.zeros((R, l1, n), np.int16)
    scratch = {}  # row -> (S, H, ljp << 1 | wl): the in-place pass hand-off

    def slot(j, c):
        return md[j] if (mask[j] >> c) & 1 else 4 + md[j]

    for p in range(passes):
        lane = []
        for g in range(G):
            t = p * G + g
            j0, tl = start[t], start[t + 1] - start[t]
            assert tl <= tj
            zv = peel and t == T - 1
            cols = list(range(j0, j0 + tl)) + ([R - 1] if zv else [])
            koff = np.array([[slot(j, c) for j in cols] for c in range(8)], np.int64)
            lane.append(dict(
                t=t, j0=j0, tl=tl, zv=zv, koff=koff.reshape(8, len(cols)),  # [code, column]
                need=sorted(set(koff.ravel().tolist())),
                pS=[np.full(n, NEG) for _ in range(tl)],
                cum=[np.full(n, NEG) for _ in range(tl)],
                pu=[np.ones(n, np.int64) for _ in range(tl)],
                cumZ=np.full(n, NEG), puZ=np.ones(n, np.int64), dL=np.full(n, NEG),
            ))
        recv = [None] * G  # what each lane received from lane g - 1 last step
        for s in range(l1 + G - 1):
            sent = [None] * G
            for g, st in enumerate(lane):
                i = s - g
                if not 0 <= i < l1:
                    continue
                fi = f32(i)
                rge = fi * ge
                rge1 = (fi - f32(1.0)) * ge
                if g > 0:
                    sL, hL, packed = recv[g]
                    wl, ljp = (packed & 1) == 1, packed >> 1
                elif p == 0:  # column 0
                    v0 = f32(0.0) if (local or i == 0) else (-go) - rge1
                    sL, hL = np.full(n, v0, f32), np.full(n, NEG)
                    wl, ljp = np.zeros(n, bool), np.zeros(n, np.int64)
                else:
                    sL, hL, packed = scratch[i]
                    wl, ljp = (packed & 1) == 1, packed >> 1
                diag, st["dL"] = st["dL"], sL
                tab = np.zeros((8, n), f32)
                for k in st["need"]:
                    tab[k] = (costm if k < 4 else costmm)[k & 3, i]
                kr = st["koff"][code_row[i]]  # [n, tile columns]
                for jj in range(st["tl"] + int(st["zv"])):
                    j = st["j0"] + jj
                    cost = tab[kr[:, jj], lanes]
                    peeled = jj == st["tl"]
                    vgo, vge = (f32(0.0), f32(0.0)) if peeled else (go, ge)
                    cum = st["cumZ"] if peeled else st["cum"][jj]
                    pu = st["puZ"] if peeled else st["pu"][jj]
                    M = diag + cost
                    cand_h = sL - np.where(wl, ge, go)
                    jump_h = hL - ge
                    cond_h = cand_h >= jump_h
                    Hn = np.where(cond_h, cand_h, jump_h)
                    mv = np.maximum(M, Hn)
                    if i == 0:
                        V = np.full(n, NEG)
                    else:
                        V = cum if peeled else cum - rge1
                    B = mv if peeled else (mv - go) + rge
                    Sn = Hn if i == 0 else np.maximum(mv, V)
                    is_diag = (M > Hn) & (M > V)
                    is_left = ~is_diag & (Hn > V)
                    is_up = ~(is_diag | is_left)
                    ljp = np.where(cond_h, j, ljp)
                    pnt = np.where((pu & 1) == 1, i, pu >> 1)
                    d = np.where(is_diag, 0, np.where(is_left, (j + 1) - ljp, pnt - (i + 1)))
                    dirs[j, i] = 1 if i == 0 else d
                    next_v = (Sn - np.where(is_up, vge, vgo)) >= (V - vge)
                    pu = (pnt << 1) | next_v
                    cum = np.maximum(cum, B)
                    if peeled:
                        st["cumZ"], st["puZ"] = cum, pu
                    else:
                        st["cum"][jj], st["pu"][jj] = cum, pu
                        diag, st["pS"][jj] = st["pS"][jj], Sn
                    sL, hL, wl = Sn, Hn, is_left | (i == 0)
                packed = (ljp << 1) | wl
                if st["t"] == T - 1:
                    S_out[i] = sL
                elif g == G - 1:
                    scratch[i] = (sL, hL, packed)
                sent[g] = (sL, hL, packed)
            recv = [None] + sent[:-1]  # __shfl_up_sync by one tile
    return S_out, dirs


def _strings(seed, n):
    """n reads of 0..L bases (ACGTN) with qualities; read 0 is empty and
    read 1 is L long."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, L + 1, n)
    lens[0], lens[1] = 0, L
    seqs = ["".join(rng.choice(list("ACGTN"), int(k))) for k in lens]
    quals = ["".join(chr(int(c)) for c in rng.integers(35, 90, int(k))) for k in lens]
    return seqs, quals


@functools.lru_cache(maxsize=None)
def _case(ref, local, pallas=True):
    """The port's planes for 23 reads (n_pad 512: not a multiple of any
    warp's reads), the plain ``dp_align`` and the Pallas ``_dir_kernel``
    (interpret mode) on them; computed once a (reference, mode)."""
    seqs, quals = _strings(len(ref) + 7 * local, 23)
    jb, tb = SeqBatch.from_strings(seqs, quals), TSeqBatch.from_strings(seqs, quals)
    jad = jax_prepare_adaptor(ref)
    modes, matched, mt, mmt = prepared_from_numpy(
        jad.modes, jad.matched, jad.match_tab, jad.mismatch_tab
    )
    codes, qidx, lengths = prepare_reads(tb, jad.tables)
    l1, n_pad = plane_dims(*codes.shape)
    planes = build_cost_planes(codes, qidx, mt, mmt, l1, n_pad)
    mask = encode_mask(matched)
    S, dirs = dp_align(modes, mask, 6.0, 2.0, *planes, local)
    pal = None
    if pallas:
        jcodes, jqidx, jlens = jax_prepare_reads(jb, jad.tables)
        sc, dr, pl1 = fit_dirs_pallas(
            np.asarray(jcodes), np.asarray(jqidx), np.asarray(jlens),
            jad.modes, jad.matched, jad.match_tab, jad.mismatch_tab,
            6.0, 2.0, local=local, interpret=True,
        )
        assert pl1 == l1
        pal = (np.asarray(sc), np.asarray(dr))
    args = (modes.numpy(), mask.numpy(), 6.0, 2.0, *(t.numpy() for t in planes), local)
    return args, lengths.numpy(), S.numpy(), dirs.numpy(), pal


def _plans(ref, local):
    """Kernel A's own plan at this batch and at calibration's 19 968 lanes,
    then forced ones: one tile, G tiles and more tiles than lanes at each
    width, with lanes from 1 to 32."""
    rn = max(len(ref) - int(local), 0)
    plans = [dir_plan(len(ref), local, 512), dir_plan(len(ref), local, 19_968)]
    for tj, G in [(31, 1), (15, 1), (7, 1), (31, 2), (15, 4), (7, 4), (7, 8), (15, 16), (7, 32)]:
        for passes in sorted({max(1, -(-rn // (tj * G))), 1 + -(-rn // (tj * G))}):
            plans.append((tj, G, passes))
    return list(dict.fromkeys(plans))


CASES = [
    (ref, local, plan)
    for ref, local in [(LONG, True), (LONG, False), (ADAPTOR1, True), (ADAPTOR2, False), ("G", True)]
    for plan in _plans(ref, local)
]


@pytest.mark.parametrize("ref,local,plan", CASES, ids=[
    f"R{len(r)}-{'fit' if lc else 'global'}-tj{p[0]}-G{p[1]}-x{p[2]}" for r, lc, p in CASES
])
def test_tiled_dirs_equal_plain_and_pallas(ref, local, plan):
    """Directions and S bit-equal to ``dp_align`` on every lane (padded
    ones included), directions to the Pallas kernel's plane and scores at
    the reads' lengths to its scores."""
    args, lengths, S_plain, dirs_plain, (pal_scores, pal_dirs) = _case(ref, local)
    S, dirs = tiled_dirs(*args, *plan)
    np.testing.assert_array_equal(dirs, dirs_plain)
    np.testing.assert_array_equal(S, S_plain)
    np.testing.assert_array_equal(dirs, pal_dirs)
    np.testing.assert_array_equal(S[lengths, np.arange(lengths.size)], pal_scores)


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("G", [1, 4])
def test_tiled_dirs_empty_reference(local, G):
    """No columns: S is column 0 (zeros fitting, the gap ramp global) and
    there are no directions, whatever the lanes."""
    args, _, S_plain, dirs_plain, _ = _case("", local, pallas=False)
    S, dirs = tiled_dirs(*args, 7, G, 1)
    assert dirs.shape == dirs_plain.shape == (0, 64, 512)
    np.testing.assert_array_equal(S, S_plain)


def test_plan_fills_the_card_and_covers_the_columns():
    """Lanes double while the launch is below DIR_FILL threads and each lane
    keeps DIR_MIN_COLS columns; the narrowest tile that holds a lane's
    share; passes only when G tiles of the widest do not cover the
    reference."""
    assert DIR_TILES == (7, 15, 31)
    # adaptor_align / extract_subseq: 19 968 lanes, adaptor1 and adaptor2.
    assert dir_plan(51, True, 19_968) == (31, 2, 1)
    assert dir_plan(14, True, 19_968) == (7, 2, 1)
    # quality_align: 300 reads (512 lanes) against 500 bp, global.
    assert dir_plan(500, False, 512) == (31, 32, 1)
    # A reference wider than 2 tiles of 31 at 19 968 lanes: three passes.
    assert dir_plan(150, False, 19_968) == (31, 2, 3)
    assert dir_plan(2000, False, 512) == (31, 32, 3)
    # The golden batch's few lanes, and references with no ordinary column.
    assert dir_plan(51, True, 512) == (7, 8, 1)
    assert dir_plan(0, True, 512) == dir_plan(1, True, 512) == dir_plan(0, False, 512) == (7, 1, 1)
    assert dir_plan(1, False, 100_352) == (7, 1, 1)
    for rlen in (0, 1, 2, 6, 13, 14, 51, 72, 150, 500, 704, 3000):
        for local in (True, False):
            for n_pad in (512, 19_968, 100_352):
                tj, G, passes = dir_plan(rlen, local, n_pad)
                rn = max(rlen - int(local), 0)
                assert tj in DIR_TILES and G in (1, 2, 4, 8, 16, 32) and passes >= 1
                assert passes * G * tj >= rn
                assert (n_pad * G) % 128 == 0
                if passes > 1:
                    assert G * DIR_TILES[-1] < rn


def test_plan_honours_the_fill_target(monkeypatch):
    """A larger fill target gives a read more lanes while each keeps
    DIR_MIN_COLS columns; a smaller one fewer."""
    monkeypatch.setattr(cuda_align, "DIR_FILL", 1 << 30)
    assert dir_plan(51, True, 19_968)[1] == 8  # 50 columns: 8 lanes of 6-7
    monkeypatch.setattr(cuda_align, "DIR_FILL", 19_968)
    assert dir_plan(51, True, 19_968) == (31, 1, 2)


def test_dir_kernel_resources_keys_follow_the_tiles():
    """The kernel's attributes are asked per compiled tile width."""
    calls = []

    class Fake:
        def function(self, symbol, argtypes):
            assert symbol == "sarlacc_dir_attrs"

            def fn(tj, buf):
                calls.append(tj)
                import ctypes

                out = ctypes.cast(buf, ctypes.POINTER(ctypes.c_int))
                for k, v in enumerate((64 + tj, 0, 0, 4, 128)):
                    out[k] = v
                return 0
            return fn

    res = cuda_align.dir_kernel_resources(Fake())
    assert calls == list(DIR_TILES)
    assert res["A@15"] == {"registers": 79, "shared_bytes": 0, "spill_bytes": 0,
                           "blocks_per_sm": 4, "threads": 128, "occupancy": 0.25}


def test_dir_kernel_rejects_cpu_tensors_before_planning():
    """On the CPU the wrapper raises (the plan is never reached)."""
    ad = prepare_adaptor(ADAPTOR2)
    codes, qidx, _ = prepare_reads(TSeqBatch.from_strings(["ACGT"], ["IIII"]), ad.tables)
    l1, n_pad = plane_dims(1, 4)
    planes = build_cost_planes(codes, qidx, ad.match_tab, ad.mismatch_tab, l1, n_pad)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_align._launch_dirs(ad.modes, encode_mask(ad.matched), 5.0, 1.0, *planes, True,
                                plan=(7, 4, 1))

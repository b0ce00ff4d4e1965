"""PyTorch port, the measurement tools: their plain versions against the
JAX scripts' Pallas kernels (interpret mode) and against the CUDA kernels'
own loops written out in numpy float32.

* The ``full`` ablation equals the Pallas ``_kernel``; ``full`` and
  ``no-dyncost`` equal ``_kernel_ablate`` of
  scripts/microbench_score_ablation.py, and ``no-rowload`` the Pallas
  ``_kernel`` on planes whose every row is row 0, bit for bit.
* Every ablation variant's plain version equals a scalar transliteration of
  kernel C's body with the variant's flags (``csrc/score_kernel.cu``,
  ``score_one``: rows outer, column tiles with the hand-off, the peeled
  fitting column, the masked row fetch), also across two column tiles.
* The ``add``/``max``/``select`` chains of tools/op_rates.py equal
  scripts/microbench_vpu_ops.py's ``_bench_kernel`` and the ``elementwise``
  chain of tools/op_mix.py equals scripts/microbench_op_mix.py's kernel, at
  a reduced iteration count.  The shift classes differ by design (a
  sublane roll against a lane shuffle); they are held against their plain
  versions on the card (tests/test_torch_cuda.py).
* Each tool runs on the CPU at a tiny size.

The scripts are imported with their persistent-cache setup switched off.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

torch.set_num_threads(1)

import sarlacc_tpu.utils.cache as jax_cache  # noqa: E402
from sarlacc_tpu.ops import pallas_align as pa  # noqa: E402
from sarlacc_tpu_torch.ops.align import dp_scores  # noqa: E402
from sarlacc_tpu_torch.ops.cuda_align import score_tile  # noqa: E402
from sarlacc_tpu_torch.tools import op_mix, op_rates, profile_demux, score_ablation  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def script(monkeypatch):
    """Import a script of ``scripts/`` without its persistent-cache setup."""
    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda *a, **k: None)

    def load(name):
        spec = importlib.util.spec_from_file_location(f"_script_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    return load


def _ablation_inputs(N=37, L=31, R=9, seed=0):
    args = score_ablation.make_inputs(N, L, R, "cpu", seed=seed)
    return args, [np.asarray(t) if isinstance(t, torch.Tensor) else t for t in args]


@pytest.mark.parametrize("local", [False, True])
def test_full_ablation_equals_pallas_kernel(local):
    args, (modes, mask, go, ge, costm, costmm, codes, lengths) = _ablation_inputs()
    l1, n_pad = codes.shape
    want = np.asarray(pa._launch_planes(
        jnp.asarray(modes), jnp.asarray(mask), jnp.asarray([go, ge], jnp.float32),
        jnp.asarray(costm), jnp.asarray(costmm), jnp.asarray(codes), jnp.asarray(lengths),
        rlen=len(modes), l1=l1, n_pad=n_pad, local=local, interpret=True,
    ))
    got = score_ablation.ablated_scores_plain("full", *args, local=local)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", ["full", "no-dyncost"])
def test_ablation_equals_kernel_ablate(script, variant):
    """The script's own ``_kernel_ablate`` (global mode, all rows) through
    ``pl.pallas_call(..., interpret=True)``, read at the reads' rows."""
    mod = script("microbench_score_ablation")
    args, (modes, mask, go, ge, costm, costmm, codes, lengths) = _ablation_inputs(seed=5)
    l1, n_pad = codes.shape
    kern = functools.partial(
        mod._kernel_ablate, rlen=len(modes), l1=l1, no_prefix=False,
        no_dyncost=variant == "no-dyncost",
    )
    lanes = mod.LANES
    S = pl.pallas_call(
        kern,
        grid=(n_pad // lanes,),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec((4, l1, lanes), lambda t: (0, 0, t), memory_space=pltpu.VMEM),
            pl.BlockSpec((4, l1, lanes), lambda t: (0, 0, t), memory_space=pltpu.VMEM),
            pl.BlockSpec((l1, lanes), lambda t: (0, t), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((l1, lanes), lambda t: (0, t), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((l1, n_pad), jnp.float32),
        scratch_shapes=[pltpu.VMEM((l1, lanes), jnp.float32), pltpu.VMEM((l1, lanes), jnp.float32)],
        interpret=True,
    )(jnp.asarray(modes), jnp.asarray(mask), jnp.asarray([go, ge], jnp.float32),
      jnp.asarray(costm), jnp.asarray(costmm), jnp.asarray(codes))
    want = np.asarray(S)[lengths, np.arange(len(lengths))]
    got = score_ablation.ablated_scores_plain(variant, *args)
    np.testing.assert_array_equal(got.numpy(), want)


def _scalar_kernel(variant, modes, mask, go, ge, costm, costmm, codes, lengths, local):
    """``csrc/score_kernel.cu::score_one`` with the variant's ablation flags,
    written out in numpy float32 one read at a time: rows outer inside
    column tiles of kernel C's width for R, each tile's last column handed
    to the next through a per-row slot, fitting mode's last column peeled
    off the tiles, row i's code and costs fetched at row ``i & row_mask``
    (0 for ``no-rowload``, every bit set otherwise)."""
    flags = score_ablation.VARIANTS[variant]
    no_vgap = bool(flags & score_ablation.NO_VGAP)
    no_dyncost = bool(flags & score_ablation.NO_DYNCOST)
    row_mask = 0 if flags & score_ablation.NO_ROWLOAD else -1
    f = np.float32
    go, ge = f(f(go) + f(ge)), f(ge)
    NEG = f(-3.0e38)
    l1 = codes.shape[0]
    R = len(modes)
    tj = score_tile([(0, R, local)])
    peel = local and R > 0
    rn = R - int(peel)
    ntiles = -(-rn // tj) if rn > tj else 1
    out = np.zeros(len(lengths), np.float32)
    for n, ln in enumerate(np.clip(lengths, 0, l1 - 1)):
        bS = np.zeros(l1, np.float32)
        bH = np.zeros(l1, np.float32)
        sL = f(0)
        for t in range(ntiles):
            j0, tl, last = t * tj, min(tj, rn - t * tj), t == ntiles - 1
            pS, cum = [NEG] * tl, [NEG] * tl
            cumZ, dL = NEG, NEG
            for i in range(ln + 1):
                src = i & row_mask
                code = codes[src, n]

                def cost(j):
                    if no_dyncost:
                        return f(-0.1) if code == 1 else f(-1.0)
                    m = min(max(int(modes[j]), 1), 4) - 1
                    return (costm if (mask[j] >> code) & 1 else costmm)[m, src, n]

                fi = f(i)
                rge, rge1 = f(fi * ge), f(f(fi - f(1)) * ge)
                if t == 0:
                    sL = f(0) if (local or i == 0) else f(f(-go) - rge1)
                    hL = NEG
                else:
                    sL, hL = bS[i], bH[i]
                diag, dL = dL, sL
                for q in range(tl):
                    Hn = max(f(sL - go), f(hL - ge))
                    mv = max(f(diag + cost(j0 + q)), Hn)
                    if no_vgap:
                        s = mv
                    else:
                        s = max(mv, f(cum[q] - rge1))
                        cum[q] = max(cum[q], f(f(mv - go) + rge))
                    diag, pS[q] = pS[q], s
                    sL, hL = s, Hn
                if peel and last:
                    Hn = max(f(sL - go), f(hL - ge))
                    mv = max(f(diag + cost(R - 1)), Hn)
                    sL, hL = (mv if no_vgap else max(mv, cumZ)), Hn
                    if not no_vgap:
                        cumZ = max(cumZ, mv)
                if not last:
                    bS[i], bH[i] = sL, hL
        out[n] = sL
    return out


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("variant", list(score_ablation.VARIANTS))
def test_ablation_plain_equals_kernel_loop(variant, local):
    args, (modes, mask, go, ge, costm, costmm, codes, _) = _ablation_inputs(N=13, L=17, R=6, seed=2)
    lengths = np.random.default_rng(3).integers(0, 18, 13).astype(np.int32)
    args = (*args[:-1], torch.as_tensor(lengths))
    want = _scalar_kernel(variant, modes, mask, go, ge, costm, costmm, codes, lengths, local)
    got = score_ablation.ablated_scores_plain(variant, *args, local=local)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("local", [False, True])
def test_kernel_loop_across_two_tiles_equals_dp_scores(local):
    """At R = 70 kernel C runs two tiles of 63 columns (the second 7 or 6
    wide, then the peeled column when fitting): the transliteration with
    its hand-off equals ``dp_scores``."""
    args, (modes, mask, go, ge, costm, costmm, codes, _) = _ablation_inputs(N=9, L=15, R=70, seed=7)
    assert score_tile([(0, 70, local)]) == 63
    lengths = np.random.default_rng(8).integers(0, 16, 9).astype(np.int32)
    want = dp_scores(*args[:-1], local)[:, :9].gather(0, torch.as_tensor(lengths, dtype=torch.int64)[None])[0]
    got = _scalar_kernel("full", modes, mask, go, ge, costm, costmm, codes, lengths, local)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("local", [False, True])
def test_no_rowload_equals_pallas_kernel_on_row0_planes(local):
    """``no-rowload`` is kernel C on planes whose every row is row 0: the
    JAX package's Pallas ``_kernel`` (interpret mode) on such planes."""
    args, (modes, mask, go, ge, costm, costmm, codes, lengths) = _ablation_inputs(seed=11)
    lengths = np.random.default_rng(12).integers(0, 32, len(lengths)).astype(np.int32)
    args = (*args[:-1], torch.as_tensor(lengths))
    l1, n_pad = codes.shape
    row0 = [np.ascontiguousarray(np.broadcast_to(p[..., :1, :], p.shape)) for p in (costm, costmm)]
    codes0 = np.ascontiguousarray(np.broadcast_to(codes[:1], codes.shape))
    want = np.asarray(pa._launch_planes(
        jnp.asarray(modes), jnp.asarray(mask), jnp.asarray([go, ge], jnp.float32),
        jnp.asarray(row0[0]), jnp.asarray(row0[1]), jnp.asarray(codes0), jnp.asarray(lengths),
        rlen=len(modes), l1=l1, n_pad=n_pad, local=local, interpret=True,
    ))
    got = score_ablation.ablated_scores_plain("no-rowload", *args, local=local)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cls", ["add", "max", "select"])
def test_op_rates_chains_equal_vpu_script(script, monkeypatch, cls):
    mod = script("microbench_vpu_ops")
    monkeypatch.setattr(mod, "ITERS", 3)
    bodies = {  # the script's op bodies, restated (microbench_vpu_ops.py:90-92)
        "add": lambda x, b, m: x + b,
        "max": lambda x, b, m: jnp.maximum(x, b),
        "select": lambda x, b, m: jnp.where(m, b, x),
    }
    rng = np.random.default_rng(9)
    a = rng.normal(size=(mod.L1, mod.LANES)).astype(np.float32)
    b = rng.normal(size=(mod.L1, mod.LANES)).astype(np.float32)
    want = pl.pallas_call(
        mod._bench_kernel(bodies[cls]),
        out_shape=jax.ShapeDtypeStruct((mod.L1, mod.LANES), jnp.float32),
        interpret=True,
    )(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    mask = torch.arange(mod.L1)[:, None].expand(mod.L1, mod.LANES) < 8  # the script's rows < 8
    got = op_rates.op_rates_plain(cls, ta, tb, tb, 3, mask, mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_op_mix_elementwise_equals_script():
    """scripts/microbench_op_mix.py's ``kern`` (:43-55, a closure, restated)
    with its elementwise body (:85-88), at 3 iterations."""
    iters, depth, L1, LANES = 3, op_mix.DEPTH, 256, 128

    def body(x, b1, b2, rows, s):
        return jnp.maximum(x + (b1 if s % 2 else b2), b2)

    def kern(a_ref, b1_ref, b2_ref, out_ref):
        rows = jax.lax.broadcasted_iota(jnp.int32, (L1, LANES), 0)
        b1 = b1_ref[:]
        b2 = b2_ref[:]

        def it(i, x):
            x = x + jnp.float32(1e-7)
            for s in range(depth):
                x = body(x, b1, b2, rows, s)
            return x

        out_ref[:] = jax.lax.fori_loop(0, iters, it, a_ref[:])

    rng = np.random.default_rng(0)
    a, b1, b2 = ((rng.normal(size=(L1, LANES)) * 1e-3).astype(np.float32) for _ in range(3))
    want = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((L1, LANES), jnp.float32), interpret=True,
    )(jnp.asarray(a), jnp.asarray(b1), jnp.asarray(b2))
    got = op_mix.op_mix_plain("elementwise", *map(torch.as_tensor, (a, b1, b2)), iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lane_shift_follows_the_shuffle_rule():
    """``__shfl_up_sync(x, d)``: lane l reads lane l-d, lanes below d keep
    their own value."""
    x = torch.arange(64, dtype=torch.float32).reshape(2, 32)
    for d in (1, 3, 16):
        got = op_rates.lane_shift_up(x, d).numpy()
        want = np.array([[row[l - d] if l >= d else row[l] for l in range(32)] for row in x.numpy()])
        np.testing.assert_array_equal(got, want)


def test_tools_run_on_cpu():
    """Every tool end to end on the CPU at a tiny size (plain versions)."""
    lines = []
    r = op_rates.measure(device="cpu", iters=2, reps=1, log=lines.append)
    m = op_mix.measure(device="cpu", iters=2, reps=1, log=lines.append)
    a = score_ablation.measure(N=40, L=12, R=5, device="cpu", reps=1, log=lines.append)
    p = profile_demux.measure(N=64, L=20, device="cpu", reps=1, log=lines.append)
    assert set(r["classes"]) == set(op_rates.CLASSES)
    assert set(m["classes"]) == set(op_mix.CLASSES)
    assert set(a["variants"]) == set(score_ablation.VARIANTS)
    assert a["variants"]["full"]["share_of_full"] == 1.0
    assert p["pure_a1"]["R"] == 47 and p["pure_a2"]["R"] == 14
    assert all("cpu" in lines[i] for i in (0,))
    for res in (r, m):
        assert all(np.isfinite(v["rate"]) and v["rate"] > 0 for v in res["classes"].values())


def test_ablation_build_covers_kernel_c_source():
    """The ablation library is kernel C's source with other entries: its
    build hash covers ``score_kernel.cu``, and the source has no DP of its
    own (no S/H planes, no cell loop)."""
    from sarlacc_tpu_torch.native.build import local_sources

    kern = score_ablation.KERNELS["full"]
    assert [pathlib.Path(p).name for p in local_sources(kern.source)] == [
        "score_ablation.cu", "score_kernel.cu"]
    source = open(kern.source).read()
    assert '#include "score_kernel.cu"' in source and "for (int i" not in source
    assert all(f"sarlacc_ablate_{v.replace('-', '_')}" in source for v in score_ablation.VARIANTS)


def test_issue_ceilings_follow_the_busiest_pipe():
    """Per-class issue ceilings at 132 SMs x 1 980 MHz: an add 128 a clock
    an SM, a max or select 64, a shuffle (with its add) 32; op_mix's
    iterations by their busiest pipe or the schedulers' dispatch."""
    sm_clk = 132 * 1.98e9
    want = {"add": 128, "max": 64, "select": 64, "shfl1": 32, "shfl16": 32}
    for cls, per_clock in want.items():
        assert op_rates.issue_ceiling(op_rates.RATE_MIX[cls], 132, 1.98e9) == pytest.approx(per_clock * sm_clk)
    d = op_mix.DEPTH
    want = {"elementwise": 128, "select+add": 128, "shift+max": (2 * d + 1) / (d / 32),
            "shift-stage(3op)": (3 * d + 1) / (2 * d / 64)}
    for cls, per_clock in want.items():
        assert op_rates.issue_ceiling(op_mix.MIX_PIPES[cls], 132, 1.98e9) == pytest.approx(per_clock * sm_clk)
    assert set(op_rates.ABLATION_CENSUS) == set(score_ablation.VARIANTS)


def test_score_tiles_routes_each_case_to_its_width():
    """The tile sweep at a tiny size on the CPU: each of its launches runs
    at the width the tool files it under (the wrappers' choice), and each
    build's nvcc command carries its register ask beside the production
    flags.  Timing the builds needs the card."""
    from sarlacc_tpu_torch.tools import score_tiles

    cases = score_tiles.make_cases(torch.device("cpu"), n_tune=5, n_barcodes=7)
    widths = {name: score_tiles._width(kind, args) for name, (kind, args, _) in cases.items()}
    assert widths == {"tune:adaptor2": 15, "barcodes12": 15, "barcodes24": 31,
                      "tune:adaptor1": 63, "C:adaptor1": 63}
    assert all(cells > 0 for _, _, cells in cases.values())
    kc, kd = score_tiles.variant_kernels(5)
    cmd = kc.command("nvcc")
    assert [c for c in cmd if c.startswith("-D")] == [
        "-DSCORE_MIN_BLOCKS_15=5", "-DSCORE_MIN_BLOCKS_31=5", "-DSCORE_MIN_BLOCKS_63=5"]
    assert kd.command("nvcc") == cmd and "--fmad=false" in cmd and cmd[-1] == kc.source
    source = open(kc.source).read()
    for tj, blocks in score_tiles.PRODUCTION.items():
        assert f"#define SCORE_MIN_BLOCKS_{tj} {blocks}\n" in source
    with pytest.raises(ValueError, match="needs the card"):
        score_tiles.measure(device="cpu")


def test_dir_tiles_plans_and_builds():
    """Kernel A's sweep at a tiny size on the CPU: each case gets the
    wrapper's plan, the tried plans cover the reference in at most
    MAX_PASSES passes, and each build's nvcc command carries its register
    ask beside the production flags.  Timing the builds needs the card."""
    from sarlacc_tpu_torch.ops.cuda_align import DIR_TILES, _ordinary
    from sarlacc_tpu_torch.tools import dir_tiles

    cases = dir_tiles.make_cases(torch.device("cpu"), n_ends=5, n_quality=3)
    assert sorted(cases) == ["adaptor1", "adaptor2", "multi-pass", "quality"]
    own = {name: dir_tiles.own_plan(args) for name, (args, _) in cases.items()}
    assert own == {"adaptor1": (7, 8, 1), "adaptor2": (7, 2, 1), "quality": (31, 32, 1),
                   "multi-pass": (15, 16, 1)}
    for name, (args, cells) in cases.items():
        rn = _ordinary(int(args[0].shape[0]), args[-1])
        tried = dir_tiles.plans(args)
        assert all(p * G * tj >= rn and p <= dir_tiles.MAX_PASSES for tj, G, p in tried)
        assert {tj for tj, _, _ in tried} <= set(DIR_TILES) and cells > 0
    kern = dir_tiles.variant_kernel(5)
    cmd = kern.command("nvcc")
    assert [c for c in cmd if c.startswith("-D")] == [
        "-DDIR_MIN_BLOCKS_7=5", "-DDIR_MIN_BLOCKS_15=5", "-DDIR_MIN_BLOCKS_31=5"]
    assert "--fmad=false" in cmd and cmd[-1] == kern.source
    source = open(kern.source).read()
    for tj, blocks in dir_tiles.PRODUCTION.items():
        assert f"#define DIR_MIN_BLOCKS_{tj} {blocks}\n" in source
    with pytest.raises(ValueError, match="needs the card"):
        dir_tiles.measure(device="cpu")


def test_kernel_turns_needs_the_card_and_each_root_package(tmp_path):
    """Each turn imports its own root's package and refuses to time without
    a card; a root without the package fails its turn."""
    from sarlacc_tpu_torch.tools import kernel_turns

    if torch.cuda.is_available():
        pytest.skip("a card is present: the turn would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_turns.run_root(str(ROOT))
    with pytest.raises(RuntimeError, match="turn 0"):
        kernel_turns.main([str(tmp_path)])


def _same(a, b) -> bool:
    """Equal values, through tuples, lists, dicts, tensors and arrays."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def test_kernel_turns_record_round_trip(tmp_path, monkeypatch):
    """``--record``'s pass on the CPU: kernel B's launch arguments and the
    merge waves come back through ``--shapes``' reader as they were saved,
    and kernel B's plain version and the wave path give on them what they
    gave in the pass (the waves on their cut-down libraries)."""
    import sarlacc_tpu_torch as st
    from sarlacc_tpu_torch.api import msa as api_msa
    from sarlacc_tpu_torch.ops import msa as ops_msa
    from sarlacc_tpu_torch.ops.cuda_msa import banded_pair_plain
    from sarlacc_tpu_torch.tools import kernel_turns
    from sarlacc_tpu_torch.tools.workload import build_workload

    seen = {"B": {}, "E": {}}
    pair, wave = ops_msa.banded_pair, api_msa.merge_wave_from_library

    def seen_pair(*args):
        out = pair(*args)
        seen["B"].setdefault(f"pipeline:P{int(args[0].shape[0])}xR{args[10]}xW{args[11]}", out)
        return out

    def seen_wave(lib, descs, rows, W):
        out = wave(lib, descs, rows, W)
        seen["E"].setdefault(f"pipeline:E:P{len(descs)}xR{rows}xW{W}", out)
        return out

    monkeypatch.setattr(ops_msa, "banded_pair", seen_pair)
    monkeypatch.setattr(api_msa, "merge_wave_from_library", seen_wave)
    path = str(tmp_path / "shapes.pt")
    saved = kernel_turns.record(path, device="cpu",
                                workload=build_workload(6, (3, 6), (200, 400), seed=3))
    assert saved["B"] and saved["E"]
    assert saved.keys() == seen.keys()
    assert all(saved[k].keys() == seen[k].keys() for k in saved)
    assert ops_msa.banded_pair is seen_pair and api_msa.merge_wave_from_library is seen_wave

    cases = kernel_turns._inputs(torch, st, torch.device("cpu"), path, "BE")
    for name, args in saved["B"].items():
        which, back = cases[f"B:{name}"]
        assert which == "B" and _same(back, args), name
        assert _same(tuple(banded_pair_plain(*back)), tuple(seen["B"][name])), name
    for name, rec in saved["E"].items():
        which, back = cases[f"{name}:wave"]
        assert which == "E" and _same(back, rec), name
        lib, descs, rows, W = back
        assert _same(ops_msa.merge_wave_from_library(lib, descs, rows, W), seen["E"][name]), name

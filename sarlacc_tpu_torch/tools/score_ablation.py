"""Attribute kernel C's time on the card by ablation.

    python -m sarlacc_tpu_torch.tools.score_ablation [N] [L] [R]

Counterpart of ``scripts/microbench_score_ablation.py`` (``_kernel_ablate``
launched by ``_launch``, ``pallas_call`` :123), with its defaults (N =
100 000 reads, L = 250, R = 51 columns, numpy seed 0, random planes as
its :149-157, gap open 4 + extension 1, global mode).  Each variant is
kernel C itself (``csrc/score_kernel.cu``'s ``score_kernel`` template,
rows outer inside register tiles of columns) built with one suspect of
its cell body removed, at C's launch shape: 128 threads a block, one read
a thread, C's tile width for R and C's hand-off scratch beyond one tile
(``csrc/score_ablation.cu``).  So the shares attribute kernel C as it
runs:

* ``full``: kernel C, bit for bit;
* ``no-vgap``: the columns' running vertical-gap max dropped, S = max(M,
  H) (the TPU's ``no-prefix``, whose log-shift scan is this running max
  here): 3 of a cell's 6 adds and 2 of its 4 maxes;
* ``no-dyncost``: one cost a row from the read's code, -0.1 where it is 1
  else -1.0 (the JAX ablation's constant), instead of the cell's two
  shared-memory loads; no cost slot is fetched;
* ``neither``: both;
* ``no-rowload``: every row's code and cost slots fetched from row 0, so
  the loads stay but hit L1: kernel C's only device-memory traffic (a
  code and 2-8 costs a row) taken off the card's memory (replaces the
  TPU's ``half-prefix``, a sublane-packing study with no meaning here).

It prints, per variant, ms, GCUPS, its time as a share of ``full``, its
registers, spill bytes and resident blocks an SM (a variant that frees
registers can hold more blocks) and its SASS instruction count at the
launch's tile width.  On the card every variant is first held bit for
bit against :func:`ablated_scores_plain`, and ``full`` against kernel C,
also in time (:func:`check`).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..native.build import CudaKernel, check_tensor, kernel_resources
from ..ops.align import NEG_INF_F32, _column0, _shift_down, dp_scores
from ..ops.cuda_align import (
    _gap_pair, _ordinary, _ptr, _scratch, plane_dims, score_kernel, score_tile,
)
from .timing import device_label, event_ms, queued_ms

__all__ = ["KERNELS", "NO_DYNCOST", "NO_ROWLOAD", "NO_VGAP", "VARIANTS", "ablated_scores",
           "ablated_scores_plain", "ablation_kernel", "ablation_resources", "ablation_sass",
           "check", "make_inputs", "measure"]

#: Ablation flags, as ``csrc/score_kernel.cu`` defines them.
NO_VGAP, NO_DYNCOST, NO_ROWLOAD = 1, 2, 4

#: Variant -> its ablation flags.
VARIANTS = {
    "full": 0,
    "no-vgap": NO_VGAP,
    "no-dyncost": NO_DYNCOST,
    "neither": NO_VGAP | NO_DYNCOST,
    "no-rowload": NO_ROWLOAD,
}

#: Most |full / kernel C - 1| :func:`check` accepts in time: ``full`` is
#: kernel C's own code.
TIME_TOLERANCE = 0.05

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: ``csrc/score_ablation.cu``: replace ``scripts/microbench_score_ablation.py::_kernel_ablate``.
KERNELS = {
    v: CudaKernel(
        "score_ablation.cu", f"sarlacc_ablate_{v.replace('-', '_')}",
        [_P, _P, _I, _F, _F, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P],
    )
    for v in VARIANTS
}


def _const_cost(codes_k):
    """The ``no-dyncost`` cost: -0.1 where the code is 1, else -1.0 (the JAX
    ablation's constant, microbench_score_ablation.py:71)."""
    f32 = torch.float32
    return torch.where(
        codes_k == 1, torch.tensor(-0.1, dtype=f32, device=codes_k.device),
        torch.tensor(-1.0, dtype=f32, device=codes_k.device),
    )


def _columns_plain(no_vgap, no_dyncost, modes, mask, go, ge, costm, costmm, codes_k, local):
    """The column DP of ``dp_scores`` with the vertical gap and/or the cost
    planes ablated; returns S [l1, n] after the last column."""
    l1, n = codes_k.shape
    dev = codes_k.device
    neg = NEG_INF_F32
    rows_f = torch.arange(l1, dtype=torch.float32, device=dev)[:, None]
    row0 = rows_f == 0
    rge, rge1 = rows_f * ge, (rows_f - 1.0) * ge
    S = _column0(local, go, rge1, row0, l1, n)
    H = torch.full((l1, n), neg, dtype=torch.float32, device=dev)
    negs = torch.full((l1, n), neg, dtype=torch.float32, device=dev)
    R = int(modes.shape[0])
    for j, (m, mk) in enumerate(zip(modes.tolist(), mask.tolist())):
        zero_vgap = local and j == R - 1
        if no_dyncost:
            cost = _const_cost(codes_k)
        else:
            sel = torch.bitwise_right_shift(torch.tensor(mk, dtype=torch.int32, device=dev), codes_k) & 1
            cost = torch.where(sel == 1, costm[m - 1], costmm[m - 1])
        Hn = torch.maximum(S - go, H - ge)
        mv = torch.maximum(_shift_down(S, neg) + cost, Hn)
        if no_vgap:
            V = negs
        else:
            cum = mv if zero_vgap else (mv - go) + rge
            V = _shift_down(torch.cummax(cum, dim=0).values, neg)
            if not zero_vgap:
                V = V - rge1
        S, H = torch.maximum(mv, V), Hn
    return S


def ablated_scores_plain(variant, modes, mask, gap_open, gap_ext, costm, costmm, codes_k,
                         lengths, local=False):
    """Plain PyTorch version of one ablation kernel: scores f32 [N].

    ``full`` is :func:`..ops.align.dp_scores` gathered at ``lengths``;
    ``no-rowload`` the same on planes whose every row is row 0; the other
    variants are its column DP with the same ablation.
    """
    flags = VARIANTS[variant]
    if flags & NO_ROWLOAD:
        costm, costmm, codes_k = (costm[:, :1].expand_as(costm), costmm[:, :1].expand_as(costmm),
                                  codes_k[:1].expand_as(codes_k))
    N = int(lengths.shape[0])
    idx = lengths.to(torch.int64).clamp(0, codes_k.shape[0] - 1)[None, :]
    if flags & (NO_VGAP | NO_DYNCOST):
        dev = codes_k.device
        go = torch.tensor(np.float32(gap_open) + np.float32(gap_ext), dtype=torch.float32, device=dev)
        ge = torch.tensor(np.float32(gap_ext), dtype=torch.float32, device=dev)
        S = _columns_plain(bool(flags & NO_VGAP), bool(flags & NO_DYNCOST), modes, mask, go, ge,
                           costm, costmm, codes_k, local)
    else:
        S = dp_scores(modes, mask, gap_open, gap_ext, costm, costmm, codes_k, local)
    return S[:, :N].gather(0, idx)[0]


def ablation_kernel(variant, modes, mask, gap_open, gap_ext, costm, costmm, codes_k, lengths,
                    local=False):
    """Launch one ablation kernel: scores f32 [N], kernel C's contract, at
    kernel C's tile width and with its hand-off scratch."""
    dev = codes_k.device
    l1, n_pad = codes_k.shape
    R, N = int(modes.shape[0]), int(lengths.shape[0])
    if R == 0 or N > n_pad:
        raise ValueError(f"the ablation kernels need R >= 1 and N <= n_pad (R={R}, N={N})")
    check_tensor(modes, "modes", torch.int32, (R,))
    check_tensor(mask, "mask", torch.int32, (R,))
    check_tensor(costm, "costm", torch.float32, (4, l1, n_pad))
    check_tensor(costmm, "costmm", torch.float32, (4, l1, n_pad))
    check_tensor(codes_k, "codes_k", torch.int32, (l1, n_pad))
    check_tensor(lengths, "lengths", torch.int32, (N,))
    out = torch.empty(N, dtype=torch.float32, device=dev)
    tj = score_tile([(0, R, bool(local))])
    scratch = _scratch(int(_ordinary(R, bool(local)) > tj), l1, n_pad, dev)
    go, ge = _gap_pair(gap_open, gap_ext)
    KERNELS[variant].launch(
        modes.data_ptr(), mask.data_ptr(), R, go, ge, int(bool(local)), costm.data_ptr(),
        costmm.data_ptr(), codes_k.data_ptr(), lengths.data_ptr(), N, l1, n_pad, tj,
        _ptr(scratch), out.data_ptr(), 0, torch.cuda.current_stream(dev),
    )
    return out


def ablation_resources(tj: int) -> dict:
    """Each variant as compiled at tile width ``tj``, with the keys of
    :func:`..ops.cuda_align.score_kernel_resources` (registers, spill
    bytes, resident blocks an SM, occupancy)."""
    fn = KERNELS["full"].function("sarlacc_ablation_attrs", [_I, _I, _P])
    return {v: kernel_resources(fn, flags, tj) for v, flags in VARIANTS.items()}


def ablation_sass(tj: int) -> dict:
    """Each variant's SASS instruction count at tile width ``tj`` (the
    built library through ``cuobjdump``); {} where the toolkit has none."""
    from .op_rates import sass_census

    census = sass_census(KERNELS["full"]) or {}
    out = {}
    for v, flags in VARIANTS.items():
        tag = f"score_kernelILi{(tj + 1) // 2}ELi{flags}E"
        found = [sum(c.values()) for name, c in census.items() if tag in name]
        if found:
            out[v] = found[0]
    return out


def ablated_scores(variant, *args, **kw):
    """The kernel on CUDA tensors, :func:`ablated_scores_plain` on CPU ones."""
    run = ablation_kernel if args[-1].is_cuda else ablated_scores_plain
    return run(variant, *args, **kw)


def make_inputs(N: int, L: int, R: int, device, seed: int = 0):
    """The script's random inputs (microbench_score_ablation.py:149-157), in
    its draw order, on ``device``: modes, masks, cost planes, codes; every
    read of length L.  Gap open 4, extension 1."""
    rng = np.random.default_rng(seed)
    l1, n_pad = plane_dims(N, L)
    modes = rng.integers(1, 5, R)
    mask = rng.integers(1, 31, R)
    costm = (rng.normal(size=(4, l1, n_pad)) * 0.1 - 0.05).astype(np.float32)
    costmm = (rng.normal(size=(4, l1, n_pad)) * 0.1 - 1.0).astype(np.float32)
    codes = rng.integers(0, 4, (l1, n_pad))

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    return (
        t(modes, torch.int32), t(mask, torch.int32), 4.0, 1.0, t(costm, torch.float32),
        t(costmm, torch.float32), t(codes, torch.int32), torch.full((N,), L, dtype=torch.int32, device=device),
    )


def check(args, local: bool = False, reps: int = 3, turns_reps: int = 10) -> dict:
    """Every variant's kernel against :func:`ablated_scores_plain` on the
    card, and ``full`` against kernel C, bit for bit, on ``args`` (from
    :func:`make_inputs`); then ``full`` and kernel C timed in turns (C,
    full, full, C; ``turns_reps`` calls each queued behind a sleep), which
    must agree within :data:`TIME_TOLERANCE`.  Returns, per variant, max
    |diff| and the kernel's and the plain version's ms, and under
    ``"kernel C"`` the two turn means."""
    dev = args[-1].device
    if dev.type != "cuda":
        raise ValueError("score_ablation.check compares the kernels on the card")
    if not torch.equal(ablation_kernel("full", *args, local=local), score_kernel(*args, local=local)):
        raise AssertionError("ablation 'full' differs from kernel C")
    out = {}
    for variant in VARIANTS:
        got = ablation_kernel(variant, *args, local=local)
        want = ablated_scores_plain(variant, *args, local=local)
        torch.cuda.synchronize(dev)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"ablation {variant}: {bad} scores differ from the plain version")
        out[variant] = {
            "max_abs_err": float((got - want).abs().max()),
            "ms": event_ms(lambda: ablation_kernel(variant, *args, local=local), reps, dev),
            "plain_ms": event_ms(lambda: ablated_scores_plain(variant, *args, local=local), 1, dev,
                                 warmup=False),
        }
    runs = {"kernel C": lambda: score_kernel(*args, local=local),
            "full": lambda: ablation_kernel("full", *args, local=local)}
    turns = {name: [] for name in runs}
    for name in ("kernel C", "full", "full", "kernel C"):
        turns[name].append(queued_ms(runs[name], turns_reps, dev))
    c_ms, full_ms = (sum(turns[k]) / 2 for k in ("kernel C", "full"))
    if abs(full_ms / c_ms - 1.0) > TIME_TOLERANCE:
        raise AssertionError(f"ablation 'full' takes {full_ms:.4f} ms against kernel C's "
                             f"{c_ms:.4f} ms (turns {turns}): more than "
                             f"{100 * TIME_TOLERANCE:.0f}% apart")
    out["kernel C"] = {"ms": c_ms, "full_ms": full_ms, "turns": turns}
    return out


def measure(N: int = 100_000, L: int = 250, R: int = 51, device=None, reps: int = 5,
            check_first: bool = True, args=None, local: bool = False, log=print) -> dict:
    """Time every variant (after :func:`check` on the card, unless
    ``check_first`` is off); ``args`` reuses inputs of :func:`make_inputs`;
    ``local`` runs fitting mode (default global, as the script)."""
    dev = resolve_device(device)
    log(f"[ablation] {device_label(dev)}")
    if args is None:
        args = make_inputs(N, L, R, dev)
    N, R = int(args[-1].shape[0]), int(args[0].shape[0])
    cells = float((args[-1].double() + 1).sum()) * R
    tj = score_tile([(0, R, bool(local))])
    log(f"[ablation] N={N} L={L} R={R} l1={args[4].shape[1]} {'fitting' if local else 'global'}, "
        f"tile {tj}, {cells:.3e} cells")
    if check_first and dev.type == "cuda":
        c = check(args, local)["kernel C"]
        log(f"[ablation] every variant equals its plain version; full equals kernel C, "
            f"{c['full_ms']:.4f} ms against C's {c['ms']:.4f} ms in turns")
    res = ablation_resources(tj) if dev.type == "cuda" else {}
    for v, n in (ablation_sass(tj) if dev.type == "cuda" else {}).items():
        res[v]["sass_instructions"] = n
    clock = "events" if dev.type == "cuda" else "host clock"
    out: dict = {"N": N, "L": L, "R": R, "local": bool(local), "tile": tj, "variants": {}}
    for variant in VARIANTS:
        if not bool(torch.isfinite(ablated_scores(variant, *args, local=local)).all()):
            raise AssertionError(f"ablation {variant}: non-finite scores")
        ms = event_ms(lambda: ablated_scores(variant, *args, local=local), reps, dev)
        out["variants"][variant] = {"ms": ms, "gcups": cells / (ms * 1e-3) / 1e9,
                                    **res.get(variant, {})}
    full_ms = out["variants"]["full"]["ms"]
    for variant, v in out["variants"].items():
        v["share_of_full"] = v["ms"] / full_ms
        occ = (f"  {v['registers']} registers, {v['spill_bytes']} B spilled, "
               f"{v['blocks_per_sm']} blocks an SM" if "registers" in v else "")
        occ += f", {v['sass_instructions']} SASS instructions" if "sass_instructions" in v else ""
        log(f"[ablation] {variant:>10}: {v['ms']:8.3f} ms {clock}  {v['gcups']:7.1f} GCUPS  "
            f"{100 * v['share_of_full']:6.1f}% of full{occ}")
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    N = int(argv[0]) if argv else 100_000
    L = int(argv[1]) if len(argv) > 1 else 250
    R = int(argv[2]) if len(argv) > 2 else 51
    measure(N, L, R)
    return 0


if __name__ == "__main__":
    sys.exit(main())

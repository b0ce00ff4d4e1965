"""Attribute the column-outer score DP's time on the card by ablation.

    python -m sarlacc_tpu_torch.tools.score_ablation [N] [L] [R]

Counterpart of ``scripts/microbench_score_ablation.py`` (``_kernel_ablate``
launched by ``_launch``, ``pallas_call`` :123), with its defaults (N =
100 000 reads, L = 250, R = 51 columns, numpy seed 0, random planes as
its :149-157, gap open 4 + extension 1, global mode).  Each variant is
the column-outer per-read DP (one thread per read walking the columns,
S and H read and written in device-memory planes every cell) with one
suspect removed, at the same launch shape (``csrc/score_ablation.cu``).
Kernel C runs rows outer inside register tiles (``csrc/score_kernel.cu``),
the design these answers point to; both designs give the same bits:

* ``full``: the column-outer body, its scores equal to kernel C's;
* ``no-vgap``: the running vertical-gap max dropped (the TPU's
  ``no-prefix``, whose log-shift scan is this running max here);
* ``no-dyncost``: a constant cost, no cost-plane loads;
* ``neither``: both;
* ``no-state``: S and H read and written at row 0's address, so the
  row-state loads and stores hit L1 (replaces the TPU's ``half-prefix``,
  a sublane-packing study with no meaning on the card).

It prints ms and GCUPS per variant and each variant's time as a share of
``full``.  Every variant is first held bit for bit against
:func:`ablated_scores_plain`, and ``full`` against kernel C.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..native.build import CudaKernel, check_tensor
from ..ops.align import NEG_INF_F32, _column0, _shift_down, dp_scores
from ..ops.cuda_align import _gap_pair, plane_dims, score_kernel
from .timing import device_label, event_ms

__all__ = ["KERNELS", "VARIANTS", "ablated_scores", "ablated_scores_plain", "ablation_kernel",
           "check", "make_inputs", "measure"]

#: Variant -> (no_vgap, no_dyncost, no_state).
VARIANTS = {
    "full": (False, False, False),
    "no-vgap": (True, False, False),
    "no-dyncost": (False, True, False),
    "neither": (True, True, False),
    "no-state": (False, False, True),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: ``csrc/score_ablation.cu``: replace ``scripts/microbench_score_ablation.py::_kernel_ablate``.
KERNELS = {
    v: CudaKernel(
        "score_ablation.cu", f"sarlacc_ablate_{v.replace('-', '_')}",
        [_P, _P, _I, _F, _F, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
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


def _no_state_plain(modes, mask, go, ge, costm, costmm, codes_k, lengths, local):
    """The ``no-state`` variant row by row, as each thread runs it: one S
    and one H cell per read, rewritten by every row; rows past a read's
    length leave them alone.  Returns the scores [N]."""
    l1 = codes_k.shape[0]
    N = int(lengths.shape[0])
    dev = codes_k.device
    f32 = torch.float32
    neg = torch.tensor(NEG_INF_F32, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    ln = lengths.to(torch.int64).clamp(0, l1 - 1)
    last = int(ln.max()) if N else -1
    s = torch.zeros(N, dtype=f32, device=dev)
    for i in range(last + 1):
        on = i <= ln
        v = zero if (local or i == 0) else (-go) - (torch.tensor(float(i), dtype=f32, device=dev) - 1.0) * ge
        s = torch.where(on, v, s)
    out = s.clone()
    h = torch.full((N,), NEG_INF_F32, dtype=f32, device=dev)
    R = int(modes.shape[0])
    for j, (m, mk) in enumerate(zip(modes.tolist(), mask.tolist())):
        zero_vgap = local and j == R - 1
        s_up = neg.expand(N)
        cum = neg.expand(N)
        for i in range(last + 1):
            on = i <= ln
            code = codes_k[i, :N]
            sel = torch.bitwise_right_shift(torch.tensor(mk, dtype=torch.int32, device=dev), code) & 1
            cost = torch.where(sel == 1, costm[m - 1, i, :N], costmm[m - 1, i, :N])
            fi = torch.tensor(float(i), dtype=f32, device=dev)
            s_old, h_old = s, h
            Hn = torch.maximum(s_old - go, h_old - ge)
            mv = torch.maximum(s_up + cost, Hn)
            V = cum if zero_vgap else cum - (fi - 1.0) * ge
            B = mv if zero_vgap else (mv - go) + fi * ge
            res = torch.maximum(mv, V)
            out = torch.where(on, res, out)
            s = torch.where(on, res, s)
            h = torch.where(on, Hn, h)
            s_up = s_old
            cum = torch.maximum(cum, B)
    return out


def ablated_scores_plain(variant, modes, mask, gap_open, gap_ext, costm, costmm, codes_k,
                         lengths, local=False):
    """Plain PyTorch version of one ablation kernel: scores f32 [N].

    ``full`` is :func:`..ops.align.dp_scores` gathered at ``lengths``; the
    other variants are its column DP with the same ablation, except
    ``no-state``, whose rows chain through one cell and so run row by row.
    """
    no_vgap, no_dyncost, no_state = VARIANTS[variant]
    dev = codes_k.device
    go = torch.tensor(np.float32(gap_open) + np.float32(gap_ext), dtype=torch.float32, device=dev)
    ge = torch.tensor(np.float32(gap_ext), dtype=torch.float32, device=dev)
    N = int(lengths.shape[0])
    idx = lengths.to(torch.int64).clamp(0, codes_k.shape[0] - 1)[None, :]
    if no_state:
        return _no_state_plain(modes, mask, go, ge, costm, costmm, codes_k, lengths, local)
    if variant == "full":
        S = dp_scores(modes, mask, gap_open, gap_ext, costm, costmm, codes_k, local)
    else:
        S = _columns_plain(no_vgap, no_dyncost, modes, mask, go, ge, costm, costmm, codes_k, local)
    return S[:, :N].gather(0, idx)[0]


def ablation_kernel(variant, modes, mask, gap_open, gap_ext, costm, costmm, codes_k, lengths,
                    local=False):
    """Launch one ablation kernel: scores f32 [N], kernel C's contract."""
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
    S = torch.empty((l1, n_pad), dtype=torch.float32, device=dev)
    H = torch.empty_like(S)
    go, ge = _gap_pair(gap_open, gap_ext)
    KERNELS[variant].launch(
        modes.data_ptr(), mask.data_ptr(), R, go, ge, int(bool(local)), costm.data_ptr(),
        costmm.data_ptr(), codes_k.data_ptr(), lengths.data_ptr(), N, l1, n_pad,
        S.data_ptr(), H.data_ptr(), out.data_ptr(), 0,
        torch.cuda.current_stream(dev),
    )
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


def check(args, reps: int = 3) -> dict:
    """Every variant's kernel against :func:`ablated_scores_plain` on the
    card, and ``full`` against kernel C, bit for bit, on ``args`` (from
    :func:`make_inputs`).  Returns, per variant, max |diff| and the
    kernel's and the plain version's ms."""
    dev = args[-1].device
    if dev.type != "cuda":
        raise ValueError("score_ablation.check compares the kernels on the card")
    kc = score_kernel(*args, local=False)
    if not torch.equal(ablation_kernel("full", *args), kc):
        raise AssertionError("ablation 'full' differs from kernel C")
    out = {}
    for variant in VARIANTS:
        got = ablation_kernel(variant, *args)
        want = ablated_scores_plain(variant, *args)
        torch.cuda.synchronize(dev)
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"ablation {variant}: {bad} scores differ from the plain version")
        out[variant] = {
            "max_abs_err": float((got - want).abs().max()),
            "ms": event_ms(lambda: ablation_kernel(variant, *args), reps, dev),
            "plain_ms": event_ms(lambda: ablated_scores_plain(variant, *args), 1, dev, warmup=False),
        }
    return out


def measure(N: int = 100_000, L: int = 250, R: int = 51, device=None, reps: int = 5,
            check_first: bool = True, args=None, log=print) -> dict:
    """Time every variant (after :func:`check` on the card, unless
    ``check_first`` is off); ``args`` reuses inputs of :func:`make_inputs`."""
    dev = resolve_device(device)
    log(f"[ablation] {device_label(dev)}")
    if args is None:
        args = make_inputs(N, L, R, dev)
    cells = float(N) * L * R
    log(f"[ablation] N={N} L={L} R={R} l1={args[4].shape[1]} global, {cells:.3e} cells")
    if check_first and dev.type == "cuda":
        check(args)
        log("[ablation] every variant equals its plain version; full equals kernel C")
    clock = "events" if dev.type == "cuda" else "host clock"
    out: dict = {"N": N, "L": L, "R": R, "variants": {}}
    for variant in VARIANTS:
        if not bool(torch.isfinite(ablated_scores(variant, *args)).all()):
            raise AssertionError(f"ablation {variant}: non-finite scores")
        ms = event_ms(lambda: ablated_scores(variant, *args), reps, dev)
        out["variants"][variant] = {"ms": ms, "gcups": cells / (ms * 1e-3) / 1e9}
    full_ms = out["variants"]["full"]["ms"]
    for variant, v in out["variants"].items():
        v["share_of_full"] = v["ms"] / full_ms
        log(f"[ablation] {variant:>10}: {v['ms']:8.3f} ms {clock}  {v['gcups']:7.1f} GCUPS  "
            f"{100 * v['share_of_full']:6.1f}% of full")
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

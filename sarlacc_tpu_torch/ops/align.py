"""Quality-aware affine-gap fitting DP with run-length directions (PyTorch).

Counterpart of ``sarlacc_tpu/ops/align.py``.  :func:`dp_align` is the plain
PyTorch version of the hand-written CUDA kernel in ``csrc/dir_kernel.cu``
(which replaces the Pallas ``_dir_kernel``): same inputs (the per-read cost
planes of :func:`..ops.cuda_align.build_cost_planes`), same outputs, same
float32 operations in the same association, so directions come out
bit-identical.  Reads ride the last axis, read positions the row axis, and
the reference columns are a Python loop; within a column the vertical-gap
recurrence ``V[i] = max(S[i-1] - open, V[i-1] - ext)`` is a shifted
``cummax`` (derivation in the JAX module).

Semantics (reference_align.cpp): ``gap_open`` is stored as open+extend;
fitting ("local") mode zeroes the first column and frees vertical gaps in
the last one; directions are 0 diagonal, +k a left run, -k an up run, with
row 0 always 1; a gap *jump* wins only when strictly greater.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "NEG_INF_F32",
    "dp_align",
    "prepare_reads",
    "prepare_reference",
    "prepared_from_numpy",
]

NEG_INF_F32 = -3.0e38  # finite stand-in for -inf; safe under further subtraction


def prepared_from_numpy(modes, matched, match_tab, mismatch_tab, device=None):
    """The JAX package's prepared-adaptor arrays (numpy) -> the port's tensors.

    Returns (modes int32 [R], matched bool [R, 5], match_tab f32 [4, Q],
    mismatch_tab f32 [4, Q]) on ``device`` (default CPU).
    """
    dev = torch.device("cpu" if device is None else device)
    return (
        torch.tensor(np.asarray(modes, np.int32), device=dev),
        torch.tensor(np.asarray(matched, bool), device=dev),
        torch.tensor(np.asarray(match_tab, np.float32), device=dev),
        torch.tensor(np.asarray(mismatch_tab, np.float32), device=dev),
    )


def prepare_reference(ref, tables, device=None):
    """An IUPACReference (or string) -> (modes, matched, match_tab, mismatch_tab)."""
    from ..core.encode import iupac_reference

    if isinstance(ref, str):
        ref = iupac_reference(ref)
    return prepared_from_numpy(
        ref.modes, ref.matched, tables.match, tables.mismatch, device
    )


def prepare_reads(batch, tables, device=None):
    """SeqBatch -> (codes int8 [N, L], qidx int8 [N, L], lengths int32 [N]).

    Padded positions get quality index 0; they never reach live DP cells
    because row i only consumes read positions < i <= length.
    """
    dev = torch.device("cpu" if device is None else device)
    if batch.quals is not None:
        qidx = np.zeros(batch.codes.shape, dtype=np.int8)
        if len(batch):
            pos = np.arange(batch.codes.shape[1])[None, :]
            valid = pos < batch.lengths[:, None]
            q = np.where(valid, batch.quals, tables.offset)
            qidx = np.asarray(tables.qual_index(q), dtype=np.int8)
    else:
        # Maximum quality: last table entry (minimum error).
        qidx = np.full(batch.codes.shape, tables.navail - 1, dtype=np.int8)
    return (
        torch.as_tensor(np.asarray(batch.codes, np.int8), device=dev),
        torch.as_tensor(qidx, device=dev),
        torch.as_tensor(np.asarray(batch.lengths, np.int32), device=dev),
    )


def _shift_down(x: torch.Tensor, fill) -> torch.Tensor:
    """Row i takes row i-1; row 0 becomes ``fill``."""
    top = torch.full_like(x[:1], fill)
    return torch.cat([top, x[:-1]], dim=0)


def dp_align(modes, mask, gap_open, gap_ext, costm, costmm, codes_k, local=True):
    """Plain PyTorch fitting/global DP over cost planes, with directions.

    ``modes`` int32 [R] (1..4), ``mask`` int32 [R] (bit b: observed base b
    matches column), ``costm``/``costmm`` f32 [4, l1, n] (per read position,
    row 0 unused), ``codes_k`` int32 [l1, n] (row 0 = 0, pad 5).  Runs on the
    device of its tensors.

    Returns (S f32 [l1, n] after the last column, dirs int16 [R, l1, n]).
    """
    l1, n = codes_k.shape
    dev = codes_k.device
    f32 = torch.float32
    R = int(modes.shape[0])
    go = torch.tensor(np.float32(gap_open) + np.float32(gap_ext), dtype=f32, device=dev)
    ge = torch.tensor(np.float32(gap_ext), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    neg = NEG_INF_F32

    rows = torch.arange(l1, dtype=torch.int32, device=dev)[:, None]
    rows_f = rows.to(f32)
    row0 = rows == 0
    rge = rows_f * ge  # vertical-gap open ramp
    rge1 = (rows_f - 1.0) * ge  # and its closing ramp

    if local:
        S = torch.zeros((l1, n), dtype=f32, device=dev)
    else:
        S = torch.where(row0, zero, -go - rge1).expand(l1, n).contiguous()
    H = torch.full((l1, n), neg, dtype=f32, device=dev)
    was_left = torch.zeros((l1, n), dtype=torch.bool, device=dev)
    ljp = torch.zeros((l1, n), dtype=torch.int32, device=dev)
    dirs = torch.empty((R, l1, n), dtype=torch.int16, device=dev)

    modes_h = [int(m) for m in modes.tolist()]
    mask_h = [int(m) for m in mask.tolist()]
    for j in range(R):
        zero_vgap = local and j == R - 1  # free trailing query gaps
        vgo = zero if zero_vgap else go
        vge = zero if zero_vgap else ge
        sel = torch.bitwise_right_shift(
            torch.tensor(mask_h[j], dtype=torch.int32, device=dev), codes_k
        ) & 1
        cost = torch.where(sel == 1, costm[modes_h[j] - 1], costmm[modes_h[j] - 1])

        M = _shift_down(S, neg) + cost

        # Horizontal gap with jump bookkeeping: the open candidate charges
        # only the extension when the source cell was itself a left step.
        cand1_h = S - torch.where(was_left, ge, go)
        jump_h = H - ge
        cond_h = cand1_h >= jump_h
        Hn = torch.where(cond_h, cand1_h, jump_h)

        mv = torch.maximum(M, Hn)
        # Exact association ((mv - go) + rge): last-ulp identity with the
        # kernel decides direction ties.
        cum = mv if zero_vgap else (mv - go) + rge
        cum = torch.cummax(cum, dim=0).values
        V = _shift_down(cum, neg)
        if not zero_vgap:
            V = V - rge1

        Sn = torch.where(row0, Hn, torch.maximum(mv, V))

        is_diag = (M > Hn) & (M > V)
        is_left = ~is_diag & (Hn > V)

        left_step = torch.where(cond_h, 1, 1 + j - ljp)
        ljp = torch.where(cond_h, j, ljp)

        # Up-run lengths: the jump point is the last row where the vertical
        # gap did not extend a jump (strictly-greater rule).
        is_up = ~(is_diag | is_left)
        is_up_prev = _shift_down(is_up, False)
        cand1_v = _shift_down(Sn, neg) - torch.where(is_up_prev, vge, vgo)
        jump_v = _shift_down(V, neg) - vge
        cond_v = cand1_v >= jump_v
        pnt = torch.cummax(torch.where(cond_v, rows, 0), dim=0).values
        up_step = torch.where(cond_v, 1, 1 + rows - _shift_down(pnt, 0))

        d = torch.where(is_diag, 0, torch.where(is_left, left_step, -up_step))
        d = torch.where(row0, 1, d)  # row 0 is always a single left step
        dirs[j] = d.to(torch.int16)

        S, H = Sn, Hn
        was_left = is_left | row0
    return S, dirs

"""The yardstick of the hand-written DP kernels A-D: the least time each
launch could take on one H100, frozen here so that no change to the
program moves it.

A launch's bound is the larger of its operations over the card's float32
rate outside the tensor cores and its compulsory bytes over HBM's rate,
counting each input byte read once and each output byte written once.
The counts are those the smoke run has used since the kernels' redesigns:
operations a DP cell of A 26, B 21, C and D 10; the cost planes' only
compulsory reads are the slots the reference's columns select
(:func:`cost_slots`).  Kernels E-I do work that depends on the data
(entries, fetches, DP cells) and get bounds once the program counts it.
"""

from __future__ import annotations

import importlib
import re

import torch

__all__ = ["PEAK_BYTES", "PEAK_F32", "OPS_PER_CELL", "WRAPPERS", "KERNEL_NAMES", "cost_slots",
           "bound_s", "LaunchRecorder"]

#: H100 SXM data sheet: HBM bytes/s and float32 operations/s outside the
#: tensor cores, at the full 700 W.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
OPS_PER_CELL = {"A": 26, "B": 21, "C": 10, "D": 10}

#: The wrappers through which the program launches each kernel.
WRAPPERS = {
    "A": ("sarlacc_tpu_torch.ops.cuda_align", "dir_kernel"),
    "B": ("sarlacc_tpu_torch.ops.cuda_msa", "pair_kernel"),
    "C": ("sarlacc_tpu_torch.ops.cuda_align", "score_kernel"),
    "D": ("sarlacc_tpu_torch.ops.cuda_align", "segments_kernel"),
}

#: Each kernel's ``__global__`` functions, as the device trace names them.
KERNEL_NAMES = {
    "A": ("dir_kernel",),
    "B": ("pair_kernel", "pair_warp_kernel", "pair_wide_kernel"),
    "C": ("score_kernel",),
    "D": ("segments_kernel",),
}


def kernel_pattern(keys: str) -> re.Pattern:
    names = sorted({n for k in keys for n in KERNEL_NAMES[k]})
    return re.compile(r"(?<![A-Za-z_])(" + "|".join(names) + r")(?![A-Za-z_])")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cost_slots(modes, mask) -> list[int]:
    """Slots of the [4, l1, n_pad] match (0-3) and mismatch (4-7) cost
    planes that the columns ``modes`` / ``mask`` select over read codes 0-7."""
    m = modes.cpu().to(torch.int64).clamp(1, 4) - 1
    hit = (mask.cpu().to(torch.int64)[:, None] >> torch.arange(8)) & 1
    return sorted(set(torch.where(hit.bool(), m[:, None], m[:, None] + 4).flatten().tolist()))


def _score_bytes(modes, mask, rows, *tensors) -> float:
    return float(rows) * 4 * (1 + len(cost_slots(modes, mask))) + _nbytes(modes, mask, *tensors)


def bound_s(n_bytes: float, ops: float) -> float:
    return max(n_bytes / PEAK_BYTES, ops / PEAK_F32)


class LaunchRecorder:
    """Wraps the wrappers of kernels ``keys`` and keeps, for every call
    while on, what its bound needs: shapes and the small column tensors,
    never the large outputs (their byte counts only).  ``bounds()`` works
    the bounds out after the window, so no call waits on the card."""

    def __init__(self, keys: str):
        self.keys = keys
        self.calls: list[tuple[str, tuple]] = []
        self.on = False
        self._undo = []
        for key in keys:
            mod, attr = WRAPPERS[key]
            owner = importlib.import_module(mod)
            orig = getattr(owner, attr)

            def wrapped(*args, _key=key, _orig=orig):
                out = _orig(*args)
                if self.on:
                    self.calls.append((_key, self._keep(_key, args, out)))
                return out

            setattr(owner, attr, wrapped)
            self._undo.append((owner, attr, orig))

    @staticmethod
    def _keep(key, args, out):
        if key == "A":  # modes, mask, go, ge, costm, costmm, codes_k, local -> (S, D)
            modes, mask, codes_k = args[0], args[1], args[6]
            return (modes, mask, tuple(codes_k.shape), _nbytes(*out))
        if key == "B":  # codes_a ... (6 inputs) ..., rows, W -> (scores, dirs)
            P = int(args[0].shape[0])
            return (P, int(args[-2]), int(args[-1]), _nbytes(*args[:6]) + _nbytes(*out))
        if key == "C":  # modes, mask, go, ge, costm, costmm, codes_k, lengths, local -> scores
            return (args[0], args[1], args[7])
        # D: modes, mask, segs of (start, rlen, local, open, ext), costm, costmm, codes_k, lens_k
        return (args[0], args[1], tuple(int(s[1]) for s in args[2]), args[6])

    def bounds(self) -> dict:
        """{kernel: summed bound seconds} over the recorded calls."""
        out = {k: 0.0 for k in self.keys}
        for key, kept in self.calls:
            if key == "A":
                modes, mask, (l1, n_pad), out_bytes = kept
                rows = l1 * n_pad
                cells = int(modes.shape[0]) * rows
                b = _score_bytes(modes, mask, rows) + out_bytes
                out[key] += bound_s(b, cells * OPS_PER_CELL["A"])
            elif key == "B":
                P, rows, W, nb = kept
                out[key] += bound_s(nb, P * rows * W * OPS_PER_CELL["B"])
            elif key == "C":
                modes, mask, lengths = kept
                n = int(lengths.shape[0])
                rws = float((lengths.double() + 1).sum())
                b = _score_bytes(modes, mask, rws, lengths) + 4 * n
                out[key] += bound_s(b, rws * int(modes.shape[0]) * OPS_PER_CELL["C"])
            else:
                modes, mask, seg_rows, lens_k = kept
                rws = float((lens_k.double() + 1).sum())
                b = _score_bytes(modes, mask, rws, lens_k) + 4 * len(seg_rows) * lens_k.numel()
                out[key] += bound_s(b, rws * sum(seg_rows) * OPS_PER_CELL["D"])
        return out

    def close(self):
        for owner, attr, orig in self._undo:
            setattr(owner, attr, orig)
        self._undo = []

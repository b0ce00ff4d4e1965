"""Dependent-chain rates per instruction class on the card, and the ALU
ceilings of the score-only DP's cell bodies.

    python -m sarlacc_tpu_torch.tools.op_mix

Counterpart of ``scripts/microbench_op_mix.py`` (its ``_launch``, inner
``kern`` :43, ``pallas_call`` :59).  Each class is a fold-proof DEPENDENT
chain: every step depends on the last and alternates operand registers,
``DEPTH`` = 16 steps per iteration after the iteration's constant add,
``ITERS`` = 2048 iterations, one chain per thread on a grid that fills
every SM (``csrc/op_rates.cu``, entries ``sarlacc_op_mix_*``):

* ``elementwise``: ``max(x + b, b2)``, 2 ops a step;
* ``select+add``: ``(lane < 1 << s % 4 ? b : x) + 1e-7``, 2 ops;
* ``shift+max``: ``max(shfl_up(x, 1 + s % 3), b)``, 2 ops;
* ``shift-stage(3op)``: ``max(lane < sh ? NEG : shfl_up(x, sh), b)`` with
  ``sh = 1 << s % 5``, 3 ops: one stage of a warp's log-shift prefix max.

It prints ops/s per class and, on the card, each class's share of its own
issue ceiling (:data:`MIX_PIPES`, :func:`.op_rates.issue_ceiling`), and
the ALU ceilings of kernels C and D's row-tile body, of the column-outer
body kernel C ran before its row tiles and of a warp-split body from their
censuses (:data:`.op_rates.BODIES`), instead of the TPU script's 45 slots.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..device import resolve_device
from ..native.build import CudaKernel
from .op_rates import (
    BODIES, PEAK_F32, SELECTS, _check_chain_inputs, _f32, census_of,
    chain_inputs, grid_rows, issue_shares, lane_shift_up, require_ops, sass_census,
)
from .timing import device_label, event_ms

__all__ = ["CLASSES", "KERNELS", "MIX_PIPES", "check", "measure", "op_mix", "op_mix_kernel",
           "op_mix_plain"]

ITERS = 2048
DEPTH = 16
#: Class -> (entry suffix, ops per step).
CLASSES = {
    "elementwise": ("elementwise", 2),
    "select+add": ("select_add", 2),
    "shift+max": ("shift_max", 2),
    "shift-stage(3op)": ("shift_stage", 3),
}
NEG = -3.0e38

_P = ctypes.c_void_p
_I = ctypes.c_int

#: ``csrc/op_rates.cu``: replace ``scripts/microbench_op_mix.py``'s ``kern``.
KERNELS = {
    cls: CudaKernel("op_rates.cu", f"sarlacc_op_mix_{entry}", [_P, _P, _P, _P, _I, _I, _P])
    for cls, (entry, _) in CLASSES.items()
}

#: Instructions by pipe of one iteration of each class (``DEPTH`` steps and
#: the iteration's add; the select predicates depend only on the lane and
#: the step, so they leave the loop) and the ops it counts
#: (:func:`.op_rates.issue_ceiling`).
MIX_PIPES = {
    "elementwise": {"fadd": DEPTH + 1, "alu": DEPTH, "ops": 2 * DEPTH + 1},
    "select+add": {"fadd": DEPTH + 1, "alu": DEPTH, "ops": 2 * DEPTH + 1},
    "shift+max": {"shfl": DEPTH, "alu": DEPTH, "fadd": 1, "ops": 2 * DEPTH + 1},
    "shift-stage(3op)": {"shfl": DEPTH, "alu": 2 * DEPTH, "fadd": 1, "ops": 3 * DEPTH + 1},
}

#: Opcodes each class must show at least DEPTH times (see op_rates.require_ops).
MIX_OPS = {
    "elementwise": {("FADD",): DEPTH + 1, ("FMNMX",): DEPTH},
    "select+add": {("FADD",): DEPTH + 1, SELECTS: DEPTH},
    "shift+max": {("SHFL",): DEPTH, ("FMNMX",): DEPTH},
    "shift-stage(3op)": {("SHFL",): DEPTH, ("FMNMX",): DEPTH},
}


def op_mix_plain(cls: str, a, b1, b2, iters: int):
    """Plain PyTorch version of one ``sarlacc_op_mix_*`` kernel over [rows,
    32] inputs: the same chain in the same float32 operations."""
    dev = a.device
    lane = torch.arange(32, device=dev)[None, :]
    eps, neg = _f32(1e-7, dev), _f32(NEG, dev)
    x = a
    for _ in range(iters):
        x = x + eps
        for s in range(DEPTH):
            b = b1 if s & 1 else b2
            if cls == "elementwise":
                x = torch.maximum(x + b, b2)
            elif cls == "select+add":
                x = torch.where(lane < (1 << (s & 3)), b, x) + eps
            elif cls == "shift+max":
                x = torch.maximum(lane_shift_up(x, 1 + s % 3), b)
            elif cls == "shift-stage(3op)":
                sh = 1 << (s % 5)
                x = torch.maximum(torch.where(lane < sh, neg, lane_shift_up(x, sh)), b)
            else:
                raise ValueError(f"unknown class {cls!r}")
    return x


def op_mix_kernel(cls: str, a, b1, b2, iters: int):
    """Launch ``sarlacc_op_mix_<cls>`` over [rows, 32] float32 inputs."""
    rows = _check_chain_inputs(a, b1, b2)
    out = torch.empty_like(a)
    KERNELS[cls].launch(
        a.data_ptr(), b1.data_ptr(), b2.data_ptr(), out.data_ptr(), int(iters),
        rows // 8, torch.cuda.current_stream(a.device),
    )
    return out


def op_mix(cls: str, a, b1, b2, iters: int):
    """The kernel on a CUDA tensor, :func:`op_mix_plain` on a CPU one."""
    if a.is_cuda:
        return op_mix_kernel(cls, a, b1, b2, iters)
    return op_mix_plain(cls, a, b1, b2, iters)


def mix_ceiling(census: dict[str, int], rates: dict[str, float]) -> float:
    """Cells/s if the column body ran at the dependent-chain rates: add,
    max, int, load and store slots at the elementwise rate, selects at the
    select+add rate; a warp-split body's 5 scan stages at the 3-op stage
    rate and its other shuffles (with their fills) at the shift+max rate."""
    shfl_other = census["shuffle"] - 5 if census["shuffle"] else 0
    stages = 5 if census["shuffle"] else 0
    plain = census["add"] + census["max"] - stages + census["int"] + census["load"] + census["store"]
    selects = census["select"] - stages - shfl_other
    sec = (
        plain / rates["elementwise"]
        + selects / rates["select+add"]
        + 3 * stages / rates["shift-stage(3op)"]
        + 2 * shfl_other / rates["shift+max"]
    )
    return 1.0 / sec


def check(device=None, iters: int = 4, reps: int = 3) -> dict:
    """Every class's kernel against :func:`op_mix_plain` on the card at
    ``iters`` iterations, bit for bit, with its instructions counted.
    Returns, per class, max |diff| and the kernel's and plain ms there."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("op_mix.check compares the kernels on the card")
    rows = grid_rows(dev)
    a, b1, b2 = chain_inputs(rows, dev)
    census = sass_census(KERNELS["elementwise"])
    out = {}
    for i, cls in enumerate(CLASSES):
        got = op_mix_kernel(cls, a, b1, b2, iters)
        want = op_mix_plain(cls, a, b1, b2, iters)
        torch.cuda.synchronize(dev)
        if not torch.equal(got, want):
            raise AssertionError(f"op_mix {cls}: kernel differs from its plain version")
        if census is not None:
            require_ops(f"op_mix {cls}", census_of(census, "op_mix_kernel", i), MIX_OPS[cls])
        out[cls] = {
            "max_abs_err": float((got - want).abs().max()),
            "ms": event_ms(lambda: op_mix_kernel(cls, a, b1, b2, iters), reps, dev),
            "plain_ms": event_ms(lambda: op_mix_plain(cls, a, b1, b2, iters), 1, dev, warmup=False),
            "iters": iters, "sass_checked": census is not None,
        }
    return out


def measure(device=None, iters: int = ITERS, reps: int = 5,
            check_first: bool = True, log=print) -> dict:
    """Time every class (after :func:`check` on the card, unless
    ``check_first`` is off); returns per-op rates (ops/s), ms and the ALU
    ceilings (GCUPS)."""
    dev = resolve_device(device)
    rows = grid_rows(dev)
    log(f"[op_mix] {device_label(dev)}")
    log(f"[op_mix] {rows} x 32 threads, one dependent chain each, {DEPTH} steps x {iters} iters")
    if check_first and dev.type == "cuda":
        checked = check(dev)
        log(f"[op_mix] every class equals its plain version at 4 iters"
            + ("; SASS chains intact" if all(v["sass_checked"] for v in checked.values())
               else "; cuobjdump not found, SASS not checked"))
    clock = "events" if dev.type == "cuda" else "host clock"
    a, b1, b2 = chain_inputs(rows, dev)
    out: dict = {"rows": rows, "iters": iters, "classes": {}}
    for cls, (_, nops) in CLASSES.items():
        res = op_mix(cls, a, b1, b2, iters)
        if not bool(torch.isfinite(res).all()):
            raise AssertionError(f"op_mix {cls}: non-finite chain result")
        ms = event_ms(lambda: op_mix(cls, a, b1, b2, iters), reps, dev)
        total = (iters * DEPTH * nops + iters) * rows * 32
        rate = total / (ms * 1e-3)
        out["classes"][cls] = {"ms": ms, "rate": rate}
        log(f"[op_mix] {cls:>16}: {ms:8.3f} ms {clock}  {rate:.4e} ops/s")
    rates = {cls: v["rate"] for cls, v in out["classes"].items()}
    sms, sm_clock, shares = issue_shares(rates, MIX_PIPES, dev)
    for cls, (ceil, share) in shares.items():
        out["classes"][cls].update(issue_ceiling=ceil, issue_share=share)
        log(f"[op_mix] {cls:>16}: issue ceiling {ceil:.4e} ops/s ({sms} SMs x "
            f"{sm_clock / 1e6:.0f} MHz), {100 * share:.1f}% of it; "
            f"{100 * rates[cls] / PEAK_F32:.1f}% of the 67 TFLOP/s float32 peak")
    for name, cen in BODIES:
        g = mix_ceiling(cen, rates) / 1e9
        out[f"{name} ceiling GCUPS"] = g
        log(f"[op_mix] {name} {cen}: mix ceiling {g:.1f} GCUPS")
    return out


def main(argv=None) -> int:
    if argv:
        raise SystemExit("usage: python -m sarlacc_tpu_torch.tools.op_mix")
    measure()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

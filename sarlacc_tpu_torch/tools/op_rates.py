"""Per-class instruction throughput on the card, and what it means for the
score-only DP's instruction mix.

    python -m sarlacc_tpu_torch.tools.op_rates

Counterpart of ``scripts/microbench_vpu_ops.py`` (its ``pallas_call`` at
:67): each class runs ``CHAINS`` = 4 independent chains of ``DEPTH`` = 8
ops per iteration for ``ITERS`` = 512 iterations, so the measurement is
throughput, not latency.  Classes (``csrc/op_rates.cu``, entries
``sarlacc_op_rates_*``): ``add``, ``max``, ``select``, and the TPU rolls'
counterparts ``shfl1`` (``__shfl_up_sync`` by 1, then an add) and
``shfl16`` (by 16, the largest shift inside a warp, then an add).  Unlike
the TPU script, which runs one (256, 128) tile on one core, the grid fills
every SM.

It prints ops/s per class, a shuffle's cost in add slots (the script's
``pair_cost``), and the ALU ceiling in GCUPS of kernels C and D's row-tile
body, of the column-outer body the ablation keeps and of a warp-split
column body, from their op censuses (:data:`BODIES`).  Before timing, each
kernel is held bit for bit against :func:`op_rates_plain` at a reduced
iteration count, and the built library's instructions are counted
(:func:`sass_census`) to show the chains did not fold.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..native.build import CudaKernel, check_tensor, nvcc_path
from .timing import device_label, event_ms

__all__ = [
    "BODIES", "CLASSES", "COLUMN_BODY_CENSUS", "KERNELS", "ROW_TILE_CENSUS", "WARP_SPLIT_CENSUS",
    "chain_inputs", "grid_rows",
    "check", "lane_shift_up", "measure", "op_rates", "op_rates_kernel", "op_rates_plain",
    "sass_census",
]

ITERS = 512
CHAINS = 4
DEPTH = 8
CLASSES = ("add", "max", "select", "shfl1", "shfl16")
#: Lanes a ``select`` takes ``b`` in: 1 of 32, the script's 8 rows of 256.
SELECT_LANES = 1
#: Blocks of 256 threads resident per SM at full occupancy (2048 threads).
BLOCKS_PER_SM = 8
#: Full-occupancy waves of blocks per launch: ~0.6 ms for the add class.
WAVES = 4

_P = ctypes.c_void_p
_I = ctypes.c_int

#: ``csrc/op_rates.cu``: replace ``scripts/microbench_vpu_ops.py::_bench_kernel``.
KERNELS = {
    cls: CudaKernel("op_rates.cu", f"sarlacc_op_rates_{cls}", [_P, _P, _P, _P, _I, _I, _I, _I, _P])
    for cls in CLASSES
}

#: Per-cell ops of the column-outer score body (one thread per read walking
#: the columns, S and H in device-memory planes), counted from its source,
#: ``csrc/score_ablation.cu``'s ``full`` cell: add/sub/mul 10 (``Hn`` 2,
#: ``M`` 1, ``V`` 4 with the int-to-float of the row, ``B`` 3), max 4
#: (``Hn``, ``mv``, ``out``, ``cum``), select 3 (the cost plane, and ``V``
#: and ``B`` on the free-gap column), int 5 (the cost bit's shift and mask,
#: the address, the loop's increment and compare), loads 4, stores 2,
#: shuffles 0.
COLUMN_BODY_CENSUS = {"add": 10, "max": 4, "select": 3, "int": 5, "load": 4, "store": 2, "shuffle": 0}
#: Per-cell ops of kernels C and D's row-tile cell (``csrc/score_kernel.cu``,
#: ``Tile::row``): add/sub 6 (``Hn`` 2, ``M`` 1, ``V`` 1, ``B`` 2), max 4,
#: int 1 (the cost's address in the row table), loads 2 (the (code, column)
#: offset and the cost, both from shared memory), no select or store (the
#: ramps, the row table and the peeled column's selects are per row).
ROW_TILE_CENSUS = {"add": 6, "max": 4, "select": 0, "int": 1, "load": 2, "store": 0, "shuffle": 0}
#: A warp-split column body (a read's rows across the 32 lanes of a warp):
#: the same cell work, with the vertical-gap prefix max as a 5-stage
#: log-shift scan (a shuffle, a fill select and a max per stage) and two
#: shift-by-one shuffles (``S[i-1]`` for the diagonal, ``cum[i-1]`` for
#: ``V``) with their fills.
WARP_SPLIT_CENSUS = {
    **COLUMN_BODY_CENSUS, "max": 4 + 5, "select": 3 + 5 + 2, "shuffle": 5 + 2,
}

#: The bodies whose ALU ceilings the tools print: (label, census).
BODIES = (
    ("row-tile body (kernels C, D)", ROW_TILE_CENSUS),
    ("column body (ablation full)", COLUMN_BODY_CENSUS),
    ("warp-split column body", WARP_SPLIT_CENSUS),
)


def grid_rows(dev: torch.device) -> int:
    """Rows of 32 lanes for :data:`WAVES` full-occupancy waves over every
    SM (8 rows per block of 256 threads); 64 rows on the CPU."""
    if dev.type != "cuda":
        return 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * BLOCKS_PER_SM * WAVES * 8


def lane_shift_up(x: torch.Tensor, d: int) -> torch.Tensor:
    """``__shfl_up_sync(x, d)`` over the last (lane) axis: lane l takes lane
    l-d; lanes below ``d`` keep their own value."""
    lanes = torch.arange(x.shape[-1], device=x.device)
    return torch.where(lanes < d, x, torch.roll(x, d, dims=-1))


def _f32(v, dev):
    return torch.tensor(v, dtype=torch.float32, device=dev)


def chain_inputs(rows: int, dev):
    """Random chain inputs (a, b1, b2), [rows, 32] float32: normal * 1e-3
    from numpy seed 0, as microbench_op_mix.py draws them."""
    rng = np.random.default_rng(0)
    return tuple(
        torch.as_tensor((rng.normal(size=(rows, 32)) * 1e-3).astype(np.float32), device=dev)
        for _ in range(3)
    )


def lane_mask(rows: int, k: int, dev) -> torch.Tensor:
    """[rows, 32] bool: lane < k."""
    return (torch.arange(32, device=dev) < k)[None, :].expand(rows, 32)


def op_rates_plain(cls: str, a, b1, b2, iters: int, m1, m2):
    """Plain PyTorch version of one ``sarlacc_op_rates_*`` kernel: the same
    chains in the same float32 operations, so the same bits.  ``m1``/``m2``
    are the select predicates of even/odd steps (the kernel's
    ``lane < k1``/``lane < k2``)."""
    xs = [a + _f32(float(c), a.device) for c in range(CHAINS)]
    for _ in range(iters):
        for d in range(DEPTH):
            b = b2 if d & 1 else b1
            m = m2 if d & 1 else m1
            for c in range(CHAINS):
                x = xs[c]
                if cls == "add":
                    x = x + b
                elif cls == "max":
                    x = torch.maximum(x, b)
                elif cls == "select":
                    x = torch.where(m, b, x)
                elif cls == "shfl1":
                    x = lane_shift_up(x, 1) + b
                elif cls == "shfl16":
                    x = lane_shift_up(x, 16) + b
                else:
                    raise ValueError(f"unknown class {cls!r}")
                xs[c] = x
    return ((xs[0] + xs[1]) + xs[2]) + xs[3]


def _check_chain_inputs(a, b1, b2):
    rows = int(a.shape[0])
    if rows % 8:
        raise ValueError(f"rows must fill blocks of 256 threads (a multiple of 8), got {rows}")
    for t, name in ((a, "a"), (b1, "b1"), (b2, "b2")):
        check_tensor(t, name, torch.float32, (rows, 32))
    return rows


def op_rates_kernel(cls: str, a, b1, b2, iters: int, k1: int, k2: int):
    """Launch ``sarlacc_op_rates_<cls>`` over [rows, 32] float32 inputs."""
    rows = _check_chain_inputs(a, b1, b2)
    out = torch.empty_like(a)
    KERNELS[cls].launch(
        a.data_ptr(), b1.data_ptr(), b2.data_ptr(), out.data_ptr(), int(iters),
        int(k1), int(k2), rows // 8, torch.cuda.current_stream(a.device),
    )
    return out


def op_rates(cls: str, a, b1, b2, iters: int, k1: int = SELECT_LANES, k2: int = SELECT_LANES):
    """The kernel on a CUDA tensor, :func:`op_rates_plain` on a CPU one."""
    if a.is_cuda:
        return op_rates_kernel(cls, a, b1, b2, iters, k1, k2)
    rows = int(a.shape[0])
    return op_rates_plain(
        cls, a, b1, b2, iters, lane_mask(rows, k1, a.device), lane_mask(rows, k2, a.device)
    )


_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def sass_census(kernel: CudaKernel) -> dict[str, dict[str, int]] | None:
    """Opcode counts per kernel function of ``kernel``'s built library
    (``cuobjdump -sass``); predicated MOVs count as ``@MOV``.  None where
    the toolkit has no ``cuobjdump``."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run(
        [tool, "-sass", kernel.build()], capture_output=True, text=True, check=True
    ).stdout
    census: dict[str, dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        if "Function :" in line:
            current = census.setdefault(line.split("Function :", 1)[1].strip(), {})
            continue
        m = _SASS_OP.search(line)
        if current is None or not m:
            continue
        op = "@MOV" if (m.group(1) and m.group(2) == "MOV") else m.group(2)
        current[op] = current.get(op, 0) + 1
    return census


def census_of(census, kernel_name: str, index: int) -> dict[str, int]:
    """The counts of ``kernel_name<index>`` (a template instance) in ``census``."""
    tag = f"{kernel_name}ILi{index}EE"
    found = [v for k, v in census.items() if tag in k]
    if len(found) != 1:
        raise AssertionError(f"{tag}: {len(found)} functions in the SASS listing")
    return found[0]


def require_ops(what: str, counts: dict[str, int], need: dict[tuple, int]) -> None:
    """Raise unless, for each group of opcodes, their static count reaches
    the chain's per-iteration op count (the iteration loop is not unrolled,
    so a folded chain shows fewer)."""
    for ops, n in need.items():
        got = sum(counts.get(op, 0) for op in ops)
        if got < n:
            raise AssertionError(
                f"{what}: {got} x {'/'.join(ops)} in the SASS, the chain needs {n}: "
                f"the compiler folded it ({counts})"
            )


#: Opcodes each class must show at least CHAINS * DEPTH times.
SELECTS = ("FSEL", "SEL", "@MOV")
RATE_OPS = {
    "add": {("FADD",): CHAINS * DEPTH},
    "max": {("FMNMX",): CHAINS * DEPTH},
    "select": {SELECTS: CHAINS * DEPTH},
    "shfl1": {("SHFL",): CHAINS * DEPTH, ("FADD",): CHAINS * DEPTH},
    "shfl16": {("SHFL",): CHAINS * DEPTH, ("FADD",): CHAINS * DEPTH},
}


def pair_cost(pair_rate: float, add_rate: float) -> float:
    """Seconds per shuffle from a shuffle+add pair's rate (the script's
    ``pair_cost``): 2/pair - 1/add, floored just above zero."""
    return max(2.0 / pair_rate - 1.0 / add_rate, 1e-18)


def alu_slots(census: dict[str, int], rates: dict[str, float]) -> float:
    """Add-slots per cell: add, int, load and store at the add rate (the
    last two issue one instruction each; their memory time is not in this
    model), max and select at their measured cost, shuffles at
    their pair cost."""
    r_add = rates["add"]
    shfl = (pair_cost(rates["shfl1"], r_add) + pair_cost(rates["shfl16"], r_add)) / 2 * r_add
    return (
        census["add"] + census["int"] + census["load"] + census["store"]
        + census["max"] * r_add / rates["max"]
        + census["select"] * r_add / rates["select"]
        + census["shuffle"] * shfl
    )


def check(device=None, iters: int = 4, reps: int = 3) -> dict:
    """Every class's kernel against :func:`op_rates_plain` on the card at
    ``iters`` iterations, bit for bit, and its instructions counted
    (:func:`sass_census`).  Returns, per class, max |diff| and the kernel's
    and the plain version's ms at that size."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("op_rates.check compares the kernels on the card")
    rows = grid_rows(dev)
    a, b1, b2 = chain_inputs(rows, dev)
    m = lane_mask(rows, SELECT_LANES, dev)
    census = sass_census(KERNELS["add"])
    out = {}
    for i, cls in enumerate(CLASSES):
        got = op_rates_kernel(cls, a, b1, b2, iters, SELECT_LANES, SELECT_LANES)
        want = op_rates_plain(cls, a, b1, b2, iters, m, m)
        torch.cuda.synchronize(dev)
        if not torch.equal(got, want):
            raise AssertionError(f"op_rates {cls}: kernel differs from its plain version")
        if census is not None:
            require_ops(f"op_rates {cls}", census_of(census, "op_rates_kernel", i), RATE_OPS[cls])
        out[cls] = {
            "max_abs_err": float((got - want).abs().max()),
            "ms": event_ms(lambda: op_rates_kernel(cls, a, b1, b2, iters, SELECT_LANES, SELECT_LANES), reps, dev),
            "plain_ms": event_ms(lambda: op_rates_plain(cls, a, b1, b2, iters, m, m), 1, dev),
            "iters": iters, "sass_checked": census is not None,
        }
    return out


def measure(device=None, iters: int = ITERS, reps: int = 5,
            check_first: bool = True, log=print) -> dict:
    """Time every class (after :func:`check` on the card, unless
    ``check_first`` is off); returns rates (ops/s), ms, the shuffle cost in
    add slots and the two ALU ceilings (GCUPS)."""
    dev = resolve_device(device)
    rows = grid_rows(dev)
    log(f"[op_rates] {device_label(dev)}")
    log(f"[op_rates] {rows} x 32 threads, {CHAINS} chains x {DEPTH} deep x {iters} iters")
    if check_first and dev.type == "cuda":
        checked = check(dev)
        log(f"[op_rates] every class equals its plain version at 4 iters"
            + ("; SASS chains intact" if all(v["sass_checked"] for v in checked.values())
               else "; cuobjdump not found, SASS not checked"))
    clock = "events" if dev.type == "cuda" else "host clock"
    # The script's inputs: a = 1, b = 0.5 everywhere.
    a = torch.ones((rows, 32), dtype=torch.float32, device=dev)
    b = torch.full((rows, 32), 0.5, dtype=torch.float32, device=dev)
    out: dict = {"rows": rows, "iters": iters, "classes": {}}
    for cls in CLASSES:
        res = op_rates(cls, a, b, b, iters)
        if not bool(torch.isfinite(res).all()):
            raise AssertionError(f"op_rates {cls}: non-finite chain result")
        ms = event_ms(lambda: op_rates(cls, a, b, b, iters), reps, dev)
        rate = iters * CHAINS * DEPTH * rows * 32 / (ms * 1e-3)
        out["classes"][cls] = {"ms": ms, "rate": rate}
        log(f"[op_rates] {cls:>7}: {ms:8.3f} ms {clock}  {rate:.4e} ops/s")
    rates = {cls: v["rate"] for cls, v in out["classes"].items()}
    r_add = rates["add"]
    out["shfl1_slots"] = pair_cost(rates["shfl1"], r_add) * r_add
    out["shfl16_slots"] = pair_cost(rates["shfl16"], r_add) * r_add
    log(f"[op_rates] a shuffle costs {out['shfl1_slots']:.2f} add slots at shift 1, "
        f"{out['shfl16_slots']:.2f} at shift 16")
    for name, cen in BODIES:
        slots = alu_slots(cen, rates)
        out[f"{name} slots"] = slots
        out[f"{name} ceiling GCUPS"] = r_add / slots / 1e9
        log(f"[op_rates] {name} {cen}: {slots:.1f} add slots/cell -> "
            f"ALU ceiling {r_add / slots / 1e9:.1f} GCUPS")
    return out


def main(argv=None) -> int:
    if argv:
        raise SystemExit("usage: python -m sarlacc_tpu_torch.tools.op_rates")
    measure()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

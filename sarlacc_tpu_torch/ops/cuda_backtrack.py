"""Kernel G: the template backtrack over kernel A's directions, on the card.

:func:`qmap_walk` and :func:`string_walk` launch ``csrc/backtrack_kernel.cu``
(one thread a read, each read's walk to its end in one launch, no host
sync; qmap climbs the fitting column in slabs its warp loads together),
replacing ``sarlacc_tpu/ops/backtrack.py::qmap_walk_device`` and
``::string_walk_device``.  Both take CUDA tensors only and raise on
anything else; their plain PyTorch versions are ``ops/backtrack.py``'s
``_qmap_walk_plain`` and ``_string_walk_plain``, which
``ops/backtrack.py::qmap_walk`` and ``::string_walk`` run on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..native.build import CudaKernel, check_tensor, kernel_resources

__all__ = [
    "COUNTS", "QMAP_KERNEL", "STRING_KERNEL", "backtrack_kernel_resources", "qmap_walk",
    "string_walk",
]

_P = ctypes.c_void_p
_I = ctypes.c_int

#: The measurement-only counters a launch adds to (``fetches=``, int64
#: [len(COUNTS)]), the kernel's ``enum Count``: fetching steps; ``rounds``,
#: the most dependent round trips of any lane (slab loads while it climbs
#: plus single fetches; the maximum, not a sum); fetching steps by kind:
#: up steps in the last column and inside, diagonal, left-run starts, and
#: steps that move nothing (a malformed plane's row <= 0 with d < 0).
COUNTS = ("fetches", "rounds", "up_last", "up_inner", "diag", "left", "other")

#: ``csrc/backtrack_kernel.cu``: replaces ``sarlacc_tpu/ops/backtrack.py::qmap_walk_device``.
#: As for :data:`STRING_KERNEL`, the pointer before the stream takes
#: :data:`COUNTS` (``fetches=``).
QMAP_KERNEL = CudaKernel("backtrack_kernel.cu", "sarlacc_qmap_kernel",
                         [_P, _I, _I, _I, _P, _I, _P, _P, _P, _P])

#: ``csrc/backtrack_kernel.cu``: replaces ``sarlacc_tpu/ops/backtrack.py::string_walk_device``.
STRING_KERNEL = CudaKernel("backtrack_kernel.cu", "sarlacc_string_kernel",
                           [_P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P])


def _inputs(dirs, lengths, fetches):
    R, l1, n_pad = dirs.shape
    if l1 < 1 or lengths.shape[0] > n_pad:
        raise ValueError(f"kernel G: {lengths.shape[0]} lengths for {n_pad} lanes of {l1} rows")
    check_tensor(dirs, "dirs", torch.int16, (R, l1, n_pad))
    lengths = lengths.to(torch.int32).contiguous()
    check_tensor(lengths, "lengths", torch.int32, (lengths.shape[0],))
    if fetches is not None:
        check_tensor(fetches, "fetches", torch.int64, (len(COUNTS),))
        fetches = fetches.data_ptr()
    return R, l1, n_pad, lengths, fetches


def qmap_walk(dirs, lengths, fetches=None):
    """Kernel G's query maps from ``dirs`` int16 [R, l1, n_pad] and the
    reads' lengths (int32 [n], n <= n_pad; lanes past n walk from row 0).
    Returns (is_match bool [n_pad, R+1], dp_row int32 [n_pad, R+1]),
    bit-equal to ``ops/backtrack.py::_qmap_walk_plain``; the kernel writes
    every cell.  ``fetches``, an int64 [len(COUNTS)] CUDA tensor, gains the
    walk's :data:`COUNTS`; only measurement sets it (the pipeline's callers
    pass None)."""
    R, l1, n_pad, lengths, fetches = _inputs(dirs, lengths, fetches)
    dev = dirs.device
    om = torch.empty((n_pad, R + 1), dtype=torch.bool, device=dev)
    orow = torch.empty((n_pad, R + 1), dtype=torch.int32, device=dev)
    if n_pad:
        QMAP_KERNEL.launch(dirs.data_ptr(), R, l1, n_pad, lengths.data_ptr(), lengths.shape[0],
                           om.data_ptr(), orow.data_ptr(), fetches, torch.cuda.current_stream(dev))
    return om, orow


def string_walk(dirs, lengths, fetches=None):
    """Kernel G's alignment emissions from ``dirs`` int16 [R, l1, n_pad]
    and the reads' lengths.  Returns (a_pos int32 [n_pad, T], b_pos int32
    [n_pad, T], ncols int32 [n_pad]), T = R + l1 + 1, bit-equal to
    ``ops/backtrack.py::_string_walk_plain``, every cell written by the
    kernel; ``fetches`` as :func:`qmap_walk`'s."""
    R, l1, n_pad, lengths, fetches = _inputs(dirs, lengths, fetches)
    dev = dirs.device
    T = R + l1 + 1
    oa = torch.empty((n_pad, T), dtype=torch.int32, device=dev)
    ob = torch.empty((n_pad, T), dtype=torch.int32, device=dev)
    ncols = torch.empty(n_pad, dtype=torch.int32, device=dev)
    if n_pad:
        STRING_KERNEL.launch(dirs.data_ptr(), R, l1, n_pad, lengths.data_ptr(), lengths.shape[0],
                             oa.data_ptr(), ob.data_ptr(), ncols.data_ptr(), fetches,
                             torch.cuda.current_stream(dev))
    return oa, ob, ncols


def backtrack_kernel_resources() -> dict:
    """Kernel G's two walks as the path launches them (keys ``"G:qmap"``,
    ``"G:string"``; values as ``ops/cuda_align.py::score_kernel_resources``'s)."""
    fn = QMAP_KERNEL.function("sarlacc_backtrack_attrs", [_I, _P])
    return {f"G:{name}": kernel_resources(fn, i) for i, name in enumerate(("qmap", "string"))}

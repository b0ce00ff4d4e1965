"""Kernels E and F: the MSA's merge DP + walk and its Gotoh pair walk, on the card.

* :func:`pair_walk` launches kernel F (``csrc/walk_kernel.cu``): the
  Gotoh walk over kernel B's [rows, P, W] direction bytes and each pair's
  identity, replacing ``sarlacc_tpu/ops/msa.py::_pair_walk_kernel`` and
  ``::_pair_ident_kernel``.
* :func:`merge_dp_walk` launches kernel E (``csrc/merge_kernel.cu``): one
  merge wave's gapless max-weight-trace DP over its cost planes and the walk
  of its choices, replacing ``sarlacc_tpu/ops/msa.py::_merge_dp_walk``.

Both take CUDA tensors only and raise on anything else; their plain PyTorch
versions are ``ops/msa.py``'s ``_pair_walk_kernel`` + ``_pair_ident_kernel``
and ``_profile_merge_kernel`` + ``_merge_walk_kernel``, which
``ops/msa.py::_pair_walk`` and ``::_merge_dp_walk`` run on CPU tensors.
This module does not import ``ops/msa.py`` (which imports it).
"""

from __future__ import annotations

import ctypes

import torch

from ..native.build import CudaKernel, check_tensor, kernel_resources

__all__ = [
    "MERGE_KERNEL", "MERGE_ROUTES", "WALK_KERNEL", "WARP_MAX_WIDTH", "merge_dp_walk", "merge_route",
    "pair_walk", "walk_kernel_resources",
]

_P = ctypes.c_void_p
_I = ctypes.c_int

#: ``csrc/walk_kernel.cu``: replaces ``sarlacc_tpu/ops/msa.py::_pair_walk_kernel``.
WALK_KERNEL = CudaKernel(
    "walk_kernel.cu",
    "sarlacc_walk_kernel",
    [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P],
)

#: ``csrc/merge_kernel.cu``: replaces ``sarlacc_tpu/ops/msa.py::_merge_dp_walk``.
MERGE_KERNEL = CudaKernel(
    "merge_kernel.cu",
    "sarlacc_merge_kernel",
    [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P],
)

#: Kernel E's routes, in the kernel's numbering.
MERGE_ROUTES = ("warp", "block")

#: Widest band of kernel E's warp route: 32 lanes of at most 16 cells.
WARP_MAX_WIDTH = 512


def merge_route(width: int) -> str:
    """Kernel E's route for a band of ``width`` cells: one warp a merge up
    to :data:`WARP_MAX_WIDTH`, one block a merge above, with no upper limit
    (a merge band spans the two profiles' difference in columns, which no
    read length caps)."""
    return "warp" if width <= WARP_MAX_WIDTH else "block"


def pair_walk(dirs, lens_a, lens_b, lo, codes_a, codes_b):
    """Kernel F on one kernel-B launch's output.

    ``dirs`` int8 [rows, P, W] (``ops/cuda_msa.py``'s layout); ``lens_a``,
    ``lens_b``, ``lo`` int32 [P]; ``codes_a`` int8 [P, LA] and ``codes_b``
    int8 [P, LB] (LB >= 1), the padded codes kernel B read.  Returns (jmat
    int32 [rows, P]: for DP row i, stored at i - 1, the matched B-position,
    0 for none; identity float32 [P]), both bit-equal to
    ``_pair_walk_kernel`` then ``_pair_ident_kernel``.
    """
    rows, P, W = dirs.shape
    LA, LB = codes_a.shape[1], codes_b.shape[1]
    if W < 1 or LB < 1:
        raise ValueError(f"kernel F needs a band and B codes: W {W}, B width {LB}")
    check_tensor(dirs, "dirs", torch.int8, (rows, P, W))
    for name, t in (("lens_a", lens_a), ("lens_b", lens_b), ("lo", lo)):
        check_tensor(t, name, torch.int32, (P,))
    check_tensor(codes_a, "codes_a", torch.int8, (P, LA))
    check_tensor(codes_b, "codes_b", torch.int8, (P, LB))
    dev = dirs.device
    jmat = torch.zeros((rows, P), dtype=torch.int32, device=dev)
    ident = torch.empty(P, dtype=torch.float32, device=dev)
    if P:
        WALK_KERNEL.launch(
            dirs.data_ptr(), P, rows, W, lens_a.data_ptr(), lens_b.data_ptr(), lo.data_ptr(),
            codes_a.data_ptr(), LA, codes_b.data_ptr(), LB, jmat.data_ptr(), ident.data_ptr(),
            torch.cuda.current_stream(dev),
        )
    return jmat, ident


def merge_dp_walk(cost, la, lb, lo, kmax):
    """Kernel E on one merge wave: ``cost`` float32 [Pp, rows, W] (after
    ``_merge_cost_init`` and the accumulation), ``la``, ``lb``, ``lo``,
    ``kmax`` int32 [Pp].  Returns jmat int32 [rows, Pp], bit-equal to
    ``_profile_merge_kernel`` then ``_merge_walk_kernel``."""
    return _launch_merge(cost, la, lb, lo, kmax)[0]


def _launch_merge(cost, la, lb, lo, kmax):
    """:func:`merge_dp_walk`, also returning the [rows, Pp, W] int8 choice
    scratch (rows past each merge's ``la`` are not written), which the card
    tests hold to the plain DP's."""
    Pp, rows, W = cost.shape
    if W < 32 or W & (W - 1):
        raise ValueError(f"band width {W}: kernel E takes a power of two from 32 up")
    route = merge_route(W)
    check_tensor(cost, "cost", torch.float32, (Pp, rows, W))
    if cost.data_ptr() % 16:
        raise ValueError("cost must start on a 16-byte boundary (the warp route's vector loads)")
    for name, t in (("la", la), ("lb", lb), ("lo", lo), ("kmax", kmax)):
        check_tensor(t, name, torch.int32, (Pp,))
    dev = cost.device
    jmat = torch.zeros((rows, Pp), dtype=torch.int32, device=dev)
    choices = torch.empty((rows, Pp, W), dtype=torch.int8, device=dev)
    scratch = None
    if route == "block":
        scratch = torch.empty((Pp, 2, W), dtype=torch.float32, device=dev)
    if Pp:
        MERGE_KERNEL.launch(
            cost.data_ptr(), Pp, rows, W, la.data_ptr(), lb.data_ptr(), lo.data_ptr(),
            kmax.data_ptr(), MERGE_ROUTES.index(route),
            None if scratch is None else scratch.data_ptr(), choices.data_ptr(),
            jmat.data_ptr(), torch.cuda.current_stream(dev),
        )
    return jmat, choices


def walk_kernel_resources(widths=(256, 512, 1024)) -> dict:
    """Kernels F and E as compiled, from ``cudaFuncGetAttributes``: key
    ``"F"``, and ``"E:warp@256"`` and so on for each band width of
    ``widths`` on its route (:func:`merge_route`); values as
    ``ops/cuda_align.py::score_kernel_resources``'s."""
    out = {"F": kernel_resources(WALK_KERNEL.function("sarlacc_walk_attrs", [_P]))}
    fn = MERGE_KERNEL.function("sarlacc_merge_attrs", [_I, _I, _P])
    for w in widths:
        route = merge_route(w)
        out[f"E:{route}@{w}"] = kernel_resources(fn, MERGE_ROUTES.index(route), w)
    return out

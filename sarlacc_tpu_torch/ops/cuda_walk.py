"""Kernels E and F: the MSA's merge wave and its Gotoh pair walk, on the card.

* :func:`pair_walk` launches kernel F (``csrc/walk_kernel.cu``): the
  Gotoh walk over kernel B's [rows, P, W] direction bytes and each pair's
  identity, replacing ``sarlacc_tpu/ops/msa.py::_pair_walk_kernel`` and
  ``::_pair_ident_kernel``.
* :func:`merge_dp_walk` launches kernel E (``csrc/merge_kernel.cu``): one
  merge wave from its library entries (sorted by cell, with row pointers)
  to jmat, building each live row's costs on chip, then the gapless
  max-weight-trace DP and the walk of its choices, replacing
  ``sarlacc_tpu/ops/msa.py``'s ``_merge_cost_init``, ``_merge_accum_kernel``
  and ``_merge_dp_walk``.

Both take CUDA tensors only and raise on anything else; their plain PyTorch
versions are ``ops/msa.py``'s ``_pair_walk_kernel`` + ``_pair_ident_kernel``
and ``_merge_entries_plain``, which ``ops/msa.py::_pair_walk`` and
``::merge_wave_from_library`` run on CPU tensors.  This module does not
import ``ops/msa.py`` (which imports it).
"""

from __future__ import annotations

import ctypes

import torch

from ..native.build import CudaKernel, check_tensor, kernel_resources

__all__ = [
    "BLOCK_MAX_WIDTH", "MERGE_KERNEL", "MERGE_ROUTES", "WALK_KERNEL", "WARP_MAX_WIDTH",
    "merge_dp_walk", "merge_route", "pair_walk", "unpack_choices", "walk_kernel_resources",
]

_P = ctypes.c_void_p
_I = ctypes.c_int

#: ``csrc/walk_kernel.cu``: replaces ``sarlacc_tpu/ops/msa.py::_pair_walk_kernel``.
WALK_KERNEL = CudaKernel(
    "walk_kernel.cu",
    "sarlacc_walk_kernel",
    [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P],
)

#: ``csrc/merge_kernel.cu``: replaces ``sarlacc_tpu/ops/msa.py``'s chain
#: ``_merge_cost_init`` -> ``_merge_accum_kernel`` -> ``_merge_dp_walk``.
MERGE_KERNEL = CudaKernel(
    "merge_kernel.cu",
    "sarlacc_merge_kernel",
    [_P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P],
)

#: Kernel E's routes, in the kernel's numbering.
MERGE_ROUTES = ("warp", "block", "wide")

#: Widest band of kernel E's warp route: 32 lanes of at most 16 cells.
WARP_MAX_WIDTH = 512

#: Widest band of kernel E's block route: 256 threads of at most 32 cells,
#: the row's costs twice in shared memory (64 KB).
BLOCK_MAX_WIDTH = 8192


def merge_route(width: int) -> str:
    """Kernel E's route for a band of ``width`` cells: one warp a merge up
    to :data:`WARP_MAX_WIDTH`, one block a merge with the row in shared
    memory up to :data:`BLOCK_MAX_WIDTH`, one block a merge with the row in
    device scratch above, with no upper limit (a merge band spans the two
    profiles' difference in columns, which no read length caps)."""
    if width <= WARP_MAX_WIDTH:
        return "warp"
    return "block" if width <= BLOCK_MAX_WIDTH else "wide"


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


def merge_dp_walk(cols, w, rowptr, la, lb, lo, kmax, rows: int, width: int):
    """Kernel E on one merge wave's library entries, stable-sorted by cell
    (``ops/msa.py::_sorted_entries``): ``cols`` int32 [N], each entry's band
    cell k; ``w`` float32 [N], their weights; ``rowptr`` int32 [Pp * rows +
    1], DP row i of merge m's entries at ``rowptr[m * rows + i - 1]`` up to
    ``rowptr[m * rows + i]`` (entries past ``rowptr[-1]`` are dropped ones);
    ``la``, ``lb``, ``lo``, ``kmax`` int32 [Pp].  Returns jmat int32 [rows,
    Pp], bit-equal to ``ops/msa.py::_merge_entries_plain``
    (``_merge_cost_init``, the entries added in order by ``_ordered_add_``,
    ``_profile_merge_kernel`` and ``_merge_walk_kernel``)."""
    return _launch_merge(cols, w, rowptr, la, lb, lo, kmax, rows, width)[0]


def _launch_merge(cols, w, rowptr, la, lb, lo, kmax, rows: int, width: int):
    """:func:`merge_dp_walk`, also returning E's choice scratch, int32
    [rows, Pp, width / 16] of two bits a cell (:func:`unpack_choices`; rows
    past each merge's ``la`` are not written), which the card tests hold to
    the plain DP's."""
    W = int(width)
    if W < 32 or W & (W - 1):
        raise ValueError(f"band width {W}: kernel E takes a power of two from 32 up")
    route = merge_route(W)
    Pp, N = la.shape[0], cols.shape[0]
    if N >= 2**31:
        raise ValueError(f"{N} entries: kernel E takes fewer than 2^31 a wave")
    check_tensor(cols, "cols", torch.int32, (N,))
    check_tensor(w, "w", torch.float32, (N,))
    check_tensor(rowptr, "rowptr", torch.int32, (Pp * rows + 1,))
    for name, t in (("la", la), ("lb", lb), ("lo", lo), ("kmax", kmax)):
        check_tensor(t, name, torch.int32, (Pp,))
    dev = la.device
    jmat = torch.zeros((rows, Pp), dtype=torch.int32, device=dev)
    choices = torch.empty((rows, Pp, W // 16), dtype=torch.int32, device=dev)
    scratch = None
    if route == "wide":
        scratch = torch.empty((Pp, 3, W), dtype=torch.float32, device=dev)
    if Pp:
        MERGE_KERNEL.launch(
            cols.data_ptr(), w.data_ptr(), N, rowptr.data_ptr(), Pp, rows, W, la.data_ptr(),
            lb.data_ptr(), lo.data_ptr(), kmax.data_ptr(), MERGE_ROUTES.index(route),
            None if scratch is None else scratch.data_ptr(), choices.data_ptr(),
            jmat.data_ptr(), torch.cuda.current_stream(dev),
        )
    return jmat, choices


def unpack_choices(words, width: int):
    """Kernel E's packed choices (int32 [..., width / 16], cell k at bits
    2 * (k % 16) of word k // 16) as int8 [..., width], one choice a cell."""
    shifts = 2 * torch.arange(16, dtype=torch.int32, device=words.device)
    cells = (words[..., None] >> shifts) & 3
    return cells.reshape(*words.shape[:-1], int(width)).to(torch.int8)


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

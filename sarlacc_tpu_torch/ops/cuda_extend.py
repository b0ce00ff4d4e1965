"""Kernel H: the device library's consistency extension, on the card.

:func:`extend_library` launches ``csrc/extend_kernel.cu`` on every chunk of
one library build, replacing ``sarlacc_tpu/ops/msa.py::_extend_chunk_kernel``
and the host's slot tables: each lane derives its slot from the per-job and
per-group tables and the identities; every chunk's counting pass, then one
device scan of all pair totals, are queued with no host wait; one readback
of the offsets gives the table's size and each pair's count; then every
chunk's writing pass fills one preallocated table.  It takes CUDA tensors
only and raises on anything else; its plain PyTorch version is
``ops/msa.py::_extend_library_plain``, which ``ops/msa.py::_extend_library``
runs on CPU tensors.  This module does not import ``ops/msa.py`` (which
imports it).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..native.build import CudaKernel, check_tensor, kernel_resources

__all__ = ["EXTEND_KERNEL", "MAX_SLOTS", "ExtendBuild", "extend_library", "extend_kernel_resources"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: ``csrc/extend_kernel.cu``: replaces ``sarlacc_tpu/ops/msa.py::_extend_chunk_kernel``.
#: One entry point for the three passes (its first argument), so a build of
#: C chunks counts 2 C + 1 launches (C + 1 when it keeps no entry).
EXTEND_KERNEL = CudaKernel(
    "extend_kernel.cu",
    "sarlacc_extend_kernel",
    [_I, _P, _L, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
)

#: Slots a pair a warp holds: one lane a slot.
MAX_SLOTS = 32


def check_chunks(jobs_np, order_np, chunks, stride: int) -> None:
    """Raise unless ``chunks`` ((q0, q1, SL, strc) ranges of ``order_np``)
    tile it in order with 1 <= g - 1 <= SL <= :data:`MAX_SLOTS` for every
    job and 0 <= strc <= ``stride`` (the host-side guard of kernel H and its
    plain version)."""
    at = 0
    for q0, q1, sl, strc in chunks:
        if q0 != at or q1 < q0:
            raise ValueError(f"kernel H: chunk ({q0}, {q1}) does not follow {at}")
        at = q1
        if not 1 <= sl <= MAX_SLOTS or not 0 <= strc <= stride:
            raise ValueError(f"kernel H takes 1-{MAX_SLOTS} slots and strc <= {stride}: SL {sl}, "
                             f"strc {strc}")
        g = jobs_np[order_np[q0:q1], 3]
        if g.size and (int(g.min()) < 2 or int(g.max()) - 1 > sl):
            raise ValueError(f"kernel H: a chunk of SL {sl} holds groups of {int(g.min())}-"
                             f"{int(g.max())} reads")
    if at != order_np.shape[0]:
        raise ValueError(f"kernel H: the chunks cover {at} of {order_np.shape[0]} pairs")


class ExtendBuild:
    """Kernel H's device tables and buffers for one library build, with
    ``ops/msa.py::_extend_library_plain``'s arguments: ``arena`` int16
    [rows, STR] and ``fracs`` float32 [J] (the pair identities) on the card;
    the host tables ``jobs`` int32 [J, 4] (group, x, y, g), ``first_job``
    int32 [groups] and ``order`` int32 [J] (the job ids in chunk order),
    uploaded here; ``chunks`` (q0, q1, SL, strc) ranges of ``order``;
    ``w_scale`` the float32 quantization scale.  :meth:`count` and
    :meth:`write` queue the passes and never wait on the card."""

    def __init__(self, arena, jobs, first_job, fracs, order, chunks, w_scale):
        rows, STR = arena.shape
        J = int(order.shape[0])
        check_chunks(jobs, order, chunks, STR)
        check_tensor(arena, "arena", torch.int16, (rows, STR))
        check_tensor(fracs, "fracs", torch.float32, (J,))
        for q0, q1, sl, strc in chunks:
            if (q1 - q0) * strc * sl >= 2**31:
                raise ValueError(f"kernel H: a chunk of {q1 - q0} x {strc} x {sl} slots exceeds "
                                 f"2^31")
        dev = arena.device
        self.J, self.chunks, self.dev = J, chunks, dev
        self._tables = [torch.as_tensor(np.ascontiguousarray(t, np.int32), device=dev)
                        for t in (jobs, first_job, order)]
        self._scale = torch.tensor([np.float32(w_scale)], dtype=torch.float32, device=dev)
        self._cnt_at = np.cumsum([0] + [(q1 - q0) * strc for q0, q1, _, strc in chunks])
        self._cnt = torch.empty(int(self._cnt_at[-1]), dtype=torch.uint8, device=dev)
        self._pair_tot = torch.empty(J, dtype=torch.int32, device=dev)
        #: int64 [J + 1] exclusive offsets of the pairs' entries, the total
        #: last, once :meth:`count`'s passes have run.
        self.off = torch.empty(J + 1, dtype=torch.int64, device=dev)
        jobs_d, first_d, _ = self._tables
        self._head = (arena.data_ptr(), STR, jobs_d.data_ptr(), first_d.data_ptr(),
                      fracs.data_ptr())

    def _launch(self, pas, q0, n, sl, strc, c0, out_ptr=None):
        EXTEND_KERNEL.launch(pas, *self._head, self._tables[2].data_ptr() + 4 * q0, n, sl, strc,
                             self._scale.data_ptr(), self._cnt.data_ptr() + int(c0),
                             self._pair_tot.data_ptr() + 4 * q0, self.off.data_ptr() + 8 * q0,
                             out_ptr, torch.cuda.current_stream(self.dev))

    def count(self) -> None:
        """Queue every chunk's counting pass, then the scan of every pair
        total into :attr:`off`."""
        for (q0, q1, sl, strc), c0 in zip(self.chunks, self._cnt_at):
            self._launch(0, q0, q1 - q0, sl, strc, c0)
        self._launch(2, 0, self.J, 1, 0, 0)

    def write(self, off_np, out) -> None:
        """Queue the writing pass of every chunk that keeps an entry, into
        ``out`` int32 [off_np[-1], 3] at the offsets ``off_np`` (the host
        copy of :attr:`off`)."""
        for (q0, q1, sl, strc), c0 in zip(self.chunks, self._cnt_at):
            if off_np[q1] > off_np[q0]:
                self._launch(1, q0, q1 - q0, sl, strc, c0, out.data_ptr())


def extend_library(arena, jobs, first_job, fracs, order, chunks, w_scale):
    """Kernel H on one library build (arguments as :class:`ExtendBuild`'s).
    Returns (int32 [T, 3] rows (a, b, round(wsum * w_scale)), pair by pair
    in ``order``, then by a and b, bit-equal to the plain version; int64
    numpy [J + 1] exclusive offsets of the pairs' entries, the total last,
    from the one readback)."""
    build = ExtendBuild(arena, jobs, first_job, fracs, order, chunks, w_scale)
    build.count()
    off_np = build.off.cpu().numpy()  # the one readback: every pair's offset, the total last
    out = torch.empty((int(off_np[-1]), 3), dtype=torch.int32, device=arena.device)
    build.write(off_np, out)
    return out, off_np


def extend_kernel_resources() -> dict:
    """Kernel H's passes as compiled (keys ``"H:count"``, ``"H:write"``,
    ``"H:scan"``; values as ``ops/cuda_align.py::score_kernel_resources``'s)."""
    fn = EXTEND_KERNEL.function("sarlacc_extend_attrs", [_I, _P])
    return {f"H:{name}": kernel_resources(fn, i)
            for i, name in enumerate(("count", "write", "scan"))}

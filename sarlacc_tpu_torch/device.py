"""Device selection and device-derived memory budgets for the port.

Every entry point takes ``device=``: ``None`` means CUDA, and a missing CUDA
device raises instead of silently running the plain PyTorch versions on the
CPU.  The CPU is reached only by asking for it (``device="cpu"``), which is
how the parity tests run.

Budgets replace the JAX package's ``utils/membudget.py``: a fraction of the
card's free memory at first probe (less a fixed reserve for the caching
allocator's slack), or a fixed fallback on the CPU.  Probed once per
process, so the pipeline's own allocations never shrink later budgets.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "memory_budget"]

#: Headroom kept out of every budget: allocator fragmentation, cuBLAS
#: workspaces and the kernels' own scratch.
_RESERVE_BYTES = 2 << 30

_FREE_BYTES: dict[int, int] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def memory_budget(device: torch.device, fraction: float, fallback: int) -> int:
    """``fraction`` of the card's free memory at first probe, else ``fallback``.

    Floors at 64 MiB so a nearly-full card degrades to small windows.
    """
    if device.type != "cuda":
        return fallback
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _FREE_BYTES:
        free, _ = torch.cuda.mem_get_info(index)
        _FREE_BYTES[index] = max(int(free) - _RESERVE_BYTES, 0)
    return max(int(_FREE_BYTES[index] * fraction), 64 << 20)

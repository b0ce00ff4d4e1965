"""Device selection and device-derived memory budgets for the port.

Every entry point takes ``device=``: ``None`` means CUDA, and a missing CUDA
device raises instead of silently running the plain PyTorch versions on the
CPU.  The CPU is reached only by asking for it (``device="cpu"``), which is
how the parity tests run.

Budgets replace the JAX package's ``utils/membudget.py``: a fraction of the
card's free memory at first probe (less a fixed reserve for the caching
allocator's slack), or a fixed fallback on the CPU.  Probed once per
process, so the pipeline's own allocations never shrink later budgets.
Each budget is recorded under its name for :func:`budget_report`.
:func:`env_number` reads the numeric environment knobs the JAX package
reads, warning on a malformed value instead of raising.
"""

from __future__ import annotations

import math
import os
import warnings

import torch

__all__ = ["resolve_device", "memory_budget", "record_budget", "budget_report", "env_number",
           "finite_float"]

#: Headroom kept out of every budget: allocator fragmentation, cuBLAS
#: workspaces and the kernels' own scratch.
_RESERVE_BYTES = 2 << 30

_FREE_BYTES: dict[int, int] = {}
_GIVEN: dict[str, tuple[str, int]] = {}


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def memory_budget(device: torch.device, fraction: float, fallback: int, name: str) -> int:
    """``fraction`` of the card's free memory at first probe, else ``fallback``.

    Floors at 64 MiB so a nearly-full card degrades to small windows.  The
    result is recorded under ``name`` for :func:`budget_report`.
    """
    if device.type != "cuda":
        out = fallback
    else:
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index not in _FREE_BYTES:
            free, _ = torch.cuda.mem_get_info(index)
            _FREE_BYTES[index] = max(int(free) - _RESERVE_BYTES, 0)
        out = max(int(_FREE_BYTES[index] * fraction), 64 << 20)
    _GIVEN[name] = (str(device), out)
    return out


def record_budget(name: str, device: torch.device, out: int) -> int:
    """Record a budget set otherwise than by :func:`memory_budget` (an
    environment override) under ``name`` for :func:`budget_report`."""
    _GIVEN[name] = (str(device), out)
    return out


def finite_float(text: str) -> float:
    """``float(text)``, refusing NaN and the infinities (ValueError)."""
    v = float(text)
    if not math.isfinite(v):
        raise ValueError(f"{text!r} is not finite")
    return v


def env_number(name: str, cast, default):
    """``cast`` of the environment variable ``name`` when it is set and not
    empty, else ``default``.  A value ``cast`` refuses warns with the
    variable's name and gives ``default`` (the JAX package raises there)."""
    text = os.environ.get(name)
    if not text:
        return default
    try:
        return cast(text)
    except (ValueError, OverflowError):
        warnings.warn(f"{name}={text!r} is not a valid {cast.__name__}; using the default "
                      f"{default}", RuntimeWarning, stacklevel=2)
        return default


def budget_report() -> str:
    """The budgets handed out so far, each with its device, and the free
    memory each card had at its first probe."""
    free = ", ".join(f"cuda:{i} {b / 2**30:.2f} GiB" for i, b in sorted(_FREE_BYTES.items()))
    src = f"free at first probe: {free}" if free else "no card probed, fallback constants"
    parts = ", ".join(
        f"{k}={v / 2**30:.2f} GiB ({d})" for k, (d, v) in sorted(_GIVEN.items())
    )
    return f"memory budgets [{src}]: {parts or 'none requested yet'}"

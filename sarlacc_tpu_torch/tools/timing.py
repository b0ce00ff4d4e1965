"""Timers and labels shared by the measurement entry points.

Device work is timed with CUDA events over back-to-back calls after a
warm-up; host stages with a clock around work that ends in a device
synchronise.  On the CPU both fall back to the host clock, and
:func:`device_label` says which device a number came from.
"""

from __future__ import annotations

import shutil
import subprocess
import time

import torch

__all__ = ["device_label", "event_ms", "host_s", "queued_ms", "sync"]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def event_ms(fn, reps: int, dev: torch.device, warmup: bool = True) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls."""
    if warmup:
        fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int, dev: torch.device) -> float:
    """Mean CUDA-event milliseconds per call of ``fn`` over ``reps`` calls
    queued behind a sleep on the card, after a warm-up call: the host
    enqueues every call while the card sleeps, so a kernel shorter than its
    wrapper's host time is timed back to back, not at the host's pace.
    ``fn`` must not synchronise; the sleep grows until the host got ahead
    (the start event still pending when the last call is queued)."""
    fn()
    sync(dev)
    for cycles in (1 << 21, 1 << 23, 1 << 25, 1 << 27):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize(dev)
        if ahead:
            return start.elapsed_time(end) / reps
    raise RuntimeError("the host never got ahead of the card: does fn synchronise?")


def host_s(fn, dev: torch.device):
    """(result, seconds) of one call, synchronised before and after."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def device_label(dev: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or that this is the CPU."""
    if dev.type != "cuda":
        return "cpu (plain versions; host-clock CPU times, not card times)"
    name = torch.cuda.get_device_name(dev)
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        )
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip().splitlines()[0]
    return f"{name}, power limit not read"

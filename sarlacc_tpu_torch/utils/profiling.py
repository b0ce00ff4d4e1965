"""Lightweight pipeline profiling.

Counterpart of ``sarlacc_tpu/utils/profiling.py``: wall-clock stage timers
with item and DP-cell counters (GCUPS), a process-wide profiler the
pipeline's stages record into (``msa.pair_library``, ``msa.triplet``,
``msa.guide_tree``, ``msa.lib_upload``, ``multi_read_align``), and a hook
into ``torch.profiler`` for device traces.

Stage times are host wall clock.  CUDA launches return before the card
finishes, so a stage that ends without reading a result back can hand its
device time to a later stage; the MSA stages each end in a readback.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
from dataclasses import dataclass, field

from ..device import budget_report

__all__ = [
    "PipelineProfiler", "StageStats", "profiler", "profiled", "get_profiler", "set_profiler",
]

#: SARLACC_STAGE_LOG=1 prints each stage's wall time as it completes.
_STAGE_LOG = bool(os.environ.get("SARLACC_STAGE_LOG"))


@dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    items: int = 0
    cells: int = 0

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds else 0.0


@dataclass
class PipelineProfiler:
    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0, cells: int = 0):
        st = self.stages.setdefault(name, StageStats())
        t0 = time.perf_counter()
        try:
            yield st
        finally:
            dt = time.perf_counter() - t0
            st.seconds += dt
            st.calls += 1
            st.items += items
            st.cells += cells
            if _STAGE_LOG:
                print(f"[stage] {name} +{dt:.3f}s", file=sys.stderr, flush=True)

    def report(self) -> str:
        """One line a stage (calls, seconds, items/s, GCUPS), then the
        memory budgets the port handed out."""
        lines = [f"{'stage':<28}{'calls':>7}{'sec':>10}{'items/s':>12}{'GCUPS':>9}"]
        for name, st in sorted(self.stages.items()):
            ips = st.items / st.seconds if st.seconds and st.items else 0.0
            lines.append(
                f"{name:<28}{st.calls:>7}{st.seconds:>10.3f}{ips:>12.1f}{st.gcups:>9.2f}"
            )
        lines.append(budget_report())
        return "\n".join(lines)

    @contextlib.contextmanager
    def device_trace(self, logdir: str):
        """Capture a ``torch.profiler`` trace (CPU activity, and CUDA where a
        card is present) around a block; written to ``logdir/trace.json``
        in the Chrome trace format."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_GLOBAL = PipelineProfiler()


def get_profiler() -> PipelineProfiler:
    return _GLOBAL


def set_profiler(p: PipelineProfiler) -> None:
    global _GLOBAL
    _GLOBAL = p


@contextlib.contextmanager
def profiler(name: str, items: int = 0, cells: int = 0):
    with _GLOBAL.stage(name, items=items, cells=cells) as st:
        yield st


def profiled(name: str):
    """Decorator: record wall time of every call under ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with _GLOBAL.stage(name):
                return fn(*args, **kwargs)

        return inner

    return wrap

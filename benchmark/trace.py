"""What a traced run reads: the benchmark's own spans around the program's
entry points, the stage profiler's stages with their intervals, the host
library's triplet-extension calls, and the device timeline from
``torch.profiler`` (CUDA activity only, so the host pays no per-operator
cost), reduced after the window to busy time, kernel times by name and the
longest idle gaps named by what the host was doing."""

from __future__ import annotations

import contextlib
import re
import threading
import time

import torch

__all__ = ["Spans", "StageRecorder", "NativeRecorder", "DeviceTrace", "TORCH_KERNEL"]

#: Kernels of PyTorch and the libraries it ships (not the port's own).
TORCH_KERNEL = re.compile(r"at::|at_cuda_detail|cub::|thrust::|c10::|_ZN2at|_ZN3cub|_ZN6thrust")


class Spans:
    """Named host intervals (epoch ns).  With ``sync`` a span ends in
    ``torch.cuda.synchronize()``, so the device work it queued is inside it."""

    def __init__(self, sync: bool):
        self.sync = sync
        self.intervals: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            if self.sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            self.intervals.append((name, t0, time.time_ns()))

    def seconds(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.intervals if n == name) / 1e9


def StageRecorder():
    """A stage profiler of the program's own type that also keeps every
    stage's interval (epoch ns), for naming the device's idle gaps."""
    from sarlacc_tpu_torch.utils.profiling import PipelineProfiler

    class _Recorder(PipelineProfiler):
        def __init__(self):
            super().__init__()
            self.intervals = []

        @contextlib.contextmanager
        def stage(self, name, items=0, cells=0):
            t0 = time.time_ns()
            with super().stage(name, items=items, cells=cells) as st:
                yield st
            self.intervals.append((name, t0, time.time_ns()))

    return _Recorder()


class NativeRecorder:
    """Times every call of the host library's triplet extension where
    ``multi_read_align`` makes it (from 8 worker threads: the sum is
    thread-seconds)."""

    def __init__(self):
        import sarlacc_tpu_torch.api.msa as msa

        self._owner = msa
        self._orig = msa.triplet_extend_native
        self._lock = threading.Lock()
        self.seconds = 0.0
        self.calls = 0
        self.on = False

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return self._orig(*args, **kw)
            finally:
                if self.on:
                    with self._lock:
                        self.seconds += time.perf_counter() - t0
                        self.calls += 1

        msa.triplet_extend_native = timed

    def close(self):
        self._owner.triplet_extend_native = self._orig


class DeviceTrace:
    """``torch.profiler`` over the window, CUDA activity only."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.events: list[tuple[str, int, int]] = []  # (name, start ns, end ns)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        for e in self._prof.profiler.kineto_results.events():
            if str(e.device_type()).split(".")[-1] != "CUDA":
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = e.start_us() * 1000, e.duration_us() * 1000
            self.events.append((e.name(), int(s), int(s) + int(d)))
        self.events.sort(key=lambda x: x[1])
        return False

    @staticmethod
    def is_copy(name: str) -> bool:
        return name.startswith(("Memcpy", "Memset")) or name.lower().startswith(("memcpy",
                                                                                   "memset"))

    def busy(self, t0: int, t1: int) -> tuple[float, list[tuple[int, int]]]:
        """(seconds some kernel or copy ran within [t0, t1], idle gaps)."""
        busy, gaps = 0, []
        cur_s = cur_e = None
        for _, s, e in self.events:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                else:
                    gaps.append((t0, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
            gaps.append((cur_e, t1))
        else:
            gaps.append((t0, t1))
        return busy / 1e9, [g for g in gaps if g[1] > g[0]]

    def kernel_seconds(self, pattern: re.Pattern | None = None, torch_only=False) -> float:
        tot = 0
        for name, s, e in self.events:
            if self.is_copy(name):
                continue
            if torch_only and not TORCH_KERNEL.search(name):
                continue
            if pattern is not None and not pattern.search(name):
                continue
            tot += e - s
        return tot / 1e9

    def top_ops(self, k=10) -> list[list]:
        by: dict[str, int] = {}
        for name, s, e in self.events:
            key = _short(name)
            by[key] = by.get(key, 0) + (e - s)
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda x: -x[1])[:k]]


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    n = name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    return n.split("(")[0].strip()[:120] or name[:120]

"""Utilities: stage checkpointing, profiling."""

from .profiling import PipelineProfiler, get_profiler, profiler, set_profiler  # noqa: F401
from .serialize import load_frame, save_frame  # noqa: F401

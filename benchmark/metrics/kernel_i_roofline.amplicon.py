"""Kernel I's thresholded form: the window's scans' bound (the program's
``lev2.cells``, ``lev2.in_bytes`` and ``lev2.hits`` counters through
``benchmark/lev2_roofline.py``) over the device time of its launches in the
trace, in percent; none where the program keeps no such counters or the
trace holds no launch."""

from benchmark.lev2_roofline import PATTERN, scan_bound_s


def read(obs):
    from sarlacc_tpu_torch.utils.profiling import get_profiler

    c = getattr(get_profiler(), "counters", {})
    trace = obs.get("trace")
    if trace is None or not c.get("lev2.cells"):
        return None
    dev = trace.kernel_seconds(PATTERN)
    if dev <= 0:
        return None
    return 100.0 * scan_bound_s(c["lev2.cells"], c.get("lev2.in_bytes", 0),
                                c.get("lev2.hits", 0)) / dev

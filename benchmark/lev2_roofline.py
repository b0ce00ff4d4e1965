"""The yardstick of kernel I's thresholded form (the row-block scan,
``csrc/lev2_kernel.cu``'s ``lev2_hits_reg`` and ``lev2_hits_wide``): the
least time a scan could take on one H100, from what the program counts.

The work depends on the data (each pair's band DP stops where a whole band
column exceeds the threshold), so the operations come from the program's
``lev2.cells`` counter, the DP cells the kernel evaluated to each pair's
exit, at 6 operations a cell (two adds, two minimums, the cost from two
mask bits), over the card's float32 rate outside the tensor cores.  The
compulsory bytes are the kernel's inputs read once (``lev2.in_bytes``: the
codes, the lengths and the jobs) and 8 bytes a hit written (``lev2.hits``).
The peaks are ``benchmark/roofline.py``'s.
"""

from __future__ import annotations

import re

from benchmark.roofline import bound_s

__all__ = ["OPS_PER_CELL", "HIT_BYTES", "KERNEL_NAMES", "PATTERN", "scan_bound_s"]

OPS_PER_CELL = 6
HIT_BYTES = 8
#: The thresholded form's ``__global__`` functions, as the device trace names them.
KERNEL_NAMES = ("lev2_hits_reg", "lev2_hits_wide")
PATTERN = re.compile(r"(?<![A-Za-z_])(" + "|".join(KERNEL_NAMES) + r")(?![A-Za-z_])")


def scan_bound_s(cells: float, in_bytes: float, hits: float) -> float:
    """The least seconds of scans that evaluated ``cells`` DP cells, were
    given ``in_bytes`` of inputs and wrote ``hits`` hits."""
    return bound_s(in_bytes + HIT_BYTES * hits, OPS_PER_CELL * cells)

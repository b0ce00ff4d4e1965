"""Seconds in ``quality_align``'s chunks on the card (the stage profiler's
``qalign.dirs``, kernel A's launches with their cost planes, and
``qalign.walk``, kernel G's string walk with the columns turned front to
back, which reads each chunk's column count back and so waits for both
kernels) per thousand reads; none where the program times neither."""

from benchmark.readers import per_kread

STAGES = ("qalign.dirs", "qalign.walk")


def read(obs):
    got = [obs["stages"][s] for s in STAGES if s in obs["stages"]]
    return per_kread(obs, sum(got)) if got else None

"""Seconds in ``umi_group``'s neighbour searches (the stage profiler's
``umi.scan``, by any route) per thousand reads; none where the program
times no such stage."""

from benchmark.readers import per_kread


def read(obs):
    s = obs["stages"].get("umi.scan")
    return per_kread(obs, s) if s is not None else None

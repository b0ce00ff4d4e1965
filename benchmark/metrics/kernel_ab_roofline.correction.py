"""Kernels A and B: their launches' summed bounds over their summed device time in the trace, in
percent."""

from benchmark.readers import roofline_percent


def read(obs):
    return roofline_percent(obs, "AB")

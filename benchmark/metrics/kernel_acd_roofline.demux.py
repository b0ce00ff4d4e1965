"""Kernels A, C and D: their launches' summed bounds over their summed device time in the trace, in
percent."""

from benchmark.readers import roofline_percent


def read(obs):
    return roofline_percent(obs, "ACD")

"""Kernel A: its launches' summed bounds (``benchmark/roofline.py``'s frozen
count) over their summed device time in the trace, in percent."""

from benchmark.readers import roofline_percent


def read(obs):
    return roofline_percent(obs, "A")

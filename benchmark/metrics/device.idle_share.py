"""Percent of the traced window in which no kernel or copy ran on the card."""

from benchmark.readers import idle_percent


def read(obs):
    return idle_percent(obs)

"""Seconds in ``multi_read_align`` (the benchmark's span, ended by a synchronise) per thousand
reads."""

from benchmark.readers import per_kread


def read(obs):
    return per_kread(obs, obs["spans"].seconds("entry.multi_read_align"))

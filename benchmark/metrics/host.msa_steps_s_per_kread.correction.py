"""Seconds in the stage profiler's host steps of ``multi_read_align`` (merge costs, applying
merges, the guide tree, reconstruction, pair post-processing) per thousand reads."""

from benchmark.readers import MSA_HOST_STAGES, per_kread


def read(obs):
    return per_kread(obs, sum(obs["stages"].get(s, 0.0) for s in MSA_HOST_STAGES))

"""Seconds in ``error_finder``'s and ``homopolymer_matcher``'s tallies (the
stage profiler's ``profile.errors`` and ``profile.homopolymers``, each
ending in its readback) per thousand reads; none where the program times
neither."""

from benchmark.readers import per_kread

STAGES = ("profile.errors", "profile.homopolymers")


def read(obs):
    got = [obs["stages"][s] for s in STAGES if s in obs["stages"]]
    return per_kread(obs, sum(got)) if got else None

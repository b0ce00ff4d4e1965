"""Seconds in ``umi_group``'s host steps around its neighbour searches (the
stage profiler's ``umi.unique``, ``umi.csr``, ``umi.intersect`` and
``umi.cluster``) per thousand reads; none where the program times none of
them."""

from benchmark.readers import per_kread

STAGES = ("umi.unique", "umi.csr", "umi.intersect", "umi.cluster")


def read(obs):
    got = [obs["stages"][s] for s in STAGES if s in obs["stages"]]
    return per_kread(obs, sum(got)) if got else None

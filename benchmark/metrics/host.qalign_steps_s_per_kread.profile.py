"""Seconds in ``quality_align``'s host steps (the stage profiler's
``qalign.plan``, the chunk plan; ``qalign.prepare``, the reads' codes and
quality indices sent to the card and cut into chunks; ``qalign.strings``,
the gapped strings built on the card, read back and decoded) per thousand
reads; none where the program times none of them."""

from benchmark.readers import per_kread

STAGES = ("qalign.plan", "qalign.prepare", "qalign.strings")


def read(obs):
    got = [obs["stages"][s] for s in STAGES if s in obs["stages"]]
    return per_kread(obs, sum(got)) if got else None

"""Thread-seconds in the host library's triplet extension (every call, timed by the benchmark) per
thousand reads; none where the window made no call."""

from benchmark.readers import per_kread


def read(obs):
    return per_kread(obs, obs["native_s"]) if obs.get("native_calls") else None

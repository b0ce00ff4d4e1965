"""Shared arithmetic of the metric readers in ``metrics/``: each reader is
``read(obs) -> float | None``, and ``None`` leaves its metric out of the
result line.  ``obs`` is what one run saw (:func:`run.observe`)."""

from __future__ import annotations

from benchmark.roofline import kernel_pattern


def per_kread(obs, seconds, scale: float = 1.0):
    """``seconds`` (times ``scale``) per thousand reads of the window."""
    if seconds is None or not obs["reads"]:
        return None
    return seconds * scale / (obs["reads"] / 1000.0)


def roofline_percent(obs, keys: str):
    """100 x the kernels' summed bounds over their summed device time."""
    trace = obs.get("trace")
    if trace is None:
        return None
    dev = trace.kernel_seconds(kernel_pattern(keys))
    bound = sum(obs["bounds"].get(k, 0.0) for k in keys)
    if dev <= 0 or bound <= 0:
        return None
    return 100.0 * bound / dev


def idle_percent(obs):
    if obs.get("trace") is None or not obs["busy_s"]:
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["window_s"])


def torch_device_ms_per_kread(obs):
    if obs.get("trace") is None or not obs["busy_s"]:
        return None
    return per_kread(obs, obs["trace"].kernel_seconds(torch_only=True), 1e3)


#: The stages of ``multi_read_align``'s host orchestration.
MSA_HOST_STAGES = ("msa.merge_cost", "msa.apply_merge", "msa.guide_tree", "msa.reconstruct",
                   "msa.pair_postprocess")

"""The card's peak allocation over the window (after a reset at its start), in GiB."""


def read(obs):
    return obs["peak_bytes"] / 2**30

"""Reads of every whole pass of the window over the window's seconds, from its start to the end of
its last pass."""


def read(obs):
    return obs["reads"] / obs["window_s"]

"""Seconds from the process's start to the first timed pass."""


def read(obs):
    return obs["setup_s"]

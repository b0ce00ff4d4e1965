"""Device milliseconds of PyTorch's own kernels (not the port's hand-written ones) per thousand
reads, from the device trace."""

from benchmark.readers import torch_device_ms_per_kread


def read(obs):
    return torch_device_ms_per_kread(obs)

"""NumPy oracles carried over from ``sarlacc_tpu.refimpl`` (the port's subset)."""

from .align import QueryMap, ReferenceAlign  # noqa: F401
from .cluster import cluster_umis  # noqa: F401
from .masking import mask_bad_bases, unmask_alignment  # noqa: F401

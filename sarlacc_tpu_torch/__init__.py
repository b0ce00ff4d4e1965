"""sarlacc_tpu_torch — the sarlacc correction pipeline on PyTorch and CUDA.

A port of ``sarlacc_tpu`` (JAX/Pallas) for NVIDIA Hopper cards:
``adaptor_align -> umi_group -> realize_reads -> multi_read_align ->
consensus_read_seq``.  Plain tensor code is PyTorch; the two DP kernels on
that path (the adaptor direction DP and the banded pair DP of the MSA
library) are hand-written CUDA in ``csrc/``, built at first use.  Every
entry point takes ``device=`` (``None`` means CUDA, which must exist).
Imports neither JAX nor ``sarlacc_tpu``.
"""

from .api import *  # noqa: F401,F403
from .api import __all__ as _api_all

__all__ = list(_api_all)

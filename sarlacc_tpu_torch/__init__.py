"""sarlacc_tpu_torch — the sarlacc pipelines on PyTorch and CUDA.

A port of ``sarlacc_tpu`` (JAX/Pallas) for NVIDIA Hopper cards, with all
19 of its exports.  The correction pipeline: ``adaptor_align -> umi_group
-> realize_reads -> multi_read_align -> consensus_read_seq``.
Demultiplexing and calibration: ``barcode_align``,
``get_barcode_thresholds``, ``tune_alignment``, ``get_adaptor_thresholds``,
``filter_reads``, ``extract_subseq`` and ``quality_align``; then
``expected_dist``, ``quality_mask`` and the host exports ``error_finder``,
``homopolymer_finder``, ``homopolymer_matcher`` and ``sam2ranges``.  Plain
tensor code is PyTorch; the DP kernels on those paths (the adaptor
direction DP, the score-only DP and its multi-segment form, and the banded
pair DP of the MSA library) are hand-written CUDA in ``csrc/``, built at
first use; the measurement tools in :mod:`.tools` add their own.  Every
entry point takes ``device=`` (``None`` means CUDA, which must exist).
Imports neither JAX nor ``sarlacc_tpu``.
"""

from .api import *  # noqa: F401,F403
from .api import __all__ as _api_all

__all__ = list(_api_all)

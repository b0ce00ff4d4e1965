"""The port's entry points: the JAX package's 19 exports
(``sarlacc_tpu/api/__init__.py``) plus ``read_fastq``."""

from ..io.fastq import read_fastq  # noqa: F401
from ..io.mock import mock_reads  # noqa: F401
from ..io.sam import sam2ranges  # noqa: F401
from .adaptor_align import adaptor_align  # noqa: F401
from .barcode import barcode_align, get_barcode_thresholds  # noqa: F401
from .consensus import consensus_read_seq  # noqa: F401
from .extract import extract_subseq  # noqa: F401
from .filter import filter_reads, realize_reads  # noqa: F401
from .msa import multi_read_align  # noqa: F401
from .profiling import (  # noqa: F401
    error_finder,
    homopolymer_finder,
    homopolymer_matcher,
)
from .quality_align import quality_align  # noqa: F401
from .tune import get_adaptor_thresholds, tune_alignment  # noqa: F401
from .umi import expected_dist, quality_mask, umi_group  # noqa: F401

__all__ = [
    "adaptor_align",
    "tune_alignment",
    "get_adaptor_thresholds",
    "filter_reads",
    "realize_reads",
    "extract_subseq",
    "barcode_align",
    "get_barcode_thresholds",
    "umi_group",
    "expected_dist",
    "quality_mask",
    "quality_align",
    "multi_read_align",
    "consensus_read_seq",
    "error_finder",
    "homopolymer_finder",
    "homopolymer_matcher",
    "sam2ranges",
    "mock_reads",
    "read_fastq",
]

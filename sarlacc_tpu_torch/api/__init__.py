"""The port's entry points (the correction pipeline)."""

from ..io.fastq import read_fastq  # noqa: F401
from ..io.mock import mock_reads  # noqa: F401
from .adaptor_align import adaptor_align  # noqa: F401
from .consensus import consensus_read_seq  # noqa: F401
from .filter import realize_reads  # noqa: F401
from .msa import multi_read_align  # noqa: F401
from .umi import umi_group  # noqa: F401

__all__ = [
    "adaptor_align",
    "umi_group",
    "realize_reads",
    "multi_read_align",
    "consensus_read_seq",
    "mock_reads",
    "read_fastq",
]

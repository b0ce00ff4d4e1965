"""NumPy oracles carried over from ``sarlacc_tpu.refimpl``."""

from .align import QueryMap, ReferenceAlign  # noqa: F401
from .cluster import cluster_umis  # noqa: F401
from .consensus import consensus_basic, consensus_quality, log1pexp  # noqa: F401
from .errors import find_errors  # noqa: F401
from .homopolymer import find_homopolymers, match_homopolymers  # noqa: F401
from .levenshtein import (  # noqa: F401
    find_neighbors,
    lev2_int,
    lev_masked_condensed,
    trie_dfs_order,
)
from .masking import mask_bad_bases, unmask_alignment  # noqa: F401

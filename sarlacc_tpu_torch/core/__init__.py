from .encode import (  # noqa: F401
    BASES,
    GAP_CODE,
    N_CODE,
    SeqBatch,
    decode_batch,
    decode_seq,
    encode_batch,
    encode_seq,
    iupac_reference,
    reverse_complement_codes,
)
from .quality import QualityEncoding, errors_to_phred_string, get_encoding  # noqa: F401
from .scoring import ScoreTables, build_score_tables  # noqa: F401

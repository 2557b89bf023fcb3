from approx_counter_tpu_torch.core.codec import (  # noqa: F401
    BASE_A,
    BASE_C,
    BASE_G,
    BASE_N,
    BASE_PAD,
    BASE_T,
    decode_kmer,
    decode_kmers,
    encode_kmer,
    seq_to_codes,
    codes_to_seq,
)
from approx_counter_tpu_torch.core.complexity import (  # noqa: F401
    adjust_threshold,
    complexity_score,
    complexity_score_np,
)

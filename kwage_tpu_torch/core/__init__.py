from .words import (
    BASE_A,
    BASE_C,
    BASE_G,
    BASE_T,
    MAX_WORD_LEN,
    canonical_kmers,
    encode_bases,
    kmer_word_mask,
    word_to_string,
    string_to_word,
)
from .hash import (
    MURMUR_HASH_32,
    UNKNOWN_HASH,
    hash_name,
    parse_hash_function_name,
    murmur32_string,
    murmur32_words,
)
from .params import (
    MIN_NUM_HASH,
    MAX_NUM_HASH,
    BloomParam,
    optimal_bloom_param,
    approximate_max_kmers,
)
from .accession import (
    INVALID_ACCESSION,
    str_to_accession,
    accession_to_str,
)
from .dates import Date
from .info import FilterInfo

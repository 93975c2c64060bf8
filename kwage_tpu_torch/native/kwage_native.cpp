// kwage_tpu native host library.
//
// The ingest hot path of the engine: canonical k-mer rolling windows,
// multi-seed murmur3-32, and the two-plane 4-bit counting-Bloom
// thresholding with conservative update. Semantics follow the reference
// engine (word.h:73-168, hash.cpp:239-332, make_bloom.cpp:506-621) so that
// filters built here are bit-identical to the reference given the same
// sequence stream; the implementation is original.
//
// Built as a shared library and bound via ctypes (see __init__.py).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>

#ifdef __AVX2__
#include <immintrin.h>
#endif

#include <zlib.h>

namespace {

constexpr uint32_t kMaxPlanes = 5;   // MAX_NUM_HASH planes of valid bits
constexpr uint32_t kNumCountHash = 4;  // seeds 0,1 -> plane A; 2,3 -> plane B
constexpr uint32_t kMaxCount = 15;   // 4-bit saturating counters

constexpr uint32_t kC1 = 0xcc9e2d51u;
constexpr uint32_t kC2 = 0x1b873593u;

inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// Murmur3-32 of the decoded ASCII k-mer for seeds 0..num_seeds-1.
// The per-block mixing of the message is seed independent, so each block
// constant is computed once and folded into all seed lanes.
// num_seeds <= 8 per call (h is 8 lanes); kn_murmur32 chunks larger
// counts with seed_base offsets.
inline void murmur_kmer(uint64_t word, uint32_t k, uint32_t seed_base,
                        uint32_t num_seeds, uint32_t* out) {
  static const uint32_t kAscii[4] = {65u, 67u, 71u, 84u};  // "ACGT"
  uint32_t h[8];
  for (uint32_t s = 0; s < num_seeds; ++s) h[s] = seed_base + s;

  const uint32_t nblocks = k / 4;
  const uint32_t tail = k & 3;

  for (uint32_t blk = 0; blk < nblocks; ++blk) {
    uint32_t k1 = 0;
    for (uint32_t byte = 0; byte < 4; ++byte) {
      const uint32_t i = blk * 4 + byte;
      const uint32_t code =
          static_cast<uint32_t>(word >> (2 * (k - 1 - i))) & 3u;
      k1 |= kAscii[code] << (8 * byte);
    }
    k1 *= kC1;
    k1 = rotl32(k1, 15);
    k1 *= kC2;
    for (uint32_t s = 0; s < num_seeds; ++s) {
      h[s] ^= k1;
      h[s] = rotl32(h[s], 13);
      h[s] = h[s] * 5u + 0xe6546b64u;
    }
  }
  if (tail) {
    uint32_t k1 = 0;
    for (uint32_t t = 0; t < tail; ++t) {
      const uint32_t i = nblocks * 4 + t;
      const uint32_t code =
          static_cast<uint32_t>(word >> (2 * (k - 1 - i))) & 3u;
      k1 ^= kAscii[code] << (8 * t);
    }
    k1 *= kC1;
    k1 = rotl32(k1, 15);
    k1 *= kC2;
    for (uint32_t s = 0; s < num_seeds; ++s) h[s] ^= k1;
  }
  for (uint32_t s = 0; s < num_seeds; ++s) out[s] = fmix32(h[s] ^ k);
}

// LUT: 8 adjacent word bits (one 4-base murmur block, 5'-base in the top
// two bits) -> the little-endian ASCII message block. 1 KiB, L1-resident.
struct BlockLut {
  uint32_t v[256];
  BlockLut() {
    static const uint32_t kA[4] = {65u, 67u, 71u, 84u};
    for (uint32_t b = 0; b < 256; ++b) {
      v[b] = kA[(b >> 6) & 3] | (kA[(b >> 4) & 3] << 8) |
             (kA[(b >> 2) & 3] << 16) | (kA[b & 3] << 24);
    }
  }
};
const BlockLut kBlockLut;

#ifdef __AVX2__
// All 8 seed lanes in one vector (callers consume the first kMaxPlanes).
// Message mixing is seed independent: each block constant k1 is computed
// once on the scalar unit and broadcast, like the reference's AVX2 path
// (hash.cpp:239-332) -- the implementation here is original.
inline void murmur_kmer8_avx(uint64_t word, uint32_t k, uint32_t* out) {
  static const uint32_t kA[4] = {65u, 67u, 71u, 84u};
  __m256i h = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
  const __m256i c5 = _mm256_set1_epi32(5);
  const __m256i cC = _mm256_set1_epi32((int)0xe6546b64u);
  const uint32_t nblocks = k / 4;
  const uint32_t tail = k & 3;
  for (uint32_t blk = 0; blk < nblocks; ++blk) {
    // Bases 4*blk..4*blk+3 sit at descending 2-bit fields whose top byte
    // starts at bit 2*(k - 4*blk - 4) of the word.
    uint32_t k1 = kBlockLut.v[(word >> (2 * (k - 4 * blk - 4))) & 0xFF];
    k1 *= kC1; k1 = rotl32(k1, 15); k1 *= kC2;
    h = _mm256_xor_si256(h, _mm256_set1_epi32((int)k1));
    h = _mm256_or_si256(_mm256_slli_epi32(h, 13), _mm256_srli_epi32(h, 19));
    h = _mm256_add_epi32(_mm256_mullo_epi32(h, c5), cC);
  }
  if (tail) {
    uint32_t k1 = 0;
    for (uint32_t t = 0; t < tail; ++t) {
      const uint32_t i = nblocks * 4 + t;
      k1 ^= kA[(uint32_t)(word >> (2 * (k - 1 - i))) & 3u] << (8 * t);
    }
    k1 *= kC1; k1 = rotl32(k1, 15); k1 *= kC2;
    h = _mm256_xor_si256(h, _mm256_set1_epi32((int)k1));
  }
  h = _mm256_xor_si256(h, _mm256_set1_epi32((int)k));
  h = _mm256_xor_si256(h, _mm256_srli_epi32(h, 16));
  h = _mm256_mullo_epi32(h, _mm256_set1_epi32((int)0x85ebca6bu));
  h = _mm256_xor_si256(h, _mm256_srli_epi32(h, 13));
  h = _mm256_mullo_epi32(h, _mm256_set1_epi32((int)0xc2b2ae35u));
  h = _mm256_xor_si256(h, _mm256_srli_epi32(h, 16));
  _mm256_storeu_si256((__m256i*)out, h);
}
#endif  // __AVX2__

inline void murmur_kmer5(uint64_t word, uint32_t k, uint32_t* out8) {
#ifdef __AVX2__
  murmur_kmer8_avx(word, k, out8);
#else
  murmur_kmer(word, k, 0, kMaxPlanes, out8);
#endif
}

inline void prefetch_byte(const uint8_t* p) {
#if defined(__GNUC__)
  __builtin_prefetch(p, 1, 3);
#endif
}

inline void prefetch_read(const uint8_t* p) {
#if defined(__GNUC__)
  __builtin_prefetch(p, 0, 3);
#endif
}

inline int base_code(char c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Counting builder: one per accession under construction.
// ---------------------------------------------------------------------------

constexpr uint32_t kChunk = 4096;  // k-mers hashed per pipeline chunk

// Touched-line tracking: valid-bit planes are 2**max_log2_filter_len
// bits (512 MB each at the default maxL=32) but only ~num_valid_kmer
// lines of each are ever written. The fold must OR the WHOLE plane at
// stride 2**L (make_bloom.cpp:337-354); skipping lines never written is
// byte-exact (zero contributes nothing to OR) and turns the reference's
// 2.5 GB/accession fold scan into a sparse walk.
constexpr uint32_t kTouchShift = 6;  // 64-byte lines

// Valid-k-mer hash storage strategy: a threshold-crossing k-mer's
// kMaxPlanes seed hashes are appended to a flat vector while it stays
// small (kMaxPlanes u32 per k-mer; identical information to the plane
// bits, so the fold is byte-exact either way) and spilled into the
// reference-shaped bit planes only past kVecMaxKmers. Small accessions
// -- the overwhelming majority under the default maxL=32 -- therefore
// never touch (or page-fault) the 5 x 512 MB planes the reference
// allocates per accession (make_bloom.cpp:103,163).
constexpr uint64_t kVecMaxKmers = 1ull << 24;  // 16M k-mers = 320 MB

struct KnBuilder {
  uint32_t k;
  uint32_t min_count;
  uint64_t count_mask;   // 2**log2_count_len - 1
  uint64_t seq_mask;     // 2**max_log2_filter_len - 1
  uint64_t plane_bytes;  // 2**max_log2_filter_len / 8
  uint64_t num_valid_kmer;
  uint64_t num_bp;
  uint8_t* cells;        // low nibble: plane A count, high nibble: plane B
  uint8_t* planes[kMaxPlanes];
  uint64_t* touched[kMaxPlanes];  // bitmap of written 64-byte plane lines
  uint64_t touched_words;
  uint32_t* hash_vec;    // [cap * kMaxPlanes] valid-k-mer seed hashes
  uint64_t hash_vec_cap;
  uint64_t vec_max;      // spill threshold (kVecMaxKmers; env-overridable)
  bool vec_mode;
  bool oom;              // an allocation failed: adds become no-ops
  uint32_t* hash_buf;    // [kChunk * 8] chunked hash pipeline scratch
};

void kn_free(KnBuilder* b);  // defined below

KnBuilder* kn_new(uint32_t k, uint32_t min_count, uint32_t log2_count_len,
                  uint32_t max_log2_filter_len) {
  if (k < 1 || k > 32 || min_count < 1 || min_count > kMaxCount ||
      log2_count_len > 32 || max_log2_filter_len > 32 ||
      max_log2_filter_len < 3) {
    return nullptr;
  }
  KnBuilder* b = new KnBuilder();
  b->k = k;
  b->min_count = min_count;
  b->count_mask = (1ull << log2_count_len) - 1;
  b->seq_mask =
      (max_log2_filter_len == 32) ? 0xffffffffull
                                  : (1ull << max_log2_filter_len) - 1;
  b->plane_bytes = (1ull << max_log2_filter_len) / 8;
  b->num_valid_kmer = 0;
  b->num_bp = 0;
  b->cells = static_cast<uint8_t*>(calloc(1ull << log2_count_len, 1));
  b->touched_words = (b->plane_bytes >> kTouchShift >> 6) + 1;
  for (uint32_t h = 0; h < kMaxPlanes; ++h) {
    b->planes[h] = nullptr;   // allocated lazily on vector spill
    b->touched[h] = nullptr;
  }
  b->vec_mode = true;
  // KWAGE_VEC_MAX_KMERS overrides the spill threshold (tests shrink it
  // to exercise the plane path cheaply).
  const char* vm = getenv("KWAGE_VEC_MAX_KMERS");
  b->vec_max = vm ? strtoull(vm, nullptr, 10) : kVecMaxKmers;
  if (b->vec_max < 1) b->vec_max = 1;
  b->hash_vec_cap = 1ull << 16;
  if (b->hash_vec_cap > b->vec_max) b->hash_vec_cap = b->vec_max;
  b->hash_vec = static_cast<uint32_t*>(
      malloc(b->hash_vec_cap * kMaxPlanes * sizeof(uint32_t)));
  b->hash_buf = static_cast<uint32_t*>(malloc(kChunk * 8 * sizeof(uint32_t)));
  b->oom = false;
  if (b->cells == NULL || b->hash_vec == NULL || b->hash_buf == NULL) {
    kn_free(b);
    return nullptr;  // clean error instead of a later null deref
  }
  return b;
}

void kn_free(KnBuilder* b) {
  if (!b) return;
  free(b->cells);
  for (uint32_t h = 0; h < kMaxPlanes; ++h) {
    free(b->planes[h]);
    free(b->touched[h]);
  }
  free(b->hash_vec);
  free(b->hash_buf);
  delete b;
}

// Move from vector mode to plane mode: allocate the reference-shaped
// planes and replay every stored hash into them. Called at most once
// per accession (when num_valid_kmer crosses kVecMaxKmers).
static void kn_spill_to_planes(KnBuilder* b) {
  for (uint32_t h = 0; h < kMaxPlanes; ++h) {
    b->planes[h] = static_cast<uint8_t*>(calloc(b->plane_bytes, 1));
    b->touched[h] =
        static_cast<uint64_t*>(calloc(b->touched_words, sizeof(uint64_t)));
    if (b->planes[h] == NULL || b->touched[h] == NULL) {
      // The spill IS the OOM fallback; if even the planes cannot be
      // allocated, poison the builder (adds become no-ops; fold and the
      // file drivers report -4, surfaced to Python as MemoryError)
      // instead of dereferencing null.
      b->oom = true;
      return;
    }
  }
  for (uint64_t i = 0; i < b->num_valid_kmer; ++i) {
    const uint32_t* hv = b->hash_vec + i * kMaxPlanes;
    for (uint32_t h = 0; h < kMaxPlanes; ++h) {
      const uint64_t bit = hv[h] & b->seq_mask;
      b->planes[h][bit >> 3] |= static_cast<uint8_t>(1u << (bit & 7));
      const uint64_t line = bit >> 3 >> kTouchShift;
      b->touched[h][line >> 6] |= 1ull << (line & 63);
    }
  }
  free(b->hash_vec);
  b->hash_vec = nullptr;
  b->vec_mode = false;
}

uint64_t kn_num_valid_kmer(const KnBuilder* b) { return b->num_valid_kmer; }
uint64_t kn_num_bp(const KnBuilder* b) { return b->num_bp; }

// Apply the counting update + threshold-crossing plane sets for one
// k-mer whose 5 seed hashes are given. Conservative update: only the
// minimum-count cells advance. True in-place increments (not stale-value
// writes) so aliased cells -- two seeds hashing to the same index --
// advance twice, with 4-bit wraparound, exactly like the reference's
// bitfield ++.
inline void kn_update_one(KnBuilder* b, const uint32_t* hashes) {
  uint8_t* c0 = b->cells + (hashes[0] & b->count_mask);
  uint8_t* c1 = b->cells + (hashes[1] & b->count_mask);
  uint8_t* c2 = b->cells + (hashes[2] & b->count_mask);
  uint8_t* c3 = b->cells + (hashes[3] & b->count_mask);
  const uint8_t v0 = *c0 & 0x0f;
  const uint8_t v1 = *c1 & 0x0f;
  const uint8_t v2 = *c2 >> 4;
  const uint8_t v3 = *c3 >> 4;
  const uint8_t mn = std::min(std::min(v0, v1), std::min(v2, v3));

  if (mn < b->min_count) {
    if (mn == b->min_count - 1) {
      if (b->vec_mode) {
        if (b->num_valid_kmer == b->hash_vec_cap) {
          if (b->hash_vec_cap >= b->vec_max) {
            kn_spill_to_planes(b);
          } else {
            uint64_t new_cap = static_cast<uint64_t>(b->hash_vec_cap) * 2;
            if (new_cap > b->vec_max) new_cap = b->vec_max;
            uint32_t* nv = static_cast<uint32_t*>(realloc(
                b->hash_vec, new_cap * kMaxPlanes * sizeof(uint32_t)));
            if (nv == NULL) {
              // OOM: the old buffer is still valid (realloc leaves it
              // untouched on failure) -- fall back to the plane
              // representation instead of crashing the process.
              kn_spill_to_planes(b);
            } else {
              b->hash_vec = nv;
              b->hash_vec_cap = new_cap;
            }
          }
        }
      }
      if (b->oom) {
        // poisoned (spill allocation failed): count but record nothing;
        // fold/digest report -4, surfaced to Python as MemoryError
      } else if (b->vec_mode) {
        uint32_t* hv = b->hash_vec + b->num_valid_kmer * kMaxPlanes;
        for (uint32_t h = 0; h < kMaxPlanes; ++h) hv[h] = hashes[h];
      } else {
        for (uint32_t h = 0; h < kMaxPlanes; ++h) {
          const uint64_t bit = hashes[h] & b->seq_mask;
          b->planes[h][bit >> 3] |= static_cast<uint8_t>(1u << (bit & 7));
          const uint64_t line = bit >> 3 >> kTouchShift;
          b->touched[h][line >> 6] |= 1ull << (line & 63);
        }
      }
      ++b->num_valid_kmer;
    }
    if (v0 == mn) *c0 = static_cast<uint8_t>((*c0 & 0xf0) | (((*c0 & 0x0f) + 1) & 0x0f));
    if (v1 == mn) *c1 = static_cast<uint8_t>((*c1 & 0xf0) | (((*c1 & 0x0f) + 1) & 0x0f));
    if (v2 == mn) *c2 = static_cast<uint8_t>((*c2 & 0x0f) | ((((*c2 >> 4) + 1) & 0x0f) << 4));
    if (v3 == mn) *c3 = static_cast<uint8_t>((*c3 & 0x0f) | ((((*c3 >> 4) + 1) & 0x0f) << 4));
  }
}

// Digest one sequence: rolling duplex window, canonical word, counting
// update, and threshold-crossing bit sets in all five planes.
//
// Pipelined in chunks to hide DRAM latency: pass A extracts canonical
// words and hashes them (AVX2 seed lanes) into hash_buf; pass B applies
// the sequential counting updates with the 4 cell lines (and, when every
// occurrence crosses, the 5 plane lines) software-prefetched a fixed
// distance ahead. Update ORDER is identical to the naive loop, so the
// result is bit-exact; measured ~2x faster (cell misses dominate).
void kn_add_seq(KnBuilder* b, const char* seq, uint64_t len) {
  const uint32_t k = b->k;
  b->num_bp += len;
  if (len < k) return;

  const uint64_t mask = (k == 32) ? ~0ull : (1ull << (2 * k)) - 1;
  const int comp_shift = 2 * (k - 1);
  const int kPrefetchDist = 24;
  // Prefetching the valid-bit planes only pays when most occurrences
  // cross the threshold (min_count == 1: every first occurrence).
  const bool prefetch_planes = (b->min_count == 1);
  uint64_t w = 0, cw = 0;
  uint32_t run = 0;
  uint64_t i = 0;

  while (i < len) {
    // Pass A: fill a chunk of canonical k-mer hashes.
    uint32_t n = 0;
    for (; i < len && n < kChunk; ++i) {
      const int code = base_code(seq[i]);
      if (code < 0) {
        run = 0;
        continue;
      }
      ++run;
      w = (w << 2) | static_cast<uint64_t>(code);
      cw = (cw >> 2) | (static_cast<uint64_t>(3 - code) << comp_shift);
      if (run < k) continue;
      const uint64_t sense = w & mask;
      const uint64_t anti = cw & mask;
      murmur_kmer5(sense < anti ? sense : anti, k, b->hash_buf + 8 * n);
      ++n;
    }

    // Pass B: sequential conservative updates, lines prefetched ahead.
    for (uint32_t j = 0; j < n; ++j) {
      if (j + kPrefetchDist < n) {
        const uint32_t* hp = b->hash_buf + 8 * (j + kPrefetchDist);
        prefetch_byte(b->cells + (hp[0] & b->count_mask));
        prefetch_byte(b->cells + (hp[1] & b->count_mask));
        prefetch_byte(b->cells + (hp[2] & b->count_mask));
        prefetch_byte(b->cells + (hp[3] & b->count_mask));
        if (prefetch_planes && !b->vec_mode) {
          for (uint32_t h = 0; h < kMaxPlanes; ++h) {
            prefetch_byte(b->planes[h] + ((hp[h] & b->seq_mask) >> 3));
          }
        }
      }
      kn_update_one(b, b->hash_buf + 8 * j);
    }
  }
}

// Fold the first num_hash planes (length 2**maxL) into a 2**L filter with
// byte-wise OR at stride (make_bloom.cpp:337-354 equivalent). Only the
// touched 64-byte lines are walked: untouched lines are zero and OR
// contributes nothing, so the result is byte-identical to the reference's
// full-plane scan while the cost scales with num_valid_kmer, not with
// 2**max_log2_filter_len.
int kn_fold(const KnBuilder* b, uint32_t log2_filter_len, uint32_t num_hash,
            uint8_t* out) {
  if (log2_filter_len < 3 || (1ull << log2_filter_len) / 8 > b->plane_bytes ||
      num_hash > kMaxPlanes) {
    return -1;  // degenerate/oversized fold: caller raises
  }
  if (b->oom) return -4;
  const uint64_t dst_bytes = (1ull << log2_filter_len) / 8;
  const uint64_t dst_mask = dst_bytes - 1;  // dst_bytes is a power of two
  const uint64_t line_bytes = 1ull << kTouchShift;
  memset(out, 0, dst_bytes);
  if (b->vec_mode) {
    // Vector fold: bit (hash & seq_mask) % 2**L == hash & (2**L - 1)
    // for L <= maxL, identical to the plane fold's strided OR.
    const uint64_t bit_mask = (1ull << log2_filter_len) - 1;
    const uint32_t nh = num_hash < kMaxPlanes ? num_hash : kMaxPlanes;
    for (uint64_t i = 0; i < b->num_valid_kmer; ++i) {
      const uint32_t* hv = b->hash_vec + i * kMaxPlanes;
      for (uint32_t h = 0; h < nh; ++h) {
        const uint64_t bit = (hv[h] & b->seq_mask) & bit_mask;
        out[bit >> 3] |= static_cast<uint8_t>(1u << (bit & 7));
      }
    }
    return 0;
  }
  for (uint32_t h = 0; h < num_hash && h < kMaxPlanes; ++h) {
    const uint8_t* src = b->planes[h];
    const uint64_t* tw = b->touched[h];
    for (uint64_t w = 0; w < b->touched_words; ++w) {
      uint64_t t = tw[w];
      while (t) {
        const uint64_t line = (w << 6) + __builtin_ctzll(t);
        t &= t - 1;
        const uint64_t base = line << kTouchShift;
        if (dst_bytes >= line_bytes && base + line_bytes <= b->plane_bytes) {
          // base is line-aligned and dst_bytes is a multiple of the line,
          // so (base & dst_mask) stays 8-byte aligned: OR u64 lanes.
          uint64_t* d = reinterpret_cast<uint64_t*>(out + (base & dst_mask));
          const uint64_t* s = reinterpret_cast<const uint64_t*>(src + base);
          for (uint64_t j = 0; j < line_bytes / 8; ++j) d[j] |= s[j];
        } else {
          const uint64_t end = std::min(base + line_bytes, b->plane_bytes);
          for (uint64_t i = base; i < end; ++i) out[i & dst_mask] |= src[i];
        }
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Native data loader: stream a FASTA/FASTQ(.gz) file straight into the
// counting builder (no per-read Python in the ingest loop). Record
// segmentation matches the engine's Python reader (io/sequence.py) and
// the reference's parse_sequence.cpp: FASTA records split on '>'-lines
// with whitespace stripped from the sequence; FASTQ is 4-line records;
// empty sequences are skipped.
// ---------------------------------------------------------------------------

struct KnRecordBuf {
  char* data = nullptr;
  uint64_t len = 0;
  uint64_t cap = 0;
  bool oom = false;
  void push(char c) {
    if (len == cap) {
      const uint64_t new_cap = cap ? cap * 2 : 1 << 20;
      char* nd = static_cast<char*>(realloc(data, new_cap));
      if (nd == NULL) {  // old buffer stays valid; record is poisoned
        oom = true;
        return;
      }
      data = nd;
      cap = new_cap;
    }
    data[len++] = c;
  }
  ~KnRecordBuf() { free(data); }
};

// Shared streaming parser: calls on_record(data, len) for every record;
// on_record returns true to STOP the parse early (e.g. a sliced range's
// end -- the remaining file is neither read nor truncation-checked,
// matching the Python twin's break-at-range-end).
// format: 0 = FASTA, 1 = FASTQ.
// Returns 0 on success, -1 open failure, -2 truncated FASTQ, -3 read error.
}  // extern "C" (template needs C++ linkage; re-entered below)
template <class F>
static int kn_parse_file(const char* path, int format, F&& on_record) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;

  const uint64_t kBuf = 1 << 20;
  char* buf = static_cast<char*>(malloc(kBuf));
  if (buf == NULL) {
    gzclose(f);
    return -4;  // OOM: callers fall back to the Python parser
  }
  KnRecordBuf rec;
  int rc = 0;
  bool stopped = false;

  auto flush_record = [&]() {
    if (rec.oom) {  // a push failed: the record is incomplete
      rc = -4;
      stopped = true;
      rec.len = 0;
      return;
    }
    if (rec.len == 0) return;
    stopped = on_record(rec.data, rec.len);
    rec.len = 0;
  };

  // fastq_line: 0 header, 1 sequence, 2 '+', 3 quality
  int fastq_line = 0;
  bool qual_seen = false;  // any character on the current quality line
  bool fasta_defline = false;
  uint64_t line_start_len = 0;  // rec.len at the start of the current line

  for (;;) {
    int n = gzread(f, buf, kBuf);
    if (n < 0) { rc = -3; break; }
    if (n == 0) break;
    for (int i = 0; i < n && !stopped; ++i) {
      const char c = buf[i];
      if (c == '\n') {
        if (format == 1) {
          if (fastq_line == 1) flush_record();
          fastq_line = (fastq_line + 1) & 3;
          if (fastq_line == 3) qual_seen = false;
        } else {
          fasta_defline = false;
          line_start_len = rec.len;
        }
        continue;
      }
      if (format == 0) {
        // A line CONTAINING '>' anywhere is a defline (parse_sequence.cpp:
        // 86 uses strchr): drop this line's chars, flush the prior record.
        if (c == '>' && !fasta_defline) {
          rec.len = line_start_len;
          flush_record();
          line_start_len = 0;
          fasta_defline = true;
        } else if (!fasta_defline && c != ' ' && c != '\t' && c != '\r') {
          rec.push(c);
        }
      } else {
        if (fastq_line == 1 && c != ' ' && c != '\t' && c != '\r') {
          rec.push(c);
        } else if (fastq_line == 3) {
          qual_seen = true;
        }
      }
    }
    if (stopped) break;
  }
  if (rc == 0 && !stopped) {
    if (format == 0) {
      flush_record();
    } else if (fastq_line == 3 && qual_seen) {
      // Quality characters present but no trailing newline: complete.
      // (The sequence flushed when its line ended; any other mid-record
      // EOF -- including a missing quality line -- is truncated input,
      // matching the Python/reference readers.)
    } else if (fastq_line != 0) {
      rc = -2;
    }
  }
  free(buf);
  gzclose(f);
  return rc;
}
extern "C" {

// b may be null (pass 1: just count).
int kn_digest_file(KnBuilder* b, const char* path, int format,
                   uint64_t* out_spots, uint64_t* out_bp) {
  uint64_t spots = 0, bp = 0;
  const int rc = kn_parse_file(path, format, [&](const char* d, uint64_t n) {
    ++spots;
    bp += n;
    if (b) kn_add_seq(b, d, n);
    return false;
  });
  if (out_spots) *out_spots = spots;
  if (out_bp) *out_bp = bp;
  if (rc == 0 && b && b->oom) return -4;  // builder poisoned mid-stream
  return rc;
}

// Batch-sizing scan: every record counts toward spots/bp; records with
// len >= min_len count toward rows/max_len (the device batch's rows).
int kn_scan_file(const char* path, int format, uint32_t min_len,
                 uint64_t* out_spots, uint64_t* out_bp,
                 uint64_t* out_rows, uint64_t* out_max_len) {
  uint64_t spots = 0, bp = 0, rows = 0, max_len = 0;
  const int rc = kn_parse_file(path, format, [&](const char*, uint64_t n) {
    ++spots;
    bp += n;
    if (n >= min_len) {
      ++rows;
      if (n > max_len) max_len = n;
    }
    return false;
  });
  if (out_spots) *out_spots = spots;
  if (out_bp) *out_bp = bp;
  if (out_rows) *out_rows = rows;
  if (out_max_len) *out_max_len = max_len;
  return rc;
}

// Pack records with len >= min_len straight into a zeroed row-major
// 2-bit batch (no intermediate strings): row r starting at row_off gets
// base j's code in packed[r*words16 + j/16] bits 2*(j%16) (A=0, C=1,
// G=2, T=3, case-insensitive) and its validity bit in
// validw[r*words32 + j/32] bit j%32 -- the exact layout of
// ops.kmers.pack_reads_host / unpack_reads_device. Rows beyond max_rows
// are dropped (caller sizes from kn_scan_file).
int kn_pack_file(const char* path, int format, uint32_t min_len,
                 uint64_t row_off, uint64_t max_rows,
                 uint64_t words16, uint64_t words32,
                 uint32_t* packed, uint32_t* validw, uint64_t* out_rows) {
  uint8_t code_lut[256];
  uint8_t valid_lut[256];
  memset(code_lut, 0, sizeof(code_lut));
  memset(valid_lut, 0, sizeof(valid_lut));
  const char* bases = "ACGT";
  for (int i = 0; i < 4; ++i) {
    code_lut[(uint8_t)bases[i]] = i;
    code_lut[(uint8_t)(bases[i] + 32)] = i;  // lowercase
    valid_lut[(uint8_t)bases[i]] = 1;
    valid_lut[(uint8_t)(bases[i] + 32)] = 1;
  }
  uint64_t rows = 0;
  const int rc = kn_parse_file(path, format, [&](const char* d, uint64_t n) {
    if (n < min_len || rows >= max_rows) return false;
    uint32_t* prow = packed + (row_off + rows) * words16;
    uint32_t* vrow = validw + (row_off + rows) * words32;
    const uint64_t limit = n < words16 * 16 ? n : words16 * 16;
    for (uint64_t j = 0; j < limit; ++j) {
      const uint8_t c = (uint8_t)d[j];
      prow[j >> 4] |= (uint32_t)code_lut[c] << (2 * (j & 15));
      vrow[j >> 5] |= (uint32_t)valid_lut[c] << (j & 31);
    }
    ++rows;
    return false;
  });
  if (out_rows) *out_rows = rows;
  return rc;
}

// ---------------------------------------------------------------------------
// Stateless helpers for the query path and device-kernel cross-checks.
// ---------------------------------------------------------------------------

// Extract canonical k-mer words in sequence order; returns the count.
// `out` must have room for len - k + 1 words.
uint64_t kn_canonical_kmers(const char* seq, uint64_t len, uint32_t k,
                            uint64_t* out) {
  if (len < k) return 0;
  const uint64_t mask = (k == 32) ? ~0ull : (1ull << (2 * k)) - 1;
  const int comp_shift = 2 * (k - 1);
  uint64_t w = 0, cw = 0;
  uint32_t run = 0;
  uint64_t n = 0;
  for (uint64_t i = 0; i < len; ++i) {
    const int code = base_code(seq[i]);
    if (code < 0) {
      run = 0;
      continue;
    }
    ++run;
    w = (w << 2) | static_cast<uint64_t>(code);
    cw = (cw >> 2) | (static_cast<uint64_t>(3 - code) << comp_shift);
    if (run >= k) {
      const uint64_t sense = w & mask;
      const uint64_t anti = cw & mask;
      out[n++] = sense < anti ? sense : anti;
    }
  }
  return n;
}

// Bit-sliced Bloom search reduction (the host query kernel,
// kwage.cpp:340-541 analog). `slices` is an in-memory uint8 matrix with
// one `slice_size`-byte bit-slice row per table row; `rows` holds the
// n_kmer * num_hash row indices (k-mer major) that the caller already
// computed via murmur % 2**L. Filter f's bit lives at byte f/8, bit f%8
// of each row (LSB-first, the on-disk layout).
//
// complete != 0 (threshold == 1.0): AND-accumulate the per-k-mer match
// vectors with an all-zero early exit -- the same result as the full
// reduction (a filter matches iff every k-mer's bit is set; once the
// accumulator is zero no filter can match), which is what makes the
// reference's early-exit loop (kwage.cpp:415-424) safe to mirror here.
// Matched filters get count = n_kmer by definition.
//
// Otherwise: exact per-filter hit counts via carry-save bit-plane
// accumulation (one u64 plane per count bit -- the host twin of the
// device CSA reduction in ops/search.py), matched = count >= qt where
// the caller supplies qt = trunc(float32(threshold) * float32(n_kmer))
// (kwage.cpp:388).
//
// out_idx / out_counts must hold num_filter entries; returns the number
// of matched filters, emitted in ascending filter order.
uint64_t kn_search(const uint8_t* slices, uint64_t slice_size,
                   const uint64_t* rows, uint64_t n_kmer, uint32_t num_hash,
                   uint32_t num_filter, int complete, uint64_t qt,
                   uint32_t* out_idx, uint64_t* out_counts) {
  if (n_kmer == 0 || num_hash == 0 || num_filter == 0 || slice_size == 0) {
    return 0;
  }
  const uint64_t W = (slice_size + 7) / 8;
  const uint64_t full = slice_size / 8;
  const uint64_t tail = slice_size & 7;
  uint64_t* m = static_cast<uint64_t*>(malloc(W * sizeof(uint64_t)));
  if (m == NULL) return ~0ull;  // OOM sentinel: caller falls back

  // m = AND of the num_hash seed rows of k-mer i (zero-padded tail word).
  auto load_match = [&](uint64_t i) {
    const uint8_t* r0 = slices + rows[i * num_hash] * slice_size;
    memcpy(m, r0, slice_size);
    if (tail) {
      memset(reinterpret_cast<uint8_t*>(m) + slice_size, 0,
             W * sizeof(uint64_t) - slice_size);
    }
    for (uint32_t h = 1; h < num_hash; ++h) {
      const uint8_t* r = slices + rows[i * num_hash + h] * slice_size;
      for (uint64_t w = 0; w < full; ++w) {
        uint64_t v;
        memcpy(&v, r + w * 8, 8);
        m[w] &= v;
      }
      if (tail) {
        uint64_t v = 0;
        memcpy(&v, r + full * 8, tail);
        m[full] &= v;
      }
    }
  };

  // Random slice rows are a per-row DRAM latency chain; prefetching the
  // next k-mers' rows overlaps the misses (same trick as the ingest
  // pipeline's cell prefetch).
  const uint64_t kRowPrefetch = 8;
  auto prefetch_kmer_rows = [&](uint64_t i) {
    if (i >= n_kmer) return;
    for (uint32_t h = 0; h < num_hash; ++h) {
      const uint8_t* r = slices + rows[i * num_hash + h] * slice_size;
      for (uint64_t off = 0; off < slice_size; off += 64) prefetch_read(r + off);
    }
  };

  uint64_t n_out = 0;
  if (complete) {
    uint64_t* acc = static_cast<uint64_t*>(malloc(W * sizeof(uint64_t)));
    if (acc == NULL) { free(m); return ~0ull; }
    load_match(0);
    memcpy(acc, m, W * sizeof(uint64_t));
    bool any = false;
    for (uint64_t w = 0; w < W; ++w) any |= acc[w] != 0;
    for (uint64_t i = 1; i < n_kmer && any; ++i) {
      prefetch_kmer_rows(i + kRowPrefetch);
      load_match(i);
      uint64_t live = 0;
      for (uint64_t w = 0; w < W; ++w) live |= (acc[w] &= m[w]);
      any = live != 0;
    }
    for (uint32_t f = 0; f < num_filter; ++f) {
      if ((acc[f >> 6] >> (f & 63)) & 1) {
        out_idx[n_out] = f;
        out_counts[n_out] = n_kmer;
        ++n_out;
      }
    }
    free(acc);
    free(m);
    return n_out;
  }

  // Counting mode: P bit planes hold every per-filter count exactly
  // (counts <= n_kmer < 2**P, so the top carry never overflows).
  uint32_t P = 1;
  while ((1ull << P) <= n_kmer) ++P;
  uint64_t* planes =
      static_cast<uint64_t*>(calloc(static_cast<size_t>(P) * W, sizeof(uint64_t)));
  if (planes == NULL) { free(m); return ~0ull; }
  for (uint64_t i = 0; i < n_kmer; ++i) {
    prefetch_kmer_rows(i + kRowPrefetch);
    load_match(i);
    // Ripple carry-save add of the 1-bit vector m into the planes;
    // m doubles as the carry vector. Amortized ~2 plane passes per add.
    for (uint32_t p = 0; p < P; ++p) {
      uint64_t* pl = planes + static_cast<uint64_t>(p) * W;
      uint64_t carry_any = 0;
      for (uint64_t w = 0; w < W; ++w) {
        const uint64_t t = pl[w] & m[w];
        pl[w] ^= m[w];
        m[w] = t;
        carry_any |= t;
      }
      if (!carry_any) break;
    }
  }
  for (uint32_t f = 0; f < num_filter; ++f) {
    const uint64_t word = f >> 6;
    const uint32_t bit = f & 63;
    uint64_t count = 0;
    for (uint32_t p = 0; p < P; ++p) {
      count |= ((planes[static_cast<uint64_t>(p) * W + word] >> bit) & 1) << p;
    }
    if (count >= qt) {
      out_idx[n_out] = f;
      out_counts[n_out] = count;
      ++n_out;
    }
  }
  free(planes);
  free(m);
  return n_out;
}

static uint64_t kn_dedup_kmers(uint64_t* kbuf, uint64_t n);  // defined below

// Whole query batch against one in-memory slice matrix in a single call
// (the per-query pipeline of kwage.cpp:340-541 with the reduction shared
// with kn_search): per query, extract unique canonical k-mers, map each
// (k-mer, seed) to a slice row via murmur3-32 masked to 2**L, then run
// the complete/counting reduction. Hits append to out_qid/out_fidx/
// out_counts -- the caller sizes them for nq * num_filter, the hard
// maximum. out_nkmer[q] gets query q's unique-k-mer count (0 = no valid
// k-mers: no hits emitted, mirroring the Python engine's None).
// qt per query = trunc(float(threshold) * float(n_unique)), the
// reference's float32 narrowing (kwage.cpp:388). Returns the number of
// hit entries, or ~0 on scratch OOM (caller falls back).
uint64_t kn_search_all(const uint8_t* slices, uint64_t slice_size,
                       const char* queries, const uint64_t* q_off,
                       uint64_t nq, uint32_t k, uint32_t num_hash,
                       uint32_t log2_filter_len, uint32_t num_filter,
                       float threshold, uint32_t* out_qid,
                       uint32_t* out_fidx, uint64_t* out_counts,
                       uint64_t* out_nkmer) {
  if (num_hash == 0 || num_hash > kMaxPlanes) {
    return ~0ull;  // murmur_kmer5 fills kMaxPlanes lanes; caller falls back
  }
  const int complete = threshold == 1.0f;
  const uint64_t mask =
      log2_filter_len >= 32 ? 0xFFFFFFFFull : (1ull << log2_filter_len) - 1;
  uint64_t max_len = 0;
  for (uint64_t q = 0; q < nq; ++q) {
    const uint64_t len = q_off[q + 1] - q_off[q];
    if (len > max_len) max_len = len;
  }
  const uint64_t kcap = max_len < 16 ? 16 : max_len;
  uint64_t* kbuf = static_cast<uint64_t*>(malloc(kcap * sizeof(uint64_t)));
  uint64_t* rows = static_cast<uint64_t*>(
      malloc(kcap * num_hash * sizeof(uint64_t)));
  uint32_t* idx = static_cast<uint32_t*>(malloc(num_filter * sizeof(uint32_t)));
  uint64_t* cnt = static_cast<uint64_t*>(malloc(num_filter * sizeof(uint64_t)));
  if (kbuf == NULL || rows == NULL || idx == NULL || cnt == NULL) {
    free(kbuf); free(rows); free(idx); free(cnt);
    return ~0ull;
  }
  uint64_t n_out = 0;
  for (uint64_t q = 0; q < nq; ++q) {
    const char* seq = queries + q_off[q];
    const uint64_t len = q_off[q + 1] - q_off[q];
    const uint64_t n = kn_canonical_kmers(seq, len, k, kbuf);
    const uint64_t nu = kn_dedup_kmers(kbuf, n);
    out_nkmer[q] = nu;
    if (nu == 0) continue;
    uint32_t h8[8];
    for (uint64_t i = 0; i < nu; ++i) {
      murmur_kmer5(kbuf[i], k, h8);
      for (uint32_t h = 0; h < num_hash; ++h) {
        rows[i * num_hash + h] = h8[h] & mask;
      }
    }
    const uint64_t qt =
        complete ? 0
                 : static_cast<uint64_t>(threshold * static_cast<float>(nu));
    const uint64_t hits = kn_search(slices, slice_size, rows, nu, num_hash,
                                    num_filter, complete, qt, idx, cnt);
    if (hits == ~0ull) {
      free(kbuf); free(rows); free(idx); free(cnt);
      return ~0ull;
    }
    for (uint64_t j = 0; j < hits; ++j) {
      out_qid[n_out] = static_cast<uint32_t>(q);
      out_fidx[n_out] = idx[j];
      out_counts[n_out] = cnt[j];
      ++n_out;
    }
  }
  free(kbuf); free(rows); free(idx); free(cnt);
  return n_out;
}

// Sorted-unique canonical k-mers of one read (the SriRachA per-read
// profile, search_by_kmer.cpp:44-70): writes the sorted deduplicated
// words to `out` (caller sizes for len - k + 1) and the TOTAL k-mer
// count (pre-dedup, N-windows excluded) to *out_total; returns the
// unique count.
static uint64_t kn_sort_dedup(uint64_t* a, uint64_t n) {
  if (n <= 1) return n;
  std::sort(a, a + n);
  uint64_t u = 1;
  for (uint64_t i = 1; i < n; ++i) {
    if (a[i] != a[u - 1]) a[u++] = a[i];
  }
  return u;
}

uint64_t kn_unique_kmers(const char* seq, uint64_t len, uint32_t k,
                         uint64_t* out, uint64_t* out_total) {
  const uint64_t n = kn_canonical_kmers(seq, len, k, out);
  if (out_total) *out_total = n;
  return kn_sort_dedup(out, n);
}

// |uniq ∩ subject| where both arrays are sorted u64: one branchless
// lower_bound per query k-mer -- the formulation the reference measured
// 1.6x faster than a merge walk (search_by_kmer.cpp:94-98,
// ChangeLog.md:16-19).
uint64_t kn_sorted_intersect_count(const uint64_t* uniq, uint64_t n,
                                   const uint64_t* subject, uint64_t m) {
  if (m == 0 || n == 0) return 0;
  uint64_t count = 0;
  // 8 searches interleaved: every level issues 8 independent loads, so
  // the dependent-load chain of one lower_bound overlaps seven others
  // (~6x on DRAM/L2-resident subjects). All lanes share the same rem
  // schedule because every search starts at rem = m.
  constexpr uint64_t kLanes = 8;
  uint64_t i = 0;
  for (; i + kLanes <= n; i += kLanes) {
    const uint64_t* base[kLanes];
    uint64_t key[kLanes];
    for (uint64_t l = 0; l < kLanes; ++l) {
      base[l] = subject;
      key[l] = uniq[i + l];
    }
    for (uint64_t rem = m; rem > 1;) {
      const uint64_t half = rem / 2;
      for (uint64_t l = 0; l < kLanes; ++l) {
        base[l] = (base[l][half] <= key[l]) ? base[l] + half : base[l];
      }
      rem -= half;
    }
    for (uint64_t l = 0; l < kLanes; ++l) count += (*base[l] == key[l]);
  }
  for (; i < n; ++i) {
    const uint64_t key = uniq[i];
    const uint64_t* base = subject;
    for (uint64_t rem = m; rem > 1;) {
      const uint64_t half = rem / 2;
      base = (base[half] <= key) ? base + half : base;
      rem -= half;
    }
    count += (*base == key);
  }
  return count;
}

// One SriRachA read against every subject in a single call
// (search_by_kmer.cpp:14-135): canonical k-mer profile, the
// min-valid-k-mer and read-complexity gates, one lower_bound
// intersection per active subject, and the score threshold -- all the
// float math in C `float`, which is bit-identical to the np.float32
// scoring of the Python twin (both round the integer counts to f32 and
// divide in f32).
//
// subject_base points at the concatenation of all subject k-mer arrays;
// subject s spans [subject_off[s], subject_off[s] + subject_len[s]).
// active[s] == 0 skips subject s (the num_perfect >= max_num_match
// skip). kbuf must hold len - k + 1 words.
//
// Returns -1 when a gate rejected the read; otherwise the number of
// matched subjects, with out_counts[s] / out_matched[s] filled for
// active subjects and *out_num_unique / *out_num_kmer set.
// Dedup a k-mer list in place WITHOUT sorting (intersection counts do
// not depend on query order): open-addressing table with ~0 as the
// empty sentinel (~0 is never a canonical k-mer -- its complement 0 is
// always smaller). Falls back to sort+dedup for huge records where the
// table would spill the cache.
static uint64_t kn_dedup_kmers(uint64_t* kbuf, uint64_t n) {
  if (n <= 1) return n;
  if (n > (1u << 15)) return kn_sort_dedup(kbuf, n);
  uint64_t cap = 16;
  while (cap < 2 * n) cap <<= 1;
  static thread_local uint64_t* table = nullptr;
  static thread_local uint64_t table_cap = 0;
  if (table_cap < cap) {
    free(table);
    table = static_cast<uint64_t*>(malloc(cap * sizeof(uint64_t)));
    table_cap = table ? cap : 0;
    if (table == nullptr) {  // OOM: the sort path needs no scratch
      return kn_sort_dedup(kbuf, n);
    }
  }
  memset(table, 0xff, cap * sizeof(uint64_t));
  const uint64_t mask = cap - 1;
  uint64_t u = 0;
  for (uint64_t i = 0; i < n; ++i) {
    const uint64_t w = kbuf[i];
    // splitmix64-style mix for slot spread
    uint64_t h = w;
    h ^= h >> 30; h *= 0xbf58476d1ce4e5b9ull;
    h ^= h >> 27; h *= 0x94d049bb133111ebull;
    h ^= h >> 31;
    uint64_t slot = h & mask;
    for (;;) {
      const uint64_t cur = table[slot];
      if (cur == ~0ull) {
        table[slot] = w;
        kbuf[u++] = w;
        break;
      }
      if (cur == w) break;
      slot = (slot + 1) & mask;
    }
  }
  return u;
}

int64_t kn_read_search(const char* seq, uint64_t len, uint32_t k,
                       uint64_t min_valid_kmer, float min_complexity,
                       float threshold, const uint64_t* subject_base,
                       const uint64_t* subject_off,
                       const uint64_t* subject_len, const uint8_t* active,
                       uint32_t num_subjects, uint64_t* kbuf,
                       uint64_t* out_counts, uint8_t* out_matched,
                       uint64_t* out_num_unique, uint64_t* out_num_kmer) {
  const uint64_t num_kmer = kn_canonical_kmers(seq, len, k, kbuf);
  const uint64_t num_unique = kn_dedup_kmers(kbuf, num_kmer);
  if (out_num_kmer) *out_num_kmer = num_kmer;
  if (out_num_unique) *out_num_unique = num_unique;
  if (num_kmer < min_valid_kmer) return -1;
  // 0/0 -> NaN; NaN < min_complexity is false, so an all-N read with
  // min_valid_kmer == 0 proceeds and scores NaN (never >= threshold),
  // exactly like the np.float32 twin.
  if (static_cast<float>(num_unique) / static_cast<float>(num_kmer) <
      min_complexity) {
    return -1;
  }
  int64_t n_matched = 0;
  for (uint32_t s = 0; s < num_subjects; ++s) {
    if (!active[s]) {
      out_matched[s] = 0;  // never leave a stale flag from a prior read
      continue;
    }
    const uint64_t count = kn_sorted_intersect_count(
        kbuf, num_unique, subject_base + subject_off[s], subject_len[s]);
    out_counts[s] = count;
    const float score =
        static_cast<float>(count) / static_cast<float>(num_unique);
    const uint8_t hit = score >= threshold ? 1 : 0;
    out_matched[s] = hit;
    n_matched += hit;
  }
  return n_matched;
}

// Stream a whole local FASTA/FASTQ(.gz) file through the per-read
// kernel: the reference's local-file reader loop (sra_stream.cpp:585-719)
// with zero per-read Python. Records are numbered 1-based; only reads in
// [start, stop) are counted and searched (assign_read_range semantics,
// sra_stream.cpp:525-543). `cb` fires once per (subject, read) match with
// the f32 score; the callback may flip entries of `active` off (perfect-
// score culling) -- it is re-read every record. Returns the total record
// count, or the parser's negative error code (-1 open, -2 truncated
// FASTQ, -3 read error).
typedef void (*KnMatchCb)(void* ctx, uint32_t subject, uint64_t read_index,
                          float score, const char* seq, uint64_t seq_len);

int64_t kn_sriracha_file(const char* path, int format, uint64_t start,
                         uint64_t stop, uint32_t k, uint64_t min_read_length,
                         uint64_t min_valid_kmer, float min_complexity,
                         float threshold, const uint64_t* subject_base,
                         const uint64_t* subject_off,
                         const uint64_t* subject_len, const uint8_t* active,
                         uint32_t num_subjects, uint64_t* out_num_reads,
                         uint64_t* out_num_bases, KnMatchCb cb, void* ctx) {
  uint64_t kbuf_cap = 4096;
  uint64_t* kbuf = static_cast<uint64_t*>(malloc(kbuf_cap * sizeof(uint64_t)));
  uint64_t* counts =
      static_cast<uint64_t*>(malloc(num_subjects * sizeof(uint64_t)));
  uint8_t* matched = static_cast<uint8_t*>(malloc(num_subjects));
  if (kbuf == NULL || counts == NULL || matched == NULL) {
    free(kbuf);
    free(counts);
    free(matched);
    return -4;  // OOM: caller falls back to the Python twin
  }
  uint64_t reads = 0, bases = 0, i = 0;
  // done = all later records are out of range: stop the parse (a sliced
  // run reads only its prefix of the file, like the Python twin's break).
  const int rc = kn_parse_file(path, format, [&](const char* d, uint64_t n) {
    ++i;
    const bool done = i + 1 >= stop;
    if (i < start || i >= stop) return done;
    ++reads;
    bases += n;
    if (n < min_read_length) return done;
    if (n >= k && n - k + 1 > kbuf_cap) {
      uint64_t* nb = static_cast<uint64_t*>(
          realloc(kbuf, (n - k + 1) * sizeof(uint64_t)));
      if (nb == NULL) return done;  // OOM: skip this record, keep streaming
      kbuf = nb;
      kbuf_cap = n - k + 1;
    }
    uint64_t nu = 0, nk = 0;
    const int64_t nm = kn_read_search(
        d, n, k, min_valid_kmer, min_complexity, threshold, subject_base,
        subject_off, subject_len, active, num_subjects, kbuf, counts, matched,
        &nu, &nk);
    if (nm <= 0) return done;
    for (uint32_t s = 0; s < num_subjects; ++s) {
      if (matched[s]) {
        cb(ctx, s, i, static_cast<float>(counts[s]) / static_cast<float>(nu),
           d, n);
      }
    }
    return done;
  });
  free(kbuf);
  free(counts);
  free(matched);
  if (out_num_reads) *out_num_reads = reads;
  if (out_num_bases) *out_num_bases = bases;
  return rc < 0 ? rc : static_cast<int64_t>(i);
}

// Multi-seed murmur for a batch of k-mer words: out[n][num_seeds].
void kn_murmur32(const uint64_t* words, uint64_t n, uint32_t k,
                 uint32_t num_seeds, uint32_t* out) {
#ifdef __AVX2__
  if (num_seeds <= 8) {
    uint32_t tmp[8];
    for (uint64_t i = 0; i < n; ++i) {
      murmur_kmer8_avx(words[i], k, tmp);
      memcpy(out + i * num_seeds, tmp, num_seeds * sizeof(uint32_t));
    }
    return;
  }
#endif
  // Any seed count: 8-lane chunks with seed_base offsets (a corrupt
  // header's num_hash can exceed the 8-lane state without overflowing).
  for (uint64_t i = 0; i < n; ++i) {
    for (uint32_t base = 0; base < num_seeds; base += 8) {
      const uint32_t cnt = num_seeds - base < 8 ? num_seeds - base : 8;
      murmur_kmer(words[i], k, base, cnt, out + i * num_seeds + base);
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native SRA inventory builder -- the fast path of pipeline/inventory.py
// (itself the twin of the reference sra_inventory.cpp:64-1268). Streams the
// NCBI metadata tar.gz twice (tab table, then XML members), accumulates
// annotations with the same 100k-record overflow merges, applies the same
// filters, stable-sorts ascending by number_of_bases and writes the binary
// inventory with the exact FilterInfo codec. Output is byte-identical to
// the Python twin on valid-UTF-8 archives (this path passes member bytes
// through raw, like the reference; the Python twin re-encodes via UTF-8
// with replacement characters on malformed input).
// ---------------------------------------------------------------------------

#include <string>
#include <unordered_map>
#include <vector>

namespace kninv {

constexpr uint64_t kMaxNumXml = 100000;  // MAX_NUM_XML overflow merge

struct Err {
  int code = 0;        // -1 open, -2 parse, -3 read
  std::string msg;
  bool fail(int c, const std::string& m) { code = c; msg = m; return false; }
};

// Insertion-ordered string map with dict overwrite-in-place semantics.
struct OrderedMap {
  std::vector<std::pair<std::string, std::string>> items;
  void set(const std::string& k, const std::string& v) {
    for (auto& kv : items) {
      if (kv.first == k) { kv.second = v; return; }
    }
    items.emplace_back(k, v);
  }
  void update(const OrderedMap& o) {
    for (const auto& kv : o.items) set(kv.first, kv.second);
  }
  bool empty() const { return items.empty(); }
};

struct Rec {
  uint64_t run = 0, exp = 0, samp = 0, study = 0;
  std::string exp_title, exp_design, lib_name, lib_strategy, lib_source,
      lib_selection, instrument;
  std::string taxa, study_title, study_abstract;
  OrderedMap attrs;
  uint64_t spots = 0, bases = 0;
  uint32_t dd = 0, dm = 0, dy = 0;
  bool valid = true;
};

struct Xml {
  std::string exp_title, exp_design, lib_name, lib_strategy, lib_source,
      lib_selection, instrument;
  std::string taxa, study_title, study_abstract;
  OrderedMap attrs;
  bool invalid = false;  // dbgap controlled access
};

// --- tar.gz member stream (TarIterator twin; ustar prefix + GNU longname).
struct TarReader {
  gzFile f = nullptr;
  uint64_t remaining = 0;  // unread data bytes of the current member
  uint64_t pad = 0;        // padding after the current member
  std::string name;

  bool open(const char* path) {
    f = gzopen(path, "rb");
    return f != nullptr;
  }
  ~TarReader() {
    if (f) gzclose(f);
  }
  bool skip(uint64_t n, Err* e) {
    char buf[4096];
    while (n) {
      const unsigned chunk = n > sizeof(buf) ? sizeof(buf) : (unsigned)n;
      const int r = gzread(f, buf, chunk);
      if (r <= 0) return e->fail(-3, "truncated tar archive");
      n -= (uint64_t)r;
    }
    return true;
  }
  static uint64_t octal(const char* p, int n) {
    if (n > 0 && (uint8_t)p[0] & 0x80) {  // GNU base-256 (members >= 8 GiB)
      uint64_t v = (uint8_t)p[0] & 0x7F;
      for (int i = 1; i < n; ++i) v = (v << 8) | (uint8_t)p[i];
      return v;
    }
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      const char c = p[i];
      if (c == ' ' || c == '\0') {
        if (v) break;
        continue;
      }
      if (c < '0' || c > '7') break;
      v = v * 8 + (uint64_t)(c - '0');
    }
    return v;
  }
  // Advance to the next REGULAR FILE member; false at end-of-archive or
  // error (check e->code).
  bool next(Err* e) {
    if (!skip(remaining + pad, e)) return false;
    remaining = pad = 0;
    std::string longname;
    uint64_t pax_size = 0;
    bool have_pax_size = false;
    for (;;) {
      char hdr[512];
      int got = gzread(f, hdr, 512);
      if (got == 0) return false;  // clean EOF (no zero blocks)
      if (got != 512) return e->fail(-3, "truncated tar header");
      bool zero = true;
      for (int i = 0; i < 512 && zero; ++i) zero = hdr[i] == 0;
      if (zero) return false;  // end-of-archive marker
      uint64_t size = octal(hdr + 124, 12);
      const char type = hdr[156];
      if (have_pax_size && type != 'L' && type != 'x') {
        size = pax_size;  // PAX size= overrides the (possibly 0) octal field
        have_pax_size = false;
      }
      const uint64_t padded = (size + 511) & ~511ull;
      if (type == 'L' || type == 'x') {
        // GNU longname ('L': data IS the next member's name) or a PAX
        // extended header ('x': "LEN key=value\n" records; the "path"
        // key overrides the next member's name -- what Python tarfile
        // emits for names over 100 chars).
        if (size > (1u << 20)) return e->fail(-3, "oversized tar header");
        std::string buf(size, '\0');
        if (size && gzread(f, &buf[0], (unsigned)size) != (int)size)
          return e->fail(-3, "truncated tar extension header");
        if (!skip(padded - size, e)) return false;
        if (type == 'L') {
          while (!buf.empty() && buf.back() == '\0') buf.pop_back();
          longname = buf;
        } else {
          size_t pos = 0;
          while (pos < buf.size()) {
            size_t sp = buf.find(' ', pos);
            if (sp == std::string::npos) break;
            const unsigned long rec_len =
                strtoul(buf.c_str() + pos, nullptr, 10);
            if (rec_len == 0 || pos + rec_len > buf.size()) break;
            // record body spans (sp+1 .. pos+rec_len-1), trailing '\n'
            const std::string body =
                buf.substr(sp + 1, pos + rec_len - sp - 2);
            if (body.compare(0, 5, "path=") == 0) longname = body.substr(5);
            if (body.compare(0, 5, "size=") == 0) {
              pax_size = strtoull(body.c_str() + 5, nullptr, 10);
              have_pax_size = true;
            }
            pos += rec_len;
          }
        }
        continue;
      }
      if (type != '0' && type != '\0') {  // non-file: skip data
        if (!skip(padded, e)) return false;
        continue;
      }
      if (!longname.empty()) {
        name = longname;
      } else {
        char nm[101], pre[156];
        memcpy(nm, hdr, 100); nm[100] = '\0';
        memcpy(pre, hdr + 345, 155); pre[155] = '\0';
        name = pre[0] ? std::string(pre) + "/" + nm : std::string(nm);
      }
      remaining = size;
      pad = padded - size;
      return true;
    }
  }
  int64_t read(char* buf, uint64_t n) {
    if (n > remaining) n = remaining;
    if (n == 0) return 0;
    const int r = gzread(f, buf, (unsigned)n);
    if (r > 0) remaining -= (uint64_t)r;
    return r;
  }
};

// Chunked line iteration over the current member: '\n' separated, all
// trailing '\r' stripped, final unterminated tail yielded (iter_tar_lines
// twin). cb returns false to abort (error recorded in e).
template <class F>
static bool for_each_line(TarReader& tr, Err* e, F&& cb) {
  std::string pending;
  std::vector<char> buf(1 << 20);
  auto emit = [&](const char* p, size_t n) {
    while (n && p[n - 1] == '\r') --n;
    return cb(p, n);
  };
  for (;;) {
    const int64_t got = tr.read(buf.data(), buf.size());
    if (got < 0) return e->fail(-3, "tar member read error");
    if (got == 0) break;
    size_t start = 0;
    const char* b = buf.data();
    for (size_t i = 0; i < (size_t)got; ++i) {
      if (b[i] != '\n') continue;
      if (pending.empty()) {
        if (!emit(b + start, i - start)) return false;
      } else {
        pending.append(b + start, i - start);
        if (!emit(pending.data(), pending.size())) return false;
        pending.clear();
      }
      start = i + 1;
    }
    pending.append(b + start, (size_t)got - start);
  }
  if (!pending.empty()) return emit(pending.data(), pending.size());
  return true;
}

static bool ends_with(const std::string& s, const char* suf) {
  const size_t n = strlen(suf);
  return s.size() >= n && memcmp(s.data() + s.size() - n, suf, n) == 0;
}

// sra_accession codec (accession.py twin; 0 = parse failure).
static uint64_t acc_parse(const char* p, size_t n) {
  int nl = 0, nd = 0;
  unsigned long long data = 0;
  for (size_t i = 0; i < n; ++i) {
    char c = p[i];
    if (c >= 'a' && c <= 'z') c -= 32;
    if (c >= 'A' && c <= 'Z') {
      ++nl;
      data = data * 26 + (unsigned)(c - 'A');
    } else if (c >= '0' && c <= '9') {
      ++nd;
      data = data * 10 + (unsigned)(c - '0');
    }
  }
  if (nl != 3 || nd == 0 || nd > 10) return 0;
  return ((uint64_t)(nd - 1) | (data << 4));
}

// Date.parse twin: "YYYY-MM-DD" prefix; false on malformed.
static bool date_parse(const char* p, size_t n, uint32_t* d, uint32_t* m,
                       uint32_t* y) {
  if (n < 10 || p[4] != '-' || p[7] != '-') return false;
  auto dig = [&](int a, int b, uint32_t* out) {
    uint32_t v = 0;
    for (int i = a; i < b; ++i) {
      if (p[i] < '0' || p[i] > '9') return false;
      v = v * 10 + (uint32_t)(p[i] - '0');
    }
    *out = v;
    return true;
  };
  return dig(0, 4, y) && dig(5, 7, m) && dig(8, 10, d);
}

static bool u64_parse(const char* p, size_t n, uint64_t* out) {
  if (n == 0) return false;
  uint64_t v = 0;
  for (size_t i = 0; i < n; ++i) {
    if (p[i] < '0' || p[i] > '9') return false;
    v = v * 10 + (uint64_t)(p[i] - '0');
  }
  *out = v;
  return true;
}

// parse_xml_value twin: <KEY>value</KEY> via find + RFIND.
static bool xml_value(const std::string& line, const char* key,
                      std::string* out) {
  std::string open = std::string("<") + key + ">";
  std::string close = std::string("</") + key + ">";
  const size_t b = line.find(open);
  if (b == std::string::npos) return false;
  const size_t begin = b + open.size();
  const size_t end = line.rfind(close);
  if (end == std::string::npos || begin > end) return false;
  out->assign(line, begin, end - begin);
  return true;
}

// parse_key_value twin: key="value" (marker find + skip one char).
static bool key_value(const std::string& line, const char* key,
                      std::string* out) {
  std::string marker = std::string(key) + "=";
  size_t loc = line.find(marker);
  if (loc == std::string::npos) return false;
  loc += marker.size() + 1;  // skip the opening quote
  const size_t end = line.find('"', loc);
  if (end == std::string::npos) return false;
  out->assign(line, loc, end - loc);
  return true;
}

struct Builder {
  std::vector<Rec> db;
  std::unordered_map<uint64_t, std::vector<uint32_t>> by_exp, by_samp,
      by_study;
  std::unordered_map<uint64_t, OrderedMap> sample_attrs;
  std::unordered_map<uint64_t, Xml> xml;
  Err err;

  bool parse_tab(const char* tar_path) {
    TarReader tr;
    if (!tr.open(tar_path)) return err.fail(-1, "cannot open metadata file");
    std::vector<std::pair<size_t, size_t>> cols;  // (offset, len) per field
    bool header_done = false;  // one header row across ALL matching members
    // Column indexes resolved from the header row.
    int iAcc = -1, iStatus = -1, iUpdated = -1, iPublished = -1,
        iReceived = -1, iType = -1, iVis = -1, iExp = -1, iSamp = -1,
        iStudy = -1, iCenter = -1, iSpots = -1, iBases = -1;
    size_t ncol = 0;
    while (tr.next(&err)) {
      if (!ends_with(tr.name, "SRA_Accessions")) continue;
      const bool ok = for_each_line(tr, &err, [&](const char* p, size_t n) {
        cols.clear();
        size_t start = 0;
        for (size_t i = 0; i <= n; ++i) {
          if (i == n || p[i] == '\t') {
            cols.emplace_back(start, i - start);
            start = i + 1;
          }
        }
        if (!header_done) {
          header_done = true;
          ncol = cols.size();
          for (size_t c = 0; c < ncol; ++c) {
            const std::string name(p + cols[c].first, cols[c].second);
            if (name == "Accession") iAcc = (int)c;
            else if (name == "Status") iStatus = (int)c;
            else if (name == "Updated") iUpdated = (int)c;
            else if (name == "Published") iPublished = (int)c;
            else if (name == "Received") iReceived = (int)c;
            else if (name == "Type") iType = (int)c;
            else if (name == "Visibility") iVis = (int)c;
            else if (name == "Experiment") iExp = (int)c;
            else if (name == "Sample") iSamp = (int)c;
            else if (name == "Study") iStudy = (int)c;
            else if (name == "Center") iCenter = (int)c;
            else if (name == "Spots") iSpots = (int)c;
            else if (name == "Bases") iBases = (int)c;
          }
          if (iAcc < 0 || iStatus < 0 || iUpdated < 0 || iPublished < 0 ||
              iReceived < 0 || iType < 0 || iVis < 0 || iExp < 0 ||
              iSamp < 0 || iStudy < 0 || iCenter < 0 || iSpots < 0 ||
              iBases < 0) {
            return err.fail(-2,
                            "missing required column in SRA Accessions file");
          }
          return true;
        }
        if (cols.size() != ncol) {
          return err.fail(-2, "unexpected column count in SRA Accessions file");
        }
        auto field = [&](int c) {
          return std::make_pair(p + cols[c].first, cols[c].second);
        };
        auto eq = [&](int c, const char* s) {
          const auto f = field(c);
          return f.second == strlen(s) && memcmp(f.first, s, f.second) == 0;
        };
        if (!eq(iType, "RUN")) return true;
        if (eq(iStatus, "suppressed") || eq(iStatus, "controlled_access") ||
            eq(iStatus, "unpublished")) {
          return true;
        }
        if (eq(iVis, "suppressed") || eq(iVis, "controlled_access")) {
          return true;
        }
        Rec r;
        auto acc_field = [&](int c, uint64_t* out) {
          const auto f = field(c);
          const uint64_t v = acc_parse(f.first, f.second);
          if (v == 0) {
            return err.fail(-2, "unable to parse accession string " +
                                    std::string(f.first, f.second));
          }
          *out = v;
          return true;
        };
        if (!acc_field(iAcc, &r.run)) return false;
        if (!eq(iSpots, "-")) {
          const auto f = field(iSpots);
          if (!u64_parse(f.first, f.second, &r.spots)) {
            return err.fail(-2, "unable to parse spot count");
          }
        }
        if (!eq(iBases, "-")) {
          const auto f = field(iBases);
          if (!u64_parse(f.first, f.second, &r.bases)) {
            return err.fail(-2, "unable to parse base count");
          }
        }
        {
          const auto f = field(iReceived);
          if (!date_parse(f.first, f.second, &r.dd, &r.dm, &r.dy)) {
            return err.fail(-2, "malformed date string " +
                                    std::string(f.first, f.second));
          }
        }
        if (!eq(iExp, "-") && !acc_field(iExp, &r.exp)) return false;
        if (!eq(iSamp, "-") && !eq(iSamp, "Multiplex") &&
            !acc_field(iSamp, &r.samp)) {
          return false;
        }
        if (!eq(iStudy, "-") && !acc_field(iStudy, &r.study)) return false;
        if (!eq(iCenter, "-")) {
          const auto f = field(iCenter);
          r.attrs.set("Center", std::string(f.first, f.second));
        }
        db.push_back(std::move(r));
        return true;
      });
      if (!ok) return false;
    }
    if (err.code) return false;
    if (!header_done) {
      return err.fail(-2, "no SRA_Accessions table found in metadata archive");
    }
    for (uint32_t i = 0; i < db.size(); ++i) {
      if (db[i].exp) by_exp[db[i].exp].push_back(i);
      if (db[i].samp) by_samp[db[i].samp].push_back(i);
      if (db[i].study) by_study[db[i].study].push_back(i);
    }
    return true;
  }

  // Fold accumulated XML annotations into the run records (_merge_xml
  // twin; per-entry application is order-independent and equivalent).
  void merge() {
    for (auto& kv : xml) {
      const uint64_t acc = kv.first;
      Xml& x = kv.second;
      auto e = by_exp.find(acc);
      if (e != by_exp.end()) {
        for (const uint32_t i : e->second) {
          Rec& r = db[i];
          if (x.invalid && r.valid) r.valid = false;
          if (!x.exp_title.empty()) r.exp_title = x.exp_title;
          if (!x.lib_name.empty()) r.lib_name = x.lib_name;
          if (!x.lib_strategy.empty()) r.lib_strategy = x.lib_strategy;
          if (!x.lib_source.empty()) r.lib_source = x.lib_source;
          if (!x.lib_selection.empty()) r.lib_selection = x.lib_selection;
          if (!x.instrument.empty()) r.instrument = x.instrument;
        }
      }
      auto s = by_samp.find(acc);
      if (s != by_samp.end()) {
        for (const uint32_t i : s->second) {
          if (!x.taxa.empty()) db[i].taxa = x.taxa;
        }
        if (!x.attrs.empty()) sample_attrs[acc].update(x.attrs);
      }
      auto t = by_study.find(acc);
      if (t != by_study.end()) {
        for (const uint32_t i : t->second) {
          if (!x.study_title.empty()) db[i].study_title = x.study_title;
          if (!x.study_abstract.empty()) {
            db[i].study_abstract = x.study_abstract;
          }
        }
      }
    }
    xml.clear();
  }

  Xml& entry(uint64_t acc) { return xml[acc]; }

  bool parse_xml(const char* tar_path) {
    TarReader tr;
    if (!tr.open(tar_path)) return err.fail(-1, "cannot open metadata file");
    std::string line, val, tmp;
    while (tr.next(&err)) {
      int ftype;  // 0 experiment, 1 sample, 2 study
      if (ends_with(tr.name, ".experiment.xml")) ftype = 0;
      else if (ends_with(tr.name, ".sample.xml")) ftype = 1;
      else if (ends_with(tr.name, ".study.xml")) ftype = 2;
      else continue;
      if (xml.size() >= kMaxNumXml) merge();
      uint64_t experiment = 0, sample = 0, study = 0;
      bool in_attr = false;
      std::string attr_tag;
      const bool ok = for_each_line(tr, &err, [&](const char* p, size_t n) {
        line.assign(p, n);
        if (ftype == 0) {
          if (line.find("<EXPERIMENT ") != std::string::npos) {
            if (!key_value(line, "accession", &val) ||
                (experiment = acc_parse(val.data(), val.size())) == 0) {
              return err.fail(-2, "unable to parse experiment accession");
            }
          }
          static const struct { const char* tag; std::string Xml::*var; }
              kTags[] = {
                  {"TITLE", &Xml::exp_title},
                  // parsed with the twin's error checks but never merged
                  // into run records (matching _merge_xml's variable list)
                  {"DESIGN_DESCRIPTION", &Xml::exp_design},
                  {"LIBRARY_NAME", &Xml::lib_name},
                  {"LIBRARY_STRATEGY", &Xml::lib_strategy},
                  {"LIBRARY_SOURCE", &Xml::lib_source},
                  {"LIBRARY_SELECTION", &Xml::lib_selection},
                  {"INSTRUMENT_MODEL", &Xml::instrument},
              };
          for (const auto& t : kTags) {
            tmp = std::string("<") + t.tag + ">";
            if (line.find(tmp) == std::string::npos) continue;
            if (experiment == 0) return err.fail(-2, "orphaned experiment tag");
            if (!xml_value(line, t.tag, &val)) {
              return err.fail(-2, "malformed experiment tag line");
            }
            entry(experiment).*(t.var) = val;
          }
          if (line.find("<EXTERNAL_ID namespace=\"dbgap\">") !=
              std::string::npos) {
            if (experiment == 0) return err.fail(-2, "orphaned dbgap id");
            entry(experiment).invalid = true;
          }
        } else if (ftype == 1) {
          if (line.find("<SAMPLE ") != std::string::npos) {
            if (!key_value(line, "accession", &val) ||
                (sample = acc_parse(val.data(), val.size())) == 0) {
              return err.fail(-2, "unable to parse sample accession");
            }
          }
          if (line.find("<SCIENTIFIC_NAME>") != std::string::npos) {
            if (sample == 0) return err.fail(-2, "orphaned scientific name");
            if (!xml_value(line, "SCIENTIFIC_NAME", &val)) {
              return err.fail(-2, "malformed SCIENTIFIC_NAME line");
            }
            entry(sample).taxa = val;
          }
          if (line.find("<SAMPLE_ATTRIBUTE>") != std::string::npos) {
            in_attr = true;
          }
          if (line.find("</SAMPLE_ATTRIBUTE>") != std::string::npos) {
            in_attr = false;
          }
          if (in_attr && line.find("<TAG>") != std::string::npos) {
            if (!xml_value(line, "TAG", &attr_tag)) {
              return err.fail(-2, "malformed TAG line");
            }
          }
          if (in_attr && line.find("<VALUE>") != std::string::npos) {
            if (!xml_value(line, "VALUE", &val)) {
              return err.fail(-2, "malformed VALUE line");
            }
            if (attr_tag.empty() && sample == 0) {
              return err.fail(-2, "orphaned sample attribute value");
            }
            if (attr_tag != "BioSampleModel") {
              entry(sample).attrs.set(attr_tag, val);
            }
          }
        } else {
          if (line.find("<STUDY ") != std::string::npos) {
            if (!key_value(line, "accession", &val) ||
                (study = acc_parse(val.data(), val.size())) == 0) {
              return err.fail(-2, "unable to parse study accession");
            }
          }
          if (line.find("<STUDY_TITLE>") != std::string::npos) {
            if (study == 0) return err.fail(-2, "orphaned study title");
            if (!xml_value(line, "STUDY_TITLE", &val)) {
              return err.fail(-2, "malformed STUDY_TITLE line");
            }
            entry(study).study_title = val;
          }
          if (line.find("<STUDY_ABSTRACT>") != std::string::npos) {
            if (study == 0) return err.fail(-2, "orphaned study abstract");
            if (!xml_value(line, "STUDY_ABSTRACT", &val)) {
              return err.fail(-2, "malformed STUDY_ABSTRACT line");
            }
            entry(study).study_abstract = val;
          }
        }
        return true;
      });
      if (!ok) return false;
    }
    if (err.code) return false;
    merge();
    return true;
  }
};

// Buffered little-endian writer for the binary inventory codec.
struct InvWriter {
  FILE* f;
  std::string buf;
  bool ok = true;
  explicit InvWriter(FILE* fp) : f(fp) { buf.reserve(1 << 20); }
  void flush() {
    if (!buf.empty() && fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
      ok = false;  // short write (ENOSPC/EIO): surfaced as -6
    }
    buf.clear();
  }
  void maybe_flush() {
    if (buf.size() >= (1 << 20)) flush();
  }
  void u32(uint32_t v) { buf.append(reinterpret_cast<char*>(&v), 4); }
  void u64(uint64_t v) { buf.append(reinterpret_cast<char*>(&v), 8); }
  void str(const std::string& s) {
    buf.append(s);
    buf.push_back('\0');
  }
  void rec(const Rec& r, const OrderedMap& attrs) {
    u64(r.run);
    u64(r.exp);
    str(r.exp_title);
    str(r.exp_design);
    str(r.lib_name);
    str(r.lib_strategy);
    str(r.lib_source);
    str(r.lib_selection);
    str(r.instrument);
    u64(r.samp);
    str(r.taxa);
    u64(attrs.items.size());
    for (const auto& kv : attrs.items) {
      str(kv.first);
      str(kv.second);
    }
    u64(r.study);
    str(r.study_title);
    str(r.study_abstract);
    u64(r.spots);
    u64(r.bases);
    u32(r.dd);
    u32(r.dm);
    u32(r.dy);
    maybe_flush();
  }
};

}  // namespace kninv

extern "C" {

// Build the binary inventory natively. strategies / sources are
// '\n'-joined required sets (empty string = no filter); include is a
// sorted run-accession allowlist (n_include == 0 = no filter); the two
// (day, month, year) triples bound date_received. Returns the record
// count written, or a negative code (-1 input open, -2 parse, -3 read,
// -5 output open, -6 write failure) with a message in err
// (NUL-terminated, truncated to err_cap).
// Transpose a packed bit matrix (the .db build's filters -> bit-slices
// step, build_db.cpp:280-362): src is [num_filter rows x nbytes cols]
// (8*nbytes bits per filter, LSB-first within each byte); dst is
// [8*nbytes rows x dst_stride cols] with bit f%8 of dst[bit][f/8] =
// bit (8j+b) of filter f. Delta-swap 8x8 bit-block transpose
// (Hacker's Delight 7-3) with a source-byte tile sized so the output
// working set stays cache-resident; tail columns of each dst row
// (past ceil(num_filter/8)) are zero-filled.
void kn_transpose_bits(const uint8_t* src, uint64_t num_filter,
                       uint64_t nbytes, uint8_t* dst, uint64_t dst_stride) {
  const uint64_t fb_total = (num_filter + 7) / 8;
  if (dst_stride > fb_total) {
    // Zero the padding columns once (rows x [fb_total, dst_stride)).
    for (uint64_t r = 0; r < 8 * nbytes; ++r) {
      memset(dst + r * dst_stride + fb_total, 0, dst_stride - fb_total);
    }
  }
  // 64x64-bit blocks: one unaligned u64 load per source row octet, an
  // in-register transpose (Hacker's Delight fig. 7-6), one u64 store
  // per output row. Power-of-2 dst strides (2048-filter files -> 256 B)
  // alias cache sets badly under byte-granular scatter; u64 stores cut
  // the store count 8x and the j-tile keeps the touched dst window
  // (8*tile rows x stride) L2-resident across the filter sweep.
  const uint64_t nf64 = (num_filter + 63) / 64;
  uint64_t tile = (128 * 1024) / (8 * (dst_stride ? dst_stride : 1));
  tile &= ~(uint64_t)7;  // whole 8-byte block columns
  if (tile < 8) tile = 8;
  uint64_t a[64];
  for (uint64_t j0 = 0; j0 < nbytes; j0 += tile) {
    const uint64_t j1 = j0 + tile < nbytes ? j0 + tile : nbytes;
    for (uint64_t g = 0; g < nf64; ++g) {
      const uint64_t f0 = g * 64;
      const uint64_t nrow =
          num_filter - f0 < 64 ? num_filter - f0 : 64;
      const uint64_t col = f0 / 8;                 // dst byte column
      const uint64_t cbytes =                      // writable dst bytes
          fb_total - col < 8 ? fb_total - col : 8;
      for (uint64_t j8 = j0; j8 < j1; j8 += 8) {
        const uint64_t jb = nbytes - j8 < 8 ? nbytes - j8 : 8;
        for (uint64_t k = 0; k < nrow; ++k) {
          uint64_t v = 0;
          memcpy(&v, src + (f0 + k) * nbytes + j8, jb);
          a[k] = v;
        }
        for (uint64_t k = nrow; k < 64; ++k) a[k] = 0;
        // In-place 64x64 bit transpose, LSB-first columns: bit b of a[k]
        // <-> bit k of a[b] (delta-swap network mirrored from Hacker's
        // Delight fig. 7-6, whose original form anti-transposes under
        // LSB-first indexing).
        uint64_t m = 0x00000000FFFFFFFFULL;
        for (unsigned s = 32; s != 0; s >>= 1, m ^= m << s) {
          for (unsigned k = 0; k < 64; k = (k + s + 1) & ~s) {
            const uint64_t t = ((a[k] >> s) ^ a[k | s]) & m;
            a[k | s] ^= t;
            a[k] ^= (t << s);
          }
        }
        uint8_t* o = dst + (uint64_t)8 * j8 * dst_stride + col;
        const uint64_t nb = 8 * jb;                // valid output rows
        if (cbytes == 8) {
          for (uint64_t b = 0; b < nb; ++b) {
            memcpy(o + b * dst_stride, &a[b], 8);
          }
        } else {
          for (uint64_t b = 0; b < nb; ++b) {
            memcpy(o + b * dst_stride, &a[b], cbytes);
          }
        }
      }
    }
  }
}

int64_t kn_build_inventory(const char* tar_path, const char* out_path,
                           const char* strategies, const char* sources,
                           const uint64_t* include, uint64_t n_include,
                           uint32_t bd, uint32_t bm, uint32_t by,
                           uint32_t ed, uint32_t em, uint32_t ey,
                           uint64_t* out_injected, char* err,
                           uint64_t err_cap) {
  using namespace kninv;
  auto split_set = [](const char* joined) {
    std::vector<std::string> out;
    const char* p = joined;
    while (p && *p) {
      const char* nl = strchr(p, '\n');
      if (!nl) {
        out.emplace_back(p);
        break;
      }
      out.emplace_back(p, nl - p);
      p = nl + 1;
    }
    return out;
  };
  Builder b;
  const bool ok = b.parse_tab(tar_path) && b.parse_xml(tar_path);
  if (!ok) {
    if (err && err_cap) {
      snprintf(err, err_cap, "%s", b.err.msg.c_str());
    }
    return b.err.code ? b.err.code : -2;
  }
  const auto strat = split_set(strategies);
  const auto src = split_set(sources);
  auto in_set = [&](const std::vector<std::string>& set,
                    const std::string& v) {
    for (const auto& s : set) {
      if (s == v) return true;
    }
    return false;
  };
  auto date_lt = [](uint32_t ad, uint32_t am, uint32_t ay, uint32_t bd2,
                    uint32_t bm2, uint32_t by2) {
    if (ay != by2) return ay < by2;
    if (am != bm2) return am < bm2;
    return ad < bd2;
  };
  for (auto& r : b.db) {
    if (!src.empty() && !in_set(src, r.lib_source)) r.valid = false;
    if (!strat.empty() && !in_set(strat, r.lib_strategy)) r.valid = false;
    if (date_lt(r.dd, r.dm, r.dy, bd, bm, by) ||
        date_lt(ed, em, ey, r.dd, r.dm, r.dy)) {
      r.valid = false;
    }
  }
  if (n_include) {
    std::unordered_map<uint64_t, bool> inc;
    for (uint64_t i = 0; i < n_include; ++i) inc[include[i]] = true;
    for (auto& r : b.db) {
      if (!inc.count(r.run)) r.valid = false;
    }
  }
  std::vector<uint32_t> order;
  order.reserve(b.db.size());
  for (uint32_t i = 0; i < b.db.size(); ++i) {
    if (b.db[i].valid) order.push_back(i);
  }
  std::stable_sort(order.begin(), order.end(), [&](uint32_t a, uint32_t c) {
    return b.db[a].bases < b.db[c].bases;
  });
  FILE* f = fopen(out_path, "wb");
  if (!f) {
    if (err && err_cap) snprintf(err, err_cap, "cannot open output file");
    return -5;
  }
  InvWriter w(f);
  w.u64(order.size());
  uint64_t injected = 0;
  OrderedMap merged;
  for (const uint32_t i : order) {
    Rec& r = b.db[i];
    const auto sa = b.sample_attrs.find(r.samp);
    if (sa != b.sample_attrs.end() && !sa->second.empty()) {
      merged = r.attrs;
      merged.update(sa->second);
      ++injected;
      w.rec(r, merged);
    } else {
      w.rec(r, r.attrs);
    }
  }
  w.flush();
  const bool closed_ok = fclose(f) == 0;
  if (!w.ok || !closed_ok) {
    if (err && err_cap) snprintf(err, err_cap, "inventory write failed");
    return -6;
  }
  if (out_injected) *out_injected = injected;
  return (int64_t)order.size();
}

}  // extern "C"

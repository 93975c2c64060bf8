"""K-mer counting, exact-count thresholding and filter bits on the device
(PyTorch + CUDA port of kwage_tpu/ops/counting.py).

The JAX module's pipeline, on int64 k-mer words (``ops.kmers``):

  1. canonical k-mers of a read batch (the canonical_kmers kernel);
  2. a sort by (accession, word) that makes equal pairs adjacent (the
     radix_sort_pairs kernels);
  3. the select_runs kernel: a position is selected when it starts a run
     of at least min_count equal pairs, and each accession's count of
     selected words is summed with integer atomics;
  4. the bloom_set_bits kernel: murmur each selected word and atomicOr
     its bits straight into the packed filter images.

The sort orders int64 (accession, word) pairs by accession, then by word,
both as signed values; invalid windows carry accession num_acc, so they
sink to the end. The JAX package leaves it to XLA's ``jax.lax.sort``; on a
CUDA tensor the port runs its own least-significant-digit radix sort
(``csrc/sort.cu``: 8-bit digits, a histogram, a scan and a stable scatter a
digit, over the bytes of the word that k can fill and the bytes of the
accession that num_acc can fill). Equal pairs cannot be told apart, so its
output equals that of the plain version, ``sort_windows_ref`` (the
library's stable sort, twice; CPU tensors and the comparisons), bit for
bit. At k = 32 the word fills all 64 bits and orders as a signed value,
which both versions do alike.

Exactness: the counts are TRUE counts (see the JAX module's docstring);
integer atomics and atomicOr are order-free, so every result is the same
bits on every run.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .hashing import murmur32_ref
from .kmers import canonical_kmers_packed, pack_to_device


# --- the sort -------------------------------------------------------------------

SORT_TILE = 4096   # pairs a block of csrc/sort.cu takes (kTile)


def sort_windows_ref(acc: torch.Tensor, words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain sort of int64 (acc, word) pairs by (acc, word), signed: two
    stable passes, by word, then by accession. Returns (acc_s, words_s)."""
    words_s, order = torch.sort(words, stable=True)
    acc_s, order2 = torch.sort(acc[order], stable=True)
    return acc_s, words_s[order2]


def sort_digits(k: int | None, num_acc: int | None) -> tuple[int, int]:
    """(word bytes, accession bytes) that can differ between two pairs: a
    k-mer word fills 2k bits, an accession in [0, num_acc] the bits of
    num_acc. None: all 8 bytes (any int64, the sign included)."""
    word_digits = 8 if k is None else -(-2 * k // 8)
    acc_digits = 8 if num_acc is None else -(-int(num_acc).bit_length() // 8)
    return word_digits, acc_digits


def sort_windows(acc: torch.Tensor, words: torch.Tensor, k: int | None = None,
                 num_acc: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 (acc, word) pairs [n] ordered by (acc, word), both signed:
    (acc_s, words_s). ``k``: the words are k-mer words, 0 <= word < 4^k
    (k = 32: any int64); ``num_acc``: 0 <= acc <= num_acc. They tell the
    radix sort which bytes can differ; the caller answers for them (a
    pair outside them is ordered by its low bytes alone). CUDA tensors:
    the radix_sort_pairs kernels, which take 32 bytes of scratch a pair
    (two ping-pong buffers; one when a single byte differs) beside the 16
    of the result; CPU tensors: sort_windows_ref."""
    if acc.dtype != torch.int64 or words.dtype != torch.int64 or acc.shape != words.shape \
            or acc.dim() != 1:
        raise ValueError("expected int64 acc and words of one shape [n]")
    if (k is not None and not 1 <= k <= 32) or (num_acc is not None and num_acc < 0):
        raise ValueError(f"bad k={k} or num_acc={num_acc}")
    if acc.device != words.device:
        raise ValueError("acc and words must share a device")
    if acc.device.type == "cpu":
        return sort_windows_ref(acc, words)
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    n = acc.shape[0]
    if n >= 1 << 32:
        raise ValueError(f"radix_sort_pairs takes n < 2^32 pairs, not {n}")
    word_digits, acc_digits = sort_digits(k, num_acc)
    if n <= 1 or word_digits + acc_digits == 0:
        return acc.clone(), words.clone()
    acc, words = acc.contiguous(), words.contiguous()
    passes = word_digits + acc_digits
    # Pass p writes pair p & 1; the last pass's pair is the result.
    pairs = [(torch.empty_like(acc), torch.empty_like(words)) for _ in range(min(passes, 2))]
    if passes == 1:
        pairs.append(pairs[0])
    hist = torch.empty(256 * -(-n // SORT_TILE), dtype=torch.int32, device=acc.device)
    totals = torch.empty(256, dtype=torch.int32, device=acc.device)
    with torch.cuda.device(acc.device):
        kernels.launch("radix_sort_pairs", acc.data_ptr(), words.data_ptr(),
                       pairs[0][0].data_ptr(), pairs[0][1].data_ptr(),
                       pairs[1][0].data_ptr(), pairs[1][1].data_ptr(),
                       hist.data_ptr(), totals.data_ptr(), n, word_digits, acc_digits,
                       torch.cuda.current_stream(acc.device).cuda_stream)
    return pairs[(passes - 1) & 1]


# --- select_runs ----------------------------------------------------------------

def select_runs_ref(acc_s: torch.Tensor, words_s: torch.Tensor, num_acc: int,
                    min_count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain select_runs: (selected bool [n], num_valid int32 [num_acc])."""
    n = acc_s.shape[0]
    valid = (acc_s >= 0) & (acc_s < num_acc)
    new = torch.ones(n, dtype=torch.bool, device=acc_s.device)
    if n > 1:
        new[1:] = (acc_s[1:] != acc_s[:-1]) | (words_s[1:] != words_s[:-1])
    selected = valid & new
    m = min_count - 1
    if m:
        ahead = torch.zeros(n, dtype=torch.bool, device=acc_s.device)
        if n > m:
            ahead[: n - m] = (acc_s[m:] == acc_s[:-m]) & (words_s[m:] == words_s[:-m])
        selected &= ahead
    num_valid = torch.bincount(acc_s[selected], minlength=num_acc)[:num_acc]
    return selected, num_valid.to(torch.int32)


def select_runs(acc_s: torch.Tensor, words_s: torch.Tensor, num_acc: int,
                min_count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted int64 (acc_s, words_s) [n] -> (selected bool [n]: first
    position of a run of >= min_count equal valid pairs; num_valid int32
    [num_acc]: selected positions per accession). A pair is valid when
    0 <= acc < num_acc. CUDA tensors: the select_runs kernel; CPU tensors:
    select_runs_ref."""
    if acc_s.dtype != torch.int64 or words_s.dtype != torch.int64 or acc_s.shape != words_s.shape:
        raise ValueError("expected int64 acc_s and words_s of one shape")
    if num_acc < 1 or min_count < 1:
        raise ValueError(f"need num_acc >= 1 and min_count >= 1 ({num_acc}, {min_count})")
    if acc_s.device != words_s.device:
        raise ValueError("acc_s and words_s must share a device")
    if acc_s.device.type == "cpu":
        return select_runs_ref(acc_s, words_s, num_acc, min_count)
    if acc_s.device.type != "cuda":
        raise ValueError(f"unsupported device {acc_s.device}")
    acc_s, words_s = acc_s.contiguous(), words_s.contiguous()
    selected = torch.empty(acc_s.shape, dtype=torch.bool, device=acc_s.device)
    num_valid = torch.zeros(num_acc, dtype=torch.int32, device=acc_s.device)
    if acc_s.numel():
        with torch.cuda.device(acc_s.device):
            kernels.launch("select_runs", acc_s.data_ptr(), words_s.data_ptr(),
                           selected.data_ptr(), num_valid.data_ptr(), acc_s.shape[0],
                           num_acc, min_count,
                           torch.cuda.current_stream(acc_s.device).cuda_stream)
    return selected, num_valid


# --- bloom_set_bits -------------------------------------------------------------

def words_per_filter(log2_filter_len: int) -> int:
    return max(1, (1 << log2_filter_len) // 32)


def bloom_set_bits_ref(acc_s, words_s, selected, slot_of_acc, k: int, num_hash: int,
                       log2_filter_len: int) -> torch.Tensor:
    """Plain bloom_set_bits: the distinct flat bit indices, then an
    index_add_ of 1 << (i & 31) into int32 words. The bits are distinct,
    so the sum equals the OR (bit 31 included, in wrapping int32)."""
    num_acc = slot_of_acc.shape[0] - 1
    wps = words_per_filter(log2_filter_len)
    out = torch.zeros(num_acc * wps, dtype=torch.int32, device=acc_s.device)
    slot = slot_of_acc[torch.where((acc_s < 0) | (acc_s > num_acc), num_acc, acc_s)].long()
    keep = selected & (slot >= 0)
    if bool(keep.any()):
        h = murmur32_ref(words_s[keep], k, num_hash).long() & 0xFFFFFFFF
        bits = h & ((1 << log2_filter_len) - 1)
        flat = torch.unique((slot[keep][:, None] * (wps * 32) + bits).reshape(-1))
        one = torch.ones(flat.shape, dtype=torch.int32, device=flat.device)
        out.index_add_(0, flat >> 5, one << (flat & 31).int())
    return out.reshape(num_acc, wps)


def bloom_set_bits(acc_s: torch.Tensor, words_s: torch.Tensor, selected: torch.Tensor,
                   slot_of_acc: torch.Tensor, k: int, num_hash: int,
                   log2_filter_len: int) -> torch.Tensor:
    """Packed filter images int32 [num_acc, max(1, 2^L/32)] (num_acc =
    len(slot_of_acc) - 1): the nh murmur bits of every selected word,
    in row slot_of_acc[acc] (-1 drops it; slot_of_acc[num_acc] absorbs
    invalid windows). Bit b of a filter is bit b & 31 of word b >> 5 (the
    .db little-endian layout). CUDA tensors: the bloom_set_bits kernel,
    into a zeroed image; CPU tensors: bloom_set_bits_ref."""
    num_acc = slot_of_acc.shape[0] - 1
    if (acc_s.dtype != torch.int64 or words_s.dtype != torch.int64
            or selected.dtype != torch.bool or slot_of_acc.dtype != torch.int32):
        raise ValueError("expected int64 acc_s/words_s, bool selected, int32 slot_of_acc")
    if not (acc_s.shape == words_s.shape == selected.shape) or num_acc < 1:
        raise ValueError("acc_s, words_s, selected must share one shape; slot_of_acc >= 2 entries")
    if not 0 <= log2_filter_len <= 32 or not 1 <= k <= 32 or num_hash < 1:
        raise ValueError(f"bad k={k}, num_hash={num_hash} or log2_filter_len={log2_filter_len}")
    if not (acc_s.device == words_s.device == selected.device == slot_of_acc.device):
        raise ValueError("all inputs must share a device")
    if int(slot_of_acc.max()) >= num_acc:
        raise IndexError(f"slot_of_acc holds a slot >= {num_acc}")
    if acc_s.device.type == "cpu":
        return bloom_set_bits_ref(acc_s, words_s, selected, slot_of_acc, k, num_hash,
                                  log2_filter_len)
    if acc_s.device.type != "cuda":
        raise ValueError(f"unsupported device {acc_s.device}")
    wps = words_per_filter(log2_filter_len)
    out = torch.zeros((num_acc, wps), dtype=torch.int32, device=acc_s.device)
    if acc_s.numel():
        with torch.cuda.device(acc_s.device):
            kernels.launch(
                "bloom_set_bits", acc_s.contiguous().data_ptr(), words_s.contiguous().data_ptr(),
                selected.contiguous().data_ptr(), slot_of_acc.contiguous().data_ptr(),
                out.data_ptr(), acc_s.shape[0], num_acc, k, num_hash, log2_filter_len, wps,
                torch.cuda.current_stream(acc_s.device).cuda_stream)
    return out


def set_filter_bits(words: torch.Tensor, selected: torch.Tensor, k: int, num_hash: int,
                    log2_filter_len: int) -> torch.Tensor:
    """One filter: packed words int32 [max(1, 2^L/32)] of the selected words."""
    acc = torch.zeros(words.shape, dtype=torch.int64, device=words.device)
    slot = torch.tensor([0, -1], dtype=torch.int32, device=words.device)
    return bloom_set_bits(acc, words, selected, slot, k, num_hash, log2_filter_len)[0]


def filter_words_to_bytes(words, log2_filter_len: int) -> np.ndarray:
    """Packed int32 filter words (tensor or array) -> the on-disk
    LSB-first bytes of one 2^L-bit filter (host)."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    data = np.ascontiguousarray(words).astype("<i4", copy=False).view(np.uint8)
    return data[: max(1, (1 << log2_filter_len) // 8)]


# --- counting -------------------------------------------------------------------

def count_multi_core(words: torch.Tensor, valid: torch.Tensor, acc_ids: torch.Tensor,
                     min_count: int, num_acc: int, k: int | None = None):
    """Windows [R, nwin] of reads [R] in accessions acc_ids -> (acc_s,
    words_s, selected, num_valid [num_acc]), all on the device. ``k``: the
    k-mer length the words were made with (None: any int64)."""
    acc = torch.where(valid, acc_ids.to(torch.int64)[:, None], num_acc)
    acc_s, words_s = sort_windows(acc.reshape(-1), words.reshape(-1), k, num_acc)
    selected, num_valid = select_runs(acc_s, words_s, num_acc, min_count)
    return acc_s, words_s, selected, num_valid


def count_kmers_multi_packed(packed: torch.Tensor, valid_words: torch.Tensor,
                             acc_ids: torch.Tensor, k: int, min_count: int, num_acc: int,
                             length: int):
    """Multi-accession fused count over 2-bit packed reads [R, ...] with
    accession slots acc_ids int32 [R] in [0, num_acc): one sort by
    (accession, word) segments every accession's windows. Returns device
    tensors (acc_s, words_s, selected, num_valid int32 [num_acc]); keep
    them on the device and feed bloom_set_bits."""
    words, valid = canonical_kmers_packed(packed, valid_words, k, length)
    return count_multi_core(words, valid, acc_ids, min_count, num_acc, k)


def count_kmers_multi(reads_ascii: np.ndarray, acc_ids: torch.Tensor, k: int,
                      min_count: int, num_acc: int):
    """count_kmers_multi_packed over an ASCII batch uint8 [R, L] (packed
    on the host, then uploaded to acc_ids' device)."""
    packed, valid_words = pack_to_device(reads_ascii, acc_ids.device)
    return count_kmers_multi_packed(packed, valid_words, acc_ids, k, min_count, num_acc,
                                    np.asarray(reads_ascii).shape[1])


def count_and_threshold(words: torch.Tensor, valid: torch.Tensor, min_count: int,
                        k: int | None = None):
    """Exact thresholding of one accession's windows: (words_s, selected,
    num_valid, num_windows). ``selected`` marks the first occurrence of
    each word whose count is >= min_count; num_windows counts the valid
    windows (duplicates included), which form the prefix of the sorted
    arrays. ``k``: the k-mer length of the words (None: any int64)."""
    zeros = torch.zeros(1, dtype=torch.int32, device=words.device)
    acc_s, words_s, selected, num_valid = count_multi_core(
        words.reshape(1, -1), valid.reshape(1, -1), zeros, min_count, 1, k)
    return words_s, selected, int(num_valid[0]), int(valid.sum())


def count_kmers(reads_ascii: np.ndarray, k: int, min_count: int, device: torch.device):
    """Fused phase 1 over a padded ASCII batch uint8 [R, L]: (words_s,
    selected, num_valid, num_windows)."""
    packed, valid_words = pack_to_device(reads_ascii, device)
    words, valid = canonical_kmers_packed(packed, valid_words, k,
                                          np.asarray(reads_ascii).shape[1])
    return count_and_threshold(words, valid, min_count, k)


def build_filter_device(reads_ascii: np.ndarray, k: int, min_count: int, num_hash: int,
                        log2_filter_len: int, device: torch.device) -> torch.Tensor:
    """One call: ASCII read batch -> packed filter words int32 on ``device``."""
    words_s, selected, _, _ = count_kmers(reads_ascii, k, min_count, device)
    return set_filter_bits(words_s, selected, k, num_hash, log2_filter_len)

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

An accession built in chunks (``pipeline.make_bloom.build_bloom_device``)
counts each chunk's sorted words with the run_counts kernel and merges the
distinct (word, count) runs into an accumulator on the card with the
merge_counts kernel (``csrc/merge.cu``), where the JAX package reads them
back and merges them in numpy.

The sort orders int64 (accession, word) pairs by accession, then by word,
both as signed values. Invalid windows carry accession num_acc; the count
keeps only the valid ones (``sort_valid_windows``), so what follows the
sort walks no padding. The JAX package leaves it to XLA's
``jax.lax.sort`` and sorts the invalid windows to the end; on a CUDA
tensor the port runs its own one-sweep least-significant-digit radix sort
(``csrc/sort.cu``: one read counts every pass's digits, then one kernel a
pass with a decoupled look-back and a staged scatter, over the bits of the
word that k can fill and of the accession that num_acc can fill, as
``sort_plan`` cuts them). Equal pairs cannot be told apart, so its output
equals that of the plain versions (``sort_windows_ref``: the library's
stable sort, twice; CPU tensors and the comparisons), bit for bit. At
k = 32 the word fills all 64 bits and orders as a signed value, which both
versions do alike.

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

SORT_TILE = 4096   # pairs a block of csrc/sort.cu takes a pass (kTile)
SORT_TOP_WIDTH = 10   # the widest top digit a plan merges (1024 bins)


def sort_windows_ref(acc: torch.Tensor, words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain sort of int64 (acc, word) pairs by (acc, word), signed: two
    stable passes, by word, then by accession. Returns (acc_s, words_s)."""
    words_s, order = torch.sort(words, stable=True)
    acc_s, order2 = torch.sort(acc[order], stable=True)
    return acc_s, words_s[order2]


def sort_valid_windows_ref(acc: torch.Tensor, words: torch.Tensor,
                           num_acc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain sort_valid_windows: the pairs with 0 <= acc < num_acc, by
    (acc, word)."""
    keep = (acc >= 0) & (acc < num_acc)
    return sort_windows_ref(acc[keep], words[keep])


def sort_plan(k: int | None, acc_bits: int) -> list[tuple[int, int]]:
    """The radix sort's digits, (shift, width) from bit 0 of the key acc:word:
    the word's 2k bits (k None: 64) below the accession's ``acc_bits``. Each
    digit is 8 bits but the top one, which takes up to SORT_TOP_WIDTH bits
    where that saves a pass: k = 31 and 4 accession bits are 7 digits of 8
    and one of 10. One pass a digit."""
    total = (64 if k is None else 2 * k) + acc_bits
    plan, shift = [], 0
    while shift < total:
        width = total - shift if total - shift <= SORT_TOP_WIDTH else 8
        plan.append((shift, width))
        shift += width
    return plan


def sort_acc_bytes(acc_bits: int) -> int:
    """Bytes an accession rides in between the passes: none for one
    accession, then uint8, uint16, else int64 (csrc/sort.cu acc_bytes_of)."""
    return 0 if acc_bits == 0 else 1 if acc_bits <= 8 else 2 if acc_bits <= 16 else 8


_ACC_DTYPES = {1: torch.uint8, 2: torch.int16, 8: torch.int64}


def _check_pairs(acc: torch.Tensor, words: torch.Tensor, k: int | None) -> None:
    if acc.dtype != torch.int64 or words.dtype != torch.int64 or acc.shape != words.shape \
            or acc.dim() != 1:
        raise ValueError("expected int64 acc and words of one shape [n]")
    if k is not None and not 1 <= k <= 32:
        raise ValueError(f"bad k={k}")
    if acc.device != words.device:
        raise ValueError("acc and words must share a device")
    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {acc.device}")
    if acc.shape[0] >= 1 << 32:
        raise ValueError(f"radix_sort_pairs takes n < 2^32 pairs, not {acc.shape[0]}")


def _radix_sort(acc: torch.Tensor, words: torch.Tensor, k: int | None, acc_bits: int,
                limit: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The radix_sort_pairs kernels over CUDA tensors: one histogram read
    of every pass's digits, then one kernel a pass (csrc/sort.cu). ``limit``
    > 0 keeps the pairs with 0 <= acc < limit (the kept count is copied to
    the host once); 0 keeps all."""
    n, device = acc.shape[0], acc.device
    acc, words = acc.contiguous(), words.contiguous()
    plan = sort_plan(k, acc_bits)
    passes = len(plan)
    widths = sum(w << (4 * p) for p, (_, w) in enumerate(plan))
    word_bits = 64 if k is None else 2 * k
    stream = torch.cuda.current_stream(device).cuda_stream
    hist = torch.empty(sum(1 << w for _, w in plan), dtype=torch.int32, device=device)
    kept = torch.empty(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        kernels.launch("radix_sort_hist", acc.data_ptr(), words.data_ptr(), hist.data_ptr(),
                       kept.data_ptr(), n, limit, word_bits, acc_bits, widths, passes, stream)
        n_kept = int(kept) if limit else n
        acc_out = (torch.zeros if acc_bits == 0 else torch.empty)(
            n_kept, dtype=torch.int64, device=device)
        words_a = torch.empty(n_kept, dtype=torch.int64, device=device)
        if n_kept == 0:
            return acc_out, words_a
        words_b = torch.empty_like(words_a) if passes > 1 else None
        ab = sort_acc_bytes(acc_bits)
        acc_a = torch.empty(n_kept, dtype=_ACC_DTYPES[ab], device=device) \
            if ab and passes > 1 else None
        acc_b = torch.empty_like(acc_a) if acc_a is not None and passes > 2 else None
        entries = max(-(-(n if p == 0 else n_kept) // SORT_TILE) << w
                      for p, (_, w) in enumerate(plan))
        lookback = torch.empty(entries, dtype=torch.int64, device=device)
        counters = torch.empty(16, dtype=torch.int32, device=device)
        ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        kernels.launch("radix_sort_pairs", acc.data_ptr(), words.data_ptr(), ptr(acc_a),
                       ptr(acc_b), words_a.data_ptr(), ptr(words_b), acc_out.data_ptr(),
                       hist.data_ptr(), lookback.data_ptr(), counters.data_ptr(), n, n_kept,
                       limit, word_bits, acc_bits, widths, passes, entries, stream)
    return acc_out, words_a


def sort_windows(acc: torch.Tensor, words: torch.Tensor, k: int | None = None,
                 num_acc: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 (acc, word) pairs [n] ordered by (acc, word), both signed:
    (acc_s, words_s), all n of them. ``k``: the words are k-mer words,
    0 <= word < 4^k (k = 32: any int64); ``num_acc``: 0 <= acc <= num_acc
    (None: any int64). They tell the radix sort which key bits can differ,
    and the accession rides in the bits of num_acc: the caller answers for
    them. CUDA tensors: the radix_sort_pairs kernels; CPU tensors:
    sort_windows_ref."""
    _check_pairs(acc, words, k)
    if num_acc is not None and num_acc < 0:
        raise ValueError(f"bad num_acc={num_acc}")
    if acc.device.type == "cpu":
        return sort_windows_ref(acc, words)
    if acc.shape[0] <= 1:
        return acc.clone(), words.clone()
    return _radix_sort(acc, words, k, 64 if num_acc is None else int(num_acc).bit_length(), 0)


def sort_valid_windows(acc: torch.Tensor, words: torch.Tensor, k: int | None,
                       num_acc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The valid windows, 0 <= acc < num_acc, of int64 (acc, word) pairs [n],
    ordered by (acc, word), both signed: (acc_s, words_s) of length n_valid,
    the valid prefix of what sort_windows returns. ``k`` as for
    sort_windows. CUDA tensors: the radix_sort_pairs kernels, which drop the
    other windows in their first read and copy n_valid to the host once;
    CPU tensors: sort_valid_windows_ref."""
    _check_pairs(acc, words, k)
    if num_acc < 1:
        raise ValueError(f"bad num_acc={num_acc}")
    if acc.device.type == "cpu":
        return sort_valid_windows_ref(acc, words, num_acc)
    if acc.shape[0] == 0:
        return acc.clone(), words.clone()
    return _radix_sort(acc, words, k, (int(num_acc) - 1).bit_length(), int(num_acc))


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
    LSB-first bytes of one 2^L-bit filter (host). A CUDA tensor comes back
    through a pinned buffer."""
    if isinstance(words, torch.Tensor):
        if words.is_cuda:
            host = torch.empty(words.shape, dtype=words.dtype, pin_memory=True)
            host.copy_(words)
            words = host
        words = words.numpy()
    data = np.ascontiguousarray(words).astype("<i4", copy=False).view(np.uint8)
    return data[: max(1, (1 << log2_filter_len) // 8)]


# --- run_counts and merge_counts ----------------------------------------------------

RUN_TILE = 4096            # positions a tile of csrc/merge.cu, both kernels
COUNT_CAP = 2**31 - 1      # the largest cap: counts are int32


def _check_cap(cap: int, min_count: int) -> None:
    if not 1 <= cap <= COUNT_CAP or not 0 <= min_count <= cap:
        raise ValueError(f"need 1 <= cap <= 2^31 - 1 and 0 <= min_count <= cap "
                         f"({cap}, {min_count})")


def run_counts_ref(words: torch.Tensor, weights: torch.Tensor | None = None,
                   cap: int = COUNT_CAP, min_count: int = 0):
    """Plain run_counts; entries from num on are zero."""
    n, device = words.shape[0], words.device
    words_out = torch.zeros(n, dtype=torch.int64, device=device)
    counts_out = torch.zeros(n, dtype=torch.int32, device=device)
    stats = torch.zeros(2, dtype=torch.int64, device=device)
    selected = torch.zeros(n, dtype=torch.bool, device=device) if min_count else None
    if n:
        start = torch.ones(n, dtype=torch.bool, device=device)
        start[1:] = words[1:] != words[:-1]
        run = torch.cumsum(start, 0) - 1
        num = int(run[-1]) + 1
        words_out[:num] = words[start]
        w = torch.ones(n, dtype=torch.int64, device=device) if weights is None \
            else weights.long()
        sums = torch.zeros(num, dtype=torch.int64, device=device).index_add_(0, run, w)
        counts_out[:num] = sums.clamp(max=cap).int()
        stats[0] = num
        if min_count:
            selected[:num] = counts_out[:num] >= min_count
            stats[1] = selected.sum()
    return words_out, counts_out, stats, selected


def run_counts(words: torch.Tensor, weights: torch.Tensor | None = None, cap: int = COUNT_CAP,
               min_count: int = 0):
    """Sorted int64 words [n] (equal words adjacent), optional int32 weights
    [n] (None: 1 each) -> (words_out int64 [n], counts int32 [n], stats
    int64 [2], selected bool [n] or None): the distinct words at 0 .. num-1
    with their summed weights, saturating at ``cap``; stats = (num, the
    number of them with count >= min_count), on the device; with min_count
    > 0, ``selected`` flags those. Entries from num on are unspecified.
    CUDA tensors: the run_counts kernel; CPU tensors: run_counts_ref."""
    if words.dtype != torch.int64 or words.dim() != 1:
        raise ValueError("expected int64 words [n]")
    if weights is not None and (weights.dtype != torch.int32 or weights.shape != words.shape
                                or weights.device != words.device):
        raise ValueError("weights must be int32 of the words' shape and device")
    _check_cap(cap, min_count)
    if words.device.type == "cpu":
        return run_counts_ref(words, weights, cap, min_count)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    n, device = words.shape[0], words.device
    words = words.contiguous()
    weights = None if weights is None else weights.contiguous()
    words_out = torch.empty(n, dtype=torch.int64, device=device)
    counts_out = torch.empty(n, dtype=torch.int32, device=device)
    stats = torch.empty(2, dtype=torch.int64, device=device)
    selected = torch.empty(n, dtype=torch.bool, device=device) if min_count else None
    with torch.cuda.device(device):
        scratch = torch.empty(kernels.scratch_words("run", n), dtype=torch.int64, device=device)
        kernels.launch("run_counts", words.data_ptr(),
                       0 if weights is None else weights.data_ptr(), words_out.data_ptr(),
                       counts_out.data_ptr(), 0 if selected is None else selected.data_ptr(),
                       stats.data_ptr(), scratch.data_ptr(), n, cap, min_count,
                       torch.cuda.current_stream(device).cuda_stream)
    return words_out, counts_out, stats, selected


def _check_runs(words: torch.Tensor, counts: torch.Tensor, device) -> None:
    if (words.dtype != torch.int64 or counts.dtype != torch.int32 or words.dim() != 1
            or words.shape != counts.shape):
        raise ValueError("expected int64 words and int32 counts of one shape [n]")
    if words.device != device or counts.device != device:
        raise ValueError("both runs must share a device")


def merge_counts_ref(words_a: torch.Tensor, counts_a: torch.Tensor, words_b: torch.Tensor,
                     counts_b: torch.Tensor, cap: int = COUNT_CAP, min_count: int = 0):
    """Plain merge_counts: a stable sort of the two runs joined, then
    run_counts_ref with the counts as weights."""
    words, order = torch.sort(torch.cat([words_a, words_b]), stable=True)
    return run_counts_ref(words, torch.cat([counts_a, counts_b])[order], cap, min_count)


def merge_counts(words_a: torch.Tensor, counts_a: torch.Tensor, words_b: torch.Tensor,
                 counts_b: torch.Tensor, cap: int = COUNT_CAP, min_count: int = 0):
    """Two runs of distinct (int64 word, int32 count) pairs, each sorted ->
    run_counts' outputs over their union [na + nb]: the distinct words,
    sorted, with the counts of a word in both runs added (saturating at
    ``cap``), stats, and with min_count > 0 the selected flags. CUDA
    tensors: the merge_counts kernel, which merges, adds and compacts in one
    pass (a partition kernel beside it); CPU tensors: merge_counts_ref."""
    device = words_a.device
    _check_runs(words_a, counts_a, device)
    _check_runs(words_b, counts_b, device)
    _check_cap(cap, min_count)
    if device.type == "cpu":
        return merge_counts_ref(words_a, counts_a, words_b, counts_b, cap, min_count)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    na, nb = words_a.shape[0], words_b.shape[0]
    words = torch.empty(na + nb, dtype=torch.int64, device=device)
    counts = torch.empty(na + nb, dtype=torch.int32, device=device)
    stats = torch.empty(2, dtype=torch.int64, device=device)
    selected = torch.empty(na + nb, dtype=torch.bool, device=device) if min_count else None
    with torch.cuda.device(device):
        scratch = torch.empty(kernels.scratch_words("merge", na, nb), dtype=torch.int64,
                              device=device)
        kernels.launch("merge_counts", words_a.contiguous().data_ptr(),
                       counts_a.contiguous().data_ptr(), words_b.contiguous().data_ptr(),
                       counts_b.contiguous().data_ptr(), words.data_ptr(), counts.data_ptr(),
                       0 if selected is None else selected.data_ptr(), stats.data_ptr(),
                       scratch.data_ptr(), na, nb, cap, min_count,
                       torch.cuda.current_stream(device).cuda_stream)
    return words, counts, stats, selected


# --- counting -------------------------------------------------------------------

def count_multi_core(words: torch.Tensor, valid: torch.Tensor, acc_ids: torch.Tensor,
                     min_count: int, num_acc: int, k: int | None = None):
    """Windows [R, nwin] of reads [R] in accessions acc_ids -> (acc_s,
    words_s, selected, num_valid [num_acc]), all on the device: the valid
    windows alone, sorted. ``k``: the k-mer length the words were made with
    (None: any int64)."""
    acc = torch.where(valid, acc_ids.to(torch.int64)[:, None], num_acc)
    acc_s, words_s = sort_valid_windows(acc.reshape(-1), words.reshape(-1), k, num_acc)
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
    windows (duplicates included), which are all the sorted arrays hold.
    ``k``: the k-mer length of the words (None: any int64)."""
    zeros = torch.zeros(1, dtype=torch.int32, device=words.device)
    acc_s, words_s, selected, num_valid = count_multi_core(
        words.reshape(1, -1), valid.reshape(1, -1), zeros, min_count, 1, k)
    return words_s, selected, int(num_valid[0]), words_s.shape[0]


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

"""Device batch path for SriRachA per-read search (PyTorch + CUDA port of
kwage_tpu/sriracha/device.py).

Reads are padded into [batch, L] uint8 blocks (L a power-of-two bucket of
at least 64 bases); the ``canonical_kmers`` kernel gives each window's
canonical word and validity, and the ``sriracha_counts`` kernel sorts and
dedups each read's valid words in shared memory and counts, for every
subject, the distinct words the subject holds. The scalar gates,
thresholding, perfect-match culling and ordering run on the host from
those integer counts, so the matches are the host engine's, bit for bit.

The two probes of the JAX package are kept, with its routing rule:

- the dense LUT (``subject_table`` kernel): uint32 [G, 4^k] with bit s
  of entry w set iff k-mer w is in subject 32g + s; one gather per
  distinct read word. Used when k <= ``table_k_limit`` (14 on a card,
  13 on the CPU, as the JAX package has 14 on a TPU and 13 elsewhere),
  a group holds more than ``KWAGE_SRIRACHA_HASH_MAX`` k-mers (default
  65536) and the groups' tables fit in half of the card's free memory;
- the bucketed hash table (``build_hash_group``, numpy): [2^m, 8]
  (key, mask) slots per group; one row per distinct read word.

K-mer words are int64 throughout (the JAX package's 32-bit and (hi, lo)
twins collapse); at k = 32 the sign bit is a word bit, and every order
here is unsigned. Each kernel wrapper runs its kernel on a CUDA tensor
and its plain PyTorch version (``*_ref``) on a CPU tensor.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from itertools import islice

import numpy as np
import torch

from .. import kernels
from ..ops.kmers import canonical_kmers, canonical_kmers_ascii_ref
from ..utils.runtime import resolve_device
from .engine import SearchMatch, SrirachaOptions, StreamStats

MAX_DEVICE_K = 32
BUCKET_CAP = 8              # candidate slots per hash row (the JAX _BUCKET_CAP)
MAX_SHARED_WORDS = 1 << 14  # csrc/sriracha.cu kMaxSharedWords: a row above it sorts in tiles
MAX_TABLE_K = 13            # 4^13 * 4 B = 256 MiB per group (CPU)
MAX_TABLE_K_CUDA = 14       # 1 GiB per group, as the JAX package allows on a TPU
GROUP = 32                  # subjects per table group (one uint32 mask)
_SIGN = -(1 << 63)


# --- host tables (numpy; the JAX module's twins, which import jax) -------------

def mix32(hi, lo):
    """32-bit avalanche mix of a (hi, lo) 64-bit word -> bucket hash, numpy
    uint32 (the JAX package's _mix32, line for line)."""
    u = np.uint32
    x = lo ^ (lo >> u(16))
    x = x * u(0x7FEB352D)
    x = x ^ (x >> u(15))
    x = x * u(0x846CA68B)
    x = x ^ (x >> u(16))
    y = hi ^ (hi >> u(16))
    y = y * u(0x9E3779B1)
    y = y ^ (y >> u(13))
    y = y * u(0x85EBCA6B)
    y = y ^ (y >> u(16))
    return x ^ y


def build_hash_group(kmer_sets: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """<=32 subjects' sorted-unique uint64 canonical k-mers -> bucketed hash
    table (keys_hi, keys_lo, masks), each uint32 [2^m, BUCKET_CAP]: the JAX
    package's _build_hash_group. Duplicate k-mers merge into one entry with
    OR'd membership bits; m grows until no bucket overflows; empty slots
    hold the all-ones key (never a canonical word) and mask 0."""
    words = np.concatenate(kmer_sets)
    owner = np.concatenate(
        [np.full(w.size, np.uint32(1) << np.uint32(s), np.uint32)
         for s, w in enumerate(kmer_sets)]
    )
    order = np.argsort(words, kind="stable")
    w, mk = words[order], owner[order]
    starts = np.ones(w.size, dtype=bool)
    starts[1:] = w[1:] != w[:-1]
    seg = np.cumsum(starts) - 1
    uniq_w = w[starts]
    uniq_m = np.zeros(uniq_w.size, np.uint32)
    np.bitwise_or.at(uniq_m, seg, mk)

    hi = (uniq_w >> np.uint64(32)).astype(np.uint32)
    lo = (uniq_w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    n = uniq_w.size
    m = max(int(np.ceil(np.log2(n / 4 + 1))), 4)
    while True:
        nb = 1 << m
        b = (mix32(hi, lo) & np.uint32(nb - 1)).astype(np.int64)
        if n == 0 or np.bincount(b, minlength=nb).max() <= BUCKET_CAP:
            break
        m += 1
    keys_hi = np.full((nb, BUCKET_CAP), 0xFFFFFFFF, np.uint32)
    keys_lo = np.full((nb, BUCKET_CAP), 0xFFFFFFFF, np.uint32)
    masks = np.zeros((nb, BUCKET_CAP), np.uint32)
    bo = np.argsort(b, kind="stable")
    bs = b[bo]
    pos = np.arange(n) - np.searchsorted(bs, bs)
    keys_hi[bs, pos] = hi[bo]
    keys_lo[bs, pos] = lo[bo]
    masks[bs, pos] = uniq_m[bo]
    return keys_hi, keys_lo, masks


# --- the port's table layout --------------------------------------------------------

@dataclass
class LutTables:
    """Dense tables of every group: ``table`` int32 [G, 4^k] (uint32 bit
    patterns), subjects 32g .. 32g + 31 in group g."""
    table: torch.Tensor
    k: int
    ns: int
    route = "lut"


@dataclass
class HashTables:
    """Bucketed hash tables of every group, rows concatenated: ``keys``
    int64 [rows, BUCKET_CAP] (all-ones in empty slots), ``masks`` int32
    [rows, BUCKET_CAP]; group g owns rows row0[g] .. row0[g] + bmask[g]
    (``row0``, ``bmask`` int64 [G])."""
    keys: torch.Tensor
    masks: torch.Tensor
    row0: torch.Tensor
    bmask: torch.Tensor
    k: int
    ns: int
    route = "hash"


def group_sizes(ns: int) -> list[int]:
    """Subjects per table group: 32, ..., the rest."""
    return [min(GROUP, ns - g) for g in range(0, ns, GROUP)]


def lut_tables_from_groups(tables: list[np.ndarray], k: int, ns: int,
                           device: torch.device) -> LutTables:
    """Per-group dense tables uint32 [4^k] (the JAX package's
    build_subject_table, as numpy arrays) -> the port's layout."""
    arr = np.ascontiguousarray(np.stack([np.asarray(t, np.uint32) for t in tables]))
    return LutTables(torch.from_numpy(arr.view(np.int32)).to(device), k, ns)


def hash_tables_from_groups(groups: list[tuple[np.ndarray, np.ndarray, np.ndarray]], k: int,
                            ns: int, device: torch.device) -> HashTables:
    """Per-group (keys_hi, keys_lo, masks) uint32 [2^m, BUCKET_CAP] (the JAX
    package's _build_hash_group, or ``build_hash_group``) -> the port's
    layout."""
    keys = np.concatenate([(np.asarray(hi, np.uint64) << np.uint64(32))
                           | np.asarray(lo, np.uint64) for hi, lo, _ in groups])
    masks = np.concatenate([np.asarray(m, np.uint32) for _, _, m in groups])
    rows = [g[0].shape[0] for g in groups]
    row0 = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int64)
    return HashTables(
        torch.from_numpy(np.ascontiguousarray(keys).view(np.int64)).to(device),
        torch.from_numpy(np.ascontiguousarray(masks).view(np.int32)).to(device),
        torch.from_numpy(row0).to(device),
        torch.tensor([r - 1 for r in rows], dtype=torch.int64, device=device), k, ns)


def build_hash_tables(subject_kmers: list[tuple[str, np.ndarray]], k: int,
                      device: torch.device) -> HashTables:
    """The hash tables of ``load_subject_kmers``'s output, 32 subjects a
    group, built on the host and uploaded once."""
    ns = len(subject_kmers)
    groups = [build_hash_group([s.astype(np.uint64) for _, s in subject_kmers[g : g + GROUP]])
              for g in range(0, ns, GROUP)]
    return hash_tables_from_groups(groups, k, ns, device)


def subjects_matrix(subject_kmers: list[tuple[str, np.ndarray]],
                    device: torch.device) -> torch.Tensor:
    """Subject words int64 [ns, smax], padded with -1 (all-ones, out of
    every 4^k range)."""
    ns = len(subject_kmers)
    smax = max((s.size for _, s in subject_kmers), default=1)
    out = np.full((ns, max(smax, 1)), -1, dtype=np.int64)
    for i, (_, s) in enumerate(subject_kmers):
        out[i, : s.size] = np.asarray(s, np.uint64).view(np.int64)
    return torch.from_numpy(out).to(device)


def subject_table_ref(subjects: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of ``subject_table``: every (entry, bit) pair once
    (so a repeated word ORs, as the kernel's atomicOr does), added in."""
    ns, smax = subjects.shape
    size = 1 << (2 * k)
    G = -(-ns // GROUP)
    s = torch.arange(ns, device=subjects.device)[:, None].expand(ns, smax)
    keep = (subjects >= 0) & (subjects < size)
    slot = ((s // GROUP) * size + subjects)[keep]
    key = torch.unique(slot * GROUP + (s % GROUP)[keep])
    bits = torch.ones_like(key, dtype=torch.int32) << (key % GROUP).int()
    out = torch.zeros(G * size, dtype=torch.int32, device=subjects.device)
    out.index_add_(0, key // GROUP, bits)
    return out.view(G, size)


def subject_table(subjects: torch.Tensor, k: int) -> torch.Tensor:
    """Dense membership tables int32 [ceil(ns/32), 4^k] (uint32 bit
    patterns) from subject words int64 [ns, smax] (padding -1): bit s % 32
    of entry [s / 32, w] set iff w is a word of subject s. CUDA tensor: the
    subject_table kernel; CPU tensor: subject_table_ref."""
    if subjects.dim() != 2 or subjects.dtype != torch.int64:
        raise ValueError(f"expected int64 [ns, smax] subjects, got {subjects.dtype} "
                         f"{tuple(subjects.shape)}")
    if not 1 <= k <= MAX_TABLE_K_CUDA:
        raise ValueError(f"need 1 <= k <= {MAX_TABLE_K_CUDA} for a dense table, got {k}")
    if subjects.device.type == "cpu":
        return subject_table_ref(subjects, k)
    if subjects.device.type != "cuda":
        raise ValueError(f"unsupported device {subjects.device}")
    subjects = subjects.contiguous()
    ns, smax = subjects.shape
    size = 1 << (2 * k)
    out = torch.zeros((-(-ns // GROUP), size), dtype=torch.int32, device=subjects.device)
    if subjects.numel():
        with torch.cuda.device(subjects.device):
            kernels.launch("subject_table", subjects.data_ptr(), out.data_ptr(), ns, smax,
                           size, torch.cuda.current_stream(subjects.device).cuda_stream)
    return out


def build_lut_tables(subject_kmers: list[tuple[str, np.ndarray]], k: int,
                     device: torch.device) -> LutTables:
    """The dense tables of ``load_subject_kmers``'s output, built on
    ``device`` in one subject_table launch."""
    table = subject_table(subjects_matrix(subject_kmers, device), k)
    return LutTables(table, k, len(subject_kmers))


# --- plain PyTorch versions -----------------------------------------------------------

def _srl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns."""
    return (x >> r) & ((1 << (32 - r)) - 1)


def _i32(c: int) -> int:
    return c - (1 << 32) if c >= 1 << 31 else c


def mix32_ref(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``mix32`` on int32 tensors holding uint32 bit patterns: int32 wrap
    multiplies and masked logical shifts (torch has no uint32 arithmetic)."""
    x = lo ^ _srl(lo, 16)
    x = x * _i32(0x7FEB352D)
    x = x ^ _srl(x, 15)
    x = x * _i32(0x846CA68B)
    x = x ^ _srl(x, 16)
    y = hi ^ _srl(hi, 16)
    y = y * _i32(0x9E3779B1)
    y = y ^ _srl(y, 13)
    y = y * _i32(0x85EBCA6B)
    y = y ^ _srl(y, 16)
    return x ^ y


def _window_valid(valid: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """Windows that are all ACGT and end inside their read."""
    nwin = valid.shape[1]
    pos = torch.arange(nwin, device=valid.device)
    return valid.bool() & (pos[None, :] + k <= lengths.long()[:, None])


def dedup_ref(words: torch.Tensor, valid: torch.Tensor, lengths: torch.Tensor,
              k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-read sort and dedup of the valid windows' words -> (sorted words
    int64 [B, nwin], invalid windows last as -1; distinct bool [B, nwin];
    num_kmer int32 [B]; num_unique int32 [B]). Unsigned order: the words
    are sorted with their sign bit flipped; the validity count, not the
    sentinel's value, marks where the valid words end."""
    win = _window_valid(valid, lengths, k)
    key = torch.where(win, words ^ _SIGN, torch.iinfo(torch.int64).max)
    s = torch.sort(key, dim=1).values ^ _SIGN
    nk = win.sum(dim=1)
    pos = torch.arange(s.shape[1], device=s.device)
    in_range = pos[None, :] < nk[:, None]
    differs = torch.ones_like(in_range)
    differs[:, 1:] = s[:, 1:] != s[:, :-1]
    uniq = in_range & differs
    return s, uniq, nk.int(), uniq.sum(dim=1).int()


def kmerize_batch_ref(reads: torch.Tensor, lengths: torch.Tensor,
                      k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's _kmerize_batch / _kmerize_batch64 for every k:
    ASCII reads uint8 [B, L] and lengths [B] -> (sorted words int64,
    distinct bool, num_kmer int32, num_unique int32)."""
    words, valid = canonical_kmers_ascii_ref(reads, k)
    return dedup_ref(words, valid, lengths, k)


def _probe_ref(tables, g: int, w: torch.Tensor) -> torch.Tensor:
    """Group g's int32 membership mask of every word of ``w``."""
    if tables.route == "lut":
        size = tables.table.shape[1]
        inside = (w >= 0) & (w < size)
        return torch.where(inside, tables.table[g][w.clamp(0, size - 1)], 0)
    hi = (w >> 32).int()
    lo = w.int()
    b = mix32_ref(hi, lo).long() & 0xFFFFFFFF & tables.bmask[g]
    row = tables.row0[g] + b
    hit = tables.keys[row] == w[..., None]                       # [..., BUCKET_CAP]
    cand = torch.where(hit, tables.masks[row], 0)
    m = torch.zeros_like(w, dtype=torch.int32)
    for c in range(BUCKET_CAP):
        m |= cand[..., c]
    return m


def sriracha_counts_ref(words: torch.Tensor, valid: torch.Tensor, lengths: torch.Tensor,
                        tables) -> torch.Tensor:
    """Plain version of ``sriracha_counts``: int32 [B, ns + 2], the
    per-subject counts of distinct valid words, then num_kmer and
    num_unique."""
    s, uniq, nk, nu = dedup_ref(words, valid, lengths, tables.k)
    parts = []
    for g, nsg in enumerate(group_sizes(tables.ns)):
        m = torch.where(uniq, _probe_ref(tables, g, s), 0)
        shifts = torch.arange(nsg, dtype=torch.int32, device=s.device)
        parts.append(((m[..., None] >> shifts) & 1).sum(dim=1, dtype=torch.int32))
    return torch.cat(parts + [nk[:, None], nu[:, None]], dim=1)


def read_batch_counts_ref(reads: torch.Tensor, lengths: torch.Tensor, tables) -> torch.Tensor:
    """The JAX package's _read_batch_kernel_tables / _read_batch_kernel_hash
    in plain PyTorch: ASCII reads uint8 [B, L] -> int32 [B, ns + 2]
    (counts, num_kmer, num_unique)."""
    words, valid = canonical_kmers_ascii_ref(reads, tables.k)
    return sriracha_counts_ref(words, valid, lengths, tables)


# --- kernel wrappers ----------------------------------------------------------------------

def next_pow2(n: int) -> int:
    """n rounded up to a power of two: the sort slots a row of n windows
    needs, and the rows of a batch of n reads."""
    return 1 << max(n - 1, 0).bit_length()


def counts_scratch(B: int, nwin: int, device: torch.device) -> torch.Tensor | None:
    """The sort slab of one sriracha_counts launch: int64 [B,
    next_pow2(nwin)] on ``device`` for a batch wide enough to hold rows of
    more than MAX_SHARED_WORDS windows (the kernel sorts those in tiles
    there; the batch's rows are already trimmed to its reads), else None."""
    if nwin <= MAX_SHARED_WORDS:
        return None
    return torch.empty((B, next_pow2(nwin)), dtype=torch.int64, device=device)


def sriracha_counts(words: torch.Tensor, valid: torch.Tensor, lengths: torch.Tensor,
                    tables, out: torch.Tensor | None = None) -> torch.Tensor:
    """Canonical words int64 [B, nwin], validity bool [B, nwin] (the
    canonical_kmers kernel's output) and read lengths int32 [B] -> int32
    [B, ns + 2]: per subject the distinct valid words it holds, then
    num_kmer and num_unique. ``out`` (optional) is a contiguous int32
    [B, ns + 2] tensor to write into. CUDA tensors: the sriracha_counts_lut
    / sriracha_counts_hash kernel (at most 65,535 rows when nwin is above
    MAX_SHARED_WORDS); CPU tensors: sriracha_counts_ref."""
    if (words.dim() != 2 or words.dtype != torch.int64 or valid.shape != words.shape
            or valid.dtype not in (torch.bool, torch.uint8)):
        raise ValueError(f"expected int64 words and validity [B, nwin], got {words.dtype} "
                         f"{tuple(words.shape)} / {tuple(valid.shape)}")
    B, nwin = words.shape
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"expected int32 lengths [{B}], got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    if tables.ns < 1 or not 1 <= tables.k <= MAX_DEVICE_K:
        raise ValueError(f"need ns >= 1 and 1 <= k <= 32 (ns={tables.ns}, k={tables.k})")
    shape = (B, tables.ns + 2)
    if out is not None and (out.shape != shape or out.dtype != torch.int32
                            or not out.is_contiguous() or out.device != words.device):
        raise ValueError(f"out must be a contiguous int32 {shape} tensor on {words.device}")
    if words.device.type == "cpu":
        got = sriracha_counts_ref(words, valid, lengths, tables)
        if out is None:
            return got
        out.copy_(got)
        return out
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    table = tables.table if tables.route == "lut" else tables.keys
    if table.device != words.device or lengths.device != words.device:
        raise ValueError(f"tables and lengths must be on {words.device}")
    words, valid, lengths = words.contiguous(), valid.contiguous(), lengths.contiguous()
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=words.device)
    if B == 0:
        return out
    if nwin > MAX_SHARED_WORDS and B > 65535:
        raise ValueError(f"at most 65535 rows of more than {MAX_SHARED_WORDS} windows, got {B}")
    scratch = counts_scratch(B, nwin, words.device)
    with torch.cuda.device(words.device):
        kernels.launch(*counts_launch(words, valid, lengths, tables, out, scratch))
    return out


def counts_launch(words, valid, lengths, tables, out, scratch) -> tuple:
    """The C entry and arguments of one sriracha_counts launch over checked,
    contiguous CUDA tensors (``scratch``: ``counts_scratch``), for
    ``kernels.launch``."""
    B, nwin = words.shape
    stream = torch.cuda.current_stream(words.device).cuda_stream
    head = (words.data_ptr(), valid.data_ptr(), lengths.data_ptr())
    tail = (out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), B, nwin, tables.k)
    if tables.route == "lut":
        return ("sriracha_counts_lut", *head, tables.table.data_ptr(), *tail,
                tables.table.shape[1], tables.ns, out.shape[1], stream)
    return ("sriracha_counts_hash", *head, tables.keys.data_ptr(), tables.masks.data_ptr(),
            tables.row0.data_ptr(), tables.bmask.data_ptr(), *tail, tables.ns, out.shape[1],
            stream)


def read_batch_counts(reads: torch.Tensor, lengths: torch.Tensor, tables,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """ASCII reads uint8 [B, L] and lengths int32 [B] -> int32 [B, ns + 2]
    through the canonical_kmers and sriracha_counts wrappers."""
    words, valid = canonical_kmers(reads, tables.k)
    return sriracha_counts(words, valid, lengths, tables, out)


# --- routing ------------------------------------------------------------------------------

def table_k_limit(device: torch.device) -> int:
    """Largest k with a dense table: 14 on a card (1 GiB per group), 13
    elsewhere."""
    return MAX_TABLE_K_CUDA if device.type == "cuda" else MAX_TABLE_K


def luts_fit(device: torch.device, num_groups: int, k: int) -> bool:
    """Whether the groups' dense tables fit in half of the card's free
    memory (always, off a card)."""
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    return num_groups * (4 << (2 * k)) <= free // 2


def use_lut(subject_kmers: list[tuple[str, np.ndarray]], k: int, device: torch.device) -> bool:
    """The JAX package's route rule: the dense LUT when k <= table_k_limit
    and a group holds more than KWAGE_SRIRACHA_HASH_MAX k-mers (default
    65536; 0 forces the LUT), and here also only when the tables fit."""
    ns = len(subject_kmers)
    hash_max = int(os.environ.get("KWAGE_SRIRACHA_HASH_MAX", "65536"))
    max_group_kmers = max(
        (sum(s.size for _, s in subject_kmers[g : g + GROUP]) for g in range(0, ns, GROUP)),
        default=0,
    )
    return (k <= table_k_limit(device)
            and (hash_max <= 0 or max_group_kmers > hash_max)
            and luts_fit(device, len(group_sizes(ns)), k))


def build_tables(subject_kmers: list[tuple[str, np.ndarray]], k: int, device: torch.device,
                 lut: bool | None = None):
    """LutTables or HashTables for the subjects on ``device``: the dense
    LUTs when ``lut`` (default: ``use_lut``)."""
    if lut is None:
        lut = use_lut(subject_kmers, k, device)
    if lut:
        return build_lut_tables(subject_kmers, k, device)
    return build_hash_tables(subject_kmers, k, device)


# --- the search ----------------------------------------------------------------------------

def pad_len(n: int) -> int:
    """Read bucket: the next power of two of at least 64 bases."""
    p = 64
    while p < n:
        p *= 2
    return p


class _SpanSlots:
    """Host staging for two spans in flight: span i packs its reads into,
    and reads its results back through, slot i % 2. Span i + 2 refills a
    slot only after span i was read back, when every copy through it has
    finished, so no buffer is reused under a copy and no dispatch waits.
    Pinned memory when a slot is on a card (the copies are asynchronous),
    plain otherwise."""

    def __init__(self, pin: bool):
        self.pin = pin
        self.slots: list[dict] = [{}, {}]

    def get(self, slot: int, name: str, n: int, dtype: torch.dtype) -> torch.Tensor:
        buf = self.slots[slot].get(name)
        if buf is None or buf.numel() < n:
            size = max(n, 2 * buf.numel() if buf is not None else 0)
            buf = torch.empty(size, dtype=dtype, pin_memory=self.pin)
            self.slots[slot][name] = buf
        return buf[:n]


def _pack_batch(block: np.ndarray, lengths: np.ndarray, seqs: list[str]) -> None:
    """ASCII reads into the zeroed rows of ``block`` uint8 [batch, L] and
    their lengths into ``lengths``."""
    n = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int64, n)
    lengths[:n] = lens
    total = int(lens.sum())
    if total == 0:
        return
    flat = np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8)
    rows = np.repeat(np.arange(n), lens)
    starts = np.cumsum(lens) - lens
    cols = np.arange(total) - np.repeat(starts, lens)
    block[rows, cols] = flat


def read_slots(mesh=None, auto_mesh: bool = True,
               device: torch.device | None = None) -> list[tuple[torch.device, object]]:
    """The (device, CUDA stream or None) slots a read batch is split over.

    ``mesh``: a ``parallel.mesh.SearchMesh`` whose filters axis is 1 (its
    data slots, each on its own stream) or a list of torch devices (one
    slot each, on a stream of its own); a device may stand in it several
    times, as logical slots of one card. Without a mesh, ``device`` is the
    one slot (on the current stream); with neither, ``auto_mesh`` takes
    every device of ``parallel.mesh.default_devices()`` when there are
    several, else ``resolve_device()``."""
    from ..parallel.mesh import SearchMesh, default_devices, make_search_mesh

    if mesh is not None and device is not None:
        raise ValueError("give a mesh or a device, not both")
    if mesh is None and device is None and auto_mesh:
        devices = default_devices()
        if len(devices) > 1:
            mesh = devices
    if mesh is None:
        return [(device if device is not None else resolve_device(), None)]
    if not isinstance(mesh, SearchMesh):
        mesh = make_search_mesh(len(mesh), 1, list(mesh))
    if mesh.shape["filters"] != 1 or mesh.spans_processes:
        raise ValueError(f"a read mesh is one column of this process's devices, got "
                         f"{mesh.shape} over ranks {sorted(set(mesh.owners.ravel().tolist()))}")
    return [(mesh.devices[d, 0], mesh.stream(d, 0)) for d in range(mesh.shape["data"])]


def _split_batch(L: int, chunk: list[int], n: int, batch_size: int) -> list[tuple]:
    """A batch's reads split along the batch axis over ``n`` slots, in
    order, ceil(len / n) each: one (L, reads, rows) per slot, None for a
    slot left without reads. Rows: the reads rounded up to a power of two
    (zero-length rows, no windows), at most ``batch_size``, so the few long
    reads of a span do not pad to batch_size rows of their bucket's width."""
    per = -(-len(chunk) // n)
    parts = [chunk[s * per : (s + 1) * per] for s in range(n)]
    return [(L, p, min(batch_size, next_pow2(len(p)))) if p else None for p in parts]


def search_reads_device(
    read_iter,
    subject_kmers: list[tuple[str, np.ndarray]],
    opt: SrirachaOptions,
    stats: StreamStats | None = None,
    batch_size: int = 512,
    span_reads: int | None = None,
    mesh=None,
    auto_mesh: bool = True,
    profile: dict | None = None,
    device: torch.device | None = None,
) -> list[list[SearchMatch]]:
    """Device-batched equivalent of engine.search_reads (bit-identical
    output) for every reference-legal k (1..32): the JAX package's
    search_reads_device.

    ``mesh`` / ``auto_mesh`` / ``device`` choose the slots (``read_slots``):
    by default every visible card when there are several, as the JAX
    function shards over every device; ``device=`` (or
    KWAGE_TORCH_DEVICE=cuda:i) is that one device. Each batch's reads are
    split over the slots along the batch axis, every read in exactly one
    slot; the subject tables are built once per distinct device (so a
    card's LUTs are counted and held once) and shared by its slots. Per-read
    work is independent: no collective, and the output is the
    single-device run's.

    The read iterator is consumed in spans of ``span_reads`` (default
    16 x batch_size), pipelined ONE span deep: span i+1 is packed and
    dispatched before span i's one readback, so host packing and gating
    overlap device work. Each slot packs its part of every batch of a span
    into one host staging buffer (pinned on a card), uploads it once,
    launches canonical_kmers and sriracha_counts per batch on its own
    stream into one device buffer int32 [its rows, ns + 2] and queues one
    asynchronous copy back, then records an event; the span's readback
    waits for every slot's event and puts the rows back in read order. No
    host sync happens while a span is dispatched. Gate state
    (perfect-match caps, intermediate culls) carries across spans, so the
    output is identical to a fully materialised run; ``stats`` counters run
    up to one span ahead of the emitted matches.

    ``profile`` (optional dict) accumulates ``pack_dispatch_s``,
    ``sync_s``, ``gate_s``, ``spans``, ``bp`` and ``events`` -- the
    ("dispatch"|"sync", span#) order, which shows the 1-deep overlap."""
    ns = len(subject_kmers)
    if ns == 0:
        return []
    slot_devs = read_slots(mesh, auto_mesh, device)
    if span_reads is None:
        span_reads = 16 * batch_size
    k = opt.kmer_len
    distinct = list(dict.fromkeys(dev for dev, _ in slot_devs))
    lut = all(use_lut(subject_kmers, k, dev) for dev in distinct)
    tables_on = {dev: build_tables(subject_kmers, k, dev, lut) for dev in distinct}
    for dev, stream in slot_devs:
        if stream is not None:
            # The tables were built on the device's current stream.
            stream.wait_stream(torch.cuda.current_stream(dev))
    staging = _SpanSlots(any(dev.type == "cuda" for dev in distinct))
    width = ns + 2

    results: list[list[SearchMatch]] = [[] for _ in range(ns)]
    num_perfect = [0] * ns

    def dispatch_slot(reads, span_slot, s, batches):
        """Pack, upload and launch slot s's part of every batch of a span on
        its stream; queue the copy back. Returns (host result view, copy
        event)."""
        dev, stream = slot_devs[s]
        nbytes = sum(rows * L for L, _, rows in batches)
        nrows = sum(rows for _, _, rows in batches)
        block_h = staging.get(span_slot, f"reads{s}", nbytes, torch.uint8)
        lens_h = staging.get(span_slot, f"lengths{s}", nrows, torch.int32)
        block_np, lens_np = block_h.numpy(), lens_h.numpy()
        block_np[:] = 0
        lens_np[:] = 0
        off = row0 = 0
        for L, chunk, rows in batches:
            _pack_batch(block_np[off : off + rows * L].reshape(rows, L),
                        lens_np[row0 : row0 + rows], [reads[i][0] for i in chunk])
            off += rows * L
            row0 += rows
        out_h = staging.get(span_slot, f"out{s}", nrows * width, torch.int32).view(nrows, width)
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            block_d = block_h.to(dev, non_blocking=True)
            lens_d = lens_h.to(dev, non_blocking=True)
            out_d = torch.empty((nrows, width), dtype=torch.int32, device=dev)
            off = row0 = 0
            for L, _, rows in batches:
                read_batch_counts(block_d[off : off + rows * L].view(rows, L),
                                  lens_d[row0 : row0 + rows], tables_on[dev],
                                  out_d[row0 : row0 + rows])
                off += rows * L
                row0 += rows
            out_h.copy_(out_d, non_blocking=True)
            event = None
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
        return out_h, event

    def dispatch_span(reads, span_slot):
        """Dispatch every slot's part of a span. Returns, for each slot with
        reads, (its batch chunks, host result view, copy event)."""
        buckets: dict[int, list[int]] = {}
        for i, (seq, _, _) in enumerate(reads):
            if stats is not None:
                stats.num_reads += 1
                stats.num_bases += len(seq)
            buckets.setdefault(pad_len(max(len(seq), k)), []).append(i)
        per_slot: list[list[tuple]] = [[] for _ in slot_devs]
        for L, idxs in sorted(buckets.items()):
            for start in range(0, len(idxs), batch_size):
                parts = _split_batch(L, idxs[start : start + batch_size], len(slot_devs),
                                     batch_size)
                for s, part in enumerate(parts):
                    if part is not None:
                        per_slot[s].append(part)
        return [([(chunk, rows) for _, chunk, rows in batches],
                 *dispatch_slot(reads, span_slot, s, batches))
                for s, batches in enumerate(per_slot) if batches]

    def readback_span(reads, pending):
        """The span's one wait: every slot's copy back. In a slot's rows a
        batch's rows follow the previous batch's."""
        for _, _, event in pending:
            if event is not None:
                event.synchronize()
        counts = np.zeros((len(reads), ns), dtype=np.int64)
        nk = np.zeros(len(reads), dtype=np.int64)
        nu = np.zeros(len(reads), dtype=np.int64)
        for chunks, out_h, _ in pending:
            res = out_h.numpy()
            row0 = 0
            for chunk, batch_rows in chunks:
                rows = res[row0 : row0 + len(chunk)]
                counts[chunk] = rows[:, :ns]
                nk[chunk] = rows[:, ns]
                nu[chunk] = rows[:, ns + 1]
                row0 += batch_rows
        return counts, nk, nu

    if profile is not None:
        for key in ("pack_dispatch_s", "sync_s", "gate_s"):
            profile.setdefault(key, 0.0)
        profile.setdefault("spans", 0)
        profile.setdefault("bp", 0)
        profile.setdefault("events", [])

    read_iter = iter(read_iter)
    prev: tuple | None = None  # (reads, pending, span#) -- 1-deep span pipeline
    span_no = 0
    while True:
        reads = list(islice(read_iter, span_reads))
        # Dispatch span i+1 BEFORE reading span i back.
        cur = None
        if reads:
            t0 = time.perf_counter()
            cur = (reads, dispatch_span(reads, span_no % 2), span_no)
            if profile is not None:
                profile["pack_dispatch_s"] += time.perf_counter() - t0
                profile["spans"] += 1
                profile["bp"] += sum(len(r[0]) for r in reads)
                profile["events"].append(("dispatch", span_no))
            span_no += 1
        if prev is None:
            if cur is None:
                break
            prev = cur
            continue
        reads, pending, prev_no = prev
        t0 = time.perf_counter()
        counts, nk, nu = readback_span(reads, pending)
        t_gate = time.perf_counter()
        if profile is not None:
            profile["sync_s"] += t_gate - t0
            profile["events"].append(("sync", prev_no))
        prev = cur

        # Vectorised gates + accumulation: exactly the engine's sequential
        # loop (float32 divisions, nan-passes-gate complexity quirk,
        # perfect-match early-skip in read order), as in the JAX package:
        #   - the perfect-match cap: a subject stops accepting matches once
        #     its appended-perfect count reaches max_num_match, so keep =
        #     (perfects before this read < max); num_perfect advances only
        #     by KEPT perfects;
        #   - the 10x intermediate cull: sort_key is a total order, so
        #     prefix culls never change the final top-max set.
        lens = np.fromiter((len(r[0]) for r in reads), np.int64, len(reads))
        nu_f = nu.astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            complexity = nu_f / nk.astype(np.float32)
            scores = counts.astype(np.float32) / nu_f[:, None]  # [n, ns]
        ok = (lens >= opt.min_read_length) & (nk >= opt.min_valid_kmer)
        # nan complexity (nk == 0) passes the gate in the scalar loop.
        ok &= ~(complexity < np.float32(opt.min_read_complexity))
        cand = ok[:, None] & (scores >= np.float32(opt.kmer_match_threshold))
        for s in range(ns):
            idxs = np.nonzero(cand[:, s])[0]
            if idxs.size == 0:
                continue
            perf = scores[idxs, s] == np.float32(1.0)
            before = num_perfect[s] + np.cumsum(perf) - perf
            keep = before < opt.max_num_match
            bucket = results[s]
            for i in idxs[keep]:
                seq, ridx, sidx = reads[i]
                bucket.append(SearchMatch(ridx, sidx, float(scores[i, s]), seq))
            num_perfect[s] += int(perf[keep].sum())
            if opt.max_num_match > 0 and len(bucket) > 10 * opt.max_num_match:
                bucket.sort(key=SearchMatch.sort_key)
                del bucket[opt.max_num_match :]
        if profile is not None:
            profile["gate_s"] += time.perf_counter() - t_gate

    for bucket in results:
        bucket.sort(key=SearchMatch.sort_key)
        if opt.max_num_match > 0 and len(bucket) > opt.max_num_match:
            del bucket[opt.max_num_match :]
    return results


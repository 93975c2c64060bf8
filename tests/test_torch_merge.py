"""The port's device build of big accessions (kwage_tpu_torch.ops.counting
run_counts / merge_counts and pipeline.make_bloom.build_bloom_device)
against kwage_tpu's numpy merge of sorted runs, its chunked device build
on the JAX CPU backend, and the exact ground truth. The CUDA kernels'
logic (csrc/merge.cu: the merge path, the serial tile merge, the
look-back and the segments' saturating adds) is held here by a numpy
emulation at small tiles; the ``cuda`` tests hold the kernels against
their plain versions on a card. Integer and bit outputs: every
comparison is exact equality."""

import dataclasses
import mmap
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from kwage_tpu.core import FilterInfo
from kwage_tpu.core.words import canonical_kmers as host_canonical_kmers
from kwage_tpu.native import murmur32_native
from kwage_tpu.pipeline import BuildOptions
from kwage_tpu.pipeline import make_bloom as jmb
from kwage_tpu_torch import kernels
from kwage_tpu_torch.io import sequence as tseq
from kwage_tpu_torch.ops import counting as tc
from kwage_tpu_torch.ops import kmers as tk
from kwage_tpu_torch.pipeline import make_bloom as tmb

CAP = tc.COUNT_CAP


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py checks the kernels on the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """The plain versions, on two torch threads: the suite runs beside
    other test processes on the same cores."""
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# --- runs of distinct (word, count) pairs ------------------------------------------

def _words(rng, n, k):
    """n random k-mer words as uint64 (k = 32: the top bit set for half)."""
    top = 2**64 if k == 32 else 1 << (2 * k)
    return rng.integers(0, top, size=n, dtype=np.uint64)


def _run(words_u64, counts):
    """A distinct run in the port's order: int64 words sorted as signed
    values, int32 counts."""
    w = words_u64.view(np.int64)
    order = np.argsort(w, kind="stable")
    return _t(w[order]), _t(counts[order].astype(np.int32))


def _jax_run(words_u64, counts):
    """The same run in the JAX package's order (uint64), int64 counts."""
    order = np.argsort(words_u64, kind="stable")
    return words_u64[order], counts[order].astype(np.int64)


def _merge_case(case, seed):
    """(words A uint64, counts A, words B, counts B), each distinct."""
    rng = np.random.default_rng(seed)
    k = 32 if case == "k32" else 31
    pool = np.unique(_words(rng, 400, k))
    rng.shuffle(pool)
    a, b = pool[:150], pool[100:260]
    if case == "empty_a":
        a = a[:0]
    elif case == "empty_b":
        b = b[:0]
    elif case == "disjoint":
        a, b = pool[:150], pool[150:300]
    elif case == "identical":
        b = a.copy()
    ca = rng.integers(1, 9, size=a.size)
    cb = rng.integers(1, 9, size=b.size)
    return a, ca, b, cb


def _as_dict(words, counts, num=None):
    num = len(words) if num is None else num
    w = np.asarray(words)[:num].astype(np.int64).view(np.uint64)
    return dict(zip(w.tolist(), np.asarray(counts)[:num].tolist()))


MERGE_CASES = ["overlap", "empty_a", "empty_b", "disjoint", "identical", "k32"]


@pytest.mark.parametrize("cap", [CAP, 5])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_counts_ref_matches_jax_merge(case, cap):
    """merge_counts_ref == kwage_tpu's _merge_sorted_counts as sets and
    counts (saturating at cap); the port's order is signed."""
    a, ca, b, cb = _merge_case(case, 3)
    want_w, want_c = jmb._merge_sorted_counts(*_jax_run(a, ca), *_jax_run(b, cb))
    want = {w: min(c, cap) for w, c in zip(want_w.tolist(), want_c.tolist())}
    for min_count in (0, min(cap, 5)):
        words, counts, stats, sel = tc.merge_counts(*_run(a, ca), *_run(b, cb), cap, min_count)
        num = int(stats[0])
        assert num == len(want)
        assert _as_dict(words, counts, num) == want
        assert torch.all(words[1:num] > words[: num - 1])      # signed order, distinct
        if min_count:
            kept = {w for w, c in want.items() if c >= min_count}
            assert int(stats[1]) == len(kept)
            assert set(words[:num][sel[:num]].numpy().view(np.uint64).tolist()) == kept
        else:
            assert sel is None and int(stats[1]) == 0


@pytest.mark.parametrize("k", [21, 31, 32])
@pytest.mark.parametrize("cap", [CAP, 1, 5])
def test_run_counts_ref_matches_jax_counts(k, cap):
    """A chunk's sorted windows: run_counts_ref == the JAX package's count
    of each run (its _merge_sorted_counts of the windows with count 1),
    saturating at cap; words with the top bit set at k = 32."""
    rng = np.random.default_rng(k + cap)
    pool = _words(rng, 300, k)
    windows = pool[rng.integers(0, pool.size, size=3000)]
    words = _t(np.sort(windows.view(np.int64)))
    got = tc.run_counts(words, None, cap, 1)
    want_w, want_c = jmb._merge_sorted_counts(np.sort(windows), np.ones(windows.size, np.int64),
                                              np.empty(0, np.uint64), np.empty(0, np.int64))
    num = int(got[2][0])
    assert _as_dict(got[0], got[1], num) == {w: min(c, cap) for w, c in
                                             zip(want_w.tolist(), want_c.tolist())}
    assert int(got[2][1]) == num and bool(got[3][:num].all())
    if k == 32:
        assert bool((got[0][:num] < 0).any())


def test_run_counts_weights_saturate_at_int32():
    words = _t(np.repeat(np.arange(-5, 5, dtype=np.int64), 3))
    weights = torch.full(words.shape, 2**30, dtype=torch.int32)
    got = tc.run_counts(words, weights, CAP, CAP)
    assert got[1][:10].tolist() == [CAP] * 10 and got[2].tolist() == [10, 10]
    got = tc.run_counts(words, weights, 2**31 - 1, 0)
    assert got[3] is None


def test_run_counts_empty_and_refusals():
    e = torch.zeros(0, dtype=torch.int64)
    words, counts, stats, sel = tc.run_counts(e, None, 5, 5)
    assert stats.tolist() == [0, 0] and words.numel() == counts.numel() == sel.numel() == 0
    assert tc.merge_counts(e, e.int(), e, e.int(), 5, 5)[2].tolist() == [0, 0]
    with pytest.raises(ValueError):
        tc.run_counts(e, None, 0)
    with pytest.raises(ValueError):
        tc.run_counts(e, None, 5, 6)
    with pytest.raises(ValueError):
        tc.run_counts(e.int())
    with pytest.raises(ValueError):
        tc.merge_counts(e, e, e, e.int())
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tc.run_counts(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tc.merge_counts(meta, meta.int(), meta, meta.int())


# --- a numpy emulation of csrc/merge.cu ------------------------------------------------

AGGREGATE, PREFIX = 1, 2


def _emulate_run_counts(words, weights, cap, min_count, threads, ipt):
    """run_counts_kernel, block by block in ticket order, thread by thread:
    the flags (the word before a thread's first from the thread before),
    the block scan, the look-back over the published tiles, and each run
    summed by the thread that holds its start, past its own positions
    where the run goes on, up to cap."""
    words = [int(x) for x in words]
    wt = [1] * len(words) if weights is None else [int(x) for x in weights]
    n, tile = len(words), threads * ipt
    tiles = -(-n // tile)
    words_out, counts, selected = [0] * n, [0] * n, [False] * n
    lookback = [None] * tiles
    num = kept = 0
    for t in range(tiles):
        base = t * tile
        flags = [[p < n and (p == 0 or words[p] != words[p - 1])
                  for p in range(base + th * ipt, base + (th + 1) * ipt)]
                 for th in range(threads)]
        nflags = [sum(f) for f in flags]
        excl = np.concatenate([[0], np.cumsum(nflags)[:-1]]).tolist()
        total = sum(nflags)
        before = 0
        if t == 0:
            lookback[t] = (PREFIX, total)
        else:
            lookback[t] = (AGGREGATE, total)
            for q in range(t - 1, -1, -1):
                kind, v = lookback[q]
                before += v
                if kind == PREFIX:
                    break
            lookback[t] = (PREFIX, before + total)
        if t == tiles - 1:
            num = before + total
        for th in range(threads):
            run = before + excl[th]
            for i in range(ipt):
                p = base + th * ipt + i
                if not flags[th][i]:
                    continue
                total_w, q = wt[p], p + 1
                while q < n and total_w < cap and words[q] == words[p]:
                    total_w, q = total_w + wt[q], q + 1
                words_out[run], counts[run] = words[p], min(total_w, cap)
                if min_count:
                    selected[run] = counts[run] >= min_count
                    kept += selected[run]
                run += 1
    return words_out[:num], counts[:num], num, kept, selected[:num] if min_count else None


def _merge_path(a, b, d):
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] <= b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _emulate_merge(wa, ca, wb, cb, threads, ipt):
    """merge_partition_kernel + merge_kernel: a binary search a tile
    diagonal, then each thread's binary search in the tile's staged pieces
    and its serial merge of ipt outputs (run A's pair first on equal
    words)."""
    wa, wb = [int(x) for x in wa], [int(x) for x in wb]
    ca, cb = [int(x) for x in ca], [int(x) for x in cb]
    n, tile = len(wa) + len(wb), threads * ipt
    tiles = -(-n // tile)
    part = [_merge_path(wa, wb, min(i * tile, n)) for i in range(tiles + 1)]
    out_w, out_c = [0] * n, [0] * n
    for t in range(tiles):
        d0 = t * tile
        length = min(d0 + tile, n) - d0
        a0, a1 = part[t], part[t + 1]
        b0 = d0 - a0
        la = a1 - a0
        lb = length - la
        s_w = wa[a0:a1] + wb[b0 : b0 + lb]
        s_c = ca[a0:a1] + cb[b0 : b0 + lb]
        for th in range(threads):
            dt = min(th * ipt, length)
            ia = _merge_path(s_w[:la], s_w[la:], dt)
            ib = dt - ia
            for i in range(ipt):
                if dt + i >= length:
                    break
                take_a = ib >= lb or (ia < la and s_w[ia] <= s_w[la + ib])
                src = ia if take_a else la + ib
                ia, ib = (ia + 1, ib) if take_a else (ia, ib + 1)
                out_w[d0 + dt + i], out_c[d0 + dt + i] = s_w[src], s_c[src]
    return out_w, out_c


TILES = [(1, 1), (2, 3), (4, 2), (8, 8)]   # (threads, positions a thread)


def _check_emulation(got, want):
    words, counts, num, kept, selected = got
    assert num == int(want[2][0]) and kept == int(want[2][1])
    assert words == want[0][:num].tolist() and counts == want[1][:num].tolist()
    if want[3] is not None:
        assert selected == want[3][:num].tolist()


@pytest.mark.parametrize("threads,ipt", TILES)
@pytest.mark.parametrize("case", MERGE_CASES + ["shifted"])
def test_merge_emulation_matches_plain(case, threads, ipt):
    """The kernels' merge and fold, emulated at tiles of 1-64 outputs:
    equal words split by a tile edge, empty and identical runs, k = 32
    signed words, counts that saturate."""
    if case == "shifted":     # A = 0..n-1, B = 1..n: every pair on both sides of an edge
        a = np.arange(0, 97, dtype=np.uint64)
        b = a + np.uint64(1)
        ca, cb = np.full(a.size, 3), np.full(b.size, 4)
    else:
        a, ca, b, cb = _merge_case(case, 17)
    ra, rb = _run(a, ca), _run(b, cb)
    mw, mc = _emulate_merge(ra[0].numpy(), ra[1].numpy(), rb[0].numpy(), rb[1].numpy(),
                            threads, ipt)
    order = sorted(range(len(mw)), key=lambda i: mw[i])
    assert [mw[i] for i in order] == mw                        # sorted, A before B on ties
    for cap, min_count in ((CAP, 0), (5, 5)):
        want = tc.merge_counts_ref(*ra, *rb, cap, min_count)
        got = _emulate_run_counts(mw, mc, cap, min_count, threads, ipt)
        _check_emulation(got, want)


@pytest.mark.parametrize("threads,ipt", TILES)
@pytest.mark.parametrize("layout", ["random", "long_runs", "one_run", "distinct", "k32"])
def test_run_counts_emulation_matches_plain(layout, threads, ipt):
    """The run_counts kernel, emulated: runs that start, end and cross at
    thread and tile edges, one run over every tile, no run longer than 1."""
    rng = np.random.default_rng(5)
    if layout == "random":
        words = np.sort(rng.integers(-40, 40, size=301))
    elif layout == "long_runs":
        words = np.repeat(np.arange(-4, 5), rng.integers(1, 90, size=9))
    elif layout == "one_run":
        words = np.full(200, 7)
    elif layout == "distinct":
        words = np.arange(-100, 101)
    else:
        words = np.sort(_words(rng, 60, 32)[rng.integers(0, 60, size=250)].view(np.int64))
    words = words.astype(np.int64)
    weights = rng.integers(1, 4, size=words.size).astype(np.int32)
    for w in (None, weights):
        for cap, min_count in ((CAP, 0), (5, 5), (1, 1)):
            want = tc.run_counts_ref(_t(words), None if w is None else _t(w), cap, min_count)
            _check_emulation(_emulate_run_counts(words, w, cap, min_count, threads, ipt), want)


# --- build_bloom_device in chunks --------------------------------------------------------

def _reads(seed, genome_bp=2000, coverage=8, read_len=100):
    """Reads of a random genome, either strand, with substitutions, an N
    here and there, a few short reads and one read of 30 kbp."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=genome_bp)
    comp = np.array([3, 2, 1, 0])
    out = []
    for _ in range(genome_bp * coverage // read_len):
        s = int(rng.integers(0, genome_bp - read_len))
        codes = g[s : s + read_len].copy()
        if rng.random() < 0.5:
            codes = comp[codes[::-1]]
        sub = rng.random(read_len) < 0.003
        codes[sub] = (codes[sub] + 1) % 4
        r = np.array(list("ACGT"))[codes]
        r[rng.random(read_len) < 0.002] = "N"
        out.append("".join(r))
    out += ["ACGTAC", "GATTACA" * 3]
    return out


def _opts(k, min_count, **kw):
    base = dict(kmer_len=k, min_kmer_count=min_count, false_positive_probability=0.25,
                min_log_2_filter_len=10, max_log_2_filter_len=24,
                min_log_2_count_len=18, max_log_2_count_len=20)
    base.update(kw)
    return BuildOptions(**base)


def _ground_truth(reads, k, min_count, num_hash, log2_len):
    counts = Counter()
    for r in reads:
        counts.update(host_canonical_kmers(r, k).tolist())
    words = np.array(sorted(w for w, c in counts.items() if c >= min_count), dtype=np.uint64)
    out = np.zeros(max(1, (1 << log2_len) // 8), np.uint8)
    if words.size:
        idx = (murmur32_native(words, k, num_hash) & np.uint32((1 << log2_len) - 1)).reshape(-1)
        np.bitwise_or.at(out, (idx >> 3).astype(np.int64),
                         np.uint8(1) << (idx & 7).astype(np.uint8))
    return words.size, out


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(path)


READS = _reads(1)
JAX_BUILDS: dict = {}


def _jax_build(k, min_count):
    if (k, min_count) not in JAX_BUILDS:
        JAX_BUILDS[k, min_count] = jmb.build_bloom_device(iter(READS), _opts(k, min_count),
                                                          FilterInfo(), chunk_bp=4000)
    return JAX_BUILDS[k, min_count]


def _same(a, b) -> bool:
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("source", ["strings", "fastq"])
@pytest.mark.parametrize("k", [21, 31, 32])
@pytest.mark.parametrize("min_count", [1, 2, 3, 4, 5])
def test_chunked_build_matches_jax_and_ground_truth(min_count, k, source, tmp_path):
    """Forced chunks of 3000 bases (6 a build; the file's in row ranges of
    its packed block) merge on the device: the record equals the JAX
    package's chunked build and the exact ground truth."""
    src = iter(READS) if source == "strings" else _write_fastq(tmp_path / "a.fastq", READS)
    rec = tmb.build_bloom_device(src, _opts(k, min_count), FilterInfo(), chunk_bp=3000)
    want = _jax_build(k, min_count)
    assert _same(rec.param, want.param) and rec.bits.tobytes() == want.bits.tobytes()
    n, gt = _ground_truth(READS, k, min_count, rec.param.num_hash, rec.param.log_2_filter_len)
    assert rec.bits.tobytes() == gt.tobytes() and n > 0
    assert rec.test_crc32()
    assert rec.info.number_of_bases == sum(map(len, READS))
    assert rec.info.number_of_spots == len(READS)


@pytest.mark.parametrize("chunk_bp", [None, 1, 3000, 10**9])
def test_chunk_sizes_give_the_same_record(chunk_bp, tmp_path):
    """One read a chunk, a few chunks, one chunk, and chunks sized without a
    card (CPU_CHUNK_WINDOWS) give the same bits, from strings and a file."""
    opts = _opts(31, 3)
    want = _jax_build(31, 3)
    path = _write_fastq(tmp_path / "a.fastq", READS)
    for src in (iter(READS), path):
        rec = tmb.build_bloom_device(src, opts, FilterInfo(), chunk_bp=chunk_bp)
        assert _same(rec.param, want.param) and rec.bits.tobytes() == want.bits.tobytes()


def _refuse_python_reader(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the Python reader was called")

    monkeypatch.setattr(tseq, "iter_sequences", refuse)
    monkeypatch.setattr(tmb, "iter_sequences", refuse)


def test_big_file_job_is_packed_natively(monkeypatch, tmp_path):
    """A file job above the batch's chunk_bp is scanned and packed by the
    native library: the Python reader is never called, and the record
    equals the JAX build's and the fused job beside it is untouched."""
    path = _write_fastq(tmp_path / "big.fastq", READS)
    small = _write_fastq(tmp_path / "small.fastq", READS[:5])
    want_small = jmb.build_bloom_device(iter(READS[:5]), _opts(31, 1), FilterInfo())
    _refuse_python_reader(monkeypatch)
    got = tmb.build_blooms_device_batch([(path, FilterInfo()), (small, FilterInfo())],
                                        _opts(31, 1), chunk_bp=2000)
    want = _jax_build(31, 1)
    assert _same(got[0].param, want.param) and got[0].bits.tobytes() == want.bits.tobytes()
    assert got[1].bits.tobytes() == want_small.bits.tobytes()
    rec = tmb.build_bloom_device(path, _opts(31, 1), FilterInfo(), chunk_bp=2500)
    assert rec.bits.tobytes() == want.bits.tobytes()


def test_file_past_the_host_cap_streams(monkeypatch, tmp_path):
    """Past PACK_HOST_CAP_BYTES the file streams through the Python reader
    into string chunks, still counted on the device: the same record."""
    path = _write_fastq(tmp_path / "a.fastq", READS)
    monkeypatch.setattr(tmb, "PACK_HOST_CAP_BYTES", 1000)
    calls = []
    real = tseq.iter_sequences
    monkeypatch.setattr(tseq, "iter_sequences", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rec = tmb.build_bloom_device(path, _opts(31, 3), FilterInfo(), chunk_bp=3000)
    assert calls and rec.bits.tobytes() == _jax_build(31, 3).bits.tobytes()


def test_native_block_equals_string_packing(tmp_path):
    """The file's native block and a string chunk pack the same reads to
    the same words (pack_reads_host's layout), row for row."""
    path = _write_fastq(tmp_path / "a.fastq", READS)
    spots, bp, packed, valid_words, blen, buf = tmb._pack_file_block(path, 31)
    assert buf.ctypes.data % mmap.PAGESIZE == 0 and buf.nbytes == packed.nbytes + valid_words.nbytes
    longs = [r for r in READS if len(r) >= 31]
    p, v, length = tmb._pack_strings(longs, 31)
    assert (spots, bp, blen) == (len(READS), sum(map(len, READS)), length)
    assert torch.equal(packed, p) and torch.equal(valid_words, v)
    block = np.zeros((len(longs), length), np.uint8)
    for i, r in enumerate(longs):
        block[i, : len(r)] = np.frombuffer(r.encode(), np.uint8)
    want_p, want_v = tk.pack_reads_host(block)
    assert np.array_equal(p.numpy().view(np.uint32), want_p)
    assert np.array_equal(v.numpy().view(np.uint32), want_v)


@pytest.mark.parametrize("chunk_bp", [500, None])
def test_bloom_invalid_past_max_kmers_as_jax(chunk_bp):
    """More distinct k-mers than max_kmers: BloomInvalid, as the JAX
    build raises it (checked after each chunk)."""
    opts = _opts(31, 1, max_log_2_filter_len=10)
    assert tmb._max_kmers(opts) < 1000
    with pytest.raises(jmb.BloomInvalid):
        jmb.build_bloom_device(iter(READS), opts, FilterInfo(), chunk_bp=500)
    with pytest.raises(tmb.BloomInvalid, match="exceeds feasible maximum"):
        tmb.build_bloom_device(iter(READS), opts, FilterInfo(), chunk_bp=chunk_bp)


def test_no_long_read_is_invalid(tmp_path):
    with pytest.raises(tmb.BloomInvalid, match="no reads of length >= k"):
        tmb.build_bloom_device(iter(["ACGT", "AC"]), _opts(31, 1), FilterInfo())
    path = _write_fastq(tmp_path / "s.fastq", ["ACGT", "AC"])
    with pytest.raises(tmb.BloomInvalid, match="no reads of length >= k"):
        tmb.build_bloom_device(path, _opts(31, 1), FilterInfo())


def test_with_last_and_row_chunks():
    assert list(tmb._with_last([])) == []
    assert list(tmb._with_last("ab")) == [("a", False), ("b", True)]
    cpu = torch.device("cpu")
    assert tmb._chunk_rows(cpu, 2) == tmb.CPU_CHUNK_WINDOWS // 2
    assert tmb._chunk_rows(cpu, tmb.CPU_CHUNK_WINDOWS) == 1
    with pytest.raises(RuntimeError, match="does not fit"):
        tmb._chunk_rows(cpu, tmb.CPU_CHUNK_WINDOWS + 1)


@pytest.mark.parametrize("chunk_bp", [None, 3000])
def test_builds_in_threads_take_turns(monkeypatch, chunk_bp, tmp_path):
    """Builds in 4 threads at once, from strings and from a file: each
    chunk is counted and merged holding the process's turn (one at a time),
    and every record equals the JAX package's."""
    path = _write_fastq(tmp_path / "a.fastq", READS)
    real, inside, most = tmb.count_chunk, [0], [0]
    guard = threading.Lock()

    def counting(*args, **kwargs):
        assert tmb._CARD_TURN.locked()
        with guard:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        try:
            return real(*args, **kwargs)
        finally:
            with guard:
                inside[0] -= 1

    monkeypatch.setattr(tmb, "count_chunk", counting)
    want = _jax_build(31, 3)
    with ThreadPoolExecutor(4) as pool:
        recs = list(pool.map(
            lambda src: tmb.build_bloom_device(src, _opts(31, 3), FilterInfo(), chunk_bp=chunk_bp),
            [path, iter(READS), path, iter(READS)]))
    assert most[0] == 1
    assert all(r.bits.tobytes() == want.bits.tobytes() for r in recs)


def test_cpu_build_launches_no_kernel():
    before = kernels.launch_counts()
    tmb.build_bloom_device(iter(READS), _opts(31, 2), FilterInfo(), chunk_bp=3000)
    assert kernels.launch_counts() == before


# --- the kernels on a card -----------------------------------------------------------------

@pytest.mark.cuda
def test_run_and_merge_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(9)
    for n in (0, 1, 2047, 2048, 2049, 3 * 2048 + 5, 1 << 20):
        for k in (31, 32):
            words = torch.sort(_t(_words(rng, max(n // 3, 1), k).view(np.int64)[
                rng.integers(0, max(n // 3, 1), size=n)])).values.to(cuda_device)
            for cap, m in ((CAP, 0), (5, 5)):
                got = tc.run_counts(words, None, cap, m)
                want = tc.run_counts_ref(words, None, cap, m)
                num = int(want[2][0])
                assert torch.equal(got[2], want[2])
                assert torch.equal(got[0][:num], want[0][:num])
                assert torch.equal(got[1][:num], want[1][:num])
    for case in MERGE_CASES:
        a, ca, b, cb = _merge_case(case, 23)
        ra = [x.to(cuda_device) for x in _run(a, ca)]
        rb = [x.to(cuda_device) for x in _run(b, cb)]
        got = tc.merge_counts(*ra, *rb, 5, 5)
        want = tc.merge_counts_ref(*ra, *rb, 5, 5)
        num = int(want[2][0])
        assert torch.equal(got[2], want[2]) and torch.equal(got[0][:num], want[0][:num])
        assert torch.equal(got[1][:num], want[1][:num])
        assert torch.equal(got[3][:num], want[3][:num])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_chunked_build_on_the_card(cuda_device, monkeypatch, tmp_path):
    path = _write_fastq(tmp_path / "a.fastq", READS)
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cuda")
    before = kernels.launch_counts()
    rec = tmb.build_bloom_device(path, _opts(31, 3), FilterInfo(), chunk_bp=3000)
    after = kernels.launch_counts()
    assert after["run_counts"] > before["run_counts"]
    assert after["merge_counts"] > before["merge_counts"]
    assert rec.bits.tobytes() == _jax_build(31, 3).bits.tobytes()


@pytest.mark.cuda
def test_builds_in_threads_share_a_full_card(cuda_device, monkeypatch, tmp_path):
    """With most of the card taken, 4 builds at once whose chunks are sized
    from what is left all fit (each sizes its chunk at its turn) and equal
    the JAX package's."""
    path = _write_fastq(tmp_path / "a.fastq", READS)
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cuda")
    free = tmb._card_free_bytes(cuda_device)
    ballast = torch.empty(max(0, free - (64 << 20)), dtype=torch.uint8, device=cuda_device)
    with ThreadPoolExecutor(4) as pool:
        recs = list(pool.map(
            lambda src: tmb.build_bloom_device(src, _opts(31, 3), FilterInfo()),
            [path, iter(READS), path, iter(READS)]))
    del ballast
    assert all(r.bits.tobytes() == _jax_build(31, 3).bits.tobytes() for r in recs)

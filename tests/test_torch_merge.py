"""The port's device build of big accessions (kwage_tpu_torch.ops.counting
run_counts / merge_counts and pipeline.make_bloom.build_bloom_device)
against kwage_tpu's numpy merge of sorted runs, its chunked device build
on the JAX CPU backend, and the exact ground truth. The CUDA kernels'
logic (csrc/merge.cu: the ballots that number a tile's starts, the halo
and the runs past it, the partition and its moved splits, the stage
layout of a merge tile, the serial merge and its saturating add, the
look-back over a mix of published counts and prefixes) is held here by a
numpy emulation at small tiles; the ``cuda`` tests hold the kernels against
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

def _walk_back(lookback, tile, lanes, rows):
    """walk_back: the published counts from tile - 1 down, ``lanes`` tiles a
    row and up to ``rows`` rows a step, to the nearest inclusive prefix
    (a row waits only where no nearer row has one: every count it reads
    here must be published)."""
    before, top = 0, tile - 1
    while True:
        for r in range(rows):
            vals = [lookback[q] if q >= 0 else ("prefix", 0)
                    for q in (top - (r * lanes + lane) for lane in range(lanes))]
            assert all(v is not None for v in vals), "a count read before it was published"
            prefixes = [lane for lane, v in enumerate(vals) if v[0] == "prefix"]
            stop = prefixes[0] if prefixes else lanes - 1
            before += sum(v[1] for v in vals[: stop + 1])
            if prefixes:
                return before
        top -= rows * lanes


def _store(staged, lookback, cap, min_count, lanes, rows, seed):
    """The storers: each tile's place by the look-back, in an order that
    mixes published aggregates and prefixes (a random order; every tile's
    count was published by its consumers first), its counts (positions:
    the distance to the next start, up to cap; the last run's as counted)
    and flags. Returns (words, counts, num, kept, flags)."""
    tiles = len(staged)
    out = {}
    for t in np.random.default_rng(seed).permutation(tiles).tolist():
        words, vals, positions, last = staged[t]
        before = _walk_back(lookback, t, lanes, rows) if t else 0
        lookback[t] = ("prefix", before + len(words))
        counts = [last if r + 1 == len(vals) else min(vals[r + 1] - vals[r], cap)
                  for r in range(len(vals))] if positions else list(vals)
        for r, (w, c) in enumerate(zip(words, counts)):
            out[before + r] = (w, c)
    num = len(out)
    assert sorted(out) == list(range(num))
    words = [out[r][0] for r in range(num)]
    counts = [out[r][1] for r in range(num)]
    flags = [c >= min_count for c in counts] if min_count else None
    return words, counts, num, sum(flags) if flags else 0, flags


def _emulate_run_counts(words, weights, cap, min_count, lanes, ipt, warps=2, halo=4, rows=2,
                        bulk=True, seed=0):
    """run_counts_kernel, tile by tile: tiles of warps x lanes x ipt
    positions, lane l of warp w holding positions w * lanes * ipt + i *
    lanes + l; a bulk tile (a whole one, inputs aligned) comes with the
    word before it and a halo of up to ``halo`` positions (fewer: a
    multiple of 4). Starts by the word before each, numbered by the warps'
    ballots and a scan of the warp totals; unit weights stage each start's
    position (the storers subtract) and count the tile's last run past the
    tile (halo, then the array); weights sum each run the same way. Then
    the storers (``_store``)."""
    words = [int(x) for x in words]
    wt = None if weights is None else [int(x) for x in weights]
    n, tile = len(words), warps * lanes * ipt
    tiles = -(-n // tile)
    lookback, staged = [None] * tiles, []
    for t in range(tiles):
        base = t * tile
        length = min(tile, n - base)
        h = 0
        if bulk and base + tile <= n:
            h = n - base - tile
            h = halo if h >= halo else h & ~3
        reach = length + h

        def w_at(j):                      # the stage: W[-1 .. reach - 1]
            assert -1 <= j < reach and base + j >= 0
            return words[base + j]

        runs = {}                         # run number in the tile -> its start
        warp_totals = []
        ballots = {}
        for w in range(warps):
            for i in range(ipt):
                bits = 0
                for lane in range(lanes):
                    j = w * lanes * ipt + i * lanes + lane
                    if j < length and (base + j == 0 or w_at(j) != w_at(j - 1)):
                        bits |= 1 << lane
                ballots[w, i] = bits
            warp_totals.append(sum(bin(ballots[w, i]).count("1") for i in range(ipt)))
        warp_first = np.concatenate([[0], np.cumsum(warp_totals)[:-1]]).tolist()
        total = sum(warp_totals)
        for w in range(warps):
            run = warp_first[w]
            for i in range(ipt):
                for lane in range(lanes):
                    if ballots[w, i] >> lane & 1:
                        runs[run + bin(ballots[w, i] & ((1 << lane) - 1)).count("1")] = \
                            w * lanes * ipt + i * lanes + lane
                run += bin(ballots[w, i]).count("1")
        starts = [runs[r] for r in range(total)]
        assert starts == sorted(starts)   # the ballots number starts in position order
        lookback[t] = ("prefix" if t == 0 else "aggregate", total)

        def run_sum(j, start_sum, step):
            """A run's sum from position q = j + 1 on: the stage, then the
            array, up to cap."""
            s, q = start_sum, j + 1
            while s < cap and q < reach and w_at(q) == w_at(j):
                s, q = s + step(base + q), q + 1
            if q == reach:
                g = base + reach
                while s < cap and g < n and words[g] == w_at(j):
                    s, g = s + step(g), g + 1
            return min(s, cap)

        if wt is None:
            j = starts[-1] if starts else None
            last = None
            if starts:
                # run_tail: the last run to the tile's end, then past it.
                s, q = length - j, length
                while s < cap and q < reach and w_at(q) == w_at(j):
                    s, q = s + 1, q + 1
                if q == reach:
                    g = base + reach
                    while s < cap and g < n and words[g] == w_at(j):
                        s, g = s + 1, g + 1
                last = min(s, cap)
            staged.append(([w_at(j) for j in starts], starts, True, last))
        else:
            staged.append(([w_at(j) for j in starts],
                           [run_sum(j, wt[base + j], lambda g: wt[g]) for j in starts],
                           False, None))
    return _store(staged, lookback, cap, min_count, lanes, rows, seed)


def _merge_path(a, b, d):
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] <= b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _partition(wa, wb, d, probes):
    """merge_partition_kernel's search at diagonal d: ``probes`` a step,
    each the last index of its part of the range (one at or past hi counts
    as above), the first part above holds the answer."""
    lo, hi = max(0, d - len(wb)), min(d, len(wa))
    while lo < hi:
        step = -(-(hi - lo) // probes)
        above = [q >= hi or wa[q] > wb[d - 1 - q]
                 for q in (lo + (k + 1) * step - 1 for k in range(probes))]
        if not any(above):
            lo = hi
            break
        f = above.index(True)
        lo, hi = lo + f * step, min(lo + (f + 1) * step - 1, hi)
    return lo


def _pieces(a0, b0, la):
    """Pieces: where a tile's words and counts of A and B sit in its stage."""
    oaw = a0 & 1
    obw = ((oaw + la + 1) & ~1) + (b0 & 1)
    oac = a0 & 3
    obc = ((oac + la + 3) & ~3) + (b0 & 3)
    return oaw, obw, oac, obc


def _load_piece(stage, owner, tag, off, src, lo, hi, per, bulk):
    """load_piece into ``stage`` (element e at off + e - lo): with ``bulk``,
    the 16-byte chunks (``per`` elements) holding [lo, hi) but the array's
    last, partial one, and plain loads of the rest; else plain loads."""
    if lo >= hi:
        return
    size = len(src)
    elems = range(lo, hi)
    if bulk:
        clo, end = lo // per * per, size // per * per
        chi = min(-(-hi // per) * per, end)
        elems = list(range(clo, chi)) + list(range(max(chi, lo), hi))
    for e in elems:
        i = off + e - lo
        assert 0 <= i < len(stage), (i, len(stage))
        assert owner[i] in (None, tag), "a copy overwrote the other piece"
        stage[i], owner[i] = src[e], tag


def _emulate_merge(wa, ca, wb, cb, cap, min_count, threads, ipt, probes=4, lanes=2, rows=2,
                   bulk=True, seed=0):
    """merge_partition_kernel + merge_counts_kernel: the splits at
    diagonals threads x ipt apart (moved one pair of B on where they would
    part a word of both runs), each tile's pieces copied into a stage as
    the producer lays them out, each thread's merge path there and its
    serial merge of ipt outputs, a word of both runs taking B's count too
    (saturating at cap), a block scan in thread order; then the storers
    (``_store``)."""
    wa, wb = [int(x) for x in wa], [int(x) for x in wb]
    ca, cb = [int(x) for x in ca], [int(x) for x in cb]
    n, tile = len(wa) + len(wb), threads * ipt
    tiles = -(-n // tile)
    split = []
    for i in range(tiles + 1):
        d = min(i * tile, n)
        a = _partition(wa, wb, d, probes)
        assert a == _merge_path(wa, wb, d)
        b = d - a
        if a > 0 and b < len(wb) and wa[a - 1] == wb[b]:
            b += 1
        split.append((a, b))
    lookback, staged = [None] * tiles, []
    for t in range(tiles):
        (a0, b0), (a1, b1) = split[t], split[t + 1]
        la, lb = a1 - a0, b1 - b0
        length = la + lb
        assert 0 <= length <= tile + 1
        oaw, obw, oac, obc = _pieces(a0, b0, la)
        sw, sc = [None] * (tile + 8), [None] * (tile + 16)
        ow_, oc_ = [None] * len(sw), [None] * len(sc)
        _load_piece(sw, ow_, "a", oaw, wa, a0, a1, 2, bulk)
        _load_piece(sw, ow_, "b", obw, wb, b0, b1, 2, bulk)
        _load_piece(sc, oc_, "a", oac, ca, a0, a1, 4, bulk)
        _load_piece(sc, oc_, "b", obc, cb, b0, b1, 4, bulk)
        A, B = sw[oaw: oaw + la], sw[obw: obw + lb]
        CA, CB = sc[oac: oac + la], sc[obc: obc + lb]
        assert A == wa[a0:a1] and B == wb[b0:b1] and CA == ca[a0:a1] and CB == cb[b0:b1]
        items = []                         # (word, count) of each thread's starts
        for th in range(threads):
            dt = min(th * ipt, length)
            ia = _merge_path(A, B, dt)
            ib = dt - ia
            have_prev = dt > 0
            prev = max(([A[ia - 1]] if ia else []) + ([B[ib - 1]] if ib else []), default=0)
            mine = []
            for i in range(ipt):
                if dt + i >= length:
                    break
                take_a = ib >= lb or (ia < la and A[ia] <= B[ib])
                word = A[ia] if take_a else B[ib]
                if not have_prev or word != prev:
                    c = CA[ia] + (CB[ib] if ib < lb and B[ib] == word else 0) if take_a \
                        else CB[ib]
                    mine.append((word, min(c, cap)))
                prev, have_prev = word, True
                ia, ib = (ia + 1, ib) if take_a else (ia, ib + 1)
            items += mine
        lookback[t] = ("prefix" if t == 0 else "aggregate", len(items))
        staged.append(([w for w, _ in items], [c for _, c in items], False, None))
    return _store(staged, lookback, cap, min_count, lanes, rows, seed)


TILES = [(1, 1), (2, 3), (4, 2), (8, 8)]   # (threads or lanes, positions a thread)


def _check_emulation(got, want):
    words, counts, num, kept, selected = got
    assert num == int(want[2][0]) and kept == int(want[2][1])
    assert words == want[0][:num].tolist() and counts == want[1][:num].tolist()
    if want[3] is not None:
        assert selected == want[3][:num].tolist()


@pytest.mark.parametrize("threads,ipt", TILES)
@pytest.mark.parametrize("case", MERGE_CASES + ["shifted", "equal_pair_at_every_edge",
                                                "saturating_add", "misaligned_head"])
def test_merge_emulation_matches_plain(case, threads, ipt):
    """The merge kernel's partition, stage layout, merge and fold,
    emulated at tiles of 1-64 outputs: equal words on both sides of a tile
    edge (the split moves), empty and identical runs, k = 32 signed words,
    counts that saturate on the add, a head off a 16-byte boundary (plain
    loads, the scalar tile)."""
    bulk = True
    if case == "shifted":     # A = 0..n-1, B = 1..n: every pair on both sides of an edge
        a = np.arange(0, 97, dtype=np.uint64)
        b = a + np.uint64(1)
        ca, cb = np.full(a.size, 3), np.full(b.size, 4)
    elif case == "equal_pair_at_every_edge":
        # A = 0..n-1, B = 1..n-1: A_j at merge position 2j - 1, B_j at 2j, so
        # every even diagonal falls between a word's two copies.
        a = np.arange(0, 97, dtype=np.uint64)
        b = a[1:].copy()
        ca, cb = np.full(a.size, 2), np.full(b.size, 4)
    elif case == "saturating_add":
        a, _, b, _ = _merge_case("overlap", 17)
        ca, cb = np.full(a.size, 4), np.full(b.size, 3)
    else:
        a, ca, b, cb = _merge_case("overlap" if case == "misaligned_head" else case, 17)
        bulk = case != "misaligned_head"
    ra, rb = _run(a, ca), _run(b, cb)
    for cap, min_count in ((CAP, 0), (5, 5)):
        want = tc.merge_counts_ref(*ra, *rb, cap, min_count)
        got = _emulate_merge(ra[0].numpy(), ra[1].numpy(), rb[0].numpy(), rb[1].numpy(), cap,
                             min_count, threads, ipt, bulk=bulk, seed=threads + ipt)
        _check_emulation(got, want)


@pytest.mark.parametrize("threads,ipt", TILES)
@pytest.mark.parametrize("layout", ["random", "long_runs", "one_run", "distinct", "k32",
                                    "across_the_halo", "misaligned_head", "cap_past_two_rows"])
def test_run_counts_emulation_matches_plain(layout, threads, ipt):
    """The run_counts kernel, emulated: runs that start, end and cross at
    lane, row, warp and tile edges, runs past a tile's halo into the next
    tiles (and past a ring stage), one run over every tile, no run longer
    than 1, inputs off a 16-byte boundary (the scalar tile), and a cap
    longer than two rows of a warp."""
    rng = np.random.default_rng(5)
    bulk, caps = True, ((CAP, 0), (5, 5), (1, 1))
    if layout == "random":
        words = np.sort(rng.integers(-40, 40, size=301))
    elif layout in ("long_runs", "misaligned_head"):
        words = np.repeat(np.arange(-4, 5), rng.integers(1, 90, size=9))
        bulk = layout == "long_runs"
    elif layout == "one_run":
        words = np.full(200, 7)
    elif layout == "distinct":
        words = np.arange(-100, 101)
    elif layout == "across_the_halo":
        # Runs of a tile and more (2 warps x lanes x ipt positions), halo 4.
        tile = 2 * threads * ipt
        words = np.repeat(np.arange(6), [tile + 5, 1, tile + 4, 3, 2 * tile + 9, 7])
    elif layout == "cap_past_two_rows":
        words = np.repeat(np.arange(12), rng.integers(1, 60, size=12))
        caps = ((2 * threads + 3, 2 * threads + 3), (40, 40))
    else:
        words = np.sort(_words(rng, 60, 32)[rng.integers(0, 60, size=250)].view(np.int64))
    words = words.astype(np.int64)
    weights = rng.integers(1, 4, size=words.size).astype(np.int32)
    for w in (None, weights):
        for cap, min_count in caps:
            want = tc.run_counts_ref(_t(words), None if w is None else _t(w), cap, min_count)
            _check_emulation(_emulate_run_counts(words, w, cap, min_count, threads, ipt,
                                                 bulk=bulk, seed=threads * ipt), want)


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
    """The kernels against their plain versions around their tiles' edges
    (tc.RUN_TILE positions; a tile's halo of 32), a cap past two rows of a
    warp, inputs 8 bytes off a 16-byte boundary, and merges with an equal
    pair at every tile edge."""
    rng = np.random.default_rng(9)
    tile = tc.RUN_TILE

    def same(got, want):
        num = int(want[2][0])
        assert torch.equal(got[2], want[2])
        assert torch.equal(got[0][:num], want[0][:num])
        assert torch.equal(got[1][:num], want[1][:num])
        if want[3] is not None:
            assert torch.equal(got[3][:num], want[3][:num])

    for n in (0, 1, tile - 1, tile, tile + 1, tile + 33, 3 * tile + 5, 1 << 20):
        for k in (31, 32):
            words = torch.sort(_t(_words(rng, max(n // 3, 1), k).view(np.int64)[
                rng.integers(0, max(n // 3, 1), size=n)])).values.to(cuda_device)
            for cap, m in ((CAP, 0), (5, 5), (40, 40)):
                same(tc.run_counts(words, None, cap, m), tc.run_counts_ref(words, None, cap, m))
            if n > 1:
                same(tc.run_counts(words[1:], None, 5, 5), tc.run_counts_ref(words[1:], None, 5, 5))
    for case in MERGE_CASES:
        a, ca, b, cb = _merge_case(case, 23)
        ra = [x.to(cuda_device) for x in _run(a, ca)]
        rb = [x.to(cuda_device) for x in _run(b, cb)]
        same(tc.merge_counts(*ra, *rb, 5, 5), tc.merge_counts_ref(*ra, *rb, 5, 5))
    for m in (tile, 3 * tile + 5):
        w = torch.arange(m, dtype=torch.int64, device=cuda_device)
        c = torch.full((m,), 3, dtype=torch.int32, device=cuda_device)
        same(tc.merge_counts(w, c, w[1:], c[1:], 5, 5), tc.merge_counts_ref(w, c, w[1:], c[1:], 5, 5))
        same(tc.merge_counts(w[1:], c[1:], w[2:], c[2:], CAP, 0),
             tc.merge_counts_ref(w[1:], c[1:], w[2:], c[2:], CAP, 0))
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


@pytest.mark.parametrize("source", ["strings", "fastq"])
def test_chunk_out_of_memory_retries_smaller(monkeypatch, source, tmp_path):
    """A chunk whose count runs out of device memory once (another process
    took it after the chunk was sized) is counted again at half its rows,
    the accumulator intact: the record is byte-equal to the JAX build's,
    and the process's halving counter reads 1. One row that does not fit
    raises."""
    real, calls = tmb.count_chunk, []
    tmb.reset_retry_counts()

    def short_of_memory(packed, *args, **kwargs):
        calls.append(packed.shape[0])
        if len(calls) == 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (a test)")
        return real(packed, *args, **kwargs)

    monkeypatch.setattr(tmb, "count_chunk", short_of_memory)
    src = iter(READS) if source == "strings" else _write_fastq(tmp_path / "a.fastq", READS)
    rec = tmb.build_bloom_device(src, _opts(31, 3), FilterInfo(), chunk_bp=3000)
    want = _jax_build(31, 3)
    assert _same(rec.param, want.param) and rec.bits.tobytes() == want.bits.tobytes()
    assert calls[2] == (calls[1] + 1) // 2 and len(calls) > 3
    assert tmb.retry_counts() == {"halved": 1, "waited": 0}
    _, gt = _ground_truth(READS, 31, 3, rec.param.num_hash, rec.param.log_2_filter_len)
    assert rec.bits.tobytes() == gt.tobytes()

    def never(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (a test)")

    monkeypatch.setattr(tmb, "CARD_WAIT_S", 0.0)
    monkeypatch.setattr(tmb, "count_chunk", never)
    tmb.reset_retry_counts()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tmb.build_bloom_device(iter(READS), _opts(31, 3), FilterInfo(), chunk_bp=3000)
    assert tmb.retry_counts()["waited"] == tmb.CARD_WAITS


@pytest.mark.parametrize("source", ["strings", "fastq"])
def test_one_row_out_of_memory_waits(monkeypatch, source, tmp_path):
    """A chunk that runs out of device memory down to one row (a merge the
    size of the accumulator, while another process holds the rest) waits
    and tries again, twice here, then goes on: the record equals the exact
    ground truth."""
    real, state = tmb.count_chunk, {"calls": 0, "at_one": 0}

    def short_at_one_row(packed, *args, **kwargs):
        state["calls"] += 1
        if state["calls"] >= 2 and state["at_one"] < 2:
            if packed.shape[0] == 1:
                state["at_one"] += 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (a test)")
        return real(packed, *args, **kwargs)

    monkeypatch.setattr(tmb, "count_chunk", short_at_one_row)
    tmb.reset_retry_counts()
    src = iter(READS) if source == "strings" else _write_fastq(tmp_path / "a.fastq", READS)
    rec = tmb.build_bloom_device(src, _opts(31, 3), FilterInfo(), chunk_bp=3000)
    _, gt = _ground_truth(READS, 31, 3, rec.param.num_hash, rec.param.log_2_filter_len)
    assert rec.bits.tobytes() == gt.tobytes()
    counts = tmb.retry_counts()
    assert counts["waited"] == 2 and counts["halved"] >= 1


def test_merge_roles_patches_the_kernels():
    """kernels/merge_roles.py's counters find every border they time in
    csrc/merge.cu (it raises when the source has moved on)."""
    from kwage_tpu_torch.kernels import merge_roles

    src = merge_roles.patched_source()
    assert src.count("atomicAdd(prof + ") == 17

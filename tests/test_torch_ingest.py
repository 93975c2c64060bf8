"""The port's device ingest (kwage_tpu_torch.ops.{kmers,hashing,counting}
and pipeline.make_bloom) against kwage_tpu on the JAX CPU backend, the
native host code and exact ground truth. Integer and bit outputs: every
comparison is exact equality. On the CPU every kernel wrapper runs its
plain PyTorch version; the ``cuda`` tests hold the kernels against those
on a card."""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwage_tpu.core import FilterInfo
from kwage_tpu.core.words import canonical_kmers as host_canonical_kmers
from kwage_tpu.native import murmur32_native
from kwage_tpu.ops import counting as jc
from kwage_tpu.ops import hashing as jh
from kwage_tpu.ops import kmers as jk
from kwage_tpu.pipeline import BuildOptions
from kwage_tpu.pipeline import make_bloom as jmb
from kwage_tpu_torch import kernels
from kwage_tpu_torch.ops import counting as tc
from kwage_tpu_torch.ops import hashing as th
from kwage_tpu_torch.ops import kmers as tk
from kwage_tpu_torch.ops.search import tensor_to_words, words_to_tensor
from kwage_tpu_torch.pipeline import make_bloom as tmb

CPU = torch.device("cpu")


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


def _read_batch(seed, R, L, n_frac=0.02):
    """ASCII reads uint8 [R, L] with ~n_frac N bases, a lower-case base
    and, given the rows, a zero-padded tail and a read of all N."""
    rng = np.random.default_rng(seed)
    b = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(R, L))].copy()
    b[rng.random((R, L)) < n_frac] = ord("N")
    b[0, 3] = ord("g")
    b[1:2, L - 7 :] = 0
    b[2:3] = ord("N")
    return b


def _jax_words(hi, lo):
    return tk.words_to_u64(np.asarray(hi), np.asarray(lo))


# --- kmers ------------------------------------------------------------------------

def test_host_twins_match_jax():
    b = _read_batch(1, 5, 77)
    for got, want in zip(tk.pack_reads_host(b), jk.pack_reads_host(b)):
        np.testing.assert_array_equal(got, want)
    w = np.random.default_rng(2).integers(0, 2**64, size=50, dtype=np.uint64)
    for got, want in zip(tk.u64_to_words(w), jk.u64_to_words(w)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tk.words_to_u64(*tk.u64_to_words(w)), w)
    np.testing.assert_array_equal(tk.tensor_to_words_u64(tk.words_u64_to_tensor(w, CPU)), w)


@pytest.mark.parametrize("k", [15, 16, 31, 32])
def test_canonical_kmers_packed_matches_jax(k):
    b = _read_batch(k, 6, 150)
    packed, vw = jk.pack_reads_host(b)
    hi, lo, valid = jax.vmap(lambda p, v: jk.canonical_kmers_packed_device(p, v, k, 150))(
        jnp.asarray(packed), jnp.asarray(vw))
    words, tvalid = tk.canonical_kmers_packed(
        words_to_tensor(packed, CPU), words_to_tensor(vw, CPU), k, 150)
    np.testing.assert_array_equal(tk.tensor_to_words_u64(words), _jax_words(hi, lo))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    assert tvalid.any() and not tvalid.all()
    # One read (1-D input) gives the same row.
    w0, v0 = tk.canonical_kmers_packed(words_to_tensor(packed[3], CPU),
                                       words_to_tensor(vw[3], CPU), k, 150)
    assert torch.equal(w0, words[3]) and torch.equal(v0, tvalid[3])


@pytest.mark.parametrize("k", [15, 16, 31, 32])
def test_canonical_kmers_ascii_matches_jax_and_host(k):
    seq = _read_batch(100 + k, 1, 203)[0]
    hi, lo, valid = jk.canonical_kmers_device(jnp.asarray(seq), k)
    words, tvalid = tk.canonical_kmers(torch.from_numpy(seq), k)
    np.testing.assert_array_equal(tk.tensor_to_words_u64(words), _jax_words(hi, lo))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    want = host_canonical_kmers(seq.tobytes(), k)
    np.testing.assert_array_equal(tk.tensor_to_words_u64(words[tvalid]), want)


def _edge_reads(length, seed):
    """ASCII reads uint8 [6, length]: an N at the first, the last, the 16th
    and the 32nd base (one row each), a lower-case row, a clean row."""
    rng = np.random.default_rng(seed)
    b = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(6, length))].copy()
    b[0, 0] = b[1, -1] = b[2, min(15, length - 1)] = b[3, min(31, length - 1)] = ord("N")
    b[4] = np.frombuffer(b"acgt", np.uint8)[rng.integers(0, 4, size=length)]
    return b


@pytest.mark.parametrize("k,length", [(k, n) for n in (17, 33, 255, 257)
                                      for k in (1, 15, 16, 17, 31, 32) if k <= n])
def test_canonical_kmers_edges_match_jax(k, length):
    """The shapes the window-slice kernel makes risky, on the CPU through
    both wrappers (their plain versions) against the JAX functions: k at
    1 and around the 32- and 64-bit word boundaries, lengths that end inside
    a packed word, an N at the first, last, 16th and 32nd base, lower case."""
    b = _edge_reads(length, 1000 * k + length)
    packed, vw = jk.pack_reads_host(b)
    hi, lo, valid = jax.vmap(lambda p, v: jk.canonical_kmers_packed_device(p, v, k, length))(
        jnp.asarray(packed), jnp.asarray(vw))
    want_words, want_valid = _jax_words(hi, lo), np.asarray(valid)
    words, tvalid = tk.canonical_kmers_packed(
        words_to_tensor(packed, CPU), words_to_tensor(vw, CPU), k, length)
    np.testing.assert_array_equal(tk.tensor_to_words_u64(words), want_words)
    np.testing.assert_array_equal(tvalid.numpy(), want_valid)
    a_words, a_valid = tk.canonical_kmers(torch.from_numpy(b), k)
    np.testing.assert_array_equal(tk.tensor_to_words_u64(a_words), want_words)
    np.testing.assert_array_equal(a_valid.numpy(), want_valid)
    for row in range(b.shape[0]):
        hi1, lo1, valid1 = jk.canonical_kmers_device(jnp.asarray(b[row]), k)
        np.testing.assert_array_equal(_jax_words(hi1, lo1), want_words[row])
        np.testing.assert_array_equal(np.asarray(valid1), want_valid[row])
    assert not want_valid[0, 0] and not want_valid[1, -1] and want_valid[4].all()
    assert want_valid[5].all()


def _every_byte_batch(seed):
    """ASCII reads uint8 [4, 160] whose last two rows hold every byte value."""
    b = _read_batch(seed, 4, 160)
    b[2:, :128] = np.arange(256, dtype=np.uint8).reshape(2, 128)
    b[2, 40:90] = np.frombuffer(b"acgtACGT", np.uint8)[np.arange(50) % 8]
    return b


@pytest.mark.parametrize("k", [15, 16, 31, 32])
def test_canonical_kmers_ascii_batch_matches_packed_and_jax(k):
    """The ASCII route over a batch holding every byte value equals the
    packed route over the host pack of the same bytes, and JAX's
    canonical_kmers_device row by row."""
    b = _every_byte_batch(300 + k)
    words, valid = tk.canonical_kmers(torch.from_numpy(b), k)
    packed, vw = tk.pack_reads_host(b)
    p_words, p_valid = tk.canonical_kmers_packed(words_to_tensor(packed, CPU),
                                                 words_to_tensor(vw, CPU), k, b.shape[1])
    assert torch.equal(words, p_words) and torch.equal(valid, p_valid)
    hi, lo, j_valid = jax.vmap(lambda r: jk.canonical_kmers_device(r, k))(jnp.asarray(b))
    np.testing.assert_array_equal(tk.tensor_to_words_u64(words), _jax_words(hi, lo))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    assert valid[2].any() and not valid[3, : 129 - k].any()  # bytes 128-255: no base


def test_canonical_kmers_rejects_bad_input():
    with pytest.raises(ValueError, match="shorter than k"):
        tk.canonical_kmers(torch.zeros(10, dtype=torch.uint8), 31)
    with pytest.raises(ValueError, match="uint8"):
        tk.canonical_kmers(torch.zeros(40, dtype=torch.int32), 31)


# --- hashing ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32])
@pytest.mark.parametrize("nh", [1, 5, 8])
def test_murmur32_matches_jax_and_native(k, nh):
    rng = np.random.default_rng(k * 10 + nh)
    top = np.uint64(2**64 - 1) if k == 32 else np.uint64((1 << (2 * k)) - 1)
    words = rng.integers(0, 2**64, size=300, dtype=np.uint64) & top
    words[:3] = [0, top, 1]
    hi, lo = jk.u64_to_words(words)
    got = tensor_to_words(th.murmur32(tk.words_u64_to_tensor(words, CPU), k, nh))
    np.testing.assert_array_equal(
        got, np.asarray(jh.murmur32_device(jnp.asarray(hi), jnp.asarray(lo), k, nh)))
    np.testing.assert_array_equal(got, murmur32_native(words, k, nh))
    for L in (7, 22, 31, 32):
        idx = th.slice_indices(tk.words_u64_to_tensor(words, CPU), k, nh, L)
        want = jh.slice_indices_device(jnp.asarray(hi), jnp.asarray(lo), k, nh, L)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want))


_REV8 = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], dtype=np.uint8)
_U32 = np.uint32


def _byte_perm(x, sel):
    """CUDA's __byte_perm(x, 0, sel) on uint32 arrays, for selector nibbles
    0-7 (no sign mode): byte n of the result is byte (nibble n of sel) of
    the 8 bytes {0, x}."""
    x, sel = np.broadcast_arrays(_U32(x), _U32(sel))
    src = np.stack([(x >> _U32(8 * j)) & _U32(0xFF) for j in range(4)] + [np.zeros_like(x)] * 4)
    out = np.zeros(x.shape, _U32)
    for n in range(4):
        pick = ((sel >> _U32(4 * n)) & _U32(7)).astype(np.int64)
        out |= np.take_along_axis(src, pick[None], 0)[0] << _U32(8 * n)
    return out


def _rotl(x, r):
    return (x << _U32(r)) | (x >> _U32(32 - r))


def _murmur_k_emulation(words, k, nh):
    """numpy emulation of csrc/murmur.cuh's murmur_blocks_k<K> and
    murmur_seed_k<K> (the murmur32 kernel's instances): the word's bits
    reversed, so that block b is byte b and each base's two bits are
    swapped; two blocks' bytes spread to nibbles a byte permute and two
    masked shifts; one byte permute a block to ASCII ("AGCT" for the
    swapped codes). -> uint32 [n, nh]."""
    rev = _REV8[words.view(np.uint8)].view(np.uint64).byteswap()
    r = rev >> np.uint64(64 - 2 * k)
    nblocks = (k + 3) // 4
    blocks = []
    for b in range(0, nblocks, 2):
        half = (r >> np.uint64(32 if b >= 4 else 0)).astype(_U32)
        s = _byte_perm(half, 0x4342 if b & 2 else 0x4140)
        s = (s | (s << _U32(4))) & _U32(0x0F0F0F0F)
        s = (s | (s << _U32(2))) & _U32(0x33333333)
        for j, sel in ((b, s), (b + 1, s >> _U32(16))):
            if j < nblocks:
                m = _byte_perm(0x54434741, sel)
                if k & 3 and j == k // 4:
                    m &= _U32((1 << (8 * (k & 3))) - 1)
                blocks.append(_rotl(m * _U32(0xCC9E2D51), 15) * _U32(0x1B873593))
    h = np.broadcast_to(np.arange(nh, dtype=_U32), (words.shape[0], nh)).copy()
    for b in range(k // 4):
        h = _rotl(h ^ blocks[b][:, None], 13) * _U32(5) + _U32(0xE6546B64)
    if k & 3:
        h ^= blocks[k // 4][:, None]
    h ^= _U32(k)
    h = (h ^ (h >> _U32(16))) * _U32(0x85EBCA6B)
    h = (h ^ (h >> _U32(13))) * _U32(0xC2B2AE35)
    return h ^ (h >> _U32(16))


@pytest.mark.parametrize("k", range(1, 33))
def test_murmur_k_emulation_matches_native_and_ref(k):
    """The murmur32 kernel's decode with k fixed at compile time (bit
    reversal, nibble spread, byte permutes), emulated, gives the native
    hash and murmur32_ref at every k the kernel has an instance for."""
    rng = np.random.default_rng(k)
    top = np.uint64(2**64 - 1) if k == 32 else np.uint64((1 << (2 * k)) - 1)
    words = rng.integers(0, 2**64, size=200, dtype=np.uint64) & top
    words[:3] = [0, top, 1]
    got = _murmur_k_emulation(words, k, 3)
    np.testing.assert_array_equal(got, murmur32_native(words, k, 3))
    np.testing.assert_array_equal(
        got, tensor_to_words(th.murmur32_ref(tk.words_u64_to_tensor(words, CPU), k, 3)))


# --- counting and filter bits -------------------------------------------------------

def _accession_batch(seed, num_acc=4, reads_per=12, L=128):
    """Reads of num_acc accessions with repeats (so min_count > 1 keeps
    words), N bases, and padding rows: (ascii [R, L], acc_ids int32 [R])."""
    rng = np.random.default_rng(seed)
    rows, accs = [], []
    for a in range(num_acc):
        uniq = _read_batch(seed * 7 + a, reads_per, L, n_frac=0.01)
        reps = uniq[rng.integers(0, reads_per, size=reads_per // 2)]
        rows += [uniq, reps, reps[: reads_per // 3]]
        accs += [a] * (reads_per + reads_per // 2 + reads_per // 3)
    b = np.concatenate(rows)
    b[-1] = b[0]  # the same read in two accessions
    pad = (-b.shape[0]) % 64
    acc = np.array(accs + [0] * pad, np.int32)
    return np.concatenate([b, np.zeros((pad, L), np.uint8)]), acc


def _jax_count(b, acc, k, min_count, num_acc):
    packed, vw = jk.pack_reads_host(b)
    return jc.count_kmers_device_multi_packed(
        jnp.asarray(packed), jnp.asarray(vw), jnp.asarray(acc), k, min_count, num_acc,
        b.shape[1])


@pytest.mark.parametrize("min_count", [1, 3, 5])
def test_count_multi_matches_jax(min_count):
    k, num_acc = 31, 4
    b, acc = _accession_batch(min_count, num_acc)
    acc_s, hi_s, lo_s, sel, nv = _jax_count(b, acc, k, min_count, num_acc)
    t_acc, t_words, t_sel, t_nv = tc.count_kmers_multi(b, torch.from_numpy(acc), k,
                                                       min_count, num_acc)
    np.testing.assert_array_equal(t_nv.numpy(), np.asarray(nv))
    assert t_nv.sum() > 0
    sel = np.asarray(sel)
    want = sorted(zip(np.asarray(acc_s)[sel].tolist(),
                      _jax_words(np.asarray(hi_s)[sel], np.asarray(lo_s)[sel]).tolist()))
    got = sorted(zip(t_acc[t_sel].tolist(), tk.tensor_to_words_u64(t_words[t_sel]).tolist()))
    assert got == want


@pytest.mark.parametrize("min_count", [1, 3])
@pytest.mark.parametrize("k", [15, 16, 31])
def test_count_multi_keeps_the_valid_windows_only(k, min_count):
    """The fused count hands select_runs and bloom_set_bits the valid
    windows alone (padding rows, N bases and read tails dropped by the
    sort): kwage_tpu's sorted arrays up to its valid prefix, and the same
    selection."""
    num_acc = 4
    b, acc = _accession_batch(k + min_count, num_acc)
    acc_s, hi_s, lo_s, sel, nv = _jax_count(b, acc, k, min_count, num_acc)
    n_valid = int((np.asarray(acc_s) < num_acc).sum())
    assert 0 < n_valid < acc_s.shape[0]
    t_acc, t_words, t_sel, t_nv = tc.count_kmers_multi(b, torch.from_numpy(acc), k, min_count,
                                                       num_acc)
    assert t_acc.shape == t_words.shape == t_sel.shape == (n_valid,)
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(acc_s)[:n_valid])
    np.testing.assert_array_equal(tk.tensor_to_words_u64(t_words),
                                  _jax_words(hi_s, lo_s)[:n_valid])
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(sel)[:n_valid])
    assert not np.asarray(sel)[n_valid:].any()
    np.testing.assert_array_equal(t_nv.numpy(), np.asarray(nv))


@pytest.mark.parametrize("min_count", [1, 3])
def test_single_accession_count_and_filter_match_jax(min_count):
    """count_kmers / build_filter_device against count_kmers_device /
    build_filter_device over one ASCII batch."""
    b, _ = _accession_batch(min_count + 30, 1)
    hi_s, lo_s, sel, nv, nw = jc.count_kmers_device(jnp.asarray(b), 31, min_count)
    words_s, t_sel, t_nv, t_nw = tc.count_kmers(b, 31, min_count, CPU)
    assert (t_nv, t_nw) == (int(nv), int(nw))
    sel = np.asarray(sel)
    np.testing.assert_array_equal(
        np.sort(tk.tensor_to_words_u64(words_s[t_sel])),
        np.sort(_jax_words(np.asarray(hi_s)[sel], np.asarray(lo_s)[sel])))
    want = jc.build_filter_device(jnp.asarray(b), 31, min_count, 4, 13)
    got = tc.build_filter_device(b, 31, min_count, 4, 13, CPU)
    np.testing.assert_array_equal(tensor_to_words(got), np.asarray(want))


def test_select_runs_edges():
    """Runs that touch the end, cross an accession change, and an invalid
    tail; min_count larger than the input."""
    acc = torch.tensor([0, 0, 0, 1, 1, 1, 2, 2, 3, 3], dtype=torch.int64)
    words = torch.tensor([5, 5, 7, 7, 7, 7, 1, 1, 9, 9], dtype=torch.int64)
    sel, nv = tc.select_runs(acc, words, 3, 2)
    assert sel.tolist() == [1, 0, 0, 1, 0, 0, 1, 0, 0, 0]
    assert nv.tolist() == [1, 1, 1]
    sel, nv = tc.select_runs(acc, words, 3, 3)
    assert sel.tolist() == [0, 0, 0, 1, 0, 0, 0, 0, 0, 0] and nv.tolist() == [0, 1, 0]
    sel, nv = tc.select_runs(acc, words, 3, 20)
    assert not sel.any() and nv.tolist() == [0, 0, 0]


# --- select_runs at the shapes where a tiled kernel can go wrong ------------------
# The kernel is held to select_runs_ref on the card, so the plain version is
# held to the JAX package here, on the same features at a small size: the
# "tile" is 32 positions.

EDGE_TILE, EDGE_NUM_ACC = 32, 12


def _edge_pairs(seed, tile=EDGE_TILE, num_acc=EDGE_NUM_ACC):
    """Sorted (acc, word) pairs, numpy int64, 5 * tile + 5 of them: an
    accession boundary 3 positions into a tile; a run of 6 that starts on a
    tile's last position; 8 accessions of 2 positions inside one tile; a
    run of 5 that ends on a tile's first position; a run of tile + 10; an
    accession boundary on a tile edge; invalid pairs (acc == num_acc) last."""
    rng = np.random.default_rng(seed)
    runs, pos = [], 0

    def run(acc, length):
        nonlocal pos
        runs.append((acc, length))
        pos += length

    def fill_to(target, acc):
        while pos < target:
            run(acc, min(target - pos, int(rng.choice([1, 1, 2, 3, 5, 6]))))

    fill_to(3, 0)
    fill_to(tile - 1, 1)
    run(1, 6)
    for acc in range(2, 10):
        fill_to(pos + 2, acc)
    fill_to(2 * tile - 4, 10)
    run(10, 5)
    run(10, tile + 10)
    fill_to(4 * tile, 10)
    fill_to(5 * tile - 4, 11)
    run(num_acc, 9)
    assert pos == 5 * tile + 5
    accs, lengths = np.array(runs, dtype=np.int64).T
    return np.repeat(accs, lengths), np.repeat(np.arange(len(runs), dtype=np.int64) * 7919 + 5,
                                               lengths)


def _jax_select(acc, words, min_count, num_acc):
    """kwage_tpu's selection and counts over one (acc, word) pair a row; a
    pair whose accession is outside [0, num_acc) is an invalid window.
    Returns (selected (acc, word) pairs sorted, num_valid)."""
    valid = (acc >= 0) & (acc < num_acc)
    u = words.astype(np.uint64)
    acc_s, hi_s, lo_s, sel, nv = jc._count_multi_core(
        jnp.asarray((u >> np.uint64(32)).astype(np.uint32))[:, None],
        jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32))[:, None],
        jnp.asarray(valid)[:, None], jnp.asarray(np.where(valid, acc, 0).astype(np.int32)),
        min_count, num_acc)
    sel = np.asarray(sel)
    return (sorted(zip(np.asarray(acc_s)[sel].tolist(),
                       _jax_words(np.asarray(hi_s)[sel], np.asarray(lo_s)[sel]).tolist())),
            np.asarray(nv))


def _check_select_against_jax(acc, words, min_count, num_acc):
    sel, nv = tc.select_runs(torch.from_numpy(acc), torch.from_numpy(words), num_acc, min_count)
    if min_count > acc.shape[0]:   # kwage_tpu cannot look past the end: no run is that long
        assert not sel.any() and not nv.any()
        return sel.numpy(), nv
    want, want_nv = _jax_select(acc, words, min_count, num_acc)
    np.testing.assert_array_equal(nv.numpy(), want_nv)
    sel = sel.numpy()
    assert sorted(zip(acc[sel].tolist(), words[sel].astype(np.uint64).tolist())) == want
    return sel, nv


@pytest.mark.parametrize("min_count", [1, 2, 5, EDGE_TILE + 3])
@pytest.mark.parametrize("n", [1, EDGE_TILE - 1, EDGE_TILE, EDGE_TILE + 1, 3 * EDGE_TILE + 5,
                               5 * EDGE_TILE + 5])
def test_select_runs_ref_matches_jax_at_tile_edges(n, min_count):
    acc, words = _edge_pairs(n * 31 + min_count)
    sel, nv = _check_select_against_jax(acc[:n], words[:n], min_count, EDGE_NUM_ACC)
    if n == acc.shape[0]:
        assert sel[2 * EDGE_TILE + 1] and nv.sum() > 0      # the run of tile + 10
        if min_count <= 5:
            assert sel[EDGE_TILE - 1] and sel[2 * EDGE_TILE - 4]   # the runs across tile edges
        if min_count == 1:
            assert (nv > 0).all()


def test_select_runs_ref_invalid_accessions_match_jax():
    """Every position invalid; then negative accessions first and accessions
    past num_acc last, which the JAX package sees as invalid windows."""
    acc, words = _edge_pairs(3)
    sel, nv = _check_select_against_jax(np.full_like(acc, EDGE_NUM_ACC), words, 2, EDGE_NUM_ACC)
    assert not sel.any() and not nv.any()
    acc[:4] = -2
    words[:4] = 1
    acc[-3:] = EDGE_NUM_ACC + 2
    for min_count in (1, 2, 3):
        sel, nv = _check_select_against_jax(acc, words, min_count, EDGE_NUM_ACC)
        assert not sel[:4].any() and not sel[-9:].any() and nv.sum() > 0


def test_sort_windows_k32_signed_words():
    """At k=32 words with the top bit set sort as negative int64s: equal
    (acc, word) pairs are still adjacent and accessions are in order."""
    rng = np.random.default_rng(4)
    words = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=40, dtype=np.int64)[
        rng.integers(0, 10, size=400)])
    acc = torch.from_numpy(rng.integers(0, 4, size=400))
    acc_s, words_s = tc.sort_windows(acc, words)
    assert torch.equal(acc_s, torch.sort(acc).values)
    pairs = list(zip(acc_s.tolist(), words_s.tolist()))
    seen, prev = set(), None
    for p in pairs:
        assert p == prev or p not in seen
        seen.add(p)
        prev = p
    assert Counter(pairs) == Counter(zip(acc.tolist(), words.tolist()))


def test_bloom_set_bits_matches_jax():
    """The batched bit set against set_filter_bits_multi, with a dropped
    accession (slot -1), on the counted words of a real batch."""
    k, num_acc, nh, L = 31, 4, 3, 12
    b, acc = _accession_batch(9, num_acc)
    acc_s, hi_s, lo_s, sel, _ = _jax_count(b, acc, k, 2, num_acc)
    slot = np.array([0, -1, 2, 3, -1], np.int32)
    want = jc.set_filter_bits_multi(acc_s, hi_s, lo_s, sel, jnp.asarray(slot),
                                    k, nh, L, num_acc)
    t_acc, t_words, t_sel, _ = tc.count_kmers_multi(b, torch.from_numpy(acc), k, 2, num_acc)
    got = tc.bloom_set_bits(t_acc, t_words, t_sel, torch.from_numpy(slot), k, nh, L)
    np.testing.assert_array_equal(tensor_to_words(got), np.asarray(want))
    assert not got[1].any() and got[0].any()


def _native_image(words_u64, k, nh, L):
    out = np.zeros(max(1, (1 << L) // 8), np.uint8)
    idx = (murmur32_native(words_u64, k, nh) & np.uint32((1 << L) - 1)).reshape(-1)
    np.bitwise_or.at(out, (idx >> 3).astype(np.int64), np.uint8(1) << (idx & 7).astype(np.uint8))
    return out


@pytest.mark.parametrize("L", [3, 8, 11])
def test_bloom_set_bits_small_filters_match_native(L):
    """num_acc=3 with L < 12: the JAX version's _pack_bit_image raises on
    these shapes (n not a multiple of 4096); the port holds them against
    the native host hash."""
    k, nh = 31, 4
    rng = np.random.default_rng(L)
    words = rng.integers(0, 2**62, size=90, dtype=np.uint64)
    acc = np.repeat(np.arange(3), 30)
    sel = rng.random(90) < 0.7
    got = tc.bloom_set_bits(torch.from_numpy(acc), tk.words_u64_to_tensor(words, CPU),
                            torch.from_numpy(sel), torch.tensor([0, 1, 2, -1], dtype=torch.int32),
                            k, nh, L)
    for a in range(3):
        m = (acc == a) & sel
        np.testing.assert_array_equal(tc.filter_words_to_bytes(got[a], L),
                                      _native_image(words[m], k, nh, L))


# --- make_bloom: mirror of tests/test_counting_device.py ------------------------------

@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(5)
    uniq = ["".join(rng.choice(list("ACGT"), size=300)) for _ in range(10)]
    noisy = uniq[0][:120] + "N" + uniq[1][:100]
    return uniq + uniq[:5] + uniq[:5] + [noisy]


def _same(a, b) -> bool:
    """Equal fields: the port's BloomParam is a class of its own."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _opts(min_count, **kw):
    base = dict(kmer_len=31, min_kmer_count=min_count, false_positive_probability=0.25,
                min_log_2_filter_len=14, max_log_2_filter_len=20,
                min_log_2_count_len=18, max_log_2_count_len=20)
    base.update(kw)
    return BuildOptions(**base)


def _exact_filter(reads, k, min_count, num_hash, log2_len):
    counts = Counter()
    for r in reads:
        counts.update(host_canonical_kmers(r, k).tolist())
    words = np.array(sorted(w for w, c in counts.items() if c >= min_count), dtype=np.uint64)
    return words.shape[0], _native_image(words, k, num_hash, log2_len)


@pytest.mark.parametrize("min_count", [1, 3])
def test_device_build_matches_exact_ground_truth_and_jax(reads, min_count):
    rec = tmb.build_bloom_device(iter(reads), _opts(min_count), FilterInfo())
    _, gt = _exact_filter(reads, 31, min_count, rec.param.num_hash, rec.param.log_2_filter_len)
    assert rec.bits.tobytes() == gt.tobytes()
    assert rec.test_crc32()
    want = jmb.build_bloom_device(iter(reads), _opts(min_count), FilterInfo())
    assert _same(rec.param, want.param) and rec.bits.tobytes() == want.bits.tobytes()


def test_device_matches_host_parity_path(reads):
    opts = _opts(1)
    dev = tmb.build_bloom_device(iter(reads), opts, FilterInfo())
    host = jmb.build_bloom_from_sequences(iter(reads), opts, FilterInfo())
    assert _same(dev.param, host.param)
    assert dev.bits.tobytes() == host.bits.tobytes()


def test_streaming_chunks_merge_counts_across_batches(reads):
    whole = tmb.build_bloom_device(iter(reads), _opts(3), FilterInfo())
    chunked = tmb.build_bloom_device(iter(reads), _opts(3), FilterInfo(), chunk_bp=700)
    assert whole.param == chunked.param
    assert whole.bits.tobytes() == chunked.bits.tobytes()
    n_exact, _ = _exact_filter(reads, 31, 3, whole.param.num_hash, whole.param.log_2_filter_len)
    assert n_exact > 0


def test_device_build_large_filter_stays_on_device(reads):
    """L=31: the JAX version sets these bits on the host; the port's int64
    offsets keep them on the device. Equal to the host-parity builder."""
    opts = _opts(1, min_log_2_filter_len=31, max_log_2_filter_len=32)
    dev = tmb.build_bloom_device(iter(reads), opts, FilterInfo())
    assert dev.param.log_2_filter_len == 31
    host = jmb.build_bloom_from_sequences(iter(reads), opts, FilterInfo())
    assert _same(dev.param, host.param)
    assert dev.bits.tobytes() == host.bits.tobytes()
    assert dev.test_crc32()


def test_batched_device_build_matches_single_and_jax(reads):
    rng = np.random.default_rng(7)
    jobs, per_acc = [], []
    for _ in range(5):
        n = int(rng.integers(4, 9))
        seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(40, 200))))
                for _ in range(n)]
        seqs = seqs + seqs[:2]
        jobs.append((seqs, FilterInfo()))
        per_acc.append(seqs)
    jobs.append((["ACGT"], FilterInfo()))  # no read >= k: fails alone

    opts = _opts(2)
    got = tmb.build_blooms_device_batch(jobs, opts)
    want_jax = jmb.build_blooms_device_batch(jobs, opts)
    for a in range(5):
        want = tmb.build_bloom_device(iter(per_acc[a]), opts, FilterInfo())
        assert not isinstance(got[a], Exception), got[a]
        assert _same(got[a].param, want.param) and _same(want.param, want_jax[a].param), a
        assert got[a].bits.tobytes() == want.bits.tobytes() == want_jax[a].bits.tobytes(), a
    assert isinstance(got[5], tmb.BloomInvalid)


def test_batched_device_build_mixed_filter_lengths():
    rng = np.random.default_rng(11)
    small = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(2)]
    big = ["".join(rng.choice(list("ACGT"), size=400)) for _ in range(40)]
    opts = _opts(1, min_log_2_filter_len=8, min_log_2_count_len=12)
    got = tmb.build_blooms_device_batch([(small, FilterInfo()), (big, FilterInfo())], opts)
    for j, seqs in enumerate([small, big]):
        want = jmb.build_bloom_device(iter(seqs), opts, FilterInfo())
        assert _same(got[j].param, want.param)
        assert got[j].bits.tobytes() == want.bits.tobytes()
    assert got[0].param.log_2_filter_len != got[1].param.log_2_filter_len


def test_batched_three_accessions_small_filters_match_native():
    """num_acc=3 with L < 12 in one fused batch (the shapes on which the
    JAX version's _pack_bit_image raises), against exact ground truth
    from the native host hash."""
    rng = np.random.default_rng(12)
    accs = [["".join(rng.choice(list("ACGT"), size=40)) for _ in range(2)] for _ in range(3)]
    opts = _opts(1, min_log_2_filter_len=8, max_log_2_filter_len=11, min_log_2_count_len=12)
    got = tmb.build_blooms_device_batch([(s, FilterInfo()) for s in accs], opts)
    for j, seqs in enumerate(accs):
        assert got[j].param.log_2_filter_len < 12
        _, gt = _exact_filter(seqs, 31, 1, got[j].param.num_hash, got[j].param.log_2_filter_len)
        assert got[j].bits.tobytes() == gt.tobytes()


def test_batched_big_job_goes_chunked(reads):
    """A job above chunk_bp takes the chunked single-accession builder
    and equals it; the fused job beside it is untouched."""
    opts = _opts(1)
    small = list(reads[:4])
    got = tmb.build_blooms_device_batch([(list(reads), FilterInfo()), (small, FilterInfo())],
                                        opts, chunk_bp=2000)
    for rec, seqs in zip(got, (reads, small)):
        want = tmb.build_bloom_device(iter(seqs), opts, FilterInfo(), chunk_bp=2000)
        assert rec.param == want.param and rec.bits.tobytes() == want.bits.tobytes()


# --- entry() ----------------------------------------------------------------------------

def test_entry_matches_graft_entry():
    import __graft_entry__
    from kwage_tpu_torch.entry import entry

    jfn, jargs = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = entry()
    assert args[0].device.type == "cpu"
    got = fn(*args)
    assert got.shape == (1, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    # The example query is random bytes in 'A'..'T' and has almost no
    # valid window; an ACGT query with an N hits.
    q = np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(3).integers(0, 4, 256)].copy()
    q[100] = ord("N")
    got = fn(args[0], torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(jfn)(jargs[0], jnp.asarray(q))))
    assert got.sum() > 0


# --- routing and the kernels on a card -------------------------------------------------

def test_cpu_tensors_take_the_plain_versions():
    before = kernels.launch_counts()
    b, acc = _accession_batch(3, 2)
    tc.count_kmers_multi(b, torch.from_numpy(acc), 31, 2, 2)
    tk.canonical_kmers(torch.from_numpy(b), 31)
    th.murmur32(torch.arange(10), 31, 3)
    assert kernels.launch_counts() == before


def test_other_devices_raise():
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        th.murmur32(torch.zeros(4, dtype=torch.int64, device=meta), 31, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.canonical_kmers_packed(torch.zeros((1, 8), dtype=torch.int32, device=meta),
                                  torch.zeros((1, 4), dtype=torch.int32, device=meta), 31, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.canonical_kmers(torch.zeros(40, dtype=torch.uint8, device=meta), 31)
    z = torch.zeros(4, dtype=torch.int64, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tc.select_runs(z, z, 2, 1)


@pytest.mark.cuda
def test_ingest_kernels_match_ref(cuda_device):
    b, acc = _accession_batch(21, 4)
    packed, vw = tk.pack_reads_host(b)
    for k in (15, 16, 31, 32):
        args = (words_to_tensor(packed, cuda_device), words_to_tensor(vw, cuda_device), k, 128)
        got = tk.canonical_kmers_packed(*args)
        want = tk.canonical_kmers_packed_ref(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        words = got[0].reshape(-1)
        assert torch.equal(th.murmur32(words, k, 5), th.murmur32_ref(words, k, 5))
    # Every instance of the murmur32 kernel: k = 1..32 x nh = 1..8 (nh = 9:
    # the instance with nh at run time); an output off a 16-byte boundary
    # is refused.
    rng = np.random.default_rng(5)
    for k in range(1, 33):
        top = np.uint64(2**64 - 1) if k == 32 else np.uint64((1 << (2 * k)) - 1)
        words = tk.words_u64_to_tensor(
            rng.integers(0, 2**64, size=1000, dtype=np.uint64) & top, cuda_device)
        for nh in range(1, 10):
            assert torch.equal(th.murmur32(words, k, nh), th.murmur32_ref(words, k, nh))
        out = torch.empty(words.numel() * 4 + 1, dtype=torch.int32, device=cuda_device)
        with pytest.raises(RuntimeError, match="murmur32 launch failed"):
            kernels.launch("murmur32", words.data_ptr(), out[1:].data_ptr(), words.numel(), k,
                           4, 0xFFFFFFFF, torch.cuda.current_stream(cuda_device).cuda_stream)
        ascii = torch.from_numpy(_every_byte_batch(k)).to(cuda_device)
        got = tk.canonical_kmers(ascii, k)
        want = tk.canonical_kmers_ascii_ref(ascii, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    acc_t = torch.from_numpy(acc).to(cuda_device)
    acc_s, words_s, sel, nv = tc.count_kmers_multi(b, acc_t, 31, 2, 4)
    ref_sel, ref_nv = tc.select_runs_ref(acc_s, words_s, 4, 2)
    assert torch.equal(sel, ref_sel) and torch.equal(nv, ref_nv)
    slot = torch.tensor([0, -1, 2, 3, -1], dtype=torch.int32, device=cuda_device)
    for L in (5, 12, 31):
        got = tc.bloom_set_bits(acc_s, words_s, sel, slot, 31, 3, L)
        assert torch.equal(got, tc.bloom_set_bits_ref(acc_s, words_s, sel, slot, 31, 3, L))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_select_runs_kernel_matches_ref(cuda_device):
    """The kernel against the plain version on the tile-edge features, below
    and above the size from which it works in tiles of 2048 positions (the
    features then sit in the last tiles), at look-aheads inside, on and past
    its staged halo, on arrays that are not 16-byte aligned, and adding into
    num_valid over two calls' worth of data."""
    tile, num_acc = 2048, 44
    for start in (0, 1 << 20):
        acc, words = _edge_pairs(start + 1, tile, num_acc)
        head = np.repeat(np.arange(start // 4, dtype=np.int64), 4)   # runs of 4, accession 0
        acc = torch.from_numpy(np.concatenate([np.zeros_like(head), acc])).to(cuda_device)
        words = torch.from_numpy(np.concatenate([head - (start // 4) * 3, words])).to(cuda_device)
        for lo, hi in [(0, start + e) for e in (1, tile - 1, tile, tile + 1, 3 * tile + 5,
                                                 5 * tile + 5)] + [(1, start + 3 * tile + 5)]:
            for min_count in (1, 2, 5, 33, 34, tile + 3):
                got = tc.select_runs(acc[lo:hi], words[lo:hi], num_acc, min_count)
                want = tc.select_runs_ref(acc[lo:hi], words[lo:hi], num_acc, min_count)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
                    (start, lo, hi, min_count)
    torch.cuda.synchronize()

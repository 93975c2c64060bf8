"""The ingest's sort of (accession, word) windows (kwage_tpu_torch.ops.counting
sort_windows and sort_valid_windows): the plain versions against numpy's
lexsort and, through count_and_threshold and count_multi_core, against
kwage_tpu.ops.counting on the JAX CPU backend; the pass plan the wrapper
hands the radix_sort_pairs kernels, held to lexsort by a numpy emulation of
the kernels' digits; the kernels against the plain versions on a card.
Integers: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwage_tpu.ops import counting as jc
from kwage_tpu_torch.ops import counting as tc

CPU = torch.device("cpu")
KS = [15, 16, 31, 32]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py checks the kernels on the card")
    return torch.device("cuda")


def _pairs(seed, n, k, num_acc, distinct=None):
    """int64 (acc, word) pairs: words drawn from ``distinct`` k-mer words
    (k = 32: any int64, the sign bit included), accessions in [0, num_acc]."""
    rng = np.random.default_rng(seed)
    distinct = distinct or max(n // 6, 1)
    if k == 32:
        pool = rng.integers(-2**63, 2**63 - 1, size=distinct, dtype=np.int64)
    else:
        pool = rng.integers(0, 1 << (2 * k), size=distinct, dtype=np.int64)
    return (rng.integers(0, num_acc + 1, size=n).astype(np.int64),
            pool[rng.integers(0, distinct, size=n)])


@pytest.mark.parametrize("num_acc", [1, 14, 300])
@pytest.mark.parametrize("k", KS)
def test_sort_windows_ref_matches_lexsort(k, num_acc):
    acc, words = _pairs(k * 1000 + num_acc, 5000, k, num_acc)
    order = np.lexsort((words, acc))       # by acc, then by word, both signed
    for fn in (tc.sort_windows_ref,
               lambda a, w: tc.sort_windows(a, w, k, num_acc), tc.sort_windows):
        acc_s, words_s = fn(torch.from_numpy(acc), torch.from_numpy(words))
        np.testing.assert_array_equal(acc_s.numpy(), acc[order])
        np.testing.assert_array_equal(words_s.numpy(), words[order])
    if k == 32:
        assert (words < 0).any() and (words > 0).any()


@pytest.mark.parametrize("n", [0, 1, 2])
def test_sort_windows_tiny(n):
    acc, words = _pairs(n, n, 31, 3)
    acc_s, words_s = tc.sort_windows(torch.from_numpy(acc), torch.from_numpy(words), 31, 3)
    order = np.lexsort((words, acc))
    np.testing.assert_array_equal(acc_s.numpy(), acc[order])
    np.testing.assert_array_equal(words_s.numpy(), words[order])


@pytest.mark.parametrize("k,num_acc,want", [
    (15, 1, 4), (16, 14, 5), (31, 14, 8), (32, 255, 9), (32, 256, 9),
    (1, 300, 2), (4, 0, 1), (5, 65536, 4), (None, None, 16), (31, None, 16),
])
def test_sort_digits(k, num_acc, want):
    """The passes sort_windows plans: digits of 8 bits from bit 0 of the key
    acc:word (2k word bits, 64 for k None; the bits of num_acc, the largest
    accession, 64 for None), the top digit widened to 9 or 10 bits where
    that saves a pass."""
    acc_bits = 64 if num_acc is None else num_acc.bit_length()
    plan = tc.sort_plan(k, acc_bits)
    assert len(plan) == want
    total = (64 if k is None else 2 * k) + acc_bits
    assert [s for s, _ in plan] == [sum(w for _, w in plan[:p]) for p in range(len(plan))]
    assert sum(w for _, w in plan) == total
    assert all(w == 8 for _, w in plan[:-1]) and 1 <= plan[-1][1] <= tc.SORT_TOP_WIDTH
    assert len(plan) == max(1, -(-total // 8) - (total > 8 and total % 8 in (1, 2)))


@pytest.mark.parametrize("acc_bits,want", [(0, 0), (1, 1), (8, 1), (9, 2), (16, 2), (17, 8),
                                           (64, 8)])
def test_sort_acc_bytes(acc_bits, want):
    assert tc.sort_acc_bytes(acc_bits) == want


def _emulate_plan(acc, words, k, num_acc, valid_only):
    """numpy LSD sort that follows the kernels' plan: drop the windows
    outside [0, num_acc) (valid only), keep a 64-bit word or accession with
    its sign bit flipped, carry the accession in its narrow type, and take
    each pass's digit (shift, width) from the key acc:word as csrc/sort.cu's
    digit_of does, in stable passes."""
    sign = np.uint64(1 << 63)
    acc_bits = 64 if num_acc is None else (num_acc - 1 if valid_only else num_acc).bit_length()
    if valid_only:
        keep = (acc >= 0) & (acc < num_acc)
        acc, words = acc[keep], words[keep]
    word_bits = 64 if k is None else 2 * k
    w = words.astype(np.uint64) ^ (sign if word_bits == 64 else np.uint64(0))
    ab = tc.sort_acc_bytes(acc_bits)
    a = acc.astype(np.uint64) ^ (sign if acc_bits == 64 else np.uint64(0))
    a = a & np.uint64((1 << (8 * ab)) - 1 if ab < 8 else (1 << 64) - 1) if ab else a * 0
    lo = w if word_bits == 64 else w & np.uint64((1 << word_bits) - 1)
    for shift, width in tc.sort_plan(k, acc_bits):
        if shift >= word_bits:
            v = a >> np.uint64(shift - word_bits)
        else:
            v = lo >> np.uint64(shift)
            if word_bits - shift < 64:
                v = v | (a << np.uint64(word_bits - shift))
        order = np.argsort(v & np.uint64((1 << width) - 1), kind="stable")
        w, a, lo, acc = w[order], a[order], lo[order], acc[order]
    out_words = (w ^ (sign if word_bits == 64 else np.uint64(0))).astype(np.int64)
    out_acc = (a ^ (sign if acc_bits == 64 else np.uint64(0))).astype(np.int64) if ab else a * 0
    return out_acc.astype(np.int64), out_words


@pytest.mark.parametrize("distinct", [None, 3])
@pytest.mark.parametrize("k,num_acc,valid_only", [
    (k, num_acc, valid_only)
    for k, num_acc in ((15, 1), (16, 3), (31, 14), (31, 300), (32, 14), (32, 70_000), (1, 5))
    for valid_only in (False, True)] + [(None, None, False)])
def test_sort_plan_emulation_matches_lexsort(k, num_acc, valid_only, distinct):
    """The plan's digits (the merged top digit, a digit across the word's top
    and the accession's low bits, the sign flip, the narrow accession)
    order the pairs as lexsort does, and the valid-only plan drops exactly
    the invalid windows. ``distinct`` 3: long runs of one word across
    accessions, where every pass must be stable."""
    n = 6000
    acc, words = _pairs(n + (k or 0), n, k or 32, num_acc if num_acc is not None else 1 << 40,
                        distinct)
    if num_acc is None:
        acc -= 1 << 39
        acc[:3] = [-2**63, 2**63 - 1, -1]
    if valid_only:
        acc[::7] = -1 - acc[::7]            # negative accessions are invalid windows too
    got_acc, got_words = _emulate_plan(acc, words, k, num_acc, valid_only)
    keep = (acc >= 0) & (acc < num_acc) if valid_only else np.ones(n, bool)
    order = np.lexsort((words[keep], acc[keep]))
    np.testing.assert_array_equal(got_acc, acc[keep][order])
    np.testing.assert_array_equal(got_words, words[keep][order])
    want = (tc.sort_valid_windows_ref(torch.from_numpy(acc), torch.from_numpy(words), num_acc)
            if valid_only else tc.sort_windows_ref(torch.from_numpy(acc), torch.from_numpy(words)))
    np.testing.assert_array_equal(want[0].numpy(), got_acc)
    np.testing.assert_array_equal(want[1].numpy(), got_words)


def test_sort_windows_refuses_bad_arguments():
    a = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        tc.sort_windows(a, a.int())
    with pytest.raises(ValueError):
        tc.sort_windows(a, a[:3])
    with pytest.raises(ValueError):
        tc.sort_windows(a, a, 33, 1)
    with pytest.raises(ValueError):
        tc.sort_windows(a, a, 31, -1)
    with pytest.raises(ValueError):
        tc.sort_valid_windows(a, a, 31, 0)
    with pytest.raises(ValueError):
        tc.sort_valid_windows(a, a, 0, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tc.sort_valid_windows(a.to("meta"), a.to("meta"), 31, 2)


def _jax_words(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


@pytest.mark.parametrize("min_count", [1, 5])
@pytest.mark.parametrize("k", KS)
def test_count_and_threshold_matches_jax(k, min_count):
    """One accession's windows through the port's count_and_threshold and
    kwage_tpu's: the same counts, the same selected words and, below
    k = 32, the same sorted array (at k = 32 kwage_tpu orders the words
    unsigned, the port signed; the valid words are then the same multiset)."""
    rng = np.random.default_rng(k * 10 + min_count)
    n = 3000
    _, words = _pairs(k + min_count, n, k, 0, distinct=400)
    valid = rng.random(n) < 0.9
    u = words.astype(np.uint64)
    hi_s, lo_s, sel, nv, nwin = jc.count_and_threshold(
        jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray(valid), min_count)
    words_s, selected, num_valid, num_windows = tc.count_and_threshold(
        torch.from_numpy(words), torch.from_numpy(valid), min_count, k)
    assert (num_valid, num_windows) == (int(nv), int(nwin))
    assert num_windows == int(valid.sum()) and 0 < num_valid <= 400
    want_sorted = _jax_words(hi_s, lo_s)[:num_windows]
    got_sorted = words_s.numpy().astype(np.uint64)[:num_windows]
    if k < 32:
        np.testing.assert_array_equal(got_sorted, want_sorted)
    np.testing.assert_array_equal(np.sort(got_sorted), np.sort(want_sorted))
    want_sel = np.sort(_jax_words(hi_s, lo_s)[np.asarray(sel)])
    got_sel = np.sort(words_s.numpy().astype(np.uint64)[selected.numpy()])
    np.testing.assert_array_equal(got_sel, want_sel)
    assert not selected.numpy()[num_windows:].any()


@pytest.mark.parametrize("min_count", [1, 5])
@pytest.mark.parametrize("num_acc", [1, 3, 14, 300])
@pytest.mark.parametrize("k", KS)
def test_sort_valid_windows_matches_jax(k, num_acc, min_count):
    """sort_valid_windows and count_multi_core, which sorts with it, against
    kwage_tpu's _count_multi_core (and count_and_threshold for one
    accession): only the valid windows, equal to the JAX package's valid
    prefix below k = 32 (at k = 32 kwage_tpu orders the words unsigned, the
    port signed: the same multiset an accession), the same selected pairs
    and the same num_valid."""
    rng = np.random.default_rng(k * 1000 + num_acc * 10 + min_count)
    R, nwin = 48, 50
    _, words = _pairs(k + num_acc, R * nwin, k, 0, distinct=300)
    words = words.reshape(R, nwin)
    valid = rng.random((R, nwin)) < 0.8
    valid[-5:] = False                              # padding rows
    acc_ids = rng.integers(0, num_acc, size=R).astype(np.int32)
    u = words.astype(np.uint64)
    hi, lo = (u >> np.uint64(32)).astype(np.uint32), (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    acc_s, hi_s, lo_s, sel, nv = jc._count_multi_core(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), jnp.asarray(acc_ids), min_count,
        num_acc)
    n_valid = int(valid.sum())
    want_acc = np.asarray(acc_s)[:n_valid].astype(np.int64)
    want_words = _jax_words(hi_s, lo_s)[:n_valid]
    assert (want_acc < num_acc).all() and (np.asarray(acc_s)[n_valid:] == num_acc).all()

    acc = np.where(valid, acc_ids[:, None].astype(np.int64), num_acc).reshape(-1)
    got_acc, got_words = tc.sort_valid_windows(torch.from_numpy(acc),
                                               torch.from_numpy(words.reshape(-1)), k, num_acc)
    t_acc, t_words, t_sel, t_nv = tc.count_multi_core(
        torch.from_numpy(words), torch.from_numpy(valid), torch.from_numpy(acc_ids), min_count,
        num_acc, k)
    for a, w in ((got_acc, got_words), (t_acc, t_words)):
        assert a.shape == (n_valid,) and w.shape == (n_valid,)
        np.testing.assert_array_equal(a.numpy(), want_acc)
        if k < 32:
            np.testing.assert_array_equal(w.numpy().astype(np.uint64), want_words)
        else:
            for i in range(num_acc):
                np.testing.assert_array_equal(np.sort(w.numpy()[want_acc == i].astype(np.uint64)),
                                              np.sort(want_words[want_acc == i]))
    np.testing.assert_array_equal(t_nv.numpy(), np.asarray(nv))
    sel = np.asarray(sel)
    want_sel = sorted(zip(np.asarray(acc_s)[sel].tolist(), _jax_words(hi_s, lo_s)[sel].tolist()))
    got_sel = sorted(zip(t_acc.numpy()[t_sel.numpy()].tolist(),
                         t_words.numpy()[t_sel.numpy()].astype(np.uint64).tolist()))
    assert got_sel == want_sel and int(t_nv.sum()) == len(want_sel)
    if num_acc == 1:
        ws, s1, nv1, nw1 = tc.count_and_threshold(torch.from_numpy(words.reshape(-1)),
                                                  torch.from_numpy(valid.reshape(-1)),
                                                  min_count, k)
        _, _, _, jnv, jnw = jc.count_and_threshold(
            jnp.asarray(hi.reshape(-1)), jnp.asarray(lo.reshape(-1)),
            jnp.asarray(valid.reshape(-1)), min_count)
        assert (nv1, nw1) == (int(jnv), int(jnw)) == (int(nv[0]), n_valid)
        assert ws.shape == (n_valid,) and torch.equal(ws, t_words)


@pytest.mark.cuda
@pytest.mark.parametrize("k,num_acc", [(31, 14), (15, 1), (16, 300), (32, 3), (31, 70_000)])
def test_sort_valid_windows_kernel_matches_ref(cuda_device, k, num_acc):
    """The kernels' valid-only entry against its plain version around the
    4096-pair tile, with negative accessions and accessions past num_acc."""
    for n in (1, 2, 33, tc.SORT_TILE - 1, tc.SORT_TILE, tc.SORT_TILE + 1, 3 * tc.SORT_TILE + 5,
              200_000):
        acc, words = _pairs(n + 1, n, k, num_acc + 2)
        acc[::5] = -acc[::5]
        acc_d, words_d = torch.from_numpy(acc).to(cuda_device), torch.from_numpy(words).to(cuda_device)
        got = tc.sort_valid_windows(acc_d, words_d, k, num_acc)
        want = tc.sort_valid_windows_ref(acc_d, words_d, num_acc)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), n
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("k,num_acc", [(31, 14), (15, 1), (16, 300), (32, 3), (None, None)])
def test_radix_sort_pairs_matches_ref(cuda_device, k, num_acc):
    for n in (2, 33, tc.SORT_TILE - 1, tc.SORT_TILE, tc.SORT_TILE + 1, 3 * tc.SORT_TILE + 5,
              200_000):
        acc, words = _pairs(n, n, k or 32, num_acc if num_acc is not None else 1 << 40)
        acc_d, words_d = torch.from_numpy(acc).to(cuda_device), torch.from_numpy(words).to(cuda_device)
        got = tc.sort_windows(acc_d, words_d, k, num_acc)
        want = tc.sort_windows_ref(acc_d, words_d)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), n

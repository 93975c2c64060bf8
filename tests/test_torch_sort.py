"""The ingest's sort of (accession, word) windows (kwage_tpu_torch.ops.counting
sort_windows): its plain version against numpy's lexsort and, through
count_and_threshold, against kwage_tpu.ops.counting on the JAX CPU backend;
the digit widths the wrapper hands the radix_sort_pairs kernels; the kernels
against the plain version on a card. Integers: every comparison is exact."""

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
    (15, 1, (4, 1)), (16, 14, (4, 1)), (31, 14, (8, 1)), (32, 255, (8, 1)), (32, 256, (8, 2)),
    (1, 300, (1, 2)), (4, 0, (1, 0)), (5, 65536, (2, 3)), (None, None, (8, 8)), (31, None, (8, 8)),
])
def test_sort_digits(k, num_acc, want):
    """The bytes of the word that k can fill and of the accession that
    num_acc (the invalid windows' accession, the largest) can fill."""
    assert tc.sort_digits(k, num_acc) == want
    word_digits, acc_digits = want
    if k is not None:
        assert (1 << (2 * k)) - 1 < 1 << (8 * word_digits)
        assert word_digits == 1 or (1 << (2 * k)) - 1 >= 1 << (8 * (word_digits - 1))
    if num_acc is not None:
        assert num_acc < 1 << (8 * acc_digits) or (num_acc == 0 and acc_digits == 0)


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

"""kwage_tpu_torch.kernels: what surrounds the CUDA kernels and can be
checked without a card -- sources and their tag, the build location, the
device routing of every wrapper and the launch counts."""

import os
import subprocess

import numpy as np
import pytest
import torch

from kwage_tpu_torch import kernels
from kwage_tpu_torch.ops import search as ts
from kwage_tpu_torch.ops import transpose as tt


def test_sources_and_tag():
    names = [os.path.basename(p) for p in kernels.sources()]
    assert {"bit_transpose.cu", "search.cu", "kmers.cu", "murmur.cu", "murmur.cuh",
            "counting.cu", "bitset.cu", "sriracha.cu"} <= set(names)
    tag = kernels.source_tag()
    assert len(tag) == 16 and tag == kernels.source_tag()
    for path in kernels.sources():
        head = open(path).read(2000)
        assert "Replaces:" in head and "Bound:" in head and "Design" in head, path


def test_build_dir_is_git_ignored():
    repo = os.path.dirname(os.path.dirname(kernels.CSRC_DIR))
    probe = os.path.relpath(os.path.join(kernels.BUILD_DIR, "libkwage_kernels_x.so"), repo)
    res = subprocess.run(["git", "check-ignore", "-q", probe], cwd=repo)
    assert res.returncode == 0, probe


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors no kernel is launched (or built): the launch counts
    stay where they were."""
    before = kernels.launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, size=(64, 3), dtype=np.int32))
    assert torch.equal(tt.packed_bit_transpose(x), tt.packed_bit_transpose_ref(x))
    db = torch.from_numpy(rng.integers(-2**31, 2**31, size=(32, 2), dtype=np.int32))
    idx = torch.from_numpy(rng.integers(0, 32, size=(2, 5, 3), dtype=np.int32))
    valid = torch.ones((2, 5), dtype=torch.bool)
    assert torch.equal(ts.search_complete(db, idx, valid), ts.complete_ref(db, idx, valid))
    assert torch.equal(ts.search_counts(db, idx, valid), ts.counts_ref(db, idx, valid))
    assert kernels.launch_counts() == before


def test_other_devices_raise():
    x = torch.zeros((32, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tt.packed_bit_transpose(x)
    idx = torch.zeros((1, 2, 3), dtype=torch.int32, device="meta")
    valid = torch.ones((1, 2), dtype=torch.bool, device="meta")
    for fn in (ts.search_complete, ts.search_counts):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(x, idx, valid)


def test_reset_launch_counts():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {
        "bit_transpose": 0, "search_complete": 0, "search_counts": 0, "search_total_hits": 0,
        "canonical_kmers": 0, "murmur32": 0, "radix_sort_pairs": 0, "select_runs": 0,
        "bloom_set_bits": 0,
        "sriracha_counts_lut": 0, "sriracha_counts_hash": 0, "sriracha_reads_lut": 0,
        "sriracha_reads_hash": 0, "sriracha_block_lut": 0, "sriracha_block_hash": 0,
        "subject_table": 0, "run_counts": 0, "merge_counts": 0}


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails: the build raises, nothing is bound and no
    library appears."""
    import shutil

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(kernels, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.get_lib()
    assert kernels._LIB is None and not list(tmp_path.glob("*.so"))


class _FakeLib:
    """Stands in for the kernel library: every entry returns CUDA error 9."""

    def __getattr__(self, name):
        if name == "kw_error_string":
            return lambda err: b"invalid configuration argument"
        return lambda *args: 9


def test_launch_error_raises_and_is_not_counted(monkeypatch):
    monkeypatch.setattr(kernels, "_LIB", _FakeLib())
    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match="search_counts launch failed: CUDA error 9"):
        kernels.launch("search_counts", 0, 0, 0, 0, 1, 1, 1, 1, 0)
    assert kernels.launch_counts() == before


class _OkLib:
    """Stands in for the kernel library: every entry succeeds."""

    def __getattr__(self, name):
        return lambda *args: 0


def test_ascii_entry_counts_as_canonical_kmers(monkeypatch):
    """kmers.cu's two entry points launch one kernel: both count under
    canonical_kmers, and no other count moves."""
    monkeypatch.setattr(kernels, "_LIB", _OkLib())
    before = kernels.launch_counts()
    kernels.launch("canonical_kmers_ascii", 0, 0, 0, 1, 40, 40, 31, 0)
    kernels.launch("canonical_kmers", 0, 0, 0, 0, 1, 3, 2, 40, 31, 0)
    after = kernels.launch_counts()
    assert "canonical_kmers_ascii" not in after
    assert after == {**before, "canonical_kmers": before["canonical_kmers"] + 2}


def test_sort_entries_count_as_radix_sort_pairs(monkeypatch):
    """sort.cu's two entries (the histogram, the passes) are steps of one
    kernel: both count under radix_sort_pairs, and no other count moves."""
    monkeypatch.setattr(kernels, "_LIB", _OkLib())
    before = kernels.launch_counts()
    kernels.launch("radix_sort_hist", *[0] * 4, 10, 14, 62, 4, 0, 8, 0)
    kernels.launch("radix_sort_pairs", *[0] * 10, 10, 10, 14, 62, 4, 0, 8, 1024, 0)
    after = kernels.launch_counts()
    assert "radix_sort_hist" not in after
    assert after == {**before, "radix_sort_pairs": before["radix_sort_pairs"] + 2}


def test_sriracha_entries_count_apart(monkeypatch):
    """sriracha.cu's two probe entries launch one templated kernel but
    count apart, so a run shows which route it took."""
    monkeypatch.setattr(kernels, "_LIB", _OkLib())
    before = kernels.launch_counts()
    kernels.launch("sriracha_counts_lut", *[0] * 6, 1, 64, 11, 1 << 22, 40, 42, 64, 0)
    kernels.launch("sriracha_counts_hash", *[0] * 9, 1, 64, 21, 40, 42, 64, 0)
    kernels.launch("sriracha_counts_hash", *[0] * 9, 1, 64, 21, 40, 42, 64, 0)
    kernels.launch("subject_table", 0, 0, 40, 100, 1 << 22, 0)
    after = kernels.launch_counts()
    assert after == {**before, "sriracha_counts_lut": before["sriracha_counts_lut"] + 1,
                     "sriracha_counts_hash": before["sriracha_counts_hash"] + 2,
                     "subject_table": before["subject_table"] + 1}


def test_sriracha_reads_entries_count_apart(monkeypatch):
    """The fused short-read entries (one templated kernel, two probes)
    count apart from each other and from the two-launch route's kernels."""
    monkeypatch.setattr(kernels, "_LIB", _OkLib())
    before = kernels.launch_counts()
    kernels.launch("sriracha_reads_lut", *[0] * 4, 512, 256, 11, 1 << 22, 40, 42, 0)
    kernels.launch("sriracha_reads_hash", *[0] * 7, 512, 256, 21, 40, 42, 0)
    kernels.launch("sriracha_reads_hash", *[0] * 7, 512, 128, 21, 40, 42, 0)
    after = kernels.launch_counts()
    assert after == {**before, "sriracha_reads_lut": before["sriracha_reads_lut"] + 1,
                     "sriracha_reads_hash": before["sriracha_reads_hash"] + 2}
    assert len(kernels._ENTRIES["sriracha_reads_lut"]) == 11
    assert len(kernels._ENTRIES["sriracha_reads_hash"]) == 13


def test_sriracha_block_entries_count_apart(monkeypatch):
    """The block-a-read entries (reads of 1-16 kbp) take sriracha_reads'
    arguments and count apart from them and from the two-launch route's
    kernels."""
    monkeypatch.setattr(kernels, "_LIB", _OkLib())
    before = kernels.launch_counts()
    kernels.launch("sriracha_block_lut", *[0] * 4, 512, 2048, 11, 1 << 22, 40, 42, 0)
    kernels.launch("sriracha_block_hash", *[0] * 7, 64, 16384, 21, 40, 42, 0)
    kernels.launch("sriracha_block_hash", *[0] * 7, 512, 16384, 21, 40, 42, 0)
    after = kernels.launch_counts()
    assert after == {**before, "sriracha_block_lut": before["sriracha_block_lut"] + 1,
                     "sriracha_block_hash": before["sriracha_block_hash"] + 2}
    for probe in ("lut", "hash"):
        assert kernels._ENTRIES[f"sriracha_block_{probe}"] == \
            kernels._ENTRIES[f"sriracha_reads_{probe}"]


def test_words_entries_are_steps_of_sriracha_counts(tmp_path):
    """The block kernel's words entries live in files of their own and are
    called by sriracha.cu's sriracha_counts_* (one launch count, the
    entry's), never bound; time_kernel links them with a sriracha.cu that
    calls them, beside it or from csrc/, and with no other."""
    from kwage_tpu_torch.kernels import time_kernel

    assert not [n for n in (*kernels._ENTRIES, *kernels.launch_counts()) if "words" in n]
    csrc = kernels.CSRC_DIR
    here = os.path.join(csrc, "sriracha.cu")
    with open(here) as f:
        src = f.read()
    assert "sriracha_counts_kernel" not in src
    words = [os.path.join(csrc, f"sriracha_words_{probe}.cu") for probe in ("lut", "hash")]
    assert set(words) <= set(kernels.sources())
    for probe, path in zip(("lut", "hash"), words):
        assert src.count(f"kw_sriracha_words_{probe}(") == 2   # declared, called
        with open(path) as f:
            assert f'extern "C" int kw_sriracha_words_{probe}(' in f.read()
    assert time_kernel.companions(here) == words
    older = tmp_path / "sriracha.cu"
    older.write_text(src.replace("kw_sriracha_words_", "kw_other_"))
    assert time_kernel.companions(str(older)) == []
    older.write_text(src)
    beside = [tmp_path / f"sriracha_words_{probe}.cu" for probe in ("lut", "hash")]
    beside[0].write_text("// lut")
    assert time_kernel.companions(str(older)) == [str(beside[0]), words[1]]

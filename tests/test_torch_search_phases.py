"""The measurement-only gather kernels (csrc/variants/search_phases.cu) and
what surrounds them: built alone into a library of their own
(``time_kernel.build_alone``), launched and counted by
``bench.search_phases`` and never by the kernel library; on the card, each
equals its plain version bit for bit at the chunked layout's edges (skipped
without a card; chip_smoke.py phase 15 holds them on the card)."""

import os
import stat

import numpy as np
import pytest
import torch

from kwage_tpu_torch import kernels
from kwage_tpu_torch.bench import search_phases as sp
from kwage_tpu_torch.kernels import time_kernel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 15 checks the kernels on the card")
    return torch.device("cuda")


class FakeLib:
    """A stand-in for the variant library: records its calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("kw_gather"):
            return lambda *args: self.calls.append((name, args)) or 0
        raise AttributeError(name)


def test_variant_launches_go_to_their_own_library(monkeypatch):
    """gather1 / gather5_and launch from the variant library, never the
    kernel library, and count in bench.search_phases, not in the kernel
    library's counts."""
    fake = FakeLib()
    monkeypatch.setattr(sp, "get_lib", lambda: fake)
    monkeypatch.setattr(kernels, "get_lib", lambda: pytest.fail("the kernel library was built"))
    monkeypatch.setattr(sp, "_LAUNCHES", dict.fromkeys(sp.ENTRIES, 0))
    library = kernels.launch_counts()
    sp.launch("gather1", 1, 2, 3, 4, 8, 1024, 5, 512, 0)
    sp.launch("gather5_and", 1, 2, 3, 4, 8, 1024, 5, 512, 0)
    sp.launch("gather5_and", 1, 2, 3, 4, 8, 1024, 5, 512, 0)
    assert [c[0] for c in fake.calls] == ["kw_gather1", "kw_gather5_and", "kw_gather5_and"]
    assert sp.launch_counts() == {"gather1": 1, "gather5_and": 2}
    assert kernels.launch_counts() == library
    assert "gather1" not in library and "gather5_and" not in library


def test_the_variant_entries_take_the_searches_arguments():
    for name in sp.ENTRIES:
        assert time_kernel._OWN_ENTRIES[name] == kernels._ENTRIES["search_complete"]
    assert sp.SOURCE == os.path.join(kernels.CSRC_DIR, "variants", "search_phases.cu")
    head = open(sp.SOURCE).read(3000)
    assert "Replaces no TPU kernel" in head and "Bound:" in head and "Design" in head
    assert '#include "search.cu"' in open(sp.SOURCE).read()


def test_build_alone_names_the_build_by_its_sources(monkeypatch, tmp_path):
    """A source built alone is named by its bytes and those of search.cu
    (which the variant includes): cached while they stay, built again when
    search.cu changes."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    (csrc / "variants").mkdir(parents=True)
    (csrc / "search.cu").write_text("// v1\n")
    source = csrc / "variants" / "x.cu"
    source.write_text('#include "search.cu"\n')
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\necho ok\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(time_kernel, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(time_kernel, "BUILD_DIR", str(build))
    monkeypatch.setattr(time_kernel, "_nvcc", lambda: str(nvcc))
    first, report = time_kernel.build_alone(str(source))
    assert report.strip() == "ok" and os.path.exists(first)
    assert time_kernel.build_alone(str(source)) == (first, None)
    (csrc / "search.cu").write_text("// v2\n")
    second, report = time_kernel.build_alone(str(source))
    assert second != first and report.strip() == "ok"


def test_a_failed_alone_build_leaves_no_library(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no'\nexit 2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    (tmp_path / "a.cu").write_text("x\n")
    monkeypatch.setattr(time_kernel, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(time_kernel, "_nvcc", lambda: str(nvcc))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        time_kernel.build_alone(str(tmp_path / "a.cu"))
    assert os.listdir(tmp_path / "build") == []


EDGES = [  # (R, W, nq, nk, nh, valid fraction, byte offset of db)
    (1024, 512, 2, 100, 5, 0.7, 0), (4096, 131, 3, 77, 3, 0.5, 0), (2048, 64, 1, 33, 9, 0.9, 0),
    (4096, 8, 2, 64, 1, 1.0, 0), (512, 3, 4, 1, 5, 0.5, 0), (1024, 512, 2, 64, 5, 1.0, 4),
    (1024, 128, 3, 40, 4, 0.0, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("R,W,nq,nk,nh,frac,offset", EDGES)
def test_gather_kernels_equal_plain_on_the_card(cuda_device, R, W, nq, nk, nh, frac, offset):
    rng = np.random.default_rng(R + W + nk)
    words = rng.integers(-2**31, 2**31, size=R * W + offset // 4, dtype=np.int32)
    db = torch.from_numpy(words).to(cuda_device)[offset // 4:].view(R, W)
    idx = torch.from_numpy(rng.integers(0, R, size=(nq, nk, nh), dtype=np.int32)).to(cuda_device)
    valid = torch.from_numpy(rng.random((nq, nk)) < frac).to(cuda_device)
    assert torch.equal(sp.gather1(db, idx, valid), sp.gather1_ref(db, idx, valid))
    assert torch.equal(sp.gather5_and(db, idx, valid), sp.gather5_and_ref(db, idx, valid))

"""The port's slice end to end on the golden corpus: .bloom -> .db through
the port's device transpose, ``kwage --device`` through the port's search
kernels, and the port's resident server. On the CPU every kernel wrapper
runs its plain PyTorch version (KWAGE_TORCH_DEVICE=cpu); the bytes must
equal the reference's golden files and the JAX package's server."""

import hashlib
import json
import socket

import pytest
import torch

from kwage_tpu_torch.core import FilterInfo, str_to_accession
from kwage_tpu_torch.io.bloom_file import read_bloom_file, write_bloom_file
from kwage_tpu_torch.pipeline.make_bloom import BuildOptions, build_bloom_from_file
from kwage_tpu_torch.cli.kwage import main as torch_kwage_main
from kwage_tpu_torch.pipeline.build_db import build_db_from_bloom_files
from kwage_tpu_torch.utils.runtime import resolve_device

CASES = [
    "json_t1_file",
    "csv_t1_file",
    "json_t075_file",
    "csv_t075_file",
    "json_t05_file",
    "json_t1_cmdline",
    "csv_t03_cmdline",
    "json_single_query",
]


@pytest.fixture(scope="module")
def manifest(golden_dir):
    with open(golden_dir / "e2e" / "manifest.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def built(manifest, data_dir, tmp_path_factory):
    """Golden corpus: blooms through the host pipeline, databases through
    the port's pack with device=True on the CPU device."""
    work = tmp_path_factory.mktemp("torch_e2e")
    opts = BuildOptions(
        kmer_len=manifest["k"],
        min_kmer_count=manifest["min_kmer_count"],
        false_positive_probability=manifest["fp"],
        min_log_2_filter_len=manifest["minL"],
        max_log_2_filter_len=manifest["maxL"],
        min_log_2_count_len=manifest["minLc"],
        max_log_2_count_len=manifest["maxLc"],
    )
    bloom_paths = {}
    for acc in manifest["accessions"]:
        info = FilterInfo(run_accession=str_to_accession(acc))
        rec = build_bloom_from_file(str(data_dir / f"{acc}.fasta"), opts, info)
        bloom_paths[acc] = work / f"{acc}.bloom"
        write_bloom_file(str(bloom_paths[acc]), rec)
    db_paths = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KWAGE_TORCH_DEVICE", "cpu")
        for gi, group in enumerate(manifest["db_groups"]):
            param = read_bloom_file(str(bloom_paths[group[0]]), with_bits=False).param
            db = work / f"sra.{gi}.db"
            # chunk_bits below the filter length: several chunks per pack.
            build_db_from_bloom_files(
                str(db), param, [str(bloom_paths[a]) for a in group],
                chunk_bits=1 << 13, device=True)
            db_paths.append(db)
    return db_paths


def test_device_packed_db_files_byte_identical(built, golden_dir):
    with open(golden_dir / "e2e" / "digests.json") as f:
        digests = json.load(f)
    for gi, db in enumerate(built):
        assert hashlib.sha256(db.read_bytes()).hexdigest() == digests[f"sra.{gi}.db"], db.name


@pytest.mark.parametrize("case", CASES)
def test_device_search_output_byte_identical(
    case, built, manifest, golden_dir, data_dir, tmp_path, monkeypatch
):
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    args = []
    for db in built:
        args += ["-d", str(db)]
    for a in manifest["cases"][case]:
        args.append(str(data_dir / "queries.fasta") if a.endswith("queries.fasta") else a)
    out_file = tmp_path / f"{case}.out"
    assert torch_kwage_main(args + ["-o", str(out_file), "--device"]) == 0
    want = (golden_dir / "e2e" / f"{case}.out").read_text()
    assert out_file.read_text() == want, f"{case}: device output differs"


def _ask(f, req):
    f.write(json.dumps(req) + "\n")
    f.flush()
    return json.loads(f.readline())


REQUESTS = [
    {"threshold": 1.0, "format": "json"},
    {"threshold": 0.5, "format": "csv"},
    {"threshold": 0.75, "format": "json"},
]


def test_search_server_matches_jax_server(built, data_dir, monkeypatch):
    from kwage_tpu.io.sequence import iter_sequences
    from kwage_tpu.search.resident import SearchServer as JaxSearchServer
    from kwage_tpu_torch.search.resident import SearchServer

    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    files = [str(p) for p in built]
    queries = [s for _, s in iter_sequences(str(data_dir / "queries.fasta"))][:3]
    replies = []
    for cls in (SearchServer, JaxSearchServer):
        server = cls(files, host="127.0.0.1")
        server.start()
        try:
            with socket.create_connection(server.address, timeout=60) as sock:
                f = sock.makefile("rw", encoding="utf-8")
                replies.append([_ask(f, dict(r, queries=queries)) for r in REQUESTS])
        finally:
            server.shutdown()
    assert all(r["ok"] for r in replies[0]), replies[0]
    assert replies[0] == replies[1]


@pytest.mark.parametrize("engine", ["device", "host"])
def test_search_server_errors_and_token(built, data_dir, monkeypatch, engine):
    """A bad threshold and a missing token come back as structured errors
    and the connection keeps serving; a tokened request is answered with
    the bytes of the port's resident searcher."""
    from kwage_tpu.io.sequence import iter_sequences
    from kwage_tpu_torch.search.resident import ResidentSearcher, SearchServer

    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    files = [str(p) for p in built]
    queries = [s for _, s in iter_sequences(str(data_dir / "queries.fasta"))][:2]
    want = ResidentSearcher(files, torch.device("cpu")).render(queries, 0.5, "csv")
    server = SearchServer(files, host="127.0.0.1", secret="tok3n", engine=engine)
    server.start()
    try:
        with socket.create_connection(server.address, timeout=60) as sock:
            f = sock.makefile("rw", encoding="utf-8")
            reply = _ask(f, {"queries": queries, "threshold": 0.5})
            assert not reply["ok"] and "token" in reply["error"]
            reply = _ask(f, {"queries": queries, "threshold": 7, "token": "tok3n"})
            assert not reply["ok"] and "threshold" in reply["error"]
            reply = _ask(f, {"queries": queries, "threshold": 0.5, "format": "csv",
                             "token": "tok3n"})
            assert reply == {"ok": True, "output": want}
    finally:
        server.shutdown()


def test_resident_budget_chunks_match(built, data_dir):
    """A budget too small for any chunk keeps every chunk on the host and
    streams it in one-column slabs; a budget of the smallest chunk keeps
    some resident and streams the rest in what is left. Output equals the
    fully resident one."""
    from kwage_tpu.io.sequence import iter_sequences
    from kwage_tpu_torch.search.resident import ResidentSearcher

    files = [str(p) for p in built]
    queries = [s for _, s in iter_sequences(str(data_dir / "queries.fasta"))][:3]
    cpu = torch.device("cpu")
    full = ResidentSearcher(files, cpu)
    tiny = ResidentSearcher(files, cpu, budget_bytes=1 << 10)
    smallest = min(db.numel() * 4 for _, db, _ in full._groups)
    partial = ResidentSearcher(files, cpu, budget_bytes=smallest)
    assert tiny.resident_bytes == 0
    assert 0 < partial.resident_bytes < full.resident_bytes
    for threshold in (1.0, 0.5):
        want = full.render(queries, threshold)
        assert tiny.render(queries, threshold) == want
        assert partial.render(queries, threshold) == want


def test_cuda_requested_without_a_card_raises(built, monkeypatch):
    """No silent CPU fallback: KWAGE_TORCH_DEVICE=cuda with no CUDA device
    raises, from the resolver and from the CLI's --device path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_kwage_main(["-d", str(built[0]), "--device", "ACGT" * 10])


def test_fused_tensor_equals_hstack(built):
    """fuse_files uploads each file into its column range of one tensor:
    the result equals the np.hstack of the files' word matrices (the
    former host join), and every column range of a HostChunk equals the
    same columns of it."""
    import numpy as np

    from kwage_tpu.io.dbz_file import open_database
    from kwage_tpu_torch.ops.search import db_bytes_to_words, fuse_files, read_chunk

    readers = [open_database(str(p)) for p in built]
    by_len: dict[int, list[int]] = {}
    for fi, r in enumerate(readers):
        by_len.setdefault(r.header.filter_len, []).append(fi)
    cpu = torch.device("cpu")
    for idxs in by_len.values():
        for order in (idxs, idxs[::-1]):
            want = np.hstack([db_bytes_to_words(readers[fi].read_slices()) for fi in order])
            fused, spans = fuse_files(readers, order, cpu)
            np.testing.assert_array_equal(fused.numpy().view(np.uint32), want)
            assert spans[-1][2] == want.shape[1]
            chunk, host_spans = read_chunk(readers, order)
            assert host_spans == spans and chunk.shape == want.shape
            W = want.shape[1]
            for lo, hi in ((0, W), (0, 1), (W - 1, W), (W // 3, 2 * W // 3 + 1)):
                got = chunk.columns(lo, hi, cpu).numpy().view(np.uint32)
                np.testing.assert_array_equal(got, want[:, lo:hi])


@pytest.mark.parametrize("budget", [1 << 10, 1 << 40])
def test_device_search_bytes_with_slab_budget(budget, built, manifest, golden_dir,
                                              data_dir, tmp_path, monkeypatch):
    """The golden bytes whether each chunk fuses on the device or, with a
    budget smaller than any file, streams from the host in slabs."""
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("KWAGE_FUSION_BUDGET_BYTES", str(budget))
    args = [a for db in built for a in ("-d", str(db))]
    for case in ("csv_t075_file", "json_t1_file"):
        case_args = [str(data_dir / "queries.fasta") if a.endswith("queries.fasta") else a
                     for a in manifest["cases"][case]]
        out_file = tmp_path / f"{case}.out"
        assert torch_kwage_main(args + case_args + ["-o", str(out_file), "--device"]) == 0
        assert out_file.read_text() == (golden_dir / "e2e" / f"{case}.out").read_text(), case

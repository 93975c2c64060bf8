"""The benchmark's reference and generator at a tiny size, on the CPU: the
frozen k-mer, murmur and threshold rules against the port's, the corpus
against filters built run by run, the .db files against the port's reader,
the plain search against the port's plain CPU path, and what the reference
may import."""

import ast
import json

import numpy as np
import pytest
import torch

from benchmark import corpus, dbfile, manifest, sequences, work
from benchmark.clients import parse_hits
from benchmark.reference import kmers, murmur, search
from kwage_tpu_torch.core.hash import murmur32_words
from kwage_tpu_torch.core.words import canonical_kmers
from kwage_tpu_torch.search.engine import query_threshold_count


@pytest.mark.parametrize("k", [11, 21, 29, 30, 31])
def test_kmers_and_murmur_are_the_ports(k):
    g = np.random.default_rng(k)
    seq = kmers.decode(g.integers(0, 4, size=3000, dtype=np.uint8))
    seq = seq[:700] + "N" + seq[701:]  # a base that resets the window
    words = kmers.canonical_np(kmers.encode(seq), k)
    assert np.array_equal(words, canonical_kmers(seq, k))
    clean = kmers.encode(seq[800:])
    t = kmers.canonical_torch(torch.from_numpy(clean), k).numpy().astype(np.uint64)
    assert np.array_equal(t, canonical_kmers(seq[800:], k))
    for nh in (1, 4, 5):
        want = murmur32_words(words, k, nh)
        assert np.array_equal(murmur.murmur_np(words, k, nh), want)
        got = murmur.murmur_torch(torch.from_numpy(words.astype(np.int64)), k, nh)
        assert np.array_equal(got.numpy().astype(np.uint32), want)


def test_threshold_rule_is_the_ports():
    for t in (0.1, 0.5, 0.8, 0.95, 1.0):
        for n in (1, 7, 29873, 197179, 2999):
            assert search.threshold_count(t, n) == query_threshold_count(t, n)


@pytest.fixture(scope="module")
def built(tmp_path_factory, tiny):
    root, _ = tiny
    cfg = manifest.config("tiny", root)
    paths = corpus.build(cfg, 2**31 + 7, str(tmp_path_factory.mktemp("corpus")),
                         torch.device("cpu"))
    return cfg, paths


def test_corpus_is_its_runs_filters(built):
    """Each run's filter, built from its own genome with the frozen rules,
    is the corpus's column."""
    cfg, paths = built
    seed = 2**31 + 7
    lineages = sequences.genomes(cfg, seed)
    pos, delta = sequences.run_substitutions(cfg, seed)
    assert (np.diff(pos, axis=1) > 0).all()
    L, nh, F = cfg["log2_filter_len"], cfg["num_hash"], cfg["filters_per_file"]
    for f, path in enumerate(paths):
        slices = dbfile.read_slices(path)
        bits = np.unpackbits(slices, axis=1, bitorder="little")  # [2^L, F]
        for col, r in enumerate(corpus.file_runs(cfg, f)):
            genome = lineages[r // cfg["runs_per_lineage"]].copy()
            genome[pos[r]] = (genome[pos[r]] + delta[r]) % 4
            words = np.unique(kmers.canonical_np(genome, cfg["k"]))
            want = np.zeros(1 << L, dtype=np.uint8)
            want[(murmur.murmur_np(words, cfg["k"], nh) & ((1 << L) - 1)).ravel()] = 1
            assert np.array_equal(bits[:, col], want), (f, col)
    assert 0.2 < bits.mean() < 0.8  # the filters are neither empty nor full


def test_db_files_read_back_through_the_port(built):
    from kwage_tpu_torch.io.db_file import DBFileReader

    cfg, paths = built
    for f, path in enumerate(paths):
        r = DBFileReader(path)
        assert r.verify_crc32()
        assert (r.header.kmer_len, r.header.num_hash, r.header.log_2_filter_len,
                r.header.num_filter) == (cfg["k"], cfg["num_hash"], cfg["log2_filter_len"],
                                         cfg["filters_per_file"])
        assert np.array_equal(r.read_slices(), dbfile.read_slices(path))
        runs = corpus.file_runs(cfg, f)
        infos = r.read_all_filter_info()
        assert [i.csv_string() for i in infos] == [sequences.accession(x) for x in runs]


@pytest.mark.parametrize("mix_name", ["genomes-t0.8", "genes-t1"])
def test_reference_is_the_ports_plain_path(built, tiny, mix_name):
    """The port's resident searcher on the CPU (its plain PyTorch search)
    and its host engine render the same hit lists as the reference."""
    from kwage_tpu_torch.search.resident import HostResidentSearcher, ResidentSearcher

    root, _ = tiny
    cfg, paths = built
    mix = manifest.traffic(mix_name, root)
    seed = 2**31 + 7
    genomes = sequences.genomes(cfg, seed)
    ref = corpus.reference(cfg, paths, torch.device("cpu"))
    port = ResidentSearcher(paths, torch.device("cpu"))
    host = HostResidentSearcher(paths)
    n_hits = 0
    for j in range(4):
        queries = sequences.request(mix, genomes, seed, j)
        want = ref.answer(queries, mix["threshold"])
        n_hits += sum(map(len, want.values()))
        for searcher in (port, host):
            out = searcher.render(queries, mix["threshold"])
            got = parse_hits(json.dumps({"ok": True, "output": out}).encode())
            assert {i: [tuple(h) for h in v] for i, v in got.items()} == want
    assert n_hits > 0


def test_warmup_sweep_touches_every_run(built, tiny):
    """The sweep's requests, at its threshold, hit every run of the corpus:
    the server has read every run's metadata before the window."""
    root, _ = tiny
    cfg, paths = built
    seed = 2**31 + 7
    ref = corpus.reference(cfg, paths, torch.device("cpu"))
    for name in ("genomes-t0.8", "genes-t1"):
        mix = manifest.traffic(name, root)
        seen = set()
        for qs in sequences.sweep(mix, sequences.genomes(cfg, seed), seed):
            for hits in ref.answer(qs, mix["warmup_sweep"]["threshold"]).values():
                seen.update(h[0] for h in hits)
        assert seen == set(ref.names)


def test_distinct_kmers_and_bytes():
    g = np.random.default_rng(3)
    qs = [kmers.decode(g.integers(0, 4, size=n, dtype=np.uint8)) for n in (40, 40, 300, 31, 5)]
    qs.append("A" * 50)  # one distinct k-mer
    want = [len(kmers.distinct_np(q, 31)) for q in qs]
    assert work.distinct_kmers(qs, 31, torch.device("cpu")) == want
    assert work.search_bytes(10, 5, 64, 0.8) == 10 * 5 * (4 * 64 + 4) + 4 * 64 * 32
    assert work.search_bytes(10, 5, 64, 1.0) == 10 * 5 * (4 * 64 + 4) + 4 * 64


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    for path in (manifest.HERE / "reference").glob("*.py"):
        names = {n.split(".", 1)[0] for n in _imports(path)}
        assert not names & {"kwage_tpu_torch", "kwage_tpu", "jax", "jaxlib", "flax"}, path


def test_benchmark_imports_no_jax():
    for path in manifest.HERE.rglob("*.py"):
        names = {n.split(".", 1)[0] for n in _imports(path)}
        assert not names & {"kwage_tpu", "jax", "jaxlib", "flax"}, path

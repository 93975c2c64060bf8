"""kwage_tpu_torch keeps its own copy of every host module it uses (it
imports nothing of kwage_tpu). A copy must not drift from its original: a
file copied whole equals it byte for byte once import lines are set
aside, and every function a merged module carries over equals its
original statement for statement. The port's host engines then give
kwage_tpu's bytes on the test corpus, and its native library and fallback
agree with kwage_tpu.native (integers and bytes: exact equality)."""

import ast
import dataclasses
import importlib
import inspect
import io
import json
import pathlib
import re
import textwrap

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = REPO / "kwage_tpu", REPO / "kwage_tpu_torch"

# Files copied whole, relative to the package.
WHOLE = sorted(
    [f"core/{p.name}" for p in (JAX_PKG / "core").glob("*.py")]
    + [f"io/{p.name}" for p in (JAX_PKG / "io").glob("*.py")]
    + ["native/fallback.py", "native/kwage_native.cpp", "search/engine.py",
       "search/output.py", "sriracha/sra_source.py", "sriracha/vdb.py", "cli/_render.py",
       "utils/mem_usage.py", "pipeline/inventory.py",
       "pipeline/merge_db.py", "pipeline/sra_meta.py"]
    + [f"cli/{name}.py" for name in (
        "bff", "bloom_diff", "bloom_test", "db_debug", "dump_bloom", "dump_db",
        "inventory_dump", "manual_db", "merge_db", "sra_diff", "sra_dump", "sra_inventory")])

_IMPORT_LINE = re.compile(r"^\s*(from\s+\S+\s+import\b.*|import\s+\S+.*)$")


def _without_imports(text: str) -> str:
    return "\n".join(line for line in text.splitlines() if not _IMPORT_LINE.match(line))


@pytest.mark.parametrize("rel", WHOLE)
def test_whole_copy_equals_its_original(rel):
    original, copy = (JAX_PKG / rel).read_bytes(), (PORT_PKG / rel).read_bytes()
    if rel.endswith(".cpp"):
        assert copy == original
    else:
        assert _without_imports(copy.decode()) == _without_imports(original.decode())


def test_no_prebuilt_library_is_copied():
    assert not list((PORT_PKG / "native").glob("*.so"))


# Merged modules: (module path under both packages, names that differ on
# purpose). Every other function or class the two modules share is held to
# its original.
MERGED = {
    # the build directory and its docstring
    "native": {"_build"},
    # the device transpose and the device argument are the port's
    "pipeline.build_db": {"_iter_transposed_chunks", "build_db_from_bloom_files"},
    # the device phases are the port's (torch, int64 offsets, no host fallbacks)
    "pipeline.make_bloom": {"build_bloom_device", "dispatch_device_batch",
                            "scatter_device_batch", "complete_device_batch"},
    "parallel.maestro": set(),
    # a late "downloaded" event of a task dispatched twice leaves an
    # absorbed filter's status as it is; the coordinator reports the
    # address it bound (tests/test_torch_maestro.py holds the CLI's line and
    # the databases built through a coordinator on port 0 to the golden
    # digests)
    "parallel.remote": {"CoordinatorServer", "run_distributed_maestro"},
    # a grid of torch devices in place of jax.sharding.Mesh
    "parallel.mesh": {"make_search_mesh"},
    # shards searched slot by slot on torch devices in place of shard_map;
    # the files staged from their mmaps, one residency rule; the one-shot
    # call plans its groups without uploading them, so that each takes the
    # gather route where its queries touch few rows (its hit lists are held
    # to the JAX package's and the host engine's in
    # tests/test_torch_sharded_gather.py)
    "parallel.sharded_search": {"to_host", "sharded_total_hits", "sharded_search_counts",
                                "sharded_search_complete", "ShardedDatabase",
                                "build_sharded_groups", "search_sharded_groups",
                                "sharded_search_files"},
    # torch.distributed in place of jax.distributed
    "parallel.distributed": {"init_distributed", "make_global_search_mesh"},
    # the device argument of the device branch
    "sriracha.engine": {"search_accession"},
    # torch.profiler in place of jax.profiler
    "utils.profiling": {"device_trace"},
    # the device branches of each main() are the port's
    "cli.kwage": {"main"},
    "cli.maestro": {"main"},
    # usage names the card; main's device branches are the port's (held to
    # the original in tests/test_torch_sriracha.py)
    "cli.sriracha": {"usage", "main"},
}
# Names the port's module must carry over (a rename would otherwise pass
# unseen).
REQUIRED = {
    "native": {"get_lib", "CountingBuilder", "canonical_kmers_native", "murmur32_native",
               "transpose_bits_native", "scan_file_native", "pack_file_native"},
    "pipeline.build_db": {"transpose_filters", "build_dbz_from_bloom_files"},
    "pipeline.make_bloom": {"BuildOptions", "BloomInvalid", "counting_filter_log2_len",
                            "build_bloom_from_sequences", "_finish_build", "DeviceBatchPrep",
                            "_src_iter", "prepare_device_batch", "DeviceScatterState",
                            "finish_device_batch", "build_blooms_device_batch",
                            "build_bloom_from_file"},
    "parallel.maestro": {"SourceResolver", "BloomStream", "LocalFastaResolver",
                         "PrefetchResolver", "StreamingResolver", "MaestroOptions",
                         "_build_bloom_streamed", "execute_bloom_task", "prepare_bloom_batch",
                         "finish_bloom_batch", "execute_bloom_batch", "_DeviceDispatcher",
                         "_LazyInfos", "Maestro"},
    "parallel.remote": {"QueueAuthError", "RemoteWorker", "run_distributed_maestro"},
    "parallel.sharded_search": {"sharded_search_files"},
    "sriracha.engine": {"SrirachaOptions", "SearchMatch", "StreamStats", "search_reads",
                        "load_subject_kmers", "format_results", "iter_reads_range",
                        "merge_slice_tsvs", "assign_read_range"},
    "utils.profiling": {"scope", "report", "reset"},
    "cli.kwage": {"find_db_files", "usage"},
    "cli.maestro": {"usage"},
    "cli.sriracha": {"usage", "main"},
}


# String constants that differ on purpose inside a function that is
# otherwise held to its original, statement for statement: (module, name) ->
# {a piece of the port's text: the original's}. The port's usage() says where its
# device flags run (one CUDA card), the original's says the TPU.
REWORDED = {
    ("cli.kwage", "usage"): {
        "\t[--device (run the search on the CUDA device KWAGE_TORCH_DEVICE names, default "
        "cuda; several visible cards shard the files over a filters-axis mesh)] "
        "(engine extension)":
        "\t[--device (run the search on the TPU; multiple visible chips auto-shard over a "
        "filters-axis mesh)] (engine extension)",
    },
    ("cli.maestro", "usage"): {
        "\t[--device-build (exact-count thresholding on the CUDA device KWAGE_TORCH_DEVICE "
        "names, default cuda; one card; ":
        "\t[--device-build (exact-count thresholding on the TPU; ",
        "\t[--device-transpose (bit-slice transpose on the same CUDA device)] "
        "(engine extension)":
        "\t[--device-transpose (bit-slice transpose on the TPU)] (engine extension)",
    },
}


def _shared_names(path: str) -> list[str]:
    """Top-level functions and classes of the kwage_tpu module that its
    copy also defines, from the sources (nothing is imported to collect)."""
    def names(pkg: pathlib.Path) -> list[str]:
        file = pkg / (path.replace(".", "/") + ".py")
        if not file.exists():
            file = pkg / path.replace(".", "/") / "__init__.py"
        return [n.name for n in ast.parse(file.read_text()).body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))]

    ported = set(names(PORT_PKG))
    return [n for n in names(JAX_PKG) if n in ported]


CARRIED = [(path, name) for path, differ in MERGED.items()
           for name in _shared_names(path) if name not in differ]


def _statements(obj) -> str:
    """A function's or class's AST without docstrings, annotations and
    import statements."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            node.returns = None
            for a in node.args.args + node.args.kwonlyargs + node.args.posonlyargs:
                a.annotation = None
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            kept = [x for x in stmts if not isinstance(x, (ast.Import, ast.ImportFrom))]
            if (field == "body" and kept and isinstance(kept[0], ast.Expr)
                    and isinstance(kept[0].value, ast.Constant)
                    and isinstance(kept[0].value.value, str)
                    and isinstance(node, (ast.FunctionDef, ast.ClassDef, ast.Module))):
                kept = kept[1:]
            setattr(node, field, kept)
    return ast.dump(tree)


@pytest.mark.parametrize("path,name", CARRIED, ids=[f"{p}.{n}" for p, n in CARRIED])
def test_carried_over_code_equals_its_original(path, name):
    original = getattr(importlib.import_module(f"kwage_tpu.{path}"), name)
    copy = getattr(importlib.import_module(f"kwage_tpu_torch.{path}"), name)
    ported = _statements(copy)
    for ours, theirs in REWORDED.get((path, name), {}).items():
        # (a literal may be one piece of a longer concatenated constant)
        assert repr(ours)[1:-1] in ported, f"{path}.{name} no longer says {ours!r}"
        ported = ported.replace(repr(ours)[1:-1], repr(theirs)[1:-1])
    assert ported == _statements(original)


@pytest.mark.parametrize("path,name", sorted(REWORDED))
def test_port_usage_names_no_tpu(path, name, capsys):
    usage = getattr(importlib.import_module(f"kwage_tpu_torch.{path}"), name)
    buf = io.StringIO()
    if inspect.signature(usage).parameters:
        usage(buf)          # kwage's takes its stream
    else:
        usage()
    out = capsys.readouterr()
    text = buf.getvalue() + out.out + out.err
    assert "TPU" not in text and "auto-shard" not in text
    assert "KWAGE_TORCH_DEVICE" in text


@pytest.mark.parametrize("path", sorted(REQUIRED))
def test_merged_module_carries_its_host_names(path):
    carried = {n for p, n in CARRIED if p == path} | MERGED[path]
    assert REQUIRED[path] <= carried, sorted(REQUIRED[path] - carried)


# The mesh modules: every public function and class of the original has its
# counterpart of the same name, with the same parameters in the same order
# (the port may add optional ones after them).
MESH_MODULES = ["parallel.mesh", "parallel.sharded_search", "parallel.distributed"]


@pytest.mark.parametrize("path", MESH_MODULES)
def test_mesh_module_keeps_names_and_signatures(path):
    original = importlib.import_module(f"kwage_tpu.{path}")
    copy = importlib.import_module(f"kwage_tpu_torch.{path}")
    public = [n.name for n in ast.parse(inspect.getsource(original)).body
              if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")]
    assert public
    for name in public:
        theirs, ours = getattr(original, name), getattr(copy, name)
        pairs = [(theirs, ours)]
        if inspect.isclass(theirs):
            pairs = [(getattr(theirs, m), getattr(ours, m)) for m, v in vars(theirs).items()
                     if not m.startswith("_") or m == "__init__"]
            assert pairs, name
        for f_theirs, f_ours in pairs:
            want = list(inspect.signature(getattr(f_theirs, "__func__", f_theirs)).parameters)
            got = list(inspect.signature(getattr(f_ours, "__func__", f_ours)).parameters)
            assert got[: len(want)] == want, (name, got, want)
            extra = list(inspect.signature(getattr(f_ours, "__func__", f_ours)).parameters.values())
            assert all(p.default is not p.empty for p in extra[len(want):]), (name, got)


def test_versions_equal_the_original():
    import kwage_tpu
    import kwage_tpu_torch

    for name in ("KWAGE_VERSION", "INVENTORY_VERSION", "MAESTRO_VERSION", "SRIRACHA_VERSION"):
        assert getattr(kwage_tpu_torch, name) == getattr(kwage_tpu, name)


# --- behaviour: the port's host engines give kwage_tpu's bytes ----------------

@pytest.fixture(scope="module")
def manifest(golden_dir):
    with open(golden_dir / "e2e" / "manifest.json") as f:
        return json.load(f)


def _build_corpus(pkg: str, manifest, data_dir, work):
    """Golden corpus -> .bloom files -> one .db per group through ``pkg``'s
    host pipeline. Returns (bloom paths, db paths)."""
    core = importlib.import_module(f"{pkg}.core")
    bloom_file = importlib.import_module(f"{pkg}.io.bloom_file")
    make_bloom = importlib.import_module(f"{pkg}.pipeline.make_bloom")
    build_db = importlib.import_module(f"{pkg}.pipeline.build_db")
    opts = make_bloom.BuildOptions(
        kmer_len=manifest["k"], min_kmer_count=manifest["min_kmer_count"],
        false_positive_probability=manifest["fp"],
        min_log_2_filter_len=manifest["minL"], max_log_2_filter_len=manifest["maxL"],
        min_log_2_count_len=manifest["minLc"], max_log_2_count_len=manifest["maxLc"])
    work.mkdir()
    blooms, params = {}, {}
    for acc in manifest["accessions"]:
        info = core.FilterInfo(run_accession=core.str_to_accession(acc))
        rec = make_bloom.build_bloom_from_file(str(data_dir / f"{acc}.fasta"), opts, info)
        blooms[acc] = work / f"{acc}.bloom"
        params[acc] = rec.param
        bloom_file.write_bloom_file(str(blooms[acc]), rec)
    dbs = []
    for gi, group in enumerate(manifest["db_groups"]):
        dbs.append(work / f"sra.{gi}.db")
        build_db.build_db_from_bloom_files(
            str(dbs[-1]), params[group[0]], [str(blooms[a]) for a in group], chunk_bits=1 << 12)
    return blooms, dbs


@pytest.fixture(scope="module")
def corpora(manifest, data_dir, tmp_path_factory):
    work = tmp_path_factory.mktemp("copies")
    return {pkg: _build_corpus(pkg, manifest, data_dir, work / pkg)
            for pkg in ("kwage_tpu", "kwage_tpu_torch")}


def test_host_build_bloom_from_file_bytes(corpora, manifest):
    jax_blooms, port_blooms = corpora["kwage_tpu"][0], corpora["kwage_tpu_torch"][0]
    for acc in manifest["accessions"]:
        assert port_blooms[acc].read_bytes() == jax_blooms[acc].read_bytes(), acc


def test_host_build_db_bytes_and_golden_digests(corpora, golden_dir):
    import hashlib

    with open(golden_dir / "e2e" / "digests.json") as f:
        digests = json.load(f)
    for jax_db, port_db in zip(corpora["kwage_tpu"][1], corpora["kwage_tpu_torch"][1]):
        assert port_db.read_bytes() == jax_db.read_bytes(), port_db.name
        assert hashlib.sha256(port_db.read_bytes()).hexdigest() == digests[port_db.name]


@pytest.mark.parametrize("threshold", [1.0, 0.75, 0.3])
def test_host_search_database_files_matches(corpora, data_dir, threshold):
    from kwage_tpu.io.sequence import iter_sequences
    from kwage_tpu.search import engine as jax_engine
    from kwage_tpu.search.output import render_csv as jax_csv
    from kwage_tpu.search.output import render_json as jax_json
    from kwage_tpu_torch.search import engine as port_engine
    from kwage_tpu_torch.search.output import render_csv, render_json

    queries = [(i, seq) for i, (_, seq) in enumerate(iter_sequences(str(data_dir / "queries.fasta")))]
    dbs = [str(p) for p in corpora["kwage_tpu_torch"][1]]
    want = jax_engine.search_database_files(dbs, queries, threshold)
    got = port_engine.search_database_files(dbs, queries, threshold)
    assert ({q: [dataclasses.asdict(m) for m in r] for q, r in got.items()}
            == {q: [dataclasses.asdict(m) for m in r] for q, r in want.items()})
    assert any(got.values())
    ordered = lambda res: [(f"q{q}", res[q]) for q in sorted(res)]  # noqa: E731
    assert render_csv(ordered(got)) == jax_csv(ordered(want))
    assert render_json(ordered(got), threshold) == jax_json(ordered(want), threshold)


@pytest.mark.parametrize("k,threshold", [(11, 0.4), (21, 0.2), (32, 0.1)])
def test_host_sriracha_search_reads_matches(data_dir, k, threshold):
    from kwage_tpu.sriracha import engine as jax_engine
    from kwage_tpu_torch.sriracha import engine as port_engine

    queries = str(data_dir / "sriracha_queries.fasta")
    reads = str(data_dir / "sriracha_reads.fasta")
    texts = []
    for eng in (jax_engine, port_engine):
        opt = eng.SrirachaOptions(kmer_len=k, kmer_match_threshold=threshold)
        subj = eng.load_subject_kmers([queries], k)
        results = eng.search_reads(eng.iter_reads_range(reads, 0, 1), subj, opt)
        texts.append(eng.format_results(reads, subj, results))
        assert eng.format_results(reads, subj, eng.search_accession(reads, subj, opt)) == texts[-1]
    assert texts[1] == texts[0] and "\t" in texts[0]


@pytest.mark.parametrize("k", [1, 15, 16, 17, 31, 32])
def test_native_and_fallback_agree_with_the_original(k):
    import kwage_tpu.native as jax_native
    import kwage_tpu_torch.native as port_native
    from kwage_tpu_torch.core.hash import murmur32_words
    from kwage_tpu_torch.core.words import canonical_kmers

    assert port_native.available(), "the port's native library did not build"
    rng = np.random.default_rng(100 + k)
    seq = np.frombuffer(b"ACGTNacgt", np.uint8)[
        rng.choice(9, size=700, p=[0.22, 0.22, 0.22, 0.22, 0.02, 0.025, 0.025, 0.025, 0.025])]
    text = seq.tobytes()
    want = jax_native.canonical_kmers_native(text, k)
    got = port_native.canonical_kmers_native(text, k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(canonical_kmers(text.decode(), k), want)
    words = np.unique(want)
    for nh in (1, 5):
        hashes = jax_native.murmur32_native(words, k, nh)
        np.testing.assert_array_equal(port_native.murmur32_native(words, k, nh), hashes)
        np.testing.assert_array_equal(murmur32_words(words, k, nh), hashes)


def test_native_library_builds_outside_the_package():
    """The port's library goes to build/kwage_tpu_torch/, named by the sha
    of its source; nothing is written beside the source."""
    import kwage_tpu_torch.native as port_native

    assert port_native.available()
    built = list((REPO / "build" / "kwage_tpu_torch").glob(
        f"libkwage_native_{port_native._source_tag()}.so"))
    assert len(built) == 1

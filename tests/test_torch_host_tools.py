"""The port's host pipeline modules (``pipeline/{inventory,merge_db,sra_meta}``)
and its 12 small CLIs against their kwage_tpu twins: each CLI runs twice on
the same inputs (made as tests/test_inventory.py, test_merge_db.py,
test_cli_tools.py and test_debug_tools.py make them), once per package, in
two copies of one working directory. The exit code, stdout (timings and
temporary paths masked) and every file the run leaves in its directory
must be equal. Every ``kwage-*-torch`` script names a port module's main."""

import contextlib
import importlib
import io
import json
import os
import pathlib
import re
import shutil
import tempfile
import time
import tomllib

import numpy as np
import pytest

from test_inventory import metadata_tar  # noqa: F401  (the miniature NCBI archive)

REPO = pathlib.Path(__file__).resolve().parent.parent

# Run-to-run noise in stdout: wall times and rates, and temporary directories.
_NOISE = [(re.compile(rf"({re.escape(tempfile.gettempdir())}|/tmp)/[\w./-]+"), "<tmp>"),
          (re.compile(r"\d+(\.\d+)?(e[-+]?\d+)? ?(sec|s\b|Mbp/sec|Mbp/s|reads/sec|ms)"), "<t>")]


def _mask(text: str) -> str:
    for pattern, repl in _NOISE:
        text = pattern.sub(repl, text)
    return text


@pytest.fixture(autouse=True)
def reference_native_loaded():
    """kwage_tpu.native builds its library at first use through one
    temporary file shared by every process, then renames it into place.
    Test processes that start that build together race on it: a process
    can load the library while another is still writing it, or find its
    temporary file renamed away, and then keeps the error (and kwage_tpu's
    Python fallbacks, whose verbose output the native paths do not print)
    for the rest of its life. Where the built library is present, the
    error is cleared and the library loaded again (waiting out a build
    that is still being written), so that each twin runs kwage_tpu's
    native path, as it does in a process that won the race."""
    from kwage_tpu import native

    so = os.path.join(native._DIR, f"libkwage_native_{native._source_tag()}.so")
    deadline = time.monotonic() + 30
    while native._LIB is None and native._LIB_ERR is not None and os.path.exists(so):
        native._LIB_ERR = None
        if native.get_lib() is not None or time.monotonic() > deadline:
            break
        time.sleep(1)
    yield


@pytest.fixture(scope="module")
def inputs(golden_dir, data_dir, tmp_path_factory):
    """One directory of inputs for every tool, built by kwage_tpu's host
    pipeline: .bloom files of the golden corpus's 4-filter group, a .db of
    them and two .db halves, two inventories and a FASTA of reads."""
    from kwage_tpu.core import FilterInfo, str_to_accession
    from kwage_tpu.io.bloom_file import read_bloom_file, write_bloom_file
    from kwage_tpu.io.inventory import write_inventory
    from kwage_tpu.pipeline import BuildOptions, build_bloom_from_file, build_db_from_bloom_files

    with open(golden_dir / "e2e" / "manifest.json") as f:
        manifest = json.load(f)
    work = tmp_path_factory.mktemp("host_tools_inputs")
    opts = BuildOptions(
        kmer_len=manifest["k"], min_kmer_count=manifest["min_kmer_count"],
        false_positive_probability=manifest["fp"],
        min_log_2_filter_len=manifest["minL"], max_log_2_filter_len=manifest["maxL"],
        min_log_2_count_len=manifest["minLc"], max_log_2_count_len=manifest["maxLc"])
    group = manifest["db_groups"][2]  # 4 filters, L=13, h=3
    blooms = []
    for acc in group:
        rec = build_bloom_from_file(str(data_dir / f"{acc}.fasta"), opts,
                                    FilterInfo(run_accession=str_to_accession(acc)))
        write_bloom_file(str(work / f"{acc}.bloom"), rec)
        blooms.append(str(work / f"{acc}.bloom"))
    param = read_bloom_file(blooms[0], with_bits=False).param
    build_db_from_bloom_files(str(work / "sra.2.db"), param, blooms)
    build_db_from_bloom_files(str(work / "part_a.db"), param, blooms[:2])
    build_db_from_bloom_files(str(work / "part_b.db"), param, blooms[2:])
    write_inventory(str(work / "inv.bin"), [
        FilterInfo(run_accession=str_to_accession(a)) for a in manifest["accessions"]])
    write_inventory(str(work / "a.bin"), [FilterInfo(run_accession=str_to_accession(x))
                                          for x in ("SRR1", "SRR2", "SRR3")])
    write_inventory(str(work / "b.bin"), [FilterInfo(run_accession=str_to_accession(x))
                                          for x in ("SRR2", "SRR4")])
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGT"), size=400)) for _ in range(8)]
    with open(work / "reads.fasta", "w") as f:
        for i, s in enumerate(seqs + seqs[:4]):
            f.write(f">r{i}\n{s}\n")
    (work / "bff").mkdir()
    return work, manifest


def _counting_args(manifest) -> list[str]:
    return ["-k", str(manifest["k"]), "--min-kmer-count", str(manifest["min_kmer_count"]),
            "--len.min", str(manifest["minL"]), "--len.max", str(manifest["maxL"]),
            "--count-len.min", str(manifest["minLc"]), "--count-len.max",
            str(manifest["maxLc"])]


# (tool, argv builder(manifest, data_dir, metadata_tar)): argv relative to the
# working directory, which holds a copy of the inputs.
CASES = {
    "sra_inventory": lambda m, d, tar: ["-i", tar, "-o", "out_inv.bin"],
    "sra_inventory_list": lambda m, d, tar: ["-i", tar, "--list", "--strategy", "WGS"],
    "inventory_dump": lambda m, d, tar: ["inv.bin"],
    "sra_dump": lambda m, d, tar: ["--print", "--max-read", "2", "reads.fasta"],
    "sra_diff": lambda m, d, tar: ["a.bin", "b.bin"],
    "merge_db": lambda m, d, tar: ["part_a.db", "part_b.db"],
    "manual_db": lambda m, d, tar: ["-d", "sra.2.db", "-s", "status.bin", "--meta", "inv.bin"],
    "dump_db": lambda m, d, tar: ["--bits", "4", "-i", "sra.2.db"],
    "dump_db_to_file": lambda m, d, tar: ["-o", "dump.txt", "--bits.all", "-i", "part_a.db"],
    "dump_bloom": lambda m, d, tar: [f"{m['db_groups'][2][0]}.bloom"],
    "db_debug": lambda m, d, tar: ["-n", "9", "--len", "12", "--seed", "3"],
    "bloom_diff": lambda m, d, tar: [f"{m['db_groups'][2][0]}.bloom",
                                     f"{m['db_groups'][2][1]}.bloom"],
    "bloom_test": lambda m, d, tar: ["--min-kmer-count", "2", "--len.max", "20",
                                     "--len.count", "18", "reads.fasta"],
    "bff": lambda m, d, tar: _counting_args(m) + ["-o", "bff", "--source-dir", str(d),
                                                  m["accessions"][0]],
}
TOOLS = {case: case.removesuffix("_list").removesuffix("_to_file") for case in CASES}


def _run_tool(pkg: str, tool: str, argv: list[str], cwd: pathlib.Path, monkeypatch):
    """(exit code, stdout, stderr) of one run in ``cwd``, masked."""
    main = importlib.import_module(f"{pkg}.cli.{tool}").main
    out, err = io.StringIO(), io.StringIO()
    monkeypatch.chdir(cwd)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, _mask(out.getvalue()), _mask(err.getvalue())


def _tree(root: pathlib.Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_equals_its_kwage_tpu_twin(case, inputs, data_dir, metadata_tar, tmp_path,  # noqa: F811
                                       monkeypatch):
    work, manifest = inputs
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    argv = CASES[case](manifest, data_dir, metadata_tar)
    runs = {}
    for pkg in ("kwage_tpu", "kwage_tpu_torch"):
        cwd = tmp_path / pkg
        shutil.copytree(work, cwd)
        runs[pkg] = (*_run_tool(pkg, TOOLS[case], argv, cwd, monkeypatch), _tree(cwd))
    want, got = runs["kwage_tpu"], runs["kwage_tpu_torch"]
    assert got[0] == want[0] == 0, (got[0], want[0])
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3].keys() == want[3].keys()
    for name in want[3]:
        assert got[3][name] == want[3][name], name
    # The run did something: it printed, or it wrote or changed a file.
    assert want[1].strip() or want[2].strip() or want[3] != _tree(work), case


def test_cli_usage_and_bad_flags_equal_their_twins(capsys):
    """No arguments and an unknown flag: the same exit code and output."""
    for tool in sorted(set(TOOLS.values())):
        for argv in ([], ["--no-such-flag"]):
            outs = []
            for pkg in ("kwage_tpu", "kwage_tpu_torch"):
                main = importlib.import_module(f"{pkg}.cli.{tool}").main
                rc = main(argv)
                cap = capsys.readouterr()
                outs.append((rc, _mask(cap.out), _mask(cap.err)))
            assert outs[1] == outs[0], (tool, argv)


@pytest.mark.parametrize("filtered", [False, True])
def test_inventory_module_equals_its_twin(metadata_tar, tmp_path, filtered):  # noqa: F811
    """pipeline.inventory: the parsed records and the written inventory
    (the port's own native library, then its Python twin) equal kwage_tpu's."""
    import dataclasses

    from kwage_tpu.pipeline import inventory as jax_inv
    from kwage_tpu_torch.pipeline import inventory as port_inv

    want_db, want_attrs = jax_inv.parse_sra_metadata(metadata_tar, verbose=False)
    got_db, got_attrs = port_inv.parse_sra_metadata(metadata_tar, verbose=False)
    assert [dataclasses.asdict(r) for r in got_db] == [dataclasses.asdict(r) for r in want_db]
    assert got_attrs == want_attrs and want_db
    filt = dict(required_strategy={"WGS", "RNA-Seq"}) if filtered else {}
    n = {}
    for pkg, mod in (("jax", jax_inv), ("port", port_inv)):
        n[pkg] = mod.build_inventory(metadata_tar, str(tmp_path / f"{pkg}.bin"),
                                     mod.InventoryFilters(**filt))
    assert n["port"] == n["jax"] > 0
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


def test_merge_db_module_equals_its_twin(inputs, tmp_path):
    """pipeline.merge_db: merge_database_files gives kwage_tpu's bytes."""
    from kwage_tpu.pipeline.merge_db import merge_database_files as jax_merge
    from kwage_tpu_torch.pipeline.merge_db import merge_database_files as port_merge

    work, _ = inputs
    for name, merge in (("jax", jax_merge), ("port", port_merge)):
        d = tmp_path / name
        d.mkdir()
        for f in ("part_a.db", "part_b.db"):
            shutil.copy(work / f, d / f)
        assert merge(str(d / "part_a.db"), str(d / "part_b.db"), 4, verbose=False) == (0, "")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert (tmp_path / "port" / "part_a.db").read_bytes() == (work / "sra.2.db").read_bytes()


def test_sra_meta_module_equals_its_twin(inputs):
    from kwage_tpu.pipeline.sra_meta import number_of_bases as jax_bases
    from kwage_tpu_torch.pipeline.sra_meta import number_of_bases as port_bases

    work, _ = inputs
    assert port_bases(str(work / "reads.fasta")) == jax_bases(str(work / "reads.fasta")) \
        == (400 * 12, 12)


def _scripts() -> dict[str, str]:
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def test_every_torch_script_names_a_port_main():
    """Each kwage-*-torch script resolves to a main() of the port, and each
    kwage_tpu script has its -torch twin on the twin module."""
    scripts = _scripts()
    torch_scripts = {name: target for name, target in scripts.items() if name.endswith("-torch")}
    assert len(torch_scripts) == 15
    for name, target in torch_scripts.items():
        module, _, func = target.partition(":")
        assert module.startswith("kwage_tpu_torch.cli."), (name, target)
        assert callable(getattr(importlib.import_module(module), func)), name
    for name, target in scripts.items():
        if not name.endswith("-torch"):
            assert scripts[f"{name}-torch"] == target.replace("kwage_tpu.", "kwage_tpu_torch.", 1)
    assert all(name.startswith("kwage") for name in scripts)

"""kwage_tpu_torch and chip_smoke.py import torch, numpy, the standard
library and the port itself: never jax, and nothing of kwage_tpu (the port
keeps its own copy of every host module it uses, and runs on a GPU machine
that has neither). The import checks run in subprocesses, because this test
process has jax loaded already (tests/conftest.py)."""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "kwage_tpu_torch"

# jax itself, and any module of kwage_tpu (the word boundary lets
# kwage_tpu_torch pass).
REFUSED_IMPORT = re.compile(
    r"^\s*(from|import)\s+(jax\b|kwage_tpu(\.|\s|$))", re.MULTILINE)

# Appended to a subprocess's code: no jax* and no kwage_tpu[.*] module loaded.
ASSERT_CLEAN = (
    "import sys\n"
    "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
    "             or m == 'kwage_tpu' or m.startswith('kwage_tpu.'))\n"
    "assert not bad, bad\n"
)

REFUSED_LINES = [
    "import jax", "import jax.numpy as jnp", "from jax import lax",
    "from kwage_tpu.ops.search import x", "from kwage_tpu.ops import search",
    "    import kwage_tpu.search.resident", "import kwage_tpu.ops.kmers",
    "from kwage_tpu.parallel.mesh import make_search_mesh",
    "from kwage_tpu.parallel.sharded_search import x",
    "    from kwage_tpu.parallel.distributed import shard_inventory",
    "from kwage_tpu.parallel import mesh", "from kwage_tpu.sriracha.device import x",
    "import kwage_tpu.sriracha.device", "from kwage_tpu.sriracha import engine",
    "from kwage_tpu.sriracha import device as jdev",
    # jax-free modules of kwage_tpu: refused all the same.
    "from kwage_tpu.search.engine import x",
    "from kwage_tpu.search.output import render_csv",
    "from kwage_tpu.parallel.maestro import Maestro",
    "from kwage_tpu.parallel import maestro as _base",
    "from kwage_tpu.cli.maestro import LONG_OPTS, usage",
    "from kwage_tpu.pipeline.make_bloom import BloomInvalid",
    "import kwage_tpu.sriracha.engine as host_engine",
    "from kwage_tpu.sriracha.engine import SearchMatch",
    "    from kwage_tpu.sriracha.sra_source import (",
    "    import kwage_tpu.sriracha.vdb as _vdb",
    "from kwage_tpu.cli._render import cli_errors",
    "import kwage_tpu", "from kwage_tpu import KWAGE_VERSION", "import kwage_tpu as k",
]
ALLOWED_LINES = [
    "import jaxlib_free", "import kwage_tpu_torch", "from kwage_tpu_torch import kernels",
    "from kwage_tpu_torch.core.words import canonical_kmers", "from ..core import FilterInfo",
    "    from kwage_tpu_torch.native import murmur32_native", "import kwage_tpu_torchx",
]


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _run(code: str, timeout: int = 600, **env):
    env = dict(os.environ, OMP_NUM_THREADS="2", **env)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_every_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import kwage_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    kwage_tpu_torch.__path__, 'kwage_tpu_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        + ASSERT_CLEAN +
        "print(len(names))\n"
    )
    res = _run(code, timeout=300)
    assert res.returncode == 0, res.stderr
    n_modules = int(res.stdout.strip().splitlines()[-1])
    assert n_modules + 1 == len(list(PKG.rglob("*.py")))  # + the package itself


def test_no_source_imports_jax():
    offenders = [
        f"{p.relative_to(REPO)}: {m.group(0).strip()}"
        for p in _sources()
        for m in REFUSED_IMPORT.finditer(p.read_text())
    ]
    assert not offenders, offenders


def test_no_source_reaches_kwage_tpu_by_name():
    """No importlib / sys.modules route to kwage_tpu either."""
    by_name = re.compile(r"""(import_module|__import__|sys\.modules)\s*[\(\[]\s*f?["']kwage_tpu(["'.])""")
    offenders = [str(p.relative_to(REPO)) for p in _sources() if by_name.search(p.read_text())]
    assert not offenders, offenders


def test_pattern_catches_jax_imports():
    for line in REFUSED_LINES:
        assert REFUSED_IMPORT.search(line), line
    for line in ALLOWED_LINES:
        assert not REFUSED_IMPORT.search(line), line


@pytest.mark.parametrize("line", REFUSED_LINES)
def test_pattern_refuses(line):
    assert REFUSED_IMPORT.search(line)


@pytest.mark.parametrize("line", ALLOWED_LINES)
def test_pattern_allows(line):
    assert not REFUSED_IMPORT.search(line)


def test_sriracha_device_run_loads_no_jax(tmp_path):
    """A whole ``kwage-sriracha-torch --device`` run (the plain versions on
    the CPU), and the same run on the host engine, load neither jax nor
    kwage_tpu and write the same TSV."""
    data = REPO / "tests" / "data"
    out, host = tmp_path / "out.tsv", tmp_path / "host.tsv"
    args = ["-k", "11", "-t", "0.4", "-i", str(data / "sriracha_queries.fasta")]
    reads = str(data / "sriracha_reads.fasta")
    code = (
        "from kwage_tpu_torch.cli.sriracha import main\n"
        f"assert main({args + ['--device', '-o', str(out), reads]!r}) == 0\n"
        f"assert main({args + ['-o', str(host), reads]!r}) == 0\n"
        + ASSERT_CLEAN
    )
    res = _run(code, timeout=300, KWAGE_TORCH_DEVICE="cpu")
    assert res.returncode == 0, res.stderr
    assert out.read_text().endswith("//\n") and "\t" in out.read_text()
    assert out.read_bytes() == host.read_bytes()


def test_maestro_and_kwage_runs_load_no_jax(tmp_path, golden_dir, data_dir):
    """A whole ``kwage-maestro-torch --device-build --device-transpose`` run
    on the golden corpus, then ``kwage-torch`` over its .db files with and
    without ``--device`` (the plain versions on the CPU): neither jax nor
    kwage_tpu is loaded, the .db files have the golden digests and both
    searches write the golden bytes."""
    with open(golden_dir / "e2e" / "manifest.json") as f:
        manifest = json.load(f)
    golden = (golden_dir / "e2e" / "csv_t075_file.out").read_text()
    maestro_args = [
        "--meta", str(tmp_path / "inventory.bin"), "--scratch", str(tmp_path),
        "--status", str(tmp_path / "status.bin"), "--source-dir", str(data_dir),
        "-k", str(manifest["k"]), "-p", str(manifest["fp"]),
        "--min-kmer-count", str(manifest["min_kmer_count"]),
        "--len.min", str(manifest["minL"]), "--len.max", str(manifest["maxL"]),
        "--count-len.min", str(manifest["minLc"]), "--count-len.max", str(manifest["maxLc"]),
        "--device-build", "--device-transpose", "--workers", "2", "--device-batch", "16"]
    kwage_args = ["-d", str(tmp_path / "database"), "-t", "0.75", "--o.csv",
                  "-i", str(data_dir / "queries.fasta")]
    code = (
        "from kwage_tpu_torch.cli.kwage import main as kwage\n"
        "from kwage_tpu_torch.cli.maestro import main as maestro\n"
        "from kwage_tpu_torch.core import FilterInfo, str_to_accession\n"
        "from kwage_tpu_torch.io.inventory import write_inventory\n"
        f"write_inventory({str(tmp_path / 'inventory.bin')!r},\n"
        f"    [FilterInfo(run_accession=str_to_accession(a)) for a in {manifest['accessions']!r}])\n"
        f"assert maestro({maestro_args!r}) == 0\n"
        f"assert kwage({kwage_args!r} + ['--device', '-o', {str(tmp_path / 'dev.csv')!r}]) == 0\n"
        f"assert kwage({kwage_args!r} + ['-o', {str(tmp_path / 'host.csv')!r}]) == 0\n"
        + ASSERT_CLEAN
    )
    res = _run(code, KWAGE_TORCH_DEVICE="cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    with open(golden_dir / "e2e" / "digests.json") as f:
        digests = json.load(f)
    import hashlib

    for gi in range(len(manifest["db_groups"])):
        got = hashlib.sha256((tmp_path / "database" / f"sra.{gi + 1}.db").read_bytes()).hexdigest()
        assert got == digests[f"sra.{gi}.db"], gi
    dev, host = (tmp_path / "dev.csv").read_text(), (tmp_path / "host.csv").read_text()
    assert dev == host
    # The golden file searched sra.0..: the same rows, whatever the file names.
    assert sorted(dev.splitlines()) == sorted(golden.splitlines())


def test_kwage_over_a_logical_mesh_loads_no_jax(tmp_path, golden_dir, data_dir):
    """``kwage-torch --device`` over a mesh of 2 logical shards on the CPU
    (the CPU listed twice as the visible devices), on .db files the port's host pipeline
    packed: neither jax nor kwage_tpu is loaded, the mesh modules are, and
    the bytes equal the host engine's and the single-device search's."""
    with open(golden_dir / "e2e" / "manifest.json") as f:
        manifest = json.load(f)
    kwage_args = ["-d", str(tmp_path), "-t", "0.75", "--o.csv",
                  "-i", str(data_dir / "queries.fasta")]
    code = (
        "import os, sys\n"
        "from kwage_tpu_torch.cli.kwage import main as kwage\n"
        "from kwage_tpu_torch.core import FilterInfo, str_to_accession\n"
        "from kwage_tpu_torch.io.bloom_file import write_bloom_file\n"
        "from kwage_tpu_torch.pipeline.build_db import build_db_from_bloom_files\n"
        "from kwage_tpu_torch.pipeline.make_bloom import BuildOptions, build_bloom_from_file\n"
        f"man, work, data = {manifest!r}, {str(tmp_path)!r}, {str(data_dir)!r}\n"
        "opts = BuildOptions(kmer_len=man['k'], min_kmer_count=man['min_kmer_count'],\n"
        "    false_positive_probability=man['fp'], min_log_2_filter_len=man['minL'],\n"
        "    max_log_2_filter_len=man['maxL'], min_log_2_count_len=man['minLc'],\n"
        "    max_log_2_count_len=man['maxLc'])\n"
        "for gi, group in enumerate(man['db_groups']):\n"
        "    blooms = []\n"
        "    for acc in group:\n"
        "        rec = build_bloom_from_file(os.path.join(data, acc + '.fasta'), opts,\n"
        "                                    FilterInfo(run_accession=str_to_accession(acc)))\n"
        "        blooms.append(os.path.join(work, acc + '.bloom'))\n"
        "        write_bloom_file(blooms[-1], rec)\n"
        "    build_db_from_bloom_files(os.path.join(work, f'sra.{gi}.db'), rec.param, blooms)\n"
        f"assert kwage({kwage_args!r} + ['--device', '-o', os.path.join(work, 'one.csv')]) == 0\n"
        "assert 'kwage_tpu_torch.parallel.sharded_search' not in sys.modules\n"
        "import torch, kwage_tpu_torch.parallel.mesh as mesh\n"
        "mesh.default_devices = lambda: [torch.device('cpu')] * 2\n"
        f"assert kwage({kwage_args!r} + ['--device', '-o', os.path.join(work, 'mesh.csv')]) == 0\n"
        "assert 'kwage_tpu_torch.parallel.sharded_search' in sys.modules\n"
        f"assert kwage({kwage_args!r} + ['-o', os.path.join(work, 'host.csv')]) == 0\n"
        + ASSERT_CLEAN
    )
    res = _run(code, KWAGE_TORCH_DEVICE="cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    mesh = (tmp_path / "mesh.csv").read_text()
    assert mesh == (tmp_path / "host.csv").read_text() == (tmp_path / "one.csv").read_text()
    golden = (golden_dir / "e2e" / "csv_t075_file.out").read_text()
    # The same rows as the golden run, whatever order the directory lists
    # the files in.
    assert sorted(mesh.splitlines()) == sorted(golden.splitlines())


def test_port_runs_with_kwage_tpu_out_of_the_way(tmp_path):
    """In a copy of the tree without kwage_tpu/, ``import chip_smoke`` and
    the three CLIs' --help still work."""
    import shutil

    shutil.copytree(PKG, tmp_path / "kwage_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    code = (
        "import chip_smoke\n"
        "from kwage_tpu_torch.cli import kwage, maestro, sriracha\n"
        "assert kwage.main(['-h']) == 0\n"
        "assert maestro.main(['-h']) == 0\n"
        "assert sriracha.main(['-h']) == 0\n"
        "from kwage_tpu_torch.parallel import distributed, mesh, sharded_search\n"
        "from kwage_tpu_torch.entry import dryrun_multichip\n"
        "import importlib.util\n"
        "assert importlib.util.find_spec('kwage_tpu') is None\n"
        + ASSERT_CLEAN
    )
    env = dict(os.environ, PYTHONPATH="", KWAGE_TORCH_DEVICE="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_remote_worker_and_a_small_cli_load_no_jax(tmp_path, golden_dir, data_dir):
    """``kwage-maestro-torch --coordinator`` (in a thread) and
    ``kwage-maestro-torch --worker`` with the device flags, both in one
    process, build the golden corpus's .db files; ``kwage-dump-db-torch``
    then reads one. Neither jax nor kwage_tpu is loaded. The coordinator
    binds port 0 and the worker reaches the address it bound."""
    with open(golden_dir / "e2e" / "manifest.json") as f:
        manifest = json.load(f)
    common = [
        "--meta", str(tmp_path / "inventory.bin"), "--scratch", str(tmp_path),
        "--status", str(tmp_path / "status.bin"), "--source-dir", str(data_dir),
        "-k", str(manifest["k"]), "-p", str(manifest["fp"]),
        "--min-kmer-count", str(manifest["min_kmer_count"]),
        "--len.min", str(manifest["minL"]), "--len.max", str(manifest["maxL"]),
        "--count-len.min", str(manifest["minLc"]), "--count-len.max", str(manifest["maxLc"]),
        "--device-build", "--device-transpose", "--device-batch", "4"]
    code = (
        "import queue, threading\n"
        "from kwage_tpu_torch.cli.dump_db import main as dump_db\n"
        "from kwage_tpu_torch.cli.maestro import main as maestro\n"
        "from kwage_tpu_torch.core import FilterInfo, str_to_accession\n"
        "from kwage_tpu_torch.io.inventory import write_inventory\n"
        "from kwage_tpu_torch.parallel import remote\n"
        f"write_inventory({str(tmp_path / 'inventory.bin')!r},\n"
        f"    [FilterInfo(run_accession=str_to_accession(a)) for a in {manifest['accessions']!r}])\n"
        "bound, start = queue.Queue(), remote.CoordinatorServer.start\n"
        "remote.CoordinatorServer.start = lambda self: (start(self), bound.put(self.address))[0]\n"
        "rcs = []\n"
        f"coord = threading.Thread(target=lambda: rcs.append(maestro({common!r} + [\n"
        "    '--workers', '1', '--coordinator', '127.0.0.1:0'])))\n"
        "coord.start()\n"
        "host, port = bound.get(timeout=600)\n"
        f"assert maestro({common!r} + ['--worker', f'{{host}}:{{port}}']) == 0\n"
        "coord.join(120)\n"
        "assert rcs == [0], rcs\n"
        f"assert dump_db(['-i', {str(tmp_path / 'database' / 'sra.1.db')!r}]) == 0\n"
        + ASSERT_CLEAN
    )
    res = _run(code, KWAGE_TORCH_DEVICE="cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Worker finished" in res.stderr and "num_filter" in res.stdout
    import hashlib

    with open(golden_dir / "e2e" / "digests.json") as f:
        digests = json.load(f)
    for gi in range(len(manifest["db_groups"])):
        got = hashlib.sha256((tmp_path / "database" / f"sra.{gi + 1}.db").read_bytes()).hexdigest()
        assert got == digests[f"sra.{gi}.db"], gi


@pytest.mark.parametrize("program,argv,env", [
    ("soak", ["2", "1003"], {}),
    ("at_scale", ["{work}"], {"SCALE_N_ACC": "12", "SCALE_HALT": "8", "SCALE_GENOME": "3000",
                              "SCALE_DEVICE_N": "2", "SCALE_REQUIRE_FULL": "0"}),
    ("prod_l", ["{work}"], {"SCALE_N_ACC": "40", "SCALE_HALT": "36", "SCALE_GENOME": "3000",
                            "SCALE_L": "16", "SCALE_DEVICE_N": "2", "SCALE_REQUIRE_FULL": "0"}),
    ("dry_sched", ["--out", "{work}.json"], {"DRY_N": "300"}),
    ("distributed", ["{work}"], {"SCALE_N_ACC": "6", "SCALE_GENOME": "1500",
                                 "SCALE_SKIP_CRASH": "1", "SCALE_SKIP_LATENCY": "1"}),
])
def test_scale_programs_load_no_jax(tmp_path, program, argv, env):
    """Each scale program, run whole on the CPU (the plain versions, tiny
    knobs), exits 0 and loads neither jax nor kwage_tpu."""
    argv = [a.format(work=tmp_path / "work") for a in argv]
    code = (
        "import sys\n"
        f"from kwage_tpu_torch.scale.{program} import main\n"
        f"assert main({argv!r}) == 0\n"
        + ASSERT_CLEAN
    )
    res = _run(code, KWAGE_TORCH_DEVICE="cpu", TMPDIR=str(tmp_path), **env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert '"ok": true' in res.stdout or "0 failures" in res.stdout


@pytest.mark.parametrize("program,env", [
    ("search_phases", {"BENCH_LOG2_L": "10", "BENCH_NQ": "2", "BENCH_NK": "64"}),
    ("sorted_gather", {"LOG2_L": 10, "N": 1024}),
    ("ingest", {"INGEST_ACCS": "2", "INGEST_READS": "32", "INGEST_LEN": "64",
                "INGEST_LOG2L": "12"}),
    ("build_phases", {"PH_N_ACC": "2", "PH_BP": "12000", "PH_REPS": "1"}),
    ("sriracha_model", {"SRIRACHA_NREADS": "600"}),
    ("scaling", {"SCALING_LOG2_L": "9", "SCALING_W_PER_DEV": "8", "SCALING_NQ": "2",
                 "SCALING_NK": "48", "LOGICAL": 2}),
])
def test_tool_programs_load_no_jax(tmp_path, program, env):
    """The counterparts of the JAX package's last programs
    (kwage_tpu_torch.bench), each run whole on the CPU with tiny knobs (the
    JAX tools' env knobs; a shape the tool fixed is set on the module),
    exit 0 and load neither jax nor kwage_tpu."""
    fixed = {k: v for k, v in env.items() if not isinstance(v, str)}
    env = {k: v for k, v in env.items() if isinstance(v, str)}
    code = (
        "import sys\n"
        f"import kwage_tpu_torch.bench.{program} as program\n"
        f"for name, value in {fixed!r}.items():\n"
        "    setattr(program, name, value)\n"
        f"assert program.main(['--out', {str(tmp_path / 'out.json')!r}]) == 0\n"
        + ASSERT_CLEAN
    )
    res = _run(code, KWAGE_TORCH_DEVICE="cpu", TMPDIR=str(tmp_path), **env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads((tmp_path / "out.json").read_text())

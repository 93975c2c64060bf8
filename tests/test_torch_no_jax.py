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
        "import importlib.util\n"
        "assert importlib.util.find_spec('kwage_tpu') is None\n"
        + ASSERT_CLEAN
    )
    env = dict(os.environ, PYTHONPATH="", KWAGE_TORCH_DEVICE="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]

"""kwage_tpu_torch and chip_smoke.py never import jax: they run on a GPU
machine that has none. The import check runs in a subprocess, because
this test process has jax loaded already (tests/conftest.py)."""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "kwage_tpu_torch"

# jax itself, and the kwage_tpu modules that import it at the top.
# kwage_tpu.parallel.maestro and kwage_tpu.cli.maestro import no jax.
JAX_IMPORT = re.compile(
    r"^\s*(from|import)\s+(jax\b|kwage_tpu\.(ops|sriracha\.device|search\.resident"
    r"|parallel\.(mesh|sharded_search|distributed))\b"
    r"|kwage_tpu\.(ops|search|sriracha)\s+import"
    r"|kwage_tpu\.parallel\s+import\s+\(?\s*(mesh|sharded_search|distributed)\b)",
    re.MULTILINE)


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_every_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import kwage_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    kwage_tpu_torch.__path__, 'kwage_tpu_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n_modules = int(res.stdout.strip().splitlines()[-1])
    assert n_modules + 1 == len(list(PKG.rglob("*.py")))  # + the package itself


def test_no_source_imports_jax():
    offenders = [
        f"{p.relative_to(REPO)}: {m.group(0).strip()}"
        for p in _sources()
        for m in JAX_IMPORT.finditer(p.read_text())
    ]
    assert not offenders, offenders


def test_pattern_catches_jax_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from kwage_tpu.ops.search import x", "from kwage_tpu.ops import search",
                 "    import kwage_tpu.search.resident", "import kwage_tpu.ops.kmers",
                 "from kwage_tpu.parallel.mesh import make_search_mesh",
                 "from kwage_tpu.parallel.sharded_search import x",
                 "    from kwage_tpu.parallel.distributed import shard_inventory",
                 "from kwage_tpu.parallel import mesh", "from kwage_tpu.sriracha.device import x"):
        assert JAX_IMPORT.search(line), line
    for line in ("from kwage_tpu.search.engine import x", "import jaxlib_free",
                 "from kwage_tpu.search.output import render_csv",
                 "from kwage_tpu.parallel.maestro import Maestro",
                 "from kwage_tpu.parallel import maestro as _base",
                 "from kwage_tpu.cli.maestro import LONG_OPTS, usage",
                 "from kwage_tpu.pipeline.make_bloom import BloomInvalid"):
        assert not JAX_IMPORT.search(line), line

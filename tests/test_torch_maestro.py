"""The port's Maestro and kwage-maestro-torch (kwage_tpu_torch.parallel
.maestro, cli.maestro) with --device-build and --device-transpose on the
golden corpus: the .db files must be the reference's bytes
(tests/golden/e2e/digests.json), as tests/test_maestro.py requires of
kwage_tpu. On the CPU (KWAGE_TORCH_DEVICE=cpu) every kernel wrapper runs
its plain PyTorch version."""

import ast
import hashlib
import inspect
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from kwage_tpu.parallel import maestro as jax_maestro
from kwage_tpu.pipeline import make_bloom as jax_make_bloom
from kwage_tpu_torch.cli.maestro import main as maestro_main
from kwage_tpu_torch.core import FilterInfo, str_to_accession
from kwage_tpu_torch.io.inventory import write_inventory
from kwage_tpu_torch.io.status import read_status_file
from kwage_tpu_torch.parallel import maestro as torch_maestro
from kwage_tpu_torch.parallel.maestro import (
    STATUS_DATABASE_SUCCESS,
    LocalFastaResolver,
    Maestro,
    MaestroOptions,
)
from kwage_tpu_torch.pipeline import make_bloom as torch_make_bloom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def manifest(golden_dir):
    with open(golden_dir / "e2e" / "manifest.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def digests(golden_dir):
    with open(golden_dir / "e2e" / "digests.json") as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """The plain versions, on two torch threads: the suite runs beside
    other test processes on the same cores."""
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _write_inventory(manifest, work):
    infos = [FilterInfo(run_accession=str_to_accession(a)) for a in manifest["accessions"]]
    write_inventory(str(work / "inventory.bin"), infos)


def _sha(p):
    with open(p, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _check_databases(manifest, digests, db_dir):
    for gi in range(len(manifest["db_groups"])):
        assert _sha(db_dir / f"sra.{gi + 1}.db") == digests[f"sra.{gi}.db"], f"group {gi}"


@pytest.mark.parametrize("device_batch", [1, 16])
def test_device_build_produces_reference_databases(manifest, digests, data_dir, tmp_path,
                                                   device_batch):
    """device_batch 1 runs execute_bloom_task per accession; 16 the
    pipelined dispatcher (prepare_bloom_batch -> dispatch/scatter ->
    finish_bloom_batch)."""
    _write_inventory(manifest, tmp_path)
    opt = MaestroOptions(
        metadata_file=str(tmp_path / "inventory.bin"),
        scratch_bloom_dir=str(tmp_path / "bloom"),
        scratch_database_dir=str(tmp_path / "db"),
        status_file=str(tmp_path / "status.bin"),
        kmer_len=manifest["k"], min_kmer_count=manifest["min_kmer_count"],
        false_positive_probability=manifest["fp"],
        min_log_2_filter_len=manifest["minL"], max_log_2_filter_len=manifest["maxL"],
        min_log_2_count_len=manifest["minLc"], max_log_2_count_len=manifest["maxLc"],
        num_workers=2, save_bloom=True, device_build=True, device_transpose=True,
        device_batch=device_batch,
    )
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    m.run()
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()
    _check_databases(manifest, digests, tmp_path / "db")
    status, db_index = read_status_file(opt.status_file, len(manifest["accessions"]))
    assert db_index == len(manifest["db_groups"]) + 1
    assert (status == STATUS_DATABASE_SUCCESS).all()


class _StreamingFastaResolver(LocalFastaResolver):
    """--stream mode over the golden FASTA files: reads arrive as a live
    stream, not a path."""

    def open_stream(self, accession):
        from kwage_tpu_torch.io.sequence import iter_sequences

        return (seq for _, seq in iter_sequences(self.resolve(accession)))


@pytest.mark.parametrize("device_batch,buffer_bp", [(1, None), (16, 600)])
def test_streamed_device_build_produces_reference_databases(
        manifest, digests, data_dir, tmp_path, monkeypatch, device_batch, buffer_bp):
    """--stream with --device-build: device_batch 1 builds each stream
    through _build_bloom_streamed; 16 buffers streams into the fused batch,
    and with a 600 bp buffer the larger ones go to the chunked builder off
    their live pipe (finish_bloom_batch's big_streams)."""
    if buffer_bp is not None:
        monkeypatch.setenv("KWAGE_STREAM_BUFFER_BP", str(buffer_bp))
    _write_inventory(manifest, tmp_path)
    opt = MaestroOptions(
        metadata_file=str(tmp_path / "inventory.bin"),
        scratch_bloom_dir=str(tmp_path / "bloom"),
        scratch_database_dir=str(tmp_path / "db"),
        status_file=str(tmp_path / "status.bin"),
        kmer_len=manifest["k"], min_kmer_count=manifest["min_kmer_count"],
        false_positive_probability=manifest["fp"],
        min_log_2_filter_len=manifest["minL"], max_log_2_filter_len=manifest["maxL"],
        num_workers=2, stream_sra=True, device_build=True, device_transpose=True,
        device_batch=device_batch,
    )
    m = Maestro(opt, _StreamingFastaResolver(str(data_dir)))
    m.restore()
    m.run()
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()
    _check_databases(manifest, digests, tmp_path / "db")


def _cli_args(manifest, data_dir, work):
    return [
        "--meta", str(work / "inventory.bin"), "--scratch", str(work),
        "--status", str(work / "status.bin"), "--source-dir", str(data_dir),
        "-k", str(manifest["k"]), "-p", str(manifest["fp"]),
        "--min-kmer-count", str(manifest["min_kmer_count"]),
        "--len.min", str(manifest["minL"]), "--len.max", str(manifest["maxL"]),
        "--count-len.min", str(manifest["minLc"]), "--count-len.max", str(manifest["maxLc"]),
        "--device-build", "--device-transpose", "--workers", "2",
    ]


def test_cli_device_build_produces_reference_databases(manifest, digests, data_dir, tmp_path,
                                                       capsys):
    _write_inventory(manifest, tmp_path)
    rc = maestro_main(_cli_args(manifest, data_dir, tmp_path) + ["--device-batch", "16"])
    assert rc == 0
    assert "database committed: 10" in capsys.readouterr().err
    _check_databases(manifest, digests, tmp_path / "database")


@pytest.mark.parametrize("flag", ["--coordinator", "--worker"])
def test_cli_remote_roles_are_not_ported(manifest, digests, data_dir, tmp_path, flag, capsys):
    """The cross-host roles are wired, not refused: ``--coordinator`` on
    port 0 binds a free port, prints it on a line of its own, and with its
    local device workers builds the golden databases; a ``--worker`` with
    no coordinator to reach exits 0 having built nothing."""
    from kwage_tpu_torch.cli.maestro import LISTENING

    _write_inventory(manifest, tmp_path)
    address = "127.0.0.1:0" if flag == "--coordinator" else "127.0.0.1:1"
    rc = maestro_main(_cli_args(manifest, data_dir, tmp_path) + ["--device-batch", "4",
                                                                 flag, address])
    err = capsys.readouterr().err
    assert rc == 0 and "not ported" not in err
    if flag == "--coordinator":
        bound = [line[len(LISTENING):] for line in err.splitlines()
                 if line.startswith(LISTENING)]
        assert len(bound) == 1 and bound[0].startswith("127.0.0.1:")
        assert 0 < int(bound[0].rpartition(":")[2]) < 65536
        assert "database committed: 10" in err
        _check_databases(manifest, digests, tmp_path / "database")
    else:
        assert "coordinator unreachable" in err and "Worker finished (0 tasks)" in err
        assert not list((tmp_path / "database").iterdir())


def test_cli_cuda_without_a_card_raises(manifest, data_dir, tmp_path, monkeypatch):
    """No CPU fallback: --device-build on KWAGE_TORCH_DEVICE=cuda without a
    card raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cuda")
    _write_inventory(manifest, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        maestro_main(_cli_args(manifest, data_dir, tmp_path))
    assert not (tmp_path / "bloom").exists()


def test_cli_options_stage_rejections_exit_zero(tmp_path, capsys):
    assert maestro_main(["--scratch", str(tmp_path)]) == 0
    assert "--meta" in capsys.readouterr().err
    assert maestro_main(["--meta", "x", "--scratch", str(tmp_path), "--source-dir", ".",
                         "--min-kmer-count", "0"]) == 0
    assert "min k-mer count" in capsys.readouterr().err


def test_device_build_run_never_imports_jax(manifest, data_dir, tmp_path):
    """A whole --device-build --device-transpose run of the CLI and the
    entry() forward, in a fresh process: jax is never loaded."""
    _write_inventory(manifest, tmp_path)
    code = (
        "import sys\n"
        "from kwage_tpu_torch.cli.maestro import main\n"
        "from kwage_tpu_torch.entry import entry\n"
        f"assert main({_cli_args(manifest, data_dir, tmp_path)!r}) == 0\n"
        "fn, args = entry()\n"
        "assert fn(*args).shape == (1, 256)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    env = dict(os.environ, KWAGE_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "database committed: 10" in res.stderr


# The functions the port carries over from kwage_tpu unchanged but for the
# modules they import: (JAX module, port module, qualified name). The
# port's scheduler is the whole module, so every method of the scheduler's
# classes is held too (tests/test_torch_copies.py holds the top-level names
# of every merged module).
COPIES = [
    (jax_maestro, torch_maestro, name) for name in (
        "_build_bloom_streamed", "execute_bloom_task", "prepare_bloom_batch",
        "finish_bloom_batch", "execute_bloom_batch", "_DeviceDispatcher._run",
        "Maestro._run", "Maestro._process_accession", "Maestro._process_accession_batch",
        "Maestro._prepare_batch_host", "Maestro._build_database")
] + [
    (jax_make_bloom, torch_make_bloom, name) for name in (
        "prepare_device_batch", "finish_device_batch", "build_blooms_device_batch")
] + [
    (jax_maestro, torch_maestro, f"{cls}.{name}")
    for cls in ("Maestro", "_DeviceDispatcher", "MaestroOptions", "LocalFastaResolver",
                "PrefetchResolver", "StreamingResolver", "_LazyInfos")
    for name, member in vars(getattr(jax_maestro, cls)).items()
    if inspect.isfunction(member) and member.__module__ == jax_maestro.__name__
    and member.__code__.co_filename == jax_maestro.__file__ and f"{cls}.{name}" not in (
        "_DeviceDispatcher._run", "Maestro._run", "Maestro._process_accession",
        "Maestro._process_accession_batch", "Maestro._prepare_batch_host",
        "Maestro._build_database")
] + [
    (jax_make_bloom, torch_make_bloom, name) for name in (
        "build_bloom_from_sequences", "build_bloom_from_file", "_finish_build",
        "counting_filter_log2_len")
]


def _statements(fn) -> str:
    """A function's body as an AST dump without its docstring, its
    argument and return annotations and its import statements."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    func = tree.body[0]
    body = func.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        func.body = body[1:]
    for node in ast.walk(func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            node.returns = None
            for a in node.args.args + node.args.kwonlyargs + node.args.posonlyargs:
                a.annotation = None
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if isinstance(stmts, list):
                setattr(node, field, [x for x in stmts
                                      if not isinstance(x, (ast.Import, ast.ImportFrom))])
    return ast.dump(func)


@pytest.mark.parametrize("jax_mod,torch_mod,name", COPIES,
                         ids=[f"{t.__name__.rsplit('.', 1)[1]}.{n}" for _, t, n in COPIES])
def test_carried_over_code_matches_its_jax_original(jax_mod, torch_mod, name):
    """A fix to the JAX scheduler or batch builder must reach its copy in
    the port: each copy is its original statement for statement."""
    def resolve(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    assert _statements(resolve(torch_mod)) == _statements(resolve(jax_mod))

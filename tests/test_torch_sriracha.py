"""The port's SriRachA device path (kwage_tpu_torch.sriracha and
``kwage-sriracha-torch --device``) against kwage_tpu's device module on the
JAX CPU backend, the host engine and the golden TSVs. Counts are integers:
every comparison is exact equality. On the CPU every kernel wrapper runs
its plain PyTorch version; the ``cuda`` tests hold the kernels against
those on a card."""

import ast
import inspect
import random
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kwage_tpu.core.words import canonical_kmers as host_canonical_kmers
from kwage_tpu.sriracha import device as jdev
from kwage_tpu.sriracha.engine import SrirachaOptions, load_subject_kmers, search_reads
from kwage_tpu.sriracha.engine import format_results as jax_format_results
from kwage_tpu_torch import kernels
from kwage_tpu_torch.cli.sriracha import main as torch_sriracha_main
from kwage_tpu_torch.sriracha import device as tdev

CPU = torch.device("cpu")
CASES = [
    "11_0.4_1_0.5_0_100_0_1",
    "11_0.8_1_0.75_0_100_0_1",
    "7_0.6_3_0.6_50_5_0_1",
    "11_0.4_1_0.5_0_100_1_3",
    "11_0.4_1_0.5_0_100_2_3",
    "15_0.3_1_0.5_0_100_0_1",
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py checks the kernels on the card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """The plain versions, on two torch threads: the suite runs beside
    other test processes on the same cores."""
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _args(case, data_dir, device=False):
    k, t, n, c, minlen, maxm, sl, of = case.split("_")
    args = ["-k", k, "-t", t, "-n", n, "--read.complexity.min", c,
            "--read.len.min", minlen, "--max-results", maxm,
            "-i", str(data_dir / "sriracha_queries.fasta")]
    if of != "1":
        args += ["--slice", sl, "--of", of]
    if device:
        args += ["--device"]
    return args + [str(data_dir / "sriracha_reads.fasta")]


def _run(main, args, tmp_path):
    out = tmp_path / "out.tsv"
    assert main(args + ["-o", str(out)]) == 0
    return out.read_text()


def _norm(text):
    """The oracle prints file-stem accessions differently; column 0 out."""
    return ["\t".join(["ACC"] + line.split("\t")[1:]) if "\t" in line else line
            for line in text.splitlines()]


def _matches(results):
    return [[(m.read_index, m.read_subindex, m.score, m.read_seq) for m in b] for b in results]


# --- the CLI --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_device_cli_matches_oracle(case, data_dir, golden_dir, tmp_path):
    got = _run(torch_sriracha_main, _args(case, data_dir, device=True), tmp_path)
    want = (golden_dir / "sriracha" / f"{case}.tsv").read_text()
    assert _norm(got) == _norm(want), case


@pytest.mark.parametrize("k", [11, 15, 16, 21, 31, 32])
def test_device_cli_matches_host_all_k(k, data_dir, tmp_path):
    from kwage_tpu.cli.sriracha import main as host_main

    case = f"{k}_0.3_1_0.5_0_100_0_1"
    host = _run(host_main, _args(case, data_dir), tmp_path)
    dev = _run(torch_sriracha_main, _args(case, data_dir, device=True), tmp_path)
    assert dev == host, k
    if k <= 21:
        assert any("\t" in line for line in dev.splitlines()), dev


def test_host_cli_matches_jax_cli(data_dir, tmp_path):
    """Without --device the port's CLI is the JAX package's CLI."""
    from kwage_tpu.cli.sriracha import main as host_main

    for case in ("11_0.4_1_0.5_0_100_1_3", "7_0.6_3_0.6_50_5_0_1"):
        assert (_run(torch_sriracha_main, _args(case, data_dir), tmp_path)
                == _run(host_main, _args(case, data_dir), tmp_path))


def _main_statements(fn) -> str:
    """``main``'s body as an AST dump without imports and without what
    ties it to its device module: the JAX CLI's platform pin before its
    lazy device import, the port's ``resolve_device()`` check and any
    ``device`` argument."""
    func = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0]
    dropped = (lambda x: isinstance(x, (ast.Import, ast.ImportFrom)),
               lambda x: ast.unparse(x) in (
                   "if opt.use_device:\n    resolve_device()",
                   "if opt.use_device:\n    pin_platform_from_env()"))
    for drop in dropped:  # imports first: the pin's block holds one
        for node in ast.walk(func):
            for field in ("body", "orelse", "finalbody"):
                stmts = getattr(node, field, None)
                if isinstance(stmts, list):
                    setattr(node, field, [x for x in stmts if not drop(x)])
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            node.keywords = [kw for kw in node.keywords if kw.arg != "device"]
            if ast.unparse(node.func) == "search_accession":
                node.args = [a for a in node.args if ast.unparse(a) != "device"]
    return ast.dump(func)


def test_cli_main_matches_its_jax_original():
    """A fix to the JAX CLI's main must reach the port's copy: the two are
    statement for statement the same but for the card check. The port
    passes no device on, so its search takes every visible card, as the
    JAX CLI's takes every device."""
    import kwage_tpu.cli.sriracha as jax_cli
    import kwage_tpu_torch.cli.sriracha as torch_cli

    assert _main_statements(torch_cli.main) == _main_statements(jax_cli.main)
    assert "device" not in {kw.arg for node in ast.walk(ast.parse(textwrap.dedent(
        inspect.getsource(torch_cli.main)))) if isinstance(node, ast.Call)
        for kw in node.keywords}


def test_device_cli_directory_and_options_stage(data_dir, tmp_path, capsys):
    """A directory accession searches its first sequence file; an
    options-stage rejection exits 0 with the reference's message."""
    import shutil

    acc = tmp_path / "SRR42"
    acc.mkdir()
    shutil.copy(data_dir / "sriracha_reads.fasta", acc / "SRR42.fasta")
    args = _args("11_0.4_1_0.5_0_100_0_1", data_dir, device=True)
    direct = _run(torch_sriracha_main, args, tmp_path)
    via_dir = _run(torch_sriracha_main, args[:-1] + [str(acc)], tmp_path)
    assert _norm(via_dir) == _norm(direct)
    assert torch_sriracha_main(["-k", "40", "-i", "x.fa", "--device", "SRR1"]) == 0
    assert "kmer length" in capsys.readouterr().err


def test_device_cli_without_a_card_raises(data_dir, tmp_path, monkeypatch):
    """No silent CPU fallback: KWAGE_TORCH_DEVICE=cuda with no card raises
    from --device; the host path still runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cuda")
    args = _args("11_0.4_1_0.5_0_100_0_1", data_dir)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_sriracha_main(args[:-1] + ["--device", "-o", str(tmp_path / "o.tsv"), args[-1]])
    assert _run(torch_sriracha_main, args, tmp_path).endswith("//\n")


def test_no_subjects_touch_no_device(monkeypatch):
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cuda")
    assert tdev.search_reads_device(iter([]), [], SrirachaOptions()) == []
    assert tdev.search_reads_device(iter([("ACGTACGTACGTACGT", 1, 0)]), [],
                                    SrirachaOptions()) == []


# --- host tables and the hash ---------------------------------------------------------

def test_mix32_matches_numpy_and_jax():
    """Every 16-bit low word, random low words and the edges, each with a
    random high word."""
    rng = np.random.default_rng(5)
    lo = np.concatenate([np.arange(1 << 16, dtype=np.uint32),
                         rng.integers(0, 1 << 32, 1 << 12, dtype=np.uint32),
                         np.array([0xFFFFFFFF, 0x80000000], np.uint32)])
    hi = rng.integers(0, 1 << 32, lo.size, dtype=np.uint32)
    hi[-2:] = [0xFFFFFFFF, 0x7FFFFFFF]
    want = tdev.mix32(hi, lo)
    np.testing.assert_array_equal(want, jdev._mix32(hi, lo))
    np.testing.assert_array_equal(np.asarray(jdev._mix32(jnp.asarray(hi), jnp.asarray(lo))), want)
    got = tdev.mix32_ref(torch.from_numpy(hi.view(np.int32)), torch.from_numpy(lo.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def _subject_sets(seed, ns, k, lo=5, hi=64):
    """ns sorted-unique uint64 k-mer sets, overlapping (shared words merge
    into one hash entry)."""
    rng = np.random.default_rng(seed)

    def words(n):
        w = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) << np.uint64(1)
        return w >> np.uint64(64 - 2 * k) if k < 32 else w | rng.integers(0, 2, n, np.uint64)

    shared = words(8)
    sets = []
    for s in range(ns):
        kms = words(int(rng.integers(lo, hi)))
        if s % 3 == 0:
            kms = np.concatenate([kms, shared])
        sets.append(np.unique(kms))
    return sets


@pytest.mark.parametrize("k", [9, 21, 32])
def test_hash_tables_equal_jax(k):
    sets = _subject_sets(1, 40, k)
    for g in range(0, 40, 32):
        for got, want in zip(tdev.build_hash_group(sets[g : g + 32]),
                             jdev._build_hash_group(sets[g : g + 32])):
            np.testing.assert_array_equal(got, want)
    # The loader: JAX-built tables into the port's layout, and the port's
    # own build from subject k-mers, agree.
    groups = [jdev._build_hash_group(sets[g : g + 32]) for g in range(0, 40, 32)]
    loaded = tdev.hash_tables_from_groups(groups, k, 40, CPU)
    built = tdev.build_hash_tables([(f"s{i}", s) for i, s in enumerate(sets)], k, CPU)
    for name in ("keys", "masks", "row0", "bmask"):
        assert torch.equal(getattr(loaded, name), getattr(built, name)), name
    assert loaded.keys.shape[1] == tdev.BUCKET_CAP
    assert int(loaded.row0[1]) == groups[0][0].shape[0]


@pytest.mark.parametrize("k", [3, 9, 11])
def test_subject_table_equals_jax(k):
    sets = _subject_sets(2, 40, k, hi=40)
    subj = [(f"s{i}", s) for i, s in enumerate(sets)]
    smax = max(s.size for s in sets)
    padded = np.full((40, smax), 0xFFFFFFFF, np.uint32)
    for i, s in enumerate(sets):
        padded[i, : s.size] = s
    want = [np.asarray(jdev.build_subject_table(jnp.asarray(padded[g : g + 32]), k))
            for g in range(0, 40, 32)]
    got = tdev.build_lut_tables(subj, k, CPU)
    assert got.table.shape == (2, 1 << (2 * k))
    np.testing.assert_array_equal(got.table.numpy().view(np.uint32), np.stack(want))
    loaded = tdev.lut_tables_from_groups(want, k, 40, CPU)
    assert torch.equal(loaded.table, got.table)


def test_subject_table_drops_padding_and_repeats_or():
    subjects = torch.tensor([[5, -1, 64, 5], [0, 63, -1, -1]], dtype=torch.int64)
    t = tdev.subject_table(subjects, 3)
    assert t.shape == (1, 64)
    assert int(t[0, 5]) == 1 and int(t[0, 0]) == 2 and int(t[0, 63]) == 2
    assert int(t.count_nonzero()) == 3


# --- the per-read dedup and the counts ---------------------------------------------------

def _read_block(seed, B, L, k):
    """ASCII reads uint8 [B, L] with lengths: N bases, lower case, every
    byte value in two rows, reads shorter than k, empty rows."""
    rng = np.random.default_rng(seed)
    b = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=(B, L))].copy()
    b[rng.random((B, L)) < 0.02] = ord("N")
    b[1] = np.frombuffer(b"acgt", np.uint8)[rng.integers(0, 4, size=L)]
    b[2, :] = np.arange(L) % 256
    b[3, : min(L, 128)] = (np.arange(min(L, 128)) + 128) % 256
    b[4, :] = b[5, :]  # a repeated read
    b[6, : L // 2] = b[6, L // 2 : 2 * (L // 2)]  # repeated words within a read
    lengths = rng.integers(k, L + 1, size=B).astype(np.int32)
    lengths[7] = max(k - 1, 0)   # shorter than k
    lengths[8] = 0               # an empty (padding) row
    lengths[-2:] = 0
    lengths[9] = L
    for r in range(B):
        b[r, lengths[r]:] = 0
    return b, lengths


@pytest.mark.parametrize("k", [9, 13, 16, 32])
def test_kmerize_batch_ref_matches_jax(k):
    b, lengths = _read_block(3, 24, 64, k)
    s, uniq, nk, nu = tdev.kmerize_batch_ref(torch.from_numpy(b), torch.from_numpy(lengths), k)
    if k <= 15:
        js, juniq, jnk, jnu = jdev._kmerize_batch(jnp.asarray(b), jnp.asarray(lengths), k)
        jwords = np.asarray(js).astype(np.uint64)
    else:
        hi, lo, juniq, jnk, jnu = jdev._kmerize_batch64(jnp.asarray(b), jnp.asarray(lengths), k)
        jwords = np.asarray(hi).astype(np.uint64) << np.uint64(32) | np.asarray(lo)
    np.testing.assert_array_equal(nk.numpy(), np.asarray(jnk))
    np.testing.assert_array_equal(nu.numpy(), np.asarray(jnu))
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(juniq))
    words = s.numpy().view(np.uint64)
    juniq = np.asarray(juniq)
    for r in range(b.shape[0]):
        np.testing.assert_array_equal(words[r][juniq[r]], jwords[r][juniq[r]])
    assert int(nk[8]) == 0 and int(nk[7]) == 0 and int(nu[8]) == 0


@pytest.mark.parametrize("k", [9, 13, 32])
def test_read_batch_counts_ref_matches_jax(k):
    """Both probes, 40 subjects (two groups), against the JAX kernels on
    one seeded batch; the subjects hold words of the reads so counts are
    not all zero."""
    b, lengths = _read_block(4, 32, 64 if k < 32 else 128, k)
    sets = _subject_sets(5, 40, k)
    read_words = np.unique(host_canonical_kmers(b[0, : lengths[0]].tobytes(), k))
    sets[0] = np.unique(np.concatenate([sets[0], read_words[::2]]))
    sets[33] = np.unique(np.concatenate([sets[33], read_words]))
    subj = [(f"s{i}", s) for i, s in enumerate(sets)]
    ns_groups = tuple(tdev.group_sizes(40))
    reads_t, lens_t = torch.from_numpy(b), torch.from_numpy(lengths)
    hgroups = [jdev._build_hash_group(sets[g : g + 32]) for g in range(0, 40, 32)]
    jhash = jdev._read_batch_kernel_hash(
        jnp.asarray(b), jnp.asarray(lengths),
        tuple(tuple(jnp.asarray(a) for a in grp) for grp in hgroups), k, ns_groups)
    want = np.concatenate([np.asarray(jhash[0]), np.asarray(jhash[1])[:, None],
                           np.asarray(jhash[2])[:, None]], axis=1)
    got = tdev.read_batch_counts_ref(reads_t, lens_t, tdev.build_hash_tables(subj, k, CPU))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] > 0 and want[0, 33] == want[0, 41]
    assert (want[[7, 8, -1, -2]] == 0).all()
    if k <= 13:
        smax = max(s.size for s in sets)
        padded = np.full((40, smax), 0xFFFFFFFF, np.uint32)
        for i, s in enumerate(sets):
            padded[i, : s.size] = s
        jt = tuple(jdev.build_subject_table(jnp.asarray(padded[g : g + 32]), k)
                   for g in range(0, 40, 32))
        jlut = jdev._read_batch_kernel_tables(jnp.asarray(b), jnp.asarray(lengths), jt, k,
                                              ns_groups)
        for a, c in zip(jlut, jhash):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
        lut = tdev.build_lut_tables(subj, k, CPU)
        np.testing.assert_array_equal(tdev.read_batch_counts_ref(reads_t, lens_t, lut).numpy(),
                                      want)
    # The wrapper on CPU tensors: the plain version, into ``out`` too.
    out = torch.full((b.shape[0], 42), -7, dtype=torch.int32)
    tables = tdev.build_hash_tables(subj, k, CPU)
    assert tdev.read_batch_counts(reads_t, lens_t, tables, out) is out
    np.testing.assert_array_equal(out.numpy(), want)


# --- the fused short-read kernel (sriracha_reads) -------------------------------------------

def _jax_read_counts(b, lengths, sets, k, lut):
    """The JAX package's _read_batch_kernel_tables (``lut``) or
    _read_batch_kernel_hash on a batch: int [B, ns + 2]."""
    ns = len(sets)
    ns_groups = tuple(tdev.group_sizes(ns))
    if lut:
        smax = max(s.size for s in sets)
        padded = np.full((ns, smax), 0xFFFFFFFF, np.uint32)
        for i, s in enumerate(sets):
            padded[i, : s.size] = s
        tables = tuple(jdev.build_subject_table(jnp.asarray(padded[g : g + 32]), k)
                       for g in range(0, ns, 32))
        res = jdev._read_batch_kernel_tables(jnp.asarray(b), jnp.asarray(lengths), tables, k,
                                             ns_groups)
    else:
        groups = [jdev._build_hash_group(sets[g : g + 32]) for g in range(0, ns, 32)]
        res = jdev._read_batch_kernel_hash(
            jnp.asarray(b), jnp.asarray(lengths),
            tuple(tuple(jnp.asarray(a) for a in grp) for grp in groups), k, ns_groups)
    return np.concatenate([np.asarray(res[0]), np.asarray(res[1])[:, None],
                           np.asarray(res[2])[:, None]], axis=1)


def _hit_sets(b, lengths, k, seed, ns=40):
    """ns subject sets (two groups) holding words of the batch's reads, so
    the counts are not all zero: half of the longest read's in subject 0,
    all of them in subject 33, a third read's in subject 31."""
    sets = _subject_sets(seed, ns, k)
    order = np.argsort(-lengths, kind="stable")
    for s, r, step in ((0, order[0], 2), (33, order[0], 1), (31, order[2], 1)):
        seq = b[r, : lengths[r]].tobytes()
        if lengths[r] >= k:
            words = np.unique(host_canonical_kmers(seq, k))[::step]
            sets[s] = np.unique(np.concatenate([sets[s], words]))
    return sets


@pytest.mark.parametrize("k", [1, 11, 21, 32])
def test_fused_route_rule(k):
    """Read buckets of 64-512 bases take the fused sriracha_reads kernel (a
    warp a read) at every k, buckets of 1024-16384 the fused sriracha_block
    kernel (a block a read); 32768 and above (the long rows) take
    canonical_kmers and sriracha_counts."""
    for width in (64, 128, 256, 512):
        assert tdev.fused_route(width, k) and tdev.fused_kernel(width, k) == "sriracha_reads"
    for width in (1024, 2048, 4096, 8192, 16384):
        assert tdev.fused_route(width, k) and tdev.fused_kernel(width, k) == "sriracha_block"
    for width in (32768, 65536):
        assert not tdev.fused_route(width, k)
    sizes = (0, 1, 64, 65, 150, 512, 513, 1500, 16_384, 16_385, 20_000)
    buckets = [tdev.pad_len(max(n, k)) for n in sizes]
    assert [tdev.fused_route(w, k) for w in buckets] == [True] * 9 + [False] * 2
    assert [tdev.fused_kernel(w, k) for w in buckets[:9]] == \
        ["sriracha_reads"] * 6 + ["sriracha_block"] * 3
    assert tdev.fused_kernel(tdev.MAX_READ_WINDOWS + k - 1, k) == "sriracha_reads"
    assert tdev.fused_kernel(tdev.MAX_READ_WINDOWS + k, k) == "sriracha_block"
    assert tdev.fused_route(tdev.MAX_BLOCK_WINDOWS + k - 1, k)
    assert not tdev.fused_route(tdev.MAX_BLOCK_WINDOWS + k, k)


def _edge_block(k, width, seed):
    """ASCII rows of 0, k - 1, k, 64, 65, 512 and 513 bases (those that fit
    ``width``), 150 bp rows (``width`` where narrower) with an N at the
    first, the last, the 16th and the 32nd base, a lowercase row and a row
    of every byte value."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    m = min(150, width)
    lens = [n for n in (0, k - 1, k, 64, 65, 512, 513) if n <= width] + [m] * 6 + [width]
    b = np.zeros((len(lens), width), np.uint8)
    for r, n in enumerate(lens):
        b[r, :n] = acgt[rng.integers(0, 4, size=n)]
    nrow = len(lens) - 7
    for r, pos in zip(range(nrow, nrow + 4), (0, m - 1, 15, 31)):
        b[r, pos] = ord("N")
    b[nrow + 4, :m] = np.frombuffer(b"acgt", np.uint8)[rng.integers(0, 4, size=m)]
    b[nrow + 5, :m] = (np.arange(m) * 7) % 256
    b[-1] = np.arange(width) % 256
    return b, np.array(lens, np.int32)


@pytest.mark.parametrize("k", [1, 11, 16, 17, 32])
@pytest.mark.parametrize("width", [512, 1024])
def test_read_batch_counts_edge_rows_match_jax(k, width):
    """read_batch_counts on CPU tensors (the plain version every CUDA batch
    is held to) against the JAX kernels over rows of 0, k - 1, k, 64, 65,
    512 and 513 bases, N at the first, last, 16th and 32nd base, lower
    case and every byte value; both probes (the LUT where k <= 13), 40
    subjects in two groups. Width 512 is the fused route's widest bucket,
    1024 the words route's narrowest."""
    b, lengths = _edge_block(k, width, 13 + k)
    sets = _hit_sets(b, lengths, k, 14 + k)
    subj = [(f"s{i}", s) for i, s in enumerate(sets)]
    reads_t, lens_t = torch.from_numpy(b), torch.from_numpy(lengths)
    for lut in ([False, True] if k <= 13 else [False]):
        want = _jax_read_counts(b, lengths, sets, k, lut)
        tables = (tdev.build_lut_tables if lut else tdev.build_hash_tables)(subj, k, CPU)
        got = tdev.read_batch_counts(reads_t, lens_t, tables)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want[:, :40].sum() > 0
        assert (want[lengths < k] == 0).all()


def _wide_block(k, width, seed):
    """ASCII rows of a bucket of 1024-16384 bases: rows of 0, k - 1, k,
    half the width, one more, the width less one and the width (the
    bucket's edges), 1.2 kbp and random lengths, N at the first, 16th,
    32nd and last base of a row, a run of Ns, a lowercase row and a row of
    every byte value; about a third of the rows copied from one sequence,
    so that subjects hold them."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    source = acgt[rng.integers(0, 4, size=width)]
    lens = [0, k - 1, k, width // 2, width // 2 + 1, width - 1, width, min(1200, width)]
    lens += rng.integers(k, width + 1, size=4).tolist()
    b = np.zeros((len(lens), width), np.uint8)
    for r, n in enumerate(lens):
        b[r, :n] = source[:n] if r % 3 == 0 else acgt[rng.integers(0, 4, size=n)]
    for r, pos in zip((3, 4, 5, 6), (0, 15, 31, width - 1)):
        b[r, pos] = ord("N")
    b[7, 100:140] = ord("N")
    b[8, : lens[8]] = np.frombuffer(b"acgt", np.uint8)[rng.integers(0, 4, size=lens[8])]
    b[9, : lens[9]] = np.arange(lens[9]) % 256
    return b, np.array(lens, np.int32)


@pytest.mark.parametrize("k", [11, 16, 17, 21, 32])
@pytest.mark.parametrize("width", [1024, 2048, 16384])
def test_block_route_widths_match_jax(k, width):
    """read_batch_counts on CPU tensors (the plain version every CUDA batch
    of the block kernel is held to) against the JAX kernels at widths of
    the sriracha_block route (1024, 2048 and 16384 bases): rows around the
    bucket's edges, N-bearing rows, rows shorter than k, lower case and
    every byte value; both probes (the LUT where k <= 13), 40 subjects in
    two groups."""
    assert tdev.fused_kernel(width, k) == "sriracha_block"
    b, lengths = _wide_block(k, width, 50 + k)
    sets = _hit_sets(b, lengths, k, 51 + k)
    subj = [(f"s{i}", s) for i, s in enumerate(sets)]
    reads_t, lens_t = torch.from_numpy(b), torch.from_numpy(lengths)
    for lut in ([False, True] if k <= 13 else [False]):
        want = _jax_read_counts(b, lengths, sets, k, lut)
        tables = (tdev.build_lut_tables if lut else tdev.build_hash_tables)(subj, k, CPU)
        got = tdev.read_batch_counts(reads_t, lens_t, tables)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want[:, :40].sum() > 0 and want[6, 40] == width - k
        assert (want[lengths < k] == 0).all()


_CODE = np.zeros(256, np.uint64)
_OK = np.zeros(256, bool)
for _value, _chars in enumerate((b"Aa", b"Cc", b"Gg", b"Tt")):
    for _c in _chars:
        _CODE[_c], _OK[_c] = _value, True
_BREV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint64)
_U = np.uint64


def _brev32(x):
    return ((_BREV8[x & _U(0xFF)] << _U(24)) | (_BREV8[(x >> _U(8)) & _U(0xFF)] << _U(16))
            | (_BREV8[(x >> _U(16)) & _U(0xFF)] << _U(8)) | _BREV8[x >> _U(24)])


def _swap_pairs(x):
    return ((x >> _U(1)) & _U(0x55555555)) | ((x & _U(0x55555555)) << _U(1))


def _funnel(lo, hi, sh):
    return (((hi << _U(32)) | lo) >> sh) & _U(0xFFFFFFFF)


def _warp_read(row, length, k, P, probe, ns):
    """One read through csrc/sriracha.cu's sriracha_reads_kernel as a
    warp runs it, in numpy: the staged 2-bit codes and ok bits,
    the canonical words of the blocked layout (lane l: windows l E ..
    l E + E - 1), the bitonic network with the cross-lane strides as xor
    exchanges, the dedup against lane - 1's last slot, the distinct words
    compacted to the front and probed by lane l at l, l + W, ..., the
    counts by ballots of the union's bits. -> int [ns + 2]."""
    W = 32
    E = P // W
    log_e, log_p = E.bit_length() - 1, P.bit_length() - 1
    L = row.size
    n_len = min(int(length), L)
    n_fit = max(n_len - k + 1, 0)
    bases = np.zeros(P + 32, np.uint8)
    bases[:n_len] = row[:n_len]
    inside = np.arange(P + 32) < n_len
    codes = np.where(inside, _CODE[bases], _U(0))
    oks = (inside & _OK[bases]).astype(np.uint64)
    shifts = _U(2) * np.arange(16, dtype=np.uint64)
    packed = (codes.reshape(-1, 16) << shifts).sum(axis=1).astype(np.uint64)
    ok16 = (oks.reshape(-1, 16) << np.arange(16, dtype=np.uint64)).sum(axis=1)
    validw = ok16[0::2] | (ok16[1::2] << _U(16))
    mask = _U((1 << (2 * k)) - 1)
    mask_lo, mask_hi = mask & _U(0xFFFFFFFF), mask >> _U(32)
    kmask = _U((1 << k) - 1)
    j = np.arange(P).reshape(W, E)
    p, sh = j >> 4, _U(2) * (j & 15).astype(np.uint64)
    s_lo = _funnel(packed[p], packed[p + 1], sh) & mask_lo
    s_hi = _funnel(packed[p + 1], packed[p + 2], sh) & mask_hi
    anti = ((s_hi ^ mask_hi) << _U(32)) | (s_lo ^ mask_lo)
    rev = (_swap_pairs(_brev32(s_lo)) << _U(32)) | _swap_pairs(_brev32(s_hi))
    word = np.minimum(rev >> _U(64 - 2 * k), anti)
    ok = (j < n_fit) & (_funnel(validw[j >> 5], validw[(j >> 5) + 1],
                                (j & 31).astype(np.uint64)) & kmask == kmask)
    v = np.where(ok, word, _U((1 << (32 if k <= 16 else 64)) - 1))
    lane = np.arange(W)[:, None]
    for ls in range(1, log_p + 1):
        for lt in range(ls - 1, -1, -1):
            if lt >= log_e:
                lx = 1 << (lt - log_e)
                other = v[np.arange(W) ^ lx]
                asc = (ls == log_p) | (((lane >> (ls - log_e)) & 1) == 0)
                keep_min = ((lane & lx) == 0) == asc
                v = np.where(keep_min, np.minimum(v, other), np.maximum(v, other))
            else:
                for e in range(E):
                    if e & (1 << lt):
                        continue
                    f = e | (1 << lt)
                    if ls >= log_p:
                        asc = np.ones((W, 1), bool)
                    elif ls >= log_e:
                        asc = ((lane >> (ls - log_e)) & 1) == 0
                    else:
                        asc = np.full((W, 1), (e & (1 << ls)) == 0)
                    lo = np.minimum(v[:, [e]], v[:, [f]])
                    hi = np.maximum(v[:, [e]], v[:, [f]])
                    v[:, [e]], v[:, [f]] = np.where(asc, lo, hi), np.where(asc, hi, lo)
    assert (np.diff(v.reshape(-1).astype(object)) >= 0).all(), "the network did not sort"
    n = int(ok.sum())
    left = v[np.maximum(np.arange(W) - 1, 0), E - 1][:, None]
    prev = np.concatenate([left, v[:, :-1]], axis=1)
    distinct = (j < n) & ((j == 0) | (v != prev))
    # The distinct words to the front, in slot order; lane l probes words
    # l, l + W, ...
    nu = int(distinct.sum())
    front = np.zeros(P, np.uint64)
    front[:nu] = v[distinct]
    word_of = np.arange(E)[None, :] * W + lane
    probed = word_of < nu
    out = np.zeros(ns + 2, np.int64)
    for g, s0 in enumerate(range(0, ns, 32)):
        m = np.where(probed, probe(g, front[word_of]), 0).astype(np.uint64)
        union = int(np.bitwise_or.reduce(m.reshape(-1)))
        for bit in range(32):
            if not union >> bit & 1:
                continue
            hit = (m >> _U(bit)) & _U(1)
            ballots = (hit << np.arange(W, dtype=np.uint64)[:, None]).sum(axis=0)
            if bit < min(32, ns - s0):
                out[s0 + bit] = sum(bin(int(x)).count("1") for x in ballots)
    out[ns], out[ns + 1] = n, nu
    return out


def _np_probe(tables):
    """Group g's masks of words ``w`` (uint64 array) from the port's
    tables, in numpy: a LUT entry, or the OR of a bucket row's matching
    slots."""
    if tables.route == "lut":
        table = tables.table.numpy().view(np.uint32)
        size = table.shape[1]
        return lambda g, w: np.where(w < size, table[g][np.minimum(w, size - 1).astype(np.int64)],
                                     0)
    keys = tables.keys.numpy().view(np.uint64)
    masks = tables.masks.numpy().view(np.uint32)
    row0, bmask = tables.row0.numpy(), tables.bmask.numpy()

    def probe(g, w):
        hi = (w >> _U(32)).astype(np.uint32)
        lo = (w & _U(0xFFFFFFFF)).astype(np.uint32)
        rows = row0[g] + (tdev.mix32(hi, lo).astype(np.int64) & bmask[g])
        return np.where(keys[rows] == w[..., None], masks[rows], 0).astype(np.uint32) \
            .max(axis=-1)

    return probe


@pytest.mark.parametrize("P", [64, 128, 256, 512])
@pytest.mark.parametrize("k", [1, 11, 16, 17, 21, 32])
def test_warp_layout_emulation_matches_ref(k, P):
    """csrc/sriracha.cu's fused kernel emulated in numpy, lane by lane
    (``_warp_read``): it gives read_batch_counts_ref's counts on seeded
    batches whose rows sort at P = 64, 128, 256 and 512 slots, with 32-bit
    (k <= 16) and 64-bit keys."""
    b, lengths = _read_block(20 + P + k, 14, P, k)
    assert tdev.next_pow2(P - k + 1) == P and tdev.fused_route(P, k)
    sets = _hit_sets(b, lengths, k, 21 + k)
    subj = [(f"s{i}", s) for i, s in enumerate(sets)]
    routes = [tdev.build_hash_tables(subj, k, CPU)]
    if k <= 13:
        routes.append(tdev.build_lut_tables(subj, k, CPU))
    for tables in routes:
        want = tdev.read_batch_counts_ref(torch.from_numpy(b), torch.from_numpy(lengths),
                                          tables).numpy()
        probe = _np_probe(tables)
        got = np.stack([_warp_read(b[r], lengths[r], k, P, probe, tables.ns)
                        for r in range(b.shape[0])])
        np.testing.assert_array_equal(got, want)
        assert want[:, :40].sum() > 0


def _block_slots_ascii(row, length, k, P):
    """csrc/sriracha_block.cuh's AsciiSource, in numpy: the read staged as
    2-bit codes and ok bits; thread t's canonical words of windows 16 t ..
    16 t + 15 (packed words t .. t + 2, validity words t / 2 and t / 2 +
    1), all-ones where invalid -> (slots [T, 16], valid [T, 16])."""
    S, T = 16, P // 16
    n_len = min(int(length), row.size)
    n_fit = max(n_len - k + 1, 0)
    bases = np.zeros(P + 32, np.uint8)
    bases[:n_len] = row[:n_len]
    inside = np.arange(P + 32) < n_len
    codes = np.where(inside, _CODE[bases], _U(0))
    oks = (inside & _OK[bases]).astype(np.uint64)
    shifts = _U(2) * np.arange(16, dtype=np.uint64)
    packed = (codes.reshape(-1, 16) << shifts).sum(axis=1).astype(np.uint64)
    ok16 = (oks.reshape(-1, 16) << np.arange(16, dtype=np.uint64)).sum(axis=1)
    validw = ok16[0::2] | (ok16[1::2] << _U(16))
    mask = _U((1 << (2 * k)) - 1)
    mask_lo, mask_hi = mask & _U(0xFFFFFFFF), mask >> _U(32)
    kmask = _U((1 << k) - 1)
    t = np.arange(T)[:, None]
    e = np.arange(S)[None, :]
    j = S * t + e
    sh = _U(2) * e.astype(np.uint64)
    s_lo = _funnel(packed[t], packed[t + 1], sh) & mask_lo
    s_hi = _funnel(packed[t + 1], packed[t + 2], sh) & mask_hi
    anti = ((s_hi ^ mask_hi) << _U(32)) | (s_lo ^ mask_lo)
    rev = (_swap_pairs(_brev32(s_lo)) << _U(32)) | _swap_pairs(_brev32(s_hi))
    word = np.minimum(rev >> _U(64 - 2 * k), anti)
    bit = ((t & 1) * 16 + e).astype(np.uint64)
    ok = (j < n_fit) & (_funnel(validw[t >> 1], validw[(t >> 1) + 1], bit) & kmask == kmask)
    return np.where(ok, word, _U((1 << (32 if k <= 16 else 64)) - 1)), ok


def _block_slots_words(words, valid, length, k, P):
    """csrc/sriracha_block.cuh's WordsSource, in numpy: thread t loads
    windows t, t + T, ... of the row's int64 words and flags (row stride
    nwin) into the padded buffer, the key of a valid window that fits the
    read (its low 32 bits where k <= 16) and all-ones for the rest, then
    takes slots 16 t .. 16 t + 15 from there -> (slots [T, 16], valid [T,
    16]); None for a row with no window in its read or more than P."""
    S, T = 16, P // 16
    nwin = words.size
    n_fit = min(int(length) - k + 1, nwin)
    if n_fit <= 0 or n_fit > P:
        return None
    ones = _U((1 << (32 if k <= 16 else 64)) - 1)
    keys = words.view(np.uint64) & ones
    t = np.arange(T)[:, None]
    e = np.arange(S)[None, :]
    jw = e * T + t                                   # the window thread t loads at step e
    at = np.minimum(jw, nwin - 1)
    ok_w = (jw < n_fit) & valid[at].astype(bool)
    staged = np.zeros(P + P // 16, np.uint64)
    staged[jw + jw // 16] = np.where(ok_w, keys[at], ones)
    j = S * t + e
    okj = np.zeros(P, bool)
    okj[jw] = ok_w
    return staged[j + j // 16], okj[j]


def _block_read(row, length, k, P, probe, ns, slots=None):
    """One row through csrc/sriracha_block.cuh's sriracha_block_kernel as
    a block of T = P / 16 threads runs it, in numpy: thread t's 16 slots
    (``slots``, a source's (slots, valid), or None for a row that gets
    zeros; default ``_block_slots_ascii`` of the read ``row``); the bitonic
    network with strides below 16 inside a thread, strides of 16-256 as xor
    exchanges with lane l ^ (stride / 16), and a level's strides of 512 and
    more in shared memory, up to four a pass, each thread owning the slots
    ``tile_strides`` gives it; the dedup against thread t - 1's last slot;
    the distinct words compacted warp by warp, slot column by slot column,
    a ballot's lanes in order; thread t probing words t, t + T, ...; the
    counts by warp over the union of its masks, then added up. -> int
    [ns + 2]."""
    S, T = 16, P // 16
    log_p = P.bit_length() - 1
    if slots is None and row is not None:
        slots = _block_slots_ascii(row, length, k, P)
    if slots is None:
        return np.zeros(ns + 2, np.int64)
    v, ok = slots
    t = np.arange(T)[:, None]
    e = np.arange(S)[None, :]
    j = S * t + e
    lane = t & 31

    def exchange(a, c, asc):
        lo, hi = np.minimum(a, c), np.maximum(a, c)
        return np.where(asc, lo, hi), np.where(asc, hi, lo)

    for ls in range(1, log_p + 1):
        if ls > 9:
            flat = v.reshape(-1).copy()    # slot 16 t + e (the padding moves no slot)
            hi = ls
            while hi > 9:
                b = max(hi - 4, 9)
                nl = hi - b
                g = np.arange(P >> nl)
                first = ((g >> b) << (b + nl)) | (g & ((1 << b) - 1))
                idx = first[:, None] | (np.arange(1 << nl)[None, :] << b)
                vals = flat[idx]
                asc = (((first >> ls) & 1) == 0)[:, None]
                for lt in range(nl - 1, -1, -1):
                    for x in range(1 << nl):
                        if not x & (1 << lt):
                            y = x | (1 << lt)
                            lo_hi = exchange(vals[:, [x]], vals[:, [y]], asc)
                            vals[:, [x]], vals[:, [y]] = lo_hi
                flat[idx] = vals
                hi = b
            v = flat.reshape(T, S)
        up = ((t >> max(ls - 4, 0)) & 1) == 0
        for lt in range(min(ls, 9) - 1, 3, -1):
            lx = 1 << (lt - 4)
            other = v[np.arange(T) ^ lx]
            keep_min = ((lane & lx) == 0) == up
            v = np.where(keep_min, np.minimum(v, other), np.maximum(v, other))
        for lt in (3, 2, 1, 0):
            if lt >= ls:
                continue
            for x in range(S):
                if not x & (1 << lt):
                    y = x | (1 << lt)
                    asc = up if ls >= 4 else np.full((T, 1), ((x >> ls) & 1) == 0)
                    v[:, [x]], v[:, [y]] = exchange(v[:, [x]], v[:, [y]], asc)
    assert (np.diff(v.reshape(-1).astype(object)) >= 0).all(), "the network did not sort"
    n = int(ok.sum())
    left = np.concatenate([v[:1, :1], v[:-1, -1:]])    # thread t - 1's last slot
    prev = np.concatenate([left, v[:, :-1]], axis=1)
    distinct = (j < n) & ((j == 0) | (v != prev))
    nw = T // 32
    front = v.reshape(nw, 32, S).transpose(0, 2, 1)[distinct.reshape(nw, 32, S)
                                                     .transpose(0, 2, 1)]
    nu = front.size
    word_of = e * T + t
    probed = word_of < nu
    out = np.zeros(ns + 2, np.int64)
    for g, s0 in enumerate(range(0, ns, 32)):
        m = np.where(probed, probe(g, front[np.minimum(word_of, max(nu - 1, 0))]
                                   if nu else np.zeros_like(word_of, np.uint64)), 0)
        m = m.astype(np.uint64).reshape(nw, 32 * S)
        for w in range(nw):
            union = int(np.bitwise_or.reduce(m[w]))
            for b in range(min(32, ns - s0)):
                if union >> b & 1:
                    out[s0 + b] += int(((m[w] >> _U(b)) & _U(1)).sum())
    out[ns], out[ns + 1] = n, nu
    return out


# (k, P, source): the ASCII source's cases keep their ids, "k-P"; the
# words entry's narrowest block (P = 512, one warp) takes its batches of
# at most 512 windows a row.
_BLOCK_CASES = [pytest.param(k, P, source, id=f"{k}-{P}" if source == "ascii"
                             else f"{source}-{k}-{P}")
                for source, sizes in (("ascii", (1024, 2048, 4096, 8192, 16384)),
                                      ("words", (512, 1024, 2048, 4096, 8192, 16384)))
                for P in sizes for k in (1, 11, 16, 17, 21, 32)]


@pytest.mark.parametrize("k, P, source", _BLOCK_CASES)
def test_block_layout_emulation_matches_ref(k, P, source):
    """csrc/sriracha_block.cuh's block kernel emulated in numpy, thread by
    thread (``_block_read``), from either source: it gives the plain
    version's counts on seeded batches whose rows sort at P = 1024 (words:
    512) to 16384 slots, with 32-bit (k <= 16) and 64-bit keys. ASCII:
    reads P bases wide, the fused route's block buckets
    (read_batch_counts_ref). Words: canonical_kmers' words and flags of
    reads P + k - 1 bases wide, so that a full row has P windows
    (sriracha_counts_ref)."""
    width = P if source == "ascii" else P + k - 1
    b, lengths = _read_block(60 + P + k, 12 if P <= 4096 else 10, width, k)
    assert source == "words" or tdev.fused_kernel(P, k) == "sriracha_block"
    assert max(tdev.next_pow2(min(width - k + 1, tdev.MAX_BLOCK_WINDOWS)), 512) == P
    words, valid = tdev.canonical_kmers_ascii_ref(torch.from_numpy(b), k)
    sets = _hit_sets(b, lengths, k, 61 + k)
    subj = [(f"s{i}", s) for i, s in enumerate(sets)]
    routes = [tdev.build_hash_tables(subj, k, CPU)]
    if k <= 13:
        routes.append(tdev.build_lut_tables(subj, k, CPU))
    for tables in routes:
        want = tdev.sriracha_counts_ref(words, valid, torch.from_numpy(lengths), tables).numpy()
        probe = _np_probe(tables)
        if source == "ascii":
            got = [_block_read(b[r], lengths[r], k, P, probe, tables.ns)
                   for r in range(b.shape[0])]
        else:
            got = [_block_read(None, lengths[r], k, P, probe, tables.ns, _block_slots_words(
                words[r].numpy(), valid[r].numpy(), lengths[r], k, P))
                   for r in range(b.shape[0])]
        np.testing.assert_array_equal(np.stack(got), want)
        assert want[:, :40].sum() > 0


def test_k32_sign_bit_words_and_invalid_windows():
    """At k = 32 words with the top bit set sort as unsigned; invalid (N)
    windows stay out by their flag whatever word they carry."""
    rng = np.random.default_rng(8)
    seq = "".join(rng.choice(list("ACGT"), 200))
    seq = "G" + seq[1:60] + "N" + seq[61:]
    b = np.zeros((3, 256), np.uint8)
    for r, s in enumerate((seq, seq.lower(), "T" * 40 + "N" + "T" * 40)):
        b[r, : len(s)] = np.frombuffer(s.encode(), np.uint8)
    lengths = np.array([len(seq), len(seq), 81], np.int32)
    words, valid = tdev.canonical_kmers_ascii_ref(torch.from_numpy(b), 32)
    assert bool((words < 0).any())
    s, uniq, nk, nu = tdev.dedup_ref(words, valid, torch.from_numpy(lengths), 32)
    want = [np.unique(host_canonical_kmers(x.encode(), 32)) for x in
            (seq, seq, "T" * 40 + "N" + "T" * 40)]
    for r in range(3):
        np.testing.assert_array_equal(np.sort(s[r][uniq[r]].numpy().view(np.uint64)), want[r])
        assert int(nu[r]) == want[r].size
    assert int(nk[2]) == 18


# --- search_reads_device against the JAX function -------------------------------------------

def test_search_reads_device_gate_differential():
    """The workloads of the JAX package's gate differential (perfect-match
    caps across span boundaries, max_num_match in {1, 3, 50}, threshold
    1.0, low-complexity / short / empty reads): the port equals the JAX
    function and the host engine."""
    random.seed(23)

    def rseq(n, alpha="ACGT"):
        return "".join(random.choice(alpha) for _ in range(n))

    for _ in range(4):
        k = random.choice([9, 15, 21])
        targets = [rseq(random.randint(200, 1200)) for _ in range(random.randint(1, 3))]
        subj = [(f"s{i}", np.unique(host_canonical_kmers(s, k))) for i, s in enumerate(targets)]
        reads = []
        for ridx in range(1, 300):
            r = random.random()
            if r < 0.35:
                t = random.choice(targets)
                a = random.randint(0, max(0, len(t) - 120))
                reads.append((t[a : a + 120], ridx, 1))
            elif r < 0.45:
                reads.append(("AC" * 60, ridx, 1))
            elif r < 0.5:
                reads.append((rseq(random.randint(0, 30)), ridx, 1))
            else:
                reads.append((rseq(120), ridx, 1))
        opt = SrirachaOptions(kmer_len=k, kmer_match_threshold=random.choice([0.2, 1.0]),
                              max_num_match=random.choice([1, 3, 50]))
        host = _matches(search_reads(iter(reads), subj, opt))
        jax_dev = _matches(jdev.search_reads_device(iter(reads), subj, opt,
                                                    batch_size=32, span_reads=64))
        port = _matches(tdev.search_reads_device(iter(reads), subj, opt,
                                                 batch_size=32, span_reads=64))
        assert port == jax_dev == host


@pytest.mark.parametrize("route", ["hash", "lut"])
def test_search_reads_device_forced_routes(route, monkeypatch):
    """KWAGE_SRIRACHA_HASH_MAX forces either table (both give the same
    counts); the port equals the JAX function on the same route."""
    random.seed(31)
    k = 11

    def rseq(n):
        return "".join(random.choice("ACGT") for _ in range(n))

    targets = [rseq(900), rseq(500)]
    subj = [(f"s{i}", np.unique(host_canonical_kmers(s, k))) for i, s in enumerate(targets)]
    reads = []
    for ridx in range(1, 200):
        if random.random() < 0.4:
            t = random.choice(targets)
            a = random.randint(0, len(t) - 120)
            reads.append((t[a : a + 120], ridx, 1))
        else:
            reads.append((rseq(120), ridx, 1))
    opt = SrirachaOptions(kmer_len=k, kmer_match_threshold=0.5)
    monkeypatch.setenv("KWAGE_SRIRACHA_HASH_MAX", "1000000000" if route == "hash" else "0")
    assert tdev.use_lut(subj, k, CPU) == (route == "lut")
    assert tdev.build_tables(subj, k, CPU).route == route
    port = _matches(tdev.search_reads_device(iter(reads), subj, opt, batch_size=32,
                                             span_reads=64))
    jax_dev = _matches(jdev.search_reads_device(iter(reads), subj, opt, batch_size=32,
                                                span_reads=64))
    assert port == jax_dev == _matches(search_reads(iter(reads), subj, opt))


def test_route_rule(monkeypatch):
    subj = [("a", np.arange(70_000, dtype=np.uint64))]
    monkeypatch.delenv("KWAGE_SRIRACHA_HASH_MAX", raising=False)
    assert tdev.use_lut(subj, 11, CPU)                      # above 65536 k-mers
    assert not tdev.use_lut(subj, 14, CPU)                  # k above the CPU's 13
    assert not tdev.use_lut([("a", subj[0][1][:65536])], 11, CPU)
    assert tdev.table_k_limit(torch.device("cuda")) == 14 and tdev.table_k_limit(CPU) == 13
    monkeypatch.setenv("KWAGE_SRIRACHA_HASH_MAX", "0")
    assert tdev.use_lut([("a", subj[0][1][:5])], 13, CPU)


def test_long_reads_and_every_bucket():
    """Reads from 0 to 20 kbp (buckets 64 .. 32768 bases, the last above
    the kernel's shared-memory sort), and reads of 16385 to 16384 + k - 1
    bases (at most 2^14 windows, in the 32768 bucket: the block kernel
    from canonical words) and of 16384 + k (the tile chain's shortest),
    equal the host engine."""
    rng = np.random.default_rng(11)
    k = 21
    target = "".join(rng.choice(list("ACGT"), 30_000))
    subj = [("t", np.unique(host_canonical_kmers(target, k)))]
    reads = []
    for i, n in enumerate([0, 5, 20, 21, 64, 65, 150, 1000, 5000, 20_000, 20_000]):
        if i % 2:
            a = int(rng.integers(0, len(target) - n + 1))
            reads.append((target[a : a + n], i + 1, 1))
        else:
            reads.append(("".join(rng.choice(list("ACGTN"), n)), i + 1, 1))
    edges = [16385, 16386, 16384 + k - 2, 16384 + k - 1, 16384 + k]
    for n in edges:
        a = int(rng.integers(0, len(target) - n + 1))
        reads.append((target[a : a + n], len(reads) + 1, 1))
    opt = SrirachaOptions(kmer_len=k, kmer_match_threshold=0.8)
    host = _matches(search_reads(iter(reads), subj, opt))
    assert any(m[3] == reads[9][0] for m in host[0])
    assert {len(m[3]) for m in host[0]} >= set(edges)
    assert _matches(tdev.search_reads_device(iter(reads), subj, opt, batch_size=4)) == host


def test_sriracha_counts_rows_around_the_tile_match_jax():
    """One batch that mixes rows of 0, 1, 2^14 - 1, 2^14, 2^14 + 1 and 2^15
    valid words (the kernel sorts a row above 2^14 in tiles across blocks):
    the wrapper's scratch sizing runs on the CPU too, and
    the counts equal the JAX kernel's; then a wide batch of rows of no
    window, of at most 2^14 and of more, at k = 11, 21 and 32."""
    k, tile = 21, tdev.MAX_SHARED_WORDS
    rng = np.random.default_rng(21)
    windows = [0, 1, tile - 1, tile, tile + 1, 1 << 15]
    lengths = np.array([0] + [n + k - 1 for n in windows[1:]], np.int32)
    L = tdev.pad_len(int(lengths.max()))
    assert L == 1 << 16
    target = rng.integers(0, 4, size=40_000)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    b = np.zeros((len(windows), L), np.uint8)
    for r, n in enumerate(lengths):
        b[r, :n] = acgt[np.resize(target, n) if r % 2 else rng.integers(0, 4, size=n)]
    sets = [np.unique(host_canonical_kmers(acgt[target].tobytes(), k)),
            np.unique(host_canonical_kmers(b[4, : lengths[4]].tobytes(), k))[::3]]
    subj = [(f"s{i}", s) for i, s in enumerate(sets)]
    nwin = L - k + 1
    scratch = tdev.counts_scratch(len(windows), nwin, CPU)
    assert scratch.shape == (len(windows), L) and scratch.dtype == torch.int64
    assert tdev.counts_scratch(len(windows), tile, CPU) is None   # a bucket of one tile

    jhash = jdev._read_batch_kernel_hash(
        jnp.asarray(b), jnp.asarray(lengths),
        (tuple(jnp.asarray(a) for a in jdev._build_hash_group(sets)),), k, (2,))
    want = np.concatenate([np.asarray(jhash[0]), np.asarray(jhash[1])[:, None],
                           np.asarray(jhash[2])[:, None]], axis=1)
    assert want[:, 2].tolist() == windows
    tables = tdev.build_hash_tables(subj, k, CPU)
    reads_t, lens_t = torch.from_numpy(b), torch.from_numpy(lengths)
    out = torch.empty((len(windows), 4), dtype=torch.int32)
    for dest in (None, out):
        got = tdev.read_batch_counts(reads_t, lens_t, tables, dest)
        np.testing.assert_array_equal(got.numpy(), want)

    # A wide batch of the 32768 bucket at k = 11, 21 and 32: rows of 0 and
    # k - 1 bases (no window), 16385 and 16384 + k - 1 (at most 2^14
    # windows: the block kernel from words), then 16384 + k, 20 and 32
    # kbp (the tile chain); the words entry against the JAX kernel.
    for k in (11, 21, 32):
        row_lens = [0, k - 1, 16385, 16384 + k - 1, 16384 + k, 20_000, 1 << 15]
        lengths = np.array(row_lens, np.int32)
        b = np.zeros((len(row_lens), 1 << 15), np.uint8)
        for r, n in enumerate(row_lens):
            b[r, :n] = acgt[np.resize(target, n) if r % 2 else rng.integers(0, 4, size=n)]
        b[2, 3000:3050] = ord("N")
        sets = [np.unique(host_canonical_kmers(acgt[target].tobytes(), k)),
                np.unique(host_canonical_kmers(b[2, : lengths[2]].tobytes(), k))[::3]]
        subj = [(f"s{i}", s) for i, s in enumerate(sets)]
        want = _jax_read_counts(b, lengths, sets, k, lut=k <= 13)
        fit = np.clip(lengths - k + 1, 0, None)
        assert (want[:, 2] <= fit).all() and want[2, 2] < fit[2] and want[3, 2] == 1 << 14
        assert (want[:2] == 0).all() and want[:, :2].sum() > 0
        words, valid = tdev.canonical_kmers(torch.from_numpy(b), k)
        assert tdev.counts_scratch(*words.shape, CPU).shape == (len(row_lens), 1 << 15)
        routes = [tdev.build_hash_tables(subj, k, CPU)]
        if k <= 13:
            routes.append(tdev.build_lut_tables(subj, k, CPU))
        for tables in routes:
            got = tdev.sriracha_counts(words, valid, torch.from_numpy(lengths), tables)
            np.testing.assert_array_equal(got.numpy(), want)


def test_long_reads_in_a_span_give_the_host_tsv(monkeypatch):
    """Long reads among short ones in one span: the TSV bytes equal the
    host engine's, and a long bucket's batch holds its reads rounded up to a
    power of two rows, not batch_size rows."""
    from kwage_tpu_torch.sriracha import engine as tengine

    rng = np.random.default_rng(12)
    k = 21
    target = "".join(rng.choice(list("ACGT"), 40_000))
    subj = [("t one", np.unique(host_canonical_kmers(target, k))),
            ("t two", np.unique(host_canonical_kmers(target[:5000], k)))]
    sizes = [150] * 40 + [20_000, 17_000, 150, 16_404, 33_000] + [150] * 30
    reads = []
    for i, n in enumerate(sizes):
        if i % 3:
            a = int(rng.integers(0, len(target) - n + 1))
            reads.append((target[a : a + n], i + 1, 0))
        else:
            reads.append(("".join(rng.choice(list("ACGTN"), n, p=[.248, .248, .248, .248, .008])),
                          i + 1, 0))
    opt = tengine.SrirachaOptions(kmer_len=k, kmer_match_threshold=0.5)
    host = tengine.format_results("SRR1.fastq", subj, tengine.search_reads(iter(reads), subj, opt))
    assert host == jax_format_results("SRR1.fastq", subj, search_reads(iter(reads), subj, opt))

    shapes = []
    real = tdev.read_batch_counts

    def spy(block, lens, tables, out=None):
        shapes.append(tuple(block.shape))
        return real(block, lens, tables, out)

    monkeypatch.setattr(tdev, "read_batch_counts", spy)
    dev = tengine.format_results(
        "SRR1.fastq", subj, tdev.search_reads_device(iter(reads), subj, opt, batch_size=32))
    assert dev == host and dev.count("\n") > 10
    # 150 bp: 71 reads in batches of 32, 32 and 7 -> 8 rows; 17,000-32,768 bp:
    # three reads -> 4 rows (the 16,404 bp one has 2^14 windows: one tile);
    # 33,000 bp: one read, one row.
    assert shapes == [(32, 256), (32, 256), (8, 256), (4, 32768), (1, 65536)]


def test_span_pipeline_overlap_order(data_dir):
    """Span i+1 is dispatched before span i is read back (the profile's
    events), and profiling does not change the result."""
    from kwage_tpu.io.sequence import iter_sequences

    reads = [s for _, s in iter_sequences(str(data_dir / "sriracha_reads.fasta"))]
    reads = (reads * 4)[:50]
    tuples = [(s, i + 1, 1) for i, s in enumerate(reads)]
    subjects = load_subject_kmers([str(data_dir / "sriracha_queries.fasta")], 11)
    opt = SrirachaOptions(kmer_len=11, kmer_match_threshold=0.4, min_valid_kmer=1,
                          max_num_match=5)
    prof: dict = {}
    got = tdev.search_reads_device(iter(tuples), subjects, opt, batch_size=4,
                                   span_reads=8, profile=prof)
    plain = tdev.search_reads_device(iter(tuples), subjects, opt, batch_size=4, span_reads=8)
    assert _matches(got) == _matches(plain)
    assert _matches(got) == _matches(jdev.search_reads_device(
        iter(tuples), subjects, opt, batch_size=4, span_reads=8))
    ev, n_spans = prof["events"], prof["spans"]
    assert n_spans >= 3
    assert [e for e in ev if e[0] == "dispatch"] == [("dispatch", i) for i in range(n_spans)]
    assert [e for e in ev if e[0] == "sync"] == [("sync", i) for i in range(n_spans)]
    for i in range(1, n_spans):
        assert ev.index(("dispatch", i)) < ev.index(("sync", i - 1)), ev
    assert prof["bp"] == sum(len(s) for s in reads)
    assert prof["pack_dispatch_s"] > 0 and prof["sync_s"] > 0


# --- search_reads_device over a mesh of logical slots ----------------------------------------

MESH_SLOTS = [2, 4, 8]
_JAX_MESH_RUNS: dict = {}


def _mesh_case(data_dir, k):
    """57 reads of 46-150 bp (buckets of 64 and 128 bases): in spans of 8
    with batch_size=4, every batch has fewer reads than 8 slots, some
    fewer than 2, and the last span holds one read."""
    from kwage_tpu.io.sequence import iter_sequences

    seqs = [s for _, s in iter_sequences(str(data_dir / "sriracha_reads.fasta"))][:57]
    reads = [(s, i + 1, 1) for i, s in enumerate(seqs)]
    subjects = load_subject_kmers([str(data_dir / "sriracha_queries.fasta")], k)
    opt = SrirachaOptions(kmer_len=k, kmer_match_threshold=0.3, min_valid_kmer=1,
                          max_num_match=5)
    return reads, subjects, opt


def _spy_batches(monkeypatch) -> list:
    """Rows of every read_batch_counts call, in order."""
    calls = []
    real = tdev.read_batch_counts

    def spy(block, lengths, tables, out=None):
        calls.append(block.shape[0])
        return real(block, lengths, tables, out)

    monkeypatch.setattr(tdev, "read_batch_counts", spy)
    return calls


@pytest.mark.parametrize("slots", MESH_SLOTS)
@pytest.mark.parametrize("k", [11, 21])
def test_search_reads_device_on_a_mesh(k, slots, data_dir, monkeypatch):
    """Meshes of 2, 4 and 8 logical CPU slots (a device list and a
    SearchMesh) equal the single-device run and the JAX function, which
    shards over the 8 virtual devices of conftest: k = 11 on the dense LUTs,
    k = 21 on the hash tables. Each batch is split over the slots."""
    from kwage_tpu_torch.parallel.mesh import make_search_mesh

    monkeypatch.setenv("KWAGE_SRIRACHA_HASH_MAX", "0")  # the LUTs wherever k allows
    reads, subjects, opt = _mesh_case(data_dir, k)
    assert tdev.use_lut(subjects, k, CPU) == (k == 11)
    calls = _spy_batches(monkeypatch)
    one = _matches(tdev.search_reads_device(iter(reads), subjects, opt, batch_size=4,
                                            span_reads=8, device=CPU))
    n_one = len(calls)
    for mesh in ([CPU] * slots, make_search_mesh(slots, 1, [CPU] * slots)):
        del calls[:]
        got = tdev.search_reads_device(iter(reads), subjects, opt, batch_size=4,
                                       span_reads=8, mesh=mesh)
        assert _matches(got) == one, slots
        assert len(calls) > n_one and max(calls) <= tdev.next_pow2(-(-4 // slots)), calls
    hit = [r for r in reads if r[1] == min(m[0] for b in one for m in b)]
    del calls[:]
    single = _matches(tdev.search_reads_device(iter(hit), subjects, opt, batch_size=4,
                                               mesh=[CPU] * slots))
    assert calls == [1] and sum(map(len, single)) > 0
    assert single == _matches(tdev.search_reads_device(iter(hit), subjects, opt,
                                                       batch_size=4, device=CPU))
    if k not in _JAX_MESH_RUNS:
        _JAX_MESH_RUNS[k] = _matches(jdev.search_reads_device(
            iter(reads), subjects, opt, batch_size=4, span_reads=8))
    assert one == _JAX_MESH_RUNS[k]
    assert sum(map(len, one)) > 0


def test_mesh_profile_events_order(data_dir):
    """Under a mesh of 4 slots span i+1 is still dispatched before span i
    is read back, once each, and profiling does not change the result."""
    reads, subjects, opt = _mesh_case(data_dir, 11)
    prof: dict = {}
    got = tdev.search_reads_device(iter(reads), subjects, opt, batch_size=4, span_reads=8,
                                   mesh=[CPU] * 4, profile=prof)
    assert _matches(got) == _matches(tdev.search_reads_device(
        iter(reads), subjects, opt, batch_size=4, span_reads=8, device=CPU))
    ev, n_spans = prof["events"], prof["spans"]
    assert n_spans == 8
    assert [e for e in ev if e[0] == "dispatch"] == [("dispatch", i) for i in range(n_spans)]
    assert [e for e in ev if e[0] == "sync"] == [("sync", i) for i in range(n_spans)]
    for i in range(1, n_spans):
        assert ev.index(("dispatch", i)) < ev.index(("sync", i - 1)), ev
    assert prof["bp"] == sum(len(r[0]) for r in reads)


def test_auto_mesh_takes_default_devices_and_device_overrides(data_dir, monkeypatch):
    """With several default devices the search splits over them all (as
    many batch calls as an explicit mesh of 4); ``device=`` and
    ``auto_mesh=False`` keep one slot; a mesh with a filters axis, or a
    mesh and a device together, is refused."""
    import kwage_tpu_torch.parallel.mesh as tmesh

    reads, subjects, opt = _mesh_case(data_dir, 21)
    calls = _spy_batches(monkeypatch)

    def run(**kw):
        del calls[:]
        got = _matches(tdev.search_reads_device(iter(reads), subjects, opt, batch_size=4,
                                                span_reads=8, **kw))
        return got, len(calls)

    one, n_one = run()
    explicit, n_mesh = run(mesh=[CPU] * 4)
    monkeypatch.setattr(tmesh, "default_devices", lambda: [CPU] * 4)
    assert tdev.read_slots() == [(CPU, None)] * 4
    assert run() == (explicit, n_mesh) and n_mesh > n_one
    assert run(device=CPU) == (one, n_one) == run(auto_mesh=False)
    assert explicit == one
    assert tdev.read_slots(device=CPU) == [(CPU, None)]
    with pytest.raises(ValueError, match="one column"):
        tdev.read_slots(mesh=tmesh.make_search_mesh(2, 2, [CPU] * 4))
    with pytest.raises(ValueError, match="not both"):
        tdev.read_slots(mesh=[CPU] * 2, device=CPU)


@pytest.mark.parametrize("case", CASES)
def test_device_cli_over_a_mesh_matches_oracle(case, data_dir, golden_dir, tmp_path,
                                               monkeypatch):
    """``kwage-sriracha-torch --device`` with 4 default devices takes the
    mesh path (4 slots) and writes the golden TSV."""
    import kwage_tpu_torch.parallel.mesh as tmesh

    monkeypatch.setattr(tmesh, "default_devices", lambda: [CPU] * 4)
    seen = []
    real = tdev.read_slots

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(tdev, "read_slots", spy)
    got = _run(torch_sriracha_main, _args(case, data_dir, device=True), tmp_path)
    want = (golden_dir / "sriracha" / f"{case}.tsv").read_text()
    assert _norm(got) == _norm(want), case
    assert seen and all(len(slots) == 4 for slots in seen), seen


def test_pack_batch_rows():
    block = np.zeros((4, 64), np.uint8)
    lengths = np.zeros(4, np.int32)
    tdev._pack_batch(block, lengths, ["ACGT", "", "g" * 64])
    assert lengths.tolist() == [4, 0, 64, 0]
    assert block[0, :5].tobytes() == b"ACGT\0" and not block[1].any()
    assert block[2].tobytes() == b"g" * 64 and not block[3].any()
    assert [tdev.pad_len(n) for n in (0, 64, 65, 20_000)] == [64, 64, 128, 32768]


# --- routing and the kernels on a card ------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions():
    before = kernels.launch_counts()
    b, lengths = _read_block(6, 16, 64, 11)
    subj = [(f"s{i}", s) for i, s in enumerate(_subject_sets(6, 3, 11))]
    for tables in (tdev.build_hash_tables(subj, 11, CPU), tdev.build_lut_tables(subj, 11, CPU)):
        tdev.read_batch_counts(torch.from_numpy(b), torch.from_numpy(lengths), tables)
    assert kernels.launch_counts() == before


def test_other_devices_and_bad_input_raise():
    meta = torch.device("meta")
    tables = tdev.LutTables(torch.zeros((1, 64), dtype=torch.int32, device=meta), 3, 1)
    w = torch.zeros((2, 62), dtype=torch.int64, device=meta)
    v = torch.zeros((2, 62), dtype=torch.bool, device=meta)
    lens = torch.zeros(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tdev.sriracha_counts(w, v, lens, tables)
    with pytest.raises(ValueError, match="unsupported device"):
        tdev.subject_table(torch.zeros((1, 3), dtype=torch.int64, device=meta), 3)
    w, v = torch.zeros((2, 62), dtype=torch.int64), torch.zeros((2, 62), dtype=torch.bool)
    with pytest.raises(ValueError, match="lengths"):
        tdev.sriracha_counts(w, v, torch.zeros(2, dtype=torch.int64), tables)
    with pytest.raises(ValueError, match="out must be"):
        tdev.sriracha_counts(w, v, torch.zeros(2, dtype=torch.int32), tables,
                             out=torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="dense table"):
        tdev.subject_table(torch.zeros((1, 3), dtype=torch.int64), 15)


def test_read_batch_counts_bad_input_raises():
    """read_batch_counts checks what it is given before any route: a
    device other than the CPU or a card, reads that are not uint8 [B, L],
    lengths that are not int32 [B], a batch narrower than k, a wrong out."""
    tables = tdev.LutTables(torch.zeros((1, 64), dtype=torch.int32), 3, 1)
    reads, lens = torch.zeros((2, 64), dtype=torch.uint8), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        tdev.read_batch_counts(reads.to("meta"), lens.to("meta"), tables)
    with pytest.raises(ValueError, match="uint8 reads"):
        tdev.read_batch_counts(reads.long(), lens, tables)
    with pytest.raises(ValueError, match="lengths"):
        tdev.read_batch_counts(reads, lens[:1], tables)
    with pytest.raises(ValueError, match="shorter than k"):
        tdev.read_batch_counts(reads[:, :2], lens, tables)
    with pytest.raises(ValueError, match="out must be"):
        tdev.read_batch_counts(reads, lens, tables, out=torch.zeros((2, 2), dtype=torch.int32))


@pytest.mark.cuda
def test_sriracha_reads_match_ref(cuda_device):
    """The fused entries against read_batch_counts_ref at every bucket of
    64-512 bases, at widths that are not a multiple of 16 (150, 200, and
    543 at k = 32: 512 windows) and on reads one byte off a 16-byte boundary
    (the kernel's byte-load staging); one launch a batch, counted under its
    probe."""
    for k, L, off in ((1, 64, 0), (3, 64, 0), (11, 256, 0), (13, 512, 0), (16, 64, 0),
                      (17, 128, 0), (21, 256, 0), (31, 512, 0), (32, 64, 0), (32, 512, 0),
                      (11, 150, 0), (21, 200, 0), (32, 150, 0), (32, 543, 0), (1, 256, 1),
                      (21, 512, 1), (32, 128, 1)):
        b, lengths = _edge_block(k, L, 30 + k)
        sets = _hit_sets(b, lengths, k, 31 + k)
        subj = [(f"s{i}", s) for i, s in enumerate(sets)]
        flat = torch.zeros(b.size + off, dtype=torch.uint8, device=cuda_device)
        reads = flat[off:].view(b.shape)
        reads.copy_(torch.from_numpy(b))
        assert reads.data_ptr() % 16 == off
        lens = torch.from_numpy(lengths).to(cuda_device)
        routes = [tdev.build_hash_tables(subj, k, cuda_device)]
        if k <= 13:
            routes.append(tdev.build_lut_tables(subj, k, cuda_device))
        for tables in routes:
            want = tdev.read_batch_counts_ref(reads, lens, tables)
            before = kernels.launch_counts()
            got = tdev.read_batch_counts(reads, lens, tables)
            after = kernels.launch_counts()
            name = f"sriracha_reads_{tables.route}"
            assert after == {**before, name: before[name] + 1}
            assert torch.equal(got, want), (k, L, off, tables.route)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sriracha_block_match_ref(cuda_device):
    """The block-a-read entries against read_batch_counts_ref at buckets of
    1024-16384 bases (P = 1024 to 2^14 sort slots), at every k branch, at
    a width that is no power of two and one of 2^14 + k - 1 (2^14 windows),
    and on reads one byte off a 16-byte boundary; one launch a batch,
    counted under its probe."""
    for k, L, off in ((3, 1024, 0), (11, 2048, 0), (13, 4096, 0), (14, 1024, 1), (16, 8192, 0),
                      (17, 16384, 0), (21, 1500, 0), (21, 16384 + 20, 0), (31, 2048, 1),
                      (32, 16384, 0)):
        b, lengths = _wide_block(k, L, 70 + k)
        sets = _hit_sets(b, lengths, k, 71 + k)
        subj = [(f"s{i}", s) for i, s in enumerate(sets)]
        flat = torch.zeros(b.size + off, dtype=torch.uint8, device=cuda_device)
        reads = flat[off:].view(b.shape)
        reads.copy_(torch.from_numpy(b))
        lens = torch.from_numpy(lengths).to(cuda_device)
        routes = [tdev.build_hash_tables(subj, k, cuda_device)]
        if k <= 14:
            routes.append(tdev.build_lut_tables(subj, k, cuda_device))
        for tables in routes:
            want = tdev.read_batch_counts_ref(reads, lens, tables)
            before = kernels.launch_counts()
            got = tdev.read_batch_counts(reads, lens, tables)
            after = kernels.launch_counts()
            name = f"sriracha_block_{tables.route}"
            assert after == {**before, name: before[name] + 1}
            assert torch.equal(got, want), (k, L, off, tables.route)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_sriracha_kernels_match_ref(cuda_device):
    for k, L in ((3, 64), (11, 256), (13, 64), (16, 64), (21, 256), (32, 128), (21, 32768)):
        B = 4 if L > 1024 else 32
        b, lengths = _read_block(9, B, L, k)
        sets = _subject_sets(10, 40, k)
        subj = [(f"s{i}", s) for i, s in enumerate(sets)]
        reads = torch.from_numpy(b).to(cuda_device)
        lens = torch.from_numpy(lengths).to(cuda_device)
        words, valid = tdev.canonical_kmers(reads, k)
        routes = [tdev.build_hash_tables(subj, k, cuda_device)]
        if k <= 13:
            routes.append(tdev.build_lut_tables(subj, k, cuda_device))
            sm = tdev.subjects_matrix(subj, cuda_device)
            assert torch.equal(tdev.subject_table(sm, k), tdev.subject_table_ref(sm, k))
        for tables in routes:
            got = tdev.sriracha_counts(words, valid, lens, tables)
            assert torch.equal(got, tdev.sriracha_counts_ref(words, valid, lens, tables)), (k, L)
    # The words entry's rows of at most 2^14 windows (the block kernel from
    # words): widths of 2048 and 16384 bases, a wide batch whose rows of 0,
    # k - 1, 16385 and 16384 + k - 1 bases sit beside rows of the tile
    # chain, and words and flags 8 bytes off a 16-byte boundary; one launch
    # a call, counted under its probe.
    for k, L in ((3, 2048), (11, 2048), (14, 16384), (16, 16384 + 15), (17, 2048),
                 (21, 16384), (21, 1 << 15), (11, 1 << 15), (32, 1 << 15)):
        b, lengths = _read_block(90 + k, 12, L, k)
        if L > 16384 + k:
            lengths[:6] = [0, k - 1, 16385, 16384 + k - 1, 16384 + k, L]
            for r, n in enumerate(lengths):
                b[r, n:] = 0
        sets = _hit_sets(b, lengths, k, 91 + k)
        subj = [(f"s{i}", s) for i, s in enumerate(sets)]
        lens = torch.from_numpy(lengths).to(cuda_device)
        words, valid = tdev.canonical_kmers(torch.from_numpy(b).to(cuda_device), k)
        w_off = torch.empty(words.numel() + 1, dtype=torch.int64, device=cuda_device)[1:]
        v_off = torch.empty(valid.numel() + 8, dtype=torch.bool, device=cuda_device)[8:]
        w_off, v_off = w_off.view(words.shape), v_off.view(valid.shape)
        w_off.copy_(words)
        v_off.copy_(valid)
        assert w_off.data_ptr() % 16 == 8 and v_off.data_ptr() % 16 == 8
        routes = [tdev.build_hash_tables(subj, k, cuda_device)]
        if k <= 14:
            routes.append(tdev.build_lut_tables(subj, k, cuda_device))
        for tables in routes:
            want = tdev.sriracha_counts_ref(words, valid, lens, tables)
            name = f"sriracha_counts_{tables.route}"
            for w, v in ((words, valid), (w_off, v_off)):
                before = kernels.launch_counts()
                got = tdev.sriracha_counts(w, v, lens, tables)
                assert kernels.launch_counts() == {**before, name: before[name] + 1}
                assert torch.equal(got, want), (k, L, tables.route, w.data_ptr() % 16)
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", [11, 21, 32])
def test_reads_work_counts_table_sectors(k):
    """bench.sriracha's bound model of the fused kernel: a LUT 4 bytes a
    distinct word and group; a hash table a 32-byte key sector a distinct
    word and group and a 32-byte mask sector a hit, counted here from
    python sets of the reads' and the groups' words; the reads, lengths and
    counts once; each group capped at its table's bytes."""
    from kwage_tpu_torch.bench.sriracha import read_block, reads_work, table_bytes

    rng = np.random.default_rng(40 + k)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = rng.integers(0, 4, size=(40, 2000), dtype=np.uint8)
    b, lengths = read_block(rng, genomes, 48, 256, 150)
    assert (lengths[-3:] == 0).all() and not b[-3:].any() and (b[:-3, 150:] == 0).all()
    subj = [(f"s{i}", np.unique(host_canonical_kmers(acgt[g].tobytes(), k)))
            for i, g in enumerate(genomes)]
    reads, lens = torch.from_numpy(b), torch.from_numpy(lengths)
    per_read = [set(host_canonical_kmers(b[r, :n].tobytes(), k).tolist()) if n >= k else set()
                for r, n in enumerate(lengths)]
    groups = [set().union(*(set(s.tolist()) for _, s in subj[g : g + 32])) for g in (0, 32)]
    distinct = sum(len(w) for w in per_read)
    hits = sum(len(w & grp) for w in per_read for grp in groups)
    fixed = b.size + 4 * 48 + 4 * 48 * 42
    routes = [tdev.build_hash_tables(subj, k, torch.device("cpu"))]
    if k <= tdev.MAX_TABLE_K:
        routes.append(tdev.build_lut_tables(subj, k, torch.device("cpu")))
    for tables in routes:
        nbytes, nops = reads_work(reads, lens, tables)
        want = tdev.read_batch_counts_ref(reads, lens, tables)
        assert int(want[:, 41].sum()) == distinct
        per_probe = (8 * distinct if tables.route == "lut" else 32 * (2 * distinct + hits))
        assert nbytes == fixed + per_probe, tables.route
        assert nops > 8 * int(lens.sum())
    # A table smaller than the probes' sectors is read once.
    small = tdev.build_hash_tables(subj[:1], k, torch.device("cpu"))
    words = torch.from_numpy(np.array([x for w in per_read for x in w], np.uint64).view(np.int64))
    whole = (int(small.bmask[0]) + 1) * tdev.BUCKET_CAP * 12
    assert 32 * words.numel() > whole
    assert table_bytes(words, small) == whole

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
    the kernel's shared-memory sort) equal the host engine."""
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
    opt = SrirachaOptions(kmer_len=k, kmer_match_threshold=0.8)
    host = _matches(search_reads(iter(reads), subj, opt))
    assert any(m[3] == reads[-2][0] for m in host[0])
    assert _matches(tdev.search_reads_device(iter(reads), subj, opt, batch_size=4)) == host


def test_sriracha_counts_rows_around_the_tile_match_jax():
    """One batch that mixes rows of 0, 1, 2^14 - 1, 2^14, 2^14 + 1 and 2^15
    valid words (the kernel sorts a row above 2^14 in tiles across blocks):
    the wrapper's scratch sizing runs on the CPU too, and
    the counts equal the JAX kernel's."""
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
    torch.cuda.synchronize()

"""The port's mesh search across processes: 2 torch.distributed CPU
processes (gloo).

The logical-shard mesh used everywhere else lives in ONE process; this
suite spawns two OS processes that form a gloo-backed torch.distributed
cluster (2 logical shards each -> 4 global), build the process-spanning
global mesh, and run `sharded_search_files` end to end over on-disk .db
files. Every process must emit the identical GLOBAL hit list (outputs are
all-gathered back by `to_host`), and that hit list must equal the port's
host engine's -- the cross-process counterpart of the reference's MPI
rank-0 result merge (SriRachA/main.cpp:462-531). The worker imports the
port alone.
"""

import json
import os
import sys

import numpy as np
import pytest
from _torch_ports import run_together, with_fresh_port

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from kwage_tpu_torch.core import FilterInfo, str_to_accession
    from kwage_tpu_torch.io.bloom_file import write_bloom_file
    from kwage_tpu_torch.pipeline.build_db import build_db_from_bloom_files
    from kwage_tpu_torch.pipeline.make_bloom import BuildOptions, build_bloom_from_file

    work = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(40)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    opts = BuildOptions(
        kmer_len=31, min_kmer_count=1,
        min_log_2_filter_len=10, max_log_2_filter_len=14,
        min_log_2_count_len=10, max_log_2_count_len=14,
    )
    genomes, blooms = {}, []
    (work / "db").mkdir()
    for i in range(6):
        acc = f"SRR88000{i}"
        g = lut[rng.integers(0, 4, size=3000, dtype=np.uint8)].tobytes().decode()
        genomes[acc] = g
        fa = work / f"{acc}.fasta"
        fa.write_text(f">{acc}\n{g}\n")
        rec = build_bloom_from_file(
            str(fa), opts, FilterInfo(run_accession=str_to_accession(acc)))
        bpath = work / f"{acc}.bloom"
        write_bloom_file(str(bpath), rec)
        blooms.append((rec.param, str(bpath)))
    # Two .db files of 3 filters each (same param group).
    param = blooms[0][0]
    assert all(p == param for p, _ in blooms)
    for fi, chunk in enumerate((blooms[:3], blooms[3:])):
        build_db_from_bloom_files(
            str(work / "db" / f"sra.{fi + 1}.db"), param,
            [b for _, b in chunk])
    queries = [
        [0, genomes["SRR880001"][500:900]],
        [1, genomes["SRR880004"][100:450]],
        [2, "".join("ACGT"[b] for b in rng.integers(0, 4, size=200))],
    ]
    (work / "queries.json").write_text(json.dumps(queries))
    return work, queries


def test_two_process_mesh_search_matches_host(corpus):
    work, queries = corpus
    env = dict(os.environ, OMP_NUM_THREADS="2")
    worker = os.path.join(HERE, "_torch_multihost_worker.py")
    # The rendezvous port is taken anew when another process took it first.
    runs = with_fresh_port(lambda port: run_together(
        [[sys.executable, worker, str(pid), "2", str(port), str(work)] for pid in range(2)],
        [env, env], timeout=240))
    outs = []
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
        lines = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")]
        assert lines, r.stdout
        outs.append(json.loads(lines[-1][len("RESULT "):]))

    # Identical global result on every process.
    assert outs[0] == outs[1]

    # Equal to the host engine (the reference's output semantics).
    from kwage_tpu_torch.search.engine import search_database_files

    dbs = sorted(str(p) for p in (work / "db").glob("*.db"))
    want = search_database_files(dbs, [(i, q) for i, q in queries], 0.5)
    expect = {
        str(i): [
            [m.num_kmers_found, m.num_query_kmer,
             int(m.subject_info.run_accession)]
            for m in ms
        ]
        for i, ms in sorted(want.items())
    }
    totals = outs[0].pop("totals")
    assert outs[0] == {q: hits for q, hits in expect.items() if hits}
    assert totals == [len(expect.get(str(i), [])) for i, _ in queries]
    # The random query must have matched nothing; the genome slices must
    # have matched their source accession (guards against an all-empty
    # vacuous pass).
    assert outs[0].get("2", []) == [] and outs[0]["0"] and outs[0]["1"]

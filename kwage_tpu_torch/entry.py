"""Entry points of the port, the counterparts of ``entry()`` and
``dryrun_multichip()`` in the repository's ``__graft_entry__.py``: a
single-device forward step, and the whole pipeline over a device mesh.

The step is the device query pipeline: ASCII query bytes -> canonical
k-mers (canonical_kmers kernel) -> slice indices (murmur32 kernel) ->
gather + AND over a packed signature matrix -> per-filter hit counts
(search_counts kernel). The example arguments are the JAX entry's, made
from the same seed, on ``resolve_device()``.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .ops.hashing import slice_indices
from .ops.kmers import canonical_kmers
from .ops.search import search_counts, words_to_tensor
from .utils.runtime import resolve_device

K = 31
NUM_HASH = 5
LOG2_L = 14            # 16384 slice rows
W = 8                  # 256 filters packed into uint32 words
QLEN = 256


def forward(db: torch.Tensor, query_ascii: torch.Tensor) -> torch.Tensor:
    """Hit counts int32 [1, W*32] of one ASCII query uint8 [QLEN]."""
    words, valid = canonical_kmers(query_ascii, K)
    idx = slice_indices(words, K, NUM_HASH, LOG2_L)
    return search_counts(db, idx[None], valid[None])


def entry(device: torch.device | None = None):
    """(forward, example_args): a random signature matrix int32 [2^14, 8]
    and a random ASCII-ish query, both on ``device``."""
    device = resolve_device() if device is None else device
    rng = np.random.default_rng(0)
    db = words_to_tensor(rng.integers(0, 1 << 32, size=(1 << LOG2_L, W), dtype=np.uint32), device)
    query = torch.from_numpy(rng.integers(65, 85, size=QLEN, dtype=np.uint8)).to(device)
    return forward, (db, query)


def dryrun_multichip(n_devices: int) -> None:
    """Run the FULL pipeline over an n_devices mesh.

    A synthetic corpus is driven through the Maestro scheduler with device
    ingest (exact-count thresholding) and device transpose, producing
    on-disk .db files and an atomic status checkpoint; the files are then
    searched on the mesh ("filters" = corpus axis, "data" = query batch
    axis) in budgeted column waves, and the mesh hit lists are verified
    identical to the port's host engine (= the reference binary's output
    semantics). A restore pass checks checkpoint interop. With fewer
    devices visible than ``n_devices`` the mesh is made of logical shards
    on those there are, and a line on stdout says so.
    """
    from .core import FilterInfo, str_to_accession
    from .io.inventory import write_inventory
    from .io.status import read_status_file
    from .parallel.maestro import (
        STATUS_DATABASE_SUCCESS,
        LocalFastaResolver,
        Maestro,
        MaestroOptions,
    )
    from .parallel.mesh import default_devices, make_search_mesh
    from .parallel.sharded_search import sharded_search_files
    from .search.engine import search_database_files

    visible = default_devices()
    devices = [visible[i % len(visible)] for i in range(n_devices)]
    if len(visible) < n_devices:
        print(f"dryrun_multichip: {len(visible)} device(s) visible ({visible[0]}, ...); the "
              f"{n_devices}-slot mesh is made of logical shards on them")
    num_data = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_search_mesh(num_data, n_devices // num_data, devices)
    rng = np.random.default_rng(1)

    with tempfile.TemporaryDirectory(prefix="kwage_dryrun.") as work:
        # Tiny synthetic corpus: one genome per accession.
        src = os.path.join(work, "src")
        os.makedirs(src)
        accs = [f"SRR{7000000 + i}" for i in range(6)]
        genomes = {}
        for acc in accs:
            g = "".join(rng.choice(list("ACGT")) for _ in range(400))
            genomes[acc] = g
            with open(os.path.join(src, acc + ".fasta"), "w") as f:
                f.write(f">{acc}\n{g}\n")
        write_inventory(
            os.path.join(work, "inv.bin"),
            [FilterInfo(run_accession=str_to_accession(a)) for a in accs],
        )

        # 1-2. Maestro run: device ingest (sort + run selection on the
        # default device) + device transpose -> .db files + status
        # checkpoint.
        opt = MaestroOptions(
            metadata_file=os.path.join(work, "inv.bin"),
            scratch_bloom_dir=os.path.join(work, "bloom"),
            scratch_database_dir=os.path.join(work, "db"),
            status_file=os.path.join(work, "status.bin"),
            kmer_len=31,
            min_kmer_count=1,
            min_log_2_filter_len=12,
            max_log_2_filter_len=16,
            min_log_2_count_len=12,
            max_log_2_count_len=16,
            num_workers=1,
            device_build=True,
            device_transpose=True,
        )
        m = Maestro(opt, LocalFastaResolver(src))
        m.restore()
        m.run()
        assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()

        # Checkpoint interop: the status file restores to all-terminal and
        # a second run is a no-op.
        status, db_index = read_status_file(opt.status_file, len(accs))
        assert (status == STATUS_DATABASE_SUCCESS).all() and db_index >= 2
        m2 = Maestro(opt, LocalFastaResolver(src))
        m2.restore()
        m2.run()
        assert all(s == STATUS_DATABASE_SUCCESS for s in m2.status)

        db_paths = sorted(
            os.path.join(work, "db", f)
            for f in os.listdir(os.path.join(work, "db"))
            if f.endswith(".db")
        )
        assert db_paths

        # 3. Mesh-sharded search of the produced files, with a budget
        # small enough to force multi-wave streaming, vs the host engine.
        queries = [(i, genomes[acc][50:150]) for i, acc in enumerate(accs[:3])]
        queries.append((3, "".join(rng.choice(list("ACGT")) for _ in range(90))))
        for threshold in (1.0, 0.5):
            got = sharded_search_files(
                mesh, db_paths, queries, threshold, budget_bytes=1 << 10
            )
            want = search_database_files(db_paths, queries, threshold)
            assert set(got) == set(want), (sorted(got), sorted(want))
            for qid in want:
                g = [(r.num_kmers_found, r.num_query_kmer,
                      int(r.subject_info.run_accession)) for r in got[qid]]
                w = [(r.num_kmers_found, r.num_query_kmer,
                      int(r.subject_info.run_accession)) for r in want[qid]]
                assert g == w, (qid, g, w)
        # Every self-query must have found its own accession completely.
        full = sharded_search_files(mesh, db_paths, queries[:3], 1.0)
        assert all(qid in full for qid, _ in queries[:3])


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
    from .parallel.mesh import default_devices

    dryrun_multichip(len(default_devices()))
    print("dryrun ok")

"""Subprocess body for test_torch_multihost: one process of a 2-process
torch.distributed (gloo) cluster running the port's mesh search pipeline on
the CPU, two logical shards a process.

Usage: python _torch_multihost_worker.py <pid> <nproc> <port> <workdir>
Prints one line: RESULT <json> (identical on every process: mesh outputs
are all-gathered back to each process by sharded_search.to_host).
"""

import glob
import json
import os
import sys

# Runnable straight from a checkout, with or without `pip install -e .`.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pid, nproc, port, work = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    os.environ["KWAGE_TORCH_DEVICE"] = "cpu"

    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    from kwage_tpu_torch.parallel.distributed import (
        init_distributed,
        make_global_search_mesh,
        shard_inventory,
    )

    assert init_distributed(f"localhost:{port}", nproc, pid)
    assert dist.get_world_size() == nproc and dist.get_backend() == "gloo"
    mesh = make_global_search_mesh(num_data=1, local_devices=["cpu"] * 2)
    assert mesh.size == 2 * nproc and mesh.spans_processes
    assert mesh.local_slots() == [(0, 2 * pid), (0, 2 * pid + 1)]

    from kwage_tpu_torch.parallel.sharded_search import (
        ShardedDatabase,
        sharded_search_files,
    )

    dbs = sorted(glob.glob(os.path.join(work, "db", "*.db")))
    with open(os.path.join(work, "queries.json")) as f:
        queries = [(int(i), q) for i, q in json.load(f)]
    got = sharded_search_files(mesh, dbs, queries, 0.5)
    out = {
        str(i): [
            [m.num_kmers_found, m.num_query_kmer,
             int(m.subject_info.run_accession)]
            for m in ms
        ]
        for i, ms in sorted(got.items())
    }
    # The same files streamed in waves over a 2 x 2 mesh, and the totals
    # summed over shards that two processes hold.
    mesh2 = make_global_search_mesh(local_devices=["cpu"] * 2)
    assert mesh2.shape == {"data": 2, "filters": 2}
    waved = sharded_search_files(mesh2, dbs, queries, 0.5, budget_bytes=1 << 10)
    assert {str(i): [[m.num_kmers_found, m.num_query_kmer, int(m.subject_info.run_accession)]
                     for m in ms] for i, ms in sorted(waved.items())} == out
    totals = ShardedDatabase.from_files(mesh, dbs).total_hits([q for _, q in queries], 0.5)
    out["totals"] = [int(t) for t in totals]
    # The contiguous per-host split rule is pure arithmetic; pin it here
    # so the multi-process run exercises it at its real call site shape.
    first, last = shard_inventory(10, pid, nproc)
    assert 0 <= first <= last <= 10
    print("RESULT " + json.dumps(out, sort_keys=True), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()

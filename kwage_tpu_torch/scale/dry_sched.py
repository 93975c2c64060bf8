"""The scheduler alone at 50,000 accessions: the port's counterpart of
``tools/dry_sched_50k.py``.

    python3 -m kwage_tpu_torch.scale.dry_sched [--out PATH]

DRY_N (50000) accessions run through the port's ``parallel.maestro``
event loop with instant fake workers (no parsing and no device: a fake
build returns a BloomParam at once, alternating L = 18 and 19 so that two
BloomParam groups are open, and a fake pack returns the file's name), so
the wall is the scheduling alone: cursor dispatch, event absorption, the
group map, quota packing, checkpoints. The run must commit every
accession and open no .bloom file (``read_bloom_file`` is counted): the
groups come from the events, not from rescanning the scratch directory.
Each checkpoint (the status file, written and fsynced) is timed:
``checkpoint_sec`` is their sum and ``schedule_sec`` the wall without it,
since an fsync waits on whatever the disk still has to write; one that
takes past a second is reported on stderr as it ends.

This program touches no card. It is ported because its original drives
``kwage_tpu/parallel/maestro.py``, which the port copied and gave device
branches (``--device-build``, ``--device-transpose``): the scheduler those
branches run inside must stay flat at this scale. Like every program of
the port it resolves its device first (``KWAGE_TORCH_DEVICE``; it exits 1
without a card unless that names the CPU), though it launches nothing
there. The device line, then one JSON line (the JAX tool's keys, the device and
the card's name and power limit), also written
to ``--out`` (default: dry_sched.json in the temporary directory).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

from ..bench._common import bench_device, out_arg, out_path, print_device
from ..core import BloomParam, FilterInfo, str_to_accession
from ..core.hash import MURMUR_HASH_32
from ..io.inventory import write_inventory
from ..parallel import maestro as maestro_mod
from ..parallel.maestro import (
    STATUS_DATABASE_SUCCESS,
    LocalFastaResolver,
    Maestro,
    MaestroOptions,
)

N = int(os.environ.get("DRY_N", "50000"))


class DryMaestro(Maestro):
    """Instant worker fakes: the event loop is the only real work."""

    def _process_accession(self, idx, phase):
        # Two shapes -> two concurrent BloomParam groups in the map.
        L = 18 + (idx & 1)
        return (idx, maestro_mod.STATUS_BLOOM_SUCCESS,
                BloomParam(kmer_len=31, log_2_filter_len=L, num_hash=5,
                           hash_func=MURMUR_HASH_32), 0.0)

    def _build_database(self, db_index, param, members):
        return members, STATUS_DATABASE_SUCCESS, f"sra.{db_index}.db", 0.0


def run(n: int = N) -> dict:
    """The dry run over ``n`` accessions: the JAX tool's result keys and
    the checkpoints' count and seconds."""
    opens = {"n": 0}
    real, real_write = maestro_mod.read_bloom_file, maestro_mod.write_status_file
    writes: list[float] = []

    def counting(path, with_bits=True):
        opens["n"] += 1
        return real(path, with_bits)

    def timed_write(*args):
        t0 = time.perf_counter()
        real_write(*args)
        writes.append(time.perf_counter() - t0)
        if writes[-1] > 1.0:
            print(f"dry_sched: checkpoint {len(writes)} took {writes[-1]:.1f} s",
                  file=sys.stderr, flush=True)

    maestro_mod.read_bloom_file = counting
    maestro_mod.write_status_file = timed_write
    work = tempfile.mkdtemp(prefix="kwage_dry_sched_")
    try:
        infos = [FilterInfo(run_accession=str_to_accession(f"SRR8{i:07d}")) for i in range(n)]
        inv = os.path.join(work, "inv.bin")
        write_inventory(inv, infos)
        opt = MaestroOptions(metadata_file=inv, scratch_bloom_dir=os.path.join(work, "bloom"),
                             scratch_database_dir=os.path.join(work, "db"),
                             status_file=os.path.join(work, "status.bin"), num_workers=4,
                             lazy_inventory=True)
        t0 = time.perf_counter()
        m = DryMaestro(opt, LocalFastaResolver(work))
        m.restore()
        m.run()
        dt = time.perf_counter() - t0
        return {"accessions": n, "ok": bool((m.status == STATUS_DATABASE_SUCCESS).all()),
                "db_files_packed": int(m.database_index - 1), "bloom_header_opens": opens["n"],
                "wall_sec": dt, "events_per_sec": n / dt, "checkpoints": len(writes),
                "checkpoint_sec": sum(writes), "checkpoint_max_sec": max(writes, default=0.0),
                "schedule_sec": dt - sum(writes)}
    finally:
        maestro_mod.read_bloom_file = real
        maestro_mod.write_status_file = real_write
        shutil.rmtree(work, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    args = out_arg(__doc__, argv)
    device = bench_device()
    card = print_device(device)
    out = {**run(N), "device": str(device), "card": card}
    print(json.dumps(out), flush=True)
    with open(out_path(args.out, "dry_sched"), "w") as f:
        json.dump([out], f, indent=1)
    return 0 if out["ok"] and out["bloom_header_opens"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

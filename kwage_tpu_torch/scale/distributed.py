"""At-scale proof of the distributed work queue, with device workers: the
port's counterpart of ``tools/run_at_scale_distributed.py``.

    python3 -m kwage_tpu_torch.scale.distributed [WORKDIR] [--out PATH]

The JAX tool's corpus (``_corpus.generate_dscale``: SCALE_N_ACC 1000
accessions SRR9000000 + i, random genomes of SCALE_GENOME 20000 bases,
SCALE_COV 3 records of up to 3000 bases each) served by ``python -m
kwage_tpu_torch.cli.maestro --coordinator 127.0.0.1:0`` (a free port, which
it binds and reports) to SCALE_WORKERS (2) ``--worker`` processes over
TCP, at min count 1 and L 16-20. The coordinator, the
workers and the single run build on the card (``--device-build
--device-transpose``; the JAX tool's build on the host): the coordinator
process holds its own 2 local device workers (``--device-build`` caps
``--workers`` at 2), so three processes share the card, each with its own
CUDA context and caching allocator. Every child is held at a READY line
after its imports, its CUDA context, its kernel library and host library
(built once by this process first), then released, so the walls compare
queue mechanics and work, not start-up. Phases, one JSON line each:

- ``generate``; ``distributed_run`` (coordinator + workers; the .bloom
  files kept); ``single_run`` (one maestro over the same inputs);
- ``queue_overhead``: an in-process ``CoordinatorServer`` over 300 tasks
  and a client that answers at once, timing each message of the wire
  protocol; ``crossover_check``: the slowdown the overhead predicts
  against the one observed;
- ``crash_recovery`` (unless SCALE_SKIP_CRASH=1): 2 device workers under
  ``--task-timeout 5``, one SIGKILLed mid-run; every accession must end
  terminal and the result set equal the single run's;
- ``latency_single_run`` / ``latency_distributed_run`` (unless
  SCALE_SKIP_LATENCY=1): SCALE_LAT_N (400) accessions through a fake
  ``fasterq-dump`` that sleeps SCALE_SIM_DELAY (0.25 s) first, one process
  of 4 workers against a ``--workers 1`` coordinator (one local pull
  thread, close to the reference's pure master) and SCALE_LAT_WORKERS (8)
  workers. These build on the host, as the JAX tool's do: the regime
  measures download latency, which the card does not change. The speedup
  must reach 1.3;
- ``blooms``: sampled .bloom files of the distributed run equal the exact
  ground truth of their reads, and the port's host build of the same
  files (at min count 1 the two builds must agree);
- ``search_parity``: the host engine's result sets (``kwage-torch -t 0.8
  --o.json``, 4 queries) of the distributed, single and crash corpora are
  equal; ``kwage-torch --device`` over the distributed corpus is byte
  for byte the host engine's; the reference ``kwage`` where it is built
  (``"oracle": "absent"`` otherwise).

Every accession of each run must be terminal (status file). Each line
carries the card's name and power limit, the peak host RSS and the
phase's peak device memory of this process; a device child reports its
own peak device memory and launches (``children``). Runs on the card
(``KWAGE_TORCH_DEVICE``, default ``cuda``; exits 1 without one);
``KWAGE_TORCH_DEVICE=cpu`` runs the plain versions (the tests). The lines
go to ``--out`` (default WORKDIR/distributed.json); a WORKDIR given is
kept, else a temporary one is removed. Exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

from .. import kernels
from ..bench._common import bench_device, card_identity
from ..cli.kwage import find_db_files
from ..cli.maestro import LISTENING
from ..core.params import BloomParam
from ..io.bloom_file import read_bloom_file
from ..io.inventory import write_inventory
from ..io.status import read_status_file
from ..native import available as native_available
from ..parallel.maestro import (
    STATUS_BLOOM_SUCCESS,
    STATUS_DATABASE_SUCCESS,
    Maestro,
    MaestroOptions,
    SourceResolver,
)
from ..parallel.remote import CoordinatorServer, _param_to_dict, _send_msg
from ..pipeline.make_bloom import BuildOptions, build_bloom_from_file
from . import _corpus
from ._corpus import PhaseLog
from .at_scale import kwage_bytes

N_ACC = int(os.environ.get("SCALE_N_ACC", "1000"))
GENOME = int(os.environ.get("SCALE_GENOME", "20000"))
COV = int(os.environ.get("SCALE_COV", "3"))
N_WORKERS = int(os.environ.get("SCALE_WORKERS", "2"))
SKIP_CRASH = os.environ.get("SCALE_SKIP_CRASH") == "1"
SKIP_LATENCY = os.environ.get("SCALE_SKIP_LATENCY") == "1"
LAT_N = int(os.environ.get("SCALE_LAT_N", "400"))
LAT_DELAY = float(os.environ.get("SCALE_SIM_DELAY", "0.25"))
LAT_WORKERS = int(os.environ.get("SCALE_LAT_WORKERS", "8"))
MIN_COUNT, LEN_MIN, LEN_MAX = 1, 16, 20
THRESHOLD = 0.8
DEVICE_FLAGS = ["--device-build", "--device-transpose"]
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# A held child: imports, then (with the device flags) its CUDA context,
# kernel library and host library, then READY; released by a line on
# stdin, whose words it adds to its arguments (a worker's --worker and the
# address its coordinator bound); at exit a device child reports its peak
# device memory and its launches on stderr.
WRAPPER = """\
import json, sys
import kwage_tpu_torch.cli.maestro as mm
device = '--device-build' in sys.argv or '--device-transpose' in sys.argv
if device:
    import torch
    from kwage_tpu_torch import kernels, native
    from kwage_tpu_torch.utils.runtime import resolve_device
    dev = resolve_device()
    torch.empty(1, device=dev)
    if dev.type == 'cuda':
        kernels.get_lib()
    native.available()
print('READY', flush=True)
release = sys.stdin.readline()
if not release.endswith('\\n'):
    sys.exit(3)     # the parent went away before the release
rc = mm.main(sys.argv[1:] + release.split())
if device:
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else None
    print('KWAGE_CHILD ' + json.dumps({'peak_device_bytes': peak,
                                       'launches': kernels.launch_counts()}),
          file=sys.stderr, flush=True)
sys.exit(rc)
"""


class Child:
    """A held maestro process; its output drained by threads (the tail of
    stderr kept), so that a child that logs much never blocks on a pipe.
    ``ready`` waits for its READY line: start every child of a run, then
    wait for each, so that their start-ups overlap. A coordinator's bound
    address (its ``LISTENING`` line) is kept for ``bound``."""

    def __init__(self, args: list[str], env: dict):
        self.proc = subprocess.Popen([sys.executable, "-c", WRAPPER, *args],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, env=env, text=True)
        self.err = collections.deque(maxlen=200)
        self._drains = []
        self._address = None
        self._listening = threading.Event()

    def ready(self) -> "Child":
        line = self.proc.stdout.readline().strip()
        if line != "READY":
            rc = self.proc.poll()
            err = self.proc.stderr.read()
            raise RuntimeError(f"held child failed before READY (rc={rc}, first line "
                               f"{line!r}): {err[-4000:]}")
        self._drains = [threading.Thread(target=lambda: [None for _ in self.proc.stdout],
                                         daemon=True),
                        threading.Thread(target=self._drain_err, daemon=True)]
        for t in self._drains:
            t.start()
        return self

    def _drain_err(self) -> None:
        for line in self.proc.stderr:
            if line.startswith(LISTENING) and self._address is None:
                self._address = line[len(LISTENING):].strip()
                self._listening.set()
            self.err.append(line)

    def bound(self, deadline: float = 120.0) -> str:
        """The host:port a released coordinator bound (it asks for port 0)."""
        t0 = time.time()
        while not self._listening.wait(0.1):
            if self.proc.poll() is not None or time.time() - t0 > deadline:
                raise RuntimeError(f"the coordinator reported no address (rc="
                                   f"{self.proc.poll()}): {self.tail()}")
        return self._address

    def stop(self) -> None:
        """Kill the process if it still runs (a run that failed part way)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def release(self, args: tuple[str, ...] = ()) -> None:
        self.proc.stdin.write(" ".join(args) + "\n")
        self.proc.stdin.flush()
        self.proc.stdin.close()

    def wait(self, timeout: float) -> int:
        rc = self.proc.wait(timeout=timeout)
        for t in self._drains:
            t.join(timeout=30)
        return rc

    def report(self) -> dict | None:
        """The child's KWAGE_CHILD line (peak device memory, launches)."""
        for line in self.err:
            if line.startswith("KWAGE_CHILD "):
                return json.loads(line[len("KWAGE_CHILD "):])
        return None

    def tail(self) -> str:
        return "".join(self.err)[-3000:]


def child_env(extra: dict | None = None) -> dict:
    """This environment, the repository first on PYTHONPATH (so that the
    children import this checkout), and ``extra``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(extra or {})
    return env


def run_queue(coord_args: list[str], worker_args: list[list[str]], env: dict,
              kill_after: float | None = None) -> dict:
    """A coordinator (``coord_args``, without --coordinator: it binds port
    0 of 127.0.0.1) and its workers (without --worker), all held, released
    coordinator first, each worker then with the address the coordinator
    reported; optionally SIGKILL worker 0 ``kill_after`` s after the
    release. Returns the walls, exit codes, the children's reports and
    their stderr tails."""
    children = [Child(a, env) for a in ([*coord_args, "--coordinator", "127.0.0.1:0"],
                                        *worker_args)]
    coord, *workers = children
    try:
        for c in children:
            c.ready()
        t0 = time.time()
        coord.release()
        address = coord.bound()
        for w in workers:
            w.release(("--worker", address))
        if kill_after is not None:
            time.sleep(kill_after)
            workers[0].proc.kill()
        rc_coord = coord.wait(3600)
        rcs = [w.wait(600) for w in workers]
        dt = time.time() - t0
    finally:
        for c in children:
            c.stop()
    return {"dt": dt, "coordinator_rc": rc_coord, "worker_rcs": rcs,
            "reports": [c.report() for c in children], "tails": [c.tail() for c in children]}


def run_single(args: list[str], env: dict) -> dict:
    one = Child(args, env)
    try:
        one.ready()
        t0 = time.time()
        one.release()
        rc = one.wait(3600)
        dt = time.time() - t0
    finally:
        one.stop()
    return {"dt": dt, "rc": rc, "report": one.report(), "tail": one.tail()}


def all_terminal(scratch: str, n: int) -> bool:
    """Every accession of a run's status file is packed into a .db."""
    status, _ = read_status_file(os.path.join(scratch, "status.bin"), n)
    return bool((status == STATUS_DATABASE_SUCCESS).all())


def measure_queue_overhead(work: str, infos, k: int = 300) -> dict:
    """Per-message queue overhead on the real wire protocol: an in-process
    CoordinatorServer over k accessions, a client answering every task at
    once, each message's round trip timed (the JAX tool's, with the
    port's parallel/remote.py)."""
    qdir = os.path.join(work, "qoverhead")
    os.makedirs(qdir, exist_ok=True)
    inv = os.path.join(qdir, "inv.bin")
    write_inventory(inv, infos[:k])
    opt = MaestroOptions(metadata_file=inv, scratch_bloom_dir=os.path.join(qdir, "bloom"),
                         scratch_database_dir=os.path.join(qdir, "db"),
                         status_file=os.path.join(qdir, "status.bin"), s3_no_write=True)
    coord = CoordinatorServer(Maestro(opt, SourceResolver()))
    coord.start()
    addr = coord.address
    param = _param_to_dict(BloomParam(kmer_len=32, log_2_filter_len=18, num_hash=5,
                                      hash_func=0))
    t_next, t_down, t_done, t_db = [], [], [], []
    eid = 0

    def timed(bucket, msg):
        nonlocal eid
        if msg.get("op") != "next":
            msg = dict(msg, eid=f"probe:{eid}")
            eid += 1
        t0 = time.perf_counter()
        r = _send_msg(addr, msg)
        bucket.append(time.perf_counter() - t0)
        return r

    try:
        while True:
            r = timed(t_next, {"op": "next", "worker": "probe", "n": 1})
            op = r.get("op")
            if op == "quit":
                break
            if op == "wait":
                time.sleep(0.02)
            elif op == "bloom":
                idx = r["idx"]
                timed(t_down, {"op": "downloaded", "idx": idx})
                timed(t_done, {"op": "bloom_done", "idx": idx, "status": STATUS_BLOOM_SUCCESS,
                               "param": param, "dt": 0.0, "mem": 0.0, "worker": "probe"})
            elif op == "db":
                timed(t_db, {"op": "db_done", "db_index": r["db_index"],
                             "members": r["members"], "status": STATUS_DATABASE_SUCCESS,
                             "dt": 0.0, "mem": 0.0, "worker": "probe"})
    finally:
        coord.shutdown()

    def ms(xs):
        return statistics.median(xs) * 1e3 if xs else None

    o_next, o_down, o_done = ms(t_next), ms(t_down), ms(t_done)
    db_share = sum(t_db) / k * 1e3 if t_db else 0.0
    o_task_16 = o_next / 16 + o_down + o_done + db_share
    return {"tasks_measured": k, "next_ms": o_next, "downloaded_ms": o_down,
            "bloom_done_ms": o_done, "db_done_ms": ms(t_db), "db_done_amortized_ms": db_share,
            "o_task_ms_batch1": o_next + o_down + o_done + db_share,
            "o_task_ms_batch16": o_task_16, "coord_ceiling_tasks_per_s": 1e3 / o_task_16}


def result_set(text: str) -> set:
    """The JAX tool's comparison key: (query line, hit line) pairs of a
    --o.json output; .db packing order may differ between runs."""
    out, query = set(), None
    for line in text.splitlines():
        ls = line.strip().strip(",")
        if ls.startswith('"query"'):
            query = ls
        elif ls.startswith(('"run_accession"', '"num_kmers_found"')):
            out.add((query, ls))
    return out


def search(scratch: str, qfasta: str, work: str, device: bool = False) -> str:
    """kwage-torch -t 0.8 --o.json over a run's database directory, in this
    process: the host engine, or ``device`` the card."""
    args = ["-d", os.path.join(scratch, "database"), "-t", str(THRESHOLD), "-i", qfasta,
            "--o.json"] + (["--device"] if device else [])
    return kwage_bytes(args, os.path.join(work, "search.out"))


def sampled_blooms(corpus, bloom_dir: str) -> dict:
    """Four sampled .bloom files of a device run against the exact ground
    truth of their reads and against the port's host build."""
    n = len(corpus.accessions)
    sample = sorted({0, 1, n // 2, n - 1})
    opts = BuildOptions(min_kmer_count=MIN_COUNT, min_log_2_filter_len=LEN_MIN,
                        max_log_2_filter_len=LEN_MAX)
    truth, host = [], []
    for i in sample:
        acc = corpus.accessions[i]
        path, fasta = os.path.join(bloom_dir, acc + ".bloom"), os.path.join(corpus.src,
                                                                          acc + ".fasta")
        truth.append(_corpus.bloom_matches_truth(path, fasta, MIN_COUNT, LEN_MIN, LEN_MAX))
        rec, mine = read_bloom_file(path), build_bloom_from_file(fasta, opts)
        host.append(rec.param == mine.param and rec.bits.tobytes() == mine.bits.tobytes())
    return {"sampled": [corpus.accessions[i] for i in sample],
            "equal_ground_truth": all(truth), "equal_host_build": all(host)}


def oracle_same(scratch: str, qfasta: str, want: str) -> dict:
    oracle = _corpus.oracle_binary("kwage")
    if oracle is None:
        return {"oracle": "absent"}
    dargs = []
    for d in find_db_files([os.path.join(scratch, "database")]):
        dargs += ["-d", d]
    o = subprocess.run([oracle, *dargs, "-t", str(THRESHOLD), "-i", qfasta, "--o.json"],
                       capture_output=True, text=True)
    return {"byte_identical_to_oracle": o.returncode == 0 and o.stdout == want}


def fail_children(log: PhaseLog, what: str, tails: list[str]) -> int:
    for tail in tails:
        if tail:
            print(f"--- {what}: a child's stderr ---\n{tail}", file=sys.stderr)
    log.log("done", ok=False, failed=what)
    return 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?", help="work here and keep it")
    ap.add_argument("--out", help="the phase lines as one JSON list (default "
                                  "WORKDIR/distributed.json)")
    args = ap.parse_args(argv)
    device = bench_device()
    card = card_identity() if device.type == "cuda" else "CPU (not a device figure)"
    log = PhaseLog(device, {"card": card})
    work = args.workdir or tempfile.mkdtemp(prefix="kwage_dscale_")
    os.makedirs(work, exist_ok=True)
    try:
        rc = run(log, device, work)
        log.save(args.out or os.path.join(work, "distributed.json"))
        return rc
    finally:
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)


def run(log: PhaseLog, device, work: str) -> int:
    """Every phase in ``work``; the program's exit code."""
    t0 = time.time()
    if device.type == "cuda":
        kernels.build()      # once, before any child: each would build it alone
    native_available()
    corpus = _corpus.generate_dscale(work, N_ACC, GENOME, COV)
    qf = os.path.join(work, "q.fasta")
    _corpus.write_queries(qf, corpus.queries)
    log.log("generate", accessions=N_ACC, device=str(device), dt_sec=time.time() - t0)
    env = child_env()

    def maestro_args(scratch: str, extra: list[str], inv: str = corpus.inv,
                     source: list[str] | None = None) -> list[str]:
        return ["--meta", inv, "--scratch", scratch,
                "--status", os.path.join(scratch, "status.bin"),
                *(source or ["--source-dir", corpus.src]), "--s3.no-write",
                "--min-kmer-count", str(MIN_COUNT), "--len.min", str(LEN_MIN),
                "--len.max", str(LEN_MAX), *extra]

    dscratch = os.path.join(work, "dist")
    keep = [*DEVICE_FLAGS, "--save.bloom"]   # whoever packs a .db keeps its .bloom files
    dist = run_queue(maestro_args(dscratch, keep),
                     [maestro_args(dscratch, keep) for _ in range(N_WORKERS)], env)
    ok = dist["coordinator_rc"] == 0 and not any(dist["worker_rcs"])
    terminal = ok and all_terminal(dscratch, N_ACC)
    log.log("distributed_run", workers=N_WORKERS, coordinator_rc=dist["coordinator_rc"],
            worker_rcs=dist["worker_rcs"], dt_sec=dist["dt"], filters_per_sec=N_ACC / dist["dt"],
            every_accession_terminal=terminal, host_cores=os.cpu_count(),
            processes_on_device=1 + N_WORKERS if device.type == "cuda" else 0,
            children=dist["reports"])
    if not terminal:
        return fail_children(log, "distributed_run", dist["tails"])

    sscratch = os.path.join(work, "single")
    single = run_single(maestro_args(sscratch, DEVICE_FLAGS), env)
    terminal = single["rc"] == 0 and all_terminal(sscratch, N_ACC)
    log.log("single_run", rc=single["rc"], dt_sec=single["dt"],
            filters_per_sec=N_ACC / single["dt"], every_accession_terminal=terminal,
            children=[single["report"]])
    if not terminal:
        return fail_children(log, "single_run", [single["tail"]])

    oh = measure_queue_overhead(work, corpus.infos)
    log.log("queue_overhead", **oh)
    t_task_ms = single["dt"] / N_ACC * 1e3
    o_ms = oh["o_task_ms_batch16"]
    log.log("crossover_check", regime=f"device build, {os.cpu_count()} host cores",
            t_task_ms=t_task_ms, o_task_ms=o_ms,
            predicted_slowdown=(t_task_ms + o_ms) / t_task_ms,
            observed_slowdown=dist["dt"] / single["dt"],
            crossover_task_ms_for_2_workers=o_ms / (2 - 1),
            crossover_task_ms_for_8_workers=o_ms / (8 - 1))

    want = search(sscratch, qf, work)
    cscratch = None
    if not SKIP_CRASH:
        cscratch = os.path.join(work, "crash")
        crash = run_queue(
            maestro_args(cscratch, [*DEVICE_FLAGS, "--task-timeout", "5"]),
            [maestro_args(cscratch, DEVICE_FLAGS) for _ in range(2)], env,
            kill_after=max(0.5, dist["dt"] / 4))
        terminal = crash["coordinator_rc"] == 0 and all_terminal(cscratch, N_ACC)
        equal = terminal and result_set(search(cscratch, qf, work)) == result_set(want)
        log.log("crash_recovery", coordinator_rc=crash["coordinator_rc"],
                survivor_rc=crash["worker_rcs"][1], killed_rc=crash["worker_rcs"][0],
                dt_sec=crash["dt"], every_accession_terminal=terminal,
                result_set_equals_single=equal, children=crash["reports"])
        if not equal:
            return fail_children(log, "crash_recovery", crash["tails"])

    lat_ratio = None
    if not SKIP_LATENCY:
        lat_ratio = latency_regime(log, work, corpus, maestro_args)
        if lat_ratio is None:
            return 1

    blooms = sampled_blooms(corpus, os.path.join(dscratch, "bloom"))
    log.log("blooms", min_count=MIN_COUNT, **blooms)

    a = search(dscratch, qf, work)
    identical = result_set(a) == result_set(want)
    dev_same = search(dscratch, qf, work, device=True) == a
    oracle = oracle_same(dscratch, qf, a)
    log.log("search_parity", distributed_equals_single=identical,
            crash_equals_single=None if cscratch is None else True,
            any_hits="num_kmers_found" in a, device_byte_identical_to_host=dev_same, **oracle)
    ok = (identical and "num_kmers_found" in a and dev_same and blooms["equal_ground_truth"]
          and blooms["equal_host_build"] and oracle.get("byte_identical_to_oracle") is not False)
    if lat_ratio is not None:
        ok = ok and lat_ratio >= 1.3
    log.log("done", ok=ok, latency_speedup=lat_ratio,
            cut=[name for name, skip in (("crash", SKIP_CRASH), ("latency", SKIP_LATENCY))
                 if skip])
    return 0 if ok else 1


def latency_regime(log: PhaseLog, work: str, corpus, maestro_args) -> float | None:
    """The download-bound regime: a fake fasterq-dump that sleeps, then one
    process against a --workers 1 coordinator and LAT_WORKERS workers, all
    building on the host. Returns the speedup, or None when a run failed."""
    lat_inv = os.path.join(work, "inventory_lat.bin")
    write_inventory(lat_inv, corpus.infos[:LAT_N])
    bindir = os.path.join(work, "bin")
    os.makedirs(bindir, exist_ok=True)
    tool = os.path.join(bindir, "fasterq-dump")
    with open(tool, "w") as f:
        f.write("#!/bin/sh\n"
                f"sleep {LAT_DELAY}\n"
                "for last; do :; done\n"
                f'cat "{corpus.src}/$last.fasta"\n')
    os.chmod(tool, 0o755)
    env = child_env({"PATH": bindir + os.pathsep + os.environ["PATH"], "KWAGE_NO_VDB": "1",
                     "KWAGE_WORKER_PULL": "4"})
    stream = ["--stream"]
    single = run_single(maestro_args(os.path.join(work, "lat_single"), [], lat_inv, stream), env)
    log.log("latency_single_run", rc=single["rc"], dt_sec=single["dt"], sim_delay=LAT_DELAY,
            accessions=LAT_N, filters_per_sec=LAT_N / single["dt"])
    if single["rc"] != 0:
        fail_children(log, "latency_single_run", [single["tail"]])
        return None
    lscratch = os.path.join(work, "lat_dist")
    dist = run_queue(
        maestro_args(lscratch, ["--workers", "1"], lat_inv, stream),
        [maestro_args(lscratch, [], lat_inv, stream) for _ in range(LAT_WORKERS)], env)
    ratio = single["dt"] / dist["dt"]
    log.log("latency_distributed_run", workers=LAT_WORKERS,
            coordinator_rc=dist["coordinator_rc"], worker_rcs=dist["worker_rcs"],
            dt_sec=dist["dt"], filters_per_sec=LAT_N / dist["dt"], speedup_vs_single=ratio)
    if dist["coordinator_rc"] != 0 or any(dist["worker_rcs"]):
        fail_children(log, "latency_distributed_run", dist["tails"])
        return None
    return ratio


if __name__ == "__main__":
    sys.exit(main())

"""The port's cross-host maestro (kwage_tpu_torch.parallel.remote, a whole
copy of kwage_tpu's): the cases of tests/test_remote.py against the port,
on the CPU (KWAGE_TORCH_DEVICE=cpu: the device build and transpose run
their kernels' plain versions). Real sockets on localhost; worker loops
run in threads to emulate the per-host processes, and the CLI's worker in a
process of its own."""

import hashlib
import json
import threading
import time

import pytest
import torch

from kwage_tpu_torch.core import FilterInfo, str_to_accession
from kwage_tpu_torch.io.inventory import write_inventory
from kwage_tpu_torch.parallel.maestro import (
    LocalFastaResolver,
    Maestro,
    MaestroOptions,
    STATUS_DATABASE_SUCCESS,
    STATUS_DOWNLOAD_FAIL,
)
from kwage_tpu_torch.parallel.remote import (
    CoordinatorServer,
    RemoteWorker,
    run_distributed_maestro,
)


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """The plain versions, on two torch threads: the suite runs beside
    other test processes on the same cores."""
    monkeypatch.setenv("KWAGE_TORCH_DEVICE", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def manifest(golden_dir):
    with open(golden_dir / "e2e" / "manifest.json") as f:
        return json.load(f)


def _options(manifest, work, **kw):
    opt = MaestroOptions(
        metadata_file=str(work / "inventory.bin"),
        scratch_bloom_dir=str(work / "bloom"),
        scratch_database_dir=str(work / "db"),
        status_file=str(work / "status.bin"),
        kmer_len=manifest["k"],
        min_kmer_count=manifest["min_kmer_count"],
        false_positive_probability=manifest["fp"],
        min_log_2_filter_len=manifest["minL"],
        max_log_2_filter_len=manifest["maxL"],
        min_log_2_count_len=manifest["minLc"],
        max_log_2_count_len=manifest["maxLc"],
        save_bloom=True,
    )
    for k, v in kw.items():
        setattr(opt, k, v)
    return opt


def _sha(p):
    with open(p, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_distributed_run_produces_reference_databases(
    manifest, data_dir, golden_dir, tmp_path
):
    """Coordinator + 2 pull workers reproduce the golden .db files
    byte-for-byte (same grouping and ordering as the local scheduler)."""
    infos = [FilterInfo(run_accession=str_to_accession(a))
             for a in manifest["accessions"]]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    opt = _options(manifest, tmp_path)
    m = run_distributed_maestro(
        opt, LocalFastaResolver(str(data_dir)), num_local_workers=2,
        host="127.0.0.1",
    )
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()
    with open(golden_dir / "e2e" / "digests.json") as f:
        digests = json.load(f)
    for gi in range(len(manifest["db_groups"])):
        got = _sha(tmp_path / "db" / f"sra.{gi + 1}.db")
        assert got == digests[f"sra.{gi}.db"], f"group {gi} differs"


def test_dynamic_balance_slow_accession(manifest, data_dir, tmp_path):
    """A worker stuck on a slow accession does not idle the fleet: the
    other worker pulls every remaining task meanwhile (the reference's
    whichever-rank-frees-up scheduling, maestro_main.cpp:339-457)."""

    class SlowResolver(LocalFastaResolver):
        def resolve(self, accession):
            if accession == slow_acc:
                time.sleep(2.5)
            return super().resolve(accession)

    accs = manifest["accessions"]
    slow_acc = accs[0]
    infos = [FilterInfo(run_accession=str_to_accession(a)) for a in accs]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    opt = _options(manifest, tmp_path)

    m = Maestro(opt, SlowResolver(str(data_dir)))
    m.restore()
    coord = CoordinatorServer(m, host="127.0.0.1")
    coord.start()
    counts = {}
    threads = []
    for name in ("w0", "w1"):
        worker = RemoteWorker(opt, SlowResolver(str(data_dir)), coord.address,
                              name=name)

        def run(w=worker, n=name):
            counts[n] = w.run()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        threads.append(t)
    coord.wait()
    for t in threads:
        t.join(timeout=30)
    coord.shutdown()

    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()
    # One worker absorbed the 2.5 s accession; the other must have done
    # the bulk of the remaining work in that window.
    assert max(counts.values()) > min(counts.values()), counts


def test_distributed_failures_and_completion(manifest, data_dir, tmp_path):
    """Missing accessions fail through the same bounded retry machine and
    the coordinator still quits cleanly."""
    accs = manifest["accessions"][:2] + ["SRR9999999"]
    infos = [FilterInfo(run_accession=str_to_accession(a)) for a in accs]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    opt = _options(manifest, tmp_path, num_download_attempt=2)
    m = run_distributed_maestro(
        opt, LocalFastaResolver(str(data_dir)), num_local_workers=2,
        host="127.0.0.1",
    )
    assert int(m.status[2]) == STATUS_DOWNLOAD_FAIL
    assert int(m.status[0]) == STATUS_DATABASE_SUCCESS
    assert int(m.status[1]) == STATUS_DATABASE_SUCCESS


@pytest.mark.parametrize("device_transpose", [False, True])
def test_distributed_device_build_batch_pull(manifest, data_dir, golden_dir, tmp_path,
                                             device_transpose):
    """A device-building remote worker pulls a whole batch per request and
    builds it in fused dispatches (and, with device_transpose, packs each
    .db on the device); golden byte parity holds."""
    infos = [FilterInfo(run_accession=str_to_accession(a))
             for a in manifest["accessions"]]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    opt = _options(manifest, tmp_path, device_build=True, device_batch=4,
                   device_transpose=device_transpose)
    m = run_distributed_maestro(
        opt, LocalFastaResolver(str(data_dir)), num_local_workers=1,
        host="127.0.0.1",
    )
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()
    with open(golden_dir / "e2e" / "digests.json") as f:
        digests = json.load(f)
    for gi in range(len(manifest["db_groups"])):
        got = _sha(tmp_path / "db" / f"sra.{gi + 1}.db")
        assert got == digests[f"sra.{gi}.db"], f"group {gi} differs"


@pytest.mark.parametrize("device", [[], ["--device-build", "--device-transpose"]],
                         ids=["host", "device"])
def test_cli_coordinator_and_subprocess_worker(manifest, data_dir, tmp_path, device,
                                              monkeypatch):
    """The maestro CLI really wires --coordinator/--worker: a coordinator
    (with one local worker) plus a separate WORKER PROCESS driven through
    the CLI converge to all-terminal, on the host builder and with the
    device flags. The coordinator binds port 0; the worker process, up
    before it, is handed the address it bound."""
    import os
    import queue
    import subprocess
    import sys
    import threading

    from kwage_tpu_torch.parallel import remote

    accs = manifest["accessions"][:6]
    infos = [FilterInfo(run_accession=str_to_accession(a)) for a in accs]
    write_inventory(str(tmp_path / "inventory.bin"), infos)

    bound, start = queue.Queue(), remote.CoordinatorServer.start
    monkeypatch.setattr(remote.CoordinatorServer, "start",
                        lambda self: (start(self), bound.put(self.address))[0])

    common = [
        "--meta", str(tmp_path / "inventory.bin"),
        "--scratch.bloom", str(tmp_path / "bloom"),
        "--scratch.database", str(tmp_path / "db"),
        "--status", str(tmp_path / "status.bin"),
        "--source-dir", str(data_dir),
        "--min-kmer-count", str(manifest["min_kmer_count"]),
        "-k", str(manifest["k"]),
        "-p", str(manifest["fp"]),
        "--len.min", str(manifest["minL"]),
        "--len.max", str(manifest["maxL"]),
        "--count-len.min", str(manifest["minLc"]),
        "--count-len.max", str(manifest["maxLc"]),
        "--save.bloom", *device,
    ]
    env = dict(os.environ, KWAGE_TORCH_DEVICE="cpu", OMP_NUM_THREADS="2")
    # The worker CLI, its imports done, waits for the coordinator's address.
    held = ("import sys\n"
            "from kwage_tpu_torch.cli.maestro import main\n"
            "sys.exit(main(sys.argv[1:] + ['--worker', sys.stdin.readline().strip()]))\n")
    worker = subprocess.Popen([sys.executable, "-c", held, *common], env=env,
                              stdin=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        from kwage_tpu_torch.cli.maestro import main as maestro_main

        rcs = []
        coord = threading.Thread(target=lambda: rcs.append(maestro_main(
            [*common, "--workers", "1", "--coordinator", "127.0.0.1:0"])))
        coord.start()
        host, port = bound.get(timeout=120)
        worker.stdin.write(f"{host}:{port}\n")
        worker.stdin.close()
        coord.join(timeout=600)
        assert not coord.is_alive() and rcs == [0]
        assert worker.wait(timeout=60) == 0, worker.stderr.read()
    finally:
        if worker.poll() is None:
            worker.kill()

    from kwage_tpu_torch.io.status import read_status_file

    status, _ = read_status_file(str(tmp_path / "status.bin"), len(accs))
    assert (status == STATUS_DATABASE_SUCCESS).all(), status


def test_cli_device_worker_without_a_card_exits_nonzero(manifest, data_dir, tmp_path):
    """``--worker`` with ``--device-build`` and no card (KWAGE_TORCH_DEVICE
    unset: the default is cuda) raises before it pulls a task: no CPU
    fallback, a non-zero exit, and no coordinator is needed to show it."""
    import os
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    write_inventory(str(tmp_path / "inventory.bin"),
                    [FilterInfo(run_accession=str_to_accession(manifest["accessions"][0]))])
    env = {k: v for k, v in os.environ.items() if k != "KWAGE_TORCH_DEVICE"}
    res = subprocess.run(
        [sys.executable, "-m", "kwage_tpu_torch.cli.maestro",
         "--meta", str(tmp_path / "inventory.bin"), "--scratch", str(tmp_path),
         "--source-dir", str(data_dir), "--device-build", "--worker", "127.0.0.1:9"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr, res.stderr[-2000:]
    assert "unreachable" not in res.stderr and "Worker finished" not in res.stderr


def test_blackholed_coordinator_buffered_events_converge(
    manifest, data_dir, tmp_path, monkeypatch
):
    """A coordinator blackholed for a window mid-run: workers buffer their
    completion events and retry/reconnect; the job still converges with no
    stalled tasks and no double-applied events."""
    import kwage_tpu_torch.parallel.remote as remote_mod

    accs = manifest["accessions"]
    infos = [FilterInfo(run_accession=str_to_accession(a)) for a in accs]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    opt = _options(manifest, tmp_path)

    real_send = remote_mod._send_msg
    blackhole_until = time.time() + 1.2

    def flaky_send(address, msg, timeout=30.0):
        # Completion/interim events bounce during the outage window; task
        # pulls keep working (the ADVICE failure mode: delivery, not pull).
        if msg.get("op") != "next" and time.time() < blackhole_until:
            raise OSError("blackholed")
        return real_send(address, msg, timeout)

    monkeypatch.setattr(remote_mod, "_send_msg", flaky_send)

    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    coord = CoordinatorServer(m, host="127.0.0.1")
    coord.start()
    threads = []
    try:
        for name in ("w0", "w1"):
            worker = RemoteWorker(opt, LocalFastaResolver(str(data_dir)),
                                  coord.address, name=name)
            t = threading.Thread(target=worker.run, daemon=True)
            t.start()
            threads.append(t)
        coord.wait()
        for t in threads:
            t.join(timeout=30)
    finally:
        coord.shutdown()
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()


def test_lost_reply_replay_is_deduped(manifest, data_dir, tmp_path, monkeypatch):
    """An event whose send was PROCESSED but whose reply line was lost is
    resent by the worker and dropped by the coordinator's eid dedupe:
    throughput counters apply exactly once."""
    import kwage_tpu_torch.parallel.remote as remote_mod

    accs = manifest["accessions"][:3]
    infos = [FilterInfo(run_accession=str_to_accession(a),
                        number_of_bases=1000)
             for a in accs]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    opt = _options(manifest, tmp_path)

    real_send = remote_mod._send_msg
    dropped = {"n": 0}

    def lossy_send(address, msg, timeout=30.0):
        reply = real_send(address, msg, timeout)
        if msg.get("op") == "bloom_done" and dropped["n"] < 2 \
                and not reply.get("dup"):
            # Delivered and applied -- but the reply vanishes.
            dropped["n"] += 1
            raise OSError("reply lost")
        return reply

    monkeypatch.setattr(remote_mod, "_send_msg", lossy_send)

    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    coord = CoordinatorServer(m, host="127.0.0.1")
    coord.start()
    try:
        worker = RemoteWorker(opt, LocalFastaResolver(str(data_dir)),
                              coord.address, name="w0")
        t = threading.Thread(target=worker.run, daemon=True)
        t.start()
        coord.wait()
        t.join(timeout=30)
    finally:
        coord.shutdown()
    assert dropped["n"] == 2
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()
    # Each accession's number_of_bases counted exactly once despite the
    # replayed bloom_done events.
    assert m._total_bp == 1000 * len(accs), m._total_bp


def test_task_timeout_requeues_abandoned_task(manifest, data_dir, tmp_path):
    """--task-timeout: a worker that takes a task and vanishes without
    reporting gets its pre-marked task re-queued and finished by a live
    worker (engine extension over the reference's stall-until-restart)."""
    import json as _json
    import socket

    from kwage_tpu_torch.parallel.remote import _send_msg

    accs = manifest["accessions"][:4]
    infos = [FilterInfo(run_accession=str_to_accession(a)) for a in accs]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    opt = _options(manifest, tmp_path)

    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    coord = CoordinatorServer(m, host="127.0.0.1", task_timeout=1.0)
    coord.start()
    try:
        # A "worker" that pulls one bloom task and dies silently.
        task = _send_msg(coord.address, {"op": "next", "worker": "ghost"})
        assert task["op"] == "bloom", task
        abandoned = task["idx"]
        time.sleep(1.2)  # exceed the timeout

        worker = RemoteWorker(opt, LocalFastaResolver(str(data_dir)),
                              coord.address, name="live")
        t = threading.Thread(target=worker.run, daemon=True)
        t.start()
        coord.wait()
        t.join(timeout=30)
    finally:
        coord.shutdown()
    assert int(m.status[abandoned]) == STATUS_DATABASE_SUCCESS, m.summary()
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()


def test_worker_eids_unique_across_restarts(manifest, tmp_path):
    """The CLI default worker name is the hostname, and the event counter
    starts at 0 -- a RESTARTED worker (same name, fresh process) must not
    have its first K events deduped as replays of the dead process's
    deliveries. eids carry a per-process salt."""
    infos = [FilterInfo(run_accession=str_to_accession("SRR000001"))]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    opt = _options(manifest, tmp_path)

    w1 = RemoteWorker(opt, None, ("127.0.0.1", 1), name="samehost")
    w2 = RemoteWorker(opt, None, ("127.0.0.1", 1), name="samehost")
    w1._queue_event({"op": "bloom_done", "idx": 0})
    w2._queue_event({"op": "bloom_done", "idx": 0})
    assert w1._pending[0]["eid"] != w2._pending[0]["eid"]


def test_failed_apply_does_not_poison_eid(manifest, data_dir, tmp_path, monkeypatch):
    """An event whose APPLY raises must stay un-seen: the worker's retry
    of the same eid has to apply, not be answered as a duplicate (the
    eid is recorded only after a clean apply)."""
    from kwage_tpu_torch.parallel.maestro import STATUS_BLOOM_INVALID

    accs = manifest["accessions"][:2]
    infos = [FilterInfo(run_accession=str_to_accession(a)) for a in accs]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    opt = _options(manifest, tmp_path)

    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    coord = CoordinatorServer(m, host="127.0.0.1")
    try:
        calls = {"n": 0}
        real = m._absorb_bloom_event

        def flaky(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient apply failure")
            return real(*a, **kw)

        monkeypatch.setattr(m, "_absorb_bloom_event", flaky)
        msg = {"op": "bloom_done", "idx": 0,
               "status": int(STATUS_BLOOM_INVALID), "eid": "w:salt:0"}
        with pytest.raises(RuntimeError):
            coord._handle(dict(msg))
        reply = coord._handle(dict(msg))  # the worker's retry, same eid
        assert not reply.get("dup")
        assert calls["n"] == 2
        assert int(m.status[0]) == STATUS_BLOOM_INVALID
        # A third resend IS now a replay.
        assert coord._handle(dict(msg)).get("dup")
        assert calls["n"] == 2
    finally:
        coord._server.server_close()


def test_queue_shared_secret(manifest, data_dir, tmp_path, monkeypatch):
    """KWAGE_QUEUE_SECRET: matching tokens converge normally; a missing or
    wrong token is refused with op=denied / QueueAuthError."""
    from kwage_tpu_torch.parallel.remote import (
        QueueAuthError,
        _send_msg,
    )

    monkeypatch.setenv("KWAGE_QUEUE_SECRET", "s3kr1t")
    infos = [FilterInfo(run_accession=str_to_accession(a))
             for a in manifest["accessions"]]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    opt = _options(manifest, tmp_path)

    # Probe phase: a coordinator with the secret refuses unauthenticated
    # and wrong-token messages (and the worker surfaces the config error
    # instead of retry-spinning).
    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    coord = CoordinatorServer(m, host="127.0.0.1")
    coord.start()
    try:
        assert _send_msg(coord.address, {"op": "next", "worker": "x", "n": 1})[
            "op"] == "denied"
        assert _send_msg(
            coord.address,
            {"op": "next", "worker": "x", "n": 1, "token": "wrong"},
        )["op"] == "denied"
        bad = RemoteWorker(opt, LocalFastaResolver(str(data_dir)),
                           coord.address, name="bad", secret="wrong")
        with pytest.raises(QueueAuthError):
            bad._send({"op": "next", "worker": "bad", "n": 1})
        ok = _send_msg(
            coord.address,
            {"op": "next", "worker": "x", "n": 1, "token": "s3kr1t"},
        )
        assert ok["op"] in ("bloom", "bloom_batch", "db", "wait")
    finally:
        coord.shutdown()

    # Full distributed run with the env secret on both sides.
    m2 = run_distributed_maestro(
        opt, LocalFastaResolver(str(data_dir)), num_local_workers=2,
        host="127.0.0.1",
    )
    assert all(s == STATUS_DATABASE_SUCCESS for s in m2.status), m2.summary()


def test_sliced_coordinator_interleaves_db_indices(manifest, data_dir, tmp_path):
    """--slice/--of combined with --coordinator keeps the collision-free
    stride-N sra.<index>.db numbering (shard s uses s+1, s+1+N, ...)."""
    infos = [FilterInfo(run_accession=str_to_accession(a))
             for a in manifest["accessions"]]
    db_names = []
    for s in range(2):
        w = tmp_path / f"s{s}"
        w.mkdir()
        write_inventory(str(w / "inventory.bin"), infos)
        opt = _options(manifest, w, slice_index=s, num_slice=2)
        m = run_distributed_maestro(
            opt, LocalFastaResolver(str(data_dir)), num_local_workers=1,
            host="127.0.0.1",
        )
        lo, hi = (0, 5) if s == 0 else (5, 10)
        assert all(st == STATUS_DATABASE_SUCCESS for st in m.status[lo:hi])
        names = sorted((w / "db").glob("*.db"))
        assert names, "shard built no databases"
        for p in names:
            assert int(p.name.split(".")[1]) % 2 == (s + 1) % 2, p.name
        db_names.append({p.name for p in names})
    assert not (db_names[0] & db_names[1])


def test_empty_reply_is_retried(manifest, data_dir, tmp_path, monkeypatch):
    """A connection that closes WITHOUT a reply line (handler crash /
    coordinator death mid-request) must count as UNDELIVERED: the event
    stays buffered and is resent, with the eid dedupe absorbing the case
    where it had actually been applied."""
    import kwage_tpu_torch.parallel.remote as remote_mod

    accs = manifest["accessions"][:3]
    infos = [FilterInfo(run_accession=str_to_accession(a),
                        number_of_bases=1000)
             for a in accs]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    opt = _options(manifest, tmp_path)

    real_send = remote_mod._send_msg
    swallowed = {"n": 0}

    def eof_send(address, msg, timeout=30.0):
        reply = real_send(address, msg, timeout)
        if msg.get("op") == "bloom_done" and swallowed["n"] < 2 \
                and not reply.get("dup"):
            # Applied by the coordinator, but the socket closed with no
            # reply line -- _send_msg returns {} in that case.
            swallowed["n"] += 1
            return {}
        return reply

    monkeypatch.setattr(remote_mod, "_send_msg", eof_send)

    m = Maestro(opt, LocalFastaResolver(str(data_dir)))
    m.restore()
    coord = CoordinatorServer(m, host="127.0.0.1")
    coord.start()
    try:
        worker = RemoteWorker(opt, LocalFastaResolver(str(data_dir)),
                              coord.address, name="w0")
        t = threading.Thread(target=worker.run, daemon=True)
        t.start()
        coord.wait()
        t.join(timeout=30)
    finally:
        coord.shutdown()
    assert swallowed["n"] == 2
    assert all(s == STATUS_DATABASE_SUCCESS for s in m.status), m.summary()
    assert m._total_bp == 1000 * len(accs), m._total_bp


@pytest.mark.parametrize("late_after", ["bloom_done", "db_done"])
def test_late_downloaded_of_a_twice_dispatched_task_is_ignored(
        manifest, tmp_path, late_after):
    """--task-timeout re-queues a slow-but-alive worker's task, so two
    workers run it. The first copy's filter is absorbed (and, once the
    coordinator is idle, packed); the second copy's "downloaded" event
    arrives after that and must leave the status as it is: a status set
    back to DOWNLOAD_SUCCESS is terminal for no one, and the coordinator
    would quit with the accession unpacked on record."""
    from kwage_tpu_torch.parallel.maestro import STATUS_BLOOM_SUCCESS

    infos = [FilterInfo(run_accession=str_to_accession(manifest["accessions"][0]))]
    write_inventory(str(tmp_path / "inventory.bin"), infos)
    m = Maestro(_options(manifest, tmp_path), None)
    m.restore()
    coord = CoordinatorServer(m, host="127.0.0.1", task_timeout=0.0)
    param = {"kmer_len": manifest["k"], "log_2_filter_len": manifest["minL"],
             "num_hash": 1, "hash_func": 0}
    try:
        m._end = m._compute_end()
        first = coord._handle({"op": "next", "worker": "slow", "n": 1})
        assert first["op"] == "bloom", first
        time.sleep(0.01)     # past the timeout: the next pull re-queues it
        second = coord._handle({"op": "next", "worker": "fast", "n": 1})
        assert second["op"] == "bloom" and second["idx"] == first["idx"], second
        idx = first["idx"]
        coord._handle({"op": "downloaded", "idx": idx, "eid": "slow:0"})
        coord._handle({"op": "bloom_done", "idx": idx, "status": STATUS_BLOOM_SUCCESS,
                       "param": param, "eid": "slow:1"})
        want = STATUS_BLOOM_SUCCESS
        if late_after == "db_done":
            db = coord._handle({"op": "next", "worker": "slow", "n": 1})
            assert db["op"] == "db" and db["members"] == [idx], db
            coord._handle({"op": "db_done", "db_index": db["db_index"], "members": [idx],
                           "status": STATUS_DATABASE_SUCCESS, "eid": "slow:2"})
            want = STATUS_DATABASE_SUCCESS
        coord._handle({"op": "downloaded", "idx": idx, "eid": "fast:0"})
        assert int(m.status[idx]) == want
        coord._handle({"op": "bloom_done", "idx": idx, "status": STATUS_BLOOM_SUCCESS,
                       "param": param, "eid": "fast:1"})
        assert int(m.status[idx]) == want
    finally:
        coord._server.server_close()

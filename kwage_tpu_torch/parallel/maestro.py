"""Maestro with the device ingest and pack of the port (PyTorch + CUDA
counterpart of the device-reaching parts of kwage_tpu/parallel/maestro.py).

The scheduler itself -- status bytes, retry queues, per-shape quotas,
checkpoints, restart rescans -- is ``kwage_tpu.parallel.maestro.Maestro``,
which imports no jax; ``Maestro`` here subclasses it. The module-level
worker functions of the JAX module call ``kwage_tpu.pipeline`` directly,
so the ones that reach the device are carried over beside the subclass,
calling ``kwage_tpu_torch.pipeline.make_bloom`` instead:
``_build_bloom_streamed``, ``execute_bloom_task``, ``prepare_bloom_batch``,
``finish_bloom_batch``, ``execute_bloom_batch`` and ``_DeviceDispatcher``.
The subclass overrides the methods that call them, and packs ``.db``
files with ``kwage_tpu_torch.pipeline.build_db`` (``--device-transpose``
on the bit_transpose kernel). Nothing of ``kwage_tpu`` is patched.

Each carried-over function and method is its JAX original statement for
statement; only imports, annotations and docstrings differ, and
``tests/test_torch_maestro.py`` holds every copy to that.
"""

from __future__ import annotations

import os
import subprocess
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from itertools import chain

from kwage_tpu.core.info import FilterInfo
from kwage_tpu.core.params import BloomParam
from kwage_tpu.io.bloom_file import write_bloom_file
from kwage_tpu.parallel import maestro as _base
from kwage_tpu.parallel.maestro import (
    STATUS_BLOOM_FAIL_1,
    STATUS_BLOOM_FAIL_10,
    STATUS_BLOOM_INVALID,
    STATUS_BLOOM_SUCCESS,
    STATUS_DATABASE_FAIL,
    STATUS_DATABASE_SUCCESS,
    STATUS_DATABASE_UPLOAD_FAIL,
    STATUS_DOWNLOAD_FAIL,
    STATUS_DOWNLOAD_SUCCESS,
    STATUS_BLOOM_FAIL,
    STATUS_NAMES,
    BloomBatchWork,
    SourceResolver,
    _colorspace_retry_signature,
    _open_sra_bloom_stream,
    _stream_batch_buffer_bp,
    _take_until_bp,
)
from kwage_tpu.pipeline.make_bloom import BloomInvalid, build_bloom_from_file, build_bloom_from_sequences
from kwage_tpu.utils.mem_usage import memory_usage

from ..pipeline.build_db import build_db_from_bloom_files
from ..pipeline.make_bloom import (
    build_bloom_device,
    complete_device_batch,
    dispatch_device_batch,
    finish_device_batch,
    prepare_device_batch,
    scatter_device_batch,
)


def _build_bloom_streamed(open_stream_fn, opt, info: FilterInfo,
                          bloom_out_path: str) -> tuple[int, BloomParam | None]:
    """Build + write one filter off a bloom-order stream, classifying the
    outcome, with the aligned-colorspace forced-unaligned retry
    (worker_main.cpp:301-310). ``open_stream_fn(force_unaligned)``
    returns a BloomStream."""
    from kwage_tpu.sriracha.sra_source import DownloadError

    stream = open_stream_fn(False)
    for attempt in range(2):
        try:
            if opt.device_build:
                rec = build_bloom_device(stream, opt.build_options(), info)
            else:
                rec = build_bloom_from_sequences(
                    stream, opt.build_options(), info,
                    num_bp_hint=info.number_of_bases or None)
            write_bloom_file(bloom_out_path, rec)
            return STATUS_BLOOM_SUCCESS, rec.param
        except BloomInvalid:
            return STATUS_BLOOM_INVALID, None
        except Exception as e:  # noqa: BLE001 -- classified below
            if attempt == 0 and _colorspace_retry_signature(getattr(stream, "progress", None)):
                stream = open_stream_fn(True)
                continue
            if isinstance(e, DownloadError):
                return STATUS_DOWNLOAD_FAIL, None
            return STATUS_BLOOM_FAIL, None
    raise AssertionError("unreachable")  # pragma: no cover


def execute_bloom_task(acc: str, info: FilterInfo, phase: str, resolver: SourceResolver,
                       opt, bloom_out_path: str,
                       on_downloaded=None) -> tuple[int, BloomParam | None]:
    """The worker-side Bloom task (worker_main.cpp:245-474): stage the
    source, build one filter, write the .bloom, classify the outcome.
    Phase "full" may download (or stream with --stream); phase "bloom"
    only looks up an already-staged source."""
    if phase == "full" and opt.stream_sra:
        stream = resolver.open_bloom_stream(acc)
        if stream is not None:
            first = [stream]

            def open_fn(forced: bool):
                if not forced and first:
                    return first.pop()
                return resolver.open_bloom_stream(acc, force_unaligned=forced)

            return _build_bloom_streamed(open_fn, opt, info, bloom_out_path)

    path = resolver.lookup(acc) if phase == "bloom" else resolver.resolve(acc)
    if path is None:
        return STATUS_DOWNLOAD_FAIL, None
    if not opt.stream_sra and on_downloaded is not None:
        on_downloaded()
    if path.endswith(".sra"):
        # A staged .sra goes through the VDB bloom stream, in the
        # reference's alignments-first ingest order (make_bloom.cpp:170-300).
        stream = _open_sra_bloom_stream(path)
        if stream is not None:
            first = [stream]

            def open_sra(forced: bool):
                if not forced and first:
                    return first.pop()
                return _open_sra_bloom_stream(path, force_unaligned=forced)

            status, param = _build_bloom_streamed(open_sra, opt, info, bloom_out_path)
            if not opt.save_sra:
                resolver.cleanup(acc, path)
            return status, param
    try:
        if opt.device_build:
            from kwage_tpu.io.sequence import iter_sequences

            rec = build_bloom_device((s for _, s in iter_sequences(path)),
                                     opt.build_options(), info)
        else:
            rec = build_bloom_from_file(path, opt.build_options(), info)
        write_bloom_file(bloom_out_path, rec)
        status: int = STATUS_BLOOM_SUCCESS
        param = rec.param
    except BloomInvalid:
        status, param = STATUS_BLOOM_INVALID, None
    except Exception:  # noqa: BLE001
        status, param = STATUS_BLOOM_FAIL, None
    if not opt.save_sra:
        resolver.cleanup(acc, path)
    return status, param


def prepare_bloom_batch(tasks: list[tuple[int, str, FilterInfo, str]], resolver: SourceResolver,
                        opt, on_downloaded=None) -> BloomBatchWork:
    """Host phase of the batched worker task: resolve or stream every
    source and 2-bit-pack the fused block (``prepare_device_batch``). No
    device work. ``tasks`` entries are (key, accession, FilterInfo,
    phase); ``on_downloaded(key)`` fires after each successful
    non-streaming download. Streamed sources above KWAGE_STREAM_BUFFER_BP
    never materialize: their buffered prefix plus the live pipe go to the
    device phase for a chunked build."""
    from kwage_tpu.sriracha.sra_source import DownloadError

    t0 = time.time()
    out: list[tuple[int, int, BloomParam | None, float]] = []
    jobs: list[tuple[list[str] | str, FilterInfo]] = []
    job_meta: list[tuple[int, str, str | None]] = []  # (key, acc, cleanup path)
    big_streams: list = []
    for key, acc, info, phase in tasks:
        source: list[str] | str | None = None
        path: str | None = None
        try:
            stream = open_fn = None
            if phase == "full" and opt.stream_sra:
                stream = resolver.open_bloom_stream(acc)
                if stream is not None:
                    def open_fn(forced, _a=acc):  # noqa: E731
                        return resolver.open_bloom_stream(_a, force_unaligned=forced)
            if stream is None:
                path = resolver.lookup(acc) if phase == "bloom" else resolver.resolve(acc)
                if path is None:
                    out.append((key, STATUS_DOWNLOAD_FAIL, None, time.time() - t0))
                    continue
                if not opt.stream_sra and on_downloaded is not None:
                    on_downloaded(key)
                if path.endswith(".sra"):
                    stream = _open_sra_bloom_stream(path)
                    if stream is not None:
                        def open_fn(forced, _p=path):  # noqa: E731
                            return _open_sra_bloom_stream(_p, force_unaligned=forced)
                if stream is None:
                    # The batch builder parses and packs the path natively.
                    source = path
            if stream is not None:
                try:
                    buf, _bp, exhausted = _take_until_bp(stream, _stream_batch_buffer_bp())
                except Exception:
                    # Aligned-colorspace fallback (worker_main.cpp:301-310).
                    if not _colorspace_retry_signature(getattr(stream, "progress", None)):
                        raise
                    stream = open_fn(True)
                    buf, _bp, exhausted = _take_until_bp(stream, _stream_batch_buffer_bp())
                if exhausted:
                    source = buf
                else:
                    big_streams.append((
                        key, acc, open_fn, chain(buf, iter(stream)),
                        getattr(stream, "progress", None), info, path,
                    ))
                    continue
        except DownloadError:
            out.append((key, STATUS_DOWNLOAD_FAIL, None, time.time() - t0))
            continue
        except Exception:  # noqa: BLE001
            out.append((key, STATUS_BLOOM_FAIL, None, time.time() - t0))
            continue
        jobs.append((source, info))
        job_meta.append((key, acc, path))

    prep = prepare_device_batch(jobs, opt.build_options()) if jobs else None
    return BloomBatchWork(out=out, jobs=jobs, job_meta=job_meta,
                          big_streams=big_streams, prep=prep, t0=t0)


def finish_bloom_batch(work: BloomBatchWork, resolver: SourceResolver, opt, bloom_path_fn,
                       handles=None, state=None) -> list[tuple[int, int, BloomParam | None, float]]:
    """Device phase of the batched worker task: run or finish the fused
    dispatches, build any streamed big jobs off their live pipes, write
    the .bloom files, classify every outcome. ``state`` carries an
    already-launched scatter (pipelined path)."""
    from kwage_tpu.sriracha.sra_source import DownloadError

    out = list(work.out)
    t0 = work.t0
    for key, acc, open_fn, stream, progress, info, path in work.big_streams:
        try:
            try:
                rec = build_bloom_device(stream, opt.build_options(), info)
            except BloomInvalid:
                raise
            except Exception:
                if not _colorspace_retry_signature(progress):
                    raise
                rec = build_bloom_device(open_fn(True), opt.build_options(), info)
            write_bloom_file(bloom_path_fn(key), rec)
            out.append((key, STATUS_BLOOM_SUCCESS, rec.param, time.time() - t0))
        except DownloadError:
            out.append((key, STATUS_DOWNLOAD_FAIL, None, time.time() - t0))
        except BloomInvalid:
            out.append((key, STATUS_BLOOM_INVALID, None, time.time() - t0))
        except Exception:  # noqa: BLE001
            out.append((key, STATUS_BLOOM_FAIL, None, time.time() - t0))
        if path is not None and not opt.save_sra:
            resolver.cleanup(acc, path)

    if work.prep is not None:
        if state is not None:
            recs = complete_device_batch(work.prep, opt.build_options(), state)
        else:
            recs = finish_device_batch(work.prep, opt.build_options(), handles)
        for (key, acc, path), rec in zip(work.job_meta, recs):
            if isinstance(rec, BloomInvalid):
                status, param = STATUS_BLOOM_INVALID, None
            elif isinstance(rec, Exception) or rec is None:
                status, param = STATUS_BLOOM_FAIL, None
            else:
                try:
                    write_bloom_file(bloom_path_fn(key), rec)
                    status, param = STATUS_BLOOM_SUCCESS, rec.param
                except Exception:  # noqa: BLE001
                    status, param = STATUS_BLOOM_FAIL, None
            if path is not None and not opt.save_sra:
                resolver.cleanup(acc, path)
            out.append((key, status, param, time.time() - t0))
    return out


def execute_bloom_batch(tasks, resolver: SourceResolver, opt, bloom_path_fn,
                        on_downloaded=None) -> list[tuple[int, int, BloomParam | None, float]]:
    """Batched worker-side Bloom task (the non-pipelined path): prepare
    + finish back to back."""
    work = prepare_bloom_batch(tasks, resolver, opt, on_downloaded)
    return finish_bloom_batch(work, resolver, opt, bloom_path_fn)


class _DeviceDispatcher(_base._DeviceDispatcher):
    """The JAX module's single owner of all device work in device-build
    mode (queue, thread, submit and stop are inherited), with a two-stage
    pipeline on this package's phases:

      stage A (batch i):   count launch -> counts readback -> solve ->
                           bloom_set_bits launch -> START pinned copy
      stage B (batch i-1): wait for the copy, write the .bloom files,
                           classify outcomes

    so batch i-1's filter copy runs under batch i's count."""

    def _run(self) -> None:
        import queue

        # Batches with stage A done, awaiting stage B; the window depth is
        # KWAGE_PIPE_DEPTH (default 2: the A(i)/B(i-1) interleave).
        depth = max(2, int(os.environ.get("KWAGE_PIPE_DEPTH", "2")))
        tails: deque = deque()  # (work, fut, scatter state)
        stopped = False
        while not (stopped and not tails):
            item = None
            if not stopped:
                try:
                    item = self.q.get(block=not tails)
                except queue.Empty:
                    item = None
            if item is self._STOP:
                stopped = True
                item = None
            trace = os.environ.get("KWAGE_PIPE_TRACE") == "1"
            if item is not None:
                work, fut = item
                try:
                    t0 = time.perf_counter()
                    state = None
                    if work.prep is not None:
                        opts = self.m.opt.build_options()
                        handles = dispatch_device_batch(work.prep, opts)
                        state = scatter_device_batch(work.prep, opts, handles)
                    if trace:
                        print(f"[pipe] stageA {1e3 * (time.perf_counter() - t0):.1f} ms")
                    tails.append((work, fut, state))
                except Exception as e:  # noqa: BLE001
                    fut.set_exception(e)
            while tails and (len(tails) >= depth or item is None or stopped):
                work, fut, state = tails.popleft()
                try:
                    t0 = time.perf_counter()
                    fut.set_result(finish_bloom_batch(
                        work, self.m.resolver, self.m.opt, self.m.bloom_path, state=state))
                    if trace:
                        print(f"[pipe] stageB {1e3 * (time.perf_counter() - t0):.1f} ms")
                except Exception as e:  # noqa: BLE001
                    fut.set_exception(e)
                if not (item is None or stopped):
                    break


class Maestro(_base.Maestro):
    """The shared scheduler, with Bloom tasks and ``.db`` packs on the
    port: ``--device-build`` runs the device ingest of
    ``kwage_tpu_torch.pipeline.make_bloom`` and ``--device-transpose``
    the bit_transpose kernel, both on ``KWAGE_TORCH_DEVICE``."""

    def _process_accession(self, idx: int, phase: str) -> tuple[int, int, BloomParam | None, float]:
        """Worker task: stage the source and build one Bloom filter
        (phase "full": resolve, download allowed; "bloom": already staged)."""
        t0 = time.time()

        def on_downloaded() -> None:
            # Persist STATUS_DOWNLOAD_SUCCESS without clobbering a
            # BLOOM_FAIL_n attempt count (the JAX scheduler's rule).
            s = int(self.status[idx])
            if not (STATUS_BLOOM_FAIL_1 <= s <= STATUS_BLOOM_FAIL_10):
                self.status[idx] = STATUS_DOWNLOAD_SUCCESS

        status, param = execute_bloom_task(
            self.accessions[idx], self.infos[idx], phase, self.resolver, self.opt,
            self.bloom_path(idx), on_downloaded=on_downloaded)
        return idx, status, param, time.time() - t0

    def _process_accession_batch(self, items: list[tuple[int, str]]):
        """Device-build worker task for a batch of accessions (the
        non-pipelined path)."""
        return execute_bloom_batch(
            [(idx, self.accessions[idx], self.infos[idx], phase) for idx, phase in items],
            self.resolver, self.opt, lambda idx: self.bloom_path(idx),
            on_downloaded=self._on_downloaded_event)

    def _prepare_batch_host(self, items: list[tuple[int, str]]) -> BloomBatchWork:
        """Host half of the pipelined device build (runs on the parse
        thread while the device executes another batch)."""
        return prepare_bloom_batch(
            [(idx, self.accessions[idx], self.infos[idx], phase) for idx, phase in items],
            self.resolver, self.opt, on_downloaded=self._on_downloaded_event)

    def _build_database(self, db_index: int, param: BloomParam,
                        members: list[int]) -> tuple[list[int], int, str, float]:
        t0 = time.time()
        ext = "dbz" if self.opt.compress_db else "db"
        db_path = os.path.join(self.opt.scratch_database_dir, f"sra.{db_index}.{ext}")
        ok = False
        try:
            blooms = [self.bloom_path(i) for i in members]
            if self.opt.compress_db:
                from kwage_tpu.pipeline.build_db import build_dbz_from_bloom_files

                build_dbz_from_bloom_files(db_path, param, blooms)
            else:
                build_db_from_bloom_files(db_path, param, blooms,
                                          device=self.opt.device_transpose)
            ok = True
        except (ValueError, OSError):
            pass
        if ok and self.opt.s3_bucket and not self.opt.s3_no_write:
            cmd = ["aws", "s3", "cp" if self.opt.save_db else "mv", db_path,
                   f"{self.opt.s3_bucket}/{os.path.basename(db_path)}"]
            proc = subprocess.run(cmd, capture_output=True)
            if proc.returncode != 0:
                return members, STATUS_DATABASE_UPLOAD_FAIL, db_path, time.time() - t0
        if ok and not self.opt.save_bloom:
            for i in members:
                try:
                    os.unlink(self.bloom_path(i))
                except OSError:
                    pass
        return members, STATUS_DATABASE_SUCCESS if ok else STATUS_DATABASE_FAIL, db_path, time.time() - t0

    def run(self) -> None:
        """The event loop. Unlike the JAX scheduler's ``run`` it opens no
        ``device_trace`` (that imports jax under KWAGE_TRACE_DIR)."""
        self._run()

    def _run(self) -> None:
        """The JAX scheduler's ``_run`` line for line, except that the
        pipelined device build uses this module's ``_DeviceDispatcher``
        (the JAX one names its own as a module global)."""
        opt = self.opt
        self._end = self._compute_end()
        self.checkpoint(force=True)
        futures: dict[Future, str] = {}
        in_flight_db: set[int] = set()
        pending_db: deque[tuple[BloomParam, list[int]]] = deque()

        # Pipelined device-build mode: ONE parse thread feeds host-packed
        # batches to ONE device dispatcher with a two-deep dispatch-ahead
        # window. Three batches in flight total.
        pipelined = opt.device_build and opt.device_batch > 1
        parse_pool = ThreadPoolExecutor(max_workers=1) if pipelined else None
        dispatcher = _DeviceDispatcher(self) if pipelined else None
        bloom_cap = 3 if pipelined else opt.num_workers

        def _submit_pipelined(items: list[tuple[int, str]]) -> Future:
            final: Future = Future()

            def _chain(pf: Future, final: Future = final) -> None:
                e = pf.exception()
                if e is not None:
                    final.set_exception(e)
                    return
                dfut = dispatcher.submit(pf.result())

                def _copy(d: Future, final: Future = final) -> None:
                    de = d.exception()
                    if de is not None:
                        final.set_exception(de)
                    else:
                        final.set_result(d.result())

                dfut.add_done_callback(_copy)

            parse_pool.submit(self._prepare_batch_host, items).add_done_callback(_chain)
            return final

        with ThreadPoolExecutor(max_workers=opt.num_workers) as pool:
            while True:
                # Forced flush: no fresh work left, nothing staged, all
                # workers idle -> zero the per-shape quotas permanently
                # (maestro_main.cpp:410-415).
                if self._cursor >= self._end and not self._download_ready and not futures:
                    self._forced_flush = True

                # Priority 1: database packing, one build at a time.
                pending_db.extend(self._take_ready_groups())
                if pending_db and not in_flight_db:
                    param, members = pending_db.popleft()
                    db_index = self.database_index
                    self.database_index += self.opt.num_slice
                    self._log(
                        f"[maestro] building database {db_index} "
                        f"(L={param.log_2_filter_len}, h={param.num_hash}, "
                        f"{len(members)} filters)"
                    )
                    fut = pool.submit(self._build_database, db_index, param, list(members))
                    futures[fut] = "db"
                    in_flight_db.update(members)
                    # Pre-mark as failed so a crash retries on restart
                    # (maestro_main.cpp:1404-1408).
                    for i in members:
                        self.status[i] = STATUS_DATABASE_FAIL

                # Priority 2: Bloom creation from restored downloads;
                # priority 3: retries, then fresh work off the cursor.
                # Device builds fuse up to --device-batch accessions.
                batch_n = opt.device_batch if opt.device_build else 1
                n_bloom = sum(1 for v in futures.values() if v != "db")
                while n_bloom < bloom_cap:
                    item = self._next_work_item()
                    if item is None:
                        break
                    if batch_n > 1:
                        items = [item]
                        while len(items) < batch_n:
                            nxt = self._next_work_item()
                            if nxt is None:
                                break
                            items.append(nxt)
                        if pipelined:
                            fut = _submit_pipelined(items)
                        else:
                            fut = pool.submit(self._process_accession_batch, items)
                        futures[fut] = "bloom_batch"
                    else:
                        fut = pool.submit(self._process_accession, *item)
                        futures[fut] = "bloom"
                    n_bloom += 1

                if not futures:
                    # Completion condition (maestro_main.cpp:341-346).
                    if not (
                        self._cursor < self._end
                        or self._download_ready
                        or self._retry
                        or bool((self.status == STATUS_BLOOM_SUCCESS).any())
                    ):
                        break
                    continue

                done, _ = wait(list(futures), return_when=FIRST_COMPLETED)
                for fut in done:
                    kind = futures.pop(fut)
                    if kind == "bloom":
                        self._absorb_bloom_event(*fut.result())
                    elif kind == "bloom_batch":
                        for item in fut.result():
                            self._absorb_bloom_event(*item)
                    else:
                        members, status, db_path, dt = fut.result()
                        in_flight_db.difference_update(members)
                        for i in members:
                            self.status[i] = status
                        self._log(
                            f"[maestro] database {os.path.basename(db_path)} "
                            f"{STATUS_NAMES.get(status, status)} "
                            f"({len(members)} filters) in {dt:.2f}s "
                            f"(mem {100.0 * memory_usage():.1f}%)"
                        )
                        if status == STATUS_DATABASE_SUCCESS:
                            self.checkpoint(force=True)

                self.checkpoint()
                self.display_status()

        if pipelined:
            dispatcher.stop()
            parse_pool.shutdown()
        self.checkpoint(force=True)
        self.display_status(force=True)

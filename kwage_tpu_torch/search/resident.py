"""Device-resident search service (PyTorch + CUDA port of
kwage_tpu/search/resident.py): load once, query many times.

``ResidentSearcher`` fuses same-shape .db/.dbz files once (the fusion and
ordering rules of ``ops.search.search_files_device``) and keeps the fused
int32 matrices on the device across requests; each query batch costs only
its own gathers. ``SearchServer`` wraps it, or the CPU host engine, in the
JSON-lines TCP protocol of the JAX module:

  request:  {"queries": ["ACGT...", ...], "threshold": 0.8,
             "format": "json" | "csv", "token": "..."}   (one line)
  response: {"ok": true, "output": "<rendered kwage JSON/CSV>"}
            | {"ok": false, "error": "..."}

The rendered output is byte-identical to what ``kwage`` prints for the
same queries against the same files.
"""

from __future__ import annotations

import json
import socketserver
import threading

import torch

from ..ops.search import (
    chunk_hits,
    chunk_words,
    collect_results,
    eval_chunk_cols,
    fuse_files,
    fusion_budget_bytes,
    group_file_chunks,
    make_query_batch,
    read_chunk,
)
from ..utils.runtime import check_token, resolve_device, resolve_secret
from .output import render_csv, render_json


class ResidentSearcher:
    """Fused database chunks resident on ``device``, searchable repeatedly.

    Chunks stay on the device until ``budget_bytes`` (default
    KWAGE_FUSION_BUDGET_BYTES) is spent; the rest stay on the host and
    upload per search call, in column slabs no wider than the budget left
    (the JAX class streams them with the whole budget, which can double
    its peak device memory).
    """

    def __init__(self, db_paths: list[str], device: torch.device,
                 budget_bytes: int | None = None):
        from ..io.dbz_file import open_database

        if budget_bytes is None:
            budget_bytes = fusion_budget_bytes()
        self.device = device
        self._budget_bytes = budget_bytes
        self.db_paths = list(db_paths)
        self._readers = [open_database(p) for p in self.db_paths]
        self._groups = []  # (param, device tensor or HostChunk, spans)
        self.resident_bytes = 0
        for param, file_idxs in group_file_chunks(self._readers, budget_bytes):
            nbytes = (self._readers[file_idxs[0]].header.filter_len
                      * chunk_words(self._readers, file_idxs) * 4)
            if self.resident_bytes + nbytes <= budget_bytes:
                self.resident_bytes += nbytes
                fused, spans = fuse_files(self._readers, file_idxs, device)
            else:
                fused, spans = read_chunk(self._readers, file_idxs)
            self._groups.append((param, fused, spans))
        self._info_cache: dict[tuple[int, int], object] = {}

    def search(self, queries: list[tuple[int, str]], threshold: float):
        """{query_id: [MatchResult]} -- the contract and ordering of
        search_files_device and the host engine."""
        if not queries:
            return {}
        qids = [qid for qid, _ in queries]
        buckets: dict[int, dict[int, list]] = {}
        for param, db, spans in self._groups:
            idx, valid, nk = make_query_batch(
                [q for _, q in queries],
                param.kmer_len, param.num_hash, param.log_2_filter_len)
            idx_d = torch.from_numpy(idx).to(self.device)
            valid_d = torch.from_numpy(valid).to(self.device)
            # Host chunks stream in slabs of the budget the resident chunks
            # left, so device memory stays within the budget.
            out = eval_chunk_cols(db, idx_d, valid_d, threshold,
                                  max(self._budget_bytes - self.resident_bytes, 1))
            chunk_hits(out, nk, spans, self._readers, threshold, buckets, qids)
        return collect_results(buckets, self._readers, self._info_cache)

    def render(self, queries: list[str], threshold: float, fmt: str = "json") -> str:
        """Rendered hit lists, byte-identical to the kwage CLI for the same
        command-line queries (ids 'command line seq i')."""
        return render(self, queries, threshold, fmt)


class HostResidentSearcher:
    """CPU twin of ResidentSearcher through the host engine (mmapped .db
    files and the native search kernel); the OS page cache plays the role
    of device residency. The JAX module's class of the same name, which
    cannot be imported without jax."""

    def __init__(self, db_paths: list[str]):
        self.db_paths = list(db_paths)

    def search(self, queries: list[tuple[int, str]], threshold: float):
        from .engine import search_database_files

        return search_database_files(self.db_paths, queries, threshold)

    def render(self, queries: list[str], threshold: float, fmt: str = "json") -> str:
        return render(self, queries, threshold, fmt)


def render(searcher, queries: list[str], threshold: float, fmt: str) -> str:
    res = searcher.search(list(enumerate(queries)), threshold)
    ordered = [(f"command line seq {i}", res[i]) for i in sorted(res)]
    if fmt == "csv":
        return render_csv(ordered)
    return render_json(ordered, threshold)


class SearchServer:
    """JSON-lines TCP server around a ResidentSearcher on one CUDA device
    (engine="device"; ``device`` defaults to ``resolve_device()``) or a
    HostResidentSearcher (engine="host": no accelerator)."""

    def __init__(self, db_paths: list[str], host: str = "127.0.0.1", port: int = 0,
                 secret: str | None = None, engine: str = "device",
                 device: torch.device | None = None):
        # Loopback + unauthenticated by default; with a shared secret
        # (argument or KWAGE_QUEUE_SECRET env) every request must carry a
        # matching "token" field or is refused.
        self._secret = resolve_secret(secret)
        if engine == "host":
            searcher = HostResidentSearcher(db_paths)
        elif engine == "device":
            searcher = ResidentSearcher(db_paths, device or resolve_device())
        else:
            raise ValueError(f"engine must be 'device' or 'host', not {engine!r}")
        self.searcher = searcher
        lock = threading.Lock()  # one device = one resource: serialize
        server_secret = self._secret

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                for raw in self.rfile:
                    line = raw.decode("utf-8").strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                        if not check_token(req, server_secret):
                            raise PermissionError("bad or missing token")
                        queries = [str(q) for q in req["queries"]]
                        threshold = float(req.get("threshold", 1.0))
                        if not 0.0 < threshold <= 1.0:
                            raise ValueError("0.0 < threshold <= 1.0 required")
                        fmt = req.get("format", "json")
                        with lock:
                            out = searcher.render(queries, threshold, fmt)
                        reply = {"ok": True, "output": out}
                    except Exception as e:  # noqa: BLE001 -- wire boundary
                        reply = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    self.wfile.write((json.dumps(reply) + "\n").encode("utf-8"))
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()

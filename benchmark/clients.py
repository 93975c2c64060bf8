"""Closed-loop clients of the search server, in a process of their own.

    python3 -m benchmark.clients '<spec JSON>'

The spec names the server's address, the configuration, the traffic mix,
the seed, the window's seconds and the number of replies to keep. Each of
``clients`` threads holds one connection and sends a request, waits for its
whole reply, and sends the next. Protocol on the pipes: after the warm-up
(the mix's ``warmup_sweep``, which touches every run once, then its own
``warmup_requests``) the process prints ``ready``; on a line ``go`` on its standard
input it runs the window; it then waits for the requests in flight and
prints one JSON line: every request sent in the window (index, send and
reply times, query bases, whether it succeeded) and the parsed hit lists of
a sample of them drawn from the seed. It imports NumPy and the standard
library only.
"""

from __future__ import annotations

import json
import socket
import sys
import threading
import time

from . import manifest, sequences


def _send(sock_file, payload: bytes) -> bytes:
    sock_file.write(payload)
    sock_file.flush()
    line = sock_file.readline()
    if not line:
        raise ConnectionError("server closed the connection")
    return line


def _payload(queries: list[str], threshold: float) -> bytes:
    return (json.dumps({"queries": queries, "threshold": threshold, "format": "json"})
            + "\n").encode()


def parse_hits(reply: bytes) -> dict[int, list] | None:
    """{query index: [[run, found, num_kmers], ...]} of a reply; None for a
    reply that is not ok."""
    msg = json.loads(reply)
    if not msg.get("ok"):
        return None
    out = msg["output"].strip()
    if not out:
        return {}
    doc = json.loads(out)
    blocks = doc if isinstance(doc, list) else [doc]
    hits = {}
    for b in blocks:
        i = int(b["query"].rsplit(" ", 1)[1])
        hits[i] = [[r["sample_metadata"]["run"], r["num_kmers_found"], r["num_kmers"]]
                   for r in b["results"]]
    return hits


def main(spec: dict) -> None:
    cfg = manifest.config(spec["config"], spec.get("root"))
    mix = manifest.traffic(spec["traffic"], spec.get("root"))
    seed, seconds = spec["seed"], spec["seconds"]
    genomes = sequences.genomes(cfg, seed)
    threshold = mix["threshold"]
    conns = []
    for _ in range(mix["clients"]):
        s = socket.create_connection((spec["host"], spec["port"]), timeout=spec["timeout_s"])
        conns.append((s, s.makefile("rwb")))

    sweep = sequences.sweep(mix, genomes, seed) if "warmup_sweep" in mix else []

    def warm(c: int) -> None:
        for q in sweep[c :: len(conns)]:
            if parse_hits(_send(conns[c][1], _payload(q, mix["warmup_sweep"]["threshold"]))) is None:
                raise RuntimeError("a warm-up request failed")
        for i in range(mix["warmup_requests"]):
            j = c * mix["warmup_requests"] + i
            q = sequences.request(mix, genomes, seed, j, warmup=True)
            if parse_hits(_send(conns[c][1], _payload(q, threshold))) is None:
                raise RuntimeError("a warm-up request failed")

    failures = []

    def guarded(c: int) -> None:
        try:
            warm(c)
        except Exception as e:  # noqa: BLE001 -- reported, and the process ends
            failures.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=guarded, args=(c,)) for c in range(len(conns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        print(f"warm-up failed: {failures[0]}", flush=True)
        return
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return

    lock = threading.Lock()
    state = {"next": 0}
    records, replies = [], {}
    t0 = time.perf_counter()
    end = t0 + seconds

    def loop(c: int) -> None:
        f = conns[c][1]
        while True:
            with lock:
                j = state["next"]
                state["next"] += 1
            q = sequences.request(mix, genomes, seed, j)
            payload = _payload(q, threshold)
            sent = time.perf_counter()
            if sent >= end:
                return
            try:
                reply = _send(f, payload)
                ok = json.loads(reply).get("ok", False)
            except (OSError, ValueError) as e:
                reply, ok = str(e).encode(), False
            done = time.perf_counter()
            with lock:
                records.append([j, sent - t0, done - t0, sum(map(len, q)), bool(ok)])
                replies[j] = reply
            if not ok:
                return

    threads = [threading.Thread(target=loop, args=(c,)) for c in range(len(conns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for s, f in conns:
        f.close()
        s.close()
    ok_js = sorted(r[0] for r in records if r[4])
    g = sequences.rng(seed, 5)
    n = min(spec["sample"], len(ok_js))
    chosen = sorted(int(x) for x in g.choice(ok_js, size=n, replace=False)) if n else []
    sample = {str(j): parse_hits(replies[j]) for j in chosen}
    errors = [replies[r[0]][:300].decode(errors="replace") for r in records if not r[4]][:3]
    print(json.dumps({"records": records, "sample": sample, "errors": errors}), flush=True)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))

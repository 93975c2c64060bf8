"""The one rule for a port that the port's tests hand to processes of
their own, where the server cannot bind port 0 itself and report the
address (torch.distributed's ``tcp://`` rendezvous, where rank 0 binds the
address it is given): take a port that is free now, run every process
with it, and run them all again with a fresh port only when one of them
failed because the address was taken in between (another process bound
it after its release), at most ATTEMPTS runs in all. Any other failure
stands as it is."""

import re
import socket
import subprocess
import threading
import time

ATTEMPTS = 3
# Python's OSError, torch's TCPStore ("... code: -98, name: EADDRINUSE,
# message: address already in use").
ADDRESS_TAKEN = re.compile(r"EADDRINUSE|address already in use", re.IGNORECASE)


def free_port() -> int:
    """A port of 127.0.0.1 that was free when this returned."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_together(argvs: list[list[str]], envs: list[dict], timeout: float,
                 **popen) -> list[subprocess.CompletedProcess]:
    """Start one process an argv (its env beside it; stdout and stderr
    captured as text) and wait for every one. Once one exits non-zero the
    others are killed: a rank whose peer failed would wait for it until
    ``timeout``. Raises subprocess.TimeoutExpired past ``timeout``, with
    every process killed."""
    procs = [subprocess.Popen(a, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, **popen) for a, e in zip(argvs, envs)]
    outs: list = [None] * len(procs)

    def drain(i):
        outs[i] = procs[i].communicate()

    drains = [threading.Thread(target=drain, args=(i,), daemon=True) for i in range(len(procs))]
    for t in drains:
        t.start()
    deadline = time.monotonic() + timeout
    try:
        while any(t.is_alive() for t in drains):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(argvs[0], timeout)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in drains:
            t.join(timeout=30)
    return [subprocess.CompletedProcess(a, p.returncode, *(o or ("", "")))
            for a, p, o in zip(argvs, procs, outs)]


def address_taken(runs: list[subprocess.CompletedProcess]) -> bool:
    """Whether a run failed and one of its processes' stderr says that the
    address was taken."""
    return (any(r.returncode for r in runs)
            and any(ADDRESS_TAKEN.search(r.stderr or "") for r in runs))


def with_fresh_port(run, attempts: int = ATTEMPTS) -> list[subprocess.CompletedProcess]:
    """``run(port)`` (its processes' CompletedProcess list) with a port free
    a moment ago; again with a fresh one while it failed on a taken
    address, at most ``attempts`` runs in all. The last run's list."""
    for attempt in range(attempts):
        runs = run(free_port())
        if attempt == attempts - 1 or not address_taken(runs):
            return runs

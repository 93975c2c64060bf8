"""The one rule for a port handed to other processes (tests/_torch_ports.py):
a run whose process failed because its address was taken runs again with
a fresh port, at most three times in all; any other failure stands."""

import subprocess
import sys
import time

import pytest
from _torch_ports import ATTEMPTS, run_together, with_fresh_port

# A child that fails with argv[2] on stderr as long as the file argv[1]
# holds fewer than argv[3] lines, adding one a run; then prints "ok".
CHILD = """
import sys
path, message, failures = sys.argv[1], sys.argv[2], int(sys.argv[3])
with open(path, "a+") as f:
    f.seek(0)
    runs = len(f.readlines())
    f.write("run\\n")
if runs < failures:
    print(message, file=sys.stderr)
    sys.exit(1)
print("ok")
"""

TAKEN = [
    "OSError: [Errno 98] Address already in use",
    "torch.distributed.DistNetworkError: The server socket has failed to listen on any local "
    "network address. port: 29500, useIpv6: false, code: -98, name: EADDRINUSE, message: "
    "address already in use",
]


def _run(tmp_path, message, failures):
    """with_fresh_port over one CHILD with a peer that waits; the ports
    each run was handed."""
    ports = []

    def run(port):
        ports.append(port)
        return run_together(
            [[sys.executable, "-c", CHILD, str(tmp_path / "runs"), message, str(failures)],
             [sys.executable, "-c", "import time; time.sleep(0.5)"]],
            [None, None], timeout=60)

    return with_fresh_port(run), ports


@pytest.mark.parametrize("message", TAKEN, ids=["python", "torch_store"])
def test_a_taken_address_runs_again_once(tmp_path, message):
    """A child that fails once because its address was taken, then
    succeeds, runs exactly twice, each time with a port free a moment
    before."""
    runs, ports = _run(tmp_path, message, 1)
    assert len(ports) == 2 and all(0 < p < 65536 for p in ports)
    assert [r.returncode for r in runs] == [0, 0] and runs[0].stdout == "ok\n"


def test_another_failure_is_not_retried(tmp_path):
    """A child that fails with any other error runs once, and its error
    stands as the result."""
    runs, ports = _run(tmp_path, "ValueError: not a port at all", 1)
    assert len(ports) == 1
    assert runs[0].returncode == 1 and "ValueError: not a port at all" in runs[0].stderr


def test_a_taken_address_runs_at_most_three_times(tmp_path):
    """An address taken every time: ATTEMPTS (3) runs, the last one's
    failure returned."""
    runs, ports = _run(tmp_path, TAKEN[0], 10)
    assert len(ports) == ATTEMPTS == 3
    assert runs[0].returncode == 1 and "Address already in use" in runs[0].stderr


def test_run_together_stops_the_peers_of_a_failed_process():
    """One process fails at once: its peer, which would wait a minute for
    it, is killed, and both results come back."""
    t0 = time.monotonic()
    runs = run_together([[sys.executable, "-c", "import sys; sys.exit(3)"],
                         [sys.executable, "-c", "import time; time.sleep(60)"]],
                        [None, None], timeout=120)
    assert time.monotonic() - t0 < 30
    assert runs[0].returncode == 3 and runs[1].returncode != 0


def test_run_together_times_out():
    with pytest.raises(subprocess.TimeoutExpired):
        run_together([[sys.executable, "-c", "import time; time.sleep(60)"]], [None],
                     timeout=1)


"""kwage for the PyTorch + CUDA port: same flags and output bytes as
kwage_tpu.cli.kwage (and the reference binary), with ``--device`` and
``--serve`` running on the port's CUDA kernels.

``--device`` searches on ``KWAGE_TORCH_DEVICE`` (default ``cuda``); with
several CUDA devices visible the files shard over all of them
(``parallel.sharded_search``). Without it the host engine runs.
"""

from __future__ import annotations

import getopt
import os
import sys
import time

from .. import KWAGE_VERSION
from ..core.params import DEFAULT_SEARCH_THRESHOLD
from ..io.sequence import iter_sequences, reference_sequence_gate
from ..search.engine import search_database_files
from ..search.output import render_csv, render_json
from ..utils.profiling import scope

OUTPUT_CSV = 0
OUTPUT_JSON = 1


def find_db_files(paths: list[str]) -> list[str]:
    """Recursive .db/.dbz discovery under -d paths (options.cpp:130-139;
    the reference README promises .dbz but its options.cpp only matches
    .db -- this engine implements both).

    Traversal replicates FindFiles (file_util.h:15-126) exactly: breadth
    first, entries in raw readdir order within each directory,
    subdirectories queued to the back. Result ordering for tied match
    scores follows database traversal order in the reference, so byte
    parity on the same directory requires the same walk.
    """
    from collections import deque

    from ..io.sequence import reference_ext_match

    def is_db(path: str) -> bool:
        # The reference's quirky matcher applies to the FULL path
        # (file_util.cpp find_file_extension: first case-insensitive
        # occurrence must end the string), so databases under a
        # '.db'-containing directory are invisible -- mirrored, with the
        # same rule for the .dbz extension.
        return (reference_ext_match(path, ".db")
                or reference_ext_match(path, ".dbz"))

    out: list[str] = []
    targets = deque(paths)
    while targets:
        p = targets.popleft()
        if os.path.isfile(p):
            if is_db(p):
                out.append(p)
        elif os.path.isdir(p):
            with os.scandir(p) as it:
                for entry in it:
                    if entry.is_dir():
                        targets.append(entry.path)
                    elif entry.is_file() and is_db(entry.path):
                        out.append(entry.path)
    return out


def usage(out=sys.stderr) -> None:
    print(f"Usage for KWAGE (v. {KWAGE_VERSION}):", file=out)
    print("\t[-o <output file>] (default is stdout)", file=out)
    print("\t[--o.csv (output CSV) | --o.json (output JSON)]", file=out)
    print(f"\t[-t <search threshold>] (default is {DEFAULT_SEARCH_THRESHOLD:g})", file=out)
    print("\t-d <database search path> (can be repeated)", file=out)
    print("\t[-i <input sequence file>] (can be repeated)", file=out)
    print("\t[<DNA sequence>] (can be repeated)", file=out)
    print("\t[--device (run the search on the CUDA device KWAGE_TORCH_DEVICE names, default cuda; several visible cards shard the files over a filters-axis mesh)] (engine extension)", file=out)
    print("\t[--threads <n> (host search threads; default OMP_NUM_THREADS/"
          "KWAGE_NUM_THREADS)] (engine extension)", file=out)
    print("\t[--serve <port> (keep the databases device-resident and answer"
          " JSON-line queries over TCP; binds loopback; UNAUTHENTICATED"
          " unless KWAGE_QUEUE_SECRET is set, then every request needs a"
          " matching \"token\" field)] (engine extension)", file=out)
    print("\t[--serve-engine <device|host> (serve backend: device-resident"
          " matrices, or the CPU host engine -- no accelerator needed;"
          " default device)] (engine extension)", file=out)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    t0 = time.time()

    output_file = ""
    output_format = OUTPUT_JSON
    threshold = DEFAULT_SEARCH_THRESHOLD
    db_paths: list[str] = []
    query_files: list[str] = []
    use_device = False
    num_threads = None
    serve_port = None
    serve_engine = "device"

    try:
        opts, args = getopt.gnu_getopt(
            argv, "o:d:i:t:h?",
            ["o.csv", "o.json", "device", "threads=", "serve=", "serve-engine="],
        )
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        usage()
        return 1

    if not argv:
        usage()
        return 0

    for flag, val in opts:
        if flag == "-o":
            output_file = val
        elif flag == "-d":
            db_paths.append(val)
        elif flag == "-i":
            query_files.append(val)
        elif flag == "-t":
            threshold = float(val)
        elif flag in ("-h", "-?"):
            usage()
            return 0
        elif flag == "--o.csv":
            output_format = OUTPUT_CSV
        elif flag == "--o.json":
            output_format = OUTPUT_JSON
        elif flag == "--device":
            use_device = True
        elif flag == "--threads":
            num_threads = max(1, int(val))
        elif flag == "--serve":
            serve_port = int(val)
        elif flag == "--serve-engine":
            if val not in ("device", "host"):
                print("--serve-engine must be 'device' or 'host'", file=sys.stderr)
                return 1
            serve_engine = val

    query_seqs = list(args)

    subject_files = find_db_files(db_paths)
    # Every options-stage rejection below exits 0 like the reference
    # (kwage.cpp:44-46): callers check stderr/output, not the exit code.
    if not subject_files:
        print("Please provide at least one database file to search (-d)", file=sys.stderr)
        return 0
    if serve_port is not None:
        from ..search.resident import SearchServer

        server = SearchServer(subject_files, port=serve_port, engine=serve_engine)
        print(
            f"Serving {len(subject_files)} database files on port "
            f"{server.address[1]}",
            file=sys.stderr,
        )
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
        return 0
    if not query_files and not query_seqs:
        print("Please provide at least one query sequence or file", file=sys.stderr)
        return 0
    for qf in query_files:
        if not reference_sequence_gate(qf):
            print(
                f"The query sequence file name, {qf}, does not have an allowed file extension",
                file=sys.stderr,
            )
            return 0
    if threshold <= 0.0 or threshold > 1.0:
        print("Please provide: 0.0 < search threshold <= 1.0", file=sys.stderr)
        return 0

    # Command-line and file sequences live in separate id spaces
    # (kwage.cpp:116-148); command-line matches print first, each by id.
    cmd_queries = [(i, s) for i, s in enumerate(query_seqs)]
    file_queries: list[tuple[int, str]] = []
    file_deflines: dict[int, str] = {}
    qid = 0
    for qf in query_files:
        for defline, seq in iter_sequences(qf):
            file_queries.append((qid, seq))
            file_deflines[qid] = defline
            qid += 1

    if use_device:
        from ..io.dbz_file import open_database
        from ..ops.search import check_device_filter_len
        from ..parallel.mesh import default_devices

        try:
            check_device_filter_len([open_database(p) for p in subject_files])
        except ValueError as e:
            print(f"--device: {e}", file=sys.stderr)
            return 1
        devices = default_devices()
        if len(devices) > 1:
            # Several cards: shard the fused matrices over a filters-axis
            # mesh spanning every visible device (hit lists remain
            # byte-identical to the host engine / reference binary).
            from ..parallel.mesh import make_search_mesh
            from ..parallel.sharded_search import sharded_search_files

            mesh = make_search_mesh(1, len(devices), devices)

            def _search(files, qs, t):
                return sharded_search_files(mesh, files, qs, t)
        else:
            from ..ops.search import search_files_device

            def _search(files, qs, t):
                return search_files_device(files, qs, t, devices[0])
    else:
        def _search(files, qs, t):
            return search_database_files(files, qs, t, num_threads=num_threads)
    # One pass over the databases for both id spaces (file qids offset).
    n_cmd = len(cmd_queries)
    combined = cmd_queries + [(n_cmd + qid, seq) for qid, seq in file_queries]
    with scope("kwage.search"):
        all_results = _search(subject_files, combined, threshold) if combined else {}
    cmd_results = {q: r for q, r in all_results.items() if q < n_cmd}
    file_results = {q - n_cmd: r for q, r in all_results.items() if q >= n_cmd}

    ordered: list[tuple[str, list]] = []
    for i in sorted(cmd_results):
        ordered.append((f"command line seq {i}", cmd_results[i]))
    for i in sorted(file_results):
        ordered.append((file_deflines[i], file_results[i]))

    if output_format == OUTPUT_CSV:
        text = render_csv(ordered)
    else:
        text = render_json(ordered, threshold)

    if output_file:
        with open(output_file, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)

    print(f"Search complete in {int(time.time() - t0)} sec", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

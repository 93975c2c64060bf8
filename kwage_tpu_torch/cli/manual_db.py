"""manual_db: mark a database file's accessions DATABASE_SUCCESS in a
status file (repair after manual S3 uploads; manual_db.cpp:13-286).

The status array indexes accessions in *sorted run-accession order* over
the inventory (matching parse_accession_loc, file_io.cpp:23-118).
"""

from __future__ import annotations

import getopt
import sys

import numpy as np

from ..core.accession import INVALID_ACCESSION, accession_to_str
from ..io.db_file import DBFileReader
from ..io.inventory import scan_inventory_locations
from ..io.status import read_status_file, write_status_file
from ..parallel.maestro import STATUS_DATABASE_SUCCESS, STATUS_INIT
from ._render import cli_errors


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    db_file = status_file = meta_file = ""

    try:
        flags, _ = getopt.gnu_getopt(argv, "d:s:h?", ["meta="])
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        return 1

    for flag, val in flags:
        if flag == "-d":
            db_file = val
        elif flag == "-s":
            status_file = val
        elif flag == "--meta":
            meta_file = val
        elif flag in ("-h", "-?"):
            argv = []

    if not argv or not (db_file and status_file and meta_file):
        print("Usage:", file=sys.stderr)
        print("\t-d <input database file to read accessions from>", file=sys.stderr)
        print("\t-s <status file to update>", file=sys.stderr)
        print("\t--meta <metadata file to read>", file=sys.stderr)
        return 0

    accession_loc = scan_inventory_locations(meta_file)
    num_sra = len(accession_loc)
    if num_sra == 0:
        print("Did not read any SRA accessions from the input metadata file", file=sys.stderr)
        return 1
    acc_sorted = [a for a, _ in accession_loc]

    import os

    if os.path.exists(status_file):
        status, database_index = read_status_file(status_file, num_sra)
        status = status.copy()
    else:
        status = np.full(num_sra, STATUS_INIT, dtype=np.uint8)
        database_index = 1

    reader = DBFileReader(db_file)
    num_success = num_fail = 0
    for info in reader.read_all_filter_info():
        if info.run_accession == INVALID_ACCESSION:
            print("Warning: FilterInfo has an invalid run accession!", file=sys.stderr)
            num_fail += 1
            continue
        import bisect

        i = bisect.bisect_left(acc_sorted, info.run_accession)
        if i < num_sra and acc_sorted[i] == info.run_accession:
            status[i] = STATUS_DATABASE_SUCCESS
            num_success += 1
        else:
            print(
                f"Unable to find a valid status file index for SRA accession "
                f"{accession_to_str(info.run_accession)}",
                file=sys.stderr,
            )
            num_fail += 1

    write_status_file(status_file, status, database_index)
    print(f"Updated {num_success} accessions ({num_fail} failures)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""sra_diff: accession-set diff of two binary inventory files (sra_diff.cpp:14-135)."""

from __future__ import annotations

import sys

from ..core.accession import accession_to_str
from ..io.inventory import read_inventory
from ._render import cli_errors


def _accessions(path: str) -> list[int]:
    return sorted(info.run_accession for info in read_inventory(path))


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(f"Usage: {sys.argv[0]} <binary metadata file 1> <binary metadata file 2>", file=sys.stderr)
        return 0

    acc = []
    for i, path in enumerate(argv, 1):
        print(f"Reading file {i}: {path}", file=sys.stderr)
        try:
            acc.append(_accessions(path))
        except Exception:
            print(f"Unable to parse file {i}: {path}", file=sys.stderr)
            acc.append([])

    a1, a2 = acc
    i = j = 0
    print("Comparing accession sets", file=sys.stderr)
    while True:
        if i == len(a1):
            print("Reached the last accession of the first file")
            print(f"There are {len(a2) - j} accessions remaining in the second file")
            break
        if j == len(a2):
            print("Reached the last accession of the second file")
            print(f"There are {len(a1) - i} accessions remaining in the first file")
            break
        if a1[i] < a2[j]:
            print(f"1: {accession_to_str(a1[i])}")
            i += 1
        elif a2[j] < a1[i]:
            print(f"2: {accession_to_str(a2[j])}")
            j += 1
        else:
            i += 1
            j += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

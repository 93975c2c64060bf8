"""merge_db: defragment partially-filled database files (merge_db.cpp)."""

from __future__ import annotations

import sys

from ..pipeline.merge_db import merge_databases


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    files = [a for a in argv if not a.startswith("-")]
    if not argv or any(a in ("-h", "-?", "--help") for a in argv):
        print("Usage: ", file=sys.stderr)
        print(f"\t{sys.argv[0]} <database file 1> <database file 2> ...", file=sys.stderr)
        return 0
    if len(files) < 2:
        print("Please specify 2 or more database files to merge", file=sys.stderr)
        return 0
    try:
        merge_databases(files)
    except (ValueError, OSError) as e:
        print(f"Caught the error {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

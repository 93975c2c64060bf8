"""sra_inventory: NCBI metadata tar.gz -> binary SRA inventory.

Flag-compatible with the reference tool (options.cpp InventoryOptions).
"""

from __future__ import annotations

import getopt
import sys

from .. import INVENTORY_VERSION
from ..core.accession import str_to_accession, accession_to_str
from ..core.dates import Date
from ..pipeline.inventory import InventoryFilters, build_inventory, parse_sra_metadata, apply_filters
from ._render import cli_errors


def usage() -> None:
    e = sys.stderr
    print(f"Usage for sra_inventory (v. {INVENTORY_VERSION}):", file=e)
    print("\t-i <NCBI SRA metadata tar.gz file>", file=e)
    print("\t[-o <binary output file>]", file=e)
    print("\t[--list (list, but do not write binary SRA inventory)]", file=e)
    print("\t[--date.from <YYYY-MM-DD>] (only download SRA records received after this date)", file=e)
    print("\t[--date.to <YYYY-MM-DD>] (only download SRA records received before this date)", file=e)
    print("\t[--strategy <strategy key word>] (only download SRA records that match one of the specified experimental strategies)", file=e)
    print("\t[--source <source key word>] (only download SRA records that match one of the specified exterimental sources)", file=e)
    print("\t[--include <list of SRA run accessions>] (only download SRA records that match one of the specified SRA runs)", file=e)


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        usage()
        return 0

    try:
        flags, _ = getopt.gnu_getopt(
            argv, "i:o:h?",
            ["list", "date.from=", "date.to=", "strategy=", "source=", "include="],
        )
    except getopt.GetoptError as e:
        print(e, file=sys.stderr)
        usage()
        return 1

    metadata_file = ""
    output_file = ""
    list_only = False
    filt = InventoryFilters()
    for flag, val in flags:
        if flag == "-i":
            metadata_file = val
        elif flag == "-o":
            output_file = val
        elif flag == "--list":
            list_only = True
        elif flag == "--date.from":
            filt.begin_date = Date.parse(val + "T00:00:00Z" if len(val) == 10 else val)
        elif flag == "--date.to":
            filt.end_date = Date.parse(val + "T00:00:00Z" if len(val) == 10 else val)
        elif flag == "--strategy":
            filt.required_strategy.add(val)
        elif flag == "--source":
            filt.required_source.add(val)
        elif flag == "--include":
            with open(val) as f:
                filt.include_accessions += [str_to_accession(a) for a in f.read().split()]
            filt.include_accessions.sort()
        elif flag in ("-h", "-?"):
            usage()
            return 0

    if not metadata_file:
        # Options-stage rejection exits 0 like the reference
        # (sra_inventory.cpp:70-72 returns EXIT_SUCCESS on opt.quit).
        print("Please specify an NCBI SRA metadata file (-i)", file=sys.stderr)
        return 0

    if list_only:
        db, _ = parse_sra_metadata(metadata_file)
        db = apply_filters(db, filt)
        for info in db:
            print(accession_to_str(info.run_accession))
        return 0

    if not output_file:
        print("Please specify a binary output file (-o)", file=sys.stderr)
        return 1

    n = build_inventory(metadata_file, output_file, filt)
    print(f"There are {n} valid SRA records", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

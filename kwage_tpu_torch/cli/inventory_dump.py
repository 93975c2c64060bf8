"""inventory_dump: print every record of a binary inventory file
(inventory_dump.cpp:12-110)."""

from __future__ import annotations

import struct
import sys

from ..core.accession import INVALID_ACCESSION, accession_to_str
from ..io.binary import BinaryReader
from ._render import cli_errors


@cli_errors
def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(f"Usage: {sys.argv[0]} <binary metadata file>", file=sys.stderr)
        return 0

    with open(argv[0], "rb") as f:
        (num_info,) = struct.unpack("<Q", f.read(8))
        print(f"Metadata file contains {num_info} FilterInfo objects")
        r = BinaryReader(f)
        for _ in range(num_info):
            info = r.filter_info()
            if info.run_accession == INVALID_ACCESSION:
                print("Invalid run accession")
            else:
                print(accession_to_str(info.run_accession))
            print(f"\tspots : {info.number_of_spots}")
            print(f"\tbases : {info.number_of_bases}")
            print(f"\tdate_received : {info.date_received}")
            if info.experiment_accession == INVALID_ACCESSION:
                print("\texperiment_accession : Invalid")
            else:
                print(f"\texperiment_accession : {accession_to_str(info.experiment_accession)}")
            print(f"\texperiment_title : {info.experiment_title}")
            print(f"\texperiment_design_description : {info.experiment_design_description}")
            print(f"\texperiment_library_name : {info.experiment_library_name}")
            print(f"\texperiment_library_strategy : {info.experiment_library_strategy}")
            print(f"\texperiment_library_source : {info.experiment_library_source}")
            print(f"\texperiment_library_selection : {info.experiment_library_selection}")
            print(f"\texperiment_instrument_model : {info.experiment_instrument_model}")
            if info.sample_accession == INVALID_ACCESSION:
                print("\tsample_accession : Invalid")
            else:
                print(f"\tsample_accession : {accession_to_str(info.sample_accession)}")
            print(f"\tsample_taxa : {info.sample_taxa}")
            if info.sample_attributes:
                print("\tsample_attributes :")
                for k, v in info.sample_attributes.items():
                    print(f"\t\t{k} : {v}")
            if info.study_accession == INVALID_ACCESSION:
                print("\tstudy_accession : Invalid")
            else:
                print(f"\tstudy_accession : {accession_to_str(info.study_accession)}")
            print(f"\tstudy_title : {info.study_title}")
            print(f"\tstudy_abstract : {info.study_abstract}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

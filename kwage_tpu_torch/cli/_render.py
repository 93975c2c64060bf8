"""Shared text rendering helpers for the inspection CLIs (reference-parity)."""

from __future__ import annotations

import functools
import sys
import tarfile

from ..core.accession import INVALID_ACCESSION, accession_to_str
from ..core.hash import MURMUR_HASH_32, UNKNOWN_HASH
from ..core.info import FilterInfo


def cli_errors(fn):
    """Turn I/O and format errors into clean diagnostics + exit code 1,
    matching the reference tools' catch-all error reporting."""

    @functools.wraps(fn)
    def wrapper(argv=None):
        try:
            return fn(argv)
        except FileNotFoundError as e:
            print(f"Unable to open {e.filename} for reading", file=sys.stderr)
            return 1
        except (OSError, EOFError, ValueError) as e:
            print(f"Caught the error {e}", file=sys.stderr)
            return 1
        except tarfile.TarError as e:
            print(f"Caught the error {e}", file=sys.stderr)
            return 1

    return wrapper


def hash_func_label(func: int) -> str:
    if func == MURMUR_HASH_32:
        return "Murmur32"
    if func == UNKNOWN_HASH:
        return "Unknown"
    return "Invalid"


def _acc_or_na(acc: int) -> str:
    return "NA" if acc == INVALID_ACCESSION else accession_to_str(acc)


def _or_na(s: str) -> str:
    return s if s else "NA"


def render_annotation(info: FilterInfo, sorted_attribs: bool) -> list[str]:
    """FilterInfo annotation block shared by dump_db/dump_bloom.

    ``sorted_attribs``: dump_db sorts attribute keys (dump_db.cpp:285-303);
    dump_bloom prints map order (we preserve insertion order).
    """
    lines = [
        f"\trun_accession = {_acc_or_na(info.run_accession)}",
        f"\texperiment_accession = {_acc_or_na(info.experiment_accession)}",
        f"\texperiment_title = {_or_na(info.experiment_title)}",
        f"\texperiment_design_description = {_or_na(info.experiment_design_description)}",
        f"\texperiment_library_name = {_or_na(info.experiment_library_name)}",
        f"\texperiment_library_strategy = {_or_na(info.experiment_library_strategy)}",
        f"\texperiment_library_source = {_or_na(info.experiment_library_source)}",
        f"\texperiment_library_selection = {_or_na(info.experiment_library_selection)}",
        f"\texperiment_instrument_model = {_or_na(info.experiment_instrument_model)}",
        f"\tsample_accession = {_acc_or_na(info.sample_accession)}",
        f"\tsample_taxa = {_or_na(info.sample_taxa)}",
    ]
    if info.sample_attributes:
        lines.append("\tsample_attributes:")
        keys = sorted(info.sample_attributes) if sorted_attribs else list(info.sample_attributes)
        for k in keys:
            lines.append(f"\t\t{k} = {info.sample_attributes[k]}")
    lines += [
        f"\tstudy_accession = {_acc_or_na(info.study_accession)}",
        f"\tstudy_title = {_or_na(info.study_title)}",
        f"\tstudy_abstract = {_or_na(info.study_abstract)}",
    ]
    return lines

"""Per-filter SRA metadata record (FilterInfo, bloom.h:474-537).

Field order follows the reference X-macro member list (bloom.h:478-496),
which also fixes the on-disk serialization order. CSV rendering is the run
accession only (bloom.cpp:124-127); JSON rendering omits NA/empty fields
and matches the reference layout exactly (bloom.cpp:129-326).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .accession import INVALID_ACCESSION, accession_to_str
from .dates import Date


@dataclass
class FilterInfo:
    run_accession: int = INVALID_ACCESSION
    experiment_accession: int = INVALID_ACCESSION
    experiment_title: str = ""
    experiment_design_description: str = ""
    experiment_library_name: str = ""
    experiment_library_strategy: str = ""
    experiment_library_source: str = ""
    experiment_library_selection: str = ""
    experiment_instrument_model: str = ""
    sample_accession: int = INVALID_ACCESSION
    sample_taxa: str = ""
    sample_attributes: dict[str, str] = field(default_factory=dict)
    study_accession: int = INVALID_ACCESSION
    study_title: str = ""
    study_abstract: str = ""
    number_of_spots: int = 0
    number_of_bases: int = 0
    date_received: Date = field(default_factory=Date)

    # Not serialized (bloom.h:502-503)
    valid: bool = True

    def sort_key(self) -> int:
        """Filters sort ascending by number_of_bases (bloom.h:522-525)."""
        return self.number_of_bases

    def csv_string(self) -> str:
        # The reference renders the accession unconditionally, even when
        # invalid (bloom.cpp:124-127: INVALID_ACCESSION prints as "AAA0").
        return accession_to_str(self.run_accession)

    def json_string(self, prefix: str) -> str:
        parts: list[str] = []

        def emit(key: str, value: str) -> None:
            parts.append(f'{prefix}"{key}": "{value}"')

        if self.run_accession != INVALID_ACCESSION:
            emit("run", accession_to_str(self.run_accession))
        if self.date_received.is_valid:
            emit("date received", str(self.date_received))
        if self.experiment_accession != INVALID_ACCESSION:
            emit("experiment", accession_to_str(self.experiment_accession))
        if self.experiment_title:
            emit("experiment title", self.experiment_title)
        if self.experiment_design_description:
            emit("experiment design", self.experiment_design_description)
        if self.experiment_library_name:
            emit("experiment library name", self.experiment_library_name)
        if self.experiment_library_strategy:
            emit("experiment library strategy", self.experiment_library_strategy)
        if self.experiment_library_source:
            emit("experiment library source", self.experiment_library_source)
        if self.experiment_library_selection:
            emit("experiment library selection", self.experiment_library_selection)
        if self.experiment_instrument_model:
            emit("experiment instrument model", self.experiment_instrument_model)
        if self.sample_accession != INVALID_ACCESSION:
            emit("sample", accession_to_str(self.sample_accession))
        if self.sample_taxa:
            emit("sample taxa", self.sample_taxa)
        if self.sample_attributes:
            attrs = []
            for tag, value in self.sample_attributes.items():
                attrs.append(
                    f'{prefix}\t{{\n'
                    f'{prefix}\t\t"tag": "{tag}",\n'
                    f'{prefix}\t\t"value": "{value}"\n'
                    f"{prefix}\t}}"
                )
            parts.append(
                f'{prefix}"sample attributes": [\n' + ",\n".join(attrs) + f"\n{prefix}]"
            )
        if self.study_accession != INVALID_ACCESSION:
            emit("study", accession_to_str(self.study_accession))
        if self.study_title:
            emit("study title", self.study_title)
        if self.study_abstract:
            emit("study abstract", self.study_abstract)

        return ",\n".join(parts)

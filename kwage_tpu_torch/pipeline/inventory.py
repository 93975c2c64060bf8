"""SRA inventory construction (the reference's sra_inventory tool).

Streams the NCBI metadata tar.gz without extraction: pass 1 parses the
SRA_Accessions.tab table (RUN rows; suppressed/controlled/unpublished
dropped; spots/bases/dates; linked experiment/sample/study accessions),
pass 2 line-scans the per-submission XML files for experiment, sample and
study annotations (plus the dbgap controlled-access exclusion), merging
every ``max_num_xml`` records to bound memory (sra_inventory.cpp:460-968).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from ..core.accession import INVALID_ACCESSION, str_to_accession
from ..core.dates import Date
from ..core.info import FilterInfo
from ..io.tar import iter_tar_members

MAX_NUM_XML = 100000

# SRA metadata member file classes (sra_inventory.cpp:1111-1132)
RUN_XML, EXPERIMENT_XML, SAMPLE_XML, STUDY_XML, SRA_ACCESSIONS, SRA_RUN_MEMBERS, UNKNOWN = range(7)


def sra_file_type(filename: str) -> int:
    if filename.endswith(".run.xml"):
        return RUN_XML
    if filename.endswith(".experiment.xml"):
        return EXPERIMENT_XML
    if filename.endswith(".sample.xml"):
        return SAMPLE_XML
    if filename.endswith(".study.xml"):
        return STUDY_XML
    # Exact-suffix matches, like the reference's find_extension
    # (sra_inventory.cpp:1100-1137): the NCBI archive member is named
    # "SRA_Accessions" with no extension; "SRA_Accessions.tab" must NOT
    # match (the reference skips it).
    if filename.endswith("SRA_Accessions"):
        return SRA_ACCESSIONS
    if filename.endswith("SRA_Run_Members"):
        return SRA_RUN_MEMBERS
    return UNKNOWN


def _xml_entry(xml_info: dict, acc: int) -> "FilterInfo":
    """xml_info[acc], creating lazily (avoids a throwaway FilterInfo
    construction per annotation line, the setdefault(acc, FilterInfo())
    anti-pattern)."""
    e = xml_info.get(acc)
    if e is None:
        e = xml_info[acc] = FilterInfo()
    return e


_TAG_CACHE: dict[str, tuple[str, str]] = {}


def parse_xml_value(key: str, line: str) -> str:
    """Single-line <KEY>value</KEY> extraction (sra_inventory.cpp:1143-1167)."""
    tags = _TAG_CACHE.get(key)
    if tags is None:
        tags = _TAG_CACHE[key] = (f"<{key}>", f"</{key}>")
    open_tag, close_tag = tags
    begin = line.find(open_tag)
    if begin < 0:
        raise ValueError(f"unable to find {open_tag}")
    begin += len(open_tag)
    end = line.rfind(close_tag)
    if end < 0 or begin > end:
        raise ValueError(f"unable to find {close_tag}")
    return line[begin:end]


def parse_key_value(line: str, key: str) -> str:
    """key="value" attribute extraction (sra_inventory.cpp:1169-1202)."""
    marker = key + "="
    loc = line.find(marker)
    if loc < 0:
        raise ValueError(f"unable to find {marker}")
    loc += len(marker) + 1  # skip opening quote
    end = line.find('"', loc)
    if end < 0:
        raise ValueError("no closing quote")
    return line[loc:end]


def parse_sra_text(metadata_file: str) -> list[FilterInfo]:
    """Pass 1: SRA_Accessions.tab -> per-RUN FilterInfo records."""
    db: list[FilterInfo] = []
    cols_index: dict[str, int] | None = None
    required = [
        "Accession", "Status", "Updated", "Published", "Received", "Type",
        "Visibility", "Experiment", "Sample", "Study", "Center", "Spots", "Bases",
    ]
    for filename, lines in iter_tar_members(metadata_file):
      if sra_file_type(filename) != SRA_ACCESSIONS:
          continue  # member skipped wholesale: no line splitting
      for line in lines:
        cols = line.split("\t")
        if cols_index is None:
            cols_index = {name: i for i, name in enumerate(cols)}
            for name in required:
                if name not in cols_index:
                    raise ValueError(f'did not find "{name}" column in SRA Accessions file')
            continue
        if len(cols) != len(cols_index):
            raise ValueError("unexpected column count in SRA Accessions file")
        c = lambda name: cols[cols_index[name]]
        if c("Type") != "RUN":
            continue
        if c("Status") in ("suppressed", "controlled_access", "unpublished"):
            continue
        if c("Visibility") in ("suppressed", "controlled_access"):
            continue
        info = FilterInfo(run_accession=str_to_accession(c("Accession")))
        if c("Spots") != "-":
            info.number_of_spots = int(c("Spots"))
        if c("Bases") != "-":
            info.number_of_bases = int(c("Bases"))
        info.date_received = Date.parse(c("Received"))
        if c("Experiment") != "-":
            info.experiment_accession = str_to_accession(c("Experiment"))
        if c("Sample") not in ("-", "Multiplex"):
            info.sample_accession = str_to_accession(c("Sample"))
        if c("Study") != "-":
            info.study_accession = str_to_accession(c("Study"))
        if c("Center") != "-":
            info.sample_attributes["Center"] = c("Center")
        db.append(info)
    if cols_index is None:
        raise ValueError("no SRA_Accessions table found in metadata archive")
    return db


def _merge_xml(db, sample_attributes, xml_info, counters) -> None:
    """Fold accumulated XML annotations into the run records
    (sra_inventory.cpp:969-1080)."""
    for r in db:
        x = xml_info.get(r.experiment_accession)
        if r.experiment_accession != INVALID_ACCESSION and x is not None:
            updated = False
            if not x.valid and r.valid:
                r.valid = False
                updated = True
            for var in (
                "experiment_title", "experiment_library_name",
                "experiment_library_strategy", "experiment_library_source",
                "experiment_library_selection", "experiment_instrument_model",
            ):
                val = getattr(x, var)
                if val:
                    setattr(r, var, val)
                    updated = True
            if updated:
                counters["experiment"] += 1

        s = xml_info.get(r.sample_accession)
        if r.sample_accession != INVALID_ACCESSION and s is not None:
            updated = False
            if s.sample_taxa:
                r.sample_taxa = s.sample_taxa
                updated = True
            if s.sample_attributes:
                local = sample_attributes.setdefault(r.sample_accession, {})
                local.update(s.sample_attributes)
            if updated:
                counters["sample"] += 1

        t = xml_info.get(r.study_accession)
        if r.study_accession != INVALID_ACCESSION and t is not None:
            updated = False
            for var in ("study_title", "study_abstract"):
                val = getattr(t, var)
                if val:
                    setattr(r, var, val)
                    updated = True
            if updated:
                counters["study"] += 1


def parse_sra_metadata(metadata_file: str, verbose: bool = True):
    """Both passes; returns (run records, per-sample attribute maps)."""
    log = (lambda *a, **k: print(*a, file=sys.stderr, **k)) if verbose else (lambda *a, **k: None)

    log("Parsing the tab-delimited tables ... ", end="")
    db = parse_sra_text(metadata_file)
    log(f"found {len(db)} SRA runs")

    log("Parsing the XML data ... ", end="")
    sample_attributes: dict[int, dict[str, str]] = {}
    xml_info: dict[int, FilterInfo] = {}
    counters = {"experiment": 0, "sample": 0, "study": 0}

    for filename, member_lines in iter_tar_members(metadata_file):
      ftype = sra_file_type(filename)
      if ftype not in (EXPERIMENT_XML, SAMPLE_XML, STUDY_XML):
          continue  # member skipped wholesale: no line splitting
      experiment = sample = study = INVALID_ACCESSION
      in_attribute = False
      attr_tag = ""
      if len(xml_info) >= MAX_NUM_XML:
          _merge_xml(db, sample_attributes, xml_info, counters)
          xml_info.clear()
      for line in member_lines:
        if ftype == EXPERIMENT_XML:
            if "<EXPERIMENT " in line:
                experiment = str_to_accession(parse_key_value(line, "accession"))
            for tag, var in (
                ("TITLE", "experiment_title"),
                ("DESIGN_DESCRIPTION", "experiment_design_description"),
                ("LIBRARY_NAME", "experiment_library_name"),
                ("LIBRARY_STRATEGY", "experiment_library_strategy"),
                ("LIBRARY_SOURCE", "experiment_library_source"),
                ("LIBRARY_SELECTION", "experiment_library_selection"),
                ("INSTRUMENT_MODEL", "experiment_instrument_model"),
            ):
                if f"<{tag}>" in line:
                    if experiment == INVALID_ACCESSION:
                        raise ValueError(f"orphaned experiment {tag}")
                    setattr(
                        _xml_entry(xml_info, experiment),
                        var,
                        parse_xml_value(tag, line),
                    )
            if '<EXTERNAL_ID namespace="dbgap">' in line:
                if experiment == INVALID_ACCESSION:
                    raise ValueError("orphaned experiment dbgap id")
                _xml_entry(xml_info, experiment).valid = False
        elif ftype == SAMPLE_XML:
            if "<SAMPLE " in line:
                sample = str_to_accession(parse_key_value(line, "accession"))
            if "<SCIENTIFIC_NAME>" in line:
                if sample == INVALID_ACCESSION:
                    raise ValueError("orphaned sample scientific name")
                _xml_entry(xml_info, sample).sample_taxa = parse_xml_value(
                    "SCIENTIFIC_NAME", line
                )
            if "<SAMPLE_ATTRIBUTE>" in line:
                in_attribute = True
            if "</SAMPLE_ATTRIBUTE>" in line:
                in_attribute = False
            if in_attribute and "<TAG>" in line:
                attr_tag = parse_xml_value("TAG", line)
            if in_attribute and "<VALUE>" in line:
                value = parse_xml_value("VALUE", line)
                if not attr_tag and sample == INVALID_ACCESSION:
                    raise ValueError("orphaned sample attribute value")
                if attr_tag != "BioSampleModel":
                    _xml_entry(xml_info, sample).sample_attributes[attr_tag] = value
        elif ftype == STUDY_XML:
            if "<STUDY " in line:
                study = str_to_accession(parse_key_value(line, "accession"))
            if "<STUDY_TITLE>" in line:
                if study == INVALID_ACCESSION:
                    raise ValueError("orphaned study title")
                _xml_entry(xml_info, study).study_title = parse_xml_value(
                    "STUDY_TITLE", line
                )
            if "<STUDY_ABSTRACT>" in line:
                if study == INVALID_ACCESSION:
                    raise ValueError("orphaned study abstract")
                _xml_entry(xml_info, study).study_abstract = parse_xml_value(
                    "STUDY_ABSTRACT", line
                )

    _merge_xml(db, sample_attributes, xml_info, counters)
    log("done.")
    if db:
        n = len(db)
        log(f"Found XML annotation for:")
        log(f"\t{counters['experiment']} ({100.0 * counters['experiment'] / n:g}%) SRA runs by association with SRA experiments")
        log(f"\t{counters['sample']} ({100.0 * counters['sample'] / n:g}%) SRA runs by association with SRA samples")
        log(f"\t{len(sample_attributes)} ({100.0 * len(sample_attributes) / n:g}%) SRA sample records have attribute data (to be added later)")
        log(f"\t{counters['study']} ({100.0 * counters['study'] / n:g}%) SRA runs by association with SRA studies")
    return db, sample_attributes


@dataclass
class InventoryFilters:
    required_strategy: set[str] = field(default_factory=set)
    required_source: set[str] = field(default_factory=set)
    include_accessions: list[int] = field(default_factory=list)
    begin_date: Date = field(default_factory=Date)
    end_date: Date = field(default_factory=lambda: Date(31, 12, 9999))


def apply_filters(db: list[FilterInfo], f: InventoryFilters, verbose: bool = True) -> list[FilterInfo]:
    """Source/strategy/date/include filters + repack of valid records
    (sra_inventory.cpp:108-274)."""
    if f.required_source:
        for r in db:
            if r.experiment_library_source not in f.required_source:
                r.valid = False
    if f.required_strategy:
        for r in db:
            if r.experiment_library_strategy not in f.required_strategy:
                r.valid = False
    for r in db:
        if r.date_received < f.begin_date or r.date_received > f.end_date:
            r.valid = False
    if f.include_accessions:
        include = set(f.include_accessions)
        for r in db:
            if r.run_accession not in include:
                r.valid = False
    out = [r for r in db if r.valid]
    out.sort(key=lambda r: r.number_of_bases)
    return out


def build_inventory(
    metadata_file: str,
    output_file: str,
    filters: InventoryFilters | None = None,
    verbose: bool = True,
) -> int:
    """Full pipeline; returns the number of records written.

    When the native library is available the whole build (two tar.gz
    scans, annotation merges, filters, sort, codec) runs in C
    (kn_build_inventory) -- output byte-identical to this module's
    Python path on valid-UTF-8 archives (the native path passes member
    bytes through raw, like the reference; Python re-encodes via UTF-8
    with replacement characters on malformed input).
    """
    from ..io.binary import BinaryWriter
    from ..native import build_inventory_native
    import struct

    f = filters or InventoryFilters()
    native = build_inventory_native(
        metadata_file, output_file, f.required_strategy, f.required_source,
        f.include_accessions,
        (f.begin_date.day, f.begin_date.month, f.begin_date.year),
        (f.end_date.day, f.end_date.month, f.end_date.year))
    if native is not None:
        count, injected = native
        if verbose:
            print(f"Injected sample attribute data for {injected} SRA runs",
                  file=sys.stderr)
        return count

    db, sample_attributes = parse_sra_metadata(metadata_file, verbose)
    db = apply_filters(db, filters or InventoryFilters(), verbose)

    injected = 0
    with open(output_file, "wb") as fout:
        fout.write(struct.pack("<Q", len(db)))
        w = BinaryWriter(fout)
        for info in db:
            attrs = sample_attributes.get(info.sample_accession)
            if attrs:
                merged = dict(info.sample_attributes)
                merged.update(attrs)
                info.sample_attributes = merged
                injected += 1
            w.filter_info(info)
    if verbose:
        print(f"Injected sample attribute data for {injected} SRA runs", file=sys.stderr)
    return len(db)

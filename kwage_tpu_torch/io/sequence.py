"""FASTA/FASTQ sequence reader (plain or gzip), matching parse_sequence.cpp.

File type is detected from the extension (.fna/.fa/.fasta[.gz] -> FASTA,
.fastq[.gz] -> FASTQ, parse_sequence.cpp:13-26). Deflines are returned with
the leading '>'/'@' and leading whitespace stripped; sequence characters are
upper-cased and whitespace is removed.
"""

from __future__ import annotations

import gzip
from typing import Iterator, TextIO

FASTA = 0
FASTQ = 1
UNKNOWN_SEQUENCE = 2

_FASTA_EXTS = (".fna", ".fna.gz", ".fa", ".fa.gz", ".fasta", ".fasta.gz")
_FASTQ_EXTS = (".fastq", ".fastq.gz")
# The one canonical sequence-extension set (the reference's
# allowed_sequence_extentions, options.cpp:22-28; .fq is NOT accepted).
SEQUENCE_EXTS = _FASTA_EXTS + _FASTQ_EXTS


def reference_ext_match(path: str, ext: str) -> bool:
    """The reference's extension test (file_util.cpp find_file_extension):
    the FIRST case-insensitive occurrence of ``ext`` anywhere in the path
    must end the string. Consequence (mirrored deliberately at the
    USER-FACING gates -- CLI -d/-i arguments -- where the reference
    applies it): a file whose DIRECTORY path contains the same extension
    earlier never matches, e.g. '/runs.db/sra.1.db' is not a database.
    Engine-internal routing (parser selection for resolver-verified
    files) uses plain suffix matching instead -- those paths have no
    reference analog to mirror. Live-oracle test pins the gate quirk."""
    lp = path.lower()
    loc = lp.find(ext.lower())
    return loc >= 0 and loc + len(ext) == len(lp)


def reference_sequence_gate(path: str) -> bool:
    """The kwage CLI's -i extension gate (options.cpp:161 with the quirky
    matcher). True = the reference would accept this query file name."""
    return any(reference_ext_match(path, e) for e in SEQUENCE_EXTS)


def get_file_type(filename: str) -> int:
    """FASTA/FASTQ/UNKNOWN parser selection from the filename suffix
    (parse_sequence.cpp:13-26's extension set; robust suffix matching --
    see reference_ext_match for where the quirky gate applies)."""
    lower = filename.lower()
    if lower.endswith(_FASTA_EXTS):
        return FASTA
    if lower.endswith(_FASTQ_EXTS):
        return FASTQ
    return UNKNOWN_SEQUENCE


def _open_text(filename: str) -> TextIO:
    if filename.endswith(".gz"):
        return gzip.open(filename, "rt")
    return open(filename, "rt")


def _iter_fasta(f: TextIO) -> Iterator[tuple[str, str]]:
    defline = ""
    chunks: list[str] = []
    for line in f:
        if ">" in line:
            seq = "".join(chunks)
            if seq:  # empty records are skipped, like the FASTQ path
                yield defline, seq
            chunks = []
            defline = line.strip().lstrip(">").lstrip()
        else:
            chunks.append("".join(line.split()).upper())
    seq = "".join(chunks)
    if seq:
        yield defline, seq


def _iter_fastq(f: TextIO) -> Iterator[tuple[str, str]]:
    while True:
        header = f.readline()
        if not header:
            return
        defline = header.strip().lstrip("@").lstrip()
        seq = f.readline()
        if not seq:
            raise ValueError("truncated FASTQ record: missing sequence")
        plus = f.readline()
        if not plus:
            raise ValueError("truncated FASTQ record: missing '+'")
        qual = f.readline()
        if not qual:
            raise ValueError("truncated FASTQ record: missing quality")
        seq = "".join(seq.split()).upper()
        if seq:
            yield defline, seq


def iter_sequences(filename: str) -> Iterator[tuple[str, str]]:
    """Yield (defline, sequence) records from a FASTA/FASTQ(.gz) file."""
    ftype = get_file_type(filename)
    if ftype == UNKNOWN_SEQUENCE:
        raise ValueError(f"unknown sequence file type: {filename}")
    with _open_text(filename) as f:
        it = _iter_fasta(f) if ftype == FASTA else _iter_fastq(f)
        yield from it


class SequenceIterator:
    """Stateful iterator mirroring the reference SequenceIterator API."""

    def __init__(self, filename: str):
        self._gen = iter_sequences(filename)
        self._cur: tuple[str, str] | None = None
        self._advance()

    def _advance(self) -> None:
        self._cur = next(self._gen, None)

    def __bool__(self) -> bool:
        return self._cur is not None

    def advance(self) -> None:
        self._advance()

    @property
    def seq(self) -> str:
        assert self._cur is not None
        return self._cur[1]

    @property
    def info(self) -> str:
        assert self._cur is not None
        return self._cur[0]

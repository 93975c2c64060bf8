"""Streaming line iterator over (gzipped) tar archives (the reference's
TarIterator, parse_tar.h:7-82): members are visited in archive order and
their contents exposed line by line, without extracting to disk."""

from __future__ import annotations

import tarfile
from typing import Iterator


def _iter_lines(fh, chunk_size: int = 1 << 20) -> Iterator[str]:
    """Chunked line splitting over a non-seekable stream member."""
    tail = b""
    while True:
        chunk = fh.read(chunk_size)
        if not chunk:
            break
        chunk = tail + chunk
        lines = chunk.split(b"\n")
        tail = lines.pop()
        for line in lines:
            yield line.rstrip(b"\r").decode("utf-8", errors="replace")
    if tail:
        yield tail.rstrip(b"\r").decode("utf-8", errors="replace")


def iter_tar_members(path: str) -> Iterator[tuple[str, Iterator[str]]]:
    """Yield (member_filename, line_iterator) per file member, in archive
    order. A member's lines may be left unconsumed -- the stream skips
    ahead -- so callers can reject members by name without paying for
    line splitting (the reference's find_extension gate,
    sra_inventory.cpp:1100-1137)."""
    with tarfile.open(path, mode="r|*") as tf:
        for member in tf:
            if not member.isfile():
                continue
            fh = tf.extractfile(member)
            if fh is None:
                continue
            yield member.name, _iter_lines(fh)


def iter_tar_lines(path: str) -> Iterator[tuple[str, str]]:
    """Yield (member_filename, line) pairs; lines have no trailing newline."""
    for name, lines in iter_tar_members(path):
        for line in lines:
            yield name, line


class TarIterator:
    """Stateful wrapper mirroring the reference API (filename() + *iter)."""

    def __init__(self, path: str):
        self._gen = iter_tar_lines(path)
        self._cur: tuple[str, str] | None = None
        self._advance()

    def _advance(self) -> None:
        self._cur = next(self._gen, None)

    def __bool__(self) -> bool:
        return self._cur is not None

    def advance(self) -> None:
        self._advance()

    @property
    def filename(self) -> str:
        assert self._cur is not None
        return self._cur[0]

    @property
    def line(self) -> str:
        assert self._cur is not None
        return self._cur[1]

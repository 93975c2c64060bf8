"""Direct NCBI VDB cursor streaming via ctypes (no toolkit subprocess).

The reference streams `.sra` records through the VDB C API
(SriRachA/sra_stream.cpp:90-413): resolve the accession's path type,
open the database's SEQUENCE table (or the flat table), create a cached
read cursor with READ + READ_LEN columns, and walk the row range calling
the per-read function once per FRAGMENT with (row id, 1-based subindex).
This module binds that exact call sequence against a real
``libncbi-vdb`` shared library when one is present; when it is not, the
engine falls back to the fasterq-dump pipe (sra_source.stream_accession)
which has the same yield contract.

Gating: ``available()`` is True when a library is found via
$KWAGE_VDB_LIB or ctypes.util.find_library("ncbi-vdb"). The KPathType
constants grew over ncbi-vdb releases (kfs/defs.h + kdb/manager.h);
defaults below match current releases and can be pinned with
$KWAGE_VDB_KPT_DATABASE / _TABLE / _PRERELEASE for older installs.

Error classification mirrors sra_stream.cpp:
  open/manager failures -> network (retryable); unknown path type ->
  controlled access; per-cell read failures retry MAX_RETRY times with a
  1 s sleep before becoming cell-data errors.
"""

from __future__ import annotations

import array
import ctypes
import ctypes.util
import os
import time
from dataclasses import dataclass

from .sra_source import (
    SRA_DOWNLOAD_ADD_COLUMN_READ_ERROR,
    SRA_DOWNLOAD_ADD_COLUMN_READ_LEN_ERROR,
    SRA_DOWNLOAD_CELL_DATA_ERROR,
    SRA_DOWNLOAD_CONTROLLED_ACCESS,
    SRA_DOWNLOAD_CREATE_CURSOR_ERROR,
    SRA_DOWNLOAD_CURSOR_OPEN_ERROR,
    SRA_DOWNLOAD_LIST_TABLE_ERROR,
    SRA_DOWNLOAD_NAME_LIST_ERROR,
    SRA_DOWNLOAD_NETWORK_FAILURE,
    SRA_DOWNLOAD_READ_FORMAT_ERROR,
    SRA_DOWNLOAD_VDB_ERROR,
    DownloadError,
)

MAX_RETRY = 3                      # sra_stream.cpp:37
DEFAULT_CURSOR_CACHE = 0           # sra_stream.cpp:69 (0 MB, tuned there)

# KPathType (kfs/defs.h) + KDB extensions (kdb/manager.h). kptAlias is a
# flag bit cleared before dispatch (sra_stream.cpp:111).
KPT_NOTFOUND = 0
KPT_ALIAS = 128
KPT_DATABASE = int(os.environ.get("KWAGE_VDB_KPT_DATABASE", "12"))
KPT_TABLE = int(os.environ.get("KWAGE_VDB_KPT_TABLE", "13"))
KPT_PRERELEASE_TBL = int(os.environ.get("KWAGE_VDB_KPT_PRERELEASE", "17"))

_LIB: "ctypes.CDLL | None | bool" = None  # False = probed and absent


def _find_lib_path() -> str | None:
    env = os.environ.get("KWAGE_VDB_LIB")
    if env:
        return env if os.path.exists(env) else None
    return ctypes.util.find_library("ncbi-vdb")


def _load():
    global _LIB
    if _LIB is None:
        path = _find_lib_path()
        if path is None:
            _LIB = False
        else:
            try:
                lib = ctypes.CDLL(path)
                _bind(lib)
                _LIB = lib
            except (OSError, AttributeError):
                # OSError: unloadable object; AttributeError: a loadable
                # library missing part of the REQUIRED cursor surface
                # (symbol-subset builds) -- both mean "not available",
                # detected at bind time rather than crashing at first use.
                _LIB = False
    return _LIB or None


def available() -> bool:
    """True when a loadable libncbi-vdb with the cursor API is present."""
    return _load() is not None


_REQUIRED = (
    "VDBManagerMakeRead", "VDBManagerPathType", "VDBManagerOpenDBRead",
    "VDBManagerOpenTableRead", "VDBManagerRelease",
    "VDatabaseOpenTableRead", "VDatabaseListTbl", "VDatabaseRelease",
    "VTableCreateCachedCursorRead", "VTableRelease",
    "VCursorAddColumn", "VCursorOpen", "VCursorIdRange",
    "VCursorCellDataDirect", "VCursorRelease",
    "KNamelistCount", "KNamelistGet", "KNamelistRelease",
)


def _bind(lib: ctypes.CDLL) -> None:
    for name in _REQUIRED:
        getattr(lib, name)  # raises AttributeError -> OSError path above
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    vp, vpp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    lib.VDBManagerMakeRead.restype = u32
    lib.VDBManagerMakeRead.argtypes = [vpp, vp]
    lib.VDBManagerPathType.restype = ctypes.c_int   # varargs: leave loose
    lib.VDBManagerRelease.restype = u32
    lib.VDBManagerRelease.argtypes = [vp]
    lib.VDBManagerOpenDBRead.restype = u32          # varargs
    lib.VDBManagerOpenTableRead.restype = u32       # varargs
    lib.VDatabaseOpenTableRead.restype = u32        # varargs
    lib.VDatabaseListTbl.restype = u32
    lib.VDatabaseListTbl.argtypes = [vp, vpp]
    lib.VDatabaseRelease.restype = u32
    lib.VDatabaseRelease.argtypes = [vp]
    lib.VTableCreateCachedCursorRead.restype = u32
    lib.VTableCreateCachedCursorRead.argtypes = [vp, vpp, ctypes.c_size_t]
    lib.VTableRelease.restype = u32
    lib.VTableRelease.argtypes = [vp]
    lib.VCursorAddColumn.restype = u32              # varargs
    lib.VCursorOpen.restype = u32
    lib.VCursorOpen.argtypes = [vp]
    lib.VCursorIdRange.restype = u32
    lib.VCursorIdRange.argtypes = [
        vp, u32, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(u64)
    ]
    lib.VCursorCellDataDirect.restype = u32
    lib.VCursorCellDataDirect.argtypes = [
        vp, ctypes.c_int64, u32, ctypes.POINTER(u32), vpp,
        ctypes.POINTER(u32), ctypes.POINTER(u32),
    ]
    lib.VCursorRelease.restype = u32
    lib.VCursorRelease.argtypes = [vp]
    lib.KNamelistCount.restype = u32
    lib.KNamelistCount.argtypes = [vp, ctypes.POINTER(u32)]
    lib.KNamelistGet.restype = u32
    lib.KNamelistGet.argtypes = [vp, u32, ctypes.POINTER(ctypes.c_char_p)]
    lib.KNamelistRelease.restype = u32
    lib.KNamelistRelease.argtypes = [vp]


def _retry_sleep() -> float:
    return float(os.environ.get("KWAGE_VDB_RETRY_SLEEP", "1.0"))


def _cell(lib, cur, row, col_id, status_on_fail):
    """VCursorCellDataDirect with the reference's per-call retry loop
    (sra_stream.cpp:281-308): MAX_RETRY 1 s sleeps before giving up."""
    elem_bits = ctypes.c_uint32()
    base = ctypes.c_void_p()
    boff = ctypes.c_uint32()
    row_len = ctypes.c_uint32()
    rc = lib.VCursorCellDataDirect(
        cur, row, col_id, ctypes.byref(elem_bits), ctypes.byref(base),
        ctypes.byref(boff), ctypes.byref(row_len))
    retry = 0
    while rc and retry < MAX_RETRY:
        time.sleep(_retry_sleep())
        rc = lib.VCursorCellDataDirect(
            cur, row, col_id, ctypes.byref(elem_bits), ctypes.byref(base),
            ctypes.byref(boff), ctypes.byref(row_len))
        retry += 1
    if rc:
        raise DownloadError(status_on_fail,
                            f"VCursorCellDataDirect failed for row {row}")
    return elem_bits.value, base, boff.value, row_len.value


def _stream_table(lib, tbl, rank: int, ntasks: int, flat: bool = False):
    """The cursor walk of stream_sra_db_seq (database SEQUENCE table,
    sra_stream.cpp:221-413: READ + READ_LEN columns, per-FRAGMENT yields
    with 1-based subindex) and stream_flat_seq (flat table,
    sra_stream.cpp:415-523: READ column only, whole read, subindex 0 --
    so flat-table TSV rows render without a ``.sub`` suffix)."""
    from .engine import assign_read_range

    cur = ctypes.c_void_p()
    if lib.VTableCreateCachedCursorRead(
            tbl, ctypes.byref(cur), DEFAULT_CURSOR_CACHE):
        raise DownloadError(SRA_DOWNLOAD_CREATE_CURSOR_ERROR,
                            "VTableCreateCachedCursorRead failed")
    try:
        read_col = ctypes.c_uint32()
        if lib.VCursorAddColumn(cur, ctypes.byref(read_col), b"READ"):
            raise DownloadError(SRA_DOWNLOAD_ADD_COLUMN_READ_ERROR,
                                "VCursorAddColumn(READ) failed")
        len_col = ctypes.c_uint32()
        if not flat:
            if lib.VCursorAddColumn(cur, ctypes.byref(len_col), b"READ_LEN"):
                raise DownloadError(SRA_DOWNLOAD_ADD_COLUMN_READ_LEN_ERROR,
                                    "VCursorAddColumn(READ_LEN) failed")
        if lib.VCursorOpen(cur):
            raise DownloadError(SRA_DOWNLOAD_CURSOR_OPEN_ERROR,
                                "VCursorOpen failed")
        first = ctypes.c_int64()
        count = ctypes.c_uint64()
        if lib.VCursorIdRange(cur, read_col, ctypes.byref(first),
                              ctypes.byref(count)) or first.value < 0:
            raise DownloadError(SRA_DOWNLOAD_VDB_ERROR,
                                "VCursorIdRange failed")
        start, stop = assign_read_range(
            first.value, count.value, rank, ntasks)
        for row in range(start, stop):
            elem_bits, base, boff, seq_len = _cell(
                lib, cur, row, read_col.value, SRA_DOWNLOAD_CELL_DATA_ERROR)
            if elem_bits != 8 or boff != 0:
                raise DownloadError(SRA_DOWNLOAD_READ_FORMAT_ERROR,
                                    f"READ cell format row {row}")
            seq = ctypes.string_at(base, seq_len).decode("ascii", "replace")
            if flat:
                yield row, 0, seq  # no sub-read (sra_stream.cpp:505)
                continue
            elem_bits, lbase, boff, n_frag = _cell(
                lib, cur, row, len_col.value, SRA_DOWNLOAD_CELL_DATA_ERROR)
            if elem_bits != 32 or boff != 0:
                raise DownloadError(SRA_DOWNLOAD_READ_FORMAT_ERROR,
                                    f"READ_LEN cell format row {row}")
            lens = ctypes.cast(
                lbase, ctypes.POINTER(ctypes.c_uint32 * n_frag)
            ).contents[:] if n_frag else []
            # Per-fragment split (sra_stream.cpp:358-377): 1-based
            # subindex; fastq_iter.c semantics allow sum(lens) != len.
            pos = 0
            for i, flen in enumerate(lens):
                yield row, i + 1, seq[pos:pos + flen]
                pos += flen
    finally:
        lib.VCursorRelease(cur)


def _db_table_names(lib, db) -> set[bytes]:
    """The database's table-name set (sra_stream.cpp:145-162,213-218)."""
    kl = ctypes.c_void_p()
    if lib.VDatabaseListTbl(db, ctypes.byref(kl)):
        raise DownloadError(SRA_DOWNLOAD_LIST_TABLE_ERROR,
                            "VDatabaseListTbl failed")
    try:
        n = ctypes.c_uint32()
        if lib.KNamelistCount(kl, ctypes.byref(n)):
            raise DownloadError(SRA_DOWNLOAD_NAME_LIST_ERROR,
                                "KNamelistCount failed")
        names: set[bytes] = set()
        for i in range(n.value):
            name = ctypes.c_char_p()
            if lib.KNamelistGet(kl, i, ctypes.byref(name)):
                raise DownloadError(SRA_DOWNLOAD_NAME_LIST_ERROR,
                                    "KNamelistGet failed")
            names.add(name.value)
        return names
    finally:
        lib.KNamelistRelease(kl)


def _db_has_sequence_table(lib, db) -> bool:
    """contains(tables, "SEQUENCE") (sra_stream.cpp:145-162,213-218)."""
    return b"SEQUENCE" in _db_table_names(lib, db)


def _open_manager(lib) -> "ctypes.c_void_p":
    mgr = ctypes.c_void_p()
    if lib.VDBManagerMakeRead(ctypes.byref(mgr), None):
        raise DownloadError(SRA_DOWNLOAD_NETWORK_FAILURE,
                            "VDBManagerMakeRead failed")
    return mgr


def _resolve_path_type(lib, mgr, acc: bytes) -> int:
    """PathType with the kptNotFound retry loop (sra_stream.cpp:113-130)."""
    path_type = lib.VDBManagerPathType(mgr, b"%s", acc) & ~KPT_ALIAS
    retry = 0
    while path_type == KPT_NOTFOUND and retry < MAX_RETRY:
        time.sleep(_retry_sleep())
        path_type = lib.VDBManagerPathType(mgr, b"%s", acc) & ~KPT_ALIAS
        retry += 1
    return path_type


def stream_accession_vdb(accession: str, rank: int = 0, ntasks: int = 1):
    """Yield (read_index, read_subindex, seq) per fragment straight off
    VDB cursors -- the reference's sra_stream() dispatch
    (sra_stream.cpp:90-211): path type (with kptNotFound retries), then
    database/SEQUENCE-table or flat-table cursor streaming. Raises
    DownloadError with the reference's status classes."""
    lib = _load()
    if lib is None:
        raise DownloadError(SRA_DOWNLOAD_VDB_ERROR, "libncbi-vdb not found")

    mgr = _open_manager(lib)
    try:
        acc = accession.encode()
        path_type = _resolve_path_type(lib, mgr, acc)

        if path_type == KPT_DATABASE:
            db = ctypes.c_void_p()
            if lib.VDBManagerOpenDBRead(mgr, ctypes.byref(db), None,
                                        b"%s", acc):
                raise DownloadError(SRA_DOWNLOAD_NETWORK_FAILURE,
                                    "VDBManagerOpenDBRead failed")
            try:
                if not _db_has_sequence_table(lib, db):
                    raise DownloadError(SRA_DOWNLOAD_VDB_ERROR,
                                        "no SEQUENCE table")
                tbl = ctypes.c_void_p()
                if lib.VDatabaseOpenTableRead(db, ctypes.byref(tbl),
                                              b"%s", b"SEQUENCE"):
                    raise DownloadError(SRA_DOWNLOAD_NETWORK_FAILURE,
                                        "VDatabaseOpenTableRead failed")
                try:
                    yield from _stream_table(lib, tbl, rank, ntasks)
                finally:
                    lib.VTableRelease(tbl)
            finally:
                lib.VDatabaseRelease(db)
        elif path_type in (KPT_TABLE, KPT_PRERELEASE_TBL):
            tbl = ctypes.c_void_p()
            if lib.VDBManagerOpenTableRead(mgr, ctypes.byref(tbl), None,
                                           b"%s", acc):
                raise DownloadError(SRA_DOWNLOAD_NETWORK_FAILURE,
                                    "VDBManagerOpenTableRead failed")
            try:
                yield from _stream_table(lib, tbl, rank, ntasks, flat=True)
            finally:
                lib.VTableRelease(tbl)
        else:
            # Invalid path type: most likely an unauthorized record
            # (sra_stream.cpp:200-204).
            raise DownloadError(SRA_DOWNLOAD_CONTROLLED_ACCESS,
                                f"path type {path_type} for {accession}")
    finally:
        lib.VDBManagerRelease(mgr)


@dataclass
class BloomStreamProgress:
    """The ingest counters of the reference's BloomProgress
    (make_bloom.h; updated make_bloom.cpp:181-299). Maestro's worker uses
    them to detect the aligned-colorspace failure signature -- all
    primary alignments read, unaligned reads known to exist but none
    read -- and retry with force_unaligned (worker_main.cpp:301-310)."""

    num_primary_align: int = 0
    curr_primary_align: int = 0
    num_unaligned_read: int = 0
    curr_unaligned_read: int = 0
    num_read: int = 0
    curr_read: int = 0
    num_bp: int = 0


def _open_db_table(lib, db, name: bytes):
    tbl = ctypes.c_void_p()
    if lib.VDatabaseOpenTableRead(db, ctypes.byref(tbl), b"%s", name):
        raise DownloadError(SRA_DOWNLOAD_NETWORK_FAILURE,
                            f"VDatabaseOpenTableRead({name.decode()}) failed")
    return tbl


def _make_cursor(lib, tbl, columns: list[bytes]) -> tuple:
    """Cached cursor + column ids + READ-column row range."""
    cur = ctypes.c_void_p()
    if lib.VTableCreateCachedCursorRead(
            tbl, ctypes.byref(cur), DEFAULT_CURSOR_CACHE):
        raise DownloadError(SRA_DOWNLOAD_CREATE_CURSOR_ERROR,
                            "VTableCreateCachedCursorRead failed")
    try:
        ids = []
        for col in columns:
            cid = ctypes.c_uint32()
            if lib.VCursorAddColumn(cur, ctypes.byref(cid), col):
                raise DownloadError(SRA_DOWNLOAD_ADD_COLUMN_READ_ERROR,
                                    f"VCursorAddColumn({col.decode()}) failed")
            ids.append(cid.value)
        if lib.VCursorOpen(cur):
            raise DownloadError(SRA_DOWNLOAD_CURSOR_OPEN_ERROR,
                                "VCursorOpen failed")
        first = ctypes.c_int64()
        count = ctypes.c_uint64()
        if lib.VCursorIdRange(cur, ids[0], ctypes.byref(first),
                              ctypes.byref(count)) or first.value < 0:
            raise DownloadError(SRA_DOWNLOAD_VDB_ERROR, "VCursorIdRange failed")
        return cur, ids, first.value, count.value
    except DownloadError:
        lib.VCursorRelease(cur)
        raise


def _stream_primary_alignments(lib, tbl, progress: BloomStreamProgress):
    """Walk the PRIMARY_ALIGNMENT table's READ column -- the clipped
    aligned bases ngs::Alignment::getAlignedFragmentBases returns -- one
    sequence per alignment row (make_bloom.cpp:194-215)."""
    cur, (read_col,), first, count = _make_cursor(lib, tbl, [b"READ"])
    try:
        for row in range(first, first + count):
            elem_bits, base, boff, seq_len = _cell(
                lib, cur, row, read_col, SRA_DOWNLOAD_CELL_DATA_ERROR)
            if elem_bits != 8 or boff != 0:
                raise DownloadError(SRA_DOWNLOAD_READ_FORMAT_ERROR,
                                    f"READ cell format row {row}")
            seq = ctypes.string_at(base, seq_len).decode("ascii", "replace")
            progress.curr_primary_align += 1
            progress.num_bp += len(seq)
            yield seq
    finally:
        lib.VCursorRelease(cur)


def _stream_unaligned_reads(lib, tbl, progress: BloomStreamProgress):
    """The ngs::Read::unaligned category over the SEQUENCE table
    (make_bloom.cpp:217-258): spots NONE of whose fragments have a
    primary alignment, split per fragment. Two passes over one cursor:
    the PRIMARY_ALIGNMENT_ID column (cheap) picks the unaligned spot
    rows and fixes num_unaligned_read up front -- NGS knows the category
    count before reading any bases, which is what makes the
    aligned-colorspace failure signature (count > 0, none read)
    detectable (worker_main.cpp:301-310) -- then READ/READ_LEN stream
    only those rows. The unaligned mate of a partially-aligned spot is
    deliberately missed (make_bloom.cpp:174-178)."""
    cur, (read_col, len_col, pal_col), first, count = _make_cursor(
        lib, tbl, [b"READ", b"READ_LEN", b"PRIMARY_ALIGNMENT_ID"])
    try:
        # array('q'), not a Python list: 8 B/row id, so the up-front
        # unaligned-spot index stays bounded even for 10^8-spot runs.
        unaligned_rows = array.array("q")
        for row in range(first, first + count):
            elem_bits, base, boff, n_ids = _cell(
                lib, cur, row, pal_col, SRA_DOWNLOAD_CELL_DATA_ERROR)
            if elem_bits != 64 or boff != 0:
                raise DownloadError(SRA_DOWNLOAD_READ_FORMAT_ERROR,
                                    f"PRIMARY_ALIGNMENT_ID cell format row {row}")
            ids = ctypes.cast(
                base, ctypes.POINTER(ctypes.c_int64 * n_ids)
            ).contents[:] if n_ids else []
            if all(i == 0 for i in ids):
                unaligned_rows.append(row)
        progress.num_unaligned_read = len(unaligned_rows)
        for row in unaligned_rows:
            elem_bits, base, boff, seq_len = _cell(
                lib, cur, row, read_col, SRA_DOWNLOAD_CELL_DATA_ERROR)
            if elem_bits != 8 or boff != 0:
                raise DownloadError(SRA_DOWNLOAD_READ_FORMAT_ERROR,
                                    f"READ cell format row {row}")
            seq = ctypes.string_at(base, seq_len).decode("ascii", "replace")
            elem_bits, lbase, boff, n_frag = _cell(
                lib, cur, row, len_col, SRA_DOWNLOAD_CELL_DATA_ERROR)
            if elem_bits != 32 or boff != 0:
                raise DownloadError(SRA_DOWNLOAD_READ_FORMAT_ERROR,
                                    f"READ_LEN cell format row {row}")
            lens = ctypes.cast(
                lbase, ctypes.POINTER(ctypes.c_uint32 * n_frag)
            ).contents[:] if n_frag else []
            pos = 0
            for flen in lens:
                progress.num_bp += flen
                yield seq[pos:pos + flen]
                pos += flen
            progress.curr_unaligned_read += 1
    finally:
        lib.VCursorRelease(cur)


def stream_accession_bloom_vdb(
    accession: str,
    force_unaligned: bool = False,
    progress: BloomStreamProgress | None = None,
):
    """Yield bare sequences in the reference's Bloom ingest order
    (make_bloom.cpp:170-300).

    For runs whose PRIMARY_ALIGNMENT table is non-empty, the reference
    streams every primary alignment's aligned bases FIRST (minimizing
    random I/O), then the fragments of fully-unaligned spots. Runs with
    no alignments -- and any run under ``force_unaligned``, the
    aligned-colorspace fallback (worker_main.cpp:301-310) -- stream every
    spot per fragment in spot order. The conservative-update counting
    Bloom is order-sensitive, so reproducing this order (and content:
    alignment records, not raw spots) is required for bit-identical
    ``.bloom`` output on aligned accessions.

    ``progress`` (when given) is updated live so a caller that fails
    mid-stream can detect the colorspace signature and retry forced.
    """
    lib = _load()
    if lib is None:
        raise DownloadError(SRA_DOWNLOAD_VDB_ERROR, "libncbi-vdb not found")
    if progress is None:
        progress = BloomStreamProgress()

    mgr = _open_manager(lib)
    try:
        acc = accession.encode()
        path_type = _resolve_path_type(lib, mgr, acc)

        if path_type == KPT_DATABASE:
            db = ctypes.c_void_p()
            if lib.VDBManagerOpenDBRead(mgr, ctypes.byref(db), None,
                                        b"%s", acc):
                raise DownloadError(SRA_DOWNLOAD_NETWORK_FAILURE,
                                    "VDBManagerOpenDBRead failed")
            try:
                tables = _db_table_names(lib, db)
                if b"SEQUENCE" not in tables:
                    raise DownloadError(SRA_DOWNLOAD_VDB_ERROR,
                                        "no SEQUENCE table")
                aligned = False
                if b"PRIMARY_ALIGNMENT" in tables and not force_unaligned:
                    # Step 1 (make_bloom.cpp:181): getAlignmentCount --
                    # the table's row count decides the branch.
                    ptbl = _open_db_table(lib, db, b"PRIMARY_ALIGNMENT")
                    try:
                        cur, _ids, _f, n_align = _make_cursor(
                            lib, ptbl, [b"READ"])
                        lib.VCursorRelease(cur)
                        progress.num_primary_align = n_align
                        if n_align > 0:
                            aligned = True
                            yield from _stream_primary_alignments(
                                lib, ptbl, progress)
                    finally:
                        lib.VTableRelease(ptbl)
                stbl = _open_db_table(lib, db, b"SEQUENCE")
                try:
                    if aligned:
                        yield from _stream_unaligned_reads(
                            lib, stbl, progress)
                    else:
                        prev_row = None
                        for row, _sub, seq in _stream_table(
                                lib, stbl, 0, 1):
                            if row != prev_row:
                                progress.curr_read += 1
                                progress.num_read = progress.curr_read
                                prev_row = row
                            progress.num_bp += len(seq)
                            yield seq
                finally:
                    lib.VTableRelease(stbl)
            finally:
                lib.VDatabaseRelease(db)
        elif path_type in (KPT_TABLE, KPT_PRERELEASE_TBL):
            tbl = ctypes.c_void_p()
            if lib.VDBManagerOpenTableRead(mgr, ctypes.byref(tbl), None,
                                           b"%s", acc):
                raise DownloadError(SRA_DOWNLOAD_NETWORK_FAILURE,
                                    "VDBManagerOpenTableRead failed")
            try:
                for _row, _sub, seq in _stream_table(lib, tbl, 0, 1,
                                                     flat=True):
                    progress.curr_read += 1
                    progress.num_read = progress.curr_read
                    progress.num_bp += len(seq)
                    yield seq
            finally:
                lib.VTableRelease(tbl)
        else:
            raise DownloadError(SRA_DOWNLOAD_CONTROLLED_ACCESS,
                                f"path type {path_type} for {accession}")
    finally:
        lib.VDBManagerRelease(mgr)


# ---------------------------------------------------------------------------
# SRA metadata (KMetadata) -- counting-filter pre-sizing without reading
# any sequence data (sra_meta.cpp:17-122, itself based on sra-stat.c).
# ---------------------------------------------------------------------------

_META_REQUIRED = (
    "VDBManagerMakeSRASchema", "VSchemaRelease",
    "VTableOpenKTableRead", "KTableRelease",
    "KTableOpenMetadataRead", "KMetadataRelease",
    "KMetadataOpenNodeRead", "KMDataNodeOpenNodeRead",
    "KMDataNodeReadAsU64", "KMDataNodeRelease",
)

_META_BOUND: "set[int]" = set()


def _bind_meta(lib) -> bool:
    """Bind the KMetadata surface lazily; False when the library predates
    it (the cursor streaming API stays usable either way)."""
    if id(lib) in _META_BOUND:
        return True
    try:
        for name in _META_REQUIRED:
            getattr(lib, name)
    except AttributeError:
        return False
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    vp, vpp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    lib.VDBManagerMakeSRASchema.restype = u32
    lib.VDBManagerMakeSRASchema.argtypes = [vp, vpp]
    lib.VSchemaRelease.restype = u32
    lib.VSchemaRelease.argtypes = [vp]
    lib.VTableOpenKTableRead.restype = u32
    lib.VTableOpenKTableRead.argtypes = [vp, vpp]
    lib.KTableRelease.restype = u32
    lib.KTableRelease.argtypes = [vp]
    lib.KTableOpenMetadataRead.restype = u32
    lib.KTableOpenMetadataRead.argtypes = [vp, vpp]
    lib.KMetadataRelease.restype = u32
    lib.KMetadataRelease.argtypes = [vp]
    lib.KMetadataOpenNodeRead.restype = u32        # varargs: leave loose
    lib.KMDataNodeOpenNodeRead.restype = u32       # varargs
    lib.KMDataNodeReadAsU64.restype = u32
    lib.KMDataNodeReadAsU64.argtypes = [vp, ctypes.POINTER(u64)]
    lib.KMDataNodeRelease.restype = u32
    lib.KMDataNodeRelease.argtypes = [vp]
    _META_BOUND.add(id(lib))
    return True


def meta_available() -> bool:
    """True when libncbi-vdb is loadable AND exposes the KMetadata API."""
    lib = _load()
    return lib is not None and _bind_meta(lib)


def _read_stats_u64(lib, node, name: bytes) -> int:
    sub = ctypes.c_void_p()
    if lib.KMDataNodeOpenNodeRead(node, ctypes.byref(sub), b"%s", name):
        raise DownloadError(SRA_DOWNLOAD_VDB_ERROR,
                            f"KMDataNodeOpenNodeRead({name.decode()}) failed")
    try:
        val = ctypes.c_uint64()
        if lib.KMDataNodeReadAsU64(sub, ctypes.byref(val)):
            raise DownloadError(SRA_DOWNLOAD_VDB_ERROR,
                                f"KMDataNodeReadAsU64({name.decode()}) failed")
        return int(val.value)
    finally:
        lib.KMDataNodeRelease(sub)


def vdb_number_of_bases(accession: str) -> tuple[int, int]:
    """(BASE_COUNT, SPOT_COUNT) from the run's ``STATS/TABLE`` metadata
    node -- zero sequence data read (sra_meta.cpp:17-122): open the flat
    table with the SRA schema, falling back to database/SEQUENCE when the
    run is a database (the reference keys the fallback on
    rcTable/rcIncorrect; any open failure routes there here), then
    KTable -> KMetadata -> STATS/TABLE -> BASE_COUNT. SPOT_COUNT (also
    under STATS/TABLE, sra-stat.c) reads 0 when absent -- the reference
    only consumes BASE_COUNT. Raises DownloadError on any failure; the
    caller falls back to the sra-stat subprocess probe or to buffering."""
    lib = _load()
    if lib is None or not _bind_meta(lib):
        raise DownloadError(SRA_DOWNLOAD_VDB_ERROR,
                            "libncbi-vdb KMetadata API not available")
    mgr = _open_manager(lib)
    schema = ctypes.c_void_p()
    db = ctypes.c_void_p()
    vtbl = ctypes.c_void_p()
    ktbl = ctypes.c_void_p()
    meta = ctypes.c_void_p()
    node = ctypes.c_void_p()
    acc = accession.encode()
    try:
        if lib.VDBManagerMakeSRASchema(mgr, ctypes.byref(schema)):
            raise DownloadError(SRA_DOWNLOAD_VDB_ERROR,
                                "VDBManagerMakeSRASchema failed")
        if lib.VDBManagerOpenTableRead(mgr, ctypes.byref(vtbl), schema,
                                       b"%s", acc):
            # Not a flat table: database/SEQUENCE (sra_meta.cpp:42-55).
            if lib.VDBManagerOpenDBRead(mgr, ctypes.byref(db), schema,
                                        b"%s", acc):
                raise DownloadError(SRA_DOWNLOAD_NETWORK_FAILURE,
                                    "VDBManagerOpenDBRead failed")
            if lib.VDatabaseOpenTableRead(db, ctypes.byref(vtbl),
                                          b"%s", b"SEQUENCE"):
                raise DownloadError(SRA_DOWNLOAD_VDB_ERROR,
                                    "VDatabaseOpenTableRead failed")
        if lib.VTableOpenKTableRead(vtbl, ctypes.byref(ktbl)):
            raise DownloadError(SRA_DOWNLOAD_VDB_ERROR,
                                "VTableOpenKTableRead failed")
        if lib.KTableOpenMetadataRead(ktbl, ctypes.byref(meta)):
            raise DownloadError(SRA_DOWNLOAD_VDB_ERROR,
                                "KTableOpenMetadataRead failed")
        if lib.KMetadataOpenNodeRead(meta, ctypes.byref(node),
                                     b"%s", b"STATS/TABLE"):
            raise DownloadError(SRA_DOWNLOAD_VDB_ERROR,
                                "KMetadataOpenNodeRead(STATS/TABLE) failed")
        base_count = _read_stats_u64(lib, node, b"BASE_COUNT")
        try:
            spot_count = _read_stats_u64(lib, node, b"SPOT_COUNT")
        except DownloadError:
            spot_count = 0
        return base_count, spot_count
    finally:
        for handle, rel in (
            (node, lib.KMDataNodeRelease), (meta, lib.KMetadataRelease),
            (ktbl, lib.KTableRelease), (vtbl, lib.VTableRelease),
            (db, lib.VDatabaseRelease), (schema, lib.VSchemaRelease),
        ):
            if handle.value:
                rel(handle)
        lib.VDBManagerRelease(mgr)

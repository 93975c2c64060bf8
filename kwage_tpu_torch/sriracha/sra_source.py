"""SRA accession resolution + download-status vocabulary for sriracha.

The reference streams accessions through the NCBI VDB C API and
classifies failures with a 15-value SRADownloadStatus enum
(SriRachA/sra_stream.h:6-22); network-classed failures are retried up to
--retry times per rank (SriRachA/main.cpp:400-445). libncbi-vdb is not
available in this environment, so this engine resolves non-local
accessions through the SRA toolkit (``prefetch`` + ``fasterq-dump``)
when installed, with the same status vocabulary and retry
classification. Local FASTA/FASTQ paths bypass resolution entirely.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import threading

# SRADownloadStatus (sra_stream.h:6-22). Success must stay the smallest
# value: the reference reconciles ranks with Allreduce(MAX).
SRA_DOWNLOAD_SUCCESS = 0
SRA_DOWNLOAD_NETWORK_FAILURE = 1
SRA_DOWNLOAD_CONTROLLED_ACCESS = 2
SRA_DOWNLOAD_VDB_ERROR = 3
SRA_DOWNLOAD_LIST_TABLE_ERROR = 4
SRA_DOWNLOAD_READ_LENGTH_ERROR = 5
SRA_DOWNLOAD_CELL_DATA_ERROR = 6
SRA_DOWNLOAD_NAME_LIST_ERROR = 7
SRA_DOWNLOAD_ADD_COLUMN_READ_ERROR = 8
SRA_DOWNLOAD_ADD_COLUMN_READ_LEN_ERROR = 9
SRA_DOWNLOAD_CURSOR_OPEN_ERROR = 10
SRA_DOWNLOAD_READ_FORMAT_ERROR = 11
SRA_DOWNLOAD_CREATE_CURSOR_ERROR = 12
SRA_DOWNLOAD_DIR_ERROR = 13
SRA_DOWNLOAD_FILE_READ_ERROR = 14

STATUS_NAMES = {
    SRA_DOWNLOAD_SUCCESS: "success",
    SRA_DOWNLOAD_NETWORK_FAILURE: "network failure",
    SRA_DOWNLOAD_CONTROLLED_ACCESS: "controlled access",
    SRA_DOWNLOAD_VDB_ERROR: "VDB error",
    SRA_DOWNLOAD_DIR_ERROR: "directory error",
    SRA_DOWNLOAD_FILE_READ_ERROR: "file read error",
    SRA_DOWNLOAD_READ_FORMAT_ERROR: "read format error",
}


def is_retryable(status: int) -> bool:
    """Only network-classed failures retry (SriRachA/main.cpp:400-445)."""
    return status == SRA_DOWNLOAD_NETWORK_FAILURE


class DownloadError(OSError):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


from ..io.sequence import SEQUENCE_EXTS as _SEQ_EXT


def is_local_source(path: str) -> bool:
    return os.path.exists(path)


def _classify_stderr(stderr: str) -> int:
    """Map toolkit stderr onto the reference's status classes: errors that
    smell like connectivity are network failures (retryable,
    SriRachA/main.cpp:400-445); access denials are controlled-access."""
    err = (stderr or "").lower()
    if any(s in err for s in ("timeout", "connection", "network", "resolve")):
        return SRA_DOWNLOAD_NETWORK_FAILURE
    if "access" in err and ("denied" in err or "controlled" in err):
        return SRA_DOWNLOAD_CONTROLLED_ACCESS
    return SRA_DOWNLOAD_VDB_ERROR


def _find_fasterq() -> str:
    fasterq = shutil.which("fasterq-dump")
    if fasterq is None:
        raise DownloadError(
            SRA_DOWNLOAD_VDB_ERROR,
            "SRA toolkit (fasterq-dump) not found: provide local sequence "
            "files or install the toolkit",
        )
    return fasterq


def resolve_accession(accession: str, scratch: str | None = None) -> str:
    """Materialize an SRA accession as a local FASTQ via the SRA toolkit.

    Returns the path of the downloaded sequence file. Raises
    DownloadError with a classified status when the toolkit is missing
    or the fetch fails. Prefer stream_accession where the consumer can
    take a read stream: it needs no scratch at all.
    """
    fasterq = _find_fasterq()
    scratch = scratch or tempfile.mkdtemp(prefix=f"sriracha.{accession}.")
    os.makedirs(scratch, exist_ok=True)
    try:
        # --split-spot keeps each spot's mate fragments as separate
        # records, matching the reference's per-fragment READ_LEN split
        # (SriRachA/sra_stream.cpp:221-413) -- a chimeric k-mer spanning
        # a mate junction must never exist.
        proc = subprocess.run(
            [fasterq, "--split-spot", "-O", scratch, accession],
            capture_output=True,
            text=True,
            timeout=24 * 3600,
        )
    except subprocess.TimeoutExpired as e:
        # Classified network failure: the caller's retry loop engages.
        raise DownloadError(
            SRA_DOWNLOAD_NETWORK_FAILURE, f"fasterq-dump timed out for {accession}"
        ) from e
    if proc.returncode != 0:
        raise DownloadError(
            _classify_stderr(proc.stderr),
            proc.stderr.strip() or "fasterq-dump failed",
        )
    for name in sorted(os.listdir(scratch)):
        if name.startswith(accession) and name.endswith((".fastq", ".fasta")):
            return os.path.join(scratch, name)
    raise DownloadError(
        SRA_DOWNLOAD_FILE_READ_ERROR, f"no sequence output for {accession}"
    )


def stream_accession(accession: str, rank: int = 0, ntasks: int = 1):
    """Yield (read_index, read_subindex, sequence) per FRAGMENT straight
    off a fasterq-dump pipe.

    The streaming shape of the reference's VDB cursor path
    (SriRachA/sra_stream.cpp:90-211): reads flow into the consumer as
    they arrive, peak scratch usage is ZERO regardless of accession size
    (no .sra staging, no FASTQ materialization). --split-spot keeps each
    spot's mate fragments as separate records, so the per-fragment
    callback semantics of the reference's READ_LEN split hold exactly
    (sra_stream.cpp:358-377: per_read_function(seq, index, i + 1)):
    read_index is the 1-based spot row id, read_subindex the 1-based
    fragment ordinal within the spot. Consecutive records sharing a spot
    id (the header's first token, ``<accession>.<spot>``) are fragments
    of one spot; the trailing integer of that token carries the toolkit's
    own row id when present.

    stderr is drained by a background thread for the whole stream: a
    chatty toolkit that emits more than the ~64 KiB pipe buffer of
    progress/warnings must not deadlock the read loop. A nonzero toolkit
    exit raises a classified DownloadError -- after any partial yield,
    the caller's retry loop restarts the whole accession, matching the
    reference's per-accession retry (SriRachA/main.cpp:401-445).

    When libncbi-vdb is present (see sriracha/vdb.py), reads stream
    through direct VDB cursors instead of the toolkit pipe -- the
    reference's exact access path (sra_stream.cpp:90-413). Same yield
    contract, same status classification. Set KWAGE_NO_VDB=1 to force
    the pipe.
    """
    if os.environ.get("KWAGE_NO_VDB") != "1":
        from . import vdb

        if vdb.available():
            n = 0
            for item in vdb.stream_accession_vdb(accession, rank, ntasks):
                n += 1
                yield item
            if n == 0 and ntasks == 1:
                raise DownloadError(
                    SRA_DOWNLOAD_FILE_READ_ERROR,
                    f"no reads streamed for {accession}",
                )
            return
    if ntasks != 1:
        # The toolkit pipe cannot skip to a row range; sliced runs
        # without libncbi-vdb materialize instead (cli/sriracha.py).
        raise DownloadError(
            SRA_DOWNLOAD_VDB_ERROR,
            "sliced streaming requires libncbi-vdb (VCursorIdRange)",
        )
    fasterq = _find_fasterq()
    proc = subprocess.Popen(
        [fasterq, "--split-spot", "--stdout", accession],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )
    stderr_parts: list[str] = []
    drain = threading.Thread(
        target=lambda: stderr_parts.append(proc.stderr.read()), daemon=True
    )
    drain.start()
    n_frag = 0
    spot_idx = 0
    sub_idx = 0
    prev_key: str | None = None
    try:
        # fasterq-dump --stdout emits 4-line FASTQ records (2-line FASTA
        # with --fasta); one record per fragment under --split-spot.
        while True:
            header = proc.stdout.readline()
            if not header:
                break
            seq = proc.stdout.readline().strip()
            if header.startswith("@"):
                proc.stdout.readline()  # '+'
                proc.stdout.readline()  # quality
            elif not header.startswith(">"):
                raise DownloadError(
                    SRA_DOWNLOAD_READ_FORMAT_ERROR,
                    f"unexpected stream record for {accession}: {header[:40]!r}",
                )
            fields = header[1:].split(None, 1)
            key = fields[0] if fields else ""
            if key and key == prev_key:
                sub_idx += 1
            else:
                tail = key.rsplit(".", 1)[-1]
                spot_idx = int(tail) if tail.isdigit() else spot_idx + 1
                sub_idx = 1
                prev_key = key
            n_frag += 1
            yield spot_idx, sub_idx, seq
    finally:
        if proc.poll() is None:
            proc.kill()
        rc = proc.wait()
        drain.join()
        stderr = "".join(stderr_parts)
        proc.stdout.close()
        proc.stderr.close()
    if rc != 0:
        raise DownloadError(
            _classify_stderr(stderr), stderr.strip() or "fasterq-dump failed"
        )
    if n_frag == 0:
        raise DownloadError(
            SRA_DOWNLOAD_FILE_READ_ERROR, f"no reads streamed for {accession}"
        )

def stream_accession_bloom(
    accession: str,
    force_unaligned: bool = False,
    progress=None,
):
    """Yield bare read sequences in the reference's BLOOM ingest order
    (make_bloom.cpp:170-300): primary alignments first, then fully
    unaligned spots, for aligned runs; spot order otherwise.

    Requires libncbi-vdb for the aligned-run order/content (the
    PRIMARY_ALIGNMENT table is only reachable through the VDB API). The
    fasterq-dump pipe fallback streams spots in spot order -- correct
    content for unaligned runs, but NOT bit-identical to the reference
    for aligned runs (the conservative-update counting Bloom is
    order-sensitive). ``progress``, when given, must be a
    vdb.BloomStreamProgress; callers use it to detect the
    aligned-colorspace failure signature (worker_main.cpp:301-310).
    """
    if os.environ.get("KWAGE_NO_VDB") != "1":
        from . import vdb

        if vdb.available():
            yield from vdb.stream_accession_bloom_vdb(
                accession, force_unaligned=force_unaligned, progress=progress
            )
            return
    for _idx, _sub, seq in stream_accession(accession):
        if progress is not None:
            progress.curr_read += 1
            progress.num_read = progress.curr_read
            progress.num_bp += len(seq)
        yield seq

"""SRA toolkit repository discovery (the reference's read_sra_repository,
file_io.cpp:120-199): parse ``~/.ncbi/user-settings.mkfg`` for the
``/repository/user/main/public/root`` key and return the ``<root>/sra``
directory where ``prefetch`` stages ``.sra`` files.
"""

from __future__ import annotations

import os

REPOSITORY_KEY = "/repository/user/main/public/root"


def read_sra_repository(config_path: str | None = None) -> str | None:
    """The prefetch staging directory (``<root>/sra``), or None when the
    toolkit config is absent or malformed (the caller falls back to an
    explicit directory, like the reference falls back to an error)."""
    if config_path is None:
        home = os.environ.get("HOME", "")
        config_path = os.path.join(home, ".ncbi", "user-settings.mkfg")
    try:
        with open(config_path) as f:
            lines = f.readlines()
    except OSError:
        return None

    for line in lines:
        pos = line.find(REPOSITORY_KEY)
        if pos < 0:
            continue
        rest = line[pos + len(REPOSITORY_KEY):].strip()
        if not rest.startswith("="):
            return None
        rest = rest[1:].strip()
        # Value is a double-quoted path (trailing whitespace tolerated).
        if len(rest) < 2 or rest[0] != '"' or rest[-1] != '"':
            return None
        root = rest[1:-1]
        # The repository root holds files/ nannot/ refseq/ sra/ wgs/;
        # downloads land under sra/.
        return os.path.join(root, "sra")
    return None

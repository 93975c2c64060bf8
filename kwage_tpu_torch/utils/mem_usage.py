"""Fraction of physical RAM in use (the reference's mem_usage.h/.cpp).

Workers piggyback this figure on every task completion so the scheduler
can watch for leaks across long runs (worker_main.cpp:141, ChangeLog.md:16).
"""

from __future__ import annotations

import os


def memory_usage() -> float:
    """Fraction of physical memory currently used, in [0, 1].

    Linux: derived from /proc/meminfo (MemTotal - MemAvailable).
    Elsewhere (or on error): 0.0, matching the reference's unsupported-OS
    fallback.
    """
    try:
        fields: dict[str, int] = {}
        with open("/proc/meminfo") as f:
            for line in f:
                name, _, rest = line.partition(":")
                parts = rest.split()
                if parts:
                    fields[name] = int(parts[0])  # kB
        total = fields.get("MemTotal", 0)
        avail = fields.get(
            "MemAvailable", fields.get("MemFree", 0) + fields.get("Cached", 0)
        )
        if total <= 0:
            return 0.0
        return max(0.0, min(1.0, (total - avail) / total))
    except OSError:
        return 0.0

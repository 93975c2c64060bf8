"""Small host-side utilities (memory accounting, profiling helpers,
device selection)."""

from .mem_usage import memory_usage
from .profiling import device_trace, report, reset, scope

__all__ = ["memory_usage", "scope", "report", "reset", "device_trace"]

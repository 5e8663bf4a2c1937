"""Host-side helpers: xyz file I/O, logging, timing, device routing and
counted flag reads."""

from .xyz_io import read_xyz, write_xyz
from .log import get_logger, enable_verbose_logging
from .device_policy import resolve_device, estimate_cpu_seconds

__all__ = [
    "read_xyz", "write_xyz", "get_logger", "enable_verbose_logging",
    "resolve_device", "estimate_cpu_seconds",
]

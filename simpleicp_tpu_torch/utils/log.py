"""Logging of the class API and the CLI.

The printed lines are the reference simpleICP's output contract: stage
banners, an iteration table with an ``orig:0`` row, the 4x4 H in %12.6f,
the parameter table, and ``Finished in N.NNN seconds!``, which benchmark
harnesses parse. The package logs under its own name and emits nothing
unless the application opts in: ``enable_verbose_logging`` attaches one
message-only stream handler (standard error, as in the JAX package),
however often it is called.
"""

from __future__ import annotations

import logging
import os

_PACKAGE = "simpleicp_tpu_torch"


def get_logger(name: str = _PACKAGE) -> logging.Logger:
    return logging.getLogger(name)


def enable_verbose_logging() -> None:
    """Attach a message-only stream handler at INFO level. Idempotent:
    repeated calls (several SimpleICP(verbose=True) instances) do not stack
    handlers. SIMPLEICP_TPU_DEBUG_TIMING=1 raises the level to DEBUG, which
    adds the 'timing:' lines of each phase; the INFO lines stay the same."""
    pkg_log = logging.getLogger(_PACKAGE)
    pkg_log.setLevel(
        logging.DEBUG if os.environ.get("SIMPLEICP_TPU_DEBUG_TIMING")
        else logging.INFO
    )
    if any(getattr(h, "_simpleicp_verbose", False) for h in pkg_log.handlers):
        return
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(message)s"))
    handler._simpleicp_verbose = True
    pkg_log.addHandler(handler)

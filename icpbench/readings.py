"""What a metric's reader (``icpbench/metrics/<name>.py``) reads: one
run's set-up, its window and, in a traced run, its profile."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Readings:
    icp: Dict
    n_fix: int
    n_mov: int
    pairs_per_call: int
    setup_s: float = 0.0
    window_seconds: float = 0.0
    window_pairs: int = 0
    window_host_reads: int = 0
    pair_latency_s: List[float] = field(default_factory=list)        # per pair: its call's
    window_iterations: List[int] = field(default_factory=list)       # per pair
    window_loop_iterations: List[int] = field(default_factory=list)  # per call
    # the traced run's profile (trace.py)
    traced_pairs: int = 0
    traced_iterations: List[int] = field(default_factory=list)       # per pair
    busy_s: float = 0.0
    traced_s: float = 0.0
    device_names: List[str] = field(default_factory=list)
    device_us: Optional[np.ndarray] = None                            # durations

    @property
    def device_ops(self) -> int:
        return len(self.device_names)

    def device_ms(self, *symbols: str) -> float:
        """Device milliseconds of the traced operations whose name holds
        any of ``symbols``."""
        if self.device_us is None:
            return 0.0
        hit = [i for i, n in enumerate(self.device_names) if any(s in n for s in symbols)]
        return float(self.device_us[hit].sum()) / 1e3

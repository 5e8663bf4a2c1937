"""The timed path: a closed loop of calls into the program's entry.

Each call registers one pair (``icp_register``) or a group of pairs
(``icp_register_batch``), and the next starts when the card has finished
the last: the users modelled are survey pipelines working through a queue
of pairs, each call waited on. The order of the calls is a permutation of
the pool drawn from the seed, cycled.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

import torch

from .pools import Pool
from .spec import ROOT, plugin

# The fields of a result the check reads, per pair.
FIELDS = ("H", "n_iterations", "converged", "error_code", "sel_idx", "sel_valid",
          "normals", "iter_stds")


@dataclass
class Window:
    """What the window did: per call its pairs (pool indices), its latency
    and its results (tensors on the device, each with a leading pair axis)."""
    calls: List[List[int]] = field(default_factory=list)
    latency_s: List[float] = field(default_factory=list)
    results: List[Dict[str, torch.Tensor]] = field(default_factory=list)
    seconds: float = 0.0
    host_reads: int = 0

    @property
    def pairs(self) -> int:
        return sum(len(c) for c in self.calls)


def groups(pool: Pool, traffic: Dict, seed: int) -> List[List[int]]:
    """The pool's calls, each a list of pool indices, in the seed's order:
    single pairs, or consecutive groups of ``pairs_per_call``."""
    per = int(traffic.get("pairs_per_call", 1))
    calls = [list(range(i, i + per)) for i in range(0, len(pool) - per + 1, per)]
    g = torch.Generator().manual_seed(seed % 2**63)
    return [calls[i] for i in torch.randperm(len(calls), generator=g).tolist()]


def entry(program, pool: Pool, traffic: Dict, cfg, device,
          root: Path = ROOT) -> Callable[[List[int]], Dict]:
    """fn(pairs) -> the result fields of one call of the traffic's entry
    (``icpbench/entries/<entry>.py``)."""
    return plugin("entries", traffic["entry"], root).make_call(program, pool, cfg, device,
                                                                FIELDS)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(call, order: List[List[int]], seconds: float, device, host_reads,
               min_pairs: int = 0) -> Window:
    """Calls in ``order``, cycled, until ``seconds`` have passed (and at
    least ``min_pairs`` pairs are registered); the last call started ends
    the window. ``host_reads()`` is the program's count of reads back to
    the host."""
    w = Window()
    _sync(device)
    reads0 = host_reads()
    t_start = time.perf_counter()
    i = 0
    while True:
        pairs = order[i % len(order)]
        t0 = time.perf_counter()
        out = call(pairs)
        _sync(device)
        t1 = time.perf_counter()
        w.calls.append(pairs)
        w.latency_s.append(t1 - t0)
        w.results.append(out)
        i += 1
        if t1 - t_start >= seconds and w.pairs >= min_pairs:
            break
    w.seconds = t1 - t_start
    w.host_reads = host_reads() - reads0
    return w

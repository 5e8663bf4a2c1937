"""The ICP loop's iteration as a cached CUDA graph.

On the card an iteration is a few hundred small operations, each a launch
the host dispatches while the card waits. ``models/icp.py`` runs the
iteration's body over static buffers that every registration of one shape
and configuration shares (a ``Graphed`` of this module's cache, keyed by
what the body's kernels bake in). A body that has no graph yet runs
eagerly once on the real data, as its warm-up, and is then captured on a
side stream; from then on each iteration is one replay of its graph. The
replay runs the same kernels on the same buffers, so its results are the
eager body's bit for bit.

A key earns an entry on its second sighting: the first runs eagerly and
the cache only notes the key (the last ``SEEN`` a device), so pairs whose
sizes change at every registration, or a process that registers one pair,
pay no capture and keep no buffers on the card. The cache keeps
``ENTRIES`` keys a device, least recently used out. An entry's lock keeps two threads from using its buffers at once, and an
event orders each user's work after the last one's, whatever streams they
launch on.

The kernel wrappers count their launches (``ops.LAUNCH_COUNTERS``) when
Python calls them. A capture runs the body's Python without launching
anything, so it leaves those counts as it found them, and each replay adds
what its graph launches.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Dict, Hashable, Optional

import torch

from ..ops import LAUNCH_COUNTERS
from ..utils.profiling import recording

# Keys a device kept at once. Each entry holds static copies of one
# registration's inputs, its movable cloud among them, and its loop state.
ENTRIES = 4

# Keys a device noted on their first sighting, least recently seen out.
SEEN = 64

_lock = threading.Lock()
_cache: Dict[torch.device, "collections.OrderedDict[Hashable, Graphed]"] = {}
_seen: Dict[torch.device, "collections.OrderedDict[Hashable, None]"] = {}


class Graphed:
    """A loop body over static buffers (``state``) and the CUDA graphs
    captured of it, one a variant (the first iteration's branches, or a
    later iteration's)."""

    def __init__(self, device: torch.device, state):
        self.device = device
        self.state = state
        self.graphs: Dict[Hashable, tuple] = {}
        self.lock = threading.Lock()
        self.done = None

    @contextlib.contextmanager
    def held(self):
        """The entry's static state, for one registration's loop: no other
        thread uses it meanwhile, and the card runs this user's work after
        the last user's."""
        with self.lock:
            stream = torch.cuda.current_stream(self.device)
            if self.done is None:
                self.done = torch.cuda.Event()
            else:
                stream.wait_event(self.done)
            try:
                yield self.state
            finally:
                self.done.record(stream)

    def run(self, variant: Hashable, body: Callable[[], None], counts: Dict[str, int]) -> None:
        """One iteration: a replay of the variant's graph, or, before it has
        one, ``body()`` run eagerly and then captured. Adds the iteration to
        ``counts`` (``replays`` or ``eager``; a capture to ``captures``). No
        capture is made while a profiler records: that iteration runs
        eagerly, and the next one tries again."""
        captured = self.graphs.get(variant)
        if captured is not None:
            graph, launched = captured
            graph.replay()
            for counter, added in launched:
                for name, n in added.items():
                    counter[name] += n
            counts["replays"] += 1
            return
        body()
        counts["eager"] += 1
        if not recording():
            self.graphs[variant] = _capture(self.device, body)
            counts["captures"] += 1


def _capture(device: torch.device, body: Callable[[], None]):
    """(the CUDA graph of ``body``, the launches a replay of it makes by
    counter), the counters left as they were."""
    before = [dict(c) for c in LAUNCH_COUNTERS]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph, capture_error_mode="thread_local"):
            body()
        launched = [(c, {k: c[k] - b[k] for k in c if c[k] != b[k]})
                    for c, b in zip(LAUNCH_COUNTERS, before)]
    finally:
        for c, b in zip(LAUNCH_COUNTERS, before):
            c.update(b)
    return graph, launched


def entry(device: torch.device, key: Hashable,
          make_state: Callable[[], object]) -> Optional[Graphed]:
    """The cached entry of ``key`` on ``device``, made from
    ``make_state()`` (its static buffers) when the key was seen before and
    has none; None on the key's first sighting, which the caller runs
    eagerly."""
    with _lock:
        entries = _cache.setdefault(device, collections.OrderedDict())
        found = entries.get(key)
        if found is None:
            seen = _seen.setdefault(device, collections.OrderedDict())
            if seen.pop(key, False) is False:
                seen[key] = None
                while len(seen) > SEEN:
                    seen.popitem(last=False)
                return None
            found = entries[key] = Graphed(device, make_state())
            while len(entries) > ENTRIES:
                entries.popitem(last=False)
        entries.move_to_end(key)
        return found


def clear() -> None:
    """Drop every cached entry (their graphs and buffers) and every noted
    key."""
    with _lock:
        _cache.clear()
        _seen.clear()

"""The least time of the overlap gate's kernels on an NVIDIA H100 SXM, from
the dilate gate's counters (``counters.py``): the band's exact sweeps
(the 1-NN kernel's d2-only mode, csrc/knn.cu ``nn1_*``) and the dilation
(csrc/dilate.cu ``dilate_kernel``).

Sweeps: as ``bounds.py`` counts a nearest-neighbour call, at its rates:
8 operations a (query, ref) pair over the float32 peak outside the tensor
cores, against each launch's query and ref coordinates read once and one
squared distance a query written, over the memory's bandwidth.

Dilation: one packed word is 32 cells along z; a stencil of n entries ORs
n shifted words into each output word, ``ceil((n - 1) / 2)`` three-input
LOP3 instructions, at one a lane a clock on 132 SMs x 64 INT32 lanes at
the 1.98 GHz boost clock; against the occupancy read once and each
stencil's grid written once. The classify runs the IN and the POSS stencil
in one launch, the band-ref compaction the POSS stencil again.
"""

from __future__ import annotations

from typing import Dict, Iterable

from .bounds import HBM_BYTES_PER_S, PEAK_FLOPS

INT32_LANE_OPS_PER_S = 132 * 64 * 1.98e9


def sweep_bound_ms(pairs: int, queries: int, refs: int, dtype_bytes: int = 4) -> float:
    """Least milliseconds of d2-only 1-NN launches that together take
    ``pairs`` (query, ref) pairs, ``queries`` queries and ``refs`` refs."""
    ops = 8.0 * pairs
    nbytes = dtype_bytes * (3 * (queries + refs) + queries)
    return 1e3 * max(ops / PEAK_FLOPS[dtype_bytes], nbytes / HBM_BYTES_PER_S)


def _lop3(entries: int) -> int:
    return max(0, -(-(entries - 1) // 2))


def dilate_bound_ms(n_words: int, in_offsets: int, poss_offsets: int,
                    dilations: int) -> float:
    """Least milliseconds of a dilate-gated registration's dilations: the
    classify's (IN and POSS), and the compaction's (POSS) where
    ``dilations`` is 2."""
    ops = n_words * (_lop3(in_offsets) + _lop3(poss_offsets))
    nbytes = 4 * n_words * 3
    if dilations > 1:
        ops += (dilations - 1) * n_words * _lop3(poss_offsets)
        nbytes += (dilations - 1) * 4 * n_words * 2
    return 1e3 * max(ops / INT32_LANE_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def gate_bounds_ms(counts: Iterable[Dict[str, int]]):
    """(sweeps, dilations): the least milliseconds of the sweeps and of the
    dilations over the registrations whose counters are ``counts``."""
    sweeps = dilate = 0.0
    for c in counts:
        sweeps += sweep_bound_ms(c["sweep_pairs"], c["sweep_queries"], c["sweep_refs"])
        dilate += dilate_bound_ms(c["n_words"], c["in_offsets"], c["poss_offsets"],
                                  c["dilations"])
    return sweeps, dilate

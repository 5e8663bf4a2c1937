"""The rooflines' bounds reproduce the port's kernel table (PERF.md)."""

import pytest

from icpbench.rooflines import bound_ms


@pytest.mark.parametrize("kernel, n_q, n_r, k, want", [
    ("match_transform", 1000, 100_000, 1, 0.0120),
    ("knn_search", 1000, 100_000, 10, 0.0119),
    ("match_transform", 1000, 1_340_000, 1, 0.160),
    ("knn_search", 1000, 1_340_000, 10, 0.160),
])
def test_bound_ms(kernel, n_q, n_r, k, want):
    ms, by = bound_ms(kernel, n_q, n_r, 4, k=k)
    assert round(ms, 4 if want < 0.1 else 3) == want
    assert by == "operations"


def test_bytes_bound_when_few_queries():
    assert bound_ms("knn_search", 1, 100_000, 4, k=10)[1] == "bytes"
    with pytest.raises(ValueError):
        bound_ms("dilate", 1, 1)

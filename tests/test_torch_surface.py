"""The port's import surface against the JAX package's: the subpackages'
re-exports, ``nn_search_auto``, ``resolve_match_method``, ``DEFAULT_RBP``
and ``utils/profiling.py``."""

import importlib
import json
import logging
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simpleicp_tpu.config as jcfg
import simpleicp_tpu.models.icp as jicp
import simpleicp_tpu.ops.knn as jk
import simpleicp_tpu.utils.profiling as jprof
import simpleicp_tpu_torch.config as tcfg
import simpleicp_tpu_torch.models.icp as ticp
import simpleicp_tpu_torch.ops.knn as tk
import simpleicp_tpu_torch.utils.profiling as tprof


@pytest.mark.parametrize("sub", ["ops", "utils", "models"])
def test_subpackage_all_parity(sub):
    """Every name of each JAX subpackage's ``__all__`` imports from the
    port's subpackage of the same name, which lists the same names."""
    jax_sub = importlib.import_module(f"simpleicp_tpu.{sub}")
    port_sub = importlib.import_module(f"simpleicp_tpu_torch.{sub}")
    assert sorted(port_sub.__all__) == sorted(jax_sub.__all__)
    for name in jax_sub.__all__:
        assert callable(getattr(port_sub, name)), name


def test_default_rbp():
    assert tcfg.DEFAULT_RBP == jcfg.DEFAULT_RBP
    assert len(tcfg.DEFAULT_RBP) == len(tcfg.RBP_NAMES)


def _cloud(rng, n):
    return rng.uniform(-1.0, 1.0, (n, 3))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_nn_search_auto_matches_jax(use_pallas, masked):
    """Indices bit-equal to the JAX function's (its lax kernel on the CPU),
    distances within float64 rounding (XLA fuses the sum of squares)."""
    rng = np.random.default_rng(11)
    Q, R = _cloud(rng, 300), _cloud(rng, 700)
    mask = rng.uniform(size=700) < 0.6 if masked else None
    d2_j, idx_j = jk.nn_search_auto(
        jnp.asarray(Q), jnp.asarray(R), ref_tile=128, query_tile=64, use_pallas=use_pallas,
        ref_mask=None if mask is None else jnp.asarray(mask))
    d2_t, idx_t = tk.nn_search_auto(
        torch.as_tensor(Q), torch.as_tensor(R), ref_tile=128, query_tile=64,
        use_pallas=use_pallas, ref_mask=None if mask is None else torch.as_tensor(mask))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-14, atol=0)
    d2_n, idx_n = tk.nn_search(torch.as_tensor(Q), torch.as_tensor(R),
                               ref_mask=None if mask is None else torch.as_tensor(mask))
    assert torch.equal(d2_t, d2_n) and torch.equal(idx_t, idx_n)


def test_nn_search_auto_without_refs():
    Q = torch.zeros((5, 3), dtype=torch.float64)
    for use_pallas in (True, False):
        d2, idx = tk.nn_search_auto(Q, torch.zeros((0, 3), dtype=torch.float64),
                                    use_pallas=use_pallas)
        assert torch.isinf(d2).all() and (idx == 0).all()


# The cases of tests/test_match_grid.py's resolve_match_method tests:
# (config fields, n_queries, n_mov).
RESOLVE_CASES = {
    "small": (dict(correspondences=1000, max_overlap_distance=1.0), 1000, 12_500_000),
    "big with radius": (dict(correspondences=100_000, max_overlap_distance=1.0),
                        100_000, 12_500_000),
    "big without radius": (dict(correspondences=100_000), 100_000, 12_500_000),
    "explicit grid": (dict(match_method="grid", match_radius=0.5), 100_000, 12_500_000),
    "explicit brute": (dict(match_method="brute"), 100_000, 12_500_000),
    "match radius": (dict(match_radius=0.5), 100_000, 12_500_000),
    "at the budget": (dict(max_overlap_distance=1.0), 1, 2**38),
    "above the budget": (dict(max_overlap_distance=1.0), 1, 2**38 + 1),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_resolve_match_method_matches_jax(case):
    kw, n_q, n_m = RESOLVE_CASES[case]
    got = ticp.resolve_match_method(tcfg.IcpConfig(**kw), n_q, n_m)
    want = jicp.resolve_match_method(jcfg.IcpConfig(**kw), n_q, n_m)
    assert got.match_method == want.match_method
    assert got == tcfg.IcpConfig(**{**kw, "match_method": want.match_method})
    assert ticp.MATCH_AUTO_PAIR_BUDGET == jicp.MATCH_AUTO_PAIR_BUDGET


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_stage_timer_matches_jax(monkeypatch):
    """The same stages on the same clock give the JAX timer's timings and
    report lines."""
    reports = []
    for mod in (jprof, tprof):
        ticks = iter(np.arange(0.0, 100.0, 0.25))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        timer = mod.StageTimer()
        for name in ("load", "register", "load", "write"):
            with timer.stage(name):
                pass
        logger = logging.getLogger(f"test_stage_timer.{mod.__name__}")
        logger.setLevel(logging.INFO)
        handler = _Lines()
        logger.addHandler(handler)
        try:
            timings = timer.report(logger)
        finally:
            logger.removeHandler(handler)
        reports.append((timings, handler.lines))
    assert reports[0] == reports[1]
    assert reports[1][0] == {"load": 0.5, "register": 0.25, "write": 0.25}


def test_trace_writes_a_chrome_trace(tmp_path, caplog):
    """trace() on the CPU writes one non-empty Chrome trace under logdir,
    which holds the profiled operators, and logs its path."""
    with caplog.at_level(logging.INFO, logger="simpleicp_tpu_torch.utils.profiling"):
        with tprof.trace(str(tmp_path / "prof")) as path:
            Q = torch.rand(64, 3, dtype=torch.float64)
            tk.nn_search(Q, torch.rand(200, 3, dtype=torch.float64))
    files = list((tmp_path / "prof").iterdir())
    assert [str(f) for f in files] == [path]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("argmin" in e.get("name", "") for e in events)
    assert any(path in r.getMessage() for r in caplog.records)

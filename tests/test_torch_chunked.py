"""Chunked dispatch in the port (``models/icp.py`` ``_run_chunked``,
``_plan_dispatch``, ``_knn_grid_normals``), on the CPU with the plain
versions, against the port's monolithic run and the JAX package.

Synthetic surfaces stand in for the JAX suite's dragon, bunny and
multisensor clouds. Tolerances:
* chunked against monolithic in the port: none, every ``IcpResult`` field
  and the last matches bit for bit (the loop body is the same; the chunk
  boundary only moves where its entry test is read);
* the port against the JAX package, float64: the tolerances of
  tests/test_torch_icp.py (integer decisions equal, H within 1e-9, normals
  within 1e-10, the residual statistics within 1e-8);
* the grid k-NN cascade in a registration or a preparation: bit-equal to
  the dense k-NN's (its branches: tests/test_torch_cascade.py).
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu import IcpConfig as JaxConfig
from simpleicp_tpu import icp_register as jax_register
from simpleicp_tpu_torch import IcpConfig, prepare_fixed
from simpleicp_tpu_torch.models import icp
from simpleicp_tpu_torch.utils import device_policy

F64 = dict(device="cpu", dtype=torch.float64)
_LOG = "simpleicp_tpu_torch.models.icp"


def _surface(rng, n, lo=-2.0, hi=2.0):
    xy = np.column_stack([rng.uniform(lo, hi, n), rng.uniform(-2, 2, n)])
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z])


def _pair(seed, n=4000, lo=-2.0, hi=2.0):
    """A fixed cloud and an independent sample of its surface (over x in
    [lo, hi]) shifted by a small motion."""
    rng = np.random.default_rng(seed)
    return _surface(rng, n), _surface(rng, n, lo, hi) - np.array([0.03, -0.02, 0.01])


def _chunked(cfg, k):
    return dataclasses.replace(cfg, dispatch="chunked", chunk_iterations=k)


def _run(X_fix, X_mov, cfg, plan=None, **kw):
    call = dict(rbp_observed_values=None, rbp_observation_weights=None,
                normals_fix=None, planarity_fix=None, planarity_mov=None,
                fixed_prep=None, device="cpu", dtype=torch.float64)
    call.update(kw)
    return icp._icp_register(X_fix, X_mov, cfg, plan=plan, **call)


def _same(a, b):
    """Equal shapes, dtypes and values, NaN where NaN (a frozen
    parameter's uncertainty)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])
    return torch.equal(a, b)


def _assert_bitequal(a, b):
    (ra, ca), (rb, cb) = a, b
    for f in ra._fields:
        assert _same(getattr(ra, f), getattr(rb, f)), f
    assert torch.equal(ca.m_idx, cb.m_idx)
    assert ca.it == cb.it


T = IcpConfig().max_iterations


@pytest.mark.parametrize("k", [1, 2, 3, T])
@pytest.mark.parametrize("solver", ["nonlinear", "linearized"])
def test_chunked_equals_monolithic(k, solver):
    """Ungated brute path, K iterations a chunk, both solvers."""
    X_fix, X_mov = _pair(901)
    cfg = IcpConfig(correspondences=300, solver=solver)
    mono = _run(X_fix, X_mov, cfg)
    assert int(mono[0].n_iterations) > 3
    _assert_bitequal(_run(X_fix, X_mov, _chunked(cfg, k)), mono)


@pytest.mark.parametrize("gate,dtype", [
    ("brute", torch.float32), ("brute", torch.float64), ("grid", torch.float32),
    ("grid", torch.float64), ("dilate", torch.float64)])
def test_chunked_equals_monolithic_gated(gate, dtype):
    """The three overlap gates, on a partial-overlap pair, in both dtypes
    (the dilate gate's plain dilation is slow on the CPU: float64 only)."""
    X_fix, X_mov = _pair(902, lo=-1.0, hi=3.0)
    cfg = IcpConfig(correspondences=300, max_overlap_distance=0.25, gate_method=gate)
    mono = _run(X_fix, X_mov, cfg, dtype=dtype)
    assert int(mono[0].error_code) == 0
    _assert_bitequal(_run(X_fix, X_mov, _chunked(cfg, 2), dtype=dtype), mono)


@pytest.mark.parametrize("tensor", [False, True])
def test_chunked_grid_matcher_builds_its_grid_once(monkeypatch, tensor):
    """The grid matcher's cell list is built once per registration, not
    once per chunk: one build with the cap counted on the host (a numpy
    movable cloud) or on the device (a tensor)."""
    from simpleicp_tpu_torch.ops import gridhash

    builds = []
    for mod in (icp, gridhash):
        orig = mod.build_sorted_grid

        def counted(*a, _orig=orig, **k):
            builds.append(1)
            return _orig(*a, **k)

        monkeypatch.setattr(mod, "build_sorted_grid", counted)
    X_fix, X_mov = _pair(903)
    if tensor:
        X_mov = torch.as_tensor(X_mov)
    cfg = IcpConfig(correspondences=300, max_overlap_distance=0.5, match_method="grid",
                    max_iterations=30)
    mono = _run(X_fix, X_mov, cfg)
    assert len(builds) == 1
    builds.clear()
    chunk = _run(X_fix, X_mov, _chunked(cfg, 1))
    assert len(builds) == 1 and chunk[1].it > 2
    _assert_bitequal(chunk, mono)


def test_chunked_prepared_fixed_side():
    X_fix, X_mov = _pair(904)
    cfg = IcpConfig(correspondences=300)
    prep = prepare_fixed(X_fix, cfg, **F64)
    mono = _run(X_fix, X_mov, cfg, fixed_prep=prep)
    _assert_bitequal(_run(X_fix, X_mov, _chunked(cfg, 2), fixed_prep=prep), mono)
    _assert_bitequal(mono, _run(X_fix, X_mov, cfg))


def test_chunked_frozen_observations_and_trajectory():
    """Frozen parameters and the recorded trajectory ride the carry across
    the chunk boundaries."""
    X_fix, X_mov = _pair(905, lo=-1.0, hi=3.0)
    obs = dict(rbp_observed_values=np.array([np.deg2rad(-0.5), 0, 0, 0, 0, 0]),
               rbp_observation_weights=np.array([np.inf, np.inf, 0, 0, 0, 0]))
    cfg = IcpConfig(correspondences=300, max_overlap_distance=0.5, record_trajectory=True)
    mono = _run(X_fix, X_mov, cfg, **obs)
    assert mono[0].iter_ps.shape == (T, 6)
    _assert_bitequal(_run(X_fix, X_mov, _chunked(cfg, 3), **obs), mono)


def test_chunked_no_overlap_runs_no_iteration():
    X_fix, _ = _pair(906, n=500)
    cfg = _chunked(IcpConfig(max_overlap_distance=0.1), 2)
    res, carry = _run(X_fix, X_fix + 100.0, cfg)
    assert int(res.error_code) == 1 and int(res.n_iterations) == 0 and not carry.go
    _assert_bitequal((res, carry), _run(X_fix, X_fix + 100.0,
                                        dataclasses.replace(cfg, dispatch="monolithic")))


def test_chunked_adds_no_host_read():
    """A chunk ends on the flag the loop reads after every iteration, so
    chunked dispatch reads nothing more than the monolithic run."""
    from simpleicp_tpu_torch.utils import sync

    X_fix, X_mov = _pair(907)
    cfg = IcpConfig(correspondences=300)
    reads = []
    for c in (cfg, _chunked(cfg, 1), _chunked(cfg, 2)):
        sync.reset_host_reads()
        _run(X_fix, X_mov, c)
        reads.append(sync.host_reads())
    assert reads[1] == reads[0] and reads[2] == reads[0]


@pytest.mark.parametrize("solver", ["nonlinear", "linearized"])
def test_chunked_matches_jax_chunked(solver):
    """Port chunked against the JAX package's chunked run, float64."""
    X_fix, X_mov = _pair(908, lo=-1.0, hi=3.0)
    kw = dict(correspondences=300, max_overlap_distance=0.5, solver=solver,
              dispatch="chunked", chunk_iterations=2, record_trajectory=True)
    j = jax_register(X_fix, X_mov, JaxConfig(**kw), dtype=jnp.float64)
    t, carry = _run(X_fix, X_mov, IcpConfig(**kw))
    J = {f: np.asarray(getattr(j, f)) for f in j._fields}
    n_it = int(J["n_iterations"])
    for f in ("n_iterations", "converged", "error_code", "sel_idx", "sel_valid",
              "iter_counts", "residual_mask", "orig_count", "iter_midx", "iter_masks"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), J[f], err_msg=f)
    np.testing.assert_array_equal(carry.m_idx.numpy(), J["iter_midx"][n_it - 1])
    for f, tol in (("H", 1e-9), ("p", 1e-9), ("iter_means", 1e-8), ("iter_stds", 1e-8),
                   ("residuals", 1e-8), ("normals", 1e-10), ("planarity", 1e-10),
                   ("uncertainties", 1e-7)):
        np.testing.assert_allclose(getattr(t, f).numpy(), J[f], rtol=0, atol=tol, err_msg=f)


@pytest.mark.parametrize("blk", [256, 384])
def test_split_prologue_knn_blocks_bitequal(blk):
    """knn_block splits the normals k-NN into query blocks (384 does not
    divide C = 1000); each row depends on its query alone."""
    X_fix, X_mov = _pair(909)
    cfg = IcpConfig(correspondences=1000)
    mono = _run(X_fix, X_mov, cfg)
    chunk = _run(X_fix, X_mov, cfg, plan=icp.DispatchPlan("chunked", 3, blk))
    _assert_bitequal(chunk, mono)


def test_grid_knn_prologue_in_a_chunked_run_bitequal(monkeypatch, caplog):
    """knn_grid routes the normals through the cascade (C = 4096, its
    floor; the card's k-NN rate lowered so that the grid plan is economical
    on this small cloud): the registration stays bit-equal to the dense
    one."""
    monkeypatch.setattr(device_policy, "GPU_KNN10_PAIRS_PER_SEC", 1e7)
    X_fix, X_mov = _pair(910, n=10_000)
    cfg = IcpConfig(correspondences=4096, max_iterations=20)
    mono = _run(X_fix, X_mov, cfg)
    with caplog.at_level(logging.DEBUG, _LOG):
        chunk = _run(X_fix, X_mov, cfg, plan=icp.DispatchPlan("chunked", 4, 2048, True))
    assert any("certified at r" in r.getMessage() for r in caplog.records)
    _assert_bitequal(chunk, mono)


# ---- the planner, against the JAX package's under equal rates ----

def _equal_rates(monkeypatch):
    from simpleicp_tpu.utils import device_policy as jax_policy

    for name, v in (("SWEEP_PAIRS", 1e8), ("KNN10_PAIRS", 1e7), ("GATHER_ELEMS", 1e8),
                    ("SORT_ELEMS", 2.5e7)):
        monkeypatch.setattr(jax_policy, f"TPU_{name}_PER_SEC", v)
        monkeypatch.setattr(device_policy, f"GPU_{name}_PER_SEC", v)


class _Planned(Exception):
    pass


def _jax_plan_line(monkeypatch, caplog, X_fix, X_mov, cfg):
    """The JAX planner's "dispatch plan:" line (or its ValueError), with the
    TPU backend faked and the run stopped right after the plan."""
    import jax

    from simpleicp_tpu.models import icp as jax_icp

    def stop(*a, **k):
        raise _Planned

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_icp, "_icp_run", stop)
    monkeypatch.setattr(jax_icp, "_icp_run_chunked", stop)
    caplog.clear()
    with caplog.at_level(logging.INFO, "simpleicp_tpu.models.icp"):
        try:
            jax_register(X_fix, X_mov, cfg, dtype=jnp.float64)
        except _Planned:
            pass
    monkeypatch.undo()
    return [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("dispatch plan:")]


PLANS = {
    "monolithic": (dict(program_budget_s=5.0), "monolithic", 0, 0, False),
    "chunked": (dict(program_budget_s=3.0), "chunked", 7, 0, False),
    "chunked_knn_grid": (dict(program_budget_s=2.0), "chunked", 4, 2048, True),
    "explicit_k": (dict(program_budget_s=3.0, chunk_iterations=5), "chunked", 5, 0, False),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_dispatch_equals_jax(name, monkeypatch, caplog):
    """Under equal rates the card planner (guarded) takes the JAX planner's
    decisions and logs its line: 4096 x 5000 points, brute matcher, k-NN
    2.05 s and 0.205 s an iteration at the rates set here."""
    kw, dispatch, K, blk, grid = PLANS[name]
    X_fix, X_mov = _pair(914, n=5000)
    _equal_rates(monkeypatch)
    jax_lines = _jax_plan_line(monkeypatch, caplog, X_fix, X_mov,
                               JaxConfig(correspondences=4096, match_method="brute", **kw))
    _equal_rates(monkeypatch)
    caplog.clear()
    with caplog.at_level(logging.INFO, _LOG):
        plan = icp._plan_dispatch(IcpConfig(correspondences=4096, match_method="brute", **kw),
                                  5000, 5000, guarded=True, has_normals=False, gate_pairs=0.0)
    port_lines = [r.getMessage() for r in caplog.records if r.name == _LOG]
    assert port_lines == jax_lines and len(port_lines) == 1
    assert plan == icp.DispatchPlan(dispatch, K if dispatch == "chunked" else 0, blk, grid)


@pytest.mark.parametrize("kw,match", [
    (dict(program_budget_s=1.0), "largest indivisible step"),
    (dict(program_budget_s=3.0, dispatch="monolithic"), "one monolithic run"),
])
def test_plan_dispatch_refusals(kw, match, monkeypatch, caplog):
    """The atom refusal and the monolithic-over-budget refusal raise
    ValueError in both packages."""
    X_fix, X_mov = _pair(915, n=5000)
    _equal_rates(monkeypatch)
    with pytest.raises(ValueError):
        _jax_plan_line(monkeypatch, caplog, X_fix, X_mov,
                       JaxConfig(correspondences=4096, match_method="brute", **kw))
    _equal_rates(monkeypatch)
    with pytest.raises(ValueError, match=match):
        icp._plan_dispatch(IcpConfig(correspondences=4096, match_method="brute", **kw),
                           5000, 5000, guarded=True, has_normals=False, gate_pairs=0.0)


def test_plan_dispatch_unguarded():
    """On the CPU (unguarded) "auto" is monolithic, and an explicit
    "chunked" without K takes 8 iterations a chunk."""
    cfg = IcpConfig(program_budget_s=1e-9)
    assert icp._plan_dispatch(cfg, 10**7, 10**7, guarded=False, has_normals=False,
                              gate_pairs=1e14) == icp.DispatchPlan("monolithic", 8)
    assert icp._plan_dispatch(dataclasses.replace(cfg, dispatch="chunked"), 10, 10,
                              guarded=False, has_normals=False,
                              gate_pairs=0.0) == icp.DispatchPlan("chunked", 8)


def test_prepare_fixed_split_knn_bitequal(monkeypatch, caplog):
    """prepare_fixed under a plan of query blocks and the cascade (the
    card's k-NN rate lowered as above) gives the one-call preparation bit
    for bit."""
    X, _ = _pair(916, n=10_000)
    cfg = IcpConfig(correspondences=4096)
    dense = prepare_fixed(X, cfg, **F64)
    monkeypatch.setattr(icp, "_plan_prepared_knn", lambda cfg, nf, dev: (2048, True))
    monkeypatch.setattr(device_policy, "GPU_KNN10_PAIRS_PER_SEC", 1e7)
    with caplog.at_level(logging.DEBUG, _LOG):
        split = prepare_fixed(X, cfg, **F64)
    assert any("certified at r" in r.getMessage() for r in caplog.records)
    for f, a, b in zip(dense._fields, dense, split):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f


def test_prepare_fixed_planner_refuses_like_jax(monkeypatch):
    """A single 2048-row k-NN block over 0.9 of the budget raises in both
    packages' preparation planners; above 0.9 of it the k-NN is split."""
    import jax

    from simpleicp_tpu import prepare_fixed as jax_prepare

    X, _ = _pair(917, n=5000)
    _equal_rates(monkeypatch)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pytest.raises(ValueError, match="minimal kNN"):
        jax_prepare(X, JaxConfig(correspondences=4096, program_budget_s=1.0), dtype=jnp.float64)
    monkeypatch.undo()
    _equal_rates(monkeypatch)
    card = torch.device("cuda")
    with pytest.raises(ValueError, match="minimal k-NN"):
        icp._plan_prepared_knn(IcpConfig(correspondences=4096, program_budget_s=1.0), 5000, card)
    assert icp._plan_prepared_knn(IcpConfig(correspondences=4096, program_budget_s=2.0),
                                  5000, card) == (2048, True)
    assert icp._plan_prepared_knn(IcpConfig(correspondences=4096), 5000, card) == (0, False)
    assert icp._plan_prepared_knn(IcpConfig(correspondences=4096, program_budget_s=2.0),
                                  5000, torch.device("cpu")) == (0, False)


# ---- the stall check, as tests/test_chunked.py drives the JAX one ----

def _stall_args():
    X_fix, X_mov = _pair(918)
    return X_fix, X_mov, IcpConfig(correspondences=256)


def test_chunk_stall_warning(monkeypatch, caplog):
    """A chunk far over its estimate warns of a degraded window; a chunk
    within the margins does not."""
    X_fix, X_mov, cfg = _stall_args()
    monkeypatch.setattr(icp, "_chunk_per_iter_estimate", lambda *a, **k: 1.0)
    with caplog.at_level(logging.WARNING, logger=_LOG):
        _run(X_fix, X_mov, _chunked(cfg, 2))
    assert not [r for r in caplog.records if "degraded window" in r.getMessage()]
    monkeypatch.setattr(icp, "_STALL_FACTOR", 0.0)
    monkeypatch.setattr(icp, "_STALL_SLACK_S", 0.0)
    monkeypatch.setattr(icp, "_STALL_MIN_EST_S", 0.0)
    with caplog.at_level(logging.WARNING, logger=_LOG):
        res, _ = _run(X_fix, X_mov, _chunked(cfg, 2))
    assert int(res.error_code) == 0
    assert [r for r in caplog.records if "degraded window" in r.getMessage()]


def test_chunk_stall_estimate_is_zero_on_the_cpu():
    assert icp._chunk_per_iter_estimate(IcpConfig(), 10**6, 10**6, False,
                                        torch.device("cpu")) == 0.0
    assert icp._chunk_per_iter_estimate(IcpConfig(), 10**6, 10**6, False,
                                        torch.device("cuda")) > 0.0


def test_stall_wait_budget_exhaustion(monkeypatch, caplog):
    """A card that never answers does not deadlock the run: after the wait
    budget the wait gives up with a warning."""
    import time

    monkeypatch.setattr(icp, "_STALL_WAIT_SLEEP_S", 0.0)
    monkeypatch.setattr(icp, "_STALL_WAIT_PROBE_TIMEOUT_S", 0.0)
    monkeypatch.setattr(icp, "_STALL_WAIT_BUDGET_S", 0.2)
    calls = []

    def never_ok(timeout_s):
        calls.append(timeout_s)
        time.sleep(0.02)
        return ("timeout", "", 0.01)

    monkeypatch.setattr(device_policy, "probe_default_backend", never_ok)
    log = logging.getLogger("simpleicp_tpu_torch.test_budget")
    t0 = time.monotonic()
    with caplog.at_level(logging.WARNING, logger="simpleicp_tpu_torch.test_budget"):
        waited = icp._wait_for_healthy_window(log)
    assert len(calls) >= 2
    assert 0.15 <= waited <= 5.0 and time.monotonic() - t0 < 10.0
    assert any("proceeding into the degraded window" in r.getMessage()
               for r in caplog.records)


def test_chunk_stall_policy_wait(monkeypatch, caplog):
    """stall_policy='wait' holds the next chunk until a probe answers ok
    (retrying a failed one), logs the wait, and changes no result."""
    X_fix, X_mov, cfg = _stall_args()
    monkeypatch.setattr(icp, "_chunk_per_iter_estimate", lambda *a, **k: 1.0)
    for name, v in (("_STALL_FACTOR", 0.0), ("_STALL_SLACK_S", 0.0),
                    ("_STALL_MIN_EST_S", 0.0), ("_STALL_WAIT_SLEEP_S", 0.0),
                    ("_STALL_WAIT_PROBE_TIMEOUT_S", 0.0), ("_STALL_WAIT_BUDGET_S", 30.0)):
        monkeypatch.setattr(icp, name, v)
    probes = []

    def fake_probe(timeout_s):
        probes.append(timeout_s)
        return ("ok" if len(probes) % 2 == 0 else "timeout", "cuda", 0.01)

    monkeypatch.setattr(device_policy, "probe_default_backend", fake_probe)
    with caplog.at_level(logging.INFO, logger=_LOG):
        wait = _run(X_fix, X_mov, _chunked(dataclasses.replace(cfg, stall_policy="wait"), 1))
    assert int(wait[0].error_code) == 0
    assert len(probes) >= 2 and len(probes) % 2 == 0, probes
    msgs = [r.getMessage() for r in caplog.records]
    assert any("Holding the next chunk" in m for m in msgs)
    assert any("cumulative stall-wait" in m for m in msgs)
    assert any("total stall-wait" in m for m in msgs)
    probes.clear()
    warn = _run(X_fix, X_mov, _chunked(cfg, 1))
    assert not probes
    _assert_bitequal(wait, warn)

"""The port's IcpConfig against the JAX package's: the same fields,
defaults and validation; config_from_dict; every setting runs."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from simpleicp_tpu import IcpConfig as JaxConfig
from simpleicp_tpu_torch import IcpConfig, config_from_dict, icp_register


def test_fields_and_defaults_equal():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(IcpConfig)]
    assert tf == jf
    assert IcpConfig().overlap_enabled == JaxConfig().overlap_enabled


BAD = [
    dict(correspondences=5),
    dict(correspondences=2**22 + 1),
    dict(neighbors=2),
    dict(min_planarity=1.0),
    dict(min_planarity=-0.1),
    dict(max_iterations=0),
    dict(distance_weights=0.0),
    dict(solver="svd"),
    dict(rejection_staging="both"),
    dict(std_ddof=2),
    dict(gate_method="kd"),
    dict(match_method="tree"),
    dict(match_radius=-1.0),
    dict(program_budget_s=-1.0),
    dict(dispatch="sharded"),
    dict(chunk_iterations=-1),
    dict(warm_start_points=99),
    dict(warm_start_correspondences=5),
    dict(stall_policy="retry"),
    dict(gate_collective="tree"),
    dict(convergence_floor_scale=-1.0),
    dict(match_method="grid"),
]


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_post_init_errors_equal(kw):
    with pytest.raises(ValueError) as ej:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as et:
        IcpConfig(**kw)
    assert str(et.value) == str(ej.value)


def test_overlap_enabled_follows_the_gate_radius():
    for d in (math.inf, -1.0, 0.0, 0.5):
        assert IcpConfig(max_overlap_distance=d).overlap_enabled == \
            JaxConfig(max_overlap_distance=d).overlap_enabled


def test_config_from_dict_round_trip():
    j = JaxConfig(correspondences=321, solver="linearized", distance_weights=None,
                  rejection_staging="joint", mad_scale=1.0, std_ddof=1)
    t = config_from_dict(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert config_from_dict(dataclasses.asdict(t)) == t
    with pytest.raises(ValueError, match="unknown"):
        config_from_dict({**dataclasses.asdict(j), "tile": 3})


_X = np.random.default_rng(0).uniform(0, 1, (50, 3))
_N = np.column_stack([np.zeros(50), np.zeros(50), np.ones(50)])

PORTED = {
    "overlap_gate": (dict(max_overlap_distance=1.0), {}),
    "dilate_gate": (dict(max_overlap_distance=1.0, gate_method="dilate"), {}),
    "record_trajectory": (dict(record_trajectory=True), {}),
    "grid_matcher": (dict(match_method="grid", match_radius=0.5), {}),
    "grid_gate": (dict(max_overlap_distance=1.0, gate_method="grid"), {}),
    "normals_fix": ({}, dict(normals_fix=_N)),
    "planarity_fix": ({}, dict(normals_fix=_N, planarity_fix=np.ones(50))),
    "planarity_mov": ({}, dict(planarity_mov=np.ones(50))),
    "chunked": (dict(dispatch="chunked", chunk_iterations=2), {}),
}


@pytest.mark.parametrize("name", list(PORTED))
def test_ported_settings_run(name):
    """Settings that the first slice refused and later slices run (the
    gated slice; the grid engines; chunked dispatch, which must also give
    the JAX package's chunked result: iterations, selection, H within
    1e-9)."""
    cfg_kw, call_kw = PORTED[name]
    res = icp_register(_X, _X + 0.01, IcpConfig(correspondences=10, **cfg_kw),
                       device="cpu", **call_kw)
    assert bool(np.isfinite(res.H.numpy()).all())
    if name == "chunked":
        import jax.numpy as jnp

        from simpleicp_tpu import icp_register as jax_register

        ref = icp_register(_X, _X + 0.01, IcpConfig(correspondences=10, **cfg_kw),
                           device="cpu", dtype=torch.float64)
        jres = jax_register(_X, _X + 0.01, JaxConfig(correspondences=10, **cfg_kw),
                            dtype=jnp.float64)
        assert int(ref.n_iterations) == int(jres.n_iterations)
        assert np.array_equal(ref.sel_idx.numpy(), np.asarray(jres.sel_idx))
        np.testing.assert_allclose(ref.H.numpy(), np.asarray(jres.H), rtol=0, atol=1e-9)


def _serving_case(name):
    """(port result, JAX result, the port's default run) of a serving
    setting, on a 1500-point surface pair in float64."""
    import jax.numpy as jnp

    from simpleicp_tpu import icp_register as jax_register
    from simpleicp_tpu import prepare_fixed as jax_prepare_fixed
    from simpleicp_tpu_torch import prepare_fixed

    rng = np.random.default_rng(5)
    xy = rng.uniform(-1, 1, (1500, 2))
    X = np.column_stack([xy, 0.2 * np.sin(3 * xy[:, 0]) + 0.1 * np.cos(2 * xy[:, 1])])
    Xm = X[::-1] + [0.01, -0.02, 0.005]
    kw = {"warm_start": dict(warm_start=True, warm_start_points=500),
          "approx_knn": dict(approx_knn=True), "fixed_prep": {}}[name]
    j, t = JaxConfig(correspondences=100, **kw), IcpConfig(correspondences=100, **kw)
    jcall, tcall = {}, {}
    if name == "fixed_prep":
        jcall["fixed_prep"] = jax_prepare_fixed(X, j, dtype=jnp.float64)
        tcall["fixed_prep"] = prepare_fixed(X, t, device="cpu", dtype=torch.float64)
    return (icp_register(X, Xm, t, device="cpu", dtype=torch.float64, **tcall),
            jax_register(X, Xm, j, dtype=jnp.float64, **jcall),
            icp_register(X, Xm, IcpConfig(correspondences=100), device="cpu",
                         dtype=torch.float64))


@pytest.mark.parametrize("name", ["warm_start", "approx_knn", "fixed_prep"])
def test_serving_settings_run_and_match_jax(name):
    """warm_start, approx_knn and fixed_prep run (they were refused before
    serving was ported): each equals the JAX package's run (iterations,
    selection, H within 1e-9). approx_knn and fixed_prep also equal the
    port's default run bit for bit (the exact k-NN; the same selection and
    normals)."""
    tres, jres, base = _serving_case(name)
    assert int(tres.n_iterations) == int(jres.n_iterations)
    assert np.array_equal(tres.sel_idx.numpy(), np.asarray(jres.sel_idx))
    np.testing.assert_allclose(tres.H.numpy(), np.asarray(jres.H), rtol=0, atol=1e-9)
    if name != "warm_start":
        for a, b in zip(tres, base):
            assert torch.equal(a, b)


def test_gated_jax_config_converts_and_runs():
    """A gated JAX IcpConfig (gate radius, brute gate, recorded trajectory)
    converts field for field and runs instead of being refused."""
    j = JaxConfig(correspondences=20, max_overlap_distance=0.5, gate_method="brute",
                  record_trajectory=True, distance_weights=None)
    t = config_from_dict(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j) and t.overlap_enabled
    rng = np.random.default_rng(2)
    X = rng.uniform(-1, 1, (400, 3)) * [1, 1, 0.1]
    res = icp_register(X, X + 0.01, t, device="cpu")
    assert int(res.error_code) == 0 and res.iter_ps.shape == (100, 6)


def test_tpu_only_fields_change_nothing():
    """query_tile, ref_tile and use_pallas are accepted and change no
    result; nor do program_budget_s, stall_policy and dispatch on the CPU,
    where the planner is unguarded and no stall is checked."""
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (600, 3)) * [1, 1, 0.1]
    base = icp_register(X, X + 0.01, IcpConfig(correspondences=50), device="cpu")
    other = icp_register(X, X + 0.01, IcpConfig(
        correspondences=50, query_tile=16, ref_tile=64, use_pallas=True,
        program_budget_s=0.0, stall_policy="wait", dispatch="monolithic",
        match_method="brute"), device="cpu")
    for a, b in zip(base, other):
        assert np.array_equal(a.numpy(), b.numpy(), equal_nan=True)

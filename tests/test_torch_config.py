"""The port's IcpConfig against the JAX package's: the same fields,
defaults and validation; config_from_dict; refusal of unported settings."""

import dataclasses
import math

import numpy as np
import pytest

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

UNPORTED = {
    "grid_matcher": (dict(match_method="grid", match_radius=0.5), {}),
    "grid_gate": (dict(max_overlap_distance=1.0, gate_method="grid"), {}),
    "dilate_gate": (dict(max_overlap_distance=1.0, gate_method="dilate"), {}),
    "chunked": (dict(dispatch="chunked"), {}),
    "warm_start": (dict(warm_start=True), {}),
    "approx_knn": (dict(approx_knn=True), {}),
    "fixed_prep": ({}, dict(fixed_prep=object())),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_settings_raise(name):
    cfg_kw, call_kw = UNPORTED[name]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        icp_register(_X, _X, IcpConfig(correspondences=10, **cfg_kw),
                     device="cpu", **call_kw)


_N = np.column_stack([np.zeros(50), np.zeros(50), np.ones(50)])

PORTED = {
    "overlap_gate": (dict(max_overlap_distance=1.0), {}),
    "record_trajectory": (dict(record_trajectory=True), {}),
    "normals_fix": ({}, dict(normals_fix=_N)),
    "planarity_fix": ({}, dict(normals_fix=_N, planarity_fix=np.ones(50))),
    "planarity_mov": ({}, dict(planarity_mov=np.ones(50))),
}


@pytest.mark.parametrize("name", list(PORTED))
def test_ported_settings_run(name):
    """Settings that the first slice refused and the gated slice runs."""
    cfg_kw, call_kw = PORTED[name]
    res = icp_register(_X, _X + 0.01, IcpConfig(correspondences=10, **cfg_kw),
                       device="cpu", **call_kw)
    assert bool(np.isfinite(res.H.numpy()).all())


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
    """query_tile, ref_tile, use_pallas, program_budget_s and stall_policy
    are accepted and change no result."""
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (600, 3)) * [1, 1, 0.1]
    base = icp_register(X, X + 0.01, IcpConfig(correspondences=50), device="cpu")
    other = icp_register(X, X + 0.01, IcpConfig(
        correspondences=50, query_tile=16, ref_tile=64, use_pallas=True,
        program_budget_s=0.0, stall_policy="wait", dispatch="monolithic",
        match_method="brute"), device="cpu")
    for a, b in zip(base, other):
        assert np.array_equal(a.numpy(), b.numpy(), equal_nan=True)

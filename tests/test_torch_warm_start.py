"""Coarse-to-fine warm start of the PyTorch port (CPU, plain versions)
against the JAX package, mirroring the portable cases of
tests/test_warm_start.py on its synthetic surface (the dragon cases on
synthetic twins, at a few thousand points with warm_start_points lowered).

Every case runs both packages on the same float64 inputs and holds the
port's iteration count equal to the JAX package's and its H within 1e-9
(the tolerance of tests/test_torch_icp.py); each also keeps the JAX test's
own claim (fewer iterations, the same basin, the seed adopted or not).
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu import IcpConfig as JaxConfig
from simpleicp_tpu import icp_register as jax_register
from simpleicp_tpu_torch import IcpConfig, icp_register
from simpleicp_tpu_torch.models import icp as icp_core
from test_torch_dilate_gate import _one_torch_thread  # noqa: F401 (autouse fixture)

F64 = dict(device="cpu", dtype=torch.float64)


def _surface(rng, n):
    xy = rng.uniform(-2, 2, size=(n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z])


def _known_motion():
    a = np.array([0.02, -0.015, 0.03])
    t = np.array([0.05, -0.04, 0.03])
    c1, s1, c2, s2, c3, s3 = (
        np.cos(a[0]), np.sin(a[0]), np.cos(a[1]), np.sin(a[1]),
        np.cos(a[2]), np.sin(a[2]),
    )
    R = np.array(
        [
            [c2 * c3, -c2 * s3, s2],
            [c1 * s3 + s1 * s2 * c3, c1 * c3 - s1 * s2 * s3, -s1 * c2],
            [s1 * s3 - c1 * s2 * c3, s1 * c3 + c1 * s2 * s3, c1 * c2],
        ]
    )
    return R, t


def _dependent_pair(seed, n):
    """The fixed cloud and itself moved by the known motion (the JAX tests'
    dependent-sampled pair, where iteration savings are deterministic)."""
    X_fix = _surface(np.random.default_rng(seed), n)
    R, t = _known_motion()
    return X_fix, (X_fix - t) @ R, t


def _both(X_fix, X_mov, kw, **call):
    """The JAX package's and the port's registration with the config
    fields ``kw``, float64."""
    jres = jax_register(X_fix, X_mov, JaxConfig(**kw), dtype=jnp.float64, **call)
    tres = icp_register(X_fix, X_mov, IcpConfig(**kw), **call, **F64)
    return jres, tres


def _assert_matches_jax(jres, tres):
    assert int(tres.n_iterations) == int(jres.n_iterations)
    assert int(tres.error_code) == int(jres.error_code)
    assert bool(tres.converged) == bool(jres.converged)
    np.testing.assert_array_equal(tres.sel_idx.numpy(), np.asarray(jres.sel_idx))
    np.testing.assert_allclose(tres.H.numpy(), np.asarray(jres.H), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tres.iter_ps[0].numpy(), np.asarray(jres.iter_ps[0]),
                               rtol=0, atol=1e-9)


def _assert_bitequal(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def basin():
    """The 9000-point dependent pair, cold and warm (warm_start_points 3000,
    stride 3) in both packages."""
    X_fix, X_mov, t = _dependent_pair(420001, 9000)
    cold = _both(X_fix, X_mov, {})
    warm = _both(X_fix, X_mov, dict(warm_start=True, warm_start_points=3000))
    return X_fix, X_mov, t, cold, warm


def test_warm_start_same_basin_fewer_iterations(basin):
    _, _, t, (jcold, cold), (jwarm, warm) = basin
    _assert_matches_jax(jcold, cold)
    _assert_matches_jax(jwarm, warm)
    assert bool(cold.converged) and bool(warm.converged)
    assert int(warm.n_iterations) < int(cold.n_iterations)
    np.testing.assert_allclose(warm.H.numpy(), cold.H.numpy(), atol=2e-4)
    np.testing.assert_allclose(warm.H.numpy()[:3, 3], t, atol=2e-3)


def test_warm_start_noop_below_threshold(basin):
    """Clouds at or below warm_start_points skip the coarse pass: bit-equal
    to the cold run."""
    X_fix, X_mov, _, (_, cold), _ = basin
    warm = icp_register(X_fix, X_mov, IcpConfig(warm_start=True, warm_start_points=9000), **F64)
    _assert_bitequal(cold, warm)


def test_warm_start_finite_weight_observations_raise(basin):
    """A finite observation weight is part of the objective; the JAX
    package's refusal, with its message, before any work."""
    X_fix, X_mov = basin[:2]
    kw = dict(rbp_observed_values=np.zeros(6),
              rbp_observation_weights=np.array([1.0, 0, 0, 0, 0, 0]))
    with pytest.raises(ValueError) as ej:
        jax_register(X_fix, X_mov, JaxConfig(warm_start=True, warm_start_points=100), **kw)
    with pytest.raises(ValueError) as et:
        icp_register(X_fix, X_mov, IcpConfig(warm_start=True, warm_start_points=100),
                     **kw, **F64)
    assert str(et.value) == str(ej.value) and "warm_start" in str(et.value)


def test_warm_start_frozen_parameters_preserved(basin):
    """weight=inf components keep the user's exact observed value through
    the warm start; free components get warm initial values."""
    X_fix, X_mov = basin[:2]
    call = dict(rbp_observed_values=np.array([0.01, 0.0, 0.0, 0.0, 0.0, 0.0]),
                rbp_observation_weights=np.array([np.inf, 0.0, 0.0, 0.0, 0.0, 0.0]))
    jres, tres = _both(X_fix, X_mov, dict(warm_start=True, warm_start_points=3000), **call)
    _assert_matches_jax(jres, tres)
    assert int(tres.error_code) == 0
    assert float(tres.p[0]) == 0.01


def test_warm_start_logs_the_jax_lines(basin, caplog):
    """The info line of an adopted seed, word for word the JAX package's,
    under the port's logger."""
    X_fix, X_mov = basin[:2]
    cfg = dict(warm_start=True, warm_start_points=3000)
    with caplog.at_level(logging.INFO, logger="simpleicp_tpu.models.icp"):
        jax_register(X_fix, X_mov, JaxConfig(**cfg), dtype=jnp.float64)
    jax_lines = [r.getMessage() for r in caplog.records if r.name == "simpleicp_tpu.models.icp"]
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="simpleicp_tpu_torch.models.icp"):
        icp_register(X_fix, X_mov, IcpConfig(**cfg), **F64)
    port_lines = [r.getMessage() for r in caplog.records
                  if r.name == "simpleicp_tpu_torch.models.icp"]
    assert port_lines == jax_lines and len(port_lines) == 1
    assert port_lines[0].startswith(
        "warm start: coarse registration on 3000 x 3000 subsampled points, ")


def test_warm_start_nonconverged_coarse_starts_cold():
    """A coarse pass that hits max_iterations is not adopted: the warm run
    is bit-equal to the cold run, and the JAX package's warning is logged."""
    X_fix, X_mov, _ = _dependent_pair(7, 6000)
    cold = icp_register(X_fix, X_mov, IcpConfig(max_iterations=1), **F64)
    kw = dict(max_iterations=1, warm_start=True, warm_start_points=2000)
    jres = jax_register(X_fix, X_mov, JaxConfig(**kw), dtype=jnp.float64)
    warm = icp_register(X_fix, X_mov, IcpConfig(**kw), **F64)
    _assert_bitequal(cold, warm)
    _assert_matches_jax(jres, warm)


def test_warm_start_nonconverged_warning_text(caplog):
    X_fix, X_mov, _ = _dependent_pair(8, 3000)
    with caplog.at_level(logging.WARNING, logger="simpleicp_tpu_torch.models.icp"):
        icp_register(X_fix, X_mov, IcpConfig(correspondences=100, max_iterations=1,
                                             warm_start=True, warm_start_points=1000), **F64)
    assert [r.getMessage() for r in caplog.records] == [
        "warm start: coarse registration did not converge in 1 iterations — starting cold"]


def test_warm_start_failed_coarse_pass_starts_cold(caplog):
    """A coarse pass that ends in an error (here: no overlap at the coarse
    gate) is not adopted; the JAX package's warning is logged."""
    X_fix, X_mov, _ = _dependent_pair(9, 3000)
    X_far = X_mov + [100.0, 0.0, 0.0]
    kw = dict(correspondences=100, max_overlap_distance=0.5, warm_start=True,
              warm_start_points=1000)
    with caplog.at_level(logging.WARNING, logger="simpleicp_tpu_torch.models.icp"):
        res = icp_register(X_fix, X_far, IcpConfig(**kw), **F64)
    assert [r.getMessage() for r in caplog.records] == [
        "warm start: coarse registration failed with error code 1 — starting cold"]
    assert int(res.error_code) == 1


def test_warm_start_gated():
    """The warm parameters feed the overlap gate's initial transform."""
    rng = np.random.default_rng(420002)
    R, t = _known_motion()
    X_fix = _surface(rng, 6000)
    X_mov = (_surface(rng, 6000) - t) @ R
    jres, tres = _both(X_fix, X_mov, dict(max_overlap_distance=1.0, warm_start=True,
                                          warm_start_points=2000))
    _assert_matches_jax(jres, tres)
    assert int(tres.error_code) == 0
    np.testing.assert_allclose(tres.H.numpy()[:3, 3], t, atol=5e-3)


def test_warm_start_tuned_corner_drift_bounded():
    """The tuned corner (points ratio ~1/3, a sharper coarse pass) at a
    smaller scale: the seed is adopted (iteration 0 differs from cold's)
    and the warm H stays within 1e-5 of the cold optimum."""
    rng = np.random.default_rng(420003)
    R, t = _known_motion()
    X_fix = _surface(rng, 9000)
    X_mov = (_surface(rng, 9000) - t) @ R
    cold = icp_register(X_fix, X_mov, IcpConfig(correspondences=1500), **F64)
    jres, warm = _both(X_fix, X_mov, dict(correspondences=1500, warm_start=True,
                                          warm_start_points=3000,
                                          warm_start_correspondences=600))
    _assert_matches_jax(jres, warm)
    assert bool(warm.converged)
    assert not torch.equal(warm.iter_ps[0], cold.iter_ps[0])
    assert float((warm.H - cold.H).abs().max()) < 1e-5
    np.testing.assert_allclose(warm.H.numpy()[:3, 3], t, atol=1e-4)


def test_warm_start_tensor_normals():
    """User normals and planarity as tensors on the run's device (the
    coarse pass slices them there, see test_plan_warm_start_slices_views):
    the result matches the JAX package's on the same normals."""
    X_fix, X_mov, t = _dependent_pair(10, 6000)
    from simpleicp_tpu_torch.ops.knn import knn_search
    from simpleicp_tpu_torch.ops.normals import estimate_normals_from_neighborhoods

    Xf = torch.as_tensor(X_fix)
    _, ik = knn_search(Xf, Xf, 10)
    normals, planarity, _ = estimate_normals_from_neighborhoods(Xf[ik.long()])
    kw = dict(warm_start=True, warm_start_points=2000)
    jres = jax_register(X_fix, X_mov, JaxConfig(**kw), normals_fix=normals.numpy(),
                        planarity_fix=planarity.numpy(), dtype=jnp.float64)
    res = icp_register(Xf, torch.as_tensor(X_mov), IcpConfig(**kw), normals_fix=normals,
                       planarity_fix=planarity, **F64)
    _assert_matches_jax(jres, res)
    assert int(res.error_code) == 0
    np.testing.assert_allclose(res.H.numpy()[:3, 3], t, atol=2e-3)


def test_plan_warm_start_slices_views():
    """plan_warm_start hands the coarse registration strided views of the
    tensors it was given (the same storage: nothing was copied to the
    host), normals and planarity included."""
    seen = {}
    X_fix, X_mov, _ = _dependent_pair(11, 3000)
    Xf, Xm = torch.as_tensor(X_fix), torch.as_tensor(X_mov)
    pl = torch.ones(3000, dtype=torch.float64)
    nrm = torch.zeros((3000, 3), dtype=torch.float64)
    nrm[:, 2] = 1.0
    real = icp_core.icp_register

    def spy(A, B, cfg, **kw):
        seen.update(A=A, B=B, pl=kw["planarity_mov"], nrm=kw["normals_fix"], cfg=cfg)
        return real(A, B, cfg, **kw)

    icp_core.icp_register = spy
    try:
        cfg, obs = icp_core.plan_warm_start(Xf, Xm, IcpConfig(correspondences=200,
                                                              warm_start=True,
                                                              warm_start_points=1000),
                                            normals_fix=nrm, planarity_fix=pl,
                                            planarity_mov=pl, **F64)
    finally:
        icp_core.icp_register = real
    assert seen["A"].data_ptr() == Xf.data_ptr() and seen["A"].stride() == (9, 1)
    assert seen["B"].data_ptr() == Xm.data_ptr() and seen["pl"].stride() == (3,)
    assert seen["nrm"].data_ptr() == nrm.data_ptr() and seen["nrm"].stride() == (9, 1)
    assert seen["cfg"].correspondences == 200 and seen["cfg"].match_method == "brute"
    assert not cfg.warm_start and obs is not None and obs.shape == (6,)


def test_warm_start_gate_widened_for_coarse_pass():
    """A gate radius tuned to the full cloud's spacing (0.05 at 6400 points
    on 16 square units) would starve the stride-10 coarse pass (spacing
    ~0.16) without the sqrt(stride) widening; with it the seed is adopted
    and the warm run takes fewer iterations."""
    X_fix, X_mov, _ = _dependent_pair(12, 6400)
    cold = icp_register(X_fix, X_mov, IcpConfig(max_overlap_distance=0.1), **F64)
    jres, warm = _both(X_fix, X_mov, dict(max_overlap_distance=0.1, warm_start=True,
                                          warm_start_points=640))
    _assert_matches_jax(jres, warm)
    assert int(warm.error_code) == 0 and bool(warm.converged)
    assert int(warm.n_iterations) < int(cold.n_iterations)
    np.testing.assert_allclose(warm.H.numpy(), cold.H.numpy(), atol=2e-4)


def test_warm_start_chunked_dispatch_raises_its_item():
    """warm_start with chunked dispatch (tests/test_warm_start.py::
    test_warm_start_chunked_dispatch), which raised its ROADMAP item until
    chunked dispatch was ported: it runs, equals the JAX package's warm
    chunked run (iterations, selection; H within 1e-9) and the port's warm
    monolithic run bit for bit, and lands in the cold run's basin (H within
    2e-4)."""
    X_fix, X_mov, _ = _dependent_pair(13, 2000)
    kw = dict(warm_start=True, warm_start_points=500)
    jres, tres = _both(X_fix, X_mov, dict(kw, dispatch="chunked", chunk_iterations=2))
    _assert_matches_jax(jres, tres)
    assert bool(tres.converged)
    _assert_bitequal(tres, icp_register(X_fix, X_mov, IcpConfig(**kw), **F64))
    cold = icp_register(X_fix, X_mov, IcpConfig(), **F64)
    np.testing.assert_allclose(tres.H.numpy(), cold.H.numpy(), rtol=0, atol=2e-4)


@pytest.mark.parametrize("grid", [
    dict(match_method="grid", match_radius=0.2),
    dict(max_overlap_distance=0.1, gate_method="grid"),
], ids=["grid_matcher", "grid_gate"])
def test_warm_start_with_a_grid_full_pass_matches_jax(grid):
    """A warm start whose full pass runs a grid engine (refused before the
    grid engines were ported): the coarse pass keeps its brute matcher and
    "auto" gate, the full pass the grid engine, and the run equals the JAX
    package's (iterations, selection; H within 1e-9)."""
    X_fix, X_mov, _ = _dependent_pair(14, 2000)
    jres, tres = _both(X_fix, X_mov, dict(warm_start=True, warm_start_points=500, **grid))
    _assert_matches_jax(jres, tres)
    assert int(tres.error_code) == 0


def test_warm_start_cli_flag():
    from simpleicp_tpu.cli import build_parser as jax_parser
    from simpleicp_tpu_torch.cli import build_parser

    for parser in (build_parser(), jax_parser()):
        assert parser.parse_args(["-f", "a.xyz", "-m", "b.xyz", "--warm-start"]).warm_start
        assert not parser.parse_args(["-f", "a.xyz", "-m", "b.xyz"]).warm_start

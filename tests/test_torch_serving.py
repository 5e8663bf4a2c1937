"""Serving: prepare_fixed, FixedPrep save/load and the prepared registration
of the PyTorch port (CPU, plain versions), against the JAX package and
against the port's own self-contained registration.

The port mirrors the portable cases of tests/test_prepared.py on the
synthetic surface of tests/test_warm_start.py:21-41 (the dragon case's
twin is a 4000-point pair). Tolerances, float64:
* the port's prepared registration equals its self-contained one bit for
  bit, every field (the same selection, the same k-NN call, the same loop);
* against the JAX package: selection, indices, fingerprints and the npz
  arrays equal; normals and planarity within 1e-10; the prepared
  registration within the tolerances of tests/test_torch_icp.py
  (``_assert_parity``: iterations equal, H within 1e-9).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu import FixedPrep as JaxFixedPrep
from simpleicp_tpu import IcpConfig as JaxConfig
from simpleicp_tpu import icp_register as jax_register
from simpleicp_tpu import load_fixed_prep as jax_load_fixed_prep
from simpleicp_tpu import prepare_fixed as jax_prepare_fixed
from simpleicp_tpu_torch import (
    FixedPrep,
    IcpConfig,
    config_from_dict,
    fixed_prep_from_jax,
    fixed_prep_to_numpy,
    icp_register,
    load_fixed_prep,
    prepare_fixed,
    result_to_numpy,
)
from simpleicp_tpu_torch.models.icp import _icp_register
from test_torch_dilate_gate import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_icp import _assert_parity

F64 = dict(device="cpu", dtype=torch.float64)


def _surface(rng, n):
    xy = rng.uniform(-2, 2, size=(n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z])


def _pair(seed, n_fix, n_mov):
    """Fixed cloud and an independent sample moved by a small rigid motion,
    as tests/test_prepared.py's _pair."""
    rng = np.random.default_rng(seed)
    Xf = _surface(rng, n_fix)
    Xm = _surface(rng, n_mov)
    ang = 0.015
    R = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                  [np.sin(ang), np.cos(ang), 0.0],
                  [0.0, 0.0, 1.0]])
    return Xf, Xm @ R.T + np.array([0.04, -0.03, 0.02])


def _assert_bitequal(a, b):
    assert a._fields == b._fields
    for f in a._fields:
        va, vb = getattr(a, f), getattr(b, f)
        assert va.dtype == vb.dtype and va.device == vb.device, f
        assert torch.equal(va, vb), f


def _assert_prep_equal(p, q):
    """Two preparations (either package's, arrays or tensors) bit-equal."""
    assert tuple(p[5:]) == tuple(q[5:])
    for f, a, b in zip(FixedPrep._fields, p[:5], q[:5]):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _normals(seed, n):
    r = np.random.default_rng(seed)
    normals = r.normal(size=(n, 3))
    return normals / np.linalg.norm(normals, axis=1, keepdims=True), r.uniform(0.3, 1.0, n)


def test_fixed_prep_has_the_jax_fields():
    assert FixedPrep._fields == JaxFixedPrep._fields


# name: (n_fix, n_mov, correspondences, supplied normals)
PREP_CASES = {
    "default": (4000, 4000, 300, False),
    "supplied_normals": (3000, 3000, 300, True),
    "small_cloud_padding": (150, 200, 256, False),
}


@pytest.mark.parametrize("name", list(PREP_CASES))
def test_prepare_fixed_matches_jax(name):
    """The port's preparation against the JAX package's on the same float64
    inputs: Q, selection and fingerprint equal, normals and planarity within
    1e-10 (bit-equal when the user supplies them)."""
    nf, _, C, supplied = PREP_CASES[name]
    Xf, _ = _pair(11, nf, 1)
    kw = {}
    if supplied:
        kw = dict(zip(("normals_fix", "planarity_fix"), _normals(7, nf)))
    jp = jax_prepare_fixed(Xf, JaxConfig(correspondences=C), dtype=jnp.float64, **kw)
    tp = prepare_fixed(Xf, IcpConfig(correspondences=C), **kw, **F64)
    assert tuple(tp[5:]) == tuple(jp[5:]) == (nf, C, 10, False)
    for f in ("Q", "sel_idx", "sel_valid"):
        a, b = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("normals", "planarity"):
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                   rtol=0, atol=0 if supplied else 1e-10, err_msg=f)
    if nf < C:
        assert int(tp.sel_valid.sum()) == nf and tp.sel_idx.max() == nf - 1


@pytest.mark.parametrize("name,solver", [("default", "nonlinear"), ("default", "linearized"),
                                         ("supplied_normals", "nonlinear"),
                                         ("small_cloud_padding", "linearized")])
def test_prepared_registration_matches_jax(name, solver):
    """The port's prepared registration against the JAX package's prepared
    registration (each package with its own preparation of the same cloud),
    and bit-equal to the port's self-contained run."""
    nf, nm, C, supplied = PREP_CASES[name]
    Xf, Xm = _pair(12, nf, nm)
    jcfg = JaxConfig(correspondences=C, solver=solver)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    kw = {}
    if supplied:
        kw = dict(zip(("normals_fix", "planarity_fix"), _normals(8, nf)))
    jres = jax_register(Xf, Xm, dataclasses.replace(jcfg, record_trajectory=True),
                        fixed_prep=jax_prepare_fixed(Xf, jcfg, dtype=jnp.float64, **kw),
                        dtype=jnp.float64)
    prep = prepare_fixed(Xf, cfg, **kw, **F64)
    common = dict(rbp_observed_values=None, rbp_observation_weights=None,
                  planarity_fix=None, planarity_mov=None, **F64)
    tres, carry = _icp_register(Xf, Xm, cfg, normals_fix=None, fixed_prep=prep, **common)
    _assert_parity(jres, result_to_numpy(tres), carry.m_idx.numpy())
    self_contained, carry_s = _icp_register(
        Xf, Xm, cfg, normals_fix=kw.get("normals_fix"), fixed_prep=None,
        **{**common, "planarity_fix": kw.get("planarity_fix")})
    _assert_bitequal(tres, self_contained)
    assert torch.equal(carry.m_idx, carry_s.m_idx)


def test_prepared_serves_many_movables():
    """One preparation, several movable clouds of different sizes: each
    prepared registration equals its self-contained counterpart bit for
    bit (tests/test_prepared.py::test_prepared_serves_many_movables)."""
    Xf, _ = _pair(13, 4000, 1)
    cfg = IcpConfig(correspondences=400)
    prep = prepare_fixed(Xf, cfg, **F64)
    for seed in range(3):
        _, Xm = _pair(seed, 1, 3000 + 500 * seed)
        _assert_bitequal(icp_register(Xf, Xm, cfg, **F64),
                         icp_register(Xf, Xm, cfg, fixed_prep=prep, **F64))


def test_prepared_float32_and_movable_planarity():
    """float32 (the card's default dtype) and a movable cloud with
    planarity: still bit-equal to the self-contained run."""
    Xf, Xm = _pair(14, 3000, 3500)
    pl_mov = np.random.default_rng(9).uniform(0.2, 1.0, 3500)
    cfg = IcpConfig(correspondences=300)
    f32 = dict(device="cpu", dtype=torch.float32)
    prep = prepare_fixed(Xf, cfg, **f32)
    assert prep.Q.dtype == torch.float32
    _assert_bitequal(icp_register(Xf, Xm, cfg, planarity_mov=pl_mov, **f32),
                     icp_register(Xf, Xm, cfg, planarity_mov=pl_mov, fixed_prep=prep, **f32))


def test_prepared_tensor_inputs_on_their_device():
    """Clouds given as tensors (the serving case: they already lie on the
    run's device) and a preparation of the tensor: bit-equal to numpy
    inputs."""
    Xf, Xm = _pair(15, 2000, 2000)
    cfg = IcpConfig(correspondences=200)
    Tf, Tm = torch.as_tensor(Xf), torch.as_tensor(Xm)
    prep = prepare_fixed(Tf, cfg, **F64)
    _assert_bitequal(icp_register(Xf, Xm, cfg, **F64),
                     icp_register(Tf, Tm, cfg, fixed_prep=prep, **F64))


def test_prepare_fixed_ignores_the_program_budget():
    """The JAX package refuses a preparation whose minimal k-NN block would
    exceed program_budget_s on a TPU (tests/test_prepared.py::
    test_prepare_fixed_watchdog_refusal). The card has no such watchdog, so
    the budget changes nothing here."""
    Xf, _ = _pair(16, 3000, 1)
    tiny = prepare_fixed(Xf, IcpConfig(correspondences=300, program_budget_s=1e-12), **F64)
    _assert_prep_equal(tiny, prepare_fixed(Xf, IcpConfig(correspondences=300,
                                                         program_budget_s=0.0), **F64))
    assert tiny.normals.shape == (300, 3)


def test_save_load_round_trip(tmp_path):
    """FixedPrep.save / load_fixed_prep: bit-exact, and a registration from
    the loaded preparation equals the self-contained run."""
    Xf, Xm = _pair(17, 3000, 3000)
    cfg = IcpConfig(correspondences=300)
    prep = prepare_fixed(Xf, cfg, **F64)
    path = tmp_path / "map_prep.npz"
    prep.save(path)
    loaded = load_fixed_prep(path, device="cpu")
    _assert_prep_equal(prep, loaded)
    assert loaded.sel_idx.dtype == torch.int32 and loaded.Q.dtype == torch.float64
    _assert_bitequal(icp_register(Xf, Xm, cfg, **F64),
                     icp_register(Xf, Xm, cfg, fixed_prep=loaded, **F64))
    with np.load(path) as z:
        assert sorted(z.files) == ["Q", "meta", "normals", "planarity", "sel_idx", "sel_valid"]
        assert z["meta"].dtype == np.int64 and list(z["meta"]) == [3000, 300, 10, 0]
        assert z["sel_valid"].dtype == bool


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_npz_files_cross_load(tmp_path, dtype):
    """A file saved by the JAX package's FixedPrep.save loads in the port,
    and one saved by the port loads in the JAX package's load_fixed_prep,
    every array bit-equal and in its dtype."""
    Xf, _ = _pair(18, 2500, 1)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jp = jax_prepare_fixed(Xf, JaxConfig(correspondences=250, approx_knn=True), dtype=jdt)
    jp.save(tmp_path / "jax.npz")
    from_jax = load_fixed_prep(tmp_path / "jax.npz", device="cpu")
    _assert_prep_equal(from_jax, jp)
    assert from_jax.Q.dtype == dtype and from_jax.approx_knn is True

    tp = prepare_fixed(Xf, IcpConfig(correspondences=250, approx_knn=True),
                       device="cpu", dtype=dtype)
    tp.save(tmp_path / "port.npz")
    _assert_prep_equal(jax_load_fixed_prep(tmp_path / "port.npz"), tp)


def test_converters_carry_a_preparation_both_ways():
    """fixed_prep_from_jax and fixed_prep_to_numpy: the JAX preparation
    consumed by the port's registration equals the port's own prepared run
    within the normals' tolerance, and the port's preparation consumed by
    the JAX package gives the JAX package's prepared result."""
    Xf, Xm = _pair(19, 3000, 3000)
    jcfg = JaxConfig(correspondences=300)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    jp = jax_prepare_fixed(Xf, jcfg, dtype=jnp.float64)
    carried = fixed_prep_from_jax(jp, device="cpu")
    _assert_prep_equal(carried, jp)
    _assert_prep_equal(fixed_prep_to_numpy(carried), jp)
    back = JaxFixedPrep(*fixed_prep_to_numpy(prepare_fixed(Xf, cfg, **F64)))
    jres = jax_register(Xf, Xm, jcfg, fixed_prep=back, dtype=jnp.float64)
    tres = icp_register(Xf, Xm, cfg, fixed_prep=carried, **F64)
    assert int(tres.n_iterations) == int(jres.n_iterations)
    np.testing.assert_array_equal(tres.sel_idx.numpy(), np.asarray(jres.sel_idx))
    np.testing.assert_allclose(tres.H.numpy(), np.asarray(jres.H), rtol=0, atol=1e-9)


def test_prepared_warm_start():
    """warm_start + fixed_prep: the coarse pass prepares its own subsampled
    fixed side, the full pass consumes the preparation. Equal to the warm
    start without it, bit for bit, and to the JAX package's prepared warm
    start (iterations equal, H within 1e-9)."""
    Xf, Xm = _pair(20, 6000, 6000)
    jcfg = JaxConfig(correspondences=500, warm_start=True, warm_start_points=2000)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    prep = prepare_fixed(Xf, cfg, **F64)
    warm = icp_register(Xf, Xm, cfg, fixed_prep=prep, **F64)
    _assert_bitequal(icp_register(Xf, Xm, cfg, **F64), warm)
    jres = jax_register(Xf, Xm, jcfg, fixed_prep=jax_prepare_fixed(Xf, jcfg, dtype=jnp.float64),
                        dtype=jnp.float64)
    assert int(warm.n_iterations) == int(jres.n_iterations)
    np.testing.assert_allclose(warm.H.numpy(), np.asarray(jres.H), rtol=0, atol=1e-9)
    assert bool(warm.converged)


def _errors(Xf, Xm, prep, jprep):
    """(port call, JAX call) pairs that each package must refuse."""
    cfg, jcfg = IcpConfig(correspondences=200), JaxConfig(correspondences=200)
    gated = dict(correspondences=200, max_overlap_distance=1.0)
    return {
        "prepare_gated": (lambda: prepare_fixed(Xf, IcpConfig(max_overlap_distance=1.0), **F64),
                          lambda: jax_prepare_fixed(Xf, JaxConfig(max_overlap_distance=1.0))),
        "gate": (lambda: icp_register(Xf, Xm, IcpConfig(**gated), fixed_prep=prep, **F64),
                 lambda: jax_register(Xf, Xm, JaxConfig(**gated), fixed_prep=jprep)),
        "normals_fix": (
            lambda: icp_register(Xf, Xm, cfg, fixed_prep=prep,
                                 normals_fix=np.ones((2000, 3)), **F64),
            lambda: jax_register(Xf, Xm, jcfg, fixed_prep=jprep,
                                 normals_fix=np.ones((2000, 3)))),
        "correspondences": (
            lambda: icp_register(Xf, Xm, IcpConfig(correspondences=300), fixed_prep=prep, **F64),
            lambda: jax_register(Xf, Xm, JaxConfig(correspondences=300), fixed_prep=jprep)),
        "neighbors": (
            lambda: icp_register(Xf, Xm, IcpConfig(correspondences=200, neighbors=12),
                                 fixed_prep=prep, **F64),
            lambda: jax_register(Xf, Xm, JaxConfig(correspondences=200, neighbors=12),
                                 fixed_prep=jprep)),
        "approx_knn": (
            lambda: icp_register(Xf, Xm, IcpConfig(correspondences=200, approx_knn=True),
                                 fixed_prep=prep, **F64),
            lambda: jax_register(Xf, Xm, JaxConfig(correspondences=200, approx_knn=True),
                                 fixed_prep=jprep)),
        "n_fix": (lambda: icp_register(Xf[:1999], Xm, cfg, fixed_prep=prep, **F64),
                  lambda: jax_register(Xf[:1999], Xm, jcfg, fixed_prep=jprep)),
        "dtype": (lambda: icp_register(Xf, Xm, cfg, fixed_prep=prep, device="cpu",
                                       dtype=torch.float32),
                  lambda: jax_register(Xf, Xm, jcfg, fixed_prep=jprep, dtype=np.float32)),
    }


@pytest.mark.parametrize("name", ["prepare_gated", "gate", "normals_fix", "correspondences",
                                  "neighbors", "approx_knn", "n_fix", "dtype"])
def test_validation_errors_equal_the_jax_package(name):
    """tests/test_prepared.py::test_prepared_validation_errors: each refusal
    in the JAX package's order, with its message."""
    Xf, Xm = _pair(21, 2000, 2000)
    prep = prepare_fixed(Xf, IcpConfig(correspondences=200), **F64)
    jprep = jax_prepare_fixed(Xf, JaxConfig(correspondences=200), dtype=jnp.float64)
    port_call, jax_call = _errors(Xf, Xm, prep, jprep)[name]
    with pytest.raises(ValueError) as ej:
        jax_call()
    with pytest.raises(ValueError) as et:
        port_call()
    assert str(et.value) == str(ej.value)


def test_loaded_float64_preparation_refused_by_a_float32_call(tmp_path):
    """A float64 file is loaded as float64 (never rounded), and a float32
    registration refuses it with the JAX package's message."""
    Xf, Xm = _pair(22, 2000, 2000)
    cfg = IcpConfig(correspondences=200)
    prepare_fixed(Xf, cfg, **F64).save(tmp_path / "p64.npz")
    loaded = load_fixed_prep(tmp_path / "p64.npz", device="cpu")
    assert loaded.Q.dtype == torch.float64
    with pytest.raises(ValueError, match="fixed_prep dtype float64 does not match "
                                         "this call's dtype float32"):
        icp_register(Xf, Xm, cfg, fixed_prep=loaded, device="cpu", dtype=torch.float32)


def test_preparation_on_another_device_is_refused():
    """The one check a JAX array does not need: a preparation's tensors must
    lie on the call's device; they are not copied there. (A call on the
    meta device stands in for the card here: the check runs before any
    compute.)"""
    Xf, Xm = _pair(23, 1000, 1000)
    cfg = IcpConfig(correspondences=100)
    prep = prepare_fixed(Xf, cfg, **F64)
    with pytest.raises(ValueError, match="fixed_prep lies on cpu, but this icp_register "
                                         "call runs on meta"):
        icp_register(Xf, Xm, cfg, fixed_prep=prep, device="meta", dtype=torch.float64)
    moved = prep._replace(normals=prep.normals.to("meta"))
    with pytest.raises(ValueError, match="fixed_prep lies on meta"):
        icp_register(Xf, Xm, cfg, fixed_prep=moved, **F64)


# Prepared cases of tests/test_prepared.py whose engines were not ported and
# raised their ROADMAP item; chunked dispatch (item 12) is ported now.
UNPORTED = {
    "chunked": dict(dispatch="chunked", chunk_iterations=2),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_prepared_cases_raise(name):
    """The formerly refused prepared cases run (tests/test_prepared.py::
    test_prepared_chunked_dispatch): bit-equal to the prepared monolithic
    run and to the self-contained chunked run, and equal to the JAX
    package's prepared chunked run (iterations, selection; H within
    1e-9)."""
    kw = UNPORTED[name]
    Xf, Xm = _pair(24, 2000, 2000)
    cfg = IcpConfig(correspondences=200)
    prep = prepare_fixed(Xf, cfg, **F64)
    res = icp_register(Xf, Xm, dataclasses.replace(cfg, **kw), fixed_prep=prep, **F64)
    for other in (icp_register(Xf, Xm, cfg, fixed_prep=prep, **F64),
                  icp_register(Xf, Xm, dataclasses.replace(cfg, **kw), **F64)):
        for f in res._fields:
            assert torch.equal(getattr(res, f), getattr(other, f)), f
    jcfg = JaxConfig(correspondences=200, **kw)
    jres = jax_register(Xf, Xm, jcfg, fixed_prep=jax_prepare_fixed(Xf, jcfg, dtype=jnp.float64),
                        dtype=jnp.float64)
    assert int(res.n_iterations) == int(jres.n_iterations)
    assert np.array_equal(res.sel_idx.numpy(), np.asarray(jres.sel_idx))
    np.testing.assert_allclose(res.H.numpy(), np.asarray(jres.H), rtol=0, atol=1e-9)


def test_prepared_grid_matcher_equals_self_contained_and_jax():
    """The grid matcher on the prepared path (refused before the grid
    engines were ported): bit-equal to the self-contained grid-matched run,
    and equal to the JAX package's prepared grid-matched run (iterations,
    selection; H within 1e-9)."""
    Xf, Xm = _pair(24, 2000, 2000)
    cfg = IcpConfig(correspondences=200)
    grid = dataclasses.replace(cfg, match_method="grid", match_radius=0.5)
    prep = prepare_fixed(Xf, cfg, **F64)
    prepared = icp_register(Xf, Xm, grid, fixed_prep=prep, **F64)
    _assert_bitequal(prepared, icp_register(Xf, Xm, grid, **F64))
    jgrid = JaxConfig(correspondences=200, match_method="grid", match_radius=0.5)
    jres = jax_register(Xf, Xm, jgrid, dtype=jnp.float64,
                        fixed_prep=jax_prepare_fixed(Xf, JaxConfig(correspondences=200),
                                                     dtype=jnp.float64))
    assert int(prepared.error_code) == int(jres.error_code) == 0
    assert int(prepared.n_iterations) == int(jres.n_iterations)
    np.testing.assert_array_equal(prepared.sel_idx.numpy(), np.asarray(jres.sel_idx))
    np.testing.assert_allclose(prepared.H.numpy(), np.asarray(jres.H), rtol=0, atol=1e-9)

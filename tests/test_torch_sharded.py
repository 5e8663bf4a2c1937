"""The sharded registration of the port (``simpleicp_tpu_torch/parallel/``)
on the CPU: every scenario of tests/test_sharded.py, and the port's own
(prepared fixed side, warm start, movable planarity), through worlds of 1,
2 and 3 processes over gloo, float64.

One world per size runs every scenario once (a module-scoped fixture:
``parallel.launch.run`` starts the processes, world 1 runs in this process)
and every rank's results come back. Pass conditions:
* against the port's ``icp_register`` on the same inputs: every result
  field bit for bit, on every rank (the same per-pair arithmetic, exact
  minima, ties to the lower index);
* against the JAX package's ``icp_register_sharded`` on the conftest's
  virtual CPU mesh (once per scenario, a mesh of 3, or 2 for the lattice
  case): the JAX tests' tolerances, error code, iterations and selected
  indices equal, H and normals within 1e-9;
* the big-C selection against the reference formula on the gate's mask
  computed in numpy, slot for slot.
World 3 leaves padding on both clouds at these sizes.
"""

import socket

import numpy as np
import pytest
import torch

from simpleicp_tpu_torch import IcpConfig, icp_register, prepare_fixed
from simpleicp_tpu_torch.parallel import launch, sharded
from simpleicp_tpu_torch.parallel.mesh import make_mesh

F64 = dict(device="cpu", dtype=torch.float64)
WORLDS = (1, 2, 3)


def _surface(rng, n, half=2.0):
    xy = rng.uniform(-half, half, size=(n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z])


def _lattice_pair():
    """The adversarial lattice of tests/test_sharded.py as whole clouds whose
    two-way blocks are its shards: block 0 (62 rows) holds three full cells
    of chaff, a far point that moves its own minimum half a cell, and the
    lone in-radius witness last; block 1 (61 rows) holds the global minimum
    and far points. Every fixed point lies within the radius (1.0) of the
    witness only, so with a per-block lattice the witness would be cut off
    by the whole-cloud cell cap and the gate would find no overlap."""
    rng = np.random.default_rng(7)
    chaff = [np.column_stack([rng.uniform(x, x + 0.4, 20), rng.uniform(y, y + 0.35, 20),
                              np.zeros(20)])
             for x, y in [(1.0, 1.0), (1.0, 0.6), (0.6, 1.0)]]
    block0 = np.concatenate(chaff + [[[0.5, 0.5, 50.0]], [[0.7, 0.7, 0.0]]])
    block1 = np.concatenate([[[0.0, 0.0, 0.0]], 100.0 + rng.uniform(0, 50, (60, 3))])
    uv = rng.uniform(-0.03, 0.03, (150, 2))
    X_fix = np.column_stack([0.7 + uv, np.full(150, -0.99)])
    return X_fix, np.concatenate([block0, block1])


def _big_c_pair():
    rng = np.random.default_rng(11)
    X_fix = _surface(rng, 80_000)
    mov = _surface(rng, 1000)
    return X_fix, mov[mov[:, 0] > -0.4] - np.array([0.01, 0.0, 0.0])


def _scenarios():
    """name -> (X_fix, X_mov, config kwargs, call kwargs), each from its own
    seed; the call kwargs hold numpy arrays only (the JAX package takes
    them too)."""
    out = {}
    rng = np.random.default_rng(42)
    X = _surface(rng, 4003)
    out["no_gate"] = (X, X - np.array([0.04, -0.03, 0.02]),
                      dict(correspondences=300, max_iterations=30), {})
    X = _surface(rng, 3001)
    half = _surface(rng, 3000)
    out["gate"] = (X, half[half[:, 0] > 0] - np.array([0.02, 0.01, -0.01]),
                   dict(correspondences=200, max_overlap_distance=0.5, max_iterations=30), {})
    X = _surface(rng, 1000)
    out["no_overlap"] = (X, X + 100.0, dict(max_overlap_distance=0.1), {})
    X = _surface(rng, 2000)
    out["frozen"] = (X, X - np.array([0.05, 0.0, 0.01]), dict(correspondences=200),
                     dict(rbp_observed_values=np.zeros(6),
                          rbp_observation_weights=np.array([np.inf] * 3 + [0.0] * 3)))
    X, Y = _surface(rng, 3011), _surface(rng, 2993) - np.array([0.03, 0.01, -0.02])
    gate = dict(correspondences=200, max_iterations=20, max_overlap_distance=0.5)
    for method in ("brute", "grid", "dilate"):
        out[f"gate_{method}"] = (X, Y, dict(gate, gate_method=method), {})
    for method in ("brute", "grid"):
        out[f"gate_{method}_allgather"] = (
            X, Y, dict(gate, gate_method=method, gate_collective="allgather"), {})
    X = _surface(rng, 2500)
    normals = np.tile([0.0, 0.0, 1.0], (2500, 1))
    normals[:, 0] = 0.05 * np.sin(X[:, 0])
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    out["user_normals"] = (X, X - np.array([0.02, -0.01, 0.015]),
                           dict(correspondences=200, max_iterations=20),
                           dict(normals_fix=normals, planarity_fix=np.full(2500, 0.9)))
    X, Y = _lattice_pair()
    out["lattice"] = (X, Y, dict(correspondences=100, max_iterations=5,
                                 max_overlap_distance=1.0, gate_method="grid"), {})
    X, Y = _big_c_pair()
    out["big_c"] = (X, Y, dict(correspondences=47_000, max_iterations=1,
                               max_overlap_distance=0.3),
                    dict(normals_fix=np.tile([0.0, 0.0, 1.0], (X.shape[0], 1))))
    X, Y = _surface(rng, 3005), _surface(rng, 2999) - np.array([0.02, 0.01, -0.015])
    cfg = dict(correspondences=250, max_overlap_distance=0.5, max_iterations=30)
    out["chunk_gate"] = (X, Y, cfg, {})
    out["chunk_gate_k2"] = (X, Y, dict(cfg, dispatch="chunked", chunk_iterations=2), {})
    X, Y = _surface(rng, 3072), _surface(rng, 3050) - np.array([0.02, -0.01, 0.01])
    cfg = dict(correspondences=250, max_overlap_distance=0.5, match_method="grid",
               max_iterations=30)
    out["chunk_grid"] = (X, Y, cfg, {})
    out["chunk_grid_k3"] = (X, Y, dict(cfg, dispatch="chunked", chunk_iterations=3), {})
    X, Y = _surface(rng, 2003), _surface(rng, 2001) - np.array([0.01, 0.02, -0.01])
    obs = dict(rbp_observed_values=np.array([np.deg2rad(-0.5), 0, 0, 0, 0, 0]),
               rbp_observation_weights=np.array([np.inf, np.inf, 0, 0, 0, 0]))
    cfg = dict(correspondences=200, max_overlap_distance=0.5, record_trajectory=True,
               max_iterations=30)
    out["chunk_obs"] = (X, Y, cfg, obs)
    out["chunk_obs_k2"] = (X, Y, dict(cfg, dispatch="chunked", chunk_iterations=2), obs)
    X = _surface(rng, 1000)
    out["chunk_no_overlap"] = (X, X + 100.0, dict(max_overlap_distance=0.1,
                                                  dispatch="chunked", chunk_iterations=2), {})
    # the port's own: a prepared fixed side, a warm start, movable planarity
    X, Y = _surface(rng, 3000), _surface(rng, 3000) - np.array([0.02, 0.01, 0.0])
    out["prepared"] = (X, Y, dict(correspondences=200), {})
    out["warm_start"] = (X[:1500], Y[:1500], dict(correspondences=200, max_overlap_distance=0.5,
                                                  warm_start=True, warm_start_points=500), {})
    out["mov_planarity"] = (X, Y, dict(correspondences=200),
                            dict(planarity_mov=rng.uniform(0.2, 1.0, 3000)))
    return out


SCENARIOS = _scenarios()


def _port_kwargs(name):
    X_fix, X_mov, cfg_kw, kw = SCENARIOS[name]
    cfg = IcpConfig(**cfg_kw)
    kw = dict(kw)
    if name == "prepared":
        kw["fixed_prep"] = prepare_fixed(X_fix, cfg, **F64)
    return dict(X_fix=X_fix, X_mov=X_mov, cfg=cfg, **kw, **F64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process computes on one thread while the module runs, as every
    rank does (``launch``): a CPU reduction over more elements than one
    thread's grain (C = 47 000 here) sums in another order on more threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def singles():
    """The port's icp_register of every scenario."""
    return {name: icp_register(**_port_kwargs(name)) for name in SCENARIOS}


@pytest.fixture(scope="module", params=WORLDS)
def world(request):
    """(size, per-rank list of per-scenario results) of one world that ran
    every scenario."""
    jobs = [_port_kwargs(name) for name in SCENARIOS]
    out = launch.run(request.param, sharded.register_jobs, jobs, device="cpu")
    return request.param, [dict(zip(SCENARIOS, per_rank)) for per_rank in out]


def _assert_equal(a, b, what):
    for field in a._fields:
        va, vb = getattr(a, field).numpy(), getattr(b, field).numpy()
        np.testing.assert_array_equal(va, vb, err_msg=f"{what}: {field}")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_equals_icp_register(world, singles, name):
    """Every rank's result equals the port's unsharded run, field for field."""
    size, ranks = world
    assert len(ranks) == size
    for rank, results in enumerate(ranks):
        _assert_equal(results[name], singles[name], f"world {size} rank {rank} {name}")


@pytest.mark.parametrize("a,b", [("gate_grid", "gate_brute"), ("gate_dilate", "gate_brute"),
                                 ("gate_brute_allgather", "gate_brute"),
                                 ("gate_grid_allgather", "gate_grid"),
                                 ("chunk_gate_k2", "chunk_gate"),
                                 ("chunk_grid_k3", "chunk_grid"),
                                 ("chunk_obs_k2", "chunk_obs")])
def test_sharded_engines_and_dispatch_agree(world, a, b):
    """The grid and dilate gates select what the brute gate selects, the
    all-gather gate equals the ring, chunked equals monolithic: every field
    bit for bit (rank 0)."""
    res = world[1][0]
    _assert_equal(res[a], res[b], f"world {world[0]}: {a} vs {b}")


def test_sharded_no_overlap_and_lattice(world):
    size, ranks = world
    res = ranks[0]
    for name in ("no_overlap", "chunk_no_overlap"):
        assert int(res[name].error_code) == 1, name
        assert int(res[name].n_iterations) == 0, name
    # the witness survives the grid gate on the global lattice: every fixed
    # point is selected
    lat = res["lattice"]
    assert int(lat.error_code) != 1
    assert int(lat.sel_valid.sum()) == 100


def test_sharded_select_n_big_c_exact(world):
    """C = 47 000 (above 46 341, where int32 products overflow) over about
    54 000 survivors: slot for slot the reference formula
    sel[round(linspace(0, n_sel - 1, C))] on the gate's mask, computed in
    numpy with the gate's arithmetic."""
    X_fix, X_mov, cfg_kw, _ = SCENARIOS["big_c"]
    r = cfg_kw["max_overlap_distance"]
    d2 = np.empty(X_fix.shape[0])
    for lo in range(0, X_fix.shape[0], 10_000):
        q = X_fix[lo:lo + 10_000, None, :]
        d = q[..., 0] - X_mov[None, :, 0]
        s = d * d
        d = q[..., 1] - X_mov[None, :, 1]
        s = s + d * d
        d = q[..., 2] - X_mov[None, :, 2]
        s = s + d * d
        d2[lo:lo + 10_000] = s.min(axis=1)
    sel = np.nonzero(d2 <= r * r)[0]
    C = cfg_kw["correspondences"]
    assert sel.shape[0] > C
    ref = sel[np.round(np.linspace(0, sel.shape[0] - 1, C)).astype(np.int64)]
    for rank, res in enumerate(world[1]):
        got = res["big_c"]
        assert bool(got.sel_valid.all())
        np.testing.assert_array_equal(got.sel_idx.numpy().astype(np.int64), ref,
                                      err_msg=f"world {world[0]} rank {rank}")


# JAX comparisons: the JAX package's sharded engine, once per scenario; the
# pairs above carry each result over to its partner scenario (the chunked
# runs, and chunk_gate, the gated brute path of "gate", are not run again).
JAX_CASES = ["no_gate", "gate", "no_overlap", "frozen", "gate_brute", "user_normals",
             "lattice", "chunk_grid", "chunk_obs"]


@pytest.fixture(scope="module")
def jax_results():
    from simpleicp_tpu import IcpConfig as JaxConfig
    from simpleicp_tpu.parallel.mesh import make_mesh as jax_mesh
    from simpleicp_tpu.parallel.sharded import icp_register_sharded as jax_sharded

    out = {}
    for name in JAX_CASES:
        X_fix, X_mov, cfg_kw, kw = SCENARIOS[name]
        mesh = jax_mesh(2 if name == "lattice" else 3)
        out[name] = jax_sharded(X_fix, X_mov, JaxConfig(**cfg_kw), mesh=mesh, **kw)
    return out


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_matches_jax_sharded(singles, jax_results, name):
    """The port (its sharded results equal ``singles`` bit for bit, above)
    against the JAX package's sharded engine: the JAX tests' tolerances.
    The lattice case is held to what its JAX test holds, the gate: every
    match there goes to one point, so its H is ill-conditioned."""
    port, jax = singles[name], jax_results[name]
    assert int(port.error_code) == int(jax.error_code)
    assert int(port.n_iterations) == int(jax.n_iterations)
    valid = np.asarray(jax.sel_valid)
    np.testing.assert_array_equal(port.sel_valid.numpy(), valid)
    np.testing.assert_array_equal(port.sel_idx.numpy()[valid], np.asarray(jax.sel_idx)[valid])
    if int(jax.error_code) == 1 or name == "lattice":
        return
    np.testing.assert_allclose(port.H.numpy(), np.asarray(jax.H), rtol=0, atol=1e-9)
    np.testing.assert_allclose(port.normals.numpy()[valid], np.asarray(jax.normals)[valid],
                               rtol=0, atol=1e-9)


# ---------------------------------------------------------------- one process


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def multihost_group():
    """This process as a multi-host world of one (initialize_multihost over
    tcp://localhost); the group is destroyed afterwards."""
    import torch.distributed as dist

    from simpleicp_tpu_torch.parallel import initialize_multihost, process_info

    assert process_info() == (0, 1)
    threads = torch.get_num_threads()  # initialize_multihost pins a CPU rank
    initialize_multihost(f"localhost:{_free_port()}", 1, 0)
    try:
        yield
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def test_multihost_refusals_and_auto_gate(multihost_group, monkeypatch):
    """Under initialize_multihost no process runs a stage on the whole
    clouds: the warm start and gate_method='dilate' raise the JAX package's
    messages; 'auto' above 2^40 pairs keeps the brute gate (monkeypatched
    threshold); a mesh larger than the group raises; fixed_prep under
    sharding needs at least C fixed points."""
    from simpleicp_tpu_torch.models import icp as icp_mod
    from simpleicp_tpu_torch.parallel import process_info

    assert process_info() == (0, 1)
    mesh = make_mesh()
    assert mesh.multihost and mesh.size == 1 and mesh.rank == 0
    X_fix, X_mov, cfg_kw, _ = SCENARIOS["gate_brute"]
    with pytest.raises(ValueError, match="warm_start is not supported multi-host"):
        sharded.icp_register_sharded(X_fix, X_mov, IcpConfig(warm_start=True), mesh=mesh, **F64)
    with pytest.raises(ValueError, match="needs a single-process run"):
        sharded.icp_register_sharded(X_fix, X_mov, IcpConfig(**dict(cfg_kw, gate_method="dilate")),
                                     mesh=mesh, **F64)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        make_mesh(2)
    small = X_fix[:150]
    prep = prepare_fixed(small, IcpConfig(correspondences=200), **F64)
    with pytest.raises(ValueError, match="at least `correspondences`"):
        sharded.icp_register_sharded(small, X_mov, IcpConfig(correspondences=200),
                                     mesh=mesh, fixed_prep=prep, **F64)
    monkeypatch.setattr(icp_mod, "GATE_AUTO_BRUTE_PAIRS", 1000)
    auto = sharded.icp_register_sharded(X_fix, X_mov, IcpConfig(**dict(cfg_kw, gate_method="auto")),
                                        mesh=mesh, **F64)
    ref = icp_register(X_fix, X_mov, IcpConfig(**dict(cfg_kw, gate_method="brute")), **F64)
    _assert_equal(auto, ref, "multihost auto gate")
    counts = mesh.counts
    assert counts["all_gather"] > 0 and counts["all_reduce"] > 0
    assert "staged_bytes" not in counts  # gloo on CPU tensors stages nothing


def test_mesh_and_launch_errors():
    """Without a process group make_mesh raises; launch.run refuses a world
    of 0 and a card it does not have; a failing rank makes the call raise."""
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    with pytest.raises(ValueError, match="at least one device"):
        launch.run(0, sharded.register_jobs, [], device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run(1, sharded.register_jobs, [])
    bad = dict(X_fix=np.zeros((10, 2)), X_mov=np.zeros((10, 3)), cfg=IcpConfig(), **F64)
    with pytest.raises(Exception, match="shape"):
        launch.run(2, sharded.register_jobs, [bad], device="cpu")


def test_multihost_helpers_single_process():
    """Without a process group this process is rank 0 of 1."""
    from simpleicp_tpu_torch.parallel import process_info

    assert process_info() == (0, 1)

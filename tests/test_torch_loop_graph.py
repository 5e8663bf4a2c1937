"""The ICP loop's iteration as a cached CUDA graph (``models/loop_graph.py``,
``models/icp.py`` ``run_icp_loop``).

On the card (``pytest -m gpu tests/test_torch_loop_graph.py``) the graphed
loop is held bit for bit against the same body run eagerly, which the test
forces by refusing the graph in ``_loop_graph_engages``. On the CPU: where
the graph engages, the counter of the loop's iterations by how they ran,
the cache key and its entries, and the carry's tensors.
"""

import dataclasses

import numpy as np
import pytest
import torch

from simpleicp_tpu_torch import IcpConfig
from simpleicp_tpu_torch.models import icp
from simpleicp_tpu_torch.utils import profiling

# Fields of IcpResult held equal: the solution, the stop, the trajectory.
FIELDS = ("H", "p", "n_iterations", "converged", "error_code", "iter_counts",
          "iter_means", "iter_stds", "orig_count", "orig_mean", "orig_std", "residuals",
          "residual_mask", "distance_weight", "iter_ps", "iter_midx", "iter_masks",
          "iter_dists", "iter_gn_rel_steps")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _surface(rng, n, shift=(0.0, 0.0, 0.0)):
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    return np.column_stack([xy, z]) + np.asarray(shift)


def _pair(seed, n=20000, shift=(0.02, -0.01, 0.01)):
    rng = np.random.default_rng(seed)
    return _surface(rng, n), _surface(rng, n, shift)


def _register(X_fix, X_mov, cfg, device, dtype=torch.float32, **kw):
    args = dict(rbp_observed_values=None, rbp_observation_weights=None, normals_fix=None,
                planarity_fix=None, planarity_mov=None, fixed_prep=None)
    args.update(kw)
    return icp._icp_register(X_fix, X_mov, cfg, device=device, dtype=dtype, **args)


def _loop_counts():
    return profiling.recorded_counters("icp.loop_graph")[-1][2]


def _assert_same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _eager(monkeypatch):
    monkeypatch.setattr(icp, "_loop_graph_engages", lambda device, x: False)


CASES = ["one pair", "batch of 4", "trajectory", "chunked K=1", "chunked K=3", "prepared",
         "linearized", "movable planarity"]


def _run_case(case, dev):
    """The case's registration on ``dev``: (result, final carry or None)."""
    X_fix, X_mov = _pair(31)
    cfg = IcpConfig(correspondences=500, max_iterations=30)
    if case == "batch of 4":
        rng = np.random.default_rng(5)
        shifts = [(0.02, -0.01, 0.01), (0.0, 0.0, 0.0), (0.05, 0.04, -0.02),
                  (-0.03, 0.02, 0.005)]
        Xf = np.stack([_surface(rng, 20000) for _ in shifts])
        Xm = np.stack([_surface(rng, 20000, s) for s in shifts])
        return icp.icp_register_batch(Xf, Xm, cfg, device=dev), None
    if case == "trajectory":
        cfg = dataclasses.replace(cfg, record_trajectory=True)
    if case.startswith("chunked"):
        plan = icp.DispatchPlan("chunked", int(case[-1]))
        return _register(X_fix, X_mov, cfg, dev, plan=plan)
    if case == "prepared":
        Xf = torch.as_tensor(X_fix, dtype=torch.float32, device=dev)
        prep = icp.prepare_fixed(Xf, cfg, device=dev)
        return _register(Xf, X_mov, cfg, dev, fixed_prep=prep)
    if case == "linearized":
        cfg = dataclasses.replace(cfg, solver="linearized")
    if case == "movable planarity":
        pm = np.random.default_rng(3).uniform(0.2, 1.0, len(X_mov))
        return _register(X_fix, X_mov, cfg, dev, planarity_mov=pm)
    return _register(X_fix, X_mov, cfg, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_graph_equals_eager_on_the_card(cuda, case, monkeypatch):
    """Three times through the graphed path (the key's first sighting runs
    eagerly, the second warms up and captures, the third replays every
    iteration), each bit-equal to the eager body on the same card, with the
    same kernel launches counted."""
    from simpleicp_tpu_torch.models import loop_graph
    from simpleicp_tpu_torch.ops import knn_cuda, solver_cuda

    loop_graph.clear()
    launched, results, loops = [], [], []
    for graphed in (True, True, True, False):
        if not graphed:
            _eager(monkeypatch)
        knn_cuda.reset_launch_counts()
        solver_cuda.reset_launch_counts()
        results.append(_run_case(case, cuda))
        torch.cuda.synchronize()
        launched.append((dict(knn_cuda.LAUNCHES), dict(solver_cuda.LAUNCHES)))
        loops.append(_loop_counts())
    eager, eager_c = results[-1]
    n_it = int(eager.n_iterations.max())
    assert n_it >= 3 and int(eager.error_code.max()) == 0
    if case == "batch of 4":
        assert len(set(eager.n_iterations.tolist())) > 1  # the pairs stop apart
    for res, res_c in results[:-1]:
        _assert_same(res, eager)
        if eager_c is not None:
            assert torch.equal(res_c.m_idx, eager_c.m_idx)
    assert launched[0] == launched[1] == launched[2] == launched[3]
    if not case.startswith("chunked"):
        assert loops[0] == loops[3] == {"captures": 0, "replays": 0, "eager": n_it}
        assert loops[1] == {"captures": 2, "replays": n_it - 2, "eager": 2}
        assert loops[2] == {"captures": 0, "replays": n_it, "eager": 0}


@pytest.mark.gpu
def test_replays_every_iteration_once_captured(cuda):
    """A key's first registration runs eagerly and keeps no entry, the
    second captures the two graphs, and the third runs every iteration as a
    replay."""
    from simpleicp_tpu_torch.models import loop_graph

    loop_graph.clear()
    cfg = IcpConfig(correspondences=500, max_iterations=30)
    first, _ = _register(*_pair(40), cfg, cuda)
    assert _loop_counts() == {"captures": 0, "replays": 0, "eager": int(first.n_iterations)}
    assert not any(loop_graph._cache.values())
    second, _ = _register(*_pair(41), cfg, cuda)
    counts = _loop_counts()
    assert counts["captures"] == 2 and counts["eager"] == 2
    again, _ = _register(*_pair(42), cfg, cuda)
    assert _loop_counts() == {"captures": 0, "replays": int(again.n_iterations), "eager": 0}


@pytest.mark.gpu
def test_results_do_not_alias_the_graphs_buffers(cuda):
    """Pair A through the graph, then pair B with the same key: A's result,
    held by the caller, is what it was, and differs from B's."""
    from simpleicp_tpu_torch.models import loop_graph

    loop_graph.clear()
    cfg = IcpConfig(correspondences=500, max_iterations=30)
    _register(*_pair(50), cfg, cuda)  # the key's first sighting
    a, a_c = _register(*_pair(51), cfg, cuda)
    assert _loop_counts()["captures"] == 2
    kept = {f: getattr(a, f).clone() for f in FIELDS}
    kept_m = a_c.m_idx.clone()
    b, _ = _register(*_pair(52, shift=(-0.03, 0.02, 0.01)), cfg, cuda)
    assert _loop_counts()["replays"] == int(b.n_iterations)
    torch.cuda.synchronize()
    for f in FIELDS:
        assert torch.equal(getattr(a, f), kept[f]), f
    assert torch.equal(a_c.m_idx, kept_m)
    assert not torch.equal(a.H, b.H)


def _inputs(B=1, C=50, nm=80, mov_planarity=False):
    Q = torch.zeros((B, C, 3))
    Xm = torch.zeros((B, nm, 3))
    return icp._LoopInputs(Q, Q, Q[..., 0], Q[..., 0] > 0, torch.zeros(B, 6),
                           torch.zeros(B, 6), torch.zeros(()), torch.zeros(B),
                           icp._BruteMatch(Q, Xm),
                           icp._RowsOf(Xm[..., 0]) if mov_planarity else None)


def test_graph_engages_only_on_a_card_with_the_brute_matcher():
    from simpleicp_tpu_torch.parallel import sharded

    card, cpu = torch.device("cuda"), torch.device("cpu")
    x = _inputs()
    assert icp._loop_graph_engages(card, x)
    assert icp._loop_graph_engages(card, _inputs(mov_planarity=True))
    assert not icp._loop_graph_engages(cpu, x)
    # the grid matcher, over a cell list built for this registration
    Xm = torch.as_tensor(_pair(1, n=500)[1], dtype=torch.float32)
    cfg = IcpConfig(correspondences=50, match_method="grid", match_radius=0.2)
    grid = icp._match_grid(Xm, cfg)
    assert not icp._loop_graph_engages(card, x._replace(
        match_fn=icp._make_match_fn(x.Q, Xm[None], cfg, grid=grid)))
    # the sharded matcher, whose collectives pass through the host
    match_fn, _ = sharded._match_fns(None, IcpConfig(correspondences=50), x.Q, Xm, 0, None)
    assert not icp._loop_graph_engages(card, x._replace(match_fn=match_fn))
    # a movable planarity gathered by a function of its own
    assert not icp._loop_graph_engages(card, x._replace(mov_planarity_fn=lambda m: m))
    # a matcher over other queries than the loop's
    assert not icp._loop_graph_engages(card, x._replace(
        match_fn=icp._BruteMatch(x.Q.clone(), Xm[None])))


@pytest.mark.parametrize("case", ["one pair", "batch", "chunked K=2"])
def test_counter_counts_every_iteration_eager_on_the_cpu(case):
    X_fix, X_mov = _pair(7, n=3000)
    cfg = IcpConfig(correspondences=300, max_iterations=30)
    if case == "batch":
        res = icp.icp_register_batch(np.stack([X_fix, X_fix]), np.stack([X_mov, X_fix]),
                                     cfg, device="cpu")
        n_it = int(res.n_iterations.max())
        counts = [_loop_counts()]
    else:
        plan = icp.DispatchPlan("chunked", 2) if case.startswith("chunked") else None
        before = len(profiling.recorded_counters("icp.loop_graph"))
        res, _ = _register(X_fix, X_mov, cfg, "cpu", plan=plan)
        n_it = int(res.n_iterations)
        counts = [v for _, _, v in profiling.recorded_counters("icp.loop_graph")[before:]]
    assert n_it >= 3
    assert sum(c["eager"] for c in counts) == n_it
    assert all(c["replays"] == 0 and c["captures"] == 0 for c in counts)


KEY_FIELDS = dict(solver="linearized", rejection_staging="joint", mad_scale=1.0,
                  min_change=0.5, std_ddof=1, distance_weights=None, gn_iterations=12,
                  max_iterations=50, record_trajectory=True)


@pytest.mark.parametrize("change", ["B", "C", "movable length", "dtype", "movable planarity",
                                    *KEY_FIELDS])
def test_cache_key_changes_with_what_the_graph_bakes_in(change):
    cfg = IcpConfig(correspondences=50)
    x = _inputs()
    key = icp._loop_graph_key(x, cfg)
    if change == "B":
        x = _inputs(B=2)
    elif change == "C":
        x = _inputs(C=51)
    elif change == "movable length":
        x = _inputs(nm=81)
    elif change == "dtype":
        x = x._replace(Q=x.Q.double())
    elif change == "movable planarity":
        x = _inputs(mov_planarity=True)
    else:
        cfg = dataclasses.replace(cfg, **{change: KEY_FIELDS[change]})
    assert icp._loop_graph_key(x, cfg) != key
    # what the loop reads from its inputs leaves the key as it is
    for same in (dict(min_planarity=0.5), dict(convergence_floor_scale=8.0),
                 dict(distance_weights=2.0), dict(neighbors=20)):
        assert icp._loop_graph_key(_inputs(), dataclasses.replace(
            IcpConfig(correspondences=50), **same)) == key


@pytest.mark.parametrize("B", [1, 3])
def test_carry_init_is_the_loops_entry_state_in_tensors_of_its_own(B):
    """make_carry_init's values are the loop's entry state, and each of its
    tensors has memory of its own: the loop writes them in place, and a
    field a caller keeps holds nothing else."""
    cfg = IcpConfig(correspondences=20, max_iterations=7, record_trajectory=B == 3)
    obs = torch.arange(6 * B, dtype=torch.float32).reshape(B, 6) / 100
    H0 = icp.rbp_to_H(obs)
    error0 = np.array([icp.ERR_OK] * (B - 1) + [icp.ERR_NO_OVERLAP], np.int32)
    c = icp.make_carry_init(cfg, torch.float32, obs, H0, error0)
    tensors = icp._tensors(c)
    assert ("n_it" in tensors) == (B > 1) and len(tensors) == len(c) - 2 - (B == 1)
    storages = {t.untyped_storage().data_ptr() for t in tensors.values()}
    assert len(storages) == len(tensors)
    assert not storages & {obs.data_ptr(), H0.data_ptr()}
    for t in tensors.values():
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    assert torch.equal(c.p, obs) and torch.equal(c.H, H0)
    assert c.error.tolist() == error0.tolist() and c.go == (B > 1)
    c.error.fill_(icp.ERR_OK)
    assert error0[-1] == icp.ERR_NO_OVERLAP  # the host's codes are not written
    assert torch.isinf(c.prev_mean).all() and torch.isinf(c.prev_std).all()
    assert (c.dist_w == 1.0).all() and not c.converged.any() and not c.flag.any()
    assert int(c.it_dev) == 0 and c.iter_ps.shape == (B, 7 if B == 3 else 1, 6)


def test_result_saves_and_loads(tmp_path):
    """A result saves and loads whole, and each field the loop fills holds
    memory of its own: kept or saved alone, it holds nothing else."""
    X_fix, X_mov = _pair(9, n=2000)
    res = icp.icp_register(X_fix, X_mov, IcpConfig(correspondences=200), device="cpu")
    torch.save(res, tmp_path / "res.pt")
    back = torch.load(tmp_path / "res.pt", weights_only=False)
    for f in res._fields:
        assert torch.equal(getattr(back, f), getattr(res, f)), f
    for f in ("H", "p", "converged", "error_code", "iter_counts", "iter_means", "orig_count",
              "residuals", "residual_mask", "distance_weight", "iter_ps", "iter_gn_rel_steps"):
        t = getattr(res, f)
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), f


def test_cache_makes_each_entry_once_and_keeps_the_newest():
    """Threads asking for one key at once: the first sighting gets none,
    the others one entry, made once; the cache keeps ``ENTRIES`` keys a
    device, the least recently used out."""
    import sys
    import threading

    from simpleicp_tpu_torch.models import loop_graph

    dev = torch.device("cuda", 7)  # a key of the cache only: nothing runs there
    loop_graph.clear()
    made, got = [], []

    def ask():
        got.append(loop_graph.entry(dev, "a", lambda: made.append("a") or "state"))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert made == ["a"] and len(got) == 32 and got.count(None) == 1
    entries = [g for g in got if g is not None]
    assert all(g is entries[0] for g in entries)
    assert entries[0].state == "state" and entries[0].graphs == {}
    for key in "bcde":
        for _ in range(2):
            loop_graph.entry(dev, key, lambda: key)
    assert list(loop_graph._cache[dev]) == ["b", "c", "d", "e"][-loop_graph.ENTRIES:]
    loop_graph.entry(dev, "c", lambda: "never made")
    assert list(loop_graph._cache[dev])[-1] == "c"
    assert loop_graph.entry(dev, "c", lambda: "never made").state == "c"
    loop_graph.clear()


def test_a_key_seen_once_gets_no_entry():
    """A key's first sighting makes nothing; its second makes the entry.
    The cache notes the last ``SEEN`` keys a device, so a key noted before
    ``SEEN`` others counts as new again."""
    from simpleicp_tpu_torch.models import loop_graph

    dev = torch.device("cuda", 7)  # a key of the cache only: nothing runs there
    loop_graph.clear()
    made = []
    for n in range(loop_graph.SEEN + 1):
        assert loop_graph.entry(dev, n, lambda: made.append(n)) is None
    assert not made and not loop_graph._cache[dev]
    assert loop_graph.entry(dev, 0, lambda: made.append(0)) is None  # forgotten
    assert loop_graph.entry(dev, loop_graph.SEEN, lambda: made.append("x") or "s").state == "s"
    assert made == ["x"] and list(loop_graph._cache[dev]) == [loop_graph.SEEN]
    assert loop_graph.SEEN not in loop_graph._seen[dev]
    loop_graph.clear()

"""The port's multi-host path in real processes: the counterpart of
tests/test_multihost.py.

Two OS processes (this file run as a script) join one process group through
``initialize_multihost`` over tcp://localhost (gloo on the CPU), each moves
only its own row block of the clouds to its device, and both run the
sharded registration. Both must hold the identical replicated result, equal
to the port's ``icp_register`` bit for bit (float64, one thread, as the
ranks) and to the JAX package's single-device engine within 1e-9 (the
tolerance of tests/test_multihost.py). The script imports torch and the
port only.

A second scenario starts its two processes at different torch thread counts
(1 and 2, as hosts with different core counts would) on a pair with
C = 47 000 correspondences, above the row count where a CPU reduction
splits over threads: ``initialize_multihost`` pins each CPU process to one
thread, so both still hold the same bits.

    python tests/test_torch_multihost.py <rank> <world> <port> <out prefix> [threads]
"""

import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene():
    """The synthetic scene of tests/multihost_worker.py, identical on every
    process."""
    rng = np.random.default_rng(7)
    n = 6000
    xy = rng.uniform(-2, 2, size=(n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    X_fix = np.column_stack([xy, z])
    a1, a2, a3 = 0.02, -0.015, 0.03
    t = np.array([0.05, -0.04, 0.03])
    c1, s1, c2, s2, c3, s3 = (np.cos(a1), np.sin(a1), np.cos(a2), np.sin(a2),
                              np.cos(a3), np.sin(a3))
    R = np.array([
        [c2 * c3, -c2 * s3, s2],
        [c1 * s3 + s1 * s2 * c3, c1 * c3 - s1 * s2 * s3, -s1 * c2],
        [s1 * s3 - c1 * s2 * c3, s1 * c3 + c1 * s2 * s3, c1 * c2],
    ])
    return X_fix, (X_fix - t) @ R


# The thread-count scenario: C above the grain of a CPU reduction (32 768
# elements; every sum over the C rows splits over threads above it), a
# movable cloud small enough to keep the brute match cheap, and the fixed
# surface's exact normals, which skip the k-NN.
BIG_C, BIG_NF, BIG_NM = 47_000, 48_000, 2_000


def _big_scene():
    """The thread-count scenario's pair and the fixed cloud's normals."""
    rng = np.random.default_rng(11)
    xy = rng.uniform(-2, 2, size=(BIG_NF, 2))
    gx, gy = 0.6 * np.cos(2 * xy[:, 0]), -0.6 * np.sin(3 * xy[:, 1])
    X_fix = np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])
    normals = np.column_stack([-gx, -gy, np.ones(BIG_NF)])
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    _, X_mov = _scene()
    return X_fix, X_mov[:BIG_NM], normals


def _worker(rank: int, world: int, port: str, out: str, threads: int = 0) -> None:
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(threads or 1)
    from simpleicp_tpu_torch import IcpConfig
    from simpleicp_tpu_torch.parallel import (icp_register_sharded, initialize_multihost,
                                              make_mesh, process_info)

    initialize_multihost(f"localhost:{port}", world, rank)
    assert process_info() == (rank, world), process_info()
    mesh = make_mesh()
    assert mesh.multihost and (mesh.rank, mesh.size) == (rank, world)
    if threads:
        X_fix, X_mov, normals = _big_scene()
        res = icp_register_sharded(X_fix, X_mov,
                                   IcpConfig(correspondences=BIG_C, max_iterations=4),
                                   mesh=mesh, normals_fix=normals, device="cpu",
                                   dtype=torch.float64)
    else:
        X_fix, X_mov = _scene()
        res = icp_register_sharded(X_fix, X_mov,
                                   IcpConfig(correspondences=500, max_iterations=30),
                                   mesh=mesh, device="cpu", dtype=torch.float64)
    assert int(res.error_code) == 0
    np.savez(f"{out}.{rank}.npz", **{f: getattr(res, f).numpy() for f in res._fields},
             collectives=sum(v for k, v in mesh.counts.items() if k != "staged_bytes"))
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "simpleicp_tpu")]
    assert not bad, bad
    print("WORKER_OK", rank, "threads", torch.get_num_threads(), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(out: str, threads=(), timeout: float = 120.0) -> list:
    """Both workers, at ``threads`` (one count a rank; none: the small
    scenario), each to its end or killed at ``timeout``; their outputs."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(i), "2",
                               str(port), out, *[str(t) for t in threads[i:i + 1]]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              cwd=ROOT)
             for i in range(2)]
    outputs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outputs.append(stdout.decode(errors="replace"))
    for i, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"worker {i} failed:\n{text[-4000:]}"
        assert f"WORKER_OK {i}" in text
    return outputs


def _assert_replicated(out: str):
    """Both processes hold the identical replicated result; returns rank 0's."""
    r0, r1 = np.load(f"{out}.0.npz"), np.load(f"{out}.1.npz")
    for f in r0.files:
        np.testing.assert_array_equal(r0[f], r1[f], err_msg=f)
    return r0


def test_two_process_sharded_registration(tmp_path):
    import torch

    out = str(tmp_path / "mh")
    _run_world(out)
    r0 = _assert_replicated(out)
    assert bool(r0["converged"]) and int(r0["collectives"]) > 0

    from simpleicp_tpu import IcpConfig as JaxConfig
    from simpleicp_tpu import icp_register as jax_register
    from simpleicp_tpu_torch import IcpConfig, icp_register

    X_fix, X_mov = _scene()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = icp_register(X_fix, X_mov, IcpConfig(correspondences=500, max_iterations=30),
                           device="cpu", dtype=torch.float64)
    finally:
        torch.set_num_threads(threads)
    for f in ref._fields:
        np.testing.assert_array_equal(r0[f], getattr(ref, f).numpy(), err_msg=f)
    jax = jax_register(X_fix, X_mov, JaxConfig(correspondences=500, max_iterations=30))
    np.testing.assert_allclose(r0["H"], np.asarray(jax.H), rtol=0, atol=1e-9)
    assert int(r0["n_iterations"]) == int(jax.n_iterations)


def test_ranks_at_different_thread_counts_agree(tmp_path):
    """Ranks started at 1 and 2 torch threads, float64, C = 47 000: each
    CPU process runs on one thread once initialize_multihost has joined it,
    so the replicated state (H, the stop flag, every result field) is the
    same bits on both, and neither waits in a collective the other skipped."""
    out = str(tmp_path / "mh")
    outputs = _run_world(out, threads=(1, 2), timeout=150)
    r0 = _assert_replicated(out)
    for i, text in enumerate(outputs):
        assert f"WORKER_OK {i} threads 1" in text, text[-2000:]
    assert int(r0["error_code"]) == 0 and int(r0["collectives"]) > 0
    assert int(r0["sel_valid"].sum()) == BIG_C


def test_initialize_multihost_pins_a_cpu_process(caplog):
    """A process without a card runs on one torch thread after
    initialize_multihost, and the log says so."""
    import logging

    import torch
    import torch.distributed as dist

    from simpleicp_tpu_torch.parallel import initialize_multihost

    before = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        with caplog.at_level(logging.INFO, logger="simpleicp_tpu_torch.parallel.multihost"):
            initialize_multihost(f"localhost:{_free_port()}", 1, 0)
        try:
            assert torch.get_num_threads() == 1
        finally:
            dist.destroy_process_group()
        assert any("one torch thread" in r.getMessage() for r in caplog.records)
    finally:
        torch.set_num_threads(before)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            int(sys.argv[5]) if len(sys.argv) > 5 else 0)

"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import simpleicp_tpu_torch
from simpleicp_tpu_torch import IcpConfig, icp_register

ROOT = Path(simpleicp_tpu_torch.__file__).resolve().parent.parent


def test_import_pulls_in_no_jax():
    code = (
        "import sys; import simpleicp_tpu_torch, simpleicp_tpu_torch.ops.knn, "
        "simpleicp_tpu_torch.ops.dilate_gate, simpleicp_tpu_torch.ops.dilate_cuda, "
        "simpleicp_tpu_torch.ops.gridhash, "
        "simpleicp_tpu_torch.models.icp, simpleicp_tpu_torch.utils.xyz_io, "
        "simpleicp_tpu_torch.native, simpleicp_tpu_torch.utils.profiling, "
        "simpleicp_tpu_torch.cli, simpleicp_tpu_torch.metrics, "
        "simpleicp_tpu_torch.parallel.launch, simpleicp_tpu_torch.parallel.sharded; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'simpleicp_tpu' or m.startswith('simpleicp_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_import_builds_nothing():
    """Importing the kernels' wrappers, the native I/O library's loader and
    the re-exporting subpackages compiles and loads nothing: no build was
    asked for (``_build.BUILD_LOGS`` records every library built or found)
    and no library handle is held. (The build directory itself is not
    compared: other tests may build the native library into it at the same
    moment.)"""
    code = ("import simpleicp_tpu_torch.ops.knn_cuda as k, simpleicp_tpu_torch._build as b, "
            "simpleicp_tpu_torch.ops.dilate_cuda as d, simpleicp_tpu_torch.ops.dilate_gate, "
            "simpleicp_tpu_torch.ops.solver_cuda as s, "
            "simpleicp_tpu_torch.native as n, simpleicp_tpu_torch.ops, "
            "simpleicp_tpu_torch.utils, simpleicp_tpu_torch.models; "
            "held = [m.__name__ for m in (k, d, s, n) if m._lib is not None]; "
            "print(dict(b.BUILD_LOGS), held); "
            "raise SystemExit(1 if b.BUILD_LOGS or held else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _port_sources():
    pkg = ROOT / "simpleicp_tpu_torch"
    files = sorted(pkg.rglob("*.py")) + sorted(pkg.rglob("*.cu")) + sorted(pkg.rglob("*.cpp"))
    return files + [ROOT / "chip_smoke.py"]


def test_sources_name_no_jax():
    files = _port_sources()
    names = {f.name for f in files}
    assert {"knn.cu", "dilate.cu", "solver.cu", "dilate_gate.py", "dilate_cuda.py",
            "solver_cuda.py", "gridhash.py", "xyz_parser.cpp", "xyz_writer.cpp",
            "profiling.py"} <= names
    jax_import = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    jax_pkg = re.compile(r"simpleicp_tpu(?!_torch)\b")
    for f in files:
        text = f.read_text()
        assert not jax_import.search(text), f"{f} imports jax"
        code_lines = [ln for ln in text.splitlines()
                      if ln.lstrip().startswith(("import ", "from "))]
        for ln in code_lines:
            assert not jax_pkg.search(ln), f"{f} imports the JAX package: {ln}"


def test_sources_import_no_jax_package_anywhere():
    """No reference to the JAX package's modules as code (only as
    documentation of what a kernel replaces)."""
    pat = re.compile(r"(import|from)\s+simpleicp_tpu(?!_torch)")
    for f in _port_sources():
        assert not pat.search(f.read_text()), f


def test_no_cuda_means_an_error_not_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).uniform(0, 1, (100, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        icp_register(X, X, IcpConfig(correspondences=10))


def test_cpu_tensor_never_reaches_a_kernel(monkeypatch):
    """On CPU tensors the wrappers are not called at all: the plain
    versions run because the tensors lie on the CPU."""
    from simpleicp_tpu_torch.ops import dilate_cuda, knn_cuda, solver_cuda

    def boom(*a, **k):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    monkeypatch.setattr(knn_cuda, "match_transform_cuda", boom)
    monkeypatch.setattr(knn_cuda, "knn_search_cuda", boom)
    monkeypatch.setattr(knn_cuda, "nn_search_cuda", boom)
    monkeypatch.setattr(knn_cuda, "nn_d2_cuda", boom)
    monkeypatch.setattr(dilate_cuda, "dilate_cuda", boom)
    monkeypatch.setattr(solver_cuda, "gn_solve_cuda", boom)
    monkeypatch.setattr(solver_cuda, "uncertainties_cuda", boom)
    X = np.random.default_rng(1).uniform(-1, 1, (400, 3)) * [1, 1, 0.1]
    res = icp_register(X, X + 0.01, IcpConfig(correspondences=30), device="cpu")
    assert int(res.error_code) == 0
    res = icp_register(X, X + 0.01, IcpConfig(correspondences=30,
                                              max_overlap_distance=0.5),
                       device="cpu")
    assert int(res.error_code) == 0
    res = icp_register(X, X + 0.01, IcpConfig(correspondences=30,
                                              max_overlap_distance=0.5,
                                              gate_method="dilate"),
                       device="cpu")
    assert int(res.error_code) == 0


@pytest.mark.parametrize("lead", [(), (3,)])
def test_cpu_tensor_never_reaches_the_uncertainty_kernel(monkeypatch, lead):
    """The finish's uncertainties on CPU tensors, with and without a pair
    axis and through the batch: the plain version, never the wrapper."""
    from simpleicp_tpu_torch import icp_register_batch
    from simpleicp_tpu_torch.models import solver
    from simpleicp_tpu_torch.ops import solver_cuda

    def boom(*a, **k):
        raise AssertionError("uncertainties_cuda called for a CPU tensor")

    monkeypatch.setattr(solver_cuda, "uncertainties_cuda", boom)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(*lead, 20, 3)))
    n = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(*lead, 20, 3))), dim=-1)
    p = torch.zeros((*lead, 6), dtype=torch.float64)
    sig, cov = solver.estimate_uncertainties(
        p, x, x + 0.01, n, torch.ones((*lead, 20), dtype=torch.bool),
        torch.ones(lead, dtype=torch.float64), p, p)
    assert sig.shape == (*lead, 6) and cov.shape == (*lead, 6, 6)
    if lead:
        X = rng.uniform(-1, 1, (3, 400, 3)) * [1, 1, 0.1]
        res = icp_register_batch(X, X + 0.01, IcpConfig(correspondences=30), device="cpu")
        assert res.uncertainties.shape == (3, 6)


def test_wrappers_refuse_cpu_tensors():
    from simpleicp_tpu_torch.ops import dilate_cuda, knn_cuda, solver_cuda

    with pytest.raises(ValueError, match="CUDA"):
        dilate_cuda.dilate_cuda(torch.zeros((1, 4, 4), dtype=torch.int32), [((0, 0, 1),)])
    q = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        knn_cuda.match_transform_cuda(q, q, torch.eye(4))
    with pytest.raises(ValueError, match="CUDA"):
        knn_cuda.knn_search_cuda(q, q, 2)
    with pytest.raises(ValueError, match="CUDA"):
        knn_cuda.nn_search_cuda(q, q)
    with pytest.raises(ValueError, match="CUDA"):
        knn_cuda.nn_d2_cuda(q, q)
    x, p = torch.zeros((1, 4, 3)), torch.zeros((1, 6))
    with pytest.raises(ValueError, match="CUDA"):
        solver_cuda.gn_solve_cuda(p, x, x, x, torch.ones((1, 4), dtype=torch.bool),
                                  torch.ones(1), p, p, 24)
    with pytest.raises(ValueError, match="CUDA"):
        solver_cuda.uncertainties_cuda(p, x, x, x, torch.ones((1, 4), dtype=torch.bool),
                                       torch.ones(1), p, p)


def _xyz_pair(tmp_path):
    from simpleicp_tpu_torch.utils.xyz_io import write_xyz

    rng = np.random.default_rng(3)
    xy = rng.uniform(-1, 1, (600, 2))
    X = np.column_stack([xy, 0.2 * np.sin(3 * xy[:, 0])])
    f1, f2 = tmp_path / "a.xyz", tmp_path / "b.xyz"
    write_xyz(f1, X, fmt="%.6f")
    write_xyz(f2, X + [0.01, 0.0, 0.0], fmt="%.6f")
    return f1, f2


def test_cli_subprocess_imports_no_jax(tmp_path):
    """``python -m simpleicp_tpu_torch`` runs a gated registration on the
    CPU and imports neither JAX nor the JAX package (-X importtime lists
    every module it imported)."""
    f1, f2 = _xyz_pair(tmp_path)
    out = tmp_path / "out.xyz"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "simpleicp_tpu_torch",
         "-f", str(f1), "-m", str(f2), "-o", "0.2", "-c", "100",
         "--device", "cpu", "--export", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    modules = [ln.rsplit("|", 1)[1].strip() for ln in proc.stderr.splitlines()
               if ln.startswith("import time:") and ln.count("|") == 2]
    assert "simpleicp_tpu_torch.cli" in modules
    bad = [m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "simpleicp_tpu")]
    assert not bad, bad
    assert "orig:0" in proc.stderr and "Finished in" in proc.stderr
    assert out.exists()


def test_no_cuda_means_the_cli_and_class_api_raise(monkeypatch, tmp_path):
    """Without a card the CLI's default device, SimpleICP and the
    PointCloud methods raise instead of running on the CPU."""
    from simpleicp_tpu_torch import PointCloud, SimpleICP
    from simpleicp_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f1, f2 = _xyz_pair(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-f", str(f1), "-m", str(f2), "--quiet"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-f", str(f1), "-m", str(f2), "--quiet", "--device", "cuda"])
    X = np.random.default_rng(4).uniform(0, 1, (100, 3))
    icp = SimpleICP(verbose=False)
    icp.add_point_clouds(PointCloud(X), PointCloud(X))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        icp.run(correspondences=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PointCloud(X).estimate_normals(5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        icp_register(X, X, IcpConfig(correspondences=10, max_overlap_distance=1.0))


def test_spawned_rank_imports_no_jax():
    """A rank that ``parallel.launch`` spawns (the entry point of
    ``SimpleICP.run(num_devices=n)``) holds no JAX and no JAX package in
    sys.modules after running the sharded registration. The rank runs
    ``eval`` (a builtin, so the child unpickles nothing of this module) of
    the registration followed by the module listing."""
    from simpleicp_tpu_torch.parallel import launch, sharded

    X = np.random.default_rng(5).uniform(-1, 1, (400, 3)) * [1, 1, 0.1]
    job = dict(X_fix=X, X_mov=X + 0.01, cfg=IcpConfig(correspondences=30), device="cpu")
    code = ("(register_jobs(jobs), sorted(m for m in __import__('sys').modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'simpleicp_tpu') "
            "or m.startswith('simpleicp_tpu_torch.parallel')))")
    out = launch.run(2, eval, code, {"register_jobs": sharded.register_jobs, "jobs": [job]},
                     device="cpu")
    for results, modules in out:
        assert int(results[0].error_code) == 0
        assert "simpleicp_tpu_torch.parallel.sharded" in modules
        assert all(m.startswith("simpleicp_tpu_torch.parallel") for m in modules), modules

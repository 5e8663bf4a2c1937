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
        "simpleicp_tpu_torch.cli, simpleicp_tpu_torch.metrics; "
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
    build_dir = ROOT / "simpleicp_tpu_torch" / "_build"
    before = sorted(build_dir.iterdir()) if build_dir.exists() else []
    code = ("import simpleicp_tpu_torch.ops.knn_cuda, simpleicp_tpu_torch._build, "
            "simpleicp_tpu_torch.ops.dilate_cuda, simpleicp_tpu_torch.ops.dilate_gate")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    after = sorted(build_dir.iterdir()) if build_dir.exists() else []
    assert after == before


def _port_sources():
    pkg = ROOT / "simpleicp_tpu_torch"
    files = sorted(pkg.rglob("*.py")) + sorted(pkg.rglob("*.cu"))
    return files + [ROOT / "chip_smoke.py"]


def test_sources_name_no_jax():
    files = _port_sources()
    names = {f.name for f in files}
    assert {"knn.cu", "dilate.cu", "dilate_gate.py", "dilate_cuda.py", "gridhash.py"} <= names
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
    from simpleicp_tpu_torch.ops import dilate_cuda, knn_cuda

    def boom(*a, **k):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    monkeypatch.setattr(knn_cuda, "match_transform_cuda", boom)
    monkeypatch.setattr(knn_cuda, "knn_search_cuda", boom)
    monkeypatch.setattr(knn_cuda, "nn_search_cuda", boom)
    monkeypatch.setattr(knn_cuda, "nn_d2_cuda", boom)
    monkeypatch.setattr(dilate_cuda, "dilate_cuda", boom)
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


def test_wrappers_refuse_cpu_tensors():
    from simpleicp_tpu_torch.ops import dilate_cuda, knn_cuda

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

"""The port's ``utils/device_policy.py`` and the CLI's ``--device auto``,
on the CPU, against the JAX package's routing decisions.

The JAX package routes between its CPU backend and the TPU ("default");
the port between the CPU and the card ("cuda"). The rates differ (the
port's are the card's and its host CPU's), so decisions are compared on
the same estimates: the same choice gives the same route whenever both
packages' CPU estimates fall on the same side of their thresholds.
"""

import math

import numpy as np
import pytest
import torch

from simpleicp_tpu.utils import device_policy as jax_policy
from simpleicp_tpu_torch.cli import main
from simpleicp_tpu_torch.utils import device_policy
from simpleicp_tpu_torch.utils.xyz_io import write_xyz

_ROUTE = {"cpu": "cpu", "default": "cuda"}


def test_holds_no_tpu_rate():
    names = [n for n in vars(device_policy) if n.isupper()]
    assert not [n for n in names if n.startswith("TPU")]
    assert {"GPU_SWEEP_PAIRS_PER_SEC", "GPU_KNN10_PAIRS_PER_SEC", "GPU_GATHER_ELEMS_PER_SEC",
            "GPU_SORT_ELEMS_PER_SEC", "CPU_ROUTE_MAX_SEC"} <= set(names)
    assert not hasattr(device_policy, "apply_device")
    for name in names:
        if name.startswith("GPU_"):
            assert getattr(device_policy, name) != getattr(jax_policy, "TPU" + name[3:])


@pytest.mark.parametrize("choice", ["cpu", "cuda", "auto"])
@pytest.mark.parametrize("n", [2_000, 50_000, 2_000_000])
def test_resolve_device_follows_the_jax_decisions(choice, n, monkeypatch):
    """With the JAX package's CPU estimate and threshold set to the port's,
    both packages take the same route; "cuda" is the JAX package's "tpu"."""
    for name in ("CPU_GATE_PAIRS_PER_SEC", "CPU_LOOP_PAIRS_PER_SEC", "CPU_ROUTE_MAX_SEC"):
        monkeypatch.setattr(jax_policy, name, getattr(device_policy, name))
    # the JAX estimate has one rate for the k-NN and the match; make them one
    monkeypatch.setattr(device_policy, "CPU_KNN10_PAIRS_PER_SEC",
                        device_policy.CPU_LOOP_PAIRS_PER_SEC)
    for gate in (math.inf, 0.1):
        kw = dict(correspondences=1000, max_overlap_distance=gate, max_iterations=100)
        want = _ROUTE[jax_policy.resolve_device({"cuda": "tpu"}.get(choice, choice), n, n, **kw)]
        assert device_policy.resolve_device(choice, n, n, **kw) == want
        assert device_policy.resolve_device(choice, n, n, sharded=True, **kw) == (
            "cpu" if choice == "cpu" else "cuda")


def test_resolve_device_sizes_and_errors():
    assert device_policy.resolve_device("auto", 2500, 2500) == "cpu"
    assert device_policy.resolve_device("auto", 10**6, 10**6) == "cuda"
    with pytest.raises(ValueError, match="unknown device choice"):
        device_policy.resolve_device("tpu", 10, 10)
    est = device_policy.estimate_cpu_seconds(10**5, 10**5, max_overlap_distance=0.1)
    assert est > device_policy.estimate_cpu_seconds(10**5, 10**5)


def test_estimates_are_the_stage_sums():
    """The program estimate is the stage sum, and big-C (C=100 000 x 12.5M,
    the grid matcher at cap 48) stays far inside the default budget of 30 s,
    so that every cell of the card runs monolithic by default."""
    nf = nm = 12_500_000
    stages = device_policy.estimate_gpu_stage_seconds(
        nf, nm, correspondences=100_000, match_method="grid", match_cell_cap=48)
    est = device_policy.estimate_gpu_program_seconds(
        nf, nm, correspondences=100_000, match_method="grid", match_cell_cap=48,
        iterations=10)
    np.testing.assert_allclose(est, sum(stages[:3]) + 10 * stages[3], rtol=1e-12)
    assert est < 0.1 * 30.0
    assert device_policy.estimate_gpu_stage_seconds(nf, nm, has_normals=True)[1] == 0.0
    gate = device_policy.estimate_gpu_stage_seconds(10**6, 10**6, gate_pairs=1e12)[0]
    np.testing.assert_allclose(gate, 1e12 / device_policy.GPU_SWEEP_PAIRS_PER_SEC)


@pytest.mark.parametrize("choice", ["auto", "cuda"])
@pytest.mark.parametrize("status", ["ok", "timeout", "error"])
@pytest.mark.parametrize("cpu_est", [10.0, 1e5])
def test_degraded_fallback_follows_the_jax_decisions(choice, status, cpu_est):
    j_route, j_msg = jax_policy.degraded_fallback({"cuda": "tpu"}.get(choice, choice),
                                                  status, cpu_est)
    route, msg = device_policy.degraded_fallback(choice, status, cpu_est)
    assert route == _ROUTE[j_route]
    assert (msg is None) == (j_msg is None)
    if status != "ok":
        assert ("did not answer" if status == "timeout" else "failed") in msg
        assert ("routing this registration to the CPU" in msg) == (route == "cpu")


def test_probe_without_a_card_reports_an_error():
    status, backend, seconds = device_policy.probe_default_backend(120.0)
    if torch.cuda.is_available():
        assert (status, backend) == ("ok", "cuda")
    else:
        assert (status, backend) == ("error", "")
    assert seconds > 0


def test_probe_until_healthy(monkeypatch):
    answers = iter(["timeout", "error", "ok"])
    monkeypatch.setattr(device_policy, "probe_default_backend",
                        lambda t: (next(answers), "", 0.01))
    assert device_policy.probe_until_healthy(1.0, budget_s=10.0, sleep_s=0.0)
    monkeypatch.setattr(device_policy, "probe_default_backend", lambda t: ("timeout", "", t))
    assert not device_policy.probe_until_healthy(0.01, budget_s=0.0, sleep_s=0.0)


@pytest.fixture(scope="module")
def xyz_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("auto")
    rng = np.random.default_rng(931)
    xy = rng.uniform(-2, 2, (2500, 2))
    X1 = np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])
    xy = rng.uniform(-2, 2, (2500, 2))
    X2 = np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])
    f1, f2 = d / "fix.xyz", d / "mov.xyz"
    write_xyz(f1, X1, fmt="%.6f")
    write_xyz(f2, X2 - [0.03, -0.02, 0.01], fmt="%.6f")
    return d, f1, f2


def _no_probe(monkeypatch):
    def probe(timeout_s):
        raise AssertionError("the card was probed")

    monkeypatch.setattr(device_policy, "probe_default_backend", probe)


def test_cli_device_auto_runs_a_small_pair_on_the_cpu(xyz_pair, monkeypatch, caplog):
    """--device auto sends a 2500-point pair to the CPU (no probe): its
    export equals --device cpu's."""
    import logging

    d, f1, f2 = xyz_pair
    _no_probe(monkeypatch)
    common = ["-f", str(f1), "-m", str(f2), "-c", "300"]
    with caplog.at_level(logging.INFO, "simpleicp_tpu_torch"):
        assert main(common + ["--device", "auto", "--export", str(d / "auto.xyz")]) == 0
    assert any(r.getMessage().startswith("device auto: cpu") for r in caplog.records)
    assert main(common + ["--quiet", "--device", "cpu", "--export", str(d / "cpu.xyz")]) == 0
    assert (d / "auto.xyz").read_text() == (d / "cpu.xyz").read_text()


@pytest.mark.parametrize("device", ["auto", "cuda"])
def test_cli_routes_to_the_card_never_fall_back(xyz_pair, monkeypatch, device):
    """A job routed to the card (--device cuda, or --device auto on a pair
    above the threshold, here by a threshold lowered under the pair's
    estimate) raises RuntimeError without a card, before any probe: it
    never falls back to the CPU."""
    _, f1, f2 = xyz_pair
    _no_probe(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(device_policy, "CPU_ROUTE_MAX_SEC", 1e-9)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-f", str(f1), "-m", str(f2), "-c", "300", "--quiet", "--device", device])


def test_cli_failed_probe_reroutes_only_auto(xyz_pair, monkeypatch, capsys):
    """With a card that fails its probe, --device auto runs a CPU-tractable
    job on the CPU with a warning on standard error; --device cuda does not
    probe the card and runs there (here: the registration runs on the CPU
    in place of the device it was given)."""
    from simpleicp_tpu_torch import api

    _, f1, f2 = xyz_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(device_policy, "CPU_ROUTE_MAX_SEC", 1e-9)
    monkeypatch.setattr(device_policy, "probe_default_backend", lambda t: ("timeout", "", t))
    seen = []
    orig = api.SimpleICP.__init__

    def record(self, *a, device=None, **k):
        seen.append(device)
        orig(self, *a, device="cpu", **k)

    monkeypatch.setattr(api.SimpleICP, "__init__", record)
    args = ["-f", str(f1), "-m", str(f2), "-c", "300"]
    assert main(args + ["--device", "auto"]) == 0
    assert "routing this registration to the CPU" in capsys.readouterr().err
    _no_probe(monkeypatch)
    assert main(args + ["--device", "cuda"]) == 0
    assert "WARNING" not in capsys.readouterr().err
    assert seen == ["cpu", "cuda"]

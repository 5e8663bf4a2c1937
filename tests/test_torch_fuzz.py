"""Configuration fuzz through the port: the seeded random small clouds and
random valid configs of tests/test_fuzz.py must never give a NaN transform
or crash on the CPU. Each config also runs through the JAX package, and
the port must agree with it: the same error code and iteration count, and
H within 1e-9 in float64 (the tolerance of tests/test_torch_icp.py). Every
engine a config picks runs in both packages as drawn: the grid gate and the
grid matcher included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu import IcpConfig as JaxConfig
from simpleicp_tpu.models.icp import icp_register as jax_register
from simpleicp_tpu_torch import ERR_OK, config_from_dict, icp_register
from test_torch_dilate_gate import _one_torch_thread  # noqa: F401 (autouse fixture)


def _case(seed):
    """The clouds, config and observations of tests/test_fuzz.py's seed."""
    rng = np.random.default_rng(1000 + seed)
    n1 = int(rng.integers(40, 800))
    n2 = int(rng.integers(40, 800))
    xy = rng.uniform(-2, 2, size=(n1, 2))
    X1 = np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.1 * xy[:, 1] ** 2])
    xy2 = rng.uniform(-2, 2, size=(n2, 2))
    X2 = np.column_stack(
        [xy2, 0.3 * np.sin(2 * xy2[:, 0]) + 0.1 * xy2[:, 1] ** 2]
    ) - rng.uniform(-0.1, 0.1, 3)
    gated = rng.random() < 0.5
    cfg = JaxConfig(
        correspondences=int(rng.integers(6, 200)),
        neighbors=int(rng.integers(3, min(9, n1))),
        min_planarity=float(rng.uniform(0.0, 0.6)),
        max_overlap_distance=float(rng.uniform(0.3, 2.0)) if gated else np.inf,
        min_change=float(rng.uniform(0.1, 5.0)),
        max_iterations=int(rng.integers(1, 25)),
        distance_weights=(None if rng.random() < 0.3 else float(rng.uniform(0.1, 10.0))),
        mad_scale=float(rng.choice([1.0, 1.4826])),
        solver=str(rng.choice(["nonlinear", "linearized"])),
        gate_method=str(rng.choice(["auto", "brute", "grid", "dilate"])),
        match_method=str(rng.choice(["brute", "grid"])) if gated else "brute",
    )
    obs = rng.uniform(-0.05, 0.05, 6)
    w = np.zeros(6)
    if rng.random() < 0.4:
        w[rng.integers(0, 6)] = rng.choice([0.5, np.inf])
    return X1, X2, cfg, dict(rbp_observed_values=obs, rbp_observation_weights=w)


@pytest.mark.parametrize("seed", range(8))
def test_random_config_never_nan(seed):
    X1, X2, jcfg, obs = _case(seed)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    res = icp_register(X1, X2, cfg, device="cpu", dtype=torch.float64, **obs)
    err = int(res.error_code)
    if err == ERR_OK:
        assert torch.isfinite(res.H).all(), f"non-finite H for seed {seed}: {cfg}"
        assert torch.isfinite(res.p).all(), f"non-finite p for seed {seed}"
    ref = jax_register(X1, X2, jcfg, dtype=jnp.float64, **obs)
    assert err == int(ref.error_code)
    assert int(res.n_iterations) == int(ref.n_iterations)
    np.testing.assert_allclose(res.H.numpy(), np.asarray(ref.H), rtol=0, atol=1e-9)

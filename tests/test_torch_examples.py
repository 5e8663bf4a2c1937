"""The port's two synthetic examples run on the CPU and register their
pairs: the counterparts of examples/batch_registration_example.py and
examples/warm_start_big_c_example.py."""

import importlib.util
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_batch_example_recovers_every_pair(capsys):
    ex = _example("batch_registration_torch")
    res = ex.main(device="cpu")
    rng = np.random.default_rng(7)
    for b in range(8):
        X_fix, X_mov = ex.make_pair(rng)
        H = res.H[b].numpy()
        assert bool(res.converged[b])
        # within the repo's recovery bound (chip_smoke.py, tests/test_warm_start.py)
        np.testing.assert_allclose(X_mov @ H[:3, :3].T + H[:3, 3], X_fix, rtol=0, atol=2e-3)
    assert capsys.readouterr().out.count("converged=True") == 8


@pytest.mark.parametrize("n,c", [(20_000, 2000)])
def test_warm_start_example_same_basin(n, c, capsys):
    ex = _example("warm_start_big_c_torch")
    H_cold, H_warm = ex.main(device="cpu", n=n, correspondences=c)
    assert np.abs(H_warm - H_cold).max() < 2e-4
    out = capsys.readouterr().out
    assert out.count("converged=True") == 2 and "same basin" in out

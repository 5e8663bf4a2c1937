"""The wrappers of the Gauss-Newton and uncertainty kernels
(``ops/solver_cuda.py``) on the CPU: the block size they take from C, and
the inputs they refuse before any library is built.
``test_torch_isolation.py`` holds that a CPU tensor never reaches them; the
kernels themselves run in ``test_torch_gpu.py``."""

import pytest
import torch

from simpleicp_tpu_torch.ops import solver_cuda


@pytest.mark.parametrize("C,threads", [
    (0, 32), (1, 32), (6, 32), (128, 32), (129, 64), (500, 128), (1000, 256),
    (1024, 256), (1025, 256), (100_000, 256), (2**31 - 1, 256),
])
def test_block_threads_from_C(C, threads):
    assert solver_cuda.block_threads(C) == threads


def _inputs(B=2, C=5, dtype=torch.float64):
    x = torch.zeros((B, C, 3), dtype=dtype)
    p = torch.zeros((B, 6), dtype=dtype)
    return dict(p0=p, xm=x, xf=x.clone(), n=x.clone(),
                mask=torch.ones((B, C), dtype=torch.bool),
                distance_weight=torch.ones(B, dtype=dtype), obs_vals=p.clone(),
                obs_w=p.clone(), n_steps=24, active=torch.ones(B, dtype=torch.bool))


def _strided(t):
    """t's values in a non-contiguous view."""
    return torch.stack([t, t], dim=-1)[..., 0]


BAD = {
    "xm float16": (TypeError, dict(xm=torch.zeros((2, 5, 3), dtype=torch.float16))),
    "xm int": (TypeError, dict(xm=torch.zeros((2, 5, 3), dtype=torch.int64))),
    "p0 float32 beside float64": (TypeError, dict(p0=torch.zeros((2, 6), dtype=torch.float32))),
    "obs_w float32": (TypeError, dict(obs_w=torch.zeros((2, 6), dtype=torch.float32))),
    "mask not bool": (TypeError, dict(mask=torch.ones((2, 5), dtype=torch.float64))),
    "active not bool": (TypeError, dict(active=torch.ones(2, dtype=torch.int32))),
    "xm without a batch axis": (ValueError, dict(xm=torch.zeros((5, 3), dtype=torch.float64))),
    "xm of 2 columns": (ValueError, dict(xm=torch.zeros((2, 5, 2), dtype=torch.float64))),
    "xf of other C": (ValueError, dict(xf=torch.zeros((2, 4, 3), dtype=torch.float64))),
    "n of other B": (ValueError, dict(n=torch.zeros((3, 5, 3), dtype=torch.float64))),
    "p0 of 3 parameters": (ValueError, dict(p0=torch.zeros((2, 3), dtype=torch.float64))),
    "distance_weight a scalar": (ValueError, dict(distance_weight=torch.ones((), dtype=torch.float64))),
    "mask of other C": (ValueError, dict(mask=torch.ones((2, 6), dtype=torch.bool))),
    "active of other B": (ValueError, dict(active=torch.ones(3, dtype=torch.bool))),
    "xf not contiguous": (ValueError, dict(xf=_strided(torch.zeros((2, 5, 3), dtype=torch.float64)))),
    "mask not contiguous": (ValueError, dict(mask=_strided(torch.ones((2, 5), dtype=torch.bool)))),
    "obs_vals not contiguous": (ValueError, dict(obs_vals=_strided(torch.zeros((2, 6), dtype=torch.float64)))),
    "negative n_steps": (ValueError, dict(n_steps=-1)),
}


@pytest.mark.parametrize("case", list(BAD))
def test_wrapper_refuses(case, monkeypatch):
    """Each bad input raises before any library is asked for."""
    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(solver_cuda, "_library", no_build)
    err, change = BAD[case]
    with pytest.raises(err):
        solver_cuda.gn_solve_cuda(**{**_inputs(), **change})


def _uncertainty_inputs():
    kw = _inputs()
    return dict(p=kw.pop("p0"), **{k: v for k, v in kw.items() if k not in ("n_steps", "active")})


BAD_UNCERTAINTIES = {
    **{case: (err, change) for case, (err, change) in BAD.items()
       if not case.startswith(("p0", "active", "negative n_steps"))},
    "p float32 beside float64": (TypeError, dict(p=torch.zeros((2, 6), dtype=torch.float32))),
    "p of 3 parameters": (ValueError, dict(p=torch.zeros((2, 3), dtype=torch.float64))),
    "p not contiguous": (ValueError, dict(p=_strided(torch.zeros((2, 6), dtype=torch.float64)))),
    "distance_weight float32": (TypeError,
                                dict(distance_weight=torch.ones(2, dtype=torch.float32))),
    "a CPU tensor": (ValueError, {}),
}


@pytest.mark.parametrize("case", list(BAD_UNCERTAINTIES))
def test_uncertainty_wrapper_refuses(case, monkeypatch):
    """Each bad input raises before any library is asked for; valid CPU
    tensors are refused for their device, with the solve wrapper's text."""
    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(solver_cuda, "_library", no_build)
    err, change = BAD_UNCERTAINTIES[case]
    with pytest.raises(err, match="CUDA" if case == "a CPU tensor" else None):
        solver_cuda.uncertainties_cuda(**{**_uncertainty_inputs(), **change})

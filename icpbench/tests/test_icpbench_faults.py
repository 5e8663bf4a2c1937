"""``correct`` comes out false when the timed path is broken underneath the
harness, once for each fault a cell can have, and for the control (the
reference computed in TF32 in the program's place). The cells run on one
card, so no exchange between cards can be left out."""

from types import SimpleNamespace

import pytest
import torch

from icpbench import run, spec
from icpbench.calibrate import control_program
import simpleicp_tpu_torch.models.icp as icp_module


def _run(root, name, program, seed=2**31 + 40):
    cell = spec.load(name, root=root)
    out, _, _ = run.run_cell(cell, seed=seed, seconds=0.1, trace=False, device="cpu",
                             program=program)
    return out


def _with(program, **entries):
    return SimpleNamespace(**{**vars(program), **entries})


@pytest.mark.parametrize("name", ["tiny.pairs", "tiny.strips", "tiny.batch"])
def test_sound_program_is_correct(tiny_root, program, name):
    out = _run(tiny_root, name, program)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("name", ["tiny.pairs", "tiny.strips", "tiny.batch"])
def test_control_is_not_correct(tiny_root, name):
    cell = spec.load(name, root=tiny_root)
    out = _run(tiny_root, name, control_program(cell.icp_fields()))
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", ["tiny.pairs", "tiny.batch"])
def test_step_that_returns_its_state_unchanged(tiny_root, program, monkeypatch, name):
    real = icp_module.gn_solve

    def stuck(p0, xm, *args, **kwargs):
        _, residuals, rel = real(p0, xm, *args, **kwargs)
        return p0.to(xm.dtype), residuals, rel

    monkeypatch.setattr(icp_module, "gn_solve", stuck)
    out = _run(tiny_root, name, program)
    assert out["correct"] is False


def test_half_of_the_batch_left_out(tiny_root, program):
    def half(X_fix, X_mov, cfg, device=None):
        h = X_fix.shape[0] // 2
        r = program.icp_register_batch(X_fix[:h], X_mov[:h], cfg, device=device)
        return type(r)(*(torch.cat([v, v]) if isinstance(v, torch.Tensor) and v.dim()
                         and v.shape[0] == h else v for v in r))

    out = _run(tiny_root, "tiny.batch", _with(program, icp_register_batch=half))
    assert out["correct"] is False


@pytest.mark.parametrize("name", ["tiny.pairs", "tiny.strips"])
def test_answer_altered_where_produced(tiny_root, program, name):
    def nudged(X_fix, X_mov, cfg, device=None):
        r = program.icp_register(X_fix, X_mov, cfg, device=device)
        H = r.H.clone()
        H[0, 3] += 1e-4
        return r._replace(H=H)

    out = _run(tiny_root, name, _with(program, icp_register=nudged))
    assert out["correct"] is False and out["checks"]["H_gap"]["value"] > 9e-5


def test_selection_altered_where_produced(tiny_root, program, monkeypatch):
    real = icp_module._select_n

    def shifted(sel_mask, n, counts=None):
        idx, valid = real(sel_mask, n, counts)
        return torch.roll(idx, 1, dims=-1), valid

    monkeypatch.setattr(icp_module, "_select_n", shifted)
    out = _run(tiny_root, "tiny.strips", program)
    assert out["correct"] is False and out["checks"]["select_off"]["value"] > 0

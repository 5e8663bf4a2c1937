"""The comparison that decides ``correct``.

Once the window has closed, a sample of the registrations it completed,
drawn from the seed (the one with the most iterations among them), is held
against the plain reference (``reference/icp.py``), run on the same pool
pairs. The numbers, each the worst over the sample:

- ``H_gap``: largest absolute difference of the final transform's [R | t]
  from the reference's after as many iterations as the program ran;
- ``trajectory_gap``: largest relative difference of the residual std of
  any iteration, up to the later of the two stops; a different iteration
  count, or a different verdict on convergence, reads 1;
- ``normals_gap``: largest absolute difference of a selected point's unit
  normal (a flipped sign reads about 2);
- ``select_off``: slots of the selection (index or validity) that differ.

A registration of the sample with no answer reads as infinitely far off.
Each cell's file lists the numbers it compares and the limit of each.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from .drive import Window

NUMBERS = ("H_gap", "trajectory_gap", "normals_gap", "select_off")


def sample(window: Window, k: int, seed: int) -> List[Tuple[int, int]]:
    """``k`` registrations of the window as (call, slot), drawn from the
    seed, the one with the most iterations among them."""
    flat = [(c, s) for c, pairs in enumerate(window.calls) for s in range(len(pairs))]
    g = torch.Generator().manual_seed((seed + 1) % 2**63)
    picks = [flat[i] for i in torch.randperm(len(flat), generator=g)[:k].tolist()]
    its = [int(window.results[c]["n_iterations"][s]) for c, s in flat]
    longest = flat[max(range(len(flat)), key=its.__getitem__)]
    if longest not in picks:
        picks[-1] = longest
    return picks


def numbers(prog: Dict[str, torch.Tensor], ref: Dict) -> Dict[str, float]:
    """The numbers of one registration: ``prog`` the program's fields of one
    pair, ``ref`` the reference's result on that pair."""
    n_p = int(prog["n_iterations"])
    n_r = ref["n_iterations"]
    H_ref = ref["H_at"][min(n_p, len(ref["H_at"]) - 1)]
    out = {"H_gap": float((prog["H"][:3].float() - H_ref[:3]).abs().max())}
    n = max(n_p, n_r)
    a = torch.zeros(n, dtype=torch.float64)
    b = torch.zeros(n, dtype=torch.float64)
    a[:n_p] = prog["iter_stds"][:n_p].double().cpu()
    b[:n_r] = ref["iter_stds"][:n_r].double().cpu()
    rel = (a - b).abs() / torch.clamp(torch.maximum(a.abs(), b.abs()), min=1e-300)
    rel = torch.where((a == 0) & (b == 0), torch.zeros_like(rel), rel)
    traj = float(rel.max()) if n else 0.0
    if n_p != n_r or bool(prog["converged"]) != ref["converged"]:
        traj = max(traj, 1.0)
    out["trajectory_gap"] = traj
    same = (prog["sel_idx"].long() == ref["sel_idx"]) & (prog["sel_valid"] == ref["sel_valid"])
    out["select_off"] = float((~same).sum())
    nz = same & ref["sel_valid"]
    gap = (prog["normals"].float() - ref["normals"]).abs().amax(dim=-1)
    out["normals_gap"] = float(gap[nz].max()) if bool(nz.any()) else 0.0
    return out


def compare(window: Window, picks: List[Tuple[int, int]],
            reference: Callable[[int, int], Dict]) -> Dict[str, float]:
    """The worst of each number over the picks; ``reference(pair, run_to)``
    is the reference's result on a pool pair."""
    run_to: Dict[int, int] = {}
    for c, s in picks:
        j = window.calls[c][s]
        run_to[j] = max(run_to.get(j, 0), int(window.results[c]["n_iterations"][s]))
    refs = {j: reference(j, n) for j, n in sorted(run_to.items())}
    worst = {k: 0.0 for k in NUMBERS}
    for c, s in picks:
        res = window.results[c]
        prog = {k: v[s] for k, v in res.items()}
        for k, v in numbers(prog, refs[window.calls[c][s]]).items():
            worst[k] = max(worst[k], v)
    return worst


def verdict(worst: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, {number: {"value", "limit"}}) over the numbers the cell
    compares; a number that is NaN fails."""
    shown = {k: {"value": worst[k], "limit": float(lim)} for k, lim in limits.items()}
    ok = all(v["value"] <= v["limit"] for v in shown.values())
    return ok, shown

"""Seeded pools of cloud pairs: the inputs both the program and the plain
reference are handed.

Each pair samples the wavy surface z = 0.3 sin(2x) + 0.2 cos(3y) twice,
independently, at constant density, and moves the second sample by the
pair's own rigid motion (angles and shifts uniform in the traffic's
ranges), so the transform that registers it is known. Where each sample
lies is the traffic's geometry, ``icpbench/geometries/<geometry>.py``
(``full``: the same square; ``strips``: adjacent flight strips). Everything
is drawn on the run's device from one ``torch.Generator`` in float64 and
stored in float32. Each height carries the scanner's noise, normal with
standard deviation ``noise``.
"""

from __future__ import annotations

from pathlib import Path

import torch

from .spec import ROOT, plugin

F64 = torch.float64


def surface_z(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return 0.3 * torch.sin(2 * x) + 0.2 * torch.cos(3 * y)


def rotation(a: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations of the angles a (..., 3), x -> y -> z order (the
    parameter order of the program's six rigid-body parameters)."""
    c1, c2, c3 = torch.cos(a).unbind(-1)
    s1, s2, s3 = torch.sin(a).unbind(-1)
    rows = [
        [c2 * c3, -c2 * s3, s2],
        [c1 * s3 + s1 * s2 * c3, c1 * c3 - s1 * s2 * s3, -s1 * c2],
        [s1 * s3 - c1 * s2 * c3, s1 * c3 + c1 * s2 * s3, c1 * c2],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


class Pool:
    """``fixed`` (P, n_fix, 3) and ``movable`` (P, n_mov, 3) float32 clouds
    and each pair's true motion ``motion`` (P, 6): angles, then shifts."""

    def __init__(self, fixed: torch.Tensor, movable: torch.Tensor, motion: torch.Tensor):
        self.fixed, self.movable, self.motion = fixed, movable, motion

    def __len__(self) -> int:
        return self.fixed.shape[0]


def make_pool(*, pairs: int, n_fix: int, n_mov: int, half: float, geometry: str,
              angle_max: float, shift_max: float, noise: float, seed: int,
              device: torch.device, root: Path = ROOT) -> Pool:
    """The traffic's pool of ``pairs`` cloud pairs from ``seed``."""
    sample_xy = plugin("geometries", geometry, root).sample_xy
    g = torch.Generator(device=device).manual_seed(seed % 2**63)
    fixed = torch.empty((pairs, n_fix, 3), dtype=torch.float32, device=device)
    movable = torch.empty((pairs, n_mov, 3), dtype=torch.float32, device=device)
    u = torch.rand((pairs, 6), generator=g, dtype=F64, device=device) * 2 - 1
    scale = torch.tensor([angle_max] * 3 + [shift_max] * 3, dtype=F64, device=device)
    motion = u * scale
    R, t = rotation(motion[:, :3]), motion[:, 3:]
    for p in range(pairs):
        f, m = sample_xy(g, n_fix, n_mov, half, F64, device)
        xy = torch.cat([f, m])
        z = surface_z(xy[:, 0], xy[:, 1])
        z = z + noise * torch.randn(z.shape, generator=g, dtype=F64, device=device)
        fixed[p] = torch.cat([f, z[:n_fix, None]], dim=1)
        S = torch.cat([m, z[n_fix:, None]], dim=1)
        # X_mov = R^T (S - t): the motion (R, t) moves it back onto S
        movable[p] = (S - t[p]) @ R[p]
    return Pool(fixed, movable, motion.to(torch.float32))

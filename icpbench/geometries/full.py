"""Full overlap: both samples of a pair over the same square [-h, h]^2."""

import torch


def sample_xy(g, n_fix, n_mov, half, dtype, device):
    """(x, y) of the fixed and the movable sample, uniform, from ``g``."""
    xy = (torch.rand((n_fix + n_mov, 2), generator=g, dtype=dtype, device=device)
          * 2 - 1) * half
    return xy[:n_fix], xy[n_fix:]

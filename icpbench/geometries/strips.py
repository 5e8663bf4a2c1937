"""Adjacent flight strips: the fixed sample over x in [-h, h], the movable
over [-h/2, 3h/2] (half of each strip overlaps the other), y in [-h, h]."""

import torch


def sample_xy(g, n_fix, n_mov, half, dtype, device):
    """(x, y) of the fixed and the movable sample, uniform, from ``g``."""
    xy = (torch.rand((n_fix + n_mov, 2), generator=g, dtype=dtype, device=device)
          * 2 - 1) * half
    shift = torch.tensor([half / 2, 0.0], dtype=dtype, device=device)
    return xy[:n_fix], xy[n_fix:] + shift

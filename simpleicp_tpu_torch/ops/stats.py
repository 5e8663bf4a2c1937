"""Masked robust statistics.

Arrays keep a fixed size with a boolean validity mask instead of being
compacted after outlier rejection, and these helpers reproduce numpy's
semantics under the mask: invalid lanes are ignored exactly, including the
average-of-two-middles median of an even count. Each reduces over the last
axis, so a leading pair axis gives one statistic per pair.
"""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum(dim=-1)
    s = torch.where(mask, x, torch.zeros_like(x)).sum(dim=-1)
    return s / torch.clamp(n, min=1)


def masked_std(x: torch.Tensor, mask: torch.Tensor, ddof: int = 0) -> torch.Tensor:
    """Masked standard deviation; ddof=0 is numpy's population std, ddof=1
    the sample std."""
    n = mask.sum(dim=-1)
    mu = masked_mean(x, mask)
    dev = (x - mu[..., None]) ** 2
    var = (torch.where(mask, dev, torch.zeros_like(dev)).sum(dim=-1)
           / torch.clamp(n - ddof, min=1))
    return torch.sqrt(var)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Exact masked median with numpy semantics (mean of the two middle
    elements for an even count): sort with +inf padding, then gather."""
    n = mask.sum(dim=-1, keepdim=True)
    sorted_x = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))),
                          dim=-1).values
    n_safe = torch.clamp(n, min=1)
    lo = torch.take_along_dim(sorted_x, (n_safe - 1) // 2, dim=-1)[..., 0]
    hi = torch.take_along_dim(sorted_x, n_safe // 2, dim=-1)[..., 0]
    return 0.5 * (lo + hi)


def masked_mad(x: torch.Tensor, mask: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Median absolute deviation about the masked median, times ``scale``
    (1.4826 gives the Gaussian-consistent robust sigma, 1.0 the raw MAD)."""
    med = masked_median(x, mask)
    return scale * masked_median(torch.abs(x - med[..., None]), mask)


def pct_change(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """|new - old| / |old| in percent, with the old == 0 guard: 0 if both
    are zero, +inf if only old is."""
    both_zero = (old == 0) & (new == 0)
    old_zero = (old == 0) & (new != 0)
    safe_old = torch.where(old == 0, torch.ones_like(old), old)
    change = torch.abs((new - old) / safe_old * 100.0)
    return torch.where(
        both_zero, torch.zeros_like(change),
        torch.where(old_zero, torch.full_like(change, float("inf")), change),
    )

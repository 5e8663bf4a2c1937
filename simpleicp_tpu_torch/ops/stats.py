"""Masked robust statistics.

Arrays keep a fixed size with a boolean validity mask instead of being
compacted after outlier rejection, and these helpers reproduce numpy's
semantics under the mask: invalid lanes are ignored exactly, including the
average-of-two-middles median of an even count.
"""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum()
    s = torch.where(mask, x, torch.zeros_like(x)).sum()
    return s / torch.clamp(n, min=1)


def masked_std(x: torch.Tensor, mask: torch.Tensor, ddof: int = 0) -> torch.Tensor:
    """Masked standard deviation; ddof=0 is numpy's population std, ddof=1
    the sample std."""
    n = mask.sum()
    mu = masked_mean(x, mask)
    dev = (x - mu) ** 2
    var = torch.where(mask, dev, torch.zeros_like(dev)).sum() / torch.clamp(n - ddof, min=1)
    return torch.sqrt(var)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Exact masked median with numpy semantics (mean of the two middle
    elements for an even count): sort with +inf padding, then gather."""
    n = mask.sum()
    sorted_x = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf")))).values
    n_safe = torch.clamp(n, min=1)
    lo = sorted_x[torch.clamp((n_safe - 1) // 2, min=0)]
    hi = sorted_x[n_safe // 2]
    return 0.5 * (lo + hi)


def masked_mad(x: torch.Tensor, mask: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Median absolute deviation about the masked median, times ``scale``
    (1.4826 gives the Gaussian-consistent robust sigma, 1.0 the raw MAD)."""
    med = masked_median(x, mask)
    return scale * masked_median(torch.abs(x - med), mask)


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

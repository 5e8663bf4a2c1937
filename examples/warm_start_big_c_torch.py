"""Coarse-to-fine warm start for big-correspondence registrations, with the
PyTorch port.

The counterpart of ``warm_start_big_c_example.py``. At the default C=1000
one ICP iteration is cheap and a warm start gains nothing. At C=100 000
against millions of points one exact iteration is a sweep of 1e11 pairs
or more, and most iterations only walk H toward the basin.
``warm_start=True`` first registers stride-subsampled clouds, then starts
the full run from the coarse result: the same basin, fewer
full-resolution iterations. This example shows the mechanism at a small
size; scale ``--n`` and ``--correspondences`` up on the card. CLI
equivalent:

    python -m simpleicp_tpu_torch -f fix.xyz -m mov.xyz -c 100000 --warm-start

    python examples/warm_start_big_c_torch.py               # on the card
    python examples/warm_start_big_c_torch.py --device cpu --n 20000 --correspondences 2000
"""

import argparse
import os
import sys
import time

# Runnable from a plain checkout.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from simpleicp_tpu_torch import IcpConfig, icp_register


def make_pair(rng, n):
    xy = rng.uniform(-2, 2, (n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])
    X_fix = np.column_stack([xy, z])
    a, t = 0.03, np.array([0.05, -0.04, 0.03])
    c, s = np.cos(a), np.sin(a)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return X_fix, (X_fix - t) @ R


def run(tag, X_fix, X_mov, cfg, device):
    t0 = time.perf_counter()
    res = icp_register(X_fix, X_mov, cfg, device=device)
    H = res.H.cpu().numpy()  # waits for the card
    dt = time.perf_counter() - t0
    print(f"{tag:>6}: {int(res.n_iterations)} full-resolution iterations, "
          f"{dt:.2f} s, converged={bool(res.converged)}")
    return H


def main(device="cuda", n=200_000, correspondences=20_000):
    rng = np.random.default_rng(7)
    X_fix, X_mov = make_pair(rng, n)

    base = dict(correspondences=correspondences)
    H_cold = run("cold", X_fix, X_mov, IcpConfig(**base), device)
    H_warm = run(
        "warm", X_fix, X_mov,
        IcpConfig(**base, warm_start=True, warm_start_points=n // 10), device,
    )
    diff = float(np.abs(H_warm - H_cold).max())
    print(f"max |H_warm - H_cold| = {diff:.2e} (same basin)")
    return H_cold, H_warm


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=200_000, help="points in each cloud")
    ap.add_argument("--correspondences", type=int, default=20_000)
    args = ap.parse_args()
    main(args.device, args.n, args.correspondences)

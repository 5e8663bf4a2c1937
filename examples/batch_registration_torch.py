"""Batch registration with the PyTorch port: many cloud pairs in one loop.

The counterpart of ``batch_registration_example.py``. ``icp_register_batch``
registers B pairs of equal sizes together: every stage and the ICP loop
take a leading pair axis, and on the card each nearest-neighbour kernel
launches once for the whole batch, so B small pairs cost far less than B
separate calls.

    python examples/batch_registration_torch.py               # on the card
    python examples/batch_registration_torch.py --device cpu  # plain versions
"""

import argparse
import os
import sys

# Runnable from a plain checkout.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from simpleicp_tpu_torch import IcpConfig, icp_register_batch


def make_pair(rng, n=2000, angle=0.05):
    xy = rng.uniform(-1, 1, (n, 2))
    z = 0.3 * np.sin(2 * xy[:, 0]) * np.cos(3 * xy[:, 1])
    X_fix = np.column_stack([xy, z])
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    t = rng.uniform(-0.1, 0.1, 3)
    return X_fix, X_fix @ R.T + t


def main(device="cuda"):
    rng = np.random.default_rng(7)
    pairs = [make_pair(rng) for _ in range(8)]
    X_fix = np.stack([p[0] for p in pairs])   # (B, n, 3)
    X_mov = np.stack([p[1] for p in pairs])   # (B, n, 3)

    res = icp_register_batch(
        X_fix, X_mov, IcpConfig(correspondences=500, solver="linearized"), device=device
    )
    for b in range(X_fix.shape[0]):
        print(
            f"pair {b}: converged={bool(res.converged[b])} "
            f"iterations={int(res.n_iterations[b])} "
            f"t={res.H[b, :3, 3].cpu().numpy().round(4)}"
        )
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)

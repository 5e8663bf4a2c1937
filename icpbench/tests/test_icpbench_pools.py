"""The pools are drawn from the seed alone, with the geometry and motions
the traffic states."""

import torch

from icpbench.pools import make_pool, rotation, surface_z

CPU = torch.device("cpu")


def pool(seed, geometry="full"):
    return make_pool(pairs=3, n_fix=500, n_mov=600, half=2.0, geometry=geometry,
                     angle_max=0.03, shift_max=0.05, noise=0.002, seed=seed, device=CPU)


def test_same_seed_same_pool_other_seed_other_pool():
    a, b, c = pool(2**31 + 11), pool(2**31 + 11), pool(2**31 + 12)
    assert torch.equal(a.fixed, b.fixed) and torch.equal(a.movable, b.movable)
    assert torch.equal(a.motion, b.motion)
    assert not torch.equal(a.fixed, c.fixed) and not torch.equal(a.motion, c.motion)


def test_motion_moves_the_movable_sample_onto_the_surface():
    for geometry in ("full", "strips"):
        p = pool(5, geometry)
        assert p.motion[:, :3].abs().max() <= 0.03 and p.motion[:, 3:].abs().max() <= 0.05
        for j in range(len(p)):
            m = p.motion[j].double()
            S = p.movable[j].double() @ rotation(m[:3]).T + m[3:]
            resid = S[:, 2] - surface_z(S[:, 0], S[:, 1])
            assert resid.abs().max() < 0.002 * 6
            lo = -2.0 if geometry == "full" else -1.0
            assert lo - 1e-5 <= S[:, 0].min() and S[:, 0].max() <= lo + 4.0 + 1e-5
        assert p.fixed[:, :, 0].min() >= -2.0 and p.fixed[:, :, 0].max() <= 2.0

"""The plain reference against the program on the CPU (its plain
versions), and the TF32 rounding of the control."""

import dataclasses

import pytest
import torch

from icpbench.pools import make_pool
from icpbench.reference import icp as ref


@pytest.mark.parametrize("geometry, radius", [("full", None), ("strips", 0.1)])
def test_reference_agrees_with_program(program, geometry, radius):
    P = make_pool(pairs=2, n_fix=8000, n_mov=8000, half=2.0, geometry=geometry,
                  angle_max=0.03, shift_max=0.05, noise=0.002, seed=2**31 + 3,
                  device=torch.device("cpu"))
    kw = {} if radius is None else {"max_overlap_distance": radius}
    cfg = program.IcpConfig(correspondences=200, **kw)
    icp = dataclasses.asdict(cfg)
    for j in range(len(P)):
        got = program.icp_register(P.fixed[j], P.movable[j], cfg, device="cpu")
        want = ref.register(P.fixed[j], P.movable[j], icp)
        n = int(got.n_iterations)
        assert n == want["n_iterations"] and bool(got.converged) == want["converged"]
        assert int(got.error_code) == want["error"] == 0
        assert torch.equal(got.sel_idx.long(), want["sel_idx"])
        assert torch.equal(got.sel_valid, want["sel_valid"])
        assert torch.equal(got.normals, want["normals"])
        assert torch.equal(got.H, want["H"])
        assert torch.equal(got.iter_stds[:n], want["iter_stds"])
        truth = P.motion[j].double()
        assert (got.H[:3, 3].double() - truth[3:]).abs().max() < 3e-3


def test_overlap_mask_is_the_brute_mask():
    g = torch.Generator().manual_seed(4)
    Xf = torch.rand((3000, 3), generator=g) * torch.tensor([4.0, 4.0, 0.3]) - torch.tensor([2.0, 2.0, 0.0])
    Xm = torch.rand((2000, 3), generator=g) * torch.tensor([4.0, 4.0, 0.3]) - torch.tensor([1.0, 1.0, 0.0])
    d = Xf[:, None, :] - Xm[None, :, :]
    d2 = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]).amin(1)
    r = torch.tensor(0.1, dtype=torch.float32)
    want = d2 <= r * r
    got = ref.overlap_mask(Xf, Xm, 0.1)
    assert torch.equal(got, want) and 0 < int(want.sum()) < 3000


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10 + 2**-12, -3.14159265])
    got = ref.tf32(x)
    assert got.tolist()[:4] == [1.0, 1.0, 1.0 + 2**-9, 1.0 + 2**-10]
    assert abs(got[4].item() + 3.140625) < 1e-7
    assert torch.equal(ref.tf32(got), got)

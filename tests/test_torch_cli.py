"""The port's CLI against the JAX package's: the flag contract of
tests/test_cli.py, and the exported cloud of a gated run on small synthetic
xyz files.

The JAX CLI runs in-process with ``--device cpu`` under the tests' x64
switch, so it computes in float64; the port's CLI runs with ``--device cpu
--dtype float64``. Tolerance of the exported cloud: 1e-9 (it is written
with three decimals, so in practice the files are equal).
"""

import numpy as np
import pytest

from simpleicp_tpu.cli import PRESETS as JAX_PRESETS
from simpleicp_tpu.cli import build_parser as jax_parser
from simpleicp_tpu.cli import main as jax_main
from simpleicp_tpu_torch.cli import PRESETS, build_parser, main
from simpleicp_tpu_torch.utils.xyz_io import read_xyz, write_xyz


def test_flag_names_match_reference_contract():
    """Short and long options and defaults as in tests/test_cli.py:12-45."""
    p = build_parser()
    args = p.parse_args([
        "-f", "a.xyz", "-m", "b.xyz", "-c", "500", "-n", "5", "-p", "0.5",
        "-o", "2.0", "-i", "0.5", "-x", "20",
    ])
    assert (args.correspondences, args.neighbors, args.min_planarity) == (500, 5, 0.5)
    assert (args.max_overlap_distance, args.min_change, args.max_iterations) == (2.0, 0.5, 20)
    d = p.parse_args(["-f", "a", "-m", "b"])
    assert (d.correspondences, d.neighbors, d.min_planarity) == (1000, 10, 0.3)
    assert (d.max_overlap_distance, d.min_change, d.max_iterations) == (-1.0, 1.0, 100)
    assert (d.device, d.dtype) == ("cuda", "float32")


def test_flags_and_presets_equal_the_jax_cli():
    """Every flag of the JAX CLI with its default, except --device (cuda or
    cpu, no auto routing) and --probe-timeout (no health probe), plus
    --dtype; the preset table is the same."""
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default) for a in parser._actions}

    j, t = flags(jax_parser()), flags(build_parser())
    assert set(j) - set(t) == {"probe_timeout"}
    assert set(t) - set(j) == {"dtype"}
    for dest in set(j) & set(t) - {"device", "help", "version"}:
        assert t[dest] == j[dest], dest
    assert PRESETS == JAX_PRESETS
    a = build_parser().parse_args(["-f", "a", "-m", "b", "--preset", "julia",
                                   "--std_ddof", "0"])
    assert a.preset == "julia" and a.std_ddof == 0
    for bad in ("auto", "tpu"):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["-f", "a", "-m", "b", "--device", bad])


@pytest.fixture(scope="module")
def xyz_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(901)
    xy = np.column_stack([rng.uniform(-2, 2, 2500), rng.uniform(-2, 2, 2500)])
    X1 = np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])
    xy = np.column_stack([rng.uniform(-1, 3, 2500), rng.uniform(-2, 2, 2500)])
    X2 = np.column_stack([xy, 0.3 * np.sin(2 * xy[:, 0]) + 0.2 * np.cos(3 * xy[:, 1])])
    X2 = X2 - np.array([0.03, -0.02, 0.01])
    f1, f2 = d / "fix.xyz", d / "mov.xyz"
    write_xyz(f1, X1, fmt="%.6f")
    write_xyz(f2, X2, fmt="%.6f")
    return d, f1, f2


def test_cli_export_equals_the_jax_cli(xyz_pair):
    """A gated CLI run with an initial rotation: the exported cloud equals
    the JAX CLI's."""
    d, f1, f2 = xyz_pair
    common = ["-f", str(f1), "-m", str(f2), "-o", "0.25", "-c", "300",
              "--observed-values=0,0,0.5,0,0,0", "--quiet", "--device", "cpu"]
    assert jax_main(common + ["--export", str(d / "jax.xyz")]) == 0
    assert main(common + ["--dtype", "float64", "--export", str(d / "port.xyz")]) == 0
    a, b = read_xyz(d / "port.xyz"), read_xyz(d / "jax.xyz")
    assert a.shape == (2500, 3)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def test_cli_float32_and_log_lines(xyz_pair, caplog):
    """The default float32 run on the CPU converges and logs the
    reference's lines; it recovers the shift within 2e-3."""
    import logging

    d, f1, f2 = xyz_pair
    caplog.set_level(logging.INFO, logger="simpleicp_tpu_torch")
    assert main(["-f", str(f1), "-m", str(f2), "-o", "0.25", "-c", "300",
                 "--device", "cpu", "--export", str(d / "f32.xyz")]) == 0
    err = caplog.text
    assert "orig:0" in err and "Convergence criteria fulfilled -> stop iteration!" in err
    assert "Finished in " in err
    moved = read_xyz(d / "f32.xyz") - read_xyz(f2)
    np.testing.assert_allclose(moved.mean(axis=0), [0.03, -0.02, 0.01], atol=2e-3)


UNPORTED_FLAGS = {
    "num_devices": (["--num-devices", "2"], "item 14"),
    "chunked": (["--dispatch", "chunked"], "item 12"),
    "warm_start": (["--warm-start"], "item 10"),
    "gate_grid": (["-o", "0.5", "--gate-method", "grid"], "item 11"),
    "gate_dilate": (["-o", "0.5", "--gate-method", "dilate"], "item 13"),
    "approx_knn": (["--approx-knn"], "item 15"),
}


@pytest.mark.parametrize("name", list(UNPORTED_FLAGS))
def test_unported_flags_fail_with_their_roadmap_item(xyz_pair, name):
    _, f1, f2 = xyz_pair
    flags, item = UNPORTED_FLAGS[name]
    with pytest.raises(NotImplementedError, match=item):
        main(["-f", str(f1), "-m", str(f2), "--quiet", "--device", "cpu", *flags])


def test_malformed_observations_exit_cleanly():
    with pytest.raises(SystemExit, match="six comma-separated"):
        main(["-f", "a", "-m", "b", "--observed-values=1,2,3"])

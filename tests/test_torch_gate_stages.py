"""The dilate gate's band-ref compaction and slab join inside ``icp_register``
(CPU, plain versions), forced on a small strips pair by lowering the
gate's thresholds: the registration against the benchmark's plain
reference (``icpbench/reference/icp.py``) within the limits of the cell
that runs this path at scale, the gate's counters against counts made
apart from them, its stage spans (``icp.gate_classify``,
``icp.gate_compact``, ``icp.gate_slab_plan``, ``icp.gate_sweep``) under a
recording profiler, and the slab join's cost model against the JAX
package's loop."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from simpleicp_tpu.ops import dilate_gate as jax_dg  # noqa: E402
from icpbench import check  # noqa: E402
from icpbench.pools import make_pool  # noqa: E402
from icpbench.reference import icp as ref  # noqa: E402
from simpleicp_tpu_torch import IcpConfig, icp_register  # noqa: E402
from simpleicp_tpu_torch.models import icp as micp  # noqa: E402
from simpleicp_tpu_torch.ops import dilate_gate as dg  # noqa: E402
from simpleicp_tpu_torch.ops.transform import apply_H, rbp_to_H  # noqa: E402
from simpleicp_tpu_torch.utils import profiling, sync  # noqa: E402

CELL = "airborne_lidar_50m.strips_tile"
BENCH = ROOT / "icpbench"
CONFIG = json.loads((BENCH / "configs" / "airborne_lidar_50m.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "strips_tile.json").read_text())
LIMITS = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())["limits"]
GATE_SPANS = ("icp.gate_classify", "icp.gate_compact", "icp.gate_slab_plan",
              "icp.gate_sweep")
# the result fields the cell's check compares (icpbench/check.py)
CHECKED = ("H", "n_iterations", "converged", "sel_idx", "sel_valid", "normals", "iter_stds")
N = 12000
# the cell's density (6 250 points a square unit) at N points a cloud
HALF = CONFIG["half_width"] * (N / CONFIG["points_fixed"]) ** 0.5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _force_slab_join(monkeypatch):
    """The cell's path at 12 000 points: "auto" plans the dilate gate, the
    band is compacted and resolved by a slab join of several blocks."""
    monkeypatch.setattr(micp, "GATE_AUTO_BRUTE_PAIRS", 0)
    monkeypatch.setattr(dg, "_DIRECT_SWEEP_MAX", 1)
    monkeypatch.setattr(dg, "_SLAB_SWEEP_MIN", 1)
    monkeypatch.setattr(dg, "_SLAB1_MIN", 32)
    monkeypatch.setattr(dg, "_SLAB_CHUNK_OPTS", (128, 512))


def _pair(seed):
    """One strips pair of the cell's traffic (its motions, noise and
    geometry) at N points, from the seed."""
    pool = make_pool(pairs=1, n_fix=N, n_mov=N, half=HALF, geometry=TRAFFIC["geometry"],
                     angle_max=TRAFFIC["angle_max"], shift_max=TRAFFIC["shift_max"],
                     noise=CONFIG["height_noise"], seed=seed, device=torch.device("cpu"))
    return pool.fixed[0], pool.movable[0]


def _icp_fields():
    return {**CONFIG["icp"], **TRAFFIC["icp"]}


@pytest.mark.parametrize("seed", [2**31 + 1701, 2**33 + 17])
def test_forced_slab_join_registration_against_the_reference(monkeypatch, seed):
    _force_slab_join(monkeypatch)
    Xf, Xm = _pair(seed)
    fields = _icp_fields()
    res = icp_register(Xf, Xm, IcpConfig(**fields), device="cpu")
    (counts,) = [v for _, _, v in profiling.recorded_counters("icp.gate")[-1:]]
    assert counts["compaction"] == 1 and counts["slab_blocks"] > 1, counts
    assert int(res.error_code) == 0 and bool(res.converged)
    R = ref.register(Xf, Xm, fields, run_to=int(res.n_iterations))
    got = check.numbers({k: getattr(res, k) for k in CHECKED}, R)
    assert got["select_off"] == 0, got
    for k in ("H_gap", "trajectory_gap", "normals_gap"):
        assert got[k] <= LIMITS[k], (k, got)


def test_gate_counters_against_counts_made_apart(monkeypatch):
    _force_slab_join(monkeypatch)
    Xf, Xm = _pair(2**32 + 5)
    radius = TRAFFIC["icp"]["max_overlap_distance"]
    Xm0 = apply_H(Xm, rbp_to_H(torch.zeros(6)))
    lo, hi = dg.bbox_of(Xm0).numpy()
    plan = dg.plan_dilate_gate(None, None, radius, bbox=(lo, hi))
    # every 1-NN launch of the sweeps, counted where it is made
    launches = []
    plain = dg.min_dist_sq

    def counted(Q, R):
        launches.append((Q.shape[0], R.shape[0]))
        return plain(Q, R)

    monkeypatch.setattr(dg, "min_dist_sq", counted)
    stats = {}
    mask = dg.overlap_mask_dilate(Xf, Xm0, radius, plan, stats=stats)
    (c,) = [v for _, _, v in profiling.recorded_counters("icp.gate")[-1:]]

    in_mask, band_mask = dg.classify_queries(Xf, Xm0, plan=plan)
    band_idx = torch.nonzero(band_mask)[:, 0]
    kept = dg._compact_refs(Xf[band_idx], Xm0, plan)
    assert c["band"] == int(band_mask.sum()) > 0
    assert c["refs_kept"] == int(kept.sum()) == stats["refs_kept"]
    assert 0 < c["refs_kept"] < Xm.shape[0]
    assert c["compaction"] == 1 and c["dilations"] == 2
    assert c["slab_blocks"] == stats["slab_blocks"] == len(launches) == c["sweep_launches"] > 1
    assert c["sweep_pairs"] == sum(q * r for q, r in launches) == stats["sweep_pairs"]
    assert c["sweep_queries"] == sum(q for q, _ in launches) == c["band"]
    assert c["sweep_refs"] == sum(r for _, r in launches)
    assert c["sweep_pairs"] < c["band"] * c["refs_kept"]
    assert (c["cell_div"], c["n_words"]) == (round(radius * plan.inv_cell), plan.n_words)
    assert (c["in_offsets"], c["poss_offsets"]) == (len(plan.in_offsets),
                                                    len(plan.poss_offsets))
    r2 = torch.tensor(radius, dtype=Xf.dtype) ** 2
    assert torch.equal(mask, ref.overlap_mask(Xf, Xm0, radius))
    assert torch.equal(mask, dg.min_dist_sq(Xf, Xm0) <= r2)


def test_direct_sweep_counters(monkeypatch):
    """Below the compaction's threshold the band is swept against every ref
    in one launch: no compaction, no slab blocks."""
    monkeypatch.setattr(micp, "GATE_AUTO_BRUTE_PAIRS", 0)
    Xf, Xm = _pair(2**31 + 99)
    icp_register(Xf, Xm, IcpConfig(**{**_icp_fields(), "max_iterations": 2}), device="cpu")
    (c,) = [v for _, _, v in profiling.recorded_counters("icp.gate")[-1:]]
    assert c["compaction"] == 0 and c["slab_blocks"] == 0 and c["dilations"] == 1
    assert c["refs_kept"] == N and c["sweep_launches"] == 1
    assert c["sweep_pairs"] == c["band"] * N and c["sweep_refs"] == N


@pytest.mark.parametrize("path", ["slab join", "direct"])
def test_gate_spans_nest_once_and_read_nothing_more(monkeypatch, path):
    if path == "slab join":
        _force_slab_join(monkeypatch)
    else:
        monkeypatch.setattr(micp, "GATE_AUTO_BRUTE_PAIRS", 0)
    Xf, Xm = _pair(2**31 + 7)
    cfg = IcpConfig(**{**_icp_fields(), "max_iterations": 3})
    sync.reset_host_reads()
    plain = icp_register(Xf, Xm, cfg, device="cpu")
    reads, counts = sync.host_reads(), profiling.recorded_counters("icp.gate")[-1][2]
    sync.reset_host_reads()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = icp_register(Xf, Xm, cfg, device="cpu")
    assert sync.host_reads() == reads
    assert profiling.recorded_counters("icp.gate")[-1][2] == counts
    for f in plain._fields:
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f
    events = [e for e in prof.events() if e.name.startswith("icp.")]
    (gate,) = [e for e in events if e.name == "icp.gate"]
    want = GATE_SPANS if path == "slab join" else ("icp.gate_classify", "icp.gate_sweep")
    got = sorted((e for e in events if e.name in GATE_SPANS), key=lambda e: e.time_range.start)
    assert [e.name for e in got] == list(want)
    assert all(e.cpu_parent is gate for e in got)
    # the band's read is the classify's, the kept refs' the compaction's
    reads_in = {e.name: sum(1 for h in events if h.name == "icp.host_read"
                            and h.cpu_parent is e) for e in got}
    assert reads_in["icp.gate_classify"] == 1 and reads_in["icp.gate_sweep"] == 0
    if path == "slab join":
        assert reads_in["icp.gate_compact"] == 1 and reads_in["icp.gate_slab_plan"] == 2


def test_counters_are_kept_without_a_profiler_and_bounded():
    profiling.clear_recorded_counters()
    profiling.record_counters("icp.gate", {"band": 3})
    profiling.record_counters("other", {"n": 1})
    (name, t, v), = profiling.recorded_counters("icp.gate")
    assert name == "icp.gate" and v == {"band": 3} and t > 0
    assert [n for n, _, _ in profiling.recorded_counters()] == ["icp.gate", "other"]
    for i in range(5000):
        profiling.record_counters("icp.gate", {"band": i})
    kept = profiling.recorded_counters("icp.gate")
    assert len(kept) <= 1 << 12 and kept[-1][2] == {"band": 4999}
    profiling.clear_recorded_counters()
    assert profiling.recorded_counters() == []


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_slab_cost_model_picks_what_the_loop_picks(monkeypatch, dtype):
    """The port's slab cost model (all slabs of all candidates at once)
    against the JAX package's loop over the slabs, at the same rates and no
    per-launch cost (as tests/test_torch_dilate_gate.py compares them), on
    strips-like coordinates, degenerate ones and two reaches; and its
    ranges' extrema against plain slices."""
    monkeypatch.setattr(dg, "_SLAB_PAIRS_PER_SEC", jax_dg._SLAB_PAIRS_PER_SEC)
    monkeypatch.setattr(dg, "_SLAB_WINDOW_SEC", jax_dg._SLAB_HOST_SORT_SEC)
    monkeypatch.setattr(dg, "_SLAB_CALL_SEC", 0.0)
    monkeypatch.setattr(jax_dg, "_SLAB_CALL_SEC", 0.0)
    rng = np.random.default_rng(2**31 + 5)
    for nq, nr, y_span in ((200_000, 300_000, 40.0), (70_000, 20_000, 0.0), (5, 9, 3.0)):
        qx = np.sort(rng.uniform(-20, 45, nq)).astype(dtype)
        qy = rng.uniform(-y_span, y_span + 1, nq).astype(dtype)
        rx = np.sort(rng.uniform(-21, 46, nr)).astype(dtype)
        ry = rng.uniform(-40, 40, nr).astype(dtype) * (y_span > 0)
        for reach in (0.1001, 3.0):
            args = (qx, qy, rx, ry, reach)
            assert dg._pick_slab_chunk_2d(*args) == jax_dg._pick_slab_chunk_2d(*args)
    assert dg._pick_slab_chunk_2d(qx, qy, rx + 1e3, ry, 0.1) == dg._SLAB_CHUNK_OPTS[0]
    v = rng.normal(size=1000).astype(dtype)
    a = np.sort(rng.integers(0, 900, 40))
    b = np.minimum(a + rng.integers(1, 300, 40), 1000)
    ((hi, lo),) = dg._range_extrema(v, [(a, b)])
    assert np.array_equal(hi, [v[i:j].max() for i, j in zip(a, b)])
    assert np.array_equal(lo, [v[i:j].min() for i, j in zip(a, b)])


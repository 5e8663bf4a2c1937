"""The dilate kernel's regrouped tables, on the CPU.

``dilate_cuda._tables`` regroups each z level's stencil entries into runs
of consecutive dx at one dy and writes each run as a word offset into the
kernel's halo'd tile. The kernel ORs exactly the words these runs name, so
the tables must name every entry of every stencil at its own level, and
nothing else: decoded here, per level and per stencil, they must equal the
stencils as sets, on the real plans of the dilate gate (cell_div 16, 8, 4
and 2) and on unstructured stencils. Each level's halo reach must cover
the entries of that level and of every later one (oz grows only there).
"""

import numpy as np
import pytest

from simpleicp_tpu_torch.ops import dilate_cuda
from simpleicp_tpu_torch.ops.dilate_gate import plan_dilate_gate

LI, LM = dilate_cuda._LEVEL_INTS, dilate_cuda._LMAX


def _decode(table, n_levels, reach, th):
    """{(z, stencil): [(dx, dy), ...]} named by the table's runs, and
    {z: the level's halo reach}, in the kernel's order of levels."""
    runs = table[n_levels * LI:]
    named, reach_of, zs = {}, {}, []
    for rec in (table[i * LI:(i + 1) * LI] for i in range(n_levels)):
        z, p = rec[0], rec[1]
        zs.append(z)
        reach_of[z] = p
        for s in range(2):
            st = rec[2 + s * (LM + 1):2 + (s + 1) * (LM + 1)]
            assert list(st) == sorted(st) and 0 <= st[0] and st[-1] <= len(runs)
            for L in range(1, LM + 1):
                for off in runs[st[L - 1]:st[L]]:
                    dy = round(-off / th)
                    last = -off - dy * th          # a + L - 1
                    assert abs(last) <= reach and abs(last - L + 1) <= reach
                    assert abs(dy) <= reach
                    named.setdefault((z, s), []).extend(
                        (last - L + 1 + k, dy) for k in range(L))
    assert zs == sorted(set(zs)), "levels must ascend, once each"
    return named, reach_of


def _check(stencils):
    table, n_levels, reach, th = dilate_cuda._tables(stencils)
    assert th % 2 == 1 and th >= dilate_cuda._TILE_X + 2 * reach
    assert reach == max(max(abs(dx), abs(dy)) for st in stencils for dx, dy, _ in st)
    named, reach_of = _decode(table, n_levels, reach, th)
    want = {}
    for s, st in enumerate(stencils):
        for dx, dy, z in st:
            want.setdefault((z, s), set()).add((dx, dy))
    assert set(named) == set(want)
    for key, pairs in named.items():
        assert len(pairs) == len(set(pairs)), f"an entry named twice at {key}"
        assert set(pairs) == want[key], f"level {key[0]}, stencil {key[1]}"
    for z, p in reach_of.items():
        later = [max(abs(dx), abs(dy)) for st in stencils for dx, dy, zz in st if zz >= z]
        assert p == max(later)
    return table, reach, th


def _plans():
    rng = np.random.default_rng(31)
    pts = rng.random((20_000, 3)) * np.array([8.0, 6.0, 4.0])
    for div in (16, 8, 4, 2):
        yield f"cell_div {div}", plan_dilate_gate(None, pts, 1.0, cell_div=div)
    # the 1.2M cell's plan: cell_div 16 over a 13.9 x 13.9 x 1 box, radius 0.1
    h = 2 * np.sqrt(12.0)
    yield "1.2M cell", plan_dilate_gate(None, None, 0.1, bbox=(np.array([-h / 2, -h, -0.5]),
                                                                np.array([1.5 * h, h, 0.5])))


@pytest.mark.parametrize("name,plan", list(_plans()), ids=lambda v: v if isinstance(v, str) else "")
@pytest.mark.parametrize("which", ["IN+POSS", "POSS"])
def test_tables_name_every_entry_of_real_plans(name, plan, which):
    """Both stencils, as the gate's first dilation takes them, and POSS
    alone, as the band-ref compaction's second dilation does."""
    _check((plan.in_offsets, plan.poss_offsets) if which == "IN+POSS"
           else (plan.poss_offsets,))


def test_real_plans_fit_shared_memory():
    """Every plan of the gate has reach at most 17 and fits a block's
    shared memory; reach 18 still fits, 19 does not."""
    for name, plan in _plans():
        table, n_levels, reach, th = dilate_cuda._plan((plan.in_offsets, plan.poss_offsets))
        assert reach <= 17, name
        assert dilate_cuda._smem_bytes(len(table), reach, th) <= dilate_cuda._SMEM_MAX
    dilate_cuda._plan((((18, -18, 0), (0, 0, 5)),))
    with pytest.raises(ValueError, match="reach up to 18"):
        dilate_cuda._plan((((19, 0, 0),),))


def _unstructured(seed, n, reach):
    rng = np.random.default_rng(seed)
    return tuple((int(dx), int(dy), int(z)) for dx, dy, z in zip(
        rng.integers(-reach, reach + 1, n), rng.integers(-reach, reach + 1, n),
        rng.integers(0, 32, n)))


UNSTRUCTURED = {
    "random": (_unstructured(1, 40, 6), _unstructured(2, 7, 6)),
    "one stencil": (_unstructured(3, 60, 9),),
    # duplicates and one (dx, dy) at several levels
    "duplicates": (((0, 0, 3), (0, 0, 3), (1, 0, 3), (0, 0, 5), (2, 0, 3)),
                   ((0, 0, 3), (-1, 2, 0))),
    # a row of 19 consecutive dx: runs split at the longest step
    "long run": (tuple((dx, 1, 2) for dx in range(-9, 10)) + ((0, 0, 0),),),
    "centre only": (((0, 0, 0),), ((0, 0, 31),)),
    "growing reach": (((0, 0, 0), (1, 1, 4), (7, -7, 9)), ((-3, 2, 1),)),
}


@pytest.mark.parametrize("name", list(UNSTRUCTURED))
@pytest.mark.parametrize("order", ["as given", "reversed"])
def test_tables_name_every_entry_of_unstructured_stencils(name, order):
    """The stencils in the kernel's slots 0 and 1, and swapped."""
    st = UNSTRUCTURED[name]
    _check(st if order == "as given" else st[::-1])


def test_runs_are_maximal_and_short():
    """A run is at most _LMAX long and splits only there; duplicates count
    once; the runs of a ring cover it exactly."""
    runs = dilate_cuda._runs([(dx, 0) for dx in range(-9, 10)] + [(12, 0), (14, 0), (15, 0)])
    assert [(a, n) for _, a, n in runs] == [(-9, 8), (-1, 8), (7, 3), (12, 1), (14, 2)]
    assert dilate_cuda._runs([(3, 1), (3, 1), (4, 1)]) == [(1, 3, 2)]
    ring = [(dx, dy) for dx in range(-6, 7) for dy in range(-6, 7)
            if 20 <= dx * dx + dy * dy <= 36]
    covered = [(a + k, dy) for dy, a, n in dilate_cuda._runs(ring) for k in range(n)]
    assert sorted(covered) == sorted(ring)


def test_reach_beyond_shared_memory_raises():
    with pytest.raises(ValueError, match="shared memory"):
        dilate_cuda._plan((((60, 0, 1),),))


ROWS = 8   # csrc/dilate.cu kRows: consecutive output rows a thread ORs into


def _loads_per_or(stencils, one_pass):
    """Shared loads per OR of the kernel's thread patch (ROWS rows of one
    column): a window of consecutive dx at one (z, dy) costs ROWS + span - 1
    loads. Without ``one_pass``, the wrapper's runs of each stencil apart;
    with it, one pass over both stencils that merges neighbouring runs of
    either stencil into one window, across a gap, wherever that loads fewer
    words (windows up to 16 wide). Returns (loads per OR, the (z, dy)
    rows where an IN run touches a POSS run)."""
    loads = touching = 0
    for z in sorted({e[2] for st in stencils for e in st}):
        for dy in sorted({e[1] for st in stencils for e in st if e[2] == z}):
            runs = [[(a, a + n - 1) for _, a, n in dilate_cuda._runs(
                [(dx, d) for dx, d, zz in st if zz == z and d == dy])] for st in stencils]
            if len(runs) == 2:
                touching += any(a2 == e1 + 1 or e2 == a1 - 1
                                for a1, e1 in runs[0] for a2, e2 in runs[1])
            windows = sorted(r for rs in runs for r in rs)
            if one_pass:
                merged = [windows[0]]
                for a, e in windows[1:]:
                    a0, e0 = merged[-1]
                    if a - e0 - 1 < ROWS - 1 and max(e, e0) - a0 < 16:
                        merged[-1] = (a0, max(e, e0))
                    else:
                        merged.append((a, e))
                windows = merged
            loads += sum(ROWS + e - a for a, e in windows)
    return loads / (ROWS * sum(len(st) for st in stencils)), touching


def test_one_pass_over_both_stencils_would_save_little():
    """The kernel walks IN's and POSS's runs of a level in two passes. On
    the gate's plans no IN run touches a POSS run at one (z, dy), so one
    pass shares a loaded word only by loading across the gap between
    them. At the 1.2M cell's plan (cell_div 16) the wrapper's runs need
    0.651 shared loads per OR, and one pass with merged windows 0.580:
    11 % fewer."""
    figures = {}
    for name, plan in _plans():
        both = (plan.in_offsets, plan.poss_offsets)
        runs, touching = _loads_per_or(both, one_pass=False)
        merged, _ = _loads_per_or(both, one_pass=True)
        assert touching == 0, name
        assert merged <= runs, name
        figures[name] = (round(runs, 3), round(merged, 3))
    assert figures["1.2M cell"] == (0.651, 0.580)

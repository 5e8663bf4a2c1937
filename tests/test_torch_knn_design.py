"""The design of the k-NN and match kernels (csrc/knn.cu), on the CPU.

No card here, so the kernels' own arithmetic is held bit-equal to the plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py). What the CPU
can check:

* the k-NN's chunk plan (``knn_cuda._plan_knn_chunks``) covers the
  reference axis, respects its minimum chunk and fills its waves of
  resident blocks at the main path's shapes (1000 queries against 1e5 and
  1.34e6 refs) and at ``estimate_normals``' (1e5 x 1e5);
* a numpy model of the k-NN's warp algorithm (a list spread over 32
  lanes, kS slots a lane; the ballot filter d2 < k-th with a strict '<';
  the broadcast compare-and-shift insertion; the merge of the chunks'
  lists in ascending (chunk, slot) order through the same insertion; the
  +inf tail filled from the mask) equals ``knn_search_plain``'s stable sort
  and the JAX package's lax ``knn_search`` on the tie lattice, under masks
  and with fewer valid refs than k, for any chunking;
* a numpy model of the index mode's finish pass (a warp per query: each
  lane's strict '<' over its chunks, then the butterfly that keeps the
  lower chunk on equal d2) picks the first chunk with the least d2;
* the wrappers' routes: on a CUDA-typed call ``match_transform`` reaches
  ``match_transform_cuda``, which passes H's own device pointer to the
  kernel (no host read) in one launch counted under ``match_transform``,
  and ``knn_search_cuda`` launches once with the planned chunks.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from simpleicp_tpu.ops import knn as jk
from simpleicp_tpu_torch.ops import knn as tk
from simpleicp_tpu_torch.ops import knn_cuda
from simpleicp_tpu_torch.utils import sync

SHAPES = [(1000, 100_000), (1000, 1_340_000), (100_000, 100_000)]


@pytest.mark.parametrize("n_q,n_r", SHAPES)
@pytest.mark.parametrize("resident", [132, 264, 396, 528, 660])
@pytest.mark.parametrize("k", [10, 64])
def test_knn_plan_fills_the_card(n_q, n_r, resident, k):
    chunk_len, n_chunks = knn_cuda._plan_knn_chunks(n_q, n_r, k, resident)
    assert (n_chunks - 1) * chunk_len < n_r <= n_chunks * chunk_len
    assert chunk_len >= knn_cuda._KNN_MIN_CHUNK
    blocks = -(-n_q // knn_cuda._KNN_BLOCK) * n_chunks
    assert blocks / (-(-blocks // resident) * resident) >= 0.94
    # few long chunks: never the old plan's hundreds of short ones
    assert n_chunks <= 64 and chunk_len >= 2000


def test_knn_plan_small_and_capped():
    assert knn_cuda._plan_knn_chunks(7, 130, 10, 528) == (130, 1)
    assert knn_cuda._plan_knn_chunks(1, 1, 1, 528) == (1, 1)
    # the partials hold at most _KNN_MAX_LISTS (query, chunk) lists
    n_q = 4_000_000
    _, n_chunks = knn_cuda._plan_knn_chunks(n_q, 2_000_000, 10, 132)
    assert n_q * n_chunks <= knn_cuda._KNN_MAX_LISTS
    assert knn_cuda.MAX_K == 64 and knn_cuda._KNN_BLOCK == 4 * 8


# ----------------------------------------------------- a model of the k-NN


def _dist2(q, R):
    """The kernel's unfused distances of one query to refs R, in R's dtype."""
    d = q[0] - R[:, 0]
    d2 = d * d
    d = q[1] - R[:, 1]
    d2 = d2 + d * d
    d = q[2] - R[:, 2]
    return d2 + d * d


class WarpList:
    """One query's list: slot s*32 + lane of kS x 32 slots, ascending."""

    def __init__(self, k, dtype):
        self.k, self.n = k, 32 * (1 if k <= 32 else 2)
        self.d = np.full(self.n, np.inf, dtype)
        self.i = np.full(self.n, 0x7FFFFFFF, np.int64)

    def kth(self):
        return self.d[self.k - 1]

    def insert(self, cd, ci):
        """csrc/knn.cu wl_insert: each slot holding more than cd takes its
        predecessor's pair, or the candidate if the predecessor does not
        hold more."""
        up_d = np.concatenate([[np.inf], self.d[:-1]]).astype(self.d.dtype)
        up_i = np.concatenate([[0x7FFFFFFF], self.i[:-1]])
        gt = cd < self.d
        prev_gt = cd < up_d
        prev_gt[0] = False
        nd = np.where(prev_gt, up_d, cd)
        ni = np.where(prev_gt, up_i, ci)
        self.d = np.where(gt, nd, self.d).astype(self.d.dtype)
        self.i = np.where(gt, ni, self.i)

    def offer(self, d, i):
        """csrc/knn.cu wl_offer: 32 candidates, one a lane; the ballot is
        taken against the k-th at the step's start, then each passing lane
        in order is checked again and inserted."""
        kth = self.kth()
        for lane in np.nonzero(d < kth)[0]:
            if d[lane] < self.kth():
                self.insert(d[lane], i[lane])

    def fill(self, q, R, mask):
        """csrc/knn.cu wl_fill: the +inf tail from index 0."""
        m = int(np.sum(np.isfinite(self.d[:self.k])))
        for j0 in range(0, len(R), 32):
            if m >= self.k:
                break
            j = np.arange(j0, min(j0 + 32, len(R)))
            d = _dist2(q, R[j])
            masked = np.zeros(len(j), bool) if mask is None else ~mask[j]
            d = np.where(masked, np.inf, d).astype(R.dtype)
            tail = masked | ~(d < np.inf)
            for lane in np.nonzero(tail)[0]:
                if m >= self.k:
                    break
                self.d[m], self.i[m] = d[lane], j0 + lane
                m += 1


def model_knn(Q, R, k, mask, chunk_len):
    """The kernel's scan (chunks of chunk_len refs, 32 a step, masked refs
    and the ragged edge as +inf coordinates) and merge, query by query."""
    n = len(R)
    staged = R.copy()
    if mask is not None:
        staged[~mask] = np.inf
    chunks = [(lo, min(n, lo + chunk_len)) for lo in range(0, n, chunk_len)]
    out_d = np.empty((len(Q), k), R.dtype)
    out_i = np.empty((len(Q), k), np.int64)
    with np.errstate(invalid="ignore", over="ignore"):
        for a, q in enumerate(Q):
            lists = []
            for lo, hi in chunks:
                lst = WarpList(k, R.dtype)
                for s in range(lo, hi, 32):
                    j = np.arange(s, s + 32)
                    p = np.full((32, 3), np.inf, R.dtype)
                    p[j < hi] = staged[j[j < hi]]
                    lst.offer(_dist2(q, p), j)
                lists.append(lst)
            if len(lists) == 1:
                final = lists[0]
            else:
                final = WarpList(k, R.dtype)
                cd = np.concatenate([lst.d[:k] for lst in lists])
                ci = np.concatenate([lst.i[:k] for lst in lists])
                for t0 in range(0, len(cd), 32):
                    d = np.full(32, np.inf, R.dtype)
                    i = np.full(32, 0x7FFFFFFF, np.int64)
                    d[:len(cd[t0:t0 + 32])] = cd[t0:t0 + 32]
                    i[:len(ci[t0:t0 + 32])] = ci[t0:t0 + 32]
                    final.offer(d, i)
            final.fill(q, R, mask)
            out_d[a], out_i[a] = final.d[:k], final.i[:k]
    return out_d, out_i


def _lattice(n):
    g = np.arange(float(n))
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


def _case(name, dtype, rng):
    lat = _lattice(6)
    if name == "tie lattice":
        q = lat[rng.choice(len(lat), 12, replace=False)] + 0.5 * rng.integers(0, 2, (12, 3))
        return q.astype(dtype), lat.astype(dtype), None
    if name == "tie lattice, repeated":
        q = lat[rng.choice(len(lat), 12, replace=False)] + 0.5 * rng.integers(0, 2, (12, 3))
        return q.astype(dtype), np.concatenate([lat] * 3).astype(dtype), None
    if name == "tie lattice, masked":
        q = lat[rng.choice(len(lat), 12, replace=False)] + 0.5 * rng.integers(0, 2, (12, 3))
        return q.astype(dtype), lat.astype(dtype), rng.random(len(lat)) < 0.4
    q = rng.uniform(0, 1, (9, 3)).astype(dtype)
    r = rng.uniform(0, 1, (300, 3)).astype(dtype)
    if name == "fewer valid than k":
        mask = np.zeros(300, bool)
        mask[[5, 77, 299]] = True
        return q, r, mask
    return q, r, rng.random(300) < 0.3  # "random, masked"


CASES = ["tie lattice", "tie lattice, repeated", "tie lattice, masked",
         "fewer valid than k", "random, masked"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [1, 10, 26, 32, 33, 64])
@pytest.mark.parametrize("chunk_len", [10_000, 97, 32])
def test_knn_model_equals_stable_sort(dtype, case, k, chunk_len):
    """The model of the scan and merge, with one chunk, ragged chunks and
    one step a chunk, equals knn_search_plain bit for bit."""
    Q, R, mask = _case(case, dtype, np.random.default_rng(51))
    d, i = model_knn(Q, R, k, mask, chunk_len)
    pd, pi = tk.knn_search_plain(torch.from_numpy(Q), torch.from_numpy(R), k,
                                 None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(i, pi.numpy())
    np.testing.assert_array_equal(d, pd.numpy())


@pytest.mark.parametrize("k", [10, 26, 33])
def test_knn_model_equals_lax_on_ties(k):
    """On the tie lattice (every difference and square exact) the model
    equals the JAX package's lax knn_search in indices and d2."""
    Q, R, _ = _case("tie lattice, repeated", np.float64, np.random.default_rng(52))
    d, i = model_knn(Q, R, k, None, 97)
    jd, ji = jk.knn_search(jnp.asarray(Q), jnp.asarray(R), k)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_array_equal(d, np.asarray(jd))


def test_knn_model_filter_needs_the_fill():
    """Without the tail fill the strict filter leaves the sentinel where
    the plain version has the lowest masked indices: the trap the fill
    exists for."""
    Q, R, mask = _case("fewer valid than k", np.float64, np.random.default_rng(53))
    lst = WarpList(8, R.dtype)
    staged = np.where(mask[:, None], R, np.inf)
    with np.errstate(invalid="ignore"):
        for s in range(0, len(R), 32):
            j = np.arange(s, min(s + 32, len(R)))
            p = np.full((32, 3), np.inf)
            p[:len(j)] = staged[j]
            lst.offer(_dist2(Q[0], p), np.arange(s, s + 32))
    assert list(lst.i[3:8]) == [0x7FFFFFFF] * 5
    lst.fill(Q[0], R, mask)
    assert list(lst.i[3:8]) == [0, 1, 2, 3, 4]


# ------------------------------------------ a model of the index mode's finish


def model_finish(part_d):
    """csrc/knn.cu arg_finish_body's chunk choice for one query: lane l
    takes chunks l, l+32, ... with a strict '<', then a butterfly keeps the
    lesser d2 or, on equal d2, the lower chunk."""
    best = np.full(32, np.inf)
    bc = np.full(32, 0x7FFFFFFF)
    for c, d in enumerate(part_d):
        if d < best[c % 32]:
            best[c % 32], bc[c % 32] = d, c
    for off in (16, 8, 4, 2, 1):
        od, oc = best[np.arange(32) ^ off], bc[np.arange(32) ^ off]
        take = (od < best) | ((od == best) & (oc < bc))
        best, bc = np.where(take, od, best), np.where(take, oc, bc)
    assert (best == best[0]).all() and (bc == bc[0]).all()
    return best[0], bc[0]


@pytest.mark.parametrize("n_chunks", [1, 5, 32, 33, 348, 1024])
def test_finish_picks_the_first_chunk_with_the_least_d2(n_chunks):
    rng = np.random.default_rng(n_chunks)
    for _ in range(20):
        part = rng.integers(0, 4, n_chunks).astype(float)  # many ties
        part[rng.random(n_chunks) < 0.3] = np.inf
        d, c = model_finish(part)
        if np.isinf(part).all():
            assert np.isinf(d)
        else:
            assert d == part.min() and c == int(np.argmin(part))


# -------------------------------------------------------- the wrappers' routes


class _FakeLib:
    """Records each kernel call; every call succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0

        return call


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers on CPU tensors, as if they lay on a card: the kernel
    library, the occupancy query, the device check and the stream are
    stood in for."""
    lib = _FakeLib()
    monkeypatch.setattr(knn_cuda, "_library", lambda: lib)
    monkeypatch.setattr(knn_cuda, "_resident", lambda dev, dtype, kernel: 528)
    monkeypatch.setattr(knn_cuda, "_knn_waves", lambda dev, dtype, k: 528)
    monkeypatch.setattr(knn_cuda, "_common", lambda q, r: (
        q.device, q.dtype, knn_cuda._suffix(q.dtype), q.shape[0], q.shape[1], r.shape[1]))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    monkeypatch.setattr(tk, "_on_device", lambda q: True)
    knn_cuda.reset_launch_counts()
    yield lib
    knn_cuda.reset_launch_counts()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_match_route_keeps_H_on_the_device(fake_card, dtype):
    rng = np.random.default_rng(54)
    Q = torch.as_tensor(rng.uniform(0, 1, (1000, 3)), dtype=dtype)
    X = torch.as_tensor(rng.uniform(0, 1, (100_000, 3)), dtype=dtype)
    H = torch.eye(4, dtype=dtype)
    sync.reset_host_reads()
    d, i = tk.match_transform(Q, X, H)
    assert sync.host_reads() == 0
    assert knn_cuda.LAUNCHES == {"match_transform": 1, "knn_search": 0,
                                 "nn_search": 0, "nn_search_d2": 0}
    suffix = "f32" if dtype == torch.float32 else "f64"
    [(name, args)] = fake_card.calls
    assert name == f"simpleicp_match_transform_{suffix}"
    # q, nq, refs, n, h, chunk_len, n_chunks, part_d, part_b, out_d, out_i, stream
    assert args[:5] == (Q.data_ptr(), 1000, X.data_ptr(), 100_000, H.data_ptr())
    assert args[5:7] == knn_cuda._plan_nn_chunks(1000, 100_000, 528)
    assert args[9] == d.data_ptr() and args[10] == i.data_ptr()
    assert d.shape == (1000,) and i.dtype == torch.int32


@pytest.mark.parametrize("k", [10, 33])
def test_knn_route_launches_once_with_the_plan(fake_card, k):
    rng = np.random.default_rng(55)
    Q = torch.as_tensor(rng.uniform(0, 1, (1000, 3)), dtype=torch.float32)
    X = torch.as_tensor(rng.uniform(0, 1, (100_000, 3)), dtype=torch.float32)
    d, i = tk.knn_search(Q, X, k)
    assert knn_cuda.LAUNCHES["knn_search"] == 1
    [(name, args)] = fake_card.calls
    chunk_len, n_chunks = knn_cuda._plan_knn_chunks(1000, 100_000, k, 528)
    assert name == "simpleicp_knn_f32" and args[5:8] == (k, chunk_len, n_chunks)
    assert n_chunks > 1 and args[8] is not None and args[9] is not None
    assert d.shape == (1000, k) and i.shape == (1000, k)
    # with one chunk the scan writes the output and no partials are made
    fake_card.calls.clear()
    tk.knn_search(Q[:64], X[:600], k)
    [(_, args)] = fake_card.calls
    assert args[7] == 1 and args[8] is None and args[9] is None


def test_batched_routes_launch_once_for_the_batch(fake_card):
    """A batch of 3 pairs goes to each kernel in one launch: the pointers
    of pair 0, the pair count and the pair strides last before the stream,
    and the chunk plans counting every pair's query blocks."""
    rng = np.random.default_rng(56)
    Q = torch.as_tensor(rng.uniform(0, 1, (3, 1000, 3)), dtype=torch.float32)
    X = torch.as_tensor(rng.uniform(0, 1, (3, 50_000, 3)), dtype=torch.float32)
    H = torch.eye(4, dtype=torch.float32).repeat(3, 1, 1)
    d, i = tk.match_transform(Q, X, H)
    tk.knn_search(Q, X, 10)
    d2 = tk.min_dist_sq(Q, X)
    assert knn_cuda.LAUNCHES == {"match_transform": 1, "knn_search": 1,
                                 "nn_search": 0, "nn_search_d2": 1}
    (m_name, m), (k_name, k), (n_name, n) = fake_card.calls
    assert m_name == "simpleicp_match_transform_f32"
    assert m[:5] == (Q.data_ptr(), 1000, X.data_ptr(), 50_000, H.data_ptr())
    assert m[5:7] == knn_cuda._plan_nn_chunks(1000, 50_000, 528, 3)
    assert m[9:11] == (d.data_ptr(), i.data_ptr()) and m[11:14] == (1000, 16, 3)
    assert k_name == "simpleicp_knn_f32" and k[12] == 3
    assert k[6:8] == knn_cuda._plan_knn_chunks(1000, 50_000, 10, 528, 3)
    assert n_name == "simpleicp_nn_d2_f32" and n[9:11] == (1000, 3)
    assert d.shape == i.shape == d2.shape == (3, 1000)


def test_knn_route_slices_a_batch_above_the_launch_refs(fake_card, monkeypatch):
    """The k-NN's scan indexes a launch's refs, over all its pairs, with
    int32: a batch with more refs in all goes in slices of whole pairs, each
    launch from its first pair's pointers (limit lowered to 3 pairs' refs)."""
    rng = np.random.default_rng(57)
    Q = torch.as_tensor(rng.uniform(0, 1, (8, 100, 3)), dtype=torch.float32)
    X = torch.as_tensor(rng.uniform(0, 1, (8, 5000, 3)), dtype=torch.float32)
    monkeypatch.setattr(knn_cuda, "_KNN_MAX_REFS", 3 * 5000 + 4999)
    d, i = tk.knn_search(Q, X, 10)
    assert knn_cuda.LAUNCHES["knn_search"] == 3
    assert [args[12] for _, args in fake_card.calls] == [3, 3, 2]
    assert [(args[0], args[2], args[10]) for _, args in fake_card.calls] == [
        (Q[p].data_ptr(), X[p].data_ptr(), d[p].data_ptr()) for p in (0, 3, 6)]


def test_chunk_plans_count_every_pair():
    """A batch's plan fills the same resident blocks with its pairs' query
    blocks: more pairs, no more chunks, and whole waves of blocks when it
    splits the reference axis."""
    one = knn_cuda._plan_nn_chunks(1000, 100_000, 528)
    assert one == knn_cuda._plan_nn_chunks(1000, 100_000, 528, 1)
    prev = one[1]
    for B in (2, 8, 32, 528):
        chunk_len, n_chunks = knn_cuda._plan_nn_chunks(1000, 100_000, 528, B)
        assert n_chunks <= prev and chunk_len * n_chunks >= 100_000
        if n_chunks > 1:
            assert (B * n_chunks) % 528 == 0 or B * n_chunks <= 528
        prev = n_chunks
    k_one = knn_cuda._plan_knn_chunks(1000, 100_000, 10, 528)
    k_eight = knn_cuda._plan_knn_chunks(1000, 100_000, 10, 528, 8)
    assert k_eight[1] <= k_one[1] and k_eight[0] * k_eight[1] >= 100_000

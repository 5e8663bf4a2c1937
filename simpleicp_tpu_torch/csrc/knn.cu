// Nearest-neighbour kernels of the ICP main path, for Hopper (sm_90a).
//
// Bound on the H100, all three kernels: instruction issue. Each (query,
// ref) pair needs 8 unfused operations (three subtractions, three
// multiplications, two additions: the exact distance may not use fused
// multiply-adds) and one to keep the best, so 9 issues a pair: 132 SMs x 4
// schedulers x 32 lanes x 1.98 GHz = 3.35e13 lane slots a second in
// float32, 64 FP64 lanes per SM in float64. At 1000 queries x 100 000 refs
// that floor is 27 us in float32 (54 us in float64); at 1e6 x 1e6, 269 ms.
// The data sheet's 67 TFLOP/s counts fused multiply-adds and gives half of
// that; the bytes (1.2 MB at 100k) are never the bound.
//
// nn_search (nn1_scan, nn1_min_reduce, nn1_arg_finish)
//   Replaces the TPU kernel _nn_kernel (simpleicp_tpu/ops/knn_pallas.py):
//   the masked 1-NN, first minimum, of the overlap gate. Every fixed point
//   is a query (1e5 to 1e6 of them; the dilate gate's band, 7e4 at 1.2M)
//   against the movable cloud. Two entry points share one scan: the d2-only
//   mode (simpleicp_nn_d2_*), which the gates and the metrics call, and the
//   index mode (simpleicp_nn_*), which also returns the first minimum's
//   index.
//   - Each thread holds kNnQ queries, so one shared-memory load of a ref (a
//     16-byte vector: x, y, z and a pad; two in float64, read by broadcast)
//     serves kNnQ pairs, and the kNnQ running minima are independent fminf
//     chains.
//   - The d2-only mode keeps no index: its running best is fmin, one issue
//     per pair. The minimum's value does not depend on the order of the
//     scan, so it is bit-equal to the plain version's d2.
//   - The index mode takes the minimum of each sub-tile of kNnSub refs
//     with fmin and keeps, beside its running best, the first sub-tile
//     whose minimum fell strictly below it (one compare and two selects per
//     kNnSub pairs). The finish pass gives each query a warp: its lanes take
//     the first chunk with the least d2 (strict '<' in ascending chunks,
//     then the lowest such chunk across lanes), and the warp rescans that
//     chunk's recorded sub-tile, one ref a lane, for the first ref at
//     exactly that distance, with the same intrinsics.
//   - The next tile is loaded into registers while the current one is
//     scanned, then stored to the other of two shared buffers: one barrier
//     per tile. A masked ref, and the ragged end of the last tile, enter as
//     +inf coordinates when the tile lands, so their d2 is +inf or NaN;
//     fmin ignores NaN and +inf never lowers a best that starts at +inf, so
//     neither ever wins: a query with no valid ref keeps d2 = +inf and index
//     0, as the plain version's argmin over an all-inf row gives. (The
//     plain argmin takes a NaN for the minimum; here a NaN distance never
//     wins.)
//   - A block covers kNnQ x 256 queries and one chunk of the reference
//     axis; the wrapper picks the number of chunks that fills the card's
//     resident blocks in whole waves. The d2-only mode reduces the chunks
//     with fmin (and skips that pass with one chunk).
//
// match_transform (match_scan, match_finish)
//   Replaces the TPU kernel _match_transform_kernel
//   (simpleicp_tpu/ops/knn_pallas.py): the 1-NN of each fixed query among
//   the movable cloud moved by the rigid [R | t]. It is the 1-NN's index
//   mode with the transform fused into the staging: the block reads H's 12
//   scalars from device memory (the ICP loop never reads H back to the
//   host) and moves each ref once as its tile lands, in apply_H's order
//   ((h0*x + h1*y) + h2*z) + h3; the finish pass moves the rescanned
//   sub-tile again with the same intrinsics, so the recovered index is the
//   plain version's. Only ~1000 queries exist, one query block: the chunk
//   plan spreads the reference axis over the card's resident blocks, and
//   the finish pass reduces the hundreds of chunk partials of a query with
//   a warp. Extra work: 18 operations a ref per query block.
//
// knn (knn_scan, knn_merge)
//   Replaces the TPU kernel _knn_kernel (simpleicp_tpu/ops/knn_pallas.py):
//   the k nearest refs of each query, ascending in (d2, index), with an
//   optional ref mask, k <= 64.
//   - A warp owns kKnnQ queries and scans refs one a lane: each step loads
//     32 refs (one 16-byte load a lane from the staged tile) and computes
//     32 x kKnnQ distances. Each query's sorted list of k (d2, index) pairs
//     is spread over the warp's registers: slot s*32 + lane in element s of
//     kS = 1 (k <= 32) or 2 (k <= 64) per lane, a compile-time count, so
//     every index is static and nothing lives in local memory.
//   - One compare a pair: d2 < the list's k-th d2, and one vote a step
//     over the kKnnQ lists of the warp; only when a lane passes, a ballot
//     per list. The lanes that pass are inserted in lane order, so a warp
//     never diverges: the candidate is broadcast, every lane compares it
//     with its slots and shifts by one with __shfl_up (branch-free
//     selects), and the k-th d2 is re-read with one shuffle.
//   - The filter and the insertion use a strict '<' on d2 alone. That is
//     the lexicographic (d2, index) order because candidates always arrive
//     in ascending index among equal d2: in the scan the refs come in
//     ascending order; in the merge the chunks' lists come in ascending
//     chunk order, each list in its own (d2, index) order, and chunks are
//     ascending ranges. An equal d2 therefore always has the higher index,
//     goes after the entries it ties and never displaces the k-th. No
//     threshold is shared between lists: each prunes with its own k-th d2.
//   - Masked refs and the ragged tile edge enter as +inf coordinates at
//     staging, so their d2 is +inf or NaN and never passes the filter. The
//     plain version's stable sort puts every ref of d2 = +inf (the masked
//     ones) after the finite ones in ascending index. So when a query's
//     final list holds m < k finite pairs (then it holds every finite ref),
//     its warp walks the refs from index 0 and fills slots m..k-1 with the
//     first refs that are masked or at a distance that is not finite (+inf
//     for masked refs, the distance itself otherwise).
//   - A block holds kKnnQ x 8 queries and one chunk of the reference axis;
//     the wrapper's whole-wave plan picks few long chunks, since each list
//     that starts empty pays about k (1 + ln(chunk / k)) insertions. With
//     one chunk the scan writes the result; otherwise a warp per query
//     merges the chunks' lists into a fresh list with the same insertion.
//   Per pair: 8 distance operations, one compare, a share of the vote and
//   a kKnnQ-th of a load, so about 10 issues, plus the insertions.
//
// The pair axis (icp_register_batch): every kernel takes a batch of cloud
// pairs in one launch, each pair's queries against its own refs (and, for
// the match, its own H). The scans' grid gains a dimension, blockIdx.z the
// pair (blockIdx.x and .y keep the chunk and the query block); the finish,
// reduce and merge passes take the pair on blockIdx.y. Each pass first moves
// its pointers to its pair: queries and outputs by the pair stride the
// wrapper gives (q_pair queries; the 1-NN wrappers launch slices of a
// pair's queries), refs by n, the mask by n, H by h_pair scalars, the
// partials by their own per-pair size. The k-NN scan instead reads its
// refs and mask at an int32 offset from the pair's first ref, so that no
// moved pointer holds registers through its scan. A pair's blocks run the
// same code on the same data as the pair's own launch, and the reduction
// across chunks keeps its ascending order, so each pair's answer is the
// single launch's, bit for bit, whatever the chunk plan. At most 65 535
// pairs a launch (the grid's z and y limits), and below 2^31 refs in all
// for the k-NN; the wrappers slice larger batches.
//
// All: every multiply, add and subtract of the transform and the distance
// is an explicit round-to-nearest intrinsic (__fmul_rn / __fadd_rn /
// __fsub_rn, __dmul_rn / __dadd_rn / __dsub_rn), which nvcc never contracts
// into an FMA. The kernels thus round exactly as the plain PyTorch version's
// separate elementwise operations do, and agree with it bit for bit.
// Indices are int32. The mask is read as bytes (a torch.bool tensor). The
// kernels allocate nothing; outputs and partials come from the caller, and
// every pass runs on the caller's stream.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 64;      // largest k of the k-NN kernel
constexpr int kNoIndex = 0x7fffffff;
constexpr int kNnQ = 4;        // 1-NN: queries per thread
constexpr int kNnTile = 512;   // refs per shared-memory tile (two buffers)
constexpr int kNnSub = 32;     // 1-NN: refs per sub-tile of the index mode
constexpr int kNnStage = kNnTile / kThreads;  // refs each thread stages per tile
constexpr int kKnnQ = 4;       // k-NN: queries per warp
constexpr int kKnnBlock = kKnnQ * kWarps;     // k-NN: queries per block
static_assert(kNnSub == 32, "the finish pass rescans a sub-tile one ref a lane");

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ bool lt(float a, float b) { return a < b; }
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  // a < b for squared distances (each +0, positive, +inf or NaN; never
  // negative) as their bit patterns read as unsigned integers: the order of
  // non-negative doubles, with a NaN of either sign above +inf, so a NaN is
  // never less. Integer instructions, off the FP64 pipe that the distance
  // saturates (a double compare is a DSETP there).
  static __device__ __forceinline__ bool lt(double a, double b) {
    return static_cast<unsigned long long>(__double_as_longlong(a)) <
           static_cast<unsigned long long>(__double_as_longlong(b));
  }
  // The lesser of two squared distances by the same order: fmin's result
  // (a NaN never wins) in four integer instructions.
  static __device__ __forceinline__ double min(double a, double b) { return lt(b, a) ? b : a; }
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
};

// One staged ref: x, y, z and a pad, 16-byte aligned.
template <typename T>
struct alignas(16) Ref4 {
  T x, y, z, pad;
};

// ((qx-rx)^2 + (qy-ry)^2) + (qz-rz)^2, unfused.
template <typename T>
__device__ __forceinline__ T dist2(T qx, T qy, T qz, T rx, T ry, T rz) {
  using A = Rn<T>;
  const T dx = A::sub(qx, rx);
  const T dy = A::sub(qy, ry);
  const T dz = A::sub(qz, rz);
  return A::add(A::add(A::mul(dx, dx), A::mul(dy, dy)), A::mul(dz, dz));
}

// ((h0*x + h1*y) + h2*z) + h3, unfused: the order of apply_H.
template <typename T>
__device__ __forceinline__ T affine(const T* h, T x, T y, T z) {
  using A = Rn<T>;
  return A::add(A::add(A::add(A::mul(h[0], x), A::mul(h[1], y)), A::mul(h[2], z)), h[3]);
}

// Ref j, moved by the rows of H when kXf.
template <typename T, bool kXf>
__device__ __forceinline__ void load_ref(const T* __restrict__ r, const T (&h)[12], int j,
                                         T& x, T& y, T& z) {
  const T* p = r + 3 * (size_t)j;
  const T px = p[0], py = p[1], pz = p[2];
  if (kXf) {
    x = affine(h, px, py, pz);
    y = affine(h + 4, px, py, pz);
    z = affine(h + 8, px, py, pz);
  } else {
    x = px;
    y = py;
    z = pz;
  }
}

// H's first three rows into registers (kXf), else nothing.
template <typename T, bool kXf>
__device__ __forceinline__ void load_h(const T* __restrict__ h_mem, T (&h)[12]) {
#pragma unroll
  for (int m = 0; m < 12; ++m) h[m] = kXf ? h_mem[m] : T(0);
}

// Loads this thread's kNnStage refs of the tile at `base` into registers;
// a masked ref, or one at or past `hi`, becomes +inf coordinates. Ref j is
// read at r[off + j] (and mask[off + j]).
template <typename T, bool kXf>
__device__ __forceinline__ void nn1_fetch(const T* __restrict__ r,
                                          const uint8_t* __restrict__ mask,
                                          const T (&h)[12], int base, int hi,
                                          T (&sx)[kNnStage], T (&sy)[kNnStage],
                                          T (&sz)[kNnStage], int off = 0) {
#pragma unroll
  for (int m = 0; m < kNnStage; ++m) {
    const int j = base + threadIdx.x + m * kThreads;
    if (j < hi && (mask == nullptr || mask[off + j])) {
      load_ref<T, kXf>(r, h, off + j, sx[m], sy[m], sz[m]);
    } else {
      sx[m] = sy[m] = sz[m] = Rn<T>::inf();
    }
  }
}

template <typename T>
__device__ __forceinline__ void nn1_store(Ref4<T>* tile, const T (&sx)[kNnStage],
                                          const T (&sy)[kNnStage],
                                          const T (&sz)[kNnStage]) {
#pragma unroll
  for (int m = 0; m < kNnStage; ++m) {
    tile[threadIdx.x + m * kThreads] = Ref4<T>{sx[m], sy[m], sz[m], T(0)};
  }
}

// The 1-NN scan of one chunk of the reference axis for kNnQ x kThreads
// queries of pair blockIdx.z, refs moved by H when kXf. d2-only (kIndex
// false): part_d[pair][chunk][q] is the least d2 (part_pair apart). Index
// mode: part_d as well, and part_b[pair][chunk][q] the first ref of the first
// sub-tile that holds it (meaningful when part_d is finite).
template <typename T, bool kIndex, bool kXf>
__device__ __forceinline__ void nn1_scan_body(Ref4<T> (*tiles)[kNnTile],
                                              const T* __restrict__ q, int nq, int q_pair,
                                              const T* __restrict__ r, int n,
                                              const uint8_t* __restrict__ mask,
                                              const T* __restrict__ h_mem, int h_pair,
                                              int chunk_len, T* __restrict__ part_d,
                                              int* __restrict__ part_b, size_t part_pair) {
  using A = Rn<T>;
  // the pair's queries, refs, mask and H; its partials are offset where
  // they are written
  const size_t pair = blockIdx.z;
  q += pair * 3 * q_pair;
  r += pair * 3 * n;
  if (mask != nullptr) mask += pair * n;
  if (kXf) h_mem += pair * h_pair;
  T h[12];
  load_h<T, kXf>(h_mem, h);
  const int lo = blockIdx.x * chunk_len;
  const int hi = min(n, lo + chunk_len);
  const int q0 = blockIdx.y * (kNnQ * kThreads) + threadIdx.x;
  T qx[kNnQ], qy[kNnQ], qz[kNnQ], best[kNnQ];
  int first[kNnQ];
#pragma unroll
  for (int k = 0; k < kNnQ; ++k) {
    const int qi = q0 + k * kThreads;
    qx[k] = qy[k] = qz[k] = T(0);
    if (qi < nq) {
      qx[k] = q[3 * (size_t)qi];
      qy[k] = q[3 * (size_t)qi + 1];
      qz[k] = q[3 * (size_t)qi + 2];
    }
    best[k] = A::inf();
    first[k] = 0;
  }

  T sx[kNnStage], sy[kNnStage], sz[kNnStage];
  nn1_fetch<T, kXf>(r, mask, h, lo, hi, sx, sy, sz);
  nn1_store(tiles[0], sx, sy, sz);
  __syncthreads();
  int buf = 0;
  for (int base = lo; base < hi; base += kNnTile) {
    const bool more = base + kNnTile < hi;  // the same in every thread
    if (more) nn1_fetch<T, kXf>(r, mask, h, base + kNnTile, hi, sx, sy, sz);
    const Ref4<T>* t = tiles[buf];
    const int n_sub = (min(kNnTile, hi - base) + kNnSub - 1) / kNnSub;
    for (int s = 0; s < n_sub; ++s, t += kNnSub) {
      if (kIndex) {
        T m[kNnQ];
#pragma unroll
        for (int k = 0; k < kNnQ; ++k) m[k] = A::inf();
#pragma unroll
        for (int j = 0; j < kNnSub; ++j) {
          const Ref4<T> p = t[j];
#pragma unroll
          for (int k = 0; k < kNnQ; ++k)
            m[k] = A::min(m[k], dist2(qx[k], qy[k], qz[k], p.x, p.y, p.z));
        }
#pragma unroll
        for (int k = 0; k < kNnQ; ++k) {
          if (m[k] < best[k]) {
            best[k] = m[k];
            first[k] = base + s * kNnSub;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNnSub; ++j) {
          const Ref4<T> p = t[j];
#pragma unroll
          for (int k = 0; k < kNnQ; ++k)
            best[k] = A::min(best[k], dist2(qx[k], qy[k], qz[k], p.x, p.y, p.z));
        }
      }
    }
    if (more) nn1_store(tiles[buf ^ 1], sx, sy, sz);
    __syncthreads();  // the next tile has landed; this one is no longer read
    buf ^= 1;
  }
#pragma unroll
  for (int k = 0; k < kNnQ; ++k) {
    const int qi = q0 + k * kThreads;
    if (qi < nq) {
      const size_t at = blockIdx.z * part_pair + (size_t)blockIdx.x * nq + qi;
      part_d[at] = best[k];
      if (kIndex) part_b[at] = first[k];
    }
  }
}

template <typename T, bool kIndex>
__global__ void __launch_bounds__(kThreads)
nn1_scan(const T* __restrict__ q, int nq, int q_pair, const T* __restrict__ r, int n,
         const uint8_t* __restrict__ mask, int chunk_len, T* __restrict__ part_d,
         int* __restrict__ part_b, size_t part_pair) {
  __shared__ Ref4<T> tiles[2][kNnTile];
  nn1_scan_body<T, kIndex, false>(tiles, q, nq, q_pair, r, n, mask, nullptr, 0, chunk_len,
                                  part_d, part_b, part_pair);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
match_scan(const T* __restrict__ q, int nq, int q_pair, const T* __restrict__ x, int n,
           const T* __restrict__ h, int h_pair, int chunk_len, T* __restrict__ part_d,
           int* __restrict__ part_b) {
  __shared__ Ref4<T> tiles[2][kNnTile];
  nn1_scan_body<T, true, true>(tiles, q, nq, q_pair, x, n, nullptr, h, h_pair, chunk_len,
                               part_d, part_b, (size_t)gridDim.x * nq);
}

// d2-only: the least of the per-chunk minima (fmin; none is NaN), for the
// queries of pair blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nn1_min_reduce(const T* __restrict__ part_d, int nq, int q_pair, int n_chunks,
               T* __restrict__ out_d) {
  const size_t pair = blockIdx.y;
  part_d += pair * n_chunks * nq;
  out_d += pair * q_pair;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  if (qi >= nq) return;
  T best = part_d[qi];
  for (int c = 1; c < n_chunks; ++c) best = Rn<T>::min(best, part_d[(size_t)c * nq + qi]);
  out_d[qi] = best;
}

// Index mode, a warp per query of pair blockIdx.y: the first chunk with the
// least d2 (strict
// '<' over each lane's ascending chunks, then the lowest chunk among the
// lanes' equal minima), then the first ref of its recorded sub-tile at
// exactly that distance, one ref a lane, moved by H again when kXf. A
// masked ref had +inf coordinates in the scan, so it is skipped here; with
// no finite d2 the index is 0.
template <typename T, bool kXf>
__device__ __forceinline__ void arg_finish_body(const T* __restrict__ q, int nq, int q_pair,
                                                const T* __restrict__ r, int n,
                                                const uint8_t* __restrict__ mask,
                                                const T* __restrict__ h_mem, int h_pair,
                                                int n_chunks, const T* __restrict__ part_d,
                                                const int* __restrict__ part_b,
                                                T* __restrict__ out_d,
                                                int* __restrict__ out_i) {
  const size_t pair = blockIdx.y;
  q += pair * 3 * q_pair;
  r += pair * 3 * n;
  if (mask != nullptr) mask += pair * n;
  if (kXf) h_mem += pair * h_pair;
  part_d += pair * n_chunks * nq;
  part_b += pair * n_chunks * nq;
  out_d += pair * q_pair;
  out_i += pair * q_pair;
  const int lane = threadIdx.x & 31;
  const int qi = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (qi >= nq) return;  // the whole warp
  T best = Rn<T>::inf();
  int bc = kNoIndex;
  for (int c = lane; c < n_chunks; c += 32) {
    const T d = part_d[(size_t)c * nq + qi];
    if (d < best) {
      best = d;
      bc = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T od = __shfl_xor_sync(kFull, best, off);
    const int oc = __shfl_xor_sync(kFull, bc, off);
    if (od < best || (od == best && oc < bc)) {
      best = od;
      bc = oc;
    }
  }
  int idx = 0;
  if (best < Rn<T>::inf()) {  // the same in every lane
    T h[12];
    load_h<T, kXf>(h_mem, h);
    const T qx = q[3 * (size_t)qi], qy = q[3 * (size_t)qi + 1], qz = q[3 * (size_t)qi + 2];
    const int b = part_b[(size_t)bc * nq + qi];
    const int j = b + lane;
    bool hit = false;
    if (j < n && (mask == nullptr || mask[j])) {
      T px, py, pz;
      load_ref<T, kXf>(r, h, j, px, py, pz);
      hit = dist2(qx, qy, qz, px, py, pz) == best;
    }
    const unsigned bal = __ballot_sync(kFull, hit);
    if (bal) idx = b + __ffs(bal) - 1;
  }
  if (lane == 0) {
    out_d[qi] = best;
    out_i[qi] = idx;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nn1_arg_finish(const T* __restrict__ q, int nq, int q_pair, const T* __restrict__ r, int n,
               const uint8_t* __restrict__ mask, int n_chunks,
               const T* __restrict__ part_d, const int* __restrict__ part_b,
               T* __restrict__ out_d, int* __restrict__ out_i) {
  arg_finish_body<T, false>(q, nq, q_pair, r, n, mask, nullptr, 0, n_chunks, part_d,
                            part_b, out_d, out_i);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
match_finish(const T* __restrict__ q, int nq, int q_pair, const T* __restrict__ x, int n,
             const T* __restrict__ h, int h_pair, int n_chunks,
             const T* __restrict__ part_d, const int* __restrict__ part_b,
             T* __restrict__ out_d, int* __restrict__ out_i) {
  arg_finish_body<T, true>(q, nq, q_pair, x, n, nullptr, h, h_pair, n_chunks, part_d,
                           part_b, out_d, out_i);
}

// ------------------------------------------------------------------ k-NN

// One query's ascending list of the k-NN, spread over a warp: slot
// s * 32 + lane is element s of this lane.
template <typename T, int kS>
struct WarpList {
  T d[kS];
  int i[kS];
};

template <typename T, int kS>
__device__ __forceinline__ void wl_init(WarpList<T, kS>& l) {
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    l.d[s] = Rn<T>::inf();
    l.i[s] = kNoIndex;
  }
}

// The d2 of slot k - 1, in every lane. Each element is shuffled and the
// values selected: a select between two elements would become a load from
// a computed address, and the list would leave the registers.
template <typename T, int kS>
__device__ __forceinline__ T wl_kth(const WarpList<T, kS>& l, int k) {
  const int t = k - 1;
  T v = __shfl_sync(kFull, l.d[0], t & 31);
#pragma unroll
  for (int s = 1; s < kS; ++s) {
    const T w = __shfl_sync(kFull, l.d[s], t & 31);
    v = (t >> 5) == s ? w : v;
  }
  return v;
}

// Inserts (cd, ci), the same in every lane, after every entry whose d2 is
// not greater: each slot that holds more than cd takes its predecessor's
// pair, or the candidate if the predecessor does not hold more. Branch-free.
template <typename T, int kS>
__device__ __forceinline__ void wl_insert(WarpList<T, kS>& l, T cd, int ci, int lane) {
  using A = Rn<T>;
  T up_d[kS];
  int up_i[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    up_d[s] = __shfl_up_sync(kFull, l.d[s], 1);
    up_i[s] = __shfl_up_sync(kFull, l.i[s], 1);
  }
#pragma unroll
  for (int s = 1; s < kS; ++s) {  // slot s*32 follows slot s*32 - 1 (lane 31)
    const T cd_prev = __shfl_sync(kFull, l.d[s - 1], 31);
    const int ci_prev = __shfl_sync(kFull, l.i[s - 1], 31);
    if (lane == 0) {
      up_d[s] = cd_prev;
      up_i[s] = ci_prev;
    }
  }
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const bool gt = A::lt(cd, l.d[s]);
    const bool prev_gt = !(s == 0 && lane == 0) && A::lt(cd, up_d[s]);
    const T nd = prev_gt ? up_d[s] : cd;
    const int ni = prev_gt ? up_i[s] : ci;
    l.d[s] = gt ? nd : l.d[s];
    l.i[s] = gt ? ni : l.i[s];
  }
}

// Offers the warp's 32 candidates (d, i), one a lane, in lane order: those
// below the k-th d2 are inserted, the k-th re-read after each.
template <typename T, int kS>
__device__ __forceinline__ void wl_offer(WarpList<T, kS>& l, T& kth, int k, T d, int i,
                                         int lane) {
  unsigned bal = __ballot_sync(kFull, Rn<T>::lt(d, kth));
  while (bal) {  // the same in every lane
    const int src = __ffs(bal) - 1;
    bal &= bal - 1;
    const T cd = __shfl_sync(kFull, d, src);
    const int ci = __shfl_sync(kFull, i, src);
    if (Rn<T>::lt(cd, kth)) {
      wl_insert(l, cd, ci, lane);
      kth = wl_kth(l, k);
    }
  }
}

// With fewer than k finite pairs in the final list (so every finite ref is
// in it), fills the slots past them with the first refs, in ascending index,
// that are masked (d2 +inf) or at a distance that is not finite: the plain
// version's stable sort of the +inf row tail.
template <typename T, int kS>
__device__ __forceinline__ void wl_fill(WarpList<T, kS>& l, int k, T qx, T qy, T qz,
                                        const T* __restrict__ r, int n,
                                        const uint8_t* __restrict__ mask, int lane) {
  using A = Rn<T>;
  const T no_h[12] = {};
  int m = 0;
#pragma unroll
  for (int s = 0; s < kS; ++s)
    m += __popc(__ballot_sync(kFull, s * 32 + lane < k && A::lt(l.d[s], A::inf())));
  for (int j0 = 0; m < k && j0 < n; j0 += 32) {  // the same in every lane
    const int j = j0 + lane;
    T d = A::inf();
    bool tail = false;
    if (j < n) {
      if (mask != nullptr && !mask[j]) {
        tail = true;
      } else {
        T px, py, pz;
        load_ref<T, false>(r, no_h, j, px, py, pz);
        d = dist2(qx, qy, qz, px, py, pz);
        tail = !A::lt(d, A::inf());
      }
    }
    unsigned bal = __ballot_sync(kFull, tail);
    while (bal && m < k) {
      const int src = __ffs(bal) - 1;
      bal &= bal - 1;
      const T cd = __shfl_sync(kFull, d, src);
      const bool here = lane == (m & 31);
#pragma unroll
      for (int s = 0; s < kS; ++s) {  // selects, not a store at a computed slot
        const bool at = here && (m >> 5) == s;
        l.d[s] = at ? cd : l.d[s];
        l.i[s] = at ? j0 + src : l.i[s];
      }
      ++m;
    }
  }
}

template <typename T, int kS>
__device__ __forceinline__ void wl_store(const WarpList<T, kS>& l, int k,
                                         T* __restrict__ d, int* __restrict__ i,
                                         int lane) {
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int slot = s * 32 + lane;
    if (slot < k) {
      d[slot] = l.d[s];
      i[slot] = l.i[s];
    }
  }
}

// The k-NN scan of one chunk (blockIdx.y) of the reference axis for the
// kKnnBlock queries of blockIdx.x of pair blockIdx.z, kKnnQ a warp. Writes
// each query's list to part[pair][q][chunk][0..k); with one chunk part is
// the output, filled.
template <typename T, int kS>
__global__ void __launch_bounds__(kThreads)
knn_scan(const T* __restrict__ q, int nq, const T* __restrict__ r, int n,
         const uint8_t* __restrict__ mask, int k, int chunk_len, int n_chunks,
         T* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ Ref4<T> tiles[2][kNnTile];
  // The pair's queries. Its refs and mask are read at the pair's first ref,
  // off = pair * n (below 2^31: the wrapper slices the pairs), from the
  // kernel's own parameters: a pointer moved to the pair would hold two
  // registers each through the scan, and the float32 scan would then fit
  // 4 blocks a SM where it fits 5. Its partials are offset where they are
  // written.
  q += (size_t)blockIdx.z * 3 * nq;
  const int off = blockIdx.z * n;
  const T no_h[12] = {};
  const int lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kKnnQ;
  const int c = blockIdx.y;
  const int lo = c * chunk_len;
  const int hi = min(n, lo + chunk_len);
  T qx[kKnnQ], qy[kKnnQ], qz[kKnnQ], kth[kKnnQ];
  WarpList<T, kS> lst[kKnnQ];
#pragma unroll
  for (int a = 0; a < kKnnQ; ++a) {
    const int qi = q0 + a;
    // a query past nq sits at +inf: its d2 is +inf or NaN and never enters
    qx[a] = qy[a] = qz[a] = Rn<T>::inf();
    if (qi < nq) {
      qx[a] = q[3 * (size_t)qi];
      qy[a] = q[3 * (size_t)qi + 1];
      qz[a] = q[3 * (size_t)qi + 2];
    }
    wl_init(lst[a]);
    kth[a] = Rn<T>::inf();
  }

  T sx[kNnStage], sy[kNnStage], sz[kNnStage];
  nn1_fetch<T, false>(r, mask, no_h, lo, hi, sx, sy, sz, off);
  nn1_store(tiles[0], sx, sy, sz);
  __syncthreads();
  int buf = 0;
  for (int base = lo; base < hi; base += kNnTile) {
    const bool more = base + kNnTile < hi;  // the same in every thread
    if (more) nn1_fetch<T, false>(r, mask, no_h, base + kNnTile, hi, sx, sy, sz, off);
    const Ref4<T>* t = tiles[buf];
    const int cnt = min(kNnTile, hi - base);
    for (int s = 0; s < cnt; s += 32) {  // past cnt the tile holds +inf refs
      const Ref4<T> p = t[s + lane];
      const int idx = base + s + lane;
      T d[kKnnQ];
      bool pass = false;
#pragma unroll
      for (int a = 0; a < kKnnQ; ++a) {
        d[a] = dist2(qx[a], qy[a], qz[a], p.x, p.y, p.z);
        pass |= Rn<T>::lt(d[a], kth[a]);
      }
      if (__any_sync(kFull, pass)) {  // one vote a step for all kKnnQ lists
#pragma unroll
        for (int a = 0; a < kKnnQ; ++a) wl_offer(lst[a], kth[a], k, d[a], idx, lane);
      }
    }
    if (more) nn1_store(tiles[buf ^ 1], sx, sy, sz);
    __syncthreads();  // the next tile has landed; this one is no longer read
    buf ^= 1;
  }
#pragma unroll
  for (int a = 0; a < kKnnQ; ++a) {
    const int qi = q0 + a;
    if (qi < nq) {  // the same in every lane
      if (n_chunks == 1)
        wl_fill(lst[a], k, qx[a], qy[a], qz[a], r + 3 * (size_t)off, n,
                mask == nullptr ? nullptr : mask + off, lane);
      const size_t row = (((size_t)blockIdx.z * nq + qi) * n_chunks + c) * k;
      wl_store(lst[a], k, part_d + row, part_i + row, lane);
    }
  }
}

// A warp per query of pair blockIdx.y: the chunks' lists in ascending
// (chunk, slot) order through the same filter and insertion, then the +inf
// tail, then out.
template <typename T, int kS>
__global__ void __launch_bounds__(kThreads)
knn_merge(const T* __restrict__ q, int nq, const T* __restrict__ r, int n,
          const uint8_t* __restrict__ mask, int k, int n_chunks,
          const T* __restrict__ part_d, const int* __restrict__ part_i,
          T* __restrict__ out_d, int* __restrict__ out_i) {
  const size_t pair = blockIdx.y;
  q += pair * 3 * nq;
  r += pair * 3 * n;
  if (mask != nullptr) mask += pair * n;
  part_d += pair * nq * n_chunks * k;
  part_i += pair * nq * n_chunks * k;
  out_d += pair * nq * k;
  out_i += pair * nq * k;
  const int lane = threadIdx.x & 31;
  const int qi = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (qi >= nq) return;  // the whole warp
  WarpList<T, kS> l;
  wl_init(l);
  T kth = Rn<T>::inf();
  const int total = n_chunks * k;
  const T* pd = part_d + (size_t)qi * total;
  const int* pi = part_i + (size_t)qi * total;
  for (int t0 = 0; t0 < total; t0 += 32) {
    const int t = t0 + lane;
    T d = Rn<T>::inf();
    int i = kNoIndex;
    if (t < total) {
      d = pd[t];
      i = pi[t];
    }
    wl_offer(l, kth, k, d, i, lane);
  }
  wl_fill(l, k, q[3 * (size_t)qi], q[3 * (size_t)qi + 1], q[3 * (size_t)qi + 2], r, n,
          mask, lane);
  wl_store(l, k, out_d + (size_t)qi * k, out_i + (size_t)qi * k, lane);
}

// ------------------------------------------------------------- launchers

// Index mode: the scan into (n_pairs, n_chunks, nq) partials, then the finish
// pass.
template <typename T>
int launch_nn(const void* q, int nq, int q_pair, const void* r, int n, const void* mask,
              int chunk_len, int n_chunks, void* part_d, void* part_b, void* out_d,
              void* out_i, int n_pairs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 scan_grid(n_chunks, (nq + kNnQ * kThreads - 1) / (kNnQ * kThreads), n_pairs);
  nn1_scan<T, true><<<scan_grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, q_pair, static_cast<const T*>(r), n,
      static_cast<const uint8_t*>(mask), chunk_len, static_cast<T*>(part_d),
      static_cast<int*>(part_b), (size_t)n_chunks * nq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn1_arg_finish<T><<<dim3((nq + kWarps - 1) / kWarps, n_pairs), kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, q_pair, static_cast<const T*>(r), n,
      static_cast<const uint8_t*>(mask), n_chunks, static_cast<const T*>(part_d),
      static_cast<const int*>(part_b), static_cast<T*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

// The match: the index mode's two passes with the refs moved by H.
template <typename T>
int launch_match(const void* q, int nq, int q_pair, const void* x, int n, const void* h,
                 int h_pair, int chunk_len, int n_chunks, void* part_d, void* part_b,
                 void* out_d, void* out_i, int n_pairs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 scan_grid(n_chunks, (nq + kNnQ * kThreads - 1) / (kNnQ * kThreads), n_pairs);
  match_scan<T><<<scan_grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, q_pair, static_cast<const T*>(x), n,
      static_cast<const T*>(h), h_pair, chunk_len, static_cast<T*>(part_d),
      static_cast<int*>(part_b));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  match_finish<T><<<dim3((nq + kWarps - 1) / kWarps, n_pairs), kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, q_pair, static_cast<const T*>(x), n,
      static_cast<const T*>(h), h_pair, n_chunks, static_cast<const T*>(part_d),
      static_cast<const int*>(part_b), static_cast<T*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

// d2-only mode: with one chunk the scan writes out_d itself (part_d unused).
template <typename T>
int launch_nn_d2(const void* q, int nq, int q_pair, const void* r, int n, const void* mask,
                 int chunk_len, int n_chunks, void* part_d, void* out_d, int n_pairs,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one = n_chunks == 1;
  const dim3 scan_grid(n_chunks, (nq + kNnQ * kThreads - 1) / (kNnQ * kThreads), n_pairs);
  nn1_scan<T, false><<<scan_grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, q_pair, static_cast<const T*>(r), n,
      static_cast<const uint8_t*>(mask), chunk_len, static_cast<T*>(one ? out_d : part_d),
      nullptr, one ? (size_t)q_pair : (size_t)n_chunks * nq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || one) return static_cast<int>(err);
  nn1_min_reduce<T><<<dim3((nq + kThreads - 1) / kThreads, n_pairs), kThreads, 0, s>>>(
      static_cast<const T*>(part_d), nq, q_pair, n_chunks, static_cast<T*>(out_d));
  return static_cast<int>(cudaGetLastError());
}

// k-NN with kS slots a lane: the scan, then (with several chunks) the merge.
template <typename T, int kS>
int launch_knn_slots(const void* q, int nq, const void* r, int n, const void* mask,
                     int k, int chunk_len, int n_chunks, void* part_d, void* part_i,
                     void* out_d, void* out_i, int n_pairs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one = n_chunks == 1;
  const dim3 scan_grid((nq + kKnnBlock - 1) / kKnnBlock, n_chunks, n_pairs);
  knn_scan<T, kS><<<scan_grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, static_cast<const T*>(r), n,
      static_cast<const uint8_t*>(mask), k, chunk_len, n_chunks,
      static_cast<T*>(one ? out_d : part_d), static_cast<int*>(one ? out_i : part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || one) return static_cast<int>(err);
  knn_merge<T, kS><<<dim3((nq + kWarps - 1) / kWarps, n_pairs), kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, static_cast<const T*>(r), n,
      static_cast<const uint8_t*>(mask), k, n_chunks, static_cast<const T*>(part_d),
      static_cast<const int*>(part_i), static_cast<T*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_knn(const void* q, int nq, const void* r, int n, const void* mask, int k,
               int chunk_len, int n_chunks, void* part_d, void* part_i, void* out_d,
               void* out_i, int n_pairs, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  return k <= 32 ? launch_knn_slots<T, 1>(q, nq, r, n, mask, k, chunk_len, n_chunks,
                                          part_d, part_i, out_d, out_i, n_pairs, stream)
                 : launch_knn_slots<T, 2>(q, nq, r, n, mask, k, chunk_len, n_chunks,
                                          part_d, part_i, out_d, out_i, n_pairs, stream);
}

// Blocks of one scan kernel resident on the current device at once.
template <typename F>
int resident_of(F kernel, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  *out = per_sm * sms;
  return static_cast<int>(err);
}

template <typename T>
int resident(int kernel, int* out) {
  switch (kernel) {
    case 0: return resident_of(nn1_scan<T, false>, out);
    case 1: return resident_of(nn1_scan<T, true>, out);
    case 2: return resident_of(match_scan<T>, out);
    case 3: return resident_of(knn_scan<T, 1>, out);
    case 4: return resident_of(knn_scan<T, 2>, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Every entry point takes n_pairs cloud pairs, contiguous one after another:
// queries (n_pairs, q_pair, 3), of which the launch takes nq from the
// pointer on in each pair, refs (n_pairs, n, 3), the mask (n_pairs, n), H
// (n_pairs, 3 or 4, 4) with h_pair = 12 or 16 scalars a pair (the first 12
// read), outputs (n_pairs, q_pair[, k]) from the pointer on. The pair
// strides and counts come last, before the stream.

// Match: part_d (n_pairs, n_chunks, nq) and part_b (n_pairs, n_chunks, nq)
// int32 scratch; H read on the device.
int simpleicp_match_transform_f32(const void* q, int nq, const void* x, int n, const void* h,
                                  int chunk_len, int n_chunks, void* part_d, void* part_b,
                                  void* out_d, void* out_i, int q_pair, int h_pair,
                                  int n_pairs, void* stream) {
  return launch_match<float>(q, nq, q_pair, x, n, h, h_pair, chunk_len, n_chunks, part_d,
                             part_b, out_d, out_i, n_pairs, stream);
}

int simpleicp_match_transform_f64(const void* q, int nq, const void* x, int n, const void* h,
                                  int chunk_len, int n_chunks, void* part_d, void* part_b,
                                  void* out_d, void* out_i, int q_pair, int h_pair,
                                  int n_pairs, void* stream) {
  return launch_match<double>(q, nq, q_pair, x, n, h, h_pair, chunk_len, n_chunks, part_d,
                              part_b, out_d, out_i, n_pairs, stream);
}

// 1-NN, index mode: part_d (n_pairs, n_chunks, nq) and part_b (n_pairs,
// n_chunks, nq) int32 scratch.
int simpleicp_nn_f32(const void* q, int nq, const void* r, int n, const void* mask,
                     int chunk_len, int n_chunks, void* part_d, void* part_b, void* out_d,
                     void* out_i, int q_pair, int n_pairs, void* stream) {
  return launch_nn<float>(q, nq, q_pair, r, n, mask, chunk_len, n_chunks, part_d, part_b,
                          out_d, out_i, n_pairs, stream);
}

int simpleicp_nn_f64(const void* q, int nq, const void* r, int n, const void* mask,
                     int chunk_len, int n_chunks, void* part_d, void* part_b, void* out_d,
                     void* out_i, int q_pair, int n_pairs, void* stream) {
  return launch_nn<double>(q, nq, q_pair, r, n, mask, chunk_len, n_chunks, part_d, part_b,
                           out_d, out_i, n_pairs, stream);
}

// 1-NN, d2-only mode: part_d (n_pairs, n_chunks, nq) scratch, unused with
// one chunk.
int simpleicp_nn_d2_f32(const void* q, int nq, const void* r, int n, const void* mask,
                        int chunk_len, int n_chunks, void* part_d, void* out_d, int q_pair,
                        int n_pairs, void* stream) {
  return launch_nn_d2<float>(q, nq, q_pair, r, n, mask, chunk_len, n_chunks, part_d,
                             out_d, n_pairs, stream);
}

int simpleicp_nn_d2_f64(const void* q, int nq, const void* r, int n, const void* mask,
                        int chunk_len, int n_chunks, void* part_d, void* out_d, int q_pair,
                        int n_pairs, void* stream) {
  return launch_nn_d2<double>(q, nq, q_pair, r, n, mask, chunk_len, n_chunks, part_d,
                              out_d, n_pairs, stream);
}

// k-NN (every query of each pair, q_pair = nq): part_d (n_pairs, nq,
// n_chunks, k) and part_i (n_pairs, nq, n_chunks, k) int32 scratch, unused
// with one chunk.
int simpleicp_knn_f32(const void* q, int nq, const void* r, int n, const void* mask, int k,
                      int chunk_len, int n_chunks, void* part_d, void* part_i, void* out_d,
                      void* out_i, int n_pairs, void* stream) {
  return launch_knn<float>(q, nq, r, n, mask, k, chunk_len, n_chunks, part_d, part_i,
                           out_d, out_i, n_pairs, stream);
}

int simpleicp_knn_f64(const void* q, int nq, const void* r, int n, const void* mask, int k,
                      int chunk_len, int n_chunks, void* part_d, void* part_i, void* out_d,
                      void* out_i, int n_pairs, void* stream) {
  return launch_knn<double>(q, nq, r, n, mask, k, chunk_len, n_chunks, part_d, part_i,
                            out_d, out_i, n_pairs, stream);
}

// Resident blocks on the current device (SMs x blocks per SM) of one scan
// kernel (0: 1-NN d2-only, 1: 1-NN index mode, 2: match, 3: k-NN with
// k <= 32, 4: k-NN with k <= 64) of one dtype (f64 0 or 1), into *out.
int simpleicp_resident(int kernel, int f64, int* out) {
  return f64 ? resident<double>(kernel, out) : resident<float>(kernel, out);
}

}  // extern "C"

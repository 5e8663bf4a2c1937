// Nearest-neighbour kernels of the ICP main path, for Hopper (sm_90a).
//
// match_transform
//   Replaces the TPU kernel _match_transform_kernel
//   (simpleicp_tpu/ops/knn_pallas.py): the 1-NN of each fixed query among
//   the movable cloud moved by the rigid [R | t], with the transform fused
//   in so the moved cloud never reaches device memory.
//   Bound on the H100: operations. 8 flops per (query, ref) pair; at the
//   main-path shape (1000 queries x 100 000 refs) that is 0.8 GFLOP, about
//   12 us at the data sheet's 67 TFLOP/s float32 (24 us at 34 TFLOP/s
//   float64), against 1.2 MB of input, 0.4 us at 3.35 TB/s (both rates at
//   the 700 W power limit).
//   Design: the TPU ran the reference-tile axis in order on one core with a
//   running best in VMEM. Here only ~1000 queries exist, so one thread per
//   query would fill 4 of 132 SMs: the reference axis is split across
//   blocks too (grid = ref chunks x query blocks). A block transforms each
//   ref of its tile once into shared memory (H's 12 scalars are read from
//   device memory, so the ICP loop never reads H back to the host), and
//   each thread scans the tile for its query with a strict '<', which
//   keeps the first minimum in its chunk. A second small pass reduces the
//   per-chunk partials in ascending chunk order with a strict '<', so ties
//   go to the lower index exactly as a first-minimum argmin does.
//
// knn
//   Replaces the TPU kernel _knn_kernel (simpleicp_tpu/ops/knn_pallas.py):
//   the k nearest refs of each query, ascending, with an optional ref mask.
//   Bound: operations, as above (the same 8 flops per pair).
//   Design: the same split of the reference axis. Each thread keeps its
//   query's sorted top-k of (d2, index) pairs in a per-thread array and
//   inserts a candidate only when it beats the current k-th pair, which it
//   holds in registers. Pairs compare lexicographically, so exact ties go
//   to the lower index as in a stable sort; masked refs take part with
//   d2 = +inf, so the slots past the valid refs hold +inf and the lowest
//   masked indices, as the plain version's stable sort gives. A second pass
//   merges the k x n_chunks candidates of each query; every chunk's list is
//   sorted, so a chunk is left at its first candidate that does not enter.
//
// nn_search (nn1_scan, nn1_min_reduce, nn1_arg_finish)
//   Replaces the TPU kernel _nn_kernel (simpleicp_tpu/ops/knn_pallas.py):
//   the masked 1-NN, first minimum, of the overlap gate. Every fixed point
//   is a query (1e5 to 1e6 of them; the dilate gate's band, 7e4 at 1.2M)
//   against the movable cloud. Two entry points share one scan: the d2-only
//   mode (simpleicp_nn_d2_*), which the gates and the metrics call, and the
//   index mode (simpleicp_nn_*), which also returns the first minimum's
//   index.
//   Bound: 8 flops per pair is 119 ms at 1e6 x 1e6 over the data sheet's
//   67 TFLOP/s float32, but that rate counts fused multiply-adds, which the
//   exact unfused distance may not use. What bounds this kernel on the H100
//   is instruction issue: 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz =
//   3.35e13 lane slots per second, and each pair needs 8 of them (three
//   subtractions, three multiplications, two additions) plus one for the
//   running minimum: 9 issues, 269 ms at 1e6 x 1e6 (float64: 9 operations
//   at 64 lanes per SM, 5.4 ms at 1e5 x 1e5).
//   Design: everything else leaves the inner loop.
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
//     kNnSub pairs): the TPU kernel's per-tile minimum with its argmin
//     deferred. The second pass picks the first chunk with the least d2
//     (ascending chunks, strict '<') and rescans that chunk's sub-tile in
//     device memory for the first ref at exactly that distance, with the
//     same intrinsics. One rescan of kNnSub refs per query, whatever the
//     order of the data.
//   - The next tile is loaded into registers while the current one is
//     scanned, then stored to the other of two shared buffers: one barrier
//     per tile. A masked ref, and the ragged end of the last tile, enter as
//     +inf coordinates when the tile lands, so their d2 is +inf or NaN;
//     fmin ignores NaN and +inf never lowers a best that starts at +inf, so
//     neither ever wins: a query with no valid ref keeps d2 = +inf and index
//     0, as the plain version's argmin over an all-inf row gives. (The
//     plain argmin takes a NaN for the minimum; here a NaN distance never
//     wins, as the strict '<' of the first kernel gave.)
//   - A block covers kNnQ x 256 queries and one chunk of the reference
//     axis; the wrapper picks the number of chunks that fills the card's
//     resident blocks in whole waves. The d2-only mode reduces the chunks
//     with fmin (and skips that pass with one chunk).
//   The mask is read as bytes (a torch.bool tensor).
//
// All: every multiply, add and subtract of the transform and the distance
// is an explicit round-to-nearest intrinsic (__fmul_rn / __fadd_rn /
// __fsub_rn, __dmul_rn / __dadd_rn / __dsub_rn), which nvcc never contracts
// into an FMA. The kernels thus round exactly as the plain PyTorch version's
// separate elementwise operations do, and agree with it bit for bit. No
// padding: the ragged edge of each tile is bounds-checked. Indices are
// int32. The kernels allocate nothing; outputs and partials come from the
// caller, and both passes run on the caller's stream.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // queries per block
constexpr int kTile = 1024;    // refs per shared-memory tile
constexpr int kMaxK = 64;      // largest k of the k-NN kernel
constexpr int kNoIndex = 0x7fffffff;
constexpr int kNnQ = 4;        // 1-NN: queries per thread
constexpr int kNnTile = 512;   // 1-NN: refs per shared-memory tile (two buffers)
constexpr int kNnSub = 32;     // 1-NN: refs per sub-tile of the index mode
constexpr int kNnStage = kNnTile / kThreads;  // refs each thread stages per tile

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  // The minimum of two squared distances (each +0, positive, +inf or NaN;
  // never negative) as the lesser bit pattern read as an unsigned integer:
  // the order of non-negative doubles, with a NaN of either sign above +inf,
  // so fmin's result (a NaN never wins) in four integer instructions, off
  // the FP64 pipe that the distance saturates (fmin costs a DSETP there).
  static __device__ __forceinline__ double min(double a, double b) {
    return static_cast<unsigned long long>(__double_as_longlong(b)) <
                   static_cast<unsigned long long>(__double_as_longlong(a))
               ? b
               : a;
  }
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
};

// One staged ref of the 1-NN: x, y, z and a pad, 16-byte aligned.
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
__device__ __forceinline__ T affine(T h0, T h1, T h2, T h3, T x, T y, T z) {
  using A = Rn<T>;
  return A::add(A::add(A::add(A::mul(h0, x), A::mul(h1, y)), A::mul(h2, z)), h3);
}

template <typename T>
__device__ __forceinline__ bool pair_less(T da, int ia, T db, int ib) {
  return da < db || (da == db && ia < ib);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
match_transform_scan(const T* __restrict__ q, int nq, const T* __restrict__ x,
                     int n, const T* __restrict__ h, int chunk_len,
                     T* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ T sx[kTile];
  __shared__ T sy[kTile];
  __shared__ T sz[kTile];
  const T h00 = h[0], h01 = h[1], h02 = h[2], h03 = h[3];
  const T h10 = h[4], h11 = h[5], h12 = h[6], h13 = h[7];
  const T h20 = h[8], h21 = h[9], h22 = h[10], h23 = h[11];

  const int qi = blockIdx.y * kThreads + threadIdx.x;
  T qx = 0, qy = 0, qz = 0;
  if (qi < nq) {
    qx = q[3 * (size_t)qi];
    qy = q[3 * (size_t)qi + 1];
    qz = q[3 * (size_t)qi + 2];
  }
  T best = Rn<T>::inf();
  int best_i = 0;
  const int lo = blockIdx.x * chunk_len;
  const int hi = min(n, lo + chunk_len);
  for (int base = lo; base < hi; base += kTile) {
    const int cnt = min(kTile, hi - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const T* p = x + 3 * (size_t)(base + j);
      const T px = p[0], py = p[1], pz = p[2];
      sx[j] = affine(h00, h01, h02, h03, px, py, pz);
      sy[j] = affine(h10, h11, h12, h13, px, py, pz);
      sz[j] = affine(h20, h21, h22, h23, px, py, pz);
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const T d = dist2(qx, qy, qz, sx[j], sy[j], sz[j]);
      if (d < best) {
        best = d;
        best_i = base + j;
      }
    }
  }
  if (qi < nq) {
    part_d[(size_t)blockIdx.x * nq + qi] = best;
    part_i[(size_t)blockIdx.x * nq + qi] = best_i;
  }
}

// The first minimum over the per-chunk partials of one query, in ascending
// chunk order with a strict '<'.
template <typename T>
__device__ __forceinline__ void reduce_chunks(const T* __restrict__ part_d,
                                              const int* __restrict__ part_i,
                                              int nq, int n_chunks,
                                              T* __restrict__ out_d,
                                              int* __restrict__ out_i) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  if (qi >= nq) return;
  T best = Rn<T>::inf();
  int best_i = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const T d = part_d[(size_t)c * nq + qi];
    if (d < best) {
      best = d;
      best_i = part_i[(size_t)c * nq + qi];
    }
  }
  out_d[qi] = best;
  out_i[qi] = best_i;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nn_reduce(const T* __restrict__ part_d, const int* __restrict__ part_i,
          int nq, int n_chunks, T* __restrict__ out_d, int* __restrict__ out_i) {
  reduce_chunks(part_d, part_i, nq, n_chunks, out_d, out_i);
}

// Loads this thread's kNnStage refs of the tile at `base` into registers;
// a masked ref, or one at or past `hi`, becomes +inf coordinates.
template <typename T>
__device__ __forceinline__ void nn1_fetch(const T* __restrict__ r,
                                          const uint8_t* __restrict__ mask,
                                          int base, int hi, T (&sx)[kNnStage],
                                          T (&sy)[kNnStage], T (&sz)[kNnStage]) {
#pragma unroll
  for (int m = 0; m < kNnStage; ++m) {
    const int j = base + threadIdx.x + m * kThreads;
    if (j < hi && (mask == nullptr || mask[j])) {
      const T* p = r + 3 * (size_t)j;
      sx[m] = p[0];
      sy[m] = p[1];
      sz[m] = p[2];
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
// queries. d2-only (kIndex false): part_d[chunk][q] is the least d2. Index
// mode: part_d as well, and part_b[chunk][q] the first ref of the first
// sub-tile that holds it (meaningful when part_d is finite).
template <typename T, bool kIndex>
__global__ void __launch_bounds__(kThreads)
nn1_scan(const T* __restrict__ q, int nq, const T* __restrict__ r, int n,
         const uint8_t* __restrict__ mask, int chunk_len,
         T* __restrict__ part_d, int* __restrict__ part_b) {
  using A = Rn<T>;
  __shared__ Ref4<T> tiles[2][kNnTile];

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
  nn1_fetch(r, mask, lo, hi, sx, sy, sz);
  nn1_store(tiles[0], sx, sy, sz);
  __syncthreads();
  int buf = 0;
  for (int base = lo; base < hi; base += kNnTile) {
    const bool more = base + kNnTile < hi;  // the same in every thread
    if (more) nn1_fetch(r, mask, base + kNnTile, hi, sx, sy, sz);
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
      part_d[(size_t)blockIdx.x * nq + qi] = best[k];
      if (kIndex) part_b[(size_t)blockIdx.x * nq + qi] = first[k];
    }
  }
}

// d2-only: the least of the per-chunk minima (fmin; none is NaN).
template <typename T>
__global__ void __launch_bounds__(kThreads)
nn1_min_reduce(const T* __restrict__ part_d, int nq, int n_chunks,
               T* __restrict__ out_d) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  if (qi >= nq) return;
  T best = part_d[qi];
  for (int c = 1; c < n_chunks; ++c) best = Rn<T>::min(best, part_d[(size_t)c * nq + qi]);
  out_d[qi] = best;
}

// Index mode: the first chunk with the least d2 (ascending, strict '<'),
// then the first ref of its recorded sub-tile at exactly that distance. A
// masked ref had +inf coordinates in the scan, so it is skipped here; with
// no finite d2 the index is 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
nn1_arg_finish(const T* __restrict__ q, int nq, const T* __restrict__ r, int n,
               const uint8_t* __restrict__ mask, int n_chunks,
               const T* __restrict__ part_d, const int* __restrict__ part_b,
               T* __restrict__ out_d, int* __restrict__ out_i) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  if (qi >= nq) return;
  T best = Rn<T>::inf();
  int b = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const T d = part_d[(size_t)c * nq + qi];
    if (d < best) {
      best = d;
      b = part_b[(size_t)c * nq + qi];
    }
  }
  int idx = 0;
  if (best < Rn<T>::inf()) {
    const T qx = q[3 * (size_t)qi], qy = q[3 * (size_t)qi + 1], qz = q[3 * (size_t)qi + 2];
    const int end = min(n, b + kNnSub);
    for (int j = b; j < end; ++j) {
      if (mask != nullptr && !mask[j]) continue;
      const T* p = r + 3 * (size_t)j;
      if (dist2(qx, qy, qz, p[0], p[1], p[2]) == best) {
        idx = j;
        break;
      }
    }
  }
  out_d[qi] = best;
  out_i[qi] = idx;
}

// Inserts (d, i) into the ascending list (ld, li) of length k if it beats
// the k-th pair (wd, wi), which is kept in registers.
template <typename T>
__device__ __forceinline__ void topk_insert(T d, int i, int k, T* ld, int* li,
                                            T& wd, int& wi) {
  if (!pair_less(d, i, wd, wi)) return;
  int pos = k - 1;
  while (pos > 0 && pair_less(d, i, ld[pos - 1], li[pos - 1])) {
    ld[pos] = ld[pos - 1];
    li[pos] = li[pos - 1];
    --pos;
  }
  ld[pos] = d;
  li[pos] = i;
  wd = ld[k - 1];
  wi = li[k - 1];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
knn_scan(const T* __restrict__ q, int nq, const T* __restrict__ r, int n,
         const uint8_t* __restrict__ mask, int k, int chunk_len,
         T* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ T sx[kTile];
  __shared__ T sy[kTile];
  __shared__ T sz[kTile];
  __shared__ uint8_t sv[kTile];

  const int qi = blockIdx.y * kThreads + threadIdx.x;
  T qx = 0, qy = 0, qz = 0;
  if (qi < nq) {
    qx = q[3 * (size_t)qi];
    qy = q[3 * (size_t)qi + 1];
    qz = q[3 * (size_t)qi + 2];
  }
  T ld[kMaxK];
  int li[kMaxK];
  for (int j = 0; j < k; ++j) {
    ld[j] = Rn<T>::inf();
    li[j] = kNoIndex;
  }
  T wd = Rn<T>::inf();
  int wi = kNoIndex;

  const int lo = blockIdx.x * chunk_len;
  const int hi = min(n, lo + chunk_len);
  for (int base = lo; base < hi; base += kTile) {
    const int cnt = min(kTile, hi - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const T* p = r + 3 * (size_t)(base + j);
      sx[j] = p[0];
      sy[j] = p[1];
      sz[j] = p[2];
      sv[j] = mask == nullptr ? 1 : mask[base + j];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const T d = sv[j] ? dist2(qx, qy, qz, sx[j], sy[j], sz[j]) : Rn<T>::inf();
      topk_insert(d, base + j, k, ld, li, wd, wi);
    }
  }
  if (qi < nq) {
    for (int j = 0; j < k; ++j) {
      const size_t at = ((size_t)blockIdx.x * k + j) * nq + qi;
      part_d[at] = ld[j];
      part_i[at] = li[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
knn_merge(const T* __restrict__ part_d, const int* __restrict__ part_i,
          int nq, int k, int n_chunks, T* __restrict__ out_d,
          int* __restrict__ out_i) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  if (qi >= nq) return;
  T ld[kMaxK];
  int li[kMaxK];
  for (int j = 0; j < k; ++j) {
    ld[j] = Rn<T>::inf();
    li[j] = kNoIndex;
  }
  T wd = Rn<T>::inf();
  int wi = kNoIndex;
  for (int c = 0; c < n_chunks; ++c) {
    for (int j = 0; j < k; ++j) {
      const size_t at = ((size_t)c * k + j) * nq + qi;
      const T d = part_d[at];
      const int i = part_i[at];
      if (!pair_less(d, i, wd, wi)) break;  // the rest of this chunk is larger
      topk_insert(d, i, k, ld, li, wd, wi);
    }
  }
  for (int j = 0; j < k; ++j) {
    out_d[(size_t)qi * k + j] = ld[j];
    out_i[(size_t)qi * k + j] = li[j];
  }
}

template <typename T>
int launch_match_transform(const void* q, int nq, const void* x, int n,
                           const void* h, int chunk_len, int n_chunks,
                           void* part_d, void* part_i, void* out_d, void* out_i,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 scan_grid(n_chunks, (nq + kThreads - 1) / kThreads);
  match_transform_scan<T><<<scan_grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, static_cast<const T*>(x), n,
      static_cast<const T*>(h), chunk_len, static_cast<T*>(part_d),
      static_cast<int*>(part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_reduce<T><<<(nq + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const T*>(part_d), static_cast<const int*>(part_i), nq,
      n_chunks, static_cast<T*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

// Index mode: the scan into (n_chunks, nq) partials, then the finish pass.
template <typename T>
int launch_nn(const void* q, int nq, const void* r, int n, const void* mask,
              int chunk_len, int n_chunks, void* part_d, void* part_b,
              void* out_d, void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 scan_grid(n_chunks, (nq + kNnQ * kThreads - 1) / (kNnQ * kThreads));
  nn1_scan<T, true><<<scan_grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, static_cast<const T*>(r), n,
      static_cast<const uint8_t*>(mask), chunk_len, static_cast<T*>(part_d),
      static_cast<int*>(part_b));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn1_arg_finish<T><<<(nq + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, static_cast<const T*>(r), n,
      static_cast<const uint8_t*>(mask), n_chunks, static_cast<const T*>(part_d),
      static_cast<const int*>(part_b), static_cast<T*>(out_d),
      static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

// d2-only mode: with one chunk the scan writes out_d itself (part_d unused).
template <typename T>
int launch_nn_d2(const void* q, int nq, const void* r, int n, const void* mask,
                 int chunk_len, int n_chunks, void* part_d, void* out_d,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 scan_grid(n_chunks, (nq + kNnQ * kThreads - 1) / (kNnQ * kThreads));
  nn1_scan<T, false><<<scan_grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, static_cast<const T*>(r), n,
      static_cast<const uint8_t*>(mask), chunk_len,
      static_cast<T*>(n_chunks == 1 ? out_d : part_d), nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  nn1_min_reduce<T><<<(nq + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const T*>(part_d), nq, n_chunks, static_cast<T*>(out_d));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the 1-NN scan resident on the current device at once.
template <typename T, bool kIndex>
int nn_resident(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn1_scan<T, kIndex>,
                                                        kThreads, 0);
  *out = per_sm * sms;
  return static_cast<int>(err);
}

template <typename T>
int launch_knn(const void* q, int nq, const void* r, int n, const void* mask,
               int k, int chunk_len, int n_chunks, void* part_d, void* part_i,
               void* out_d, void* out_i, void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 scan_grid(n_chunks, (nq + kThreads - 1) / kThreads);
  knn_scan<T><<<scan_grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, static_cast<const T*>(r), n,
      static_cast<const uint8_t*>(mask), k, chunk_len, static_cast<T*>(part_d),
      static_cast<int*>(part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  knn_merge<T><<<(nq + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const T*>(part_d), static_cast<const int*>(part_i), nq, k,
      n_chunks, static_cast<T*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int simpleicp_match_transform_f32(const void* q, int nq, const void* x, int n,
                                  const void* h, int chunk_len, int n_chunks,
                                  void* part_d, void* part_i, void* out_d,
                                  void* out_i, void* stream) {
  return launch_match_transform<float>(q, nq, x, n, h, chunk_len, n_chunks,
                                       part_d, part_i, out_d, out_i, stream);
}

int simpleicp_match_transform_f64(const void* q, int nq, const void* x, int n,
                                  const void* h, int chunk_len, int n_chunks,
                                  void* part_d, void* part_i, void* out_d,
                                  void* out_i, void* stream) {
  return launch_match_transform<double>(q, nq, x, n, h, chunk_len, n_chunks,
                                        part_d, part_i, out_d, out_i, stream);
}

// 1-NN, index mode: part_d (n_chunks, nq) and part_b (n_chunks, nq) int32
// scratch.
int simpleicp_nn_f32(const void* q, int nq, const void* r, int n,
                     const void* mask, int chunk_len, int n_chunks,
                     void* part_d, void* part_b, void* out_d, void* out_i,
                     void* stream) {
  return launch_nn<float>(q, nq, r, n, mask, chunk_len, n_chunks, part_d,
                          part_b, out_d, out_i, stream);
}

int simpleicp_nn_f64(const void* q, int nq, const void* r, int n,
                     const void* mask, int chunk_len, int n_chunks,
                     void* part_d, void* part_b, void* out_d, void* out_i,
                     void* stream) {
  return launch_nn<double>(q, nq, r, n, mask, chunk_len, n_chunks, part_d,
                           part_b, out_d, out_i, stream);
}

// 1-NN, d2-only mode: part_d (n_chunks, nq) scratch, unused with one chunk.
int simpleicp_nn_d2_f32(const void* q, int nq, const void* r, int n,
                        const void* mask, int chunk_len, int n_chunks,
                        void* part_d, void* out_d, void* stream) {
  return launch_nn_d2<float>(q, nq, r, n, mask, chunk_len, n_chunks, part_d,
                             out_d, stream);
}

int simpleicp_nn_d2_f64(const void* q, int nq, const void* r, int n,
                        const void* mask, int chunk_len, int n_chunks,
                        void* part_d, void* out_d, void* stream) {
  return launch_nn_d2<double>(q, nq, r, n, mask, chunk_len, n_chunks, part_d,
                              out_d, stream);
}

// Resident 1-NN scan blocks on the current device (SMs x blocks per SM) of
// one dtype (f64 0 or 1) and mode (index 0 or 1), into *out.
int simpleicp_nn_resident(int f64, int index, int* out) {
  if (f64) return index ? nn_resident<double, true>(out) : nn_resident<double, false>(out);
  return index ? nn_resident<float, true>(out) : nn_resident<float, false>(out);
}

int simpleicp_knn_f32(const void* q, int nq, const void* r, int n,
                      const void* mask, int k, int chunk_len, int n_chunks,
                      void* part_d, void* part_i, void* out_d, void* out_i,
                      void* stream) {
  return launch_knn<float>(q, nq, r, n, mask, k, chunk_len, n_chunks, part_d,
                           part_i, out_d, out_i, stream);
}

int simpleicp_knn_f64(const void* q, int nq, const void* r, int n,
                      const void* mask, int k, int chunk_len, int n_chunks,
                      void* part_d, void* part_i, void* out_d, void* out_i,
                      void* stream) {
  return launch_knn<double>(q, nq, r, n, mask, k, chunk_len, n_chunks, part_d,
                            part_i, out_d, out_i, stream);
}

}  // extern "C"

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
// nn_search
//   Replaces the TPU kernel _nn_kernel (simpleicp_tpu/ops/knn_pallas.py):
//   the masked 1-NN of the brute overlap gate, first minimum. Every fixed
//   point is a query (1e5 to 1e6 of them) against the movable cloud.
//   Bound: operations, 8 flops per pair; at 100 000 x 100 000 that is
//   8e10 flops, about 1.19 ms at 67 TFLOP/s float32 (2.35 ms at 34 TFLOP/s
//   float64), against 2.4 MB of input; at 1e6 x 1e6 about 119 ms.
//   Design: the scan of match_transform without the transform and with the
//   mask. One thread per query and the block's reference tile in shared
//   memory: at 1e6 queries that alone is 3 907 blocks, several waves on the
//   132 SMs; at 1e5 (391 blocks) the reference axis is split into chunks as
//   for the other kernels, and the same second pass reduces them in
//   ascending order with a strict '<'. A masked ref enters the tile with
//   +inf coordinates, so its d2 is +inf (or NaN) and never passes the strict
//   '<' against a best that starts at +inf: a query with no valid ref keeps
//   d2 = +inf and index 0, as the plain version's argmin over an all-inf row
//   gives. The mask is read as bytes (a torch.bool tensor).
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

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
nn_search_scan(const T* __restrict__ q, int nq, const T* __restrict__ r, int n,
               const uint8_t* __restrict__ mask, int chunk_len,
               T* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ T sx[kTile];
  __shared__ T sy[kTile];
  __shared__ T sz[kTile];

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
      if (mask == nullptr || mask[base + j]) {
        const T* p = r + 3 * (size_t)(base + j);
        sx[j] = p[0];
        sy[j] = p[1];
        sz[j] = p[2];
      } else {
        sx[j] = Rn<T>::inf();
        sy[j] = Rn<T>::inf();
        sz[j] = Rn<T>::inf();
      }
    }
    __syncthreads();
#pragma unroll 8
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
nn_search_reduce(const T* __restrict__ part_d, const int* __restrict__ part_i,
                 int nq, int n_chunks, T* __restrict__ out_d,
                 int* __restrict__ out_i) {
  reduce_chunks(part_d, part_i, nq, n_chunks, out_d, out_i);
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

template <typename T>
int launch_nn(const void* q, int nq, const void* r, int n, const void* mask,
              int chunk_len, int n_chunks, void* part_d, void* part_i,
              void* out_d, void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 scan_grid(n_chunks, (nq + kThreads - 1) / kThreads);
  nn_search_scan<T><<<scan_grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), nq, static_cast<const T*>(r), n,
      static_cast<const uint8_t*>(mask), chunk_len, static_cast<T*>(part_d),
      static_cast<int*>(part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_search_reduce<T><<<(nq + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const T*>(part_d), static_cast<const int*>(part_i), nq,
      n_chunks, static_cast<T*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
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

int simpleicp_nn_f32(const void* q, int nq, const void* r, int n,
                     const void* mask, int chunk_len, int n_chunks,
                     void* part_d, void* part_i, void* out_d, void* out_i,
                     void* stream) {
  return launch_nn<float>(q, nq, r, n, mask, chunk_len, n_chunks, part_d,
                          part_i, out_d, out_i, stream);
}

int simpleicp_nn_f64(const void* q, int nq, const void* r, int n,
                     const void* mask, int chunk_len, int n_chunks,
                     void* part_d, void* part_i, void* out_d, void* out_i,
                     void* stream) {
  return launch_nn<double>(q, nq, r, n, mask, chunk_len, n_chunks, part_d,
                           part_i, out_d, out_i, stream);
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

// Packed-occupancy stencil dilation of the dilate overlap gate, for Hopper
// (sm_90a).
//
// dilate
//   Replaces the TPU kernel of simpleicp_tpu/ops/dilate_pallas.py (the inner
//   `kernel` of _build_call, entry dilate_packed_multi_pallas), which
//   computes the semantics of dilate_gate._dilate_packed_multi: for each of
//   one or two stencils of (dx, dy, z) entries, out[w, x, y] is the OR over
//   the entries of oz_z[w, x - dx, y - dy], where oz_z is the occupancy
//   shifted by every -z..z cells along z. The grid is (wz, nx, ny) 32-bit
//   words, 32 z-cells per word, so a z-shift by k < 32 cells is an in-word
//   shift plus the carry bits of the neighbouring word. Everything outside
//   the grid is empty.
//   Bound on the H100: operations. One 32-bit OR per output word per
//   stencil entry: at the 1.2M-point plan (48.5M words, 673 + 933 entries)
//   7.8e10 ORs against 0.58 GB of grid traffic (one read, two writes).
//   Design: the TPU read the grid once per (x, y) block into VMEM and rolled
//   the whole block per entry. Here a block owns one word plane w and a
//   32 x 32 (x, y) output tile; it stages the tile with a halo of
//   P = max |dx|, |dy| of the stencils (taken from the tables) for planes
//   w-1, w and w+1 in shared memory (the neighbour planes supply the
//   z-carries), and grows oz level by level in a fourth shared array. At
//   each level every thread ORs the level's (dx, dy) windows of oz into four
//   register accumulators per stencil (four x rows of one y column); a warp
//   reads 32 consecutive words per window, so shared loads are free of bank
//   conflicts. The entries come as (dx, dy) pairs sorted by z with per-level
//   start offsets, built once per plan by the wrapper; all threads of a
//   block read the same entry (a broadcast). None of the Pallas kernel's
//   (8, 128) alignment, rolls or negative-shift normalisation is needed.
//   At P = 17 (cell_div 16) the four arrays take 66 x 66 x 16 = 69.7 KB of
//   dynamic shared memory, above the 48 KB default, so the entry point
//   raises the kernel's limit first.
//
// Integer operations only: the result is bit-equal to the plain PyTorch
// version. The kernel allocates nothing and runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;                      // output rows (x) per block
constexpr int kTileY = 32;                      // output columns (y): one per lane
constexpr int kRows = 8;                        // warps per block (blockDim.y)
constexpr int kOutPerThread = kTileX / kRows;   // x rows each thread owns
constexpr int kThreads = kTileY * kRows;

// acc[j] |= oz[row + j*kRows - dx, col - dy] for the entries [e0, e1); `oz`
// points at the thread's own (row, col) in the halo'd tile.
__device__ __forceinline__ void or_windows(const uint32_t* oz, int tw,
                                           const int2* __restrict__ pairs,
                                           int e0, int e1,
                                           uint32_t (&acc)[kOutPerThread]) {
  for (int e = e0; e < e1; ++e) {
    const int2 d = pairs[e];
    const uint32_t* src = oz - d.x * tw - d.y;
#pragma unroll
    for (int j = 0; j < kOutPerThread; ++j) acc[j] |= src[j * kRows * tw];
  }
}

__global__ void __launch_bounds__(kThreads)
dilate_kernel(const uint32_t* __restrict__ occ, int wz, int nx, int ny,
              const int2* __restrict__ pairs, const int* __restrict__ starts,
              int n_st, int z_max, int P, uint32_t* __restrict__ out0,
              uint32_t* __restrict__ out1) {
  extern __shared__ uint32_t smem[];
  const int th = kTileX + 2 * P;
  const int tw = kTileY + 2 * P;
  const int tile = th * tw;
  uint32_t* s_prev = smem;
  uint32_t* s_cur = smem + tile;
  uint32_t* s_next = smem + 2 * tile;
  uint32_t* s_oz = smem + 3 * tile;

  const int w = blockIdx.z;
  const int x0 = blockIdx.y * kTileX;
  const int y0 = blockIdx.x * kTileY;
  const int tid = threadIdx.y * kTileY + threadIdx.x;
  const size_t plane = static_cast<size_t>(nx) * ny;

  for (int p = tid; p < tile; p += kThreads) {
    const int hx = p / tw;
    const int gx = x0 - P + hx;
    const int gy = y0 - P + (p - hx * tw);
    uint32_t a = 0, b = 0, c = 0;
    if (gx >= 0 && gx < nx && gy >= 0 && gy < ny) {
      const size_t o = static_cast<size_t>(gx) * ny + gy;
      b = occ[w * plane + o];
      if (w > 0) a = occ[(w - 1) * plane + o];
      if (w + 1 < wz) c = occ[(w + 1) * plane + o];
    }
    s_prev[p] = a;
    s_cur[p] = b;
    s_next[p] = c;
    s_oz[p] = b;
  }

  uint32_t acc0[kOutPerThread] = {};
  uint32_t acc1[kOutPerThread] = {};
  const uint32_t* my_oz = s_oz + (threadIdx.y + P) * tw + threadIdx.x + P;
  const int* st0 = starts;
  const int* st1 = starts + (z_max + 2);
  for (int z = 0; z <= z_max; ++z) {
    if (z > 0) {
      for (int p = tid; p < tile; p += kThreads) {
        const uint32_t c = s_cur[p];
        s_oz[p] |= (c << z) | (s_prev[p] >> (32 - z)) | (c >> z) |
                   (s_next[p] << (32 - z));
      }
    }
    __syncthreads();
    or_windows(my_oz, tw, pairs, st0[z], st0[z + 1], acc0);
    if (n_st > 1) or_windows(my_oz, tw, pairs, st1[z], st1[z + 1], acc1);
    __syncthreads();
  }

  const int y = y0 + threadIdx.x;
  if (y >= ny) return;
#pragma unroll
  for (int j = 0; j < kOutPerThread; ++j) {
    const int x = x0 + threadIdx.y + j * kRows;
    if (x >= nx) continue;
    const size_t o = w * plane + static_cast<size_t>(x) * ny + y;
    out0[o] = acc0[j];
    if (n_st > 1) out1[o] = acc1[j];
  }
}

}  // namespace

extern "C" {

// occ: (wz, nx, ny) words; pairs: (dx, dy) int32 pairs of every stencil,
// each stencil's sorted by z; starts: n_st rows of z_max + 2 offsets into
// pairs (level z of stencil s is [starts[s][z], starts[s][z + 1])); P: the
// largest |dx|, |dy|; out1 is read only when n_st == 2.
int simpleicp_dilate(const void* occ, int wz, int nx, int ny,
                     const void* pairs, const void* starts, int n_st,
                     int z_max, int P, void* out0, void* out1, void* stream) {
  if (n_st < 1 || n_st > 2 || z_max < 0 || z_max > 31 || P < 0 || wz < 1 ||
      nx < 1 || ny < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * sizeof(uint32_t) * static_cast<size_t>(kTileX + 2 * P) *
                      (kTileY + 2 * P);
  cudaError_t err = cudaFuncSetAttribute(
      dilate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ny + kTileY - 1) / kTileY, (nx + kTileX - 1) / kTileX, wz);
  const dim3 block(kTileY, kRows);
  dilate_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(occ), wz, nx, ny,
      static_cast<const int2*>(pairs), static_cast<const int*>(starts), n_st,
      z_max, P, static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

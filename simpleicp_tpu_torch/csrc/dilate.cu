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
//   shift plus the carry bits of the neighbouring word (one funnel shift).
//   Everything outside the grid is empty.
//   Bound on the H100: operations. An output word of a stencil of n entries
//   ORs n words, ceil((n - 1) / 2) three-input ORs (LOP3); at the 1.2M-point
//   plan (48.5M words, 673 + 933 entries) 3.9e10 of them at the INT32 rate,
//   2.3 ms, against 0.58 GB of grid traffic (one read, two writes).
//   What bounds a design with the grid in shared memory is the shared
//   loads: one 4-byte load per entry per output word would be 7.8e10 of
//   them at 32 words per clock per SM, 9.3 ms.
//   Design:
//   - A block owns one word plane w and a kTileX x 32 (x, y) output tile
//     (128 x 32: 16 warps of 8 rows), and stages it with the stencils' halo
//     (P: the largest |dx|, |dy|) for planes w-1, w and w+1 in shared
//     memory (the neighbour planes supply the z-carries). The layout is
//     y-major with an odd row stride TH, so a warp's 32 lanes, one y column
//     each, read 32 distinct banks.
//   - Each thread owns kRows consecutive x rows of one column and ORs into
//     kRows register accumulators per stencil. The entries of one z level
//     come from the wrapper as runs of consecutive dx at one dy (at most
//     kLMax long): a run of L entries needs kRows + L - 1 consecutive words
//     of the thread's column, loaded once into registers (two runs at a
//     time, the next pair's offsets read ahead) and OR'd three words at a
//     time. At the 1.2M plan that is 0.65 loads per OR, 0.73 with the
//     runs' offsets (runs are short: each level of the stencil is a ring).
//   - The tables (per level: z, the halo the level and every later one
//     still reads, the run groups; then one word offset per run) are built
//     once per plan by the wrapper and staged into shared memory once per
//     block: no entry's offset sits on a global load in the loop.
//   - oz grows level by level into two alternating buffers, over the
//     shrinking halo that later levels read, with one barrier per level.
//   At P = 17 (cell_div 16) the five arrays of the 128 x 32 tile take
//   163 x 66 x 20 bytes = 215 KB of dynamic shared memory (one block of
//   16 warps per SM), above the 48 KB default, so the entry point raises
//   the kernel's limit first. The tile takes stencils of reach up to 18
//   (every plan of the gate: at most 17) within the 227 KB a block may use.
//   Why 16 warps of 8 rows, and x-runs only (measured on the H100 with
//   chip_smoke.py, PERF.md): 32 warps of 4 rows were no faster, 8 warps of
//   8 rows 45 % slower, and taking the steep arcs as runs of consecutive
//   dy on a second thread mapping cut loads by 16 % but ran 7 % slower
//   (64 registers, twice the run groups). The window ORs run at about
//   80 % of this design's shared-load floor; staging, the oz growth and
//   the per-level barriers take about 4 ms of a 1.2M-plan call whatever
//   the entry count (a flat, unrolled staging loop took 3-5 % off it).
//
// Integer operations only: the result is bit-equal to the plain PyTorch
// version. The kernel allocates nothing and runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;   // output columns (y) per block: one per lane
constexpr int kWarps = 16;   // warps per block
constexpr int kRows = 8;     // consecutive output rows (x) per thread
constexpr int kThreads = kWarps * 32;
constexpr int kTileX = kWarps * kRows;  // output rows per block
constexpr int kLMax = 8;     // longest run of consecutive dx one step ORs
// Ints per level record of the table: z, the reach p of this level and
// every later one, then for each of two stencils kLMax + 1 run offsets
// (runs of length L are [s[L-1], s[L])).
constexpr int kLevelInts = 2 + 2 * (kLMax + 1);

// acc[i] |= p[i] | ... | p[i + L - 1] for i < R: one run of L entries.
template <int L, int R>
__device__ __forceinline__ void or_run(const uint32_t* p, uint32_t (&acc)[R]) {
  uint32_t w[R + L - 1];
#pragma unroll
  for (int m = 0; m < R + L - 1; ++m) w[m] = p[m];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    uint32_t v = w[i];
#pragma unroll
    for (int k = 1; k < L; ++k) v |= w[i + k];
    acc[i] |= v;
  }
}

// acc[i] |= the words of two runs of L entries: 2 (R + L - 1) independent
// loads, and LOP3s that OR three words each.
template <int L, int R>
__device__ __forceinline__ void or_run_pair(const uint32_t* p, const uint32_t* q,
                                            uint32_t (&acc)[R]) {
  uint32_t a[R + L - 1], b[R + L - 1];
#pragma unroll
  for (int m = 0; m < R + L - 1; ++m) {
    a[m] = p[m];
    b[m] = q[m];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    uint32_t v = a[i] | b[i];
#pragma unroll
    for (int k = 1; k < L; ++k) v |= a[i + k] | b[i + k];
    acc[i] |= v;
  }
}

// The runs of length L, two at a time, with the next pair's offsets read
// before this pair's words, so that no offset load waits in the chain.
template <int L, int R>
__device__ __forceinline__ void or_group(const uint32_t* oz, const int* runs,
                                         const int* st, uint32_t (&acc)[R]) {
  int r = st[L - 1];
  const int r1 = st[L];
  if (r + 1 < r1) {
    int o0 = runs[r], o1 = runs[r + 1];
    for (;;) {
      r += 2;
      const bool more = r + 1 < r1;
      int n0 = 0, n1 = 0;
      if (more) {
        n0 = runs[r];
        n1 = runs[r + 1];
      }
      or_run_pair<L>(oz + o0, oz + o1, acc);
      if (!more) break;
      o0 = n0;
      o1 = n1;
    }
  }
  if (r < r1) or_run<L>(oz + runs[r], acc);
}

// Every run of one stencil at one level; `oz` is the thread's own output
// position in the halo'd tile, `st` the level's run offsets of the stencil.
template <int R>
__device__ __forceinline__ void or_level(const uint32_t* oz, const int* runs,
                                         const int* st, uint32_t (&acc)[R]) {
  or_group<1>(oz, runs, st, acc);
  or_group<2>(oz, runs, st, acc);
  or_group<3>(oz, runs, st, acc);
  or_group<4>(oz, runs, st, acc);
  or_group<5>(oz, runs, st, acc);
  or_group<6>(oz, runs, st, acc);
  or_group<7>(oz, runs, st, acc);
  or_group<8>(oz, runs, st, acc);
}

__global__ void __launch_bounds__(kThreads)
dilate_kernel(const uint32_t* __restrict__ occ, int wz, int nx, int ny,
              const int* __restrict__ table, int table_len, int n_levels,
              int n_st, int P, int TH, uint32_t* __restrict__ out0,
              uint32_t* __restrict__ out1) {
  extern __shared__ uint32_t smem[];
  const int tw = kLanes + 2 * P;
  const int th = kTileX + 2 * P;
  const int tile = TH * tw;
  int* s_tab = reinterpret_cast<int*>(smem);
  uint32_t* s_prev = smem + ((table_len + 3) & ~3);
  uint32_t* s_cur = s_prev + tile;
  uint32_t* s_next = s_cur + tile;
  uint32_t* s_oz0 = s_next + tile;
  uint32_t* s_oz1 = s_oz0 + tile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int w = blockIdx.z;
  const int x0 = blockIdx.y * kTileX;
  const int y0 = blockIdx.x * kLanes;
  const size_t plane = static_cast<size_t>(nx) * ny;

  for (int i = tid; i < table_len; i += kThreads) s_tab[i] = table[i];
  // Halo position (hx, hy) is word hy * TH + hx. Consecutive threads take
  // consecutive y, so the global reads coalesce and the odd stride keeps
  // the stores conflict-free; one flat loop, unrolled, keeps several
  // positions' global loads in flight (nothing else on the SM hides them).
  // hx = i / tw in float: exact, the quotient is never within 0.5 / tw of
  // an integer and the error is below 1e-4.
  const int n_stage = th * tw;
  const float inv_tw = 1.0f / tw;
#pragma unroll 4
  for (int i = tid; i < n_stage; i += kThreads) {
    const int hx = __float2int_rz((i + 0.5f) * inv_tw);
    const int hy = i - hx * tw;
    const int gx = x0 - P + hx, gy = y0 - P + hy;
    uint32_t a = 0, b = 0, c = 0;
    if (gx >= 0 && gx < nx && gy >= 0 && gy < ny) {
      const size_t o = static_cast<size_t>(gx) * ny + gy;
      b = occ[w * plane + o];
      if (w > 0) a = occ[(w - 1) * plane + o];
      if (w + 1 < wz) c = occ[(w + 1) * plane + o];
    }
    const int p = hy * TH + hx;
    s_prev[p] = a;
    s_cur[p] = b;
    s_next[p] = c;
    s_oz0[p] = b;
  }
  __syncthreads();

  uint32_t acc0[kRows] = {};
  uint32_t acc1[kRows] = {};
  const int me = (lane + P) * TH + warp * kRows + P;
  const int* runs = s_tab + n_levels * kLevelInts;
  uint32_t* oz_in = s_oz0;
  uint32_t* oz_out = s_oz1;
  int z_done = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int* lv = s_tab + l * kLevelInts;
    const int z = lv[0];
    if (z > z_done) {
      // oz_z = oz_{z_done} | the shifts by z_done+1..z, over the halo that
      // this level and the later ones read (reach p: rows and columns
      // P - p .. P + tile + p).
      const int p_l = lv[1];
      const int rh = kTileX + 2 * p_l;
      const int n_pos = rh * (kLanes + 2 * p_l);
      const float inv_rh = 1.0f / rh;
      const int start = (P - p_l) * TH + (P - p_l);
      for (int i = tid; i < n_pos; i += kThreads) {
        const int ry = __float2int_rz((i + 0.5f) * inv_rh);
        const int p = start + ry * TH + (i - ry * rh);
        const uint32_t pv = s_prev[p], c = s_cur[p], nv = s_next[p];
        uint32_t v = oz_in[p];
        for (int k = z_done + 1; k <= z; ++k)
          v |= __funnelshift_l(pv, c, k) | __funnelshift_r(c, nv, k);
        oz_out[p] = v;
      }
      z_done = z;
      uint32_t* t = oz_out;
      oz_out = oz_in;
      oz_in = t;
      // oz_z has landed; the buffer written next was last read a level ago
      __syncthreads();
    }
    or_level(oz_in + me, runs, lv + 2, acc0);
    if (n_st > 1) or_level(oz_in + me, runs, lv + 2 + kLMax + 1, acc1);
  }

  const int y = y0 + lane;
  if (y >= ny) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int x = x0 + warp * kRows + i;
    if (x >= nx) continue;
    const size_t o = w * plane + static_cast<size_t>(x) * ny + y;
    out0[o] = acc0[i];
    if (n_st > 1) out1[o] = acc1[i];
  }
}

}  // namespace

extern "C" {

// occ: (wz, nx, ny) words; table: table_len int32 on the device, n_levels
// level records (kLevelInts each, levels by ascending z) then the run
// offsets; n_st stencils (1 or 2); P: the largest |dx|, |dy|; TH: the
// halo'd tile's row stride, odd and at least kTileX + 2 P. out1 is written
// only when n_st == 2.
int simpleicp_dilate(const void* occ, int wz, int nx, int ny, const void* table,
                     int table_len, int n_levels, int n_st, int P, int TH,
                     void* out0, void* out1, void* stream) {
  if (n_st < 1 || n_st > 2 || n_levels < 1 || P < 0 || wz < 1 || nx < 1 ||
      ny < 1 || table_len < n_levels * kLevelInts || TH < kTileX + 2 * P)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) * (((table_len + 3) & ~3) +
                                          5 * static_cast<size_t>(TH) * (kLanes + 2 * P));
  cudaError_t err = cudaFuncSetAttribute(dilate_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((ny + kLanes - 1) / kLanes, (nx + kTileX - 1) / kTileX, wz);
  dilate_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(occ), wz, nx, ny, static_cast<const int*>(table),
      table_len, n_levels, n_st, P, TH, static_cast<uint32_t*>(out0),
      static_cast<uint32_t*>(out1));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

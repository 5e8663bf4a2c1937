// Gauss-Newton solve of the six rigid-body parameters, for Hopper (sm_90a).
//
// gn_solve (gn_solve_kernel)
//   Replaces no Pallas kernel. It stands in for the JAX package's fused
//   lax.while_loop of the solve (simpleicp_tpu/models/solver.py, gn_solve's
//   while_loop), which XLA keeps on the device: the plain PyTorch loop
//   (models/solver.py gn_solve_plain) issues ~330 scalar float64
//   operations a Gauss-Newton step and reads a flag back to the host after
//   each step, so on the card it is paced by the host's launches. Here the
//   whole inner loop, and the residuals at the optimum, are one launch.
//   Semantics: gn_solve_plain's, one problem per leading index b:
//   - p = vary ? p0 : obs_vals, vary = isfinite(obs_w); rel = +inf.
//   - A problem that is not active takes no step. Otherwise, up to n_steps
//     times: N = J^T W J + diag(obs_w2), b = J^T W r + obs_w2 (p - obs),
//     with J the analytic Jacobian of the point-to-plane residual r at p
//     and W = mask ? dw^2 : 0; frozen parameters eliminated (zero rows and
//     columns, unit diagonal, zero right-hand side); N damped by
//     diag(N) 1e-9 + 1e-30; delta from the unrolled Cholesky; p -= delta,
//     rel = |delta| / (1 + |p|); stop once rel <= 64 eps(float64). The step
//     is applied first and tested after, as the plain loop and the JAX
//     while_loop do.
//   - Out: p, the residuals at the final p and rel, in the coordinate type.
//   Bound on the H100: latency, not operations or bytes. A step is one pass
//   over C correspondences (~150 float64 operations each: 1.5e5 at
//   C = 1000, 4 ns at 34 TFLOP/s), one block reduction of 27 sums and a
//   serial 6 x 6 factorisation (6 square roots and 27 divides, dependent).
//   Design:
//   - One block per problem; the block loops over the steps, so nothing
//     leaves the SM between steps and the host reads nothing. Threads
//     stride over C; the wrapper sizes the block from C (about four
//     correspondences a thread, 32 to kMaxThreads threads).
//   - Thread 0 puts [R | t] and the three dR/dalpha_k of the current p in
//     shared memory, with the formulas of euler_angles_to_rotation_matrix
//     and _rotation_derivatives. Each thread computes its rows' residuals
//     (apply_H's order ((h0 x + h1 y) + h2 z) + h3, dotted with n) and
//     Jacobian rows [n . (dR_k xm)]_k, n in separate correctly rounded
//     operations (__dmul_rn, __dadd_rn: no contraction to fused
//     multiply-adds, as the plain version's separate operations), and
//     accumulates the 21 upper entries of N and the 6 of b in registers.
//   - The 27 sums are reduced in a fixed order: a shuffle tree in each
//     warp, then the warps in index order, one thread a sum. No atomics:
//     a launch gives the same bits every time, and every rank of a
//     sharded registration (which solves the same replicated problem)
//     gets the same p.
//   - Thread 0 finishes the step (observations, elimination, damping,
//     Cholesky, the update and the stop test) and sets the next rotation.
//     Three barriers a step.
// All solver arithmetic is float64 whatever the coordinate type. The
// kernel allocates nothing and runs on the caller's stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 256 threads keep the 27 running sums, the point's data and the hoisted
// rotation in registers (255 a thread); at 512 (128 a thread) they spilled.
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kSums = 27;  // the 21 upper entries of N (row by row), then b
constexpr double kTol = 64.0 * 2.220446049250313080847e-16;  // 64 eps(float64)

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// dw * dw in the coordinate type, then widened (the plain version squares
// before its conversion to float64).
__device__ __forceinline__ double square_in(float v) { return static_cast<double>(__fmul_rn(v, v)); }
__device__ __forceinline__ double square_in(double v) { return __dmul_rn(v, v); }

struct Shared {
  double Rt[3][4];       // [R | t]
  double dR[3][3][3];    // dR / dalpha_k [k][i][j]
  double part[kMaxWarps][kSums];
  double sum[kSums];
  double p[6];
  double obs[6], obs_w2[6], vary_f[6];  // the problem's observations
  double rel;
  int go;
};

// [R | t] and dR/dalpha_k at p, each entry as the plain version's separate
// elementwise operations compute it (negation is exact).
__device__ void set_rotation(Shared& s, const double* p) {
  const double c1 = cos(p[0]), s1 = sin(p[0]);
  const double c2 = cos(p[1]), s2 = sin(p[1]);
  const double c3 = cos(p[2]), s3 = sin(p[2]);
  const double s1s2 = mul(s1, s2), c1s2 = mul(c1, s2);
  const double c1c2 = mul(c1, c2), s1c2 = mul(s1, c2);
  s.Rt[0][0] = mul(c2, c3);
  s.Rt[0][1] = -mul(c2, s3);
  s.Rt[0][2] = s2;
  s.Rt[1][0] = add(mul(c1, s3), mul(s1s2, c3));
  s.Rt[1][1] = sub(mul(c1, c3), mul(s1s2, s3));
  s.Rt[1][2] = -s1c2;
  s.Rt[2][0] = sub(mul(s1, s3), mul(c1s2, c3));
  s.Rt[2][1] = add(mul(s1, c3), mul(c1s2, s3));
  s.Rt[2][2] = c1c2;
  for (int i = 0; i < 3; ++i) s.Rt[i][3] = p[3 + i];
  // dR1
  s.dR[0][0][0] = 0.0; s.dR[0][0][1] = 0.0; s.dR[0][0][2] = 0.0;
  s.dR[0][1][0] = add(-mul(s1, s3), mul(c1s2, c3));
  s.dR[0][1][1] = sub(-mul(s1, c3), mul(c1s2, s3));
  s.dR[0][1][2] = -c1c2;
  s.dR[0][2][0] = add(mul(c1, s3), mul(s1s2, c3));
  s.dR[0][2][1] = sub(mul(c1, c3), mul(s1s2, s3));
  s.dR[0][2][2] = -s1c2;
  // dR2
  s.dR[1][0][0] = -mul(s2, c3);
  s.dR[1][0][1] = mul(s2, s3);
  s.dR[1][0][2] = c2;
  s.dR[1][1][0] = mul(s1c2, c3);
  s.dR[1][1][1] = -mul(s1c2, s3);
  s.dR[1][1][2] = s1s2;
  s.dR[1][2][0] = -mul(c1c2, c3);
  s.dR[1][2][1] = mul(c1c2, s3);
  s.dR[1][2][2] = -c1s2;
  // dR3
  s.dR[2][0][0] = -mul(c2, s3);
  s.dR[2][0][1] = -mul(c2, c3);
  s.dR[2][0][2] = 0.0;
  s.dR[2][1][0] = sub(mul(c1, c3), mul(s1s2, s3));
  s.dR[2][1][1] = sub(-mul(c1, s3), mul(s1s2, c3));
  s.dR[2][1][2] = 0.0;
  s.dR[2][2][0] = add(mul(s1, c3), mul(c1s2, s3));
  s.dR[2][2][1] = add(-mul(s1, s3), mul(c1s2, c3));
  s.dR[2][2][2] = 0.0;
}

// (((a0 b0 + a1 b1) + a2 b2): a dot product of three in index order.
__device__ __forceinline__ double dot3(double a0, double a1, double a2, double b0,
                                       double b1, double b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// The signed point-to-plane residual of one correspondence at s.Rt.
__device__ __forceinline__ double residual(const Shared& s, const double* x, const double* f,
                                           const double* n) {
  double e[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double xt = add(add(add(mul(s.Rt[i][0], x[0]), mul(s.Rt[i][1], x[1])),
                              mul(s.Rt[i][2], x[2])), s.Rt[i][3]);
    e[i] = mul(sub(xt, f[i]), n[i]);
  }
  return add(add(e[0], e[1]), e[2]);
}

template <typename T>
__device__ __forceinline__ void load3(const T* src, int64_t row, double* out) {
  out[0] = static_cast<double>(src[3 * row]);
  out[1] = static_cast<double>(src[3 * row + 1]);
  out[2] = static_cast<double>(src[3 * row + 2]);
}

// Thread 0: the step's 6 x 6 system from the reduced sums, and its solve,
// with the plain version's arithmetic on the lower triangle (the
// factorisation in place). Writes p - delta to s.p and returns rel.
__device__ __forceinline__ double finish_step(Shared& s) {
  double A[6][6], b[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) A[j][i] = s.sum[k++];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    // the observations, then _restrict_to_varying (vary_f is 0 or 1, so
    // the products are exact in any order), then _damp
    A[i][i] = A[i][i] + s.obs_w2[i];
    b[i] = (s.sum[21 + i] + s.obs_w2[i] * (s.p[i] - s.obs[i])) * s.vary_f[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) A[i][j] = A[i][j] * s.vary_f[i] * s.vary_f[j];
    A[i][i] = A[i][i] + (1.0 - s.vary_f[i]);
    A[i][i] = A[i][i] + (A[i][i] * 1e-9 + 1e-30);
  }
  // _cholesky6, in place, then _cholesky6_solve
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      double v = A[i][j];
#pragma unroll
      for (int m = 0; m < j; ++m) v = v - A[i][m] * A[j][m];
      A[i][j] = i == j ? sqrt(v) : v / A[j][j];
    }
  double z[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    double v = b[i];
#pragma unroll
    for (int m = 0; m < i; ++m) v = v - A[i][m] * z[m];
    z[i] = v / A[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double v = z[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) v = v - A[m][i] * x[m];
    x[i] = v / A[i][i];
  }
  double dd = 0.0, pp = 0.0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    s.p[i] = s.p[i] - x[i];
    dd += x[i] * x[i];
    pp += s.p[i] * s.p[i];
  }
  return sqrt(dd) / (1.0 + sqrt(pp));
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_solve_kernel(const T* __restrict__ p0, const T* __restrict__ xm, const T* __restrict__ xf,
                const T* __restrict__ nrm, const uint8_t* __restrict__ mask,
                const T* __restrict__ dw, const T* __restrict__ obs_vals,
                const T* __restrict__ obs_w, const uint8_t* __restrict__ active, int C,
                int n_steps, T* __restrict__ p_out, T* __restrict__ res_out,
                T* __restrict__ rel_out) {
  __shared__ Shared s;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int64_t base = static_cast<int64_t>(b) * C;

  const double dw2 = square_in(dw[b]);

  if (tid == 0) {
    for (int i = 0; i < 6; ++i) {
      const double w = static_cast<double>(obs_w[6 * b + i]);
      const bool vary = isfinite(w);
      s.obs[i] = static_cast<double>(obs_vals[6 * b + i]);
      s.vary_f[i] = vary ? 1.0 : 0.0;
      s.obs_w2[i] = (vary && w > 0.0) ? w * w : 0.0;
      s.p[i] = vary ? static_cast<double>(p0[6 * b + i]) : s.obs[i];
    }
    s.rel = INFINITY;
    s.go = active == nullptr || active[b] != 0;
    set_rotation(s, s.p);
  }
  __syncthreads();

  for (int step = 0; step < n_steps && s.go; ++step) {
    double acc[kSums];
#pragma unroll
    for (int v = 0; v < kSums; ++v) acc[v] = 0.0;
    for (int c = tid; c < C; c += blockDim.x) {
      double x[3], f[3], n[3];
      load3(xm, base + c, x);
      load3(xf, base + c, f);
      load3(nrm, base + c, n);
      const double r = residual(s, x, f, n);
      double J[6];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        double rot[3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          rot[i] = dot3(s.dR[k][i][0], s.dR[k][i][1], s.dR[k][i][2], x[0], x[1], x[2]);
        J[k] = dot3(rot[0], rot[1], rot[2], n[0], n[1], n[2]);
      }
      J[3] = n[0]; J[4] = n[1]; J[5] = n[2];
      const double w = mask[base + c] ? dw2 : 0.0;
      double Jw[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) Jw[j] = J[j] * w;
      int v = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j) acc[v++] += J[i] * Jw[j];
#pragma unroll
      for (int i = 0; i < 6; ++i) acc[21 + i] += Jw[i] * r;
    }
#pragma unroll
    for (int v = 0; v < kSums; ++v) {
      double a = acc[v];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
      if (lane == 0) s.part[warp][v] = a;
    }
    __syncthreads();
    if (tid < kSums) {
      double a = s.part[0][tid];
      for (int w = 1; w < n_warps; ++w) a += s.part[w][tid];
      s.sum[tid] = a;
    }
    __syncthreads();
    if (tid == 0) {
      s.rel = finish_step(s);
      s.go = s.rel > kTol;  // false for a NaN step too, as the plain test
      set_rotation(s, s.p);
    }
    __syncthreads();
  }

  for (int c = tid; c < C; c += blockDim.x) {
    double x[3], f[3], n[3];
    load3(xm, base + c, x);
    load3(xf, base + c, f);
    load3(nrm, base + c, n);
    res_out[base + c] = static_cast<T>(residual(s, x, f, n));
  }
  if (tid < 6) p_out[6 * b + tid] = static_cast<T>(s.p[tid]);
  if (tid == 0) rel_out[b] = static_cast<T>(s.rel);
}

template <typename T>
int launch(const void* p0, const void* xm, const void* xf, const void* n, const void* mask,
           const void* dw, const void* obs_vals, const void* obs_w, const void* active,
           int B, int C, int n_steps, int threads, void* p_out, void* res_out, void* rel_out,
           void* stream) {
  if (B < 1 || C < 0 || n_steps < 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  gn_solve_kernel<T><<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p0), static_cast<const T*>(xm), static_cast<const T*>(xf),
      static_cast<const T*>(n), static_cast<const uint8_t*>(mask), static_cast<const T*>(dw),
      static_cast<const T*>(obs_vals), static_cast<const T*>(obs_w),
      static_cast<const uint8_t*>(active), C, n_steps, static_cast<T*>(p_out),
      static_cast<T*>(res_out), static_cast<T*>(rel_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One problem per leading index b < B: p0, obs_vals, obs_w (B, 6); xm, xf, n
// (B, C, 3); mask (B, C) and active (B) bool (active may be null: every
// problem steps); dw (B); all contiguous, in the coordinate type but the
// masks. Outputs p_out (B, 6), res_out (B, C), rel_out (B). threads: a
// multiple of 32, at most kMaxThreads.
int simpleicp_gn_solve_f32(const void* p0, const void* xm, const void* xf, const void* n,
                           const void* mask, const void* dw, const void* obs_vals,
                           const void* obs_w, const void* active, int B, int C, int n_steps,
                           int threads, void* p_out, void* res_out, void* rel_out,
                           void* stream) {
  return launch<float>(p0, xm, xf, n, mask, dw, obs_vals, obs_w, active, B, C, n_steps,
                       threads, p_out, res_out, rel_out, stream);
}

int simpleicp_gn_solve_f64(const void* p0, const void* xm, const void* xf, const void* n,
                           const void* mask, const void* dw, const void* obs_vals,
                           const void* obs_w, const void* active, int B, int C, int n_steps,
                           int threads, void* p_out, void* res_out, void* rel_out,
                           void* stream) {
  return launch<double>(p0, xm, xf, n, mask, dw, obs_vals, obs_w, active, B, C, n_steps,
                        threads, p_out, res_out, rel_out, stream);
}

}  // extern "C"

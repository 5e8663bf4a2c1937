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
//
// estimate_uncertainties (uncertainty_kernel)
//   Replaces no Pallas kernel. It stands in for XLA's fusion of the JAX
//   package's estimate_uncertainties (simpleicp_tpu/models/solver.py), the
//   last stage of every registration: the plain PyTorch version
//   (models/solver.py estimate_uncertainties_plain) issues ~370 launches on
//   six numbers and a 6 x 6 matrix, with the card idle between them.
//   Semantics: estimate_uncertainties_plain's, one problem per index b, at
//   the final p as given:
//   - N = J^T P J + diag(obs_w at observed parameters), P = mask ? dw : 0
//     (the weight multipliers, not their squares); frozen parameters
//     (obs_w not finite) eliminated and N damped as in the solve;
//     Qxx = N^-1 by the Cholesky factor and six unit-vector column solves.
//   - vPv = sum P r^2 + sum obs_w (p - obs)^2 over observed parameters,
//     s0^2 = vPv / max(valid rows + observed - varying, 1).
//   - Out: sigma = sqrt(s0^2 diag Qxx), NaN at frozen parameters; Cxx =
//     s0^2 Qxx with frozen rows and columns multiplied by 0; in the
//     coordinate type.
//   Bound on the H100: latency. One pass over C (~140 float64 operations a
//   correspondence: 1.4e5 at C = 1000, 4 ns at 34 TFLOP/s), one block
//   reduction of 23 sums, a serial 6 x 6 factorisation.
//   Design: the solve kernel's, for one step: its rotation, residual,
//   Jacobian row and fixed-order block reduction (so a launch gives the
//   same bits every time and every rank of a sharded registration the same
//   result) and its 6 x 6 work (restrict_and_damp, cholesky6,
//   cholesky6_solve). Thread 0 assembles N and factors it; threads 0-5
//   then solve one column of Qxx each and write its column of Cxx and its
//   sigma.
// All solver arithmetic is float64 whatever the coordinate type. The
// kernels allocate nothing and run on the caller's stream.

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

// The rotation of a problem's current p, shared by its block.
struct Pose {
  double Rt[3][4];       // [R | t]
  double dR[3][3][3];    // dR / dalpha_k [k][i][j]
};

struct Shared {
  Pose pose;
  double part[kMaxWarps][kSums];
  double sum[kSums];
  double p[6];
  double obs[6], obs_w2[6], vary_f[6];  // the problem's observations
  double rel;
  int go;
};

// [R | t] and dR/dalpha_k at p, each entry as the plain version's separate
// elementwise operations compute it (negation is exact).
__device__ void set_rotation(Pose& s, const double* p) {
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
__device__ __forceinline__ double residual(const Pose& s, const double* x, const double* f,
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

// The Jacobian row of one correspondence at s: [n . (dR_k x)]_k, then n.
__device__ __forceinline__ void jacobian_row(const Pose& s, const double* x, const double* n,
                                             double* J) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    double rot[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      rot[i] = dot3(s.dR[k][i][0], s.dR[k][i][1], s.dR[k][i][2], x[0], x[1], x[2]);
    J[k] = dot3(rot[0], rot[1], rot[2], n[0], n[1], n[2]);
  }
  J[3] = n[0]; J[4] = n[1]; J[5] = n[2];
}

template <typename T>
__device__ __forceinline__ void load3(const T* src, int64_t row, double* out) {
  out[0] = static_cast<double>(src[3 * row]);
  out[1] = static_cast<double>(src[3 * row + 1]);
  out[2] = static_cast<double>(src[3 * row + 2]);
}

// The block's totals of each thread's K running sums, in a fixed order: a
// shuffle tree in each warp, then the warps in index order, one thread a
// sum. Every thread of the block calls it; sum[] holds the totals after it.
template <int K>
__device__ __forceinline__ void block_sum(const double (&acc)[K], double (*part)[K],
                                          double* sum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int v = 0; v < K; ++v) {
    double a = acc[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
    if (lane == 0) part[warp][v] = a;
  }
  __syncthreads();
  if (tid < K) {
    double a = part[0][tid];
    for (int w = 1; w < n_warps; ++w) a += part[w][tid];
    sum[tid] = a;
  }
  __syncthreads();
}

// The 6 x 6 work both kernels share, on the lower triangle of A, in the
// plain version's order of operations (nvcc may contract a product and a
// sum into one fused multiply-add here, as in the solve's running sums).
//
// Row by row: diag_w on the diagonal, then _restrict_to_varying (vary_f is
// 0 or 1, so the products are exact in any order), then _damp.
__device__ __forceinline__ void restrict_and_damp(double (&A)[6][6], const double* diag_w,
                                                  const double* vary_f) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] = A[i][i] + diag_w[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) A[i][j] = A[i][j] * vary_f[i] * vary_f[j];
    A[i][i] = A[i][i] + (1.0 - vary_f[i]);
    A[i][i] = A[i][i] + (A[i][i] * 1e-9 + 1e-30);
  }
}

// _cholesky6, in place.
__device__ __forceinline__ void cholesky6(double (&A)[6][6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      double v = A[i][j];
#pragma unroll
      for (int m = 0; m < j; ++m) v = v - A[i][m] * A[j][m];
      A[i][j] = i == j ? sqrt(v) : v / A[j][j];
    }
}

// _cholesky6_solve: x = (L L^T)^-1 b, L the factor cholesky6 leaves.
__device__ __forceinline__ void cholesky6_solve(const double (&L)[6][6], const double* b,
                                                double* x) {
  double z[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    double v = b[i];
#pragma unroll
    for (int m = 0; m < i; ++m) v = v - L[i][m] * z[m];
    z[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double v = z[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) v = v - L[m][i] * x[m];
    x[i] = v / L[i][i];
  }
}

// Thread 0: the step's 6 x 6 system from the reduced sums, and its solve.
// Writes p - delta to s.p and returns rel.
__device__ __forceinline__ double finish_step(Shared& s) {
  double A[6][6], b[6], x[6];
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) A[j][i] = s.sum[k++];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    b[i] = (s.sum[21 + i] + s.obs_w2[i] * (s.p[i] - s.obs[i])) * s.vary_f[i];
  restrict_and_damp(A, s.obs_w2, s.vary_f);
  cholesky6(A);
  cholesky6_solve(A, b, x);
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
  const int tid = threadIdx.x;
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
    set_rotation(s.pose, s.p);
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
      const double r = residual(s.pose, x, f, n);
      double J[6];
      jacobian_row(s.pose, x, n, J);
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
    block_sum(acc, s.part, s.sum);
    if (tid == 0) {
      s.rel = finish_step(s);
      s.go = s.rel > kTol;  // false for a NaN step too, as the plain test
      set_rotation(s.pose, s.p);
    }
    __syncthreads();
  }

  for (int c = tid; c < C; c += blockDim.x) {
    double x[3], f[3], n[3];
    load3(xm, base + c, x);
    load3(xf, base + c, f);
    load3(nrm, base + c, n);
    res_out[base + c] = static_cast<T>(residual(s.pose, x, f, n));
  }
  if (tid < 6) p_out[6 * b + tid] = static_cast<T>(s.p[tid]);
  if (tid == 0) rel_out[b] = static_cast<T>(s.rel);
}

constexpr int kUSums = 23;  // the 21 lower entries of N (row by row), sum w r^2, valid rows

struct UShared {
  Pose pose;
  double part[kMaxWarps][kUSums];
  double sum[kUSums];
  double p[6];
  double L[6][6];  // the Cholesky factor (lower triangle)
  double vary_f[6];
  double s0_sq;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
uncertainty_kernel(const T* __restrict__ p, const T* __restrict__ xm, const T* __restrict__ xf,
                   const T* __restrict__ nrm, const uint8_t* __restrict__ mask,
                   const T* __restrict__ dw, const T* __restrict__ obs_vals,
                   const T* __restrict__ obs_w, int C, T* __restrict__ sigma_out,
                   T* __restrict__ cxx_out) {
  __shared__ UShared s;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t base = static_cast<int64_t>(b) * C;
  const double w_valid = static_cast<double>(dw[b]);  // P is the weight, not its square

  if (tid == 0) {
    for (int i = 0; i < 6; ++i) s.p[i] = static_cast<double>(p[6 * b + i]);
    set_rotation(s.pose, s.p);
  }
  __syncthreads();

  double acc[kUSums];
#pragma unroll
  for (int v = 0; v < kUSums; ++v) acc[v] = 0.0;
  for (int c = tid; c < C; c += blockDim.x) {
    double x[3], f[3], n[3];
    load3(xm, base + c, x);
    load3(xf, base + c, f);
    load3(nrm, base + c, n);
    const double r = residual(s.pose, x, f, n);
    double J[6];
    jacobian_row(s.pose, x, n, J);
    // a rejected row takes part with weight zero, as in the plain version
    // (so a non-finite row spreads as there)
    const bool valid = mask[base + c] != 0;
    const double w = valid ? w_valid : 0.0;
    double Jw[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) Jw[j] = mul(J[j], w);
    int v = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) acc[v++] += J[i] * Jw[j];
    acc[21] += mul(w, r) * r;
    acc[22] += valid ? 1.0 : 0.0;
  }
  block_sum(acc, s.part, s.sum);

  if (tid == 0) {
    // N = J^T P J + diag(obs_w) over the varying parameters, frozen ones
    // eliminated, damped; its Cholesky factor; s0^2 = vPv / redundancy
    double A[6][6], diag_w[6];
    double vpv_obs = 0.0;
    int n_obs = static_cast<int>(s.sum[22]), n_prm = 0;
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) A[i][j] = s.sum[k++];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const double w = static_cast<double>(obs_w[6 * b + i]);
      const bool vary = isfinite(w), is_obs = vary && w > 0.0;
      s.vary_f[i] = vary ? 1.0 : 0.0;
      diag_w[i] = is_obs ? w : 0.0;
      n_prm += vary;
      n_obs += is_obs;
      if (is_obs) {
        const double d = sub(s.p[i], static_cast<double>(obs_vals[6 * b + i]));
        vpv_obs = add(vpv_obs, mul(w, mul(d, d)));
      }
    }
    restrict_and_damp(A, diag_w, s.vary_f);
    cholesky6(A);
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) s.L[i][j] = A[i][j];
    const int dof = n_obs - n_prm;
    s.s0_sq = add(s.sum[21], vpv_obs) / static_cast<double>(dof > 1 ? dof : 1);
  }
  __syncthreads();

  if (tid < 6) {
    // column m of Qxx = N^-1: _cholesky6_solve on the unit vector e_m
    const int m = tid;
    double e[6], x[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) e[i] = i == m ? 1.0 : 0.0;
    cholesky6_solve(s.L, e, x);
    const double s0_sq = s.s0_sq;
    double x_mm = 0.0;  // Qxx[m][m]: x[m], a dynamic index, would put x in local memory
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      cxx_out[36 * static_cast<int64_t>(b) + 6 * i + m] =
          static_cast<T>(mul(mul(mul(s0_sq, x[i]), s.vary_f[i]), s.vary_f[m]));
      if (i == m) x_mm = x[i];
    }
    sigma_out[6 * b + m] = s.vary_f[m] != 0.0 ? static_cast<T>(sqrt(mul(s0_sq, x_mm)))
                                              : static_cast<T>(NAN);
  }
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

template <typename T>
int launch_uncertainties(const void* p, const void* xm, const void* xf, const void* n,
                         const void* mask, const void* dw, const void* obs_vals,
                         const void* obs_w, int B, int C, int threads, void* sigma_out,
                         void* cxx_out, void* stream) {
  if (B < 1 || C < 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  uncertainty_kernel<T><<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const T*>(xm), static_cast<const T*>(xf),
      static_cast<const T*>(n), static_cast<const uint8_t*>(mask), static_cast<const T*>(dw),
      static_cast<const T*>(obs_vals), static_cast<const T*>(obs_w), C,
      static_cast<T*>(sigma_out), static_cast<T*>(cxx_out));
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

// The uncertainties of B problems at their final p (B, 6): the other inputs
// as the solve's (no active mask). Outputs sigma_out (B, 6) and cxx_out
// (B, 6, 6), contiguous, in the coordinate type.
int simpleicp_uncertainties_f32(const void* p, const void* xm, const void* xf, const void* n,
                                const void* mask, const void* dw, const void* obs_vals,
                                const void* obs_w, int B, int C, int threads, void* sigma_out,
                                void* cxx_out, void* stream) {
  return launch_uncertainties<float>(p, xm, xf, n, mask, dw, obs_vals, obs_w, B, C, threads,
                                     sigma_out, cxx_out, stream);
}

int simpleicp_uncertainties_f64(const void* p, const void* xm, const void* xf, const void* n,
                                const void* mask, const void* dw, const void* obs_vals,
                                const void* obs_w, int B, int C, int threads, void* sigma_out,
                                void* cxx_out, void* stream) {
  return launch_uncertainties<double>(p, xm, xf, n, mask, dw, obs_vals, obs_w, B, C, threads,
                                      sigma_out, cxx_out, stream);
}

}  // extern "C"

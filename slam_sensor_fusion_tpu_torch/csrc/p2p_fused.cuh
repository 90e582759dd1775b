// Shared device functions of the point-to-plane registration kernels: K4,
// K5, K6 (p2p_fused.cu) and the LIO superblock kernel K7
// (lio_superblock_fused.cu), the body of slam_sensor_fusion_tpu/ops/
// p2p_fused.py:64-374 (and its repetition in ops/lio_superblock_fused.py:
// 276-401).
//
// A matched set is each source point's best d2 and matched (x, y, z, nx,
// ny, nz) in K5's output layout; `add_moments` is one point's terms of the
// 29 Huber-weighted moments of a GN pass (K4, K6, K7), `moments` their
// block-wide sum over a matched set in global memory; `gn_passes`
// runs the GN iterations and the trailing stats pass and leaves the stats
// pass's UNDAMPED moments in S.mom: K4 and K6 add the damping to the JtJ
// they export, K7 feeds the undamped moments to its measurement covariance.
// `grid_gn` is the whole GN of the cooperative grids K4 and K7: each
// association a round of grid_assoc.cuh, then gn_passes' order.
// The scalar tail (damped Cholesky solve, starve guard, Taylor SE(3) step,
// polar polish, composition) runs on thread 0 in the JAX kernel's operation
// order; the library builds with -fmad=false, so it rounds op by op as the
// plain versions do.
#pragma once

#include <cuda_runtime.h>

#include "grid_assoc.cuh"
#include "icp_fused.cuh"

// Mirrors ctypes struct `_P2PParams` in ops/p2p_fused.py.
struct P2PParams {
  float gate;         // max_correspondence_dist_sq
  float huber_delta;  // Huber kernel width on the plane residual
  float damping;      // Levenberg damping on JtJ's diagonal
  int num_iterations;
  int fixed;          // associate once at the prior
};

namespace sfk {
namespace p2p {

constexpr int kNMom = 29;  // 21 JtJ (lower triangle), 6 Jtr, W, wr2

struct Shared {
  // broadcast from thread 0 to the block
  float R[9];
  float t[3];
  float mom[kNMom];
};

// A matched set and its source pages; TN is the target pages' width (the
// stride of a winner's rows where a round's combine fills the set).
struct Tiles {
  const float* src;  // (nSt, 3, TM) sensor-frame source pages
  float* d2;         // (nSt, 1, TM) best squared distance
  float* qn;         // (nSt, 6, TM) matched point + normal
  int nSt, TM, TN;
};

// One matched point's terms of the 29 moments under (R, t), added to v:
// source point s (sensor frame), matched point q and normal n, best d2
// (p2p_fused.py:254-303 without the damping).
__device__ __forceinline__ void add_moments(float (&v)[kNMom], const float* R, const float* t,
                                            const P2PParams& prm, float sx, float sy, float sz,
                                            float qx, float qy, float qz, float nx, float ny,
                                            float nz, float d2) {
  const float px = R[0] * sx + R[1] * sy + R[2] * sz + t[0];
  const float py = R[3] * sx + R[4] * sy + R[5] * sz + t[1];
  const float pz = R[6] * sx + R[7] * sy + R[8] * sz + t[2];
  // invalid normals are stored as 0-vectors -> |n|^2 < 0.5
  const float w_in = (d2 < prm.gate && nx * nx + ny * ny + nz * nz > 0.5f) ? 1.0f : 0.0f;
  const float res = nx * (px - qx) + ny * (py - qy) + nz * (pz - qz);
  const float w = w_in * sfk::jmin(1.0f, prm.huber_delta / sfk::jmax(fabsf(res), 1e-12f));
  // J = [n, p' x n]
  const float J[6] = {nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx};
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float wJ = w * J[a];
#pragma unroll
    for (int b = 0; b <= a; ++b) v[a * (a + 1) / 2 + b] += wJ * J[b];
    v[21 + a] += wJ * res;
  }
  v[27] += w_in;
  v[28] += w_in * res * res;
}

// The 29 moments under (S.R, S.t) on the matched set, into S.mom (every
// thread must call it): thread x adds up the points x, x + blockDim.x, ...
// of the flat (tile, row) order, then the fixed-order block sum. With the
// one-block layout's TM x G threads (TM <= 1024) that is point x % TM of
// tiles x / TM, x / TM + G, ..., the order of the one-block kernels; past
// 1024 rows the block has 1024 threads and a thread owns several rows of
// a tile (grid_assoc.cuh's `first_threads`).
__device__ inline void moments(Shared& S, const Tiles& T, const P2PParams& prm, float* red) {
  float R[9], t[3];
#pragma unroll
  for (int m = 0; m < 9; ++m) R[m] = S.R[m];
  t[0] = S.t[0]; t[1] = S.t[1]; t[2] = S.t[2];
  float v[kNMom];
#pragma unroll
  for (int m = 0; m < kNMom; ++m) v[m] = 0.0f;
  for (int p = threadIdx.x; p < T.nSt * T.TM; p += blockDim.x) {
    const int i = p / T.TM;
    const int r = p - i * T.TM;
    const float* s = T.src + (size_t)i * 3 * T.TM + r;
    const float* q = T.qn + (size_t)i * 6 * T.TM + r;
    add_moments(v, R, t, prm, s[0], s[T.TM], s[2 * T.TM], q[0], q[T.TM], q[2 * T.TM],
                q[3 * T.TM], q[4 * T.TM], q[5 * T.TM], T.d2[p]);
  }
  sfk::block_sum<kNMom>(v, red, S.mom);
}

// Solve (6x6 SPD) A x = b by unrolled Cholesky, pivots floored at
// sqrt(1e-12) (p2p_fused.py:64-95). `tri` is A's row-major lower triangle.
__device__ inline void chol6_solve(const float* tri, const float* b, float* x) {
  float L[6][6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j <= i; ++j) {
      float s = tri[i * (i + 1) / 2 + j];
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrtf(sfk::jmax(s, 1e-12f)) : s / L[j][j];
    }
  float y[6];
  for (int i = 0; i < 6; ++i) {  // forward substitution L y = b
    float s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {  // back substitution L^T x = y
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// exp([phi]x, rho) -> (R, t) by the nested 4-term Taylor series of
// A = sin(th)/th, B = (1-cos th)/th^2, C = (1-A)/th^2 (p2p_fused.py:98-120).
__device__ inline void se3_exp_taylor(const float* rho, const float* phi, float* R, float* t) {
  const float t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float A = 1.0f - t2 / 6.0f * (1.0f - t2 / 20.0f * (1.0f - t2 / 42.0f));
  const float B = 0.5f * (1.0f - t2 / 12.0f * (1.0f - t2 / 30.0f * (1.0f - t2 / 56.0f)));
  const float C =
      (1.0f / 6.0f) * (1.0f - t2 / 20.0f * (1.0f - t2 / 42.0f * (1.0f - t2 / 72.0f)));
  const float wx = phi[0], wy = phi[1], wz = phi[2];
  const float zero = 0.0f * wx;
  const float K[9] = {zero, -wz, wy, wz, zero, -wx, -wy, wx, zero};
  float K2[9], V[9];
  sfk::mm3(K, K, K2);
#pragma unroll
  for (int m = 0; m < 9; ++m) {
    const float eye = (m % 4 == 0) ? 1.0f : 0.0f;
    R[m] = eye + A * K[m] + B * K2[m];
    V[m] = eye + B * K[m] + C * K2[m];
  }
  sfk::mv3(V, rho, t);
}

// The damped JtJ of S.mom as a row-major lower triangle: damping goes on
// the diagonal after the reduction.
__device__ inline void damped_tri(const Shared& S, float damping, float* tri) {
  for (int k = 0; k < 21; ++k) tri[k] = S.mom[k];
  for (int a = 0; a < 6; ++a) tri[a * (a + 1) / 2 + a] = tri[a * (a + 1) / 2 + a] + damping;
}

// One GN step from the moments in S.mom (thread 0): solve the damped
// system, skip the step on a starved frame, Taylor exp, one Newton-polar
// step, T <- exp(dx) T in S.R, S.t.
__device__ inline void gn_step(Shared& S, float damping) {
  float tri[21], x[6], rho[3], phi[3], R_step[9], t_step[3], R_inv[9], Rn[9], v[3];
  damped_tri(S, damping, tri);
  chol6_solve(tri, S.mom + 21, x);
  // a starved frame must not step
  const float ok = S.mom[27] >= 3.0f ? 1.0f : 0.0f;
  for (int a = 0; a < 3; ++a) {
    rho[a] = -x[a] * ok;
    phi[a] = -x[3 + a] * ok;
  }
  se3_exp_taylor(rho, phi, R_step, t_step);
  // one Newton-polar step pins orthogonality
  sfk::adjugate_transpose_over_det(R_step, R_inv);
  for (int m = 0; m < 9; ++m) R_step[m] = 0.5f * (R_step[m] + R_inv[m]);
  sfk::mm3(R_step, S.R, Rn);
  sfk::mv3(R_step, S.t, v);
  for (int m = 0; m < 9; ++m) S.R[m] = Rn[m];
  for (int a = 0; a < 3; ++a) S.t[a] = v[a] + t_step[a];
}

// The GN iterations and the stats pass from (S.R, S.t) on the matched set
// in T (every thread must call it): p2p_fused.py:325-374 with fixed
// correspondences. On return S.R, S.t hold the final transform and S.mom
// the stats pass's undamped moments, visible to every thread.
__device__ inline void gn_passes(Shared& S, const Tiles& T, const P2PParams& prm, float* red) {
  for (int it = 0; it <= prm.num_iterations; ++it) {
    moments(S, T, prm, red);
    if (it < prm.num_iterations) {
      if (threadIdx.x == 0) gn_step(S, prm.damping);
      __syncthreads();
    }
  }
}

// The leader's whole GN on a cooperative grid (K4, K7; every thread of the
// leader block calls it, from (S.R, S.t)): each association is a first-row
// round (grid_assoc.cuh: `scan_first<6>` on the workers for the published
// `frame`, whose pair list and pages A and T hold), combined into T's
// matched set in the layout `moments` reads (group g: tiles g, g + G, ...;
// thread r: point r), so no barrier follows the combine. With fixed
// correspondences one round at the prior, then gn_passes; with fresh ones
// gn_passes' order with a round in every pass. Leaves S as gn_passes does.
__device__ inline void grid_gn(const cooperative_groups::grid_group& g, grid::Ctl* ctl,
                               int frame, Shared& S, const Tiles& T,
                               const grid::FirstRound& A, const P2PParams& prm, float* red) {
  auto associate = [&] {
    grid::lead_round(g, ctl, frame, S.R, S.t);
    grid::combine_first<6>(A, [&](int i, int r, float best, const float* win) {
      T.d2[(size_t)i * T.TM + r] = best;
      float* o = T.qn + (size_t)i * 6 * T.TM + r;
#pragma unroll
      for (int k = 0; k < 6; ++k) o[k * T.TM] = win ? win[k * T.TN] : 0.0f;
    });
  };
  if (prm.fixed) {
    associate();
    gn_passes(S, T, prm, red);
    return;
  }
  for (int it = 0; it <= prm.num_iterations; ++it) {
    associate();
    moments(S, T, prm, red);
    if (it < prm.num_iterations) {
      if (threadIdx.x == 0) gn_step(S, prm.damping);
      __syncthreads();
    }
  }
}

}  // namespace p2p
}  // namespace sfk

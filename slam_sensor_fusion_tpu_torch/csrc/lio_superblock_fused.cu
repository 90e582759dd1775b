// K7: K frames of LiDAR-inertial odometry in one launch.
//
// Replaces the Pallas kernel `_make_lio_superblock_kernel` of
// slam_sensor_fusion_tpu/ops/lio_superblock_fused.py (launched by
// `lio_superblock` from models/lio.run_lio_superblocks). Per frame k of the
// block, in the JAX kernel's operation order:
//   1. EKF IMU propagation over the frame's Ki samples: the mean in 3x3
//      scalar math (Taylor-series rotation exponential), the covariance as a
//      zero-padded 16x16 matrix, P <- F P F^T + Q dt a sample;
//   2. point-to-plane GN against the block's anchor pages in the rebased
//      frame: p2p_fused.cuh's association, moments and GN step (K4's), the
//      stats pass's UNDAMPED moments kept for the measurement covariance;
//   3. the pose Kalman update: asin-series rotation residual, constant or
//      GN covariance (sigma^2 (JtJ + 1e-6 I)^-1 adjoint-mapped, floored, plus
//      the block-start pose covariance), a 6x6 inverse from six Cholesky
//      solves, Joseph form;
//   4. the chi^2-gated GPS position update with a 3x3 adjugate inverse; a
//      rejected fix multiplies its step and its Joseph terms by 0;
//   5. predicated state for tail-padding frames (an invalid frame is
//      skipped: the state carries over and its stats are 0).
// Outputs: poses (K, 4, 4), stats (K, 128) = [rmse, n_corr, gps_accepted,
// gps_chi2, slack_violation, slack_dist, x/y/z_std_used, 0...], the final
// pose (4, 4), P (16, 16) and [v, bg, ba, 0...] (128).
//
// What bounds it on an H100: the association's instruction issue, as K4's
// (8 float operations a distance over the tile pairs each frame admits; at
// the LIO bench's width 4 source tiles of 512 against up to 32 target tiles
// of 1024, two GN iterations on fixed correspondences: ~5 x 10^7 distances
// a frame), spread over the card; then the serial chain of a frame: the
// EKF's scalar chain, its 16x16 products (2 a sample, 4 more a frame:
// ~10^5 operations) and the GN and Kalman solves, all latency.
//
// Design: a persistent cooperative grid, one block on each SM, as K4's
// (grid_assoc.cuh). The frame loop runs on the device, since every frame
// starts from the previous frame's posterior. Block 0, the leader, has
// K4's leader layout: `first_threads` threads, thread x owning the points
// x, x + blockDim.x, ... of the frame's flat (tile, row) order (at TM <=
// 1024 the one-block layout, TM x G threads with G = min(nSt, 1024 / TM),
// group g owning source tiles g, g + G, ...; past it 1024 threads, each
// owning several rows of a tile: K1's global layout); the GN passes are
// K4's device functions on the frame's slice of the pages and pair lists,
// with the matched set in a global buffer in L2. Tiles of 32 to 4096 rows
// in steps of 32 take the same code. Each association is a round
// over the grid for the frame it publishes (`grid_gn`, K4's GN loop):
// every other block scans (source tile, pair slot) items of that frame's
// pair list into per-slot scratch, reused frame after frame, and the
// leader combines each point's slots in order under a strict `<`, which
// gives the one-block walk's winners bit for bit. An invalid frame
// publishes no round. The 16x16 products run one thread an output in
// shared memory, each a sum over k = 0, 1, ... in order; the scalar chain
// (mean propagation, assembling F, the Kalman gains, the state updates)
// runs on thread 0. The library builds with -fmad=false, so the plain
// version (`lio_superblock_plain`), which takes the same sums in the same
// order, rounds alike.
#include <cuda_runtime.h>

#include "grid_assoc.cuh"
#include "p2p_fused.cuh"

namespace cg = cooperative_groups;

// Mirrors ctypes struct `_LIOParams` in ops/lio_superblock_fused.py.
struct LioParams {
  P2PParams p2p;
  float q_rate[16];     // process-noise rates of the padded 16-state diagonal
  float meas_var[6];    // constant mode: icp stds^2; gn mode: the std floors^2
  float gps_chi2_gate;
  float gn_cov_scale;
  float superstep_slack;
  float slack_base;
  int cov_gn;           // icp_cov_mode == "gn"
  int gn_anchor_cov;
};

namespace {

constexpr float kG = 9.80665f;  // models/ekf.py GRAVITY

// Row of the 16-state for pose-measurement row a: (position, attitude).
__device__ __forceinline__ int pose_row(int a) { return a < 3 ? a : a + 3; }

struct LioShared {
  sfk::p2p::Shared g;  // GN transform and moments
  float P[256];        // the covariance: the carry, then the frame's working copy
  float F[256];        // the transition, then the Joseph factors
  float T1[256];       // product scratch
  float Kk[96];        // the pose gain (16 x 6), then the GPS gain (16 x 3)
  float KR[96];        // Kk Rm (16 x 6)
  float Rm[36];        // the pose measurement covariance
  float S_anchor[36];  // the block-start pose covariance
  // the state: carry (frame start) and the frame's working copy
  float p[3], v[3], R[9], bg[3], ba[3];
  float pw[3], vw[3], Rw[9];
  float acc_var;       // acc * var of the GPS update
  float acc;
};

// sum_k A[i][k] B[k][j], k = 0 .. l-1 in order; B has m columns.
__device__ __forceinline__ float dot_ab(const float* A, const float* B, int i, int j, int l,
                                        int m) {
  float s = A[i * l] * B[j];
  for (int k = 1; k < l; ++k) s = s + A[i * l + k] * B[k * m + j];
  return s;
}

// sum_k A[i][k] B[j][k], k = 0 .. l-1 in order.
__device__ __forceinline__ float dot_abt(const float* A, const float* B, int i, int j, int l) {
  float s = A[i * l] * B[j * l];
  for (int k = 1; k < l; ++k) s = s + A[i * l + k] * B[j * l + k];
  return s;
}

// Rotation of the Taylor-series SE(3) exp.
__device__ __forceinline__ void so3_exp(const float* phi, float* R) {
  const float zero[3] = {phi[0] * 0.0f, phi[0] * 0.0f, phi[0] * 0.0f};
  float t[3];
  sfk::p2p::se3_exp_taylor(zero, phi, R, t);
}

// Small-angle so3_log by the asin series (lio_superblock_fused.py:116-131).
__device__ void so3_log_small(const float* Re, float* out) {
  float s[3] = {0.5f * (Re[7] - Re[5]), 0.5f * (Re[2] - Re[6]), 0.5f * (Re[3] - Re[1])};
  const float m2 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2];
  const float fac =
      1.0f + m2 * ((float)(1.0 / 6.0) + m2 * ((float)(3.0 / 40.0) + m2 * (float)(15.0 / 336.0)));
  for (int a = 0; a < 3; ++a) out[a] = s[a] * fac;
}

// (6, 6) SPD inverse from six Cholesky solves of the lower triangle `tri`.
__device__ void inv6_cholesky(const float* tri, float* inv) {
  for (int e = 0; e < 6; ++e) {
    float b[6], x[6];
    for (int i = 0; i < 6; ++i) b[i] = i == e ? 1.0f : 0.0f;
    sfk::p2p::chol6_solve(tri, b, x);
    for (int i = 0; i < 6; ++i) inv[i * 6 + e] = x[i];
  }
}

__device__ __forceinline__ void skew(const float* v, float* K) {
  const float z = v[0] * 0.0f;
  K[0] = z;     K[1] = -v[2]; K[2] = v[1];
  K[3] = v[2];  K[4] = z;     K[5] = -v[0];
  K[6] = -v[1]; K[7] = v[0];  K[8] = z;
}

// Thread 0: one IMU sample's mean update, and F into S.F
// (lio_superblock_fused.py:427-461).
__device__ void imu_sample(LioShared& S, const float* gy, const float* ac, float d) {
  float w[3], f[3], a_w[3], wd[3], wmd[3], E[9], Em[9], Rn[9], Sf[9], RS[9];
  for (int a = 0; a < 3; ++a) {
    w[a] = gy[a] - S.bg[a];
    f[a] = ac[a] - S.ba[a];
  }
  sfk::mv3(S.Rw, f, a_w);
  a_w[0] = a_w[0] + d * 0.0f;
  a_w[1] = a_w[1] + d * 0.0f;
  a_w[2] = a_w[2] + (d * 0.0f - kG);
  const float h = 0.5f * d * d;
  for (int a = 0; a < 3; ++a) {
    wd[a] = w[a] * d;
    wmd[a] = w[a] * (-d);
  }
  so3_exp(wd, E);
  so3_exp(wmd, Em);
  skew(f, Sf);
  sfk::mm3(S.Rw, Sf, RS);
  float* F = S.F;
  for (int m = 0; m < 256; ++m) F[m] = (m % 17 == 0) ? 1.0f : 0.0f;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      const float eye = r == c ? 1.0f : 0.0f;
      F[r * 16 + 3 + c] = eye * d;
      F[(3 + r) * 16 + 6 + c] = RS[r * 3 + c] * (-d);
      F[(3 + r) * 16 + 12 + c] = S.Rw[r * 3 + c] * (-d);
      F[(6 + r) * 16 + 6 + c] = eye + (Em[r * 3 + c] - eye);
      F[(6 + r) * 16 + 9 + c] = eye * (-d);
    }
  sfk::mm3(S.Rw, E, Rn);
  for (int a = 0; a < 3; ++a) {
    S.pw[a] = S.pw[a] + S.vw[a] * d + h * a_w[a];
    S.vw[a] = S.vw[a] + a_w[a] * d;
  }
  for (int m = 0; m < 9; ++m) S.Rw[m] = Rn[m];
}

// Thread 0: the pose measurement, gain and mean update after the GN
// (lio_superblock_fused.py:479-549). Leaves Rm and Kk in shared memory and
// writes rmse, W, the *_std_used lanes into `st`.
__device__ void pose_update(LioShared& S, const LioParams& prm, const float* cx, float* st) {
  const float W = S.g.mom[27], wr2 = S.g.mom[28];
  const bool enough = W >= 3.0f;
  float R_meas[9], t_meas[3], t_reb[3], r6[6], Rt[9], Re[9];
  for (int m = 0; m < 9; ++m) R_meas[m] = enough ? S.g.R[m] : S.Rw[m];
  for (int a = 0; a < 3; ++a) {
    t_meas[a] = enough ? S.g.t[a] + cx[a] : S.pw[a];
    t_reb[a] = enough ? S.g.t[a] : S.pw[a] - cx[a];
    r6[a] = t_meas[a] - S.pw[a];
  }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) Rt[r * 3 + c] = S.Rw[c * 3 + r];
  sfk::mm3(Rt, R_meas, Re);
  so3_log_small(Re, r6 + 3);

  float* Rm = S.Rm;
  if (prm.cov_gn) {
    // sigma^2 (JtJ)^-1 from the UNDAMPED stats-pass moments, mapped from the
    // left-perturbation frame to (dp, dtheta_body): C = [[I, -[t]x], [0, R^T]]
    const float sigma2 = (wr2 / sfk::jmax(W - 6.0f, 1.0f)) * prm.gn_cov_scale;
    float tri[21], inv[36], Sg[36], C[36], CS[36], Kt[9];
    for (int a = 0; a < 6; ++a)
      for (int b = 0; b <= a; ++b)
        tri[a * (a + 1) / 2 + b] = S.g.mom[a * (a + 1) / 2 + b] + (a == b ? 1e-6f : 0.0f);
    inv6_cholesky(tri, inv);
    for (int m = 0; m < 36; ++m) Sg[m] = sigma2 * inv[m];
    skew(t_reb, Kt);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        C[r * 6 + c] = r == c ? 1.0f : 0.0f;
        C[r * 6 + 3 + c] = -Kt[r * 3 + c];
        C[(3 + r) * 6 + c] = 0.0f;
        C[(3 + r) * 6 + 3 + c] = R_meas[c * 3 + r];
      }
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) CS[i * 6 + j] = dot_ab(C, Sg, i, j, 6, 6);
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) {
        float x = dot_abt(CS, C, i, j, 6) + (i == j ? prm.meas_var[i] : 0.0f);
        if (prm.gn_anchor_cov) x = x + S.S_anchor[i * 6 + j];
        Rm[i * 6 + j] = x;
      }
  } else {
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) Rm[i * 6 + j] = i == j ? prm.meas_var[i] : 0.0f;
  }

  // S = H P H^T + Rm; K = P H^T S^-1; dx = K r
  float tri[21], S_inv[36], dx[16], R2[9], E[9];
  for (int a = 0; a < 6; ++a)
    for (int b = 0; b <= a; ++b)
      tri[a * (a + 1) / 2 + b] = S.P[pose_row(a) * 16 + pose_row(b)] + Rm[a * 6 + b];
  inv6_cholesky(tri, S_inv);
  for (int i = 0; i < 16; ++i)
    for (int a = 0; a < 6; ++a) {
      float s = S.P[i * 16 + pose_row(0)] * S_inv[a];
      for (int c = 1; c < 6; ++c) s = s + S.P[i * 16 + pose_row(c)] * S_inv[c * 6 + a];
      S.Kk[i * 6 + a] = s;
    }
  for (int i = 0; i < 16; ++i) dx[i] = dot_ab(S.Kk, r6, i, 0, 6, 1);
  so3_exp(dx + 6, E);
  sfk::mm3(S.Rw, E, R2);
  for (int a = 0; a < 3; ++a) {
    S.pw[a] = S.pw[a] + dx[a];
    S.vw[a] = S.vw[a] + dx[3 + a];
  }
  for (int m = 0; m < 9; ++m) S.Rw[m] = R2[m];
  // the biases: the carry's, stepped (they do not move during propagation)
  for (int a = 0; a < 3; ++a) {
    S.bg[a] = S.bg[a] + dx[9 + a];
    S.ba[a] = S.ba[a] + dx[12 + a];
  }
  st[0] = sqrtf(wr2 / sfk::jmax(W, 1.0f));
  st[1] = W;
  for (int a = 0; a < 3; ++a) st[6 + a] = sqrtf(sfk::jmax(Rm[a * 6 + a], 0.0f));
}

// Thread 0: the gated GPS update's gain and mean step
// (lio_superblock_fused.py:554-579), from P2 in S.P. Leaves K3 in S.Kk.
__device__ void gps_update(LioShared& S, const LioParams& prm, const float* z, float var,
                           bool gv, float* st) {
  float r3[3], S3[9], S3_inv[9], q3[3], dx3[16], phi[3], E[9], R3[9];
  for (int a = 0; a < 3; ++a) r3[a] = z[a] - S.pw[a];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) S3[r * 3 + c] = r == c ? S.P[r * 16 + c] + var : S.P[r * 16 + c];
  sfk::adjugate_transpose_over_det(S3, S3_inv);
  sfk::mv3(S3_inv, r3, q3);
  const float chi2 = r3[0] * q3[0] + r3[1] * q3[1] + r3[2] * q3[2];
  const float acc = (chi2 <= prm.gps_chi2_gate && gv) ? 1.0f : 0.0f;
  for (int i = 0; i < 16; ++i)
    for (int c = 0; c < 3; ++c) {
      float s = S.P[i * 16] * S3_inv[c];
      for (int b = 1; b < 3; ++b) s = s + S.P[i * 16 + b] * S3_inv[b * 3 + c];
      S.Kk[i * 3 + c] = s;
    }
  for (int i = 0; i < 16; ++i) dx3[i] = dot_ab(S.Kk, r3, i, 0, 3, 1);
  for (int a = 0; a < 3; ++a) phi[a] = acc * dx3[6 + a];
  so3_exp(phi, E);
  sfk::mm3(S.Rw, E, R3);
  for (int a = 0; a < 3; ++a) {
    S.pw[a] = S.pw[a] + acc * dx3[a];
    S.vw[a] = S.vw[a] + acc * dx3[3 + a];
    S.bg[a] = S.bg[a] + acc * dx3[9 + a];
    S.ba[a] = S.ba[a] + acc * dx3[12 + a];
  }
  for (int m = 0; m < 9; ++m) S.Rw[m] = R3[m];
  S.acc = acc;
  S.acc_var = acc * var;
  st[2] = acc * (gv ? 1.0f : 0.0f);
  st[3] = chi2;
}

__global__ void __launch_bounds__(1024, 1) lio_superblock_kernel(
    const int* __restrict__ pair_start,   // (K, nSt)
    const int* __restrict__ pair_cnt,     // (K, nSt)
    const int* __restrict__ pair_tgt,     // (K, max_pairs)
    const int* __restrict__ valid,        // (K,)
    const float* __restrict__ gyro,       // (K, Ki * 3)
    const float* __restrict__ accel,      // (K, Ki * 3)
    const float* __restrict__ dts,        // (K, Ki)
    const float* __restrict__ gps,        // (K, 3)
    const float* __restrict__ gps_var,    // (K,)
    const int* __restrict__ gps_valid,    // (K,)
    const float* __restrict__ pred_t,     // (K, 3) dead-reckoned translations
    const float* __restrict__ vec0,       // (9,) v, bg, ba
    const float* __restrict__ center,     // (3,) anchor rebase point
    const float* __restrict__ pose0,      // (4, 4)
    const float* __restrict__ P0,         // (16, 16)
    const float* __restrict__ src_pages,  // (K, nSt, 3, TM)
    const float* __restrict__ tgt_pages,  // (nTt, 6, TN)
    float* __restrict__ poses,            // (K, 4, 4)
    float* __restrict__ stats,            // (K, 128)
    float* __restrict__ state_pose,       // (4, 4)
    float* __restrict__ state_P,          // (16, 16)
    float* __restrict__ state_vec,        // (128,)
    float* __restrict__ best_d2,          // (nSt, 1, TM) scratch
    float* __restrict__ best_qn,          // (nSt, 6, TM) scratch
    float* slot_d2,                       // (max_pairs, TM) rounds' winners by slot
    int* slot_row,                        // (max_pairs, TM)
    sfk::grid::Ctl* ctl,                  // the leader's published round
    int K, int Ki, int nSt, int TM, int TN, int max_pairs, LioParams prm) {
  const cg::grid_group g = cg::this_grid();
  // frame k's round: its source pages and pair list
  auto round_of = [&](int k) {
    return sfk::grid::FirstRound{src_pages + (size_t)k * nSt * 3 * TM, tgt_pages,
                                 pair_start + (size_t)k * nSt, pair_cnt + (size_t)k * nSt,
                                 pair_tgt + (size_t)k * max_pairs, slot_d2, slot_row,
                                 nSt, TM, TN};
  };
  if (blockIdx.x != 0) {  // a worker: serve the leader's association rounds
    sfk::grid::serve(g, ctl, [&] {
      sfk::grid::scan_first<6>(round_of(sfk::grid::read_frame(ctl)), ctl);
    });
    return;
  }
  __shared__ float red[sfk::p2p::kNMom * 32];
  __shared__ LioShared S;
  const int tid = threadIdx.x;
  float cx[3] = {center[0], center[1], center[2]};

  for (int m = tid; m < 256; m += blockDim.x) S.P[m] = P0[m];
  if (tid == 0) {
    sfk::read44(pose0, S.R, S.p);
    for (int a = 0; a < 3; ++a) {
      S.v[a] = vec0[a];
      S.bg[a] = vec0[3 + a];
      S.ba[a] = vec0[6 + a];
    }
    for (int a = 0; a < 6; ++a)
      for (int b = 0; b < 6; ++b) S.S_anchor[a * 6 + b] = P0[pose_row(a) * 16 + pose_row(b)];
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    float* st = stats + (size_t)k * 128;
    for (int m = 9 + tid; m < 128; m += blockDim.x) st[m] = 0.0f;
    if (!valid[k]) {  // the state carries over; the frame reports zeros
      if (tid == 0) {
        sfk::pack44(S.R, S.p, 1.0f, poses + (size_t)k * 16);
        for (int m = 0; m < 9; ++m) st[m] = 0.0f;
      }
      continue;
    }
    if (tid == 0) {
      for (int a = 0; a < 3; ++a) {
        S.pw[a] = S.p[a];
        S.vw[a] = S.v[a];
      }
      for (int m = 0; m < 9; ++m) S.Rw[m] = S.R[m];
    }
    // 1) IMU propagation
    for (int j = 0; j < Ki; ++j) {
      const float d = dts[(size_t)k * Ki + j];
      if (tid == 0)
        imu_sample(S, gyro + ((size_t)k * Ki + j) * 3, accel + ((size_t)k * Ki + j) * 3, d);
      __syncthreads();
      for (int o = tid; o < 256; o += blockDim.x) S.T1[o] = dot_ab(S.F, S.P, o / 16, o % 16, 16, 16);
      __syncthreads();
      for (int o = tid; o < 256; o += blockDim.x) {
        const int i = o / 16, c = o % 16;
        S.P[o] = dot_abt(S.T1, S.F, i, c, 16) + (i == c ? prm.q_rate[i] : 0.0f) * d;
      }
      __syncthreads();
    }

    // 2) GN registration in the anchor-rebased frame
    float sd = 0.0f;
    bool viol = false;
    if (tid == 0) {
      float dp[3];
      for (int a = 0; a < 3; ++a) dp[a] = S.pw[a] - pred_t[k * 3 + a];
      sd = sqrtf(dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2]);
      viol = sd > prm.superstep_slack * (float)k + prm.slack_base;
      for (int m = 0; m < 9; ++m) S.g.R[m] = S.Rw[m];
      for (int a = 0; a < 3; ++a) S.g.t[a] = S.pw[a] - cx[a];
    }
    __syncthreads();
    const sfk::grid::FirstRound A = round_of(k);
    const sfk::p2p::Tiles T{A.src, best_d2, best_qn, nSt, TM, TN};
    sfk::p2p::grid_gn(g, ctl, k, S.g, T, A, prm.p2p, red);

    // 3) the pose update: gain and mean on thread 0, Joseph form by all
    if (tid == 0) pose_update(S, prm, cx, st);
    __syncthreads();
    for (int o = tid; o < 256; o += blockDim.x) {  // A = I - K H
      const int i = o / 16, c = o % 16;
      float ke = 0.0f;
      for (int a = 0; a < 6; ++a)
        if (pose_row(a) == c) ke = S.Kk[i * 6 + a];
      S.F[o] = (i == c ? 1.0f : 0.0f) - ke;
    }
    for (int o = tid; o < 96; o += blockDim.x) S.KR[o] = dot_ab(S.Kk, S.Rm, o / 6, o % 6, 6, 6);
    __syncthreads();
    for (int o = tid; o < 256; o += blockDim.x) S.T1[o] = dot_ab(S.F, S.P, o / 16, o % 16, 16, 16);
    __syncthreads();
    for (int o = tid; o < 256; o += blockDim.x)
      S.P[o] = dot_abt(S.T1, S.F, o / 16, o % 16, 16) + dot_abt(S.KR, S.Kk, o / 16, o % 16, 6);
    __syncthreads();

    // 4) the gated GPS update
    if (tid == 0) gps_update(S, prm, gps + k * 3, gps_var[k], gps_valid[k] != 0, st);
    __syncthreads();
    for (int o = tid; o < 256; o += blockDim.x) {  // A3 = I - acc K3 H3
      const int i = o / 16, c = o % 16;
      S.F[o] = (i == c ? 1.0f : 0.0f) - S.acc * (c < 3 ? S.Kk[i * 3 + c] : 0.0f);
    }
    __syncthreads();
    for (int o = tid; o < 256; o += blockDim.x) S.T1[o] = dot_ab(S.F, S.P, o / 16, o % 16, 16, 16);
    __syncthreads();
    for (int o = tid; o < 256; o += blockDim.x)
      S.P[o] = dot_abt(S.T1, S.F, o / 16, o % 16, 16) +
               S.acc_var * dot_abt(S.Kk, S.Kk, o / 16, o % 16, 3);

    // 5) the frame's posterior becomes the carry
    if (tid == 0) {
      for (int a = 0; a < 3; ++a) {
        S.p[a] = S.pw[a];
        S.v[a] = S.vw[a];
      }
      for (int m = 0; m < 9; ++m) S.R[m] = S.Rw[m];
      sfk::pack44(S.R, S.p, 1.0f, poses + (size_t)k * 16);
      st[4] = viol ? 1.0f : 0.0f;
      st[5] = sd;
    }
    __syncthreads();
  }
  sfk::grid::dismiss(g, ctl);

  for (int m = tid; m < 256; m += blockDim.x) state_P[m] = S.P[m];
  for (int m = 9 + tid; m < 128; m += blockDim.x) state_vec[m] = 0.0f;
  if (tid == 0) {
    sfk::pack44(S.R, S.p, 1.0f, state_pose);
    for (int a = 0; a < 3; ++a) {
      state_vec[a] = S.v[a];
      state_vec[3 + a] = S.bg[a];
      state_vec[6 + a] = S.ba[a];
    }
  }
}

inline bool bad_shape(int nSt, int TM, int K, int Ki) {
  return TM < 32 || TM > 4096 || TM % 32 || nSt < 1 || K < 1 || Ki < 0;
}

}  // namespace

// Enqueues K7 on `stream` as a cooperative grid; returns cudaGetLastError()
// (0 on success), the launch's error if the card refuses it, or
// cudaErrorInvalidValue for a tile width it does not take.
extern "C" int sfk_lio_superblock(
    const int* pair_start, const int* pair_cnt, const int* pair_tgt, const int* valid,
    const float* gyro, const float* accel, const float* dts, const float* gps,
    const float* gps_var, const int* gps_valid, const float* pred_t, const float* vec0,
    const float* center, const float* pose0, const float* P0, const float* src_pages,
    const float* tgt_pages, float* poses, float* stats, float* state_pose, float* state_P,
    float* state_vec, float* best_d2, float* best_qn, float* slot_d2, int* slot_row, void* ctl,
    int K, int Ki, int nSt, int TM, int TN, int max_pairs, const LioParams* prm,
    cudaStream_t stream) {
  if (bad_shape(nSt, TM, K, Ki)) return (int)cudaErrorInvalidValue;
  const int threads = sfk::grid::first_threads(nSt, TM);
  int blocks, per_sm;
  cudaError_t e = sfk::grid::grid_size((const void*)lio_superblock_kernel, threads, 0, &blocks,
                                       &per_sm);
  if (e != cudaSuccess) return (int)e;
  sfk::grid::Ctl* c = static_cast<sfk::grid::Ctl*>(ctl);
  LioParams p = *prm;
  void* args[] = {&pair_start, &pair_cnt, &pair_tgt, &valid, &gyro, &accel, &dts, &gps,
                  &gps_var, &gps_valid, &pred_t, &vec0, &center, &pose0, &P0, &src_pages,
                  &tgt_pages, &poses, &stats, &state_pose, &state_P, &state_vec, &best_d2,
                  &best_qn, &slot_d2, &slot_row, &c, &K, &Ki, &nSt, &TM, &TN, &max_pairs, &p};
  e = cudaLaunchCooperativeKernel((const void*)lio_superblock_kernel, dim3(blocks),
                                  dim3(threads), args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K7's cooperative grid for these tiles: blocks, threads a block and the
// blocks a multiprocessor could hold.
extern "C" int sfk_lio_grid(int nSt, int TM, int* blocks, int* threads, int* per_sm) {
  if (bad_shape(nSt, TM, 1, 0)) return (int)cudaErrorInvalidValue;
  *threads = sfk::grid::first_threads(nSt, TM);
  return (int)sfk::grid::grid_size((const void*)lio_superblock_kernel, *threads, 0, blocks,
                                   per_sm);
}

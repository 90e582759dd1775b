// K4, K5, K6: the whole-GN point-to-plane registration and its two halves.
//
// Replace the Pallas kernels of slam_sensor_fusion_tpu/ops/p2p_fused.py:
//   K4 `_make_p2p_kernel` (launched by `point_to_plane_align_fused`, the LIO
//      per-frame registration): association against 6-row target pages (xyz
//      + normal), the 29 Huber-weighted moments, an unrolled 6x6 Cholesky
//      solve, a Taylor SE(3) step with one polar polish, a FIXED number of
//      iterations and a trailing stats pass;
//   K5 `_make_assoc_kernel` (`associate_p2p_fused`): K4's association pass
//      alone at the prior; its winners are the outputs;
//   K6 `_make_gn_corr_kernel` (`p2p_gn_from_correspondences`): K4's GN on a
//      matched set given as input.
// Two device functions carry all three: `associate` writes each source
// point's best d2 and matched (x, y, z, nx, ny, nz) to a per-point buffer,
// `gn_drive` runs the iterations and the stats pass from that buffer.
// K4 = associate (once at the prior with fixed correspondences, else in
// every pass) + gn_drive; K5 = associate with the buffer as its output;
// K6 = gn_drive with the buffer as its input.
// Outputs of K4 and K6: T_out (4, 4) in the rebased frame and stats (128) =
// [rmse, W, iterations, 21 damped JtJ entries (row-major lower triangle),
// wr2, 0...], as the JAX kernels.
//
// What bounds them on an H100: K4 and K5 by the association's instruction
// issue. One pass walks every source tile's admitted target tiles, TM x TN
// direct-difference distances a pair (8 float operations and a compare
// each); at the LIO bench's shapes (16 source tiles of 512, target tiles of
// 1024, up to 256 pairs) that is ~10^8 distances a pass. K4 issues them from
// ONE SM: GN is a serial chain of passes around block-wide sums, and one
// block a launch is the simple, correct first design (1 of 132 SMs). K5 has
// no sums, so its launcher spreads the source tiles over blocks. K6 has no
// distances: it reads 10 floats a point a pass and is bound by its bytes and
// the latency of its serial scalar tail. Bytes never limit K4/K5: the target
// pages (32 x 24 KiB) stay in L2 and a warp reads one target row at a time
// as a broadcast.
//
// Design: a block of TM x G threads, G = min(nSt, 1024 / TM) groups; group g
// owns source tiles g, g + G, ... and thread r of a group owns point r of
// each of them. The matched set (7 floats a point: 224 KiB at 16 tiles of
// 512) is more than an SM's shared memory, so it lives in global buffers the
// wrapper allocates, in K5's output layout (d2 (nSt, 1, TM), qn (nSt, 6,
// TM)); each thread reads and writes only its own points, so it needs no
// barrier, and the buffers stay in L2. The association is icp_fused.cuh's
// `nearest_first` (K3's, with 6-row pages): first row within a tile, earlier
// tile across tiles. The 29 moment sums go through the fixed-order block
// reduction (no atomics: deterministic); the scalar tail (damping, Cholesky,
// starve guard, Taylor exp, polish, composition) runs on thread 0 in the
// JAX kernel's operation order, and the library builds with -fmad=false, so
// products and sums round op by op as in the plain versions
// (`_p2p_core_plain`, `_p2p_associate_plain`, `_p2p_gn_corr_plain`).
#include <cuda_runtime.h>

#include "icp_fused.cuh"

// Mirrors ctypes struct `_P2PParams` in ops/p2p_fused.py.
struct P2PParams {
  float gate;         // max_correspondence_dist_sq
  float huber_delta;  // Huber kernel width on the plane residual
  float damping;      // Levenberg damping on JtJ's diagonal
  int num_iterations;
  int fixed;          // associate once at the prior
};

namespace {

constexpr int kNMom = 29;  // 21 JtJ (lower triangle), 6 Jtr, W, wr2

struct Shared {
  // broadcast from thread 0 to the block
  float R[9];
  float t[3];
  float mom[kNMom];
};

struct Tiles {
  const float* src;  // (nSt, 3, TM) sensor-frame source pages
  const float* tgt;  // (nTt, 6, TN) rebased target pages: xyz + normal
  const int* ps;     // (nSt,) pair_start
  const int* pc;     // (nSt,) pair_cnt
  const int* pt;     // (max_pairs,) pair_tgt
  float* d2;         // (nSt, 1, TM) best squared distance
  float* qn;         // (nSt, 6, TM) matched point + normal
  int nSt, TM, TN;
};

// Associate under (R, t) the points of source tiles first, first + stride,
// ...; thread r of a tile's group owns its point r.
__device__ void associate(const float* R, const float* t, const Tiles& T, int first,
                          int stride) {
  const int r = threadIdx.x % T.TM;
  for (int i = first; i < T.nSt; i += stride) {
    const float* s = T.src + (size_t)i * 3 * T.TM;
    const float px = s[r], py = s[T.TM + r], pz = s[2 * T.TM + r];
    const float sx = R[0] * px + R[1] * py + R[2] * pz + t[0];
    const float sy = R[3] * px + R[4] * py + R[5] * pz + t[1];
    const float sz = R[6] * px + R[7] * py + R[8] * pz + t[2];
    const float* win;
    T.d2[(size_t)i * T.TM + r] =
        sfk::nearest_first<6>(T.tgt, T.pt, T.ps[i], T.pc[i], T.TN, sx, sy, sz, &win);
    float* o = T.qn + (size_t)i * 6 * T.TM + r;
#pragma unroll
    for (int k = 0; k < 6; ++k) o[k * T.TM] = win ? win[k * T.TN] : 0.0f;
  }
}

// The 29 moments under (S.R, S.t) on the matched set, into S.mom (every
// thread must call it): p2p_fused.py:254-303 without the damping.
__device__ void moments(Shared& S, const Tiles& T, const P2PParams& prm, float* red) {
  float R[9], t[3];
#pragma unroll
  for (int m = 0; m < 9; ++m) R[m] = S.R[m];
  t[0] = S.t[0]; t[1] = S.t[1]; t[2] = S.t[2];
  float v[kNMom];
#pragma unroll
  for (int m = 0; m < kNMom; ++m) v[m] = 0.0f;
  const int G = blockDim.x / T.TM;
  const int r = threadIdx.x % T.TM;
  for (int i = threadIdx.x / T.TM; i < T.nSt; i += G) {
    const float* s = T.src + (size_t)i * 3 * T.TM;
    const float sx = s[r], sy = s[T.TM + r], sz = s[2 * T.TM + r];
    const float px = R[0] * sx + R[1] * sy + R[2] * sz + t[0];
    const float py = R[3] * sx + R[4] * sy + R[5] * sz + t[1];
    const float pz = R[6] * sx + R[7] * sy + R[8] * sz + t[2];
    const float* q = T.qn + (size_t)i * 6 * T.TM + r;
    const float qx = q[0], qy = q[T.TM], qz = q[2 * T.TM];
    const float nx = q[3 * T.TM], ny = q[4 * T.TM], nz = q[5 * T.TM];
    const float d2 = T.d2[(size_t)i * T.TM + r];
    // invalid normals are stored as 0-vectors -> |n|^2 < 0.5
    const float w_in =
        (d2 < prm.gate && nx * nx + ny * ny + nz * nz > 0.5f) ? 1.0f : 0.0f;
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
  sfk::block_sum<kNMom>(v, red, S.mom);
}

// Solve (6x6 SPD) A x = b by unrolled Cholesky, pivots floored at
// sqrt(1e-12) (p2p_fused.py:64-95). `tri` is A's row-major lower triangle.
__device__ void chol6_solve(const float* tri, const float* b, float* x) {
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
__device__ void se3_exp_taylor(const float* rho, const float* phi, float* R, float* t) {
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

// The GN iterations and the stats pass from the matched set (every thread
// must call it): p2p_fused.py:325-374. With `fresh`, every pass associates
// first under the current transform. Thread 0 writes the outputs.
__device__ void gn_drive(Shared& S, const Tiles& T, const P2PParams& prm, bool fresh,
                         float* red, float* T_out, float* stats) {
  const int G = blockDim.x / T.TM;
  for (int it = 0; it <= prm.num_iterations; ++it) {
    if (fresh) associate(S.R, S.t, T, threadIdx.x / T.TM, G);
    moments(S, T, prm, red);
    if (threadIdx.x == 0) {
      float tri[21];
      for (int k = 0; k < 21; ++k) tri[k] = S.mom[k];
      // damping goes on the diagonal after the reduction
      for (int a = 0; a < 6; ++a) tri[a * (a + 1) / 2 + a] = tri[a * (a + 1) / 2 + a] + prm.damping;
      const float W = S.mom[27], wr2 = S.mom[28];
      if (it < prm.num_iterations) {
        float x[6], rho[3], phi[3], R_step[9], t_step[3], R_inv[9], Rn[9], v[3];
        chol6_solve(tri, S.mom + 21, x);
        // a starved frame must not step
        const float ok = W >= 3.0f ? 1.0f : 0.0f;
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
      } else {  // the stats pass: moments at the final transform, no step
        sfk::pack44(S.R, S.t, 1.0f, T_out);
        stats[0] = sqrtf(wr2 / sfk::jmax(W, 1.0f));
        stats[1] = W;
        stats[2] = (float)prm.num_iterations;
        for (int k = 0; k < 21; ++k) stats[3 + k] = tri[k];
        stats[24] = wr2;
        for (int m = 25; m < 128; ++m) stats[m] = 0.0f;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(1024, 1) p2p_fused_kernel(
    const float* __restrict__ src_pages,  // (nSt, 3, TM)
    const float* __restrict__ tgt_pages,  // (nTt, 6, TN)
    const int* __restrict__ pair_start,   // (nSt,)
    const int* __restrict__ pair_cnt,     // (nSt,)
    const int* __restrict__ pair_tgt,     // (max_pairs,)
    const float* __restrict__ T0,         // (4, 4) rebased prior
    float* __restrict__ T_out,            // (4, 4)
    float* __restrict__ stats,            // (128,)
    float* __restrict__ best_d2,          // (nSt, 1, TM) scratch
    float* __restrict__ best_qn,          // (nSt, 6, TM) scratch
    int nSt, int TM, int TN, P2PParams prm) {
  __shared__ float red[kNMom * 32];
  __shared__ Shared S;
  const Tiles T{src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt,
                best_d2, best_qn, nSt, TM, TN};
  if (threadIdx.x == 0) sfk::read44(T0, S.R, S.t);
  __syncthreads();
  if (prm.fixed) associate(S.R, S.t, T, threadIdx.x / TM, blockDim.x / TM);
  gn_drive(S, T, prm, !prm.fixed, red, T_out, stats);
}

__global__ void __launch_bounds__(1024, 1) p2p_associate_kernel(
    const float* __restrict__ src_pages, const float* __restrict__ tgt_pages,
    const int* __restrict__ pair_start, const int* __restrict__ pair_cnt,
    const int* __restrict__ pair_tgt, const float* __restrict__ T0,
    float* __restrict__ best_d2,  // (nSt, 1, TM) out
    float* __restrict__ best_qn,  // (nSt, 6, TM) out
    int nSt, int TM, int TN) {
  const Tiles T{src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt,
                best_d2, best_qn, nSt, TM, TN};
  float R[9], t[3];
  sfk::read44(T0, R, t);
  // no sums follow, so the source tiles spread over the grid's blocks
  const int G = blockDim.x / TM;
  associate(R, t, T, blockIdx.x * G + threadIdx.x / TM, gridDim.x * G);
}

__global__ void __launch_bounds__(1024, 1) p2p_gn_corr_kernel(
    const float* __restrict__ T0,         // (4, 4) rebased prior
    const float* __restrict__ src_pages,  // (nSt, 3, TM)
    const float* __restrict__ best_d2,    // (nSt, 1, TM) in
    const float* __restrict__ best_qn,    // (nSt, 6, TM) in
    float* __restrict__ T_out, float* __restrict__ stats, int nSt, int TM,
    P2PParams prm) {
  __shared__ float red[kNMom * 32];
  __shared__ Shared S;
  const Tiles T{src_pages, nullptr, nullptr, nullptr, nullptr,
                const_cast<float*>(best_d2), const_cast<float*>(best_qn), nSt, TM, 0};
  if (threadIdx.x == 0) sfk::read44(T0, S.R, S.t);
  __syncthreads();
  gn_drive(S, T, prm, false, red, T_out, stats);
}

// Threads of one block: TM a source tile, as many tiles side by side as fit.
inline int groups(int nSt, int TM) { return nSt < 1024 / TM ? nSt : 1024 / TM; }

inline bool bad_tiles(int nSt, int TM) {
  return TM < 32 || TM > 1024 || TM % 32 || nSt < 1;
}

}  // namespace

// Each launcher enqueues its kernel on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a tile
// width it does not take.

extern "C" int sfk_p2p_fused(const float* src_pages, const float* tgt_pages,
                             const int* pair_start, const int* pair_cnt,
                             const int* pair_tgt, const float* T0, float* T_out,
                             float* stats, float* best_d2, float* best_qn, int nSt,
                             int TM, int TN, const P2PParams* prm, cudaStream_t stream) {
  if (bad_tiles(nSt, TM)) return (int)cudaErrorInvalidValue;
  p2p_fused_kernel<<<1, TM * groups(nSt, TM), 0, stream>>>(
      src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0, T_out, stats, best_d2,
      best_qn, nSt, TM, TN, *prm);
  return (int)cudaGetLastError();
}

extern "C" int sfk_p2p_associate(const float* src_pages, const float* tgt_pages,
                                 const int* pair_start, const int* pair_cnt,
                                 const int* pair_tgt, const float* T0, float* best_d2,
                                 float* best_qn, int nSt, int TM, int TN,
                                 cudaStream_t stream) {
  if (bad_tiles(nSt, TM)) return (int)cudaErrorInvalidValue;
  const int G = groups(nSt, TM);
  p2p_associate_kernel<<<(nSt + G - 1) / G, TM * G, 0, stream>>>(
      src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt, T0, best_d2, best_qn, nSt, TM,
      TN);
  return (int)cudaGetLastError();
}

extern "C" int sfk_p2p_gn_corr(const float* T0, const float* src_pages,
                               const float* best_d2, const float* best_qn, float* T_out,
                               float* stats, int nSt, int TM, const P2PParams* prm,
                               cudaStream_t stream) {
  if (bad_tiles(nSt, TM)) return (int)cudaErrorInvalidValue;
  p2p_gn_corr_kernel<<<1, TM * groups(nSt, TM), 0, stream>>>(
      T0, src_pages, best_d2, best_qn, T_out, stats, nSt, TM, *prm);
  return (int)cudaGetLastError();
}

// Shared device helpers for the registration kernels K1, K3 and K4-K6: the
// 3x3 register math of slam_sensor_fusion_tpu/ops/icp_fused.py:56-128
// (_adjugate_transpose_over_det, _mv3, _mm3, _newton_polar) and its Kabsch
// step (:285-295), the rigid-transform helpers of
// ops/superblock_fused.py:62-102, the tile-major first-row association of
// K3 and K4 and a deterministic block reduction that stands in for _sum_all.
//
// Matrices are row-major float[9]; translations float[3]. Every expression
// keeps the JAX package's operand order, and the library is compiled with
// -fmad=false, so products and sums round exactly as the plain PyTorch
// versions do (no fused multiply-add contraction).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sfk {

constexpr float kBig = 3.0e38f;

// jnp.minimum / jnp.maximum propagate NaN; fminf/fmaxf drop it.
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// o = M @ v
__device__ __forceinline__ void mv3(const float* M, const float* v, float* o) {
  float r0 = M[0] * v[0] + M[1] * v[1] + M[2] * v[2];
  float r1 = M[3] * v[0] + M[4] * v[1] + M[5] * v[2];
  float r2 = M[6] * v[0] + M[7] * v[1] + M[8] * v[2];
  o[0] = r0;
  o[1] = r1;
  o[2] = r2;
}

// C = A @ B (C may alias neither A nor B)
__device__ __forceinline__ void mm3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      C[r * 3 + c] =
          A[r * 3 + 0] * B[c] + A[r * 3 + 1] * B[3 + c] + A[r * 3 + 2] * B[6 + c];
}

// X^{-T} = cofactor(X) / det(X); returns det.
__device__ __forceinline__ float adjugate_transpose_over_det(const float* X,
                                                             float* out) {
  const float a = X[0], b = X[1], c = X[2];
  const float d = X[3], e = X[4], f = X[5];
  const float g = X[6], h = X[7], i = X[8];
  const float A = e * i - f * h;
  const float B = f * g - d * i;
  const float C = d * h - e * g;
  const float D = c * h - b * i;
  const float E = a * i - c * g;
  const float F = b * g - a * h;
  const float G = b * f - c * e;
  const float H = c * d - a * f;
  const float I = a * e - b * d;
  const float det = a * A + b * B + c * C;
  out[0] = A / det; out[1] = B / det; out[2] = C / det;
  out[3] = D / det; out[4] = E / det; out[5] = F / det;
  out[6] = G / det; out[7] = H / det; out[8] = I / det;
  return det;
}

// Orthogonal polar factor of H by 8 Newton steps X <- (X + X^-T) / 2.
// Returns ok = |det(X0)| > 1e-6 and every entry of R finite.
__device__ inline bool newton_polar(const float* H, float* R) {
  float ss = 0.0f;
#pragma unroll
  for (int m = 0; m < 9; ++m) ss = ss + H[m] * H[m];
  const float nrm = sqrtf(jmax(ss, 1e-20f));
  float X[9], Xi[9];
#pragma unroll
  for (int m = 0; m < 9; ++m) X[m] = H[m] / nrm;
  const float det0 = adjugate_transpose_over_det(X, Xi);
  const bool ok = fabsf(det0) > 1e-6f;
  for (int s = 0; s < 8; ++s) {
    const float det = adjugate_transpose_over_det(X, Xi);
    if (fabsf(det) > 1e-12f) {
#pragma unroll
      for (int m = 0; m < 9; ++m) X[m] = 0.5f * (X[m] + Xi[m]);
    }
  }
  bool finite = true;
#pragma unroll
  for (int m = 0; m < 9; ++m) {
    R[m] = X[m];
    finite = finite && isfinite(X[m]);
  }
  return ok && finite;
}

// (Ri, ti) = rigid inverse of (R, t): R^T, -(R^T t)
__device__ __forceinline__ void inv_rigid(const float* R, const float* t,
                                          float* Ri, float* ti) {
  Ri[0] = R[0]; Ri[1] = R[3]; Ri[2] = R[6];
  Ri[3] = R[1]; Ri[4] = R[4]; Ri[5] = R[7];
  Ri[6] = R[2]; Ri[7] = R[5]; Ri[8] = R[8];
  float v[3];
  mv3(Ri, t, v);
  ti[0] = -v[0];
  ti[1] = -v[1];
  ti[2] = -v[2];
}

// (Rc, tc) = (Ra, ta) @ (Rb, tb)
__device__ __forceinline__ void compose(const float* Ra, const float* ta,
                                        const float* Rb, const float* tb,
                                        float* Rc, float* tc) {
  mm3(Ra, Rb, Rc);
  float v[3];
  mv3(Ra, tb, v);
  tc[0] = v[0] + ta[0];
  tc[1] = v[1] + ta[1];
  tc[2] = v[2] + ta[2];
}

// Split / pack a row-major 4x4.
__device__ __forceinline__ void read44(const float* T, float* R, float* t) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) R[r * 3 + c] = T[r * 4 + c];
    t[r] = T[r * 4 + 3];
  }
}
__device__ __forceinline__ void pack44(const float* R, const float* t,
                                       float scale, float* T) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) T[r * 4 + c] = scale * R[r * 3 + c];
    T[r * 4 + 3] = scale * t[r];
  }
  T[12] = 0.0f * scale;
  T[13] = 0.0f * scale;
  T[14] = 0.0f * scale;
  T[15] = scale;
}

// Kabsch step from the 17 moments [W, Ss(3), St(3), Mst(9), Eabs]
// (icp_fused.py:285-295): R_step = polar(H^T) by Newton, t_step = c_t -
// R_step c_s; detH = det(H). Returns the polar factor's ok flag.
__device__ inline bool solve_step(const float* mom, float* R_step, float* t_step,
                                  float* detH) {
  const float W = mom[0];
  const float Wc = jmax(W, 1.0f);
  float c_s[3], c_t[3], Hm[9], HmT[9], adj[9];
  for (int a = 0; a < 3; ++a) {
    c_s[a] = mom[1 + a] / Wc;
    c_t[a] = mom[4 + a] / Wc;
  }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) Hm[3 * a + b] = mom[7 + 3 * a + b] - W * (c_s[a] * c_t[b]);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) HmT[3 * a + b] = Hm[3 * b + a];
  const bool ok = newton_polar(HmT, R_step);
  *detH = adjugate_transpose_over_det(Hm, adj);
  float v[3];
  mv3(R_step, c_s, v);
  for (int a = 0; a < 3; ++a) t_step[a] = c_t[a] - v[a];
  return ok;
}

// (R, t) <- (R_step R, R_step t + t_step) unless `stop`.
__device__ inline void apply_step(float* R, float* t, const float* R_step,
                                  const float* t_step, bool stop) {
  if (stop) return;
  float Rn[9], v[3];
  mm3(R_step, R, Rn);
  mv3(R_step, t, v);
  for (int m = 0; m < 9; ++m) R[m] = Rn[m];
  for (int a = 0; a < 3; ++a) t[a] = v[a] + t_step[a];
}

// What one ICP reports: the last mean error, the correspondence count,
// the steps taken and the smallest det(H) seen.
struct IcpOut {
  float err;
  int n_corr;
  int iters;
  float det_min;
};

// Tile-major nearest neighbour of the transformed source point (sx, sy, sz)
// over its admitted target tiles pt[start .. start + cnt), pages of ROWS
// rows by TN columns (rows 0-2 are x, y, z; K4's rows 3-5 the normal):
// direct-difference distances and a running strict `<` in visit order, which
// keeps the FIRST row of an exact d2 tie within a tile and the earlier tile
// across tiles (icp_fused.py:205-214, p2p_fused.py:180-194: argmin, then a
// strict `<`). Returns the best d2 (kBig when nothing was admitted) and
// leaves in *win the address of the winner's x, or nullptr; its row k is
// (*win)[k * TN]. The TPU kernels fetch the winner by a one-hot product,
// which is this gather exactly (1.0 * x plus zeros; the sentinels are finite).
// A warp reads the same four target rows at a time as one 16-byte broadcast
// load a coordinate (the pages are 16-byte aligned when TN is a multiple of
// 4; other widths take the scalar loop). bench/assoc_variants.cu times this
// loop against its scalar-load forms: on an H100 the 16-byte form is the
// fastest, and scalar loads that carry the winner's row run at half the rate
// of scalar loads that carry its coordinates.
template <int ROWS>
__device__ __forceinline__ float nearest_first(const float* __restrict__ tgt,
                                               const int* __restrict__ pt, int start,
                                               int cnt, int TN, float sx, float sy,
                                               float sz, const float** win) {
  float best = kBig;
  const float* w = nullptr;
  const int n4 = (TN % 4 == 0) ? TN / 4 : 0;
  for (int q = 0; q < cnt; ++q) {
    const float* tx = tgt + (size_t)pt[start + q] * ROWS * TN;
    const float* ty = tx + TN;
    const float* tz = tx + 2 * TN;
    const float4* x4 = reinterpret_cast<const float4*>(tx);
    const float4* y4 = reinterpret_cast<const float4*>(ty);
    const float4* z4 = reinterpret_cast<const float4*>(tz);
    int hit = -1;  // the winning row of this tile, if it beats the best so far
#pragma unroll 2
    for (int c = 0; c < n4; ++c) {
      const float4 X = __ldg(x4 + c), Y = __ldg(y4 + c), Z = __ldg(z4 + c);
      const float xs[4] = {X.x, X.y, X.z, X.w};
      const float ys[4] = {Y.x, Y.y, Y.z, Y.w};
      const float zs[4] = {Z.x, Z.y, Z.z, Z.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float dx = xs[u] - sx;
        const float dy = ys[u] - sy;
        const float dz = zs[u] - sz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best) {
          best = d2;
          hit = 4 * c + u;
        }
      }
    }
    for (int c = 4 * n4; c < TN; ++c) {
      const float dx = __ldg(tx + c) - sx;
      const float dy = __ldg(ty + c) - sy;
      const float dz = __ldg(tz + c) - sz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < best) {
        best = d2;
        hit = c;
      }
    }
    if (hit >= 0) w = tx + hit;
  }
  *win = w;
  return best;
}

// Deterministic block sum of NV per-thread values: a fixed shuffle tree per
// warp, then warp partials summed in warp order. blockDim.x must be a
// multiple of 32 and at most 1024. `red` holds NV * 32 floats; the sums land
// in out[0..NV). Every thread must call it.
template <int NV>
__device__ inline void block_sum(const float (&v)[NV], float* red, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    float x = v[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[m * 32 + warp] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += red[threadIdx.x * 32 + w];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

}  // namespace sfk

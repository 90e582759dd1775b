// K2: pair-list gated nearest-neighbour search.
//
// Replaces the Pallas kernel slam_sensor_fusion_tpu/ops/nn_pallas.py
// `_make_kernel` (launched by `pair_nn`), which the rescue ICP
// (ops/icp.py `_icp_pallas`) runs for every association.
//
// What bounds it on an H100: per admitted (source tile, target tile) pair it
// evaluates TM x TN distances at ~10 float instructions each and reads one
// 3 x TN target page (6 KiB at TN = 512) that stays L2-resident; at the
// startup rescue's size (1024 source points in 4 tiles, 16 target tiles)
// it is a few hundred microseconds of FP32 issue on 4 SMs, i.e. bound by
// having only nSt blocks, not by bytes.
//
// Design: one block per source tile, one thread per source point, walking
// that tile's run of the TILE-MAJOR pair list (pair_start/pair_cnt/pair_tgt,
// the list K1 uses too; the JAX kernel walked a pair-major list with the same
// per-tile visit order, so outputs are unchanged). Each target page is
// staged once into shared memory as (x, y, z, |t|^2) and every thread scans
// it with a running (min, first argmin, winner coords) in registers. A
// tile wider than 1024 rows takes pair_nn_wide_kernel, the same scan with
// the tile's rows spread over ceil(TM / 1024) blocks; each row's result
// depends on its row alone, so the split gives the bits one block would.
// Tiles of up to 1024 rows keep the one-block kernel: the shared form with
// a row offset compiled to a slower scan.
// Distances use the JAX kernel's EXPANDED form, (|t|^2 - 2 t.s) + |s|^2
// (nn_pallas.py:133-140), not the direct difference; a strict `<` keeps the
// first row within a tile and the earlier tile across tiles; d2 is clamped
// at 0 on output (nn_pallas.py:229). The three K=3 dot products are the
// fused multiply-add chain fma(z, z', fma(y, y', x * x')), which is how XLA
// evaluates the JAX kernel's contractions (the cancellation in the expanded
// form makes d2 of near points sensitive to every rounding); everything else
// rounds op by op (-fmad=false), as the plain version `pair_nn_plain` does.
#include <cuda_runtime.h>

#include "icp_fused.cuh"

namespace {

// a.b as fma(az, bz, fma(ay, by, ax * bx))
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, ax * bx));
}

__global__ void pair_nn_kernel(const float* __restrict__ src,   // (nSt, 3, TM)
                               const float* __restrict__ tgt,   // (nTt, 3, TN)
                               const int* __restrict__ pair_start,  // (nSt,)
                               const int* __restrict__ pair_cnt,    // (nSt,)
                               const int* __restrict__ pair_tgt,    // (max_pairs,)
                               int TN,
                               float* __restrict__ d2_out,   // (nSt, 1, TM)
                               int* __restrict__ idx_out,    // (nSt, 1, TM)
                               float* __restrict__ xyz_out)  // (nSt, 3, TM)
{
  extern __shared__ float4 page[];  // TN x (x, y, z, |t|^2)
  const int TM = blockDim.x;
  const int i = blockIdx.x;
  const int r = threadIdx.x;
  const float* s = src + (size_t)i * 3 * TM;
  const float sx = s[r], sy = s[TM + r], sz = s[2 * TM + r];
  const float s_norm = dot3(sx, sy, sz, sx, sy, sz);

  float best = sfk::kBig, bx = 0.0f, by = 0.0f, bz = 0.0f;
  int bidx = 0;
  const int start = pair_start[i];
  const int cnt = pair_cnt[i];
  for (int q = 0; q < cnt; ++q) {
    const int j = pair_tgt[start + q];
    const float* t = tgt + (size_t)j * 3 * TN;
    __syncthreads();  // previous page fully consumed
    for (int c = r; c < TN; c += TM) {
      const float x = t[c], y = t[TN + c], z = t[2 * TN + c];
      page[c] = make_float4(x, y, z, dot3(x, y, z, x, y, z));
    }
    __syncthreads();
    for (int c = 0; c < TN; ++c) {
      const float4 p = page[c];
      const float cross = dot3(p.x, p.y, p.z, sx, sy, sz);
      const float d2 = (p.w - 2.0f * cross) + s_norm;
      if (d2 < best) {
        best = d2;
        bidx = c + j * TN;
        bx = p.x;
        by = p.y;
        bz = p.z;
      }
    }
  }
  const size_t o = (size_t)i * TM + r;
  d2_out[o] = sfk::jmax(best, 0.0f);
  idx_out[o] = bidx;
  xyz_out[(size_t)i * 3 * TM + r] = bx;
  xyz_out[(size_t)i * 3 * TM + TM + r] = by;
  xyz_out[(size_t)i * 3 * TM + 2 * TM + r] = bz;
}

// pair_nn_kernel for a tile wider than a block: its rows spread over
// gridDim.y blocks of blockDim.x threads, each staging the same pages.
__global__ void pair_nn_wide_kernel(const float* __restrict__ src,   // (nSt, 3, TM)
                                    const float* __restrict__ tgt,   // (nTt, 3, TN)
                                    const int* __restrict__ pair_start,  // (nSt,)
                                    const int* __restrict__ pair_cnt,    // (nSt,)
                                    const int* __restrict__ pair_tgt,    // (max_pairs,)
                                    int TM, int TN,
                                    float* __restrict__ d2_out,   // (nSt, 1, TM)
                                    int* __restrict__ idx_out,    // (nSt, 1, TM)
                                    float* __restrict__ xyz_out)  // (nSt, 3, TM)
{
  extern __shared__ float4 page[];  // TN x (x, y, z, |t|^2)
  const int i = blockIdx.x;
  const int r = blockIdx.y * blockDim.x + threadIdx.x;
  const bool row = r < TM;  // the last block of a wide tile may run past it
  const float* s = src + (size_t)i * 3 * TM;
  const float sx = row ? s[r] : 0.0f;
  const float sy = row ? s[TM + r] : 0.0f;
  const float sz = row ? s[2 * TM + r] : 0.0f;
  const float s_norm = dot3(sx, sy, sz, sx, sy, sz);

  float best = sfk::kBig, bx = 0.0f, by = 0.0f, bz = 0.0f;
  int bidx = 0;
  const int start = pair_start[i];
  const int cnt = pair_cnt[i];
  for (int q = 0; q < cnt; ++q) {
    const int j = pair_tgt[start + q];
    const float* t = tgt + (size_t)j * 3 * TN;
    __syncthreads();  // previous page fully consumed
    for (int c = threadIdx.x; c < TN; c += blockDim.x) {
      const float x = t[c], y = t[TN + c], z = t[2 * TN + c];
      page[c] = make_float4(x, y, z, dot3(x, y, z, x, y, z));
    }
    __syncthreads();
    for (int c = 0; c < TN; ++c) {
      const float4 p = page[c];
      const float cross = dot3(p.x, p.y, p.z, sx, sy, sz);
      const float d2 = (p.w - 2.0f * cross) + s_norm;
      if (d2 < best) {
        best = d2;
        bidx = c + j * TN;
        bx = p.x;
        by = p.y;
        bz = p.z;
      }
    }
  }
  if (!row) return;
  const size_t o = (size_t)i * TM + r;
  d2_out[o] = sfk::jmax(best, 0.0f);
  idx_out[o] = bidx;
  xyz_out[(size_t)i * 3 * TM + r] = bx;
  xyz_out[(size_t)i * 3 * TM + TM + r] = by;
  xyz_out[(size_t)i * 3 * TM + 2 * TM + r] = bz;
}

}  // namespace

// Launch K2 on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int sfk_pair_nn(const float* src, const float* tgt,
                           const int* pair_start, const int* pair_cnt,
                           const int* pair_tgt, int nSt, int TM, int TN,
                           float* d2, int* idx, float* xyz, cudaStream_t stream) {
  const size_t smem = (size_t)TN * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_nn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (TM > 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_nn_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    pair_nn_wide_kernel<<<dim3(nSt, (TM + 1023) / 1024), 1024, smem, stream>>>(
        src, tgt, pair_start, pair_cnt, pair_tgt, TM, TN, d2, idx, xyz);
  } else {
    pair_nn_kernel<<<nSt, TM, smem, stream>>>(src, tgt, pair_start, pair_cnt,
                                              pair_tgt, TN, d2, idx, xyz);
  }
  return (int)cudaGetLastError();
}

// K2: pair-list gated nearest-neighbour search.
//
// Replaces the Pallas kernel slam_sensor_fusion_tpu/ops/nn_pallas.py
// `_make_kernel` (launched by `pair_nn`), which the rescue ICP
// (ops/icp.py `_icp_pallas`) runs for every association.
//
// What bounds it on an H100: per admitted (source tile, target tile) pair it
// evaluates TM x TN distances at ~11 float instructions each and reads one
// 3 x TN target page (6 KiB at TN = 512) that stays L2-resident; at the
// startup rescue's size (1024 source points in 4 tiles, 16 target tiles)
// that is a few microseconds of FP32 issue on the whole card, so latency
// (one thread walks a whole target tile) and the launches bound it.
//
// Design: two ordinary launches on the stream, no grid barrier (K2 has no
// serial chain).
//   1. The scan spreads the items of the TILE-MAJOR pair list (pair_start /
//      pair_cnt / pair_tgt, the list K1 uses too: item j is (source tile i,
//      admitted pair slot s), tiles in order, slots in order) over every SM:
//      an item is cut into warps of 32 source rows, and warp w of the
//      launch takes the item-warps w, w + W, ..., numbered so that
//      neighbouring item-warps land in different blocks. Each thread scans
//      the slot's one target tile for its source row from L2 (16-byte loads
//      where the page allows) and writes the tile's unclamped minimum and
//      its FIRST winning row (strict `<` from kBig) to per-slot scratch
//      (max_pairs, TM). Every width up to ops/cuda_lib.MAX_TILE_SRC takes
//      this one kernel.
//   2. The combine gives each source row its slots in slot order under a
//      strict `<` from kBig (grid_assoc.cuh's `combine`), so the earlier
//      tile keeps an exact tie and a tile whose minimum is kBig never wins:
//      the running walk of the one-block kernel that came before, bit for
//      bit. It clamps d2 at 0 (nn_pallas.py:229) and writes d2, the winner's
//      flat index and its xyz; a row with no winner (no admitted pair)
//      keeps d2 kBig, idx 0 and xyz 0.
// The JAX kernel walked a pair-major list with the same per-tile visit
// order, so outputs are unchanged. Each slot belongs to at most one source
// tile, as `_build_tile_pair_list` builds the list.
// Distances use the JAX kernel's EXPANDED form, (|t|^2 - 2 t.s) + |s|^2
// (nn_pallas.py:133-140), not the direct difference. The three K=3 dot
// products are the fused multiply-add chain fma(z, z', fma(y, y', x * x')),
// which is how XLA evaluates the JAX kernel's contractions (the
// cancellation in the expanded form makes d2 of near points sensitive to
// every rounding); everything else rounds op by op (-fmad=false), as the
// plain version `pair_nn_plain` does.
#include <cuda_runtime.h>

#include <stdint.h>

#include "grid_assoc.cuh"

namespace {

constexpr int kScanThreads = 128;
constexpr int kCombineThreads = 256;

// a.b as fma(az, bz, fma(ay, by, ax * bx))
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, ax * bx));
}

// The expanded-form d2 of target row (x, y, z) against source s.
__device__ __forceinline__ float expanded_d2(float x, float y, float z, float sx, float sy,
                                             float sz, float s_norm) {
  const float cross = dot3(x, y, z, sx, sy, sz);
  return (dot3(x, y, z, x, y, z) - 2.0f * cross) + s_norm;
}

__global__ void __launch_bounds__(kScanThreads) pair_nn_scan_kernel(
    const float* __restrict__ src,         // (nSt, 3, TM)
    const float* __restrict__ tgt,         // (nTt, 3, TN)
    const int* __restrict__ pair_start,    // (nSt,)
    const int* __restrict__ pair_cnt,      // (nSt,)
    const int* __restrict__ pair_tgt,      // (max_pairs,)
    int nSt, int TM, int TN, int vec4,
    float* __restrict__ slot_d2,           // (max_pairs, TM) a tile's minimum
    int* __restrict__ slot_row)            // (max_pairs, TM) its first row, -1 for none
{
  const int n = sfk::grid::n_items(pair_cnt, nSt);
  const int wpi = (TM + 31) / 32;  // warps an item
  const int lane = threadIdx.x % 32;
  const int W = gridDim.x * (blockDim.x / 32);
  for (int tw = (threadIdx.x / 32) * gridDim.x + blockIdx.x; tw < n * wpi; tw += W) {
    const int r = (tw % wpi) * 32 + lane;
    if (r >= TM) continue;
    int s;
    const int i = sfk::grid::item_at(tw / wpi, pair_start, pair_cnt, &s);
    const float* sp = src + (size_t)i * 3 * TM;
    const float sx = sp[r], sy = sp[TM + r], sz = sp[2 * TM + r];
    const float s_norm = dot3(sx, sy, sz, sx, sy, sz);
    const float* tx = tgt + (size_t)pair_tgt[s] * 3 * TN;
    const float* ty = tx + TN;
    const float* tz = tx + 2 * TN;
    float best = sfk::kBig;
    int hit = -1;
    const int n4 = vec4 ? TN / 4 : 0;
    const float4* x4 = reinterpret_cast<const float4*>(tx);
    const float4* y4 = reinterpret_cast<const float4*>(ty);
    const float4* z4 = reinterpret_cast<const float4*>(tz);
#pragma unroll 2
    for (int c = 0; c < n4; ++c) {
      const float4 X = __ldg(x4 + c), Y = __ldg(y4 + c), Z = __ldg(z4 + c);
      const float xs[4] = {X.x, X.y, X.z, X.w};
      const float ys[4] = {Y.x, Y.y, Y.z, Y.w};
      const float zs[4] = {Z.x, Z.y, Z.z, Z.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float d2 = expanded_d2(xs[u], ys[u], zs[u], sx, sy, sz, s_norm);
        if (d2 < best) {
          best = d2;
          hit = 4 * c + u;
        }
      }
    }
    for (int c = 4 * n4; c < TN; ++c) {
      const float d2 = expanded_d2(__ldg(tx + c), __ldg(ty + c), __ldg(tz + c), sx, sy, sz,
                                   s_norm);
      if (d2 < best) {
        best = d2;
        hit = c;
      }
    }
    slot_d2[(size_t)s * TM + r] = best;
    slot_row[(size_t)s * TM + r] = hit;
  }
}

__global__ void __launch_bounds__(kCombineThreads) pair_nn_combine_kernel(
    const float* __restrict__ tgt,         // (nTt, 3, TN)
    const int* __restrict__ pair_start,    // (nSt,)
    const int* __restrict__ pair_cnt,      // (nSt,)
    const int* __restrict__ pair_tgt,      // (max_pairs,)
    const float* __restrict__ slot_d2,     // (max_pairs, TM)
    const int* __restrict__ slot_row,      // (max_pairs, TM)
    int nSt, int TM, int TN,
    float* __restrict__ d2_out,   // (nSt, 1, TM)
    int* __restrict__ idx_out,    // (nSt, 1, TM)
    float* __restrict__ xyz_out)  // (nSt, 3, TM)
{
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= nSt * TM) return;
  const int i = p / TM;
  const int r = p - i * TM;
  int w;
  const float best = sfk::grid::combine(slot_d2 + r, TM, pair_start[i], pair_cnt[i], &w);
  float bx = 0.0f, by = 0.0f, bz = 0.0f;
  int bidx = 0;
  if (w >= 0) {
    const int row = slot_row[(size_t)w * TM + r];
    const int j = pair_tgt[w];
    const float* t = tgt + (size_t)j * 3 * TN;
    bidx = row + j * TN;
    bx = t[row];
    by = t[TN + row];
    bz = t[2 * TN + row];
  }
  d2_out[p] = sfk::jmax(best, 0.0f);
  idx_out[p] = bidx;
  float* o = xyz_out + (size_t)i * 3 * TM + r;
  o[0] = bx;
  o[TM] = by;
  o[2 * TM] = bz;
}

// The scan's grid: one full wave of blocks on every multiprocessor, fewer
// where the list's item-warps cannot fill it.
cudaError_t scan_grid(int TM, int max_pairs, int* blocks, int* per_sm) {
  return sfk::grid::item_warp_grid((const void*)pair_nn_scan_kernel, kScanThreads, TM, max_pairs,
                                   blocks, per_sm);
}

}  // namespace

// Launch K2 (the scan, then the combine) on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// it does not take. slot_d2 / slot_row are the wrapper's (max_pairs, TM)
// scratch.
extern "C" int sfk_pair_nn(const float* src, const float* tgt, const int* pair_start,
                           const int* pair_cnt, const int* pair_tgt, int nSt, int TM, int TN,
                           int max_pairs, float* d2, int* idx, float* xyz, float* slot_d2,
                           int* slot_row, cudaStream_t stream) {
  if (nSt < 1 || TM < 1 || TN < 1 || max_pairs < 1) return (int)cudaErrorInvalidValue;
  int blocks, per_sm;
  cudaError_t e = scan_grid(TM, max_pairs, &blocks, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const int vec4 = TN % 4 == 0 && reinterpret_cast<uintptr_t>(tgt) % 16 == 0;
  pair_nn_scan_kernel<<<blocks, kScanThreads, 0, stream>>>(
      src, tgt, pair_start, pair_cnt, pair_tgt, nSt, TM, TN, vec4, slot_d2, slot_row);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pair_nn_combine_kernel<<<(nSt * TM + kCombineThreads - 1) / kCombineThreads, kCombineThreads,
                           0, stream>>>(tgt, pair_start, pair_cnt, pair_tgt, slot_d2, slot_row,
                                        nSt, TM, TN, d2, idx, xyz);
  return (int)cudaGetLastError();
}

// K2's scan grid for these tiles: blocks, threads a block and the blocks a
// multiprocessor could hold.
extern "C" int sfk_pair_nn_grid(int TM, int max_pairs, int* blocks, int* threads, int* per_sm) {
  if (TM < 1 || max_pairs < 1) return (int)cudaErrorInvalidValue;
  *threads = kScanThreads;
  return (int)scan_grid(TM, max_pairs, blocks, per_sm);
}

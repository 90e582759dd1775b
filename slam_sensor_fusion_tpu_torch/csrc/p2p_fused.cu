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
// Device functions of p2p_fused.cuh carry all three: `associate` writes
// each source point's best d2 and matched (x, y, z, nx, ny, nz) to a
// per-point buffer (K5, with the buffer as its output), `gn_passes` runs
// the iterations and the stats pass from that buffer (K6, with the buffer
// as its input), and `grid_gn` (shared with K7) runs K4's whole GN on a
// cooperative grid, each association a round that fills the same buffer.
// Outputs of K4 and K6: T_out (4, 4) in the rebased frame and stats (128) =
// [rmse, W, iterations, 21 damped JtJ entries (row-major lower triangle),
// wr2, 0...], as the JAX kernels.
//
// What bounds them on an H100: K4 and K5 by the association's instruction
// issue. One pass walks every source tile's admitted target tiles, TM x TN
// direct-difference distances a pair (8 float operations and a compare
// each); at the LIO bench's shapes (16 source tiles of 512, target tiles of
// 1024, up to 256 pairs) that is ~10^8 distances a pass. GN around it is a
// serial chain of passes around block-wide sums. K6 has no distances: it
// reads 10 floats a point a pass and is bound by its bytes and the latency
// of its serial scalar tail. Bytes never limit K4/K5: the target pages
// (32 x 24 KiB) stay in L2 and a warp reads one target row at a time as a
// broadcast.
//
// Design. K4 is a persistent cooperative grid, one block on each SM
// (grid_assoc.cuh). Block 0, the leader, keeps the one-block layout of the
// first port: TM x G threads, G = min(nSt, 1024 / TM); group g owns source
// tiles g, g + G, ... and thread r of a group owns point r of each of them.
// The matched set (7 floats a point: 224 KiB at 16 tiles of 512) is more
// than an SM's shared memory, so it lives in global buffers the wrapper
// allocates, in K5's output layout (d2 (nSt, 1, TM), qn (nSt, 6, TM)). Each
// association is a round over the grid, grid_assoc.cuh's first-row round
// that K3 runs on 3-row pages: every other block takes chunks of (source
// tile, pair slot) items and runs icp_fused.cuh's `nearest_first` on the
// slot's one tile, writing the tile's best d2 and first winning row to
// per-slot scratch (`scan_first<6>`); the leader then combines each
// point's slots in order under a strict `<` (first row within a tile,
// earlier tile across tiles, as the one-block walk) into the matched set
// (`combine_first<6>`).
// With fixed correspondences that is one round at the prior followed by
// p2p_fused.cuh's `gn_passes`; with fresh ones gn_passes' order with a
// round in every pass (`grid_gn`, K7's GN too). The 29 moment sums go through the
// fixed-order block reduction (no atomics: deterministic); the scalar tail
// (damping, Cholesky, starve guard, Taylor exp, polish, composition) runs
// on thread 0 in the JAX kernel's operation order, and the library builds
// with -fmad=false, so products and sums round op by op as in the plain
// versions (`_p2p_core_plain`, `_p2p_associate_plain`,
// `_p2p_gn_corr_plain`) and K4's outputs equal the one-block kernel's bit
// for bit. K5 has no sums: its launcher spreads the source tiles over
// blocks with `associate`. K6 is `gn_passes` on one block.
#include <cuda_runtime.h>

#include "grid_assoc.cuh"
#include "p2p_fused.cuh"

namespace cg = cooperative_groups;

namespace {

using sfk::p2p::kNMom;
using sfk::p2p::Shared;
using sfk::p2p::Tiles;

// K4's and K6's outputs from the state gn_passes leaves (thread 0): T_out and
// stats = [rmse, W, iterations, 21 damped JtJ entries, wr2, 0...].
__device__ void pack_outputs(const Shared& S, const P2PParams& prm, float* T_out,
                             float* stats) {
  float tri[21];
  sfk::p2p::damped_tri(S, prm.damping, tri);
  const float W = S.mom[27], wr2 = S.mom[28];
  sfk::pack44(S.R, S.t, 1.0f, T_out);
  stats[0] = sqrtf(wr2 / sfk::jmax(W, 1.0f));
  stats[1] = W;
  stats[2] = (float)prm.num_iterations;
  for (int k = 0; k < 21; ++k) stats[3 + k] = tri[k];
  stats[24] = wr2;
  for (int m = 25; m < 128; ++m) stats[m] = 0.0f;
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
    float* slot_d2,                       // (max_pairs, TM) rounds' winners by slot
    int* slot_row,                        // (max_pairs, TM)
    sfk::grid::Ctl* ctl,                  // the leader's published round
    int nSt, int TM, int TN, P2PParams prm) {
  const cg::grid_group g = cg::this_grid();
  const Tiles T{src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt,
                best_d2, best_qn, nSt, TM, TN};
  const sfk::grid::FirstRound A{src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt,
                                slot_d2, slot_row, nSt, TM, TN};
  if (blockIdx.x != 0) {  // a worker: serve the leader's association rounds
    sfk::grid::serve(g, ctl, [&] { sfk::grid::scan_first<6>(A, ctl); });
    return;
  }
  __shared__ float red[kNMom * 32];
  __shared__ Shared S;
  if (threadIdx.x == 0) sfk::read44(T0, S.R, S.t);
  __syncthreads();
  sfk::p2p::grid_gn(g, ctl, 0, S, T, A, prm, red);
  sfk::grid::dismiss(g, ctl);
  if (threadIdx.x == 0) pack_outputs(S, prm, T_out, stats);
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
  sfk::p2p::associate(R, t, T, blockIdx.x * G + threadIdx.x / TM, gridDim.x * G);
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
  sfk::p2p::gn_passes(S, T, prm, red);
  if (threadIdx.x == 0) pack_outputs(S, prm, T_out, stats);
}

// Threads of one block: TM a source tile, as many tiles side by side as fit.
inline int groups(int nSt, int TM) { return sfk::grid::first_threads(nSt, TM) / TM; }

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
                             float* stats, float* best_d2, float* best_qn, float* slot_d2,
                             int* slot_row, void* ctl, int nSt, int TM, int TN,
                             const P2PParams* prm, cudaStream_t stream) {
  if (bad_tiles(nSt, TM)) return (int)cudaErrorInvalidValue;
  const int threads = TM * groups(nSt, TM);
  int blocks, per_sm;
  cudaError_t e = sfk::grid::grid_size((const void*)p2p_fused_kernel, threads, 0, &blocks, &per_sm);
  if (e != cudaSuccess) return (int)e;
  sfk::grid::Ctl* c = static_cast<sfk::grid::Ctl*>(ctl);
  P2PParams p = *prm;
  void* args[] = {&src_pages, &tgt_pages, &pair_start, &pair_cnt, &pair_tgt, &T0, &T_out, &stats,
                  &best_d2, &best_qn, &slot_d2, &slot_row, &c, &nSt, &TM, &TN, &p};
  e = cudaLaunchCooperativeKernel((const void*)p2p_fused_kernel, dim3(blocks), dim3(threads),
                                  args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K4's cooperative grid for these tiles: blocks, threads a block and the
// blocks a multiprocessor could hold.
extern "C" int sfk_p2p_grid(int nSt, int TM, int* blocks, int* threads, int* per_sm) {
  if (bad_tiles(nSt, TM)) return (int)cudaErrorInvalidValue;
  *threads = TM * groups(nSt, TM);
  return (int)sfk::grid::grid_size((const void*)p2p_fused_kernel, *threads, 0, blocks, per_sm);
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

// K4, K5, K6: the whole-GN point-to-plane registration and its two halves.
//
// Replace the Pallas kernels of slam_sensor_fusion_tpu/ops/p2p_fused.py:
//   K4 `_make_p2p_kernel` (launched by `point_to_plane_align_fused`, the LIO
//      per-frame registration): association against 6-row target pages (xyz
//      + normal), the 29 Huber-weighted moments, an unrolled 6x6 Cholesky
//      solve, a Taylor SE(3) step with one polar polish, a FIXED number of
//      iterations and a trailing stats pass;
//   K5 `_make_assoc_kernel` (`associate_p2p_fused`, once a map shard in
//      parallel/map_shard.sp_p2p_align): K4's association pass alone at the
//      prior; its winners are the outputs;
//   K6 `_make_gn_corr_kernel` (`p2p_gn_from_correspondences`, once a
//      sp_p2p_align call on the shards' combined winners): K4's GN on a
//      matched set given as input.
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
// reads 10 floats a point once and is bound by the latency of its passes
// (about 110 float operations a point a pass, a reduction of 29 sums, a
// scalar tail on one thread). Bytes never limit K4/K5: the target pages
// (32 x 24 KiB) stay in L2 and a warp reads one target row at a time as a
// broadcast.
//
// Design.
// K4 is a persistent cooperative grid, one block on each SM
// (grid_assoc.cuh). Block 0, the leader, has `first_threads` threads:
// TM x G, G = min(nSt, 1024 / TM), up to 1024 rows a tile, and 1024 past
// that. Thread x owns the points x, x + blockDim.x, ... of the flat (tile,
// row) order: at TM <= 1024 that is the one-block layout of the first port
// (group g = x / TM owns tiles g, g + G, ..., thread r of a group point r
// of each), past it K1's global layout (a thread owns several rows of a
// tile). The matched set (7 floats a point: 224 KiB at 16 tiles of 512,
// 448 KiB at 16 384 rows) is more than an SM's shared memory, so it lives
// in global buffers the wrapper allocates, in K5's output layout (d2 (nSt,
// 1, TM), qn (nSt, 6, TM)); the source points are read from their pages.
// Tiles of 32 to 4096 rows in steps of 32 take the same code. Each
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
// round in every pass (`grid_gn`, K7's GN too). The 29 moment sums go
// through the fixed-order block reduction (no atomics: deterministic); the
// scalar tail (damping, Cholesky, starve guard, Taylor exp, polish,
// composition) runs on thread 0 in the JAX kernel's operation order, and
// the library builds with -fmad=false, so products and sums round op by op
// as in the plain versions (`_p2p_core_plain`, `_p2p_associate_plain`,
// `_p2p_gn_corr_plain`) and K4's outputs equal the one-block kernel's bit
// for bit.
// K5 is that round without the grid barrier (it has no serial chain), as
// K2 (nn_pallas.cu): two ordinary launches. The scan numbers the (source
// tile, pair slot) items, cuts each into warps of 32 source rows and deals
// the item-warps round-robin to the blocks of one wave over every SM, so
// the 256 slots of the bench, or the few a map shard admits, spread over
// the card; each row runs `scan_first_row<6>` under the prior T0 into
// per-slot scratch (max_pairs, TM). The combine gives each source row its
// slots in slot order from kBig under a strict `<` (`combine_first_row<6>`)
// and writes d2 and the winner's six rows, or zeros where no row beat kBig:
// the one-block walk's outputs bit for bit.
// K6 is a thread-block cluster of C CTAs (C <= 8, a power of two, CTAs of
// whole warps; grid and cluster are the same C CTAs on neighbouring SMs)
// that takes over the leader layout's V = first_threads(nSt, TM) threads:
// virtual thread v = rank x blockDim + tid keeps the points v, v + V, ...
// of the flat (tile, row) order (at TM <= 1024 point v % TM of tiles v /
// TM, v / TM + G, ...; past it several rows of a tile). The matched set is
// spread over the cluster's CTAs, each holding its own virtual threads'
// share: each CTA copies their points (source xyz, d2, matched xyz and
// normal: 10 floats a point, ~40 KiB a CTA at 16 x 512 and C = 8, 80 KiB
// at 16 384 rows) into its shared memory once with cp.async, and the
// three passes then read shared memory (where a share does not fit, the
// same kernel reads it from global memory each pass). A pass: every CTA adds up its
// virtual threads' moments in the one-block order (`add_moments`), runs
// block_sum's warp shuffle tree and writes each warp's partial to
// red[m * 32 + warp] in CTA 0's shared memory (distributed shared memory);
// after a cluster barrier CTA 0's threads < 29 add the warp partials in
// warp order and thread 0 runs the scalar tail; after a second barrier the
// other CTAs read the new (R, t) from CTA 0. Same operations in the same
// order as the one-block `gn_passes`: K6 keeps its bits, and K6(K5(x))
// equals K4 with fixed correspondences.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "grid_assoc.cuh"
#include "p2p_fused.cuh"

namespace cg = cooperative_groups;

namespace {

using sfk::p2p::kNMom;
using sfk::p2p::Shared;
using sfk::p2p::Tiles;

constexpr int kScanThreads = 128;     // K5's scan: 4 warps a block
constexpr int kCombineThreads = 256;  // K5's combine: one source row a thread
constexpr int kMaxCluster = 8;        // K6: the portable cluster size
constexpr int kPointFloats = 10;      // K6's staged point: src xyz, d2, qn (6)

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
  const Tiles T{src_pages, best_d2, best_qn, nSt, TM, TN};
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

// K5's scan: warp w of the launch takes the item-warps w, w + W, ...,
// numbered so that neighbouring item-warps land in different blocks; each
// thread scans its row of the item under T0 into the per-slot scratch.
__global__ void __launch_bounds__(kScanThreads) p2p_assoc_scan_kernel(
    const sfk::grid::FirstRound A, const float* __restrict__ T0) {
  sfk::grid::Pose X;
  sfk::read44(T0, X.R, X.t);
  const int n = sfk::grid::n_items(A.pc, A.nSt);
  const int wpi = (A.TM + 31) / 32;  // warps an item
  const int lane = threadIdx.x % 32;
  const int W = gridDim.x * (blockDim.x / 32);
  for (int tw = (threadIdx.x / 32) * gridDim.x + blockIdx.x; tw < n * wpi; tw += W) {
    const int r = (tw % wpi) * 32 + lane;
    if (r >= A.TM) continue;
    int s;
    const int i = sfk::grid::item_at(tw / wpi, A.ps, A.pc, &s);
    sfk::grid::scan_first_row<6>(A, X, i, s, r);
  }
}

// K5's combine: source row p = i x TM + r takes its slots in order.
__global__ void __launch_bounds__(kCombineThreads) p2p_assoc_combine_kernel(
    const sfk::grid::FirstRound A,
    float* __restrict__ best_d2,  // (nSt, 1, TM) out
    float* __restrict__ best_qn)  // (nSt, 6, TM) out
{
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= A.nSt * A.TM) return;
  const int i = p / A.TM;
  const int r = p - i * A.TM;
  const float* win;
  best_d2[p] = sfk::grid::combine_first_row<6>(A, i, r, &win);
  float* o = best_qn + (size_t)i * 6 * A.TM + r;
#pragma unroll
  for (int k = 0; k < 6; ++k) o[k * A.TM] = win ? win[k * A.TN] : 0.0f;
}

// One float from global to shared memory without passing through registers.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K6 on a cluster of gridDim.x CTAs (see the file's head). kStaged: the
// matched set is copied into shared memory once, `staged` holding a CTA's
// points as (point k of the thread, field, thread). kThreads: the most
// threads a CTA has; at 256 a thread may hold two points' terms at once
// (a thread's points are a serial chain of sums, so only the overlap of
// their terms shortens a pass).
template <bool kStaged, int kThreads>
__global__ void __launch_bounds__(kThreads, 1) p2p_gn_cluster_kernel(
    const float* __restrict__ T0,         // (4, 4) rebased prior
    const float* __restrict__ src_pages,  // (nSt, 3, TM)
    const float* __restrict__ best_d2,    // (nSt, 1, TM) in
    const float* __restrict__ best_qn,    // (nSt, 6, TM) in
    float* __restrict__ T_out, float* __restrict__ stats, int nSt, int TM, P2PParams prm) {
  extern __shared__ float staged[];
  __shared__ float red[kNMom * 32];  // CTA 0's: every warp's partials
  __shared__ Shared S;               // CTA 0's: (R, t) and the moments
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int B = blockDim.x;
  const int v = rank * B + threadIdx.x;  // virtual thread of the leader layout
  const int V = (int)cl.num_blocks() * B;
  const int n = nSt * TM;
  if constexpr (kStaged) {
    float* dst = staged + threadIdx.x;
    for (int p = v; p < n; p += V, dst += kPointFloats * B) {
      const int i = p / TM;
      const float* s = src_pages + (size_t)i * 3 * TM + (p - i * TM);
      const float* q = best_qn + (size_t)i * 6 * TM + (p - i * TM);
      cp_async4(dst, s);
      cp_async4(dst + B, s + TM);
      cp_async4(dst + 2 * B, s + 2 * TM);
      cp_async4(dst + 3 * B, best_d2 + p);
#pragma unroll
      for (int k = 0; k < 6; ++k) cp_async4(dst + (4 + k) * B, q + k * TM);
    }
  }
  float R[9], t[3];
  sfk::read44(T0, R, t);
  if (rank == 0 && threadIdx.x == 0) sfk::read44(T0, S.R, S.t);
  float* red0 = cl.map_shared_rank(red, 0);
  const Shared* S0 = cl.map_shared_rank(&S, 0);
  const int lane = threadIdx.x & 31;
  const int warp = v >> 5;  // the warp's index in the leader layout
  const int nwarps = V >> 5;
  if constexpr (kStaged) cp_async_wait_all();  // each thread reads only what it copied
  cl.sync();                         // every CTA runs before DSMEM is touched
  for (int it = 0;; ++it) {
    float acc[kNMom];
#pragma unroll
    for (int m = 0; m < kNMom; ++m) acc[m] = 0.0f;
    const float* p = staged + threadIdx.x;
#pragma unroll 2
    for (int x = v; x < n; x += V) {
      if constexpr (kStaged) {
        sfk::p2p::add_moments(acc, R, t, prm, p[0], p[B], p[2 * B], p[4 * B], p[5 * B],
                              p[6 * B], p[7 * B], p[8 * B], p[9 * B], p[3 * B]);
        p += kPointFloats * B;
      } else {
        const int i = x / TM;
        const float* s = src_pages + (size_t)i * 3 * TM + (x - i * TM);
        const float* q = best_qn + (size_t)i * 6 * TM + (x - i * TM);
        sfk::p2p::add_moments(acc, R, t, prm, s[0], s[TM], s[2 * TM], q[0], q[TM], q[2 * TM],
                              q[3 * TM], q[4 * TM], q[5 * TM], best_d2[x]);
      }
    }
    // block_sum's warp tree; each warp's partial into CTA 0's red
#pragma unroll
    for (int m = 0; m < kNMom; ++m) {
      float x = acc[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) red0[m * 32 + warp] = x;
    }
    cl.sync();
    const bool last = it == prm.num_iterations;
    if (rank == 0) {
      if (threadIdx.x < kNMom) {  // the warp partials in warp order
        float s = 0.0f;
        for (int w = 0; w < nwarps; ++w) s += red[threadIdx.x * 32 + w];
        S.mom[threadIdx.x] = s;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        if (last) {
          pack_outputs(S, prm, T_out, stats);
        } else {
          sfk::p2p::gn_step(S, prm.damping);
        }
      }
    }
    if (last) return;
    cl.sync();  // CTA 0's new (R, t) to the cluster
#pragma unroll
    for (int m = 0; m < 9; ++m) R[m] = S0->R[m];
#pragma unroll
    for (int a = 0; a < 3; ++a) t[a] = S0->t[a];
  }
}

// ops/cuda_lib.check_tile_src's rule: 32 to 4096 rows in steps of 32.
inline bool bad_tiles(int nSt, int TM) {
  return TM < 32 || TM > 4096 || TM % 32 || nSt < 1;
}

constexpr int kNarrow = 256;  // K6's CTAs of at most this many threads take more registers

// K6's launch for these tiles: C CTAs of `threads` (the leader layout's
// V = first_threads(nSt, TM) threads cut into whole warps: C the largest
// power of two <= 8 that divides its warps), the dynamic shared memory a
// CTA stages and whether its share of the matched set fits it.
struct GnCluster {
  int dev, ctas, threads;
  size_t smem;
  bool staged;
};

cudaError_t gn_cluster(int nSt, int TM, GnCluster* c) {
  const int V = sfk::grid::first_threads(nSt, TM);
  const int warps = V / 32;
  int C = kMaxCluster;
  while (warps % C) C /= 2;
  c->ctas = C;
  c->threads = V / C;
  const int per_thread = (nSt * TM + V - 1) / V;  // points a virtual thread owns at most
  c->smem = (size_t)per_thread * kPointFloats * c->threads * sizeof(float);
  // the card's shared memory a block may opt into, less the kernel's own:
  // asked once a device in a host thread (a launch should not pay for it)
  struct Room {
    int dev;
    size_t bytes;
  };
  thread_local Room room = {-1, 0};
  cudaError_t e = cudaGetDevice(&c->dev);
  if (e != cudaSuccess) return e;
  if (room.dev != c->dev) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, c->dev);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, p2p_gn_cluster_kernel<true, 1024>);
    if (e != cudaSuccess) return e;
    room = {c->dev, (size_t)optin - fa.sharedSizeBytes};
  }
  c->staged = c->smem <= room.bytes;
  if (!c->staged) c->smem = 0;
  return cudaSuccess;
}

// Launch K6's cluster; the card's acceptance of a cluster shape is asked
// once a (device, kernel, shape) in a host thread.
template <bool kStaged, int kThreads>
cudaError_t launch_gn(const GnCluster& c, cudaStream_t stream, const float* T0,
                      const float* src_pages, const float* best_d2, const float* best_qn,
                      float* T_out, float* stats, int nSt, int TM, const P2PParams& prm) {
  auto kernel = p2p_gn_cluster_kernel<kStaged, kThreads>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.ctas);
  cfg.blockDim = dim3(c.threads);
  cfg.dynamicSmemBytes = c.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  struct Checked {
    int dev, ctas, threads;
    size_t smem;
  };
  thread_local Checked checked = {-1, 0, 0, 0};  // one a kernel instance
  cudaError_t e;
  if (checked.dev != c.dev || checked.ctas != c.ctas || checked.threads != c.threads ||
      checked.smem != c.smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
    if (e != cudaSuccess) return e;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    checked = {c.dev, c.ctas, c.threads, c.smem};
  }
  e = cudaLaunchKernelEx(&cfg, kernel, T0, src_pages, best_d2, best_qn, T_out, stats, nSt, TM,
                         prm);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Each launcher enqueues its kernels on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a tile
// width it does not take.

extern "C" int sfk_p2p_fused(const float* src_pages, const float* tgt_pages,
                             const int* pair_start, const int* pair_cnt,
                             const int* pair_tgt, const float* T0, float* T_out,
                             float* stats, float* best_d2, float* best_qn, float* slot_d2,
                             int* slot_row, void* ctl, int nSt, int TM, int TN,
                             const P2PParams* prm, cudaStream_t stream) {
  if (bad_tiles(nSt, TM)) return (int)cudaErrorInvalidValue;
  const int threads = sfk::grid::first_threads(nSt, TM);
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
  *threads = sfk::grid::first_threads(nSt, TM);
  return (int)sfk::grid::grid_size((const void*)p2p_fused_kernel, *threads, 0, blocks, per_sm);
}

// K5: the scan, then the combine. slot_d2 / slot_row are the wrapper's
// (max_pairs, TM) scratch.
extern "C" int sfk_p2p_associate(const float* src_pages, const float* tgt_pages,
                                 const int* pair_start, const int* pair_cnt,
                                 const int* pair_tgt, const float* T0, float* best_d2,
                                 float* best_qn, float* slot_d2, int* slot_row, int nSt, int TM,
                                 int TN, int max_pairs, cudaStream_t stream) {
  if (bad_tiles(nSt, TM) || TN < 1 || max_pairs < 0) return (int)cudaErrorInvalidValue;
  const sfk::grid::FirstRound A{src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt,
                                slot_d2, slot_row, nSt, TM, TN};
  if (max_pairs > 0) {  // an empty list has no item to scan
    int blocks, per_sm;
    cudaError_t e = sfk::grid::item_warp_grid((const void*)p2p_assoc_scan_kernel, kScanThreads,
                                              TM, max_pairs, &blocks, &per_sm);
    if (e != cudaSuccess) return (int)e;
    p2p_assoc_scan_kernel<<<blocks, kScanThreads, 0, stream>>>(A, T0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  p2p_assoc_combine_kernel<<<(nSt * TM + kCombineThreads - 1) / kCombineThreads,
                             kCombineThreads, 0, stream>>>(A, best_d2, best_qn);
  return (int)cudaGetLastError();
}

// K5's scan grid for these tiles: blocks, threads a block and the blocks a
// multiprocessor could hold.
extern "C" int sfk_p2p_assoc_grid(int TM, int max_pairs, int* blocks, int* threads,
                                  int* per_sm) {
  if (TM < 1 || max_pairs < 1) return (int)cudaErrorInvalidValue;
  *threads = kScanThreads;
  return (int)sfk::grid::item_warp_grid((const void*)p2p_assoc_scan_kernel, kScanThreads, TM,
                                        max_pairs, blocks, per_sm);
}

extern "C" int sfk_p2p_gn_corr(const float* T0, const float* src_pages,
                               const float* best_d2, const float* best_qn, float* T_out,
                               float* stats, int nSt, int TM, const P2PParams* prm,
                               cudaStream_t stream) {
  if (bad_tiles(nSt, TM)) return (int)cudaErrorInvalidValue;
  GnCluster c;
  cudaError_t e = gn_cluster(nSt, TM, &c);
  if (e != cudaSuccess) return (int)e;
  using Launch = cudaError_t (*)(const GnCluster&, cudaStream_t, const float*, const float*,
                                 const float*, const float*, float*, float*, int, int,
                                 const P2PParams&);
  const Launch launch = c.threads <= kNarrow
                            ? (c.staged ? &launch_gn<true, kNarrow> : &launch_gn<false, kNarrow>)
                            : (c.staged ? &launch_gn<true, 1024> : &launch_gn<false, 1024>);
  return (int)launch(c, stream, T0, src_pages, best_d2, best_qn, T_out, stats, nSt, TM, *prm);
}

// K6's cluster for these tiles: CTAs, threads a CTA and the dynamic shared
// memory a CTA stages (0: the matched set is read from global memory).
extern "C" int sfk_p2p_gn_cluster(int nSt, int TM, int* ctas, int* threads, int* smem) {
  if (bad_tiles(nSt, TM)) return (int)cudaErrorInvalidValue;
  GnCluster c;
  cudaError_t e = gn_cluster(nSt, TM, &c);
  *ctas = c.ctas;
  *threads = c.threads;
  *smem = (int)c.smem;
  return (int)e;
}

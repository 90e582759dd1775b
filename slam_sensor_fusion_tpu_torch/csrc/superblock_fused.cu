// K1: the whole-superblock fine loop, K frames in one launch.
//
// Replaces the Pallas kernel slam_sensor_fusion_tpu/ops/superblock_fused.py
// `_make_superblock_kernel` (launched by `superblock_fine`). Per frame k:
// odometry prediction, element-wise covariance blend with the GPS pose,
// stochastic-filter push and z-score gate (with stochastic_filter.cpp:106's
// operand order), ICP in the crop-rebased frame — lazy (the reference's
// control flow, parity mode) or fresh — and a predicated state update for
// invalid frames. Outputs and state layout match the JAX kernel exactly.
//
// What bounds it on an H100: association. Per ICP association a frame visits
// ~nSt x (admitted target tiles) pairs of TM x TN direct-difference
// distances, each ~20 float instructions with the tie bookkeeping; at bench
// shapes (4 source tiles of 1024, 17-45 admitted pairs a frame, TN = 512)
// that is 0.9-2.4 x 10^7 distances an association, and a superblock runs
// 8-25 associations. The target pages (128 x 6 KiB) stay in L2, so bytes
// are not the limit; float instructions are, and the frame chain around
// them is serial (each prior depends on the last frame's ICP).
// The first port ran it all in ONE block, on 1 of 132 SMs.
//
// Design: a persistent cooperative grid, one block on each SM
// (grid_assoc.cuh). Block 0, the leader, keeps the one-block layout: thread
// r owns point r of every source tile, its sensor-frame coordinates,
// matched target coordinates and alive flag in registers (NST x 7 floats);
// the 17 moment sums are a fixed-order block reduction (warp shuffles, then
// warps in order; no atomics); the scalar chain (prediction, blend, filter,
// Kabsch solve by Newton polar, state selects) runs on thread 0 and is
// broadcast through shared memory. Each association is a round over the
// grid: the leader publishes (R, t) and the frame, every block takes
// (source tile, pair slot) items, cut into chunks of source rows so that a
// round's ~17-45 items fill the 132 blocks, stages the slot's target page
// in shared memory as float4 and scans it for its rows, tracking the tile
// minimum and the SUM and COUNT of coordinates of rows that tie it exactly:
// K1 averages exact ties within a tile (superblock_fused.py:199-216),
// unlike K2 and K3, which take the first row; a chunk never splits a tile's
// target rows, so the sums run in row order. Each item writes its tile
// minimum and tie-averaged coordinates to a scratch buffer by slot; after
// the barrier the leader combines each point's slots in order under a
// strict `<` (the earlier tile keeps a tie), as the one-block loop did.
// Built with -fmad=false: the same expressions round the same way, so
// every output equals the one-block kernel's bit for bit and the plain
// PyTorch version's to rounding of the moment sums.
//
// Two leader layouts. Up to 8 source tiles of at most 1024 rows (the bench
// path), the leader's points live in registers as above, and the block is
// TM threads. Past that (the JAX package's default 64 tiles of 256, its
// autosize rule's 32 of 512, the stress cell's 16 of 4096) the GLOBAL
// layout keeps each point's matched x, y, z and alive weight as a float4
// in a global buffer (nSt, TM) and reads its sensor coordinates from the
// source pages, as K3 does. Every block is then 1024 threads whatever TM
// is; leader thread x owns rows x, x + L, ... (L = min(TM, 1024)) of every
// tile and sums them tile by tile, so at the register layout's shapes it
// sums the same points in the same order and its outputs equal the
// register layout's bit for bit (threads past L add zeros to the block
// sums). A round of the global layout has many items (~12 a tile), and
// its combine reads every slot of every point, so the combine is spread
// too: after the scan's barrier each block combines a share of the
// points into the float4 buffer, and a third barrier ends the round.
#include <cuda_runtime.h>

#include "grid_assoc.cuh"

namespace cg = cooperative_groups;

constexpr int kNMom = 17;  // W, Ss[3], St[3], Mst[9], Eabs

// Mirrors ctypes struct `_SBParams` in ops/superblock_fused.py.
struct SBParams {
  float gate;   // max_correspondence_dist_sq
  float eps;    // transformation_epsilon
  float acc;    // acceptable_mean_error
  float mad_lo; // min_distance_per_scan
  float mad_hi; // max_distance_per_scan / 3
  float z_thr;  // z_score_threshold
  int num_iterations;
  int min_corr;
  int Q;
  int fixed_gains;
  int lazy;
};

namespace {

struct Frame {
  // broadcast from thread 0 to the block
  float R[9];
  float t[3];
  int need;   // lazy: re-associate in this iteration
  int live;   // the ICP loop continues
  float mom[kNMom];
};

// What one launch's association rounds read: the frames' source pages and
// pair lists, the target pages, the per-slot scratch (max_pairs x 4 x TM:
// tile minimum d2 and tie-averaged x, y, z), the global layout's points
// and the control block.
struct Assoc {
  const float* src;   // (K, nSt, 3, TM)
  const int* ps;      // (K, nSt)
  const int* pc;      // (K, nSt)
  const int* pt;      // (K, max_pairs)
  const float* tgt;   // (nTt, 3, TN)
  float* scratch;     // (max_pairs, 4, TM)
  float4* state;      // (nSt, TM): the global layout's matched x, y, z, alive
  sfk::grid::Ctl* ctl;
  int nSt, TM, TN, max_pairs;
  int s_max;  // row chunks an item may be cut into (staging pages a block holds)
  float gate;
};

// The register layout's points of leader thread r: point r of each tile.
template <int NST>
struct Points {
  static constexpr bool kGlobal = false;
  static constexpr int kTiles = NST;
  float px[NST], py[NST], pz[NST];  // sensor-frame source point of each tile
  float bx[NST], by[NST], bz[NST];  // matched target coords (rebased frame)
  float al[NST];                    // alive / gate weight
  // frame pages s (nSt, 3, TM)
  __device__ __forceinline__ void load(const float* s, int TM, const Assoc&) {
#pragma unroll
    for (int i = 0; i < NST; ++i) {
      px[i] = s[(i * 3 + 0) * TM + threadIdx.x];
      py[i] = s[(i * 3 + 1) * TM + threadIdx.x];
      pz[i] = s[(i * 3 + 2) * TM + threadIdx.x];
    }
  }
};

// The global layout's points: the frame's source pages and the state
// buffer; leader thread x owns rows x, x + L, ... of every tile.
struct GlobalPoints {
  static constexpr bool kGlobal = true;
  static constexpr int kTiles = 0;
  const float* src;  // (nSt, 3, TM) of the frame
  float4* state;     // (nSt, TM)
  int nSt, TM, L;
  __device__ __forceinline__ void load(const float* s, int TM_, const Assoc& A) {
    src = s;
    state = A.state;
    nSt = A.nSt;
    TM = TM_;
    L = TM_ < (int)blockDim.x ? TM_ : (int)blockDim.x;
  }
};


// This worker's share of the round the control block describes. A round of
// n items is cut by grid_assoc.cuh's `chunking`: at the bench path's
// shapes a round has fewer items than the grid has workers (~17-45
// against 131), so each item is cut into about workers / n chunks of
// source rows (at most s_max, whole warps of rows, at most a block), and a
// worker's threads form groups of `rows` threads, each with its own
// staging page. Chunk c (worker c % workers, group c / workers) is row
// chunk c % P of item c / P: for item (tile i, slot s) of frame k, thread
// r of the chunk transforms its point r of tile i and scans target tile
// pt[s], staged in shared memory as float4; exact d2 ties of the tile
// minimum sum their coordinates in row order. Writes the tile minimum and
// the averaged coordinates to scratch[s]. Every thread of the block runs
// the same number of trips, so the staging barriers are block-wide. NST is
// the register layout's tile count (its blocks are TM threads), known to
// the compiler; 0 for the global layout.
template <int NST>
__device__ void scan_items(const Assoc& A, float4* page) {
  const sfk::grid::Pose X = sfk::grid::read_pose(A.ctl);
  const int k = sfk::grid::read_frame(A.ctl);
  const int nSt = NST > 0 ? NST : A.nSt;
  const int TM = NST > 0 ? (int)blockDim.x : A.TM;
  const int* ps = A.ps + k * nSt;
  const int* pc = A.pc + k * nSt;
  const int* pt = A.pt + (size_t)k * A.max_pairs;
  const int TN = A.TN;
  const int n = sfk::grid::n_items(pc, nSt);
  const int workers = sfk::grid::n_workers();
  const sfk::grid::Chunks C = sfk::grid::chunking(n, TM, A.s_max);
  const int rows = C.rows, P = C.P;
  const int h = threadIdx.x / rows;  // the thread's group
  const int lr = threadIdx.x % rows;
  float4* pg = page + h * TN;
  const int units = workers * C.groups;
  const int chunks = n * P;
  for (int c0 = 0; c0 < chunks; c0 += units) {
    const int c = c0 + h * workers + sfk::grid::worker();
    const int r = (c % P) * rows + lr;
    const bool have = h < C.groups && c < chunks;
    int s = 0, i = 0;
    if (have) i = sfk::grid::item_at(c / P, ps, pc, &s);
    const float* tp = A.tgt + (size_t)pt[s] * 3 * TN;
    __syncthreads();
    if (have)
      for (int cc = lr; cc < TN; cc += rows)
        pg[cc] = make_float4(tp[cc], tp[TN + cc], tp[2 * TN + cc], 0.0f);
    __syncthreads();
    if (!have || r >= TM) continue;
    const float* sp = A.src + ((size_t)k * nSt + i) * 3 * TM;
    const float px = sp[r], py = sp[TM + r], pz = sp[2 * TM + r];
    const float sx = X.R[0] * px + X.R[1] * py + X.R[2] * pz + X.t[0];
    const float sy = X.R[3] * px + X.R[4] * py + X.R[5] * pz + X.t[1];
    const float sz = X.R[6] * px + X.R[7] * py + X.R[8] * pz + X.t[2];
    float m = INFINITY, cx = 0.0f, cy = 0.0f, cz = 0.0f, cn = 0.0f;
    // the one-block kernel's `if (d2 < m) reset; else if (d2 == m) add` as
    // selects of the same values, without its branches
#pragma unroll 4
    for (int cc = 0; cc < TN; ++cc) {
      const float4 p = pg[cc];
      const float dx = p.x - sx;
      const float dy = p.y - sy;
      const float dz = p.z - sz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      const bool lt = d2 < m;
      const bool eq = d2 == m;
      cx = lt ? p.x : (eq ? cx + p.x : cx);
      cy = lt ? p.y : (eq ? cy + p.y : cy);
      cz = lt ? p.z : (eq ? cz + p.z : cz);
      cn = lt ? 1.0f : (eq ? cn + 1.0f : cn);
      m = lt ? d2 : m;
    }
    const float inv = 1.0f / fmaxf(cn, 1.0f);
    float* o = A.scratch + (size_t)s * 4 * TM + r;
    o[0] = m;
    o[TM] = cx * inv;
    o[2 * TM] = cy * inv;
    o[3 * TM] = cz * inv;
  }
}

// The global layout's combine: block b takes the points b * blockDim.x +
// x, + gridDim.x * blockDim.x, ... of the flat (tile, row) order, combines
// each point's slots in order under a strict `<` from kBig, and writes its
// winner's averaged x, y, z (zeros where no slot won) and alive weight
// (mode 0: the gate test; mode 1: times the gate test) to the state buffer.
__device__ void combine_share(const Assoc& A) {
  const int k = sfk::grid::read_frame(A.ctl);
  const int mode = sfk::grid::read_mode(A.ctl);
  const int* ps = A.ps + k * A.nSt;
  const int* pc = A.pc + k * A.nSt;
  const int TM = A.TM;
  const size_t stride = 4 * (size_t)TM;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < A.nSt * TM;
       p += gridDim.x * blockDim.x) {
    const int i = p / TM;
    const float* col = A.scratch + (p - i * TM);
    int w;
    const float best = sfk::grid::combine(col, stride, ps[i], pc[i], &w);
    const float* o = col + (size_t)(w < 0 ? 0 : w) * stride;
    const float gt = best < A.gate ? 1.0f : 0.0f;
    const float al = mode == 0 ? gt : __ldcg(&A.state[p].w) * gt;
    A.state[p] = make_float4(w < 0 ? 0.0f : __ldcg(o + TM), w < 0 ? 0.0f : __ldcg(o + 2 * TM),
                             w < 0 ? 0.0f : __ldcg(o + 3 * TM), al);
  }
}

// Tile-major association of the leader's points under (F.R, F.t) for frame
// k: one round over the grid, then each point's slots combined in order.
// mode 0: al = (d2 < gate); mode 1: al *= (d2 < gate).
template <int NST>
__device__ void associate(const cg::grid_group& g, Points<NST>& P, const Frame& F,
                          const Assoc& A, int k, float gate, int mode) {
  sfk::grid::lead_round(g, A.ctl, k, F.R, F.t);
  const int TM = blockDim.x;
  const int* ps = A.ps + k * NST;
  const int* pc = A.pc + k * NST;
  const float* col = A.scratch + threadIdx.x;
#pragma unroll
  for (int i = 0; i < NST; ++i) {
    int w;
    const float best = sfk::grid::combine(col, 4 * (size_t)TM, ps[i], pc[i], &w);
    const float* o = col + (size_t)(w < 0 ? 0 : w) * 4 * TM;
    P.bx[i] = w < 0 ? 0.0f : __ldcg(o + TM);
    P.by[i] = w < 0 ? 0.0f : __ldcg(o + 2 * TM);
    P.bz[i] = w < 0 ? 0.0f : __ldcg(o + 3 * TM);
    const float gt = best < gate ? 1.0f : 0.0f;
    P.al[i] = mode == 0 ? gt : P.al[i] * gt;
  }
}

// The 17 gated Kabsch moments under (R, t) with weights P.al, into F.mom.
template <int NST>
__device__ void moments(const Points<NST>& P, Frame& F, float* red) {
  float R[9], t[3];
#pragma unroll
  for (int m = 0; m < 9; ++m) R[m] = F.R[m];
  t[0] = F.t[0]; t[1] = F.t[1]; t[2] = F.t[2];
  float v[kNMom];
#pragma unroll
  for (int m = 0; m < kNMom; ++m) v[m] = 0.0f;
#pragma unroll
  for (int i = 0; i < NST; ++i) {
    const float w = P.al[i];
    const float sp[3] = {
        R[0] * P.px[i] + R[1] * P.py[i] + R[2] * P.pz[i] + t[0],
        R[3] * P.px[i] + R[4] * P.py[i] + R[5] * P.pz[i] + t[1],
        R[6] * P.px[i] + R[7] * P.py[i] + R[8] * P.pz[i] + t[2]};
    const float tb[3] = {P.bx[i], P.by[i], P.bz[i]};
    v[0] += w;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[1 + a] += sp[a] * w;
      v[4 + a] += tb[a] * w;
#pragma unroll
      for (int b = 0; b < 3; ++b) v[7 + 3 * a + b] += sp[a] * w * tb[b];
    }
    const float dx = sp[0] - tb[0], dy = sp[1] - tb[1], dz = sp[2] - tb[2];
    v[16] += w * sqrtf(dx * dx + dy * dy + dz * dz);
  }
  sfk::block_sum<kNMom>(v, red, F.mom);
}

// The global layout's association: one round over the grid whose combine
// every block shares (combine_share).
__device__ void associate(const cg::grid_group& g, GlobalPoints&, const Frame& F,
                          const Assoc& A, int k, float, int mode) {
  sfk::grid::lead_round(g, A.ctl, k, mode, F.R, F.t, [&] { combine_share(A); });
}

// The register layout's moments over the global layout's points: the same
// expressions over thread x's rows, tile by tile.
__device__ void moments(const GlobalPoints& P, Frame& F, float* red) {
  float R[9], t[3];
#pragma unroll
  for (int m = 0; m < 9; ++m) R[m] = F.R[m];
  t[0] = F.t[0]; t[1] = F.t[1]; t[2] = F.t[2];
  float v[kNMom];
#pragma unroll
  for (int m = 0; m < kNMom; ++m) v[m] = 0.0f;
  const int first = threadIdx.x < P.L ? (int)threadIdx.x : P.TM;
  for (int i = 0; i < P.nSt; ++i) {
    const float* s = P.src + (size_t)i * 3 * P.TM;
    for (int r = first; r < P.TM; r += P.L) {
      const float4 b = __ldcg(P.state + (size_t)i * P.TM + r);
      const float w = b.w;
      const float px = s[r], py = s[P.TM + r], pz = s[2 * P.TM + r];
      const float sp[3] = {
          R[0] * px + R[1] * py + R[2] * pz + t[0],
          R[3] * px + R[4] * py + R[5] * pz + t[1],
          R[6] * px + R[7] * py + R[8] * pz + t[2]};
      const float tb[3] = {b.x, b.y, b.z};
      v[0] += w;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        v[1 + a] += sp[a] * w;
        v[4 + a] += tb[a] * w;
#pragma unroll
        for (int c = 0; c < 3; ++c) v[7 + 3 * a + c] += sp[a] * w * tb[c];
      }
      const float dx = sp[0] - tb[0], dy = sp[1] - tb[1], dz = sp[2] - tb[2];
      v[16] += w * sqrtf(dx * dx + dy * dy + dz * dz);
    }
  }
  sfk::block_sum<kNMom>(v, red, F.mom);
}

// The sum of the alive weights into F.mom[0] (every thread must call it).
template <int NST>
__device__ void alive(const Points<NST>& P, Frame& F, float* red) {
  float v[1];
  v[0] = 0.0f;
#pragma unroll
  for (int i = 0; i < NST; ++i) v[0] += P.al[i];
  sfk::block_sum<1>(v, red, F.mom);
}

__device__ void alive(const GlobalPoints& P, Frame& F, float* red) {
  float v[1];
  v[0] = 0.0f;
  const int first = threadIdx.x < P.L ? (int)threadIdx.x : P.TM;
  for (int i = 0; i < P.nSt; ++i)
    for (int r = first; r < P.TM; r += P.L) v[0] += __ldcg(&P.state[(size_t)i * P.TM + r].w);
  sfk::block_sum<1>(v, red, F.mom);
}

template <class Pts>
__device__ sfk::IcpOut icp_lazy(const cg::grid_group& g, Pts& P, Frame& F, float* red,
                                const Assoc& A, int k, const SBParams& prm) {
  sfk::IcpOut o{sfk::kBig, 0, 0, sfk::kBig};
  associate(g, P, F, A, k, prm.gate, 0);
  alive(P, F, red);
  o.n_corr = (int)F.mom[0];
  bool live = o.n_corr >= prm.min_corr;
  for (int it = 0; it < prm.num_iterations && live; ++it) {
    moments(P, F, red);
    float err = 0.0f;
    bool hit = false;
    if (threadIdx.x == 0) {
      err = F.mom[16] / sfk::jmax(F.mom[0], 1.0f);
      hit = err < prm.acc;
      F.need = (!hit) && (fabsf(o.err - err) < prm.eps);
    }
    __syncthreads();
    if (F.need) {  // plateau: re-associate, the alive set only shrinks
      associate(g, P, F, A, k, prm.gate, 1);
      moments(P, F, red);
    }
    if (threadIdx.x == 0) {
      float R_step[9], t_step[3], detH;
      const bool ok = sfk::solve_step(F.mom, R_step, t_step, &detH);
      const bool stop = hit || !ok;
      sfk::apply_step(F.R, F.t, R_step, t_step, stop);
      o.err = err;
      o.iters += stop ? 0 : 1;
      o.det_min = sfk::jmin(o.det_min, detH);
      F.live = !stop;
    }
    __syncthreads();
    live = F.live;
  }
  return o;  // meaningful on thread 0
}

template <class Pts>
__device__ sfk::IcpOut icp_fresh(const cg::grid_group& g, Pts& P, Frame& F, float* red,
                                 const Assoc& A, int k, const SBParams& prm) {
  sfk::IcpOut o{sfk::kBig, 0, 0, sfk::kBig};
  bool live = true;
  for (int it = 0; it < prm.num_iterations && live; ++it) {
    associate(g, P, F, A, k, prm.gate, 0);
    moments(P, F, red);
    if (threadIdx.x == 0) {
      const float W = F.mom[0];
      const float Wc = sfk::jmax(W, 1.0f);
      const float err = W >= (float)prm.min_corr ? F.mom[16] / Wc : sfk::kBig;
      float R_step[9], t_step[3], detH;
      const bool ok = sfk::solve_step(F.mom, R_step, t_step, &detH);
      const bool stop = err < prm.acc || fabsf(o.err - err) < prm.eps || !ok;
      sfk::apply_step(F.R, F.t, R_step, t_step, stop);
      o.err = err;
      o.n_corr = (int)W;
      o.iters += stop ? 0 : 1;
      o.det_min = sfk::jmin(o.det_min, detH);
      F.live = !stop;
    }
    __syncthreads();
    live = F.live;
  }
  return o;
}

template <class Pts>
__global__ void __launch_bounds__(1024, 1) superblock_kernel(
    const float* __restrict__ src_pages,  // (K, nSt, 3, TM)
    const int* __restrict__ pair_start,   // (K, nSt)
    const int* __restrict__ pair_cnt,     // (K, nSt)
    const int* __restrict__ pair_tgt,     // (K, max_pairs)
    const int* __restrict__ valid,        // (K,)
    const float* __restrict__ odom_T,     // (K, 4, 4)
    const float* __restrict__ gps_T,      // (K, 4, 4)
    const float* __restrict__ odom_tr,    // (K,)
    const float* __restrict__ gps_tr,     // (K,)
    const float* __restrict__ pose0,      // (4, 4)
    const float* __restrict__ odom_prev0, // (4, 4)
    const float* __restrict__ trans0,     // (Q, 4, 4)
    const int* __restrict__ count0,       // ()
    const float* __restrict__ filt_prev0, // (4, 4)
    const float* __restrict__ center,     // (3,)
    const float* __restrict__ tgt_pages,  // (nTt, 3, TN)
    float* __restrict__ poses_out,        // (K, 4, 4)
    float* __restrict__ priors_out,       // (K, 4, 4)
    float* __restrict__ odom_pred_out,    // (K, 4, 4)
    float* __restrict__ stats_out,        // (K, 128)
    float* __restrict__ state_out,        // (Q + 3, 4, 4)
    float* __restrict__ count_out,        // (1, 128)
    float* scratch,                       // (max_pairs, 4, TM), rounds' winners by slot
    float4* point_state,                  // (nSt, TM): the global layout's points
    const float* __restrict__ wq,         // (Q,) the filter queue's weights
    float* qbuf,                          // (2, Q, 12): the queue and its next state (thread 0)
    sfk::grid::Ctl* ctl,                  // the leader's published round
    int K, int nSt, int TM, int TN, int max_pairs, int s_max, SBParams prm) {
  extern __shared__ float4 smem_page[];  // s_max staging pages of TN rows (workers)
  __shared__ float red[kNMom * 32];
  __shared__ Frame F;
  float4* const page = smem_page;
  const cg::grid_group g = cg::this_grid();
  const Assoc A{src_pages, pair_start, pair_cnt, pair_tgt, tgt_pages, scratch, point_state,
                ctl, nSt, TM, TN, max_pairs, s_max, prm.gate};
  if (blockIdx.x != 0) {  // a worker: serve the leader's association rounds
    if constexpr (Pts::kGlobal)
      sfk::grid::serve(g, ctl, [&] { scan_items<0>(A, page); }, [&] { combine_share(A); });
    else
      sfk::grid::serve(g, ctl, [&] { scan_items<Pts::kTiles>(A, page); });
    return;
  }
  const int Q = prm.Q;

  // carried state, thread 0 only; the queue's Q transitions (rotation,
  // then translation: 12 floats each) and their next state live in `qbuf`,
  // so the queue takes any size
  float Rp[9], tp[3], Ro[9], to[3], Rf[9], tf[3];
  float* const trans = qbuf;
  int count = 0;
  // per-frame values thread 0 keeps across the ICP
  float Rg[9], tg[3], Rpr[9], tpr[3], Rpred[9], tpred[3], Rok[9], tok[3];
  float* const new_trans = qbuf + 12 * Q;
  int new_count = 0;
  float cx[3];
  if (threadIdx.x == 0) {
    sfk::read44(pose0, Rp, tp);
    sfk::read44(odom_prev0, Ro, to);
    sfk::read44(filt_prev0, Rf, tf);
    for (int q = 0; q < Q; ++q) sfk::read44(trans0 + 16 * q, trans + 12 * q, trans + 12 * q + 9);
    count = count0[0];
    cx[0] = center[0]; cx[1] = center[1]; cx[2] = center[2];
  }

  for (int k = 0; k < K; ++k) {
    const bool v = valid[k] != 0;
    if (threadIdx.x == 0) {
      float Rgk[9], tgk[3];
      sfk::read44(odom_T + 16 * k, Rok, tok);
      sfk::read44(gps_T + 16 * k, Rgk, tgk);
      // 1) odometry prediction
      float Roi[9], toi[3], Rd[9], td[3];
      sfk::inv_rigid(Ro, to, Roi, toi);
      sfk::compose(Roi, toi, Rok, tok, Rd, td);
      sfk::compose(Rp, tp, Rd, td, Rpred, tpred);
      // 2) element-wise covariance blend
      float og, gg;
      if (prm.fixed_gains) {
        og = 0.95f;
        gg = 0.05f;
      } else {
        const float tot = odom_tr[k] + gps_tr[k];
        og = gps_tr[k] / tot;
        gg = odom_tr[k] / tot;
      }
      for (int m = 0; m < 9; ++m) Rpr[m] = og * Rpred[m] + gg * Rgk[m];
      for (int a = 0; a < 3; ++a) tpr[a] = og * tpred[a] + gg * tgk[a];
      // 3) stochastic filter: push the transition, z-score gate
      float Rfi[9], tfi[3], Rtr[9], ttr[3];
      sfk::inv_rigid(Rf, tf, Rfi, tfi);
      sfk::compose(Rfi, tfi, Rpr, tpr, Rtr, ttr);
      const bool not_full = count < Q;
      for (int q = 0; q < Q; ++q) {
        const float* srcq;
        if (not_full) srcq = (count == q) ? nullptr : trans + 12 * q;
        else srcq = (q < Q - 1) ? trans + 12 * (q + 1) : nullptr;
        float* nq = new_trans + 12 * q;
        for (int m = 0; m < 9; ++m) nq[m] = srcq ? srcq[m] : Rtr[m];
        for (int a = 0; a < 3; ++a) nq[9 + a] = srcq ? srcq[9 + a] : ttr[a];
      }
      new_count = min(count + 1, Q);
      // each queued position pose @ transition_q's translation, computed
      // again for the deviation pass (the same expression, the same bits)
      float mean[3] = {0.0f, 0.0f, 0.0f};
      for (int q = 0; q < Q; ++q) {
        float v3[3];
        sfk::mv3(Rp, new_trans + 12 * q + 9, v3);
        for (int a = 0; a < 3; ++a) mean[a] = mean[a] + wq[q] * (v3[a] + tp[a]);
      }
      float mad[3] = {0.0f, 0.0f, 0.0f};
      for (int q = 0; q < Q; ++q) {
        float v3[3];
        sfk::mv3(Rp, new_trans + 12 * q + 9, v3);
        for (int a = 0; a < 3; ++a) mad[a] = mad[a] + wq[q] * fabsf((v3[a] + tp[a]) - mean[a]);
      }
      for (int a = 0; a < 3; ++a) mad[a] = fminf(fmaxf(mad[a], prm.mad_lo), prm.mad_hi);
      float z = sfk::jmax(fabsf(tpr[0] - mean[0]) / mad[0],
                          sfk::jmax(fabsf(tpr[1] - mean[1]) / mad[1],
                                    fabsf(tpr[2] - mean[2]) / mad[2]));
      if (new_count < Q) z = 0.0f;
      // replacement mean pose sum_q w_q (transition_q @ pose)  (:106 order)
      float mR[9], mt[3];
      for (int m = 0; m < 9; ++m) mR[m] = 0.0f;
      for (int a = 0; a < 3; ++a) mt[a] = 0.0f;
      for (int q = 0; q < Q; ++q) {
        float Rc[9], tc[3];
        sfk::compose(new_trans + 12 * q, new_trans + 12 * q + 9, Rp, tp, Rc, tc);
        for (int m = 0; m < 9; ++m) mR[m] = mR[m] + wq[q] * Rc[m];
        for (int a = 0; a < 3; ++a) mt[a] = mt[a] + wq[q] * tc[a];
      }
      const bool gated = z > prm.z_thr;
      for (int m = 0; m < 9; ++m) Rg[m] = gated ? mR[m] : Rpr[m];
      for (int a = 0; a < 3; ++a) tg[a] = gated ? mt[a] : tpr[a];
      // ICP runs in the frame rebased on the crop centre
      for (int m = 0; m < 9; ++m) F.R[m] = Rg[m];
      for (int a = 0; a < 3; ++a) F.t[a] = tg[a] - cx[a];
    }
    __syncthreads();

    sfk::IcpOut o{sfk::kBig, 0, 0, sfk::kBig};
    if (v) {  // an invalid frame's ICP result is discarded: skip it
      Pts P;
      P.load(src_pages + (size_t)k * nSt * 3 * TM, TM, A);
      o = prm.lazy ? icp_lazy(g, P, F, red, A, k, prm) : icp_fresh(g, P, F, red, A, k, prm);
    }

    if (threadIdx.x == 0) {
      const float vf = v ? 1.0f : 0.0f;
      float* st = stats_out + 128 * k;
      for (int m = 0; m < 128; ++m) st[m] = 0.0f;
      float Rfin[9], tfin[3];
      if (v) {
        const bool enough = o.n_corr >= prm.min_corr;
        float ticp[3];
        for (int a = 0; a < 3; ++a) ticp[a] = F.t[a] + cx[a];
        for (int m = 0; m < 9; ++m) Rfin[m] = enough ? F.R[m] : Rg[m];
        for (int a = 0; a < 3; ++a) tfin[a] = enough ? ticp[a] : tg[a];
        const bool conv = enough && o.err < prm.acc;
        st[0] = vf * (enough ? o.err : 1.0e6f);
        st[1] = vf * (float)(enough ? o.iters : 0);
        st[2] = vf * (float)o.n_corr;
        st[3] = vf * (conv ? 1.0f : 0.0f);
        st[4] = vf * o.det_min;
        // 5) predicated state update
        for (int m = 0; m < 9; ++m) { Rp[m] = Rfin[m]; Ro[m] = Rok[m]; Rf[m] = Rpr[m]; }
        for (int a = 0; a < 3; ++a) { tp[a] = tfin[a]; to[a] = tok[a]; tf[a] = tpr[a]; }
        for (int m = 0; m < 12 * Q; ++m) trans[m] = new_trans[m];
        count = new_count;
      }
      sfk::pack44(Rp, tp, 1.0f, poses_out + 16 * k);
      sfk::pack44(Rg, tg, vf, priors_out + 16 * k);
      sfk::pack44(Rpred, tpred, vf, odom_pred_out + 16 * k);
    }
    __syncthreads();
  }
  sfk::grid::dismiss(g, ctl);

  if (threadIdx.x == 0) {
    sfk::pack44(Rp, tp, 1.0f, state_out);
    sfk::pack44(Ro, to, 1.0f, state_out + 16);
    sfk::pack44(Rf, tf, 1.0f, state_out + 32);
    for (int q = 0; q < Q; ++q)
      sfk::pack44(trans + 12 * q, trans + 12 * q + 9, 1.0f, state_out + 48 + 16 * q);
    count_out[0] = (float)count;
    for (int m = 1; m < 128; ++m) count_out[m] = 0.0f;
  }
}

// The most row chunks an item may be cut into: up to 16, chunks of at
// least a warp, and as many staging pages as fit 200 KB of the 227 KB of
// shared memory a block may use.
inline int chunk_max(int threads, int TN) {
  int s = 16;
  while (s > 1 && (32 * s > threads || (size_t)s * TN * sizeof(float4) > 200 * 1024)) --s;
  return s;
}

// Threads a block: the register layout's TM, the global layout's 1024.
template <class Pts>
int block_threads(int TM) {
  return Pts::kGlobal ? 1024 : TM;
}

template <class Pts>
int launch(const float* src_pages, const int* pair_start, const int* pair_cnt,
           const int* pair_tgt, const int* valid, const float* odom_T,
           const float* gps_T, const float* odom_tr, const float* gps_tr,
           const float* pose0, const float* odom_prev0, const float* trans0,
           const int* count0, const float* filt_prev0, const float* center,
           const float* tgt_pages, float* poses_out, float* priors_out,
           float* odom_pred_out, float* stats_out, float* state_out,
           float* count_out, float* scratch, float4* point_state, const float* wq, float* qbuf,
           sfk::grid::Ctl* ctl, int K, int nSt, int TM, int TN, int max_pairs, SBParams prm,
           cudaStream_t stream) {
  const int threads = block_threads<Pts>(TM);
  int s_max = chunk_max(threads, TN);
  const size_t smem = (size_t)s_max * TN * sizeof(float4);
  cudaError_t e = cudaFuncSetAttribute(
      superblock_kernel<Pts>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks, per_sm;
  e = sfk::grid::grid_size((const void*)superblock_kernel<Pts>, threads, smem, &blocks, &per_sm);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&src_pages, &pair_start, &pair_cnt, &pair_tgt, &valid, &odom_T,
                  &gps_T, &odom_tr, &gps_tr, &pose0, &odom_prev0, &trans0,
                  &count0, &filt_prev0, &center, &tgt_pages, &poses_out, &priors_out,
                  &odom_pred_out, &stats_out, &state_out, &count_out, &scratch, &point_state,
                  &wq, &qbuf, &ctl, &K, &nSt, &TM, &TN, &max_pairs, &s_max, &prm};
  e = cudaLaunchCooperativeKernel((const void*)superblock_kernel<Pts>, dim3(blocks),
                                  dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class Pts>
int grid_of(int TM, int TN, int* blocks, int* threads, int* per_sm) {
  *threads = block_threads<Pts>(TM);
  const size_t smem = (size_t)chunk_max(*threads, TN) * TN * sizeof(float4);
  cudaError_t e = cudaFuncSetAttribute(
      superblock_kernel<Pts>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)sfk::grid::grid_size((const void*)superblock_kernel<Pts>, *threads, smem, blocks,
                                   per_sm);
}

// Does (nSt, TM) take the global layout? Past 8 tiles or 1024 rows, or
// when the caller asks for it.
inline bool global_layout(int nSt, int TM, int force) { return force || nSt > 8 || TM > 1024; }

inline bool bad_tiles(int nSt, int TM) {
  return TM < 32 || TM > 4096 || TM % 32 || nSt < 1;
}

}  // namespace

// Launch K1 on `stream` as a cooperative grid; returns the launch's error
// (0 on success; a grid the card cannot hold co-resident is refused, not
// shrunk), or cudaErrorInvalidValue for a tile shape or queue size it does
// not take. `scratch` holds max_pairs x 4 x TM floats, `point_state` nSt x
// TM x 4 floats (read only by the global layout: past 8 source tiles or
// 1024 rows, or with `global` set), `wq` the filter queue's Q weights,
// `qbuf` 2 x Q x 12 floats, `ctl` a sfk::grid::Ctl; only `wq` needs
// initialising.
extern "C" int sfk_superblock_fine(
    const float* src_pages, const int* pair_start, const int* pair_cnt,
    const int* pair_tgt, const int* valid, const float* odom_T,
    const float* gps_T, const float* odom_tr, const float* gps_tr,
    const float* pose0, const float* odom_prev0, const float* trans0,
    const int* count0, const float* filt_prev0, const float* center,
    const float* tgt_pages, float* poses_out, float* priors_out,
    float* odom_pred_out, float* stats_out, float* state_out, float* count_out,
    float* scratch, float* point_state, const float* wq, float* qbuf, void* ctl, int K, int nSt,
    int TM, int TN, int max_pairs, int global, const SBParams* prm, cudaStream_t stream) {
  if (prm->Q < 1 || bad_tiles(nSt, TM)) return (int)cudaErrorInvalidValue;
  sfk::grid::Ctl* c = static_cast<sfk::grid::Ctl*>(ctl);
  float4* ps4 = reinterpret_cast<float4*>(point_state);
#define SFK_LAUNCH(PTS)                                                       \
  launch<PTS>(src_pages, pair_start, pair_cnt, pair_tgt, valid, odom_T, gps_T, \
              odom_tr, gps_tr, pose0, odom_prev0, trans0, count0, filt_prev0,  \
              center, tgt_pages, poses_out, priors_out, odom_pred_out,         \
              stats_out, state_out, count_out, scratch, ps4, wq, qbuf, c, K,   \
              nSt, TM, TN, max_pairs, *prm, stream)
  if (global_layout(nSt, TM, global)) return SFK_LAUNCH(GlobalPoints);
  switch (nSt) {
    case 1: return SFK_LAUNCH(Points<1>);
    case 2: return SFK_LAUNCH(Points<2>);
    case 3: return SFK_LAUNCH(Points<3>);
    case 4: return SFK_LAUNCH(Points<4>);
    case 5: return SFK_LAUNCH(Points<5>);
    case 6: return SFK_LAUNCH(Points<6>);
    case 7: return SFK_LAUNCH(Points<7>);
    default: return SFK_LAUNCH(Points<8>);
  }
#undef SFK_LAUNCH
}

// K1's cooperative grid for these tiles: blocks, threads a block and the
// blocks a multiprocessor could hold.
extern "C" int sfk_superblock_grid(int nSt, int TM, int TN, int* blocks, int* threads,
                                   int* per_sm) {
  if (bad_tiles(nSt, TM)) return (int)cudaErrorInvalidValue;
  if (global_layout(nSt, TM, 0)) return grid_of<GlobalPoints>(TM, TN, blocks, threads, per_sm);
  switch (nSt) {
    case 1: return grid_of<Points<1>>(TM, TN, blocks, threads, per_sm);
    case 2: return grid_of<Points<2>>(TM, TN, blocks, threads, per_sm);
    case 3: return grid_of<Points<3>>(TM, TN, blocks, threads, per_sm);
    case 4: return grid_of<Points<4>>(TM, TN, blocks, threads, per_sm);
    case 5: return grid_of<Points<5>>(TM, TN, blocks, threads, per_sm);
    case 6: return grid_of<Points<6>>(TM, TN, blocks, threads, per_sm);
    case 7: return grid_of<Points<7>>(TM, TN, blocks, threads, per_sm);
    default: return grid_of<Points<8>>(TM, TN, blocks, threads, per_sm);
  }
}

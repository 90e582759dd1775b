// Grid-wide association for the registration kernels K1, K3 and K4: one
// persistent cooperative grid a launch, one leader block that runs the
// serial chain, and the other blocks scanning the pair list's tiles.
//
// The frame, ICP and GN loops are serial chains (each prior depends on the
// last solve); only the association is wide. So block 0, the LEADER, runs
// the kernel's serial work in the one-block kernels' layout (the moment
// sums, the scalar chain on thread 0), and each association is a ROUND
// over the grid:
//
//   1. the leader's thread 0 publishes (R, t), the frame and the command in
//      a control block in global memory (`Ctl`); a grid barrier;
//   2. every other block, a WORKER, takes work items from the pair list:
//      item j is (source tile i, admitted pair slot s) in tile order, slot
//      order within a tile. An item scans ONE target tile for a source
//      tile's rows and writes the tile's per-row winner to a scratch buffer
//      indexed by the slot (the caller's per-tile scan: K1 averages exact
//      ties, K3 and K4 keep the first row). Items are cut into chunks of
//      whole warps of source rows (`chunking`), never of target rows, so a
//      tile's scan runs in row order as before. The leader scans nothing,
//      so the scan is not compiled into the leader's path, whose live state
//      already spills;
//   3. a grid barrier; each source row's per-slot winners are combined in
//      slot order under the strict `<` of the one-block kernels' running
//      loop, starting from kBig, so the earlier tile keeps an exact tie and
//      a tile whose minimum is kBig never wins. The result equals the
//      running loop bit for bit. The leader combines (K3, K4, K1 with its
//      points in registers), or, where the points are too many for one
//      block, every block combines a share of them and a third barrier
//      ends the round (K1's global layout).
//
// Workers `serve`: they wait at the barrier, read the command and either
// scan their items and meet the next barriers, or return. The grid must
// be co-resident, so it is launched with cudaLaunchCooperativeKernel, one
// block on each multiprocessor (`grid_size`); a launch the card refuses
// returns its error. grid.sync() orders memory across the grid; data other
// blocks wrote is read with __ldcg (L2, not a stale L1 line).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "icp_fused.cuh"

namespace sfk {
namespace grid {

namespace cg = cooperative_groups;

constexpr int kExit = 0;
constexpr int kAssociate = 1;

// What the leader publishes before a round (global memory, written by the
// leader's thread 0, read by every thread after the barrier).
struct Ctl {
  float R[9];
  float t[3];
  int cmd;    // kAssociate or kExit
  int frame;  // the frame whose pair list the round walks (K1)
  int mode;   // K1's global layout: 0 weight = gate test, 1 weight *= gate test
};

// A round's transform as every thread reads it after the barrier.
struct Pose {
  float R[9];
  float t[3];
};

__device__ __forceinline__ Pose read_pose(const Ctl* ctl) {
  Pose p;
#pragma unroll
  for (int m = 0; m < 9; ++m) p.R[m] = __ldcg(ctl->R + m);
#pragma unroll
  for (int a = 0; a < 3; ++a) p.t[a] = __ldcg(ctl->t + a);
  return p;
}

__device__ __forceinline__ int read_frame(const Ctl* ctl) { return __ldcg(&ctl->frame); }
__device__ __forceinline__ int read_mode(const Ctl* ctl) { return __ldcg(&ctl->mode); }

// The number of (tile, slot) items of a pair list: sum of the tiles' counts.
__device__ __forceinline__ int n_items(const int* pc, int nSt) {
  int n = 0;
  for (int i = 0; i < nSt; ++i) n += pc[i];
  return n;
}

// Item j of a pair list: returns its source tile and sets *slot to its
// pair slot (index into pair_tgt). Tiles in order, slots in order.
// Only for j < n_items(pc, nSt).
__device__ __forceinline__ int item_at(int j, const int* ps, const int* pc, int* slot) {
  int i = 0;
  while (j >= pc[i]) {
    j -= pc[i];
    ++i;
  }
  *slot = ps[i] + j;
  return i;
}

// A worker's index among the grid's workers (every block but the leader).
__device__ __forceinline__ int worker() { return blockIdx.x - 1; }
__device__ __forceinline__ int n_workers() { return gridDim.x - 1; }

// How a round of n items of TM source rows is cut for the workers' blocks
// of blockDim.x threads: each item into P chunks of `rows` source rows
// (whole warps; at most a block), a block into `groups` groups of `rows`
// threads (at most s_max: K1's staging pages). Items are split into about
// workers / n chunks, so that a round of few items still spreads over the
// grid; at least one chunk an item, and enough that a chunk fits a block.
// Chunk c goes to worker c % workers, group c / workers % groups.
struct Chunks {
  int P, rows, groups;
};

__device__ __forceinline__ Chunks chunking(int n, int TM, int s_max) {
  const int T = blockDim.x;
  int P = n > 0 ? n_workers() / n : 1;
  P = P < 1 ? 1 : (P > s_max ? s_max : P);
  int rows = ((TM + P - 1) / P + 31) / 32 * 32;
  rows = rows > T ? T : rows;
  Chunks c;
  c.rows = rows;
  c.groups = T / rows < s_max ? T / rows : s_max;
  c.P = (TM + rows - 1) / rows;
  return c;
}

// A worker: serve rounds until the leader dismisses the grid. `items()`
// scans this worker's items of the round.
template <class Items>
__device__ void serve(const cg::grid_group& g, const Ctl* ctl, Items&& items) {
  for (;;) {
    g.sync();
    if (__ldcg(&ctl->cmd) == kExit) return;
    items();
    g.sync();
  }
}

// A worker of rounds with a grid-wide combine: scan, barrier, combine this
// block's share of the points, barrier.
template <class Items, class Combine>
__device__ void serve(const cg::grid_group& g, const Ctl* ctl, Items&& items, Combine&& combine) {
  for (;;) {
    g.sync();
    if (__ldcg(&ctl->cmd) == kExit) return;
    items();
    g.sync();
    combine();
    g.sync();
  }
}

// The leader's thread 0 publishes a round.
__device__ __forceinline__ void publish(Ctl* ctl, int frame, int mode, const float* R,
                                        const float* t) {
  if (threadIdx.x == 0) {
    for (int m = 0; m < 9; ++m) ctl->R[m] = R[m];
    for (int a = 0; a < 3; ++a) ctl->t[a] = t[a];
    ctl->frame = frame;
    ctl->mode = mode;
    ctl->cmd = kAssociate;
  }
}

// The leader's side of one round under (R, t) (every thread of the leader
// block calls it; R, t are read on thread 0 only): publish, then wait for
// the workers. The per-slot winners are then in the scratch buffer for the
// combine.
__device__ inline void lead_round(const cg::grid_group& g, Ctl* ctl, int frame, const float* R,
                                  const float* t) {
  publish(ctl, frame, 0, R, t);
  g.sync();
  g.sync();
}

// The leader's side of a round with a grid-wide combine: publish, wait for
// the scan, combine the leader block's share, wait for the other shares.
template <class Combine>
__device__ void lead_round(const cg::grid_group& g, Ctl* ctl, int frame, int mode,
                           const float* R, const float* t, Combine&& combine) {
  publish(ctl, frame, mode, R, t);
  g.sync();
  g.sync();
  combine();
  g.sync();
}

// The leader ends the launch: the serving blocks return (every thread of
// the leader block calls it).
__device__ inline void dismiss(const cg::grid_group& g, Ctl* ctl) {
  if (threadIdx.x == 0) ctl->cmd = kExit;
  g.sync();
}

// The ordered combine of one source row: its per-slot minima d2[s * stride]
// for slots start .. start + cnt - 1, in slot order under a strict `<` from
// kBig. Returns the best d2 and sets *win to the winning slot, or -1.
__device__ __forceinline__ float combine(const float* d2, size_t stride, int start, int cnt,
                                         int* win) {
  float best = kBig;
  int w = -1;
  for (int q = 0; q < cnt; ++q) {
    const float m = __ldcg(d2 + (size_t)(start + q) * stride);
    if (m < best) {
      best = m;
      w = start + q;
    }
  }
  *win = w;
  return best;
}

// A first-row round (K3: 3-row target pages; K4: 6-row pages, xyz and the
// normal): the pair list and the per-slot scratch the workers fill, the
// tile's best d2 and first winning row for each source row.
struct FirstRound {
  const float* src;  // (nSt, 3, TM) sensor-frame source pages
  const float* tgt;  // (nTt, ROWS, TN) rebased target pages
  const int* ps;     // (nSt,) pair_start
  const int* pc;     // (nSt,) pair_cnt
  const int* pt;     // (max_pairs,) pair_tgt
  float* slot_d2;    // (max_pairs, TM)
  int* slot_row;     // (max_pairs, TM): -1 where no row beat kBig
  int nSt, TM, TN;
};

// One row of a first-row item under (R, t): point r of source tile i,
// transformed, scanned against slot s's one target tile pt[s] with
// icp_fused.cuh's `nearest_first`; the tile's best d2 and first winning
// row (-1 for none) go to the per-slot scratch.
template <int ROWS>
__device__ __forceinline__ void scan_first_row(const FirstRound& A, const Pose& X, int i, int s,
                                               int r) {
  const int TM = A.TM;
  const float* sp = A.src + (size_t)i * 3 * TM;
  const float px = sp[r], py = sp[TM + r], pz = sp[2 * TM + r];
  const float sx = X.R[0] * px + X.R[1] * py + X.R[2] * pz + X.t[0];
  const float sy = X.R[3] * px + X.R[4] * py + X.R[5] * pz + X.t[1];
  const float sz = X.R[6] * px + X.R[7] * py + X.R[8] * pz + X.t[2];
  const float* win;
  A.slot_d2[(size_t)s * TM + r] = nearest_first<ROWS>(A.tgt, A.pt, s, 1, A.TN, sx, sy, sz, &win);
  A.slot_row[(size_t)s * TM + r] =
      win ? (int)(win - (A.tgt + (size_t)A.pt[s] * ROWS * A.TN)) : -1;
}

// A worker's chunks of the round under the published (R, t): for item
// (tile i, slot s), thread r of the chunk scans its row (`scan_first_row`).
// No page is staged, so a block holds a group for each warp at most.
template <int ROWS>
__device__ void scan_first(const FirstRound& A, const Ctl* ctl) {
  const Pose X = read_pose(ctl);
  const int TM = A.TM;
  const int n = n_items(A.pc, A.nSt);
  const Chunks C = chunking(n, TM, blockDim.x / 32);
  const int h = threadIdx.x / C.rows;
  const int lr = threadIdx.x % C.rows;
  if (h >= C.groups) return;
  const int workers = n_workers();
  for (int c = h * workers + worker(); c < n * C.P; c += workers * C.groups) {
    const int r = (c % C.P) * C.rows + lr;
    if (r >= TM) continue;
    int s;
    const int i = item_at(c / C.P, A.ps, A.pc, &s);
    scan_first_row<ROWS>(A, X, i, s, r);
  }
}

// The ordered combine of point r of source tile i over its slots: returns
// the best d2 and sets *win to the address of the winner's row 0 (row k at
// win[k * TN]), or nullptr.
template <int ROWS>
__device__ __forceinline__ float combine_first_row(const FirstRound& A, int i, int r,
                                                   const float** win) {
  const int TM = A.TM;
  int w;
  const float best = combine(A.slot_d2 + r, TM, A.ps[i], A.pc[i], &w);
  *win = w < 0 ? nullptr
               : A.tgt + (size_t)A.pt[w] * ROWS * A.TN + __ldcg(A.slot_row + (size_t)w * TM + r);
  return best;
}

// The leader's combine of a first-row round: thread x takes the points
// x, x + blockDim.x, ... of the flat (tile, row) order, the layout the
// leader's moment sums read, so no barrier follows. `sink(i, r, best, win)`
// stores point r of tile i: its best d2 and the address of the winner's
// row 0 (row k at win[k * TN]), or nullptr.
template <int ROWS, class Sink>
__device__ void combine_first(const FirstRound& A, Sink&& sink) {
  const int TM = A.TM;
  for (int p = threadIdx.x; p < A.nSt * TM; p += blockDim.x) {
    const int i = p / TM;
    const int r = p - i * TM;
    const float* win;
    const float best = combine_first_row<ROWS>(A, i, r, &win);
    sink(i, r, best, win);
  }
}

// Host: the grid for `kernel` at `threads` a block and `smem` bytes of
// dynamic shared memory: one block on each multiprocessor. *per_sm is how
// many such blocks a multiprocessor could hold (the card's occupancy); the
// grid needs at least one, and a leader and a worker.
inline cudaError_t grid_size(const void* kernel, int threads, size_t smem, int* blocks,
                             int* per_sm) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (*per_sm < 1 || sms < 2) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms;
  return cudaSuccess;
}

// Host: the grid of an item-warp scan (K2, K5: ordinary launches, no grid
// barrier): one full wave of `threads`-thread blocks on every
// multiprocessor, fewer where the list's max_pairs x ceil(TM / 32)
// item-warps cannot fill it. *per_sm is how many blocks a multiprocessor
// could hold.
inline cudaError_t item_warp_grid(const void* kernel, int threads, int TM, int max_pairs,
                                  int* blocks, int* per_sm) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, 0);
  if (e != cudaSuccess) return e;
  const long long warps = (long long)max_pairs * ((TM + 31) / 32);
  const long long need = (warps + threads / 32 - 1) / (threads / 32);
  const long long full = (long long)sms * *per_sm;
  *blocks = (int)(need < full ? need : full);
  return cudaSuccess;
}

// Threads of a first-row kernel's blocks (K3, K4): the leader's layout of
// the one-block kernels, TM threads a source tile and as many tiles side
// by side as fit 1024 threads; wider tiles take 1024 threads, each owning
// rows x, x + 1024, ... of the flat order.
__host__ __device__ inline int first_threads(int nSt, int TM) {
  if (TM > 1024) return 1024;
  return TM * (nSt < 1024 / TM ? nSt : 1024 / TM);
}

}  // namespace grid
}  // namespace sfk

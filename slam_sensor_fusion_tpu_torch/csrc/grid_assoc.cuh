// Grid-wide association for the registration kernels K1 and K4: one
// persistent cooperative grid a launch, one leader block that runs the
// serial chain, and the other blocks scanning the pair list's tiles.
//
// The frame and GN loops are serial chains (each prior depends on the last
// solve); only the association is wide. So block 0, the LEADER, runs the
// kernel's serial work in the one-block kernels' layout (the moment sums,
// the scalar chain on thread 0), and each association is a ROUND over the
// grid:
//
//   1. the leader's thread 0 publishes (R, t), the frame and the command in
//      a control block in global memory (`Ctl`); a grid barrier;
//   2. every other block, a WORKER, takes work items from the pair list:
//      item j is (source tile i, admitted pair slot s) in tile order, slot
//      order within a tile. An item scans ONE target tile for a source
//      tile's rows and writes the tile's per-row winner to a scratch buffer
//      indexed by the slot (the caller's per-tile scan: K1 averages exact
//      ties, K4 keeps the first row). Items may be cut into chunks of
//      source rows, never of target rows, so a tile's scan runs in row
//      order as before. The leader scans nothing, so the scan is not
//      compiled into the leader's path, whose live state already spills;
//   3. a grid barrier; the leader combines each source row's per-slot
//      winners in slot order under the strict `<` of the one-block
//      kernels' running loop, starting from kBig, so the earlier tile keeps an exact
//      tie and a tile whose minimum is kBig never wins. The result equals
//      the running loop bit for bit.
//
// Workers `serve`: they wait at the barrier, read the command and either
// scan their items and meet the second barrier, or return. The grid must
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

// The leader's side of one round under (R, t) (every thread of the leader
// block calls it; R, t are read on thread 0 only): publish, then wait for
// the workers. The per-slot winners are then in the scratch buffer for the
// combine.
__device__ inline void lead_round(const cg::grid_group& g, Ctl* ctl, int frame, const float* R,
                                  const float* t) {
  if (threadIdx.x == 0) {
    for (int m = 0; m < 9; ++m) ctl->R[m] = R[m];
    for (int a = 0; a < 3; ++a) ctl->t[a] = t[a];
    ctl->frame = frame;
    ctl->cmd = kAssociate;
  }
  g.sync();
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

}  // namespace grid
}  // namespace sfk

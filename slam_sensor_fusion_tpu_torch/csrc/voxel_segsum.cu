// voxel_segment_sum: the order-exact segment sum of the device voxel stores.
//
// Not a port of a Pallas kernel. Both voxel stores of the JAX package
// reduce an insert group to one (sum, count) moment per voxel cell with an
// XLA scatter-add over sorted segment ids
// (slam_sensor_fusion_tpu/ops/voxel_map.py:203-208 and
// ops/voxel_map_sorted.py:175-183), which on the CPU adds each cell's rows
// one at a time in row order. On the card `index_add_` adds with atomics in
// an order that changes from run to run, so the cell sums would move by ulps
// and the two stores (and a CPU run) would no longer agree bit for bit.
// This kernel fixes the order: each output element is 0.0 plus its
// segment's rows added one at a time, first row first.
//
// What bounds it on an H100: the bytes (S rows of C floats and S int32 ids
// read once, U x C floats written once: ~2.6 MB at a 131072-point group,
// under a microsecond at 3.35 TB/s). What bounds this design is the
// longest segment: its rows are one dependent chain of float additions on
// one thread. A tree or warp reduction would shorten it and change the
// bits, so there is none.
//
// Design: one thread per output element (segment u, column c). It finds
// its segment's rows [lo, hi) by two binary searches over the sorted ids
// (lower bounds of u and u + 1) and adds values[r, c] for r = lo .. hi - 1
// in order. The loads of a run do not depend on the sum: they are issued
// kBatch rows at a time into registers before that batch's additions, so
// a long run (a padded group's masked rows all alias one segment) keeps
// several cache lines in flight instead of waiting on each line in turn.
// A segment with no rows writes 0.0; rows whose id is
// negative or U or more belong to no output element (the stores clip ids
// to U - 1 before the call, with zero payload, voxel_map_sorted.py:172-178).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 32;  // rows loaded ahead of their additions

// first index in seg[0, n) whose id is >= key (seg nondecreasing)
__device__ __forceinline__ int lower_bound(const int* __restrict__ seg, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (seg[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    segment_sum_sorted_kernel(const float* __restrict__ values, const int* __restrict__ seg,
                              int S, int C, int U, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(U) * C) return;
  const int u = static_cast<int>(t / C);
  const int c = static_cast<int>(t % C);
  const int lo = lower_bound(seg, S, u);
  const int hi = lower_bound(seg, S, u + 1);
  const float* __restrict__ col = values + c;
  float acc = 0.0f;
  int r = lo;
  for (; hi - r >= kBatch; r += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) v[k] = col[static_cast<long long>(r + k) * C];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) acc += v[k];
  }
  for (; r < hi; ++r) acc += col[static_cast<long long>(r) * C];
  out[t] = acc;
}

}  // namespace

// out (U, C) = the segment sums of values (S, C) over the nondecreasing
// ids seg (S,), each in row order. Returns the launch's cudaError_t.
extern "C" int sfk_segment_sum_sorted(const float* values, const int* seg, int S, int C, int U,
                                      float* out, cudaStream_t stream) {
  if (S < 0 || C < 1 || U < 1) return (int)cudaErrorInvalidValue;
  const long long n = static_cast<long long>(U) * C;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_sum_sorted_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      values, seg, S, C, U, out);
  return (int)cudaGetLastError();
}

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
// segment's rows added one at a time, first row first. Rows whose id is
// negative or U or more belong to no output element; an id with no rows
// gets 0.0. There are no atomics and no tree: a tree or a warp reduction
// would shorten a segment's chain and change its bits.
//
// What bounds it on an H100: the bytes (S rows of 4 floats and S int32 ids
// read once, U x 4 floats written once: ~2.6 MB at a 131072-point group,
// under a microsecond at 3.35 TB/s), and, for a group with a long segment,
// that segment's chain of dependent float additions (one add of latency
// ~4 cycles a row: ~0.025 ms for a run of 10 000 rows).
//
// Design: parallel over rows, not over outputs (the first design gave each
// output element a thread and two binary searches over all S ids).
//   - The rows are cut into tiles of kTileRows; a persistent grid of blocks
//     walks the tiles b, b + gridDim.x, ... and stages each tile's rows
//     and the kHalo rows after it (one float4 a row: C = 4, as every
//     caller has) and their ids in shared memory with cp.async,
//     double-buffered: the next tile's copies are in flight while the
//     block works on this one.
//   - A row starts a segment where its id differs from the row before. The
//     thread that owns a start finds the segment's end among the staged
//     rows by a binary search over their ids, chains its rows from shared
//     memory in row order (4 independent chains, one a column) and writes
//     it; it also writes 0.0 to the ids skipped between the previous row's
//     id and this one (empty segments). The ids before the first row's and
//     after the last row's are written by the whole grid, stride by stride.
//   - A segment that starts in the tile and ends in its halo is thus
//     chained whole by its thread. One that runs past the halo (at most one
//     a tile: the tile's last) is finished by the whole block after the
//     tile: from the staged rows' partial sum, the block stages the
//     following rows kRunRows at a time (the first stage alone, then a
//     ring of kStages stages of cp.async copies, several in flight), finds
//     the run's end with a ballot on the ids, and four lanes of one warp, a
//     column each, add the stage's rows of the run in order from shared
//     memory, loads issued ahead of the additions, so the chain runs at the
//     add's latency (one add a row a lane). Rows whose payload is +0.0 or
//     -0.0 in every column are skipped (found by a ballot): the running sum
//     starts at +0.0 and never becomes -0.0 under round-to-nearest (+0 +
//     -0 = +0, x + -x = +0), and s + (+-0.0) = s for every s that is not
//     -0.0, NaN included, so skipping them moves no bit. A run of masked
//     rows aliased to one id (the stores clip them to U - 1 with zero
//     payload) is thus only read, and a long nonzero run costs its chain.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 512;  // rows a tile: 2 a thread
constexpr int kHalo = 64;       // rows after a tile staged with it
constexpr int kRunRows = 512;   // rows a stage of a long run: 2 a thread
constexpr int kStages = 6;      // a long run's ring of stages
constexpr int kChunks = kRunRows / 32;  // 32-row chunks of a stage, one ballot each

// Dynamic shared memory: two tile buffers, then the run ring.
struct Smem {
  float4 tile_v[2][kTileRows + kHalo];
  int tile_id[2][kTileRows + kHalo];
  float4 run_v[kStages][kRunRows];
  int run_id[kStages][kRunRows];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x = a.x + v.x;
  a.y = a.y + v.y;
  a.z = a.z + v.z;
  a.w = a.w + v.w;
}

__device__ __forceinline__ bool zero4(const float4& v) {
  return v.x == 0.0f && v.y == 0.0f && v.z == 0.0f && v.w == 0.0f;
}

// 0.0 into out[u] for the ids u in [lo, hi) within [0, U).
__device__ __forceinline__ void zero_ids(float4* out, long long lo, long long hi, int U) {
  lo = lo < 0 ? 0 : lo;
  hi = hi > U ? U : hi;
  for (long long u = lo; u < hi; ++u) out[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Stage rows [t0, t0 + n) of a tile into buffer b (this thread's share),
// as one commit group.
__device__ __forceinline__ void load_tile(Smem& sm, int b, const float4* values, const int* seg,
                                          int t0, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    cp_async16(&sm.tile_v[b][i], values + t0 + i);
    cp_async4(&sm.tile_id[b][i], seg + t0 + i);
  }
  cp_async_commit();
}

// Stage s of a long run starting at row r: rows r + s * kRunRows + i, i =
// tid, tid + kThreads, into ring slot s % kStages, as one commit group
// (empty past S).
__device__ __forceinline__ void load_stage(Smem& sm, const float4* values, const int* seg,
                                           long long r, int s, int S) {
#pragma unroll
  for (int i = threadIdx.x; i < kRunRows; i += kThreads) {
    const long long row = r + (long long)s * kRunRows + i;
    if (row < S) {
      cp_async16(&sm.run_v[s % kStages][i], values + row);
      cp_async4(&sm.run_id[s % kStages][i], seg + row);
    }
  }
  cp_async_commit();
}

// acc += v[0], v[1], ..., v[n - 1] in order, software-pipelined: the next
// 8 rows are loaded while the last 8 are added, so the loads do not wait
// on the chain and the chain runs at the adds' latency.
__device__ __forceinline__ void chain(float4& acc, const float4* v, int n) {
  int r = 0;
  if (n >= 8) {
    float4 x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = v[j];
    for (r = 8; r + 8 <= n; r += 8) {
      float4 y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = v[r + j];
#pragma unroll
      for (int j = 0; j < 8; ++j) add4(acc, x[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = y[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) add4(acc, x[j]);
  }
  for (; r < n; ++r) add4(acc, v[r]);
}

// acc += col[0], col[4], ..., col[4 (n - 1)] in order: one column of n
// staged rows, on the lane that owns the column. Ping-ponged: 8 rows are
// loaded while the 8 before them are added, so the chain runs at the add's
// latency.
__device__ __forceinline__ float chain_col(float acc, const float* col, int n) {
  int r = 0;
  if (n >= 16) {
    float x[8], y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = col[4 * j];
    for (r = 8; r + 16 <= n; r += 16) {
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = col[4 * (r + j)];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = acc + x[j];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = col[4 * (r + 8 + j)];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = acc + y[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = acc + x[j];
  }
  for (; r < n; ++r) acc = acc + col[4 * r];
  return acc;
}

// The rest of a segment of id u from row r on, after the partial sum
// s_acc of its first rows (every thread of the block calls it). Lanes 0-3
// of warp 0 own the columns: lane c adds column c of the run's rows in row
// order and returns its sum (the other threads return 0.0). Stage 0 is
// staged alone (most such runs end in it); a run that outlives it fills
// the ring, kStages - 1 stages in flight, stage s + kStages - 2 going into
// the slot of stage s - 2, which warp 0 finished before the barrier that
// opened stage s - 1. The caller's own copies in flight are whole commit
// groups.
__device__ float finish_run(Smem& sm, const float4* values, const int* seg, int S, long long r,
                            int u, const float4& s_acc) {
  __shared__ unsigned in_run[2][kChunks], nonzero[2][kChunks];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane & 3;  // the column of lanes 0-3 of warp 0
  float acc = reinterpret_cast<const float*>(&s_acc)[c];
  load_stage(sm, values, seg, r, 0, S);
  for (int s = 0;; ++s) {
    if (s == 0) {
      cp_async_wait<0>();
    } else {
      if (s == 1) {
#pragma unroll
        for (int q = 1; q < kStages; ++q) load_stage(sm, values, seg, r, q, S);
      } else {
        load_stage(sm, values, seg, r, s + kStages - 2, S);
      }
      cp_async_wait<kStages - 2>();
    }
    __syncthreads();
    const int b = s % kStages, h = s & 1;
#pragma unroll
    for (int k = warp; k < kChunks; k += kThreads / 32) {  // chunk k: rows 32k ..
      const int i = k * 32 + lane;
      const bool in = r + (long long)s * kRunRows + i < S && sm.run_id[b][i] == u;
      const bool nz = in && !zero4(sm.run_v[b][i]);
      const unsigned m_in = __ballot_sync(0xffffffffu, in);
      const unsigned m_nz = __ballot_sync(0xffffffffu, nz);
      if (lane == 0) {
        in_run[h][k] = m_in;
        nonzero[h][k] = m_nz;
      }
    }
    __syncthreads();
    if (warp == 0) {
      // warp 0 reads the chunks' masks a lane each: a stage with no
      // nonzero row of the run is skipped, a dense one chained whole
      const unsigned m = lane < kChunks ? nonzero[h][lane] : 0xffffffffu;
      const bool any = __any_sync(0xffffffffu, lane < kChunks && m != 0u);
      const bool dense = __all_sync(0xffffffffu, m == 0xffffffffu);
      if (lane < 4 && any) {
        const float* col = reinterpret_cast<const float*>(sm.run_v[b]) + c;
        if (dense) {
          acc = chain_col(acc, col, kRunRows);
        } else {
          for (int k = 0; k < kChunks; ++k) {
            unsigned mk = nonzero[h][k];
            if (mk == 0xffffffffu) {
              acc = chain_col(acc, col + 4 * 32 * k, 32);
            } else {
              while (mk) {
                const int j = __ffs(mk) - 1;
                mk &= mk - 1;
                acc = acc + col[4 * (32 * k + j)];
              }
            }
          }
        }
      }
    }
    // ids are nondecreasing: the run ended in this stage unless its last
    // row is still in it
    if ((in_run[h][kChunks - 1] >> 31) == 0) break;
  }
  cp_async_wait<0>();
  return warp == 0 && lane < 4 ? acc : 0.0f;
}

__global__ void __launch_bounds__(kThreads) segment_sum_sorted_kernel(
    const float4* __restrict__ values, const int* __restrict__ seg, int S, int U,
    float4* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  __shared__ int s_run;      // id of the tile's last segment if it runs past the tile, else -1
  __shared__ float4 s_acc;   // that segment's sum over the tile's rows

  // the empty ids before the first row's and after the last row's
  const long long first = S > 0 ? seg[0] : U;
  const long long last = S > 0 ? seg[S - 1] : (long long)U - 1;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long u = g; u < first && u < U; u += stride)
    out[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long u = (last + 1 > 0 ? last + 1 : 0) + g; u < U; u += stride)
    out[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  const int n_tiles = (S + kTileRows - 1) / kTileRows;
  int tile = blockIdx.x;
  if (tile < n_tiles)
    load_tile(sm, 0, values, seg, tile * kTileRows, min(kTileRows + kHalo, S - tile * kTileRows));
  for (int k = 0; tile < n_tiles; tile += gridDim.x, ++k) {
    const int b = k & 1;
    const int t0 = tile * kTileRows;
    const int n = min(kTileRows, S - t0);
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      load_tile(sm, b ^ 1, values, seg, next * kTileRows,
                min(kTileRows + kHalo, S - next * kTileRows));
    } else {
      cp_async_commit();  // an empty group keeps the count
    }
    if (threadIdx.x == 0) s_run = -1;
    cp_async_wait<1>();  // this tile's copies (the next tile's may still fly)
    __syncthreads();
    const int* id = sm.tile_id[b];
    const float4* v = sm.tile_v[b];
    const int staged = min(kTileRows + kHalo, S - t0);  // the tile and its halo
    const bool more = t0 + staged < S;
    const int next_id = more ? __ldg(seg + t0 + staged) : 0;
    for (int j = 0; j < kTileRows / kThreads; ++j) {
      const int i = threadIdx.x * (kTileRows / kThreads) + j;
      if (i >= n) break;
      const int u = id[i];
      if (i > 0 || t0 > 0) {  // row 0 of the group starts a segment; its head gap is the grid's
        const int prev = i > 0 ? id[i - 1] : __ldg(seg + t0 - 1);
        if (u == prev) continue;  // not a segment's first row
        zero_ids(out, (long long)prev + 1, u, U);
      }
      if (u < 0 || u >= U) continue;  // belongs to no output
      // the segment's end in the staged rows: the first row of a larger id
      // (a binary search over the sorted ids), then its rows in order
      int lo = i + 1, hi = staged;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (id[mid] == u) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const int e = lo;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      chain(acc, v + i, e - i);
      if (e == staged && more && next_id == u) {  // runs past the halo: the block finishes it
        s_run = u;
        s_acc = acc;
      } else {
        out[u] = acc;
      }
    }
    __syncthreads();
    const int run = s_run;
    if (run >= 0) {  // block-uniform
      const float acc = finish_run(sm, values, seg, S, (long long)t0 + staged, run, s_acc);
      if (threadIdx.x < 4) reinterpret_cast<float*>(out + run)[threadIdx.x] = acc;
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();
}

}  // namespace

// out (U, 4) = the segment sums of values (S, 4) over the nondecreasing
// ids seg (S,), each in row order (values 16-byte aligned). Returns the
// launch's cudaError_t.
extern "C" int sfk_segment_sum_sorted(const float* values, const int* seg, int S, int C, int U,
                                      float* out, cudaStream_t stream) {
  if (S < 0 || C != 4 || U < 1 || reinterpret_cast<uintptr_t>(values) % 16)
    return (int)cudaErrorInvalidValue;
  // the grid: every tile a block, at most the blocks the card holds at once;
  // the card's shape asked once a device in a host thread
  struct Shape {
    int dev, sms, per_sm;
  };
  thread_local Shape shape = {-1, 0, 0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int smem = (int)sizeof(Smem);
  if (shape.dev != dev) {
    e = cudaFuncSetAttribute(segment_sum_sorted_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_sum_sorted_kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    shape = {dev, sms, per_sm};
  }
  const long long n_tiles = ((long long)S + kTileRows - 1) / kTileRows;
  const long long full = (long long)shape.sms * shape.per_sm;
  const int blocks = (int)(n_tiles < 1 ? 1 : (n_tiles < full ? n_tiles : full));
  segment_sum_sorted_kernel<<<blocks, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(values), seg, S, U, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

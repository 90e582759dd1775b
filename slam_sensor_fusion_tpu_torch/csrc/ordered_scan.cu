// cumsum_rows: the prefix sum along the rows of an (N, C) float32 array in
// XLA's order of addition.
//
// Not a port of a Pallas kernel. The cell normals of the LIO anchor
// (ops/point_to_plane.estimate_normals_cells) take each cell's moments as
// differences of a float32 prefix sum at world coordinates; in the JAX
// package that sum is `jnp.cumsum` (slam_sensor_fusion_tpu/ops/
// point_to_plane.py:333), which XLA on the CPU computes as a blocked scan:
// blocks of 16 rows, each summed row by row from +0.0 (a one-row input is
// returned as it is); the block totals
// scanned recursively the same way; the exclusive prefix of the totals
// added to every row of its block (+0.0 to block 0). The sums reach ~1e6
// while a cell's variance is ~1e-2, so the order decides thin cells'
// normals; `torch.cumsum` on the card (CUB's scan) adds in another. This
// kernel computes the same tree of additions, so its output equals the
// plain version (ops/ordered_scan.cumsum_rows_plain) bit for bit: there
// are only additions, and each is the same pair of operands.
//
// What bounds it on an H100: the bytes, N x C floats read and N x C
// written once (5.2 MB at the LIO bench's 65 536-row ring of 10 columns:
// ~1.6 us at 3.35 TB/s); the levels above the first are 1/16 of it.
//
// Design: one pass, one cooperative launch a call. Each element is read
// once and written once; the chunks' totals go through a tree of flagged
// items in the scratch (decoupled look-back, in the tree's own order).
//   1. A chunk is 16^LV rows (LV = 2: 256 rows while they fit a block's
//      shared memory, else LV = 1: 16 rows), aligned to the tree, so its
//      lower LV levels are the tree's own. The grid is every block that is
//      resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor;
//      the cooperative launch guarantees it, and a launch the card refuses
//      returns its error, with no fallback); block b takes chunks b, b +
//      grid, ... in order. It stages a chunk with cp.async (the next one
//      while it finishes the current), scans its 16-row blocks from +0.0
//      (one thread a block and column), then, for LV = 2, the chunk's 16
//      block totals.
//   2. The chunks' totals are level 0 of a tree of items (C floats and a
//      flag each); item g of level k + 1 is the sum from +0.0 of items
//      16g .. 16g + 15 of level k, up to the first level of 16 items or
//      fewer. A block publishes its chunk's total (values, fence, flag);
//      if that is the 16th item of a group, it waits for the group's other
//      15, publishes their sum one level up, and so on.
//   3. The final value of item j of level k (the tree's inclusive prefix
//      there) is the scan of j's group up to j, plus the final value of
//      the group before it one level up (+0.0 for the first group). A
//      chunk reads that for its predecessors (the items it needs are all
//      of earlier chunks), adds it down its levels as the tree does, and
//      writes its rows from shared memory.
// The flags are zeroed by the grid before one grid barrier, which each
// block passes once its first chunk is scanned. A block waits (every
// thread polling one flag with an acquiring load, the block voting) only
// for chunks of lower index, and the block holding the lowest chunk in
// progress waits for none, so the waits end. A wait that lasts past ~2 s
// traps (a fault in the kernel, not a hang of the card).
// Padded rows of a partial block are not added (XLA adds +0.0 there, which
// changes no sum that starts from +0.0).
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 16;      // a block of the scan (ops/ordered_scan.BLOCK_ROWS)
constexpr int kThreads = 256;  // threads a block
constexpr int kMaxC = 256;     // widest row
constexpr int kSmemLv2 = 48 * 1024;  // the most shared memory an LV = 2 chunk takes
constexpr int kMaxLevels = 8;  // levels of the totals' tree: 16^8 chunks exceed 2^31 rows
constexpr long long kSpinCycles = 1LL << 32;  // a wait past this many clocks traps

// kernels this library launched (sfk_cumsum_kernel_launches)
long long g_launches = 0;

// Shared memory of a block: the tree's level offsets (kMaxLevels + 1 long
// longs); two chunks, one staged while the other is scanned, each its
// 16-row blocks of 16 x C floats padded by one word (so the threads of one
// column in neighbouring blocks fall in other banks), then for LV = 2 the
// 16 block totals' scan (16 x C); then the chunk's prefixes (3 x C: the
// final values before it and before its first 16-row block, the total it
// publishes); then the look-back's group sums (2 chains x kMaxLevels x C).
__host__ __device__ constexpr int pitch(int C) { return kRows * C + 1; }
__host__ __device__ constexpr int level_floats(int lv, int C) {
  return lv == 2 ? kRows * pitch(C) + kRows * C : pitch(C);
}
constexpr int kOffFloats = 2 * (kMaxLevels + 1);
__host__ __device__ constexpr int chunk_floats(int lv, int C) {
  return kOffFloats + 2 * level_floats(lv, C) + 3 * C + 2 * kMaxLevels * C;
}
__host__ __device__ constexpr int lv_of(int C) {
  return level_floats(2, C) * (int)sizeof(float) <= kSmemLv2 ? 2 : 1;
}

// The tree of the chunks' totals: level k's items are [off[k], off[k + 1])
// of the scratch, C floats each, then one int flag an item after them all.
struct Tree {
  long long off[kMaxLevels + 1];
  int levels;
};

__host__ __device__ inline Tree make_tree(long long n_chunks) {
  Tree t{};
  long long n = n_chunks;
  int L = 0;
  for (;;) {
    t.off[L + 1] = t.off[L] + n;
    ++L;
    if (n <= kRows || L == kMaxLevels) break;
    n = (n + kRows - 1) / kRows;
  }
  t.levels = L;
  return t;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The block waits until the flag of each thread's `item` is set (-1: none),
// each thread polling its own with an acquiring load, all voting at once.
__device__ void wait_items(const int* __restrict__ flags, long long item) {
  int ok = item < 0 || ld_acquire(flags + item);
  const long long t0 = clock64();
  while (!__syncthreads_and(ok)) {
    if (!ok) ok = ld_acquire(flags + item);
    if (clock64() - t0 > kSpinCycles) __trap();
  }
}

// Item t of the items that the final value of item j of level 0 takes: its
// group up to it, then the group up to j / 16 - 1 one level up, and so on
// (the look-back's loads); -1 past them, with t reduced by their number.
__device__ __forceinline__ long long chain_item(const long long* off, long long j, int& t) {
  for (int l = 0;; ++l) {
    const long long first = j - j % kRows;
    const int cnt = (int)(j - first) + 1;
    if (t < cnt) return off[l] + first + t;
    t -= cnt;
    if (j < kRows) return -1;
    j = j / kRows - 1;
  }
}

// The sum from +0.0 of items first .. first + cnt - 1 (cnt <= 16) of column
// c, in order: the scan of a group of the tree up to its last item.
__device__ __forceinline__ float group_sum(const float* __restrict__ vals, long long first,
                                           int cnt, int C, int c) {
  float v[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
    if (m < cnt) v[m] = __ldcg(vals + (first + m) * C + c);
  float acc = __fadd_rn(0.0f, v[0]);
#pragma unroll
  for (int m = 1; m < kRows; ++m)
    if (m < cnt) acc = __fadd_rn(acc, v[m]);
  return acc;
}

// Stage chunk `ch` (rows [ch R, ch R + R) of x, the last chunk partial)
// into its 16-row blocks in shared memory with cp.async. Returns its rows.
template <int LV>
__device__ __forceinline__ int stage(const float* __restrict__ x, long long N, int C,
                                     long long ch, float* sm) {
  constexpr int R = LV == 2 ? kRows * kRows : kRows;
  const long long row0 = ch * R;
  const int rows = N - row0 < R ? (int)(N - row0) : R;
  const int per_block = kRows * C;
  const float* src = x + row0 * C;
  for (int e = threadIdx.x; e < rows * C; e += kThreads) {
    const int b = e / per_block;
    __pipeline_memcpy_async(sm + b * pitch(C) + (e - b * per_block), src + e, sizeof(float));
  }
  __pipeline_commit();
  return rows;
}

// Scan a staged chunk's levels in shared memory: the blocks' rows from
// +0.0 (a one-row scan left as it is, as XLA leaves it), and for LV = 2
// the blocks' totals into sm + 16 pitch(C).
template <int LV>
__device__ void scan_chunk(long long N, int C, int rows, float* sm) {
  const int nb = (rows + kRows - 1) / kRows;
  float* tot1 = sm + kRows * pitch(C);
  for (int it = threadIdx.x; it < nb * C; it += kThreads) {
    const int b = it / C, c = it - b * C;
    float* col = sm + b * pitch(C) + c;
    const int nr = rows - b * kRows < kRows ? rows - b * kRows : kRows;
    float acc = N == 1 ? col[0] : __fadd_rn(0.0f, col[0]);
    col[0] = acc;
    for (int j = 1; j < nr; ++j) {
      acc = __fadd_rn(acc, col[j * C]);
      col[j * C] = acc;
    }
    if (LV == 2) tot1[b * C + c] = acc;
  }
  __syncthreads();
  if (LV == 2) {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float acc = __fadd_rn(0.0f, tot1[c]);
      tot1[c] = acc;
      for (int b = 1; b < nb; ++b) {
        acc = __fadd_rn(acc, tot1[b * C + c]);
        tot1[b * C + c] = acc;
      }
    }
    __syncthreads();
  }
}

// The address of the chunk's total of column c: the last of its top
// level's scan.
template <int LV>
__device__ __forceinline__ float* chunk_total(float* sm, int rows, int C, int c) {
  const int nb = (rows + kRows - 1) / kRows;
  if (LV == 2) return sm + kRows * pitch(C) + (nb - 1) * C + c;
  return sm + (rows - 1) * C + c;
}

// Publish item j of level 0 (the chunk's total), and each total one level
// up that it completes: values, a fence by each writer, the flag.
template <int LV>
__device__ void publish(const long long* off, int levels, float* __restrict__ vals,
                        int* __restrict__ flags, int C, long long j, float* sm, int rows,
                        float* cur) {
  for (int c = threadIdx.x; c < C; c += kThreads) cur[c] = *chunk_total<LV>(sm, rows, C, c);
  for (int k = 0;; ++k) {
    const long long item = off[k] + j;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      vals[item * C + c] = cur[c];
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) *(volatile int*)(flags + item) = 1;
    if (k + 1 >= levels || j % kRows != kRows - 1) break;
    // the 16th item of its group: the group's sum is item j / 16 one up
    const long long first = item - (kRows - 1);
    wait_items(flags, threadIdx.x < kRows - 1 ? first + threadIdx.x : -1);
    for (int c = threadIdx.x; c < C; c += kThreads)
      cur[c] = __fadd_rn(group_sum(vals, first, kRows - 1, C, c), cur[c]);
    j /= kRows;
  }
}

// The chunk's prefixes added down its levels as the tree adds them, and its
// rows written. pre[0 .. C): the final value before the chunk (+0.0 for
// chunk 0); for LV = 2, pre[C .. 2C): the final value before its first
// 16-row block (the predecessor's total plus the final value before the
// predecessor; +0.0 for chunk 0).
template <int LV>
__device__ void add_down_and_write(float* sm, int rows, int C, long long ch, long long N,
                                   const float* pre, float* __restrict__ out) {
  constexpr int R = LV == 2 ? kRows * kRows : kRows;
  const int per_block = kRows * C;
  float* tot1 = sm + kRows * pitch(C);
  if (LV == 2 && N > 1) {
    const int nb = (rows + kRows - 1) / kRows;
    for (int it = threadIdx.x; it < nb * C; it += kThreads)
      tot1[it] = __fadd_rn(tot1[it], pre[it % C]);
    __syncthreads();
  }
  float* dst = out + ch * R * C;
  for (int e = threadIdx.x; e < rows * C; e += kThreads) {
    const int b = e / per_block, c = e % C;
    const float v = sm[b * pitch(C) + (e - b * per_block)];
    const float add = LV == 1 ? pre[c] : b > 0 ? tot1[(b - 1) * C + c] : pre[C + c];
    dst[e] = N > 1 ? __fadd_rn(v, add) : v;
  }
}

// The levels a chain of final values climbs from item j of level 0.
__device__ __forceinline__ int chain_depth(long long j) {
  int K = 0;
  for (; j >= kRows; j = j / kRows - 1) ++K;
  return K;
}

// The final value of a chain from its group sums s[l * C + c], l = 0 .. K:
// the top's plus +0.0, then each level's plus the one above it.
__device__ __forceinline__ float chain_final(const float* s, int K, int C, int c) {
  float f = __fadd_rn(s[K * C + c], 0.0f);
  for (int l = K - 1; l >= 0; --l) f = __fadd_rn(s[l * C + c], f);
  return f;
}

// Four blocks a multiprocessor (64 registers): at 2^20 + 3 rows the chunks
// take 8 rounds of the grid, not 10 (PERF.md §6).
template <int LV>
__global__ void __launch_bounds__(kThreads, 4)
    scan_rows_kernel(const float* __restrict__ x, long long N, int C, float* __restrict__ out,
                     float* __restrict__ vals, Tree tr) {
  extern __shared__ float sm[];
  long long* off = (long long*)sm;
  float* const bufs = sm + kOffFloats;
  const int lf = level_floats(LV, C);
  float* pre = bufs + 2 * lf;  // the prefixes, then the published total
  float* sums = pre + 3 * C;   // the look-back's group sums, two chains
  if (threadIdx.x <= kMaxLevels) off[threadIdx.x] = tr.off[threadIdx.x];
  const int levels = tr.levels;
  int* flags = (int*)(vals + tr.off[levels] * C);
  const long long n_chunks = tr.off[1];
  long long ch = blockIdx.x;
  int rows = ch < n_chunks ? stage<LV>(x, N, C, ch, bufs) : 0, b = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < tr.off[levels];
       i += (long long)gridDim.x * kThreads)
    flags[i] = 0;
  for (; ch < n_chunks; ch += gridDim.x, b ^= 1) {
    float* buf = bufs + b * lf;
    __pipeline_wait_prior(0);
    __syncthreads();
    scan_chunk<LV>(N, C, rows, buf);
    if (ch == blockIdx.x) cg::this_grid().sync();  // every flag zeroed
    const int rows_now = rows;
    if (ch + gridDim.x < n_chunks) rows = stage<LV>(x, N, C, ch + gridDim.x, bufs + (b ^ 1) * lf);
    if (n_chunks > 1) {
      publish<LV>(off, levels, vals, flags, C, ch, buf, rows_now, pre + 2 * C);
      // the items the prefixes take: the final value before the chunk; for
      // LV = 2 also the predecessor's total and the final value before it
      int t = threadIdx.x;
      long long item = ch >= 1 ? chain_item(off, ch - 1, t) : -1;
      if (item < 0 && LV == 2 && ch >= 2) item = chain_item(off, ch - 2, t);
      wait_items(flags, item);
      // the group sums of both chains' levels at once, a thread a (chain,
      // level, column): chain A's final value is the one before the chunk,
      // chain B's (LV = 2) the one before its predecessor
      const int KA = ch >= 1 ? chain_depth(ch - 1) : -1;
      const int KB = LV == 2 && ch >= 2 ? chain_depth(ch - 2) : -1;
      const int nA = (KA + 1) * C;
      for (int it = threadIdx.x; it < nA + (KB + 1) * C; it += kThreads) {
        const int r = it < nA ? it : it - nA, l = r / C, c = r - l * C;
        long long j = it < nA ? ch - 1 : ch - 2;
        for (int i = 0; i < l; ++i) j = j / kRows - 1;
        const long long first = j - j % kRows;
        sums[(it < nA ? 0 : kMaxLevels * C) + r] =
            group_sum(vals, off[l] + first, (int)(j - first) + 1, C, c);
      }
      __syncthreads();
      if (threadIdx.x < C) {
        pre[threadIdx.x] = ch == 0 ? 0.0f : chain_final(sums, KA, C, threadIdx.x);
      } else if (LV == 2 && threadIdx.x < 2 * C) {
        const int c = threadIdx.x - C;
        pre[C + c] = ch == 0 ? 0.0f
                             : __fadd_rn(__ldcg(vals + (ch - 1) * C + c),
                                         ch == 1 ? 0.0f
                                                 : chain_final(sums + kMaxLevels * C, KB, C, c));
      }
    } else {
      for (int c = threadIdx.x; c < 2 * C; c += kThreads) pre[c] = 0.0f;
    }
    __syncthreads();
    add_down_and_write<LV>(buf, rows_now, C, ch, N, pre, out);
  }
}

template <int LV>
long long scratch_floats(long long N, int C) {
  constexpr int R = LV == 2 ? kRows * kRows : kRows;
  const Tree tr = make_tree((N + R - 1) / R);
  return tr.off[tr.levels] * (C + 1);
}

template <int LV>
int launch_scan(const float* x, long long N, int C, float* out, float* scratch,
                long long scratch_floats_given, cudaStream_t stream) {
  constexpr int R = LV == 2 ? kRows * kRows : kRows;
  const long long n_chunks = (N + R - 1) / R;
  if (scratch_floats<LV>(N, C) > scratch_floats_given) return (int)cudaErrorInvalidValue;
  Tree tr = make_tree(n_chunks);
  const int smem = chunk_floats(LV, C) * (int)sizeof(float);
  auto kernel = scan_rows_kernel<LV>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long resident = (long long)per_sm * sms;
  const int blocks = (int)(n_chunks < resident ? n_chunks : resident);
  void* args[] = {(void*)&x, (void*)&N, (void*)&C, (void*)&out, (void*)&scratch, (void*)&tr};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kThreads), args,
                                  (size_t)smem, stream);
  if (e == cudaSuccess) ++g_launches;
  return (int)e;
}

}  // namespace

// The floats of scratch that sfk_cumsum_rows takes for an (N, C) input:
// the items of the totals' tree, C floats and an int flag each.
extern "C" long long sfk_cumsum_scratch_floats(int N, int C) {
  if (N <= 0 || C < 1 || C > kMaxC) return 0;
  return lv_of(C) == 2 ? scratch_floats<2>(N, C) : scratch_floats<1>(N, C);
}

// out (N, C) = the prefix sum of x (N, C) along the rows in XLA's blocked
// order, in one cooperative launch; scratch holds scratch_floats floats
// (at least sfk_cumsum_scratch_floats(N, C)). C from 1 to 256. Returns the
// launch's cudaError_t.
extern "C" int sfk_cumsum_rows(const float* x, int N, int C, float* out, float* scratch,
                               long long scratch_floats, cudaStream_t stream) {
  if (N < 0 || C < 1 || C > kMaxC || scratch_floats < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  if (lv_of(C) == 2) return launch_scan<2>(x, N, C, out, scratch, scratch_floats, stream);
  return launch_scan<1>(x, N, C, out, scratch, scratch_floats, stream);
}

// The scan kernels this library has launched since it was loaded: a call's
// launches are the difference across it.
extern "C" long long sfk_cumsum_kernel_launches() { return g_launches; }

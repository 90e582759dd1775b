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
// Design, simple first: one launch a level up, one a level down.
//   - Up, at level l (n_l rows; level 0 the input): a block of threads
//     stages 16 T consecutive rows (T = 256 / C row blocks) in shared
//     memory with coalesced loads, one thread a (row block, column) chains
//     its 16 rows from +0.0 in place, the rows go back coalesced, and the
//     block's total goes to level l + 1 (n_l / 16 rows, in the scratch).
//     The top level (16 rows or fewer) is one block: its prefix is final.
//   - Down, from the top: every element of level l gets the final prefix
//     of level l + 1 at its block's predecessor added (+0.0 for block 0).
// Above level 0 an up launch writes its level in place (v == p): each
// block reads its rows before the barrier and writes them after.
// Padded rows of a partial block are not added (XLA adds +0.0 there, which
// changes no sum that starts from +0.0).
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;       // a block of the scan (ops/ordered_scan.BLOCK_ROWS)
constexpr int kThreads = 256;   // threads of an up launch; also its widest C
constexpr int kMaxLevels = 12;  // 16^8 > 2^31 rows

// Shared memory of an up block: T row blocks of kRows x C floats, each
// padded by one word so the threads of one column in neighbouring row
// blocks fall in other banks.
__host__ __device__ constexpr int stride(int C) { return kRows * C + 1; }

__global__ void __launch_bounds__(kThreads) scan_up_kernel(const float* v, int n, int C, float* p,
                                                           float* __restrict__ totals) {
  extern __shared__ float sm[];
  const int T = kThreads / C;
  const long long row0 = (long long)blockIdx.x * T * kRows;
  const long long left = n - row0;
  const int rows = left < (long long)T * kRows ? (int)left : T * kRows;
  const int elems = rows * C;
  const int per_block = kRows * C;
  const float* src = v + row0 * C;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int b = e / per_block;
    sm[b * stride(C) + (e - b * per_block)] = src[e];
  }
  __syncthreads();
  const int b = threadIdx.x / C, c = threadIdx.x - (threadIdx.x / C) * C;
  if (b < T && b * kRows < rows) {
    float* col = sm + b * stride(C) + c;
    const int nr = rows - b * kRows < kRows ? rows - b * kRows : kRows;
    // from +0.0, but a scan of one row is left as it is (XLA's too)
    float acc = n == 1 ? col[0] : __fadd_rn(0.0f, col[0]);
    col[0] = acc;
    for (int j = 1; j < nr; ++j) {
      acc = __fadd_rn(acc, col[j * C]);
      col[j * C] = acc;
    }
    if (totals != nullptr) totals[(row0 / kRows + b) * C + c] = acc;
  }
  __syncthreads();
  float* dst = p + row0 * C;
  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int b = e / per_block;
    dst[e] = sm[b * stride(C) + (e - b * per_block)];
  }
}

__global__ void scan_down_kernel(float* __restrict__ p, long long elems, int C,
                                 const float* __restrict__ s) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < elems; e += step) {
    const long long r = e / C;
    const long long b = r / kRows;
    const float add = b == 0 ? 0.0f : s[(b - 1) * C + (e - r * C)];
    p[e] = __fadd_rn(p[e], add);
  }
}

}  // namespace

// out (N, C) = the prefix sum of x (N, C) along the rows in XLA's blocked
// order; scratch holds scratch_rows x C floats for the totals' levels
// (ops/ordered_scan.scratch_rows(N) rows). C from 1 to 256. Returns the
// first launch's cudaError_t that is not cudaSuccess.
extern "C" int sfk_cumsum_rows(const float* x, int N, int C, float* out, float* scratch,
                               int scratch_rows, cudaStream_t stream) {
  if (N < 0 || C < 1 || C > kThreads || scratch_rows < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  long long n[kMaxLevels];
  float* lvl[kMaxLevels];
  n[0] = N;
  lvl[0] = out;
  int L = 0;
  long long used = 0;
  while (n[L] > kRows) {
    if (L + 1 >= kMaxLevels) return (int)cudaErrorInvalidValue;
    n[L + 1] = (n[L] + kRows - 1) / kRows;
    lvl[L + 1] = scratch + used * C;
    used += n[L + 1];
    ++L;
  }
  if (used > scratch_rows) return (int)cudaErrorInvalidValue;
  const int T = kThreads / C;
  const int smem = (int)(T * stride(C) * sizeof(float));
  for (int l = 0; l <= L; ++l) {
    const long long rows_a_block = (long long)T * kRows;
    const int blocks = (int)((n[l] + rows_a_block - 1) / rows_a_block);
    scan_up_kernel<<<blocks, kThreads, smem, stream>>>(l == 0 ? x : lvl[l], (int)n[l], C, lvl[l],
                                                       l < L ? lvl[l + 1] : nullptr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  for (int l = L - 1; l >= 0; --l) {
    const long long elems = n[l] * C;
    const long long want = (elems + 255) / 256;
    const int blocks = (int)(want < 4096 ? want : 4096);
    scan_down_kernel<<<blocks, 256, 0, stream>>>(lvl[l], elems, C, lvl[l + 1]);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

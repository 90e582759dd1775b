"""csrc/ordered_scan.cu built for the host CPU (g++, C++20): every thread of
every block of the kernel runs as an OS thread, with `__syncthreads`, the
block's vote (`__syncthreads_and`) and the grid barrier as
`std::barrier`s, cp.async as a copy and the flags' acquiring loads as
atomic ones. The kernel's own code (its chunks, the tree
of flagged totals, the waits on earlier chunks, the additions down) is
held against the plain version (ops/ordered_scan.cumsum_rows_plain) bit
for bit, with blocks that take several chunks in turn. The scratch and
chunk sizes are the library's own (`sfk_cumsum_scratch_floats`). Imports
nothing of JAX. The kernel on the card is held to the same plain version
by tests/test_torch_cuda.py and chip_smoke.py's phases 14 and 17."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu_torch.ops import cuda_lib
from slam_sensor_fusion_tpu_torch.ops.ordered_scan import cumsum_rows_plain

#: what the CUDA source needs of the CUDA toolkit, for a host build
_SHIM = r"""
#include <atomic>
#include <barrier>
#include <chrono>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct Dim3 { unsigned x, y, z; };
thread_local Dim3 threadIdx, blockIdx;
Dim3 gridDim;
thread_local float* tl_smem;
thread_local std::barrier<>* tl_block_bar;
std::barrier<>* g_grid_bar;
thread_local std::atomic<int>* tl_votes;  // the block's two vote slots
thread_local int tl_phase = 0;
static inline void __syncthreads() { tl_block_bar->arrive_and_wait(); }
static inline int __syncthreads_and(int pred) {  // slots alternate between calls
  std::atomic<int>& slot = tl_votes[tl_phase];
  tl_phase ^= 1;
  if (!pred) slot.fetch_add(1);
  tl_block_bar->arrive_and_wait();
  const int all = slot.load() == 0;
  tl_block_bar->arrive_and_wait();
  if (threadIdx.x == 0) slot.store(0);
  return all;
}
namespace cooperative_groups {
struct grid_group { void sync() { g_grid_bar->arrive_and_wait(); } };
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
static inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
static inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
static inline float __ldcg(const float* p) { return *(volatile const float*)p; }
static inline long long clock64() {
  std::this_thread::yield();  // a spinning thread lets the others run
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
static inline void __trap() { abort(); }
static inline void __pipeline_memcpy_async(float* d, const float* s, size_t n) { memcpy(d, s, n); }
static inline void __pipeline_commit() {}
static inline void __pipeline_wait_prior(int) {}
"""

#: a host launcher: `grid` blocks of kThreads threads, all at once
_ENTRY = r"""
template <int LV>
static void run(const float* x, long long N, int C, float* out, float* scratch, int grid) {
  constexpr int R = LV == 2 ? kRows * kRows : kRows;
  const Tree tr = make_tree((N + R - 1) / R);
  const int G = grid < tr.off[1] ? grid : (int)tr.off[1];
  gridDim = {(unsigned)G, 1, 1};
  std::barrier<> grid_bar(G * kThreads);
  g_grid_bar = &grid_bar;
  std::vector<std::barrier<>*> bars;
  std::vector<std::vector<double>> smem(G, std::vector<double>(chunk_floats(LV, C)));
  std::vector<std::atomic<int>> votes(2 * G);
  for (int b = 0; b < G; ++b) bars.push_back(new std::barrier<>(kThreads));
  std::vector<std::thread> threads;
  for (int b = 0; b < G; ++b)
    for (int t = 0; t < kThreads; ++t)
      threads.emplace_back([=, &smem, &bars, &votes]() {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        tl_smem = (float*)smem[b].data();  // 8-byte aligned, as the card's
        tl_block_bar = bars[b];
        tl_votes = &votes[2 * b];
        scan_rows_kernel<LV>(x, N, C, out, scratch, tr);
      });
  for (auto& t : threads) t.join();
  for (auto* p : bars) delete p;
}

extern "C" void host_scan(const float* x, long long N, int C, float* out, float* scratch,
                          int grid) {
  if (lv_of(C) == 2) run<2>(x, N, C, out, scratch, grid);
  else run<1>(x, N, C, out, scratch, grid);
}

extern "C" int host_chunk_rows(int C) { return lv_of(C) == 2 ? kRows * kRows : kRows; }
"""


@pytest.fixture(scope="module")
def host_scan(tmp_path_factory):
    """The scan kernel's source compiled for the host, as a ctypes library
    (skips where there is no g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    src = open(os.path.join(cuda_lib.CSRC, "ordered_scan.cu")).read()
    src = src.replace("#include <cooperative_groups.h>\n#include <cuda_pipeline.h>\n"
                      "#include <cuda_runtime.h>\n", _SHIM)
    src = src.replace('asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) '
                      ': "memory");', "v = __atomic_load_n(p, __ATOMIC_ACQUIRE);")
    src = src.replace("extern __shared__ float sm[];", "float* sm = tl_smem;")
    # the card's launcher and its C entries stay out; the scratch's size is
    # the library's own function
    a, b = src.index("template <int LV>\nint launch_scan"), src.index("}  // namespace")
    c, d = src.index('extern "C" long long sfk_cumsum_scratch_floats'), src.index("// out (N, C)")
    src = src[:a] + _ENTRY + "}  // namespace\n\n" + src[c:d]
    assert "ld.acquire" not in src and "__shared__" not in src
    d = tmp_path_factory.mktemp("ordered_scan_host")
    (d / "ordered_scan_host.cpp").write_text(src)
    lib = d / "libordered_scan_host.so"
    subprocess.run([gxx, "-O2", "-std=c++20", "-pthread", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", str(lib), str(d / "ordered_scan_host.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    P = ctypes.c_void_p
    so.host_scan.argtypes = [P, ctypes.c_longlong, ctypes.c_int, P, P, ctypes.c_int]
    so.sfk_cumsum_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    so.sfk_cumsum_scratch_floats.restype = ctypes.c_longlong
    return so


def test_host_scan_sizes(host_scan):
    """256-row chunks (two levels of the tree) while a chunk fits 48 KiB of
    shared memory (C up to 45), 16-row ones past; the scratch is C floats
    and a flag for each item of the totals' tree (the chunks' totals, then
    each level of 16 up to the first of 16 items or fewer)."""
    assert [host_scan.host_chunk_rows(c) for c in (1, 10, 45, 46, 256)] == [256, 256, 256, 16, 16]
    floats = [host_scan.sfk_cumsum_scratch_floats(n, 10)
              for n in (1, 16, 17, 256, 257, 65536, 65537, 2**20 + 3)]
    assert floats == [11 * i for i in (1, 1, 1, 1, 2, 256 + 16, 257 + 17 + 2,
                                       4097 + 257 + 17 + 2)]
    assert host_scan.sfk_cumsum_scratch_floats(700, 60) == 61 * (44 + 3)
    assert host_scan.sfk_cumsum_scratch_floats(0, 10) == 0


@pytest.mark.parametrize("N, C, grid", [
    (1, 10, 1), (17, 10, 2), (257, 10, 2), (4097, 10, 3),  # one level, two
    (65536 + 300, 1, 3),  # 258 chunks: three levels of totals
    (1000, 13, 4),  # more blocks than a level's group
    (5000, 60, 3),  # 16-row chunks, three levels
])
def test_host_scan_bits_equal_plain(host_scan, N, C, grid):
    """The kernel's source on seeded rows (magnitudes of 1e-3 to 1e6, a
    tenth of the rows -0.0), each block taking chunks in turn, bit-equal
    to the plain version; the scratch starts as NaN, as any memory."""
    rng = np.random.default_rng(N + C)
    x = (rng.normal(0.0, 1.0, (N, C)) * 10.0 ** rng.uniform(-3, 6, (N, 1))).astype(np.float32)
    x[rng.uniform(size=N) < 0.1] = -0.0
    scratch = np.full(max(host_scan.sfk_cumsum_scratch_floats(N, C), 1), np.nan, np.float32)
    out = np.empty_like(x)
    host_scan.host_scan(x.ctypes.data, N, C, out.ctypes.data, scratch.ctypes.data, grid)
    want = cumsum_rows_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out.view(np.int32), want.view(np.int32))

#!/usr/bin/env python3
"""Where a cumsum_rows launch spends its time on one GPU: the phases of
csrc/ordered_scan.cu's kernel, read off the card's global timer.

    python3 slam_sensor_fusion_tpu_torch/csrc/bench/scan_phases.py [--source FILE]

Writes a copy of the kernel's source (default: this checkout's
csrc/ordered_scan.cu) with a `%globaltimer` mark by thread 0 of every
block at each phase of its first chunk: the kernel's start, the chunk
staged, scanned, the grid barrier passed, its total published (with the
sums it completes), the look-back done, its rows written, and the
block's end. The copy and a C++ main program are built with nvcc into
the package's git-ignored `_build/`. The program runs 30 warm-up launches and
50 timed ones (CUDA events, back to back) at the LIO anchor's 65 536 x 10
and at 2^20 + 3 x 10, then prints, for the last launch, each mark's
minimum, median and maximum over the blocks in microseconds from the
first block's start, with the kernel's registers, stack and blocks a
multiprocessor. The marks cost a few stores a block; the events time the
marked kernel.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
sys.path.insert(0, ROOT)

from slam_sensor_fusion_tpu_torch.ops import cuda_lib  # noqa: E402

MARKS = ("start", "staged", "scanned", "grid barrier", "published", "look-back", "written",
         "end")

_TIMER = r'''
__device__ long long g_marks[16384 * 8];
__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define MARK(k) do { if (threadIdx.x == 0 && first) g_marks[blockIdx.x * 8 + (k)] = gtime(); } while (0)
'''

#: (text in the kernel, the same text with its mark)
_AT = (
    ("    __pipeline_wait_prior(0);\n    __syncthreads();\n    scan_chunk<LV>(N, C, rows, buf);\n",
     "    __pipeline_wait_prior(0);\n    __syncthreads();\n    MARK(1);\n"
     "    scan_chunk<LV>(N, C, rows, buf);\n    MARK(2);\n"),
    ("    if (ch == blockIdx.x) cg::this_grid().sync();  // every flag zeroed\n",
     "    if (ch == blockIdx.x) cg::this_grid().sync();  // every flag zeroed\n    MARK(3);\n"),
    ("      publish<LV>(off, levels, vals, flags, C, ch, buf, rows_now, pre + 2 * C);\n",
     "      publish<LV>(off, levels, vals, flags, C, ch, buf, rows_now, pre + 2 * C);\n"
     "      MARK(4);\n"),
    ("    __syncthreads();\n    add_down_and_write<LV>(buf, rows_now, C, ch, N, pre, out);\n  }\n",
     "    __syncthreads();\n    MARK(5);\n    add_down_and_write<LV>(buf, rows_now, C, ch, N, pre, out);\n"
     "    MARK(6);\n    first = false;\n  }\n"
     "  if (threadIdx.x == 0) g_marks[blockIdx.x * 8 + 7] = gtime();\n"),
)

_MAIN = r'''
#include <algorithm>
#include <cstdio>
#include <vector>
int main() {
  const char* names[8] = {%s};
  for (long long N : {65536LL, 1048579LL}) {
    const int C = 10;
    float *x, *out, *scratch;
    cudaMalloc(&x, N * C * 4);
    cudaMalloc(&out, N * C * 4);
    const long long S = sfk_cumsum_scratch_floats((int)N, C);
    cudaMalloc(&scratch, S * 4);
    std::vector<float> h(N * C);
    for (size_t i = 0; i < h.size(); ++i) h[i] = (float)((i * 2654435761u) %% 1000) * 0.01f;
    cudaMemcpy(x, h.data(), N * C * 4, cudaMemcpyHostToDevice);
    for (int r = 0; r < 30; ++r) sfk_cumsum_rows(x, (int)N, C, out, scratch, S, 0);
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    for (int r = 0; r < 50; ++r) sfk_cumsum_rows(x, (int)N, C, out, scratch, S, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0;
    cudaEventElapsedTime(&ms, a, b);
    std::vector<long long> m(16384 * 8);
    cudaMemcpyFromSymbol(m.data(), g_marks, m.size() * 8);
    cudaFuncAttributes fa;
    cudaFuncGetAttributes(&fa, scan_rows_kernel<2>);
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_rows_kernel<2>, kThreads,
                                                  chunk_floats(2, C) * 4);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    const long long chunks = (N + 255) / 256;
    const int G = (int)std::min<long long>(chunks, (long long)per_sm * sms);
    long long t0 = m[0];
    for (int g = 0; g < G; ++g) t0 = std::min(t0, m[g * 8]);
    printf("%%lld x %%d: %%.4f ms a launch by events (50 back to back), %%d registers, %%zu bytes "
           "of stack, %%d blocks an SM, grid %%d, %%lld chunks; %%s\n", N, C, ms / 50, fa.numRegs,
           fa.localSizeBytes, per_sm, G, chunks, cudaGetErrorString(cudaGetLastError()));
    for (int k = 0; k < 8; ++k) {
      std::vector<double> v;
      for (int g = 0; g < G; ++g) v.push_back((m[g * 8 + k] - t0) * 1e-3);
      std::sort(v.begin(), v.end());
      printf("  %%-13s min %%8.2f  median %%8.2f  max %%8.2f us\n", names[k], v[0],
             v[v.size() / 2], v.back());
    }
    cudaFree(x);
    cudaFree(out);
    cudaFree(scratch);
  }
  return 0;
}
'''


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=os.path.join(cuda_lib.CSRC, "ordered_scan.cu"))
    args = ap.parse_args()
    src = open(args.source).read()
    src = src.replace("namespace {\n", "namespace {\n" + _TIMER, 1)
    head = src.index("scan_rows_kernel(const float* __restrict__ x")
    body = src.index("{", head) + 1
    src = src[:body] + "\n  bool first = true;\n  MARK(0);" + src[body:]
    for old, new in _AT:
        if old not in src:
            sys.exit(f"scan_phases: the kernel has no\n{old}")
        src = src.replace(old, new)
    names = ", ".join(f'"{n}"' for n in MARKS)
    out_dir = os.path.join(cuda_lib.BUILD, "scan_phases")
    os.makedirs(out_dir, exist_ok=True)
    cu, exe = os.path.join(out_dir, "scan_phases.cu"), os.path.join(out_dir, "scan_phases")
    with open(cu, "w") as f:
        f.write(src + _MAIN % names)
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([cuda_lib._nvcc(), *flags, "-o", exe, cu], check=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    subprocess.run([exe], check=True)


if __name__ == "__main__":
    main()

// Microbenchmark of the tile-major association's inner loop (the hot loop of
// K3 and K4-K5, `nearest_first` in ../icp_fused.cuh): one block of 1024
// threads on one SM walks every source tile's admitted target tiles, as the
// kernels do, in four ways of loading the target rows and carrying the
// winner. All variants compute the same distances in the same order and
// print the same checksum. Stand-alone, not part of the library:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -o assoc_variants assoc_variants.cu && ./assoc_variants
//
// It prints milliseconds and distances per second for K3's shapes at the
// online session (8 source tiles of 512, 5 target tiles of 512 each, 3-row
// pages) and K4's at the LIO bench (16 x 512, 16 target tiles of 1024 each,
// 6-row pages).
#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>
#include <vector>

constexpr float kBig = 3.0e38f;

enum Variant {
  kScalarCarryXyz,   // scalar loads, the winner's x, y, z carried in registers
  kScalarCarryRow,   // scalar loads, the winner's row carried as one int a tile
  kScalarTileMin,    // scalar loads, a tile-local minimum compared after the tile
  kVectorCarryRow,   // 16-byte loads of four rows, the winner's row as one int
};

template <int V, int ROWS>
__device__ __forceinline__ float nearest(const float* __restrict__ tgt,
                                         const int* __restrict__ pt, int start, int cnt,
                                         int TN, float sx, float sy, float sz, float* out) {
  float best = kBig;
  float bx = 0, by = 0, bz = 0;
  const float* w = nullptr;
  for (int q = 0; q < cnt; ++q) {
    const float* tx = tgt + (size_t)pt[start + q] * ROWS * TN;
    const float* ty = tx + TN;
    const float* tz = tx + 2 * TN;
    if (V == kScalarCarryXyz) {
#pragma unroll 4
      for (int c = 0; c < TN; ++c) {
        const float x = __ldg(tx + c), y = __ldg(ty + c), z = __ldg(tz + c);
        const float dx = x - sx, dy = y - sy, dz = z - sz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best) { best = d2; bx = x; by = y; bz = z; }
      }
    } else if (V == kScalarCarryRow) {
      int hit = -1;
#pragma unroll 4
      for (int c = 0; c < TN; ++c) {
        const float dx = __ldg(tx + c) - sx, dy = __ldg(ty + c) - sy, dz = __ldg(tz + c) - sz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best) { best = d2; hit = c; }
      }
      if (hit >= 0) w = tx + hit;
    } else if (V == kScalarTileMin) {
      float tb = kBig;
      int hit = 0;
#pragma unroll 4
      for (int c = 0; c < TN; ++c) {
        const float dx = __ldg(tx + c) - sx, dy = __ldg(ty + c) - sy, dz = __ldg(tz + c) - sz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < tb) { tb = d2; hit = c; }
      }
      if (tb < best) { best = tb; w = tx + hit; }
    } else {
      const float4* x4 = reinterpret_cast<const float4*>(tx);
      const float4* y4 = reinterpret_cast<const float4*>(ty);
      const float4* z4 = reinterpret_cast<const float4*>(tz);
      int hit = -1;
#pragma unroll 2
      for (int c = 0; c < TN / 4; ++c) {
        const float4 X = __ldg(x4 + c), Y = __ldg(y4 + c), Z = __ldg(z4 + c);
        const float xs[4] = {X.x, X.y, X.z, X.w};
        const float ys[4] = {Y.x, Y.y, Y.z, Y.w};
        const float zs[4] = {Z.x, Z.y, Z.z, Z.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float dx = xs[u] - sx, dy = ys[u] - sy, dz = zs[u] - sz;
          const float d2 = dx * dx + dy * dy + dz * dz;
          if (d2 < best) { best = d2; hit = 4 * c + u; }
        }
      }
      if (hit >= 0) w = tx + hit;
    }
  }
  if (V == kScalarCarryXyz) {
    out[0] = bx; out[1] = by; out[2] = bz;
  } else {
    for (int k = 0; k < 3; ++k) out[k] = w ? w[k * TN] : 0.0f;
  }
  return best;
}

template <int V, int ROWS>
__global__ void __launch_bounds__(1024, 1)
    kern(const float* __restrict__ src, const float* __restrict__ tgt,
         const int* __restrict__ ps, const int* __restrict__ pc, const int* __restrict__ pt,
         float4* __restrict__ out, int nSt, int TM, int TN) {
  const int G = blockDim.x / TM, r = threadIdx.x % TM;
  for (int i = threadIdx.x / TM; i < nSt; i += G) {
    const float* s = src + (size_t)i * 3 * TM;
    float o[3];
    const float b =
        nearest<V, ROWS>(tgt, pt, ps[i], pc[i], TN, s[r], s[TM + r], s[2 * TM + r], o);
    out[(size_t)i * TM + r] = make_float4(o[0], o[1], o[2], b);
  }
}

template <int V, int ROWS>
void run(const char* name, const float* src, const float* tgt, const int* ps, const int* pc,
         const int* pt, float4* out, int nSt, int TM, int TN, double ndist) {
  const int G = nSt < 1024 / TM ? nSt : 1024 / TM;
  const int reps = 5;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  kern<V, ROWS><<<1, TM * G>>>(src, tgt, ps, pc, pt, out, nSt, TM, TN);  // warm-up
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int k = 0; k < reps; ++k)
    kern<V, ROWS><<<1, TM * G>>>(src, tgt, ps, pc, pt, out, nSt, TM, TN);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  ms /= reps;
  std::vector<float4> h((size_t)nSt * TM);
  cudaMemcpy(h.data(), out, h.size() * sizeof(float4), cudaMemcpyDeviceToHost);
  double cs = 0;
  for (auto& v : h) cs += v.x + 2 * v.y + 3 * v.z + v.w;
  printf("  %-34s %8.3f ms  %6.2f G distances/s  checksum %.6f  cudaError %d\n", name, ms,
         ndist / ms / 1e6, cs, (int)cudaGetLastError());
}

template <int ROWS>
void suite(int nSt, int TM, int TN, int nTt, int cnt) {
  std::vector<float> src((size_t)nSt * 3 * TM), tgt((size_t)nTt * ROWS * TN);
  srand(1);
  for (auto& v : src) v = rand() / (float)RAND_MAX * 20 - 10;
  for (auto& v : tgt) v = rand() / (float)RAND_MAX * 20 - 10;
  std::vector<int> ps(nSt), pc(nSt, cnt), pt((size_t)nSt * cnt);
  for (int i = 0; i < nSt; ++i) {
    ps[i] = i * cnt;
    for (int q = 0; q < cnt; ++q) pt[i * cnt + q] = (i * 7 + q * 3) % nTt;
  }
  float *dsrc, *dtgt;
  int *dps, *dpc, *dpt;
  float4* dout;
  cudaMalloc(&dsrc, src.size() * 4);
  cudaMalloc(&dtgt, tgt.size() * 4);
  cudaMalloc(&dps, nSt * 4);
  cudaMalloc(&dpc, nSt * 4);
  cudaMalloc(&dpt, pt.size() * 4);
  cudaMalloc(&dout, (size_t)nSt * TM * 16);
  cudaMemcpy(dsrc, src.data(), src.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dtgt, tgt.data(), tgt.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dps, ps.data(), nSt * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dpc, pc.data(), nSt * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dpt, pt.data(), pt.size() * 4, cudaMemcpyHostToDevice);
  const double nd = (double)nSt * cnt * TM * TN;
  printf("%d source tiles of %d, %d target tiles of %d each, %d-row pages: %.1f M distances\n",
         nSt, TM, cnt, TN, ROWS, nd / 1e6);
  run<kScalarCarryXyz, ROWS>("scalar loads, carry x, y, z", dsrc, dtgt, dps, dpc, dpt, dout, nSt, TM, TN, nd);
  run<kScalarCarryRow, ROWS>("scalar loads, carry the row", dsrc, dtgt, dps, dpc, dpt, dout, nSt, TM, TN, nd);
  run<kScalarTileMin, ROWS>("scalar loads, tile-local minimum", dsrc, dtgt, dps, dpc, dpt, dout, nSt, TM, TN, nd);
  run<kVectorCarryRow, ROWS>("16-byte loads, carry the row", dsrc, dtgt, dps, dpc, dpt, dout, nSt, TM, TN, nd);
  cudaFree(dsrc); cudaFree(dtgt); cudaFree(dps); cudaFree(dpc); cudaFree(dpt); cudaFree(dout);
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "no CUDA device\n");
    return 1;
  }
  printf("%s\n", prop.name);
  suite<3>(8, 512, 512, 128, 5);
  suite<6>(16, 512, 1024, 32, 16);
  return 0;
}

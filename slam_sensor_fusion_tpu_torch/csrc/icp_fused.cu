// K3: one whole point-to-point ICP per launch, fresh or lazy.
//
// Replaces the Pallas kernel slam_sensor_fusion_tpu/ops/icp_fused.py
// `_make_fused_kernel` (launched by `_fused_core`), which the per-frame fast
// step (`icp_align_fused` with the cached target), the per-frame branch of
// the superblock pipeline (`icp_align_fused_paged`, lazy in parity mode) and
// the lite pipeline run. Per iteration: tile-major association over the
// pair list under the current (R, t), the 17 gated Kabsch moments, and a
// Newton-polar Kabsch step on thread 0.
//   fresh (lazy = 0): re-associate every iteration, weights d2 < gate; stop
//     on err < acceptable, |err_prev - err| < eps or a degenerate polar.
//   lazy (lazy = 1): associate once at the prior; the alive set only
//     shrinks; re-associate only on a plateau that is not a hit; n_corr is
//     the initial alive count (icp_fused.py:338-410).
// Outputs: T_out (4, 4) in the rebased frame and stats (128) = [err, iters,
// n_corr, det_min, 0...], as the JAX kernel.
//
// What bounds it on an H100: association. Each pass walks every source
// tile's admitted target tiles, TM x TN direct-difference distances a pair
// (~13 float instructions each with the running minimum); at the session's
// shapes (8 source tiles of 512, ~10-20 admitted tiles each) that is ~10^7
// distances a pass. The ICP is a serial chain of passes, so only the
// association is wide: the first port ran it all in ONE block (1 of 132
// SMs). Bytes are not the limit: the target pages (at most 128 x 6 KiB at
// the session's shapes) stay in L2 and each warp reads one target row at a
// time as a broadcast.
//
// Design: a persistent cooperative grid, one block on each SM
// (grid_assoc.cuh), as K1 and K4. Block 0, the leader, keeps the one-block
// layout: TM x G threads, G = min(nSt, 1024 / TM); thread x owns the points
// x, x + TM G, ... of the flat (tile, row) order, i.e. group g owns source
// tiles g, g + G, ... and thread r of a group owns point r of each of them
// (tiles wider than 1024 rows: 1024 threads, the same flat order). The
// per-point scratch (matched x, y, z and the gate/alive weight, a float4 a
// point: 512 KiB at 128 tiles of 256) lives in a global buffer the wrapper
// allocates; each leader thread reads and writes only its own points, so
// it needs no barrier, and it stays in the 50 MB L2. Each association is a
// first-row round over the grid (grid_assoc.cuh `scan_first<3>`, K4's
// round on 3-row pages): the leader publishes (R, t), the other 131 blocks
// scan (source tile, pair slot) items cut into chunks of whole warps of
// source rows with icp_fused.cuh's `nearest_first` on the slot's one
// target tile, writing the tile's best d2 and first winning row to
// per-slot scratch; the leader then combines each point's slots in slot
// order under a strict `<` from kBig (`combine_first<3>`) into the
// per-point scratch: weight d2 < gate in a fresh round, weight *= (d2 <
// gate) in a lazy re-association. That is the one-block running loop's
// result bit for bit: the FIRST row of an exact tie within a tile and the
// earlier tile across tiles, the JAX kernel's argmin + strict-`<` rule (K1
// averages ties instead). The moment sums are the fixed-order block
// reduction of icp_fused.cuh (no atomics: deterministic) in the one-block
// layout, the Kabsch solve and the lazy branch logic run on thread 0 as
// before, and the library builds with -fmad=false, so products and sums
// round op by op as in the plain version `_fused_core_plain` and the
// outputs equal the one-block kernel's bit for bit.
#include <cuda_runtime.h>

#include "grid_assoc.cuh"

namespace cg = cooperative_groups;

// Mirrors ctypes struct `_K3Params` in ops/icp_fused.py.
struct K3Params {
  float gate;  // max_correspondence_dist_sq
  float eps;   // transformation_epsilon
  float acc;   // acceptable_mean_error
  int num_iterations;
  int min_corr;
  int lazy;
};

namespace {

constexpr int kNMom = 17;  // W, Ss[3], St[3], Mst[9], Eabs

struct Shared {
  // broadcast from thread 0 to the block
  float R[9];
  float t[3];
  int need;  // lazy: re-associate in this iteration
  int live;  // the ICP loop continues
  float mom[kNMom];
};

// What the leader's association rounds read and write.
struct Leader {
  const cg::grid_group& g;
  sfk::grid::Ctl* ctl;
  const sfk::grid::FirstRound& A;
  float4* scratch;  // (nSt, TM): matched x, y, z and weight
};

// Associate the leader's points under (S.R, S.t): one round over the grid,
// then each point's slots combined in order. shrink = 0: weight = (d2 <
// gate); shrink = 1: weight *= (d2 < gate).
__device__ void associate(const Shared& S, const Leader& L, float gate, bool shrink) {
  sfk::grid::lead_round(L.g, L.ctl, 0, S.R, S.t);
  const int TM = L.A.TM, TN = L.A.TN;
  sfk::grid::combine_first<3>(L.A, [&](int i, int r, float best, const float* win) {
    const float bx = win ? win[0] : 0.0f;
    const float by = win ? win[TN] : 0.0f;
    const float bz = win ? win[2 * TN] : 0.0f;
    float4* o = L.scratch + (size_t)i * TM + r;
    const float gt = best < gate ? 1.0f : 0.0f;
    *o = make_float4(bx, by, bz, shrink ? o->w * gt : gt);
  });
}

// The 17 gated Kabsch moments under (S.R, S.t), weights from the scratch,
// into S.mom (every thread must call it).
__device__ void moments(Shared& S, const Leader& L, float* red) {
  float R[9], t[3];
#pragma unroll
  for (int m = 0; m < 9; ++m) R[m] = S.R[m];
  t[0] = S.t[0]; t[1] = S.t[1]; t[2] = S.t[2];
  float v[kNMom];
#pragma unroll
  for (int m = 0; m < kNMom; ++m) v[m] = 0.0f;
  const int TM = L.A.TM;
  for (int p = threadIdx.x; p < L.A.nSt * TM; p += blockDim.x) {
    const int i = p / TM;
    const int r = p - i * TM;
    const float* s = L.A.src + (size_t)i * 3 * TM;
    const float px = s[r], py = s[TM + r], pz = s[2 * TM + r];
    const float4 b = L.scratch[p];
    const float w = b.w;
    const float sp[3] = {R[0] * px + R[1] * py + R[2] * pz + t[0],
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
  sfk::block_sum<kNMom>(v, red, S.mom);
}

__device__ sfk::IcpOut icp_lazy(Shared& S, const Leader& L, float* red, const K3Params& prm) {
  sfk::IcpOut o{sfk::kBig, 0, 0, sfk::kBig};
  associate(S, L, prm.gate, false);
  {
    float v[1] = {0.0f};
    for (int p = threadIdx.x; p < L.A.nSt * L.A.TM; p += blockDim.x) v[0] += L.scratch[p].w;
    sfk::block_sum<1>(v, red, S.mom);
  }
  o.n_corr = (int)S.mom[0];
  bool live = o.n_corr >= prm.min_corr;
  for (int it = 0; it < prm.num_iterations && live; ++it) {
    moments(S, L, red);
    float err = 0.0f;
    bool hit = false;
    if (threadIdx.x == 0) {
      err = S.mom[16] / sfk::jmax(S.mom[0], 1.0f);
      hit = err < prm.acc;
      S.need = (!hit) && (fabsf(o.err - err) < prm.eps);
    }
    __syncthreads();
    if (S.need) {  // plateau: re-associate, the alive set only shrinks
      associate(S, L, prm.gate, true);
      moments(S, L, red);
    }
    if (threadIdx.x == 0) {
      float R_step[9], t_step[3], detH;
      const bool ok = sfk::solve_step(S.mom, R_step, t_step, &detH);
      const bool stop = hit || !ok;
      sfk::apply_step(S.R, S.t, R_step, t_step, stop);
      o.err = err;
      o.iters += stop ? 0 : 1;
      o.det_min = sfk::jmin(o.det_min, detH);
      S.live = !stop;
    }
    __syncthreads();
    live = S.live;
  }
  return o;  // meaningful on thread 0
}

__device__ sfk::IcpOut icp_fresh(Shared& S, const Leader& L, float* red, const K3Params& prm) {
  sfk::IcpOut o{sfk::kBig, 0, 0, sfk::kBig};
  bool live = true;
  for (int it = 0; it < prm.num_iterations && live; ++it) {
    associate(S, L, prm.gate, false);
    moments(S, L, red);
    if (threadIdx.x == 0) {
      const float W = S.mom[0];
      const float Wc = sfk::jmax(W, 1.0f);
      const float err = W >= (float)prm.min_corr ? S.mom[16] / Wc : sfk::kBig;
      float R_step[9], t_step[3], detH;
      const bool ok = sfk::solve_step(S.mom, R_step, t_step, &detH);
      const bool stop = err < prm.acc || fabsf(o.err - err) < prm.eps || !ok;
      sfk::apply_step(S.R, S.t, R_step, t_step, stop);
      o.err = err;
      o.n_corr = (int)W;
      o.iters += stop ? 0 : 1;
      o.det_min = sfk::jmin(o.det_min, detH);
      S.live = !stop;
    }
    __syncthreads();
    live = S.live;
  }
  return o;
}

__global__ void __launch_bounds__(1024, 1) icp_fused_kernel(
    const float* __restrict__ src_pages,  // (nSt, 3, TM)
    const float* __restrict__ tgt_pages,  // (nTt, 3, TN)
    const int* __restrict__ pair_start,   // (nSt,)
    const int* __restrict__ pair_cnt,     // (nSt,)
    const int* __restrict__ pair_tgt,     // (max_pairs,)
    const float* __restrict__ T0,         // (4, 4) rebased initial transform
    float* __restrict__ T_out,            // (4, 4)
    float* __restrict__ stats,            // (128,)
    float4* __restrict__ scratch,         // (nSt, TM)
    float* slot_d2,                       // (max_pairs, TM) rounds' winners by slot
    int* slot_row,                        // (max_pairs, TM)
    sfk::grid::Ctl* ctl,                  // the leader's published round
    int nSt, int TM, int TN, K3Params prm) {
  const cg::grid_group g = cg::this_grid();
  const sfk::grid::FirstRound A{src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt,
                                slot_d2, slot_row, nSt, TM, TN};
  if (blockIdx.x != 0) {  // a worker: serve the leader's association rounds
    sfk::grid::serve(g, ctl, [&] { sfk::grid::scan_first<3>(A, ctl); });
    return;
  }
  __shared__ float red[kNMom * 32];
  __shared__ Shared S;
  const Leader L{g, ctl, A, scratch};
  if (threadIdx.x == 0) sfk::read44(T0, S.R, S.t);
  __syncthreads();
  const sfk::IcpOut o = prm.lazy ? icp_lazy(S, L, red, prm) : icp_fresh(S, L, red, prm);
  sfk::grid::dismiss(g, ctl);
  if (threadIdx.x == 0) {
    sfk::pack44(S.R, S.t, 1.0f, T_out);
    stats[0] = o.err;
    stats[1] = (float)o.iters;
    stats[2] = (float)o.n_corr;
    stats[3] = o.det_min;
    for (int m = 4; m < 128; ++m) stats[m] = 0.0f;
  }
}

inline bool bad_tiles(int nSt, int TM) {
  return TM < 32 || TM > 4096 || TM % 32 || nSt < 1;
}

}  // namespace

// Launch K3 on `stream` as a cooperative grid; returns the launch's error
// (0 on success; a grid the card cannot hold co-resident is refused, not
// shrunk), or cudaErrorInvalidValue for a tile width it does not take.
// `scratch` holds nSt x TM float4, `slot_d2` and `slot_row` max_pairs x TM
// floats and ints, `ctl` a sfk::grid::Ctl; none needs initialising.
extern "C" int sfk_icp_fused(const float* src_pages, const float* tgt_pages,
                             const int* pair_start, const int* pair_cnt,
                             const int* pair_tgt, const float* T0, float* T_out,
                             float* stats, float* scratch, float* slot_d2, int* slot_row,
                             void* ctl, int nSt, int TM, int TN, const K3Params* prm,
                             cudaStream_t stream) {
  if (bad_tiles(nSt, TM)) return (int)cudaErrorInvalidValue;
  const int threads = sfk::grid::first_threads(nSt, TM);
  int blocks, per_sm;
  cudaError_t e =
      sfk::grid::grid_size((const void*)icp_fused_kernel, threads, 0, &blocks, &per_sm);
  if (e != cudaSuccess) return (int)e;
  float4* s4 = reinterpret_cast<float4*>(scratch);
  sfk::grid::Ctl* c = static_cast<sfk::grid::Ctl*>(ctl);
  K3Params p = *prm;
  void* args[] = {&src_pages, &tgt_pages, &pair_start, &pair_cnt, &pair_tgt, &T0, &T_out,
                  &stats, &s4, &slot_d2, &slot_row, &c, &nSt, &TM, &TN, &p};
  e = cudaLaunchCooperativeKernel((const void*)icp_fused_kernel, dim3(blocks), dim3(threads),
                                  args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K3's cooperative grid for these tiles: blocks, threads a block and the
// blocks a multiprocessor could hold.
extern "C" int sfk_icp_grid(int nSt, int TM, int* blocks, int* threads, int* per_sm) {
  if (bad_tiles(nSt, TM)) return (int)cudaErrorInvalidValue;
  *threads = sfk::grid::first_threads(nSt, TM);
  return (int)sfk::grid::grid_size((const void*)icp_fused_kernel, *threads, 0, blocks, per_sm);
}

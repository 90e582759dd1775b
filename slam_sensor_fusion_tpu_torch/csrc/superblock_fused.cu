// K1: the whole-superblock fine loop, K frames in one launch.
//
// Replaces the Pallas kernel slam_sensor_fusion_tpu/ops/superblock_fused.py
// `_make_superblock_kernel` (launched by `superblock_fine`). Per frame k:
// odometry prediction, element-wise covariance blend with the GPS pose,
// stochastic-filter push and z-score gate (with stochastic_filter.cpp:106's
// operand order), ICP in the crop-rebased frame — lazy (the reference's
// control flow, parity mode) or fresh — and a predicated state update for
// invalid frames. Outputs and state layout match the JAX kernel exactly.
//
// What bounds it on an H100: association. Per ICP association a frame visits
// ~nSt x (admitted target tiles) pairs of TM x TN direct-difference
// distances, each ~20 float instructions with the tie bookkeeping; at bench
// shapes (TM = 1024, TN = 512) that is on the order of 10^8 distances per
// association, issued by ONE SM. The target pages (128 x 6 KiB) stay in L2,
// so bytes are not the limit; the frame chain is serial (each prior depends
// on the last frame's ICP), so one block per superblock is the simple,
// correct first design and uses 1 of 132 SMs. Spreading a superblock over a
// cluster of blocks, double-buffered TMA page loads and many sequences per
// launch are the levers for later.
//
// Design: one block of TM threads. Thread r owns point r of every source
// tile: its sensor-frame coordinates, matched target coordinates and alive
// flag stay in registers (NST x 7 floats). For each admitted target tile the
// block stages the page into shared memory as float4 and every thread scans
// it, tracking the tile minimum and the SUM and COUNT of coordinates of rows
// that tie it exactly: K1 averages exact ties within a tile
// (superblock_fused.py:199-216), unlike K2 and K3, which take the first row.
// Across tiles a strict `<` keeps the earlier tile. The 17 moment sums are a
// fixed-order block reduction (warp shuffles, then warps in order; no
// atomics), so runs are deterministic. The scalar chain (prediction, blend,
// filter, Kabsch solve by Newton polar, state selects) runs on thread 0 and
// is broadcast through shared memory. Built with -fmad=false: the distance
// expressions and moment products round as in the plain PyTorch version.
#include <cuda_runtime.h>

#include "icp_fused.cuh"

constexpr int kQmax = 8;
constexpr int kNMom = 17;  // W, Ss[3], St[3], Mst[9], Eabs

// Mirrors ctypes struct `_SBParams` in ops/superblock_fused.py.
struct SBParams {
  float gate;   // max_correspondence_dist_sq
  float eps;    // transformation_epsilon
  float acc;    // acceptable_mean_error
  float mad_lo; // min_distance_per_scan
  float mad_hi; // max_distance_per_scan / 3
  float z_thr;  // z_score_threshold
  float wq[kQmax];
  int num_iterations;
  int min_corr;
  int Q;
  int fixed_gains;
  int lazy;
};

namespace {

struct Frame {
  // broadcast from thread 0 to the block
  float R[9];
  float t[3];
  int need;   // lazy: re-associate in this iteration
  int live;   // the ICP loop continues
  float mom[kNMom];
};

template <int NST>
struct Points {
  float px[NST], py[NST], pz[NST];  // sensor-frame source point of each tile
  float bx[NST], by[NST], bz[NST];  // matched target coords (rebased frame)
  float al[NST];                    // alive / gate weight
};

// Tile-major association of this thread's points under (R, t), read from
// shared memory. mode 0: al = (d2 < gate); mode 1: al *= (d2 < gate).
template <int NST>
__device__ void associate(Points<NST>& P, const Frame& F, float4* page,
                          const int* pair_start, const int* pair_cnt,
                          const int* pair_tgt, const float* tgt, int TN,
                          float gate, int mode) {
  float R[9], t[3];
#pragma unroll
  for (int m = 0; m < 9; ++m) R[m] = F.R[m];
  t[0] = F.t[0]; t[1] = F.t[1]; t[2] = F.t[2];
  const int TM = blockDim.x;
#pragma unroll
  for (int i = 0; i < NST; ++i) {
    const float sx = R[0] * P.px[i] + R[1] * P.py[i] + R[2] * P.pz[i] + t[0];
    const float sy = R[3] * P.px[i] + R[4] * P.py[i] + R[5] * P.pz[i] + t[1];
    const float sz = R[6] * P.px[i] + R[7] * P.py[i] + R[8] * P.pz[i] + t[2];
    float best = sfk::kBig, bx = 0.0f, by = 0.0f, bz = 0.0f;
    const int start = pair_start[i];
    const int cnt = pair_cnt[i];
    for (int q = 0; q < cnt; ++q) {
      const float* tp = tgt + (size_t)pair_tgt[start + q] * 3 * TN;
      __syncthreads();
      for (int c = threadIdx.x; c < TN; c += TM)
        page[c] = make_float4(tp[c], tp[TN + c], tp[2 * TN + c], 0.0f);
      __syncthreads();
      float m = INFINITY, cx = 0.0f, cy = 0.0f, cz = 0.0f, n = 0.0f;
      for (int c = 0; c < TN; ++c) {
        const float4 p = page[c];
        const float dx = p.x - sx;
        const float dy = p.y - sy;
        const float dz = p.z - sz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < m) {
          m = d2; cx = p.x; cy = p.y; cz = p.z; n = 1.0f;
        } else if (d2 == m) {
          cx += p.x; cy += p.y; cz += p.z; n += 1.0f;
        }
      }
      if (m < best) {
        const float inv = 1.0f / fmaxf(n, 1.0f);
        best = m;
        bx = cx * inv;
        by = cy * inv;
        bz = cz * inv;
      }
    }
    P.bx[i] = bx;
    P.by[i] = by;
    P.bz[i] = bz;
    const float g = best < gate ? 1.0f : 0.0f;
    P.al[i] = mode == 0 ? g : P.al[i] * g;
  }
}

// The 17 gated Kabsch moments under (R, t) with weights P.al, into F.mom.
template <int NST>
__device__ void moments(const Points<NST>& P, Frame& F, float* red) {
  float R[9], t[3];
#pragma unroll
  for (int m = 0; m < 9; ++m) R[m] = F.R[m];
  t[0] = F.t[0]; t[1] = F.t[1]; t[2] = F.t[2];
  float v[kNMom];
#pragma unroll
  for (int m = 0; m < kNMom; ++m) v[m] = 0.0f;
#pragma unroll
  for (int i = 0; i < NST; ++i) {
    const float w = P.al[i];
    const float sp[3] = {
        R[0] * P.px[i] + R[1] * P.py[i] + R[2] * P.pz[i] + t[0],
        R[3] * P.px[i] + R[4] * P.py[i] + R[5] * P.pz[i] + t[1],
        R[6] * P.px[i] + R[7] * P.py[i] + R[8] * P.pz[i] + t[2]};
    const float tb[3] = {P.bx[i], P.by[i], P.bz[i]};
    v[0] += w;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[1 + a] += sp[a] * w;
      v[4 + a] += tb[a] * w;
#pragma unroll
      for (int b = 0; b < 3; ++b) v[7 + 3 * a + b] += sp[a] * w * tb[b];
    }
    const float dx = sp[0] - tb[0], dy = sp[1] - tb[1], dz = sp[2] - tb[2];
    v[16] += w * sqrtf(dx * dx + dy * dy + dz * dz);
  }
  sfk::block_sum<kNMom>(v, red, F.mom);
}

template <int NST>
__device__ sfk::IcpOut icp_lazy(Points<NST>& P, Frame& F, float4* page, float* red,
                           const int* ps, const int* pc, const int* pt,
                           const float* tgt, int TN, const SBParams& prm) {
  sfk::IcpOut o{sfk::kBig, 0, 0, sfk::kBig};
  associate(P, F, page, ps, pc, pt, tgt, TN, prm.gate, 0);
  {
    float v[1];
    v[0] = 0.0f;
#pragma unroll
    for (int i = 0; i < NST; ++i) v[0] += P.al[i];
    sfk::block_sum<1>(v, red, F.mom);
  }
  o.n_corr = (int)F.mom[0];
  bool live = o.n_corr >= prm.min_corr;
  for (int it = 0; it < prm.num_iterations && live; ++it) {
    moments(P, F, red);
    float err = 0.0f;
    bool hit = false;
    if (threadIdx.x == 0) {
      err = F.mom[16] / sfk::jmax(F.mom[0], 1.0f);
      hit = err < prm.acc;
      F.need = (!hit) && (fabsf(o.err - err) < prm.eps);
    }
    __syncthreads();
    if (F.need) {  // plateau: re-associate, the alive set only shrinks
      associate(P, F, page, ps, pc, pt, tgt, TN, prm.gate, 1);
      moments(P, F, red);
    }
    if (threadIdx.x == 0) {
      float R_step[9], t_step[3], detH;
      const bool ok = sfk::solve_step(F.mom, R_step, t_step, &detH);
      const bool stop = hit || !ok;
      sfk::apply_step(F.R, F.t, R_step, t_step, stop);
      o.err = err;
      o.iters += stop ? 0 : 1;
      o.det_min = sfk::jmin(o.det_min, detH);
      F.live = !stop;
    }
    __syncthreads();
    live = F.live;
  }
  return o;  // meaningful on thread 0
}

template <int NST>
__device__ sfk::IcpOut icp_fresh(Points<NST>& P, Frame& F, float4* page, float* red,
                            const int* ps, const int* pc, const int* pt,
                            const float* tgt, int TN, const SBParams& prm) {
  sfk::IcpOut o{sfk::kBig, 0, 0, sfk::kBig};
  bool live = true;
  for (int it = 0; it < prm.num_iterations && live; ++it) {
    associate(P, F, page, ps, pc, pt, tgt, TN, prm.gate, 0);
    moments(P, F, red);
    if (threadIdx.x == 0) {
      const float W = F.mom[0];
      const float Wc = sfk::jmax(W, 1.0f);
      const float err = W >= (float)prm.min_corr ? F.mom[16] / Wc : sfk::kBig;
      float R_step[9], t_step[3], detH;
      const bool ok = sfk::solve_step(F.mom, R_step, t_step, &detH);
      const bool stop = err < prm.acc || fabsf(o.err - err) < prm.eps || !ok;
      sfk::apply_step(F.R, F.t, R_step, t_step, stop);
      o.err = err;
      o.n_corr = (int)W;
      o.iters += stop ? 0 : 1;
      o.det_min = sfk::jmin(o.det_min, detH);
      F.live = !stop;
    }
    __syncthreads();
    live = F.live;
  }
  return o;
}

template <int NST>
__global__ void __launch_bounds__(1024, 1) superblock_kernel(
    const float* __restrict__ src_pages,  // (K, nSt, 3, TM)
    const int* __restrict__ pair_start,   // (K, nSt)
    const int* __restrict__ pair_cnt,     // (K, nSt)
    const int* __restrict__ pair_tgt,     // (K, max_pairs)
    const int* __restrict__ valid,        // (K,)
    const float* __restrict__ odom_T,     // (K, 4, 4)
    const float* __restrict__ gps_T,      // (K, 4, 4)
    const float* __restrict__ odom_tr,    // (K,)
    const float* __restrict__ gps_tr,     // (K,)
    const float* __restrict__ pose0,      // (4, 4)
    const float* __restrict__ odom_prev0, // (4, 4)
    const float* __restrict__ trans0,     // (Q, 4, 4)
    const int* __restrict__ count0,       // ()
    const float* __restrict__ filt_prev0, // (4, 4)
    const float* __restrict__ center,     // (3,)
    const float* __restrict__ tgt_pages,  // (nTt, 3, TN)
    float* __restrict__ poses_out,        // (K, 4, 4)
    float* __restrict__ priors_out,       // (K, 4, 4)
    float* __restrict__ odom_pred_out,    // (K, 4, 4)
    float* __restrict__ stats_out,        // (K, 128)
    float* __restrict__ state_out,        // (Q + 3, 4, 4)
    float* __restrict__ count_out,        // (1, 128)
    int K, int TN, int max_pairs, SBParams prm) {
  extern __shared__ float4 page[];
  __shared__ float red[kNMom * 32];
  __shared__ Frame F;
  const int TM = blockDim.x;
  const int Q = prm.Q;

  // carried state, thread 0 only
  float Rp[9], tp[3], Ro[9], to[3], Rf[9], tf[3];
  float trans[kQmax][12];
  int count = 0;
  // per-frame values thread 0 keeps across the ICP
  float Rg[9], tg[3], Rpr[9], tpr[3], Rpred[9], tpred[3], Rok[9], tok[3];
  float new_trans[kQmax][12];
  int new_count = 0;
  float cx[3];
  if (threadIdx.x == 0) {
    sfk::read44(pose0, Rp, tp);
    sfk::read44(odom_prev0, Ro, to);
    sfk::read44(filt_prev0, Rf, tf);
    for (int q = 0; q < Q; ++q) sfk::read44(trans0 + 16 * q, trans[q], trans[q] + 9);
    count = count0[0];
    cx[0] = center[0]; cx[1] = center[1]; cx[2] = center[2];
  }

  for (int k = 0; k < K; ++k) {
    const bool v = valid[k] != 0;
    if (threadIdx.x == 0) {
      float Rgk[9], tgk[3];
      sfk::read44(odom_T + 16 * k, Rok, tok);
      sfk::read44(gps_T + 16 * k, Rgk, tgk);
      // 1) odometry prediction
      float Roi[9], toi[3], Rd[9], td[3];
      sfk::inv_rigid(Ro, to, Roi, toi);
      sfk::compose(Roi, toi, Rok, tok, Rd, td);
      sfk::compose(Rp, tp, Rd, td, Rpred, tpred);
      // 2) element-wise covariance blend
      float og, gg;
      if (prm.fixed_gains) {
        og = 0.95f;
        gg = 0.05f;
      } else {
        const float tot = odom_tr[k] + gps_tr[k];
        og = gps_tr[k] / tot;
        gg = odom_tr[k] / tot;
      }
      for (int m = 0; m < 9; ++m) Rpr[m] = og * Rpred[m] + gg * Rgk[m];
      for (int a = 0; a < 3; ++a) tpr[a] = og * tpred[a] + gg * tgk[a];
      // 3) stochastic filter: push the transition, z-score gate
      float Rfi[9], tfi[3], Rtr[9], ttr[3];
      sfk::inv_rigid(Rf, tf, Rfi, tfi);
      sfk::compose(Rfi, tfi, Rpr, tpr, Rtr, ttr);
      const bool not_full = count < Q;
      for (int q = 0; q < Q; ++q) {
        const float* srcq;
        if (not_full) srcq = (count == q) ? nullptr : trans[q];
        else srcq = (q < Q - 1) ? trans[q + 1] : nullptr;
        for (int m = 0; m < 9; ++m) new_trans[q][m] = srcq ? srcq[m] : Rtr[m];
        for (int a = 0; a < 3; ++a) new_trans[q][9 + a] = srcq ? srcq[9 + a] : ttr[a];
      }
      new_count = min(count + 1, Q);
      float mean[3] = {0.0f, 0.0f, 0.0f}, px[kQmax][3];
      for (int q = 0; q < Q; ++q) {
        float v3[3];
        sfk::mv3(Rp, new_trans[q] + 9, v3);
        for (int a = 0; a < 3; ++a) {
          px[q][a] = v3[a] + tp[a];
          mean[a] = mean[a] + prm.wq[q] * px[q][a];
        }
      }
      float mad[3] = {0.0f, 0.0f, 0.0f};
      for (int q = 0; q < Q; ++q)
        for (int a = 0; a < 3; ++a) mad[a] = mad[a] + prm.wq[q] * fabsf(px[q][a] - mean[a]);
      for (int a = 0; a < 3; ++a) mad[a] = fminf(fmaxf(mad[a], prm.mad_lo), prm.mad_hi);
      float z = sfk::jmax(fabsf(tpr[0] - mean[0]) / mad[0],
                          sfk::jmax(fabsf(tpr[1] - mean[1]) / mad[1],
                                    fabsf(tpr[2] - mean[2]) / mad[2]));
      if (new_count < Q) z = 0.0f;
      // replacement mean pose sum_q w_q (transition_q @ pose)  (:106 order)
      float mR[9], mt[3];
      for (int m = 0; m < 9; ++m) mR[m] = 0.0f;
      for (int a = 0; a < 3; ++a) mt[a] = 0.0f;
      for (int q = 0; q < Q; ++q) {
        float Rc[9], tc[3];
        sfk::compose(new_trans[q], new_trans[q] + 9, Rp, tp, Rc, tc);
        for (int m = 0; m < 9; ++m) mR[m] = mR[m] + prm.wq[q] * Rc[m];
        for (int a = 0; a < 3; ++a) mt[a] = mt[a] + prm.wq[q] * tc[a];
      }
      const bool gated = z > prm.z_thr;
      for (int m = 0; m < 9; ++m) Rg[m] = gated ? mR[m] : Rpr[m];
      for (int a = 0; a < 3; ++a) tg[a] = gated ? mt[a] : tpr[a];
      // ICP runs in the frame rebased on the crop centre
      for (int m = 0; m < 9; ++m) F.R[m] = Rg[m];
      for (int a = 0; a < 3; ++a) F.t[a] = tg[a] - cx[a];
    }
    __syncthreads();

    sfk::IcpOut o{sfk::kBig, 0, 0, sfk::kBig};
    if (v) {  // an invalid frame's ICP result is discarded: skip it
      Points<NST> P;
      const float* s = src_pages + (size_t)k * NST * 3 * TM;
#pragma unroll
      for (int i = 0; i < NST; ++i) {
        P.px[i] = s[(i * 3 + 0) * TM + threadIdx.x];
        P.py[i] = s[(i * 3 + 1) * TM + threadIdx.x];
        P.pz[i] = s[(i * 3 + 2) * TM + threadIdx.x];
      }
      const int* ps = pair_start + k * NST;
      const int* pc = pair_cnt + k * NST;
      const int* pt = pair_tgt + (size_t)k * max_pairs;
      o = prm.lazy ? icp_lazy<NST>(P, F, page, red, ps, pc, pt, tgt_pages, TN, prm)
                   : icp_fresh<NST>(P, F, page, red, ps, pc, pt, tgt_pages, TN, prm);
    }

    if (threadIdx.x == 0) {
      const float vf = v ? 1.0f : 0.0f;
      float* st = stats_out + 128 * k;
      for (int m = 0; m < 128; ++m) st[m] = 0.0f;
      float Rfin[9], tfin[3];
      if (v) {
        const bool enough = o.n_corr >= prm.min_corr;
        float ticp[3];
        for (int a = 0; a < 3; ++a) ticp[a] = F.t[a] + cx[a];
        for (int m = 0; m < 9; ++m) Rfin[m] = enough ? F.R[m] : Rg[m];
        for (int a = 0; a < 3; ++a) tfin[a] = enough ? ticp[a] : tg[a];
        const bool conv = enough && o.err < prm.acc;
        st[0] = vf * (enough ? o.err : 1.0e6f);
        st[1] = vf * (float)(enough ? o.iters : 0);
        st[2] = vf * (float)o.n_corr;
        st[3] = vf * (conv ? 1.0f : 0.0f);
        st[4] = vf * o.det_min;
        // 5) predicated state update
        for (int m = 0; m < 9; ++m) { Rp[m] = Rfin[m]; Ro[m] = Rok[m]; Rf[m] = Rpr[m]; }
        for (int a = 0; a < 3; ++a) { tp[a] = tfin[a]; to[a] = tok[a]; tf[a] = tpr[a]; }
        for (int q = 0; q < Q; ++q)
          for (int m = 0; m < 12; ++m) trans[q][m] = new_trans[q][m];
        count = new_count;
      }
      sfk::pack44(Rp, tp, 1.0f, poses_out + 16 * k);
      sfk::pack44(Rg, tg, vf, priors_out + 16 * k);
      sfk::pack44(Rpred, tpred, vf, odom_pred_out + 16 * k);
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    sfk::pack44(Rp, tp, 1.0f, state_out);
    sfk::pack44(Ro, to, 1.0f, state_out + 16);
    sfk::pack44(Rf, tf, 1.0f, state_out + 32);
    for (int q = 0; q < Q; ++q) sfk::pack44(trans[q], trans[q] + 9, 1.0f, state_out + 48 + 16 * q);
    count_out[0] = (float)count;
    for (int m = 1; m < 128; ++m) count_out[m] = 0.0f;
  }
}

template <int NST>
int launch(const float* src_pages, const int* pair_start, const int* pair_cnt,
           const int* pair_tgt, const int* valid, const float* odom_T,
           const float* gps_T, const float* odom_tr, const float* gps_tr,
           const float* pose0, const float* odom_prev0, const float* trans0,
           const int* count0, const float* filt_prev0, const float* center,
           const float* tgt_pages, float* poses_out, float* priors_out,
           float* odom_pred_out, float* stats_out, float* state_out,
           float* count_out, int K, int TM, int TN, int max_pairs,
           const SBParams& prm, cudaStream_t stream) {
  const size_t smem = (size_t)TN * sizeof(float4);
  cudaError_t e = cudaFuncSetAttribute(
      superblock_kernel<NST>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  superblock_kernel<NST><<<1, TM, smem, stream>>>(
      src_pages, pair_start, pair_cnt, pair_tgt, valid, odom_T, gps_T, odom_tr,
      gps_tr, pose0, odom_prev0, trans0, count0, filt_prev0, center, tgt_pages,
      poses_out, priors_out, odom_pred_out, stats_out, state_out, count_out, K,
      TN, max_pairs, prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K1 on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a tile count or queue size it was not built for.
extern "C" int sfk_superblock_fine(
    const float* src_pages, const int* pair_start, const int* pair_cnt,
    const int* pair_tgt, const int* valid, const float* odom_T,
    const float* gps_T, const float* odom_tr, const float* gps_tr,
    const float* pose0, const float* odom_prev0, const float* trans0,
    const int* count0, const float* filt_prev0, const float* center,
    const float* tgt_pages, float* poses_out, float* priors_out,
    float* odom_pred_out, float* stats_out, float* state_out, float* count_out,
    int K, int nSt, int TM, int TN, int max_pairs, const SBParams* prm,
    cudaStream_t stream) {
  if (prm->Q < 1 || prm->Q > kQmax) return (int)cudaErrorInvalidValue;
#define SFK_LAUNCH(N)                                                        \
  case N:                                                                    \
    return launch<N>(src_pages, pair_start, pair_cnt, pair_tgt, valid,       \
                     odom_T, gps_T, odom_tr, gps_tr, pose0, odom_prev0,      \
                     trans0, count0, filt_prev0, center, tgt_pages,          \
                     poses_out, priors_out, odom_pred_out, stats_out,        \
                     state_out, count_out, K, TM, TN, max_pairs, *prm, stream);
  switch (nSt) {
    SFK_LAUNCH(1)
    SFK_LAUNCH(2)
    SFK_LAUNCH(3)
    SFK_LAUNCH(4)
    SFK_LAUNCH(5)
    SFK_LAUNCH(6)
    SFK_LAUNCH(7)
    SFK_LAUNCH(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SFK_LAUNCH
}

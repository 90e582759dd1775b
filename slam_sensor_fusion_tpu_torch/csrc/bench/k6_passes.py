#!/usr/bin/env python3
"""Where K6's time goes, on one GPU.

    python3 slam_sensor_fusion_tpu_torch/csrc/bench/k6_passes.py [--package DIR] [--label NAME] [--plain]

Copies the package of the checkout at DIR (default: this one) into this
checkout's git-ignored build directory (`_build/k6_passes/`) with K6 (the
fixed-correspondence GN on a given matched set, `sfk_p2p_gn_corr` in
`csrc/p2p_fused.cu`) instrumented by the card's %globaltimer, read on the
thread that runs the scalar tail (thread 0 of the kernel's first block):
the launch, the load of the matched set (the thread-block cluster's copy
into shared memory and its first cluster barrier; none in the one-block
kernel, which reads global memory every pass), and in each GN pass the
accumulation of the 29 moments (to a barrier added after it: a block
barrier in the one-block kernel, a cluster barrier in the cluster), the
reduction (warp trees, warp partials, the sum in warp order) and the
scalar tail of a step (damped Cholesky solve, Taylor SE(3) step, polish,
composition; in the cluster also the barrier that hands the new pose to
the other CTAs). Both kernel forms are recognised, so the parent tree's
one-block K6 and this tree's cluster split the same way when DIR is a
`git archive` of the parent.

The matched set is K5's plain winners on the card tests' bench scene
(tests/torch_lio_world.p2p_scene: 16 source tiles of 512 against 32 target
tiles of 1024, 2 GN iterations on fixed correspondences: 3 passes); K6
runs `--launches` times after a warm-up. The added barriers make the
copy's launches slightly slower than `chip_smoke.py`'s K6 times.

With `--plain` the copy is left as it is and K5 and K6 are timed on that
scene instead: each call's device time under torch.profiler (the sum of
the kernels it launches: the card alone) and back-to-back calls by CUDA
events (which the host's work a call bounds when it exceeds the kernel's),
so the parent tree's kernels and this tree's compare in one process each.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
COPY = os.path.join(ROOT, "slam_sensor_fusion_tpu_torch", "_build", "k6_passes")

#: counters: 0 launch ns, 1 load ns, 2 accumulation ns, 3 reduction ns,
#: 4 tail ns, 5 launches, 6 passes, 7 steps
N_COUNTERS = 8

_TIMER = f'''#include "icp_fused.cuh"

static __device__ unsigned long long g_prof[{N_COUNTERS}];
static __device__ __forceinline__ unsigned long long now_ns() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
'''

#: the cluster kernel (csrc/p2p_fused.cu `p2p_gn_cluster_kernel`):
#: file -> [(text in it, its instrumented replacement, occurrences)]
CLUSTER = {
    "p2p_fused.cuh": [('#include "icp_fused.cuh"\n', _TIMER, 1)],
    "p2p_fused.cu": [
        ("  const int r = v - g * TM;\n",
         "  const int r = v - g * TM;\n  const unsigned long long t_start = now_ns();\n", 1),
        ("  cl.sync();                         // every CTA runs before DSMEM is touched\n",
         """  cl.sync();                         // every CTA runs before DSMEM is touched
  const bool lead = rank == 0 && threadIdx.x == 0;
  if (lead) atomicAdd(&g_prof[1], now_ns() - t_start);
""", 1),
        ("  for (int it = 0;; ++it) {\n",
         "  for (int it = 0;; ++it) {\n    const unsigned long long t_pass = now_ns();\n", 1),
        ("    // block_sum's warp tree; each warp's partial into CTA 0's red\n",
         """    cl.sync();
    const unsigned long long t_acc = now_ns();
    if (lead) atomicAdd(&g_prof[2], t_acc - t_pass);
    // block_sum's warp tree; each warp's partial into CTA 0's red
""", 1),
        ("    if (rank == 0) {\n",
         "    unsigned long long t_red = 0;\n    if (rank == 0) {\n", 1),
        ("""      __syncthreads();
      if (threadIdx.x == 0) {
        if (last) {""", """      __syncthreads();
      t_red = now_ns();
      if (lead) {
        atomicAdd(&g_prof[3], t_red - t_acc);
        atomicAdd(&g_prof[6], 1ull);
      }
      if (threadIdx.x == 0) {
        if (last) {""", 1),
        ("    if (last) return;\n", """    if (last) {
      if (lead) {
        atomicAdd(&g_prof[0], now_ns() - t_start);
        atomicAdd(&g_prof[5], 1ull);
      }
      return;
    }
""", 1),
        ("    for (int a = 0; a < 3; ++a) t[a] = S0->t[a];\n",
         """    for (int a = 0; a < 3; ++a) t[a] = S0->t[a];
    if (lead) {
      atomicAdd(&g_prof[4], now_ns() - t_red);
      atomicAdd(&g_prof[7], 1ull);
    }
""", 1),
    ],
}

#: the one-block kernel (`p2p_gn_corr_kernel` on p2p_fused.cuh's
#: `gn_passes`); the step's lines also stand in K4's fresh GN loop, which
#: this script does not run
ONE_BLOCK = {
    "p2p_fused.cuh": [
        ('#include "icp_fused.cuh"\n', _TIMER, 1),
        ("__device__ inline void moments(Shared& S, const Tiles& T, const P2PParams& prm, "
         "float* red) {\n",
         "__device__ inline void moments(Shared& S, const Tiles& T, const P2PParams& prm, "
         "float* red) {\n  const unsigned long long t_pass = now_ns();\n", 1),
        ("  sfk::block_sum<kNMom>(v, red, S.mom);\n", """  __syncthreads();
  const unsigned long long t_acc = now_ns();
  if (threadIdx.x == 0) atomicAdd(&g_prof[2], t_acc - t_pass);
  sfk::block_sum<kNMom>(v, red, S.mom);
  if (threadIdx.x == 0) {
    atomicAdd(&g_prof[3], now_ns() - t_acc);
    atomicAdd(&g_prof[6], 1ull);
  }
""", 1),
        ("""      if (threadIdx.x == 0) gn_step(S, prm.damping);
      __syncthreads();
""", """      const unsigned long long t_tail = now_ns();
      if (threadIdx.x == 0) gn_step(S, prm.damping);
      __syncthreads();
      if (threadIdx.x == 0) {
        atomicAdd(&g_prof[4], now_ns() - t_tail);
        atomicAdd(&g_prof[7], 1ull);
      }
""", 2),
    ],
    "p2p_fused.cu": [
        ("""  sfk::p2p::gn_passes(S, T, prm, red);
  if (threadIdx.x == 0) pack_outputs(S, prm, T_out, stats);
""", """  const unsigned long long t_start = now_ns();
  sfk::p2p::gn_passes(S, T, prm, red);
  if (threadIdx.x == 0) {
    pack_outputs(S, prm, T_out, stats);
    atomicAdd(&g_prof[0], now_ns() - t_start);
    atomicAdd(&g_prof[5], 1ull);
  }
""", 1),
    ],
}

READER = f"""
// Copy the counters out and zero them.
extern "C" int sfk_k6_passes(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[{N_COUNTERS}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}}
"""


def instrumented_copy(checkout: str, patch: bool = True) -> tuple[str, str]:
    """The package of `checkout` copied under COPY with K6 instrumented
    (unless not `patch`); returns (the copy's root, the kernel form:
    "cluster" or "one block")."""
    dst = os.path.join(COPY, "slam_sensor_fusion_tpu_torch")
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(checkout, "slam_sensor_fusion_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(dst, "csrc")
    cluster = "p2p_gn_cluster_kernel" in open(os.path.join(csrc, "p2p_fused.cu")).read()
    for name, patches in (CLUSTER if cluster else ONE_BLOCK).items() if patch else ():
        path = os.path.join(csrc, name)
        src = open(path).read()
        for old, new, count in patches:
            if src.count(old) != count:
                raise RuntimeError(f"k6_passes: csrc/{name} changed; {old!r} is not there "
                                   f"{count} time(s)")
            src = src.replace(old, new)
        if name == "p2p_fused.cu":
            src += READER
        with open(path, "w") as f:
            f.write(src)
    return COPY, "cluster" if cluster else "one block"


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=ROOT, help="checkout whose K6 is split")
    ap.add_argument("--label", default="this tree", help="name of that checkout in the output")
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--plain", action="store_true", help="time K5 and K6 uninstrumented")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k6_passes: needs an NVIDIA GPU")
    copy, form = instrumented_copy(os.path.abspath(args.package), patch=not args.plain)
    sys.path[:0] = [copy, os.path.join(ROOT, "tests"), ROOT]
    import chip_smoke as cs
    from slam_sensor_fusion_tpu_torch.ops import cuda_lib
    from slam_sensor_fusion_tpu_torch.ops import p2p_fused as tpf
    from slam_sensor_fusion_tpu_torch.ops.point_to_plane import PointToPlaneConfig
    from torch_lio_world import p2p_core_inputs, p2p_scene

    assert cuda_lib.__file__.startswith(copy), cuda_lib.__file__
    dev = torch.device("cuda", 0)
    tag = cs.card()
    config = PointToPlaneConfig(
        num_iterations=2, tile_src=512, tile_tgt=1024, max_visits=64, reassoc_margin=0.15,
        nn_backend="fused", fixed_correspondences=True,
    )
    core = p2p_core_inputs(p2p_scene(7, n_tgt=30000, M=8192, N=32768), config, dev)
    d2, qn = tpf._p2p_associate_plain(*core)
    k6_in = (core[5], core[0], d2, qn)
    if args.plain:
        k5_dev = cs.device_ms(lambda: tpf._p2p_associate(*core), args.launches, ("",))
        k6_dev = cs.device_ms(lambda: tpf._p2p_gn_corr(*k6_in, config), args.launches, ("",))
        k5_ev = cs.time_ms(lambda: tpf._p2p_associate(*core), args.launches)
        k6_ev = cs.time_ms(lambda: tpf._p2p_gn_corr(*k6_in, config), args.launches)
        print(f"K5 and K6 ({args.label}: K6 {form}; {tuple(core[0].shape)} source pages, "
              f"{tuple(core[1].shape)} target pages, {int(core[3].sum())} tile pairs, "
              f"{args.launches} calls each): on the card alone K5 {k5_dev} ms, K6 {k6_dev} ms a "
              f"call; back-to-back by CUDA events K5 {k5_ev:.4f} ms, K6 {k6_ev:.4f} ms a call "
              f"[{tag}]", flush=True)
        return
    lib = cuda_lib.lib()
    lib.sfk_k6_passes.argtypes = [ctypes.c_void_p]
    counters = (ctypes.c_ulonglong * N_COUNTERS)()

    def read() -> list[int]:
        torch.cuda.synchronize()
        cuda_lib.check(lib.sfk_k6_passes(counters), "sfk_k6_passes")
        return [int(x) for x in counters]

    tpf._p2p_gn_corr(*k6_in, config)
    read()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(args.launches):
        tpf._p2p_gn_corr(*k6_in, config)
    b.record()
    p = read()
    ev_us = a.elapsed_time(b) * 1e3 / args.launches
    n, passes, steps = max(p[5], 1), max(p[6], 1), max(p[7], 1)
    assert p[5] == args.launches, (p[5], args.launches)
    us = [x / 1e3 for x in p]
    rest = us[0] - us[1] - us[2] - us[3] - us[4]
    shape = ""
    if form == "cluster":
        c = tpf.gn_cluster(core[0].shape[0], core[0].shape[2])
        shape = f", {c['ctas']} CTAs x {c['threads']} threads, {c['smem_bytes']} B staged a CTA"
    print(f"K6 split ({args.label}: {form}{shape}; {tuple(core[0].shape)} source pages, "
          f"{p[6] // n} passes and {p[7] // n} steps a launch, {args.launches} launches): "
          f"{us[0] / n:.2f} us a launch in the kernel ({ev_us:.2f} us a launch by CUDA events) = "
          f"load {us[1] / n:.2f} + accumulation {us[2] / n:.2f} + reduction {us[3] / n:.2f} + "
          f"tail {us[4] / n:.2f} + rest {rest / n:.2f}; a pass: accumulation "
          f"{us[2] / passes:.2f} us, reduction {us[3] / passes:.2f} us; a step's tail "
          f"{us[4] / steps:.2f} us [{tag}]", flush=True)


if __name__ == "__main__":
    main()

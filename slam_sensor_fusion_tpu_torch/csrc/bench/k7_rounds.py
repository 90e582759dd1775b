#!/usr/bin/env python3
"""Where K7's time goes, on one GPU.

    python3 slam_sensor_fusion_tpu_torch/csrc/bench/k7_rounds.py

Copies the package into its git-ignored build directory
(`_build/k7_rounds/`) with K7 (`csrc/lio_superblock_fused.cu`) and its GN
loop (`grid_gn` in `csrc/p2p_fused.cuh`) instrumented by the card's
%globaltimer: the leader's thread 0 adds up, a valid frame, the time it
spends in the EKF's IMU propagation, in the GN (within it: the association
rounds, publish to the second grid barrier, and the combine; the rest is
the moment sums and solves of the GN passes), in the Kalman updates (pose
and GPS, their Joseph forms) and in the whole launch; each worker adds up
its scan time a round and keeps the longest. Then runs the copy's
`run_lio_superblocks` over `chip_smoke.py`'s LIO world and configuration
(128 frames, 8 blocks of 16: one K7 launch a block) twice and prints the
second pass's split a launch and a frame. The instrumentation adds a few
block barriers and atomics a frame, so its totals run slightly above
`chip_smoke.py`'s K7 times.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
PKG = os.path.join(ROOT, "slam_sensor_fusion_tpu_torch")
COPY = os.path.join(PKG, "_build", "k7_rounds")

#: counters: 0 launch ns, 1 round ns, 2 combine ns, 3 rounds, 4 launches,
#: 5 worker scan ns, 6 worker rounds, 7 longest worker scan ns, 8 GN ns,
#: 9 IMU propagation ns, 10 Kalman ns, 11 valid frames
N_COUNTERS = 12

#: file -> [(text in it, its instrumented replacement)]
PATCHES = {
    "p2p_fused.cuh": [
        ('#include "icp_fused.cuh"\n', f'''#include "icp_fused.cuh"

static __device__ unsigned long long g_prof[{N_COUNTERS}];
static __device__ __forceinline__ unsigned long long now_ns() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
'''),
        ("    grid::lead_round(g, ctl, frame, S.R, S.t);\n",
         """    const unsigned long long ta = now_ns();
    grid::lead_round(g, ctl, frame, S.R, S.t);
    const unsigned long long tb = now_ns();
"""),
        ("""    });
  };
  if (prm.fixed) {""", """    });
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(&g_prof[1], tb - ta);
      atomicAdd(&g_prof[2], now_ns() - tb);
      atomicAdd(&g_prof[3], 1ull);
    }
  };
  if (prm.fixed) {"""),
    ],
    "lio_superblock_fused.cu": [
        ("""      sfk::grid::scan_first<6>(round_of(sfk::grid::read_frame(ctl)), ctl);
""", """      const unsigned long long t1 = now_ns();
      sfk::grid::scan_first<6>(round_of(sfk::grid::read_frame(ctl)), ctl);
      __syncthreads();
      if (threadIdx.x == 0) {
        const unsigned long long d = now_ns() - t1;
        atomicAdd(&g_prof[5], d);
        atomicAdd(&g_prof[6], 1ull);
        atomicMax(&g_prof[7], d);
      }
"""),
        ("  float cx[3] = {center[0], center[1], center[2]};\n",
         """  float cx[3] = {center[0], center[1], center[2]};
  const unsigned long long t_start = now_ns();
"""),
        ("    // 1) IMU propagation\n", """    const unsigned long long t_imu = now_ns();
    // 1) IMU propagation
"""),
        ("    // 2) GN registration in the anchor-rebased frame\n",
         """    if (tid == 0) atomicAdd(&g_prof[9], now_ns() - t_imu);
    // 2) GN registration in the anchor-rebased frame
"""),
        ("    sfk::p2p::grid_gn(g, ctl, k, S.g, T, A, prm.p2p, red);\n",
         """    const unsigned long long t_gn = now_ns();
    sfk::p2p::grid_gn(g, ctl, k, S.g, T, A, prm.p2p, red);
    __syncthreads();
    if (tid == 0) {
      atomicAdd(&g_prof[8], now_ns() - t_gn);
      atomicAdd(&g_prof[11], 1ull);
    }
    const unsigned long long t_kal = now_ns();
"""),
        ("""      st[5] = sd;
    }
    __syncthreads();
""", """      st[5] = sd;
    }
    __syncthreads();
    if (tid == 0) atomicAdd(&g_prof[10], now_ns() - t_kal);
"""),
        ("  sfk::grid::dismiss(g, ctl);\n", """  sfk::grid::dismiss(g, ctl);
  if (tid == 0) {
    atomicAdd(&g_prof[0], now_ns() - t_start);
    atomicAdd(&g_prof[4], 1ull);
  }
"""),
    ],
}

READER = f"""
// Copy the counters out and zero them.
extern "C" int sfk_k7_rounds(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[{N_COUNTERS}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}}
"""


def instrumented_copy() -> str:
    """The package copied to COPY with K7 instrumented; returns its parent."""
    dst = os.path.join(COPY, "slam_sensor_fusion_tpu_torch")
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, patches in PATCHES.items():
        path = os.path.join(dst, "csrc", name)
        src = open(path).read()
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"k7_rounds: csrc/{name} changed; no unique {old!r}")
            src = src.replace(old, new)
        if name == "lio_superblock_fused.cu":
            src += READER
        with open(path, "w") as f:
            f.write(src)
    return COPY


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("k7_rounds: needs an NVIDIA GPU")
    sys.path[:0] = [instrumented_copy(), ROOT]
    import chip_smoke as cs
    from slam_sensor_fusion_tpu_torch.models import lio
    from slam_sensor_fusion_tpu_torch.ops import cuda_lib
    from slam_sensor_fusion_tpu_torch.ops.lio_superblock_fused import lio_superblock

    assert cuda_lib.__file__.startswith(COPY), cuda_lib.__file__
    dev = torch.device("cuda", 0)
    tag = cs.card()
    lib = cuda_lib.lib()
    lib.sfk_k7_rounds.argtypes = [ctypes.c_void_p]
    counters = (ctypes.c_ulonglong * N_COUNTERS)()

    def read() -> list[int]:
        torch.cuda.synchronize()
        cuda_lib.check(lib.sfk_k7_rounds(counters), "sfk_k7_rounds")
        return [int(x) for x in counters]

    def up(a):
        return torch.from_numpy(a).to(dev)

    cfg = cs.lio_config()
    poses, v0, sp, sm, tp, gyro, accel, dts, gps = cs.build_lio_world(cs.LIO_FRAMES, cfg.scan_capacity)
    state0 = lio.init_state(cfg, up(sp[0]), up(sm[0]), up(poses[0]))
    state0 = state0._replace(ekf_state=state0.ekf_state._replace(v=up(v0)))
    T = cs.LIO_FRAMES - 1
    gps_var = torch.full((T,), 0.25, dtype=torch.float32, device=dev)
    frames = [up(a) for a in (sp[1:], sm[1:], gyro, accel, dts, gps)]
    frames += [gps_var, torch.ones(T, dtype=torch.bool, device=dev)]
    tau = up(tp[1:])
    lio.run_lio_superblocks(state0, *frames, cfg, scan_tau=tau)
    read()
    before = lio_superblock.launches
    lio.run_lio_superblocks(state0, *frames, cfg, scan_tau=tau)
    p = read()
    n, f, r = max(p[4], 1), max(p[11], 1), max(p[3], 1)
    assert lio_superblock.launches - before == p[4], (lio_superblock.launches - before, p[4])
    us = [x / 1e3 for x in p]
    rest = us[0] - us[8] - us[9] - us[10]
    gn_rest = us[8] - us[1] - us[2]
    print(f"K7 steady pass: {p[4]} launches, {p[11]} valid frames, {us[0] / n:.1f} us a launch = "
          f"IMU propagation {us[9] / n:.1f} + GN {us[8] / n:.1f} (rounds {us[1] / n:.1f}, combine "
          f"{us[2] / n:.1f}, moments and solves {gn_rest / n:.1f}) + Kalman {us[10] / n:.1f} + rest "
          f"{rest / n:.1f} us [{tag}]", flush=True)
    print(f"K7 a frame: IMU propagation {us[9] / f:.2f} us, {p[3] / f:.1f} rounds {us[1] / f:.2f} us "
          f"(a round {us[1] / r:.2f} us), combine {us[2] / f:.2f} us, moments and solves "
          f"{gn_rest / f:.2f} us, Kalman {us[10] / f:.2f} us; a worker's scan a round "
          f"{us[5] / max(p[6], 1):.2f} us, longest {us[7]:.2f} us [{tag}]", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where K1's time goes, on one GPU.

    python3 slam_sensor_fusion_tpu_torch/csrc/bench/k1_rounds.py

Copies the package into its git-ignored build directory
(`_build/k1_rounds/`) with K1 (`csrc/superblock_fused.cu`) instrumented by
the card's %globaltimer: the leader's thread 0 adds up the time it spends
in association rounds (publish to the second grid barrier), in the combine
and in the rest of the launch (the serial chain: filter, moments, Kabsch
solves); each worker adds up its scan time a round and keeps the longest.
Then runs the copy's K1 on the main path's startup superblock (5 launches)
and over one steady pass of `run_chunk_fast` (32 launches), on
`chip_smoke.py`'s bench world, and prints the split a launch. The
instrumentation adds a block barrier and a few atomics a round, so its
totals run slightly above `chip_smoke.py`'s K1 times.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
PKG = os.path.join(ROOT, "slam_sensor_fusion_tpu_torch")
COPY = os.path.join(PKG, "_build", "k1_rounds")

#: (text in csrc/superblock_fused.cu, its instrumented replacement)
PATCHES = [
    ("namespace cg = cooperative_groups;\n", """namespace cg = cooperative_groups;

// 0 launch ns, 1 round ns, 2 combine ns, 3 rounds, 4 launches,
// 5 worker scan ns, 6 worker rounds, 7 longest worker scan ns
__device__ unsigned long long g_prof[8];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""),
    ("  sfk::grid::lead_round(g, A.ctl, k, F.R, F.t);\n",
     """  const unsigned long long ta = now_ns();
  sfk::grid::lead_round(g, A.ctl, k, F.R, F.t);
  const unsigned long long tb = now_ns();
"""),
    ("""    P.al[i] = mode == 0 ? gt : P.al[i] * gt;
  }
}""", """    P.al[i] = mode == 0 ? gt : P.al[i] * gt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(&g_prof[1], tb - ta);
    atomicAdd(&g_prof[2], now_ns() - tb);
    atomicAdd(&g_prof[3], 1ull);
  }
}"""),
    ("""      sfk::grid::serve(g, ctl, [&] { scan_items<Pts::kTiles>(A, page); });
    return;
  }""", """      sfk::grid::serve(g, ctl, [&] {
      const unsigned long long t1 = now_ns();
      scan_items<Pts::kTiles>(A, page);
      __syncthreads();
      if (threadIdx.x == 0) {
        const unsigned long long d = now_ns() - t1;
        atomicAdd(&g_prof[5], d);
        atomicAdd(&g_prof[6], 1ull);
        atomicMax(&g_prof[7], d);
      }
    });
    return;
  }
  const unsigned long long t_start = now_ns();"""),
    ("  sfk::grid::dismiss(g, ctl);\n", """  sfk::grid::dismiss(g, ctl);
  if (threadIdx.x == 0) {
    atomicAdd(&g_prof[0], now_ns() - t_start);
    atomicAdd(&g_prof[4], 1ull);
  }
"""),
]

READER = """
// Copy the counters out and zero them.
extern "C" int sfk_k1_rounds(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""


def instrumented_copy() -> str:
    """The package copied to COPY with K1 instrumented; returns its parent."""
    dst = os.path.join(COPY, "slam_sensor_fusion_tpu_torch")
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(dst, "csrc", "superblock_fused.cu")
    src = open(path).read()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"k1_rounds: csrc/superblock_fused.cu changed; no unique {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src + READER)
    return COPY


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("k1_rounds: needs an NVIDIA GPU")
    sys.path[:0] = [instrumented_copy(), ROOT]
    import numpy as np

    import chip_smoke as cs
    from slam_sensor_fusion_tpu_torch.models import localization as lz
    from slam_sensor_fusion_tpu_torch.models import pipeline_fast as pf
    from slam_sensor_fusion_tpu_torch.ops import cuda_lib
    from slam_sensor_fusion_tpu_torch.ops.superblock_fused import superblock_fine

    assert cuda_lib.__file__.startswith(COPY), cuda_lib.__file__
    dev = torch.device("cuda", 0)
    tag = cs.card()
    lib = cuda_lib.lib()
    lib.sfk_k1_rounds.argtypes = [ctypes.c_void_p]
    counters = (ctypes.c_ulonglong * 8)()

    def read() -> list[int]:
        torch.cuda.synchronize()
        cuda_lib.check(lib.sfk_k1_rounds(counters), "sfk_k1_rounds")
        return [int(x) for x in counters]

    def show(what: str, p: list[int]) -> None:
        n, r = max(p[4], 1), max(p[3], 1)
        print(f"{what}: {p[4]} launches, {p[0] / n / 1e3:.1f} us a launch = {p[3] / n:.1f} rounds "
              f"{p[1] / n / 1e3:.1f} us (a round {p[1] / r / 1e3:.2f} us) + combine "
              f"{p[2] / n / 1e3:.1f} us + serial chain {(p[0] - p[1] - p[2]) / n / 1e3:.1f} us; "
              f"a worker's scan a round {p[5] / max(p[6], 1) / 1e3:.2f} us, longest "
              f"{p[7] / 1e3:.2f} us [{tag}]", flush=True)

    config = cs.bench_config()
    seq, map_data = cs.build_world(cs.N_FRAMES)
    loc = lz.Localizer(map_data, config, dev)
    gps_T = loc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    state0, _, _ = cs.startup(loc, seq, gps_T, config, dev)
    T = cs.N_FRAMES - 1
    frames = pf.build_paged_frames(
        config, seq.scans[1:cs.N_FRAMES], seq.odom_T_sensor[1:cs.N_FRAMES], gps_T[1:cs.N_FRAMES],
        seq.odom_cov_trace[1:cs.N_FRAMES], seq.gps_cov_trace[1:cs.N_FRAMES], np.ones(T, bool), dev,
    )
    blk = pf.PagedFrames(*[x[:config.superstep] for x in frames])
    pro = pf.superstep_prologue(state0, blk, loc.map_cloud, config)
    fs = state0.filter_state
    args = (
        blk.src_pages, pro.pair_start, pro.pair_cnt, pro.pair_tgt, blk.valid,
        blk.odom_T_sensor, blk.map_T_sensor_gps, blk.odom_cov_trace, blk.gps_cov_trace,
        state0.map_T_sensor, state0.odom_T_sensor_previous, fs.transitions, fs.count,
        fs.previous_pose, pro.cached_target.center, pro.cached_target.pages, config,
    )
    superblock_fine(*args)
    read()
    for _ in range(5):
        superblock_fine(*args)
    show("K1 startup superblock", read())
    pf.run_chunk_fast(state0, frames, loc.map_cloud, config)
    read()
    pf.run_chunk_fast(state0, frames, loc.map_cloud, config)
    show("K1 steady pass", read())


if __name__ == "__main__":
    main()

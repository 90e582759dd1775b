#!/usr/bin/env python3
"""The localization and mapping paths of chip_smoke.py's phases 3, 5 and 9
on one GPU: ATE-RMSE and scans/s (frames/s) of each.

    python3 slam_sensor_fusion_tpu_torch/csrc/bench/host_paths.py [--package DIR] [--label NAME]

The companion of lio_paths.py, with the same `--package` rule (a `git
archive` of a parent commit unpacked under the git-ignored `_parent/`
gives the parent's package), and the worlds and configurations of this
checkout's chip_smoke.py, so two trees run the same inputs. Paths, each
run twice from one state (the second pass timed, host clock around a
synchronised call):

- phase 3: `run_chunk_fast` over bench_loc's world (256 frames, one K1
  launch a superblock of 8; the brute-force startup's `rot_z` before it);
- phase 5: `Localizer.run` over bench_latency's world (33 frames) on the
  K2 (parity) and K3 (fast) engines;
- phase 9: bench_map's loop (16 groups of 8 skewed 16 384-point scans:
  deskew, transform, one insert a group) into the sorted and the hash
  store.

One JSON line a path, with the card's name and power limit. Run parent,
change, change, parent in one call to compare two trees on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))


def smoke_helpers():
    """This checkout's chip_smoke.py as a module (its worlds, configurations
    and constants), whichever package is on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default=ROOT, help="checkout whose package runs")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.package))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("host_paths: no CUDA device")
    from slam_sensor_fusion_tpu_torch.models import localization as lz
    from slam_sensor_fusion_tpu_torch.models import pipeline_fast as pf
    from slam_sensor_fusion_tpu_torch.models.mapping import build_map_data
    from slam_sensor_fusion_tpu_torch.ops.deskew import se3_log
    from slam_sensor_fusion_tpu_torch.ops.voxel_map import (
        VoxelMapConfig,
        voxel_map_init,
        voxel_map_insert,
    )
    from slam_sensor_fusion_tpu_torch.ops.voxel_map_sorted import (
        SortedVoxelMapConfig,
        sorted_voxel_map_init,
        sorted_voxel_map_insert,
    )

    cs = smoke_helpers()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()

    def emit(path, frames, seconds, **extra):
        print(json.dumps({"label": args.label, "path": path, "frames": frames,
                          "scans_s": frames / seconds, **extra, "card": card}), flush=True)

    def twice(run):
        """Two passes of `run`: (the second's seconds, its output)."""
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
        return dt, out

    # ---- phase 3: bench_loc's world, the superblock replay ----
    config = cs.bench_config()
    seq, tiles, odom_pos, gps_rows = cs.world_parts(cs.N_FRAMES, cs.RAW_POINTS)
    loc = lz.Localizer(build_map_data(tiles, odom_pos, gps_rows), config, dev)
    gps_T = loc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, _, coarse = cs.startup(loc, seq, gps_T, config, dev)
    torch.cuda.synchronize()
    t_start = time.perf_counter() - t1
    T = cs.N_FRAMES - 1
    frames = pf.build_paged_frames(
        config, seq.scans[1:cs.N_FRAMES], seq.odom_T_sensor[1:cs.N_FRAMES],
        gps_T[1:cs.N_FRAMES], seq.odom_cov_trace[1:cs.N_FRAMES],
        seq.gps_cov_trace[1:cs.N_FRAMES], np.ones(T, bool), dev)
    dt, (_, out) = twice(lambda: pf.run_chunk_fast(state, frames, loc.map_cloud, config))
    emit("phase 3 run_chunk_fast", T, dt,
         ate_rmse_m=cs.ate_rmse(out.map_T_sensor.cpu().numpy(), seq.true_map_T_sensor[1:cs.N_FRAMES]),
         startup_s=t_start, coarse_success=bool(coarse.success))

    # ---- phase 5: Localizer.run on bench_latency's world ----
    scfg = cs.session_config()
    sseq, smap = cs.build_session_world(cs.SESSION_FRAMES)
    n = cs.REPLAY_FRAMES
    run_args = (sseq.scans[:n], sseq.odom_T_sensor[:n], sseq.gps_lat[:n], sseq.gps_lon[:n],
                sseq.gps_alt[:n], sseq.compass_yaw[:n], sseq.odom_cov_trace[:n],
                sseq.gps_cov_trace[:n])
    engines = {"parity": dataclasses.replace(
        scfg, icp=dataclasses.replace(scfg.icp, mode="parity")), "fast": scfg}
    for label, cfg in engines.items():
        dt, rr = twice(lambda: lz.Localizer(smap, cfg, dev).run(*run_args))
        ok = rr.valid
        emit(f"phase 5 Localizer.run {label}", n, dt, valid=int(ok.sum()),
             ate_rmse_m=cs.ate_rmse(rr.map_T_sensor[ok], sseq.true_map_T_sensor[:n][ok]))

    # ---- phase 9: bench_map's loop into both stores ----
    mposes, msp, msm, mtp = cs.build_map_world(cs.MAP_FRAMES, cs.MAP_SCAN_CAP)
    G = cs.MAP_FRAMES // cs.MAP_GROUP
    uniq, _ = cs.dedup_capacity(
        [np.concatenate([msp[i][msm[i]] @ mposes[i][:3, :3].T + mposes[i][:3, 3]
                         for i in range(g * cs.MAP_GROUP, (g + 1) * cs.MAP_GROUP)])
         for g in sorted({0, G // 2, G - 1})],
        np.asarray(cs.MAP_ORIGIN, np.float32), cs.MAP_VOXEL, cs.MAP_GROUP * cs.MAP_SCAN_CAP)
    rel = np.stack([np.linalg.inv(mposes[max(i - 1, 0)].astype(np.float64))
                    @ mposes[i].astype(np.float64) for i in range(cs.MAP_FRAMES)]).astype(np.float32)

    def grouped(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).reshape(
            G, cs.MAP_GROUP, *a.shape[1:])

    groups = (grouped(msp), grouped(msm), grouped(mtp),
              se3_log(torch.from_numpy(rel).to(dev)).reshape(G, cs.MAP_GROUP, 6), grouped(mposes))
    dims = dict(voxel_size=cs.MAP_VOXEL, dim_xy=1024, dim_z=128)
    stores = {
        "sorted": (sorted_voxel_map_init, sorted_voxel_map_insert,
                   SortedVoxelMapConfig(capacity=1 << 18, unique_capacity=uniq, **dims)),
        "hash": (voxel_map_init, voxel_map_insert,
                 VoxelMapConfig(table_size=1 << 21, max_probes=8,
                                straggler_capacity=max(1024, cs.MAP_GROUP * 512),
                                unique_capacity=uniq, **dims)),
    }
    for label, (init, insert, mcfg) in stores.items():
        dt, st = twice(lambda: cs.map_pass(insert, mcfg, init(mcfg, cs.MAP_ORIGIN, dev), groups))
        emit(f"phase 9 mapping {label}", cs.MAP_FRAMES, dt, cells=int(st.n_cells()),
             dropped=int(st.n_dropped), oob=int(st.n_oob))


if __name__ == "__main__":
    main()

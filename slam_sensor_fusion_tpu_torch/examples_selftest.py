"""End-to-end smoke test of the product on the card (port of the JAX
`examples_selftest.py`): synthetic world -> mapping run -> map build ->
full localization replay -> ATE report. The same world, config and pass
rule as the JAX package's."""

from __future__ import annotations

import json

import numpy as np
import torch


def selftest_config():
    """The selftest's LocalizationConfig: the default per-frame parity
    engine (the K2 ICP) with capacities and a brute-force grid sized to the
    small world."""
    from slam_sensor_fusion_tpu_torch.utils.config import (
        BruteForceConfig,
        CloudCapacity,
        LocalizationConfig,
    )

    return LocalizationConfig(
        capacity=CloudCapacity(
            scan=8192, cropped_scan=8192, cropped_map=16384,
            map=1 << 17, bf_source=512, bf_target=4096,
        ),
        brute_force=BruteForceConfig(
            x_step=0.2, y_step=0.2, z_step=0.1, x_range=0.8, y_range=0.8,
            z_range=0.2, yaw_step=np.pi / 18, yaw_range=np.pi / 9,
            mean_error_threshold=0.1,
        ),
        map_subsample_step=1,
        brute_force_map_subsample_step=3,
    )


def selftest_world(
    n_frames: int = 30, seed: int = 3, points_per_m2: float = 24.0, map_scan_points: int = 6000
):
    """The selftest's world: (sequence, map-frame tiles of every 2nd frame,
    odometry positions, GPS rows) of the mapping run. `points_per_m2` (the
    walls' density) and `map_scan_points` (the mapping run's scans) give
    the same layout at another density; the localized scans stay at 6000
    points."""
    from slam_sensor_fusion_tpu_torch.utils import synthetic as syn

    rng = np.random.default_rng(seed)
    world = syn.make_world(rng, extent=60.0, n_buildings=25, n_poles=60,
                           points_per_m2=points_per_m2)
    poses = syn.make_trajectory(n_frames)
    seq = syn.make_sequence(seed=seed, world=world, poses=poses,
                            scan_points=6000, gps_noise_m=0.3)
    tiles = []
    map_rng = np.random.default_rng(seed + 1)
    for i in range(0, n_frames, 2):
        body = syn.render_scan(world, poses[i], map_rng, max_points=map_scan_points,
                               noise=0.005)
        tiles.append(body @ poses[i][:3, :3].T + poses[i][:3, 3])
    odom_pos, gps_rows = syn.make_mapping_logs(seq, standstill_frames=10)
    return seq, tiles, odom_pos, gps_rows


def run_selftest(
    n_frames: int = 30, seed: int = 3, device: torch.device | str = torch.device("cuda")
) -> int:
    """Localize the selftest world on `device`; prints one JSON line (ATE,
    valid frames, the pass flag, the kernels' launch counts) and returns 0
    on a pass (ATE < 0.25 m, every frame valid from the 6th)."""
    from slam_sensor_fusion_tpu_torch.api import localize
    from slam_sensor_fusion_tpu_torch.models.mapping import build_map_data
    from slam_sensor_fusion_tpu_torch.utils.profiling import kernel_launches

    seq, tiles, odom_pos, gps_rows = selftest_world(n_frames, seed)
    map_data = build_map_data(tiles, odom_pos, gps_rows)

    res = localize(
        scans=seq.scans,
        odom_T_sensor=seq.odom_T_sensor,
        gps_lat=seq.gps_lat,
        gps_lon=seq.gps_lon,
        gps_alt=seq.gps_alt,
        compass_yaw=seq.compass_yaw,
        map_data=map_data,
        odom_cov_trace=seq.odom_cov_trace,
        gps_cov_trace=seq.gps_cov_trace,
        config=selftest_config(),
        device=device,
    )
    d = res.map_T_sensor[res.valid, :3, 3] - seq.true_map_T_sensor[res.valid, :3, 3]
    ate = float(np.sqrt((d**2).sum(axis=1).mean()))
    ok = ate < 0.25 and res.valid[5:].all()
    print(json.dumps({"ate_rmse_m": round(ate, 4),
                      "frames": int(res.valid.sum()), "ok": bool(ok),
                      "device": str(torch.device(device)),
                      "launches": kernel_launches()}))
    return 0 if ok else 1

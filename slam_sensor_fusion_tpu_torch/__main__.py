"""CLI: the launch-file equivalent (localization/launch/*.py), on the card.

    python -m slam_sensor_fusion_tpu_torch localize --map-data-path DIR --streams F.npz [...]
    python -m slam_sensor_fusion_tpu_torch build-map --map-data-path DIR --streams F.npz
    python -m slam_sensor_fusion_tpu_torch selftest

Offline log-replay semantics: inputs are .npz stream files (see
api.RawStreams for the schema) rather than live ROS topics. `localize` and
`selftest` run on `--device` (default: the card); `build-map` is host
work. Each prints one JSON line; `localize` and `selftest` include the
kernels' launch counts.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load_streams(path: str):
    from slam_sensor_fusion_tpu_torch.api import RawStreams

    z = np.load(path, allow_pickle=True)
    scans = list(z["scans"]) if "scans" in z else [
        z[k] for k in sorted(z.files) if k.startswith("scan_")
    ]
    return RawStreams(
        scan_t=z["scan_t"],
        scans=scans,
        gps_t=z["gps_t"],
        gps_lat=z["gps_lat"],
        gps_lon=z["gps_lon"],
        gps_alt=z["gps_alt"],
        gps_cov_trace=z.get("gps_cov_trace", np.full(len(z["gps_t"]), 1.0)),
        odom_t=z["odom_t"],
        odom_T_sensor=z["odom_T_sensor"],
        odom_cov_trace=z.get("odom_cov_trace", np.full(len(z["odom_t"]), 0.03)),
        compass_t=z["compass_t"],
        compass_heading_deg=z["compass_heading_deg"],
    )


def save_streams(path: str, streams) -> None:
    """Write an api.RawStreams as the .npz file `--streams` reads (the
    scans as one object array: they differ in length)."""
    scans = np.empty(len(streams.scans), object)
    scans[:] = [np.asarray(s, np.float32) for s in streams.scans]
    arrays = {"scans": scans}
    for f in ("scan_t", "gps_t", "gps_lat", "gps_lon", "gps_alt", "gps_cov_trace", "odom_t",
              "odom_T_sensor", "odom_cov_trace", "compass_t", "compass_heading_deg"):
        arrays[f] = np.asarray(getattr(streams, f))
    np.savez(path, **arrays)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="slam_sensor_fusion_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pl = sub.add_parser("localize", help="replay streams against a map")
    pl.add_argument("--map-data-path", required=True)
    pl.add_argument("--map-name", default="map")
    pl.add_argument("--streams", required=True, help=".npz RawStreams file")
    pl.add_argument("--output", default="trajectory.npz")
    pl.add_argument("--enable-debug", action="store_true")
    pl.add_argument("--max-map-optimization-poses", type=int, default=50)
    pl.add_argument("--device", default="cuda", help="torch device (default: the card)")

    pb = sub.add_parser("build-map", help="build map_data from streams")
    pb.add_argument("--map-data-path", required=True)
    pb.add_argument("--streams", required=True)

    ps = sub.add_parser("selftest", help="synthetic end-to-end smoke test")
    ps.add_argument("--device", default="cuda", help="torch device (default: the card)")

    args = p.parse_args(argv)

    if args.cmd == "selftest":
        from slam_sensor_fusion_tpu_torch.examples_selftest import run_selftest

        return run_selftest(device=args.device)

    if args.cmd == "localize":
        import dataclasses

        from slam_sensor_fusion_tpu_torch.api import localize_streams
        from slam_sensor_fusion_tpu_torch.utils.config import LocalizationConfig
        from slam_sensor_fusion_tpu_torch.utils.profiling import kernel_launches

        cfg = dataclasses.replace(
            LocalizationConfig(),
            enable_debug=args.enable_debug,
            max_map_optimization_poses=args.max_map_optimization_poses,
        )
        res = localize_streams(
            _load_streams(args.streams),
            map_data_path=args.map_data_path,
            map_name=args.map_name,
            config=cfg,
            device=args.device,
        )
        np.savez_compressed(
            args.output,
            map_T_sensor=res.map_T_sensor,
            valid=res.valid,
            icp_error=res.icp_error,
            icp_iterations=res.icp_iterations,
        )
        print(
            json.dumps(
                {
                    "frames": int(res.valid.sum()),
                    "first_processed_frame": res.first_processed_frame,
                    "output": args.output,
                    "device": args.device,
                    "launches": kernel_launches(),
                }
            )
        )
        return 0

    if args.cmd == "build-map":
        from slam_sensor_fusion_tpu_torch.api import build_map

        s = _load_streams(args.streams)
        build_map(
            scans_map_frame=s.scans,
            odom_positions=s.odom_T_sensor[:, :3, 3],
            gps_lat=s.gps_lat,
            gps_lon=s.gps_lon,
            gps_alt=s.gps_alt,
            compass_yaw=np.deg2rad(90.0 - s.compass_heading_deg),
            map_data_path=args.map_data_path,
        )
        print(json.dumps({"map_data_path": args.map_data_path}))
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())

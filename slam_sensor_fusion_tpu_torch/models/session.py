"""Online (incremental) sessions: feed one frame, get one pose (port of the
JAX `models/session.py`).

The reference is a live 10 Hz node: every sensor triplet arrives as a
callback and produces a pose immediately (localization_node.cpp:263-374).
`Localizer.run` replays whole sequences; a session is the real-time form,
the same per-frame programs driven one frame at a time, so a robot
integrator gets the callback contract `push(frame) -> pose`.

`LocalizerSession.push` follows the per-frame engine
(models/localization.step: one K3 launch a frame in fast mode, the K2
parity ICP otherwise); `BlockLocalizerSession` buffers K frames and runs
one superblock (models/pipeline_fast.run_chunk_fast, one K1 launch). The
startup ladder (first-GPS init, brute-force coarse alignment with
rescue-ICP retries per frame, localization_node.cpp:181-261) runs inside
`push`, as the reference runs it inside callbacks.

With `profile=True` each steady-state push leaves {host_ms, dispatch_ms,
device_ms} in `last_timing`: host = geodesy and frame staging on the CPU,
dispatch = the engine call returning (it issues the kernels, and blocks
where the engine reads a device value back: the re-crop test, the valid
flag), device = until the outputs are on the host (`.cpu()`).

`LIOSession` is the native-mode form: one `push` per (scan, IMU packet,
GPS) triplet through `models/lio.lio_step` (one K4 launch a push on the
fused backend).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.models import lio as lio_mod
from slam_sensor_fusion_tpu_torch.models.localization import (
    Localizer,
    _fine,
    build_frame_batch,
    coarse_attempt,
    init_state,
    step,
)
from slam_sensor_fusion_tpu_torch.models.mapping import MapData
from slam_sensor_fusion_tpu_torch.utils.config import LocalizationConfig


@dataclasses.dataclass
class PushResult:
    """One callback's outputs (the node's publish set, localization_node.cpp:343-373)."""

    map_T_sensor: np.ndarray  # (4, 4) posterior (or carried pose on skips)
    #: "init" | "skipped" (invalid GPS) | "coarse_retry" | "tracking"
    phase: str
    icp_error: float = float("nan")
    icp_converged: bool = False
    n_correspondences: int = 0
    #: the port's addition: the frame's correspondence search was truncated
    #: (StepOutput.pair_overflow), so an integrator can see it per pose
    pair_overflow: bool = False


def _tracking(pose: np.ndarray, out) -> PushResult:
    """A tracking callback's result from its StepOutput."""
    return PushResult(
        pose,
        "tracking",
        icp_error=float(out.icp_error),
        icp_converged=bool(out.icp_converged),
        n_correspondences=int(out.n_correspondences),
        pair_overflow=bool(out.pair_overflow),
    )


class LocalizerSession:
    """Incremental localization: the node's callback contract. `push`
    mirrors localizationCallback's gating order: invalid-GPS skip ->
    first-fix init -> coarse ladder (retry per frame) -> steady-state
    per-frame step."""

    def __init__(
        self,
        map_data: MapData,
        config: LocalizationConfig = LocalizationConfig(),
        profile: bool = False,
        device: torch.device | str = torch.device("cuda"),
    ):
        self.loc = Localizer(map_data, config, device)
        self.device = self.loc.device
        self.config = config
        self.state = None
        self.coarse_done = False
        self._guess = None
        self.profile = profile
        self.last_timing: dict | None = None

    def push(
        self,
        scan: np.ndarray,
        odom_T_sensor: np.ndarray,
        lat: float,
        lon: float,
        alt: float,
        compass_yaw: float,
        odom_cov_trace: float,
        gps_cov_trace: float,
    ) -> PushResult:
        cfg = self.config
        valid = alt >= 0
        t_host0 = time.perf_counter()
        gps_T = self.loc.gps_poses(
            np.asarray([lat]), np.asarray([lon]), np.asarray([compass_yaw])
        )[0]

        # ---- startup gating: the first valid GPS fix initializes the pose
        # (initializePosesWithFirstReading, localization_node.cpp:181-198)
        if self.state is None:
            if not valid:
                return PushResult(np.eye(4, dtype=np.float32), "skipped")
            self.state = init_state(
                cfg, self.loc.map_cloud.capacity, self.loc._tensor(gps_T),
                self.loc._tensor(odom_T_sensor),
            )
            self._guess = self.loc._tensor(gps_T)
            return PushResult(gps_T, "init")

        frame = build_frame_batch(
            cfg, [scan], np.asarray(odom_T_sensor)[None], gps_T[None],
            np.asarray([odom_cov_trace]), np.asarray([gps_cov_trace]),
            np.asarray([valid]), self.device,
        )

        # ---- coarse ladder: retry per callback until success
        # (performCoarseAlignment, localization_node.cpp:200-261, 307-315)
        if not self.coarse_done:
            if not valid:
                return PushResult(self.state.map_T_sensor.cpu().numpy(), "skipped")
            cropped_map, cached_target, map_T_ref, cropped_scan, coarse = coarse_attempt(
                self.state, frame.scan_points[0], frame.scan_mask[0],
                self.loc.map_cloud, self._guess, cfg,
            )
            self.state = self.state._replace(
                cropped_map=cropped_map, cached_target=cached_target, map_T_ref=map_T_ref
            )
            if bool(coarse.success):
                self.coarse_done = True
                self.state = self.state._replace(map_T_sensor=coarse.map_T_sensor)
                # fine alignment runs in the same callback (:311-341)
                self.state, out = _fine(
                    self.state, cropped_scan, self.state.cropped_map,
                    self.state.cached_target, self.state.map_T_ref, False,
                    frame.odom_T_sensor[0], frame.map_T_sensor_gps[0],
                    frame.odom_cov_trace[0], frame.gps_cov_trace[0], cfg,
                )
                return _tracking(out.map_T_sensor.cpu().numpy(), out)
            # next attempt searches around the best brute-force candidate
            # (brute_force_alignment.cpp:125-126)
            self._guess = coarse.map_T_sensor
            return PushResult(self.state.map_T_sensor.cpu().numpy(), "coarse_retry")

        # ---- steady state: the per-frame step
        t_disp0 = time.perf_counter()
        self.state, out = step(
            self.state, *[x[0] for x in frame], self.loc.map_cloud, cfg,
        )
        t_dev0 = time.perf_counter()
        pose = out.map_T_sensor.cpu().numpy()
        if self.profile:
            self.last_timing = {
                "host_ms": (t_disp0 - t_host0) * 1e3,
                "dispatch_ms": (t_dev0 - t_disp0) * 1e3,
                "device_ms": (time.perf_counter() - t_dev0) * 1e3,
            }
        if not valid:
            return PushResult(pose, "skipped")
        return _tracking(pose, out)


class BlockLocalizerSession(LocalizerSession):
    """Dispatch-amortized online session: buffers K = config.superstep
    frames and runs them as ONE superblock (one K1 launch).

    It trades K-1 frames of freshness for 1/K of the per-frame host work.
    Contract: `push(frame) -> list[PushResult]` — `[]` while buffering, K
    results (sensor order) when the block flushes. Startup (first-GPS init
    and coarse ladder) stays per frame, exactly the parent's path."""

    def __init__(
        self,
        map_data: MapData,
        config: LocalizationConfig,
        profile: bool = False,
        device: torch.device | str = torch.device("cuda"),
    ):
        if not config.block_kernel:
            raise ValueError(
                "BlockLocalizerSession needs block_kernel=True (the "
                "superblock program is the whole point); superstep is K"
            )
        super().__init__(map_data, config, profile=profile, device=device)
        self.K = config.superstep
        self._buf: list[tuple] = []

    def push(
        self,
        scan: np.ndarray,
        odom_T_sensor: np.ndarray,
        lat: float,
        lon: float,
        alt: float,
        compass_yaw: float,
        odom_cov_trace: float,
        gps_cov_trace: float,
    ) -> list[PushResult]:
        if self.state is None or not self.coarse_done:
            # per-frame startup ladder (gating order is the reference's)
            return [
                super().push(
                    scan, odom_T_sensor, lat, lon, alt, compass_yaw,
                    odom_cov_trace, gps_cov_trace,
                )
            ]

        self._buf.append((
            np.asarray(scan), np.asarray(odom_T_sensor), float(lat), float(lon),
            float(alt), float(compass_yaw), float(odom_cov_trace), float(gps_cov_trace),
        ))
        if len(self._buf) < self.K:
            return []

        from slam_sensor_fusion_tpu_torch.models.pipeline_fast import (
            build_paged_frames,
            run_chunk_fast,
        )

        cfg = self.config
        t_host0 = time.perf_counter()
        scans = [b[0] for b in self._buf]
        odom_T, lats, lons, alts, yaws, ocov, gcov = (
            np.stack([b[m] for b in self._buf]) for m in range(1, 8)
        )
        self._buf.clear()
        valid = alts >= 0
        gps_T = self.loc.gps_poses(lats, lons, yaws)
        frames = build_paged_frames(cfg, scans, odom_T, gps_T, ocov, gcov, valid, self.device)
        t_disp0 = time.perf_counter()
        self.state, outs = run_chunk_fast(self.state, frames, self.loc.map_cloud, cfg)
        t_dev0 = time.perf_counter()
        poses = outs.map_T_sensor.cpu().numpy()
        errs = outs.icp_error.cpu().numpy()
        conv = outs.icp_converged.cpu().numpy()
        ncor = outs.n_correspondences.cpu().numpy()
        ovf = outs.pair_overflow.cpu().numpy()
        if self.profile:
            self.last_timing = {
                "host_ms": (t_disp0 - t_host0) * 1e3,
                "dispatch_ms": (t_dev0 - t_disp0) * 1e3,
                "device_ms": (time.perf_counter() - t_dev0) * 1e3,
            }
        return [
            PushResult(
                poses[k],
                "tracking" if valid[k] else "skipped",
                icp_error=float(errs[k]),
                icp_converged=bool(conv[k]),
                n_correspondences=int(ncor[k]),
                pair_overflow=bool(ovf[k]),
            )
            for k in range(self.K)
        ]


@dataclasses.dataclass
class LIOPushResult:
    world_T_body: np.ndarray  # (4, 4)
    rmse: float
    n_correspondences: int
    gps_accepted: bool


class LIOSession:
    """Incremental native-mode LIO: one `push` per (scan, IMU packet, GPS)
    triplet, wrapping the same `lio_step` the chunk loop loops over.
    Scans should arrive Morton-pre-sorted (the loader contract); `tau`
    rides the same permutation for deskew."""

    def __init__(
        self,
        config: lio_mod.LIOConfig,
        first_scan: np.ndarray,
        first_scan_mask: np.ndarray,
        world_T_body0: np.ndarray,
        device: torch.device | str = torch.device("cuda"),
    ):
        self.config = config
        self.device = torch.device(device)
        self.state = lio_mod.init_state(
            config,
            self._tensor(first_scan, np.float32),
            self._tensor(first_scan_mask, bool),
            self._tensor(world_T_body0, np.float32),
        )

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=dtype)).to(self.device)

    def push(
        self,
        scan_points: np.ndarray,  # (S, 3) padded to config.scan_capacity
        scan_mask: np.ndarray,  # (S,)
        imu_gyro: np.ndarray,  # (K, 3)
        imu_accel: np.ndarray,  # (K, 3)
        imu_dt: np.ndarray,  # (K,)
        gps_pos: np.ndarray,  # (3,)
        gps_var: float,
        gps_valid: bool,
        tau: np.ndarray | None = None,  # (S,) sweep fractions
    ) -> LIOPushResult:
        f32 = np.float32
        args = [
            self._tensor(scan_points, f32),
            self._tensor(scan_mask, bool),
            self._tensor(imu_gyro, f32),
            self._tensor(imu_accel, f32),
            self._tensor(imu_dt, f32),
            self._tensor(gps_pos, f32),
            self._tensor(gps_var, f32),
            self._tensor(gps_valid, bool),
        ]
        self.state, out = lio_mod.lio_step(
            self.state, *args, self.config, None if tau is None else self._tensor(tau, f32)
        )
        return LIOPushResult(
            world_T_body=out.world_T_body.cpu().numpy(),
            rmse=float(out.rmse),
            n_correspondences=int(out.n_correspondences),
            gps_accepted=bool(out.gps_accepted),
        )

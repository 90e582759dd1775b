"""Synthetic world, trajectory and sensor-stream generation.

The reference is exercised against live ROS topics from a LiDAR+LIO+GPS rig;
this module builds the equivalent offline: a structured 3-D world, a smooth
trajectory through it, per-frame LiDAR-like scans (in the sensor body frame,
mirroring `/cloud_registered_body`), LIO odometry with drift, GPS fixes with
noise, and ArduPilot-convention compass headings. It also emits the mapping
run's artifacts (tiles + odometry/GPS logs in the exact text formats of
map_data_save_node.cpp:84-98) so the map-manager path is tested end-to-end.

Everything is deterministic given a seed. A copy of the JAX package's
generator (same seeds, same arrays), trimmed to what the localization and
LIO slices need, so the port builds its worlds without importing jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from slam_sensor_fusion_tpu_torch.ops.utm import ll_to_utm

# default datum for synthetic GPS (mid-latitude, zone 32)
DATUM_LAT = 47.5
DATUM_LON = 9.0
_M_PER_DEG_LAT = 111319.4907932736


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def make_world(
    rng: np.random.Generator,
    extent: float = 120.0,
    n_buildings: int = 40,
    n_poles: int = 120,
    points_per_m2: float = 8.0,
    ground_z: float = -1.8,
) -> np.ndarray:
    """Sample a structured outdoor scene: ground, building walls, poles.

    Returns (N, 3) float32 map-frame points. Structure (rather than
    uniform noise) matters: ICP needs surfaces to be well-posed.

    The map frame follows the reference's convention: it is anchored at the
    initial SENSOR pose of the mapping run (the LIO odometry origin), so
    the ground sits at ``ground_z`` (-sensor height) and the trajectory
    travels near z = 0. This is what makes the GPS altitude-table prior
    consistent (localization_node.cpp:121-126) and gives the floor-removal
    z > 0 cut (point_cloud_processing.hpp:76-92) its actual meaning.
    """
    pts = []
    n_ground = int(extent * extent * 1.0)
    ground = np.stack(
        [
            rng.uniform(-extent / 2, extent / 2, n_ground),
            rng.uniform(-extent / 2, extent / 2, n_ground),
            ground_z + rng.normal(0.0, 0.02, n_ground),
        ],
        axis=1,
    )
    pts.append(ground)
    # buildings: axis-aligned boxes, sample the 4 walls
    for _ in range(n_buildings):
        cx, cy = rng.uniform(-extent / 2, extent / 2, 2)
        w, d = rng.uniform(4, 14, 2)
        h = rng.uniform(3, 10)
        for axis, sign in [(0, -1), (0, 1), (1, -1), (1, 1)]:
            area = (d if axis == 0 else w) * h
            n = max(int(area * points_per_m2), 8)
            u = rng.uniform(-0.5, 0.5, n)
            z = ground_z + rng.uniform(0, h, n)
            if axis == 0:
                x = np.full(n, cx + sign * w / 2)
                y = cy + u * d
            else:
                x = cx + u * w
                y = np.full(n, cy + sign * d / 2)
            pts.append(np.stack([x, y, z], axis=1))
    # poles
    for _ in range(n_poles):
        px, py = rng.uniform(-extent / 2, extent / 2, 2)
        h = rng.uniform(2, 6)
        n = max(int(h * 15), 5)
        pts.append(
            np.stack(
                [
                    np.full(n, px) + rng.normal(0, 0.01, n),
                    np.full(n, py) + rng.normal(0, 0.01, n),
                    ground_z + rng.uniform(0, h, n),
                ],
                axis=1,
            )
        )
    return np.concatenate(pts).astype(np.float32)


def make_trajectory(
    n_frames: int,
    speed_per_frame: float = 0.15,
    radius: float = 35.0,
    z_amp: float = 0.3,
) -> np.ndarray:
    """Smooth arc trajectory; returns (T, 4, 4) map_T_sensor poses.

    Speed (~0.15 m/frame = 1.5 m/s at 10 Hz) sits inside the stochastic
    filter's expected envelope (stochastic_filter.cpp:11-12).
    """
    s = np.arange(n_frames) * speed_per_frame
    theta = s / radius
    x = radius * np.sin(theta)
    y = radius * (1.0 - np.cos(theta))
    # map frame is anchored at the initial sensor pose, so z stays near 0
    z = z_amp * np.sin(s / 15.0)
    yaw = theta  # heading tangent to the arc
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        poses[i, :3, :3] = _rot_z(yaw[i])
        poses[i, :3, 3] = [x[i], y[i], z[i]]
        poses[i, 3, 3] = 1.0
    return poses.astype(np.float32)


def render_scan(
    world: np.ndarray,
    map_T_sensor: np.ndarray,
    rng: np.random.Generator,
    max_range: float = 35.0,
    max_points: int = 20000,
    noise: float = 0.01,
) -> np.ndarray:
    """Points of the world within range, expressed in the sensor frame.

    Samples with probability ~ 1/r^2 like a real spinning LiDAR's areal
    density, so the 10 m crop region stays point-rich.
    """
    rel = world - map_T_sensor[:3, 3]
    d = np.linalg.norm(rel, axis=1)
    sel = np.flatnonzero(d < max_range)
    if len(sel) > max_points:
        w = 1.0 / np.maximum(d[sel], 2.0) ** 2
        w /= w.sum()
        sel = rng.choice(sel, size=max_points, replace=False, p=w)
        sel.sort()
    R = map_T_sensor[:3, :3]
    body = rel[sel] @ R  # R^T @ rel
    body = body + rng.normal(0, noise, body.shape)
    return body.astype(np.float32)


def _so3_V(phi: np.ndarray) -> np.ndarray:
    """Left Jacobian V of SO(3) for batched rotation vectors (N, 3)."""
    th = np.linalg.norm(phi, axis=-1, keepdims=True)
    th = np.maximum(th, 1e-12)
    a = phi / th
    K = np.zeros(phi.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -a[..., 2], a[..., 1]
    K[..., 1, 0], K[..., 1, 2] = a[..., 2], -a[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -a[..., 1], a[..., 0]
    th = th[..., None]
    return (
        np.eye(3)
        + (1.0 - np.cos(th)) / th * K
        + (1.0 - np.sin(th) / th) * (K @ K)
    )


def render_scan_skewed(
    world: np.ndarray,
    prev_T: np.ndarray,
    curr_T: np.ndarray,
    rng: np.random.Generator,
    max_range: float = 35.0,
    max_points: int = 20000,
    noise: float = 0.01,
    tau_mode: str = "random",
) -> tuple[np.ndarray, np.ndarray]:
    """Scan with intra-sweep motion: each point is measured from the pose
    at its own sweep fraction tau (constant-twist interpolation
    prev_T -> curr_T), then naively stacked as if one rigid frame — the
    raw output of a spinning LiDAR on a moving platform. Returns
    (points (N, 3) in the per-point measurement frames, tau (N,)).
    `ops/deskew.deskew` with xi = se3_log(prev_T^-1 curr_T) maps them to
    the end-of-sweep (curr) frame.

    ``tau_mode="azimuth"`` assigns each point the sweep fraction a
    clockwise-spinning LiDAR would give it (the KITTI velodyne model:
    sweep starts/ends at the rear) instead of a
    random fraction — so loaders that must SYNTHESIZE per-point times
    from geometry (KITTI ships none) recover nearly the true fractions.
    """
    from scipy.spatial.transform import Rotation as ScipyR

    rel = np.linalg.inv(prev_T.astype(np.float64)) @ curr_T.astype(np.float64)
    phi = ScipyR.from_matrix(rel[:3, :3]).as_rotvec()
    rho = np.linalg.solve(_so3_V(phi[None])[0], rel[:3, 3])

    d = np.linalg.norm(world - curr_T[:3, 3], axis=1)
    sel = np.flatnonzero(d < max_range)
    if len(sel) > max_points:
        w = 1.0 / np.maximum(d[sel], 2.0) ** 2
        w /= w.sum()
        sel = rng.choice(sel, size=max_points, replace=False, p=w)
        sel.sort()
    if tau_mode == "azimuth":
        # end-of-sweep body azimuth ~ measured azimuth (intra-sweep motion
        # shifts it by < 0.01 rad at survey speeds): tau = (pi - theta)/2pi
        rel_end = (world[sel] - curr_T[:3, 3]) @ curr_T[:3, :3]
        theta = np.arctan2(rel_end[:, 1], rel_end[:, 0])
        tau = 0.5 * (1.0 - theta / np.pi)
    else:
        tau = rng.uniform(0.0, 1.0, len(sel))

    R_tau = ScipyR.from_rotvec(tau[:, None] * phi).as_matrix()  # (N, 3, 3)
    t_tau = np.einsum("nij,nj->ni", _so3_V(tau[:, None] * phi), tau[:, None] * rho)
    R_w = prev_T[:3, :3].astype(np.float64) @ R_tau
    t_w = np.einsum("ij,nj->ni", prev_T[:3, :3].astype(np.float64), t_tau) + prev_T[:3, 3]
    body = np.einsum("nji,nj->ni", R_w, world[sel] - t_w)
    body = body + rng.normal(0, noise, body.shape)
    return body.astype(np.float32), tau.astype(np.float32)


@dataclasses.dataclass
class SensorSequence:
    """Host-side arrays for one localization run (the log-replay equivalent
    of the ROS topic streams, pre-aligned in time)."""

    scans: list[np.ndarray]  # T x (n_i, 3) body-frame points
    odom_T_sensor: np.ndarray  # (T, 4, 4) LIO odometry (drifting)
    gps_lat: np.ndarray  # (T,)
    gps_lon: np.ndarray  # (T,)
    gps_alt: np.ndarray  # (T,)
    gps_cov_trace: np.ndarray  # (T,) position covariance trace
    odom_cov_trace: np.ndarray  # (T,)
    compass_yaw: np.ndarray  # (T,) already converted to ENU rad
    true_map_T_sensor: np.ndarray  # (T, 4, 4) ground truth
    global_T_map: np.ndarray  # (4, 4) datum transform used for GPS synth


def _gps_from_map_pose(
    map_t: np.ndarray, global_T_map: np.ndarray
) -> tuple[float, float, float]:
    """Map-frame position -> (lat, lon, alt) whose UTM round-trip lands on
    global_T_map @ p. Inverts ll_to_utm with two Newton refinements."""
    g = global_T_map[:3, :3] @ map_t + global_T_map[:3, 3]
    e_target, n_target, alt = g[0], g[1], g[2]
    e0, n0 = ll_to_utm(DATUM_LAT, DATUM_LON)
    lat = DATUM_LAT + (n_target - n0) / _M_PER_DEG_LAT
    lon = DATUM_LON + (e_target - e0) / (
        _M_PER_DEG_LAT * np.cos(np.deg2rad(DATUM_LAT))
    )
    for _ in range(2):
        e, n = ll_to_utm(lat, lon)
        lat = lat + (n_target - n) / _M_PER_DEG_LAT
        lon = lon + (e_target - e) / (_M_PER_DEG_LAT * np.cos(np.deg2rad(lat)))
    return float(lat), float(lon), float(alt)


def make_sequence(
    seed: int = 0,
    n_frames: int = 100,
    odom_drift: float = 0.0008,
    gps_noise_m: float = 0.6,
    datum_yaw: float = 0.35,
    scan_points: int = 20000,
    world: np.ndarray | None = None,
    poses: np.ndarray | None = None,
) -> SensorSequence:
    """Build a full synthetic localization run."""
    rng = np.random.default_rng(seed)
    if world is None:
        world = make_world(rng)
    if poses is None:
        poses = make_trajectory(n_frames)
    n_frames = len(poses)

    # global datum: map frame sits at a UTM position with a yaw offset
    e0, n0 = ll_to_utm(DATUM_LAT, DATUM_LON)
    global_T_map = np.eye(4)
    global_T_map[:3, :3] = _rot_z(datum_yaw)
    global_T_map[:3, 3] = [e0, n0, 412.0]

    scans = []
    odom = np.zeros_like(poses)
    lat = np.zeros(n_frames)
    lon = np.zeros(n_frames)
    alt = np.zeros(n_frames)
    compass = np.zeros(n_frames)

    # LIO odometry: true relative motion composed with small drift noise
    odom_T = np.eye(4)
    for i in range(n_frames):
        scans.append(render_scan(world, poses[i], rng, max_points=scan_points))
        if i > 0:
            rel = np.linalg.inv(poses[i - 1]) @ poses[i]
            dyaw = rng.normal(0, odom_drift)
            noise_T = np.eye(4)
            noise_T[:3, :3] = _rot_z(dyaw)
            noise_T[:3, 3] = rng.normal(0, odom_drift * 10, 3)
            odom_T = odom_T @ rel @ noise_T
        odom[i] = odom_T.astype(np.float32)

        noisy_t = poses[i][:3, 3].astype(np.float64) + rng.normal(0, gps_noise_m, 3)
        lat[i], lon[i], alt[i] = _gps_from_map_pose(noisy_t, global_T_map)

        # true yaw in global frame = datum_yaw + map yaw; compass reports
        # ENU yaw directly after the ArduPilot conversion
        map_yaw = np.arctan2(poses[i][1, 0], poses[i][0, 0])
        compass[i] = np.mod(
            datum_yaw + map_yaw + rng.normal(0, 0.01) + np.pi, 2 * np.pi
        ) - np.pi

    return SensorSequence(
        scans=scans,
        odom_T_sensor=odom.astype(np.float32),
        gps_lat=lat,
        gps_lon=lon,
        gps_alt=alt,
        gps_cov_trace=np.full(n_frames, 3 * gps_noise_m ** 2),
        odom_cov_trace=np.full(n_frames, 0.03),
        compass_yaw=compass,
        true_map_T_sensor=poses,
        global_T_map=global_T_map,
    )


def make_sequence_from_scans(
    scans: list[np.ndarray],
    poses: np.ndarray,
    seed: int = 0,
    odom_drift: float = 0.0008,
    gps_noise_m: float = 0.6,
    datum_yaw: float = 0.35,
) -> SensorSequence:
    """Synthesize the sensor streams around EXTERNAL scans + ground truth.

    The KITTI-format path: the odometry benchmark ships scans and poses
    but none of the streams the localization product consumes
    (localization_node.cpp:80-84 — upstream LIO odometry, GPS NavSatFix,
    compass heading), so this derives them from the ground-truth poses
    exactly like `make_sequence` does for fully synthetic runs: drifting
    LIO odometry (relative GT motion composed with noise), GPS fixes
    whose UTM round-trip lands near the true position, and an ENU
    compass yaw with the datum offset.
    """
    rng = np.random.default_rng(seed)
    poses = np.asarray(poses, np.float64)
    n_frames = len(poses)
    if len(scans) != n_frames:
        raise ValueError(f"{len(scans)} scans for {n_frames} poses")

    e0, n0 = ll_to_utm(DATUM_LAT, DATUM_LON)
    global_T_map = np.eye(4)
    global_T_map[:3, :3] = _rot_z(datum_yaw)
    global_T_map[:3, 3] = [e0, n0, 412.0]

    odom = np.zeros((n_frames, 4, 4), np.float64)
    lat = np.zeros(n_frames)
    lon = np.zeros(n_frames)
    alt = np.zeros(n_frames)
    compass = np.zeros(n_frames)
    odom_T = np.eye(4)
    for i in range(n_frames):
        if i > 0:
            rel = np.linalg.inv(poses[i - 1]) @ poses[i]
            dyaw = rng.normal(0, odom_drift)
            noise_T = np.eye(4)
            noise_T[:3, :3] = _rot_z(dyaw)
            noise_T[:3, 3] = rng.normal(0, odom_drift * 10, 3)
            odom_T = odom_T @ rel @ noise_T
        odom[i] = odom_T

        noisy_t = poses[i][:3, 3] + rng.normal(0, gps_noise_m, 3)
        lat[i], lon[i], alt[i] = _gps_from_map_pose(noisy_t, global_T_map)
        map_yaw = np.arctan2(poses[i][1, 0], poses[i][0, 0])
        compass[i] = np.mod(
            datum_yaw + map_yaw + rng.normal(0, 0.01) + np.pi, 2 * np.pi
        ) - np.pi

    return SensorSequence(
        scans=list(scans),
        odom_T_sensor=odom.astype(np.float32),
        gps_lat=lat,
        gps_lon=lon,
        gps_alt=alt,
        gps_cov_trace=np.full(n_frames, 3 * gps_noise_m ** 2),
        odom_cov_trace=np.full(n_frames, 0.03),
        compass_yaw=compass,
        true_map_T_sensor=poses.astype(np.float32),
        global_T_map=global_T_map,
    )


def make_imu(
    poses: np.ndarray,
    scan_dt: float = 0.1,
    imu_rate: int = 10,
    gyro_bias: np.ndarray | None = None,
    accel_bias: np.ndarray | None = None,
    gyro_noise: float = 0.002,
    accel_noise: float = 0.02,
    seed: int = 0,
    gravity: float = 9.80665,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthesize body-frame IMU packets between scan poses.

    Returns (gyro (T-1, K, 3), accel (T-1, K, 3), dt (T-1, K)) with K =
    imu_rate samples per inter-scan interval. Angular velocity comes from
    the relative rotation log; the accelerometer reports specific force
    f = R^T (a_world - g_world) with g_world = (0, 0, -gravity), plus bias
    and white noise. Packet k covers poses[k] -> poses[k+1].
    """
    from scipy.spatial.transform import Rotation as ScipyR

    rng = np.random.default_rng(seed)
    T = len(poses)
    K = imu_rate
    dt = scan_dt / K
    gyro_bias = np.zeros(3) if gyro_bias is None else np.asarray(gyro_bias)
    accel_bias = np.zeros(3) if accel_bias is None else np.asarray(accel_bias)
    g_w = np.array([0.0, 0.0, -gravity])

    # world-frame accelerations by central differences of position
    pos = poses[:, :3, 3].astype(np.float64)
    vel = np.gradient(pos, scan_dt, axis=0)
    acc = np.gradient(vel, scan_dt, axis=0)

    gyro = np.zeros((T - 1, K, 3))
    accel = np.zeros((T - 1, K, 3))
    dts = np.full((T - 1, K), dt)
    for k in range(T - 1):
        R0 = poses[k, :3, :3].astype(np.float64)
        R1 = poses[k + 1, :3, :3].astype(np.float64)
        w_body = ScipyR.from_matrix(R0.T @ R1).as_rotvec() / scan_dt
        for j in range(K):
            alpha = (j + 0.5) / K
            Rj = R0 @ ScipyR.from_rotvec(w_body * alpha * scan_dt).as_matrix()
            a_w = (1 - alpha) * acc[k] + alpha * acc[min(k + 1, T - 1)]
            f_body = Rj.T @ (a_w - g_w)
            gyro[k, j] = w_body + gyro_bias + rng.normal(0, gyro_noise, 3)
            accel[k, j] = f_body + accel_bias + rng.normal(0, accel_noise, 3)
    return (
        gyro.astype(np.float32),
        accel.astype(np.float32),
        dts.astype(np.float32),
    )


def make_mapping_logs(
    seq: SensorSequence, standstill_frames: int = 12
) -> tuple[np.ndarray, np.ndarray]:
    """Produce (odom_positions (T,3), gps_yaw rows (T,4)) as the mapping
    node's text logs would contain (map_data_save_node.cpp:84-98), with the
    first `standstill_frames` rows near the odometry origin so the
    map_T_global solve (global_map_frames_manager.cpp:166-180) has
    calibration poses."""
    T = len(seq.gps_lat)
    odom_positions = seq.odom_T_sensor[:, :3, 3].astype(np.float64).copy()
    odom_positions[:standstill_frames] *= 0.0
    gps_rows = np.stack(
        [seq.gps_lat, seq.gps_lon, seq.gps_alt, seq.compass_yaw], axis=1
    )
    del T
    return odom_positions, gps_rows

"""KITTI odometry dataset loading (port of the JAX `utils/kitti.py`, a
NumPy copy).

The north-star metric is defined on KITTI seq 00 (BASELINE.md). No dataset
ships with the repository, so the fixture generator below writes a
KITTI-layout sequence from the synthetic world — and the loader is here so
the same pipeline runs on real data unchanged:

    seq = load_sequence("/data/kitti/odometry", "00", max_frames=500)
    # seq.scans are velodyne points (x, y, z), seq.poses ground truth

Velodyne `.bin` files are float32 records (x, y, z, reflectance); poses
come from `poses/<seq>.txt` (3x4 row-major, cam0 frame) and are moved to
the velodyne frame via `calib.txt`'s Tr.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """(n, 3) xyz from a KITTI velodyne .bin (reflectance dropped)."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return np.ascontiguousarray(raw[:, :3])


def read_poses(path: str) -> np.ndarray:
    """(T, 4, 4) homogeneous poses from a KITTI poses txt (3x4 rows)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    T = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    T[:, :3, :4] = rows
    return T


def read_calib_tr(path: str) -> np.ndarray:
    """The velodyne->cam0 transform Tr from calib.txt (4x4)."""
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = np.array(line.split(":", 1)[1].split(), dtype=np.float64)
                T = np.eye(4)
                T[:3, :4] = vals.reshape(3, 4)
                return T
    raise ValueError(f"no Tr line in {path}")


@dataclasses.dataclass
class KittiSequence:
    scans: list[np.ndarray]  # velodyne-frame xyz per frame
    poses: np.ndarray  # (T, 4, 4) ground truth, velodyne frame


def load_sequence(
    root: str, sequence: str = "00", max_frames: int | None = None
) -> KittiSequence:
    """Load scans + ground-truth poses for one odometry sequence.

    Expects the standard layout: `<root>/sequences/<seq>/velodyne/*.bin`,
    `<root>/sequences/<seq>/calib.txt`, `<root>/poses/<seq>.txt`.
    """
    seq_dir = os.path.join(root, "sequences", sequence)
    velo_dir = os.path.join(seq_dir, "velodyne")
    files = sorted(f for f in os.listdir(velo_dir) if f.endswith(".bin"))
    if max_frames is not None:
        files = files[:max_frames]
    scans = [read_velodyne_bin(os.path.join(velo_dir, f)) for f in files]

    cam_poses = read_poses(os.path.join(root, "poses", f"{sequence}.txt"))
    Tr = read_calib_tr(os.path.join(seq_dir, "calib.txt"))
    # velodyne-frame pose: Tr^-1 @ cam_pose @ Tr
    Tr_inv = np.linalg.inv(Tr)
    poses = np.einsum("ij,tjk,kl->til", Tr_inv, cam_poses[: len(scans)], Tr)
    return KittiSequence(scans=scans, poses=poses)


# ---------------------------------------------------------------------------
# Real-data quirks the pipeline must absorb: KITTI velodyne has NO per-point
# timestamps (deskew needs them), scan sizes vary frame to frame (fixed
# capacities need sizing), and no IMU/GPS ships with the odometry benchmark
# (the fusion stack needs both).
# ---------------------------------------------------------------------------


def azimuth_taus(points: np.ndarray) -> np.ndarray:
    """Per-point sweep fractions synthesized from scan geometry.

    The HDL-64E spins clockwise (viewed from above) with the sweep cut at
    the vehicle's rear, so a point's azimuth encodes WHEN in the sweep it
    was measured: theta = atan2(y, x) runs +pi (rear, sweep start) ->
    0 (front, mid-sweep) -> -pi (rear, sweep end), giving
    tau = (pi - theta) / (2 pi) in [0, 1]. This is the standard KITTI
    deskew-time model (the dataset ships no per-point stamps); feed the
    result to ops/deskew.deskew as the `tau` argument.
    """
    points = np.asarray(points, np.float32).reshape(-1, 3)
    theta = np.arctan2(points[:, 1], points[:, 0])
    return (0.5 * (1.0 - theta / np.pi)).astype(np.float32)


def suggest_scan_capacity(
    scans: list[np.ndarray], subsample: int = 1, margin: float = 1.25
) -> int:
    """Capacity (power of two) covering every scan with headroom.

    Real scan sizes vary ~20% frame to frame (KITTI 00: 85k-130k points);
    the fixed-shape device pipeline needs one capacity that fits them all.
    `margin` guards frames beyond the sample when sizing from a prefix.
    """
    biggest = max((len(s) for s in scans), default=0)
    need = max(int(-(-biggest // subsample) * margin), 1024)
    return 1 << int(np.ceil(np.log2(need)))


def synthesize_imu(
    poses: np.ndarray,
    dt: float = 0.1,
    substeps: int = 10,
    gyro_noise: float = 0.0005,
    accel_noise: float = 0.005,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """IMU packets consistent with a ground-truth pose sequence.

    The odometry benchmark ships no inertial data; the LIO stack needs
    gyro/accel between consecutive scans. Delegates to
    utils/synthetic.make_imu (twist differentiation + gravity + noise).
    Returns (gyro (T-1, K, 3), accel (T-1, K, 3), dts (T-1, K)).
    """
    from slam_sensor_fusion_tpu_torch.utils import synthetic as syn

    return syn.make_imu(
        np.asarray(poses, np.float32),
        scan_dt=dt,
        imu_rate=substeps,
        gyro_noise=gyro_noise,
        accel_noise=accel_noise,
        seed=seed,
    )


def write_fixture(
    root: str,
    scans: list[np.ndarray],
    velo_poses: np.ndarray,
    sequence: str = "00",
    Tr: np.ndarray | None = None,
    seed: int = 0,
) -> None:
    """Write scans + poses as a standard KITTI odometry layout on disk.

    Produces `sequences/<seq>/velodyne/*.bin` (float32 xyzr records),
    `sequences/<seq>/calib.txt` (P0-P3 + Tr lines) and `poses/<seq>.txt`
    (cam0-frame 3x4 rows, i.e. Tr @ velo_pose @ Tr^-1) — the loader then
    exercises the exact parsing/frame-conversion path real data takes.
    """
    rng = np.random.default_rng(seed)
    if Tr is None:
        # a realistic velodyne->cam0 extrinsic: axis permutation (x fwd,
        # y left, z up -> z fwd, x right, y down) plus a small mount offset
        Tr = np.eye(4)
        Tr[:3, :3] = np.array(
            [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]
        )
        Tr[:3, 3] = [-0.01, -0.07, -0.27]
    velo_poses = np.asarray(velo_poses, np.float64)

    seq_dir = os.path.join(root, "sequences", sequence)
    velo_dir = os.path.join(seq_dir, "velodyne")
    os.makedirs(velo_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)

    for k, xyz in enumerate(scans):
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        refl = rng.uniform(0.0, 1.0, (len(xyz), 1)).astype(np.float32)
        np.hstack([xyz, refl]).tofile(os.path.join(velo_dir, f"{k:06d}.bin"))

    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        proj = "7.070912e+02 0.0 6.018873e+02 0.0 0.0 7.070912e+02 " \
               "1.831104e+02 0.0 0.0 0.0 1.0 0.0"
        for cam in range(4):
            f.write(f"P{cam}: {proj}\n")
        f.write(
            "Tr: " + " ".join(f"{v:.9e}" for v in Tr[:3, :4].ravel()) + "\n"
        )

    cam_poses = np.einsum(
        "ij,tjk,kl->til", Tr, velo_poses[: len(scans)], np.linalg.inv(Tr)
    )
    with open(os.path.join(root, "poses", f"{sequence}.txt"), "w") as f:
        for T in cam_poses:
            f.write(" ".join(f"{v:.9e}" for v in T[:3, :4].ravel()) + "\n")


def make_synthetic_kitti(
    root: str,
    n_frames: int = 64,
    max_points: int = 16384,
    extent: float = 120.0,
    speed_per_frame: float = 0.15,
    points_per_m2: float = 24.0,
    seed: int = 0,
    sequence: str = "00",
) -> None:
    """Generate a KITTI-layout dataset from the synthetic world model.

    Scans carry REAL intra-sweep motion with azimuth-consistent sweep
    fractions (utils/synthetic.render_scan_skewed tau_mode="azimuth"), so
    a consumer that synthesizes per-point times from geometry
    (azimuth_taus) recovers nearly the true fractions — the same contract
    real KITTI data imposes. Per-frame point counts vary like real logs.
    The same seed writes the same bytes as the JAX package's generator.
    """
    from slam_sensor_fusion_tpu_torch.utils import synthetic as syn

    rng = np.random.default_rng(seed)
    world = syn.make_world(
        rng,
        extent=extent,
        n_buildings=max(int(extent * extent / 280), 8),
        n_poles=max(int(extent * extent / 100), 20),
        points_per_m2=points_per_m2,
    )
    poses = syn.make_trajectory(
        n_frames, speed_per_frame=speed_per_frame, radius=extent / 4.7
    )
    scans = []
    for i in range(n_frames):
        cap = int(max_points * rng.uniform(0.8, 1.0))  # real logs vary
        pts, _ = syn.render_scan_skewed(
            world, poses[max(i - 1, 0)], poses[i], rng,
            max_points=cap, max_range=25.0, tau_mode="azimuth",
        )
        scans.append(pts)
    write_fixture(root, scans, poses, sequence=sequence, seed=seed)

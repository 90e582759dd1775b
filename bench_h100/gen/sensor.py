"""The benchmark's sensor model, on the device from a seed.

A torch copy of the port's `utils/synthetic` (make_world, make_trajectory,
render_scan_skewed, make_sequence_from_scans, make_imu) and of
`utils/kitti` (azimuth_taus, the fixture's sizes), written for the card:
every random draw comes from one `torch.Generator` on the target device, in
a few large calls. The host numpy generator takes tens of seconds for a
seq-00-density log; this one takes well under a second on an H100.

The streams follow the same model as the port's generator; they are not
the same numbers (another random generator).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

F32 = torch.float32
F64 = torch.float64


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on `device` seeded from any whole number (seeds may pass
    32 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(g, n, lo, hi, device, dtype=F32):
    return torch.rand(n, generator=g, device=device, dtype=dtype) * (hi - lo) + lo


def _normal(g, shape, std, device, dtype=F32):
    return torch.randn(shape, generator=g, device=device, dtype=dtype) * std


def rot_z(yaw: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations about z."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, -s, z, s, c, z, z, z, o], dim=-1).reshape(yaw.shape + (3, 3))


def make_world(g, device, extent: float, n_buildings: int, n_poles: int,
               points_per_m2: float, ground_z: float = -1.8) -> torch.Tensor:
    """Ground, building walls and poles, (N, 3) float32 (utils/synthetic.
    make_world): ground at one point a square metre, walls at
    `points_per_m2`, poles at 15 points a metre of height."""
    half = extent / 2
    n_ground = int(extent * extent)
    ground = torch.stack([
        _uniform(g, n_ground, -half, half, device),
        _uniform(g, n_ground, -half, half, device),
        ground_z + _normal(g, n_ground, 0.02, device),
    ], dim=1)
    # buildings: centre, width, depth, height; four walls each
    cx, cy = _uniform(g, n_buildings, -half, half, device), _uniform(g, n_buildings, -half, half, device)
    w, d = _uniform(g, n_buildings, 4, 14, device), _uniform(g, n_buildings, 4, 14, device)
    h = _uniform(g, n_buildings, 3, 10, device)
    # wall k of building b: axis 0 (x = cx -+ w/2, spans d) or 1 (spans w)
    axis = torch.tensor([0, 0, 1, 1], device=device).repeat(n_buildings)
    sign = torch.tensor([-1.0, 1.0, -1.0, 1.0], device=device).repeat(n_buildings)
    bid = torch.arange(n_buildings, device=device).repeat_interleave(4)
    span = torch.where(axis == 0, d[bid], w[bid])
    counts = torch.clamp((span * h[bid] * points_per_m2).to(torch.int64), min=8)
    wall = torch.repeat_interleave(torch.arange(4 * n_buildings, device=device), counts)
    n = wall.shape[0]
    u = _uniform(g, n, -0.5, 0.5, device)
    zw = ground_z + torch.rand(n, generator=g, device=device) * h[bid[wall]]
    b, ax, sg = bid[wall], axis[wall], sign[wall]
    xw = torch.where(ax == 0, cx[b] + sg * w[b] / 2, cx[b] + u * w[b])
    yw = torch.where(ax == 0, cy[b] + u * d[b], cy[b] + sg * d[b] / 2)
    walls = torch.stack([xw, yw, zw], dim=1)
    # poles
    px, py = _uniform(g, n_poles, -half, half, device), _uniform(g, n_poles, -half, half, device)
    ph = _uniform(g, n_poles, 2, 6, device)
    pc = torch.clamp((ph * 15).to(torch.int64), min=5)
    pole = torch.repeat_interleave(torch.arange(n_poles, device=device), pc)
    m = pole.shape[0]
    poles = torch.stack([
        px[pole] + _normal(g, m, 0.01, device),
        py[pole] + _normal(g, m, 0.01, device),
        ground_z + torch.rand(m, generator=g, device=device) * ph[pole],
    ], dim=1)
    return torch.cat([ground, walls, poles]).contiguous()


def make_trajectory(n_frames: int, device, speed_per_frame: float, radius: float,
                    z_amp: float = 0.3) -> torch.Tensor:
    """A smooth arc, (T, 4, 4) float64 map_T_sensor (utils/synthetic.
    make_trajectory): heading tangent to the arc, z near 0."""
    s = torch.arange(n_frames, device=device, dtype=F64) * speed_per_frame
    theta = s / radius
    T = torch.zeros((n_frames, 4, 4), device=device, dtype=F64)
    T[:, :3, :3] = rot_z(theta)
    T[:, 0, 3] = radius * torch.sin(theta)
    T[:, 1, 3] = radius * (1.0 - torch.cos(theta))
    T[:, 2, 3] = z_amp * torch.sin(s / 15.0)
    T[:, 3, 3] = 1.0
    return T


def _hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1], v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z], dim=-1).reshape(v.shape[:-1] + (3, 3))


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula for (..., 3) rotation vectors."""
    th = torch.linalg.norm(phi, dim=-1, keepdim=True).clamp(min=1e-12)
    K = _hat(phi / th)
    th = th[..., None]
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)


def so3_V(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3) for (..., 3) rotation vectors."""
    th = torch.linalg.norm(phi, dim=-1, keepdim=True).clamp(min=1e-12)
    K = _hat(phi / th)
    th = th[..., None]
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + (1.0 - torch.cos(th)) / th * K + (1.0 - torch.sin(th) / th) * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector of (..., 3, 3) rotations away from pi."""
    c = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) / 2.0).clamp(-1.0, 1.0)
    th = torch.arccos(c)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    k = torch.where(th > 1e-9, th / (2.0 * torch.sin(th).clamp(min=1e-30)), 0.5)
    return w * k[..., None]


def azimuth_taus(points: torch.Tensor) -> torch.Tensor:
    """Sweep fractions of a clockwise-spinning HDL-64E cut at the rear
    (utils/kitti.azimuth_taus): tau = (pi - atan2(y, x)) / (2 pi)."""
    theta = torch.atan2(points[..., 1], points[..., 0])
    return 0.5 * (1.0 - theta / math.pi)


class Scan(NamedTuple):
    """One rendered sweep."""

    skewed: torch.Tensor  # (n, 3) float32, each point in its own measurement frame
    tau: torch.Tensor  # (n,) float32 sweep fraction
    deskewed: torch.Tensor  # (n, 3) float32, in the end-of-sweep frame


def render_scan_skewed(g, world: torch.Tensor, prev_T: torch.Tensor, curr_T: torch.Tensor,
                       cap: int, max_range: float, noise: float) -> Scan:
    """A sweep with intra-sweep motion (utils/synthetic.render_scan_skewed,
    tau_mode="azimuth"): the points within `max_range` of the end pose,
    thinned to `cap` without replacement with weights 1 / max(d, 2)^2 (the
    Efraimidis-Spirakis keys), each measured from the pose at its sweep
    fraction on the constant twist prev -> curr, plus Gaussian noise. The
    deskewed copy maps each point back through its own measurement pose
    into the end-of-sweep frame, as a deskew with the true twist does."""
    dev = world.device
    rel = torch.linalg.inv(prev_T) @ curr_T
    phi = so3_log(rel[:3, :3])
    rho = torch.linalg.solve(so3_V(phi), rel[:3, 3])
    d = torch.linalg.norm(world - curr_T[:3, 3].to(F32), dim=1)
    sel = torch.nonzero(d < max_range).flatten()
    if sel.numel() > cap:
        w = 1.0 / torch.clamp(d[sel], min=2.0) ** 2
        u = torch.rand(sel.numel(), generator=g, device=dev).clamp(min=1e-30)
        keys = torch.log(u) / w
        sel = torch.sort(sel[torch.topk(keys, cap).indices]).values
    pts = world[sel].to(F64)
    rel_end = (pts - curr_T[:3, 3]) @ curr_T[:3, :3]
    tau = azimuth_taus(rel_end)
    R_tau = so3_exp(tau[:, None] * phi)
    t_tau = (so3_V(tau[:, None] * phi) @ (tau[:, None] * rho)[:, :, None])[:, :, 0]
    R_w = prev_T[:3, :3] @ R_tau
    t_w = t_tau @ prev_T[:3, :3].T + prev_T[:3, 3]
    body = torch.einsum("nji,nj->ni", R_w, pts - t_w)
    body = body + _normal(g, body.shape, noise, dev, F64)
    world_pt = torch.einsum("nij,nj->ni", R_w, body) + t_w
    deskewed = (world_pt - curr_T[:3, 3]) @ curr_T[:3, :3]
    return Scan(body.to(F32), tau.to(F32), deskewed.to(F32))


class Streams(NamedTuple):
    """The localization streams around a log (utils/synthetic.
    make_sequence_from_scans), already in the map frame."""

    odom_T_sensor: torch.Tensor  # (T, 4, 4) drifting LIO odometry
    map_T_sensor_gps: torch.Tensor  # (T, 4, 4) GPS position + compass yaw
    odom_cov_trace: torch.Tensor  # (T,)
    gps_cov_trace: torch.Tensor  # (T,)


def make_streams(g, poses: torch.Tensor, odom_drift: float, gps_noise_m: float,
                 compass_noise: float) -> Streams:
    """Odometry = the true relative motion composed with a small drift
    (yaw N(0, drift), translation N(0, 10 drift)); GPS = the true position
    plus N(0, gps_noise_m) on each axis with the compass yaw (true yaw plus
    N(0, compass_noise)), given in the map frame (the GPS -> map datum is
    not exercised); covariance traces 3 gps_noise_m^2 and 0.03."""
    T, dev = poses.shape[0], poses.device
    dyaw = _normal(g, T, odom_drift, dev, F64)
    dt = _normal(g, (T, 3), odom_drift * 10, dev, F64)
    gps_t = poses[:, :3, 3] + _normal(g, (T, 3), gps_noise_m, dev, F64)
    yaw = torch.atan2(poses[:, 1, 0], poses[:, 0, 0]) + _normal(g, T, compass_noise, dev, F64)
    noise_T = torch.eye(4, dtype=F64, device=dev).repeat(T, 1, 1)
    noise_T[:, :3, :3] = rot_z(dyaw)
    noise_T[:, :3, 3] = dt
    rel = torch.linalg.inv(poses[:-1]) @ poses[1:]
    steps = rel @ noise_T[1:]
    odom = [torch.eye(4, dtype=F64, device=dev)]
    for k in range(T - 1):
        odom.append(odom[-1] @ steps[k])
    gps = torch.eye(4, dtype=F64, device=dev).repeat(T, 1, 1)
    gps[:, :3, :3] = rot_z(yaw)
    gps[:, :3, 3] = gps_t
    return Streams(
        odom_T_sensor=torch.stack(odom).to(F32),
        map_T_sensor_gps=gps.to(F32),
        odom_cov_trace=torch.full((T,), 0.03, dtype=F32, device=dev),
        gps_cov_trace=torch.full((T,), 3 * gps_noise_m ** 2, dtype=F32, device=dev),
    )


def make_imu(g, poses: torch.Tensor, scan_dt: float = 0.1, imu_rate: int = 10,
             gyro_noise: float = 0.0005, accel_noise: float = 0.005,
             gravity: float = 9.80665):
    """Body-frame IMU packets between scan poses (utils/synthetic.make_imu
    with utils/kitti.synthesize_imu's noise): gyro from the relative
    rotation's log, specific force R^T (a_world - g) from central
    differences of the positions. Returns gyro, accel (T-1, K, 3) and dt
    (T-1, K), float32."""
    T, dev, K = poses.shape[0], poses.device, imu_rate
    pos = poses[:, :3, 3]
    vel = torch.gradient(pos, spacing=scan_dt, dim=0)[0]
    acc = torch.gradient(vel, spacing=scan_dt, dim=0)[0]
    R0, R1 = poses[:-1, :3, :3], poses[1:, :3, :3]
    w_body = so3_log(R0.transpose(1, 2) @ R1) / scan_dt  # (T-1, 3)
    alpha = (torch.arange(K, device=dev, dtype=F64) + 0.5) / K  # (K,)
    Rj = R0[:, None] @ so3_exp(w_body[:, None, :] * (alpha[None, :, None] * scan_dt))
    nxt = torch.clamp(torch.arange(1, T, device=dev), max=T - 1)
    a_w = (1 - alpha)[None, :, None] * acc[:-1, None] + alpha[None, :, None] * acc[nxt][:, None]
    g_w = torch.tensor([0.0, 0.0, -gravity], dtype=F64, device=dev)
    f_body = torch.einsum("tkji,tkj->tki", Rj, a_w - g_w)
    gyro = w_body[:, None, :].expand(T - 1, K, 3) + _normal(g, (T - 1, K, 3), gyro_noise, dev, F64)
    accel = f_body + _normal(g, (T - 1, K, 3), accel_noise, dev, F64)
    dts = torch.full((T - 1, K), scan_dt / K, dtype=F32, device=dev)
    return gyro.to(F32), accel.to(F32), dts


class Log(NamedTuple):
    """A seq-00-density log: the world, the truth, the sweeps, the streams."""

    world: torch.Tensor
    poses: torch.Tensor  # (T, 4, 4) float64 truth
    scans: list[Scan]
    streams: Streams


def firing_order(n: int, stride: int, g, device) -> torch.Tensor:
    """A random order of a sweep's `n` points that keeps each point's
    place modulo `stride`: the points at places 0, stride, 2 stride, ...
    are the same set in every order."""
    idx = torch.empty(n, dtype=torch.int64, device=device)
    for r in range(min(stride, n)):
        places = torch.arange(r, n, stride, device=device)
        idx[places] = places[torch.randperm(len(places), generator=g, device=device)]
    return idx


def make_log(site: dict, log: dict, noise: dict, seed: int, device, stride: int) -> Log:
    """One deployment's log, the same work for every seed: the world, the
    route, the scan sizes (max_points x U(0.8, 1.0), utils/kitti.
    make_synthetic_kitti), the points each sweep samples, the noise, the
    odometry drift and the GPS fixes all come from the site's own seed;
    the noise levels are the configuration's (`range_noise_m`,
    `odom_drift`, `gps_noise_m`, `compass_noise_rad`).
    The run's `seed` orders each sweep's points (another firing order),
    keeping each point's place modulo `stride`, so a subsample of every
    `stride`-th point in sweep order keeps the same points for every seed,
    in another order."""
    device = torch.device(device)
    gw = generator(site["world_seed"], device)
    world = make_world(gw, device, site["extent"], site["n_buildings"], site["n_poles"],
                       site["points_per_m2"])
    poses = make_trajectory(log["frames"], device, log["speed_per_frame"],
                            site["extent"] / site["radius_div"])
    caps = (log["max_points"] * _uniform(gw, log["frames"], 0.8, 1.0, device, F64)).to(torch.int64)
    scans = [render_scan_skewed(gw, world, poses[max(i - 1, 0)], poses[i], cap, log["max_range"],
                                noise["range_noise_m"])
             for i, cap in enumerate(caps.tolist())]
    streams = make_streams(gw, poses, noise["odom_drift"], noise["gps_noise_m"],
                           noise["compass_noise_rad"])
    g = generator(seed, device)
    orders = [firing_order(len(s.tau), stride, g, device) for s in scans]
    scans = [Scan(*[x[p] for x in s]) for s, p in zip(scans, orders)]
    return Log(world, poses, scans, streams)


def survey_tiles(lg: Log, every: int, reach: float) -> list[torch.Tensor]:
    """The site's prior map as a mapping run leaves it: for every
    `every`-th pose of the route, the world's points within `reach` of it
    that no earlier tile holds (the same for every run of the site)."""
    seen = torch.zeros(lg.world.shape[0], dtype=torch.bool, device=lg.world.device)
    out = []
    for i in range(0, lg.poses.shape[0], every):
        near = torch.linalg.norm(lg.world - lg.poses[i, :3, 3].to(F32), dim=1) < reach
        out.append(lg.world[near & ~seen])
        seen |= near
    return out

"""Small LIO worlds and registration scenes for the PyTorch port's LIO tests,
importing nothing of JAX, so the tests of the CUDA kernels
(tests/test_torch_cuda.py) also run where JAX is not installed. Everything
is NumPy made from a seed; each test hands the same arrays to both
packages."""

from __future__ import annotations

import os

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.models.ekf import EKFConfig
from slam_sensor_fusion_tpu_torch.models.lio import LIOConfig
from slam_sensor_fusion_tpu_torch.ops import p2p_fused as tpf
from slam_sensor_fusion_tpu_torch.ops import point_to_plane as tpp
from slam_sensor_fusion_tpu_torch.ops.morton import sort_order_numpy, sort_points_numpy
from slam_sensor_fusion_tpu_torch.utils import synthetic as syn

#: the bench's LIO configuration (bench.py bench_lio in its `blocks` mode
#: on the `fused` backend) at test size: tests/test_lio.py's
#: SMALL_LIO capacities, 16 source tiles of 256 and 16 target tiles of 512
SMALL_LIO = LIOConfig(
    scan_capacity=4096,
    window=8,
    slot_points=2048,
    refresh_every=4,
    p2p=tpp.PointToPlaneConfig(
        nn_backend="fused", num_iterations=2, fixed_correspondences=True,
        reassoc_margin=0.15, tile_src=256, tile_tgt=512, max_visits=64,
    ),
    anchor_subsample=2,
    normal_est="cells",
    normal_voxel=1.8,
    icp_cov_mode="gn",
    icp_pos_std=0.3,
    ekf=EKFConfig(init_pos_std=0.1, init_vel_std=0.1),
)


def ground_and_walls(seed: int, shift=(0.0, 0.0, 0.0), n: int = 65536):
    """A masked LIO-ring-sized cloud of ground and walls every 10 m, moved
    by `shift`: (points (n, 3) float32, mask (n,)). At 0.75 m cells, near
    the origin and moved by (40, 30, 0) m, a point lies on a cell's edge:
    its cell id floors otherwise under a true division by the edge than
    under the product with its float32 reciprocal."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 3)) * [60.0, 60.0, 0.3] - [30.0, 30.0, 0.0]
    walls = rng.uniform(size=n) < 0.4
    pts[walls, 2] = rng.uniform(0, 4, walls.sum())
    pts[walls, 1] = np.round(pts[walls, 1] / 10.0) * 10.0 + rng.normal(0, 0.02, walls.sum())
    pts = (pts + np.asarray(shift)).astype(np.float32)
    return pts, rng.uniform(size=n) < 0.9


def lio_sequence(n_frames: int, cap: int, seed: int = 0, extent: float = 50.0,
                 imu_rate: int = 10):
    """bench.py bench_lio's data at test size: skewed scans (Morton
    pre-sorted with taus riding along), IMU packets, noisy GPS. Returns
    poses (T, 4, 4), v0 (3,), the first frame (scan, mask) and the arrays of
    frames 1..: (scans, masks, gyro, accel, dt, gps_pos, gps_var, gps_valid,
    taus)."""
    rng = np.random.default_rng(seed)
    world = syn.make_world(rng, extent=extent, n_buildings=15, n_poles=40, points_per_m2=24.0)
    poses = syn.make_trajectory(n_frames, speed_per_frame=0.15)
    gyro, accel, dts = syn.make_imu(poses, imu_rate=imu_rate, gyro_noise=0.0005, accel_noise=0.005)
    sp = np.zeros((n_frames, cap, 3), np.float32)
    sm = np.zeros((n_frames, cap), bool)
    tp = np.ones((n_frames, cap), np.float32)
    for i in range(n_frames):
        pts, tau = syn.render_scan_skewed(
            world, poses[max(i - 1, 0)], poses[i], rng, max_points=cap - 64, max_range=25.0
        )
        order = sort_order_numpy(pts, isotropic=True)
        n = len(pts)
        sp[i, :n], sm[i, :n], tp[i, :n] = pts[order], True, tau[order]
    gps = (
        poses[1:, :3, 3] + np.random.default_rng(seed + 3).normal(0, 0.5, (n_frames - 1, 3))
    ).astype(np.float32)
    v0 = ((poses[1][:3, 3] - poses[0][:3, 3]) / 0.1).astype(np.float32)
    frames = (
        sp[1:], sm[1:], gyro, accel, dts, gps,
        np.full(n_frames - 1, 0.25, np.float32), np.ones(n_frames - 1, bool), tp[1:],
    )
    return poses, v0, (sp[0], sm[0]), frames


def p2p_scene(seed: int, n_tgt: int = 1900, M: int = 1024, N: int = 2048, ties: bool = False):
    """A registration problem: a Morton-sorted target of two walls, a floor
    and a pole with per-point normals (analytic, some invalid), and the
    same points seen from a pose 0.1 m / 1 degree off, with noise, as the
    source. `ties` duplicates target points exactly (the copy lands in a
    later row or tile), so first-row association is exercised. Returns
    (src, src_mask, tgt, tgt_mask, normals, normals_valid, T0) as NumPy."""
    rng = np.random.default_rng(seed)
    q = n_tgt // 4
    parts = [
        (np.stack([rng.uniform(-6, 6, q), np.full(q, 4.0), rng.uniform(0, 3, q)], 1), [0, 1, 0]),
        (np.stack([np.full(q, -5.0), rng.uniform(-6, 4, q), rng.uniform(0, 3, q)], 1), [1, 0, 0]),
        (np.stack([rng.uniform(-6, 6, q), rng.uniform(-6, 4, q), np.zeros(q)], 1), [0, 0, 1]),
    ]
    ang = np.linspace(0, 20, n_tgt - 3 * q)
    pole = np.stack([np.cos(ang) * 0.2 + 2.0, np.sin(ang) * 0.2 - 1.0,
                     rng.uniform(0, 3, len(ang))], 1)
    pts = np.concatenate([p for p, _ in parts] + [pole]).astype(np.float32)
    nrm = np.concatenate(
        [np.tile(np.asarray(n, np.float32), (q, 1)) for _, n in parts]
        + [np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], 1).astype(np.float32)]
    )
    if ties:
        pts[1::5] = pts[0::5][: len(pts[1::5])]
        nrm[1::5] = nrm[0::5][: len(nrm[1::5])]
    order = sort_order_numpy(pts)
    pts, nrm = pts[order], nrm[order]
    nvalid = rng.uniform(size=len(pts)) > 0.1
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.017), np.sin(0.017)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [0.08, -0.06, 0.03]
    n_src = M - 60
    pick = pts[rng.choice(len(pts), n_src, replace=n_src > len(pts))]
    src = (pick - T[:3, 3]) @ T[:3, :3] + rng.normal(0, 0.01, pick.shape)
    src = sort_points_numpy(src.astype(np.float32))
    sbuf = np.zeros((M, 3), np.float32)
    sbuf[:n_src] = src
    tbuf = np.zeros((N, 3), np.float32)
    tbuf[: len(pts)] = pts
    nbuf = np.zeros((N, 3), np.float32)
    nbuf[: len(pts)] = nrm
    vbuf = np.zeros(N, bool)
    vbuf[: len(pts)] = nvalid
    return sbuf, np.arange(M) < n_src, tbuf, np.arange(N) < len(pts), nbuf, vbuf, np.eye(4, dtype=np.float32)


def p2p_core_inputs(scene, config, device="cpu", center=(0.5, -0.3, 0.1)):
    """K4's arguments for `scene` (p2p_scene) as `point_to_plane_align_fused`
    builds them: (src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt,
    T0_rebased)."""
    src, smask, tgt, tmask, nrm, nvalid, T0 = (torch.from_numpy(a).to(device) for a in scene)
    cached = tpf.build_cached_p2p_target(
        tgt, tmask, nrm, nvalid, torch.tensor(center, device=device), config.tile_tgt
    )
    return tpf.p2p_inputs(src, smask, cached, T0, config)[0]


#: bench.py bench_lio's configuration for its `block` loop (one K7 launch a block):
#: SMALL_LIO's settings at the bench's width, 16-frame blocks, registration
#: on every 4th scan point (4 source tiles of 512 against 32 target tiles
#: of 1024)
BENCH_LIO = SMALL_LIO._replace(
    scan_capacity=8192, window=16, slot_points=4096, refresh_every=16, reg_subsample=4,
    max_pairs_factor=64, slack_base=0.1,
    p2p=SMALL_LIO.p2p._replace(tile_src=512, tile_tgt=1024, assoc_unroll=1),
)

#: an odd shape for K7: 3-frame blocks of 7 IMU samples, 4 source tiles of
#: 96 (scan 1152 every 3rd point) against 6 target tiles of 200 (a width the
#: 16-byte association loads do not take)
ODD_LIO = SMALL_LIO._replace(
    scan_capacity=1152, window=3, slot_points=800, refresh_every=3, reg_subsample=3,
    gate_sub_src=16, gate_sub_tgt=40, icp_cov_mode="constant",
    p2p=SMALL_LIO.p2p._replace(tile_src=96, tile_tgt=200, fixed_correspondences=False),
)


def k7_case(config, device, imu_rate: int = 10, seed: int = 0):
    """K7's arguments for the first block of a small world at `config`'s
    width, through the port's own prologue (anchor refresh, dead
    reckoning, deskew, pages, pair lists), on `device`; and its params."""
    from slam_sensor_fusion_tpu_torch.models import lio as tl

    R = config.refresh_every
    poses, v0, (s0, m0), frames = lio_sequence(R + 1, config.scan_capacity, seed=seed,
                                               imu_rate=imu_rate)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    st = tl.init_state(config, up(s0), up(m0), up(poses[0]))
    st = st._replace(ekf_state=st.ekf_state._replace(v=up(v0)))
    sp, sm, gy, ac, dt, gp, gv, gok, tau = [up(a) for a in frames]
    cache = tl._refresh_anchor(st.ring, st.ring_mask, st.ekf_state.p, config)[4]
    base_r = float(np.sqrt(config.p2p.max_correspondence_dist_sq)) + config.p2p.reassoc_margin
    ks = torch.arange(R, dtype=torch.float32, device=device)
    radius2 = (base_r + config.slack_base + config.superstep_slack * ks) ** 2
    vld = torch.ones(R, dtype=torch.bool, device=device)
    pred_t, _, src_pages, pairs, _, _ = tl._block_prologue(
        st, cache, sp, sm, tau, gy, ac, dt, vld, radius2, config)
    e0 = st.ekf_state
    args = (*pairs, vld, gy, ac, dt, gp, gv, gok, pred_t, tl.ekf.pose_matrix(e0), e0.v,
            e0.bg, e0.ba, e0.P, cache.center, src_pages, cache.pages)
    return args, tl._superblock_params(config)


#: K7's card scenes: (configuration, IMU samples a frame, the least
#: correspondences a frame must have for the comparison not to be vacuous)
K7_SHAPES = {"bench": (BENCH_LIO, 10, 1000), "odd": (ODD_LIO, 7, 50)}

#: K7 past 1024 rows a tile: BENCH_LIO's block registered on every 2nd scan
#: point in 2 tiles of 2048, and on every point in 2 tiles of 4096
K7_WIDE = {
    str(TM): (BENCH_LIO._replace(reg_subsample=8192 // (2 * TM),
                                 p2p=BENCH_LIO.p2p._replace(tile_src=TM)), 10, 1000)
    for TM in (2048, 4096)
}


#: K7_DIGEST's inputs: `k7_case`'s arguments on the K7_SHAPES blocks as the
#: port's host path on the CPU built them (anchor refresh, dead reckoning,
#: deskew, pages, pair lists), written once by `save_k7_inputs`, so the
#: digest moves only when K7 itself does
K7_INPUTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "k7_inputs.npz")


def save_k7_inputs(path: str = K7_INPUTS) -> None:
    """Write `k7_case`'s arguments on the K7_SHAPES blocks (built on the
    CPU) to `path`."""
    arrays = {}
    for name, (config, imu_rate, _) in K7_SHAPES.items():
        args, _ = k7_case(config, torch.device("cpu"), imu_rate=imu_rate)
        arrays.update({f"{name}_{i:02d}": a.numpy() for i, a in enumerate(args)})
    np.savez_compressed(path, **arrays)


def load_k7_inputs(device) -> dict:
    """K7_INPUTS on `device`: name -> (K7's arguments, its params)."""
    from slam_sensor_fusion_tpu_torch.models import lio as tl

    with np.load(K7_INPUTS) as f:
        out = {}
        for name, (config, _, _) in K7_SHAPES.items():
            keys = sorted(k for k in f.files if k.startswith(name + "_"))
            out[name] = ([torch.from_numpy(f[k]).to(device) for k in keys],
                         tl._superblock_params(config))
    return out


#: `k7_digest` of K7 as the one-block kernel computed it, before its
#: association spread over a cooperative grid (NVIDIA H100 80GB HBM3). Its
#: inputs are a fixture (K7_INPUTS), so it moves only when K7 does. Before
#: the fixture they came out of the port's host path and the value moved
#: with it (the cell normals' prefix sum in XLA's order, the host path in
#: XLA's float32 rounding); each time, and on the fixture, the kernel of
#: the commit before the change gave these same bits, in one chip call.
#: tests/test_torch_cuda.py and chip_smoke.py's phase 17 hold the card to it
K7_DIGEST = "456f963ef1a709d10f12f6b942b6b52e77eff8b63185d74920c1b4afe8aee558"

#: `p2p_digest` of K4, K5 and K6 as built before their device functions
#: moved into csrc/p2p_fused.cuh (NVIDIA H100 80GB HBM3); held as K7_DIGEST
P2P_DIGEST = "fe9b69ff3a2114e57bd6f478c916440175859294bc76ae9359ef0d60a2250539"


def k7_digest(device) -> str:
    """SHA-256 of `lio_superblock`'s outputs on K7_INPUTS' blocks, the
    bench block with frames 0, 7 and 15 invalid, and the odd block with
    every frame invalid: a kernel that rounds one bit differently, or takes
    another tile on a tie, changes it."""
    import hashlib

    from slam_sensor_fusion_tpu_torch.ops import lio_superblock_fused as tsb

    h = hashlib.sha256()
    for name, (args, params) in load_k7_inputs(device).items():
        valid = args[3]
        blocks = [valid.clone()]
        if name == "bench":
            blocks.append(valid.clone())
            blocks[-1][[0, 7, valid.shape[0] - 1]] = False
        else:
            blocks.append(torch.zeros_like(valid))
        for vld in blocks:
            for x in tsb.lio_superblock(*args[:3], vld, *args[4:], params):
                h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def p2p_digest(device) -> str:
    """SHA-256 of K4 (fixed and fresh correspondences), K5 and K6's outputs
    on the scenes of tests/test_torch_cuda.py's K4 tests (the LIO bench's
    tiles and an odd shape): a kernel that rounds one bit differently
    changes it."""
    import hashlib

    h = hashlib.sha256()
    for M, N, n_tgt, TM, TN in [(8192, 32768, 30000, 512, 1024), (96, 450, 400, 96, 150)]:
        scene = p2p_scene(7, n_tgt=n_tgt, M=M, N=N, ties=True)
        for fixed in (True, False):
            config = tpp.PointToPlaneConfig(
                num_iterations=2, tile_src=TM, tile_tgt=TN, max_visits=64, reassoc_margin=0.15,
                nn_backend="fused", fixed_correspondences=fixed,
            )
            core = p2p_core_inputs(scene, config, device)
            outs = list(tpf._p2p_core(*core, config))
            if fixed:
                d2, qn = tpf._p2p_associate(*core)
                outs += [d2, qn, *tpf._p2p_gn_corr(core[5], core[0], d2, qn, config)]
            for x in outs:
                h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def xla_math_cases() -> dict:
    """Seeded inputs of xla_math's composite functions at the LIO path's
    shapes (tests/test_torch_cuda.py on the card, and
    tests/test_torch_xla_math_host.py with the kernel's source built for
    the host): name -> (call, inputs on the CPU)."""
    from slam_sensor_fusion_tpu_torch.models import ekf, lio
    from slam_sensor_fusion_tpu_torch.ops import deskew as dk
    from slam_sensor_fusion_tpu_torch.ops import geometry as geo
    from slam_sensor_fusion_tpu_torch.ops import point_to_plane as tpp
    from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

    rng = np.random.default_rng(3)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    mag = np.concatenate([10.0 ** rng.uniform(-9, 0.5, 250), np.zeros(3), np.full(3, np.pi)])
    w = torch.from_numpy((f32(256, 3).numpy() / np.linalg.norm(f32(256, 3).numpy(), axis=1,
                                                                keepdims=True)
                          * mag[:, None]).astype(np.float32))
    R = geo.so3_exp(w)
    xi = torch.cat([f32(256, 3, scale=2.0), w], 1)
    T = geo.se3_exp(xi)
    A = f32(15, 15, scale=0.1)
    st = ekf.EKFState(f32(3, scale=10.0), f32(3), geo.so3_exp(f32(3)), f32(3, scale=1e-3),
                      f32(3, scale=1e-2), A @ A.T + 0.01 * torch.eye(15))
    gy, ac = f32(4, 10, 3, scale=0.3), f32(4, 10, 3) + torch.tensor([0.0, 0.0, 9.8])
    dt = torch.full((4, 10), 0.01)
    dt[1, 5:] = 0.0
    pts = torch.from_numpy((rng.normal(size=(3000, 3)) * [20, 20, 0.3]).astype(np.float32))
    seg = tpp._cell_segments(pts, torch.ones(3000, dtype=torch.bool), 1.8)
    return {
        "norm2": (xm.norm2, [f32(16, 512, 3, scale=30.0)]),
        "mm": (xm.mm3, [R[:16], R[16:32].transpose(-1, -2)]),
        "mv": (xm.mv3, [R[:16], f32(16, 3)]),
        "mm_lanes": (xm.mm_lanes, [st.P, st.P.T]),
        "mm_lanes 15x6x6": (xm.mm_lanes, [st.P[:, :6].contiguous(), A[:6, :6].contiguous()]),
        "so3_exp": (geo.so3_exp, [w]),
        "so3_log": (geo.so3_log, [R]),
        "se3_exp": (geo.se3_exp, [xi]),
        "se3_log": (dk.se3_log, [T]),
        "deskew": (dk.deskew, [f32(4, 512, 3, scale=30.0), torch.rand(4, 512), xi[:4] * 0.1]),
        "deskew one twist": (dk.deskew, [f32(8192, 3, scale=30.0), torch.rand(8192), xi[5] * 0.1]),
        "cell_normals": (tpp._cell_eigen, [seg]),
        "propagate": (lambda *a: ekf.flat_state(
            ekf.propagate_batch(ekf.unflat_state(a[0]), *a[1:], ekf.EKFConfig())),
            [ekf.flat_state(st), gy[0], ac[0], dt[1]]),
        "dead_reckon": (lambda *a: lio._dead_reckon(ekf.unflat_state(a[0]), *a[1:]),
                        [ekf.flat_state(st), gy, ac, dt]),
    }


#: the names of `xla_math_cases`
XLA_MATH_CASES = ["norm2", "mm", "mv", "mm_lanes", "mm_lanes 15x6x6", "so3_exp", "so3_log",
                  "se3_exp", "se3_log", "deskew", "deskew one twist", "cell_normals",
                  "propagate", "dead_reckon"]

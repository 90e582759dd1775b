#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's localization main path once on one GPU.

    python3 chip_smoke.py

Runs from the repository root on a host with one NVIDIA GPU and the CUDA
toolkit (nvcc). It imports nothing of JAX. Phases, in order; any failed
check exits non-zero:

  0. device: a CUDA device must exist; prints nvidia-smi's name and power
     limit of the card;
  1. build: compiles the CUDA kernels from the checkout's sources
     (slam_sensor_fusion_tpu_torch/csrc) and reports the seconds;
  2. kernel against plain PyTorch at the main path's shapes, on inputs
     taken from the smoke world: K2 (pair-list NN) at the startup rescue's
     size, K1 (whole-superblock fine loop) on the first real superblock;
  3. the main path at the bench's defaults (bench.py bench_loc): synthetic
     world (24 000 raw points a scan, 140 m, 257 frames), map build,
     Localizer -> init_state -> coarse_attempt, one forced rescue ICP (K2),
     then build_paged_frames -> run_chunk_fast twice from the post-startup
     state (32 superblocks each, one K1 launch per superblock). Requires
     zero pair-overflow and slack-violation frames, finite poses,
     ATE-RMSE < 0.1 m, and the launch counts the path implies.
  4. the online path at bench.py bench_latency's configuration (120 m
     world, 144 frames, scan 4096, cropped map 65 536, tile_src 512, fast
     ICP, block_kernel=False): LocalizerSession.push over every frame (one
     K3 launch a push from the coarse ladder's success on), then
     BlockLocalizerSession at K=4 (parity superblock, one K1 launch a
     block). Prints push and block p50/p99 and the host/dispatch/device
     split; requires ATE-RMSE < 0.1 m and no pair overflow;
  5. the replay entry point Localizer.run over the first 33 frames of the
     phase-4 world, twice: the default per-frame parity engine (run_chunk
     -> step, K2) and fast mode without the superblock kernel
     (run_chunk_fast's per-frame branch, K3). Requires ATE-RMSE < 0.1 m and
     K2 / K3 launches.

Phase 2 also holds K3 against its plain version (fresh and lazy, at the
session's shapes) and the per-frame superblock branch (K3 lazy) against K1
on the first superblock. Every kernel's launch count is set to 0 before
each path of phases 3-5 and read after it.

The line before the last is the kernels' JSON record (time, plain time,
error against plain, launches on the main paths, and the least time the
card could take for the same work); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 257  # 1 startup frame + 32 superblocks of 8
SESSION_FRAMES = 144  # bench.py bench_latency's sequence
SESSION_WARMUP = 16  # pushes before the timed ones (bench.py:759)
REPLAY_FRAMES = 33  # phase 5: 1 init frame + 1 coarse frame + 31 steady frames
ATE_LIMIT = 0.1  # m
K1_TOL = 3e-4  # poses/priors/state: tests/test_superblock_kernel.py's bound
K3_TOL = 3e-4  # poses, the same bound; the ICP error to K3_ERR_TOL
K3_ERR_TOL = 1e-3
K2_RTOL = 1e-5  # d2, relative
#: NVIDIA H100 SXM data sheet: float32 on the CUDA cores (the kernels use
#: no tensor cores) and HBM3 bandwidth, both at the 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FLOP_PER_DISTANCE = 8  # 3 differences, 3 products, 2 sums


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out


def bench_config():
    """bench.py bench_loc's defaults (:405-466)."""
    from slam_sensor_fusion_tpu_torch.utils.config import (
        CloudCapacity,
        ICPConfig,
        LocalizationConfig,
    )

    raw_points, subsample = 24000, 8
    scan_cap = 1 << max(int(np.ceil(np.log2(max(raw_points // subsample, 1024)))), 10)
    return LocalizationConfig(
        block_kernel=True,
        superstep=8,
        superstep_slack=0.08,
        scan_subsample_step=subsample,
        superblock_parity=True,
        icp=dataclasses.replace(
            ICPConfig(), mode="parity", reassoc_margin=0.5, num_iterations=10,
            tile_src=1024, acceptable_mean_error=0.05, tile_tgt=512,
            max_visits=128, max_pairs_factor=128,
        ),
        capacity=CloudCapacity(
            scan=scan_cap, cropped_scan=scan_cap, cropped_map=65536,
            map=1 << 20, bf_source=1024, bf_target=8192,
        ),
        map_subsample_step=1,
        brute_force_map_subsample_step=3,
    )


def session_config():
    """bench.py bench_latency's per-frame engine (:778-789): fast ICP (K3)
    each callback, no superblock batching."""
    from slam_sensor_fusion_tpu_torch.utils.config import (
        CloudCapacity,
        ICPConfig,
        LocalizationConfig,
    )

    return LocalizationConfig(
        block_kernel=False,
        superblock_parity=False,
        scan_subsample_step=8,
        icp=dataclasses.replace(ICPConfig(), mode="fast", tile_src=512),
        capacity=CloudCapacity(
            scan=4096, cropped_scan=4096, cropped_map=65536, map=1 << 20,
            bf_source=1024, bf_target=8192,
        ),
        map_subsample_step=1,
        brute_force_map_subsample_step=3,
    )


def build_session_world(n_frames: int):
    """bench.py bench_latency's world, sequence and map (:758-774)."""
    from slam_sensor_fusion_tpu_torch.models.mapping import build_map_data
    from slam_sensor_fusion_tpu_torch.utils import synthetic as syn

    rng = np.random.default_rng(0)
    world = syn.make_world(rng, extent=120.0, n_buildings=50, n_poles=150, points_per_m2=24.0)
    poses = syn.make_trajectory(n_frames, speed_per_frame=0.15, radius=26.0)
    seq = syn.make_sequence(seed=0, world=world, poses=poses, scan_points=24000)
    tiles = []
    map_rng = np.random.default_rng(1)
    for i in range(0, n_frames, 4):
        body = syn.render_scan(world, poses[i], map_rng, max_points=24000, noise=0.005)
        tiles.append(body @ poses[i][:3, :3].T + poses[i][:3, 3])
    odom_pos, gps_rows = syn.make_mapping_logs(seq)
    return seq, build_map_data(tiles, odom_pos, gps_rows)


def build_world(n_frames: int):
    """bench.py bench_loc's synthetic world, sequence and map (:487-505)."""
    from slam_sensor_fusion_tpu_torch.models.mapping import build_map_data
    from slam_sensor_fusion_tpu_torch.utils import synthetic as syn

    rng = np.random.default_rng(0)
    world = syn.make_world(rng, extent=140.0, n_buildings=70, n_poles=200, points_per_m2=24.0)
    poses = syn.make_trajectory(n_frames, speed_per_frame=0.15, radius=30.0)
    seq = syn.make_sequence(seed=0, world=world, poses=poses, scan_points=24000)
    tiles = []
    map_rng = np.random.default_rng(1)
    for i in range(0, n_frames, 4):
        body = syn.render_scan(world, poses[i], map_rng, max_points=24000, noise=0.005)
        tiles.append(body @ poses[i][:3, :3].T + poses[i][:3, 3])
    odom_pos, gps_rows = syn.make_mapping_logs(seq)
    return seq, build_map_data(tiles, odom_pos, gps_rows)


def startup(loc, seq, gps_T, config, dev):
    """init_state + one coarse attempt on frame 1 (bench.py:514-539)."""
    from slam_sensor_fusion_tpu_torch.models import localization as lz

    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    state = lz.init_state(config, loc.map_cloud.capacity, f32(gps_T[0]), f32(seq.odom_T_sensor[0]))
    fb0 = lz.build_frame_batch(
        config, [seq.scans[1]], seq.odom_T_sensor[1:2], gps_T[1:2],
        seq.odom_cov_trace[1:2], seq.gps_cov_trace[1:2], np.ones(1, bool), dev,
    )
    cm, ct, ref, cscan, coarse = lz.coarse_attempt(
        state, fb0.scan_points[0], fb0.scan_mask[0], loc.map_cloud, f32(gps_T[0]), config
    )
    state = state._replace(map_T_sensor=coarse.map_T_sensor, cropped_map=cm, cached_target=ct, map_T_ref=ref)
    return state, cscan, coarse


def nudge(T: torch.Tensor, dx: float, dy: float, yaw_deg: float) -> torch.Tensor:
    """T pushed by (dx, dy) metres and yaw_deg degrees in its own frame."""
    from slam_sensor_fusion_tpu_torch.ops import geometry as geo

    yaw = torch.tensor(math.radians(yaw_deg), device=T.device)
    off = torch.tensor([dx, dy, 0.0], device=T.device)
    return T @ geo.make_T(geo.rot_z(yaw), off)


def rescue_start(coarse_T: torch.Tensor) -> torch.Tensor:
    """The coarse pose pushed ~1 m and 5 degrees off, so the rescue ICP has
    metre-scale work to do."""
    return nudge(coarse_T, 0.8, -0.6, 5.0)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: the
    larger of operations over the f32 peak and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    return float(np.sqrt(((est[:, :3, 3] - gt[:, :3, 3]) ** 2).sum(-1).mean()))


def percentile_ms(xs, q) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def check_k2(inputs, dev_name):
    from slam_sensor_fusion_tpu_torch.ops.nn_pallas import pair_nn, pair_nn_plain

    d2k, idxk, xyzk = pair_nn(*inputs)
    d2p, idxp, xyzp = pair_nn_plain(*inputs)
    torch.cuda.synchronize()
    rel = ((d2k - d2p).abs() / torch.clamp(d2p.abs(), min=1e-30)).max().item()
    same = idxk == idxp
    # idx may differ only where d2 ties exactly between the two rows
    if not bool(torch.all(same | (d2k == d2p))):
        fail("K2: idx differs off an exact d2 tie")
    if not bool(torch.all(torch.where(same, xyzk == xyzp, True))):
        fail("K2: xyz differs where idx agrees")
    if rel > K2_RTOL:
        fail(f"K2: d2 relative error {rel} > {K2_RTOL}")
    err = (d2k - d2p).abs().max().item()
    print(f"K2 pair_nn vs plain: max|d2| diff {err:.3e} (rel {rel:.3e}), idx equal "
          f"{same.float().mean().item():.6f}, shapes src {tuple(inputs[0].shape)} "
          f"tgt {tuple(inputs[1].shape)} [{dev_name}]", flush=True)
    return err


def check_k1(args, dev_name):
    from slam_sensor_fusion_tpu_torch.ops.superblock_fused import (
        superblock_fine,
        superblock_fine_plain,
    )

    k = superblock_fine(*args)
    p = superblock_fine_plain(*args)
    torch.cuda.synchronize()
    worst = 0.0
    for i, name in [(0, "poses"), (1, "priors"), (2, "odom_preds"), (4, "pose"),
                    (5, "odom_prev"), (6, "filt_trans"), (8, "filt_prev")]:
        d = (k[i] - p[i]).abs().max().item()
        worst = max(worst, d)
        if not d <= K1_TOL:
            fail(f"K1: {name} differs by {d} > {K1_TOL}")
    for col, name in [(1, "iterations"), (2, "n_corr"), (3, "converged")]:
        if not torch.equal(k[3][:, col], p[3][:, col]):
            fail(f"K1: {name} differ: {k[3][:, col].tolist()} vs {p[3][:, col].tolist()}")
    if int(k[7]) != int(p[7]):
        fail("K1: queue count differs")
    print(f"K1 superblock_fine vs plain: max|pose/prior/state| diff {worst:.3e}, "
          f"iterations {k[3][:, 1].int().tolist()}, n_corr {k[3][:, 2].int().tolist()} "
          f"equal [{dev_name}]", flush=True)
    return worst


def check_k3(inputs, icp, lazy, dev_name):
    """K3 against its plain version on the same inputs; returns (max |T|
    diff, the plain run's tile pairs visited, stats)."""
    from slam_sensor_fusion_tpu_torch.ops.icp_fused import (
        _fused_core,
        _fused_core_plain,
        _icp_plain,
    )

    T_k, st_k = _fused_core(*inputs, icp, lazy)
    _icp_plain.pairs_visited = 0
    T_p, st_p = _fused_core_plain(*inputs, icp, lazy)
    torch.cuda.synchronize()
    what = "K3 lazy" if lazy else "K3 fresh"
    d = (T_k - T_p).abs().max().item()
    if not d <= K3_TOL:
        fail(f"{what}: T differs by {d} > {K3_TOL}")
    if not torch.equal(st_k[0, 1:3], st_p[0, 1:3]):
        fail(f"{what}: iterations/n_corr {st_k[0, 1:3].tolist()} vs {st_p[0, 1:3].tolist()}")
    e = (st_k[0, 0] - st_p[0, 0]).abs().item()
    if not e <= K3_ERR_TOL:
        fail(f"{what}: error differs by {e} > {K3_ERR_TOL}")
    if not int(st_k[0, 1]) >= 1:
        fail(f"{what}: ICP took no step, the comparison is vacuous")
    print(f"{what} vs plain: max|T| diff {d:.3e}, error diff {e:.3e}, iterations "
          f"{int(st_k[0, 1])}, n_corr {int(st_k[0, 2])} equal, tile pairs visited "
          f"{_icp_plain.pairs_visited}, shapes src {tuple(inputs[0].shape)} tgt "
          f"{tuple(inputs[1].shape)} [{dev_name}]", flush=True)
    return d, _icp_plain.pairs_visited, st_k


def check_per_frame_vs_k1(state0, blk, map_cloud, config, tag):
    """One superblock through run_chunk_fast's per-frame branch (one K3 lazy
    launch a frame) against the same superblock on K1."""
    from slam_sensor_fusion_tpu_torch.models import pipeline_fast as pf

    fin_k, out_k = pf.run_chunk_fast(state0, blk, map_cloud, config)
    fin_f, out_f = pf.run_chunk_fast(
        state0, blk, map_cloud, dataclasses.replace(config, block_kernel=False)
    )
    torch.cuda.synchronize()
    worst = 0.0
    for name in ("map_T_sensor", "map_T_sensor_prior", "map_T_sensor_odom"):
        worst = max(worst, (getattr(out_f, name) - getattr(out_k, name)).abs().max().item())
    worst = max(worst, (fin_f.map_T_sensor - fin_k.map_T_sensor).abs().max().item())
    if not worst <= K3_TOL:
        fail(f"per-frame K3 vs K1: poses differ by {worst} > {K3_TOL}")
    for name in ("icp_iterations", "n_correspondences", "icp_converged", "pair_overflow"):
        if not torch.equal(getattr(out_f, name), getattr(out_k, name)):
            fail(f"per-frame K3 vs K1: {name} differ: {getattr(out_f, name).tolist()} vs "
                 f"{getattr(out_k, name).tolist()}")
    print(f"per-frame superblock (K3 lazy) vs K1: max|pose| diff {worst:.3e}, iterations "
          f"{out_f.icp_iterations.tolist()}, n_corr {out_f.n_correspondences.tolist()} equal "
          f"[{tag}]", flush=True)


def push_args(seq, i):
    return (seq.scans[i], seq.odom_T_sensor[i], float(seq.gps_lat[i]), float(seq.gps_lon[i]),
            float(seq.gps_alt[i]), float(seq.compass_yaw[i]), float(seq.odom_cov_trace[i]),
            float(seq.gps_cov_trace[i]))


def zero_counts(*kernels) -> None:
    for k in kernels:
        k.launches = 0


def main() -> None:
    t_start = time.perf_counter()
    # ---- 0. the device ----
    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda", 0)
    tag = card()  # "<name>, <power limit>", printed beside every number
    print(tag, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    from slam_sensor_fusion_tpu_torch.models import localization as lz
    from slam_sensor_fusion_tpu_torch.models import pipeline_fast as pf
    from slam_sensor_fusion_tpu_torch.models.session import (
        BlockLocalizerSession,
        LocalizerSession,
    )
    from slam_sensor_fusion_tpu_torch.ops import cuda_lib
    from slam_sensor_fusion_tpu_torch.ops.icp import association_inputs, icp_align
    from slam_sensor_fusion_tpu_torch.ops.icp_fused import (
        _fused_core,
        _fused_core_plain,
        _icp_plain,
        fused_inputs,
    )
    from slam_sensor_fusion_tpu_torch.ops.nn_pallas import pair_nn, pair_nn_plain
    from slam_sensor_fusion_tpu_torch.ops.superblock_fused import (
        superblock_fine,
        superblock_fine_plain,
    )

    kernels = (superblock_fine, pair_nn, _fused_core)

    # ---- 1. build ----
    t0 = time.perf_counter()
    cuda_lib.build(force=True)
    cuda_lib.lib()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s (nvcc {cuda_lib.build_seconds:.1f} s) [{tag}]", flush=True)
    for line in cuda_lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- worlds (host set-up: phases 2-3 and phases 2, 4-5) ----
    t0 = time.perf_counter()
    config = bench_config()
    seq, map_data = build_world(N_FRAMES)
    scfg = session_config()
    sseq, smap = build_session_world(SESSION_FRAMES)
    print(f"set-up worlds: {time.perf_counter() - t0:.1f} s, map points {map_data.map_points.shape[0]} "
          f"(bench), {smap.map_points.shape[0]} (session)", flush=True)

    # ---- 2. kernel against plain at main-path shapes ----
    t0 = time.perf_counter()
    loc = lz.Localizer(map_data, config, dev)
    gps_T = loc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    state0, cscan, coarse = startup(loc, seq, gps_T, config, dev)
    bf_map, bf_scan = lz.brute_force_clouds(cscan, state0.cropped_map, state0.map_T_ref, config)
    k2_in = association_inputs(
        bf_scan.points, bf_scan.mask, bf_map.points, bf_map.mask,
        rescue_start(coarse.map_T_sensor), config.rescue_icp,
    )
    k2_err = check_k2(k2_in, name)
    T = N_FRAMES - 1
    frames = pf.build_paged_frames(
        config, seq.scans[1:N_FRAMES], seq.odom_T_sensor[1:N_FRAMES], gps_T[1:N_FRAMES],
        seq.odom_cov_trace[1:N_FRAMES], seq.gps_cov_trace[1:N_FRAMES], np.ones(T, bool), dev,
    )
    K = config.superstep
    blk = pf.PagedFrames(*[x[:K] for x in frames])
    pro = pf.superstep_prologue(state0, blk, loc.map_cloud, config)
    fs = state0.filter_state
    k1_args = (
        blk.src_pages, pro.pair_start, pro.pair_cnt, pro.pair_tgt, blk.valid,
        blk.odom_T_sensor, blk.map_T_sensor_gps, blk.odom_cov_trace, blk.gps_cov_trace,
        state0.map_T_sensor, state0.odom_T_sensor_previous, fs.transitions, fs.count,
        fs.previous_pose, pro.cached_target.center, pro.cached_target.pages, config,
    )
    _icp_plain.pairs_visited = 0
    k1_err = check_k1(k1_args, name)
    k1_pairs = _icp_plain.pairs_visited
    print(f"K1 block pair demand {pro.demand.tolist()}, tile pairs visited {k1_pairs}", flush=True)
    check_per_frame_vs_k1(state0, blk, loc.map_cloud, config, tag)

    # K3 at the online session's shapes: frame 1's cropped scan (8 tiles of
    # 512) against the post-coarse cropped map (128 tiles of 512), from a
    # prior 0.3 m and 2 degrees off the coarse pose
    sloc = lz.Localizer(smap, scfg, dev)
    sgps_T = sloc.gps_poses(sseq.gps_lat, sseq.gps_lon, sseq.compass_yaw)
    sstate, sscan, scoarse = startup(sloc, sseq, sgps_T, scfg, dev)
    k3_in, _, k3_ovf = fused_inputs(
        sscan.points, sscan.mask, sstate.cropped_map.points, sstate.cropped_map.mask,
        nudge(scoarse.map_T_sensor, 0.3, -0.2, 2.0), scfg.icp, sstate.cached_target,
    )
    if bool(k3_ovf):
        fail("K3 check inputs: pair list overflow")
    k3_err, k3_pairs, _ = check_k3(k3_in, scfg.icp, False, name)
    k3l_err, k3l_pairs, _ = check_k3(k3_in, scfg.icp, True, name)

    k2_ms = time_ms(lambda: pair_nn(*k2_in), 20)
    k2_plain_ms = time_ms(lambda: pair_nn_plain(*k2_in), 5)
    k1_ms = time_ms(lambda: superblock_fine(*k1_args), 5)
    k1_plain_ms = time_ms(lambda: superblock_fine_plain(*k1_args), 2)
    k3_ms = time_ms(lambda: _fused_core(*k3_in, scfg.icp, False), 10)
    k3_plain_ms = time_ms(lambda: _fused_core_plain(*k3_in, scfg.icp, False), 3)
    k3l_ms = time_ms(lambda: _fused_core(*k3_in, scfg.icp, True), 10)
    k3l_plain_ms = time_ms(lambda: _fused_core_plain(*k3_in, scfg.icp, True), 3)
    print(f"K1 {k1_ms:.3f} ms/superblock (plain {k1_plain_ms:.3f}); K2 {k2_ms:.3f} ms/call "
          f"(plain {k2_plain_ms:.3f}); K3 fresh {k3_ms:.3f} ms/ICP (plain {k3_plain_ms:.3f}), "
          f"lazy {k3l_ms:.3f} (plain {k3l_plain_ms:.3f}) [{tag}]", flush=True)

    # least times from this run's inputs: the tile pairs the data made the
    # kernels visit, 8 FLOP a distance, each input read and output written once
    TM1, TN1 = blk.src_pages.shape[-1], pro.cached_target.pages.shape[-1]
    k1_bound = bound(
        k1_pairs * TM1 * TN1 * FLOP_PER_DISTANCE,
        nbytes(*[a for a in k1_args if isinstance(a, torch.Tensor)])
        + nbytes(*superblock_fine(*k1_args)),
    )
    TM2, TN2 = k2_in[0].shape[-1], k2_in[1].shape[-1]
    k2_bound = bound(
        int(k2_in[3].sum()) * TM2 * TN2 * FLOP_PER_DISTANCE,
        nbytes(*k2_in) + nbytes(*pair_nn(*k2_in)),
    )
    TM3, TN3 = k3_in[0].shape[-1], k3_in[1].shape[-1]
    k3_bytes = nbytes(*k3_in) + nbytes(*_fused_core(*k3_in, scfg.icp, False))
    k3_bound = bound(k3_pairs * TM3 * TN3 * FLOP_PER_DISTANCE, k3_bytes)
    k3l_bound = bound(k3l_pairs * TM3 * TN3 * FLOP_PER_DISTANCE, k3_bytes)
    print(f"bounds: K1 {k1_bound[0]:.4f} ms ({k1_bound[1]}), K2 {k2_bound[0]:.4f} ms "
          f"({k2_bound[1]}), K3 fresh {k3_bound[0]:.4f} ms ({k3_bound[1]}), K3 lazy "
          f"{k3l_bound[0]:.4f} ms ({k3l_bound[1]}) [{tag}]", flush=True)
    print(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)

    launches = {k: {} for k in kernels}

    def record(path: str) -> None:
        for k in kernels:
            launches[k][path] = k.launches

    # ---- 3. the main path ----
    t0 = time.perf_counter()
    zero_counts(*kernels)
    loc = lz.Localizer(map_data, config, dev)
    gps_T = loc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    state, cscan, coarse = startup(loc, seq, gps_T, config, dev)
    if not bool(coarse.success):
        fail("coarse alignment failed")
    bf_map, bf_scan = lz.brute_force_clouds(cscan, state.cropped_map, state.map_T_ref, config)
    T0 = rescue_start(coarse.map_T_sensor)
    res = icp_align(bf_scan.points, bf_scan.mask, bf_map.points, bf_map.mask, T0, config.rescue_icp)
    if not bool(res.has_converged):
        fail("forced rescue ICP did not converge")
    moved = torch.linalg.norm(res.transformation[:3, 3] - coarse.map_T_sensor[:3, 3]).item()
    print(f"coarse: success={bool(coarse.success)} score={float(coarse.score):.4f}; forced rescue: "
          f"converged, {int(res.iterations)} iterations, error {float(res.error):.4f} m, "
          f"{moved:.3f} m from the coarse pose", flush=True)
    t_start_path = time.perf_counter() - t0
    frames = pf.build_paged_frames(
        config, seq.scans[1:N_FRAMES], seq.odom_T_sensor[1:N_FRAMES], gps_T[1:N_FRAMES],
        seq.odom_cov_trace[1:N_FRAMES], seq.gps_cov_trace[1:N_FRAMES], np.ones(T, bool), dev,
    )
    gt = seq.true_map_T_sensor[1:N_FRAMES]
    n_blocks = T // K
    rate = 0.0
    for p in range(2):
        before = superblock_fine.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fin, out = pf.run_chunk_fast(state, frames, loc.map_cloud, config)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launched = superblock_fine.launches - before
        est = out.map_T_sensor.cpu().numpy()
        ate = ate_rmse(est, gt)
        n_ovf = int(out.pair_overflow.sum())
        n_slack = int(out.slack_violation.sum())
        conv = out.icp_converged.float().mean().item()
        rate = T / dt
        print(f"pass {p}: {T} frames {dt:.3f} s = {rate:.1f} scans/s, ATE-RMSE {ate:.4f} m, "
              f"icp-converged {conv:.3f}, pair-overflow frames {n_ovf}, slack-violations {n_slack}, "
              f"K1 launches {launched}, pair demand mean {out.pair_demand.float().mean().item():.1f} "
              f"[{tag}]", flush=True)
        if launched != n_blocks:
            fail(f"K1 launched {launched} times for {n_blocks} superblocks")
        if n_ovf or n_slack:
            fail(f"pair overflow on {n_ovf} frames, slack violated on {n_slack}")
        if not np.isfinite(est).all():
            fail("non-finite pose")
        if not ate < ATE_LIMIT:
            fail(f"ATE-RMSE {ate} >= {ATE_LIMIT}")
    record("superblocks")
    if pair_nn.launches < 1:
        fail("K2 never launched on the main path")
    print(f"phase 3 main path: {time.perf_counter() - t0:.1f} s (startup {t_start_path:.1f} s); "
          f"launches K1 {superblock_fine.launches}, K2 {pair_nn.launches}; scans/s (pass 1) "
          f"{rate:.1f} [{tag}]", flush=True)

    # ---- 4. the online path: LocalizerSession (K3 a push), then
    # BlockLocalizerSession at K=4 (K1 a block) ----
    t0 = time.perf_counter()
    zero_counts(*kernels)
    sess = LocalizerSession(smap, scfg, profile=True, device=dev)
    first = None  # the push where the coarse ladder succeeded
    lat, split, est, gt_idx = [], [], [], []
    for i in range(SESSION_FRAMES):
        before = _fused_core.launches
        t1 = time.perf_counter()
        r = sess.push(*push_args(sseq, i))
        dt = time.perf_counter() - t1
        if first is None and sess.coarse_done:
            first = i
        if first is None:
            continue
        launched = _fused_core.launches - before
        if r.phase != "tracking" or launched != 1:
            fail(f"session push {i}: phase {r.phase}, {launched} K3 launches (expected tracking, 1)")
        if r.pair_overflow:
            fail(f"session push {i}: pair overflow")
        est.append(r.map_T_sensor)
        gt_idx.append(i)
        if i >= max(SESSION_WARMUP, first + 1):
            lat.append(dt)
            split.append(sess.last_timing)
    if first is None:
        fail("session: the coarse ladder never succeeded")
    record("session")
    s_ate = ate_rmse(np.stack(est), sseq.true_map_T_sensor[gt_idx])
    sp50 = {k: float(np.percentile([s[k] for s in split], 50)) for k in split[0]}
    print(f"LocalizerSession: {len(est)} tracking pushes from push {first}, ATE-RMSE {s_ate:.4f} m, "
          f"push p50 {percentile_ms(lat, 50):.3f} ms p99 {percentile_ms(lat, 99):.3f} ms over "
          f"{len(lat)} pushes; split p50 host {sp50['host_ms']:.3f} dispatch "
          f"{sp50['dispatch_ms']:.3f} device {sp50['device_ms']:.3f} ms; K3 launches "
          f"{_fused_core.launches}, K2 {pair_nn.launches} [{tag}]", flush=True)
    if not s_ate < ATE_LIMIT:
        fail(f"session ATE-RMSE {s_ate} >= {ATE_LIMIT}")

    zero_counts(*kernels)
    mcfg = dataclasses.replace(
        scfg, block_kernel=True, superblock_parity=True, superstep=4,
        icp=dataclasses.replace(scfg.icp, mode="parity"),
    )
    msess = BlockLocalizerSession(smap, mcfg, profile=True, device=dev)
    blat, bsplit, best, bgt = [], [], [], []
    t_block0 = None
    n_flush = 0
    for i in range(SESSION_FRAMES):
        tracking = msess.coarse_done
        if tracking and t_block0 is None:
            t_block0 = time.perf_counter()
        outs = msess.push(*push_args(sseq, i))
        if not tracking:
            continue
        if outs:
            n_flush += 1
            if n_flush > 1:  # the first block warms up
                blat.append(time.perf_counter() - t_block0)
                bsplit.append(msess.last_timing)
            t_block0 = None
            for k, r in enumerate(outs):
                if r.phase != "tracking" or r.pair_overflow:
                    fail(f"block session frame {i - len(outs) + 1 + k}: phase {r.phase}, "
                         f"overflow {r.pair_overflow}")
                best.append(r.map_T_sensor)
                bgt.append(i - len(outs) + 1 + k)
    record("block_session")
    b_ate = ate_rmse(np.stack(best), sseq.true_map_T_sensor[bgt])
    bp50 = {k: float(np.percentile([s[k] for s in bsplit], 50)) for k in bsplit[0]}
    print(f"BlockLocalizerSession K=4: {n_flush} blocks, ATE-RMSE {b_ate:.4f} m, block p50 "
          f"{percentile_ms(blat, 50):.3f} ms p99 {percentile_ms(blat, 99):.3f} ms over {len(blat)} "
          f"blocks; split p50 host {bp50['host_ms']:.3f} dispatch {bp50['dispatch_ms']:.3f} device "
          f"{bp50['device_ms']:.3f} ms; K1 launches {superblock_fine.launches} [{tag}]", flush=True)
    if superblock_fine.launches != n_flush:
        fail(f"K1 launched {superblock_fine.launches} times for {n_flush} blocks")
    if not b_ate < ATE_LIMIT:
        fail(f"block session ATE-RMSE {b_ate} >= {ATE_LIMIT}")
    print(f"phase 4 online path: {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)

    # ---- 5. the replay entry point: Localizer.run, per-frame parity (K2)
    # and fast mode's per-frame superblock branch (K3) ----
    t0 = time.perf_counter()
    n = REPLAY_FRAMES
    run_args = (sseq.scans[:n], sseq.odom_T_sensor[:n], sseq.gps_lat[:n], sseq.gps_lon[:n],
                sseq.gps_alt[:n], sseq.compass_yaw[:n], sseq.odom_cov_trace[:n],
                sseq.gps_cov_trace[:n])
    engines = {
        "replay_parity": (dataclasses.replace(
            scfg, icp=dataclasses.replace(scfg.icp, mode="parity")), pair_nn),
        "replay_fast": (scfg, _fused_core),
    }
    for path, (cfg, kernel) in engines.items():
        zero_counts(*kernels)
        t1 = time.perf_counter()
        rr = lz.Localizer(smap, cfg, dev).run(*run_args)
        dt = time.perf_counter() - t1
        record(path)
        ok = rr.valid
        r_ate = ate_rmse(rr.map_T_sensor[ok], sseq.true_map_T_sensor[:n][ok])
        print(f"Localizer.run {path}: {int(ok.sum())} valid frames from frame "
              f"{rr.first_processed_frame}, ATE-RMSE {r_ate:.4f} m, {dt:.2f} s; launches K1 "
              f"{superblock_fine.launches}, K2 {pair_nn.launches}, K3 {_fused_core.launches} "
              f"[{tag}]", flush=True)
        if kernel.launches < 1:
            fail(f"Localizer.run {path}: its kernel never launched")
        if ok.sum() < n - 2 or not np.isfinite(rr.map_T_sensor).all():
            fail(f"Localizer.run {path}: {int(ok.sum())} valid frames of {n}")
        if not r_ate < ATE_LIMIT:
            fail(f"Localizer.run {path}: ATE-RMSE {r_ate} >= {ATE_LIMIT}")
    print(f"phase 5 replay: {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s [{tag}]", flush=True)

    def row(kernel, label, source, replaces, err, ms, plain_ms, bnd):
        by_path = {p: c for p, c in launches[kernel].items() if c}
        return {"name": label, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    print(json.dumps({"kernels": [
        row(superblock_fine, "K1 superblock_fine",
            "slam_sensor_fusion_tpu_torch/csrc/superblock_fused.cu",
            "slam_sensor_fusion_tpu/ops/superblock_fused.py:105",
            k1_err, k1_ms, k1_plain_ms, k1_bound),
        row(pair_nn, "K2 pair_nn", "slam_sensor_fusion_tpu_torch/csrc/nn_pallas.cu",
            "slam_sensor_fusion_tpu/ops/nn_pallas.py:105", k2_err, k2_ms, k2_plain_ms, k2_bound),
        row(_fused_core, "K3 icp_fused", "slam_sensor_fusion_tpu_torch/csrc/icp_fused.cu",
            "slam_sensor_fusion_tpu/ops/icp_fused.py:131", max(k3_err, k3l_err), k3_ms,
            k3_plain_ms, k3_bound),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

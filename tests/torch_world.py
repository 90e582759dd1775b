"""The small synthetic world and slice configuration of the PyTorch port's
tests, importing nothing of JAX, so the tests of the CUDA kernels
(tests/test_torch_cuda.py) also run where JAX is not installed."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu_torch.examples_selftest import selftest_world
from slam_sensor_fusion_tpu_torch.models import localization as tl
from slam_sensor_fusion_tpu_torch.models import pipeline_fast as tpf
from slam_sensor_fusion_tpu_torch.models.mapping import build_map_data
from slam_sensor_fusion_tpu_torch.ops import icp_fused as tif
from slam_sensor_fusion_tpu_torch.ops.morton import sort_points_numpy, tile_bboxes
from slam_sensor_fusion_tpu_torch.ops.nn_gated import pair_tiles
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import _build_tile_pair_list, make_pages
from slam_sensor_fusion_tpu_torch.utils.config import (
    BruteForceConfig,
    CloudCapacity,
    ICPConfig,
    LocalizationConfig,
)

#: the slice's configuration at test size (tests/test_pipeline.py's
#: TEST_CONFIG, run as bench.py bench_loc runs it: parity ICP through the
#: superblock kernel, superstep 8); 8 source tiles of 256 (K1 takes up to
#: 8) and 32 target tiles of 512
SLICE_CONFIG = LocalizationConfig(
    capacity=CloudCapacity(
        scan=2048, cropped_scan=2048, cropped_map=16384, map=1 << 17,
        bf_source=512, bf_target=4096,
    ),
    brute_force=BruteForceConfig(
        x_step=0.2, y_step=0.2, z_step=0.1, x_range=0.8, y_range=0.8, z_range=0.2,
        yaw_step=np.pi / 18, yaw_range=np.pi / 9, mean_error_threshold=0.1,
    ),
    map_subsample_step=1,
    brute_force_map_subsample_step=3,
    scan_subsample_step=4,
    superblock_parity=True,
    block_kernel=True,
    superstep=8,
)


def build_world(n_frames: int, seed: int):
    """tests/test_pipeline.py's build_world_and_sequence, from the port's
    copy of the generator (the same arrays, tests/test_torch_host.py): the
    selftest's world (examples_selftest.selftest_world) and its map."""
    seq, tiles, odom_pos, gps_rows = selftest_world(n_frames, seed)
    return seq, build_map_data(tiles, odom_pos, gps_rows)


@pytest.fixture
def cuda_device():
    """The card, for tests of the CUDA kernels; they have no CPU mode, so
    without a card the test skips (chip_smoke.py checks them on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def mode_config(mode):
    """SLICE_CONFIG with ICP in `mode` ("parity": lazy, "fast": fresh)."""
    return dataclasses.replace(SLICE_CONFIG, icp=dataclasses.replace(SLICE_CONFIG.icp, mode=mode))


def superblock_args(mode, device="cpu", invalid=(3,), src_tiles=None, ties=False,
                    queue_size=None):
    """One superblock's K1 inputs from the port's prologue: the first 8
    frames after the GPS start, the frames in `invalid` invalid.
    `src_tiles` = (nSt, TM) re-tiles the cropped scan (nSt * TM points);
    `ties` copies each even target row over the odd row after it, so every
    tile minimum is an exact tie of two rows. `queue_size` sets the
    stochastic filter's queue and enters the block with it two poses short
    of full, every slot holding one GPS step, so the block fills it and
    then runs the z-score gate on a full queue."""
    seq, map_data = build_world(n_frames=9, seed=2)
    cfg = mode_config(mode)
    if queue_size is not None:
        cfg = dataclasses.replace(
            cfg, filter=dataclasses.replace(cfg.filter, queue_size=queue_size))
    if src_tiles is not None:
        n_tiles, tile_src = src_tiles
        cfg = dataclasses.replace(
            cfg,
            capacity=dataclasses.replace(cfg.capacity, cropped_scan=n_tiles * tile_src),
            icp=dataclasses.replace(cfg.icp, tile_src=tile_src),
        )
    loc = tl.Localizer(map_data, cfg, device)
    gps_T = loc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    state = tl.init_state(
        cfg, loc.map_cloud.capacity, torch.from_numpy(gps_T[0]).to(device),
        torch.from_numpy(seq.odom_T_sensor[0]).to(device),
    )
    valid = np.ones(8, bool)
    valid[list(invalid)] = False
    blk = tpf.build_paged_frames(
        cfg, seq.scans[1:], seq.odom_T_sensor[1:], gps_T[1:],
        seq.odom_cov_trace[1:], seq.gps_cov_trace[1:], valid, device,
    )
    pro = tpf.superstep_prologue(state, blk, loc.map_cloud, cfg)
    fs = state.filter_state
    if queue_size is not None:
        step = np.linalg.inv(gps_T[0].astype(np.float64)) @ gps_T[1]
        fs = fs._replace(
            transitions=torch.from_numpy(np.tile(step.astype(np.float32), (queue_size, 1, 1)))
            .to(device),
            count=torch.tensor(queue_size - 2, dtype=torch.int32, device=device),
            previous_pose=state.map_T_sensor,
        )
    tgt_pages = pro.cached_target.pages
    if ties:
        tgt_pages = tgt_pages.clone()
        tgt_pages[..., 1::2] = tgt_pages[..., 0::2]
    return cfg, (
        blk.src_pages, pro.pair_start, pro.pair_cnt, pro.pair_tgt, blk.valid,
        blk.odom_T_sensor, blk.map_T_sensor_gps, blk.odom_cov_trace,
        blk.gps_cov_trace, state.map_T_sensor, state.odom_T_sensor_previous,
        fs.transitions, fs.count, fs.previous_pose, pro.cached_target.center,
        tgt_pages,
    )


#: the card tests' K1 scenes (superblock_args keywords): the parity and
#: fast superblocks with frame 3 invalid, the first and last frames
#: invalid, an odd tiling (3 source tiles of 224: not a power of two) and
#: every tile minimum an exact tie
K1_SCENES = {
    "parity": dict(mode="parity"),
    "fast": dict(mode="fast"),
    "invalid_ends": dict(mode="parity", invalid=(0, 7)),
    "odd": dict(mode="fast", src_tiles=(3, 224)),
    "ties": dict(mode="parity", ties=True),
}


#: K1 scenes past the kernel's register layout (up to 8 source tiles of
#: at most 1024 rows), the same world re-tiled: 16 source tiles of 128, 64
#: tiles of one warp (32 rows; a round then holds far more items than the
#: grid has workers) and one tile of 2048 rows
K1_WIDE_SCENES = {
    "16x128": dict(mode="parity", src_tiles=(16, 128)),
    "64x32": dict(mode="fast", src_tiles=(64, 32)),
    "1x2048": dict(mode="parity", src_tiles=(1, 2048)),
}


def k1_digest(device, global_layout: bool = False) -> str:
    """SHA-256 of `superblock_fine`'s outputs on the K1_SCENES: a kernel
    that rounds one bit differently, or takes another tile on a tie,
    changes it. `global_layout` runs the kernel with its leader's points
    in the global buffer (the layout of more or wider source tiles)."""
    import hashlib

    from slam_sensor_fusion_tpu_torch.ops import superblock_fused as tsf

    h = hashlib.sha256()
    for scene in K1_SCENES.values():
        cfg, args = superblock_args(device=device, **scene)
        if global_layout:
            out = tsf._superblock_fine(*args, cfg, global_layout=True)
        else:
            out = tsf.superblock_fine(*args, cfg)
        for x in out:
            h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


#: K2's card scenes: (exact ties, source tiles, rows a source tile) against
#: 16 target tiles of 512: the rescue's tiles, and tiles wider than a block
#: (the stress configuration's 4096 rows)
K2_CASES = {"False": (False, 4, 256), "True": (True, 4, 256), "2x2048": (False, 2, 2048),
            "1x4096-ties": (True, 1, 4096)}


def k2_case(seed, ties, device, n_tiles=4, TM=256, masked=False):
    """K2's inputs as the rescue ICP builds them (both page sets at the +1e7
    sentinel): `n_tiles` source tiles of TM rows near 16 target tiles of
    512, Morton-sorted; `ties` duplicates every 7th target point, `masked`
    drops every 8th source and every 9th target point to the sentinel."""
    rng = np.random.default_rng(seed)
    TN = 512
    tgt = rng.uniform(-8, 8, (16 * TN, 3)).astype(np.float32)
    if ties:
        tgt[1::7] = tgt[0::7][: len(tgt[1::7])]
    tgt = sort_points_numpy(tgt)
    src = tgt[rng.choice(len(tgt), n_tiles * TM, replace=False)]
    src = sort_points_numpy(src + rng.normal(0, 0.05, src.shape).astype(np.float32))
    s, tg = torch.from_numpy(src).to(device), torch.from_numpy(tgt).to(device)
    sm = torch.ones(len(src), dtype=torch.bool, device=device)
    tm = torch.ones(len(tgt), dtype=torch.bool, device=device)
    if masked:
        sm[::8] = False
        tm[::9] = False
    r2 = (math.sqrt(5.0) + 0.5) ** 2
    lo_t, hi_t, _ = tile_bboxes(tg, tm, TN)
    lo_s, hi_s, cnt_s = tile_bboxes(s, sm, TM)
    visits, counts, _ = pair_tiles(lo_s, hi_s, cnt_s, lo_t, hi_t, r2, 64)
    center = s.mean(0)
    return (make_pages(s, sm, center, TM), make_pages(tg, tm, center, TN),
            *_build_tile_pair_list(visits, counts, 4 * 32))


def k2_empty_tile_case(device):
    """The rescue's tiles with sentinel rows on both sides and source tile 1
    given no admitted target tile."""
    args = list(k2_case(1, True, device, masked=True))
    args[3] = args[3].clone()
    args[3][1] = 0  # pair_cnt
    return args


def k2_digest(device) -> str:
    """SHA-256 of `pair_nn`'s outputs (d2, idx, xyz) on the K2_CASES and the
    empty-tile case."""
    import hashlib

    from slam_sensor_fusion_tpu_torch.ops.nn_pallas import pair_nn

    h = hashlib.sha256()
    cases = [k2_case(0, ties, device, n_tiles, TM) for ties, n_tiles, TM in K2_CASES.values()]
    cases.append(k2_empty_tile_case(device))
    for args in cases:
        for x in pair_nn(*args):
            h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def compare_superblock(a, b, valid):
    """a, b: superblock_fine 9-tuples as NumPy arrays."""
    for i, name in [(0, "poses"), (1, "priors"), (2, "odom_preds"), (4, "pose"),
                    (5, "odom_prev"), (6, "filt_trans"), (8, "filt_prev")]:
        np.testing.assert_allclose(b[i], a[i], rtol=0, atol=3e-4, err_msg=name)
    for col, name in [(1, "iterations"), (2, "n_corr"), (3, "converged")]:
        np.testing.assert_array_equal(b[3][:, col], a[3][:, col], err_msg=name)
    np.testing.assert_allclose(b[3][:, 0], a[3][:, 0], rtol=0, atol=1e-3)  # error
    assert int(b[7]) == int(a[7])
    assert (a[3][valid, 2] > 100).all()  # real correspondence sets
    assert (a[3][~valid] == 0).all() and (a[1][~valid] == 0).all()


def port_slice(seq, map_data, device="cpu"):
    """The port's main path on `device`: Localizer -> init_state ->
    coarse_attempt on frame 1 -> build_paged_frames -> run_chunk_fast over
    frames 1.. (bench.py bench_loc's order). Returns (coarse, final, out)."""
    cfg = SLICE_CONFIG
    loc = tl.Localizer(map_data, cfg, device)
    gps_T = loc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    state = tl.init_state(cfg, loc.map_cloud.capacity, f32(gps_T[0]), f32(seq.odom_T_sensor[0]))
    fb = tl.build_frame_batch(cfg, [seq.scans[1]], seq.odom_T_sensor[1:2], gps_T[1:2],
                              seq.odom_cov_trace[1:2], seq.gps_cov_trace[1:2], np.ones(1, bool), device)
    cm, ct, ref, _, coarse = tl.coarse_attempt(
        state, fb.scan_points[0], fb.scan_mask[0], loc.map_cloud, f32(gps_T[0]), cfg
    )
    state = state._replace(map_T_sensor=coarse.map_T_sensor, cropped_map=cm, cached_target=ct, map_T_ref=ref)
    T = len(seq.scans) - 1
    frames = tpf.build_paged_frames(cfg, seq.scans[1:], seq.odom_T_sensor[1:], gps_T[1:],
                                    seq.odom_cov_trace[1:], seq.gps_cov_trace[1:], np.ones(T, bool), device)
    final, out = tpf.run_chunk_fast(state, frames, loc.map_cloud, cfg)
    return coarse, final, out


#: K3's test configuration: the default ICP with a tighter acceptable error,
#: so ICP takes several steps and the lazy variant hits its plateau
#: re-association
K3_CONFIG = ICPConfig(acceptable_mean_error=0.012, tile_src=256, tile_tgt=512)


def k3_scene(seed, n_src=1000, M=1024, N=4096):
    """A Morton-sorted target (two walls, a floor and a pole in 12 m) and a
    noisy source seen from a perturbed pose, both padded; returns (src,
    src_mask, tgt, tgt_mask, T0) as NumPy arrays."""
    rng = np.random.default_rng(seed)
    n = N - 96
    q = n // 4
    walls = [
        np.stack([rng.uniform(-6, 6, q), np.full(q, 4.0), rng.uniform(0, 3, q)], 1),
        np.stack([np.full(q, -5.0), rng.uniform(-6, 4, q), rng.uniform(0, 3, q)], 1),
        np.stack([rng.uniform(-6, 6, q), rng.uniform(-6, 4, q), np.zeros(q)], 1),
        np.stack([np.cos(np.linspace(0, 20, q)) * 0.2 + 2.0,
                  np.sin(np.linspace(0, 20, q)) * 0.2 - 1.0, rng.uniform(0, 3, q)], 1),
    ]
    tgt = sort_points_numpy(np.concatenate(walls).astype(np.float32))
    ang = rng.normal(0, 0.03, 3)
    c, s = np.cos(ang[2]), np.sin(ang[2])
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [0.25, -0.2, 0.05]
    pick = tgt[rng.choice(len(tgt), n_src, replace=n_src > len(tgt))]
    src = (pick - T[:3, 3]) @ T[:3, :3] + rng.normal(0, 0.01, pick.shape)
    src = sort_points_numpy(src.astype(np.float32))
    sbuf = np.zeros((M, 3), np.float32)
    sbuf[:n_src] = src
    tbuf = np.zeros((N, 3), np.float32)
    tbuf[: len(tgt)] = tgt
    return sbuf, np.arange(M) < n_src, tbuf, np.arange(N) < len(tgt), np.eye(4, dtype=np.float32)


def k3_inputs(cfg, scene, device="cpu"):
    """K3's arguments for `scene` (k3_scene), as `icp_align_fused` builds
    them: (src_pages, tgt_pages, pair_start, pair_cnt, pair_tgt,
    T0_rebased)."""
    src, smask, tgt, tmask, T0 = (torch.from_numpy(a).to(device) for a in scene)
    return tif.fused_inputs(src, smask, tgt, tmask, T0, cfg)[0]


#: the card tests' K3 scenes (k3_case keywords): the online session's
#: source shape (8 tiles of 512) and the default scan capacity's (128
#: tiles of 256) against 32 target tiles of 512, every tile minimum an
#: exact tie of two rows, and one source tile with an empty pair list
K3_SCENES = {
    "session": dict(n_tiles=8, tile_src=512),
    "default_scan": dict(n_tiles=128, tile_src=256),
    "ties": dict(n_tiles=8, tile_src=512, ties=True),
    "empty_tile": dict(n_tiles=8, tile_src=512, empty_tile=3),
}


def k3_case(device, n_tiles, tile_src, ties=False, empty_tile=None):
    """(K3_CONFIG at `tile_src`, K3's arguments) for k3_scene(1) with
    n_tiles x tile_src source points (100 of them padding) against 16384
    target points. `ties` copies each even target row over the odd row
    after it; `empty_tile` empties that source tile's pair list."""
    cfg = dataclasses.replace(K3_CONFIG, tile_src=tile_src)
    M = n_tiles * tile_src
    args = list(k3_inputs(cfg, k3_scene(1, n_src=M - 100, M=M, N=16384), device))
    if ties:
        args[1] = args[1].clone()
        args[1][..., 1::2] = args[1][..., 0::2]
    if empty_tile is not None:
        args[3] = args[3].clone()
        args[3][empty_tile] = 0
    return cfg, args


def k3_digest(device) -> str:
    """SHA-256 of `_fused_core`'s outputs (T_out and stats), fresh and lazy,
    on the K3_SCENES."""
    import hashlib

    h = hashlib.sha256()
    for scene in K3_SCENES.values():
        cfg, args = k3_case(device, **scene)
        for lazy in (False, True):
            for x in tif._fused_core(*args, cfg, lazy):
                h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()

"""The PyTorch port's CUDA kernels against their plain PyTorch versions on
the card. Every test here needs an NVIDIA GPU and nvcc and skips without
one; nothing here imports JAX, so on a GPU host without JAX run them as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

K2 must agree with its plain version exactly (same fused dot products,
same first-min rule), at tiles of up to 4096 rows as well; K1 and K3 to
3e-4 on poses and state, 1e-3 on the
ICP error, with EQUAL iteration and correspondence counts (the moment sums
are reduced in another order). K4 and K6 agree to 3e-4 on T and 1e-4
relative on rmse, wr2 and the JtJ lanes with EQUAL n_correspondences; K5's
d2 to 1e-6 relative with EQUAL matched pages (also with 32 slots on one
source tile and a target tile of sentinels only). The map-sharded
registration (`sp_p2p_align`, K5 a shard and K6 once) equals K4 with fixed
correspondences on the whole map: EQUAL n_correspondences, T to 1e-4 (the
JAX package's test of it). K4, K5 and K6 give the same
bits as before their device functions moved into csrc/p2p_fused.cuh, and
K1, K3, K4 and K7 as cooperative grids, K5 as a scan over the card and a
combine, and K6 as a thread-block cluster the same bits as their one-block
predecessors, and K2 with its scan spread over the card the same bits as
its kernel of one block a source tile (SHA-256 digests of their outputs),
and K1 with its leader's points in a global buffer the same bits as with
them in registers. K7 to 3e-4 on poses and state, 1e-4 of max|P| on P,
1e-4 relative on the stats lanes with EQUAL n_correspondences, GPS
acceptance and slack flags. The voxel stores' segment sum equals its plain
version bit for bit, and the sorted and hash stores on the card equal each
other and their CPU runs bit for bit. K1 takes a filter queue of any size
(12 here) to the same bounds, with its digest at the default 4 unchanged.
Map-sharded ICP at 4 shards on the card has the CPU run's counts and T to
1e-4. The LIO cell normals' prefix sum in XLA's order (cumsum_rows) equals
its plain version bit for bit, and the cell normals on the card the CPU's
to 1e-5 with equal valid masks. The voxel normals' moments (the segment
sum over each cell's rows) equal the CPU's bit for bit and from run to
run; K2 at the LIO's 512 / 1024-row tiles equals its plain version."""

import dataclasses

import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu_torch.ops import lio_superblock_fused as tsb
from slam_sensor_fusion_tpu_torch.ops import nn_pallas as tnn
from slam_sensor_fusion_tpu_torch.ops import p2p_fused as tpf
from slam_sensor_fusion_tpu_torch.ops.icp_fused import _fused_core, _fused_core_plain
from slam_sensor_fusion_tpu_torch.ops.point_to_plane import PointToPlaneConfig
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import pair_nn, pair_nn_plain
from slam_sensor_fusion_tpu_torch.parallel import map_shard as tms
from slam_sensor_fusion_tpu_torch.ops.superblock_fused import (
    superblock_fine,
    superblock_fine_plain,
)
from torch_lio_world import (
    K7_DIGEST,
    K7_SHAPES,
    K7_WIDE,
    ODD_LIO,
    P2P_DIGEST,
    XLA_MATH_CASES,
    ground_and_walls,
    k7_case,
    k7_digest,
    p2p_core_inputs,
    p2p_digest,
    p2p_scene,
    xla_math_cases,
)
from torch_world import (  # noqa: F401
    K1_SCENES,
    K1_WIDE_SCENES,
    K2_CASES,
    K3_CONFIG,
    build_world,
    compare_superblock,
    cuda_device,
    k1_digest,
    k2_case,
    k2_digest,
    k2_empty_tile_case,
    k3_digest,
    k3_inputs,
    k3_scene,
    port_slice,
    superblock_args,
)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("ties, n_tiles, tile_src", list(K2_CASES.values()), ids=list(K2_CASES))
def test_pair_nn_kernel_matches_plain(cuda_device, ties, n_tiles, tile_src):
    """The rescue's tiles, and tiles wider than a block (the stress
    configuration's 4096 rows)."""
    args = k2_case(0, ties, cuda_device, n_tiles, tile_src)
    before = pair_nn.launches
    d2k, idxk, xyzk = pair_nn(*args)
    d2p, idxp, xyzp = pair_nn_plain(*args)
    torch.cuda.synchronize()
    assert pair_nn.launches == before + 1
    torch.testing.assert_close(d2k, d2p, rtol=1e-5, atol=1e-6)
    assert torch.equal(idxk, idxp)
    assert torch.equal(xyzk, xyzp)


def test_pair_nn_empty_source_tile(cuda_device):
    """A source tile with no admitted target tile, among sentinel rows:
    d2 3e38, idx 0 and xyz 0 there, as the plain version."""
    args = k2_empty_tile_case(cuda_device)
    got = pair_nn(*args)
    want = pair_nn_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    d2, idx, xyz = got
    assert (d2[1] == 3.0e38).all() and (idx[1] == 0).all() and (xyz[1] == 0).all()
    assert (d2[0] < 3.0e38).any()


#: `k2_digest` of K2 as the kernel of one block a source tile computed it,
#: before its scan spread over the card (NVIDIA H100 80GB HBM3)
K2_DIGEST = "aeb056bf45518aff97d6aea1cd2b86e76ce01f93a1123430940768f0bce77c5e"


def test_pair_nn_bits_equal_the_per_tile_kernel(cuda_device):
    assert k2_digest(cuda_device) == K2_DIGEST


@pytest.mark.parametrize("scene", list(K1_SCENES) + list(K1_WIDE_SCENES))
def test_superblock_kernel_matches_plain(cuda_device, scene):
    """K1 on the parity and fast superblocks, with the first and last
    frames invalid, on 3 source tiles of 224 points, with every tile
    minimum an exact tie, and past its register layout: 16 source tiles of
    128, 64 of 32 and one of 2048."""
    cfg, args = superblock_args(device=cuda_device, **{**K1_SCENES, **K1_WIDE_SCENES}[scene])
    before = superblock_fine.launches
    got = superblock_fine(*args, cfg)
    want = superblock_fine_plain(*args, cfg)
    torch.cuda.synchronize()
    assert superblock_fine.launches == before + 1
    compare_superblock([x.cpu().numpy() for x in want], [x.cpu().numpy() for x in got],
                       args[4].cpu().numpy())


def test_superblock_kernel_takes_any_queue_size(cuda_device):
    """K1 with a 12-pose filter queue (past the 8 its parameter block once
    held), entered two poses short of full: the queue fills inside the
    block and the z-score gate runs on it, against the plain version."""
    cfg, args = superblock_args("parity", device=cuda_device, queue_size=12)
    got = superblock_fine(*args, cfg)
    want = superblock_fine_plain(*args, cfg)
    torch.cuda.synchronize()
    assert got[6].shape == (12, 4, 4) and int(got[7]) == int(want[7]) == 12
    compare_superblock([x.cpu().numpy() for x in want], [x.cpu().numpy() for x in got],
                       args[4].cpu().numpy())


#: `k1_digest` of K1 as the one-block kernel computed it, before the
#: association spread over a cooperative grid (NVIDIA H100 80GB HBM3)
K1_DIGEST = "8362c701d0d5e1daa1716db74923e3cd45f9540181d0cddd3fe28d112a7fa74c"


def test_superblock_kernel_bits_equal_the_one_block_kernel(cuda_device):
    assert k1_digest(cuda_device) == K1_DIGEST


def test_superblock_global_layout_bits_equal_the_register_layout(cuda_device):
    """K1 with its leader's points in the global buffer (its layout past 8
    source tiles or 1024 rows) on the K1_SCENES: the register layout's
    bits."""
    assert k1_digest(cuda_device, global_layout=True) == K1_DIGEST


def test_grid_kernels_span_the_card(cuda_device):
    """K1, K3 and K4 launch one block on every multiprocessor at the main
    paths' tiles, and K1 and K3 at the JAX package's default and stress
    tiles."""
    from slam_sensor_fusion_tpu_torch.ops import icp_fused as tif
    from slam_sensor_fusion_tpu_torch.ops import superblock_fused as tsf

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    grids = [
        (tsf.kernel_grid(4, 1024, 512), 1024), (tsf.kernel_grid(64, 256, 512), 1024),
        (tsf.kernel_grid(16, 4096, 128), 1024), (tpf.kernel_grid(16, 512), 1024),
        (tif.kernel_grid(8, 512), 1024), (tif.kernel_grid(128, 256), 1024),
        (tif.kernel_grid(4, 4096), 1024),
    ]
    for grid, threads in grids:
        assert grid["blocks"] == sms and grid["threads"] == threads and grid["per_sm"] >= 1


def test_k7_and_k2_grids_span_the_card(cuda_device):
    """K7 launches one block on every multiprocessor at the LIO bench's
    block tiles (4 x 512) and the odd test shape's (4 x 96); K2's scan at
    least one block on each at the rescue's tiles and the stress
    configuration's (16 x 4096 with 16 slots a tile)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for grid, threads in [(tsb.kernel_grid(4, 512), 1024), (tsb.kernel_grid(4, 96), 384)]:
        assert grid["blocks"] == sms and grid["threads"] == threads and grid["per_sm"] >= 1
    for tile_src, max_pairs in [(256, 128), (4096, 256)]:
        grid = tnn.kernel_grid(tile_src, max_pairs)
        assert grid["blocks"] >= sms and grid["per_sm"] >= 1, grid


def test_slice_on_card_matches_cpu(cuda_device):
    """The slice on the card (K1, and the prologue on the GPU) against the
    same slice on the CPU (K1's plain version): two superblocks."""
    seq, map_data = build_world(n_frames=17, seed=3)
    _, _, out_c = port_slice(seq, map_data)
    before = superblock_fine.launches
    _, _, out_g = port_slice(seq, map_data, cuda_device)
    assert superblock_fine.launches - before == 2
    torch.testing.assert_close(out_g.map_T_sensor.cpu(), out_c.map_T_sensor, rtol=0, atol=3e-4)
    for name in ("icp_iterations", "n_correspondences", "pair_overflow", "slack_violation"):
        assert torch.equal(getattr(out_g, name).cpu(), getattr(out_c, name)), name


@pytest.mark.parametrize("lazy", [False, True], ids=["fresh", "lazy"])
@pytest.mark.parametrize("n_tiles, tile_src", [(8, 512), (128, 256), (2, 2048), (1, 4096)])
def test_icp_fused_kernel_matches_plain(cuda_device, n_tiles, tile_src, lazy):
    """K3 at the online session's source shape (8 tiles of 512), at the
    default scan capacity's (128 tiles of 256) and at tiles wider than a
    block (the stress configuration's 4096 rows), against 32 target
    tiles; the wide tiles' pair lists hold every target tile."""
    cfg = dataclasses.replace(K3_CONFIG, tile_src=tile_src,
                              max_pairs_factor=max(K3_CONFIG.max_pairs_factor, 64 // n_tiles))
    M = n_tiles * tile_src
    args = k3_inputs(cfg, k3_scene(1, n_src=M - 100, M=M, N=16384), cuda_device)
    before = _fused_core.launches
    T_k, st_k = _fused_core(*args, cfg, lazy)
    T_p, st_p = _fused_core_plain(*args, cfg, lazy)
    torch.cuda.synchronize()
    assert _fused_core.launches == before + 1
    torch.testing.assert_close(T_k, T_p, rtol=0, atol=3e-4)
    assert torch.equal(st_k[0, 1:3], st_p[0, 1:3])  # iterations, n_corr
    torch.testing.assert_close(st_k[0, 0], st_p[0, 0], rtol=0, atol=1e-3)
    assert st_p[0, 1] >= 2 and st_p[0, 2] > M // 2


#: `k3_digest` of K3 as the one-block kernel computed it, before the
#: association spread over a cooperative grid (NVIDIA H100 80GB HBM3)
K3_DIGEST = "c8f08adac2e85fa22ab60ac8270546ae0aac50c72a72b2c11692a9f812edf9c0"


def test_icp_fused_kernel_bits_equal_the_one_block_kernel(cuda_device):
    assert k3_digest(cuda_device) == K3_DIGEST


#: K4-K6 at the LIO bench's tiles (16 source tiles of 512, 32 target tiles
#: of 1024), the same with no admitted target tile for source tile 5, and
#: at one small odd shape (1 source tile of 96, 3 target tiles of 150: not
#: a multiple of 4, so the association takes its scalar loads)
P2P_SHAPES = {
    "bench": dict(M=8192, N=32768, n_tgt=30000, tile_src=512, tile_tgt=1024, min_corr=3000),
    "bench_empty_tile": dict(M=8192, N=32768, n_tgt=30000, tile_src=512, tile_tgt=1024,
                             min_corr=3000, empty_tile=5),
    "odd": dict(M=96, N=450, n_tgt=400, tile_src=96, tile_tgt=150, min_corr=20),
    # past 1024 rows a tile (the leader's global layout): the bench scene's
    # 8192 source rows in 4 tiles of 2048 and in 2 tiles of 4096
    "wide2048": dict(M=8192, N=32768, n_tgt=30000, tile_src=2048, tile_tgt=1024, min_corr=3000),
    "wide4096": dict(M=8192, N=32768, n_tgt=30000, tile_src=4096, tile_tgt=1024, min_corr=3000),
}


def _p2p_case(shape, device, **cfg):
    s = P2P_SHAPES[shape]
    config = PointToPlaneConfig(
        num_iterations=2, tile_src=s["tile_src"], tile_tgt=s["tile_tgt"], max_visits=64,
        reassoc_margin=0.15, nn_backend="fused", **cfg,
    )
    scene = p2p_scene(7, n_tgt=s["n_tgt"], M=s["M"], N=s["N"], ties=True)
    core = p2p_core_inputs(scene, config, device)
    if "empty_tile" in s:  # its points match nothing
        core = list(core)
        core[3] = core[3].clone()
        core[3][s["empty_tile"]] = 0  # pair_cnt
    return config, core


def _assert_gn_outputs(got, want, min_corr):
    (T_k, st_k), (T_p, st_p) = got, want
    torch.testing.assert_close(T_k, T_p, rtol=0, atol=3e-4)
    assert torch.equal(st_k[0, 1:3], st_p[0, 1:3])  # n_correspondences, iterations
    torch.testing.assert_close(st_k[0, 0], st_p[0, 0], rtol=1e-4, atol=1e-7)
    scale = st_p[0, 3:24].abs().max().item()
    torch.testing.assert_close(st_k[0, 3:25], st_p[0, 3:25], rtol=1e-4, atol=1e-4 * scale)
    assert torch.equal(st_k[0, 25:], torch.zeros_like(st_k[0, 25:]))
    assert st_p[0, 1] >= min_corr


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "fresh"])
@pytest.mark.parametrize("shape", ["bench", "bench_empty_tile", "odd", "wide2048", "wide4096"])
def test_p2p_fused_kernel_matches_plain(cuda_device, shape, fixed):
    config, core = _p2p_case(shape, cuda_device, fixed_correspondences=fixed)
    before = tpf._p2p_core.launches
    got = tpf._p2p_core(*core, config)
    want = tpf._p2p_core_plain(*core, config)
    torch.cuda.synchronize()
    assert tpf._p2p_core.launches == before + 1
    _assert_gn_outputs(got, want, P2P_SHAPES[shape]["min_corr"])


@pytest.mark.parametrize("shape", ["bench", "odd", "wide2048", "wide4096"])
def test_p2p_halves_match_plain_and_compose(cuda_device, shape):
    """K5 and K6 against their plain versions, and K6(K5(x)) against K4
    with fixed correspondences."""
    config, core = _p2p_case(shape, cuda_device, fixed_correspondences=True)
    counts = (tpf._p2p_associate.launches, tpf._p2p_gn_corr.launches)
    d2_k, qn_k = tpf._p2p_associate(*core)
    d2_p, qn_p = tpf._p2p_associate_plain(*core)
    torch.cuda.synchronize()
    torch.testing.assert_close(d2_k, d2_p, rtol=1e-6, atol=0)
    assert torch.equal(qn_k, qn_p)
    src_pages, T0 = core[0], core[5]
    got = tpf._p2p_gn_corr(T0, src_pages, d2_p, qn_p, config)
    want = tpf._p2p_gn_corr_plain(T0, src_pages, d2_p, qn_p, config)
    torch.cuda.synchronize()
    assert (tpf._p2p_associate.launches, tpf._p2p_gn_corr.launches) == (counts[0] + 1, counts[1] + 1)
    _assert_gn_outputs(got, want, 1)
    whole = tpf._p2p_core(*core, config)
    halves = tpf._p2p_gn_corr(T0, src_pages, d2_k, qn_k, config)
    for a, b in zip(whole, halves):
        assert torch.equal(a, b)


def test_p2p_empty_pair_list_returns_prior(cuda_device):
    """One source tile and no admitted target tile: the prior comes back
    and no correspondence is counted."""
    config, core = _p2p_case("odd", cuda_device, fixed_correspondences=True)
    core = list(core)
    core[3] = torch.zeros_like(core[3])  # pair_cnt
    T_out, stats = tpf._p2p_core(*core, config)
    T_p, stats_p = tpf._p2p_core_plain(*core, config)
    torch.cuda.synchronize()
    torch.testing.assert_close(T_out, core[5], rtol=0, atol=1e-6)
    torch.testing.assert_close(T_out, T_p, rtol=0, atol=1e-6)
    assert stats[0, 1] == 0 and stats_p[0, 1] == 0
    d2, qn = tpf._p2p_associate(*core)
    assert (d2 > 1e37).all() and (qn == 0).all()


def test_p2p_associate_many_slots_and_a_sentinel_tile(cuda_device):
    """K5 where source tile 0 admits every target tile (32 slots), tile 1
    only a target tile of -1e7 sentinels (its winners: that tile's first
    row, normal 0) and the other tiles their own lists."""
    from slam_sensor_fusion_tpu_torch.ops.icp_fused import TARGET_SENTINEL

    _, core = _p2p_case("bench", cuda_device, fixed_correspondences=True)
    src, tgt, ps, pc, pt, T0 = core
    nTt = tgt.shape[0]
    tgt = tgt.clone()
    tgt[nTt - 1, :3] = TARGET_SENTINEL
    tgt[nTt - 1, 3:] = 0.0
    lists = [list(range(nTt)), [nTt - 1]] + [
        pt[int(ps[i]):int(ps[i]) + int(pc[i])].tolist() for i in range(2, src.shape[0])]
    flat = [j for lst in lists for j in lst]
    cnt = torch.tensor([len(lst) for lst in lists], dtype=torch.int32, device=cuda_device)
    start = (torch.cumsum(cnt, 0) - cnt).int()
    slots = torch.tensor(flat, dtype=torch.int32, device=cuda_device)
    args = (src, tgt, start, cnt, slots, T0)
    before = tpf._p2p_associate.launches
    d2_k, qn_k = tpf._p2p_associate(*args)
    d2_p, qn_p = tpf._p2p_associate_plain(*args)
    torch.cuda.synchronize()
    assert tpf._p2p_associate.launches == before + 1
    torch.testing.assert_close(d2_k, d2_p, rtol=1e-6, atol=0)
    assert torch.equal(qn_k, qn_p)
    assert (d2_p[0] < 1.0).any()  # tile 0 found its points
    assert (qn_k[1, 3:] == 0).all() and (qn_k[1, :3] == TARGET_SENTINEL).all()


def test_p2p_halves_launch_shapes(cuda_device):
    """K5's scan fills the card at the bench's list (16 source tiles of 512,
    256 slots); K6's cluster is 8 CTAs of 4 warps there, each staging its
    points (10 floats a point, 8 tiles of 128 rows: 40 KiB), and one CTA of
    3 warps at the odd shape."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    grid = tpf.assoc_grid(512, 256)
    assert grid["blocks"] >= sms and grid["threads"] == 128, grid
    assert tpf.gn_cluster(16, 512) == {"ctas": 8, "threads": 128, "smem_bytes": 40960}
    assert tpf.gn_cluster(1, 96) == {"ctas": 1, "threads": 96, "smem_bytes": 3840}


def test_p2p_wide_tiles_launch_shapes(cuda_device):
    """Past 1024 rows a tile K4's leader and K7's are 1024 threads and K6's
    cluster 8 CTAs of 128 (each virtual thread owning several rows of a
    tile), each CTA staging its share of the matched set: 16 points of 10
    floats a thread at 4 x 4096 rows, 32 at 16 x 2048 (phase 13's 32 768
    rows a frame)."""
    assert tpf.kernel_grid(4, 4096)["threads"] == 1024
    assert tsb.kernel_grid(16, 2048)["threads"] == 1024
    assert tpf.gn_cluster(4, 4096) == {"ctas": 8, "threads": 128, "smem_bytes": 81920}
    assert tpf.gn_cluster(16, 2048) == {"ctas": 8, "threads": 128, "smem_bytes": 163840}


@pytest.mark.parametrize("wrapper", ["core", "associate", "gn_corr", "lio"])
def test_p2p_kernels_refuse_tiles_past_4096(cuda_device, wrapper):
    """K4-K7 take tiles up to 4096 rows on the card and raise past that,
    before any launch."""
    config, core = _p2p_case("odd", cuda_device)
    src = torch.zeros((1, 3, 4128), device=cuda_device)
    d2 = torch.zeros((1, 1, 4128), device=cuda_device)
    qn = torch.zeros((1, 6, 4128), device=cuda_device)
    call = {
        "core": lambda: tpf._p2p_core(src, *core[1:], config),
        "associate": lambda: tpf._p2p_associate(src, *core[1:]),
        "gn_corr": lambda: tpf._p2p_gn_corr(core[5], src, d2, qn, config),
    }
    if wrapper == "lio":
        args, params = k7_case(ODD_LIO, cuda_device, imu_rate=7)
        K = args[3].shape[0]
        wide = torch.zeros((K, 1, 3, 4128), device=cuda_device)
        call["lio"] = lambda: tsb.lio_superblock(
            args[0][:, :1].contiguous(), args[1][:, :1].contiguous(), *args[2:17], wide,
            args[18], params)
    with pytest.raises(ValueError, match="4096"):
        call[wrapper]()


@pytest.mark.parametrize("n_tiles, tile_src, cluster", [
    (3, 96, {"ctas": 1, "threads": 288, "smem_bytes": 11520}),
    (96, 512, {"ctas": 8, "threads": 128, "smem_bytes": 0}),
], ids=["wide_cta", "unstaged"])
def test_p2p_gn_corr_cluster_forms_match_plain(cuda_device, n_tiles, tile_src, cluster):
    """K6 where its CTA is wider than 256 threads (3 source tiles of 96: 9
    warps, one CTA) and where the matched set does not fit a CTA's shared
    memory and is read from global memory each pass (96 tiles of 512: 48
    points a thread, 240 KiB a CTA), on a random matched set."""
    assert tpf.gn_cluster(n_tiles, tile_src) == cluster
    rng = np.random.default_rng(4)
    shape = (n_tiles, tile_src)
    src = rng.uniform(-6.0, 6.0, (n_tiles, 3, tile_src))
    nrm = rng.normal(size=(n_tiles, 3, tile_src))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[:, :, ::7] = 0.0  # invalid normals
    q = src + 0.05 * nrm + rng.normal(0.0, 0.01, src.shape)
    d2 = rng.uniform(0.0, 1.3, shape)[:, None]  # some beyond the gate
    T0 = np.eye(4)
    T0[:3, 3] = [0.03, -0.02, 0.01]
    k6_in = [torch.tensor(a, dtype=torch.float32, device=cuda_device)
             for a in (T0, src, d2, np.concatenate([q, nrm], axis=1))]
    config = PointToPlaneConfig(num_iterations=2, tile_src=tile_src)
    before = tpf._p2p_gn_corr.launches
    got = tpf._p2p_gn_corr(*k6_in, config)
    want = tpf._p2p_gn_corr_plain(*k6_in, config)
    torch.cuda.synchronize()
    assert tpf._p2p_gn_corr.launches == before + 1
    _assert_gn_outputs(got, want, n_tiles * tile_src // 2)


def _sp_case(device, n_shards):
    """The bench scene's map (30 000 points, no exact duplicates) split into
    `n_shards` and whole, and a configuration whose pair lists hold every
    admissible tile pair in both (so both see the same winners)."""
    config = PointToPlaneConfig(
        num_iterations=2, tile_src=512, tile_tgt=1024, max_visits=64, reassoc_margin=0.15,
        nn_backend="fused", fixed_correspondences=True, max_pairs_factor=32,
    )
    src, smask, tgt, tmask, nrm, nvalid, T0 = p2p_scene(7, n_tgt=30000, M=8192, N=32768)
    n = int(tmask.sum())
    center = np.asarray([0.5, -0.3, 0.1], np.float32)
    sharded = tms.shard_p2p_target(tgt[:n], nrm[:n], nvalid[:n], n_shards, 1024, center,
                                   device=device)
    whole = tpf.build_cached_p2p_target(
        *[torch.from_numpy(a).to(device) for a in (tgt, tmask, nrm, nvalid, center)], 1024)
    return config, [torch.from_numpy(a).to(device) for a in (src, smask, T0)], sharded, whole


@pytest.mark.parametrize("n_shards", [1, 4])
def test_sp_p2p_align_matches_whole_map_k4(cuda_device, n_shards):
    config, (src, smask, T0), sharded, whole = _sp_case(cuda_device, n_shards)
    counts = (tpf._p2p_associate.launches, tpf._p2p_gn_corr.launches)
    got = tms.sp_p2p_align(src, smask, sharded, T0, config)
    torch.cuda.synchronize()
    assert (tpf._p2p_associate.launches - counts[0], tpf._p2p_gn_corr.launches - counts[1]) == (
        n_shards, 1)
    want = tpf.point_to_plane_align_fused(src, smask, whole, T0, config)
    assert int(got.n_correspondences) == int(want.n_correspondences) > 3000
    torch.testing.assert_close(got.transformation, want.transformation, rtol=0, atol=1e-4)


def test_sp_icp_align_on_the_card_matches_the_cpu(cuda_device):
    """Map-sharded ICP at 4 shards (parallel/map_shard.sp_icp_align, K2 a
    shard an association) on the card against the same run on the CPU (K2's
    plain version): EQUAL iterations, correspondence count and overflow, T
    to 1e-4."""
    from slam_sensor_fusion_tpu_torch.parallel.dryrun import registration_inputs
    from slam_sensor_fusion_tpu_torch.parallel.mesh import make_mesh

    def run(device):
        inp = registration_inputs(device)["icp"]
        shards, mask = tms.shard_cloud(inp["map_points"], 4, inp["config"].tile_tgt)
        return tms.sp_icp_align(
            inp["source"], inp["source_mask"], torch.from_numpy(shards).to(device),
            torch.from_numpy(mask).to(device), inp["initial_T"], inp["config"],
            make_mesh(4, "sp", device, single_process=True))

    before = pair_nn.launches
    got = run(cuda_device)
    torch.cuda.synchronize()
    launched = pair_nn.launches - before
    want = run("cpu")
    assert launched > 0 and launched % 4 == 0
    for name in ("iterations", "n_correspondences", "pair_overflow", "has_converged"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    assert int(got.n_correspondences) == 300
    torch.testing.assert_close(got.transformation.cpu(), want.transformation, rtol=0, atol=1e-4)


def test_p2p_kernels_unchanged_by_the_header_move(cuda_device):
    assert p2p_digest(cuda_device) == P2P_DIGEST


def _assert_k7_matches_plain(config, imu_rate, min_corr, device):
    args, params = k7_case(config, device, imu_rate=imu_rate)
    before = tsb.lio_superblock.launches
    got = tsb.lio_superblock(*args, params)
    want = tsb.lio_superblock_plain(*args, params)
    torch.cuda.synchronize()
    assert tsb.lio_superblock.launches == before + 1
    (poses, stats, pose, v, bg, ba, P), (poses_p, stats_p, pose_p, v_p, bg_p, ba_p, P_p) = got, want
    for a, b in [(poses, poses_p), (pose, pose_p), (v, v_p), (bg, bg_p), (ba, ba_p)]:
        torch.testing.assert_close(a, b, rtol=0, atol=3e-4)
    torch.testing.assert_close(P, P_p, rtol=0, atol=1e-4 * P_p.abs().max().item())
    for lane in (1, 2, 4):
        assert torch.equal(stats[:, lane], stats_p[:, lane]), lane
    for lane in (0, 3, 5, 6, 7, 8):
        torch.testing.assert_close(stats[:, lane], stats_p[:, lane], rtol=1e-4, atol=1e-6)
    assert torch.equal(stats[:, 9:], torch.zeros_like(stats[:, 9:]))
    assert stats_p[:, 1].min() >= min_corr


@pytest.mark.parametrize("shape", ["bench", "odd"])
def test_lio_superblock_kernel_matches_plain(cuda_device, shape):
    """K7 against its plain version on one block: 16 frames of 10 IMU
    samples at the LIO bench's width, and an odd shape (3 frames of 7
    samples, source tiles of 96, target tiles of 200, fresh
    correspondences, the constant measurement covariance)."""
    _assert_k7_matches_plain(*K7_SHAPES[shape], cuda_device)


@pytest.mark.parametrize("width", list(K7_WIDE))
def test_lio_superblock_wide_tiles_match_plain(cuda_device, width):
    """K7 past 1024 rows a tile (2 source tiles of 2048 and of 4096 a
    frame, the leader's global layout) against its plain version on the
    bench's first block, to K7's bounds."""
    _assert_k7_matches_plain(*K7_WIDE[width], cuda_device)


def test_lio_superblock_skips_padding_frames(cuda_device):
    """Trailing invalid frames carry the state over and report zeros, on
    the card as in the plain version."""
    args, params = k7_case(ODD_LIO, cuda_device, imu_rate=7)
    args = list(args)
    args[3] = torch.tensor([True, False, False], device=cuda_device)
    got = tsb.lio_superblock(*args, params)
    want = tsb.lio_superblock_plain(*args, params)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=3e-4)
    assert torch.equal(got[0][1], got[0][0]) and torch.equal(got[0][2], got[0][0])
    assert torch.equal(got[2], got[0][0])
    assert (got[1][1:] == 0).all() and (want[1][1:] == 0).all()
    torch.testing.assert_close(got[6], want[6], rtol=0, atol=1e-4 * want[6].abs().max().item())


def test_lio_superblock_bits_equal_the_one_block_kernel(cuda_device):
    assert k7_digest(cuda_device) == K7_DIGEST


def _segsum_case(kind, device):
    """(values, seg, U): a group of 131072 sorted rows in ~30 000 segments
    of skewed lengths, or a tie-heavy one (one run of 10 000 rows, many
    singletons, empty segments, rows aliased to U - 1 with zero payload);
    and the edges of the kernel's design (tiles of 512 rows, a long run
    finished 256 rows a stage): runs across tile boundaries, a run of 5000
    rows with scattered zero rows, runs of mixed +0.0 and -0.0, NaN payload
    rows, and the first and last ids without rows (ids -1 before them and
    U after them, which belong to no output)."""
    rng = np.random.default_rng(12)
    if kind == "group":
        U = 1 << 15
        lens = np.minimum(rng.geometric(0.25, U), 400)
        seg = np.repeat(np.arange(U), lens)[: 1 << 17]
    elif kind == "ties":
        U = 5000
        lens = rng.integers(0, 2, U)
        lens[1234] = 10_000
        seg = np.concatenate([np.repeat(np.arange(U), lens), np.full(777, U - 1)])
    else:
        U = 3000
        lens = rng.integers(0, 4, U)
        lens[[0, U - 1]] = 0  # the first and last ids have no rows
        lens[[150, 151, 700]] = [511, 600, 5000]  # across one, two and ten tiles
        seg = np.concatenate([np.full(5, -1), np.repeat(np.arange(U), lens), np.full(9, U)])
    vals = (rng.standard_normal((len(seg), 4)) * 40).astype(np.float32)
    if kind == "ties":
        vals[-777:] = 0.0
    elif kind != "group":
        long = np.flatnonzero(seg == 700)
        vals[long[::3]] = 0.0  # zero rows inside the long run
        vals[long[1::7]] = -0.0
        signed = np.flatnonzero(seg == 151)
        vals[signed] = np.where(rng.uniform(size=(len(signed), 1)) < 0.5, 0.0, -0.0)
        vals[signed[::50], 1] = 2.5
        vals[np.isin(seg, [3, 4, 5])] = -0.0  # ids whose rows are all -0.0
        if kind == "nan":
            vals[np.flatnonzero(seg == 700)[[17, 4000]], 2] = np.nan
            vals[np.flatnonzero(seg == 150)[300]] = np.nan
            vals[np.isin(seg, [9, 10])] = np.nan
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return to(vals), to(seg.astype(np.int32)), U


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("kind", ["group", "ties", "edges", "nan"])
def test_segment_sum_kernel_matches_plain(cuda_device, kind):
    """The order-exact segment sum: bits equal the plain version's on the
    card (each segment's rows added in row order; NaN canonical there),
    and the CPU run's (NaN where it has NaN), one launch a call."""
    from slam_sensor_fusion_tpu_torch.ops import voxel_segsum as vs

    vals, seg, U = _segsum_case(kind, cuda_device)
    before = vs.segment_sum_sorted.launches
    got = vs.segment_sum_sorted(vals, seg, U)
    want = vs.segment_sum_sorted_plain(vals, seg, U)
    torch.cuda.synchronize()
    assert vs.segment_sum_sorted.launches == before + 1
    assert _same_bits(got, want)
    cpu = vs.segment_sum_sorted_plain(vals.cpu(), seg.cpu(), U)
    nan = torch.isnan(cpu)
    assert torch.equal(torch.isnan(got.cpu()), nan) and _same_bits(got.cpu()[~nan], cpu[~nan])
    assert (kind == "nan") == bool(nan.any())
    if kind in ("edges", "nan"):  # the empty first and last ids, and the -0.0 ids
        assert (got[[0, U - 1]] == 0).all() and not torch.signbit(got[[0, U - 1, 3, 4, 5]]).any()


def test_voxel_stores_on_the_card_equal_each_other_and_the_cpu(cuda_device):
    """Four groups of 8192 quantized points (cells revisited across
    groups): the sorted and hash stores on the card give the same
    centroids bit for bit, and each the same state as its CPU run."""
    from slam_sensor_fusion_tpu_torch.ops import voxel_map as tvm
    from slam_sensor_fusion_tpu_torch.ops import voxel_map_sorted as tvs

    rng = np.random.default_rng(13)
    pts = ((rng.integers(0, 960, (4, 8192, 3)) + 0.5) / 32.0).astype(np.float32)
    pts[2, :2000] = pts[0, :2000]
    msk = np.ones((4, 8192), bool)
    msk[3, 6000:] = False
    grid = dict(voxel_size=0.25, dim_xy=256, dim_z=128)
    stores = (
        (tvm.voxel_map_init, tvm.voxel_map_insert_chunk,
         tvm.VoxelMapConfig(**grid, table_size=1 << 18, unique_capacity=8192)),
        (tvs.sorted_voxel_map_init, tvs.sorted_voxel_map_insert_chunk,
         tvs.SortedVoxelMapConfig(**grid, capacity=1 << 15, unique_capacity=8192)),
    )
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        for init, chunk, cfg in stores:
            st = chunk(init(cfg, np.zeros(3), dev), torch.from_numpy(pts).to(dev),
                       torch.from_numpy(msk).to(dev), cfg)
            runs[dev.type, type(cfg).__name__] = st
    hs, ss = runs["cuda", "VoxelMapConfig"], runs["cuda", "SortedVoxelMapConfig"]
    assert int(hs.n_dropped) == int(ss.n_dropped) == int(hs.n_oob) == 0
    assert int(hs.n_cells()) == int(ss.n_cells()) > 20000
    np.testing.assert_array_equal(
        tvs.sorted_voxel_map_centroids_numpy(ss), tvm.voxel_map_centroids_numpy(hs))
    for name in ("VoxelMapConfig", "SortedVoxelMapConfig"):
        card, cpu = runs["cuda", name], runs["cpu", name]
        for f in card._fields:
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), (name, f)


def _gated_case(device):
    """1024 Morton-sorted source points near a 4096-point target, a few rows
    of each masked (tests/test_torch_helpers.py's case)."""
    from slam_sensor_fusion_tpu_torch.ops.morton import sort_points_numpy

    rng = np.random.default_rng(4)
    tgt = sort_points_numpy(rng.uniform(-8, 8, (4096, 3)).astype(np.float32))
    src = tgt[rng.choice(4096, 1024, replace=False)] + rng.normal(0, 0.05, (1024, 3))
    src = sort_points_numpy(src.astype(np.float32))
    smask, tmask = np.arange(1024) < 984, np.arange(4096) < 3996
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return to(src), to(smask), to(tgt), to(tmask), to(src[smask].mean(0)), 2.736 ** 2


@pytest.mark.parametrize("max_pairs", [None, 12], ids=["default", "truncating"])
def test_gated_nn_pallas_on_the_card_matches_the_cpu(cuda_device, max_pairs):
    """The one-call gated NN launches K2 once; idx and overflow equal the
    CPU run's (the plain K2), d2 to 1e-5 relative, with and without a
    truncated pair list."""
    args = _gated_case(cuda_device)
    before = pair_nn.launches
    got = tnn.gated_nn_pallas(*args, tile_src=256, tile_tgt=512, max_pairs=max_pairs)
    torch.cuda.synchronize()
    assert pair_nn.launches == before + 1
    want = tnn.gated_nn_pallas(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args],
                               tile_src=256, tile_tgt=512, max_pairs=max_pairs)
    assert bool(got.overflow) == bool(want.overflow) == (max_pairs is not None)
    assert torch.equal(got.idx.cpu(), want.idx)
    torch.testing.assert_close(got.d2.cpu(), want.d2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("origin", [None, (0.0, 0.0, 0.0)], ids=["min_corner", "origin"])
def test_voxel_downsample_on_the_card_matches_the_cpu(cuda_device, origin):
    """The device voxel grid launches the segment sum once and gives the
    CPU run's bits, its int32 ids wrapping (x from 0 to 250 m at 0.2 m:
    cells 1024 apart share an id) on a cloud with masked inf rows."""
    from slam_sensor_fusion_tpu_torch.ops import cloud as tcl
    from slam_sensor_fusion_tpu_torch.ops import voxel_segsum as vs

    rng = np.random.default_rng(14)
    pts = (rng.uniform(0, 1, (20000, 3)) * [250.0, 30.0, 5.0]).astype(np.float32)
    mask = rng.random(20000) < 0.9
    pts[~mask] = np.inf
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        o = None if origin is None else torch.tensor(origin, device=dev)
        before = vs.segment_sum_sorted.launches
        runs.append(tcl.voxel_downsample(
            tcl.Cloud(torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)), 0.2, 16384,
            origin=o))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert vs.segment_sum_sorted.launches == before + 1
    card, cpu = runs
    assert torch.equal(card.points.cpu(), cpu.points) and torch.equal(card.mask.cpu(), cpu.mask)
    assert bool(cpu.mask.all())  # more voxels than rows: the first 16384 kept


@pytest.mark.parametrize("n", [1, 15, 16, 17, 257, 4097, 2**20 + 3])
def test_cumsum_rows_kernel_matches_plain(cuda_device, n):
    """The prefix sum in XLA's order: bits equal its plain version on the
    card and on the CPU, -0.0 rows included (a one-row scan keeps its
    -0.0), one launch a call."""
    from slam_sensor_fusion_tpu_torch.ops import ordered_scan as os_
    from slam_sensor_fusion_tpu_torch.ops.point_to_plane import _cell_moments

    rng = np.random.default_rng(n)
    pts = (rng.normal(0.0, 12.0, (n, 3)) + [-140.0, 60.0, -2.0]).astype(np.float32)
    mask = rng.uniform(size=n) < 0.7
    mask[:5] = False
    x = _cell_moments(torch.from_numpy(pts).to(cuda_device), torch.from_numpy(mask).to(cuda_device))
    before = os_.cumsum_rows.launches
    got = os_.cumsum_rows(x)
    want = os_.cumsum_rows_plain(x)
    torch.cuda.synchronize()
    assert os_.cumsum_rows.launches == before + 1
    assert _same_bits(got, want)
    assert _same_bits(got.cpu(), os_.cumsum_rows_plain(x.cpu()))
    assert bool(torch.signbit(got[:5]).any()) == (n == 1)


def test_estimate_normals_cells_on_the_card_matches_the_cpu(cuda_device):
    """The cell normals on the card (the scan kernel, then the same tensor
    code) against the CPU's: valid masks equal, unsigned gap 3e-5 (found
    1.1e-5 on an H100: 100-160 m from the origin the float32 moments leave
    some cells' covariances indefinite, where the float32 eigen-solve is
    itself 4.7e-6 from float64's, and the card's arccos, cos and sqrt
    round otherwise than the CPU's)."""
    from slam_sensor_fusion_tpu_torch.ops import ordered_scan as os_
    from slam_sensor_fusion_tpu_torch.ops import point_to_plane as tpp
    from slam_sensor_fusion_tpu_torch.ops.cloud import Cloud
    from slam_sensor_fusion_tpu_torch.ops.morton import sort_by_morton

    # ground and walls every 10 m, 140 m from the origin, Morton-sorted as
    # the LIO anchor is
    rng = np.random.default_rng(15)
    pts = rng.uniform(0, 1, (65536, 3)) * [60.0, 60.0, 0.3] + [100.0, -80.0, 1.0]
    walls = rng.uniform(size=65536) < 0.4
    pts[walls, 2] = rng.uniform(0, 4, walls.sum())
    pts[walls, 1] = np.round(pts[walls, 1] / 10.0) * 10.0 + rng.normal(0, 0.02, walls.sum())
    mask = rng.uniform(size=65536) < 0.9
    s = sort_by_morton(Cloud(torch.from_numpy(pts.astype(np.float32)), torch.from_numpy(mask)),
                       isotropic=True)
    p, m = s.points, s.mask
    before = os_.cumsum_rows.launches
    n_c, v_c = tpp.estimate_normals_cells(p.to(cuda_device), m.to(cuda_device), 1.2,
                                          max_planarity=0.25)
    torch.cuda.synchronize()
    assert os_.cumsum_rows.launches == before + 1
    n_h, v_h = tpp.estimate_normals_cells(p, m, 1.2, max_planarity=0.25)
    assert torch.equal(v_c.cpu(), v_h) and int(v_h.sum()) > 1000
    assert float((1.0 - (n_c.cpu() * n_h).sum(-1).abs())[v_h].max()) <= 3e-5


@pytest.mark.parametrize("shift", [(0.0, 0.0, 0.0), (40.0, 30.0, 0.0), (140.0, -60.0, 2.0)],
                         ids=["origin", "shifted", "far"])
def test_voxel_normals_on_the_card_match_the_cpu(cuda_device, shift):
    """The voxel normals' per-cell moments (`estimate_normals`, LIOConfig()'s
    estimator) take one segment-sum launch a call: the same bits on two
    runs and as the CPU's, the sort and cell ids equal; the normals' valid
    masks equal and every valid normal within 1e-5 (1 - |n . n'|, the
    eigen-solvers cuSOLVER and LAPACK)."""
    from slam_sensor_fusion_tpu_torch.ops import point_to_plane as tpp
    from slam_sensor_fusion_tpu_torch.ops import voxel_segsum as vs

    p, m = (torch.from_numpy(a) for a in ground_and_walls(16, shift))
    pc, mc = p.to(cuda_device), m.to(cuda_device)
    before = vs.segment_sum_sorted.launches
    card = [tpp._voxel_moments(pc, mc, 0.75) for _ in range(2)]
    torch.cuda.synchronize()
    assert vs.segment_sum_sorted.launches == before + 2
    host = tpp._voxel_moments(p, m, 0.75)
    for k in range(3):  # order, cell ids, sorted mask
        assert torch.equal(card[0][k].cpu(), host[k]) and torch.equal(card[1][k], card[0][k])
    for a, b, h in zip(card[0][3], card[1][3], host[3]):
        assert _same_bits(a, b) and _same_bits(a.cpu(), h)
    n_c, v_c = tpp.estimate_normals(pc, mc, 0.75)
    n_h, v_h = tpp.estimate_normals(p, m, 0.75)
    assert torch.equal(v_c.cpu(), v_h) and int(v_h.sum()) > 10000
    gap = (1.0 - (n_c.cpu() * n_h).sum(-1).abs())[v_h]
    assert float(gap.max()) < 1e-5


def test_pair_nn_at_the_lio_tiles_matches_plain(cuda_device):
    """K2 as `point_to_plane_align`'s "pallas" branch calls it at bench_lio's
    tiles (source tiles of 512, target tiles of 1024; the pair list of 8
    slots a source tile, built at the prior): d2 to 1e-5 relative, idx and
    xyz EQUAL."""
    from slam_sensor_fusion_tpu_torch.ops import point_to_plane as tpp
    from slam_sensor_fusion_tpu_torch.ops.geometry import transform_points

    src, sm, tgt, tm, _, _, T0 = (torch.from_numpy(a).to(cuda_device)
                                  for a in p2p_scene(7, n_tgt=12000, M=8192, N=16384))
    cfg = PointToPlaneConfig(tile_src=512, tile_tgt=1024, max_visits=64)
    pairs, tgt_pages = tpp._k2_lists(src, sm, tgt, tm, T0, cfg)
    args = (tnn.make_pages(transform_points(T0, src), sm, T0[:3, 3], 512), tgt_pages, *pairs)
    assert args[0].shape == (16, 3, 512) and tgt_pages.shape == (16, 3, 1024)
    assert int(pairs[1].sum()) > 16
    before = pair_nn.launches
    d2k, idxk, xyzk = pair_nn(*args)
    d2p, idxp, xyzp = pair_nn_plain(*args)
    torch.cuda.synchronize()
    assert pair_nn.launches == before + 1
    torch.testing.assert_close(d2k, d2p, rtol=1e-5, atol=1e-6)
    assert torch.equal(idxk, idxp)
    assert torch.equal(xyzk, xyzp)


def xla_math_inputs(fn: str, n: int, seed: int = 0) -> list[np.ndarray]:
    """Float32 inputs of `xla_math`'s function `fn`: seeded angles in
    [-pi, pi] and magnitudes of 1e-8 to 1e6 of either sign ([-1, 1] for
    acos), random bit patterns, and the special values (+-0, subnormals,
    +-inf, NaN, the branch points of the reductions)."""
    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-39, -3e-39, 1.17e-38, np.inf, -np.inf,
                        np.nan, 1.0, -1.0, 0.78539816, 120.0, -120.0, 119.99999, 3.4e38,
                        2.0**-12, 2.0**-29, 2.0**25], np.float32)
    q = (n - special.size) // 3
    bits = rng.integers(0, 2**32, q, dtype=np.uint64).astype(np.uint32).view(np.float32)
    if fn == "acos":
        a = rng.uniform(-1.0, 1.0, 2 * q)
    else:
        a = np.concatenate([rng.uniform(-np.pi, np.pi, q),
                            np.sign(rng.normal(size=q)) * 10.0 ** rng.uniform(-8, 6, q)])
    x = np.concatenate([special, a.astype(np.float32), bits])
    return [x] + [rng.permutation(x) for _ in range({"atan2": 1, "fma": 2}.get(fn, 0))]


def _same_or_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bits equal, or both NaN (the card's arithmetic returns its canonical
    NaN, the CPU's propagates the operand's)."""
    a, b = a.cpu(), b.cpu()
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("fn", ["sincos", "atan2", "acos", "fma"])
def test_xla_math_kernel_bits_equal_plain(cuda_device, fn):
    """csrc/xla_math.cu equals ops/xla_math's plain versions bit for bit
    (NaN where NaN) on 2^20 inputs a function, special values included,
    in one launch a call; an input of one element broadcasts."""
    from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

    host = [torch.from_numpy(a) for a in xla_math_inputs(fn, 1 << 20)]
    before = xm.xla_math.launches
    got = xm.xla_math(fn, *[a.to(cuda_device) for a in host])
    torch.cuda.synchronize()
    assert xm.xla_math.launches == before + 1
    want = xm.xla_math(fn, *host)
    if fn != "sincos":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and _same_or_nan(g, w)
    if fn in ("fma", "atan2"):  # each operand of one element, read in place
        for j in range(len(host)):
            ins = [a[:1] if k == j else a for k, a in enumerate(host)]
            got = xm.xla_math(fn, *[a.to(cuda_device) for a in ins])
            assert _same_or_nan(got, xm.xla_math(fn, *ins))


@pytest.mark.parametrize("name", XLA_MATH_CASES)
def test_xla_math_composites_bits_equal_plain(cuda_device, name):
    """Each composite function of csrc/xla_math.cu (the small products,
    so3 / se3, deskew, the cell normals, the IMU propagation, the dead
    reckoning) equals its plain version on the CPU bit for bit, in one
    launch a call."""
    from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

    call, host = xla_math_cases()[name]
    before = xm.xla_math.launches
    got = call(*[a.to(cuda_device) for a in host])
    torch.cuda.synchronize()
    assert xm.xla_math.launches == before + 1
    want = call(*host)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.shape == w.shape and _same_or_nan(g, w)


def test_xla_math_refuses_other_tensors(cuda_device):
    """A CUDA tensor that is neither float32 nor a float64 reference
    raises: no quiet fallback."""
    from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

    with pytest.raises(ValueError):
        xm.sinf(torch.ones(4, dtype=torch.float16, device=cuda_device))


def test_xla_math_composite_entry_refuses_elementwise(cuda_device):
    """`sfk_xla_math` launches the composite functions only: an elementwise
    function there returns cudaErrorInvalidValue (1) and launches nothing;
    those go through `sfk_xla_ew` / `sfk_xla_ew_strided`."""
    from slam_sensor_fusion_tpu_torch.ops import cuda_lib
    from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

    a = torch.ones(8, device=cuda_device)
    out = torch.empty(8, device=cuda_device)
    so = cuda_lib.lib()
    for fn in ("sincos", "atan2", "acos", "fma"):
        before = so.sfk_xla_math_kernel_launches()
        err = so.sfk_xla_math(xm.FN[fn], a.data_ptr(), a.data_ptr(), a.data_ptr(),
                              out.data_ptr(), out.data_ptr(), None, 8, *([0] * 10),
                              cuda_lib.stream_ptr(a))
        assert err == 1 and so.sfk_xla_math_kernel_launches() == before


def _kernel_launches(fn, counter: str) -> int:
    """The kernels one call of `fn` launches, by the kernel library's own
    count (`sfk_xla_math_kernel_launches`, `sfk_cumsum_kernel_launches`;
    the profiler drops some launches)."""
    from slam_sensor_fusion_tpu_torch.ops import cuda_lib

    count = getattr(cuda_lib.lib(), counter)
    before = count()
    fn()
    torch.cuda.synchronize()
    return count() - before


@pytest.mark.parametrize("fn", ["sincos", "atan2", "acos", "fma"])
def test_xla_math_launch_paths_bits_equal_plain(cuda_device, fn):
    """Each elementwise function through its three launch paths, bit-equal
    to the plain version on the CPU in one kernel launch: 16-byte
    accesses (aligned contiguous operands), one value a thread (views one
    element off the alignment) and broadcast strides read in place
    (operands of shapes (512, 1), (512, 512) and (512,))."""
    from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

    host = [torch.from_numpy(a) for a in xla_math_inputs(fn, 1 << 19, seed=3)]
    k = len(host)
    shapes = [(512, 1), (512, 512), (512,)][:k] if k > 1 else [(512, 512)]
    cases = {"vec": host, "scalar": [a[1:] for a in host],
             "strided": [a[: int(np.prod(s))].reshape(s) for a, s in zip(host, shapes)]}
    if k == 1:
        cases["strided"] = [cases["strided"][0].T]
    for path, ins in cases.items():
        # the card's views one element off (or transposed) as the host's
        dev_ins = ([h.to(cuda_device)[1:] for h in host] if path == "scalar"
                   else [a.to(cuda_device) for a in ins])
        if path == "strided" and k == 1:
            dev_ins = [host[0][: 512 * 512].reshape(512, 512).to(cuda_device).T]
        call = lambda: xm.xla_math(fn, *dev_ins)  # noqa: E731
        assert _kernel_launches(call, "sfk_xla_math_kernel_launches") == 1, path
        got = call()
        want = xm.xla_math(fn, *ins)
        got, want = (got, want) if fn == "sincos" else ((got,), (want,))
        for g, w in zip(got, want):
            assert g.shape == w.shape and _same_or_nan(g, w), path


@pytest.mark.parametrize("n, C", [(1, 10), (17, 10), (4097, 10), (65536, 10), (2**20 + 3, 10),
                                  (300, 1), (1000, 13), (700, 60)])
def test_cumsum_rows_one_launch_matches_plain(cuda_device, n, C):
    """The ordered scan in one launch of its kernel at every length, 256-row
    chunks (C up to 45) and 16-row chunks past that: bits equal its plain
    version on the CPU, -0.0 rows included."""
    from slam_sensor_fusion_tpu_torch.ops import ordered_scan as os_

    rng = np.random.default_rng(n + C)
    x = (rng.normal(0.0, 1.0, (n, C)) * 10.0 ** rng.uniform(-3, 6, (n, 1))).astype(np.float32)
    x[rng.uniform(size=n) < 0.1] = -0.0
    xd = torch.from_numpy(x).to(cuda_device)
    assert _kernel_launches(lambda: os_.cumsum_rows(xd), "sfk_cumsum_kernel_launches") == 1
    assert _same_bits(os_.cumsum_rows(xd).cpu(), os_.cumsum_rows_plain(torch.from_numpy(x)))

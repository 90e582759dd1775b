"""The whole-block LIO loop of the PyTorch port against the JAX package:
`run_lio_superblocks` (K7's plain version on the CPU; the JAX side runs
K7 in interpret mode, as tests/test_lio_superblock.py does), K7's plain
version against the Pallas kernel on identical inputs, `_dead_reckon`,
`packed_sample_indices`, the fleet, and `icp_align_fused`'s dense fallback.

One module-scoped JAX run of 7 frames at a small width (scan 2048 with
`reg_subsample` 2: 4 source tiles of 256; ring 4 x 1024 with
`anchor_subsample` 2: 4 target tiles of 512; refresh 4, so a full block and
a block of 3 frames padded with a no-op frame; deskew on).

Tolerances, as found at this size:
 * K7 plain vs the Pallas kernel on the same inputs: BIT-EQUAL, poses,
   state, P and every stats lane, with constant and GN measurement
   covariances. The plain version follows XLA's CPU order (ops/p2p_fused's
   scalar tail, the GN moments' planes with their Huber weights a true
   division, the GN covariance's C Sg C^T as inline fma chains);
 * `run_lio_superblocks`: BIT-EQUAL, every pose, rmse, n_correspondences,
   slack distance, ICP std, GPS flag and pair demand, to the JAX package
   run a block a call (each call a one-block program); the JAX package's
   own 7-frame call (its loop over 2 blocks) parts from that by up to
   2.2e-6 m (8.1e-10 in frame 0: XLA compiles the block step, K7's
   interpreted kernel and its prologue, inside its loop into other
   fusions), and the port's gap to it is exactly that,
   frame by frame; against that call the flags and counts are EQUAL, the
   first block's slack distance to 5e-8 m, its ICP std to 1e-7 relative
   and rmse to 5e-8; the final state's position 2e-5 m, velocity 3e-5 m/s,
   P 1e-5 of max|P| and ring 1e-4 m;
 * `_dead_reckon` EQUAL bit for bit; `packed_sample_indices` EQUAL; the dense ICP
   fallback 1e-4 with equal iteration and correspondence counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.models import ekf as je
from slam_sensor_fusion_tpu.models import lio as jl
from slam_sensor_fusion_tpu.ops import cloud as jcl
from slam_sensor_fusion_tpu.ops import icp_fused as jif
from slam_sensor_fusion_tpu.ops import lio_superblock_fused as jsb
from slam_sensor_fusion_tpu.ops.point_to_plane import PointToPlaneConfig as JP2P
from slam_sensor_fusion_tpu.utils.config import ICPConfig as JICPConfig
from slam_sensor_fusion_tpu_torch.models import lio as tl
from slam_sensor_fusion_tpu_torch.ops import cloud as tcl
from slam_sensor_fusion_tpu_torch.ops import icp_fused as tif
from slam_sensor_fusion_tpu_torch.ops import lio_superblock_fused as tsb
from slam_sensor_fusion_tpu_torch.parallel import lio_fleet
from slam_sensor_fusion_tpu_torch.parallel.mesh import make_mesh, tree_stack
from slam_sensor_fusion_tpu_torch.utils.convert import lio_state_from_numpy
from torch_lio_world import SMALL_LIO, lio_sequence
from torch_parity import np_tree, t
from torch_world import K3_CONFIG, k3_scene

SB_CONFIG = SMALL_LIO._replace(
    scan_capacity=2048, window=4, slot_points=1024, reg_subsample=2, slack_base=0.1,
    p2p=SMALL_LIO.p2p._replace(tile_src=256, tile_tgt=512),
)
N_STEPS = 7  # a block of 4, then 3 frames and one no-op frame


def jax_lio_config(cfg: tl.LIOConfig) -> jl.LIOConfig:
    d = cfg._asdict()
    d["p2p"] = JP2P(**cfg.p2p._asdict())
    d["ekf"] = je.EKFConfig(**cfg.ekf._asdict())
    return jl.LIOConfig(**d)


def _states(poses, v0, first, cfg):
    s0, m0 = first
    st_j = jl.init_state(jax_lio_config(cfg), jnp.asarray(s0), jnp.asarray(m0),
                         jnp.asarray(poses[0]))
    st_j = st_j._replace(ekf_state=st_j.ekf_state._replace(v=jnp.asarray(v0)))
    st_t = tl.init_state(cfg, t(s0), t(m0), t(poses[0]))
    return st_j, st_t._replace(ekf_state=st_t.ekf_state._replace(v=t(v0)))


@pytest.fixture(scope="module")
def runs():
    """The same 7 frames through both packages' `run_lio_superblocks`."""
    poses, v0, first, frames = lio_sequence(N_STEPS + 1, SB_CONFIG.scan_capacity)
    st_j, st_t = _states(poses, v0, first, SB_CONFIG)
    *core, tau = frames
    fin_j, out_j = jl.run_lio_superblocks(
        st_j, *[jnp.asarray(a) for a in core], jax_lio_config(SB_CONFIG),
        scan_tau=jnp.asarray(tau), interpret=True,
    )
    # the same frames a block a call (two one-block programs)
    R = SB_CONFIG.refresh_every
    mid_j, blk1_j = jl.run_lio_superblocks(
        st_j, *[jnp.asarray(a[:R]) for a in core], jax_lio_config(SB_CONFIG),
        scan_tau=jnp.asarray(tau[:R]), interpret=True,
    )
    _, blk2_j = jl.run_lio_superblocks(
        mid_j, *[jnp.asarray(a[R:]) for a in core], jax_lio_config(SB_CONFIG),
        scan_tau=jnp.asarray(tau[R:]), interpret=True,
    )
    fin_t, out_t = tl.run_lio_superblocks(st_t, *[t(a) for a in core], SB_CONFIG,
                                          scan_tau=t(tau))
    return dict(poses=poses, frames=frames, st_j=st_j, st_t=st_t, fin_j=np_tree(fin_j),
                out_j=np_tree(out_j), blocks_j=[np_tree(blk1_j), np_tree(blk2_j)],
                fin_t=fin_t, out_t=out_t)


def test_run_lio_superblocks_matches_jax(runs):
    out_j, out_t = runs["out_j"], runs["out_t"]
    R = SB_CONFIG.refresh_every
    assert out_t.world_T_body.shape == (N_STEPS, 4, 4)
    # the JAX package run a block a call: every output bit for bit
    blocks = runs["blocks_j"]
    for name in ("world_T_body", "rmse", "n_correspondences", "slack_dist", "icp_std_xyz",
                 "gps_accepted", "pair_demand"):
        want = np.concatenate([getattr(b, name) for b in blocks])
        got = getattr(out_t, name).numpy()
        np.testing.assert_array_equal(got.view(np.int32) if got.dtype == np.float32 else got,
                                      want.view(np.int32) if want.dtype == np.float32 else want,
                                      err_msg=name)
    # the JAX package's own 7-frame call (its loop over 2 blocks) parts from
    # its block-a-call run: XLA compiles the block step (K7's interpreted
    # kernel and its prologue) inside the loop over blocks into other
    # fusions, as it does K4's in run_lio_blocks
    want = np.concatenate([b.world_T_body for b in blocks])
    d = np.abs(out_t.world_T_body.numpy() - out_j.world_T_body).max(axis=(1, 2))
    d_j = np.abs(want - out_j.world_T_body).max(axis=(1, 2))
    print("pose diff per frame", d, "the JAX call against its block-a-call run", d_j)
    np.testing.assert_array_equal(d, d_j)
    assert d[:R].max() < 1e-8, d
    assert d.max() < 2e-5, d
    for name in ("pair_demand", "pair_overflow", "slack_violation", "gps_accepted", "refreshed"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(), getattr(out_j, name),
                                      err_msg=name)
    n_j, n_t = out_j.n_correspondences, out_t.n_correspondences.numpy()
    np.testing.assert_array_equal(n_t, n_j)
    assert (n_t > 300).all()
    np.testing.assert_allclose(out_t.slack_dist.numpy()[:R], out_j.slack_dist[:R], atol=5e-8)
    np.testing.assert_allclose(out_t.icp_std_xyz.numpy()[:R], out_j.icp_std_xyz[:R], rtol=1e-7)
    np.testing.assert_allclose(out_t.rmse.numpy()[:R], out_j.rmse[:R], atol=5e-8)
    assert out_t.pair_demand.dtype == torch.int32 and not out_t.pair_overflow.any()
    # it tracks the ground truth (tests/test_lio.py's bound)
    gt = np.linalg.norm(out_t.world_T_body.numpy()[:, :3, 3] - runs["poses"][1:, :3, 3], axis=1)
    assert gt.max() < 0.3, gt


def test_final_state_matches_jax(runs):
    """The padded frame is a no-op: the counters advance by the 7 real
    frames, and the ring, filter and anchor agree."""
    fin_j, fin_t = runs["fin_j"], runs["fin_t"]
    assert (fin_t.slot, fin_t.frame) == (int(fin_j.slot), int(fin_j.frame)) == (8, 8)
    np.testing.assert_array_equal(fin_t.ring_mask.numpy(), fin_j.ring_mask)
    m = fin_j.ring_mask
    np.testing.assert_allclose(fin_t.ring.numpy()[m], fin_j.ring[m], rtol=0, atol=1e-4)
    e_t, e_j = fin_t.ekf_state, fin_j.ekf_state
    np.testing.assert_allclose(e_t.p.numpy(), e_j.p, rtol=0, atol=2e-5)
    np.testing.assert_allclose(e_t.v.numpy(), e_j.v, rtol=0, atol=3e-5)
    np.testing.assert_allclose(e_t.P.numpy(), e_j.P, rtol=0, atol=1e-5 * np.abs(e_j.P).max())
    np.testing.assert_allclose(fin_t.anchor_P6.numpy(), fin_j.anchor_P6, rtol=1e-3, atol=1e-7)
    np.testing.assert_array_equal(fin_t.anchor_mask.numpy(), fin_j.anchor_mask)


def _k7_inputs(st, frames, cfg, lo=0):
    """K7's arguments for the block of frames lo.. from the port's state,
    through the port's own prologue."""
    R = cfg.refresh_every
    sp, sm, gy, ac, dt, gp, gv, gok, tau = [t(a[lo:lo + R]) for a in frames]
    anchor = tl._refresh_anchor(st.ring, st.ring_mask, st.ekf_state.p, cfg)
    cache = anchor[4]
    base_r = float(np.sqrt(cfg.p2p.max_correspondence_dist_sq)) + cfg.p2p.reassoc_margin
    radius2 = (base_r + cfg.slack_base + cfg.superstep_slack * torch.arange(R).float()) ** 2
    vld = torch.ones(R, dtype=torch.bool)
    pred_t, _, src_pages, pairs, _, _ = tl._block_prologue(
        st, cache, sp, sm, tau, gy, ac, dt, vld, radius2, cfg)
    e0 = st.ekf_state
    return (*pairs, vld, gy, ac, dt, gp, gv, gok, pred_t, tl.ekf.pose_matrix(e0), e0.v,
            e0.bg, e0.ba, e0.P, cache.center, src_pages, cache.pages)


@pytest.mark.parametrize("cov_mode", ["constant", "gn"])
def test_k7_plain_matches_pallas_kernel(runs, cov_mode):
    """K7's plain version against the JAX kernel in interpret mode on
    identical inputs (the first block, GPS gate exercised)."""
    cfg = SB_CONFIG._replace(icp_cov_mode=cov_mode)
    args = _k7_inputs(runs["st_t"], runs["frames"], cfg)
    params_t = tl._superblock_params(cfg)
    got = tsb.lio_superblock(*args, params_t)
    jcfg = jax_lio_config(cfg)
    params_j = jsb.LIOSuperblockParams(**{**params_t._asdict(), "p2p": jcfg.p2p, "ekf": jcfg.ekf})
    want = np_tree(jsb.lio_superblock(*[jnp.asarray(a.numpy()) for a in args], params_j,
                                      interpret=True))
    poses, stats, pose, v, bg, ba, P = [x.numpy() for x in got]
    for name, a, b in [("poses", poses, want[0]), ("pose", pose, want[2]), ("v", v, want[3]),
                       ("bg", bg, want[4]), ("ba", ba, want[5]), ("P", P, want[6])]:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=name)
    # every stats lane bit for bit, in both covariance modes
    np.testing.assert_array_equal(stats.view(np.int32), want[1].view(np.int32))
    assert (stats[:, 9:] == 0).all()
    assert (stats[:, 1] > 300).all()
    print(cov_mode, "max pose diff", np.abs(poses - want[0]).max(), "gps", stats[:, 2])


def test_k7_wrapper_rejects_malformed_inputs(runs):
    args = list(_k7_inputs(runs["st_t"], runs["frames"], SB_CONFIG))
    params = tl._superblock_params(SB_CONFIG)
    bad = list(args)
    bad[0] = args[0].long()
    with pytest.raises(ValueError, match="pair_start"):
        tsb.lio_superblock(*bad, params)
    bad = list(args)
    bad[18] = args[18][:, :3].contiguous()
    with pytest.raises(ValueError, match="tgt_pages"):
        tsb.lio_superblock(*bad, params)
    assert tsb.lio_superblock.launches == 0  # CPU tensors never launch


def test_dead_reckon_matches_jax(runs):
    _, _, gy, ac, dt, *_ = runs["frames"]
    R = SB_CONFIG.refresh_every
    e_j = runs["st_j"].ekf_state._replace(bg=jnp.asarray([1e-3, -2e-3, 5e-4], jnp.float32),
                                           ba=jnp.asarray([0.02, -0.01, 0.03], jnp.float32))
    e_t = lio_state_from_numpy(np_tree(runs["st_j"]._replace(ekf_state=e_j)), "cpu").ekf_state
    want = jl._dead_reckon(e_j, jnp.asarray(gy[:R]), jnp.asarray(ac[:R]), jnp.asarray(dt[:R]))
    got = tl._dead_reckon(e_t, t(gy[:R]), t(ac[:R]), t(dt[:R]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [0, 5, 700, 2048])
def test_packed_sample_indices_match_jax(n):
    mask = np.zeros((3, 2048), bool)
    mask[0, :n], mask[1, : n // 2], mask[2, :1] = True, True, True
    idx_j, m_j = jcl.packed_sample_indices(jnp.asarray(mask), 1024)
    idx_t, m_t = tcl.packed_sample_indices(t(mask), 1024)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    # and the same selection as sample_to_capacity on a packed cloud
    pts = torch.arange(2048 * 3, dtype=torch.float32).reshape(2048, 3)
    ref = tcl.sample_to_capacity(tcl.Cloud(pts, t(mask[0])), 1024)
    np.testing.assert_array_equal(m_t[0].numpy(), ref.mask.numpy())
    keep = ref.mask
    np.testing.assert_array_equal(pts[idx_t[0]][keep].numpy(), ref.points[keep].numpy())


def test_fleet_robots_equal_their_solo_runs(runs):
    """Two robots, the second without GPS (the fleet takes no deskew taus,
    as the JAX package's): each equals its own `run_lio_superblocks`; the
    fleet's state and outputs carry the robot axis."""
    core = list(runs["frames"][:8])
    robots = [core, core[:7] + [np.zeros_like(core[7])]]
    stacked = [torch.stack([t(a), t(b)]) for a, b in zip(*robots)]
    first = runs["st_t"]
    states = tree_stack([first, first])
    fin, out = lio_fleet.fleet_run_lio_superblocks(states, *stacked, SB_CONFIG, mesh=None)
    assert out.world_T_body.shape == (2, N_STEPS, 4, 4)
    for b, frames in enumerate(robots):
        fin_b, out_b = tl.run_lio_superblocks(first, *[t(a) for a in frames], SB_CONFIG)
        assert torch.equal(out.world_T_body[b], out_b.world_T_body)
        assert torch.equal(out.n_correspondences[b], out_b.n_correspondences)
        assert torch.equal(fin.ekf_state.P[b], fin_b.ekf_state.P)
        assert torch.equal(fin.ring[b], fin_b.ring)
        assert fin_b.slot == fin.slot == 8
    assert not out.gps_accepted[1].any() and out.gps_accepted[0].any()
    # the robots split over a mesh of 2 shards give the same fleet; a mesh
    # whose shard count does not divide the robots is refused
    _, out2 = lio_fleet.fleet_run_lio_superblocks(
        states, *stacked, SB_CONFIG, mesh=make_mesh(2, device="cpu", single_process=True))
    assert torch.equal(out2.world_T_body, out.world_T_body)
    with pytest.raises(ValueError, match="multiple of mesh size"):
        lio_fleet.fleet_run_lio_superblocks(
            states, *stacked, SB_CONFIG, mesh=make_mesh(3, device="cpu", single_process=True))


def test_fleet_init_stacks_robots():
    poses, _, (s0, m0), _ = lio_sequence(2, SB_CONFIG.scan_capacity)
    st = lio_fleet.fleet_init(SB_CONFIG, np.stack([s0, s0]), np.stack([m0, m0]),
                              np.stack([poses[0], poses[1]]), device="cpu")
    solo = tl.init_state(SB_CONFIG, t(s0), t(m0), t(poses[1]))
    assert st.ring.shape == (2, 4 * 1024, 3) and (st.slot, st.frame) == (1, 1)
    assert torch.equal(st.ring[1], solo.ring)
    assert torch.equal(st.anchor_cache.pages[1], solo.anchor_cache.pages)


@pytest.mark.parametrize("M, N", [(500, 2048), (512, 2000)])
def test_icp_align_fused_dense_fallback_matches_jax(M, N):
    """Capacities that are not multiples of the tiles: both packages fall
    back to the dense ICP instead of the fused kernel."""
    src, smask, tgt, tmask, T0 = k3_scene(2, n_src=480, M=M, N=N)
    cfg = K3_CONFIG
    got = tif.icp_align_fused(t(src), t(smask), t(tgt), t(tmask), t(T0), cfg)
    jcfg = JICPConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    want = jif.icp_align_fused(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt),
                               jnp.asarray(tmask), jnp.asarray(T0), jcfg, interpret=True)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               rtol=0, atol=1e-4)
    assert int(got.iterations) == int(want.iterations) >= 2
    assert int(got.n_correspondences) == int(want.n_correspondences) > 400
    assert bool(got.has_converged) == bool(want.has_converged)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-4)
    assert not bool(got.pair_overflow)

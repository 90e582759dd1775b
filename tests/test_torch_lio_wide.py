"""K4-K7 at source tiles of 2048 rows (past the 1024 rows a thread block
once held one row a thread of) in the PyTorch port against the JAX Pallas
kernels in interpret mode. CPU tensors run the port's plain versions, which
take any width; on the card the same widths run the kernels' global layout
(tests/test_torch_cuda.py, chip_smoke.py phase 13).

A narrow size: 2 source tiles of 2048 against target tiles of 256, 2 GN
iterations. Tolerances are those of tests/test_torch_lio_k4.py and
tests/test_torch_lio_superblock.py: K4 and K6 T 1e-4 with EQUAL
n_correspondences, rmse and wr2 1e-4 relative; K5 d2 1e-6 relative with
EQUAL matched pages on valid source points; K7 poses and state 1e-4, P 1e-4
of max|P|, n_corr, GPS acceptance and slack flags EQUAL; 3 frames of
`run_lio_superblocks` (one block, the anchor shared) 2e-4 m.

K7 runs in the constant measurement-covariance mode on identical inputs
and in the GN mode inside the loop (the configuration's): each JAX kernel
in interpret mode compiles for 5-12 s, so the file compiles each kernel
once."""

import jax.numpy as jnp
import numpy as np
import pytest

from slam_sensor_fusion_tpu.models import ekf as je
from slam_sensor_fusion_tpu.models import lio as jl
from slam_sensor_fusion_tpu.ops import lio_superblock_fused as jsb
from slam_sensor_fusion_tpu.ops import p2p_fused as jf
from slam_sensor_fusion_tpu.ops.point_to_plane import PointToPlaneConfig as JConfig
from slam_sensor_fusion_tpu_torch.models import lio as tl
from slam_sensor_fusion_tpu_torch.ops import lio_superblock_fused as tsb
from slam_sensor_fusion_tpu_torch.ops import p2p_fused as tf
from slam_sensor_fusion_tpu_torch.ops.point_to_plane import PointToPlaneConfig
from test_torch_lio_k4 import CENTER, _assert_result, _cached
from test_torch_lio_superblock import _k7_inputs, jax_lio_config
from torch_lio_world import SMALL_LIO, lio_sequence, p2p_scene
from torch_parity import np_tree, t


TM = 2048
#: the LIO loop at 2 source tiles of 2048 (scan 4096, every point
#: registered) against target tiles of 256 (ring 2 x 1024, every 2nd
#: anchor point)
WIDE_LIO = SMALL_LIO._replace(
    scan_capacity=4096, window=2, slot_points=1024, refresh_every=4, reg_subsample=1,
    slack_base=0.1, p2p=SMALL_LIO.p2p._replace(tile_src=TM, tile_tgt=256),
)
N_STEPS = 3


def _cfg(**kw):
    base = dict(num_iterations=2, tile_src=TM, tile_tgt=256, max_visits=64, nn_backend="fused")
    base.update(kw)
    return PointToPlaneConfig(**base), JConfig(**base)


@pytest.fixture(scope="module")
def scene():
    """p2p_scene at 2 source tiles of 2048 against 8 target tiles of 256."""
    sc = p2p_scene(5, n_tgt=1900, M=2 * TM, N=2048)
    return sc, _cached(sc, 256)


@pytest.mark.parametrize("fixed", [False, True], ids=["fresh", "fixed"])
def test_k4_wide_tiles_match_jax_kernel(scene, fixed):
    sc, (c_t, c_j) = scene
    cfg_t, cfg_j = _cfg(fixed_correspondences=fixed)
    src, smask, *_, T0 = sc
    want = jf.point_to_plane_align_fused(jnp.asarray(src), jnp.asarray(smask), c_j,
                                         jnp.asarray(T0), cfg_j, interpret=True)
    got = tf.point_to_plane_align_fused(t(src), t(smask), c_t, t(T0), cfg_t)
    _assert_result(got, want)
    assert int(got.n_correspondences) > 2000


def test_k5_k6_wide_tiles_match_jax_kernels(scene):
    """K5's winners, and K6 on the JAX K5's winners."""
    sc, (c_t, c_j) = scene
    cfg_t, cfg_j = _cfg(fixed_correspondences=True)
    src, smask, *_, T0 = sc
    d2_j, qn_j = jf.associate_p2p_fused(jnp.asarray(src), jnp.asarray(smask), c_j,
                                        jnp.asarray(T0), cfg_j, interpret=True)
    d2_t, qn_t = tf.associate_p2p_fused(t(src), t(smask), c_t, t(T0), cfg_t)
    assert d2_t.shape == (2, 1, TM) and qn_t.shape == (2, 6, TM)
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-6)
    valid = smask.reshape(2, 1, TM)
    np.testing.assert_array_equal(np.where(valid, qn_t.numpy(), 0),
                                  np.where(valid, np.asarray(qn_j), 0))
    want = jf.p2p_gn_from_correspondences(jnp.asarray(src), jnp.asarray(smask), d2_j, qn_j,
                                          jnp.asarray(T0), jnp.asarray(CENTER), cfg_j,
                                          interpret=True)
    got = tf.p2p_gn_from_correspondences(t(src), t(smask), t(d2_j), t(qn_j), t(T0), t(CENTER),
                                         cfg_t)
    _assert_result(got, want)


def _jax_state(st):
    """The port's LIOState as the JAX package's: both loops start from the
    same ring, anchor and pages."""
    def a(x):
        return jnp.asarray(x.numpy())

    return jl.LIOState(
        ekf_state=je.EKFState(**{f: a(getattr(st.ekf_state, f)) for f in je.EKFState._fields}),
        ring=a(st.ring), ring_mask=a(st.ring_mask), slot=jnp.int32(st.slot),
        frame=jnp.int32(st.frame), anchor_points=a(st.anchor_points),
        anchor_mask=a(st.anchor_mask), anchor_normals=a(st.anchor_normals),
        anchor_normals_valid=a(st.anchor_normals_valid),
        anchor_cache=jf.CachedP2PTarget(*[None if x is None else a(x) for x in st.anchor_cache]),
        anchor_P6=a(st.anchor_P6),
    )


@pytest.fixture(scope="module")
def runs():
    """The same 3 frames through both packages' `run_lio_superblocks`, from
    the port's initial state."""
    poses, v0, (s0, m0), frames = lio_sequence(N_STEPS + 1, WIDE_LIO.scan_capacity)
    st_t = tl.init_state(WIDE_LIO, t(s0), t(m0), t(poses[0]))
    st_t = st_t._replace(ekf_state=st_t.ekf_state._replace(v=t(v0)))
    st_j = _jax_state(st_t)
    *core, _ = frames  # without deskew: it does not depend on the tile width
    _, out_j = jl.run_lio_superblocks(st_j, *[jnp.asarray(a) for a in core],
                                      jax_lio_config(WIDE_LIO), interpret=True)
    _, out_t = tl.run_lio_superblocks(st_t, *[t(a) for a in core], WIDE_LIO)
    return dict(poses=poses, frames=frames, st_t=st_t, out_j=np_tree(out_j), out_t=out_t)


def test_run_lio_superblocks_wide_tiles_match_jax(runs):
    """The loop with K7 in the GN covariance mode."""
    assert WIDE_LIO.icp_cov_mode == "gn"
    out_j, out_t = runs["out_j"], runs["out_t"]
    d = np.abs(out_t.world_T_body.numpy() - out_j.world_T_body).max()
    assert d < 2e-4, d
    for name in ("pair_demand", "pair_overflow", "slack_violation", "gps_accepted"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(), getattr(out_j, name),
                                      err_msg=name)
    n_j, n_t = out_j.n_correspondences, out_t.n_correspondences.numpy()
    assert (np.abs(n_t - n_j) <= 0.005 * n_j).all(), (n_t, n_j)
    assert (n_t > 1000).all()


def test_k7_wide_tiles_match_pallas_kernel(runs):
    """K7's plain version against the JAX kernel in interpret mode on
    identical inputs (the block of the 3 frames and a padding frame), in
    the constant measurement-covariance mode."""
    cfg = WIDE_LIO._replace(icp_cov_mode="constant")
    frames = [np.concatenate([a, a[-1:]]) for a in runs["frames"]]  # the block's 4th frame
    args = list(_k7_inputs(runs["st_t"], frames, cfg))
    args[3][N_STEPS:] = False  # the padding frame
    assert args[17].shape[1:] == (2, 3, TM)
    params_t = tl._superblock_params(cfg)
    got = tsb.lio_superblock(*args, params_t)
    jcfg = jax_lio_config(cfg)
    params_j = jsb.LIOSuperblockParams(**{**params_t._asdict(), "p2p": jcfg.p2p, "ekf": jcfg.ekf})
    want = np_tree(jsb.lio_superblock(*[jnp.asarray(a.numpy()) for a in args], params_j,
                                      interpret=True))
    poses, stats, pose, v, bg, ba, P = [x.numpy() for x in got]
    for name, a, b in [("poses", poses, want[0]), ("pose", pose, want[2]), ("v", v, want[3]),
                       ("bg", bg, want[4]), ("ba", ba, want[5])]:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(P, want[6], rtol=0, atol=1e-4 * np.abs(want[6]).max())
    for lane in (1, 2, 4):
        np.testing.assert_array_equal(stats[:, lane], want[1][:, lane], err_msg=f"lane {lane}")
    for lane in (0, 3, 5, 6, 7, 8):
        np.testing.assert_allclose(stats[:, lane], want[1][:, lane], rtol=1e-4, atol=1e-7,
                                   err_msg=f"lane {lane}")
    assert (stats[N_STEPS:] == 0).all() and (stats[:N_STEPS, 1] > 1000).all()

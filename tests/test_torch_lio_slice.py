"""The LIO slice of the PyTorch port as a whole against the JAX package:
`init_state` + `run_lio_blocks` over 8 frames (K4 with fixed
correspondences, deskew on, the GN covariance, GPS on, cell normals; the
JAX side runs K4 in interpret mode), one frame continued from a JAX
`LIOState` handed over as NumPy, `lio_step` / `run_lio_chunk` / `LIOSession`
against each other, and the config converter.

The port rounds the LIO path as XLA compiles the JAX package's jitted
functions on the CPU, stage by stage: glibc's sinf / cosf, XLA's arccos,
correctly rounded sqrt and XLA's fused multiply-adds (ops/xla_math), the
library GEMM's order of the filter's products, the cell normals' prefix
sum (ops/ordered_scan) and each fusion's own contractions in the 3x3
eigen-solve and deskew, K4's plain version (its Huber weights a true
division), the GN's sums (the library dot's chains) and jaxlib's LAPACK
for the inverses, solves and eigen-solves (ops/lapack_cpu). So at this size
(tests/torch_lio_world.SMALL_LIO):
 * `run_lio_blocks` is BIT-EQUAL, every pose, rmse, n_correspondences and
   GPS flag, to the JAX package's run a block a call (each call a
   one-block program); the voxel normals and the dense sweep under
   tests/test_lio.py's configuration are bit-equal over every frame;
 * the JAX package's own 8-frame call (its `lax.scan` over 2 blocks)
   parts from its block-a-call run by up to 8.7e-6 m (1.9e-9 in frame 0):
   the first quantity that parts is frame 0's registration, K4's
   interpreted kernel, which XLA compiles inside the loop over blocks into
   other fusions (found with a copy of the JAX function returning the
   stages). The port's gap to that call is exactly the JAX package's own,
   frame by frame; so is the final
   state's (position to 1e-5 m, velocity 2e-5 m/s, P 1e-5 of max|P|, the
   ring 1e-4 m);
 * one frame from a JAX state handed over: EQUAL (`lio_step` and
   `run_lio_blocks`);
 * one frame from the initial state on the other branches of
   `_frame_step` to 2e-7 m (found 5.5e-8 with the constant measurement
   covariance, 1.7e-7 on the multi-launch backends): the JAX package's
   `init_state` runs eagerly (unjitted), so its first anchor's cell normals
   round op by op, which the port, rounding as the jitted LIO does, does
   not follow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.models import ekf as je
from slam_sensor_fusion_tpu.models import lio as jl
from slam_sensor_fusion_tpu.ops.point_to_plane import PointToPlaneConfig as JP2P
from slam_sensor_fusion_tpu_torch.models import lio as tl
from slam_sensor_fusion_tpu_torch.models.session import LIOSession
from slam_sensor_fusion_tpu_torch.utils.convert import (
    lio_config_from_fields,
    lio_state_from_numpy,
)
from torch_lio_world import SMALL_LIO, lio_sequence
from torch_parity import np_tree, t

N_FRAMES = 9  # 8 steps = 2 blocks of 4


def jax_lio_config(cfg: tl.LIOConfig) -> jl.LIOConfig:
    d = cfg._asdict()
    d["p2p"] = JP2P(**cfg.p2p._replace(pallas_interpret=True)._asdict())
    d["ekf"] = je.EKFConfig(**cfg.ekf._asdict())
    return jl.LIOConfig(**d)


@pytest.fixture(scope="module")
def runs():
    """The same 8 frames through both packages' `run_lio_blocks`."""
    poses, v0, (s0, m0), frames = lio_sequence(N_FRAMES, SMALL_LIO.scan_capacity)
    cfg_j = jax_lio_config(SMALL_LIO)
    st_j = jl.init_state(cfg_j, jnp.asarray(s0), jnp.asarray(m0), jnp.asarray(poses[0]))
    st_j = st_j._replace(ekf_state=st_j.ekf_state._replace(v=jnp.asarray(v0)))
    st_t = tl.init_state(SMALL_LIO, t(s0), t(m0), t(poses[0]))
    st_t = st_t._replace(ekf_state=st_t.ekf_state._replace(v=t(v0)))
    *core, tau = frames
    fin_j, out_j = jl.run_lio_blocks(st_j, *[jnp.asarray(a) for a in core], cfg_j,
                                     scan_tau=jnp.asarray(tau))
    # the JAX state after the first block, for the hand-over test
    mid_j, blk1_j = jl.run_lio_blocks(st_j, *[jnp.asarray(a[:4]) for a in core], cfg_j,
                                      scan_tau=jnp.asarray(tau[:4]))
    # the same frames a block a call: the second block continues from the
    # first's state (two one-block programs)
    _, blk2_j = jl.run_lio_blocks(mid_j, *[jnp.asarray(a[4:]) for a in core], cfg_j,
                                  scan_tau=jnp.asarray(tau[4:]))
    fin_t, out_t = tl.run_lio_blocks(st_t, *[t(a) for a in core], SMALL_LIO, scan_tau=t(tau))
    return dict(poses=poses, frames=frames, first=(s0, m0), st_j=st_j, st_t=st_t, cfg_j=cfg_j,
                fin_j=np_tree(fin_j), out_j=np_tree(out_j), mid_j=np_tree(mid_j),
                blocks_j=[np_tree(blk1_j), np_tree(blk2_j)], fin_t=fin_t, out_t=out_t)


def test_init_state_matches_jax(runs):
    st_j, st_t = np_tree(runs["st_j"]), runs["st_t"]
    np.testing.assert_array_equal(st_t.ring.numpy(), st_j.ring)
    np.testing.assert_array_equal(st_t.ring_mask.numpy(), st_j.ring_mask)
    np.testing.assert_array_equal(st_t.anchor_points.numpy(), st_j.anchor_points)
    np.testing.assert_array_equal(st_t.anchor_mask.numpy(), st_j.anchor_mask)
    np.testing.assert_array_equal(st_t.anchor_normals_valid.numpy(), st_j.anchor_normals_valid)
    np.testing.assert_array_equal(st_t.anchor_cache.pages[:, :3].numpy(), st_j.anchor_cache.pages[:, :3])
    for name in ("lo", "hi", "center", "sub_lo", "sub_hi"):
        np.testing.assert_array_equal(getattr(st_t.anchor_cache, name).numpy(),
                                      getattr(st_j.anchor_cache, name), err_msg=name)
    np.testing.assert_array_equal(st_t.anchor_P6.numpy(), st_j.anchor_P6)
    assert (st_t.slot, st_t.frame) == (int(st_j.slot), int(st_j.frame)) == (1, 1)
    assert st_t.anchor_cache.pages.shape == (16, 6, 512)


def test_run_lio_blocks_matches_jax(runs):
    out_j, out_t = runs["out_j"], runs["out_t"]
    # the JAX package run a block a call: every pose bit for bit
    want = np.concatenate([b.world_T_body for b in runs["blocks_j"]])
    np.testing.assert_array_equal(out_t.world_T_body.numpy().view(np.int32), want.view(np.int32))
    for name in ("rmse", "n_correspondences", "gps_accepted"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.concatenate([getattr(b, name) for b in runs["blocks_j"]]))
    # the JAX package's own 8-frame call (its loop over 2 blocks) parts from
    # its block-a-call run: XLA compiles K4's interpreted kernel inside the
    # loop over blocks into other fusions, and frame 0's registration parts
    d = np.abs(out_t.world_T_body.numpy() - out_j.world_T_body).max(axis=(1, 2))
    d_j = np.abs(want - out_j.world_T_body).max(axis=(1, 2))
    print("pose diff per frame", d, "the JAX call against its block-a-call run", d_j)
    np.testing.assert_array_equal(d, d_j)
    assert d[:4].max() < 1e-8, d
    assert d.max() < 1e-5, d
    n_j, n_t = out_j.n_correspondences, out_t.n_correspondences.numpy()
    np.testing.assert_array_equal(n_t, n_j)
    assert (n_t > 1500).all()
    np.testing.assert_allclose(out_t.rmse.numpy()[:4], out_j.rmse[:4], rtol=0, atol=1e-7)
    np.testing.assert_allclose(out_t.rmse.numpy(), out_j.rmse, rtol=0, atol=5e-6)
    np.testing.assert_array_equal(out_t.gps_accepted.numpy(), out_j.gps_accepted)
    np.testing.assert_array_equal(out_t.refreshed.numpy(), out_j.refreshed)
    assert out_t.pair_demand is None and out_t.slack_violation is None
    # and it tracks the ground truth (tests/test_lio.py's bound)
    gt = np.linalg.norm(out_t.world_T_body.numpy()[:, :3, 3] - runs["poses"][1:, :3, 3], axis=1)
    assert gt.max() < 0.3, gt


def test_final_state_matches_jax(runs):
    fin_j, fin_t = runs["fin_j"], runs["fin_t"]
    assert (fin_t.slot, fin_t.frame) == (int(fin_j.slot), int(fin_j.frame)) == (9, 9)
    np.testing.assert_array_equal(fin_t.ring_mask.numpy(), fin_j.ring_mask)
    m = fin_j.ring_mask
    np.testing.assert_allclose(fin_t.ring.numpy()[m], fin_j.ring[m], rtol=0, atol=1e-4)
    # slots 1-4 were written before the refresh (slot 0 again by frame 8)
    first = slice(SMALL_LIO.slot_points, 5 * SMALL_LIO.slot_points)
    np.testing.assert_allclose(fin_t.ring.numpy()[first], fin_j.ring[first], rtol=0, atol=1e-5)
    e_t, e_j = fin_t.ekf_state, fin_j.ekf_state
    print("final p diff", np.abs(e_t.p.numpy() - e_j.p).max(), "v diff",
          np.abs(e_t.v.numpy() - e_j.v).max(), "P rel diff",
          np.abs(e_t.P.numpy() - e_j.P).max() / np.abs(e_j.P).max())
    np.testing.assert_allclose(e_t.p.numpy(), e_j.p, rtol=0, atol=1e-5)
    np.testing.assert_allclose(e_t.v.numpy(), e_j.v, rtol=0, atol=2e-5)
    P = e_j.P
    np.testing.assert_allclose(e_t.P.numpy(), P, rtol=0, atol=1e-5 * np.abs(P).max())
    np.testing.assert_array_equal(fin_t.anchor_mask.numpy(), fin_j.anchor_mask)


@pytest.mark.parametrize("entry", ["step", "blocks"])
def test_frame_continued_from_jax_state(runs, entry):
    """A JAX LIOState taken mid-run (after the first block) continues in
    the port through `lio_state_from_numpy`; both compute the same next
    frame bit for bit with equal counts: `lio_step` keeps the JAX anchor;
    `run_lio_blocks` refreshes it."""
    core = [a[4:5] for a in runs["frames"]]
    *args, tau = core
    mid_j = jax.tree.map(jnp.asarray, runs["mid_j"])
    st_t = lio_state_from_numpy(runs["mid_j"], "cpu")
    assert (st_t.slot, st_t.frame) == (5, 5)
    if entry == "step":
        _, want = jl.lio_step(mid_j, *[jnp.asarray(a[0]) for a in args], runs["cfg_j"],
                              jnp.asarray(tau[0]))
        _, got = tl.lio_step(st_t, *[t(a[0]) for a in args], SMALL_LIO, t(tau[0]))
    else:
        _, want = jl.run_lio_blocks(mid_j, *[jnp.asarray(a) for a in args], runs["cfg_j"],
                                    scan_tau=jnp.asarray(tau))
        _, got = tl.run_lio_blocks(st_t, *[t(a) for a in args], SMALL_LIO, scan_tau=t(tau))
        want = jax.tree.map(lambda x: x[0], want)
        got = tl.LIOOutput(*[None if x is None else x[0] for x in got])
    d = np.abs(got.world_T_body.numpy() - np.asarray(want.world_T_body)).max()
    print(entry, "pose diff", d)
    np.testing.assert_array_equal(got.world_T_body.numpy().view(np.int32),
                                  np.asarray(want.world_T_body).view(np.int32))
    assert float(got.rmse) == float(want.rmse)
    assert int(got.n_correspondences) == int(want.n_correspondences)
    assert bool(got.gps_accepted) == bool(want.gps_accepted)
    assert bool(got.refreshed) == bool(want.refreshed)


@pytest.mark.parametrize("cov_mode, backend", [("constant", "fused"), ("gn", "xla"), ("gn", "pallas")])
def test_lio_step_other_modes_match_jax(runs, cov_mode, backend):
    """One frame from the shared initial state on the other branches of
    `_frame_step`: the constant measurement covariance, and the multi-launch
    registration backends (JAX runs its dense sweep for both). Each
    package's `init_state` anchor is its own: the JAX package's runs eagerly
    (its cell normals op by op), the port's as the jitted LIO rounds."""
    cfg_t = SMALL_LIO._replace(icp_cov_mode=cov_mode,
                               p2p=SMALL_LIO.p2p._replace(nn_backend=backend, fixed_correspondences=False))
    cfg_j = jax_lio_config(cfg_t)
    if backend == "pallas":
        cfg_j = cfg_j._replace(p2p=cfg_j.p2p._replace(nn_backend="xla"))
    *args, tau = [a[0] for a in runs["frames"]]
    _, want = jl.lio_step(runs["st_j"], *[jnp.asarray(a) for a in args], cfg_j, jnp.asarray(tau))
    _, got = tl.lio_step(runs["st_t"], *[t(a) for a in args], cfg_t, t(tau))
    d = np.abs(got.world_T_body.numpy() - np.asarray(want.world_T_body)).max()
    print(cov_mode, backend, "pose diff", d)
    assert d < (2e-7 if backend == "fused" else 1e-6), d
    n = int(want.n_correspondences)
    assert abs(int(got.n_correspondences) - n) <= 0.005 * n


def test_session_equals_chunk_and_refreshes(runs):
    """`LIOSession.push` wraps the `lio_step` that `run_lio_chunk` loops:
    EQUAL poses; the anchor refreshes after frame 4 (frame counter 4)."""
    poses, frames = runs["poses"], runs["frames"]
    sess = LIOSession(SMALL_LIO, *runs["first"], poses[0], device="cpu")
    sess.state = sess.state._replace(ekf_state=runs["st_t"].ekf_state)
    n = 5
    res = [sess.push(*[a[k] for a in frames[:8]], tau=frames[8][k]) for k in range(n)]
    _, out = tl.run_lio_chunk(runs["st_t"], *[t(a[:n]) for a in frames[:8]], SMALL_LIO,
                              scan_tau=t(frames[8][:n]))
    np.testing.assert_array_equal(np.stack([r.world_T_body for r in res]), out.world_T_body.numpy())
    assert [r.n_correspondences for r in res] == out.n_correspondences.tolist()
    assert out.refreshed.tolist() == [False, False, False, True, False]
    assert isinstance(res[0].gps_accepted, bool) and isinstance(res[0].rmse, float)
    assert sess.state.frame == n + 1
    # the chunk loop refreshed after frame 4, the block loop before it:
    # the trajectories stay within the registration noise floor
    d = np.linalg.norm(out.world_T_body.numpy()[:, :3, 3]
                       - runs["out_t"].world_T_body.numpy()[:n, :3, 3], axis=1)
    assert d.max() < 0.05, d


def test_run_lio_blocks_tail_and_inputs_untouched(runs):
    """A tail block (6 frames = 4 + 2) and a restart from the same initial
    state give the same poses: the loops do not write into their inputs."""
    frames, st = runs["frames"], runs["st_t"]
    ring0 = st.ring.clone()
    _, out = tl.run_lio_blocks(st, *[t(a[:6]) for a in frames[:8]], SMALL_LIO, scan_tau=t(frames[8][:6]))
    assert out.world_T_body.shape == (6, 4, 4)
    assert torch.equal(st.ring, ring0)
    torch.testing.assert_close(out.world_T_body, runs["out_t"].world_T_body[:6], rtol=0, atol=0)


#: tests/test_lio.py's configuration: LIOConfig()'s voxel normals at its
#: 0.75 m cells and the dense sweep ("xla"), 4 GN iterations (the 1 m
#: `normal_voxel` of the registration config is a field the LIO does not
#: read)
TEST_LIO = tl.LIOConfig(
    scan_capacity=4096, window=8, slot_points=2048, refresh_every=4,
    p2p=tl.PointToPlaneConfig(nn_backend="xla", num_iterations=4, normal_voxel=1.0),
)


@pytest.fixture(scope="module")
def voxel_runs():
    """5 frames (a block of 4, then a refresh) through both packages'
    `run_lio_blocks` at TEST_LIO, from one initial state."""
    poses, v0, (s0, m0), frames = lio_sequence(6, TEST_LIO.scan_capacity)
    cfg_j = jax_lio_config(TEST_LIO)
    st_j = jl.init_state(cfg_j, jnp.asarray(s0), jnp.asarray(m0), jnp.asarray(poses[0]))
    st_j = st_j._replace(ekf_state=st_j.ekf_state._replace(v=jnp.asarray(v0)))
    st_t = tl.init_state(TEST_LIO, t(s0), t(m0), t(poses[0]))
    st_t = st_t._replace(ekf_state=st_t.ekf_state._replace(v=t(v0)))
    *core, tau = frames
    fin_j, out_j = jl.run_lio_blocks(st_j, *[jnp.asarray(a) for a in core], cfg_j,
                                     scan_tau=jnp.asarray(tau))
    fin_t, out_t = tl.run_lio_blocks(st_t, *[t(a) for a in core], TEST_LIO, scan_tau=t(tau))
    return dict(poses=poses, st_j=np_tree(st_j), st_t=st_t, fin_j=np_tree(fin_j),
                out_j=np_tree(out_j), fin_t=fin_t, out_t=out_t)


def test_run_lio_blocks_voxel_normals_matches_jax(voxel_runs):
    """The voxel normals (moments in row order) and the dense sweep under
    tests/test_lio.py's configuration (a block of 4, then a one-frame
    tail): the anchors' valid masks EQUAL at init and after the refresh,
    the refreshed anchor's normals (jaxlib's eigh on both sides), every
    pose, rmse and n_correspondences BIT-EQUAL (the GN's sums as XLA's
    library dot and gemv add them, ops/point_to_plane)."""
    r = voxel_runs
    for st_t, st_j in [(r["st_t"], r["st_j"]), (r["fin_t"], r["fin_j"])]:
        np.testing.assert_array_equal(st_t.anchor_mask.numpy(), st_j.anchor_mask)
        np.testing.assert_array_equal(st_t.anchor_normals_valid.numpy(), st_j.anchor_normals_valid)
    assert r["st_t"].anchor_normals_valid.sum() > 400 and r["fin_t"].anchor_normals_valid.sum() > 2000
    out_t, out_j = r["out_t"], r["out_j"]
    d = np.abs(out_t.world_T_body.numpy() - out_j.world_T_body).max(axis=(1, 2))
    print("voxel / xla pose diff per frame", d)
    np.testing.assert_array_equal(out_t.world_T_body.numpy().view(np.int32),
                                  out_j.world_T_body.view(np.int32))
    np.testing.assert_array_equal(out_t.rmse.numpy(), out_j.rmse)
    np.testing.assert_array_equal(r["fin_t"].anchor_normals.numpy().view(np.int32),
                                  r["fin_j"].anchor_normals.view(np.int32))
    np.testing.assert_array_equal(out_t.n_correspondences.numpy(), out_j.n_correspondences)
    assert (out_t.n_correspondences.numpy() > 900).all()
    np.testing.assert_array_equal(out_t.refreshed.numpy(), out_j.refreshed)


def test_lio_config_from_fields_roundtrip():
    cfg_j = jax_lio_config(SMALL_LIO)
    got = lio_config_from_fields(cfg_j._asdict())
    assert got == SMALL_LIO._replace(p2p=SMALL_LIO.p2p._replace(pallas_interpret=True))
    assert set(tl.LIOConfig._fields) == set(jl.LIOConfig._fields)
    assert tl.LIOConfig() == lio_config_from_fields(jl.LIOConfig()._asdict())
    with pytest.raises(ValueError, match="unknown"):
        lio_config_from_fields({"no_such_field": 1})

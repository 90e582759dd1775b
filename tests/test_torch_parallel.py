"""The multi-device layer of the PyTorch port (slam_sensor_fusion_tpu_torch/
parallel) against the JAX package's, whose sharded programs run on
conftest's 8-device CPU mesh (Pallas kernels in interpret mode); the port
holds every shard in one process on the CPU (plain kernel versions).

Tolerances are tests/test_parallel.py's: fleets 1e-4 on poses; brute force
EQUAL success, T 1e-5, score 1e-4 relative; map-sharded ICP EQUAL
iterations, correspondence counts and overflow, T 1e-4, error 1e-5. The
sharded voxel store equals JAX's whole sharded state bit for bit (keys,
sums, counts, counters of every shard), its drops included, and the
ownership hash equals JAX's uint32 arithmetic over the int32 range. The
port's fleets and sharded paths equal their one-shard and one-sequence runs
bit for bit. JAX states handed over (utils/convert) go on in the port to
JAX's results. The LIO fleets are in tests/test_torch_lio_fleets.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.models import localization as jl
from slam_sensor_fusion_tpu.models import pipeline_fast as jpf
from slam_sensor_fusion_tpu.ops import voxel_map as jvm
from slam_sensor_fusion_tpu.parallel import batch as jbatch
from slam_sensor_fusion_tpu.parallel import brute_force as jbf
from slam_sensor_fusion_tpu.parallel import map_shard as jms
from slam_sensor_fusion_tpu.parallel import voxel_map_shard as jvs
from slam_sensor_fusion_tpu.parallel.mesh import make_mesh as j_make_mesh
from slam_sensor_fusion_tpu.utils.config import BruteForceConfig as JBruteForceConfig
from slam_sensor_fusion_tpu.utils.config import ICPConfig as JICPConfig
from slam_sensor_fusion_tpu.utils.config import StochasticFilterConfig as JFilterConfig
from slam_sensor_fusion_tpu_torch.models import localization as tl
from slam_sensor_fusion_tpu_torch.models import pipeline_fast as tpf
from slam_sensor_fusion_tpu_torch.ops.brute_force import brute_force_align
from slam_sensor_fusion_tpu_torch.ops.morton import sort_points_numpy
from slam_sensor_fusion_tpu_torch.ops.voxel_map import VoxelMapConfig
from slam_sensor_fusion_tpu_torch.parallel import batch as tbatch
from slam_sensor_fusion_tpu_torch.parallel import map_shard as tms
from slam_sensor_fusion_tpu_torch.parallel import voxel_map_shard as tvs
from slam_sensor_fusion_tpu_torch.parallel.brute_force import sharded_brute_force_align
from slam_sensor_fusion_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicated,
    tree_index,
)
from slam_sensor_fusion_tpu_torch.utils import convert
from slam_sensor_fusion_tpu_torch.utils import synthetic as syn
from slam_sensor_fusion_tpu_torch.utils.config import BruteForceConfig, ICPConfig
from slam_sensor_fusion_tpu_torch.utils.config import StochasticFilterConfig
from torch_parity import jax_config, np_tree, t
from torch_world import SLICE_CONFIG, build_world



def _mesh(n, axis="dp"):
    return make_mesh(n, axis, "cpu", single_process=True)


def _tile(x, B):
    x = np.asarray(x)
    return np.broadcast_to(x, (B,) + x.shape).copy()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_make_mesh_fits_the_world():
    """One process holds every shard only when asked by name; a shard
    count and blocks split as JAX's device blocks; placements check the
    split."""
    mesh = _mesh(4, "sp")
    assert (mesh.n_shards, mesh.axis, mesh.world_size, mesh.rank) == (4, "sp", 1, 0)
    assert list(mesh.local_shards) == [0, 1, 2, 3] and mesh.local_block(8) == slice(0, 8)
    with pytest.raises(ValueError, match="not initialised"):
        make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(4, device="cpu", group=object(), single_process=True)
    with pytest.raises(ValueError, match="shards"):
        make_mesh(0, device="cpu", single_process=True)
    with pytest.raises(ValueError, match="multiple of mesh size"):
        batch_sharding(mesh)(torch.zeros(6, 3))
    assert batch_sharding(mesh)(torch.zeros(8, 3)).shape == (8, 3)
    assert replicated(mesh)(torch.zeros(5)).device == torch.device("cpu")
    # JAX's mesh of 4 of conftest's 8 devices has the same shape
    assert j_make_mesh(4, axis="sp").shape["sp"] == mesh.n_shards


# ---------------------------------------------------------------------------
# brute force over the candidate grid
# ---------------------------------------------------------------------------

BF = dict(x_step=0.2, y_step=0.2, z_step=0.1, x_range=0.8, y_range=0.8, z_range=0.2,
          yaw_step=np.pi / 18, yaw_range=np.pi / 9)


@pytest.mark.parametrize("threshold", [0.05, 1e-6], ids=["hit", "miss"])
def test_sharded_brute_force_matches_jax(threshold):
    """tests/test_parallel.py's pair, 8 shards: a hit, and with a
    threshold nothing meets the best score."""
    rng = np.random.default_rng(0)
    tgt = rng.uniform(-3, 3, size=(150, 3)).astype(np.float32)
    src = (tgt - np.array([0.35, 0.15, 0.05], np.float32)) + rng.normal(
        0, 0.02, tgt.shape).astype(np.float32)
    s, sm = _padded(src, 256)
    tg, tm = _padded(tgt, 256)
    want = jbf.sharded_brute_force_align(
        *map(jnp.asarray, (s, sm, tg, tm)), jnp.eye(4),
        JBruteForceConfig(**BF, mean_error_threshold=threshold), j_make_mesh(8))
    cfg = BruteForceConfig(**BF, mean_error_threshold=threshold)
    got = sharded_brute_force_align(t(s), t(sm), t(tg), t(tm), torch.eye(4), cfg, _mesh(8))
    assert bool(got.success) == bool(want.success) == (threshold > 1e-3)
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               atol=1e-5)
    np.testing.assert_allclose(float(got.score), float(want.score), rtol=1e-4)
    # and the one-process sweep it splits, bit for bit
    single = brute_force_align(t(s), t(sm), t(tg), t(tm), torch.eye(4), cfg, candidate_chunk=16)
    assert bool(single.success) == bool(got.success)
    assert torch.equal(single.transformation, got.transformation)
    assert torch.equal(single.score, got.score)


def _padded(points, cap):
    buf = np.zeros((cap, 3), np.float32)
    buf[: len(points)] = points
    return buf, np.arange(cap) < len(points)


# ---------------------------------------------------------------------------
# the map-sharded ICP and steady state
# ---------------------------------------------------------------------------


def _sp_scene():
    """tests/test_parallel.py's sp-ICP scene: a Morton-sorted 40 m world of
    ~2000 points, a 9-frame trajectory of 700-point scans in 768 slots."""
    rng = np.random.default_rng(0)
    world = syn.make_world(rng, extent=40.0, n_buildings=10, n_poles=25, points_per_m2=8.0)
    n_frames = 10
    poses = syn.make_trajectory(n_frames, speed_per_frame=0.15, radius=9.0)
    map_pts = sort_points_numpy(world.astype(np.float32))
    T = n_frames - 1
    sp = np.zeros((T, 768, 3), np.float32)
    sm = np.zeros((T, 768), bool)
    for i in range(1, n_frames):
        s = syn.render_scan(world, poses[i], rng, max_points=700, max_range=20.0)
        sp[i - 1, : len(s)] = s
        sm[i - 1, : len(s)] = True
    odom_T = poses[1:].astype(np.float32)
    gps_T = (poses[1:] + rng.normal(0, 0.05, (T, 4, 4)).astype(np.float32)
             * np.array([0, 0, 0, 1.0])[None, None, :]).astype(np.float32)
    frames = (sp, sm, odom_T, gps_T, np.full(T, 0.05, np.float32), np.full(T, 1.0, np.float32))
    return poses, map_pts, frames


#: the map-sharded ICP's configuration (tests/test_parallel.py): lists that
#: hold every (source, target) tile pair, so both packages see every
#: admissible tile at any shard count
SP_FIELDS = dict(tile_src=128, tile_tgt=128, max_visits=256, max_pairs_factor=256)


@pytest.fixture(scope="module")
def sp_world():
    poses, map_pts, frames = _sp_scene()
    cap = -(-len(map_pts) // 128) * 128
    full = _padded(map_pts, cap)
    shards = jms.shard_cloud(map_pts, 4, 128)
    return poses, map_pts, frames, full, shards


def test_shard_cloud_equals_jax(sp_world):
    _, map_pts, _, _, (shards, mask) = sp_world
    got, got_mask = tms.shard_cloud(map_pts, 4, 128)
    np.testing.assert_array_equal(got, shards)
    np.testing.assert_array_equal(got_mask, mask)


def test_sp_icp_align_matches_jax(sp_world):
    """Frame 1's scan against the map split into 4 shards: the port
    against JAX's sp_icp_align, the port's one-shard run and `icp_align` on
    the whole map, from a prior 0.1 m and 1 degree off."""
    poses, _, frames, (tfull, tfull_m), (shards, mask) = sp_world
    T0 = poses[1].astype(np.float32).copy()
    c, s_ = np.cos(np.radians(1.0)), np.sin(np.radians(1.0))
    T0[:3, :3] = T0[:3, :3] @ np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32)
    T0[:3, 3] += [0.1, -0.05, 0.0]
    src, smask = frames[0][0], frames[1][0]
    jcfg = dataclasses.replace(JICPConfig(), nn_backend="pallas", pallas_interpret=True,
                               **SP_FIELDS)
    want = jms.sp_icp_align(*map(jnp.asarray, (src, smask, shards, mask, T0)), jcfg,
                            j_make_mesh(4, axis="sp"), interpret=True)
    cfg = ICPConfig(**SP_FIELDS)
    got = tms.sp_icp_align(t(src), t(smask), t(shards), t(mask), t(T0), cfg, _mesh(4, "sp"))
    for name in ("iterations", "n_correspondences", "pair_overflow", "has_converged"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name
    assert int(got.n_correspondences) > 500 and int(got.iterations) >= 1
    np.testing.assert_allclose(got.transformation.numpy(), np.asarray(want.transformation),
                               atol=1e-4)
    np.testing.assert_allclose(float(got.error), float(want.error), atol=1e-5)
    whole = tms.sp_icp_align(t(src), t(smask), t(tfull), t(tfull_m), t(T0), cfg, _mesh(1, "sp"))
    single = tl.icp_align(t(src), t(smask), t(tfull), t(tfull_m), t(T0), cfg)
    for a, b in zip(whole[:6], single[:6]):  # one shard is the whole-map loop, bit for bit
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_sp_run_chunk_matches_jax(sp_world):
    """6 steady frames against the 4-way sharded map and the whole map in
    the port, against JAX's sharded loop run as two chunks of 3 (one
    compiled shape): the second from the first's carry, which is also
    handed over (utils/convert.sp_state_from_numpy) and run on in the
    port."""
    poses, _, frames, (tfull, tfull_m), (shards, mask) = sp_world
    n = 6
    fr = [a[:n] for a in frames]
    jcfg = dataclasses.replace(JICPConfig(), nn_backend="pallas", pallas_interpret=True,
                               **SP_FIELDS)
    jf = JFilterConfig()
    jmesh = j_make_mesh(4, axis="sp")
    jmid = jms.sp_init_state(jnp.asarray(poses[0], jnp.float32),
                             jnp.asarray(poses[0], jnp.float32), jf)
    jouts = []
    for half in (slice(0, 3), slice(3, 6)):
        handed = jmid
        jmid, jout = jms.sp_run_chunk(jmid, *[jnp.asarray(a[half]) for a in fr],
                                      jnp.asarray(shards), jnp.asarray(mask), jcfg, jf, jmesh,
                                      interpret=True)
        jouts.append(np_tree(jout))
    jout = type(jouts[0])(*[np.concatenate(f) for f in zip(*jouts)])
    cfg, fcfg = ICPConfig(**SP_FIELDS), StochasticFilterConfig()
    t0 = tms.sp_init_state(poses[0], poses[0], fcfg, device="cpu")
    tfin, tout = tms.sp_run_chunk(t0, *map(t, fr), t(shards), t(mask), cfg, fcfg,
                                  _mesh(4, "sp"))
    _, tsingle = tms.sp_run_chunk_single(t0, *map(t, fr), t(tfull), t(tfull_m), cfg, fcfg)
    for out in (tout, tsingle):
        np.testing.assert_array_equal(out.n_correspondences.numpy(), jout.n_correspondences)
        np.testing.assert_array_equal(out.icp_converged.numpy(), jout.icp_converged)
        np.testing.assert_array_equal(out.pair_overflow.numpy(), jout.pair_overflow)
        np.testing.assert_allclose(out.map_T_sensor.numpy(), jout.map_T_sensor, atol=1e-4)
    assert not tout.pair_overflow.any()
    err = np.linalg.norm(tout.map_T_sensor.numpy()[:, :3, 3] - poses[1:n + 1, :3, 3], axis=1)
    assert err.max() < 0.3, err
    np.testing.assert_allclose(tfin.map_T_sensor.numpy(), np.asarray(jmid.map_T_sensor),
                               atol=1e-4)
    # JAX's carry after 3 frames, continued in the port
    mid = convert.sp_state_from_numpy(np_tree(handed), "cpu")
    _, rest = tms.sp_run_chunk(mid, *[t(a[3:]) for a in fr], t(shards), t(mask), cfg, fcfg,
                               _mesh(4, "sp"))
    np.testing.assert_allclose(rest.map_T_sensor.numpy(), jout.map_T_sensor[3:], atol=1e-4)


# ---------------------------------------------------------------------------
# the sharded voxel store
# ---------------------------------------------------------------------------


def test_owner_matches_jax_over_the_int32_range():
    rng = np.random.default_rng(1)
    keys = np.concatenate([
        rng.integers(-2**31, 2**31 - 1, 200_000, dtype=np.int64),
        [0, 1, -1, 2**31 - 1, -2**31, 2**20, 2**32 // 0x9E3779B1],
    ]).astype(np.int32)
    for n in (1, 3, 4, 8):
        want = np.asarray(jvs._owner(jnp.asarray(keys), n))
        np.testing.assert_array_equal(tvs._owner(t(keys), n).numpy(), want)


@pytest.mark.parametrize("table_bits", [10, 11])
def test_sharded_voxel_store_equals_jax(table_bits):
    """The JAX dry run's 3 groups of 1024 points at 4 shards: tables of
    1024 slots (too full at 4 shards: both packages drop the same 50
    points) and 2048; the whole sharded state bit for bit, then JAX's
    state after 2 groups handed over and the last group inserted in the
    port."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(1.0, 39.0, (3, 1024, 3)).astype(np.float32)
    msk = np.ones((3, 1024), bool)
    fields = dict(voxel_size=0.5, table_size=1 << table_bits, dim_xy=128, dim_z=128)
    jcfg, cfg = jvm.VoxelMapConfig(**fields), VoxelMapConfig(**fields)
    jmesh = j_make_mesh(4, axis="sp")
    j0 = jvs.sp_voxel_map_init(jcfg, np.zeros(3, np.float32), jmesh)
    want = np_tree(jvs.sp_voxel_map_insert_chunk(j0, jnp.asarray(pts), jnp.asarray(msk), jcfg,
                                                 jmesh))
    mesh = _mesh(4, "sp")
    got = tvs.sp_voxel_map_init(cfg, np.zeros(3, np.float32), mesh, "cpu")
    got = tvs.sp_voxel_map_insert_chunk(got, t(pts), t(msk), cfg, mesh)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name),
                                      err_msg=name)
    dropped, oob, per_shard = tvs.sp_voxel_map_flags(got)
    assert (dropped, oob) == (int(want.n_dropped.sum()), 0)
    assert dropped == (50 if table_bits == 10 else 0)
    np.testing.assert_array_equal(per_shard, jvs.sp_voxel_map_flags(want)[2])
    np.testing.assert_array_equal(tvs.sp_voxel_map_centroids_numpy(got),
                                  jvs.sp_voxel_map_centroids_numpy(want))
    jmid = np_tree(jvs.sp_voxel_map_insert_chunk(j0, jnp.asarray(pts[:2]), jnp.asarray(msk[:2]),
                                                 jcfg, jmesh))
    mid = convert.sp_voxel_map_state_from_numpy(jmid, "cpu")
    last = tvs.sp_voxel_map_insert_chunk(mid, t(pts[2:]), t(msk[2:]), cfg, mesh)
    for name in got._fields:
        assert torch.equal(getattr(last, name), getattr(got, name)), name


# ---------------------------------------------------------------------------
# the fleets
# ---------------------------------------------------------------------------


def _fast_config():
    return dataclasses.replace(SLICE_CONFIG, block_kernel=True)


@pytest.fixture(scope="module")
def fleet_world():
    return build_world(n_frames=9, seed=7)


def test_batched_run_chunk_matches_jax(fleet_world):
    """2 sequences of 2 frames on the "xla" backend (the per-frame step,
    each ICP on the gated XLA search): the port against JAX's vmapped fleet
    and against each sequence's own run_chunk."""
    seq, map_data = fleet_world
    cfg = dataclasses.replace(SLICE_CONFIG, superblock_parity=False, block_kernel=False)
    B, n = 2, 2
    jcfg = jax_config(cfg)
    jloc = jl.Localizer(map_data, jcfg)
    gps_T = jloc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    args = (seq.scans[1:n + 1], seq.odom_T_sensor[1:n + 1], gps_T[1:n + 1],
            seq.odom_cov_trace[1:n + 1], seq.gps_cov_trace[1:n + 1], np.ones(n, bool))
    jfr = jl.build_frame_batch(jcfg, *args)
    jst = jbatch.batched_init_state(jcfg, jnp.asarray(_tile(gps_T[0], B)),
                                    jnp.asarray(_tile(seq.odom_T_sensor[0], B), jnp.float32))
    jtile = lambda x: jnp.asarray(_tile(x, B))  # noqa: E731
    jmesh = j_make_mesh(2)
    _, want = jbatch.batched_run_chunk(
        jbatch.shard_batch(jst, jmesh), jbatch.shard_batch(jax.tree.map(jtile, jfr), jmesh),
        jbatch.shard_batch(jax.tree.map(jtile, jloc.map_cloud), jmesh), jcfg)
    tloc = tl.Localizer(map_data, cfg, device="cpu")
    tfr = tl.build_frame_batch(cfg, *args, device="cpu")
    tst = tbatch.batched_init_state(cfg, _tile(gps_T[0], B), _tile(seq.odom_T_sensor[0], B),
                                    device="cpu")
    mesh = _mesh(2)
    fin, got = tbatch.batched_run_chunk(
        tst, tbatch.shard_batch(tl.FrameBatch(*[torch.stack([x] * B) for x in tfr]), mesh),
        tl.cl.Cloud(*[torch.stack([x] * B) for x in tloc.map_cloud]), cfg)
    assert got.map_T_sensor.shape == (B, n, 4, 4)
    np.testing.assert_allclose(got.map_T_sensor.numpy(), np.asarray(want.map_T_sensor), atol=1e-4)
    np.testing.assert_array_equal(got.n_correspondences.numpy(), np.asarray(want.n_correspondences))
    _, solo = tl.run_chunk(tree_index(tst, 0), tfr, tloc.map_cloud, tbatch._xla_config(cfg))
    for b in range(B):
        assert torch.equal(got.map_T_sensor[b], solo.map_T_sensor)
    assert fin.map_T_sensor.shape == (B, 4, 4)


def test_fleet_run_chunk_fast_matches_jax(fleet_world):
    """2 sequences, one superblock each, over a 2-shard dp mesh (K1's plain
    version): the port against JAX's shard_map fleet, each sequence equal
    to its own run_chunk_fast, and a batch the mesh does not divide
    refused."""
    seq, map_data = fleet_world
    cfg = _fast_config()
    B, n = 2, 8
    jcfg = jax_config(cfg)
    jloc = jl.Localizer(map_data, jcfg)
    gps_T = jloc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    args = (seq.scans[1:n + 1], seq.odom_T_sensor[1:n + 1], gps_T[1:n + 1],
            seq.odom_cov_trace[1:n + 1], seq.gps_cov_trace[1:n + 1], np.ones(n, bool))
    jst = jl.init_state(jcfg, jloc.map_cloud.capacity, jnp.asarray(gps_T[0]),
                        jnp.asarray(seq.odom_T_sensor[0], jnp.float32))
    jtile = lambda x: jnp.asarray(_tile(x, B))  # noqa: E731
    jmesh = j_make_mesh(2)
    _, want = jbatch.fleet_run_chunk_fast(
        jbatch.shard_batch(jax.tree.map(jtile, jst), jmesh),
        jbatch.shard_batch(jax.tree.map(jtile, jpf.build_paged_frames(jcfg, *args)), jmesh),
        jbatch.shard_batch(jax.tree.map(jtile, jloc.map_cloud), jmesh), jcfg, jmesh,
        interpret=True)
    tloc = tl.Localizer(map_data, cfg, device="cpu")
    tst = tl.init_state(cfg, 0, t(gps_T[0]), t(seq.odom_T_sensor[0].astype(np.float32)))
    tfr = tpf.build_paged_frames(cfg, *args, device="cpu")
    mesh = _mesh(2)
    stack = lambda tree: tbatch.shard_batch(  # noqa: E731
        tl.cl.Cloud(*[torch.stack([x] * B) for x in tree]) if isinstance(tree, tl.cl.Cloud)
        else type(tree)(*[None if x is None else _stack(x, B) for x in tree]), mesh)
    _, got = tbatch.fleet_run_chunk_fast(stack(tst), stack(tfr), stack(tloc.map_cloud), cfg, mesh)
    np.testing.assert_allclose(got.map_T_sensor.numpy(), np.asarray(want.map_T_sensor), atol=1e-4)
    for name in ("icp_iterations", "n_correspondences", "pair_overflow", "slack_violation"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    _, solo = tpf.run_chunk_fast(tst, tfr, tloc.map_cloud, cfg)
    for b in range(B):
        assert torch.equal(got.map_T_sensor[b], solo.map_T_sensor)
    with pytest.raises(ValueError, match="multiple of mesh size"):
        tbatch.fleet_run_chunk_fast(stack(tst), stack(tfr), stack(tloc.map_cloud), cfg, _mesh(3))


def _stack(x, B):
    from slam_sensor_fusion_tpu_torch.parallel.mesh import tree_stack

    return torch.stack([x] * B) if isinstance(x, torch.Tensor) else tree_stack([x] * B)

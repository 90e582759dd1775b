"""The LIO fleets of the PyTorch port (parallel/lio_fleet: `fleet_run_lio`
on the "xla" backend, `fleet_run_lio_superblocks` on K7's plain version)
over a 2-shard dp mesh, against the JAX package's fleets on conftest's
8-device CPU mesh (the block fleet a shard_map with K7 in interpret
mode): each robot equals its own run in the port bit for bit, and the JAX
fleet to 5e-6 m (found 1.6e-6: one block from the shared first anchor,
whose cell normals the port takes from a prefix sum in XLA's order,
tests/test_torch_lio_superblock.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.parallel import batch as jbatch
from slam_sensor_fusion_tpu.parallel import lio_fleet as jlf
from slam_sensor_fusion_tpu.parallel.mesh import make_mesh as j_make_mesh
from slam_sensor_fusion_tpu_torch.models.lio import run_lio_blocks, run_lio_superblocks
from slam_sensor_fusion_tpu_torch.parallel import lio_fleet as tlf
from slam_sensor_fusion_tpu_torch.parallel.mesh import make_mesh, tree_index
from torch_lio_world import SMALL_LIO, lio_sequence
from torch_parity import t



def _tile(x, B):
    x = np.asarray(x)
    return np.broadcast_to(x, (B,) + x.shape).copy()


@pytest.fixture(scope="module")
def lio_world():
    # 1024-point scans against a 2048-point ring (4 slots of 512), blocks
    # of 4 frames: the JAX side runs K7 in interpret mode
    cfg = SMALL_LIO._replace(normal_est="cells", normal_voxel=2.0, scan_capacity=1024,
                             window=4, slot_points=512)
    poses, v0, (s0, m0), frames = lio_sequence(5, cfg.scan_capacity, seed=5)
    return cfg, poses, (s0, m0), frames[:8]


def test_fleet_run_lio_superblocks_matches_jax(lio_world):
    """2 robots over a 2-shard dp mesh, 4 frames (one block): each equal to its own
    `run_lio_superblocks` in the port bit for bit, and to the JAX shard_map
    fleet to 5e-6 m."""
    from slam_sensor_fusion_tpu.models.lio import LIOConfig as JLIOConfig
    from slam_sensor_fusion_tpu.ops.point_to_plane import PointToPlaneConfig as JP2P

    cfg, poses, (s0, m0), frames = lio_world
    B = 2
    jcfg = JLIOConfig(**{**cfg._asdict(), "p2p": JP2P(**cfg.p2p._asdict()),
                         "ekf": type(JLIOConfig().ekf)(**cfg.ekf._asdict())})
    jmesh = j_make_mesh(2)
    jst = jlf.fleet_init(jcfg, jnp.asarray(_tile(s0, B)), jnp.asarray(_tile(m0, B)),
                         jnp.asarray(_tile(poses[0], B), jnp.float32))
    jin = [jbatch.shard_batch(jnp.asarray(_tile(a, B)), jmesh) for a in frames]
    _, want = jlf.fleet_run_lio_superblocks(jbatch.shard_batch(jst, jmesh), *jin, jcfg,
                                            mesh=jmesh, interpret=True)
    st, got = _port_fleet(tlf.fleet_run_lio_superblocks, cfg, poses, s0, m0, frames)
    np.testing.assert_allclose(got.world_T_body.numpy(), np.asarray(want.world_T_body), atol=5e-6)
    _, solo = run_lio_superblocks(tree_index(st, 0), *[t(a) for a in frames], cfg)
    for b in range(B):
        assert torch.equal(got.world_T_body[b], solo.world_T_body)


def test_fleet_run_lio_equals_its_robots(lio_world):
    """The per-frame fleet on the "xla" backend over a 2-shard mesh: each
    robot equal to its own `run_lio_blocks` bit for bit (that loop on the
    "xla" backend is held to the JAX package in tests/test_torch_lio_slice.py);
    a robot count the mesh does not divide is refused."""
    cfg, poses, (s0, m0), frames = lio_world
    # 3 frames: the dense "xla" search is slow on the CPU, and the check is
    # equality, not accuracy
    cfg = cfg._replace(refresh_every=2)
    frames = tuple(a[:3] for a in frames)
    st, got = _port_fleet(tlf.fleet_run_lio, cfg, poses, s0, m0, frames)
    _, solo = run_lio_blocks(tree_index(st, 0), *[t(a) for a in frames], tlf._xla_config(cfg))
    for b in range(2):
        assert torch.equal(got.world_T_body[b], solo.world_T_body)
    with pytest.raises(ValueError, match="multiple of mesh size"):
        tlf.fleet_run_lio(st, *[t(_tile(a, 2)) for a in frames], cfg,
                          mesh=make_mesh(4, device="cpu", single_process=True))


def _port_fleet(run, cfg, poses, s0, m0, frames, B=2):
    """(initial fleet state, outputs) of `run` for B copies of the robot
    over a B-shard mesh."""
    st = tlf.fleet_init(cfg, _tile(s0, B), _tile(m0, B), _tile(poses[0], B), device="cpu")
    fin, got = run(st, *[t(_tile(a, B)) for a in frames], cfg,
                   mesh=make_mesh(B, device="cpu", single_process=True))
    assert got.world_T_body.shape == (B, len(frames[0]), 4, 4) and fin.ring.shape[0] == B
    return st, got

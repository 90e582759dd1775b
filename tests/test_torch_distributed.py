"""The multi-device layer's distributed form on the CPU: 2 gloo ranks, each
holding 2 of 4 shards, against one process holding all 4, bit for bit, for
the three paths that combine winners over the mesh: `sp_icp_align`,
`sp_p2p_align` and `sharded_brute_force_align` (parallel/dryrun's
registration scene). The ranks are spawned processes that import only the
port (parallel/dryrun.run_distributed: a file store in a temporary
directory, so parallel test workers never race for a port). The
one-process paths are held against the JAX package in
tests/test_torch_parallel.py and tests/test_torch_map_shard.py."""

import torch

from slam_sensor_fusion_tpu_torch.parallel import dryrun
from slam_sensor_fusion_tpu_torch.parallel.mesh import make_mesh


def test_two_gloo_ranks_equal_one_process():
    inputs = dryrun.registration_inputs("cpu")
    one = dryrun.sharded_registration(make_mesh(4, "sp", "cpu", single_process=True), **inputs)
    assert not bool(one["icp"].pair_overflow)
    assert int(one["icp"].n_correspondences) == 300 and bool(one["bf"].success)
    assert int(one["p2p"].n_correspondences) > 100
    two = dryrun.run_distributed(inputs, n_shards=4, world_size=2, backend="gloo",
                                 device_type="cpu", timeout=300)
    for key in ("icp", "p2p", "bf"):
        assert dryrun.bit_equal(two[key], one[key]), key
    assert isinstance(two["icp"].transformation, torch.Tensor)

"""The port's dry run of its multi-device layer
(parallel/dryrun.dryrun_multichip, the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`) at 4 shards on the CPU: every sharded
path at the JAX dry run's tiny sizes, each held against its single-device
run inside the port."""

import torch_parity  # noqa: F401 (torch on one thread)
from slam_sensor_fusion_tpu_torch.parallel.dryrun import dryrun_multichip


def test_dryrun_multichip_on_four_shards():
    line = dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip OK: 4 shards on cpu")
    assert "bf success=True" in line and "sp-map icp converged=True" in line

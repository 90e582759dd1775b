"""The port's dry run of its multi-device layer
(parallel/dryrun.dryrun_multichip, the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`) at 4 shards on the CPU: every sharded
path at the JAX dry run's tiny sizes, each held against its single-device
run inside the port."""

import pytest

from slam_sensor_fusion_tpu_torch.parallel.dryrun import dryrun_multichip
from torch_parity import one_torch_thread  # noqa: F401 (the module's fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_dryrun_multichip_on_four_shards():
    line = dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip OK: 4 shards on cpu")
    assert "bf success=True" in line and "sp-map icp converged=True" in line

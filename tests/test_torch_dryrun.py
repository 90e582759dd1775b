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


def test_torchrun_main_raises_without_the_card(monkeypatch):
    """Under torchrun the dry run passes `--device` through to its ranks:
    asked for the card on a host without one it raises before joining a
    group, and never carries on on the CPU."""
    import pytest
    import torch

    from slam_sensor_fusion_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    joined = []
    monkeypatch.setattr(dryrun.dist, "init_process_group", lambda *a, **k: joined.append(a))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    for argv in (["dryrun"], ["dryrun", "--device", "cuda", "--shards", "2"]):
        monkeypatch.setattr("sys.argv", argv)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.main()
    with pytest.raises(ValueError, match="expected cuda or cpu"):
        dryrun._torchrun_main(2, "meta")
    assert joined == []

"""Every public entry point of the PyTorch port that takes a `device`
defaults to the card: the CPU runs only where a caller asks for it (as the
port's CPU tests do), and no entry point falls back to the CPU when no card
is found."""

import importlib
import inspect
import pkgutil

import pytest
import torch

import slam_sensor_fusion_tpu_torch as port
from slam_sensor_fusion_tpu_torch.ops import stochastic_filter as sf
from slam_sensor_fusion_tpu_torch.utils.config import StochasticFilterConfig

#: the entry points users and the port's own loops call with a device
EXPECTED = {
    "api.localize",
    "examples_selftest.run_selftest",
    "models.ekf.init_state",
    "models.session.LIOSession",
    "utils.convert.cached_p2p_target_from_numpy",
    "utils.convert.ekf_state_from_numpy",
    "utils.convert.lio_state_from_numpy",
    "models.localization.Localizer",
    "models.mapping.StreamingMapper",
    "models.localization.build_frame_batch",
    "models.localization_lite.run_lite",
    "models.pipeline_fast.build_paged_frames",
    "models.session.BlockLocalizerSession",
    "models.session.LocalizerSession",
    "ops.cloud.from_numpy",
    "ops.stochastic_filter.init_state",
    "ops.voxel_map.voxel_map_init",
    "ops.voxel_map_sorted.sorted_voxel_map_init",
    "parallel.lio_fleet.fleet_init",
    "parallel.map_shard.shard_p2p_target",
    "utils.convert.sharded_p2p_target_from_numpy",
    "utils.convert.paged_frames_from_numpy",
    "utils.convert.state_from_numpy",
    "utils.convert.sorted_voxel_map_state_from_numpy",
    "utils.convert.voxel_map_state_from_numpy",
    "utils.convert.sp_state_from_numpy",
    "utils.convert.sp_voxel_map_state_from_numpy",
    "parallel.mesh.make_mesh",
    "parallel.batch.batched_init_state",
    "parallel.map_shard.sp_init_state",
    "parallel.voxel_map_shard.sp_voxel_map_init",
    "parallel.dryrun.dryrun_multichip",
    "parallel.dryrun.registration_inputs",
}


def _device_defaults():
    """{"module.name": default of its `device` parameter} over the port's
    public functions and classes (a class through its __init__) whose
    `device` has a default (a required one is named by every caller)."""
    found = {}
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            if not (inspect.isfunction(obj) or inspect.isclass(obj)):
                continue
            try:
                params = inspect.signature(obj).parameters
            except (TypeError, ValueError):
                continue
            if "device" in params and params["device"].default is not inspect.Parameter.empty:
                key = f"{mod.__name__[len(port.__name__) + 1:]}.{name}"
                found[key] = params["device"].default
    return found


def test_entry_points_default_to_the_card():
    found = _device_defaults()
    assert EXPECTED <= set(found), sorted(EXPECTED - set(found))
    for name, default in found.items():
        assert torch.device(default) == torch.device("cuda"), f"{name}: defaults to {default}"


def test_default_device_without_a_card_raises():
    """Without a card the default raises as torch raises; with one, the
    state lands on it."""
    if torch.cuda.is_available():
        assert sf.init_state(StochasticFilterConfig()).transitions.is_cuda
        return
    with pytest.raises((AssertionError, RuntimeError)):
        sf.init_state(StochasticFilterConfig())

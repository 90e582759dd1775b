"""JAX-side helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Each test feeds the same inputs, made from a NumPy seed or the small
synthetic world of tests/torch_world.py, to a JAX package function and to
its counterpart in `slam_sensor_fusion_tpu_torch`, and compares them with
a stated tolerance. JAX stays on the CPU (tests/conftest.py); Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
On the CPU the port runs its plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.utils import config as jc
from slam_sensor_fusion_tpu_torch.utils.convert import config_from_fields

_NESTED = {
    "icp": jc.ICPConfig,
    "rescue_icp": jc.ICPConfig,
    "brute_force": jc.BruteForceConfig,
    "filter": jc.StochasticFilterConfig,
    "capacity": jc.CloudCapacity,
}


def jax_config(port_config):
    """The JAX package's LocalizationConfig with the port config's fields."""
    d = dataclasses.asdict(port_config)
    return jc.LocalizationConfig(
        **{k: (_NESTED[k](**v) if k in _NESTED else v) for k, v in d.items()}
    )


def port_config(jax_cfg):
    """The port's config built from the JAX one's fields."""
    return config_from_fields(dataclasses.asdict(jax_cfg))


def np_tree(x):
    """A JAX pytree with NumPy leaves."""
    return jax.tree.map(np.asarray, x)


def t(a) -> torch.Tensor:
    """NumPy (or JAX) array -> CPU torch tensor, dtype kept."""
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one thread for a module, restored after it: the port's plain
    kernels issue many small operations, and under the suite's parallel
    workers their thread pools oversubscribe the cores (results do not
    change: the modules using it compare within one setting or to JAX)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

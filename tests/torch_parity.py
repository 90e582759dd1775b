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
import torch

from slam_sensor_fusion_tpu.utils import config as jc
from slam_sensor_fusion_tpu_torch.utils.convert import config_from_fields

# torch on one thread in every test process that imports this module: the
# port's plain kernels issue many small operations, and under the suite's
# parallel workers (pytest -n 6 on a host of 8 cores) each worker's full
# intra-op pool oversubscribes the cores. K2's plain version over the 19
# calls of test_torch_session's world took 204 s a process at torch's 8
# threads with 6 processes side by side, 15 s at one thread.
# test_torch_lio_normals.py holds plain versions at DEFAULT_THREADS to the
# same bits as on one thread.
DEFAULT_THREADS = torch.get_num_threads()
torch.set_num_threads(1)

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

"""Fleet native-mode LIO: B robots' odometry in one call (port of the JAX
`parallel/lio_fleet.py`).

Every input gains a leading robot axis B; so does every tensor of the fleet
state (`LIOState`, whose slot and frame counters all robots share: they run
the same frames). Per-robot odometry is embarrassingly parallel. The JAX
package vmaps `run_lio_blocks` on its XLA backend (the single-shot kernels
do not vmap) and shards `run_lio_superblocks` over a `dp` mesh, one
`lax.map` of robots per device. On one card there is no mesh: robots run
one after another, so B robots cost B launches of the per-frame kernels or
of K7 a block. Batching robots into one launch is later work.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.models.lio import (
    LIOConfig,
    LIOOutput,
    LIOState,
    init_state,
    run_lio_blocks,
    run_lio_superblocks,
)


def _xla_config(config: LIOConfig) -> LIOConfig:
    """The registration backend forced to the dense "xla" form, as the JAX
    package's vmapped fleet does."""
    if config.p2p.nn_backend in ("fused", "pallas"):
        return config._replace(p2p=config.p2p._replace(nn_backend="xla"))
    return config


def _map(fn, *trees):
    """`fn` over the tensors of matching NamedTuples (None and ints kept
    from the first tree)."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[_map(fn, *xs) for xs in zip(*trees)])
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    return first


def _robot(states: LIOState, b: int) -> LIOState:
    return _map(lambda x: x[b], states)


def _stack(items):
    return _map(lambda *xs: torch.stack(xs), *items)


def fleet_init(
    config: LIOConfig,
    first_scans,  # (B, S, 3)
    first_masks,  # (B, S)
    world_T_body0,  # (B, 4, 4)
    device: torch.device | str = torch.device("cuda"),
) -> LIOState:
    """Per-robot `init_state`, stacked (leading axis B on every tensor).
    Takes NumPy arrays or tensors; the state lives on `device`."""
    def to(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    scans = to(first_scans, torch.float32)
    masks = to(first_masks, torch.bool)
    T0 = to(world_T_body0, torch.float32)
    cfg = _xla_config(config)
    return _stack([init_state(cfg, s, m, T) for s, m, T in zip(scans, masks, T0)])


def _per_robot(run, states: LIOState, inputs) -> tuple[LIOState, LIOOutput]:
    finals, outs = [], []
    for b in range(inputs[0].shape[0]):
        fin, out = run(_robot(states, b), *[a[b] for a in inputs])
        finals.append(fin)
        outs.append(out)
    return _stack(finals), _stack(outs)


def fleet_run_lio(
    states: LIOState,  # leading axis B on every tensor
    scan_points: torch.Tensor,  # (B, T, S, 3)
    scan_mask: torch.Tensor,  # (B, T, S)
    imu_gyro: torch.Tensor,  # (B, T, K, 3)
    imu_accel: torch.Tensor,  # (B, T, K, 3)
    imu_dt: torch.Tensor,  # (B, T, K)
    gps_pos: torch.Tensor,  # (B, T, 3)
    gps_var: torch.Tensor,  # (B, T)
    gps_valid: torch.Tensor,  # (B, T)
    config: LIOConfig = LIOConfig(),
) -> tuple[LIOState, LIOOutput]:
    """`run_lio_blocks` for each robot on the dense ("xla") registration
    backend, as the JAX package's vmapped fleet runs it."""
    cfg = _xla_config(config)
    inputs = (scan_points, scan_mask, imu_gyro, imu_accel, imu_dt, gps_pos, gps_var, gps_valid)
    return _per_robot(lambda st, *a: run_lio_blocks(st, *a, cfg), states, inputs)


def fleet_run_lio_superblocks(
    states: LIOState,  # leading axis B on every tensor
    scan_points: torch.Tensor,  # (B, T, S, 3)
    scan_mask: torch.Tensor,  # (B, T, S)
    imu_gyro: torch.Tensor,  # (B, T, K, 3)
    imu_accel: torch.Tensor,  # (B, T, K, 3)
    imu_dt: torch.Tensor,  # (B, T, K)
    gps_pos: torch.Tensor,  # (B, T, 3)
    gps_var: torch.Tensor,  # (B, T)
    gps_valid: torch.Tensor,  # (B, T)
    config: LIOConfig,
    mesh=None,
) -> tuple[LIOState, LIOOutput]:
    """The production whole-block loop (`run_lio_superblocks`, one K7
    launch a block) for each robot in turn, as each device of the JAX
    package's `dp` mesh maps it over its robots. One card holds the whole
    fleet: `mesh` must be None or name a single device."""
    if mesh is not None and np.asarray(getattr(mesh, "devices", mesh)).size != 1:
        raise ValueError("fleet_run_lio_superblocks: the port runs the fleet on one card")
    inputs = (scan_points, scan_mask, imu_gyro, imu_accel, imu_dt, gps_pos, gps_var, gps_valid)
    return _per_robot(lambda st, *a: run_lio_superblocks(st, *a, config), states, inputs)

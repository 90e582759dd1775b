"""Fleet native-mode LIO: B robots' odometry in one call (port of the JAX
`parallel/lio_fleet.py`).

Every input gains a leading robot axis B; so does every tensor of the fleet
state (`LIOState`, whose slot and frame counters all robots share: they run
the same frames). Per-robot odometry is embarrassingly parallel. The JAX
package vmaps `run_lio_blocks` on its XLA backend (the single-shot kernels
do not vmap) and shards `run_lio_superblocks` over a `dp` mesh, one
`lax.map` of robots per device. The port splits the robots over a
`parallel/mesh.Mesh` in contiguous blocks (B must be a multiple of its
shard count): each process runs its block one robot after another (B
robots cost B launches of the per-frame kernels or of K7 a block), and the
outputs are gathered over the mesh's processes, so every process returns
the whole fleet. No other collective is needed. With no mesh one process
runs every robot. Batching robots into one launch is later work.
"""

from __future__ import annotations

import torch

from slam_sensor_fusion_tpu_torch.models.lio import (
    LIOConfig,
    LIOOutput,
    LIOState,
    init_state,
    run_lio_blocks,
    run_lio_superblocks,
)
from slam_sensor_fusion_tpu_torch.parallel.mesh import Mesh, tree_index, tree_stack


def _xla_config(config: LIOConfig) -> LIOConfig:
    """The registration backend forced to the dense "xla" form, as the JAX
    package's vmapped fleet does."""
    if config.p2p.nn_backend in ("fused", "pallas"):
        return config._replace(p2p=config.p2p._replace(nn_backend="xla"))
    return config


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
    return tree_stack([init_state(cfg, s, m, T) for s, m, T in zip(scans, masks, T0)])


def _per_robot(run, states: LIOState, inputs, mesh: Mesh | None) -> tuple[LIOState, LIOOutput]:
    """`run` for each robot of this process's block in turn, the results
    stacked and gathered over the mesh."""
    B = inputs[0].shape[0]
    block = range(B) if mesh is None else range(*mesh.local_block(B).indices(B))
    finals, outs = [], []
    for b in block:
        fin, out = run(tree_index(states, b), *[a[b] for a in inputs])
        finals.append(fin)
        outs.append(out)
    fin, out = tree_stack(finals), tree_stack(outs)
    if mesh is not None:
        fin, out = mesh.gather_tree(fin), mesh.gather_tree(out)
    return fin, out


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
    mesh: Mesh | None = None,
) -> tuple[LIOState, LIOOutput]:
    """`run_lio_blocks` for each robot on the dense ("xla") registration
    backend, as the JAX package's vmapped fleet runs it; the robots split
    over `mesh` (None: every robot in this process)."""
    cfg = _xla_config(config)
    inputs = (scan_points, scan_mask, imu_gyro, imu_accel, imu_dt, gps_pos, gps_var, gps_valid)
    return _per_robot(lambda st, *a: run_lio_blocks(st, *a, cfg), states, inputs, mesh)


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
    mesh: Mesh | None = None,
) -> tuple[LIOState, LIOOutput]:
    """The production whole-block loop (`run_lio_superblocks`, one K7
    launch a block) for each robot of this process's block of `mesh` in
    turn, as each device of the JAX package's `dp` mesh maps it over its
    robots (None: every robot in this process). B must be a multiple of
    the mesh's shard count."""
    inputs = (scan_points, scan_mask, imu_gyro, imu_accel, imu_dt, gps_pos, gps_var, gps_valid)
    return _per_robot(lambda st, *a: run_lio_superblocks(st, *a, config), states, inputs, mesh)

"""Fleet-parallel localization: a batch of sequences (port of the JAX
`parallel/batch.py`).

Every input gains a leading batch axis B, one sequence a row, each against
its own map. Pose estimation across robots is embarrassingly parallel: no
collective in the steady state.

* `batched_run_chunk` is the JAX `vmap` of the per-frame `step` over the
  batch, on the "xla" correspondence backend the JAX function forces (its
  single-shot kernels do not vmap): the gated XLA search of
  ops/icp._icp_xla. The port runs the B sequences frame by frame in turn,
  the vmap's semantics.
* `fleet_run_chunk_fast` is the production superblock pipeline over a
  `dp` mesh (JAX's `shard_map` of `run_chunk_fast`, `lax.map` over each
  device's sub-batch): each process runs its block of sequences through
  `run_chunk_fast`, one K1 launch a superblock, one sequence after another,
  and the outputs are gathered over the mesh's processes.

Batching B sequences into one K1 grid (B leaders) is kernel work for later.
"""

from __future__ import annotations

import dataclasses

import torch

from slam_sensor_fusion_tpu_torch.models.localization import (
    FrameBatch,
    PipelineState,
    StepOutput,
    init_state,
    join_outputs,
    step,
)
from slam_sensor_fusion_tpu_torch.models.pipeline_fast import PagedFrames, run_chunk_fast
from slam_sensor_fusion_tpu_torch.ops import cloud as cl
from slam_sensor_fusion_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    tree_index,
    tree_map,
    tree_stack,
)
from slam_sensor_fusion_tpu_torch.utils.config import LocalizationConfig


def batched_init_state(
    config: LocalizationConfig,
    first_gps_pose,  # (B, 4, 4)
    first_odom_pose,  # (B, 4, 4)
    device: torch.device | str = torch.device("cuda"),
) -> PipelineState:
    """`init_state` for each of B sequences (leading axis B on every
    tensor), from arrays or tensors, on `device`."""
    gps = torch.as_tensor(first_gps_pose, dtype=torch.float32, device=device)
    odom = torch.as_tensor(first_odom_pose, dtype=torch.float32, device=device)
    single = init_state(config, 0, gps[0], odom[0])
    batched = tree_stack([single] * gps.shape[0])
    return batched._replace(map_T_sensor=gps, odom_T_sensor_previous=odom, map_T_ref=gps)


def _xla_config(config: LocalizationConfig) -> LocalizationConfig:
    """Both ICPs on the "xla" correspondence backend, as the JAX
    `batched_run_chunk` forces."""
    return dataclasses.replace(
        config,
        icp=dataclasses.replace(config.icp, nn_backend="xla"),
        rescue_icp=dataclasses.replace(config.rescue_icp, nn_backend="xla"),
    )


def batched_run_chunk(
    states: PipelineState,  # leading axis B on every tensor
    frames: FrameBatch,  # (B, T, ...)
    map_clouds: cl.Cloud,  # (B, N, 3) / (B, N): one map a sequence
    config: LocalizationConfig,
) -> tuple[PipelineState, StepOutput]:
    """The per-frame `step` over a (B, T, ...) chunk: frame by frame, each
    sequence in turn, on the "xla" backend. Returns the final states and
    the outputs, both with a leading axis B (outputs (B, T, ...))."""
    cfg = _xla_config(config)
    B, T = frames.valid.shape[:2]
    carry = [tree_index(states, b) for b in range(B)]
    outs = [[] for _ in range(B)]
    for k in range(T):
        for b in range(B):
            carry[b], out = step(
                carry[b], *[x[b, k] for x in frames], tree_index(map_clouds, b), cfg)
            outs[b].append(out)
    return tree_stack(carry), tree_stack([join_outputs(o, torch.stack) for o in outs])


def shard_batch(tree, mesh: Mesh):
    """Every tensor of `tree` placed with its leading axis split over the
    mesh (JAX's `device_put` with `batch_sharding`): checked to split
    evenly and moved to this process's device."""
    return tree_map(batch_sharding(mesh), tree)


def fleet_run_chunk_fast(
    states: PipelineState,  # leading axis B on every tensor
    frames: PagedFrames,  # (B, T, ...)
    map_clouds: cl.Cloud,  # (B, N, 3) / (B, N)
    config: LocalizationConfig,
    mesh: Mesh,
) -> tuple[PipelineState, StepOutput]:
    """The production superblock pipeline for a fleet split over a `dp`
    mesh: each sequence of this process's block through `run_chunk_fast`
    (one K1 launch a superblock) in turn, then the results gathered over
    the mesh. B must be a multiple of the mesh's shard count."""
    B = frames.valid.shape[0]
    block = mesh.local_block(B)
    finals, outs = [], []
    for b in range(*block.indices(B)):
        fin, out = run_chunk_fast(
            tree_index(states, b), tree_index(frames, b), tree_index(map_clouds, b), config)
        finals.append(fin)
        outs.append(out)
    return mesh.gather_tree(tree_stack(finals)), mesh.gather_tree(tree_stack(outs))

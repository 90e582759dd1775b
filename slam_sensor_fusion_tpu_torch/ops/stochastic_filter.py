"""Stochastic outlier gate on fused pose priors (port of the JAX
`ops/stochastic_filter.py`, itself a rebuild of stochastic_filter.cpp).

Replicated semantics, quirks included:

* weights w_i = exp(i - queue_size), normalized; queue index 0 is the
  OLDEST transition (stochastic_filter.cpp:14-26, :44-55);
* transitions are previous_prior^-1 @ current_prior (:52);
* the z-score prediction composes origin_pose_previous @ transition (:72)
  but the replacement mean pose composes transition @ origin_pose_previous
  (:106) — an operand-order inconsistency kept for trajectory parity;
* per-axis weighted MEAN ABSOLUTE deviation, clamped to
  [min_distance_per_scan, max_distance_per_scan / 3] (:80-87);
* z-score is 0 while the queue is not yet full (:60-63).

Pure functions on a `FilterState`; nothing here syncs with the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_sensor_fusion_tpu_torch.ops.geometry import inv_T
from slam_sensor_fusion_tpu_torch.utils.config import StochasticFilterConfig


class FilterState(NamedTuple):
    """The transition queue."""

    transitions: torch.Tensor  # (queue_size, 4, 4), index 0 oldest
    count: torch.Tensor  # () int32, saturates at queue_size
    previous_pose: torch.Tensor  # (4, 4) last pose added to the queue


def init_state(
    config: StochasticFilterConfig, device: torch.device | str = torch.device("cuda")
) -> FilterState:
    eye = torch.eye(4, dtype=torch.float32, device=device)
    return FilterState(
        transitions=eye.repeat(config.queue_size, 1, 1),
        count=torch.zeros((), dtype=torch.int32, device=device),
        previous_pose=eye.clone(),
    )


def _weights(config: StochasticFilterConfig, device) -> torch.Tensor:
    i = torch.arange(config.queue_size, dtype=torch.float32, device=device)
    w = torch.exp(i - config.queue_size)
    return w / w.sum()


def add_pose(
    state: FilterState, pose: torch.Tensor, config: StochasticFilterConfig
) -> FilterState:
    """Push previous_pose^-1 @ pose; while filling, write slot `count`,
    once full drop the oldest (stochastic_filter.cpp:44-55)."""
    Q = config.queue_size
    transition = inv_T(state.previous_pose) @ pose
    shifted = torch.cat([state.transitions[1:], transition[None]])
    slot = torch.arange(Q, device=pose.device) == state.count
    filled = torch.where(slot[:, None, None], transition, state.transitions)
    transitions = torch.where(state.count < Q, filled, shifted)
    count = torch.clamp(state.count + 1, max=Q)
    return FilterState(transitions, count, pose)


def pose_z_score(
    state: FilterState,
    origin_pose_previous: torch.Tensor,
    origin_pose_current: torch.Tensor,
    config: StochasticFilterConfig,
) -> torch.Tensor:
    """Max per-axis z-score of the current pose vs the queue's prediction
    (stochastic_filter.cpp:57-92)."""
    w = _weights(config, origin_pose_current.device)
    preds = torch.einsum("ij,qjk->qik", origin_pose_previous, state.transitions)
    xyz = preds[:, :3, 3]
    xyz_mean = (w[:, None] * xyz).sum(dim=0)
    mad = (w[:, None] * (xyz - xyz_mean[None]).abs()).sum(dim=0)
    mad = torch.clamp(
        mad, config.min_distance_per_scan, config.max_distance_per_scan / 3.0
    )
    z_max = ((origin_pose_current[:3, 3] - xyz_mean).abs() / mad).amax()
    return torch.where(state.count < config.queue_size, 0.0, z_max)


def apply_gate(
    state: FilterState,
    origin_pose_previous: torch.Tensor,
    origin_pose_current: torch.Tensor,
    config: StochasticFilterConfig,
) -> torch.Tensor:
    """Replace the pose by the weighted-mean prediction when gated
    (stochastic_filter.cpp:94-113), with :106's transition @ previous
    order."""
    z = pose_z_score(state, origin_pose_previous, origin_pose_current, config)
    w = _weights(config, origin_pose_current.device)
    mean_pose = torch.einsum(
        "q,qij->ij",
        w,
        torch.einsum("qij,jk->qik", state.transitions, origin_pose_previous),
    )
    return torch.where(
        z > config.z_score_threshold, mean_pose, origin_pose_current
    )

"""Map-sharded (`sp` axis) registration: ICP and point-to-plane against a
map split into Morton-contiguous shards (port of the JAX
`parallel/map_shard.py`).

The JAX package shards the MAP over a mesh's `sp` axis, so the map is not
capped at one chip's memory: the Morton-sorted map is split into
contiguous chunks (spatially compact, so each shard's tile culling stays
tight), every device associates the replicated scan against its own shard
with the production kernel, the per-point winners are all-gathered and the
first argmin over the shards is taken, and the rest of the registration
runs replicated. The port does the same on a `parallel/mesh.Mesh`: each
process calls the kernel once for each shard it holds (K2 for the
point-to-point ICP, K5 for point-to-plane), `Mesh.combine_winners` gathers
the winners over the mesh's processes and combines them, and the loop
goes on replicated (K6 once for point-to-plane). An exact tie keeps the
earlier shard, as `jnp.argmin` does. The centre every shard's pages are
rebased on is the frame's (the prior's translation), so a point pair's
distance does not depend on the shard that holds it.

`sp_run_chunk` is the steady-state loop against the sharded map, frame by
frame as the JAX scan is; `sp_run_chunk_single` the same frame body on the
whole map, its equality oracle.

Inputs are the JAX functions' global view: `shard_cloud`'s (n_shards * cap,
3) array, or a `ShardedP2PTarget`; each process takes its own shards'
rows. Outputs are replicated on every process.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.ops import geometry as geo
from slam_sensor_fusion_tpu_torch.ops import stochastic_filter as sf
from slam_sensor_fusion_tpu_torch.ops.icp import ICPResult, _icp_pairs
from slam_sensor_fusion_tpu_torch.ops.p2p_fused import (
    CachedP2PTarget,
    associate_p2p_fused,
    build_cached_p2p_target,
    p2p_gn_from_correspondences,
)
from slam_sensor_fusion_tpu_torch.ops.point_to_plane import (
    PointToPlaneConfig,
    PointToPlaneResult,
)
from slam_sensor_fusion_tpu_torch.parallel.mesh import Mesh, make_mesh
from slam_sensor_fusion_tpu_torch.utils.config import ICPConfig, StochasticFilterConfig


def shard_cloud(
    points: np.ndarray,  # (N, 3) Morton-sorted valid points
    n_shards: int,
    tile_tgt: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Split a Morton-sorted cloud into `n_shards` contiguous chunks of
    ceil(N / n_shards) points, each padded to a multiple of `tile_tgt`,
    concatenated into one (n_shards * cap, 3) array and its mask."""
    n = len(points)
    per = -(-n // n_shards)  # ceil
    cap = -(-per // tile_tgt) * tile_tgt
    out = np.zeros((n_shards * cap, 3), np.float32)
    mask = np.zeros(n_shards * cap, bool)
    for s in range(n_shards):
        chunk = points[s * per : (s + 1) * per]
        out[s * cap : s * cap + len(chunk)] = chunk
        mask[s * cap : s * cap + len(chunk)] = True
    return out, mask


def _local_shards(mesh: Mesh, target_shards: torch.Tensor, target_shard_mask: torch.Tensor):
    """[(points, mask)] of the shards this process holds, on its device."""
    cap = target_shards.shape[0] // mesh.n_shards
    if cap * mesh.n_shards != target_shards.shape[0]:
        raise ValueError(
            f"{target_shards.shape[0]} map rows do not split into {mesh.n_shards} shards")
    return [
        (target_shards[s * cap : (s + 1) * cap].to(mesh.device),
         target_shard_mask[s * cap : (s + 1) * cap].to(mesh.device))
        for s in mesh.local_shards
    ]


def sp_icp_align(
    source: torch.Tensor,  # (M, 3) padded scan
    source_mask: torch.Tensor,  # (M,)
    target_shards: torch.Tensor,  # (n_shards * cap, 3) from shard_cloud
    target_shard_mask: torch.Tensor,  # (n_shards * cap,)
    initial_T: torch.Tensor,  # (4, 4)
    config: ICPConfig,
    mesh: Mesh,
) -> ICPResult:
    """Point-to-point ICP with the map sharded over `mesh`: the parity
    pair-list loop (ops/icp._icp_pairs), K2 once a shard an association,
    each shard against its own pair list (max_pairs = nSt *
    max_pairs_factor a shard), the winners combined over the mesh. Equals
    `icp_align` against the whole map up to exact distance ties; the
    overflow flag is the OR over the shards."""
    return _icp_pairs(
        source, source_mask, _local_shards(mesh, target_shards, target_shard_mask),
        initial_T, config, mesh,
    )


class ShardedP2PTarget(NamedTuple):
    """Per-shard point-to-plane target pages (xyz + normals): shard s is the
    complete `CachedP2PTarget` of rows [s * cap, (s + 1) * cap) of the page
    and box arrays, all rebased by the SAME `center` so winners combine in
    one frame."""

    pages: torch.Tensor  # (n_shards * nTt_cap, 6, TN)
    lo: torch.Tensor  # (n_shards * nTt_cap, 3) tile bbox minima (original frame)
    hi: torch.Tensor
    center: torch.Tensor  # (3,)
    n_shards: int

    def shard(self, s: int) -> CachedP2PTarget:
        """Shard s as the cached target its device would hold."""
        cap = self.pages.shape[0] // self.n_shards
        rows = slice(s * cap, (s + 1) * cap)
        return CachedP2PTarget(
            pages=self.pages[rows], lo=self.lo[rows], hi=self.hi[rows], center=self.center
        )


def shard_p2p_target(
    points: np.ndarray,  # (N, 3) Morton-sorted valid points
    normals: np.ndarray,  # (N, 3)
    normals_valid: np.ndarray,  # (N,) bool
    n_shards: int,
    tile_tgt: int,
    center: np.ndarray | None = None,
    device: torch.device | str = torch.device("cuda"),
) -> ShardedP2PTarget:
    """Split a Morton-sorted cloud + normals into `n_shards` contiguous
    chunks of ceil(N / n_shards) points, each padded to a multiple of
    `tile_tgt`, and pack each as 6-row pages (`build_cached_p2p_target`)
    on `device`."""
    dev = torch.device(device)
    if center is None:
        center = np.zeros(3, np.float32)
    n = len(points)
    per = -(-n // n_shards)  # ceil
    cap = -(-per // tile_tgt) * tile_tgt
    ctr = torch.as_tensor(np.asarray(center, np.float32), device=dev)
    pages, lo, hi = [], [], []
    for s in range(n_shards):
        sl = slice(s * per, (s + 1) * per)
        k = len(points[sl])
        pts = np.zeros((cap, 3), np.float32)
        nrm = np.zeros((cap, 3), np.float32)
        nv = np.zeros(cap, bool)
        pts[:k] = points[sl]
        nrm[:k] = normals[sl]
        nv[:k] = normals_valid[sl]
        cached = build_cached_p2p_target(
            torch.from_numpy(pts).to(dev), torch.arange(cap, device=dev) < k,
            torch.from_numpy(nrm).to(dev), torch.from_numpy(nv).to(dev), ctr, tile_tgt,
        )
        pages.append(cached.pages)
        lo.append(cached.lo)
        hi.append(cached.hi)
    return ShardedP2PTarget(
        pages=torch.cat(pages), lo=torch.cat(lo), hi=torch.cat(hi), center=ctr,
        n_shards=n_shards,
    )


def sp_p2p_align(
    source: torch.Tensor,  # (M, 3) padded scan
    source_mask: torch.Tensor,  # (M,)
    target: ShardedP2PTarget,
    initial_T: torch.Tensor,  # (4, 4)
    config: PointToPlaneConfig,
    mesh: Mesh | None = None,
) -> PointToPlaneResult:
    """Point-to-plane registration with the map split into shards: K5
    against each shard this process holds (its own pair list against that
    shard's boxes), the winners combined over `mesh` by first argmin over
    the shards, then K6 on the combined matched set. With `mesh` None this
    process holds every shard of `target`. Equals
    `point_to_plane_align_fused` with `fixed_correspondences=True` against
    the whole map, up to distance ties, as the JAX function does."""
    if mesh is None:
        mesh = make_mesh(target.n_shards, "sp", source.device, single_process=True)
    if mesh.n_shards != target.n_shards:
        raise ValueError(f"sp_p2p_align: a mesh of {mesh.n_shards} shards for a map of "
                         f"{target.n_shards}")
    d2s, qns = [], []
    for s in mesh.local_shards:
        d2, qn = associate_p2p_fused(source, source_mask, target.shard(s), initial_T, config)
        d2s.append(d2)
        qns.append(qn)
    d2, qn = mesh.combine_winners(d2s, qns)
    return p2p_gn_from_correspondences(
        source, source_mask, d2, qn, initial_T, target.center, config
    )


# ---------------------------------------------------------------------------
# the steady-state loop against the sharded map
# ---------------------------------------------------------------------------


class SpPipelineState(NamedTuple):
    """Per-frame carry of the sharded steady-state loop (the small-state
    part of models/localization.PipelineState: pose, odometry reference,
    stochastic-filter queue; all replicated, the map is the sharded part
    and needs no carry)."""

    map_T_sensor: torch.Tensor  # (4, 4)
    odom_T_sensor_previous: torch.Tensor  # (4, 4)
    filter_state: sf.FilterState


class SpStepOutput(NamedTuple):
    map_T_sensor: torch.Tensor  # (T, 4, 4)
    icp_error: torch.Tensor
    icp_converged: torch.Tensor
    n_correspondences: torch.Tensor
    #: visit/pair-list truncation this frame (must stay 0)
    pair_overflow: torch.Tensor


def sp_init_state(
    first_gps_pose,
    first_odom_pose,
    filter_config: StochasticFilterConfig,
    device: torch.device | str = torch.device("cuda"),
) -> SpPipelineState:
    """The loop's first carry from the first GPS and odometry poses
    (arrays or tensors), on `device`."""
    return SpPipelineState(
        map_T_sensor=torch.as_tensor(first_gps_pose, dtype=torch.float32, device=device),
        odom_T_sensor_previous=torch.as_tensor(first_odom_pose, dtype=torch.float32,
                                               device=device),
        filter_state=sf.init_state(filter_config, device),
    )


def _sp_frame_body(
    carry: SpPipelineState,
    xs,
    targets: list,
    icp_config: ICPConfig,
    filter_config: StochasticFilterConfig,
    mesh: Mesh | None,
) -> tuple[SpPipelineState, SpStepOutput]:
    """One steady-state frame (the fine section of localization's step:
    odometry prediction, covariance blend, stochastic gate, ICP,
    localization_node.cpp:317-341), the ICP against the shards `targets`
    this process holds with the winners combined over `mesh`. With `mesh`
    None and the whole map it is the single-device oracle."""
    sp, sm, odom_T, gps_T, odom_cov, gps_cov = xs
    previous_T_current = geo.inv_T(carry.odom_T_sensor_previous) @ odom_T
    odom_pred = carry.map_T_sensor @ previous_T_current
    total = odom_cov + gps_cov
    prior = (gps_cov / total) * odom_pred + (odom_cov / total) * gps_T
    fs = sf.add_pose(carry.filter_state, prior, filter_config)
    prior = sf.apply_gate(fs, carry.map_T_sensor, prior, filter_config)
    res = _icp_pairs(sp, sm, targets, prior, icp_config, mesh)
    new = SpPipelineState(
        map_T_sensor=res.transformation, odom_T_sensor_previous=odom_T, filter_state=fs,
    )
    out = SpStepOutput(
        map_T_sensor=res.transformation,
        icp_error=res.error,
        icp_converged=res.has_converged,
        n_correspondences=res.n_correspondences,
        pair_overflow=torch.as_tensor(res.pair_overflow, dtype=torch.bool, device=prior.device),
    )
    return new, out


def _frames(state, xs, targets, icp_config, filter_config, mesh):
    outs = []
    for k in range(xs[0].shape[0]):
        state, out = _sp_frame_body(
            state, [x[k] for x in xs], targets, icp_config, filter_config, mesh)
        outs.append(out)
    return state, SpStepOutput(*[torch.stack(f) for f in zip(*outs)])


def sp_run_chunk(
    state: SpPipelineState,
    scan_points: torch.Tensor,  # (T, M, 3) per-frame scans
    scan_mask: torch.Tensor,  # (T, M)
    odom_T_sensor: torch.Tensor,  # (T, 4, 4)
    map_T_sensor_gps: torch.Tensor,  # (T, 4, 4)
    odom_cov_trace: torch.Tensor,  # (T,)
    gps_cov_trace: torch.Tensor,  # (T,)
    target_shards: torch.Tensor,  # (n_shards * cap, 3) from shard_cloud
    target_shard_mask: torch.Tensor,
    icp_config: ICPConfig,
    filter_config: StochasticFilterConfig,
    mesh: Mesh,
) -> tuple[SpPipelineState, SpStepOutput]:
    """The steady-state localization loop against a map sharded over
    `mesh`: prediction, blend, gate and ICP a frame, every association K2
    once a shard this process holds, the winners combined over the mesh.
    There is no per-frame re-crop: each shard is its process's resident
    part of the map, and each shard's tile culling plays the crop's role.
    Carry and outputs are replicated; equal to `sp_run_chunk_single` on the
    whole map up to exact distance ties."""
    xs = (scan_points, scan_mask, odom_T_sensor, map_T_sensor_gps, odom_cov_trace,
          gps_cov_trace)
    return _frames(state, xs, _local_shards(mesh, target_shards, target_shard_mask),
                   icp_config, filter_config, mesh)


def sp_run_chunk_single(
    state: SpPipelineState,
    scan_points: torch.Tensor,
    scan_mask: torch.Tensor,
    odom_T_sensor: torch.Tensor,
    map_T_sensor_gps: torch.Tensor,
    odom_cov_trace: torch.Tensor,
    gps_cov_trace: torch.Tensor,
    target: torch.Tensor,  # (N, 3) the whole map
    target_mask: torch.Tensor,
    icp_config: ICPConfig,
    filter_config: StochasticFilterConfig,
) -> tuple[SpPipelineState, SpStepOutput]:
    """The single-device oracle of `sp_run_chunk`: the same frame body
    against the whole map, with no mesh."""
    xs = (scan_points, scan_mask, odom_T_sensor, map_T_sensor_gps, odom_cov_trace,
          gps_cov_trace)
    return _frames(state, xs, [(target, target_mask)], icp_config, filter_config, None)

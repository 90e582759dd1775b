"""Point-to-point parity ICP on K2 (port of the JAX `ops/icp.py`, its
pages-native `_icp_pallas` algorithm).

A rebuild of ICPPointToPoint (icp_point_to_point.cpp:185-254) with the
reference's control flow:

* initial correspondences are found ONCE against the prior-transformed
  source and then stay fixed (:193-195) — a shrinking `alive` mask here;
* abort with the prior below `min_correspondences` matches (:196-200);
* per iteration: masked mean Euclidean error (:161-170); early exit when it
  is below acceptable_mean_error (:215-219); LAZY re-association only when
  |last_error - error| < transformation_epsilon (:221-224);
* Kabsch/SVD step on the matched pairs (:112-159), left-composed (:228).

State lives in (n_tiles, 3, TILE) page layout, rebased on the initial
translation; every association is one K2 call (ops/nn_pallas.pair_nn)
against a tile pair list built with the gate radius dilated by
`reassoc_margin`. A movement guard rebuilds the list once accumulated motion
could exceed that margin, so metre-scale rescue alignments never miss true
neighbours. The loop runs on the host (one sync per iteration): the
startup rescue, the per-frame parity engine and the map-sharded loop run
it, not the superblock path.

`_icp_xla` is the same control flow on the (M, 3) layout, on the gated XLA
search (ops/nn_gated.gated_nn) or the dense sweep: what `icp_align` runs
off the "pallas" backend, without `gated` or at capacities that are not
multiples of the tiles, as the JAX `icp_align` dispatches (the JAX package
computes it with XLA, so plain PyTorch is the port; there is no kernel).

`_icp_pairs` also runs against a map split into shards
(parallel/map_shard.sp_icp_align): K2 once a shard, the winners combined
over the mesh.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slam_sensor_fusion_tpu_torch.ops import geometry
from slam_sensor_fusion_tpu_torch.ops.cloud import dist2
from slam_sensor_fusion_tpu_torch.ops.morton import tile_bboxes
from slam_sensor_fusion_tpu_torch.ops.nn import nearest_neighbor
from slam_sensor_fusion_tpu_torch.ops.nn_gated import gated_nn, pair_tiles
from slam_sensor_fusion_tpu_torch.ops.nn_pallas import (
    _build_tile_pair_list,
    make_pages,
    pair_nn,
)
from slam_sensor_fusion_tpu_torch.utils.config import ICPConfig

_F32_MAX = 3.4028234663852886e38


class ICPResult(NamedTuple):
    """Mirror of the reference's ICPResult (icp_point_to_point.h:28-39)
    plus observability extras."""

    transformation: torch.Tensor  # (4, 4)
    error: torch.Tensor  # () mean correspondence error [m]
    iterations: torch.Tensor  # () int32
    has_converged: torch.Tensor  # () bool
    n_correspondences: torch.Tensor  # () int32
    #: () bool — the pair list was truncated (max_visits / max_pairs)
    pair_overflow: torch.Tensor
    #: () f32 — smallest det of K3's Kabsch moment matrix (0 here, as on
    #: the JAX package's non-fused paths); near 0 = degenerate geometry
    det_min: torch.Tensor | float = 0.0
    #: (num_iterations,) per-iteration mean error (the reference's
    #: printStepDebug trace); the JAX package exports it only from its XLA
    #: engine under ICPConfig.debug_trace, which the port does not have
    error_trace: torch.Tensor | None = None


def _pages_transform(T: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform to (nSt, 3, TM) pages."""
    out = torch.einsum("ij,sjt->sit", T[:3, :3], pages) + T[:3, 3][None, :, None]
    return out.contiguous()


def _pages_masked_mean_error(pts, corr, w) -> torch.Tensor:
    """Mean Euclidean error over matched entries (icp_point_to_point.cpp:161-170)."""
    d = pts - corr
    d = torch.sqrt(torch.clamp(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2], min=0.0))
    return (d * w).sum() / torch.clamp(w.sum(), min=1.0)


def _pages_kabsch(src: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted Kabsch on (nSt, 3, TM) pages (icp_point_to_point.cpp:112-159):
    SVD of the cross-covariance, reflection fixed by flipping V's last
    column."""
    wsum = torch.clamp(w.sum(), min=1e-12)
    c_src = torch.einsum("sct,st->c", src, w) / wsum
    c_tgt = torch.einsum("sct,st->c", tgt, w) / wsum
    src0 = (src - c_src[None, :, None]) * w[:, None, :]
    tgt0 = tgt - c_tgt[None, :, None]
    H = torch.einsum("sct,sdt->cd", src0, tgt0)
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.T
    det = torch.linalg.det(V @ U.T)
    flip = torch.ones(3, dtype=H.dtype, device=H.device)
    flip[2] = torch.where(det < 0, -1.0, 1.0)
    R = (V * flip[None, :]) @ U.T
    return geometry.make_T(R, c_tgt - R @ c_src)


def _pages_bboxes(pages: torch.Tensor, mask_pages: torch.Tensor):
    """tile_bboxes over (nSt, 3, TM) pages (invalid entries excluded)."""
    m = mask_pages[:, None, :]
    lo = torch.where(m, pages, torch.inf).amin(dim=2)
    hi = torch.where(m, pages, -torch.inf).amax(dim=2)
    return lo, hi


def _step_displacement_bound(T_step: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Max displacement of any point within radius `rho` of the origin
    under the rigid step: ||t|| + 2 sin(theta/2) rho."""
    R = T_step[:3, :3]
    cos_theta = torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    half = torch.sqrt(torch.clamp(0.5 * (1.0 - cos_theta), min=0.0))
    return torch.linalg.norm(T_step[:3, 3]) + 2.0 * half * rho


def _pair_list_builder(target, target_mask, config: ICPConfig, nSt: int):
    """Tile pair lists against the target's (fixed) tile boxes with the gate
    radius dilated by `reassoc_margin`: build(lo_s, hi_s, cnt_s) ->
    ((pair_start, pair_cnt, pair_tgt), overflow)."""
    lo_t, hi_t, _ = tile_bboxes(target, target_mask, config.tile_tgt)
    search_r2 = (math.sqrt(config.max_correspondence_dist_sq) + config.reassoc_margin) ** 2
    max_pairs = nSt * config.max_pairs_factor

    def build(lo_s, hi_s, cnt_s):
        visits, counts, v_ovf = pair_tiles(
            lo_s, hi_s, cnt_s, lo_t, hi_t, search_r2, config.max_visits
        )
        pairs = _build_tile_pair_list(visits, counts, max_pairs)
        return pairs, v_ovf | (counts.sum() > max_pairs)

    return build


def _stage(source, source_mask, targets, initial_T, config: ICPConfig):
    """Stage the first association of the pair-list loop against the
    target shards `targets` [(target, target_mask)]: (source points under
    initial_T, their pages, each shard's target pages, pair-list builder
    and first pair list, the lists' overflow flag). Every page set is
    rebased on initial_T's translation, the same centre for every shard, so
    a point pair's d2 does not depend on the shard that holds the target
    point; +1e7 sentinels."""
    TM, TN = config.tile_src, config.tile_tgt
    bad = [t.shape[0] for t, _ in targets if t.shape[0] % TN]
    if source.shape[0] % TM or bad:
        raise ValueError(
            f"icp_align: capacities {source.shape[0]}, {[t.shape[0] for t, _ in targets]} "
            f"are not multiples of the tiles {TM}, {TN}"
        )
    center = initial_T[:3, 3]
    pts0_flat = geometry.transform_points(initial_T, source)
    box0 = tile_bboxes(pts0_flat, source_mask, TM)
    builds = [_pair_list_builder(t, m, config, source.shape[0] // TM) for t, m in targets]
    firsts = [build(*box0) for build in builds]
    overflow = torch.stack([ovf for _, ovf in firsts]).any()
    pts = make_pages(pts0_flat, source_mask, center, TM)
    tgt_pages = [make_pages(t, m, center, TN) for t, m in targets]
    return pts0_flat, pts, tgt_pages, builds, [pairs for pairs, _ in firsts], overflow


def association_inputs(source, source_mask, target, target_mask, initial_T, config: ICPConfig):
    """K2's inputs for the first association of `icp_align`: (source pages
    under initial_T, target pages, pair_start, pair_cnt, pair_tgt)."""
    _, pts, tgt_pages, _, pairs, _ = _stage(
        source, source_mask, [(target, target_mask)], initial_T, config
    )
    return (pts, tgt_pages[0], *pairs[0])


def _icp_xla(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    initial_T: torch.Tensor,
    config: ICPConfig,
    use_gated: bool = False,
) -> ICPResult:
    """The (M, 3)-layout ICP (the JAX `_icp_xla`): the same control flow as
    the pair-list loop, each association either the gated XLA formulation
    (ops/nn_gated.gated_nn, `use_gated`: capacities that are multiples of
    the tiles) or the dense sweep (ops/nn.nearest_neighbor, any
    capacities). `icp_align` takes it off the "pallas" backend, and the
    fused ICP for capacities that are not multiples of the tiles.
    `pair_overflow` is the first association's visit-list truncation, as
    in the JAX function. The loop runs on the host, one sync an
    iteration."""
    dev = source.device
    gate = config.max_correspondence_dist_sq
    center = initial_T[:3, 3]

    def associate(pts, mask):
        if use_gated:
            res = gated_nn(
                pts, mask, target, target_mask, center, gate, config.tile_src,
                config.tile_tgt, config.max_visits,
            )
            return res.d2, target[res.idx.long()], res.visit_overflow
        d2, idx = nearest_neighbor(pts, mask, target, target_mask, center)
        return d2, target[idx.long()], torch.zeros((), dtype=torch.bool, device=dev)

    def mean_error(pts, corr, alive):
        w = alive.float()
        return (torch.linalg.norm(pts - corr, dim=-1) * w).sum() / torch.clamp(w.sum(), min=1.0)

    pts = geometry.transform_points(initial_T, source)
    d2, corr, pair_overflow = associate(pts, source_mask)
    alive = source_mask & (d2 < gate)
    n_corr0 = alive.sum(dtype=torch.int32)
    enough = int(n_corr0) >= config.min_correspondences
    T = initial_T
    i = 0
    last_error = torch.tensor(_F32_MAX, dtype=torch.float32, device=dev)
    done = not enough
    while i < config.num_iterations and not done:
        error = mean_error(pts, corr, alive)
        done = bool(error < config.acceptable_mean_error)
        if not done:
            if bool((last_error - error).abs() < config.transformation_epsilon):
                d2n, corr_n, _ = associate(pts, alive)
                alive = alive & (d2n < gate)
                corr = torch.where(alive[:, None], corr_n, corr)
            T_step = geometry.kabsch(pts, corr, alive.float())
            T = T_step @ T
            pts = geometry.transform_points(T_step, pts)
            i += 1
        last_error = error
    error_out = last_error if enough else torch.tensor(1e6, device=dev)
    return ICPResult(
        transformation=T if enough else initial_T,
        error=error_out,
        iterations=torch.tensor(i if enough else 0, dtype=torch.int32, device=dev),
        has_converged=torch.tensor(
            enough and bool(error_out < config.acceptable_mean_error), device=dev
        ),
        n_correspondences=n_corr0,
        pair_overflow=pair_overflow,
        det_min=torch.zeros((), dtype=torch.float32, device=dev),
    )


def icp_align(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    initial_T: torch.Tensor,
    config: ICPConfig = ICPConfig(),
) -> ICPResult:
    """Align ``source`` (M, 3) onto ``target`` (N, 3) from ``initial_T``.

    Dispatches as the JAX function does (icp.py:481-525): with
    config.gated and M, N multiples of the tiles, the "pallas" backend runs
    the pair-list loop on K2 (`_icp_pairs`) and any other backend the
    gated XLA formulation (`_icp_xla` on ops/nn_gated.gated_nn); otherwise
    the dense sweep (`_icp_xla` on ops/nn.nearest_neighbor). Both clouds
    should be spatially coherent (Morton order) for the tile cull to be
    tight; it is exact for any order."""
    use_gated = (
        config.gated
        and source.shape[0] % config.tile_src == 0
        and target.shape[0] % config.tile_tgt == 0
    )
    if use_gated and config.nn_backend == "pallas":
        return _icp_pairs(source, source_mask, [(target, target_mask)], initial_T, config)
    return _icp_xla(source, source_mask, target, target_mask, initial_T, config, use_gated)


def _icp_pairs(
    source: torch.Tensor,
    source_mask: torch.Tensor,
    targets: list[tuple[torch.Tensor, torch.Tensor]],
    initial_T: torch.Tensor,
    config: ICPConfig,
    mesh=None,
) -> ICPResult:
    """The pair-list loop on K2 (the JAX `_icp_pallas`) against the target
    shards this process holds, `targets` [(target, target_mask)]: one
    (the whole map) with `mesh` None. With a mesh (parallel/mesh.Mesh,
    map-sharded mode, the JAX `axis_name`), every association calls K2
    once a local shard, each against its own pair list, and
    `mesh.combine_winners` gathers the (d2, xyz) winners over every shard
    of the mesh and takes the first argmin over the shard axis (an exact
    tie keeps the earlier shard) before the gate; the rest of the loop is
    replicated. `pair_overflow` is then the OR over the shards."""
    dev = source.device
    pts0_flat, pts, tgt_pages, builds, pairs, pair_overflow = _stage(
        source, source_mask, targets, initial_T, config
    )
    gate = config.max_correspondence_dist_sq
    center = initial_T[:3, 3]
    smask_pages = source_mask.reshape(pts.shape[0], config.tile_src)
    cnt_pages = smask_pages.sum(dim=1, dtype=torch.int32)
    rho = torch.sqrt(
        torch.clamp(torch.where(source_mask, dist2(pts0_flat, center), 0.0).amax(), min=0.0)
    )

    def associate(pts_pages, alive_w, pairs):
        outs = [pair_nn(pts_pages, tp, *pr) for tp, pr in zip(tgt_pages, pairs)]
        if mesh is None:
            d2, _, xyz = outs[0]
        else:
            d2, xyz = mesh.combine_winners([o[0] for o in outs], [o[2] for o in outs])
        return xyz, alive_w * (d2[:, 0, :] < gate).float()

    corr, alive = associate(pts, smask_pages.float(), pairs)
    n_corr0 = alive.sum().to(torch.int32)
    enough = int(n_corr0) >= config.min_correspondences

    eye = torch.eye(3, dtype=torch.float32, device=dev)
    T = geometry.make_T(eye, -center) @ initial_T  # rebased frame
    i = 0
    moved = torch.zeros((), dtype=torch.float32, device=dev)
    last_error = torch.tensor(_F32_MAX, dtype=torch.float32, device=dev)
    done = not enough
    while i < config.num_iterations and not done:
        if bool(moved > config.reassoc_margin):
            # past the margin the dilated list may miss true neighbours:
            # rebuild each shard's list from the current point positions
            lo_r, hi_r = _pages_bboxes(pts, smask_pages)
            rebuilt = [build(lo_r + center, hi_r + center, cnt_pages) for build in builds]
            pairs = [p for p, _ in rebuilt]
            pair_overflow = pair_overflow | torch.stack([ovf for _, ovf in rebuilt]).any()
            moved = torch.zeros_like(moved)
        error = _pages_masked_mean_error(pts, corr, alive)
        hit = bool(error < config.acceptable_mean_error)
        if not hit and bool((last_error - error).abs() < config.transformation_epsilon):
            corr_new, alive = associate(pts, alive, pairs)
            corr = torch.where(alive[:, None, :] > 0, corr_new, corr)
        T_step = _pages_kabsch(pts, corr, alive)
        if not hit:
            T = T_step @ T
            pts = _pages_transform(T_step, pts)
            moved = moved + _step_displacement_bound(T_step, rho)
            i += 1
        last_error = error
        done = hit
    if mesh is not None:
        # each shard's lists can truncate on their own; any truncation
        # makes the combined correspondence set suspect
        pair_overflow = mesh.any(pair_overflow)
    final_T = geometry.make_T(eye, center) @ T
    error_out = last_error if enough else torch.tensor(1e6, device=dev)
    return ICPResult(
        transformation=final_T if enough else initial_T,
        error=error_out,
        iterations=torch.tensor(i if enough else 0, dtype=torch.int32, device=dev),
        has_converged=torch.tensor(
            enough and bool(error_out < config.acceptable_mean_error), device=dev
        ),
        n_correspondences=n_corr0,
        pair_overflow=pair_overflow,
        det_min=torch.zeros((), dtype=torch.float32, device=dev),
    )

"""A dry run of the multi-device layer, and its distributed form (port of
the JAX `__graft_entry__.dryrun_multichip`).

`dryrun_multichip(n)` runs every sharded path at the JAX dry run's tiny
sizes over a mesh of n shards held by this process, and holds each sharded
result against its single-device run as the JAX dry run does: the
per-frame fleet (`batched_run_chunk`), the candidate-sharded brute force,
both LIO fleets, the superblock fleet, map-sharded ICP and point-to-plane,
the map-sharded steady state and the sharded voxel store. Where the JAX dry
run checks only a fleet's shape, this one also holds its first sequence
against the sequence's own run.

The distributed form runs the three paths that combine winners over the
mesh (`sp_icp_align`, `sp_p2p_align`, `sharded_brute_force_align`) in
processes of a `torch.distributed` group, each holding its block of the
shards: `run_distributed` spawns the ranks on this host; under `torchrun`
the module is its own entry point:

    torchrun --nproc-per-node N -m slam_sensor_fusion_tpu_torch.parallel.dryrun \
        [--shards S] [--device cuda|cpu]

Each rank runs on `cuda:<local rank>` with NCCL (`--device cuda`, the
default; it raises where no card is present) or on the CPU with gloo
(`--device cpu`), and rank 0 holds the group's results against one process
holding every shard, bit for bit. Without `torchrun` the module runs
`dryrun_multichip` on `--device`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from slam_sensor_fusion_tpu_torch.parallel.mesh import make_mesh, tree_index, tree_stack
from slam_sensor_fusion_tpu_torch.utils.config import (
    BruteForceConfig,
    CloudCapacity,
    LocalizationConfig,
)


def tiny_config() -> LocalizationConfig:
    """The JAX dry run's configuration (`__graft_entry__._tiny_config`)."""
    return LocalizationConfig(
        capacity=CloudCapacity(
            scan=2048, cropped_scan=2048, cropped_map=4096, map=8192,
            bf_source=128, bf_target=512,
        ),
        brute_force=BruteForceConfig(
            x_step=0.2, y_step=0.2, z_step=0.1, x_range=0.4, y_range=0.4, z_range=0.2,
            yaw_step=np.pi / 18, yaw_range=np.pi / 18,
        ),
        map_subsample_step=1,
    )


def _padded(points: np.ndarray, cap: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    pts = np.zeros((cap, 3), np.float32)
    pts[: len(points)] = points
    mask = np.arange(cap) < len(points)
    return torch.from_numpy(pts).to(device), torch.from_numpy(mask).to(device)


def _to(x, device):
    """Every tensor of a nested tuple, list, dict or NamedTuple on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_to(v, device) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    return x


def bit_equal(a, b) -> bool:
    """Nested results equal bit for bit (NaN where NaN)."""
    if isinstance(a, torch.Tensor):
        a, b = a.cpu(), b.cpu()
        return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bit_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(bit_equal(x, y) for x, y in zip(a, b))
    return a == b


# ---------------------------------------------------------------------------
# the three paths that combine over the mesh
# ---------------------------------------------------------------------------


def registration_inputs(device: torch.device | str = torch.device("cuda")) -> dict:
    """The JAX dry run's map-sharded ICP and point-to-plane scene (1500
    Morton-sorted points in a 16 m box, 300 of them shifted as the scan,
    tiles of 128) and its brute-force pair (1024 points, the first 384
    shifted), made from fixed seeds, as keyword arguments of
    `sharded_registration`: {"icp", "p2p", "bf"}."""
    from slam_sensor_fusion_tpu_torch.ops.morton import sort_points_numpy
    from slam_sensor_fusion_tpu_torch.ops.point_to_plane import (
        PointToPlaneConfig,
        estimate_normals,
    )

    config = tiny_config()
    rng = np.random.default_rng(5)
    tgt = sort_points_numpy(rng.uniform(-8, 8, (1500, 3)).astype(np.float32))
    src = tgt[rng.choice(1500, 300, replace=False)] - np.asarray([0.08, 0.05, 0.02], np.float32)
    s, sm = _padded(src, 384, device)
    t, tm = _padded(tgt, 1536, device)
    nrm, nvalid = estimate_normals(t, tm, voxel=4.0)
    rng_bf = np.random.default_rng(3)
    bf_tgt = rng_bf.uniform(-3, 3, (1024, 3)).astype(np.float32)
    bf_src = bf_tgt[: config.capacity.bf_source * 3] - np.asarray([0.35, 0.15, 0.05], np.float32)
    bs, bsm = _padded(bf_src, config.capacity.bf_source * 4, device)
    bt, btm = _padded(bf_tgt, config.capacity.bf_target * 4, device)
    eye = torch.eye(4, device=device)
    return dict(
        icp=dict(source=s, source_mask=sm, map_points=tgt, initial_T=eye,
                 config=dataclasses.replace(config.icp, tile_src=128, tile_tgt=128,
                                            max_pairs_factor=64)),
        p2p=dict(source=s, source_mask=sm, map_points=tgt, map_normals=nrm[:1500].cpu().numpy(),
                 map_normals_valid=nvalid[:1500].cpu().numpy(), center=None, initial_T=eye,
                 config=PointToPlaneConfig(tile_src=128, tile_tgt=128,
                                           fixed_correspondences=True)),
        bf=(bs, bsm, bt, btm, eye, config.brute_force),
    )


def sharded_registration(mesh, icp: dict, p2p: dict, bf: tuple) -> dict:
    """`sp_icp_align`, `sp_p2p_align` (each map, given as NumPy arrays,
    split into the mesh's shards) and `sharded_brute_force_align` over
    `mesh`, on its device, from `registration_inputs`' layout:
    {"icp", "p2p", "bf"} results."""
    from slam_sensor_fusion_tpu_torch.parallel.brute_force import sharded_brute_force_align
    from slam_sensor_fusion_tpu_torch.parallel.map_shard import (
        shard_cloud,
        shard_p2p_target,
        sp_icp_align,
        sp_p2p_align,
    )

    dev = mesh.device
    n = mesh.n_shards
    icp, p2p = _to(icp, dev), _to(p2p, dev)
    shards, shard_mask = shard_cloud(icp["map_points"], n, icp["config"].tile_tgt)
    target = shard_p2p_target(p2p["map_points"], p2p["map_normals"], p2p["map_normals_valid"],
                              n, p2p["config"].tile_tgt, center=p2p["center"], device=dev)
    return {
        "icp": sp_icp_align(icp["source"], icp["source_mask"], torch.from_numpy(shards).to(dev),
                            torch.from_numpy(shard_mask).to(dev), icp["initial_T"],
                            icp["config"], mesh),
        "p2p": sp_p2p_align(p2p["source"], p2p["source_mask"], target, p2p["initial_T"],
                            p2p["config"], mesh),
        "bf": sharded_brute_force_align(*_to(bf[:5], dev), bf[5], mesh),
    }


def _rank_main(rank: int, world_size: int, init_method: str, backend: str, device_type: str,
               n_shards: int, in_path: str, out_path: str) -> None:
    """One rank of `run_distributed`: join the group, run
    `sharded_registration` on its block of the shards, rank 0 saves."""
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    try:
        # written by run_distributed in this run; holds configs as well as tensors
        inputs = torch.load(in_path, weights_only=False)
        mesh = make_mesh(n_shards, "sp", device)
        out = sharded_registration(mesh, **_to(inputs, device))
        if rank == 0:
            torch.save(_to(out, "cpu"), out_path)
    finally:
        dist.destroy_process_group()


def run_distributed(inputs: dict, n_shards: int, world_size: int, backend: str,
                    device_type: str, timeout: float = 600.0) -> dict:
    """`sharded_registration(**inputs)` in `world_size` processes on this
    host, spawned here, joined through a file store in a temporary
    directory: a `backend` group ("nccl" or "gloo"), each rank holding
    n_shards / world_size shards on `cuda:<rank % cards>` (device_type
    "cuda") or the CPU. Gloo on card tensors stages its gathers through
    the host. Returns rank 0's results on the CPU; raises if a rank fails
    or the ranks outlast `timeout` seconds (they are then terminated)."""
    with tempfile.TemporaryDirectory() as tmp:
        in_path = os.path.join(tmp, "inputs.pt")
        out_path = os.path.join(tmp, "outputs.pt")
        torch.save(_to(inputs, "cpu"), in_path)
        # one host: gloo's pairs stay on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        ctx = mp.start_processes(
            _rank_main,
            args=(world_size, f"file://{tmp}/pg", backend, device_type, n_shards, in_path,
                  out_path),
            nprocs=world_size, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                    p.join(10)
                raise TimeoutError(f"run_distributed: ranks still running after {timeout} s")
        return torch.load(out_path, weights_only=False)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _close(a: torch.Tensor, b: torch.Tensor, atol: float) -> bool:
    return bool(((a - b).abs() <= atol).all())


def dryrun_multichip(n_devices: int, device: torch.device | str = torch.device("cuda")) -> str:
    """Every sharded path of the multi-device layer over a mesh of
    `n_devices` shards, all held by this process on `device`, each held
    against its single-device run; returns the summary line it prints."""
    from slam_sensor_fusion_tpu_torch.models import localization as lz
    from slam_sensor_fusion_tpu_torch.models import pipeline_fast as pf
    from slam_sensor_fusion_tpu_torch.models.lio import (
        LIOConfig,
        run_lio_blocks,
        run_lio_superblocks,
    )
    from slam_sensor_fusion_tpu_torch.ops import cloud as cl
    from slam_sensor_fusion_tpu_torch.ops.brute_force import brute_force_align
    from slam_sensor_fusion_tpu_torch.ops.icp import icp_align
    from slam_sensor_fusion_tpu_torch.ops.p2p_fused import (
        build_cached_p2p_target,
        point_to_plane_align_fused,
    )
    from slam_sensor_fusion_tpu_torch.ops.point_to_plane import (
        PointToPlaneConfig,
        estimate_normals,
    )
    from slam_sensor_fusion_tpu_torch.ops.voxel_map import (
        VoxelMapConfig,
        voxel_map_centroids_numpy,
        voxel_map_init,
        voxel_map_insert,
    )
    from slam_sensor_fusion_tpu_torch.parallel import batch, lio_fleet, voxel_map_shard
    from slam_sensor_fusion_tpu_torch.parallel.map_shard import (
        shard_cloud,
        sp_init_state,
        sp_run_chunk,
        sp_run_chunk_single,
    )
    from slam_sensor_fusion_tpu_torch.utils.config import StochasticFilterConfig

    dev = torch.device(device)
    config = tiny_config()
    mesh = make_mesh(n_devices, "dp", dev, single_process=True)
    sp_mesh = make_mesh(n_devices, "sp", dev, single_process=True)
    B, T = n_devices, 2
    eye = torch.eye(4, dtype=torch.float32, device=dev)

    def rep(x, *lead):
        return x.expand(*lead, *x.shape).contiguous()

    # the per-frame fleet on the "xla" backend: B copies of one sequence
    rng = np.random.default_rng(0)
    map_cloud = cl.from_numpy(rng.uniform(-20, 20, (4096, 3)).astype(np.float32),
                              config.capacity.map, dev)
    scan_pts, scan_mask = _padded(rng.uniform(-10, 10, (1024, 3)).astype(np.float32),
                                  config.capacity.scan, dev)
    frames = lz.FrameBatch(
        scan_points=rep(scan_pts, B, T), scan_mask=rep(scan_mask, B, T),
        odom_T_sensor=rep(eye, B, T), map_T_sensor_gps=rep(eye, B, T),
        odom_cov_trace=torch.full((B, T), 0.05, device=dev),
        gps_cov_trace=torch.ones((B, T), device=dev),
        valid=torch.ones((B, T), dtype=torch.bool, device=dev),
    )
    maps = cl.Cloud(rep(map_cloud.points, B), rep(map_cloud.mask, B))
    states = batch.batched_init_state(config, rep(eye, B), rep(eye, B), device=dev)
    _, outs = batch.batched_run_chunk(states, frames, maps, config)
    _check(outs.map_T_sensor.shape == (B, T, 4, 4), "batched_run_chunk's output shape")
    _, solo = lz.run_chunk(tree_index(states, 0), tree_index(frames, 0), map_cloud,
                           batch._xla_config(config))
    _check(torch.equal(outs.map_T_sensor[0], solo.map_T_sensor),
           "batched_run_chunk differs from its sequence's run_chunk")

    # candidate-sharded brute force: a registrable pair, equal in success
    # and pose to the single-device sweep
    from slam_sensor_fusion_tpu_torch.parallel.brute_force import sharded_brute_force_align

    reg = registration_inputs(dev)
    bf_single = brute_force_align(*reg["bf"], candidate_chunk=16)
    bf = sharded_brute_force_align(*reg["bf"], mesh)
    _check(bool(bf.success) == bool(bf_single.success), "brute force success")
    _check(_close(bf.transformation, bf_single.transformation, 1e-5), "brute force pose")

    # the LIO fleets, one robot a shard: per-frame (the "xla" backend) and
    # the whole-block loop (K7)
    lio_cfg = LIOConfig(
        scan_capacity=256, window=2, slot_points=256, refresh_every=2,
        p2p=PointToPlaneConfig(nn_backend="xla", num_iterations=2, normal_voxel=2.0),
        normal_est="cells", normal_voxel=2.0,
    )
    Tl, K = 4, 3
    rng = np.random.default_rng(0)
    sp0 = rng.uniform(-5, 5, (B, 256, 3)).astype(np.float32)
    sm0 = np.ones((B, 256), bool)
    T0 = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    lio_in = tuple(torch.as_tensor(a, device=dev) for a in (
        rng.uniform(-5, 5, (B, Tl, 256, 3)).astype(np.float32),
        np.ones((B, Tl, 256), bool),
        np.zeros((B, Tl, K, 3), np.float32),
        np.zeros((B, Tl, K, 3), np.float32) + np.asarray([0, 0, 9.81], np.float32),
        np.full((B, Tl, K), 0.033, np.float32),
        np.zeros((B, Tl, 3), np.float32),
        np.ones((B, Tl), np.float32),
        np.zeros((B, Tl), bool),
    ))
    lio_states = lio_fleet.fleet_init(lio_cfg, sp0, sm0, T0, device=dev)
    _, lio_outs = lio_fleet.fleet_run_lio(lio_states, *lio_in, lio_cfg, mesh=mesh)
    _check(lio_outs.world_T_body.shape == (B, Tl, 4, 4), "fleet_run_lio's output shape")
    _, lio_solo = run_lio_blocks(tree_index(lio_states, 0), *[a[0] for a in lio_in],
                                 lio_fleet._xla_config(lio_cfg))
    _check(torch.equal(lio_outs.world_T_body[0], lio_solo.world_T_body),
           "fleet_run_lio differs from its robot's run")
    _, sb_outs = lio_fleet.fleet_run_lio_superblocks(lio_states, *lio_in, lio_cfg, mesh=mesh)
    _check(sb_outs.world_T_body.shape == (B, Tl, 4, 4),
           "fleet_run_lio_superblocks' output shape")
    _, sb_solo = run_lio_superblocks(tree_index(lio_states, 0), *[a[0] for a in lio_in],
                                     lio_cfg)
    _check(torch.equal(sb_outs.world_T_body[0], sb_solo.world_T_body),
           "fleet_run_lio_superblocks differs from its robot's run")

    # the superblock fleet (K1), superstep T
    fast_cfg = dataclasses.replace(config, block_kernel=True, superstep=T)
    rng = np.random.default_rng(0)
    pframes = pf.build_paged_frames(
        fast_cfg, [rng.uniform(-10, 10, (1024, 3)).astype(np.float32) for _ in range(T)],
        np.broadcast_to(np.eye(4, dtype=np.float32), (T, 4, 4)),
        np.broadcast_to(np.eye(4, dtype=np.float32), (T, 4, 4)),
        np.full(T, 0.05, np.float32), np.ones(T, np.float32), np.ones(T, bool), dev,
    )
    state1 = lz.init_state(config, config.capacity.map, eye, eye)
    bpf = pf.PagedFrames(*[rep(x, B) for x in pframes])
    fast_states = batch.shard_batch(tree_stack([state1] * B), mesh)
    _, fast_outs = batch.fleet_run_chunk_fast(fast_states, bpf, maps, fast_cfg, mesh)
    _check(fast_outs.map_T_sensor.shape == (B, T, 4, 4), "fleet_run_chunk_fast's output shape")
    _, fast_solo = pf.run_chunk_fast(state1, pframes, map_cloud, fast_cfg)
    _check(torch.equal(fast_outs.map_T_sensor[0], fast_solo.map_T_sensor),
           "fleet_run_chunk_fast differs from its sequence's run_chunk_fast")

    # map-sharded ICP and point-to-plane against their whole-map runs
    sharded = sharded_registration(sp_mesh, **reg)
    rin, pin = reg["icp"], reg["p2p"]
    t_full, tm_full = _padded(rin["map_points"], 1536, dev)
    icp_cfg = rin["config"]
    icp_single = icp_align(rin["source"], rin["source_mask"], t_full, tm_full, eye, icp_cfg)
    _check(_close(sharded["icp"].transformation, icp_single.transformation, 1e-4),
           "sp_icp_align's pose")
    _check(bool(sharded["icp"].has_converged) == bool(icp_single.has_converged),
           "sp_icp_align's convergence")
    p2p_cfg = pin["config"]
    nrm, nvalid = estimate_normals(t_full, tm_full, voxel=4.0)
    p2p_single = point_to_plane_align_fused(
        pin["source"], pin["source_mask"],
        build_cached_p2p_target(t_full, tm_full, nrm, nvalid, torch.zeros(3, device=dev),
                                p2p_cfg.tile_tgt),
        eye, p2p_cfg,
    )
    _check(_close(sharded["p2p"].transformation, p2p_single.transformation, 1e-4),
           "sp_p2p_align's pose")
    _check(int(sharded["p2p"].n_correspondences) == int(p2p_single.n_correspondences),
           "sp_p2p_align's correspondences")

    # the map-sharded steady state: 4 frames, each shard ~1/n of the map
    Tsp = 4
    traj_cfg = dataclasses.replace(icp_cfg, max_visits=64, max_pairs_factor=64)
    fcfg = StochasticFilterConfig()
    step_xyz = torch.tensor([0.02, 0.01, 0.0], device=dev)
    src300 = rin["source"][:300]
    traj_pts = torch.zeros((Tsp, 384, 3), device=dev)
    for k in range(Tsp):
        traj_pts[k, :300] = src300 - step_xyz * k
    traj_msk = rep(rin["source_mask"], Tsp)
    pose_k = rep(eye, Tsp).clone()
    pose_k[:, :3, 3] = step_xyz * torch.arange(Tsp, device=dev)[:, None]
    covs = torch.full((Tsp,), 0.05, device=dev)
    st0 = sp_init_state(eye, eye, fcfg, device=dev)
    _, traj_single = sp_run_chunk_single(st0, traj_pts, traj_msk, pose_k, pose_k, covs, covs,
                                         t_full, tm_full, traj_cfg, fcfg)
    shards, shard_mask = shard_cloud(rin["map_points"], n_devices, icp_cfg.tile_tgt)
    _, traj_shard = sp_run_chunk(st0, traj_pts, traj_msk, pose_k, pose_k, covs, covs,
                                 torch.from_numpy(shards).to(dev),
                                 torch.from_numpy(shard_mask).to(dev), traj_cfg, fcfg, sp_mesh)
    _check(not bool(traj_single.pair_overflow.any()) and not bool(traj_shard.pair_overflow.any()),
           "sp steady state: pair overflow")
    _check(_close(traj_shard.map_T_sensor, traj_single.map_T_sensor, 1e-4),
           "sp_run_chunk's trajectory")

    # the sharded voxel store, each shard's table smaller than the map's
    # live cells, its union cell-exact against one store
    rng = np.random.default_rng(11)
    vm_pts = torch.from_numpy(rng.uniform(1.0, 39.0, (3, 1024, 3)).astype(np.float32)).to(dev)
    vm_msk = torch.ones((3, 1024), dtype=torch.bool, device=dev)
    vm_cfg = VoxelMapConfig(voxel_size=0.5, table_size=1 << 14, dim_xy=128, dim_z=128)
    vm_single = voxel_map_init(vm_cfg, np.zeros(3, np.float32), dev)
    for k in range(3):
        vm_single = voxel_map_insert(vm_single, vm_pts[k], vm_msk[k], vm_cfg)
    vm_want = voxel_map_centroids_numpy(vm_single)
    # a shard's table: twice its share of the 3072 points, so 1024 slots
    # at 8 shards (the JAX dry run's size, which at 4 shards fills to 73%
    # and drops points past its 8 probes, in both packages alike); from 4
    # shards on it is smaller than the map's live cells
    vm_small = vm_cfg._replace(table_size=1 << int(np.ceil(np.log2(2 * 3072 / n_devices))))
    _check(n_devices < 4 or vm_small.table_size < len(vm_want),
           "a shard's table holds the whole map")
    vm_state = voxel_map_shard.sp_voxel_map_init(vm_small, np.zeros(3, np.float32), sp_mesh, dev)
    vm_state = voxel_map_shard.sp_voxel_map_insert_chunk(vm_state, vm_pts, vm_msk, vm_small,
                                                         sp_mesh)
    vm_drop, vm_oob, vm_per_shard = voxel_map_shard.sp_voxel_map_flags(vm_state)
    _check(vm_drop == 0 and vm_oob == 0, "sharded voxel store: dropped or out-of-grid points")
    _check(int(vm_per_shard.sum()) == len(vm_want), "sharded voxel store: cell count")
    vm_got = voxel_map_shard.sp_voxel_map_centroids_numpy(vm_state)

    def rows(a):
        return a[np.lexsort((a[:, 2], a[:, 1], a[:, 0]))]

    _check(np.array_equal(rows(vm_got), rows(vm_want)), "sharded voxel store: centroids")

    line = (
        f"dryrun_multichip OK: {n_devices} shards on {dev}, fleet step "
        f"{tuple(outs.map_T_sensor.shape)}, bf success={bool(bf.success)} (sharded == single), "
        f"lio fleet {tuple(lio_outs.world_T_body.shape)}, superblock lio fleet "
        f"{tuple(sb_outs.world_T_body.shape)}, superblock fast fleet "
        f"{tuple(fast_outs.map_T_sensor.shape)}, sp-map icp converged="
        f"{bool(sharded['icp'].has_converged)} (sharded == single), sp-map p2p corr="
        f"{int(sharded['p2p'].n_correspondences)} (sharded == single), sp steady-state "
        f"trajectory {tuple(traj_shard.map_T_sensor.shape)} (sharded == single), sp voxel map "
        f"{len(vm_want)} cells over {n_devices}x{vm_small.table_size}-slot shards (union == "
        f"single, max shard {int(vm_per_shard.max())} cells)"
    )
    print(line, flush=True)
    return line


def _torchrun_main(n_shards: int | None, device: str = "cuda") -> None:
    """One rank under torchrun on `device` ("cuda": NCCL, a card a rank;
    "cpu": gloo): the three combining paths over the group, held by rank 0
    against one process holding every shard. Asked for the card where
    there is none, it raises before joining the group."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"dry run: device {device!r}, expected cuda or cpu")
    cuda = kind == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("dry run: --device cuda asked for, and this host has no CUDA device "
                           "(pass --device cpu to run the ranks on the CPU with gloo)")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device("cuda", local) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")
    try:
        n = n_shards or dist.get_world_size()
        inputs = registration_inputs(device)
        got = sharded_registration(make_mesh(n, "sp", device), **inputs)
        if dist.get_rank() == 0:
            want = sharded_registration(make_mesh(n, "sp", device, single_process=True),
                                        **inputs)
            for key in want:
                _check(bit_equal(got[key], want[key]), f"{key}: the group differs from one process")
            print(f"distributed dry run OK: {n} shards over {dist.get_world_size()} ranks "
                  f"({dist.get_backend()}), sp_icp_align, sp_p2p_align and "
                  f"sharded_brute_force_align equal to one process bit for bit", flush=True)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of the mesh (default: the world size, or 4 without torchrun)")
    ap.add_argument("--device", default="cuda",
                    help="the dry run's device: cuda (under torchrun a card a rank, NCCL) or cpu")
    args = ap.parse_args()
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        _torchrun_main(args.shards, args.device)
    else:
        dryrun_multichip(args.shards or 4, args.device)


if __name__ == "__main__":
    main()

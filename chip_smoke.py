#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU.

    python3 chip_smoke.py

Runs from the repository root on a host with one NVIDIA GPU and the CUDA
toolkit (nvcc). It imports nothing of JAX. Phases, in order; any failed
check exits non-zero:

  0. device: a CUDA device must exist; prints nvidia-smi's name and power
     limit of the card;
  1. build: compiles the CUDA kernels from the checkout's sources
     (slam_sensor_fusion_tpu_torch/csrc) and reports the seconds, ptxas's
     registers and spills of each kernel, and the cooperative grids of K1,
     K3, K4 and K7 at the main paths' tiles, of K1 and K3 at the JAX
     package's default and stress tiles, K2's scan grid at the
     rescue's and the stress tiles and K5's at the LIO bench's (blocks,
     threads, blocks a multiprocessor holds; at least 16 blocks), and K6's
     thread-block cluster at the LIO bench's tiles (CTAs, threads, the
     bytes of the matched set each stages);
  2. kernel against plain PyTorch at the main path's shapes, on inputs
     taken from the smoke world: K2 (pair-list NN) at the startup rescue's
     size, K1 (whole-superblock fine loop) on the first real superblock;
     and at the JAX package's own tile shapes: K1 on the first superblock
     of LocalizationConfig()'s tiles (64 source tiles of 256, the bench
     world at subsample 2) and of bench.py's stress cell (16 tiles of
     4096 against 1024 target tiles of 128: 122 000 raw points a scan
     subsampled by 2, density 48, cropped map 131 072; 33 frames, not
     256), K2 at the stress tiles, and K3 fresh and lazy on 4 tiles of
     4096 of the stress scan; with their times, bounds, the
     superstep_prologue's time and K1's per-slot scratch;
  3. the main path at the bench's defaults (bench.py bench_loc): synthetic
     world (24 000 raw points a scan, 140 m, 257 frames), map build,
     Localizer -> init_state -> coarse_attempt, one forced rescue ICP (K2),
     then build_paged_frames -> run_chunk_fast twice from the post-startup
     state (32 superblocks each, one K1 launch per superblock). Requires
     zero pair-overflow and slack-violation frames, finite poses,
     ATE-RMSE < 0.1 m, and the launch counts the path implies. A third
     pass runs under torch.profiler: K1's mean ms a steady-state
     superblock, its share of device time and the device's idle share
     (CUDA events around the launches if the profiler sees no device time).
  4. the online path at bench.py bench_latency's configuration (120 m
     world, 144 frames, scan 4096, cropped map 65 536, tile_src 512, fast
     ICP, block_kernel=False): LocalizerSession.push over every frame (one
     K3 launch a push from the coarse ladder's success on), then
     BlockLocalizerSession at K=4 (parity superblock, one K1 launch a
     block). Prints push and block p50/p99 and the host/dispatch/device
     split; requires ATE-RMSE < 0.1 m and no pair overflow;
  5. the replay entry point Localizer.run over the first 33 frames of the
     phase-4 world, twice: the default per-frame parity engine (run_chunk
     -> step, K2) and fast mode without the superblock kernel
     (run_chunk_fast's per-frame branch, K3). Requires ATE-RMSE < 0.1 m and
     K2 / K3 launches.
  6. the LIO path at bench.py bench_lio's width under its `blocks` loop
     and `fused` backend (140 m world, skewed scans of 8192 points deskewed
     in the loop, ring 16 x 4096, 32 target tiles of 1024, 2 GN iterations
     on fixed correspondences, cell normals, the GN covariance, GPS every
     frame), cut to 129 frames: run_lio_blocks twice from the same state,
     LIOSession.push over the same frames, run_lio_chunk over the first 33,
     8 frames through the split registration (associate_p2p_fused ->
     p2p_gn_from_correspondences, K5 then K6), and the map-sharded
     registration (parallel/map_shard.sp_p2p_align) over phase 2's
     steady-state anchor map split into 1 and 4 shards, 8 frames each.
     Requires ATE-RMSE < 0.3 m, finite outputs, exactly one K4 launch a
     frame, the session's first 33 poses equal to the chunk's within 1e-5,
     the split registration equal to the whole one, and sp_p2p_align's
     n_corr equal to K4's with fixed correspondences on the whole map, T
     within 1e-4, K5 launched once a shard and K6 once a frame. Prints
     K5's and K6's device ms a frame of sp_p2p_align, scans/s, push
     p50/p99, the frame's split
     into host-issued work and K4 (and one block under torch.profiler:
     device busy and idle share, K4's share, device operations a frame), the
     anchor refresh, pair demand against the list's capacity and the GPS
     accepted count.
  7. the LIO path under bench.py bench_lio's `block` loop (the production
     path on an accelerator, bench.py:77, :244-250): run_lio_superblocks at
     phase 6's configuration and width over the same 128 frames, twice
     from one state (one K7 launch a 16-frame block, no K4 launch).
     Requires ATE-RMSE < 0.3 m, finite outputs and zero pair overflow (256
     slots >= 4 source tiles x 32 target tiles: complete by construction).
     Prints scans/s, slack violations, pair demand and one block's split
     (refresh, prologue, K7, ring insert; device busy and idle share and
     device operations a block under torch.profiler). Then
     fleet_run_lio_superblocks with 2 robots over 33 frames: each robot
     equals its own run, with 2 x 3 K7 launches.

  8. the superblock main path at the JAX package's tile shapes: from each
     of phase 2's two startup states, run_chunk_fast twice over 32 frames
     (4 superblocks: the first frames still carry the coarse pose's
     error), then once under torch.profiler. Requires zero
     pair-overflow and slack-violation frames, ATE-RMSE < 0.1 m and one K1
     launch a superblock; prints scans/s and K1's ms a superblock.
  9. mapping at bench.py bench_map's widths (the 140 m world, skewed scans
     of 16384 points at 25 m range, 0.2 m voxels on a 1024 x 1024 x 128
     grid anchored at (-100, -100, -10), 8-frame groups of 131 072 points;
     128 frames, not 512): deskew and the map-frame transform on the card,
     then one insert a group, twice through the sorted store (capacity
     2^18) and the hash store (2^21 slots, 8 probes, 4096 stragglers),
     unique_capacity sized from sample groups as bench_map does. Requires
     zero dropped and out-of-grid points, the sorted and hash centroids
     equal bit for bit, the card's sorted state (keys, moments, counters)
     equal to a CPU run fed the same deskewed world points, and one
     voxel_segment_sum launch an insert; prints frames/s, ms an insert
     (CUDA events) and the device's idle share of a pass (profiler). Then
     holds voxel_segment_sum against its plain version bit for bit on the
     first real group and on a tie-heavy one, with `index_add_` timed
     beside it (and the output elements where it differs). Then records
     phase 3's map tiles through StreamingMapper on the card (sorted store
     at 0.1 m, anchored at the tiles' min corner, sized from the data; 257
     frames, a tile every 4th), finalize(use_device=True), saves and loads
     the map_data directory (the device map as its cached map.pcd), and
     localizes 32 frames on the loaded map through phase 3's path (startup,
     a forced rescue ICP on K2, run_chunk_fast on K1). Requires the loaded
     map equal to the finalized one, ATE-RMSE < 0.1 m and zero overflow and
     slack; prints how many cells differ from the host merge's map.
 10. the product's entry points: `python -m slam_sensor_fusion_tpu_torch
     selftest` in a process of its own (ok, K2 launched there); the CLI's
     `build-map` and `localize` as processes of their own on .npz streams
     of the selftest world at the map density LocalizationConfig() assumes
     (96 points a square metre, 24 000-point map scans; map-frame tiles;
     body scans with every other stream jittered within the 0.1 s slop;
     LocalizationConfig() defaults:
     ATE-RMSE < 0.25 m, every frame valid from the 6th, the trajectory
     file's four arrays); the KITTI-format path at seq-00 scan density (a
     129-frame fixture of up to 131 072 points a scan at 96 points a square
     metre, written and loaded through utils/kitti, deskewed with the
     ground-truth twist, streams from make_sequence_from_scans, a map of
     every 4th scan through api.build_map, the config from
     suggest_localization_config on the first 16 scans and bench_loc's at
     subsample 2): api.localize from the map_data directory twice
     (ATE-RMSE < 0.1 m, zero overflow and slack, one K1 launch a
     superblock; scans/s, host staging ms a frame, per-slot scratch, peak
     device memory, and a third pass's device idle share under the
     profiler), K1 against its plain version on its first superblock; the
     LIO block loop at bench_kitti's configuration with
     suggest_lio_config's capacity and registration subsample, twice
     (ATE-RMSE < 0.3 m, zero overflow, one K7 launch a block); an autosized
     hash store (suggest_voxel_map_config) through StreamingMapper on the
     card (zero dropped and out-of-grid points, one segment sum an
     insert); Localizer.run's debug branch on the selftest world (poses
     equal bit for bit to a run without it, its five files, CALLBACK TOOK
     logged).
 11. the multi-device layer (slam_sensor_fusion_tpu_torch/parallel), each
     path over a mesh of 4 shards that this process holds on the one card,
     against its single-device run: fleet_run_chunk_fast with 4 copies of
     phase 3's sequence over 32 frames (each bit-equal to its own
     run_chunk_fast, 0 overflow and slack, ATE-RMSE < 0.1 m, one K1 a
     superblock; scans/s); batched_run_chunk with 2 sequences of 9 frames
     on the gated "xla" backend (each bit-equal to its own run_chunk);
     sharded_brute_force_align at phase 3's brute-force inputs with no hit
     and with a hit (the threshold at twice the best score; success, T and
     score bit-equal to brute_force_align);
     sp_icp_align of phase 3's cropped scan against the whole map in 4
     Morton-contiguous shards (iterations and n_corr equal to icp_align on
     the whole map, T to 1e-4, error to 1e-5, 4 K2 launches an
     association); sp_run_chunk over 32 steady frames from frame 9 (equal to
     sp_run_chunk_single on the whole map to the same bounds, 0 overflow,
     ATE-RMSE < 0.1 m; scans/s, K2 launches a frame); the sharded hash
     store over phase 9's 16 groups, each shard's table below the map's
     live cells (union cell-exact to one store, 0 dropped, 0 out of grid,
     one segment sum a shard insert; frames/s); the LIO fleets over a mesh
     of 2 shards, one robot each (equal to phase 7's robots and to their
     own run_lio_blocks); the distributed form in processes of their own,
     a 1-rank NCCL group and 2 gloo ranks holding 2 shards each (host
     staging), running sp_icp_align, sp_p2p_align (phase 6's anchor map)
     and sharded_brute_force_align bit-equal to this process's 4 shards;
     dryrun_multichip(4) on the card.
 12. the public helpers on the card at full width: gated_nn_pallas (K2)
     on phase 3's first steady frame (the cropped scan, 4 x 1024 rows
     under that frame's pose, against the Morton-sorted cropped map, 128 x
     512, at the ICP gate), with a roomy pair list and a truncating one;
     voxel_downsample (voxel_segment_sum) on phase 9's first deskewed
     scan (16 384 rows) and group (131 072 rows) at 0.2 m, anchored at the
     masked min corner and at bench_map's anchor (where the int32 voxel
     ids wrap); masked_points, to_numpy, rotation, translation and svd3x3.
     Requires each result equal to the same call on CPU copies (K2's idx
     and overflow, d2 to 1e-5 relative; the voxel grid bit for bit;
     svd3x3's S to 3e-6 of the largest, U diag(S) Vh to 1e-5 of H), K2's
     choice and d2 within 1e-4 m^2 of a float64 dense search on every row
     with a neighbour in the gate, the voxel grid's cells equal to
     voxel_downsample_numpy's to 1e-4 m (rows on a float32/float64 cell
     boundary left out), one K2 launch a gated call and one
     voxel_segment_sum launch a downsample; prints each call's ms, the
     card's busy ms of it (profiler), its CPU ms and its bound.
 13. bench.py bench_kitti's own LIO settings (registration subsample 8)
     through run_lio_superblocks at source tiles of 512, 2048 and 4096 rows
     on its own 16 384-point fixture (129 frames) and on phase 10's
     seq-00-density fixture (65 frames): ATE-RMSE < 0.3 m, zero overflow,
     one K7 a block, the widths' trajectories within 1e-4 m in the first
     block and 0.1 m over the run; K4-K7 against their plain versions at
     2048 and 4096 rows; voxel_segment_sum on a seq-00 group.
 14. the prefix sum of the LIO cell normals in XLA's order
     (ops/ordered_scan.cumsum_rows, csrc/ordered_scan.cu) against its plain
     version on CPU copies, bit for bit: (N, 10) moments of masked clouds
     at negative coordinates (-0.0 rows) at N = 1, 15, 16, 17, 257, 4097
     and 2^20 + 3, phase 7's anchor (65 536 rows) and phase 13 (b)'s;
     estimate_normals_cells on the card against the CPU at phase 13 (a)'s
     first anchor (valid masks equal, unsigned gap <= 1e-5); the kernel's
     ms by events and on the card alone beside torch.cumsum's on the same
     tensor (which the port never calls), its plain version's and its
     bound. Every LIO path of phases 6, 7, 10, 11 and 13 must have launched
     it (each anchor refresh takes one).
 15. XLA's float32 math (ops/xla_math, csrc/xla_math.cu) bit-equal to its
     plain version on 2^24 inputs a function and at the LIO paths' shapes,
     one launch a function call; phase 7's first block on the card against
     the CPU within 1e-5 m.
 16. the LIO's default configuration on phase 6's world: LIOConfig()'s
     voxel normals, whose per-cell moments are one voxel_segment_sum launch
     (each cell's rows in row order, as the JAX package's scatter-add),
     and its "pallas" registration (K2 on a pair list, every GN
     iteration). (a) At phase 7's anchor and moved by ~40 m and ~140 m, at
     1.8 m and 0.75 m cells: the moments bit-equal to the CPU's and on two
     card runs; the voxel and tiled normals' valid masks equal to the
     CPU's, 1 - |n . n'| < 1e-5 on every valid point. (b) K2 against its
     plain version at the LIO's 512 x 1024 and 256 x 512 tiles on phase
     6's frame 33. Then run_lio_blocks on "pallas" and on the dense sweep
     ("xla", TF32 off) with voxel normals, 64 frames twice each, (c) the
     first 16-frame block of "pallas" on the card against the port on the
     CPU from one state (poses 1e-4 m, frame 0's n_correspondences equal)
     and the dense sweep's frame 0 on the card against the CPU (the rows
     whose winner changed); the tiled normals on "pallas" (32 frames);
     LIOSession on LIOConfig()'s registration and normals at phase 6's
     scan capacity (33 pushes); run_lio_superblocks (K7) with voxel
     normals, 64 frames twice, (e) zero pair overflow; fleet_run_lio on
     LIOConfig() itself, 2 robots x 33 frames, each equal to its own run.
     (d) ATE-RMSE < 0.3 m on every run; exact K2 launches a frame (GN
     iterations + 1), the segment sum and K7 launched on their paths.
     Prints scans/s of the second passes, a refresh's segment sum, eigh
     and host syncs (the whole refresh's and each part's), K2's ms a
     frame, device operations a frame and the idle share of a profiled
     block.
 17. xla_math as a kernel a function (csrc/xla_math.cu's template
     instances) and cumsum_rows in one launch (one pass, each element
     read and written once): each elementwise
     function through its three launch paths (16-byte accesses on aligned
     operands, one value a thread on views one element off, broadcast
     strides read in place) bit-equal to its plain version on 2^22 seeded
     values, one kernel launch (the kernel library's own count); the
     ordered scan at phase 14's lengths and at 1 to 60 columns, one launch
     (256-row chunks to 45 columns, 16-row ones past), bits equal its
     plain version; K7's and K4-K6's fixture digests equal the ones
     tests/torch_lio_world.py pins; the split kernels' ptxas lines
     (registers, stack, spills) and phases 14 and 15's times against their
     bounds and torch's calls.

Phase 2 also holds K3 against its plain version (fresh and lazy, at the
session's shapes), the per-frame superblock branch (K3 lazy) against K1 on
the first superblock, and K4 (fixed and fresh correspondences), K5, K6 and
K6(K5(x)) against K4 on a steady-state frame of the LIO world (frame 33,
the ring full) against the anchor its block starts with (with K5's scan
and combine and K6's device time under the profiler), and K7 against
its plain version on the block of frames 33-48 from the same state.
Every kernel's launch count is set to 0 before each path of phases 3-16
and read after it. A kernel's time on the card alone (`device_ms`) is the
mean of the launches the profiler recorded times its launches a call.

The line before the last is the kernels' JSON record (time, plain time,
error against plain, launches on the main paths, and the least time the
card could take for the same work; K1 also its steady-state time and its
times at the JAX package's tile shapes, K2 at the stress tiles, K3 its
lazy times and at 4 x 4096, K4 its fresh-correspondence times, K5 and K6
their device times alone and a frame of sp_p2p_align at 1 and 4 shards;
K1-K5 and K7 their grids, K6 its cluster; K2 also gated_nn_pallas's time,
CPU time, bound and busy device time; voxel_segment_sum its tie-heavy times, `index_add_`'s
time as its library_ms, phase 9's frames/s, ms an insert and idle share
of each store, and voxel_downsample's time, CPU time, bound and busy
device time on a group; cumsum_rows its device time, torch.cumsum's as
its library_ms, and its times at phase 13 (b)'s anchor and 2^20 + 3
rows); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: the checkout this script runs from
REPO = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 257  # 1 startup frame + 32 superblocks of 8
TILES_FRAMES = 33  # phase 8: 1 startup frame + 4 superblocks of 8 (the bench runs 1024 / 256)
SESSION_FRAMES = 144  # bench.py bench_latency's sequence
SESSION_WARMUP = 16  # pushes before the timed ones (bench.py:759)
REPLAY_FRAMES = 33  # phase 5: 1 init frame + 1 coarse frame + 31 steady frames
LIO_FRAMES = 129  # phase 6: 1 seeding frame + 8 blocks of 16 (the bench runs 512)
LIO_CHUNK_FRAMES = 33  # run_lio_chunk, and the session poses held against it
LIO_SPLIT_FRAMES = 8  # frames through the K5 -> K6 split registration
LIO_WARM_FRAMES = 32  # frames before the kernel checks and the profile (the ring is full)
FLEET_FRAMES = 33  # phase 7's fleet: 2 blocks of 16 and a padded block of 1
FLEET_ROBOTS = 2
MAP_FRAMES = 128  # phase 9: bench.py bench_map's loop, 16 groups (the bench runs 512)
MAP_SCAN_CAP = 16384  # bench_map's skewed scans (BENCH_MAP_SCAN_CAP)
MAP_GROUP = 8  # frames an insert (BENCH_MAP_BATCH)
MAP_VOXEL = 0.2  # m (BENCH_MAP_VOXEL)
MAP_ORIGIN = (-100.0, -100.0, -10.0)  # bench_map's grid anchor
RAW_POINTS = 24000  # phase 3's scans and map tiles (bench_loc's BENCH_SCAN_POINTS)
RECORD_GROUP = 4  # phase 9's recording: frames a StreamingMapper insert (one map tile)
RECORD_FRAMES = 33  # phase 9: frames localized on the recorded map (1 startup + 4 superblocks)
#: phase 10: the KITTI-format fixture at seq-00 scan density (131 072
#: points a scan at most; 96 points a square metre gives 105k-128k), 1
#: startup frame + 16 superblocks of 8 (bench_kitti runs 256 frames, seq 00
#: has 4541)
KITTI_FRAMES = 129
KITTI_POINTS = 131072
KITTI_DENSITY = 96.0
KITTI_EXTENT = 140.0
KITTI_SAMPLE = 16  # scans autosize samples
#: phase 13: bench.py bench_kitti's own LIO settings (:1169-1227, the
#: fixture branch) at the source tile widths the JAX LIO takes
#: (BENCH_LIO_TILE_SRC); (a) its own fixture, cut from 256 frames, (b)
#: phase 10's seq-00-density fixture, cut to 65 frames
BENCH_KITTI_FRAMES = 129
BENCH_KITTI_POINTS = 16384  # BENCH_KITTI_FIXTURE_PTS
BENCH_KITTI_REG_SUB = 8  # BENCH_KITTI_REG_SUB on the fixture
SEQ00_LIO_FRAMES = 65
WIDE_TILES = (512, 2048, 4096)
#: one fixture's trajectories at two tile widths (m). The widths change the
#: pair lists' order and the moment sums' order, so not the bits: in the
#: first block, on one anchor, the bound of the K4 parity tests
#: (tests/test_torch_lio_k4.py); over the run, after each anchor refresh
#: the cell normals' float32 prefix sums at world coordinates round the
#: parted rings apart (ROADMAP §3: ~6e-3 m against the JAX package after
#: one refresh) and the runs become two estimates, each held to
#: LIO_ATE_LIMIT on its own: a third of it
WIDTH_BLOCK_TOL = 1e-4
WIDTH_TRAJ_TOL = 0.1
KITTI_MAP_EVERY = 4  # a map tile every 4th frame (bench_kitti_loc)
SELFTEST_ATE_LIMIT = 0.25  # m: examples_selftest's pass rule
STREAM_JITTER = 0.03  # s: timestamp jitter of the CLI's streams, within the 0.1 s slop
ATE_LIMIT = 0.1  # m
LIO_ATE_LIMIT = 0.3  # m: tests/test_lio.py's bound on the fused LIO backend
K1_TOL = 3e-4  # poses/priors/state: tests/test_superblock_kernel.py's bound
K3_TOL = 3e-4  # poses, the same bound; the ICP error to K3_ERR_TOL
K3_ERR_TOL = 1e-3
K2_RTOL = 1e-5  # d2, relative
#: gated_nn_pallas against a float64 dense search, within the gate (m^2):
#: its choice's distance to the minimum, its d2 to its choice's distance
#: (K2's expanded float32 form at coordinates up to ~10 m rounds by ~2e-5)
DENSE_TOL = 1e-4
VOXEL_TOL = 1e-4  # m: voxel_downsample's float32 centroids against the host merge's float64
#: svd3x3's S on the card (cuSOLVER) against the CPU's (LAPACK), relative to
#: the largest: two backward-stable algorithms, each some ulps of it off
SVD_RTOL = 3e-6
SVD_TOL = 1e-5  # |U diag(S) Vh - H|
K4_TOL = 3e-4  # T of K4 and K6
K4_RTOL = 1e-4  # rmse, wr2 and the 21 JtJ lanes, relative
K5_RTOL = 1e-6  # d2, relative; the matched pages are equal
K7_TOL = 3e-4  # poses and state of K7; n_corr, GPS acceptance and slack flags equal
#: float operations a point a pass of K6: the transform (18), the residual,
#: Huber weight and Jacobian (~30) and the 29 moments (~60)
FLOP_PER_GN_POINT = 110
#: float operations of the EKF's 16x16 products: two a IMU sample (F P, then
#: (F P) F^T) and four a frame (the two Joseph forms), 2 x 16^3 each
FLOP_PER_EKF_PRODUCT = 2 * 16**3
#: NVIDIA H100 SXM data sheet: float32 on the CUDA cores (the kernels use
#: no tensor cores) and HBM3 bandwidth, both at the 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FLOP_PER_DISTANCE = 8  # 3 differences, 3 products, 2 sums
#: K2's and K5's two launches a call and K6's one, by their names in the profiler
K2_KERNELS = ("pair_nn_scan_kernel", "pair_nn_combine_kernel")
K5_KERNELS = ("p2p_assoc_scan_kernel", "p2p_assoc_combine_kernel")
K6_KERNELS = ("p2p_gn_cluster_kernel",)
#: phase 6's map-sharded registration: shard counts, and its bound on T
#: against K4 with fixed correspondences on the whole map (the JAX
#: package's test of sp_p2p_align, tests/test_parallel.py)
SP_SHARDS = (1, 4)
SHARDS11 = 4  # phase 11: the shards of every mesh
FLEET11_SEQUENCES = 4  # phase 11's superblock fleet
FLEET11_FRAMES = 32  # after the startup frame: 4 superblocks
BATCHED11_FRAMES = 9  # phase 11's per-frame fleet
SP11_FRAMES = 32  # phase 11's map-sharded steady state
SP_TOL = 1e-4
#: phase 14: the scan's lengths (N x 10 moments), its launches' names in
#: the profiler, and the bound on the card's cell normals against the CPU's
SCAN_LENGTHS = (1, 15, 16, 17, 257, 4097, 2**20 + 3)
SCAN_KERNELS = ("scan_rows_kernel",)
NORMALS_CARD_TOL = 1e-5  # 1 - |n . n'|
#: phase 15: inputs a function of xla_math's bit check (2^24), the chunk its
#: plain version runs in on the host, the kernel's name in the profiler, the
#: double operations of one sincos (reduction, two polynomials: ~40 fma and
#: products, counted as two each) and of one atan2 (float: ~30), and the
#: float64 peak outside the tensor cores (NVIDIA H100 SXM data sheet, 700 W)
XM_INPUTS = 1 << 24
XM_CHUNK = 1 << 21
XM_KERNEL = "xm_"
XM_FLOP = {"sincos": 80, "atan2": 30, "acos": 34, "fma": 2}
#: phase 17: values a function and launch path of xla_math's path check
XM17_INPUTS = 1 << 22
PEAK_F64_FLOPS = 34e12
#: phase 15: the bound on phase 7's first block card against CPU (m): the
#: host path is the same bits on both, K7 sums in another order than its
#: plain version (3.4e-8 found)
XM_CARD_CPU_GAP = 1e-5
#: phase 16, the LIO's default configuration (LIOConfig()'s voxel normals,
#: the "pallas" and "xla" registration backends) on phase 6's world: 1
#: seeding frame + 4 blocks of 16 (run_lio_blocks, run_lio_superblocks);
#: 1 + 32 for the tiled normals, LIOSession and the fleet
P16_FRAMES = 65
P16_SHORT_FRAMES = 33
#: phase 7's anchor moved by ~40 m and ~140 m: the cells' moments at world
#: coordinates (tests/test_torch_lio_normals.py's shifts)
P16_SHIFTS = {"anchor": (0.0, 0.0, 0.0), "shifted": (40.0, 30.0, 0.0),
              "far": (140.0, -60.0, 2.0)}
#: the first 16-frame block on the card against the port on the CPU from
#: one state (m)
P16_CARD_CPU_TOL = 1e-4
#: K1 and K4 must spread each association over at least this many SMs
MIN_GRID_BLOCKS = 16


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out


def bench_config(raw_points=24000, subsample=8, tile_src=1024, tile_tgt=512, cropped_map=65536):
    """bench.py bench_loc's defaults (:405-466); the keywords are its
    BENCH_SCAN_POINTS, BENCH_SUBSAMPLE, BENCH_TILE_SRC, BENCH_TILE_TGT and
    BENCH_CROPPED_MAP."""
    from slam_sensor_fusion_tpu_torch.utils.config import (
        CloudCapacity,
        ICPConfig,
        LocalizationConfig,
    )

    scan_cap = 1 << max(int(np.ceil(np.log2(max(raw_points // subsample, 1024)))), 10)
    return LocalizationConfig(
        block_kernel=True,
        superstep=8,
        superstep_slack=0.08,
        scan_subsample_step=subsample,
        superblock_parity=True,
        icp=dataclasses.replace(
            ICPConfig(), mode="parity", reassoc_margin=0.5, num_iterations=10,
            tile_src=tile_src, acceptable_mean_error=0.05, tile_tgt=tile_tgt,
            max_visits=128, max_pairs_factor=128,
        ),
        capacity=CloudCapacity(
            scan=scan_cap, cropped_scan=scan_cap, cropped_map=cropped_map,
            map=1 << 20, bf_source=1024, bf_target=8192,
        ),
        map_subsample_step=1,
        brute_force_map_subsample_step=3,
    )


def default_tiles_config():
    """bench_loc in the JAX package's default LocalizationConfig() tile
    shapes: the reference's scan subsample 2 (utils/config.py:254), so the
    bench world's 24 000 raw points fill cropped_scan 16384 (:168) in 64
    source tiles of 256 (:59) against target tiles of 512 (:60)."""
    return bench_config(subsample=2, tile_src=256)


def stress_config():
    """bench.py's stress cell (STRESS_OVERRIDES, :340-348): 122 000 raw
    points a scan subsampled by 2 (scan capacity 65536: 16 source tiles of
    4096), cropped map 131 072 (1024 target tiles of 128)."""
    return bench_config(raw_points=122000, subsample=2, tile_src=4096, tile_tgt=128,
                        cropped_map=131072)


def session_config():
    """bench.py bench_latency's per-frame engine (:778-789): fast ICP (K3)
    each callback, no superblock batching."""
    from slam_sensor_fusion_tpu_torch.utils.config import (
        CloudCapacity,
        ICPConfig,
        LocalizationConfig,
    )

    return LocalizationConfig(
        block_kernel=False,
        superblock_parity=False,
        scan_subsample_step=8,
        icp=dataclasses.replace(ICPConfig(), mode="fast", tile_src=512),
        capacity=CloudCapacity(
            scan=4096, cropped_scan=4096, cropped_map=65536, map=1 << 20,
            bf_source=1024, bf_target=8192,
        ),
        map_subsample_step=1,
        brute_force_map_subsample_step=3,
    )


def build_session_world(n_frames: int):
    """bench.py bench_latency's world, sequence and map (:758-774)."""
    from slam_sensor_fusion_tpu_torch.models.mapping import build_map_data
    from slam_sensor_fusion_tpu_torch.utils import synthetic as syn

    rng = np.random.default_rng(0)
    world = syn.make_world(rng, extent=120.0, n_buildings=50, n_poles=150, points_per_m2=24.0)
    poses = syn.make_trajectory(n_frames, speed_per_frame=0.15, radius=26.0)
    seq = syn.make_sequence(seed=0, world=world, poses=poses, scan_points=24000)
    tiles = []
    map_rng = np.random.default_rng(1)
    for i in range(0, n_frames, 4):
        body = syn.render_scan(world, poses[i], map_rng, max_points=24000, noise=0.005)
        tiles.append(body @ poses[i][:3, :3].T + poses[i][:3, 3])
    odom_pos, gps_rows = syn.make_mapping_logs(seq)
    return seq, build_map_data(tiles, odom_pos, gps_rows)


def build_world(n_frames: int, raw_points: int = 24000, density: float = 24.0):
    """bench.py bench_loc's synthetic world, sequence and map (:487-505);
    raw_points and density are its BENCH_SCAN_POINTS and BENCH_DENSITY."""
    from slam_sensor_fusion_tpu_torch.models.mapping import build_map_data

    seq, tiles, odom_pos, gps_rows = world_parts(n_frames, raw_points, density)
    return seq, build_map_data(tiles, odom_pos, gps_rows)


def world_parts(n_frames: int, raw_points: int = 24000, density: float = 24.0):
    """`build_world`'s sequence and the mapping run its map is built from:
    map-frame tiles (a scan every 4th frame), odometry and GPS rows."""
    from slam_sensor_fusion_tpu_torch.utils import synthetic as syn

    rng = np.random.default_rng(0)
    world = syn.make_world(rng, extent=140.0, n_buildings=70, n_poles=200,
                           points_per_m2=density)
    poses = syn.make_trajectory(n_frames, speed_per_frame=0.15, radius=30.0)
    seq = syn.make_sequence(seed=0, world=world, poses=poses, scan_points=raw_points)
    tiles = []
    map_rng = np.random.default_rng(1)
    for i in range(0, n_frames, 4):
        body = syn.render_scan(world, poses[i], map_rng, max_points=raw_points, noise=0.005)
        tiles.append(body @ poses[i][:3, :3].T + poses[i][:3, 3])
    odom_pos, gps_rows = syn.make_mapping_logs(seq)
    return seq, tiles, odom_pos, gps_rows


def startup(loc, seq, gps_T, config, dev):
    """init_state + one coarse attempt on frame 1 (bench.py:514-539)."""
    from slam_sensor_fusion_tpu_torch.models import localization as lz

    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    state = lz.init_state(config, loc.map_cloud.capacity, f32(gps_T[0]), f32(seq.odom_T_sensor[0]))
    fb0 = lz.build_frame_batch(
        config, [seq.scans[1]], seq.odom_T_sensor[1:2], gps_T[1:2],
        seq.odom_cov_trace[1:2], seq.gps_cov_trace[1:2], np.ones(1, bool), dev,
    )
    cm, ct, ref, cscan, coarse = lz.coarse_attempt(
        state, fb0.scan_points[0], fb0.scan_mask[0], loc.map_cloud, f32(gps_T[0]), config
    )
    state = state._replace(map_T_sensor=coarse.map_T_sensor, cropped_map=cm, cached_target=ct, map_T_ref=ref)
    return state, cscan, coarse


def nudge(T: torch.Tensor, dx: float, dy: float, yaw_deg: float) -> torch.Tensor:
    """T pushed by (dx, dy) metres and yaw_deg degrees in its own frame."""
    from slam_sensor_fusion_tpu_torch.ops import geometry as geo

    yaw = torch.tensor(math.radians(yaw_deg), device=T.device)
    off = torch.tensor([dx, dy, 0.0], device=T.device)
    return T @ geo.make_T(geo.rot_z(yaw), off)


def rescue_start(coarse_T: torch.Tensor) -> torch.Tensor:
    """The coarse pose pushed ~1 m and 5 degrees off, so the rescue ICP has
    metre-scale work to do."""
    return nudge(coarse_T, 0.8, -0.6, 5.0)


#: ptxas's mangled kernel names -> the kernels' labels (K1's register
#: layout is built for 1-8 source tiles: `Points<n>`)
KERNEL_SYMBOLS = [
    ("pair_nn_scan_kernel", "K2 scan"), ("pair_nn_combine_kernel", "K2 combine"),
    ("icp_fused_kernel", "K3"), ("lio_superblock_kernel", "K7"),
    ("GlobalPoints", "K1 global layout"), ("superblock_kernel", "K1 register layout"),
    ("p2p_fused_kernel", "K4"), ("p2p_assoc_scan_kernel", "K5 scan"),
    ("p2p_assoc_combine_kernel", "K5 combine"), ("p2p_gn_cluster_kernelILb1", "K6 staged"),
    ("p2p_gn_cluster_kernelILb0", "K6 global"),
    ("segment_sum_sorted_kernel", "voxel_segment_sum"),
    ("scan_rows_kernelILi2", "cumsum_rows, 256-row chunks"),
    ("scan_rows_kernelILi1", "cumsum_rows, 16-row chunks"),
    ("xm_norm2", "xla_math norm2"), ("xm_mmILb0", "xla_math mm"),
    ("xm_mmILb1", "xla_math mm_lanes"), ("xm_propagate", "xla_math propagate"),
    ("xm_dead_reckon", "xla_math dead_reckon"),
]

#: csrc/xla_math.cu's function numbers (ops/xla_math.FN), for the template
#: instances' labels
XM_FN_NAMES = {0: "sincos", 1: "atan2", 2: "acos", 3: "fma", 7: "so3_exp", 8: "so3_log",
               9: "se3_exp", 10: "se3_log", 11: "deskew", 12: "cell_normals"}


def kernel_label(line: str) -> str:
    """The label of the kernel a ptxas 'Compiling entry function' line
    names: the template instances of xla_math's kernels by function and
    path, the others from KERNEL_SYMBOLS."""
    for kind, mangled in (("16-byte", "xm_ewILi"), ("strided", "xm_ew_stridedILi"),
                          ("batch", "xm_batchILi")):
        if mangled in line:
            fn = int(line.split(mangled, 1)[1].split("E", 1)[0])
            path = kind
            if kind == "16-byte" and "ELb0" in line.split(mangled, 1)[1][:12]:
                path = "one a thread"
            return f"xla_math {XM_FN_NAMES.get(fn, fn)}" + ("" if kind == "batch" else f", {path}")
    return next((k for sym, k in KERNEL_SYMBOLS if sym in line), "?")


def ptxas_lines(log: str) -> list[str]:
    """ptxas's registers, stack and spills of each kernel, labelled."""
    out, label = [], "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            label = kernel_label(line)
            if label == "K1 register layout" and "PointsILi" in line:
                tiles = line.split("PointsILi", 1)[1].split("E", 1)[0]
                label = f"K1 register layout, {tiles} tiles"
        elif "registers" in line or "spill" in line:
            out.append(f"{label}: {line.strip().removeprefix('ptxas info    : ')}")
    return out


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: the
    larger of operations over the f32 peak and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    return float(np.sqrt(((est[:, :3, 3] - gt[:, :3, 3]) ** 2).sum(-1).mean()))


def percentile_ms(xs, q) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms_by_kernel(fn, reps: int, names) -> dict:
    """Mean device milliseconds a call spends in each kernel whose name holds
    one of `names` (keyed by that name), under torch.profiler after a
    warm-up: the mean of the launches the profiler recorded over `reps`
    calls, times the kernel's launches in one call (counted under the
    profiler on a call of its own), so launches the profiler drops (it
    dropped some under CUPTI on an H100) do not lower it; None for a name
    the profiler records no device time for."""
    from torch.profiler import ProfilerActivity, profile

    def cuda_events(prof, n):
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and n in e.key]

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as one:
        fn()
        torch.cuda.synchronize()
    per_call = {n: sum(e.count for e in cuda_events(one, n)) for n in names}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for n in names:
        hits = cuda_events(prof, n)
        count = sum(e.count for e in hits)
        us = sum(e.self_device_time_total for e in hits)
        k = per_call[n] or max(1, round(count / reps))
        out[n] = us / 1e3 / count * k if count and us > 0 else None
    return out


def device_ms(fn, reps: int, names) -> float | None:
    """Mean device milliseconds a call spends in the kernels whose names
    hold one of `names` (a call's time on the card alone, where `time_ms`
    of back-to-back calls may be its host's); None where the profiler
    records no device time."""
    found = [ms for ms in device_ms_by_kernel(fn, reps, names).values() if ms is not None]
    return sum(found) if found else None


def profiled_pass(run) -> tuple[float, float, list]:
    """One pass of `run` under torch.profiler, timed by itself: (the
    device's busy ms, the pass's own wall ms, the device events). The idle
    share of the pass is 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    on_dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in on_dev) / 1e3, wall_ms, on_dev


def idle_share(busy_ms: float, wall_ms: float) -> str:
    return f"{100 - 100 * busy_ms / wall_ms:.1f}%" if busy_ms > 0 else "not measured"


def check_k2(inputs, dev_name):
    from slam_sensor_fusion_tpu_torch.ops.nn_pallas import pair_nn, pair_nn_plain

    d2k, idxk, xyzk = pair_nn(*inputs)
    d2p, idxp, xyzp = pair_nn_plain(*inputs)
    torch.cuda.synchronize()
    rel = ((d2k - d2p).abs() / torch.clamp(d2p.abs(), min=1e-30)).max().item()
    same = idxk == idxp
    # idx may differ only where d2 ties exactly between the two rows
    if not bool(torch.all(same | (d2k == d2p))):
        fail("K2: idx differs off an exact d2 tie")
    if not bool(torch.all(torch.where(same, xyzk == xyzp, True))):
        fail("K2: xyz differs where idx agrees")
    if rel > K2_RTOL:
        fail(f"K2: d2 relative error {rel} > {K2_RTOL}")
    err = (d2k - d2p).abs().max().item()
    print(f"K2 pair_nn vs plain: max|d2| diff {err:.3e} (rel {rel:.3e}), idx equal "
          f"{same.float().mean().item():.6f}, shapes src {tuple(inputs[0].shape)} "
          f"tgt {tuple(inputs[1].shape)} [{dev_name}]", flush=True)
    return err


def check_k1(args, dev_name):
    from slam_sensor_fusion_tpu_torch.ops.superblock_fused import (
        superblock_fine,
        superblock_fine_plain,
    )

    k = superblock_fine(*args)
    p = superblock_fine_plain(*args)
    torch.cuda.synchronize()
    worst = 0.0
    for i, name in [(0, "poses"), (1, "priors"), (2, "odom_preds"), (4, "pose"),
                    (5, "odom_prev"), (6, "filt_trans"), (8, "filt_prev")]:
        d = (k[i] - p[i]).abs().max().item()
        worst = max(worst, d)
        if not d <= K1_TOL:
            fail(f"K1: {name} differs by {d} > {K1_TOL}")
    for col, name in [(1, "iterations"), (2, "n_corr"), (3, "converged")]:
        if not torch.equal(k[3][:, col], p[3][:, col]):
            fail(f"K1: {name} differ: {k[3][:, col].tolist()} vs {p[3][:, col].tolist()}")
    if int(k[7]) != int(p[7]):
        fail("K1: queue count differs")
    print(f"K1 superblock_fine vs plain: max|pose/prior/state| diff {worst:.3e}, "
          f"iterations {k[3][:, 1].int().tolist()}, n_corr {k[3][:, 2].int().tolist()} "
          f"equal, shapes src {tuple(args[0].shape)} tgt {tuple(args[15].shape)} [{dev_name}]",
          flush=True)
    return worst


def check_k3(inputs, icp, lazy, dev_name):
    """K3 against its plain version on the same inputs; returns (max |T|
    diff, the plain run's tile pairs visited, stats)."""
    from slam_sensor_fusion_tpu_torch.ops.icp_fused import (
        _fused_core,
        _fused_core_plain,
        _icp_plain,
    )

    T_k, st_k = _fused_core(*inputs, icp, lazy)
    _icp_plain.pairs_visited = 0
    T_p, st_p = _fused_core_plain(*inputs, icp, lazy)
    torch.cuda.synchronize()
    what = "K3 lazy" if lazy else "K3 fresh"
    d = (T_k - T_p).abs().max().item()
    if not d <= K3_TOL:
        fail(f"{what}: T differs by {d} > {K3_TOL}")
    if not torch.equal(st_k[0, 1:3], st_p[0, 1:3]):
        fail(f"{what}: iterations/n_corr {st_k[0, 1:3].tolist()} vs {st_p[0, 1:3].tolist()}")
    e = (st_k[0, 0] - st_p[0, 0]).abs().item()
    if not e <= K3_ERR_TOL:
        fail(f"{what}: error differs by {e} > {K3_ERR_TOL}")
    if not int(st_k[0, 1]) >= 1:
        fail(f"{what}: ICP took no step, the comparison is vacuous")
    print(f"{what} vs plain: max|T| diff {d:.3e}, error diff {e:.3e}, iterations "
          f"{int(st_k[0, 1])}, n_corr {int(st_k[0, 2])} equal, tile pairs visited "
          f"{_icp_plain.pairs_visited}, shapes src {tuple(inputs[0].shape)} tgt "
          f"{tuple(inputs[1].shape)} [{dev_name}]", flush=True)
    return d, _icp_plain.pairs_visited, st_k


def check_per_frame_vs_k1(state0, blk, map_cloud, config, tag):
    """One superblock through run_chunk_fast's per-frame branch (one K3 lazy
    launch a frame) against the same superblock on K1."""
    from slam_sensor_fusion_tpu_torch.models import pipeline_fast as pf

    fin_k, out_k = pf.run_chunk_fast(state0, blk, map_cloud, config)
    fin_f, out_f = pf.run_chunk_fast(
        state0, blk, map_cloud, dataclasses.replace(config, block_kernel=False)
    )
    torch.cuda.synchronize()
    worst = 0.0
    for name in ("map_T_sensor", "map_T_sensor_prior", "map_T_sensor_odom"):
        worst = max(worst, (getattr(out_f, name) - getattr(out_k, name)).abs().max().item())
    worst = max(worst, (fin_f.map_T_sensor - fin_k.map_T_sensor).abs().max().item())
    if not worst <= K3_TOL:
        fail(f"per-frame K3 vs K1: poses differ by {worst} > {K3_TOL}")
    for name in ("icp_iterations", "n_correspondences", "icp_converged", "pair_overflow"):
        if not torch.equal(getattr(out_f, name), getattr(out_k, name)):
            fail(f"per-frame K3 vs K1: {name} differ: {getattr(out_f, name).tolist()} vs "
                 f"{getattr(out_k, name).tolist()}")
    print(f"per-frame superblock (K3 lazy) vs K1: max|pose| diff {worst:.3e}, iterations "
          f"{out_f.icp_iterations.tolist()}, n_corr {out_f.n_correspondences.tolist()} equal "
          f"[{tag}]", flush=True)


def lio_config():
    """bench.py bench_lio's configuration (:85-156) in its `blocks` mode (one
    launch of the fused GN kernel a frame, :252-258) on the `fused` backend."""
    from slam_sensor_fusion_tpu_torch.models.ekf import EKFConfig
    from slam_sensor_fusion_tpu_torch.models.lio import LIOConfig
    from slam_sensor_fusion_tpu_torch.ops.point_to_plane import PointToPlaneConfig

    return LIOConfig(
        scan_capacity=8192, window=16, slot_points=4096, refresh_every=16,
        p2p=PointToPlaneConfig(
            nn_backend="fused", num_iterations=2, fixed_correspondences=True,
            reassoc_margin=0.15, tile_src=512, tile_tgt=1024, max_visits=64, assoc_unroll=1,
        ),
        reg_subsample=4, anchor_subsample=2, normal_est="cells", normal_voxel=1.8,
        normal_planarity=None, icp_cov_mode="gn", gn_cov_scale=1.0, icp_pos_std=0.3,
        superstep_slack=0.05, slack_base=0.1,
        ekf=EKFConfig(init_pos_std=0.1, init_vel_std=0.1),
    )


def build_lio_world(n_frames: int, scan_cap: int):
    """bench.py bench_lio's data (:160-222): the 140 m world, IMU packets,
    skewed scans Morton pre-sorted with their taus riding along, GPS at
    0.5 m noise. Returns (poses, v0, scans (T, S, 3), masks, taus, gyro,
    accel, dts, gps_pos (T-1, 3))."""
    from slam_sensor_fusion_tpu_torch.ops.morton import sort_order_numpy
    from slam_sensor_fusion_tpu_torch.utils import synthetic as syn

    rng = np.random.default_rng(0)
    world = syn.make_world(rng, extent=140.0, n_buildings=70, n_poles=200, points_per_m2=24.0)
    poses = syn.make_trajectory(n_frames, speed_per_frame=0.15, radius=30.0)
    gyro, accel, dts = syn.make_imu(poses, gyro_noise=0.0005, accel_noise=0.005)
    sp = np.zeros((n_frames, scan_cap, 3), np.float32)
    sm = np.zeros((n_frames, scan_cap), bool)
    tp = np.ones((n_frames, scan_cap), np.float32)
    for i in range(n_frames):
        pts, tau = syn.render_scan_skewed(
            world, poses[max(i - 1, 0)], poses[i], rng, max_points=scan_cap, max_range=25.0
        )
        order = sort_order_numpy(pts, isotropic=True)
        n = min(len(pts), scan_cap)
        sp[i, :n], sm[i, :n], tp[i, :n] = pts[order][:n], True, tau[order][:n]
    gps_pos = (
        poses[1:, :3, 3] + np.random.default_rng(3).normal(0, 0.5, (n_frames - 1, 3))
    ).astype(np.float32)
    v0 = ((poses[1][:3, 3] - poses[0][:3, 3]) / 0.1).astype(np.float32)
    return poses, v0, sp, sm, tp, gyro, accel, dts, gps_pos


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| relative to max |b|."""
    return ((a - b).abs().max() / torch.clamp(b.abs().max(), min=1e-30)).item()


def check_gn(what, got, want, dev_name):
    """K4's or K6's (T_out, stats) against the plain version's."""
    (T_k, st_k), (T_p, st_p) = got, want
    torch.cuda.synchronize()
    d = (T_k - T_p).abs().max().item()
    if not d <= K4_TOL:
        fail(f"{what}: T differs by {d} > {K4_TOL}")
    if not torch.equal(st_k[0, 1:3], st_p[0, 1:3]):
        fail(f"{what}: n_corr/iterations {st_k[0, 1:3].tolist()} vs {st_p[0, 1:3].tolist()}")
    e_rmse = rel_err(st_k[0, 0], st_p[0, 0])
    e_jtj = rel_err(st_k[0, 3:25], st_p[0, 3:25])
    if not (e_rmse <= K4_RTOL and e_jtj <= K4_RTOL):
        fail(f"{what}: rmse differs by {e_rmse}, JtJ/wr2 lanes by {e_jtj} (relative) > {K4_RTOL}")
    if bool(st_k[0, 25:].abs().max() != 0):
        fail(f"{what}: the unused stats lanes are not zero")
    if not int(st_k[0, 1]) >= 1000:
        fail(f"{what}: {int(st_k[0, 1])} correspondences, the comparison is vacuous")
    print(f"{what} vs plain: max|T| diff {d:.3e}, rmse rel {e_rmse:.3e}, JtJ lanes rel {e_jtj:.3e}, "
          f"n_corr {int(st_k[0, 1])} equal [{dev_name}]", flush=True)
    return d


def lio_block_inputs(lio, cfg, state, arrays, tau, lo, dev):
    """K7's arguments for the block of frames lo.. of the LIO world from
    `state`, through run_lio_superblocks' own prologue; and the tile pairs
    in its lists."""
    R = cfg.refresh_every
    sp, sm, gy, ac, dt, gp, gv, gok = [a[lo:lo + R] for a in arrays]
    anchor = lio._refresh_anchor(state.ring, state.ring_mask, state.ekf_state.p, cfg)
    cache = anchor[4]
    base_r = math.sqrt(cfg.p2p.max_correspondence_dist_sq) + cfg.p2p.reassoc_margin
    ks = torch.arange(R, dtype=torch.float32, device=dev)
    radius2 = (base_r + cfg.slack_base + cfg.superstep_slack * ks) ** 2
    vld = torch.ones(R, dtype=torch.bool, device=dev)
    pred_t, _, src_pages, pairs, demand, ovf = lio._block_prologue(
        state, cache, sp, sm, tau[lo:lo + R], gy, ac, dt, vld, radius2, cfg)
    if bool(ovf.any()):
        fail("K7 check inputs: pair list overflow")
    e0 = state.ekf_state
    args = (*pairs, vld, gy, ac, dt, gp, gv, gok, pred_t, lio.ekf.pose_matrix(e0), e0.v,
            e0.bg, e0.ba, e0.P, cache.center, src_pages, cache.pages)
    print(f"K7 check inputs: src {tuple(src_pages.shape)} tgt {tuple(cache.pages.shape)}, pair "
          f"demand {demand.tolist()}", flush=True)
    return args, int(pairs[1].sum())


def check_k7(args, params, dev_name):
    """K7 against its plain version on one block; returns max |pose/state|
    diff."""
    from slam_sensor_fusion_tpu_torch.ops.lio_superblock_fused import (
        lio_superblock,
        lio_superblock_plain,
    )

    k = lio_superblock(*args, params)
    p = lio_superblock_plain(*args, params)
    torch.cuda.synchronize()
    worst = 0.0
    for i, what in [(0, "poses"), (2, "pose"), (3, "v"), (4, "bg"), (5, "ba")]:
        d = (k[i] - p[i]).abs().max().item()
        worst = max(worst, d)
        if not d <= K7_TOL:
            fail(f"K7: {what} differs by {d} > {K7_TOL}")
    e_P = rel_err(k[6], p[6])
    if not e_P <= 1e-4:
        fail(f"K7: P differs by {e_P} of max|P|")
    for lane, what in [(1, "n_corr"), (2, "gps_accepted"), (4, "slack_violation")]:
        if not torch.equal(k[1][:, lane], p[1][:, lane]):
            fail(f"K7: {what} differ: {k[1][:, lane].tolist()} vs {p[1][:, lane].tolist()}")
    if not int(p[1][:, 1].min()) >= 1000:
        fail("K7: a frame with under 1000 correspondences, the comparison is vacuous")
    print(f"K7 lio_superblock vs plain: max|pose/state| diff {worst:.3e}, P rel {e_P:.3e}, n_corr "
          f"{k[1][:, 1].int().tolist()} equal, GPS accepted {int(k[1][:, 2].sum())} equal "
          f"[{dev_name}]", flush=True)
    return worst


def push_args(seq, i):
    return (seq.scans[i], seq.odom_T_sensor[i], float(seq.gps_lat[i]), float(seq.gps_lon[i]),
            float(seq.gps_alt[i]), float(seq.compass_yaw[i]), float(seq.odom_cov_trace[i]),
            float(seq.gps_cov_trace[i]))


def profile_pass(run, pf, n_blocks: int, tag: str) -> float:
    """One more steady pass of the superblock main path under
    torch.profiler, timed by itself: prints K1's mean ms a launch, its
    share of the device time and the device's idle share of that pass's
    own wall time. Where the profiler records no device time, K1 is timed
    with CUDA events around each launch instead. Returns K1's ms a launch."""
    busy, pass_ms, on_dev = profiled_pass(run)
    k1 = [e for e in on_dev if "superblock_kernel" in e.key]
    k1_total = sum(e.self_device_time_total for e in k1) / 1e3
    k1_n = sum(e.count for e in k1)
    if busy > 0 and k1_n == n_blocks:
        print(f"superblock profile, one pass: K1 {k1_total / k1_n:.3f} ms a launch over {k1_n} "
              f"launches, {100 * k1_total / busy:.1f}% of device time; device busy {busy:.3f} ms "
              f"of the profiled pass's own {pass_ms:.3f} ms (idle {idle_share(busy, pass_ms)}); "
              f"{sum(e.count for e in on_dev)} device operations [{tag}]", flush=True)
        return k1_total / k1_n
    # no device time under the profiler: CUDA events around each K1 launch
    inner, times = pf.superblock_fine, []

    def timed(*args):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(*args)
        b.record()
        times.append((a, b))
        return out

    pf.superblock_fine = timed
    try:
        run()
    finally:
        pf.superblock_fine = inner
    torch.cuda.synchronize()
    ms = float(np.mean([a.elapsed_time(b) for a, b in times]))
    print(f"superblock profile: the profiler recorded no device time; K1 {ms:.3f} ms a launch "
          f"over {len(times)} launches (CUDA events); device idle share not measured [{tag}]",
          flush=True)
    return ms


def prime_below(n: int) -> int:
    """The largest prime <= n (n >= 2)."""
    while any(n % d == 0 for d in range(2, math.isqrt(n) + 1)):
        n -= 1
    return n


def zero_counts(*kernels) -> None:
    for k in kernels:
        k.launches = 0
        if hasattr(k, "launches_by"):
            k.launches_by = {}


def build_map_world(n_frames: int, scan_cap: int):
    """bench.py bench_map's world, trajectory and skewed scans (:977-994),
    padded to scan_cap: poses, points (T, S, 3), mask (T, S), tau (T, S)."""
    from slam_sensor_fusion_tpu_torch.utils import synthetic as syn

    rng = np.random.default_rng(0)
    world = syn.make_world(rng, extent=140.0, n_buildings=70, n_poles=200, points_per_m2=24.0)
    poses = syn.make_trajectory(n_frames, speed_per_frame=0.15, radius=30.0)
    sp = np.zeros((n_frames, scan_cap, 3), np.float32)
    sm = np.zeros((n_frames, scan_cap), bool)
    tp = np.ones((n_frames, scan_cap), np.float32)
    for i in range(n_frames):
        pts, tau = syn.render_scan_skewed(world, poses[max(i - 1, 0)], poses[i], rng,
                                          max_points=scan_cap, max_range=25.0)
        n = min(len(pts), scan_cap)
        sp[i, :n], sm[i, :n], tp[i, :n] = pts[:n], True, tau[:n]
    return poses, sp, sm, tp


def dedup_capacity(groups, origin, voxel: float, cap: int) -> tuple[int, int]:
    """bench.py bench_map's sizing of the dedup stage (:1003-1025): the most
    distinct cells of the sample groups x 1.5, rounded up to 4096, at most
    `cap`; and that most."""
    worst = 0
    for p in groups:
        ijk = np.floor((p - origin) / voxel).astype(np.int64)
        worst = max(worst, len(np.unique((ijk[:, 0] << 42) + (ijk[:, 1] << 21) + ijk[:, 2])))
    return min(cap, -(-int(worst * 1.5) // 4096) * 4096), worst


def group_world(groups, g: int) -> torch.Tensor:
    """Group g's points (points, mask, tau, twists, poses: (G, 8, ...)
    each), every frame deskewed with its own twist and put in the world
    frame: (8 x S, 3)."""
    from slam_sensor_fusion_tpu_torch.ops.deskew import deskew

    P, _, TAU, XI, TT = groups
    fixed = deskew(P[g], TAU[g], XI[g])
    return (torch.einsum("bij,bnj->bni", TT[g, :, :3, :3], fixed)
            + TT[g, :, None, :3, 3]).reshape(-1, 3)


def map_pass(insert, cfg, state, groups, flushes=None):
    """bench_map's loop over every group: `group_world`, then ONE insert
    for the group. With `flushes`, CUDA events around each insert are
    appended to it."""
    for g in range(groups[0].shape[0]):
        world = group_world(groups, g)
        if flushes is not None:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        state = insert(state, world, groups[1][g].reshape(-1), cfg)
        if flushes is not None:
            b.record()
            flushes.append((a, b))
    return state


def tie_heavy_group(n_rows: int, dev):
    """A segment-sum group of `n_rows` rows: one run of 10 000 rows, then
    singletons, then the last fifth aliased to U - 1 with zero payload
    (half of it -0.0), as the stores clip masked rows."""
    rng = np.random.default_rng(9)
    n_alias = n_rows // 5
    n_single = n_rows - n_alias - 10_000
    seg = np.concatenate([np.zeros(10_000, np.int32), np.arange(1, n_single + 1, dtype=np.int32)])
    U = n_single + 2
    seg = np.concatenate([seg, np.full(n_alias, U - 1, np.int32)])
    vals = (rng.standard_normal((n_rows, 4)) * 30).astype(np.float32)
    vals[-n_alias:] = 0.0
    vals[-n_alias::2] = -0.0
    return torch.from_numpy(vals).to(dev), torch.from_numpy(seg).to(dev), U


def check_segsum(values, seg, U):
    """The segment-sum kernel against its plain version (bits) and against
    `index_add_` on the same rows: max |kernel - plain|, the times by CUDA
    events and on the card alone (profiler), the plain version's, the
    bound, and the output elements where `index_add_` differs."""
    from slam_sensor_fusion_tpu_torch.ops.voxel_segsum import (
        segment_sum_sorted,
        segment_sum_sorted_plain,
    )

    got = segment_sum_sorted(values, seg, U)
    want = segment_sum_sorted_plain(values, seg, U)
    idx = seg.long()
    lib = torch.zeros_like(want).index_add_(0, idx, values)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"voxel_segment_sum differs from its plain version on "
             f"{int((got.view(torch.int32) != want.view(torch.int32)).sum())} of {got.numel()} "
             f"elements")

    def library():
        return torch.zeros_like(want).index_add_(0, idx, values)

    return dict(
        err=(got - want).abs().max().item(),
        ms=time_ms(lambda: segment_sum_sorted(values, seg, U), 20),
        device_ms=device_ms(lambda: segment_sum_sorted(values, seg, U), 20,
                            ("segment_sum_sorted_kernel",)),
        plain_ms=time_ms(lambda: segment_sum_sorted_plain(values, seg, U), 1),
        bound=bound(values.numel(), nbytes(values, seg, want)),
        lib_ms=time_ms(library, 20),
        lib_device_ms=device_ms(library, 20, ("index",)),
        lib_diff=int((lib != got).sum()),
    )


def run_cli(*args, timeout: int = 600):
    """`python -m slam_sensor_fusion_tpu_torch <args>` in a process of its
    own, from the checkout: (its last stdout line as JSON, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "slam_sensor_fusion_tpu_torch", *args],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"CLI {args[0]} exited {r.returncode}: {r.stdout[-1000:]} {r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1]), dt


def cli_streams(seq, tiles, odom_pos, gps_rows):
    """A world (`selftest_world`) as the CLI's RawStreams: the mapping run (its
    map-frame tiles every 2nd frame, the odometry positions, GPS rows and
    compass headings) for `build-map`, and the body scans with every other
    stream's timestamps jittered within the 0.1 s slop (the compass at or
    before its scan) for `localize`."""
    from slam_sensor_fusion_tpu_torch.api import RawStreams

    T = len(seq.scans)
    t = np.arange(T) * 0.1
    rng = np.random.default_rng(7)
    empty = np.zeros((0, 3), np.float32)
    odom_T = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    odom_T[:, :3, 3] = odom_pos
    mapping = RawStreams(
        scan_t=t, scans=[tiles[i // 2] if i % 2 == 0 else empty for i in range(T)],
        gps_t=t, gps_lat=gps_rows[:, 0], gps_lon=gps_rows[:, 1], gps_alt=gps_rows[:, 2],
        gps_cov_trace=seq.gps_cov_trace, odom_t=t, odom_T_sensor=odom_T,
        odom_cov_trace=seq.odom_cov_trace, compass_t=t,
        compass_heading_deg=90.0 - np.rad2deg(gps_rows[:, 3]),
    )

    def jitter():
        return rng.uniform(-STREAM_JITTER, STREAM_JITTER, T)

    replay = RawStreams(
        scan_t=t, scans=seq.scans, gps_t=t + jitter(), gps_lat=seq.gps_lat,
        gps_lon=seq.gps_lon, gps_alt=seq.gps_alt, gps_cov_trace=seq.gps_cov_trace,
        odom_t=t + jitter(), odom_T_sensor=seq.odom_T_sensor,
        odom_cov_trace=seq.odom_cov_trace, compass_t=t - np.abs(jitter()),
        compass_heading_deg=90.0 - np.rad2deg(seq.compass_yaw),
    )
    return mapping, replay


def kitti_world(root: str):
    """bench.py bench_kitti_loc's data (:1337-1393) at seq-00 density: the
    fixture written to `root` and loaded through the port's KITTI loader,
    each scan deskewed with its ground-truth twist (the upstream LIO's
    contract) and the localization streams synthesized around the scans.
    Returns (the loaded KittiSequence, the SensorSequence)."""
    from slam_sensor_fusion_tpu_torch.ops.deskew import deskew_numpy, se3_log_numpy
    from slam_sensor_fusion_tpu_torch.utils import kitti
    from slam_sensor_fusion_tpu_torch.utils import synthetic as syn

    kitti.make_synthetic_kitti(root, n_frames=KITTI_FRAMES, max_points=KITTI_POINTS,
                               extent=KITTI_EXTENT, points_per_m2=KITTI_DENSITY)
    kseq = kitti.load_sequence(root, "00")
    scans = [kseq.scans[0]]
    for i in range(1, len(kseq.scans)):
        rel = np.linalg.inv(kseq.poses[i - 1]) @ kseq.poses[i]
        scans.append(deskew_numpy(kseq.scans[i], kitti.azimuth_taus(kseq.scans[i]),
                                  se3_log_numpy(rel)))
    return kseq, syn.make_sequence_from_scans(scans, kseq.poses)


def bench_kitti_lio_config(scans, tile_src: int):
    """bench.py bench_kitti's LIOConfig word for word on its fixture
    (:1193-1227: registration subsample 8, normal cells of 1.2 m, the fused
    backend), at source tiles of `tile_src`, with the scan capacity
    suggest_scan_capacity gives for `scans`."""
    from slam_sensor_fusion_tpu_torch.models.ekf import EKFConfig
    from slam_sensor_fusion_tpu_torch.models.lio import LIOConfig
    from slam_sensor_fusion_tpu_torch.ops.point_to_plane import PointToPlaneConfig
    from slam_sensor_fusion_tpu_torch.utils import kitti

    return LIOConfig(
        scan_capacity=kitti.suggest_scan_capacity(scans), window=16, slot_points=4096,
        refresh_every=16,
        p2p=PointToPlaneConfig(
            nn_backend="fused", num_iterations=2, fixed_correspondences=True,
            reassoc_margin=0.15, tile_src=tile_src, tile_tgt=1024, max_visits=64,
            assoc_unroll=1,
        ),
        reg_subsample=BENCH_KITTI_REG_SUB, anchor_subsample=2, normal_est="cells",
        normal_voxel=1.2, icp_cov_mode="gn", icp_pos_std=0.3, superstep_slack=0.05,
        slack_base=0.1, ekf=EKFConfig(init_pos_std=0.1, init_vel_std=0.1),
    )


def kitti_lio_config(scans):
    """bench.py bench_kitti's configuration on its fixture (:1195-1227,
    the block driver), with the scan capacity and registration subsample
    utils/autosize.suggest_lio_config picks for `scans`."""
    from slam_sensor_fusion_tpu_torch.utils.autosize import suggest_lio_config

    return suggest_lio_config(scans, base=bench_kitti_lio_config(scans, 512))


def lio_inputs(kseq, cap: int):
    """bench_kitti's loader contract (:1229-1262): Morton pre-sorted scans
    padded to `cap` with their azimuth taus riding along, the synthesized
    IMU, GPS at 0.5 m noise. Returns (scans, masks, taus, gyro, accel, dts,
    gps)."""
    from slam_sensor_fusion_tpu_torch.ops.morton import sort_order_numpy
    from slam_sensor_fusion_tpu_torch.utils import kitti

    T = len(kseq.scans)
    sp = np.zeros((T, cap, 3), np.float32)
    sm = np.zeros((T, cap), bool)
    tp = np.ones((T, cap), np.float32)
    for i, s in enumerate(kseq.scans):
        if len(s) > cap:
            fail(f"KITTI LIO: a scan of {len(s)} points over the capacity {cap}")
        order = sort_order_numpy(s, isotropic=True)
        sp[i, :len(s)], sm[i, :len(s)], tp[i, :len(s)] = s[order], True, kitti.azimuth_taus(s)[order]
    gyro, accel, dts = kitti.synthesize_imu(kseq.poses)
    gps = (kseq.poses[1:, :3, 3]
           + np.random.default_rng(3).normal(0, 0.5, (T - 1, 3))).astype(np.float32)
    return sp, sm, tp, gyro, accel, dts, gps


def phase10(dev, tag, name, kernels, record, launches):
    """The product's entry points (api, CLI, selftest, the KITTI-format
    loader, autosize, Localizer.run's debug branch) on the card; returns
    the numbers phase 10 adds to the kernels' record."""
    import logging

    from slam_sensor_fusion_tpu_torch import api
    from slam_sensor_fusion_tpu_torch.__main__ import save_streams
    from slam_sensor_fusion_tpu_torch.examples_selftest import selftest_config, selftest_world
    from slam_sensor_fusion_tpu_torch.models import lio
    from slam_sensor_fusion_tpu_torch.models import localization as lz
    from slam_sensor_fusion_tpu_torch.models import pipeline_fast as pf
    from slam_sensor_fusion_tpu_torch.models.mapping import StreamingMapper, build_map_data
    from slam_sensor_fusion_tpu_torch.ops.icp_fused import _icp_plain
    from slam_sensor_fusion_tpu_torch.ops.superblock_fused import kernel_grid as sb_grid
    from slam_sensor_fusion_tpu_torch.ops.superblock_fused import (
        superblock_fine,
        superblock_fine_plain,
    )
    from slam_sensor_fusion_tpu_torch.utils import autosize, profiling
    from slam_sensor_fusion_tpu_torch.utils import synthetic as syn
    from slam_sensor_fusion_tpu_torch.utils.config import MappingConfig

    t_phase = time.perf_counter()
    by_name = dict(zip(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "voxel_segment_sum",
                        "cumsum_rows", "xla_math"), kernels))
    pair_nn, lio_superblock = by_name["K2"], by_name["K7"]
    segment_sum_sorted = by_name["voxel_segment_sum"]
    out = {}

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- a. the selftest, as a user runs it ----
    st, st_s = run_cli("selftest")
    for k, n in st["launches"].items():
        launches[by_name[k]]["selftest"] = n
    print(f"selftest (python -m slam_sensor_fusion_tpu_torch selftest): ATE-RMSE "
          f"{st['ate_rmse_m']} m, {st['frames']} valid frames, ok {st['ok']}, device {st['device']}, "
          f"{st_s:.1f} s with the process's start; launches {st['launches']} [{tag}]", flush=True)
    if not (st["ok"] and st["launches"]["K2"] > 0):
        fail(f"selftest: ok {st['ok']}, K2 launched {st['launches']['K2']} times")

    # ---- b. the CLI: build-map, then localize on jittered streams, each
    # in a process of its own, LocalizationConfig() defaults ----
    # the selftest's world at the map density LocalizationConfig() assumes:
    # walls at 96 points a square metre, not 24, and map scans of 24 000
    # points, not 6000. The defaults keep every 3rd map point and every
    # 15th of those for the brute force; on the selftest's own world that
    # leaves ~120 brute-force points in a crop and the coarse ladder never
    # succeeds
    cseq, ctiles, codom, cgps = selftest_world(points_per_m2=96.0, map_scan_points=24000)
    mapping, replay = cli_streams(cseq, ctiles, codom, cgps)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.npz") for k in ("mapping", "replay", "trajectory")}
        save_streams(paths["mapping"], mapping)
        save_streams(paths["replay"], replay)
        mdir = os.path.join(tmp, "map_data")
        _, bm_s = run_cli("build-map", "--map-data-path", mdir, "--streams", paths["mapping"])
        lo, lo_s = run_cli("localize", "--map-data-path", mdir, "--streams", paths["replay"],
                           "--output", paths["trajectory"])
        with np.load(paths["trajectory"]) as z:
            traj = {k: z[k] for k in z.files}
    for k, n in lo["launches"].items():
        launches[by_name[k]]["cli_localize"] = n
    if sorted(traj) != ["icp_error", "icp_iterations", "map_T_sensor", "valid"]:
        fail(f"CLI localize: the trajectory file holds {sorted(traj)}")
    v = traj["valid"]
    c_ate = ate_rmse(traj["map_T_sensor"][v], cseq.true_map_T_sensor[v])
    print(f"CLI: build-map {bm_s:.1f} s, localize {lo_s:.1f} s (processes with their start; "
          f"LocalizationConfig() defaults, the full brute-force grid; the selftest world at 96 "
          f"points a square metre, 24 000-point map scans), {int(v.sum())} valid frames "
          f"from frame {lo['first_processed_frame']}, ATE-RMSE {c_ate:.4f} m, device "
          f"{lo['device']}; launches {lo['launches']} [{tag}]", flush=True)
    if not (c_ate < SELFTEST_ATE_LIMIT and v[5:].all() and np.isfinite(traj["map_T_sensor"]).all()):
        fail(f"CLI localize: ATE-RMSE {c_ate} (limit {SELFTEST_ATE_LIMIT}), valid {v.astype(int)}")
    print(f"phase 10 a-b (selftest, CLI): {time.perf_counter() - t_phase:.1f} s [{tag}]", flush=True)

    # ---- c. KITTI-format localization at seq-00 density: the fixture
    # through the loader, api.build_map, an autosized config, api.localize
    # from the map_data directory twice ----
    t0 = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    kseq, kloc = kitti_world(os.path.join(tmp, "kitti"))
    gen_s = time.perf_counter() - t0
    T = len(kseq.scans)
    sizes = np.array([len(s) for s in kseq.scans])
    poses = kseq.poses
    empty = np.zeros((0, 3), np.float32)
    tiles = [(s @ poses[i][:3, :3].T + poses[i][:3, 3]).astype(np.float32)
             if i % KITTI_MAP_EVERY == 0 else empty for i, s in enumerate(kloc.scans)]
    odom_pos, gps_rows = syn.make_mapping_logs(kloc)
    mdir = os.path.join(tmp, "map_data")
    t1 = time.perf_counter()
    md = api.build_map(tiles, odom_pos, *gps_rows.T, map_data_path=mdir)
    build_s = time.perf_counter() - t1
    cfg = autosize.suggest_localization_config(
        kloc.scans[:KITTI_SAMPLE], md.map_points, base=bench_config(subsample=2),
        poses_xyz=poses[:KITTI_SAMPLE, :3, 3],
    )
    TM, TN = cfg.icp.tile_src, cfg.icp.tile_tgt
    nSt, nTt = cfg.capacity.cropped_scan // TM, cfg.capacity.cropped_map // TN
    max_pairs = nSt * cfg.icp.max_pairs_factor
    # what K3's wrapper would allocate at this shape (K3 does not run on
    # this path; K1's and K2's are read from their wrappers below)
    k3_scratch = max_pairs * TM * 8 + nSt * TM * 16
    g = sb_grid(nSt, TM, TN)
    print(f"KITTI fixture: {T} frames, {sizes.min()}-{sizes.max()} points a scan (mean "
          f"{sizes.mean():.0f}), generated, written, loaded and deskewed in {gen_s:.1f} s; "
          f"api.build_map of {len(tiles[::KITTI_MAP_EVERY])} map-frame scans {build_s:.1f} s, "
          f"{md.map_points.shape[0]} map points; autosized: scan {cfg.capacity.scan} "
          f"({nSt} source tiles of {TM}), cropped map {cfg.capacity.cropped_map} ({nTt} target "
          f"tiles of {TN}), map {cfg.capacity.map}, max_pairs {max_pairs} "
          f"(factor {cfg.icp.max_pairs_factor}); K3's per-slot scratch at this shape "
          f"{k3_scratch} B (computed; K3 does not run here); K1 grid {g['blocks']} blocks of "
          f"{g['threads']} threads [{tag}]", flush=True)
    if g["blocks"] < MIN_GRID_BLOCKS:
        fail(f"K1 at {nSt} x {TM}: a grid of {g['blocks']} blocks")

    blocks, staging, first_k1 = [], [], []
    inner = (pf.run_chunk_fast, pf.build_paged_frames, pf.superblock_fine)

    def run_chunk_fast(state, frames, map_cloud, config):
        st_, outs = inner[0](state, frames, map_cloud, config)
        blocks.append((frames.valid.shape[0] // config.superstep, outs.pair_overflow.sum(),
                       outs.slack_violation.sum(), outs.pair_demand.max()))
        return st_, outs

    def build_paged_frames(*a, **kw):
        t = time.perf_counter()
        r = inner[1](*a, **kw)
        staging.append(time.perf_counter() - t)
        return r

    def superblock(*a):
        if not first_k1:
            first_k1.append(tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a))
        return inner[2](*a)

    loc_args = dict(
        scans=kloc.scans, odom_T_sensor=kloc.odom_T_sensor, gps_lat=kloc.gps_lat,
        gps_lon=kloc.gps_lon, gps_alt=kloc.gps_alt, compass_yaw=kloc.compass_yaw,
        odom_cov_trace=kloc.odom_cov_trace, gps_cov_trace=kloc.gps_cov_trace,
        map_data_path=mdir, config=cfg, device=dev,
    )
    zero_counts(*kernels)
    superblock_fine.scratch_bytes = pair_nn.scratch_bytes = 0
    torch.cuda.reset_peak_memory_stats()
    pf.run_chunk_fast, pf.build_paged_frames, pf.superblock_fine = (
        run_chunk_fast, build_paged_frames, superblock)
    try:
        for p in range(2):
            blocks.clear()
            staging.clear()
            before = superblock_fine.launches
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = api.localize(**loc_args)
            loc_s = time.perf_counter() - t1
            launched = superblock_fine.launches - before
            n_blocks = sum(b[0] for b in blocks)
            n_ovf = sum(int(b[1]) for b in blocks)
            n_slack = sum(int(b[2]) for b in blocks)
            demand = max(int(b[3]) for b in blocks)
            v = res.valid
            k_ate = ate_rmse(res.map_T_sensor[v], kloc.true_map_T_sensor[v])
            host_ms = 1e3 * sum(staging) / (n_blocks * cfg.superstep)
            print(f"KITTI localize pass {p} (api.localize from map_data): {T} frames {loc_s:.3f} s "
                  f"= {T / loc_s:.1f} scans/s with the map load and startup, {int(v.sum())} valid "
                  f"from frame {res.first_processed_frame}, ATE-RMSE {k_ate:.4f} m, pair-overflow "
                  f"frames {n_ovf}, slack-violations {n_slack}, pair demand max {demand} of "
                  f"{max_pairs} slots, K1 launches {launched} for {n_blocks} "
                  f"superblocks, host staging (build_paged_frames) {host_ms:.2f} ms a frame "
                  f"[{tag}]", flush=True)
            if launched != n_blocks:
                fail(f"KITTI localize: K1 launched {launched} times for {n_blocks} superblocks")
            if n_ovf or n_slack:
                fail(f"KITTI localize: pair overflow on {n_ovf} frames, slack violated on {n_slack}")
            if not (np.isfinite(res.map_T_sensor).all() and v[2:].all()):
                fail(f"KITTI localize: valid {v.astype(int)}, or a non-finite pose")
            if not k_ate < ATE_LIMIT:
                fail(f"KITTI localize: ATE-RMSE {k_ate} >= {ATE_LIMIT}")
        record("kitti_localize")
        peak = torch.cuda.max_memory_allocated()
        # the per-slot scratch K1's and K2's wrappers allocated (K2: the
        # rescue ICP's pair list)
        scratch = {"K1": superblock_fine.scratch_bytes, "K2": pair_nn.scratch_bytes}
        # a third pass under the profiler, timed by itself: its device
        # operations' time against its own wall time
        trace_dir = os.path.join(tmp, "trace")
        with profiling.trace(trace_dir):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            api.localize(**loc_args)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t1
    finally:
        pf.run_chunk_fast, pf.build_paged_frames, pf.superblock_fine = inner
    on_dev = profiling.summarize_trace(trace_dir, top=sys.maxsize)
    busy = sum(ms for _, ms, _ in on_dev)
    k1_dev = sum(ms for op, ms, _ in on_dev if "superblock_kernel" in op)
    idle = f"{100 - 100 * busy / (prof_s * 1e3):.1f}%" if busy > 0 else "not measured"
    print(f"KITTI localize: peak device memory {peak} B (max_memory_allocated over both passes); "
          f"per-slot scratch allocated: K1 {scratch['K1']} B, K2 {scratch['K2']} B; a third "
          f"pass under the profiler (utils/profiling.trace): device busy {busy:.1f} ms of its "
          f"{prof_s * 1e3:.1f} ms (idle {idle}), K1 {k1_dev:.1f} ms [{tag}]", flush=True)
    out.update(kitti_scans_s=T / loc_s, kitti_host_ms=host_ms, kitti_idle=idle,
               kitti_peak_bytes=peak, kitti_scratch=scratch, kitti_tiles=(nSt, TM, nTt, TN),
               kitti_ate=k_ate)

    # K1 at this shape against its plain version: the first superblock
    _icp_plain.pairs_visited = 0
    out["k1_err"] = check_k1(first_k1[0], name)
    pairs = _icp_plain.pairs_visited
    out["k1_ms"] = time_ms(lambda: superblock_fine(*first_k1[0]), 3)
    out["k1_plain_ms"] = time_ms(lambda: superblock_fine_plain(*first_k1[0]), 1)
    out["k1_bound"] = bound(
        pairs * TM * TN * FLOP_PER_DISTANCE,
        nbytes(*[a for a in first_k1[0] if isinstance(a, torch.Tensor)])
        + nbytes(*superblock_fine(*first_k1[0])),
    )
    print(f"K1 at {nSt} x {TM} (KITTI, first superblock): {out['k1_ms']:.3f} ms (plain "
          f"{out['k1_plain_ms']:.3f}), bound {out['k1_bound'][0]:.4f} ms ({out['k1_bound'][1]}), "
          f"{pairs} tile pairs visited [{tag}]", flush=True)
    print(f"phase 10 c (KITTI localization): {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)

    # ---- d. KITTI-format LIO at the same density (bench_kitti's block
    # driver, autosized capacity and registration subsample) ----
    t0 = time.perf_counter()
    kcfg = kitti_lio_config(kseq.scans)
    sp, sm, tp, gyro, accel, dts, gps = lio_inputs(kseq, kcfg.scan_capacity)
    Tl = T - 1
    state0 = lio.init_state(kcfg, up(sp[0]), up(sm[0]), up(poses[0].astype(np.float32)))
    v0 = ((poses[1, :3, 3] - poses[0, :3, 3]) / 0.1).astype(np.float32)
    state0 = state0._replace(ekf_state=state0.ekf_state._replace(v=up(v0)))
    arrays = [up(a) for a in (sp[1:], sm[1:], gyro, accel, dts, gps,
                              np.full(Tl, 0.5**2, np.float32), np.ones(Tl, bool))]
    tau = up(tp[1:])
    prep_s = time.perf_counter() - t0
    n_blk = -(-Tl // kcfg.refresh_every)
    zero_counts(*kernels)
    for p in range(2):
        before = lio_superblock.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, lout = lio.run_lio_superblocks(state0, *arrays, kcfg, scan_tau=tau)
        torch.cuda.synchronize()
        lio_s = time.perf_counter() - t1
        launched = lio_superblock.launches - before
        est = lout.world_T_body.cpu().numpy()
        l_ate = ate_rmse(est, poses[1:])
        n_ovf = int(lout.pair_overflow.sum())
        print(f"KITTI LIO pass {p} (run_lio_superblocks): {Tl} frames {lio_s:.3f} s = "
              f"{Tl / lio_s:.1f} scans/s, ATE-RMSE {l_ate:.4f} m, pair overflow {n_ovf}, n_corr "
              f"mean {lout.n_correspondences.float().mean().item():.0f}, K7 launches {launched}; "
              f"scan capacity {kcfg.scan_capacity}, registration subsample {kcfg.reg_subsample} "
              f"({kcfg.scan_capacity // kcfg.reg_subsample // kcfg.p2p.tile_src} source "
              f"tiles of {kcfg.p2p.tile_src}) [{tag}]", flush=True)
        if launched != n_blk:
            fail(f"KITTI LIO: K7 launched {launched} times for {n_blk} blocks")
        if n_ovf:
            fail(f"KITTI LIO: pair overflow on {n_ovf} frames")
        if not np.isfinite(est).all():
            fail("KITTI LIO: non-finite pose")
        if not l_ate < LIO_ATE_LIMIT:
            fail(f"KITTI LIO: ATE-RMSE {l_ate} >= {LIO_ATE_LIMIT}")
    record("kitti_lio")
    out.update(lio_scans_s=Tl / lio_s, lio_ate=l_ate, kseq=kseq)
    del arrays, tau
    print(f"phase 10 d (KITTI LIO): {time.perf_counter() - t0:.1f} s (host inputs {prep_s:.1f} s) "
          f"[{tag}]", flush=True)

    # ---- e. the autosized device map store over the map-frame scans ----
    t0 = time.perf_counter()
    mframes = [i for i, tl_ in enumerate(tiles) if len(tl_)]
    vox = MappingConfig().map_voxel_size
    vcfg, origin = autosize.suggest_voxel_map_config([tiles[i] for i in mframes], vox)
    cap = 1 << int(np.ceil(np.log2(max(len(tiles[i]) for i in mframes))))
    zero_counts(*kernels)
    mapper = StreamingMapper(MappingConfig(), device_origin=origin, device_config=vcfg,
                             device_scan_capacity=cap, device=dev)
    for i in mframes:
        mapper.add_frame(tiles[i], odom_pos[i], *gps_rows[i])
    try:
        dmd = mapper.finalize(use_device=True)
    except ValueError as e:  # the store counted dropped or out-of-grid points
        fail(f"KITTI map store: {e}")
    torch.cuda.synchronize()
    record("kitti_map")
    n_seg = launches[segment_sum_sorted]["kitti_map"]
    print(f"KITTI map store (autosized hash store: {vcfg.table_size} slots, {vcfg.dim_xy} x "
          f"{vcfg.dim_xy} x {vcfg.dim_z} cells, unique_capacity {vcfg.unique_capacity}): "
          f"{len(mframes)} inserts of up to {cap} points, dropped 0, out of grid 0 (finalize reads "
          f"both), {dmd.map_points.shape[0]} cells against the host merge's "
          f"{md.map_points.shape[0]}, voxel_segment_sum launches {n_seg}, "
          f"{time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    if n_seg != len(mframes):
        fail(f"KITTI map store: voxel_segment_sum launched {n_seg} times for {len(mframes)} inserts")
    tmp_dir.cleanup()

    # ---- f. Localizer.run's debug branch over the selftest world ----
    t0 = time.perf_counter()
    sseq, stiles, sodom, sgps = selftest_world()
    smd = build_map_data(stiles, sodom, sgps)
    run_args = (sseq.scans, sseq.odom_T_sensor, sseq.gps_lat, sseq.gps_lon, sseq.gps_alt,
                sseq.compass_yaw, sseq.odom_cov_trace, sseq.gps_cov_trace)
    zero_counts(*kernels)
    want = lz.Localizer(smd, selftest_config(), dev).run(*run_args)
    msgs = []
    handler = logging.Handler()
    handler.emit = lambda r: msgs.append(r.getMessage())
    logger = logging.getLogger("slam_sensor_fusion_tpu_torch")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        with tempfile.TemporaryDirectory() as ddir:
            got = lz.Localizer(smd, dataclasses.replace(selftest_config(), enable_debug=True),
                               dev).run(*run_args, debug_dir=ddir)
            files = {f: os.path.getsize(os.path.join(ddir, f)) for f in os.listdir(ddir)}
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    record("debug")
    for f in dataclasses.fields(want):
        if not np.array_equal(getattr(got, f.name), getattr(want, f.name)):
            fail(f"debug branch: {f.name} differs from the run without debug")
    need = ("cropped_scan_map_frame.ply", "cropped_map.ply", "map.ply", "trajectory.svg",
            "viewer.html")
    if not all(files.get(f, 0) > 0 for f in need):
        fail(f"debug branch: files {files}")
    if not any("CALLBACK TOOK" in m for m in msgs):
        fail(f"debug branch: no CALLBACK TOOK in the log {msgs}")
    print(f"debug branch (Localizer.run, enable_debug, selftest world): poses and outputs equal bit "
          f"for bit to the run without debug, files {files}, log "
          f"{[m.splitlines()[0] for m in msgs]}, {time.perf_counter() - t0:.1f} s [{tag}]",
          flush=True)
    print(f"phase 10 entry points: {time.perf_counter() - t_phase:.1f} s [{tag}]", flush=True)
    return out


def phase11(dev, tag, kernels, record, p) -> dict:
    """The multi-device layer (slam_sensor_fusion_tpu_torch/parallel) on the
    card at the bench's widths, from the worlds and states of phases 3, 6,
    7 and 9 (`p`): every path over a mesh held by this process (n shards
    in turn on the one card), each against its single-device run; then the
    distributed form in processes of their own, and the dry run."""
    from slam_sensor_fusion_tpu_torch.models import lio
    from slam_sensor_fusion_tpu_torch.models import localization as lz
    from slam_sensor_fusion_tpu_torch.models import pipeline_fast as pf
    from slam_sensor_fusion_tpu_torch.ops import cloud as cl
    from slam_sensor_fusion_tpu_torch.ops.brute_force import brute_force_align
    from slam_sensor_fusion_tpu_torch.ops.icp import icp_align
    from slam_sensor_fusion_tpu_torch.ops.lio_superblock_fused import lio_superblock
    from slam_sensor_fusion_tpu_torch.ops.nn_pallas import pair_nn
    from slam_sensor_fusion_tpu_torch.ops.superblock_fused import superblock_fine
    from slam_sensor_fusion_tpu_torch.ops.voxel_map import (
        voxel_map_centroids_numpy,
        voxel_map_init,
        voxel_map_insert,
    )
    from slam_sensor_fusion_tpu_torch.ops.voxel_segsum import segment_sum_sorted
    from slam_sensor_fusion_tpu_torch.parallel import (
        batch,
        dryrun,
        lio_fleet,
        map_shard,
        voxel_map_shard,
    )
    from slam_sensor_fusion_tpu_torch.parallel.brute_force import sharded_brute_force_align
    from slam_sensor_fusion_tpu_torch.parallel.mesh import make_mesh, tree_index, tree_stack

    t0 = time.perf_counter()
    res = {}
    config, loc, state, seq, gps_T = p["config"], p["loc"], p["state"], p["seq"], p["gps_T"]
    n_sh = SHARDS11
    dp4 = make_mesh(n_sh, "dp", dev, single_process=True)
    sp4 = make_mesh(n_sh, "sp", dev, single_process=True)

    def stack(x, B):
        return x if x is None else torch.stack([x] * B)

    # the superblock fleet: B sequences of phase 3's world, 4 superblocks each
    n = FLEET11_FRAMES
    frames = pf.PagedFrames(*[x[:n] for x in p["frames"]])
    B = FLEET11_SEQUENCES
    zero_counts(*kernels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ffin, fout = batch.fleet_run_chunk_fast(
        tree_stack([state] * B), pf.PagedFrames(*[stack(x, B) for x in frames]),
        cl.Cloud(*[stack(x, B) for x in loc.map_cloud]), config, dp4)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    record("fleet_chunk_fast")
    k1 = superblock_fine.launches
    _, solo = pf.run_chunk_fast(state, frames, loc.map_cloud, config)
    gt = seq.true_map_T_sensor[1:n + 1]
    ates = [ate_rmse(fout.map_T_sensor[b].cpu().numpy(), gt) for b in range(B)]
    n_ovf, n_slack = int(fout.pair_overflow.sum()), int(fout.slack_violation.sum())
    res["fleet_scans_s"] = B * n / dt
    print(f"fleet_run_chunk_fast: {B} sequences x {n} frames over {n_sh} dp shards {dt:.3f} s = "
          f"{res['fleet_scans_s']:.1f} scans/s, ATE-RMSE {', '.join(f'{a:.4f}' for a in ates)} m, "
          f"pair-overflow frames {n_ovf}, slack-violations {n_slack}, K1 launches {k1} [{tag}]",
          flush=True)
    for b in range(B):
        if not torch.equal(fout.map_T_sensor[b], solo.map_T_sensor):
            fail(f"fleet_run_chunk_fast: sequence {b} differs from its own run by "
                 f"{(fout.map_T_sensor[b] - solo.map_T_sensor).abs().max().item()}")
    if n_ovf or n_slack or k1 != B * (n // config.superstep) or not max(ates) < ATE_LIMIT:
        fail(f"fleet_run_chunk_fast: overflow {n_ovf}, slack {n_slack}, K1 launches {k1}, "
             f"ATE-RMSE {max(ates)}")

    # the per-frame fleet on the "xla" backend (the gated XLA search)
    n, B = BATCHED11_FRAMES, 2
    sl = slice(1, n + 1)
    fb = lz.build_frame_batch(config, seq.scans[sl], seq.odom_T_sensor[sl], gps_T[sl],
                              seq.odom_cov_trace[sl], seq.gps_cov_trace[sl], np.ones(n, bool), dev)
    zero_counts(*kernels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, bout = batch.batched_run_chunk(
        tree_stack([state] * B), lz.FrameBatch(*[stack(x, B) for x in fb]),
        cl.Cloud(*[stack(x, B) for x in loc.map_cloud]), config)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    record("batched_run_chunk")
    _, bsolo = lz.run_chunk(state, fb, loc.map_cloud, batch._xla_config(config))
    b_ate = ate_rmse(bout.map_T_sensor[0].cpu().numpy(), seq.true_map_T_sensor[sl])
    print(f"batched_run_chunk: {B} sequences x {n} frames on the gated \"xla\" backend {dt:.3f} s, "
          f"ATE-RMSE {b_ate:.4f} m, iterations {bout.icp_iterations[0].tolist()}, overflow frames "
          f"{int(bout.pair_overflow.sum())} [{tag}]", flush=True)
    for b in range(B):
        if not torch.equal(bout.map_T_sensor[b], bsolo.map_T_sensor):
            fail(f"batched_run_chunk: sequence {b} differs from its own run_chunk")
    if not np.isfinite(b_ate):
        fail("batched_run_chunk: a non-finite pose")

    # the brute force over the candidate grid: with no candidate under the
    # threshold, then with the threshold at twice the best score (the first
    # candidate under it in enumeration order wins, not the best)
    bf_in = p["bf"][:5]
    thr = 1e-9
    for label in ("none", "hit"):
        bcfg = dataclasses.replace(config.brute_force, mean_error_threshold=thr)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = sharded_brute_force_align(*bf_in, bcfg, sp4)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        want = brute_force_align(*bf_in, bcfg)
        same = (bool(got.success) == bool(want.success)
                and torch.equal(got.transformation, want.transformation)
                and torch.equal(got.score, want.score))
        print(f"sharded_brute_force_align ({label}): success {bool(got.success)}, score "
              f"{float(got.score):.6f}, {dt * 1e3:.1f} ms over {n_sh} shards; equal to "
              f"brute_force_align bit for bit: {same} [{tag}]", flush=True)
        if not same or bool(got.success) != (label == "hit"):
            fail(f"sharded_brute_force_align ({label}) differs from brute_force_align: success "
                 f"{bool(got.success)} vs {bool(want.success)}, score {float(got.score)} vs "
                 f"{float(want.score)}")
        thr = 2.0 * float(want.score)
    record("sharded_brute_force")

    # map-sharded ICP: phase 3's cropped scan against the whole map split
    # into 4 Morton-contiguous shards, K2 once a shard an association
    icfg = config.icp
    whole = loc.map_cloud
    map_np = whole.points[whole.mask].cpu().numpy()
    shards, smask = map_shard.shard_cloud(map_np, n_sh, icfg.tile_tgt)
    shards, smask = torch.from_numpy(shards).to(dev), torch.from_numpy(smask).to(dev)
    cscan, T0 = p["cscan"], nudge(p["coarse_T"], 0.3, -0.2, 2.0)
    zero_counts(*kernels)
    single = icp_align(cscan.points, cscan.mask, whole.points, whole.mask, T0, icfg)
    k2_single = pair_nn.launches
    zero_counts(*kernels)
    sharded = map_shard.sp_icp_align(cscan.points, cscan.mask, shards, smask, T0, icfg, sp4)
    torch.cuda.synchronize()
    record("sp_icp_align")
    k2_sharded = pair_nn.launches
    gap = (sharded.transformation - single.transformation).abs().max().item()
    print(f"sp_icp_align over {n_sh} shards of the whole map ({map_np.shape[0]} points): "
          f"{int(sharded.iterations)} iterations, n_corr {int(sharded.n_correspondences)}, max |T| "
          f"diff to icp_align on the whole map {gap:.3e}, error diff "
          f"{abs(float(sharded.error) - float(single.error)):.3e}; K2 launches {k2_sharded} "
          f"(whole map {k2_single}) [{tag}]", flush=True)
    if (int(sharded.iterations), int(sharded.n_correspondences)) != (
            int(single.iterations), int(single.n_correspondences)):
        fail("sp_icp_align: iterations or n_corr differ from icp_align on the whole map")
    if not (gap <= SP_TOL and abs(float(sharded.error) - float(single.error)) <= 1e-5):
        fail(f"sp_icp_align: T differs by {gap} or error by "
             f"{abs(float(sharded.error) - float(single.error))}")
    if bool(sharded.pair_overflow) or bool(single.pair_overflow) or k2_sharded != n_sh * k2_single:
        fail(f"sp_icp_align: overflow, or K2 launched {k2_sharded} times for {k2_single} "
             f"associations over {n_sh} shards")

    # the map-sharded steady state: 32 frames from frame 9, started at the
    # superblock path's posterior of frame 8 (the coarse pose's error has
    # been worked off by then)
    n = SP11_FRAMES
    sl = slice(9, n + 9)
    fb = lz.build_frame_batch(config, seq.scans[sl], seq.odom_T_sensor[sl], gps_T[sl],
                              seq.odom_cov_trace[sl], seq.gps_cov_trace[sl], np.ones(n, bool), dev)
    scans = cl.crop_radius(cl.Cloud(fb.scan_points, fb.scan_mask),
                           torch.zeros(3, device=dev), config.cloud_crop_radius)
    xs = (scans.points, scans.mask, fb.odom_T_sensor, fb.map_T_sensor_gps, fb.odom_cov_trace,
          fb.gps_cov_trace)
    st0 = map_shard.sp_init_state(solo.map_T_sensor[7], seq.odom_T_sensor[8], config.filter,
                                  device=dev)
    zero_counts(*kernels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, sout = map_shard.sp_run_chunk(st0, *xs, shards, smask, icfg, config.filter, sp4)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    record("sp_run_chunk")
    k2_frame = pair_nn.launches / n
    _, wout = map_shard.sp_run_chunk_single(st0, *xs, whole.points, whole.mask, icfg,
                                            config.filter)
    s_ate = ate_rmse(sout.map_T_sensor.cpu().numpy(), seq.true_map_T_sensor[sl])
    gap = (sout.map_T_sensor - wout.map_T_sensor).abs().max().item()
    res["sp_scans_s"], res["sp_k2_a_frame"] = n / dt, k2_frame
    print(f"sp_run_chunk: {n} frames over {n_sh} map shards {dt:.3f} s = {n / dt:.1f} scans/s, "
          f"ATE-RMSE {s_ate:.4f} m, max |T| diff to the whole map {gap:.3e}, overflow frames "
          f"{int(sout.pair_overflow.sum())}, K2 launches a frame {k2_frame:.2f} [{tag}]",
          flush=True)
    if not (torch.equal(sout.n_correspondences, wout.n_correspondences)
            and torch.equal(sout.icp_converged, wout.icp_converged)):
        fail("sp_run_chunk: n_corr or convergence differ from the whole map's loop")
    if not gap <= SP_TOL or sout.pair_overflow.any() or wout.pair_overflow.any():
        fail(f"sp_run_chunk: T differs by {gap}, or a pair list overflowed")
    if not s_ate < ATE_LIMIT:
        fail(f"sp_run_chunk: ATE-RMSE {s_ate} >= {ATE_LIMIT}")

    # the sharded voxel store: phase 9's groups, each shard's table below
    # the single store's live cells
    worlds, masks, hcfg = p["map_worlds"], p["map_masks"], p["hash_config"]
    single = voxel_map_init(hcfg, MAP_ORIGIN, dev)
    for w, m in zip(worlds, masks):
        single = voxel_map_insert(single, w, m, hcfg)
    want = voxel_map_centroids_numpy(single)
    # a shard's table below the map's live cells holds its quarter of
    # them at 2/7 of its slots, ~10x the single store's occupancy. A prime
    # size gives every probe stride a full cycle; on this world a power of
    # two, or a size with small factors, leaves cells unplaced after the
    # probe budget at this occupancy, and the store counts their points
    # dropped
    table = prime_below(len(want) * 7 // 8)
    scfg = hcfg._replace(table_size=table)
    if not table < len(want):
        fail(f"sharded voxel store: a shard's table of {table} holds the {len(want)} cells")
    pts = torch.stack(worlds)
    zero_counts(*kernels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vst = voxel_map_shard.sp_voxel_map_init(scfg, MAP_ORIGIN, sp4, dev)
    vst = voxel_map_shard.sp_voxel_map_insert_chunk(vst, pts, masks, scfg, sp4)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    record("sp_voxel_map")
    dropped, oob, per_shard = voxel_map_shard.sp_voxel_map_flags(vst)
    got = voxel_map_shard.sp_voxel_map_centroids_numpy(vst)

    def rows(a):
        return a[np.lexsort((a[:, 2], a[:, 1], a[:, 0]))]

    exact = got.shape == want.shape and np.array_equal(rows(got), rows(want))
    res["sp_map_frames_s"] = MAP_FRAMES / dt
    print(f"sp_voxel_map_insert_chunk: {len(worlds)} groups ({MAP_FRAMES} frames) over {n_sh} "
          f"shards of {table} slots {dt:.3f} s = {MAP_FRAMES / dt:.1f} frames/s; {len(want)} cells, "
          f"per shard {per_shard.tolist()}, dropped {dropped}, oob {oob}; union == one store "
          f"cell for cell: {exact}; voxel_segment_sum launches {segment_sum_sorted.launches} "
          f"[{tag}]", flush=True)
    if dropped or oob or not exact:
        fail(f"sharded voxel store: dropped {dropped}, oob {oob}, union equal {exact}")
    if segment_sum_sorted.launches != n_sh * len(worlds):
        fail(f"sharded voxel store: {segment_sum_sorted.launches} segment sums for "
             f"{n_sh * len(worlds)} shard inserts")

    # the LIO fleets, one robot a shard, against phase 7's fleet (each
    # robot already equal to its own run) and the robots' own run_lio_blocks
    lcfg, lstates, robots = p["lcfg"], p["lio_states"], p["lio_robots"]
    dp2 = make_mesh(len(robots), "dp", dev, single_process=True)
    stacked = [torch.stack(xs) for xs in zip(*robots)]
    zero_counts(*kernels)
    mfin, mout = lio_fleet.fleet_run_lio_superblocks(lstates, *stacked, lcfg, mesh=dp2)
    torch.cuda.synchronize()
    record("lio_fleet_superblocks_mesh")
    k7 = lio_superblock.launches
    ffin, fout = p["lio_fleet"]
    if not (torch.equal(mout.world_T_body, fout.world_T_body)
            and torch.equal(mfin.ekf_state.P, ffin.ekf_state.P) and torch.equal(mfin.ring, ffin.ring)):
        fail("fleet_run_lio_superblocks over a mesh differs from the robots' own runs")
    zero_counts(*kernels)
    t1 = time.perf_counter()
    _, xout = lio_fleet.fleet_run_lio(lstates, *stacked, lcfg, mesh=dp2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    record("lio_fleet_xla_mesh")
    for b, frames in enumerate(robots):
        _, xsolo = lio.run_lio_blocks(tree_index(lstates, b), *frames, lio_fleet._xla_config(lcfg))
        if not torch.equal(xout.world_T_body[b], xsolo.world_T_body):
            fail(f"fleet_run_lio: robot {b} differs from its own run_lio_blocks")
    x_ate = [ate_rmse(xout.world_T_body[b].cpu().numpy(), p["lio_gt"]) for b in range(len(robots))]
    print(f"LIO fleets over {len(robots)} dp shards: fleet_run_lio_superblocks equal to phase 7's "
          f"robots (K7 launches {k7}); fleet_run_lio (\"xla\" backend) {dt:.3f} s, each robot equal "
          f"to its own run_lio_blocks, ATE-RMSE {', '.join(f'{a:.4f}' for a in x_ate)} m [{tag}]",
          flush=True)
    if not max(x_ate) < LIO_ATE_LIMIT:
        fail(f"fleet_run_lio: ATE-RMSE {max(x_ate)} >= {LIO_ATE_LIMIT}")

    # the distributed form: a 1-rank NCCL group, and 2 gloo ranks holding 2
    # shards each on the one card (NCCL refuses two ranks on one card; gloo
    # stages its gathers through the host), against this process's 4 shards
    inputs = dict(
        icp=dict(source=cscan.points, source_mask=cscan.mask, map_points=map_np,
                 initial_T=T0, config=icfg),
        p2p=p["p2p"],
        bf=tuple(p["bf"][:5]) + (config.brute_force,),
    )
    want = dryrun.sharded_registration(sp4, **inputs)
    for world, backend in [(1, "nccl"), (2, "gloo")]:
        t1 = time.perf_counter()
        got = dryrun.run_distributed(inputs, n_sh, world, backend, "cuda", timeout=300)
        dt = time.perf_counter() - t1
        same = {k: dryrun.bit_equal(got[k], want[k]) for k in want}
        print(f"distributed form: {world} {backend} rank(s) x {n_sh // world} shards, "
              f"sp_icp_align / sp_p2p_align / sharded_brute_force_align equal to one process "
              f"bit for bit: {same} ({dt:.1f} s with the processes' start) [{tag}]", flush=True)
        if not all(same.values()):
            fail(f"distributed form ({world} {backend} ranks) differs from one process: {same}")

    # the dry run on the card
    line = dryrun.dryrun_multichip(n_sh, dev)
    print(f"phase 11 multi-device layer: {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)
    res["dryrun"] = line
    return res


def voxel_reference(points, mask, origin, voxel: float, grid_dim: int):
    """`voxel_downsample_numpy`'s centroids in `voxel_downsample`'s row
    order, for the rows whose float32 cell (the device's arithmetic) is
    their float64 cell (the host merge's): (kept rows (N,) bool, centroids
    (n, 3)). Fails where the wrapped ids of two cells collide or a cell
    lies off the grid. The host merge numbers cells in (i, j, k) order; the
    device in the order of their int32 ids, (i * g + j) * g + k wrapped."""
    from slam_sensor_fusion_tpu_torch.ops.cloud import voxel_downsample_numpy

    p32 = points.cpu().numpy()
    o32 = np.asarray(origin, np.float32)
    c64 = np.floor((p32.astype(np.float64) - o32.astype(np.float64)) / voxel)
    c32 = np.floor((p32 - o32) / np.float32(voxel))
    kept = mask.cpu().numpy() & (c32 == c64).all(axis=1)
    cells = np.unique(c64[kept].astype(np.int64), axis=0)  # (i, j, k) order
    if not ((cells >= 0) & (cells < grid_dim)).all():
        fail("voxel_downsample reference: a cell lies off the grid")
    lin = (cells[:, 0] * grid_dim + cells[:, 1]) * grid_dim + cells[:, 2]
    wrapped = (lin + 2**31) % 2**32 - 2**31
    if len(np.unique(wrapped)) != len(cells):
        fail("voxel_downsample reference: two cells share a wrapped id")
    want = voxel_downsample_numpy(p32[kept], voxel, origin=o32)
    return kept, want[np.argsort(wrapped, kind="stable")]


def phase12(dev, tag, kernels, record, launches, p) -> dict:
    """The public helpers on the card at full width (`p`: phase 3's first
    steady frame, phase 9's first group): `gated_nn_pallas` (K2) on the
    cropped scan against the cropped map, `voxel_downsample`
    (voxel_segment_sum) on a scan and a group, then `masked_points`,
    `to_numpy`, `rotation`, `translation` and `svd3x3`; each against the
    same call on CPU copies, K2's against a dense search too and the voxel
    grid against the host merge. Returns the numbers for the kernels'
    record."""
    from slam_sensor_fusion_tpu_torch.ops import cloud as cl
    from slam_sensor_fusion_tpu_torch.ops import geometry as geo
    from slam_sensor_fusion_tpu_torch.ops.nn_gated import build_visit_lists
    from slam_sensor_fusion_tpu_torch.ops.nn_pallas import gated_nn_pallas, pair_nn
    from slam_sensor_fusion_tpu_torch.ops.voxel_segsum import segment_sum_sorted

    t0 = time.perf_counter()
    res = {}
    icp = p["config"].icp
    TM, TN = icp.tile_src, icp.tile_tgt
    pages, cnt, pose = p["frame_pages"], p["frame_cnt"], p["pose"]
    src = geo.transform_points(pose, pages.transpose(1, 2).reshape(-1, 3))
    smask = (torch.arange(TM, device=dev)[None, :] < cnt[:, None]).reshape(-1)
    tgt, tmask = p["cropped_map"].points, p["cropped_map"].mask
    center = geo.translation(pose).contiguous()
    r2 = icp.max_correspondence_dist_sq
    nSt = src.shape[0] // TM
    _, counts, _ = build_visit_lists(src, smask, tgt, tmask, r2, TM, TN, icp.max_visits)
    demand = int(counts.sum())
    nn_args = (src, smask, tgt, tmask, center, r2)
    nn_kw = {
        "full": dict(tile_src=TM, tile_tgt=TN, max_visits=icp.max_visits,
                     max_pairs=nSt * icp.max_pairs_factor),
        "truncated": dict(tile_src=TM, tile_tgt=TN, max_visits=icp.max_visits,
                          max_pairs=demand // 2),
    }
    MAP_GRID = 2048  # voxel_downsample's default grid
    rows = {"scan": (p["scan"], MAP_SCAN_CAP), "group": (p["group"], MAP_GROUP * MAP_SCAN_CAP)}
    vox_cases = {(k, o): (pm, n, o) for k, (pm, n) in rows.items() for o in ("min", "map")}

    map_origin = torch.tensor(MAP_ORIGIN, device=dev)

    def vox(points, mask, n, origin):
        o = None if origin == "min" else map_origin.to(points.device)
        return cl.voxel_downsample(cl.Cloud(points, mask), MAP_VOXEL, n, origin=o)

    # the main path: each helper once on the card, launches counted
    zero_counts(*kernels)
    nn_got = {k: gated_nn_pallas(*nn_args, **kw) for k, kw in nn_kw.items()}
    vox_got = {k: vox(*pm, n, o) for k, (pm, n, o) in vox_cases.items()}
    torch.cuda.synchronize()
    record("public_helpers")
    n_k2, n_seg = launches[pair_nn]["public_helpers"], launches[segment_sum_sorted]["public_helpers"]
    if n_k2 != len(nn_kw) or n_seg != len(vox_cases):
        fail(f"public helpers: K2 launched {n_k2} times for {len(nn_kw)} calls, "
             f"voxel_segment_sum {n_seg} for {len(vox_cases)}")

    # gated_nn_pallas against its CPU run (the plain K2) and a dense search
    cpu_args = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in nn_args)
    for k, kw in nn_kw.items():
        t1 = time.perf_counter()
        want = gated_nn_pallas(*cpu_args, **kw)
        plain_s = time.perf_counter() - t1
        got = nn_got[k]
        if bool(got.overflow) != bool(want.overflow) or bool(got.overflow) != (k == "truncated"):
            fail(f"gated_nn_pallas {k}: overflow {bool(got.overflow)} on the card, "
                 f"{bool(want.overflow)} on the CPU")
        if not torch.equal(got.idx.cpu(), want.idx):
            fail(f"gated_nn_pallas {k}: idx differs from the CPU run on "
                 f"{int((got.idx.cpu() != want.idx).sum())} rows")
        rel = ((got.d2.cpu() - want.d2).abs() / want.d2.abs().clamp(min=1e-30)).max().item()
        if rel > K2_RTOL:
            fail(f"gated_nn_pallas {k}: d2 relative error {rel} > {K2_RTOL} against the CPU run")
        if k == "full":
            res["gnn_plain_ms"] = plain_s * 1e3
        print(f"gated_nn_pallas {k} (max_pairs {kw['max_pairs']}, tile-pair demand {demand}): "
              f"idx and overflow ({bool(got.overflow)}) equal the CPU run, d2 rel {rel:.2e}; "
              f"CPU {plain_s * 1e3:.1f} ms [{tag}]", flush=True)
    full = nn_got["full"]
    s64, t64 = src.double(), tgt.double()
    t_norm = torch.where(tmask, (t64 * t64).sum(-1), torch.inf)
    dmin, darg = [], []
    for i0 in range(0, s64.shape[0], 1024):
        s = s64[i0:i0 + 1024]
        d2 = (s * s).sum(-1)[:, None] - 2.0 * s @ t64.T + t_norm[None, :]
        m, a = d2.min(dim=1)
        dmin.append(m)
        darg.append(a)
    dmin, darg = torch.cat(dmin), torch.cat(darg)
    inside = smask & (dmin < r2)
    exact = ((s64 - t64[full.idx.long()]) ** 2).sum(-1)  # its choice's distance
    off_choice = (exact - dmin)[inside].abs().max().item()
    off_d2 = (full.d2.double() - exact)[inside].abs().max().item()
    if off_choice > DENSE_TOL or off_d2 > DENSE_TOL:
        fail(f"gated_nn_pallas: within the gate its choice is {off_choice:.2e} m^2 from the dense "
             f"minimum and its d2 {off_d2:.2e} m^2 from its choice's (> {DENSE_TOL})")
    n_in = int(inside.sum())
    n_other = int((full.idx.long() != darg)[inside].sum())
    print(f"gated_nn_pallas vs a dense search (float64) on {n_in} of {int(smask.sum())} rows with a "
          f"neighbour in the gate: choice within {off_choice:.2e} m^2 of the minimum, d2 within "
          f"{off_d2:.2e} m^2; {n_other} rows chose another point at that distance [{tag}]",
          flush=True)
    res["gnn_ms"] = time_ms(lambda: gated_nn_pallas(*nn_args, **nn_kw["full"]), 20)
    # every kernel of a call ("" is in every name): the card's busy time
    res["gnn_device_ms"] = device_ms(lambda: gated_nn_pallas(*nn_args, **nn_kw["full"]), 10, ("",))
    res["gnn_bound"] = bound(
        min(demand, nn_kw["full"]["max_pairs"]) * TM * TN * FLOP_PER_DISTANCE,
        nbytes(*nn_args[:5]) + nbytes(full.d2, full.idx, full.overflow),
    )
    print(f"gated_nn_pallas ({nSt} x {TM} source rows, {tgt.shape[0] // TN} x {TN} target, "
          f"{min(demand, nn_kw['full']['max_pairs'])} tile pairs): {res['gnn_ms']:.4f} ms a call, "
          f"the card busy {res['gnn_device_ms']} ms of it (profiler), "
          f"CPU {res['gnn_plain_ms']:.1f} ms, bound {res['gnn_bound'][0]:.4f} ms "
          f"({res['gnn_bound'][1]}) [{tag}]", flush=True)

    # voxel_downsample against its CPU run (bits) and the host merge (sets)
    for (k, o), (pm, n, _) in vox_cases.items():
        pts, msk = pm
        got = vox_got[k, o]
        t1 = time.perf_counter()
        want = vox(pts.cpu(), msk.cpu(), n, o)
        plain_s = time.perf_counter() - t1
        if not (torch.equal(got.points.cpu(), want.points) and torch.equal(got.mask.cpu(), want.mask)):
            fail(f"voxel_downsample {k}, origin {o}: the card differs from the CPU run")
        origin = (torch.where(msk[:, None], pts, torch.inf).amin(0).cpu().numpy() if o == "min"
                  else np.asarray(MAP_ORIGIN, np.float32))
        kept, ref = voxel_reference(pts, msk, origin, MAP_VOXEL, MAP_GRID)
        sub = cl.voxel_downsample(cl.Cloud(pts, torch.from_numpy(kept).to(dev)), MAP_VOXEL, n,
                                  origin=torch.from_numpy(origin).to(dev))
        u = ref.shape[0]
        sm = sub.mask.cpu().numpy()
        if not (sm[:u].all() and not sm[u:].any()):
            fail(f"voxel_downsample {k}, origin {o}: {int(sm.sum())} cells against the host "
                 f"merge's {u}")
        err = float(np.abs(sub.points.cpu().numpy()[:u] - ref).max())
        if err > VOXEL_TOL:
            fail(f"voxel_downsample {k}, origin {o}: centroids {err:.2e} m from the host merge's")
        neg = int((sub.points[:u, 0] - float(origin[0]) >= 512 * MAP_VOXEL).sum())
        print(f"voxel_downsample {k} ({n} rows, origin {o}): {int(got.mask.sum())} cells, bits equal "
              f"the CPU run (CPU {plain_s * 1e3:.1f} ms); {u} cells over {int(kept.sum())} rows "
              f"({int(msk.sum()) - int(kept.sum())} on a float32/float64 cell boundary left out) "
              f"equal the host merge's to {err:.2e} m, {neg} of them at i >= 512 (negative ids) "
              f"[{tag}]", flush=True)
        if (k, o) == ("group", "map"):
            res["vox_plain_ms"] = plain_s * 1e3
    gpts, gmsk = p["group"]
    res["vox_ms"] = time_ms(lambda: vox(gpts, gmsk, MAP_GROUP * MAP_SCAN_CAP, "map"), 20)
    res["vox_device_ms"] = device_ms(lambda: vox(gpts, gmsk, MAP_GROUP * MAP_SCAN_CAP, "map"), 10,
                                     ("",))
    gout = vox_got["group", "map"]
    res["vox_bound"] = bound(4 * int(gmsk.sum()), nbytes(gpts, gmsk) + nbytes(*gout))
    print(f"voxel_downsample group ({gpts.shape[0]} rows, bench_map's anchor): {res['vox_ms']:.4f} "
          f"ms a call, the card busy {res['vox_device_ms']} ms of it (profiler), CPU "
          f"{res['vox_plain_ms']:.1f} ms, bound {res['vox_bound'][0]:.5f} ms "
          f"({res['vox_bound'][1]}) [{tag}]", flush=True)

    # masked_points, to_numpy, rotation, translation, svd3x3: the card's
    # results against the CPU's
    scan = cl.Cloud(src, smask)
    cscan = cl.Cloud(src.cpu(), smask.cpu())
    if not torch.equal(cl.masked_points(scan).cpu(), cl.masked_points(cscan)):
        fail("masked_points: the card differs from the CPU")
    if not np.array_equal(cl.to_numpy(scan), cl.to_numpy(cscan)):
        fail("to_numpy: the card differs from the CPU")
    for f in (geo.rotation, geo.translation):
        if not torch.equal(f(pose).cpu(), f(pose.cpu())):
            fail(f"{f.__name__}: the card differs from the CPU")
    H = torch.from_numpy(np.random.default_rng(12).normal(size=(64, 3, 3)).astype(np.float32))
    U, S, Vh = geo.svd3x3(H.to(dev))
    _, S_cpu, _ = geo.svd3x3(H)
    s_rel = ((S.cpu() - S_cpu).abs() / S_cpu[:, :1]).max().item()
    rebuild = ((U * S[:, None, :]) @ Vh - H.to(dev)).abs().max().item()
    if s_rel > SVD_RTOL or rebuild > SVD_TOL:
        fail(f"svd3x3: S {s_rel:.2e} (relative) from the CPU's, rebuild {rebuild:.2e}")
    print(f"masked_points, to_numpy, rotation, translation equal the CPU's; svd3x3 of 64 3x3 on "
          f"the card: S within {s_rel:.2e} of the CPU's (relative to the largest), U diag(S) Vh "
          f"within {rebuild:.2e} of H [{tag}]", flush=True)
    print(f"phase 12 public helpers: {time.perf_counter() - t0:.1f} s; launches K2 {n_k2}, "
          f"voxel_segment_sum {n_seg} [{tag}]", flush=True)
    return res


def p2p_bounds(k4_in, cfg, k4_out, k5_out, k6_in, k6_out) -> dict:
    """The bounds (ms, by) of K4 fixed and fresh, K5 and K6 on one frame's
    inputs: the distances over the tile pairs in the list, ~110 float
    operations a point a GN pass, each input and output byte once."""
    TM, TN = k4_in[0].shape[-1], k4_in[1].shape[-1]
    n_pass = cfg.num_iterations + 1
    gn_flops = n_pass * k4_in[0].shape[0] * TM * FLOP_PER_GN_POINT
    assoc_flops = int(k4_in[3].sum()) * TM * TN * FLOP_PER_DISTANCE
    k4_bytes = nbytes(*k4_in) + nbytes(*k4_out)
    return {
        "K4": bound(assoc_flops + gn_flops, k4_bytes),
        "K4 fresh": bound(n_pass * assoc_flops + gn_flops, k4_bytes),
        "K5": bound(assoc_flops, nbytes(*k4_in) + nbytes(*k5_out)),
        "K6": bound(gn_flops, nbytes(*k6_in) + nbytes(*k6_out)),
    }


def k7_bound_of(k7_in, k7_pairs: int, cfg, k7_out) -> tuple[float, str]:
    """K7's bound on a block: the distances over the block's tile pairs
    (once a frame with fixed correspondences), the GN passes' points and
    the EKF's 16x16 products, each input and output byte once."""
    Kb, nSt, _, TM = k7_in[17].shape
    TN, Ki = k7_in[18].shape[-1], k7_in[6].shape[1]
    n_pass = cfg.p2p.num_iterations + 1
    n_assoc = 1 if cfg.p2p.fixed_correspondences else n_pass
    flops = (n_assoc * k7_pairs * TM * TN * FLOP_PER_DISTANCE
             + Kb * n_pass * nSt * TM * FLOP_PER_GN_POINT
             + Kb * (2 * Ki + 4) * FLOP_PER_EKF_PRODUCT)
    return bound(flops, nbytes(*[a for a in k7_in if isinstance(a, torch.Tensor)])
                 + nbytes(*k7_out))


def check_wide_kernels(lio, cfg, state, arrays, tau, lo, dev, name, tag) -> dict:
    """K4 (fixed and fresh), K5, K6 and K6(K5(x)) against their plain
    versions on frame `lo`'s registration rows (the state's ring after the
    frames before it, its anchor refreshed), and K7 against its plain
    version on the first 2 frames of the block from `lo`; their times and
    bounds."""
    from slam_sensor_fusion_tpu_torch.ops import p2p_fused as p2p
    from slam_sensor_fusion_tpu_torch.ops.lio_superblock_fused import (
        lio_superblock,
        lio_superblock_plain,
    )

    W = cfg.p2p.tile_src
    st = lio._with_anchor(
        state, lio._refresh_anchor(state.ring, state.ring_mask, state.ekf_state.p, cfg),
        lio._pose_cov6(state.ekf_state.P))
    _, prior, scan = lio._prior_and_scan(st, arrays[0][lo], arrays[2][lo], arrays[3][lo],
                                         arrays[4][lo], cfg, tau[lo])
    rsub = cfg.reg_subsample
    k4_in, _, demand = p2p.p2p_inputs(scan[::rsub].contiguous(), arrays[1][lo][::rsub].contiguous(),
                                      st.anchor_cache, prior, cfg.p2p)
    fixed, fresh = cfg.p2p, cfg.p2p._replace(fixed_correspondences=False)
    print(f"K4 at {W} rows: src {tuple(k4_in[0].shape)} tgt {tuple(k4_in[1].shape)}, pair demand "
          f"{int(demand)}, in the list {int(k4_in[3].sum())} of {k4_in[4].shape[0]}", flush=True)
    r = {"K4 err": check_gn(f"K4 fixed at {W} rows", p2p._p2p_core(*k4_in, fixed),
                            p2p._p2p_core_plain(*k4_in, fixed), name),
         "K4 fresh err": check_gn(f"K4 fresh at {W} rows", p2p._p2p_core(*k4_in, fresh),
                                  p2p._p2p_core_plain(*k4_in, fresh), name)}
    d2_k, qn_k = p2p._p2p_associate(*k4_in)
    d2_p, qn_p = p2p._p2p_associate_plain(*k4_in)
    torch.cuda.synchronize()
    k5_rel = ((d2_k - d2_p).abs() / torch.clamp(d2_p.abs(), min=1e-30)).max().item()
    if not (k5_rel <= K5_RTOL and torch.equal(qn_k, qn_p)):
        fail(f"K5 at {W} rows: d2 relative error {k5_rel}, matched pages equal "
             f"{torch.equal(qn_k, qn_p)}")
    r["K5 err"] = (d2_k - d2_p).abs()[d2_p < 1e6].max().item()
    print(f"K5 at {W} rows vs plain: d2 rel {k5_rel:.3e}, matched pages equal [{name}]", flush=True)
    k6_in = (k4_in[5], k4_in[0], d2_p, qn_p)
    r["K6 err"] = check_gn(f"K6 at {W} rows", p2p._p2p_gn_corr(*k6_in, fixed),
                           p2p._p2p_gn_corr_plain(*k6_in, fixed), name)
    whole = p2p._p2p_core(*k4_in, fixed)
    halves = p2p._p2p_gn_corr(k4_in[5], k4_in[0], d2_k, qn_k, fixed)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(whole, halves)):
        fail(f"K6(K5(x)) at {W} rows differs from K4 with fixed correspondences")
    calls = {
        "K4": (lambda: p2p._p2p_core(*k4_in, fixed), lambda: p2p._p2p_core_plain(*k4_in, fixed)),
        "K4 fresh": (lambda: p2p._p2p_core(*k4_in, fresh),
                     lambda: p2p._p2p_core_plain(*k4_in, fresh)),
        "K5": (lambda: p2p._p2p_associate(*k4_in), lambda: p2p._p2p_associate_plain(*k4_in)),
        "K6": (lambda: p2p._p2p_gn_corr(*k6_in, fixed),
               lambda: p2p._p2p_gn_corr_plain(*k6_in, fixed)),
    }
    bounds = p2p_bounds(k4_in, fixed, whole, (d2_k, qn_k), k6_in, halves)
    r["K6 device ms"] = device_ms(calls["K6"][0], 10, K6_KERNELS)
    # the card alone by a CUDA graph's replay: the profiler records no
    # launch of K6's cluster at these widths
    r["K6 graph ms"] = graph_ms(calls["K6"][0], 10)
    for k, (kernel, plain) in calls.items():
        r[f"{k} ms"], r[f"{k} plain ms"], r[f"{k} bound"] = (
            time_ms(kernel, 5), time_ms(plain, 1), bounds[k])
    r["K6 cluster"] = p2p.gn_cluster(k4_in[0].shape[0], W)
    r["K4 grid"] = p2p.kernel_grid(k4_in[0].shape[0], W)
    print(f"at {W} rows: " + ", ".join(
        f"{k} {r[f'{k} ms']:.3f} ms (plain {r[f'{k} plain ms']:.1f}, bound {r[f'{k} bound'][0]:.4f} "
        f"by {r[f'{k} bound'][1]})" for k in calls)
        + f"; K6 on the card alone {r['K6 device ms']} ms (profiler), {r['K6 graph ms']:.5f} ms (a "
        f"CUDA graph's replay), its cluster {r['K6 cluster']}, K4's grid "
        f"{r['K4 grid']} [{tag}]", flush=True)
    # K7 on the first 2 frames of the block from `lo`
    k7_in, _ = lio_block_inputs(lio, cfg, state, arrays, tau, lo, dev)
    k7_2 = tuple(a[:2] if i in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 17) else a
                 for i, a in enumerate(k7_in))
    params = lio._superblock_params(cfg)
    r["K7 err"] = check_k7(k7_2, params, name)
    r["K7 2-frame ms"] = time_ms(lambda: lio_superblock(*k7_2, params), 3)
    r["K7 2-frame plain ms"] = time_ms(lambda: lio_superblock_plain(*k7_2, params), 1)
    return r


def phase13(dev, tag, name, kernels, record, seq00) -> dict:
    """bench.py bench_kitti's own LIO settings (registration subsample 8,
    its LIOConfig word for word) through run_lio_superblocks (K7) at source
    tiles of 512, 2048 and 4096 rows, on (a) bench_kitti's own fixture
    (16 384 points a scan, 140 m) and (b) phase 10's seq-00-density
    fixture (`seq00`, cut to 65 frames); K4-K7 against their plain versions
    at 2048 and 4096 rows on (b). Returns the numbers for the kernels'
    record."""
    from types import SimpleNamespace

    from slam_sensor_fusion_tpu_torch.models import lio
    from slam_sensor_fusion_tpu_torch.ops.lio_superblock_fused import kernel_grid as lio_grid
    from slam_sensor_fusion_tpu_torch.utils import kitti

    t_phase = time.perf_counter()
    k7 = kernels[6]
    out = {"runs": {}, "wide": {}}

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        kitti.make_synthetic_kitti(tmp, n_frames=BENCH_KITTI_FRAMES, max_points=BENCH_KITTI_POINTS,
                                   extent=KITTI_EXTENT)
        seq_a = kitti.load_sequence(tmp, "00")
    fixtures = {
        "a": seq_a,
        "b": SimpleNamespace(scans=seq00.scans[:SEQ00_LIO_FRAMES],
                             poses=seq00.poses[:SEQ00_LIO_FRAMES]),
    }
    print(f"phase 13 fixtures: (a) bench_kitti's, {len(seq_a.scans)} frames of up to "
          f"{max(len(s) for s in seq_a.scans)} points, made in {time.perf_counter() - t0:.1f} s; "
          f"(b) phase 10's, {SEQ00_LIO_FRAMES} frames of up to "
          f"{max(len(s) for s in fixtures['b'].scans)} points", flush=True)
    for fx, seq in fixtures.items():
        t0 = time.perf_counter()
        poses = seq.poses
        cfg0 = bench_kitti_lio_config(seq.scans, WIDE_TILES[0])
        sp, sm, tp, gyro, accel, dts, gps = lio_inputs(seq, cfg0.scan_capacity)
        Tl = len(seq.scans) - 1
        arrays = [up(a) for a in (sp[1:], sm[1:], gyro, accel, dts, gps,
                                  np.full(Tl, 0.5**2, np.float32), np.ones(Tl, bool))]
        tau = up(tp[1:])
        v0 = up(((poses[1, :3, 3] - poses[0, :3, 3]) / 0.1).astype(np.float32))
        R = cfg0.refresh_every
        rows = cfg0.scan_capacity // cfg0.reg_subsample
        n_blk = -(-Tl // R)
        trajs = {}
        for W in WIDE_TILES:
            if rows % W:
                print(f"({fx}) {rows} registration rows do not fill tiles of {W}", flush=True)
                continue
            cfg = cfg0._replace(p2p=cfg0.p2p._replace(tile_src=W))
            state0 = lio.init_state(cfg, up(sp[0]), up(sm[0]), up(poses[0].astype(np.float32)))
            state0 = state0._replace(ekf_state=state0.ekf_state._replace(v=v0))

            def run():
                return lio.run_lio_superblocks(state0, *arrays, cfg, scan_tau=tau)

            zero_counts(*kernels)
            for p in range(2):
                before = k7.launches
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                _, lout = run()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t1
                launched = k7.launches - before
                est = lout.world_T_body.cpu().numpy()
                ate = ate_rmse(est, poses[1:])
                n_ovf = int(lout.pair_overflow.sum())
                what = f"bench_kitti LIO ({fx}) at {rows // W} x {W} rows, pass {p}"
                print(f"{what}: {Tl} frames {dt:.3f} s = {Tl / dt:.1f} scans/s, ATE-RMSE {ate:.4f} m, "
                      f"pair overflow {n_ovf}, n_corr mean {lout.n_correspondences.float().mean().item():.0f}, "
                      f"K7 launches {launched} for {n_blk} blocks; scan capacity {cfg.scan_capacity}, "
                      f"registration subsample {cfg.reg_subsample} [{tag}]", flush=True)
                if launched != n_blk:
                    fail(f"{what}: K7 launched {launched} times for {n_blk} blocks")
                if n_ovf:
                    fail(f"{what}: pair overflow on {n_ovf} frames")
                if not (np.isfinite(est).all() and torch.isfinite(lout.rmse).all()):
                    fail(f"{what}: a non-finite pose")
                if not ate < LIO_ATE_LIMIT:
                    fail(f"{what}: ATE-RMSE {ate} >= {LIO_ATE_LIMIT}")
            record(f"lio13_{fx}{W}")
            trajs[W] = est
            # K7 a block by CUDA events: the second block, from the first's state
            mid, _ = lio.run_lio_superblocks(state0, *[a[:R] for a in arrays], cfg,
                                             scan_tau=tau[:R])
            # phase 14's inputs: (a)'s first anchor, (b)'s after one block
            out.setdefault(f"anchor_{fx}", ((state0 if fx == "a" else mid), cfg))
            k7_in, k7_pairs = lio_block_inputs(lio, cfg, mid, arrays, tau, R, dev)
            params = lio._superblock_params(cfg)
            k7_ms = time_ms(lambda: k7(*k7_in, params), 3)
            k7_bnd = k7_bound_of(k7_in, k7_pairs, cfg, k7(*k7_in, params))
            busy, wall, on_dev = profiled_pass(run)
            k7_dev = sum(e.self_device_time_total for e in on_dev
                         if "lio_superblock_kernel" in e.key) / 1e3
            out["runs"][f"{fx}{W}"] = dict(
                scans_s=Tl / dt, ate=ate, k7_ms=k7_ms, k7_bound=k7_bnd, busy_ms=busy,
                wall_ms=wall, idle=idle_share(busy, wall), k7_profiled_ms=k7_dev / n_blk,
                rows=rows, grid=lio_grid(rows // W, W))
            print(f"bench_kitti LIO ({fx}) at {rows // W} x {W} rows: {Tl / dt:.1f} scans/s; K7 "
                  f"{k7_ms:.3f} ms a block of {R} frames (CUDA events, {k7_pairs} tile pairs), "
                  f"bound {k7_bnd[0]:.4f} ms ({k7_bnd[1]}); a profiled pass: device busy "
                  f"{busy:.1f} ms of its own {wall:.1f} ms (idle {idle_share(busy, wall)}), K7 "
                  f"{k7_dev / n_blk:.3f} ms a block there [{tag}]", flush=True)
            if fx == "b" and W > 1024:
                out["wide"][W] = check_wide_kernels(lio, cfg, mid, arrays, tau, R, dev, name, tag)
        base = trajs[WIDE_TILES[0]][:, :3, 3]
        gaps = {W: (float(np.abs(e[:R, :3, 3] - base[:R]).max()),
                    float(np.abs(e[:, :3, 3] - base).max())) for W, e in trajs.items()}
        print(f"bench_kitti LIO ({fx}): the widths' trajectories against {WIDE_TILES[0]} rows, "
              f"max |position| diff (first block, whole run) {gaps} m (tolerances "
              f"{WIDTH_BLOCK_TOL}, {WIDTH_TRAJ_TOL}); {time.perf_counter() - t0:.1f} s [{tag}]",
              flush=True)
        if not all(g[0] <= WIDTH_BLOCK_TOL and g[1] <= WIDTH_TRAJ_TOL for g in gaps.values()):
            fail(f"bench_kitti LIO ({fx}): trajectories at two widths differ by {gaps} m")
        out[f"gaps_{fx}"] = gaps
    # voxel_segment_sum at seq-00 density: (b)'s first MAP_GROUP scans in
    # the world frame as one insert group of the sorted store at bench_map's
    # voxel, grid anchored 1 m under the group's min corner
    from slam_sensor_fusion_tpu_torch.ops.voxel_map_sorted import (
        SortedVoxelMapConfig,
        _group_rows,
    )

    seq_b = fixtures["b"]
    pts = np.concatenate([sc @ P[:3, :3].T + P[:3, 3] for sc, P in
                          zip(seq_b.scans[:MAP_GROUP], seq_b.poses[:MAP_GROUP])]).astype(np.float32)
    lo = pts.min(axis=0) - 1.0
    cells = np.ceil((pts.max(axis=0) + 1.0 - lo) / MAP_VOXEL).astype(int)
    gcfg = SortedVoxelMapConfig(voxel_size=MAP_VOXEL, unique_capacity=len(pts),
                                dim_xy=int(cells[:2].max()), dim_z=int(cells[2])).validate()
    *_, payload, seg_c, n_oob = _group_rows(up(pts), torch.ones(len(pts), dtype=torch.bool,
                                                                 device=dev), up(lo), gcfg)
    if int(n_oob):
        fail(f"phase 13 segment-sum group: {int(n_oob)} points off the grid")
    U = min(gcfg.unique_capacity, len(pts))
    c = out["segsum"] = check_segsum(payload, seg_c, U)
    print(f"voxel_segment_sum seq-00 group ({len(pts)} rows of {MAP_GROUP} scans, "
          f"{int(seg_c.max()) + 1} cells, longest run {int(torch.bincount(seg_c.long()).max())}): "
          f"bits equal the plain version; {c['ms']:.4f} ms by events, {c['device_ms']} ms on the "
          f"card alone, plain {c['plain_ms']:.3f} ms, bound {c['bound'][0]:.5f} ms; index_add_ "
          f"{c['lib_ms']:.4f} ms, {c['lib_device_ms']} ms on the card alone [{tag}]", flush=True)
    print(f"phase 13 bench_kitti LIO at wide tiles: {time.perf_counter() - t_phase:.1f} s [{tag}]",
          flush=True)
    return out


def scan_moments(n: int, seed: int, dev) -> torch.Tensor:
    """(n, 10) cell-normal moments of a masked cloud around (-140, 60, -2)
    m, its first rows masked: masked rows at negative coordinates are
    -0.0, as the LIO anchor's are."""
    from slam_sensor_fusion_tpu_torch.ops.point_to_plane import _cell_moments

    rng = np.random.default_rng(seed)
    pts = (rng.normal(0.0, 12.0, (n, 3)) + [-140.0, 60.0, -2.0]).astype(np.float32)
    mask = rng.uniform(size=n) < 0.7
    mask[:5] = False
    return _cell_moments(torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))


def time_scan(x: torch.Tensor) -> dict:
    """cumsum_rows on `x` (N, 10) on the card: ms by CUDA events and on the
    card alone (profiler), its plain version's ms on the card, its bound
    (each element read and written once; one addition an element up and
    one down), and torch.cumsum's ms by events and on the card alone."""
    from slam_sensor_fusion_tpu_torch.ops.ordered_scan import cumsum_rows, cumsum_rows_plain

    out = cumsum_rows(x)
    try:  # the card alone by a CUDA graph's replay (the profiler drops launches)
        g_ms = graph_ms(lambda: cumsum_rows(x), 20)
    except RuntimeError as e:
        print(f"cumsum_rows: no CUDA graph of its cooperative launch ({e})", flush=True)
        g_ms = None
    return dict(
        ms=time_ms(lambda: cumsum_rows(x), 20), graph_ms=g_ms,
        device_ms=device_ms(lambda: cumsum_rows(x), 20, SCAN_KERNELS),
        plain_ms=time_ms(lambda: cumsum_rows_plain(x), 3),
        bound=bound(2 * x.numel(), nbytes(x, out)),
        lib_ms=time_ms(lambda: torch.cumsum(x, dim=0), 20),
        # "" matches every kernel the call launches
        lib_device_ms=device_ms(lambda: torch.cumsum(x, dim=0), 20, ("",)),
    )


def phase14(dev, tag, anchor7, r13) -> dict:
    """The prefix sum of the LIO cell normals in XLA's order on the card:
    bit-equal to its plain version on CPU copies at SCAN_LENGTHS and at
    phase 7's and phase 13 (b)'s anchor moments; estimate_normals_cells
    on the card against the CPU at phase 13 (a)'s first anchor; the
    kernel's times. Returns the numbers for the kernels' record."""
    from slam_sensor_fusion_tpu_torch.ops import point_to_plane as pp
    from slam_sensor_fusion_tpu_torch.ops.ordered_scan import cumsum_rows, cumsum_rows_plain

    t_phase = time.perf_counter()
    st_b, _ = r13["anchor_b"]
    cases = {f"{n} rows": scan_moments(n, n, dev) for n in SCAN_LENGTHS}
    cases["phase 7 anchor"] = pp._cell_moments(*anchor7)
    cases["phase 13 (b) anchor"] = pp._cell_moments(st_b.anchor_points, st_b.anchor_mask)
    err = 0.0
    for what, x in cases.items():
        got = cumsum_rows(x).cpu()
        want = cumsum_rows_plain(x.cpu())
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        n_neg = int(torch.signbit(x).logical_and(x == 0).sum())
        print(f"cumsum_rows, {what} ({x.shape[0]} x {x.shape[1]}, {n_neg} elements -0.0): bits "
              f"equal its plain version on the CPU: {same} [{tag}]", flush=True)
        if not same:
            fail(f"cumsum_rows, {what}: {int((got.view(torch.int32) != want.view(torch.int32)).sum())}"
                 f" of {got.numel()} elements differ from its plain version")
        err = max(err, (got - want).abs().max().item())

    st_a, cfg_a = r13["anchor_a"]
    normals = [pp.estimate_normals_cells(pts, msk, cfg_a.normal_voxel,
                                         max_planarity=cfg_a.normal_planarity)
               for pts, msk in [(st_a.anchor_points, st_a.anchor_mask),
                                (st_a.anchor_points.cpu(), st_a.anchor_mask.cpu())]]
    (n_c, v_c), (n_h, v_h) = [(n.cpu(), v.cpu()) for n, v in normals]
    flips = int((v_c != v_h).sum())
    gap = float((1.0 - (n_c * n_h).sum(-1).abs())[v_h].max()) if bool(v_h.any()) else 0.0
    print(f"estimate_normals_cells at phase 13 (a)'s first anchor ({st_a.anchor_points.shape[0]} "
          f"rows, {int(st_a.anchor_mask.sum())} live, {int(v_h.sum())} valid normals): the card "
          f"against the CPU, valid flags differing {flips}, max unsigned gap {gap:.3e} (tolerance "
          f"{NORMALS_CARD_TOL}) [{tag}]", flush=True)
    if flips or not gap <= NORMALS_CARD_TOL:
        fail(f"estimate_normals_cells on the card: {flips} valid flags differ from the CPU's, "
             f"gap {gap}")

    times = {"anchor": time_scan(cases["phase 7 anchor"]),
             "seq00": time_scan(cases["phase 13 (b) anchor"]),
             "1m": time_scan(cases[f"{SCAN_LENGTHS[-1]} rows"])}
    for what, c in times.items():
        print(f"cumsum_rows ({what}): {c['ms']:.4f} ms by events, {c['device_ms']} ms on the card "
              f"alone (profiler), {c['graph_ms']} ms (a CUDA graph's replay), plain "
              f"{c['plain_ms']:.3f} ms, bound {c['bound'][0]:.5f} ms ({c['bound'][1]}); "
              f"torch.cumsum {c['lib_ms']:.4f} ms, {c['lib_device_ms']} ms on the card alone "
              f"[{tag}]", flush=True)
    print(f"phase 14 ordered scan: {time.perf_counter() - t_phase:.1f} s [{tag}]", flush=True)
    return dict(err=err, normals_gap=gap, times=times,
                rows={k: int(v.shape[0]) for k, v in cases.items()})


def xla_math_inputs(fn: str, n: int, seed: int = 0) -> list[np.ndarray]:
    """Float32 inputs of xla_math's elementwise function `fn`
    (tests/test_torch_cuda.py has the same): seeded angles in [-pi, pi] and
    magnitudes of 1e-8 to 1e6 of either sign ([-1, 1] for acos), random bit
    patterns (subnormals, infinities and NaNs among them), and the special
    values."""
    rng = np.random.default_rng(seed)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-39, -3e-39, 1.17e-38, np.inf, -np.inf,
                        np.nan, 1.0, -1.0, 0.78539816, 120.0, -120.0, 119.99999, 3.4e38,
                        2.0**-12, 2.0**-29, 2.0**25], np.float32)
    q = (n - special.size) // 3
    bits = rng.integers(0, 2**32, q, dtype=np.uint64).astype(np.uint32).view(np.float32)
    if fn == "acos":
        a = rng.uniform(-1.0, 1.0, 2 * q)
    else:
        a = np.concatenate([rng.uniform(-np.pi, np.pi, q),
                            np.sign(rng.normal(size=q)) * 10.0 ** rng.uniform(-8, 6, q)])
    x = np.concatenate([special, a.astype(np.float32), bits])
    x = np.concatenate([x, rng.uniform(-np.pi, np.pi, n - x.size).astype(np.float32)])
    return [x] + [rng.permutation(x) for _ in range({"atan2": 1, "fma": 2}.get(fn, 0))]


def xla_math_bound(fn: str, ins, outs) -> tuple[float, str]:
    """xla_math's least time on the card for an elementwise function: each
    input read and each output written once over the memory rate, or its
    double operations over the float64 peak, whichever is larger."""
    n = ins[0].numel()
    t_ops, t_bytes = n * XM_FLOP[fn] / PEAK_F64_FLOPS, nbytes(*ins, *outs) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of a call of `fn` replayed from one CUDA graph of
    `reps` calls: the card's own time, with no host issue between the
    launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def recorded_launch_ms(fn, reps: int, name: str) -> tuple[float | None, int]:
    """torch.profiler over `reps` calls of `fn` (one launch of the kernel
    `name` each, after a warm-up): (the mean device ms of the launches it
    recorded, how many it recorded). The profiler may record only some of
    the launches (it did on an H100 under CUPTI), and `device_ms`, which
    divides by `reps`, then reads low or None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
    n = sum(e.count for e in hits)
    us = sum(e.self_device_time_total for e in hits)
    return (us / 1e3 / n if n else None), n


def xla_cases(lio_block, anchor, dev) -> dict:
    """xla_math's functions at the shapes the LIO paths give them, on the
    card: name -> (call, inputs, flops, library call or None). The inputs
    come from phase 7's first block (its state, IMU packets, scans and
    timestamps) and phase 14's anchor, through the port's own functions."""
    from slam_sensor_fusion_tpu_torch.models import ekf, lio
    from slam_sensor_fusion_tpu_torch.ops import deskew as dk
    from slam_sensor_fusion_tpu_torch.ops import geometry as geo
    from slam_sensor_fusion_tpu_torch.ops import point_to_plane as tpp
    from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

    state, arrays, tau, cfg = lio_block
    e0 = state.ekf_state
    sp, gy, ac, dts = arrays[0], arrays[2], arrays[3], arrays[4]
    R_blk, t_blk = lio._dead_reckon(e0, gy, ac, dts)  # (R, 3, 3), (R, 3)
    prev_R = torch.cat([e0.R[None], R_blk[:-1]])
    prev_t = torch.cat([e0.p[None], t_blk[:-1]])
    rel = geo.make_T(xm.mm3(prev_R.transpose(-1, -2), R_blk),
                     xm.mv3(prev_R.transpose(-1, -2), t_blk - prev_t))
    xi = dk.se3_log(rel)  # (R, 6): each frame's twist
    rsub = cfg.reg_subsample
    th = (tau[0] - 1.0) * xm.sqrtf(xm.norm2(xi[0, 3:]))
    seg = tpp._cell_segments(anchor[0], anchor[1], cfg.normal_voxel)
    P, cov6 = e0.P, state.anchor_P6 if state.anchor_P6 is not None else e0.P[:6, :6]
    one = torch.ones(1, device=dev)
    w = (gy[0, 0] - e0.bg) * dts[0, 0]
    R = geo.so3_exp(w)
    n_pts = sp.shape[1]
    return {
        "sincos (8192, one frame's deskew angles)": (xm.sincosf, [th], 80, None),
        "atan2 scalar y": (xm.atan2f, [one * 0.25, th], 30, torch.atan2),
        "atan2 scalar x": (xm.atan2f, [th, one * -0.5], 30, torch.atan2),
        "acos (3,)": (xm.acosf, [torch.clamp(t_blk[0] / 20.0, -1.0, 1.0)], 34, torch.acos),
        "fma (6, 6), scalar a (the registration covariance)":
            (xm.fma32, [one * 1.7, cov6.contiguous(), cov6 * 0.01], 2, None),
        "fma (15, 15), scalar b": (xm.fma32, [P, one * 0.01, P.T.contiguous()], 2, None),
        "fma (3,), scalar a and c": (xm.fma32, [one * 0.5, e0.v, one * -0.25], 2, None),
        "fma (3, 3), scalar c": (xm.fma32, [R, prev_R[1], one * 1e-3], 2, None),
        "norm2 (16, 512, 3) (gated_nn's tiles)":
            (xm.norm2, [sp[0].reshape(-1, 512, 3)], 5, lambda p: torch.linalg.vecdot(p, p)),
        "mm (3, 3)": (xm.mm3, [R, prev_R[1]], 45, torch.matmul),
        "mm (16, 3, 3) batched, transposed": (xm.mm3, [prev_R.transpose(-1, -2), R_blk], 45 * 16,
                                              torch.matmul),
        "mv (16, 3, 3) (16, 3)": (xm.mv3, [prev_R.transpose(-1, -2), t_blk - prev_t], 15 * 16,
                                  lambda A, v: torch.matmul(A, v[..., None])),
        "mm_lanes (15, 15) (15, 15)^T": (xm.mm_lanes, [P, P.T], 2 * 15**3, torch.matmul),
        "mm_lanes (15, 6) (6, 6)": (xm.mm_lanes, [P[:, :6].contiguous(), cov6.contiguous()],
                                    2 * 15 * 36, torch.matmul),
        "so3_exp (3,)": (geo.so3_exp, [w], 120, None),
        "so3_exp (16, 10, 3)": (geo.so3_exp, [(gy - e0.bg) * dts[..., None]], 120 * gy[..., 0].numel(),
                                None),
        "so3_log (3, 3)": (geo.so3_log, [R_blk[3]], 60, None),
        "se3_exp (6,)": (geo.se3_exp, [xi[1] * 3.0], 200, None),
        "se3_log (4, 4)": (dk.se3_log, [rel[2]], 200, None),
        "se3_log (16, 4, 4)": (dk.se3_log, [rel], 200 * rel.shape[0], None),
        f"deskew ({n_pts}, one frame)": (dk.deskew, [sp[0], tau[0], xi[0]], 150 * n_pts, None),
        f"deskew ({sp.shape[0]}, {n_pts // rsub}, 3), the prologue's":
            (dk.deskew, [sp[:, ::rsub], tau[:, ::rsub], xi], 150 * sp[:, ::rsub, 0].numel(), None),
        f"cell_normals ({seg.shape[0]}, the anchor's)":
            (tpp._cell_eigen, [seg], 250 * seg.shape[0], None),
        f"propagate ({gy.shape[1]} samples)":
            (lambda *a: ekf.flat_state(ekf.propagate_batch(ekf.unflat_state(a[0]), *a[1:],
                                                           ekf.EKFConfig())),
             [ekf.flat_state(e0), gy[0], ac[0], dts[0]], 4 * 15**3 * gy.shape[1], None),
        f"dead_reckon ({gy.shape[0]} x {gy.shape[1]})":
            (lambda *a: lio._dead_reckon(ekf.unflat_state(a[0]), *a[1:]),
             [ekf.flat_state(e0), gy, ac, dts], 150 * gy[..., 0].numel(), None),
    }


def phase15(dev, tag, launches, launches_by, lio_block, anchor) -> dict:
    """XLA's float32 math on the card (ops/xla_math, csrc/xla_math.cu): each
    elementwise function bit-equal to its plain version on the host over
    XM_INPUTS inputs; every function of the kernel at the shapes the LIO
    paths give it (scalar operands, small matrices, a frame's deskew, the
    anchor's cell normals, an IMU packet, a block's dead reckoning)
    bit-equal to its plain version on the same inputs on the CPU, with its
    ms by events and on the card alone (the profiler, and a CUDA graph's
    replay), its bound, its plain version's ms and a library call's; the
    elementwise functions' times at 8192 and XM_INPUTS values; the
    launches along each LIO path by function; and phase 7's first LIO block
    on the card and on the CPU from one state (the worst pose gap, a
    finding). Returns the kernel's record."""
    from slam_sensor_fusion_tpu_torch.models import lio
    from slam_sensor_fusion_tpu_torch.ops import xla_math as xm
    from slam_sensor_fusion_tpu_torch.parallel.dryrun import _to

    def same_bits(got, want) -> int:
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        n_bad = 0
        for g, w in zip(got, want):
            g, w = g.cpu(), w.cpu()
            if g.shape != w.shape:
                return max(g.numel(), w.numel())
            same = (g.view(torch.int32) == w.view(torch.int32)) | (g.isnan() & w.isnan())
            n_bad += int((~same).sum())
        return n_bad

    t_phase = time.perf_counter()
    out = {"bits_equal": {}, "times": {}, "cases": {}}
    for fn in ("sincos", "atan2", "acos", "fma"):
        host = [torch.from_numpy(a) for a in xla_math_inputs(fn, XM_INPUTS, seed=len(fn))]
        got = xm.xla_math(fn, *[a.to(dev) for a in host])
        got = got if fn == "sincos" else (got,)
        n_bad = 0
        for i in range(0, XM_INPUTS, XM_CHUNK):
            want = xm.xla_math(fn, *[a[i:i + XM_CHUNK] for a in host])
            n_bad += same_bits([g[i:i + XM_CHUNK] for g in got], want)
        out["bits_equal"][fn] = n_bad == 0
        print(f"xla_math {fn}: {XM_INPUTS} inputs (angles, magnitudes to 1e6, random bits, "
              f"+-0, subnormals, +-inf, NaN), {n_bad} differ from the plain version's bits "
              f"[{tag}]", flush=True)
        if n_bad:
            fail(f"xla_math {fn}: {n_bad} of {XM_INPUTS} results differ from the plain version")

    # every function at the LIO paths' shapes, against the CPU's plain run
    for name, (call, ins, flops, lib) in xla_cases(lio_block, anchor, dev).items():
        before = xm.xla_math.launches
        got = call(*ins)
        torch.cuda.synchronize()
        n_launch = xm.xla_math.launches - before
        host = [a.cpu() for a in ins]
        want = call(*host)
        n_bad = same_bits(got, want)
        outs = list(got) if isinstance(got, (tuple, list)) else [got]
        prof = recorded_launch_ms(lambda: call(*ins), 20, XM_KERNEL)
        c = dict(bad=n_bad, launches=n_launch, ms=time_ms(lambda: call(*ins), 20),
                 device_ms=prof[0], recorded=prof[1], graph_ms=graph_ms(lambda: call(*ins), 20),
                 plain_ms=time_ms(lambda: call(*host), 3),
                 bound=bound(flops, nbytes(*ins, *outs)),
                 lib_ms=time_ms(lambda: lib(*ins), 20) if lib is not None else None)
        out["cases"][name] = c
        print(f"xla_math {name}: {n_bad} of {sum(o.numel() for o in outs)} differ from the "
              f"plain version's bits, {n_launch} launch(es); {c['ms']:.4f} ms by events, "
              f"{c['device_ms']} ms on the card alone (profiler, a recorded launch's mean: "
              f"{c['recorded']} of 20 recorded), {c['graph_ms']:.5f} ms (a CUDA graph's replay), bound {c['bound'][0]:.6f} ms ({c['bound'][1]}), plain "
              f"(host) {c['plain_ms']:.3f} ms, library {c['lib_ms']} ms [{tag}]", flush=True)
        if n_bad:
            fail(f"xla_math {name}: {n_bad} results differ from the plain version")
        if n_launch != 1:
            fail(f"xla_math {name}: {n_launch} launches, expected one")

    # the elementwise functions' times at an LIO call's size (one frame's
    # deskew) and at the check's size; the library's on the same tensor
    # give other bits
    for size in (8192, XM_INPUTS):
        for fn in ("sincos", "atan2", "acos", "fma"):
            ins = [torch.from_numpy(a).to(dev) for a in xla_math_inputs(fn, size, seed=7)]
            res = xm.xla_math(fn, *ins)
            outs = list(res) if fn == "sincos" else [res]
            lib = {"sincos": lambda: (torch.sin(ins[0]), torch.cos(ins[0])),
                   "atan2": lambda: torch.atan2(ins[0], ins[1]),
                   "acos": lambda: torch.acos(ins[0]),
                   "fma": lambda: torch.addcmul(ins[2], ins[0], ins[1])}[fn]
            host = [a.cpu() for a in ins]
            run = lambda: xm.xla_math(fn, *ins)  # noqa: E731
            prof = recorded_launch_ms(run, 20, XM_KERNEL)
            c = dict(ms=time_ms(run, 20), device_ms=prof[0], recorded=prof[1],
                     graph_ms=graph_ms(run, 20),
                     plain_ms=time_ms(lambda: xm.xla_math(fn, *[a[:XM_CHUNK] for a in host]), 1)
                     * max(1, size // XM_CHUNK),
                     bound=xla_math_bound(fn, ins, outs), lib_ms=time_ms(lib, 20),
                     lib_device_ms=device_ms(lib, 20, ("",)), lib_graph_ms=graph_ms(lib, 20))
            out["times"][f"{fn} {size}"] = c
            print(f"xla_math {fn} on {size} values: {c['ms']:.4f} ms by events, {c['device_ms']} ms "
                  f"on the card alone (profiler, a recorded launch's mean: {c['recorded']} of 20 "
                  f"recorded), {c['graph_ms']:.5f} ms (a CUDA graph's replay), bound "
                  f"{c['bound'][0]:.6f} ms ({c['bound'][1]}), plain (host) {c['plain_ms']:.3f} ms, "
                  f"torch's {fn} {c['lib_ms']:.4f} ms by events, {c['lib_device_ms']} ms on the "
                  f"card alone (profiler), {c['lib_graph_ms']:.5f} ms (a CUDA graph's replay) "
                  f"[{tag}]", flush=True)

    lio_paths = {p: n for p, n in launches.items() if p.startswith(("lio", "kitti_lio"))}
    print(f"xla_math launches by LIO path: {lio_paths} [{tag}]", flush=True)
    print(f"xla_math launches by path and function: "
          f"{ {p: by for p, by in launches_by.items() if by} } [{tag}]", flush=True)
    idle = [p for p in ("lio_blocks", "lio_session", "lio_chunk", "lio_superblocks",
                        "lio_fleet", "kitti_lio") if not launches.get(p)]
    if idle:
        fail(f"xla_math never launched on the LIO paths {idle}")
    out["launches"] = lio_paths
    out["launches_by"] = launches_by

    # phase 7's first block on the card and on the CPU from one state
    state, arrays, tau, cfg = lio_block
    runs = []
    for d in (dev, torch.device("cpu")):
        _, o = lio.run_lio_superblocks(_to(state, d), *[a.to(d) for a in arrays], cfg,
                                       scan_tau=tau.to(d))
        runs.append(o.world_T_body.cpu())
    gap = float((runs[0] - runs[1]).abs().max())
    out["card_cpu_gap"] = gap
    print(f"phase 7's first LIO block ({tau.shape[0]} frames) on the card and on the CPU from one "
          f"state: worst pose entry gap {gap:.3e} (bound {XM_CARD_CPU_GAP}) [{tag}]", flush=True)
    if not gap < XM_CARD_CPU_GAP:
        fail(f"phase 7's first block: card and CPU part by {gap} >= {XM_CARD_CPU_GAP}")
    print(f"phase 15 XLA's float32 math: {time.perf_counter() - t_phase:.1f} s [{tag}]", flush=True)
    return out


def kernel_launch_count(fn, counter: str) -> int:
    """The kernels one call of `fn` launches, by the kernel library's own
    count (`counter`: `sfk_xla_math_kernel_launches` or
    `sfk_cumsum_kernel_launches`; the profiler drops some launches)."""
    from slam_sensor_fusion_tpu_torch.ops import cuda_lib

    count = getattr(cuda_lib.lib(), counter)
    before = count()
    fn()
    torch.cuda.synchronize()
    return count() - before


def phase17(dev, tag, r14, r15) -> dict:
    """xla_math as a kernel a function and cumsum_rows in one launch, on the
    card: each elementwise function through its three launch paths (16-byte
    accesses, one value a thread, broadcast strides read in place) bit-equal
    to its plain version on XM17_INPUTS seeded values (+-0, subnormals,
    +-inf, NaN among them) in one kernel launch (the library's count); the ordered scan
    in one launch at phase 14's lengths and widths to 60 columns, bits
    equal its plain version; K7's and K4-K6's fixture digests equal the
    ones tests/test_torch_cuda.py pins (their kernels did not move); the
    ptxas lines of the split kernels; a summary of phase 14's and 15's
    times against their bounds and torch's calls."""
    from slam_sensor_fusion_tpu_torch.ops import cuda_lib
    from slam_sensor_fusion_tpu_torch.ops import ordered_scan as os_
    from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

    t_phase = time.perf_counter()
    out = {"paths": {}, "scan_launches": {}}

    def same(got, want) -> int:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        bad = 0
        for g, w in zip(got, want):
            g = g.cpu()
            if g.shape != w.shape:
                return max(g.numel(), w.numel())
            bad += int((~((g.view(torch.int32) == w.view(torch.int32))
                          | (g.isnan() & w.isnan()))).sum())
        return bad

    side = int(np.sqrt(XM17_INPUTS))
    for fn in ("sincos", "atan2", "acos", "fma"):
        host = [torch.from_numpy(a) for a in xla_math_inputs(fn, XM17_INPUTS, seed=17)]
        k = len(host)
        shapes = [(side, 1), (side, side), (side,)][:k]
        cases = {"16-byte": (host, [h.to(dev) for h in host]),
                 "one a thread": ([h[1:] for h in host], [h.to(dev)[1:] for h in host])}
        if k == 1:
            sq = host[0][: side * side].reshape(side, side)
            cases["strided"] = ([sq.T], [sq.to(dev).T])
        else:
            cut = [h[: int(np.prod(sh))].reshape(sh) for h, sh in zip(host, shapes)]
            cases["strided"] = (cut, [c.to(dev) for c in cut])
        for path, (h_ins, d_ins) in cases.items():
            n_launch = kernel_launch_count(lambda: xm.xla_math(fn, *d_ins),
                                           "sfk_xla_math_kernel_launches")
            got = xm.xla_math(fn, *d_ins)
            torch.cuda.synchronize()
            n = got[0].numel() if fn == "sincos" else got.numel()
            bad = 0
            for i in range(0, n, XM_CHUNK):
                sl = [a.reshape(-1)[i:i + XM_CHUNK] if a.shape == h_ins[0].shape and path != "strided"
                      else None for a in h_ins]
                if None in sl:
                    bad = same(got, xm.xla_math(fn, *h_ins))
                    break
                g = tuple(x.reshape(-1)[i:i + XM_CHUNK] for x in got) if fn == "sincos" \
                    else got.reshape(-1)[i:i + XM_CHUNK]
                bad += same(g, xm.xla_math(fn, *sl))
            out["paths"][f"{fn} {path}"] = dict(bad=bad, launches=n_launch, values=n)
            print(f"xla_math {fn}, {path} path: {n} values, {bad} differ from the plain version's "
                  f"bits, {n_launch} launch(es) of its kernel [{tag}]", flush=True)
            if bad or n_launch != 1:
                fail(f"xla_math {fn} {path}: {bad} values differ, {n_launch} launches")

    widths = {(n, 10): n for n in SCAN_LENGTHS}
    widths.update({(300, 1): 300, (1000, 13): 1000, (700, 60): 700, (65536, 10): 65536})
    for (n, C) in widths:
        rng = np.random.default_rng(n + C)
        x = (rng.normal(0.0, 1.0, (n, C)) * 10.0 ** rng.uniform(-3, 6, (n, 1))).astype(np.float32)
        x[rng.uniform(size=n) < 0.1] = -0.0
        xd = torch.from_numpy(x).to(dev)
        n_launch = kernel_launch_count(lambda: os_.cumsum_rows(xd), "sfk_cumsum_kernel_launches")
        bad = same(os_.cumsum_rows(xd), os_.cumsum_rows_plain(torch.from_numpy(x)))
        out["scan_launches"][f"{n}x{C}"] = n_launch
        print(f"cumsum_rows {n} x {C}: {n_launch} launch(es) of "
              f"its kernel, {bad} elements differ from the plain version's bits [{tag}]",
              flush=True)
        if bad or n_launch != 1:
            fail(f"cumsum_rows {n} x {C}: {bad} elements differ, {n_launch} launches")

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_lio_world import K7_DIGEST, P2P_DIGEST, k7_digest, p2p_digest

    pinned = {"K7_DIGEST": K7_DIGEST, "P2P_DIGEST": P2P_DIGEST}
    got = {"K7_DIGEST": k7_digest(dev), "P2P_DIGEST": p2p_digest(dev)}
    for k, v in got.items():
        print(f"{k} on the card: {v} (pinned {pinned[k]}) [{tag}]", flush=True)
        if v != pinned[k]:
            fail(f"{k}: the card's {v} differs from the pinned {pinned[k]}")
    out["digests_equal"] = True

    out["ptxas"] = [ln for ln in ptxas_lines(cuda_lib.build_log)
                    if ln.startswith(("xla_math", "cumsum_rows"))]
    for ln in out["ptxas"]:
        print(f"  ptxas (phase 17): {ln}", flush=True)
    for what, c in r15["times"].items():
        print(f"xla_math {what}: {c['ms']:.4f} ms by events, {c['graph_ms']:.5f} ms on the card "
              f"alone (a CUDA graph's replay), bound {c['bound'][0]:.5f} ms ({c['bound'][1]}), torch "
              f"{c['lib_ms']:.4f} ms by events, {c['lib_graph_ms']:.5f} ms on the card alone [{tag}]",
              flush=True)
    for what, c in r14["times"].items():
        print(f"cumsum_rows ({what}): {c['ms']:.4f} ms by events, {c['device_ms']} ms on the card "
              f"alone (profiler), {c['graph_ms']} ms (a CUDA graph's replay), bound "
              f"{c['bound'][0]:.5f} ms, torch.cumsum {c['lib_ms']:.4f} ms by events, "
              f"{c['lib_device_ms']} ms on the card alone [{tag}]", flush=True)
    print(f"phase 17 split xla_math and one-launch scan: {time.perf_counter() - t_phase:.1f} s "
          f"[{tag}]", flush=True)
    return out


#: phase 18: xla_math's launches along the LIO paths (34 a per-frame
#: step, 7 a block), as the smoke counted them before the CPU's LAPACK
#: (ops/lapack_cpu) came in; it must leave them as they were
XM_LAUNCHES_PINNED = {"lio_blocks": 8720, "lio_session": 5001, "lio_chunk": 1124,
                      "lio_superblocks": 112, "kitti_lio": 112}
#: phase 18: points of the changed xla_math composites' check (deskew, the
#: cell normals)
P18_POINTS = 1 << 18


def lapack_cpu_counter() -> dict:
    """Count the calls into ops/lapack_cpu (scipy's LAPACK for CPU tensors)
    by the device of their first argument; installed before any phase."""
    from slam_sensor_fusion_tpu_torch.ops import lapack_cpu

    calls = {}

    def counted(name, fn):
        def call(a, *rest):
            calls[(name, a.device.type)] = calls.get((name, a.device.type), 0) + 1
            return fn(a, *rest)
        return call

    for name in ("inv", "solve", "eigh"):
        setattr(lapack_cpu, name, counted(name, getattr(lapack_cpu, name)))
    return calls


def digests_pinned() -> dict:
    """K1_DIGEST, K2_DIGEST and K3_DIGEST as tests/test_torch_cuda.py pins
    them (read from its text: it imports pytest)."""
    import re

    with open(os.path.join(REPO, "tests", "test_torch_cuda.py")) as f:
        text = f.read()
    return {k: re.search(rf'^{k} = "([0-9a-f]+)"', text, re.M).group(1)
            for k in ("K1_DIGEST", "K2_DIGEST", "K3_DIGEST")}


def phase18(dev, tag, xm_launches, lapack_calls, r16, w18) -> dict:
    """The CPU's LAPACK from the JAX package's library (ops/lapack_cpu) and
    the LIO parity repairs leave the card as it was: xla_math's launches
    on every LIO path as pinned, no card path calling ops/lapack_cpu (a
    card frame and a voxel-normals block counted), the K1-K3 digests as
    pinned (K4-K7 and P2P in phase 17), the two changed xla_math
    composites (deskew, the cell normals) bit-equal to their plain
    versions on P18_POINTS seeded inputs; prints the host syncs a frame
    that the card's torch.linalg inv, solve and eigh cost, and how often the
    card's eigenvectors agree in sign with the CPU's (jaxlib's)."""
    from slam_sensor_fusion_tpu_torch.models import lio
    from slam_sensor_fusion_tpu_torch.ops import deskew as dk
    from slam_sensor_fusion_tpu_torch.ops import point_to_plane as pp
    from slam_sensor_fusion_tpu_torch.ops import xla_math as xm

    t_phase = time.perf_counter()
    out = {}
    # (a) xla_math's launches by LIO path, as pinned
    got = {p: xm_launches.get(p, 0) for p in XM_LAUNCHES_PINNED}
    print(f"phase 18 xla_math launches by LIO path {got} (pinned {XM_LAUNCHES_PINNED}): "
          f"{got['lio_blocks'] / 256:.2f} a per-frame step, {got['lio_superblocks'] / 16:.2f} a "
          f"block [{tag}]", flush=True)
    if got != XM_LAUNCHES_PINNED:
        fail(f"phase 18: xla_math launches {got} differ from the pinned {XM_LAUNCHES_PINNED}")
    out["xla_math_launches"] = got

    # (b) no card path reaches ops/lapack_cpu
    on_card = {k: v for k, v in lapack_calls.items() if k[1] != "cpu"}
    lapack_calls.clear()
    st, arrays, tau, cfg, vcfg = w18["state"], w18["arrays"], w18["tau"], w18["lcfg"], w18["vcfg"]
    lio.lio_step(st, *[a[0] for a in arrays], cfg, tau[0])
    lio.run_lio_blocks(st, *[a[:vcfg.refresh_every] for a in arrays], vcfg,
                       scan_tau=tau[:vcfg.refresh_every])
    torch.cuda.synchronize()
    print(f"phase 18 ops/lapack_cpu calls with a card tensor over the run {on_card}; in a card "
          f"frame (lio_step) and a voxel-normals block (run_lio_blocks): "
          f"{dict(lapack_calls)} [{tag}]", flush=True)
    if on_card or lapack_calls:
        fail(f"phase 18: a card path called ops/lapack_cpu: {on_card or dict(lapack_calls)}")

    # (c) the host syncs of the card's torch.linalg calls
    g = torch.Generator(device="cpu").manual_seed(18)
    a6 = torch.randn(6, 6, generator=g)
    s6 = (a6 @ a6.T + torch.eye(6)).to(dev)
    s3 = s6[:3, :3].contiguous()
    b6 = torch.randn(6, generator=g).to(dev)
    cov = (s3[None] * torch.rand(4096, 1, 1, generator=g).to(dev)).contiguous()
    syncs = {"inv 6x6": sync_count(lambda: torch.linalg.inv(s6)),
             "inv 3x3": sync_count(lambda: torch.linalg.inv(s3)),
             "solve 6x6": sync_count(lambda: torch.linalg.solve(s6, b6)),
             "eigh 4096 x 3x3": sync_count(lambda: pp._eigh(cov))}
    # a per-frame step on K4: the GN covariance's inverse and the two
    # Kalman updates'; the multi-launch GN adds a solve an iteration; a
    # voxel refresh one eigh a part
    frame_k4 = 2 * syncs["inv 6x6"] + syncs["inv 3x3"]
    frame_gn = frame_k4 + vcfg.p2p.num_iterations * syncs["solve 6x6"]
    frame_sync = sync_count(lambda: lio.lio_step(st, *[a[0] for a in arrays], cfg, tau[0]))
    print(f"phase 18 host syncs of torch.linalg on the card: {syncs}; a per-frame step "
          f"(K4) {frame_k4} of its {frame_sync} syncs, the multi-launch GN ("
          f"{vcfg.p2p.num_iterations} iterations) {frame_gn}, plus {syncs['eigh 4096 x 3x3']} "
          f"an eigh part at a voxel refresh [{tag}]", flush=True)
    out["linalg_syncs"] = dict(syncs, frame_k4=frame_k4, frame_gn=frame_gn, frame_all=frame_sync)

    # (d) K1-K3's digests as pinned
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_world import k1_digest, k2_digest, k3_digest

    pinned = digests_pinned()
    got = {"K1_DIGEST": k1_digest(dev), "K2_DIGEST": k2_digest(dev), "K3_DIGEST": k3_digest(dev)}
    for k, v in got.items():
        print(f"{k} on the card: {v} (pinned {pinned[k]}) [{tag}]", flush=True)
        if v != pinned[k]:
            fail(f"{k}: the card's {v} differs from the pinned {pinned[k]}")
    out["digests_equal"] = True

    # (e) the changed composites on the card against their plain versions
    rng = np.random.default_rng(18)
    n = P18_POINTS
    pts = rng.uniform(-60.0, 60.0, (n, 3)).astype(np.float32)
    taus = rng.uniform(0.0, 1.0, n).astype(np.float32)
    taus[:64] = 1.0
    bad = {}
    for name, xi in (("turning", [0.3, -0.2, 0.05, 0.04, -0.02, 0.3]),
                     ("slow turn", [1.5, 0.1, -0.02, 1e-4, -3e-4, 2e-3]),
                     ("straight", [0.1, 0.05, -0.02, 0.0, 0.0, 0.0])):
        x = np.asarray(xi, np.float32)
        host = [torch.from_numpy(a) for a in (pts, taus, x)]
        got_d = dk.deskew(*[h.to(dev) for h in host]).cpu()
        bad[f"deskew {name}"] = int((got_d.view(torch.int32) != dk.deskew(*host).view(torch.int32)).sum())
    seg = np.zeros((n, 10), np.float32)
    cnt = rng.integers(0, 40, n).astype(np.float32)
    centre = rng.uniform(-150.0, 150.0, (n, 3)).astype(np.float32)
    spread = (rng.uniform(0.0, 0.5, (n, 3)) * (rng.uniform(size=(n, 1)) < 0.9)).astype(np.float32)
    seg[:, 0] = cnt
    seg[:, 1:4] = centre * cnt[:, None]
    m2 = centre[:, :, None] * centre[:, None, :] + np.eye(3, dtype=np.float32) * spread[:, :, None] ** 2
    seg[:, 4:7] = np.stack([m2[:, 0, 0], m2[:, 1, 1], m2[:, 2, 2]], 1) * cnt[:, None]
    seg[:, 7:10] = np.stack([m2[:, 0, 1], m2[:, 0, 2], m2[:, 1, 2]], 1) * cnt[:, None]
    seg[rng.uniform(size=n) < 0.02] = 0.0
    hs = torch.from_numpy(seg)
    want = pp._cell_eigen(hs)
    got_c = pp._cell_eigen(hs.to(dev))
    bad["cell_normals"] = sum(int((a.cpu().view(torch.int32) != b.view(torch.int32)).sum())
                              for a, b in zip(got_c, want))
    print(f"phase 18 xla_math's changed composites on {n} seeded inputs, elements differing from "
          f"the plain version's bits: {bad} [{tag}]", flush=True)
    if any(bad.values()):
        fail(f"phase 18: a changed xla_math composite parts from its plain version: {bad}")
    out["composites_bad"] = bad

    # (f) the card's eigen-solve against the CPU's (jaxlib's) in sign
    signs = {k: (v["same_sign"], v["valid"]) for k, v in r16["normals"].items()}
    agree = sum(a for a, _ in signs.values())
    total = sum(b for _, b in signs.values())
    print(f"phase 18 the card's normals (cuSOLVER's eigh; the tiled and voxel estimators) in "
          f"the same sign as the CPU's (jaxlib's ssyevd): {agree} of {total} valid points; by "
          f"case {signs} [{tag}]", flush=True)
    out["same_sign"] = (agree, total)
    print(f"phase 18 LAPACK and parity: {time.perf_counter() - t_phase:.1f} s [{tag}]", flush=True)
    return out


def sync_count(fn) -> int:
    """The host synchronisations `fn` makes, counted by torch's sync debug
    mode's warnings."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def hold_normals(what, got, want, tag) -> dict:
    """The card's normals (n, valid) against the CPU's: valid flags equal,
    1 - |n . n'| within NORMALS_CARD_TOL on every valid point."""
    (n_k, v_k), (n_h, v_h) = (x.cpu() for x in got), want
    flips = int((v_k != v_h).sum())
    dot = (n_k * n_h).sum(-1)
    gap = (1.0 - dot.abs())[v_h]
    r = dict(flips=flips, valid=int(v_h.sum()), gap=float(gap.max()) if gap.numel() else 0.0,
             same_sign=int((dot > 0)[v_h].sum()))
    print(f"{what}: the card against the CPU, valid flags differing {flips} of {r['valid']} "
          f"valid; 1 - |n.n'| max {r['gap']:.3e} (bound {NORMALS_CARD_TOL}); the same sign on "
          f"{r['same_sign']} of the valid [{tag}]", flush=True)
    if flips or not r["gap"] < NORMALS_CARD_TOL:
        fail(f"{what}: the card's normals part from the CPU's: {r}")
    return r


def check_voxel_cells(pts, msk, voxel, what, tag) -> dict:
    """(a) `estimate_normals` at `voxel` on the card twice and on the CPU:
    the sort, cell ids and the cells' moments bit for bit, then the
    normals (`hold_normals`)."""
    from slam_sensor_fusion_tpu_torch.ops import point_to_plane as pp

    card = [pp._voxel_moments(pts, msk, voxel) for _ in range(2)]
    host = pp._voxel_moments(pts.cpu(), msk.cpu(), voxel)
    for k, name in enumerate(("order", "cell ids", "sorted mask")):
        if not (torch.equal(card[0][k], card[1][k]) and torch.equal(card[0][k].cpu(), host[k])):
            fail(f"voxel normals, {what}: the {name} differ between runs or from the CPU")
    moments = {}
    for m0, m1, mh, name in zip(card[0][3], card[1][3], host[3], ("sums", "counts", "products")):
        b0, b1, bh = (m.cpu().contiguous().view(torch.int32) for m in (m0, m1, mh))
        moments[name] = (int((b0 != b1).sum()), int((b0 != bh).sum()), bh.numel())
    print(f"voxel moments, {what}, {voxel} m cells ({int(host[2].sum())} live rows, "
          f"{int(host[1][host[2]].max()) + 1 if bool(host[2].any()) else 0} cells): elements "
          f"differing (card run 2, the CPU) of all: {moments} [{tag}]", flush=True)
    if any(a or b for a, b, _ in moments.values()):
        fail(f"voxel moments, {what}: the card's are not the same bits on two runs and as the CPU's")
    return hold_normals(f"voxel normals, {what}, {voxel} m cells",
                        pp.estimate_normals(pts, msk, voxel),
                        pp.estimate_normals(pts.cpu(), msk.cpu(), voxel), tag)


def check_tiled(pts, msk, chunk, what, tag) -> dict:
    """`estimate_normals_tiled` on the card against the CPU (`hold_normals`)."""
    from slam_sensor_fusion_tpu_torch.ops import point_to_plane as pp

    return hold_normals(f"tiled normals, {what}, chunks of {chunk}",
                        pp.estimate_normals_tiled(pts, msk, chunk),
                        pp.estimate_normals_tiled(pts.cpu(), msk.cpu(), chunk), tag)


def voxel_segsum_args(pts, msk, voxel) -> tuple:
    """The (values, ids, n_out) that `estimate_normals`' moments hand the
    segment sum, caught on their way in (one launch)."""
    from slam_sensor_fusion_tpu_torch.ops import point_to_plane as pp

    seen, real = [], pp.segment_sum_sorted

    def catch(values, seg, n_out):
        seen.append((values, seg, n_out))
        return real(values, seg, n_out)

    pp.segment_sum_sorted = catch
    try:
        pp._voxel_moments(pts, msk, voxel)
    finally:
        pp.segment_sum_sorted = real
    return seen[0]


def k2_lio_inputs(scan, mask, anchor, prior, p2p_cfg):
    """K2's inputs as `point_to_plane_align`'s "pallas" branch builds them
    for one frame at its prior (the pair list of n_source_tiles * 8 slots
    against the anchor's pages), and the frame's pair demand (the admitted
    tile pairs, at most `max_visits` a source tile, before the list
    truncates them to its slots, as the JAX package's list does)."""
    from slam_sensor_fusion_tpu_torch.ops import point_to_plane as pp
    from slam_sensor_fusion_tpu_torch.ops.geometry import transform_points
    from slam_sensor_fusion_tpu_torch.ops.morton import tile_bboxes
    from slam_sensor_fusion_tpu_torch.ops.nn_gated import pair_tiles
    from slam_sensor_fusion_tpu_torch.ops.nn_pallas import make_pages

    pairs, tgt_pages = pp._k2_lists(scan, mask, *anchor, prior, p2p_cfg)
    pts0 = transform_points(prior, scan)
    src_pages = make_pages(pts0, mask, prior[:3, 3], p2p_cfg.tile_src)
    search_r2 = (math.sqrt(p2p_cfg.max_correspondence_dist_sq) + p2p_cfg.reassoc_margin) ** 2
    lo_s, hi_s, cnt_s = tile_bboxes(pts0, mask, p2p_cfg.tile_src)
    lo_t, hi_t, _ = tile_bboxes(*anchor, p2p_cfg.tile_tgt)
    _, counts, _ = pair_tiles(lo_s, hi_s, cnt_s, lo_t, hi_t, search_r2, p2p_cfg.max_visits)
    return (src_pages, tgt_pages, *pairs), int(counts.sum())


def phase16(dev, tag, name, kernels, record, w6) -> dict:
    """The LIO's default configuration on the card: LIOConfig()'s voxel
    normals and its "pallas" registration (K2 on a pair list, every GN
    iteration), the dense sweep ("xla") and the tiled normals, on phase 6's
    world; LIOSession on LIOConfig()'s own registration and normals at
    phase 6's scan capacity; run_lio_superblocks (K7) with voxel normals;
    the 2-robot fleet on LIOConfig() itself. Returns the numbers for the
    kernels' record."""
    from slam_sensor_fusion_tpu_torch.models import lio
    from slam_sensor_fusion_tpu_torch.models.lio import LIOConfig
    from slam_sensor_fusion_tpu_torch.models.session import LIOSession
    from slam_sensor_fusion_tpu_torch.ops import point_to_plane as pp
    from slam_sensor_fusion_tpu_torch.ops.lio_superblock_fused import lio_superblock
    from slam_sensor_fusion_tpu_torch.ops.nn import nearest_neighbor
    from slam_sensor_fusion_tpu_torch.ops.nn_pallas import pair_nn, pair_nn_plain
    from slam_sensor_fusion_tpu_torch.ops.voxel_segsum import segment_sum_sorted
    from slam_sensor_fusion_tpu_torch.parallel import lio_fleet
    from slam_sensor_fusion_tpu_torch.parallel.mesh import tree_index, tree_map

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        fail("phase 16: TF32 is on; the dense sweep must run in float32")
    lcfg, sp, sm, poses, v0 = w6["lcfg"], w6["sp"], w6["sm"], w6["poses"], w6["v0"]
    arrays, tau, gt = w6["arrays"], w6["tau"], w6["gt"]
    st7 = w6["state7"]
    pts7, msk7 = st7.anchor_points, st7.anchor_mask
    # the configurations: phase 6's with voxel normals on each back end,
    # and LIOConfig()'s own
    p_cfg = lcfg._replace(normal_est="voxel", p2p=lcfg.p2p._replace(nn_backend="pallas"))
    x_cfg = p_cfg._replace(p2p=p_cfg.p2p._replace(nn_backend="xla"))
    t_cfg = p_cfg._replace(normal_est="tiled")
    d_cfg = LIOConfig()
    s_cfg = d_cfg._replace(scan_capacity=lcfg.scan_capacity)
    b_cfg = lcfg._replace(normal_est="voxel")
    print(f"phase 16 configurations: registration {p_cfg.p2p.nn_backend} / "
          f"{x_cfg.p2p.nn_backend} at {p_cfg.p2p.tile_src} x {p_cfg.p2p.tile_tgt} tiles, "
          f"{p_cfg.p2p.num_iterations} GN iterations, voxel normals at {p_cfg.normal_voxel} m; "
          f"LIOConfig(): {d_cfg.p2p.nn_backend} at {d_cfg.p2p.tile_src} x {d_cfg.p2p.tile_tgt}, "
          f"{d_cfg.p2p.num_iterations} iterations, {d_cfg.normal_est} normals at "
          f"{d_cfg.normal_voxel} m, refresh every {d_cfg.refresh_every}, scans of "
          f"{d_cfg.scan_capacity}; TF32 off [{tag}]", flush=True)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def init(cfg):
        st = lio.init_state(cfg, up(sp[0]), up(sm[0]), up(poses[0]))
        return st._replace(ekf_state=st.ekf_state._replace(v=up(v0)))

    def frames(n, device=dev):
        return [a[:n].to(device) for a in arrays], tau[:n].to(device)

    def hold_ate(what, est, n_corr, n):
        if not (np.isfinite(est).all() and (n_corr > 0).all()):
            fail(f"{what}: non-finite pose or a frame without correspondences")
        ate = ate_rmse(est, gt[:n])
        if not ate < LIO_ATE_LIMIT:
            fail(f"{what}: ATE-RMSE {ate} >= {LIO_ATE_LIMIT}")
        return ate

    out = {"runs": {}}
    # ---- (a) the voxel moments and normals at phase 7's anchor and moved
    # by ~40 m and ~140 m: bit-equal to the CPU's and from run to run ----
    normals = {}
    for where, shift in P16_SHIFTS.items():
        pts = pts7 + torch.tensor(shift, dtype=torch.float32, device=dev)
        for voxel in (p_cfg.normal_voxel, d_cfg.normal_voxel):
            normals[f"voxel {voxel} {where}"] = check_voxel_cells(pts, msk7, voxel, where, tag)
        normals[f"tiled {where}"] = check_tiled(pts, msk7, t_cfg.normal_chunk, where, tag)
    out["normals"] = normals

    # ---- a refresh's parts on phase 7's ring: the segment sum (against its
    # plain version and index_add_), the eigen-solve, the host syncs ----
    N7 = pts7.shape[0]
    vals, ids, n_ids = voxel_segsum_args(pts7, msk7, p_cfg.normal_voxel)
    seg_case = check_segsum(vals, ids, n_ids)
    sums, cnts, sq = pp._voxel_moments(pts7, msk7, p_cfg.normal_voxel)[3]
    c = torch.clamp(cnts, min=1.0)
    mean = sums / c[:, None]
    cov = (sq / c[:, None, None] - mean[:, :, None] * mean[:, None, :]
           + 1e-9 * torch.eye(3, device=dev)[None])
    eigh_ms = time_ms(lambda: pp._eigh(cov), 5)
    eigh_dev = device_ms(lambda: pp._eigh(cov), 5, ("",))
    ring = (st7.ring, st7.ring_mask, st7.ekf_state.p)
    refresh = {k: time_ms(lambda c=c_: lio._refresh_anchor(*ring, c), 3)
               for k, c_ in (("voxel", p_cfg), ("tiled", t_cfg), ("cells", lcfg))}
    syncs = {k: sync_count(lambda c=c_: lio._refresh_anchor(*ring, c))
             for k, c_ in (("voxel", p_cfg), ("tiled", t_cfg), ("cells", lcfg))}
    syncs["eigh"] = sync_count(lambda: pp._eigh(cov))
    # the voxel refresh's parts, each counted on two calls in a row (a
    # first-call sync reads on the first only)
    anchor = lio.sort_by_morton(lio.cl.Cloud(st7.ring, st7.ring_mask), isotropic=False)
    a_pts, a_msk, v = anchor.points, anchor.mask, p_cfg.normal_voxel
    a_nrm, a_nvl = pp.estimate_normals(a_pts, a_msk, v)
    asub = p_cfg.anchor_subsample
    parts = {
        "sort": lambda: lio.sort_by_morton(lio.cl.Cloud(st7.ring, st7.ring_mask), isotropic=False),
        "moments": lambda: pp._voxel_moments(a_pts, a_msk, v),
        "eigh": lambda: pp._eigh(cov),
        "estimate_normals": lambda: pp.estimate_normals(a_pts, a_msk, v),
        "pages": lambda: lio.build_cached_p2p_target(
            a_pts[::asub], a_msk[::asub], a_nrm[::asub], a_nvl[::asub], ring[2],
            p_cfg.p2p.tile_tgt, gate_sub=p_cfg.gate_sub_tgt),
        "refresh": lambda: lio._refresh_anchor(*ring, p_cfg),
    }
    syncs["voxel parts"] = {k: [sync_count(f), sync_count(f)] for k, f in parts.items()}
    print(f"voxel normals' refresh on phase 7's ring ({N7} rows): segment sum of "
          f"{vals.shape[0]} rows x 4 into {4 * (N7 + 1)} ids {seg_case['ms']:.4f} ms by events, "
          f"{seg_case['device_ms']} ms on the card alone, bound {seg_case['bound'][0]:.5f} ms "
          f"({seg_case['bound'][1]}), plain {seg_case['plain_ms']:.2f} ms, index_add_ "
          f"{seg_case['lib_ms']:.4f} ms ({seg_case['lib_device_ms']} on the card; "
          f"{seg_case['lib_diff']} elements differ); eigh of {cov.shape[0]} 3 x 3 "
          f"{eigh_ms:.3f} ms by events, {eigh_dev} ms of device time; the whole refresh "
          f"{', '.join(f'{k} {v:.3f} ms' for k, v in refresh.items())}; host syncs a refresh "
          f"{syncs} [{tag}]", flush=True)
    out.update(segsum=seg_case, eigh_ms=eigh_ms, eigh_device_ms=eigh_dev, refresh_ms=refresh,
               syncs=syncs)

    # ---- (b) K2 against its plain version at the LIO's shapes: a steady
    # frame (phase 6's frame 33 at its prior, against phase 7's anchor) ----
    k2 = {}
    for p2p_cfg in (p_cfg.p2p, s_cfg.p2p):
        label = f"{p2p_cfg.tile_src}x{p2p_cfg.tile_tgt}"
        k2_in, demand = k2_lio_inputs(w6["scan"], w6["mask"], (pts7, msk7), w6["prior"], p2p_cfg)
        err = check_k2(k2_in, name)
        TM, TN = k2_in[0].shape[-1], k2_in[1].shape[-1]
        k2[label] = dict(
            err=err, demand=demand, slots=int(k2_in[4].shape[0]),
            pairs=int(k2_in[3].sum()),
            ms=time_ms(lambda: pair_nn(*k2_in), 20),
            device_ms=device_ms(lambda: pair_nn(*k2_in), 20, K2_KERNELS),
            plain_ms=time_ms(lambda: pair_nn_plain(*k2_in), 2),
            bound=bound(int(k2_in[3].sum()) * TM * TN * FLOP_PER_DISTANCE,
                        nbytes(*k2_in) + nbytes(*pair_nn(*k2_in))))
        c2 = k2[label]
        print(f"K2 at the LIO's {label} tiles (src {tuple(k2_in[0].shape)}, tgt "
              f"{tuple(k2_in[1].shape)}): {c2['ms']:.4f} ms a call by events, "
              f"{c2['device_ms']} ms on the card alone, plain {c2['plain_ms']:.3f} ms, bound "
              f"{c2['bound'][0]:.4f} ms ({c2['bound'][1]}); pair demand {demand}, in the list "
              f"{c2['pairs']} of {c2['slots']} slots [{tag}]", flush=True)
    out["k2"] = k2

    # ---- the per-frame loop on K2 ("pallas") and on the dense sweep
    # ("xla"), voxel normals, two passes each ----
    for label, cfg in (("pallas", p_cfg), ("xla", x_cfg)):
        n = P16_FRAMES - 1
        st0 = init(cfg)
        args, tau_n = frames(n)
        zero_counts(*kernels)
        rates = []
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, o = lio.run_lio_blocks(st0, *args, cfg, scan_tau=tau_n)
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t1))
        record(f"p16_blocks_{label}")
        est, n_corr = o.world_T_body.cpu().numpy(), o.n_correspondences.cpu().numpy()
        ate = hold_ate(f"run_lio_blocks, {label}, voxel normals", est, n_corr, n)
        k2_n, seg_n = pair_nn.launches, segment_sum_sorted.launches
        want_k2 = 2 * n * (cfg.p2p.num_iterations + 1) if label == "pallas" else 0
        if k2_n != want_k2 or not seg_n:
            fail(f"run_lio_blocks, {label}: K2 launched {k2_n} times (expected {want_k2}), the "
                 f"segment sum {seg_n} times")
        out["runs"][f"blocks_{label}"] = dict(ate=ate, scans_s=rates, k2=k2_n, segsum=seg_n)
        print(f"run_lio_blocks, {label}, voxel normals: {n} frames twice, {rates[1]:.1f} scans/s "
              f"(second pass; first {rates[0]:.1f}), ATE-RMSE {ate:.4f} m, n_corr mean "
              f"{n_corr.mean():.0f}, launches K2 {k2_n}, segment sum {seg_n} [{tag}]", flush=True)

        # (c) the first block on the card against the port on the CPU, from
        # one state; the dense sweep at frame 0: the winners that part
        nb = lcfg.refresh_every if label == "pallas" else 1
        args_b, tau_b = frames(nb)
        args_h, tau_h = frames(nb, cpu)
        _, ok = lio.run_lio_blocks(st0, *args_b, cfg, scan_tau=tau_b)
        st0_h = tree_map(lambda x: x.cpu(), st0)
        _, oh = lio.run_lio_blocks(st0_h, *args_h, cfg, scan_tau=tau_h)
        gap = (ok.world_T_body.cpu() - oh.world_T_body).abs().amax(dim=(1, 2))
        nk, nh = ok.n_correspondences.cpu(), oh.n_correspondences
        c_res = dict(frames=nb, gap=float(gap.max()), n_corr_card=nk.tolist(),
                     n_corr_cpu=nh.tolist())
        if label == "xla":
            _, prior, scan = lio._prior_and_scan(st0, args_b[0][0], args_b[2][0], args_b[3][0],
                                                 args_b[4][0], cfg, tau_b[0])
            _, prior_h, scan_h = lio._prior_and_scan(st0_h, args_h[0][0], args_h[2][0],
                                                     args_h[3][0], args_h[4][0], cfg, tau_h[0])
            d2k, ik = nearest_neighbor(scan, args_b[1][0], st0.anchor_points, st0.anchor_mask,
                                       prior[:3, 3])
            d2h, ih = nearest_neighbor(scan_h, args_h[1][0], st0_h.anchor_points,
                                       st0_h.anchor_mask, prior_h[:3, 3])
            live = args_h[1][0]
            moved = (ik.cpu() != ih) & live
            c_res.update(winners_changed=int(moved.sum()), rows=int(live.sum()),
                         d2_gap_changed=float((d2k.cpu() - d2h)[moved].abs().max())
                         if bool(moved.any()) else 0.0,
                         d2_gap=float((d2k.cpu() - d2h)[live].abs().max()))
        out["runs"][f"blocks_{label}"]["card_cpu"] = c_res
        print(f"run_lio_blocks, {label}: the first {nb} frame(s) on the card against the CPU "
              f"from one state: max |pose| gap {c_res['gap']:.3e} m, n_corr card {nk.tolist()} "
              f"CPU {nh.tolist()}"
              + (f"; the dense sweep at frame 0's prior: {c_res['winners_changed']} of "
                 f"{c_res['rows']} rows' winners changed (their d2 gap max "
                 f"{c_res['d2_gap_changed']:.3e}), d2 gap max {c_res['d2_gap']:.3e}"
                 if label == "xla" else "") + f" [{tag}]", flush=True)
        if label == "pallas" and (not c_res["gap"] <= P16_CARD_CPU_TOL or int(nk[0]) != int(nh[0])):
            fail(f"run_lio_blocks, pallas: the card's first block parts from the CPU's: {c_res}")

        if label == "pallas":
            # one block under the profiler: K2 a frame, device operations, idle
            busy, wall, on_dev = profiled_pass(
                lambda: lio.run_lio_blocks(st0, *args_b, cfg, scan_tau=tau_b))
            k2_dev = sum(e.self_device_time_total for e in on_dev
                         if any(k in e.key for k in K2_KERNELS)) / 1e3
            n_ops = sum(e.count for e in on_dev)
            prof = dict(busy_ms=busy, wall_ms=wall, idle=idle_share(busy, wall),
                        k2_ms_a_frame=k2_dev / nb, ops_a_frame=n_ops / nb)
            out["runs"]["blocks_pallas"]["profile"] = prof
            print(f"run_lio_blocks, pallas, one block of {nb} frames under the profiler: device "
                  f"busy {busy / nb:.3f} ms a frame of the block's own {wall / nb:.3f} ms (idle "
                  f"{prof['idle']}), K2 {prof['k2_ms_a_frame']:.4f} ms a frame, "
                  f"{prof['ops_a_frame']:.0f} device operations a frame [{tag}]", flush=True)

    # ---- the tiled normals on K2 ----
    n = P16_SHORT_FRAMES - 1
    st0 = init(t_cfg)
    args, tau_n = frames(n)
    zero_counts(*kernels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, o = lio.run_lio_blocks(st0, *args, t_cfg, scan_tau=tau_n)
    torch.cuda.synchronize()
    rate = n / (time.perf_counter() - t1)
    record("p16_blocks_tiled")
    ate = hold_ate("run_lio_blocks, pallas, tiled normals", o.world_T_body.cpu().numpy(),
                   o.n_correspondences.cpu().numpy(), n)
    if pair_nn.launches != n * (t_cfg.p2p.num_iterations + 1):
        fail(f"run_lio_blocks, tiled normals: K2 launched {pair_nn.launches} times")
    out["runs"]["blocks_tiled"] = dict(ate=ate, scans_s=[rate], k2=pair_nn.launches)
    print(f"run_lio_blocks, pallas, tiled normals: {n} frames, {rate:.1f} scans/s (one pass), "
          f"ATE-RMSE {ate:.4f} m, K2 launches {pair_nn.launches} [{tag}]", flush=True)

    # ---- LIOSession on LIOConfig()'s registration and normals ----
    n = P16_SHORT_FRAMES
    zero_counts(*kernels)
    sess = LIOSession(s_cfg, sp[0], sm[0], poses[0], device=dev)
    sess.state = sess.state._replace(ekf_state=sess.state.ekf_state._replace(v=up(v0)))
    lat, est, n_corr = [], [], []
    for k in range(n):
        t1 = time.perf_counter()
        gy, ac, dt_k, gps, gvar = (a[k] for a in w6["imu_gps"])
        r = sess.push(sp[k + 1], sm[k + 1], gy, ac, dt_k, gps, float(gvar), True,
                      tau=w6["taus"][k + 1])
        lat.append(time.perf_counter() - t1)
        est.append(r.world_T_body)
        n_corr.append(r.n_correspondences)
    record("p16_session")
    ate = hold_ate("LIOSession, LIOConfig()'s registration and normals", np.stack(est),
                   np.asarray(n_corr), n)
    want_k2 = n * (s_cfg.p2p.num_iterations + 1)
    if pair_nn.launches != want_k2 or not segment_sum_sorted.launches:
        fail(f"LIOSession: K2 launched {pair_nn.launches} times (expected {want_k2}), the "
             f"segment sum {segment_sum_sorted.launches} times")
    warm = min(8, n // 2)  # pushes before the timed ones
    out["runs"]["session"] = dict(ate=ate, p50_ms=percentile_ms(lat[warm:], 50),
                                  p99_ms=percentile_ms(lat[warm:], 99), k2=pair_nn.launches,
                                  segsum=segment_sum_sorted.launches)
    print(f"LIOSession, LIOConfig()'s registration and normals at scans of {s_cfg.scan_capacity}: "
          f"{n} pushes, ATE-RMSE {ate:.4f} m, push p50 {out['runs']['session']['p50_ms']:.3f} ms "
          f"p99 {out['runs']['session']['p99_ms']:.3f} ms over {n - warm}, launches K2 "
          f"{pair_nn.launches}, segment sum {segment_sum_sorted.launches} [{tag}]", flush=True)

    # ---- the block loop (K7) with voxel normals, two passes ----
    n = P16_FRAMES - 1
    st0 = init(b_cfg)
    args, tau_n = frames(n)
    n_blk = -(-n // b_cfg.refresh_every)
    zero_counts(*kernels)
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, o = lio.run_lio_superblocks(st0, *args, b_cfg, scan_tau=tau_n)
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t1))
    record("p16_superblocks")
    ate = hold_ate("run_lio_superblocks, voxel normals", o.world_T_body.cpu().numpy(),
                   o.n_correspondences.cpu().numpy(), n)
    n_ovf = int(o.pair_overflow.sum())
    if n_ovf or lio_superblock.launches != 2 * n_blk or not segment_sum_sorted.launches:
        fail(f"run_lio_superblocks, voxel normals: pair overflow on {n_ovf} frames, K7 launched "
             f"{lio_superblock.launches} times for {2 * n_blk} blocks, the segment sum "
             f"{segment_sum_sorted.launches} times")
    out["runs"]["superblocks"] = dict(ate=ate, scans_s=rates, k7=lio_superblock.launches,
                                      segsum=segment_sum_sorted.launches, overflow=n_ovf)
    print(f"run_lio_superblocks, voxel normals: {n} frames twice, {rates[1]:.1f} scans/s (second "
          f"pass; first {rates[0]:.1f}), ATE-RMSE {ate:.4f} m, pair overflow 0, launches K7 "
          f"{lio_superblock.launches}, segment sum {segment_sum_sorted.launches} [{tag}]",
          flush=True)

    # ---- the 2-robot fleet on LIOConfig() itself (the dense sweep, as the
    # JAX package's vmapped fleet runs it; scans padded to its capacity;
    # the second robot with GPS every other frame), each robot against its
    # own run ----
    n = P16_SHORT_FRAMES
    S = d_cfg.scan_capacity
    pad = S - lcfg.scan_capacity

    def padded(a, fill):  # (n, scan, ...) -> (n, S, ...)
        tail = torch.full((a.shape[0], pad, *a.shape[2:]), fill, dtype=a.dtype, device=a.device)
        return torch.cat([a, tail], dim=1)

    base = [a[:n] for a in arrays]
    base[0], base[1] = padded(base[0], 0.0), padded(base[1], False)
    robots = [base, base[:7] + [base[7] & (torch.arange(n, device=dev) % 2 == 0)]]
    first_sp = np.zeros((S, 3), np.float32)
    first_sp[: lcfg.scan_capacity] = sp[0]
    first_sm = np.zeros(S, bool)
    first_sm[: lcfg.scan_capacity] = sm[0]
    states = lio_fleet.fleet_init(d_cfg, np.stack([first_sp] * 2), np.stack([first_sm] * 2),
                                  np.stack([poses[0]] * 2), device=dev)
    states = states._replace(ekf_state=states.ekf_state._replace(v=torch.stack([up(v0)] * 2)))
    zero_counts(*kernels)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ffin, fout = lio_fleet.fleet_run_lio(states, *[torch.stack(xs) for xs in zip(*robots)], d_cfg)
    torch.cuda.synchronize()
    rate = 2 * n / (time.perf_counter() - t1)
    record("p16_fleet")
    f_seg = segment_sum_sorted.launches
    f_ate = []
    for b, rb in enumerate(robots):
        sfin, sout = lio.run_lio_blocks(tree_index(states, b), *rb, lio_fleet._xla_config(d_cfg))
        if not (torch.equal(fout.world_T_body[b], sout.world_T_body)
                and torch.equal(ffin.ekf_state.P[b], sfin.ekf_state.P)):
            fail(f"fleet_run_lio robot {b} differs from its own run by "
                 f"{(fout.world_T_body[b] - sout.world_T_body).abs().max().item()}")
        f_ate.append(hold_ate(f"fleet_run_lio robot {b}", fout.world_T_body[b].cpu().numpy(),
                              fout.n_correspondences[b].cpu().numpy(), n))
    if not f_seg:
        fail("fleet_run_lio: the segment sum never launched")
    out["runs"]["fleet"] = dict(ate=f_ate, scans_s=[rate], segsum=f_seg)
    print(f"fleet_run_lio on LIOConfig(): 2 robots x {n} frames, each equal to its own run, "
          f"{rate:.1f} scans/s, ATE-RMSE {', '.join(f'{a:.4f}' for a in f_ate)} m, GPS accepted "
          f"{fout.gps_accepted.sum(dim=1).tolist()}, segment sum launches {f_seg} [{tag}]",
          flush=True)
    print(f"phase 16 the LIO's default configuration: {time.perf_counter() - t_phase:.1f} s "
          f"[{tag}]", flush=True)
    return out


def main() -> None:
    t_start = time.perf_counter()
    # ---- 0. the device ----
    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda", 0)
    tag = card()  # "<name>, <power limit>", printed beside every number
    print(tag, flush=True)
    name = torch.cuda.get_device_name(0)
    lapack_calls = lapack_cpu_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)

    from slam_sensor_fusion_tpu_torch.models import localization as lz
    from slam_sensor_fusion_tpu_torch.models import pipeline_fast as pf
    from slam_sensor_fusion_tpu_torch.models.session import (
        BlockLocalizerSession,
        LocalizerSession,
    )
    from slam_sensor_fusion_tpu_torch.ops import cuda_lib
    from slam_sensor_fusion_tpu_torch.ops.icp import association_inputs, icp_align
    from slam_sensor_fusion_tpu_torch.ops.icp_fused import (
        _fused_core,
        _fused_core_plain,
        _icp_plain,
        fused_inputs,
    )
    from slam_sensor_fusion_tpu_torch.models import lio
    from slam_sensor_fusion_tpu_torch.models.session import LIOSession
    from slam_sensor_fusion_tpu_torch.ops import p2p_fused as p2p
    from slam_sensor_fusion_tpu_torch.ops.lio_superblock_fused import (
        lio_superblock,
        lio_superblock_plain,
    )
    from slam_sensor_fusion_tpu_torch.parallel import lio_fleet, map_shard
    from slam_sensor_fusion_tpu_torch.ops.nn_pallas import pair_nn, pair_nn_plain
    from slam_sensor_fusion_tpu_torch.ops.superblock_fused import (
        superblock_fine,
        superblock_fine_plain,
    )
    from slam_sensor_fusion_tpu_torch.ops.superblock_fused import kernel_grid as sb_grid
    from slam_sensor_fusion_tpu_torch.ops.icp_fused import kernel_grid as icp_grid
    from slam_sensor_fusion_tpu_torch.ops.lio_superblock_fused import kernel_grid as lio_grid
    from slam_sensor_fusion_tpu_torch.ops.nn_pallas import kernel_grid as nn_grid
    from slam_sensor_fusion_tpu_torch.models.mapping import StreamingMapper, build_map_data
    from slam_sensor_fusion_tpu_torch.ops.deskew import se3_log
    from slam_sensor_fusion_tpu_torch.ops.voxel_map import (
        VoxelMapConfig,
        voxel_map_centroids_numpy,
        voxel_map_init,
        voxel_map_insert,
    )
    from slam_sensor_fusion_tpu_torch.ops.voxel_map_sorted import (
        SortedVoxelMapConfig,
        _group_rows,
        sorted_voxel_map_centroids_numpy,
        sorted_voxel_map_init,
        sorted_voxel_map_insert,
    )
    from slam_sensor_fusion_tpu_torch.ops.voxel_segsum import segment_sum_sorted
    from slam_sensor_fusion_tpu_torch.ops.ordered_scan import cumsum_rows
    from slam_sensor_fusion_tpu_torch.ops.xla_math import xla_math
    from slam_sensor_fusion_tpu_torch.utils import mapdata, native
    from slam_sensor_fusion_tpu_torch.utils.config import MappingConfig

    kernels = (superblock_fine, pair_nn, _fused_core, p2p._p2p_core, p2p._p2p_associate,
               p2p._p2p_gn_corr, lio_superblock, segment_sum_sorted, cumsum_rows, xla_math)

    # ---- 1. build ----
    t0 = time.perf_counter()
    cuda_lib.build(force=True)
    cuda_lib.lib()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s (nvcc {cuda_lib.build_seconds:.1f} s) [{tag}]", flush=True)
    for line in ptxas_lines(cuda_lib.build_log):
        print(f"  ptxas: {line}")
    # K1, K3, K4 and K7 are cooperative grids: their launch shape at the
    # main paths' tiles (bench_loc's 4 x 1024 source, 512-row target tiles;
    # the session's 8 x 512 source tiles; bench_lio's 16 x 512 source tiles
    # a frame, 4 x 512 in the block loop), and K1's and K3's at the JAX
    # package's default and stress tiles; K2's scan is an ordinary launch
    # spread over every SM (the rescue's tiles and the stress tiles)
    config, lcfg, scfg = bench_config(), lio_config(), session_config()
    dcfg, xcfg = default_tiles_config(), stress_config()
    rcfg = config.rescue_icp
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def tiles(c):
        return c.capacity.cropped_scan // c.icp.tile_src, c.icp.tile_src

    grids = {
        "K1": sb_grid(*tiles(config), config.icp.tile_tgt),
        "K1 64x256": sb_grid(*tiles(dcfg), dcfg.icp.tile_tgt),
        "K1 16x4096": sb_grid(*tiles(xcfg), xcfg.icp.tile_tgt),
        "K3": icp_grid(*tiles(scfg)),
        "K3 4x4096": icp_grid(4, xcfg.icp.tile_src),
        "K4": p2p.kernel_grid(lcfg.scan_capacity // lcfg.p2p.tile_src, lcfg.p2p.tile_src),
        "K7": lio_grid(lcfg.scan_capacity // lcfg.reg_subsample // lcfg.p2p.tile_src,
                       lcfg.p2p.tile_src),
        "K2 scan": nn_grid(rcfg.tile_src,
                           config.capacity.bf_source // rcfg.tile_src * rcfg.max_pairs_factor),
        "K2 scan 16x4096": nn_grid(xcfg.icp.tile_src, tiles(xcfg)[0] * xcfg.icp.max_pairs_factor),
        "K5 scan": p2p.assoc_grid(lcfg.p2p.tile_src, lcfg.scan_capacity // lcfg.p2p.tile_src
                                  * lcfg.p2p.max_pairs_factor),
    }
    for label, g in grids.items():
        print(f"  grid: {label} {g['blocks']} blocks of {g['threads']} threads on {sms} "
              f"multiprocessors (a multiprocessor could hold {g['per_sm']}) [{tag}]", flush=True)
        if g["blocks"] < MIN_GRID_BLOCKS:
            fail(f"{label}: a grid of {g['blocks']} blocks spans fewer than {MIN_GRID_BLOCKS} SMs")
    # K6 is a thread-block cluster: its CTAs and what each stages at the LIO
    # bench's 16 x 512 source tiles
    k6_cluster = p2p.gn_cluster(lcfg.scan_capacity // lcfg.p2p.tile_src, lcfg.p2p.tile_src)
    print(f"  cluster: K6 {k6_cluster['ctas']} CTAs of {k6_cluster['threads']} threads, "
          f"{k6_cluster['smem_bytes']} bytes of the matched set staged a CTA [{tag}]", flush=True)

    # ---- worlds (host set-up of every phase's world) ----
    t0 = time.perf_counter()
    seq, tiles, odom_pos, gps_rows = world_parts(N_FRAMES, RAW_POINTS)
    map_data = build_map_data(tiles, odom_pos, gps_rows)
    xseq, xmap = build_world(TILES_FRAMES, raw_points=122000, density=48.0)
    sseq, smap = build_session_world(SESSION_FRAMES)
    lposes, lv0, lsp, lsm, ltp, lgyro, laccel, ldts, lgps = build_lio_world(
        LIO_FRAMES, lcfg.scan_capacity)
    mposes, msp, msm, mtp = build_map_world(MAP_FRAMES, MAP_SCAN_CAP)
    n_map_groups = MAP_FRAMES // MAP_GROUP
    map_uniq, map_worst = dedup_capacity(
        [np.concatenate([msp[i][msm[i]] @ mposes[i][:3, :3].T + mposes[i][:3, 3]
                         for i in range(g * MAP_GROUP, (g + 1) * MAP_GROUP)])
         for g in sorted({0, n_map_groups // 2, n_map_groups - 1})],
        np.asarray(MAP_ORIGIN, np.float32), MAP_VOXEL, MAP_GROUP * MAP_SCAN_CAP)
    rel = np.stack([np.linalg.inv(mposes[max(i - 1, 0)].astype(np.float64))
                    @ mposes[i].astype(np.float64) for i in range(MAP_FRAMES)]).astype(np.float32)

    def grouped(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).reshape(
            n_map_groups, MAP_GROUP, *a.shape[1:])

    map_groups = (grouped(msp), grouped(msm), grouped(mtp),
                  se3_log(torch.from_numpy(rel).to(dev)).reshape(n_map_groups, MAP_GROUP, 6),
                  grouped(mposes))
    print(f"set-up worlds: {time.perf_counter() - t0:.1f} s, map points {map_data.map_points.shape[0]} "
          f"(bench), {xmap.map_points.shape[0]} (stress), {smap.map_points.shape[0]} (session), "
          f"LIO scan points mean "
          f"{lsm.sum(1).mean():.0f} of {lcfg.scan_capacity}, mapping scan points mean "
          f"{msm.sum(1).mean():.0f} of {MAP_SCAN_CAP} (unique cells a group <= {map_worst}: "
          f"unique_capacity {map_uniq})", flush=True)

    # ---- 2. kernel against plain at main-path shapes ----
    t0 = time.perf_counter()
    loc = lz.Localizer(map_data, config, dev)
    gps_T = loc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    state0, cscan, coarse = startup(loc, seq, gps_T, config, dev)
    bf_map, bf_scan = lz.brute_force_clouds(cscan, state0.cropped_map, state0.map_T_ref, config)
    k2_in = association_inputs(
        bf_scan.points, bf_scan.mask, bf_map.points, bf_map.mask,
        rescue_start(coarse.map_T_sensor), config.rescue_icp,
    )
    k2_err = check_k2(k2_in, name)
    T = N_FRAMES - 1
    frames = pf.build_paged_frames(
        config, seq.scans[1:N_FRAMES], seq.odom_T_sensor[1:N_FRAMES], gps_T[1:N_FRAMES],
        seq.odom_cov_trace[1:N_FRAMES], seq.gps_cov_trace[1:N_FRAMES], np.ones(T, bool), dev,
    )
    K = config.superstep
    blk = pf.PagedFrames(*[x[:K] for x in frames])
    pro = pf.superstep_prologue(state0, blk, loc.map_cloud, config)
    fs = state0.filter_state
    k1_args = (
        blk.src_pages, pro.pair_start, pro.pair_cnt, pro.pair_tgt, blk.valid,
        blk.odom_T_sensor, blk.map_T_sensor_gps, blk.odom_cov_trace, blk.gps_cov_trace,
        state0.map_T_sensor, state0.odom_T_sensor_previous, fs.transitions, fs.count,
        fs.previous_pose, pro.cached_target.center, pro.cached_target.pages, config,
    )
    _icp_plain.pairs_visited = 0
    k1_err = check_k1(k1_args, name)
    k1_pairs = _icp_plain.pairs_visited
    print(f"K1 block pair demand {pro.demand.tolist()}, tile pairs visited {k1_pairs}", flush=True)
    check_per_frame_vs_k1(state0, blk, loc.map_cloud, config, tag)

    # K3 at the online session's shapes: frame 1's cropped scan (8 tiles of
    # 512) against the post-coarse cropped map (128 tiles of 512), from a
    # prior 0.3 m and 2 degrees off the coarse pose
    sloc = lz.Localizer(smap, scfg, dev)
    sgps_T = sloc.gps_poses(sseq.gps_lat, sseq.gps_lon, sseq.compass_yaw)
    sstate, sscan, scoarse = startup(sloc, sseq, sgps_T, scfg, dev)
    k3_in, _, k3_ovf = fused_inputs(
        sscan.points, sscan.mask, sstate.cropped_map.points, sstate.cropped_map.mask,
        nudge(scoarse.map_T_sensor, 0.3, -0.2, 2.0), scfg.icp, sstate.cached_target,
    )
    if bool(k3_ovf):
        fail("K3 check inputs: pair list overflow")
    k3_err, k3_pairs, _ = check_k3(k3_in, scfg.icp, False, name)
    k3l_err, k3l_pairs, _ = check_k3(k3_in, scfg.icp, True, name)

    # K1, K2 and K3 at the JAX package's own tile shapes: LocalizationConfig()'s
    # 64 source tiles of 256 (the bench world), and the stress cell's 16 tiles
    # of 4096 against 1024 target tiles of 128 (the stress world). Each from
    # its configuration's startup state; phase 8 runs their main path
    wide = {}
    for label, wcfg, wseq, wmap in [("64x256", dcfg, seq, map_data),
                                    ("16x4096", xcfg, xseq, xmap)]:
        wloc = lz.Localizer(wmap, wcfg, dev)
        wgps = wloc.gps_poses(wseq.gps_lat, wseq.gps_lon, wseq.compass_yaw)
        wstate, wscan, wcoarse = startup(wloc, wseq, wgps, wcfg, dev)
        n = TILES_FRAMES
        wframes = pf.build_paged_frames(
            wcfg, wseq.scans[1:n], wseq.odom_T_sensor[1:n], wgps[1:n], wseq.odom_cov_trace[1:n],
            wseq.gps_cov_trace[1:n], np.ones(n - 1, bool), dev,
        )
        wblk = pf.PagedFrames(*[x[:K] for x in wframes])
        t1 = time.perf_counter()
        wpro = pf.superstep_prologue(wstate, wblk, wloc.map_cloud, wcfg)
        torch.cuda.synchronize()
        pro_s = time.perf_counter() - t1
        wfs = wstate.filter_state
        wargs = (
            wblk.src_pages, wpro.pair_start, wpro.pair_cnt, wpro.pair_tgt, wblk.valid,
            wblk.odom_T_sensor, wblk.map_T_sensor_gps, wblk.odom_cov_trace, wblk.gps_cov_trace,
            wstate.map_T_sensor, wstate.odom_T_sensor_previous, wfs.transitions, wfs.count,
            wfs.previous_pose, wpro.cached_target.center, wpro.cached_target.pages, wcfg,
        )
        _icp_plain.pairs_visited = 0
        w = dict(cfg=wcfg, seq=wseq, loc=wloc, gps=wgps, state=wstate, frames=wframes,
                 k1_err=check_k1(wargs, name), k1_pairs=_icp_plain.pairs_visited)
        superblock_fine.scratch_bytes = 0
        w["k1_ms"] = time_ms(lambda: superblock_fine(*wargs), 3)
        w["scratch_mib"] = superblock_fine.scratch_bytes / 2**20
        w["k1_plain_ms"] = time_ms(lambda: superblock_fine_plain(*wargs), 1)
        TMw, TNw = wblk.src_pages.shape[-1], wpro.cached_target.pages.shape[-1]
        w["k1_bound"] = bound(
            w["k1_pairs"] * TMw * TNw * FLOP_PER_DISTANCE,
            nbytes(*[a for a in wargs if isinstance(a, torch.Tensor)])
            + nbytes(*superblock_fine(*wargs)),
        )
        w["prologue_ms"] = time_ms(lambda: pf.superstep_prologue(wstate, wblk, wloc.map_cloud, wcfg), 3)
        print(f"K1 at {label}: {w['k1_ms']:.3f} ms/superblock (plain {w['k1_plain_ms']:.3f}), bound "
              f"{w['k1_bound'][0]:.4f} ms ({w['k1_bound'][1]}), {w['k1_pairs']} tile pairs visited, "
              f"pair demand {wpro.demand.tolist()} of {wpro.pair_tgt.shape[1]} slots, per-slot scratch "
              f"{w['scratch_mib']:.1f} MiB; superstep_prologue {w['prologue_ms']:.3f} ms "
              f"({pro_s * 1e3:.1f} ms the first call) [{tag}]", flush=True)
        wide[label] = w
        if label != "16x4096":
            continue
        # K2 at the stress tiles: the first association of an ICP of the
        # cropped scan (16 x 4096) against the cropped map (1024 x 128)
        k2x_in = association_inputs(
            wscan.points, wscan.mask, wstate.cropped_map.points, wstate.cropped_map.mask,
            wcoarse.map_T_sensor, wcfg.icp,
        )
        w["k2_err"] = check_k2(k2x_in, name)
        w["k2_ms"] = time_ms(lambda: pair_nn(*k2x_in), 5)
        w["k2_device_ms"] = device_ms(lambda: pair_nn(*k2x_in), 5, K2_KERNELS)
        w["k2_plain_ms"] = time_ms(lambda: pair_nn_plain(*k2x_in), 1)
        w["k2_bound"] = bound(
            int(k2x_in[3].sum()) * k2x_in[0].shape[-1] * k2x_in[1].shape[-1] * FLOP_PER_DISTANCE,
            nbytes(*k2x_in) + nbytes(*pair_nn(*k2x_in)),
        )
        # K3 at 4 tiles of 4096: the first quarter of the cropped scan
        # (Morton order) against the cropped map, from a prior 0.3 m and 2
        # degrees off the coarse pose, fresh and lazy
        q = 4 * wcfg.icp.tile_src
        x3cfg = dataclasses.replace(wcfg.icp, mode="fast")
        k3x_in, _, k3x_ovf = fused_inputs(
            wscan.points[:q], wscan.mask[:q], wstate.cropped_map.points, wstate.cropped_map.mask,
            nudge(wcoarse.map_T_sensor, 0.3, -0.2, 2.0), x3cfg, wstate.cached_target,
        )
        if bool(k3x_ovf):
            fail("K3 at 4 x 4096: pair list overflow")
        for lazy, key in [(False, "fresh"), (True, "lazy")]:
            err3, pairs3, _ = check_k3(k3x_in, x3cfg, lazy, name)
            w[f"k3_{key}_err"] = err3
            w[f"k3_{key}_ms"] = time_ms(lambda: _fused_core(*k3x_in, x3cfg, lazy), 5)
            w[f"k3_{key}_plain_ms"] = time_ms(lambda: _fused_core_plain(*k3x_in, x3cfg, lazy), 1)
            w[f"k3_{key}_bound"] = bound(
                pairs3 * k3x_in[0].shape[-1] * k3x_in[1].shape[-1] * FLOP_PER_DISTANCE,
                nbytes(*k3x_in) + nbytes(*_fused_core(*k3x_in, x3cfg, lazy)),
            )
        print(f"K2 at 16 x 4096: {w['k2_ms']:.3f} ms (on the card alone {w['k2_device_ms']}; "
              f"plain {w['k2_plain_ms']:.3f}), bound "
              f"{w['k2_bound'][0]:.4f} ms; K3 at 4 x 4096: fresh {w['k3_fresh_ms']:.3f} ms (plain "
              f"{w['k3_fresh_plain_ms']:.3f}, bound {w['k3_fresh_bound'][0]:.4f}), lazy "
              f"{w['k3_lazy_ms']:.3f} ms (plain {w['k3_lazy_plain_ms']:.3f}, bound "
              f"{w['k3_lazy_bound'][0]:.4f}) [{tag}]", flush=True)

    # K4-K6 at the LIO bench's shapes on a steady-state frame of the LIO
    # world: the first two blocks fill the ring (16 slots), then frame 33 (16
    # source tiles of 512, deskewed at its IMU prior) against the anchor its
    # block starts with (32 target tiles of 1024)
    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    lstate0 = lio.init_state(lcfg, up(lsp[0]), up(lsm[0]), up(lposes[0]))
    lstate0 = lstate0._replace(ekf_state=lstate0.ekf_state._replace(v=up(lv0)))
    Tl = LIO_FRAMES - 1
    gps_var = np.full(Tl, 0.5**2, np.float32)
    larrays = [up(a) for a in (lsp[1:], lsm[1:], lgyro, laccel, ldts, lgps, gps_var,
                               np.ones(Tl, bool))]
    ltau = up(ltp[1:])
    w = LIO_WARM_FRAMES
    lstate_w, _ = lio.run_lio_blocks(lstate0, *[a[:w] for a in larrays], lcfg, scan_tau=ltau[:w])
    lstate_w = lio._with_anchor(
        lstate_w,
        lio._refresh_anchor(lstate_w.ring, lstate_w.ring_mask, lstate_w.ekf_state.p, lcfg),
        lio._pose_cov6(lstate_w.ekf_state.P),
    )
    _, lprior, lscan = lio._prior_and_scan(
        lstate_w, larrays[0][w], larrays[2][w], larrays[3][w], larrays[4][w], lcfg, ltau[w])
    k4_in, _, k4_demand = p2p.p2p_inputs(
        lscan, larrays[1][w], lstate_w.anchor_cache, lprior, lcfg.p2p)
    cfg_fresh = lcfg.p2p._replace(fixed_correspondences=False)
    k4_pairs = int(k4_in[3].sum())
    print(f"K4 check inputs: src {tuple(k4_in[0].shape)} tgt {tuple(k4_in[1].shape)}, pair demand "
          f"{int(k4_demand)}, in the list {k4_pairs} of {k4_in[4].shape[0]}", flush=True)
    k4_err = check_gn("K4 fixed", p2p._p2p_core(*k4_in, lcfg.p2p),
                      p2p._p2p_core_plain(*k4_in, lcfg.p2p), name)
    k4f_err = check_gn("K4 fresh", p2p._p2p_core(*k4_in, cfg_fresh),
                       p2p._p2p_core_plain(*k4_in, cfg_fresh), name)
    d2_k, qn_k = p2p._p2p_associate(*k4_in)
    d2_p, qn_p = p2p._p2p_associate_plain(*k4_in)
    torch.cuda.synchronize()
    k5_rel = ((d2_k - d2_p).abs() / torch.clamp(d2_p.abs(), min=1e-30)).max().item()
    if not k5_rel <= K5_RTOL:
        fail(f"K5: d2 relative error {k5_rel} > {K5_RTOL}")
    if not torch.equal(qn_k, qn_p):
        fail("K5: matched point + normal pages differ")
    k5_err = (d2_k - d2_p).abs()[d2_p < 1e6].max().item()
    print(f"K5 vs plain: d2 rel {k5_rel:.3e}, matched pages equal [{name}]", flush=True)
    k6_in = (k4_in[5], k4_in[0], d2_p, qn_p)
    k6_err = check_gn("K6", p2p._p2p_gn_corr(*k6_in, lcfg.p2p),
                      p2p._p2p_gn_corr_plain(*k6_in, lcfg.p2p), name)
    whole = p2p._p2p_core(*k4_in, lcfg.p2p)
    halves = p2p._p2p_gn_corr(k4_in[5], k4_in[0], d2_k, qn_k, lcfg.p2p)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(whole, halves)):
        fail(f"K6(K5(x)) differs from K4 with fixed correspondences by "
             f"{(whole[0] - halves[0]).abs().max().item()}")
    print(f"K6(K5(x)) equals K4 fixed bit for bit [{name}]", flush=True)

    k4_ms = time_ms(lambda: p2p._p2p_core(*k4_in, lcfg.p2p), 10)
    k4_plain_ms = time_ms(lambda: p2p._p2p_core_plain(*k4_in, lcfg.p2p), 2)
    k4f_ms = time_ms(lambda: p2p._p2p_core(*k4_in, cfg_fresh), 5)
    k4f_plain_ms = time_ms(lambda: p2p._p2p_core_plain(*k4_in, cfg_fresh), 2)
    k5_ms = time_ms(lambda: p2p._p2p_associate(*k4_in), 10)
    k5_plain_ms = time_ms(lambda: p2p._p2p_associate_plain(*k4_in), 2)
    k6_ms = time_ms(lambda: p2p._p2p_gn_corr(*k6_in, lcfg.p2p), 20)
    k6_plain_ms = time_ms(lambda: p2p._p2p_gn_corr_plain(*k6_in, lcfg.p2p), 2)
    print(f"K4 fixed {k4_ms:.3f} ms/registration (plain {k4_plain_ms:.3f}), fresh {k4f_ms:.3f} "
          f"(plain {k4f_plain_ms:.3f}); K5 {k5_ms:.3f} ms (plain {k5_plain_ms:.3f}); K6 {k6_ms:.3f} ms "
          f"(plain {k6_plain_ms:.3f}) [{tag}]", flush=True)
    # on the card alone (the profiler's device time a call): K5's scan and
    # combine, K6's cluster
    k5_split = device_ms_by_kernel(lambda: p2p._p2p_associate(*k4_in), 20, K5_KERNELS)
    k6_device_ms = device_ms_by_kernel(
        lambda: p2p._p2p_gn_corr(*k6_in, lcfg.p2p), 20, K6_KERNELS)[K6_KERNELS[0]]
    k5_device_ms = (None if None in k5_split.values() else sum(k5_split.values()))
    print(f"on the card alone: K5 {k5_device_ms} ms (scan {k5_split[K5_KERNELS[0]]}, combine "
          f"{k5_split[K5_KERNELS[1]]}), K6 {k6_device_ms} ms (a cluster of {k6_cluster['ctas']} "
          f"x {k6_cluster['threads']} threads) [{tag}]", flush=True)
    bnd4 = p2p_bounds(k4_in, lcfg.p2p, whole, (d2_k, qn_k), k6_in, halves)
    k4_bound, k4f_bound, k5_bound, k6_bound = (bnd4[k] for k in ("K4", "K4 fresh", "K5", "K6"))
    print(f"bounds: K4 fixed {k4_bound[0]:.4f} ms ({k4_bound[1]}), fresh {k4f_bound[0]:.4f} ms "
          f"({k4f_bound[1]}), K5 {k5_bound[0]:.4f} ms ({k5_bound[1]}), K6 {k6_bound[0]:.5f} ms "
          f"({k6_bound[1]}) [{tag}]", flush=True)

    # K7 at the width of the LIO bench's `block` loop on a steady-state block: the
    # block of frames 33-48 (16 frames of 10 IMU samples, 4 source tiles of
    # 512 against 32 target tiles of 1024) from the state after two blocks,
    # through run_lio_superblocks' own prologue
    k7_in, k7_pairs = lio_block_inputs(lio, lcfg, lstate_w, larrays, ltau, w, dev)
    k7_params = lio._superblock_params(lcfg)
    k7_err = check_k7(k7_in, k7_params, name)
    k7_ms = time_ms(lambda: lio_superblock(*k7_in, k7_params), 3)
    k7_plain_ms = time_ms(lambda: lio_superblock_plain(*k7_in, k7_params), 1)
    k7_bound = k7_bound_of(k7_in, k7_pairs, lcfg, lio_superblock(*k7_in, k7_params))
    Kb = k7_in[17].shape[0]
    print(f"K7 {k7_ms:.3f} ms/block of {Kb} frames (plain {k7_plain_ms:.3f}); {k7_pairs} tile "
          f"pairs; bound {k7_bound[0]:.4f} ms ({k7_bound[1]}) [{tag}]", flush=True)

    k2_ms = time_ms(lambda: pair_nn(*k2_in), 20)
    k2_device_ms = device_ms(lambda: pair_nn(*k2_in), 20, K2_KERNELS)
    k2_plain_ms = time_ms(lambda: pair_nn_plain(*k2_in), 5)
    k1_ms = time_ms(lambda: superblock_fine(*k1_args), 5)
    k1_plain_ms = time_ms(lambda: superblock_fine_plain(*k1_args), 2)
    k3_ms = time_ms(lambda: _fused_core(*k3_in, scfg.icp, False), 10)
    k3_plain_ms = time_ms(lambda: _fused_core_plain(*k3_in, scfg.icp, False), 3)
    k3l_ms = time_ms(lambda: _fused_core(*k3_in, scfg.icp, True), 10)
    k3l_plain_ms = time_ms(lambda: _fused_core_plain(*k3_in, scfg.icp, True), 3)
    print(f"K1 {k1_ms:.3f} ms/superblock (plain {k1_plain_ms:.3f}); K2 {k2_ms:.3f} ms/call "
          f"(on the card alone {k2_device_ms} ms) "
          f"(plain {k2_plain_ms:.3f}); K3 fresh {k3_ms:.3f} ms/ICP (plain {k3_plain_ms:.3f}), "
          f"lazy {k3l_ms:.3f} (plain {k3l_plain_ms:.3f}) [{tag}]", flush=True)
    # the host's share of a K3 call (a session push makes one): the call as
    # it returns, and the scratch and control block it allocates each time
    reps = 50
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        _fused_core(*k3_in, scfg.icp, False)
    k3_host_ms = (time.perf_counter() - t1) / reps * 1e3
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        torch.empty((k3_in[4].shape[0], k3_in[0].shape[-1]), dtype=torch.float32, device=dev)
        torch.empty((k3_in[4].shape[0], k3_in[0].shape[-1]), dtype=torch.int32, device=dev)
        cuda_lib.control_block(dev)
    k3_alloc_ms = (time.perf_counter() - t1) / reps * 1e3
    print(f"K3 host time a call (as it returns) {k3_host_ms:.4f} ms, of which its per-call grid "
          f"scratch and control block {k3_alloc_ms:.4f} ms [{tag}]", flush=True)

    # least times from this run's inputs: the tile pairs the data made the
    # kernels visit, 8 FLOP a distance, each input read and output written once
    TM1, TN1 = blk.src_pages.shape[-1], pro.cached_target.pages.shape[-1]
    k1_bound = bound(
        k1_pairs * TM1 * TN1 * FLOP_PER_DISTANCE,
        nbytes(*[a for a in k1_args if isinstance(a, torch.Tensor)])
        + nbytes(*superblock_fine(*k1_args)),
    )
    TM2, TN2 = k2_in[0].shape[-1], k2_in[1].shape[-1]
    k2_bound = bound(
        int(k2_in[3].sum()) * TM2 * TN2 * FLOP_PER_DISTANCE,
        nbytes(*k2_in) + nbytes(*pair_nn(*k2_in)),
    )
    TM3, TN3 = k3_in[0].shape[-1], k3_in[1].shape[-1]
    k3_bytes = nbytes(*k3_in) + nbytes(*_fused_core(*k3_in, scfg.icp, False))
    k3_bound = bound(k3_pairs * TM3 * TN3 * FLOP_PER_DISTANCE, k3_bytes)
    k3l_bound = bound(k3l_pairs * TM3 * TN3 * FLOP_PER_DISTANCE, k3_bytes)
    print(f"bounds: K1 {k1_bound[0]:.4f} ms ({k1_bound[1]}), K2 {k2_bound[0]:.4f} ms "
          f"({k2_bound[1]}), K3 fresh {k3_bound[0]:.4f} ms ({k3_bound[1]}), K3 lazy "
          f"{k3l_bound[0]:.4f} ms ({k3l_bound[1]}) [{tag}]", flush=True)
    print(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)

    launches = {k: {} for k in kernels}
    xla_by = {}  # xla_math's launches by path and function

    def record(path: str) -> None:
        for k in kernels:
            launches[k][path] = k.launches
        xla_by[path] = dict(xla_math.launches_by)

    # ---- 3. the main path ----
    t0 = time.perf_counter()
    zero_counts(*kernels)
    loc = lz.Localizer(map_data, config, dev)
    gps_T = loc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    state, cscan, coarse = startup(loc, seq, gps_T, config, dev)
    if not bool(coarse.success):
        fail("coarse alignment failed")
    bf_map, bf_scan = lz.brute_force_clouds(cscan, state.cropped_map, state.map_T_ref, config)
    T0 = rescue_start(coarse.map_T_sensor)
    res = icp_align(bf_scan.points, bf_scan.mask, bf_map.points, bf_map.mask, T0, config.rescue_icp)
    if not bool(res.has_converged):
        fail("forced rescue ICP did not converge")
    moved = torch.linalg.norm(res.transformation[:3, 3] - coarse.map_T_sensor[:3, 3]).item()
    print(f"coarse: success={bool(coarse.success)} score={float(coarse.score):.4f}; forced rescue: "
          f"converged, {int(res.iterations)} iterations, error {float(res.error):.4f} m, "
          f"{moved:.3f} m from the coarse pose", flush=True)
    t_start_path = time.perf_counter() - t0
    frames = pf.build_paged_frames(
        config, seq.scans[1:N_FRAMES], seq.odom_T_sensor[1:N_FRAMES], gps_T[1:N_FRAMES],
        seq.odom_cov_trace[1:N_FRAMES], seq.gps_cov_trace[1:N_FRAMES], np.ones(T, bool), dev,
    )
    gt = seq.true_map_T_sensor[1:N_FRAMES]
    n_blocks = T // K
    rate = 0.0
    for p in range(2):
        before = superblock_fine.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fin, out = pf.run_chunk_fast(state, frames, loc.map_cloud, config)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launched = superblock_fine.launches - before
        est = out.map_T_sensor.cpu().numpy()
        ate = ate_rmse(est, gt)
        n_ovf = int(out.pair_overflow.sum())
        n_slack = int(out.slack_violation.sum())
        conv = out.icp_converged.float().mean().item()
        rate = T / dt
        print(f"pass {p}: {T} frames {dt:.3f} s = {rate:.1f} scans/s, ATE-RMSE {ate:.4f} m, "
              f"icp-converged {conv:.3f}, pair-overflow frames {n_ovf}, slack-violations {n_slack}, "
              f"K1 launches {launched}, pair demand mean {out.pair_demand.float().mean().item():.1f} "
              f"[{tag}]", flush=True)
        if launched != n_blocks:
            fail(f"K1 launched {launched} times for {n_blocks} superblocks")
        if n_ovf or n_slack:
            fail(f"pair overflow on {n_ovf} frames, slack violated on {n_slack}")
        if not np.isfinite(est).all():
            fail("non-finite pose")
        if not ate < ATE_LIMIT:
            fail(f"ATE-RMSE {ate} >= {ATE_LIMIT}")
    record("superblocks")
    # phase 11 starts from this path's world, state and paged frames
    # phase 12 runs the public helpers on the first steady frame
    p12 = dict(config=config, cropped_map=state.cropped_map, frame_pages=frames.src_pages[0],
               frame_cnt=frames.src_cnt[0], pose=out.map_T_sensor[0])
    p11 = dict(config=config, loc=loc, state=state, seq=seq, gps_T=gps_T, frames=frames,
               cscan=cscan, coarse_T=coarse.map_T_sensor,
               bf=(bf_scan.points, bf_scan.mask, bf_map.points, bf_map.mask,
                   torch.from_numpy(np.asarray(gps_T[0], np.float32)).to(dev)))
    ate3_head = ate_rmse(est[: RECORD_FRAMES - 1], gt[: RECORD_FRAMES - 1])
    if pair_nn.launches < 1:
        fail("K2 never launched on the main path")
    k1_steady_ms = profile_pass(
        lambda: pf.run_chunk_fast(state, frames, loc.map_cloud, config), pf, n_blocks, tag)
    print(f"phase 3 main path: {time.perf_counter() - t0:.1f} s (startup {t_start_path:.1f} s); "
          f"launches K1 {launches[superblock_fine]['superblocks']}, K2 "
          f"{launches[pair_nn]['superblocks']} (before the profiled pass); scans/s (pass 1) "
          f"{rate:.1f} [{tag}]", flush=True)

    # ---- 4. the online path: LocalizerSession (K3 a push), then
    # BlockLocalizerSession at K=4 (K1 a block) ----
    t0 = time.perf_counter()
    zero_counts(*kernels)
    sess = LocalizerSession(smap, scfg, profile=True, device=dev)
    first = None  # the push where the coarse ladder succeeded
    lat, split, est, gt_idx = [], [], [], []
    for i in range(SESSION_FRAMES):
        before = _fused_core.launches
        t1 = time.perf_counter()
        r = sess.push(*push_args(sseq, i))
        dt = time.perf_counter() - t1
        if first is None and sess.coarse_done:
            first = i
        if first is None:
            continue
        launched = _fused_core.launches - before
        if r.phase != "tracking" or launched != 1:
            fail(f"session push {i}: phase {r.phase}, {launched} K3 launches (expected tracking, 1)")
        if r.pair_overflow:
            fail(f"session push {i}: pair overflow")
        est.append(r.map_T_sensor)
        gt_idx.append(i)
        if i >= max(SESSION_WARMUP, first + 1):
            lat.append(dt)
            split.append(sess.last_timing)
    if first is None:
        fail("session: the coarse ladder never succeeded")
    record("session")
    s_ate = ate_rmse(np.stack(est), sseq.true_map_T_sensor[gt_idx])
    sp50 = {k: float(np.percentile([s[k] for s in split], 50)) for k in split[0]}
    print(f"LocalizerSession: {len(est)} tracking pushes from push {first}, ATE-RMSE {s_ate:.4f} m, "
          f"push p50 {percentile_ms(lat, 50):.3f} ms p99 {percentile_ms(lat, 99):.3f} ms over "
          f"{len(lat)} pushes; split p50 host {sp50['host_ms']:.3f} dispatch "
          f"{sp50['dispatch_ms']:.3f} device {sp50['device_ms']:.3f} ms; K3 launches "
          f"{_fused_core.launches}, K2 {pair_nn.launches} [{tag}]", flush=True)
    if not s_ate < ATE_LIMIT:
        fail(f"session ATE-RMSE {s_ate} >= {ATE_LIMIT}")

    zero_counts(*kernels)
    mcfg = dataclasses.replace(
        scfg, block_kernel=True, superblock_parity=True, superstep=4,
        icp=dataclasses.replace(scfg.icp, mode="parity"),
    )
    msess = BlockLocalizerSession(smap, mcfg, profile=True, device=dev)
    blat, bsplit, best, bgt = [], [], [], []
    t_block0 = None
    n_flush = 0
    for i in range(SESSION_FRAMES):
        tracking = msess.coarse_done
        if tracking and t_block0 is None:
            t_block0 = time.perf_counter()
        outs = msess.push(*push_args(sseq, i))
        if not tracking:
            continue
        if outs:
            n_flush += 1
            if n_flush > 1:  # the first block warms up
                blat.append(time.perf_counter() - t_block0)
                bsplit.append(msess.last_timing)
            t_block0 = None
            for k, r in enumerate(outs):
                if r.phase != "tracking" or r.pair_overflow:
                    fail(f"block session frame {i - len(outs) + 1 + k}: phase {r.phase}, "
                         f"overflow {r.pair_overflow}")
                best.append(r.map_T_sensor)
                bgt.append(i - len(outs) + 1 + k)
    record("block_session")
    b_ate = ate_rmse(np.stack(best), sseq.true_map_T_sensor[bgt])
    bp50 = {k: float(np.percentile([s[k] for s in bsplit], 50)) for k in bsplit[0]}
    print(f"BlockLocalizerSession K=4: {n_flush} blocks, ATE-RMSE {b_ate:.4f} m, block p50 "
          f"{percentile_ms(blat, 50):.3f} ms p99 {percentile_ms(blat, 99):.3f} ms over {len(blat)} "
          f"blocks; split p50 host {bp50['host_ms']:.3f} dispatch {bp50['dispatch_ms']:.3f} device "
          f"{bp50['device_ms']:.3f} ms; K1 launches {superblock_fine.launches} [{tag}]", flush=True)
    if superblock_fine.launches != n_flush:
        fail(f"K1 launched {superblock_fine.launches} times for {n_flush} blocks")
    if not b_ate < ATE_LIMIT:
        fail(f"block session ATE-RMSE {b_ate} >= {ATE_LIMIT}")
    print(f"phase 4 online path: {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)

    # ---- 5. the replay entry point: Localizer.run, per-frame parity (K2)
    # and fast mode's per-frame superblock branch (K3) ----
    t0 = time.perf_counter()
    n = REPLAY_FRAMES
    run_args = (sseq.scans[:n], sseq.odom_T_sensor[:n], sseq.gps_lat[:n], sseq.gps_lon[:n],
                sseq.gps_alt[:n], sseq.compass_yaw[:n], sseq.odom_cov_trace[:n],
                sseq.gps_cov_trace[:n])
    engines = {
        "replay_parity": (dataclasses.replace(
            scfg, icp=dataclasses.replace(scfg.icp, mode="parity")), pair_nn),
        "replay_fast": (scfg, _fused_core),
    }
    for path, (cfg, kernel) in engines.items():
        zero_counts(*kernels)
        t1 = time.perf_counter()
        rr = lz.Localizer(smap, cfg, dev).run(*run_args)
        dt = time.perf_counter() - t1
        record(path)
        ok = rr.valid
        r_ate = ate_rmse(rr.map_T_sensor[ok], sseq.true_map_T_sensor[:n][ok])
        print(f"Localizer.run {path}: {int(ok.sum())} valid frames from frame "
              f"{rr.first_processed_frame}, ATE-RMSE {r_ate:.4f} m, {dt:.2f} s; launches K1 "
              f"{superblock_fine.launches}, K2 {pair_nn.launches}, K3 {_fused_core.launches} "
              f"[{tag}]", flush=True)
        if kernel.launches < 1:
            fail(f"Localizer.run {path}: its kernel never launched")
        if ok.sum() < n - 2 or not np.isfinite(rr.map_T_sensor).all():
            fail(f"Localizer.run {path}: {int(ok.sum())} valid frames of {n}")
        if not r_ate < ATE_LIMIT:
            fail(f"Localizer.run {path}: ATE-RMSE {r_ate} >= {ATE_LIMIT}")
    print(f"phase 5 replay: {time.perf_counter() - t0:.1f} s [{tag}]", flush=True)

    # ---- 6. the LIO path: run_lio_blocks twice, LIOSession, run_lio_chunk
    # (one K4 launch a frame), then the split registration (K5 -> K6) ----
    t0 = time.perf_counter()
    k4 = p2p._p2p_core
    lgt = lposes[1:]
    torch.cuda.synchronize()

    def check_lio(what, est, n_corr, launched, frames):
        if launched != frames:
            fail(f"{what}: K4 launched {launched} times for {frames} frames")
        if not (np.isfinite(est).all() and (n_corr > 0).all()):
            fail(f"{what}: non-finite pose or a frame without correspondences")
        ate = ate_rmse(est, lgt[:frames])
        if not ate < LIO_ATE_LIMIT:
            fail(f"{what}: ATE-RMSE {ate} >= {LIO_ATE_LIMIT}")
        return ate

    zero_counts(*kernels)
    lrate = 0.0
    for p in range(2):
        before = k4.launches
        t1 = time.perf_counter()
        lfin, lout = lio.run_lio_blocks(lstate0, *larrays, lcfg, scan_tau=ltau)
        t_issue = time.perf_counter() - t1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        est = lout.world_T_body.cpu().numpy()
        n_corr = lout.n_correspondences.cpu().numpy()
        ate = check_lio(f"run_lio_blocks pass {p}", est, n_corr, k4.launches - before, Tl)
        lrate = Tl / dt
        print(f"LIO pass {p}: {Tl} frames {dt:.3f} s = {lrate:.1f} scans/s, ATE-RMSE {ate:.4f} m, "
              f"{dt / Tl * 1e3:.3f} ms a frame of which host-issued {t_issue / Tl * 1e3:.3f} ms "
              f"(the call returns) and K4 {k4_ms:.3f} ms (phase 2), n_corr mean {n_corr.mean():.0f}, "
              f"rmse mean {lout.rmse.mean().item():.4f} m, GPS accepted "
              f"{int(lout.gps_accepted.sum())} of {Tl}, K4 launches {k4.launches - before} [{tag}]",
              flush=True)
    record("lio_blocks")
    refresh_ms = time_ms(
        lambda: lio._refresh_anchor(lfin.ring, lfin.ring_mask, lfin.ekf_state.p, lcfg), 5)
    print(f"LIO anchor refresh (Morton sort + cell normals + pages of {lfin.ring.shape[0]} ring "
          f"points): {refresh_ms:.3f} ms, once every {lcfg.refresh_every} frames [{tag}]", flush=True)

    # where a frame's time goes: one block from the warmed-up state under
    # the profiler (kernel time by name, launches, the device's idle share)
    nb = lcfg.refresh_every
    blk = [a[w:w + nb] for a in larrays]
    busy_ms, wall_ms, on_dev = profiled_pass(
        lambda: lio.run_lio_blocks(lstate_w, *blk, lcfg, scan_tau=ltau[w:w + nb]))
    k4_prof_ms = sum(e.self_device_time_total for e in on_dev if "p2p_fused_kernel" in e.key) / 1e3
    n_dev = sum(e.count for e in on_dev)
    if busy_ms > 0:
        print(f"LIO profile, one block of {nb} frames: device busy {busy_ms / nb:.3f} ms a frame "
              f"of the profiled block's own {wall_ms / nb:.3f} ms a frame (idle "
              f"{idle_share(busy_ms, wall_ms)}), of which K4 {k4_prof_ms / nb:.3f} ms; "
              f"{n_dev / nb:.0f} device operations a frame; {1e3 / lrate:.3f} ms a frame in the "
              f"second pass without the profiler [{tag}]", flush=True)
    else:
        print(f"LIO profile: the profiler recorded no device time (not measured) [{tag}]", flush=True)

    zero_counts(*kernels)
    lsess = LIOSession(lcfg, lsp[0], lsm[0], lposes[0], device=dev)
    lsess.state = lsess.state._replace(ekf_state=lsess.state.ekf_state._replace(v=up(lv0)))
    llat, lest, lncorr, demand, n_gps = [], [], [], [], 0
    for k in range(Tl):
        # the push's own prologue, replayed beside it: the pair demand of
        # this frame against the list's capacity
        _, prior_k, scan_k = lio._prior_and_scan(
            lsess.state, larrays[0][k], larrays[2][k], larrays[3][k], larrays[4][k], lcfg, ltau[k])
        core_k, _, dem_k = p2p.p2p_inputs(
            scan_k, larrays[1][k], lsess.state.anchor_cache, prior_k, lcfg.p2p)
        demand.append(int(dem_k))
        t1 = time.perf_counter()
        r = lsess.push(lsp[k + 1], lsm[k + 1], lgyro[k], laccel[k], ldts[k], lgps[k],
                       float(gps_var[k]), True, tau=ltp[k + 1])
        llat.append(time.perf_counter() - t1)
        lest.append(r.world_T_body)
        lncorr.append(r.n_correspondences)
        n_gps += r.gps_accepted
    record("lio_session")
    lest = np.stack(lest)
    s_ate = check_lio("LIOSession", lest, np.asarray(lncorr), k4.launches, Tl)
    capacity = core_k[4].shape[0]
    print(f"LIOSession: {Tl} pushes, ATE-RMSE {s_ate:.4f} m, push p50 "
          f"{percentile_ms(llat[16:], 50):.3f} ms p99 {percentile_ms(llat[16:], 99):.3f} ms over "
          f"{len(llat) - 16} pushes, GPS accepted {n_gps}, K4 launches {k4.launches}; pair demand "
          f"mean {np.mean(demand):.1f} max {max(demand)} against a list of {capacity} "
          f"({sum(d > capacity for d in demand)} frames truncated) [{tag}]", flush=True)

    zero_counts(*kernels)
    n = LIO_CHUNK_FRAMES
    _, cout = lio.run_lio_chunk(lstate0, *[a[:n] for a in larrays], lcfg, scan_tau=ltau[:n])
    cest = cout.world_T_body.cpu().numpy()
    record("lio_chunk")
    c_ate = check_lio("run_lio_chunk", cest, cout.n_correspondences.cpu().numpy(), k4.launches, n)
    gap = float(np.abs(cest - lest[:n]).max())
    print(f"run_lio_chunk: {n} frames, ATE-RMSE {c_ate:.4f} m, refreshed at "
          f"{torch.nonzero(cout.refreshed).flatten().tolist()}, max |pose| diff to the session "
          f"{gap:.3e}, K4 launches {k4.launches} [{tag}]", flush=True)
    if not gap <= 1e-5:
        fail(f"LIOSession and run_lio_chunk differ by {gap} > 1e-5")

    # the split registration, the single-shard form of a map-sharded one:
    # association (K5), then GN on its winners (K6), against the whole K4
    zero_counts(*kernels)
    worst = 0.0
    for k in range(LIO_SPLIT_FRAMES):
        prior_k = nudge(up(lposes[k + 1]), 0.05, -0.03, 0.3)
        args = (larrays[0][k], larrays[1][k], lstate0.anchor_cache, prior_k, lcfg.p2p)
        d2_k, qn_k = p2p.associate_p2p_fused(*args)
        split = p2p.p2p_gn_from_correspondences(
            args[0], args[1], d2_k, qn_k, prior_k, lstate0.anchor_cache.center, lcfg.p2p)
        whole = p2p.point_to_plane_align_fused(*args)
        worst = max(worst, (split.transformation - whole.transformation).abs().max().item())
        if int(split.n_correspondences) != int(whole.n_correspondences):
            fail(f"split registration frame {k}: n_corr {int(split.n_correspondences)} vs "
                 f"{int(whole.n_correspondences)}")
    record("lio_split")
    print(f"split registration over {LIO_SPLIT_FRAMES} frames: max |T| diff to K4 {worst:.3e}; "
          f"launches K5 {p2p._p2p_associate.launches}, K6 {p2p._p2p_gn_corr.launches}, K4 "
          f"{k4.launches} [{tag}]", flush=True)
    if worst != 0.0:
        fail(f"split registration differs from K4 by {worst}")
    if p2p._p2p_associate.launches != LIO_SPLIT_FRAMES or p2p._p2p_gn_corr.launches != LIO_SPLIT_FRAMES:
        fail("split registration: K5 / K6 did not launch once a frame")

    # the map-sharded registration (parallel/map_shard.sp_p2p_align: K5 a
    # shard, the first argmin over shards, K6 once) over the steady-state
    # anchor map of phase 2 (the ring after 32 frames, split into 1 and 4
    # Morton-contiguous shards), frames 33-40 from nudged priors, against K4
    # with fixed correspondences on the whole map; the pair lists hold every
    # tile pair, so both see every admissible target tile
    sp_cfg = lcfg.p2p._replace(max_pairs_factor=lstate_w.anchor_cache.pages.shape[0])
    # the registration map is every anchor_subsample-th anchor point
    asub = lcfg.anchor_subsample
    keep = lstate_w.anchor_mask[::asub]
    a_pts, a_nrm, a_nv = (x[::asub][keep].cpu().numpy() for x in (
        lstate_w.anchor_points, lstate_w.anchor_normals, lstate_w.anchor_normals_valid))
    sp_frames = []
    for k in range(LIO_SPLIT_FRAMES):
        prior_k = nudge(up(lposes[w + k + 1]), 0.05, -0.03, 0.3)
        args = (larrays[0][w + k], larrays[1][w + k])
        sp_frames.append((args, prior_k, p2p.point_to_plane_align_fused(
            *args, lstate_w.anchor_cache, prior_k, sp_cfg)))
    p11["p2p"] = dict(
        source=sp_frames[0][0][0], source_mask=sp_frames[0][0][1], map_points=a_pts,
        map_normals=a_nrm, map_normals_valid=a_nv,
        center=lstate_w.anchor_cache.center.cpu().numpy(), initial_T=sp_frames[0][1],
        config=sp_cfg)
    sp = {}
    for n_sh in SP_SHARDS:
        target = map_shard.shard_p2p_target(
            a_pts, a_nrm, a_nv, n_sh, sp_cfg.tile_tgt,
            center=lstate_w.anchor_cache.center.cpu().numpy(), device=dev)
        zero_counts(*kernels)
        worst, n_corr = 0.0, []
        for args, prior_k, whole in sp_frames:
            got = map_shard.sp_p2p_align(*args, target, prior_k, sp_cfg)
            worst = max(worst, (got.transformation - whole.transformation).abs().max().item())
            n_corr.append(int(got.n_correspondences))
            if n_corr[-1] != int(whole.n_correspondences):
                fail(f"sp_p2p_align at {n_sh} shards: n_corr {n_corr[-1]} vs "
                     f"{int(whole.n_correspondences)} on the whole map")
        record(f"lio_sp{n_sh}")
        launched = (p2p._p2p_associate.launches, p2p._p2p_gn_corr.launches)
        if launched != (n_sh * LIO_SPLIT_FRAMES, LIO_SPLIT_FRAMES):
            fail(f"sp_p2p_align at {n_sh} shards: K5 / K6 launched {launched} times over "
                 f"{LIO_SPLIT_FRAMES} frames")
        if not worst <= SP_TOL:
            fail(f"sp_p2p_align at {n_sh} shards: T differs from K4 on the whole map by {worst}")
        if not min(n_corr) >= 1000:
            fail(f"sp_p2p_align at {n_sh} shards: a frame with under 1000 correspondences")

        def run_sp():
            for args, prior_k, _ in sp_frames:
                map_shard.sp_p2p_align(*args, target, prior_k, sp_cfg)

        dev_ms = device_ms_by_kernel(run_sp, 2, K5_KERNELS + K6_KERNELS)
        k5_frame = (None if dev_ms[K5_KERNELS[0]] is None
                    else (dev_ms[K5_KERNELS[0]] + dev_ms[K5_KERNELS[1]]) / LIO_SPLIT_FRAMES)
        k6_frame = (None if dev_ms[K6_KERNELS[0]] is None
                    else dev_ms[K6_KERNELS[0]] / LIO_SPLIT_FRAMES)
        frame_ms = time_ms(run_sp, 3) / LIO_SPLIT_FRAMES
        sp[n_sh] = {"k5_ms_a_frame": k5_frame, "k6_ms_a_frame": k6_frame, "ms_a_frame": frame_ms}
        print(f"sp_p2p_align at {n_sh} shards ({target.pages.shape[0]} target tiles of "
              f"{sp_cfg.tile_tgt}) over {LIO_SPLIT_FRAMES} frames: max |T| diff to K4 on the whole "
              f"map {worst:.3e}, n_corr {n_corr} equal; K5 {k5_frame} ms a frame ({n_sh} launches) "
              f"and K6 {k6_frame} ms a frame on the card alone, {frame_ms:.3f} ms a frame as "
              f"called [{tag}]", flush=True)
    print(f"phase 6 LIO path: {time.perf_counter() - t0:.1f} s; scans/s (pass 1) {lrate:.1f} "
          f"[{tag}]", flush=True)
    # ---- 7. the LIO path under the block loop: run_lio_superblocks twice
    # (one K7 launch a block), one block's split, then the fleet ----
    t0 = time.perf_counter()
    n_blk = -(-Tl // lcfg.refresh_every)
    zero_counts(*kernels)
    brate = 0.0
    for p in range(2):
        before = lio_superblock.launches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bfin, bout = lio.run_lio_superblocks(lstate0, *larrays, lcfg, scan_tau=ltau)
        t_issue = time.perf_counter() - t1
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launched = lio_superblock.launches - before
        est = bout.world_T_body.cpu().numpy()
        n_corr = bout.n_correspondences.cpu().numpy()
        if launched != n_blk or p2p._p2p_core.launches:
            fail(f"run_lio_superblocks pass {p}: K7 launched {launched} times for {n_blk} blocks, "
                 f"K4 {p2p._p2p_core.launches} times")
        if not (np.isfinite(est).all() and (n_corr > 0).all()
                and torch.isfinite(bout.rmse).all() and torch.isfinite(bfin.ekf_state.P).all()):
            fail(f"run_lio_superblocks pass {p}: non-finite output or a frame without correspondences")
        n_ovf = int(bout.pair_overflow.sum())
        if n_ovf:
            fail(f"run_lio_superblocks pass {p}: pair overflow on {n_ovf} frames")
        b_ate = ate_rmse(est, lgt[:Tl])
        if not b_ate < LIO_ATE_LIMIT:
            fail(f"run_lio_superblocks pass {p}: ATE-RMSE {b_ate} >= {LIO_ATE_LIMIT}")
        brate = Tl / dt
        dem = bout.pair_demand.cpu().numpy()
        print(f"LIO block loop pass {p}: {Tl} frames {dt:.3f} s = {brate:.1f} scans/s "
              f"({dt / n_blk * 1e3:.3f} ms a block of {lcfg.refresh_every}, host-issued "
              f"{t_issue / n_blk * 1e3:.3f} ms a block), ATE-RMSE {b_ate:.4f} m, n_corr mean "
              f"{n_corr.mean():.0f}, rmse mean {bout.rmse.mean().item():.4f} m, GPS accepted "
              f"{int(bout.gps_accepted.sum())} of {Tl}, slack violations "
              f"{int(bout.slack_violation.sum())}, slack dist max "
              f"{bout.slack_dist.max().item():.4f} m, pair demand mean {dem.mean():.1f} max "
              f"{dem.max()} of {k7_in[2].shape[1]} slots, overflow 0, K7 launches {launched} "
              f"[{tag}]", flush=True)
    record("lio_superblocks")

    # one block's split: its parts timed alone on the card, then the whole
    # block under the profiler (device busy, idle share, operations)
    R7 = lcfg.refresh_every
    blk7 = [a[w:w + R7] for a in larrays]
    anchor_w = lio._refresh_anchor(lstate_w.ring, lstate_w.ring_mask, lstate_w.ekf_state.p, lcfg)
    pro_args = (lstate_w, anchor_w[4], blk7[0], blk7[1], ltau[w:w + R7], blk7[2], blk7[3],
                blk7[4], torch.ones(R7, dtype=torch.bool, device=dev),
                (math.sqrt(lcfg.p2p.max_correspondence_dist_sq) + lcfg.p2p.reassoc_margin
                 + lcfg.slack_base + lcfg.superstep_slack
                 * torch.arange(R7, dtype=torch.float32, device=dev)) ** 2, lcfg)
    _, xi_w, *_ = lio._block_prologue(*pro_args)
    split = {
        "refresh": time_ms(lambda: lio._refresh_anchor(
            lstate_w.ring, lstate_w.ring_mask, lstate_w.ekf_state.p, lcfg), 3),
        "prologue": time_ms(lambda: lio._block_prologue(*pro_args), 3),
        "K7": k7_ms,
        "ring insert": time_ms(lambda: lio._ring_sample(
            blk7[0], blk7[1], ltau[w:w + R7], xi_w, lcfg), 3),
    }
    zero_counts(*kernels)
    busy7, wall7, on_dev = profiled_pass(
        lambda: lio.run_lio_superblocks(lstate_w, *blk7, lcfg, scan_tau=ltau[w:w + R7]))
    k7_prof = sum(e.self_device_time_total for e in on_dev if "lio_superblock_kernel" in e.key) / 1e3
    n_dev7 = sum(e.count for e in on_dev)
    block_ms = 1e3 * R7 / brate  # the second pass's, without the profiler
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
    if busy7 > 0:
        print(f"LIO block split (each part alone, CUDA events): {parts}; under the profiler: device "
              f"busy {busy7:.3f} ms of the profiled block's own {wall7:.3f} ms (idle "
              f"{idle_share(busy7, wall7)}), K7 {k7_prof:.3f} ms; {n_dev7} device operations a "
              f"block; {block_ms:.3f} ms a block in the second pass without the profiler [{tag}]",
              flush=True)
    else:
        print(f"LIO block split: {parts}; the profiler recorded no device time (not measured) "
              f"[{tag}]", flush=True)

    # the fleet: 2 robots (the second without GPS) over 33 frames, each
    # against its own run
    nf = FLEET_FRAMES
    robots = [[a[:nf] for a in larrays]]
    robots.append(robots[0][:7] + [torch.zeros_like(robots[0][7])])
    states = lio_fleet.fleet_init(lcfg, np.stack([lsp[0]] * FLEET_ROBOTS),
                                  np.stack([lsm[0]] * FLEET_ROBOTS),
                                  np.stack([lposes[0]] * FLEET_ROBOTS), device=dev)
    states = states._replace(ekf_state=states.ekf_state._replace(
        v=torch.stack([up(lv0)] * FLEET_ROBOTS)))
    zero_counts(*kernels)
    ffin, fout = lio_fleet.fleet_run_lio_superblocks(
        states, *[torch.stack(xs) for xs in zip(*robots)], lcfg)
    torch.cuda.synchronize()
    record("lio_fleet")
    p11.update(lcfg=lcfg, lio_states=states, lio_robots=robots, lio_fleet=(ffin, fout),
               lio_gt=lgt[:nf])
    f_launched = lio_superblock.launches
    f_blocks = -(-nf // lcfg.refresh_every)
    for b, frames in enumerate(robots):
        sfin, sout = lio.run_lio_superblocks(lstate0, *frames, lcfg)
        if not (torch.equal(fout.world_T_body[b], sout.world_T_body)
                and torch.equal(ffin.ekf_state.P[b], sfin.ekf_state.P)
                and torch.equal(ffin.ring[b], sfin.ring)):
            fail(f"fleet robot {b} differs from its own run by "
                 f"{(fout.world_T_body[b] - sout.world_T_body).abs().max().item()}")
    f_ate = [ate_rmse(fout.world_T_body[b].cpu().numpy(), lgt[:nf]) for b in range(FLEET_ROBOTS)]
    print(f"fleet_run_lio_superblocks: {FLEET_ROBOTS} robots x {nf} frames, each equal to its own "
          f"run, ATE-RMSE {', '.join(f'{a:.4f}' for a in f_ate)} m, GPS accepted "
          f"{fout.gps_accepted.sum(dim=1).tolist()}, K7 launches {f_launched} "
          f"[{tag}]", flush=True)
    if f_launched != FLEET_ROBOTS * f_blocks:
        fail(f"fleet: K7 launched {f_launched} times, expected {FLEET_ROBOTS * f_blocks}")
    print(f"phase 7 LIO block loop: {time.perf_counter() - t0:.1f} s; scans/s (pass 1) {brate:.1f} "
          f"[{tag}]", flush=True)

    # ---- 8. the superblock main path at the JAX package's tile shapes:
    # run_chunk_fast twice from each startup state of phase 2 (one K1
    # launch a superblock, 64 x 256 and 16 x 4096 source tiles) ----
    t0 = time.perf_counter()
    for label, w in wide.items():
        wcfg, wseq, n = w["cfg"], w["seq"], TILES_FRAMES
        gt = wseq.true_map_T_sensor[1:n]
        n_blocks = (n - 1) // K
        zero_counts(*kernels)
        wrate = 0.0
        for p in range(2):
            before = superblock_fine.launches
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, out = pf.run_chunk_fast(w["state"], w["frames"], w["loc"].map_cloud, wcfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            launched = superblock_fine.launches - before
            est = out.map_T_sensor.cpu().numpy()
            ate = ate_rmse(est, gt)
            n_ovf = int(out.pair_overflow.sum())
            n_slack = int(out.slack_violation.sum())
            wrate = (n - 1) / dt
            print(f"tiles {label} pass {p}: {n - 1} frames {dt:.3f} s = {wrate:.1f} scans/s, ATE-RMSE "
                  f"{ate:.4f} m, icp-converged {out.icp_converged.float().mean().item():.3f}, "
                  f"pair-overflow frames {n_ovf}, slack-violations {n_slack}, K1 launches {launched}, "
                  f"pair demand mean {out.pair_demand.float().mean().item():.1f} max "
                  f"{int(out.pair_demand.max())} [{tag}]", flush=True)
            if launched != n_blocks:
                fail(f"tiles {label}: K1 launched {launched} times for {n_blocks} superblocks")
            if n_ovf or n_slack:
                fail(f"tiles {label}: pair overflow on {n_ovf} frames, slack violated on {n_slack}")
            if not np.isfinite(est).all():
                fail(f"tiles {label}: non-finite pose")
            if not ate < ATE_LIMIT:
                fail(f"tiles {label}: ATE-RMSE {ate} >= {ATE_LIMIT}")
        record(f"tiles_{label}")
        w["rate"] = wrate
        w["k1_steady_ms"] = profile_pass(
            lambda: pf.run_chunk_fast(w["state"], w["frames"], w["loc"].map_cloud, wcfg), pf,
            n_blocks, f"tiles {label}; {tag}")
    print(f"phase 8 the JAX package's tile shapes: {time.perf_counter() - t0:.1f} s; scans/s (pass 1) "
          + ", ".join(f"{k} {w['rate']:.1f}" for k, w in wide.items()) + f" [{tag}]", flush=True)

    # ---- 9. mapping: bench.py bench_map's loop at its widths (both device
    # stores, 16 groups of 8 skewed scans), the segment-sum kernel against
    # its plain version, then record / save / load / localize ----
    t0 = time.perf_counter()
    dims = dict(voxel_size=MAP_VOXEL, dim_xy=1024, dim_z=128)
    scfg = SortedVoxelMapConfig(capacity=1 << 18, unique_capacity=map_uniq, **dims)
    hcfg = VoxelMapConfig(table_size=1 << 21, max_probes=8,
                          straggler_capacity=max(1024, MAP_GROUP * 512), unique_capacity=map_uniq,
                          **dims)
    stores = {
        "sorted": (sorted_voxel_map_init, sorted_voxel_map_insert, scfg),
        "hash": (voxel_map_init, voxel_map_insert, hcfg),
    }
    finals, map_ms = {}, {}
    for label, (init, insert, cfg) in stores.items():
        zero_counts(*kernels)
        rate = 0.0
        for p in range(2):
            flushes = []
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st = map_pass(insert, cfg, init(cfg, MAP_ORIGIN, dev), map_groups, flushes)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            rate = MAP_FRAMES / dt
            flush_ms = float(np.mean([a.elapsed_time(b) for a, b in flushes]))
            dropped, oob, cells = torch.stack([st.n_dropped, st.n_oob, st.n_cells()]).tolist()
            print(f"mapping {label} pass {p}: {MAP_FRAMES} frames {dt:.3f} s = {rate:.1f} frames/s, "
                  f"{flush_ms:.3f} ms an insert of {MAP_GROUP * MAP_SCAN_CAP} points (CUDA events, "
                  f"mean of {len(flushes)}), {cells} cells, dropped {dropped}, oob {oob} [{tag}]",
                  flush=True)
            if dropped or oob:
                fail(f"mapping {label}: dropped {dropped}, oob {oob}")
        record(f"map_{label}")
        if launches[segment_sum_sorted][f"map_{label}"] != len(flushes) * 2:
            fail(f"mapping {label}: voxel_segment_sum launched "
                 f"{launches[segment_sum_sorted][f'map_{label}']} times for {2 * len(flushes)} inserts")
        # one more pass under the profiler: the device's busy and idle share
        # of that pass's own wall time
        busy, pass_ms, on_dev = profiled_pass(
            lambda: map_pass(insert, cfg, init(cfg, MAP_ORIGIN, dev), map_groups))
        seg_dev = sum(e.self_device_time_total for e in on_dev
                      if "segment_sum_sorted_kernel" in e.key) / 1e3
        idle = idle_share(busy, pass_ms)
        print(f"mapping {label} profile, one pass: device busy {busy:.3f} ms of the profiled "
              f"pass's own {pass_ms:.3f} ms (idle {idle}), voxel_segment_sum {seg_dev:.3f} ms, "
              f"{sum(e.count for e in on_dev)} device operations [{tag}]", flush=True)
        finals[label] = st
        map_ms[label] = dict(frames_s=rate, flush_ms=flush_ms, idle=idle)
    got_s = sorted_voxel_map_centroids_numpy(finals["sorted"])
    got_h = voxel_map_centroids_numpy(finals["hash"])
    if not np.array_equal(got_s, got_h):
        fail(f"mapping: sorted and hash centroids differ ({got_s.shape} vs {got_h.shape})")
    # the sorted store on the card and on the CPU, fed the same deskewed
    # world points (computed on the card), so only the store is compared
    worlds = [group_world(map_groups, g) for g in range(n_map_groups)]
    masks = map_groups[1].reshape(len(worlds), -1)
    p11.update(map_worlds=worlds, map_masks=masks, hash_config=hcfg)
    p12.update(group=(worlds[0], masks[0]),
               scan=(worlds[0][:MAP_SCAN_CAP], masks[0][:MAP_SCAN_CAP]))
    t1 = time.perf_counter()
    cst = sorted_voxel_map_init(scfg, MAP_ORIGIN, "cpu")
    gst = sorted_voxel_map_init(scfg, MAP_ORIGIN, dev)
    for w, m in zip(worlds, masks):
        gst = sorted_voxel_map_insert(gst, w, m, scfg)
        cst = sorted_voxel_map_insert(cst, w.cpu(), m.cpu(), scfg)
    cpu_s = time.perf_counter() - t1
    for f in ("keys", "moments", "n_dropped", "n_oob"):
        if not torch.equal(getattr(gst, f).cpu(), getattr(cst, f)):
            fail(f"mapping: the card's sorted store differs from the CPU run in {f}")
    print(f"mapping: sorted == hash centroids bit for bit ({got_s.shape[0]} cells); the card's "
          f"sorted state == the CPU run bit for bit (CPU {cpu_s:.1f} s)", flush=True)

    # the segment-sum kernel on the first real group and on a tie-heavy one
    _, _, _, payload, seg_c, _ = _group_rows(
        worlds[0], masks[0], torch.tensor(MAP_ORIGIN, device=dev), scfg)
    seg_case = {"group": (payload, seg_c, min(scfg.unique_capacity, payload.shape[0])),
                "ties": tie_heavy_group(payload.shape[0], dev)}
    segsum = {}
    for label, (vals, seg, U) in seg_case.items():
        c = segsum[label] = check_segsum(vals, seg, U)
        print(f"voxel_segment_sum {label} ({vals.shape[0]} rows, {U} segments, "
              f"longest run {int(torch.bincount(seg.long()).max())}): bits equal the plain "
              f"version; {c['ms']:.4f} ms by events, {c['device_ms']} ms on the card alone, plain "
              f"{c['plain_ms']:.3f} ms, bound {c['bound'][0]:.5f} ms ({c['bound'][1]}); index_add_ "
              f"{c['lib_ms']:.4f} ms by events, {c['lib_device_ms']} ms on the card alone, "
              f"{c['lib_diff']} of {U * 4} elements differ from the kernel [{tag}]", flush=True)

    # record phase 3's map tiles with StreamingMapper (sorted store, the
    # card), save, load, and localize on the loaded map
    t1 = time.perf_counter()
    zero_counts(*kernels)
    vox = MappingConfig().map_voxel_size
    allp = np.concatenate(tiles)
    lo = allp.min(axis=0)
    ext = np.floor((allp.max(axis=0).astype(np.float64) - lo) / vox) + 2
    rec_uniq, rec_worst = dedup_capacity(tiles, lo, vox,
                                         RECORD_GROUP * RAW_POINTS)
    rcfg = SortedVoxelMapConfig(
        voxel_size=vox,
        capacity=1 << int(np.ceil(np.log2(1.25 * map_data.map_points.shape[0]))),
        unique_capacity=rec_uniq, dim_xy=int(ext[:2].max()), dim_z=int(ext[2]),
    )
    mapper = StreamingMapper(MappingConfig(), device_origin=lo, device_config=rcfg,
                             device_scan_capacity=RAW_POINTS, device_group=RECORD_GROUP, device=dev)
    empty = np.zeros((0, 3), np.float32)
    for i in range(N_FRAMES):
        mapper.add_frame(tiles[i // 4] if i % 4 == 0 else empty, odom_pos[i], *gps_rows[i])
    recorded = mapper.finalize(use_device=True)
    t_record = time.perf_counter() - t1
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map_data")
        mapdata.save_map_data(path, mapper.tiles, np.stack(mapper.odom_positions),
                              np.stack(mapper.gps_rows))
        native.write_pcd(os.path.join(path, "map.pcd"), recorded.map_points)
        np.save(os.path.join(path, "map_T_global.npy"), recorded.map_T_global)
        loaded = mapdata.load_map_data(path)
    if not (np.array_equal(loaded.map_points, recorded.map_points)
            and np.array_equal(loaded.map_T_global, recorded.map_T_global)):
        fail("record: the loaded map differs from the finalized one")
    host_cells = np.floor((map_data.map_points.astype(np.float64) - lo) / vox)
    dev_cells = np.floor((recorded.map_points.astype(np.float64) - lo) / vox)
    n_moved = len(set(map(tuple, host_cells.astype(np.int64))) ^ set(map(tuple, dev_cells.astype(np.int64))))
    print(f"record: {N_FRAMES} frames ({len(tiles)} tiles) through StreamingMapper, {rcfg.capacity} "
          f"cells of capacity, unique {rec_uniq} (worst tile {rec_worst}), {recorded.map_points.shape[0]} "
          f"map points against the host merge's {map_data.map_points.shape[0]}, {n_moved} cells in "
          f"one map and not the other (f32 against f64 binning); saved and loaded equal; altitude "
          f"table max diff {np.abs(loaded.altitude_table - recorded.altitude_table).max():.2e} "
          f"(8-decimal text log)", flush=True)
    rloc = lz.Localizer(loaded, config, dev)
    r_gps = rloc.gps_poses(seq.gps_lat, seq.gps_lon, seq.compass_yaw)
    rstate, rcscan, rcoarse = startup(rloc, seq, r_gps, config, dev)
    if not bool(rcoarse.success):
        fail("record: coarse alignment failed on the loaded map")
    rbf_map, rbf_scan = lz.brute_force_clouds(rcscan, rstate.cropped_map, rstate.map_T_ref, config)
    rres = icp_align(rbf_scan.points, rbf_scan.mask, rbf_map.points, rbf_map.mask,
                     rescue_start(rcoarse.map_T_sensor), config.rescue_icp)
    if not bool(rres.has_converged):
        fail("record: forced rescue ICP did not converge on the loaded map")
    n = RECORD_FRAMES
    rframes = pf.build_paged_frames(
        config, seq.scans[1:n], seq.odom_T_sensor[1:n], r_gps[1:n], seq.odom_cov_trace[1:n],
        seq.gps_cov_trace[1:n], np.ones(n - 1, bool), dev,
    )
    _, rout = pf.run_chunk_fast(rstate, rframes, rloc.map_cloud, config)
    rest = rout.map_T_sensor.cpu().numpy()
    r_ate = ate_rmse(rest, seq.true_map_T_sensor[1:n])
    r_ovf, r_slack = int(rout.pair_overflow.sum()), int(rout.slack_violation.sum())
    record("record_localize")
    print(f"record: localized {n - 1} frames on the loaded map: ATE-RMSE {r_ate:.4f} m (phase 3 "
          f"on the host merge, the same frames: {ate3_head:.4f} m), pair-overflow frames {r_ovf}, "
          f"slack-violations {r_slack}, K1 launches {launches[superblock_fine]['record_localize']}, "
          f"voxel_segment_sum launches {launches[segment_sum_sorted]['record_localize']} [{tag}]",
          flush=True)
    if r_ovf or r_slack:
        fail(f"record: pair overflow on {r_ovf} frames, slack violated on {r_slack}")
    if not (np.isfinite(rest).all() and r_ate < ATE_LIMIT):
        fail(f"record: ATE-RMSE {r_ate} >= {ATE_LIMIT} on the loaded map")
    print(f"phase 9 mapping: {time.perf_counter() - t0:.1f} s (record and save {t_record:.1f} s of it); "
          f"frames/s (pass 1) sorted {map_ms['sorted']['frames_s']:.1f}, hash "
          f"{map_ms['hash']['frames_s']:.1f}; ms an insert sorted {map_ms['sorted']['flush_ms']:.3f}, "
          f"hash {map_ms['hash']['flush_ms']:.3f} [{tag}]", flush=True)

    # ---- 10. the product's entry points: selftest, CLI, the KITTI-format
    # path at seq-00 density (localization, LIO, map store), debug branch ----
    p10 = phase10(dev, tag, name, kernels, record, launches)

    # ---- 11. the multi-device layer: fleets, sharded brute force, ICP,
    # steady state and voxel store, LIO fleets over a mesh, the distributed
    # form, the dry run ----
    r11 = phase11(dev, tag, kernels, record, p11)

    # ---- 12. the public helpers: gated_nn_pallas (K2), voxel_downsample
    # (voxel_segment_sum), masked_points, to_numpy, rotation, translation,
    # svd3x3 ----
    r12 = phase12(dev, tag, kernels, record, launches, p12)

    # ---- 13. bench_kitti's own LIO settings at source tiles of 512, 2048
    # and 4096 rows on its fixture and at seq-00 density; K4-K7 against
    # their plain versions past 1024 rows ----
    r13 = phase13(dev, tag, name, kernels, record, p10.pop("kseq"))

    # ---- 14. the LIO cell normals' prefix sum in XLA's order (cumsum_rows)
    # against its plain version, the card's normals against the CPU's ----
    r14 = phase14(dev, tag, (lstate_w.anchor_points, lstate_w.anchor_mask), r13)

    # ---- 15. XLA's float32 elementwise math (xla_math) against its plain
    # version, its launches along the LIO paths, phase 7's first block on
    # the card and on the CPU ----
    R15 = lcfg.refresh_every
    r15 = phase15(dev, tag, launches[xla_math], xla_by,
                  (lstate0, [a[:R15] for a in larrays], ltau[:R15], lcfg),
                  (lstate_w.anchor_points, lstate_w.anchor_mask))

    # ---- 16. the LIO's default configuration: voxel normals (moments in
    # row order on the segment sum), registration on K2 and on the dense
    # sweep, the tiled normals, LIOSession and the fleet on LIOConfig(),
    # the block loop with voxel normals ----
    r16 = phase16(dev, tag, name, kernels, record, dict(
        lcfg=lcfg, sp=lsp, sm=lsm, poses=lposes, v0=lv0, arrays=larrays, tau=ltau, gt=lgt,
        taus=ltp, imu_gps=(lgyro, laccel, ldts, lgps, gps_var), state7=lstate_w, scan=lscan,
        mask=larrays[1][LIO_WARM_FRAMES], prior=lprior))

    # ---- 17. xla_math a kernel a function (three launch paths), the
    # ordered scan in one launch, the LIO kernels' digests ----
    r17 = phase17(dev, tag, r14, r15)

    # ---- 18. the CPU's LAPACK (jaxlib's, through scipy) and the LIO parity
    # repairs leave the card as it was: launches, digests, no scipy on the
    # card; the changed xla_math composites; torch.linalg's host syncs ----
    r18 = phase18(dev, tag, launches[xla_math], lapack_calls, r16, dict(
        state=lstate_w, arrays=[a[LIO_WARM_FRAMES:] for a in larrays],
        tau=ltau[LIO_WARM_FRAMES:], lcfg=lcfg,
        vcfg=lcfg._replace(normal_est="voxel", p2p=lcfg.p2p._replace(nn_backend="pallas"))))

    for kernel in kernels:
        if not sum(launches[kernel].values()):
            fail(f"{kernel.__name__} never launched on a main path")
    # every LIO path refreshes its anchor, each refresh one scan
    lio_paths = [p for p in launches[cumsum_rows] if p.startswith(("lio", "kitti_lio"))
                 and p not in ("lio_split", "lio_sp1", "lio_sp4")]
    idle = [p for p in lio_paths if not launches[cumsum_rows][p]]
    print(f"cumsum_rows launches by LIO path: { {p: launches[cumsum_rows][p] for p in lio_paths} } "
          f"[{tag}]", flush=True)
    if idle:
        fail(f"cumsum_rows never launched on the LIO paths {idle}")
    print(f"total {time.perf_counter() - t_start:.1f} s [{tag}]", flush=True)

    x = wide["16x4096"]
    wide13 = r13["wide"]

    def wide_fields(kernel, suffix=""):
        """A kernel's times at phase 13's wide tiles (seq-00 density)."""
        tail = f"_{suffix}" if suffix else ""
        return {f"{key}{tail}_{W}": (v[f"{kernel} {src}"] if key != "bound_ms"
                                     else v[f"{kernel} bound"][0])
                for W, v in wide13.items()
                for key, src in [("ms", "ms"), ("plain_ms", "plain ms"), ("bound_ms", "")]}

    def row(kernel, label, source, replaces, err, ms, plain_ms, bnd, **extra):
        by_path = {p: c for p, c in launches[kernel].items() if c}
        return {"name": label, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        row(superblock_fine, "K1 superblock_fine",
            "slam_sensor_fusion_tpu_torch/csrc/superblock_fused.cu",
            "slam_sensor_fusion_tpu/ops/superblock_fused.py:105",
            max([k1_err, p10["k1_err"]] + [w["k1_err"] for w in wide.values()]), k1_ms,
            k1_plain_ms, k1_bound, ms_steady_superblock=k1_steady_ms, grid=grids["K1"],
            ms_kitti=p10["k1_ms"], plain_ms_kitti=p10["k1_plain_ms"],
            bound_ms_kitti=p10["k1_bound"][0], scratch_bytes_kitti=p10["kitti_scratch"]["K1"],
            tiles_kitti=p10["kitti_tiles"], kitti_scans_s=p10["kitti_scans_s"],
            kitti_idle=p10["kitti_idle"], fleet_scans_s=r11["fleet_scans_s"],
            **{f"{key}_{label}": val for label, w in wide.items() for key, val in [
                ("ms", w["k1_ms"]), ("plain_ms", w["k1_plain_ms"]),
                ("bound_ms", w["k1_bound"][0]), ("ms_steady_superblock", w["k1_steady_ms"]),
                ("scratch_mib", w["scratch_mib"]), ("prologue_ms", w["prologue_ms"]),
                ("grid", grids[f"K1 {label}"])]}),
        row(pair_nn, "K2 pair_nn", "slam_sensor_fusion_tpu_torch/csrc/nn_pallas.cu",
            "slam_sensor_fusion_tpu/ops/nn_pallas.py:105",
            max([k2_err, x["k2_err"]] + [c["err"] for c in r16["k2"].values()]), k2_ms,
            k2_plain_ms, k2_bound, ms_16x4096=x["k2_ms"],
            **{f"{key}_lio_{label}": (c[key] if key != "bound_ms" else c["bound"][0])
               for label, c in r16["k2"].items()
               for key in ("ms", "device_ms", "plain_ms", "bound_ms", "demand", "slots")},
            k2_ms_a_frame_lio=r16["runs"]["blocks_pallas"]["profile"]["k2_ms_a_frame"], plain_ms_16x4096=x["k2_plain_ms"],
            bound_ms_16x4096=x["k2_bound"][0], device_ms=k2_device_ms,
            device_ms_16x4096=x["k2_device_ms"], grid=grids["K2 scan"],
            scratch_bytes_kitti=p10["kitti_scratch"]["K2"],
            grid_16x4096=grids["K2 scan 16x4096"], sp_scans_s=r11["sp_scans_s"],
            sp_launches_a_frame=r11["sp_k2_a_frame"], ms_gated_nn_pallas=r12["gnn_ms"],
            plain_ms_gated_nn_pallas=r12["gnn_plain_ms"],
            bound_ms_gated_nn_pallas=r12["gnn_bound"][0],
            device_ms_gated_nn_pallas=r12["gnn_device_ms"]),
        row(_fused_core, "K3 icp_fused", "slam_sensor_fusion_tpu_torch/csrc/icp_fused.cu",
            "slam_sensor_fusion_tpu/ops/icp_fused.py:131",
            max(k3_err, k3l_err, x["k3_fresh_err"], x["k3_lazy_err"]), k3_ms, k3_plain_ms, k3_bound,
            ms_lazy=k3l_ms, plain_ms_lazy=k3l_plain_ms, bound_ms_lazy=k3l_bound[0], grid=grids["K3"],
            **{f"{key}_4x4096_{v}": x[f"k3_{v}_{src}"] if key != "bound_ms" else x[f"k3_{v}_bound"][0]
               for v in ("fresh", "lazy")
               for key, src in [("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound")]},
            grid_4x4096=grids["K3 4x4096"]),
        row(p2p._p2p_core, "K4 p2p_fused", "slam_sensor_fusion_tpu_torch/csrc/p2p_fused.cu",
            "slam_sensor_fusion_tpu/ops/p2p_fused.py:210",
            max([k4_err, k4f_err] + [v[k] for v in wide13.values() for k in ("K4 err", "K4 fresh err")]),
            k4_ms, k4_plain_ms, k4_bound, ms_fresh=k4f_ms, plain_ms_fresh=k4f_plain_ms,
            bound_ms_fresh=k4f_bound[0], grid=grids["K4"], **wide_fields("K4", "fixed"),
            **wide_fields("K4 fresh", "fresh"),
            **{f"grid_{W}": v["K4 grid"] for W, v in wide13.items()}),
        row(p2p._p2p_associate, "K5 p2p_associate",
            "slam_sensor_fusion_tpu_torch/csrc/p2p_fused.cu",
            "slam_sensor_fusion_tpu/ops/p2p_fused.py:510",
            max([k5_err] + [v["K5 err"] for v in wide13.values()]), k5_ms, k5_plain_ms, k5_bound,
            device_ms=k5_device_ms, device_ms_scan=k5_split[K5_KERNELS[0]],
            device_ms_combine=k5_split[K5_KERNELS[1]], grid=grids["K5 scan"],
            **{f"sp{n}_device_ms_a_frame": v["k5_ms_a_frame"] for n, v in sp.items()},
            **wide_fields("K5")),
        row(p2p._p2p_gn_corr, "K6 p2p_gn_corr", "slam_sensor_fusion_tpu_torch/csrc/p2p_fused.cu",
            "slam_sensor_fusion_tpu/ops/p2p_fused.py:536",
            max([k6_err] + [v["K6 err"] for v in wide13.values()]), k6_ms, k6_plain_ms, k6_bound,
            device_ms=k6_device_ms, cluster=k6_cluster,
            **{f"sp{n}_device_ms_a_frame": v["k6_ms_a_frame"] for n, v in sp.items()},
            **{f"sp{n}_ms_a_frame": v["ms_a_frame"] for n, v in sp.items()},
            **wide_fields("K6"), **{f"device_ms_{W}": v["K6 device ms"] for W, v in wide13.items()},
            **{f"graph_ms_{W}": v["K6 graph ms"] for W, v in wide13.items()},
            **{f"cluster_{W}": v["K6 cluster"] for W, v in wide13.items()}),
        row(lio_superblock, "K7 lio_superblock",
            "slam_sensor_fusion_tpu_torch/csrc/lio_superblock_fused.cu",
            "slam_sensor_fusion_tpu/ops/lio_superblock_fused.py:196",
            max([k7_err] + [v["K7 err"] for v in wide13.values()]), k7_ms, k7_plain_ms,
            k7_bound, grid=grids["K7"], kitti_lio_scans_s=p10["lio_scans_s"],
            **{f"{key}_bench_kitti_{run}": v[src] for run, v in r13["runs"].items()
               for key, src in [("ms_a_block", "k7_ms"), ("scans_s", "scans_s"), ("ate", "ate"),
                                ("idle", "idle"), ("grid", "grid")]},
            **{f"bound_ms_bench_kitti_{run}": v["k7_bound"][0] for run, v in r13["runs"].items()},
            **{f"{key}_2_frames_{W}": v[src] for W, v in wide13.items()
               for key, src in [("ms", "K7 2-frame ms"), ("plain_ms", "K7 2-frame plain ms")]},
            trajectory_gaps_a=r13["gaps_a"], trajectory_gaps_b=r13["gaps_b"]),
        row(segment_sum_sorted, "voxel_segment_sum",
            "slam_sensor_fusion_tpu_torch/csrc/voxel_segsum.cu",
            "none: XLA scatter-add, slam_sensor_fusion_tpu/ops/voxel_map_sorted.py:178 and "
            "ops/voxel_map.py:203",
            max([v["err"] for v in segsum.values()] + [r13["segsum"]["err"], r16["segsum"]["err"]]),
            segsum["group"]["ms"], segsum["group"]["plain_ms"], segsum["group"]["bound"],
            library_ms=segsum["group"]["lib_ms"], device_ms=segsum["group"]["device_ms"],
            library_device_ms=segsum["group"]["lib_device_ms"],
            library_diff_elements=segsum["group"]["lib_diff"],
            **{f"{key}_ties": segsum["ties"][src] for key, src in [
                ("ms", "ms"), ("device_ms", "device_ms"), ("plain_ms", "plain_ms"),
                ("library_ms", "lib_ms"), ("library_device_ms", "lib_device_ms"),
                ("library_diff_elements", "lib_diff")]},
            bound_ms_ties=segsum["ties"]["bound"][0],
            map_frames_s={k: v["frames_s"] for k, v in map_ms.items()},
            map_ms_an_insert={k: v["flush_ms"] for k, v in map_ms.items()},
            map_idle={k: v["idle"] for k, v in map_ms.items()},
            sp_map_frames_s=r11["sp_map_frames_s"], ms_voxel_downsample=r12["vox_ms"],
            plain_ms_voxel_downsample=r12["vox_plain_ms"],
            bound_ms_voxel_downsample=r12["vox_bound"][0],
            device_ms_voxel_downsample=r12["vox_device_ms"],
            **{f"{key}_seq00_group": r13["segsum"][src] for key, src in [
                ("ms", "ms"), ("device_ms", "device_ms"), ("plain_ms", "plain_ms"),
                ("library_ms", "lib_ms"), ("library_device_ms", "lib_device_ms")]},
            bound_ms_seq00_group=r13["segsum"]["bound"][0],
            **{f"{key}_voxel_normals": r16["segsum"][src] for key, src in [
                ("ms", "ms"), ("device_ms", "device_ms"), ("plain_ms", "plain_ms"),
                ("library_ms", "lib_ms"), ("library_device_ms", "lib_device_ms"),
                ("library_diff_elements", "lib_diff")]},
            bound_ms_voxel_normals=r16["segsum"]["bound"][0],
            eigh_ms_voxel_normals=r16["eigh_ms"], eigh_device_ms_voxel_normals=r16["eigh_device_ms"],
            refresh_ms=r16["refresh_ms"], host_syncs_a_refresh=r16["syncs"]),
        row(cumsum_rows, "cumsum_rows", "slam_sensor_fusion_tpu_torch/csrc/ordered_scan.cu",
            "none: XLA's reduce-window cumsum, slam_sensor_fusion_tpu/ops/point_to_plane.py:333",
            r14["err"], r14["times"]["anchor"]["ms"], r14["times"]["anchor"]["plain_ms"],
            r14["times"]["anchor"]["bound"], library_ms=r14["times"]["anchor"]["lib_ms"],
            device_ms=r14["times"]["anchor"]["device_ms"], graph_ms=r14["times"]["anchor"]["graph_ms"],
            library_device_ms=r14["times"]["anchor"]["lib_device_ms"], rows=r14["rows"],
            normals_gap_card_cpu=r14["normals_gap"], kernel_launches_a_call=r17["scan_launches"],
            ptxas=[ln for ln in r17["ptxas"] if ln.startswith("cumsum_rows")],
            **{f"{key}_{what}": (c[src] if key != "bound_ms" else c["bound"][0])
               for what, c in r14["times"].items() if what != "anchor"
               for key, src in [("ms", "ms"), ("device_ms", "device_ms"), ("graph_ms", "graph_ms"),
                                ("plain_ms", "plain_ms"), ("bound_ms", ""), ("library_ms", "lib_ms"),
                                ("library_device_ms", "lib_device_ms")]}),
        row(xla_math, "xla_math", "slam_sensor_fusion_tpu_torch/csrc/xla_math.cu",
            "none: XLA's sin / cos (glibc sinf / cosf), atan2 (glibc atan2f) and arccos "
            "rewrite, slam_sensor_fusion_tpu/ops/geometry.py:180-210",
            0.0 if all(r15["bits_equal"].values()) else None,
            r15["times"]["sincos 8192"]["ms"], r15["times"]["sincos 8192"]["plain_ms"],
            r15["times"]["sincos 8192"]["bound"],
            library_ms=r15["times"]["sincos 8192"]["lib_ms"],
            device_ms=r15["times"]["sincos 8192"]["device_ms"],
            graph_ms=r15["times"]["sincos 8192"]["graph_ms"],
            library_device_ms=r15["times"]["sincos 8192"]["lib_device_ms"],
            card_cpu_first_block_gap=r15["card_cpu_gap"],
            launch_paths={k: dict(bits_differ=v["bad"], kernel_launches=v["launches"])
                          for k, v in r17["paths"].items()},
            ptxas=[ln for ln in r17["ptxas"] if ln.startswith("xla_math")],
            lio_kernel_digests_equal=r17["digests_equal"],
            launches_by_path_and_function={p: by for p, by in r15["launches_by"].items() if by},
            lio_shapes={name: dict(bits_differ=c["bad"], ms=c["ms"], device_ms=c["device_ms"],
                                   graph_ms=c["graph_ms"], plain_ms=c["plain_ms"],
                                   bound_ms=c["bound"][0], library_ms=c["lib_ms"])
                        for name, c in r15["cases"].items()},
            **{f"{key}_{what.replace(' ', '_')}": (c[src] if key != "bound_ms" else c["bound"][0])
               for what, c in r15["times"].items() if what != "sincos 8192"
               for key, src in [("ms", "ms"), ("device_ms", "device_ms"), ("graph_ms", "graph_ms"),
                                ("plain_ms", "plain_ms"), ("bound_ms", ""),
                                ("library_ms", "lib_ms"), ("library_device_ms", "lib_device_ms"),
                                ("library_graph_ms", "lib_graph_ms")]}),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

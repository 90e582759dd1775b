"""The PyTorch port's mapping product against the JAX package's: both
device voxel stores (ops/voxel_map, ops/voxel_map_sorted), the order-exact
segment sum they reduce an insert group with (ops/voxel_segsum),
`StreamingMapper`'s device path and the map_data directory I/O.

Inputs come from a NumPy seed: the quantized points of
tests/test_voxel_map_sorted.py (cells revisited across groups) and groups
of real scans rendered from a small synthetic world. Both packages get the
same arrays; the port runs on the CPU, where `segment_sum_sorted` runs its
plain version. The contract is exactness, so everything is compared with
`assert_array_equal`: keys, cell counts, n_dropped and n_oob equal, sums,
counts and moments bit for bit (the JAX package's scatter-add on the CPU
adds each cell's points in row order, and so does the port; its sorts keep
equal keys in input order, as `torch.sort(stable=True)` does)."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.models import mapping as jmap
from slam_sensor_fusion_tpu.ops import voxel_map as jvm
from slam_sensor_fusion_tpu.ops import voxel_map_sorted as jvs
from slam_sensor_fusion_tpu.utils import mapdata as jmd
from slam_sensor_fusion_tpu.utils.config import MappingConfig as JMappingConfig
from slam_sensor_fusion_tpu_torch.models import mapping as tmap
from slam_sensor_fusion_tpu_torch.ops import voxel_map as tvm
from slam_sensor_fusion_tpu_torch.ops import voxel_map_sorted as tvs
from slam_sensor_fusion_tpu_torch.ops.voxel_segsum import (
    segment_sum_sorted,
    segment_sum_sorted_plain,
)
from slam_sensor_fusion_tpu_torch.utils import convert
from slam_sensor_fusion_tpu_torch.utils import mapdata as tmd
from slam_sensor_fusion_tpu_torch.utils import synthetic as syn
from slam_sensor_fusion_tpu_torch.utils.config import MappingConfig
from torch_parity import np_tree, t

CPU = torch.device("cpu")
GROUP = 2048  # points an insert group (padded)
#: the quantized points' grid (tests/test_voxel_map_sorted.py) and the
#: synthetic scans' (0.2 m voxels over a 60 m world)
GRIDS = {
    "quantized": dict(voxel_size=0.25, dim_xy=256, dim_z=128),
    "scans": dict(voxel_size=0.2, dim_xy=512, dim_z=64),
}
HASH = {k: dict(g, table_size=1 << 14, straggler_capacity=256) for k, g in GRIDS.items()}
SORTED = {k: dict(g, capacity=1 << 13, unique_capacity=1 << 11) for k, g in GRIDS.items()}


def _quantized_points(rng, n, extent=30.0):
    p = rng.integers(0, int(extent * 32), (n, 3)).astype(np.float64) / 32.0
    return (p + 1.0 / 64.0).astype(np.float32)


def _quantized_groups(rng):
    frames = [_quantized_points(rng, n) for n in (1200, 1900, 800, 1500)]
    frames[2][:400] = frames[0][:400]  # revisit earlier cells
    frames[3][:300] = frames[1][-300:]
    return frames, np.zeros(3, np.float32)


def _scan_groups(rng, n_groups=3, per_scan=1000):
    """Groups of 2 real scans each (rendered from a small synthetic world,
    put in the world frame by their poses), consecutive poses close enough
    that groups revisit each other's cells."""
    world = syn.make_world(rng, extent=60.0, n_buildings=12, n_poles=30, points_per_m2=8.0)
    poses = syn.make_trajectory(2 * n_groups, speed_per_frame=0.5, radius=12.0)
    scans = [
        syn.render_scan(world, T, rng, max_points=per_scan, max_range=20.0) @ T[:3, :3].T + T[:3, 3]
        for T in poses
    ]
    groups = [np.concatenate(scans[2 * g: 2 * g + 2]).astype(np.float32) for g in range(n_groups)]
    origin = np.floor(np.concatenate(groups).min(axis=0)) - 1.0
    return groups, origin.astype(np.float32)


def _groups(kind, rng):
    return _quantized_groups(rng) if kind == "quantized" else _scan_groups(rng)


def _pad(pts, cap=GROUP):
    buf = np.zeros((cap, 3), np.float32)
    buf[: len(pts)] = pts
    msk = np.zeros(cap, bool)
    msk[: len(pts)] = True
    return buf, msk


def _jax_run(init, insert, cfg, origin, groups, state=None):
    st = init(cfg, jnp.asarray(origin)) if state is None else state
    for g in groups:
        p, m = _pad(g)
        st = insert(st, jnp.asarray(p), jnp.asarray(m), cfg)
    return st


def _port_run(init, insert, cfg, origin, groups, state=None):
    st = init(cfg, origin, CPU) if state is None else state
    for g in groups:
        p, m = _pad(g)
        st = insert(st, t(p), t(m), cfg)
    return st


def _assert_states_equal(port_state, jax_state):
    for f in port_state._fields:
        np.testing.assert_array_equal(getattr(port_state, f).numpy(), np.asarray(getattr(jax_state, f)), err_msg=f)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table_size", [1 << 12, 3001, 1 << 21])
def test_probe_slot_matches_jax(table_size):
    """uint32 wrap-around emulated in int64: the same slots for keys over
    the whole int32 range (both ends and _EMPTY included)."""
    rng = np.random.default_rng(1)
    keys = np.concatenate([
        rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, 4000, dtype=np.int64),
        [0, 1, -1, 2**31 - 2, -(2**31), 65535, 65536, 2**24 + 7],
    ]).astype(np.int32)
    keys = np.append(keys, jvm._EMPTY)
    for probe in range(8):
        want = np.asarray(jvm._probe_slot(jnp.asarray(keys), probe, table_size))
        got = tvm._probe_slot(t(keys), probe, table_size).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"probe {probe}")


def test_pack_ids_out_of_range_and_nan_match_jax():
    """Points far outside the grid (1e4, 1e12, inf) and NaN rows: ids, the
    in-bounds mask and n_oob as the JAX package gives them. XLA's
    float->int32 conversion saturates and maps NaN to 0, so a NaN
    coordinate bins as cell index 0: an all-NaN row counts as IN bounds
    (ROADMAP §3, reproduced on purpose)."""
    cfg = jvm.VoxelMapConfig(**GRIDS["quantized"])
    origin = np.asarray([-1.0, -2.0, -3.0], np.float32)
    big = [1e4, -1e4, 1e12, -1e12, np.inf, -np.inf]
    rows = [[v, 1.0, 1.0] for v in big] + [[1.0, v, 1.0] for v in big] + [[1.0, 1.0, v] for v in big]
    rows += [[np.nan] * 3, [np.nan, 1.0, 1.0], [1.0, 1.0, np.nan], [63.9, 63.9, 28.9], [64.0, 0.0, 0.0]]
    pts = np.concatenate([np.asarray(rows, np.float32), _quantized_points(np.random.default_rng(2), 40)])
    mask = np.ones(len(pts), bool)
    mask[3] = mask[-1] = False
    jk, jok, jn = jvm._pack_ids(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(origin), cfg)
    tk, tok, tn = tvm._pack_ids(t(pts), t(mask), t(origin), tvm.VoxelMapConfig(**GRIDS["quantized"]))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert int(tn) == int(jn)
    nan_row = len(big) * 3
    assert bool(jok[nan_row]) and int(jk[nan_row]) == 0  # the quirk the port keeps


@pytest.mark.parametrize("store", ["hash", "sorted"])
def test_masked_nan_rows_match_jax(store):
    """Masked-out rows holding NaN: the hash store zeroes their payload
    with a select, the sorted store multiplies it by the mask (NaN * 0 =
    NaN), so in the JAX package the sorted store's last real cell of the
    group turns NaN. The port reproduces both (ROADMAP §3)."""
    rng = np.random.default_rng(14)
    pts = _quantized_points(rng, 64)
    pts[60:] = np.nan
    mask = np.arange(64) < 60
    kw = GRIDS["quantized"]
    if store == "hash":
        jcfg, tcfg = jvm.VoxelMapConfig(**kw, table_size=1 << 10), tvm.VoxelMapConfig(**kw, table_size=1 << 10)
        js = jvm.voxel_map_insert(jvm.voxel_map_init(jcfg, jnp.zeros(3)), jnp.asarray(pts), jnp.asarray(mask), jcfg)
        ts = tvm.voxel_map_insert(tvm.voxel_map_init(tcfg, np.zeros(3), CPU), t(pts), t(mask), tcfg)
        n_nan = int(torch.isnan(ts.sums).any(-1).sum())
    else:
        kw = dict(kw, capacity=256, unique_capacity=64)
        jcfg, tcfg = jvs.SortedVoxelMapConfig(**kw), tvs.SortedVoxelMapConfig(**kw)
        js = jvs.sorted_voxel_map_insert(
            jvs.sorted_voxel_map_init(jcfg, jnp.zeros(3)), jnp.asarray(pts), jnp.asarray(mask), jcfg)
        ts = tvs.sorted_voxel_map_insert(tvs.sorted_voxel_map_init(tcfg, np.zeros(3), CPU), t(pts), t(mask), tcfg)
        n_nan = int(torch.isnan(ts.moments).any(-1).sum())
    _assert_states_equal(ts, js)
    assert n_nan == (1 if store == "sorted" else 0)


@pytest.mark.parametrize("C", [1, 4])
def test_segment_sum_plain_matches_jax_scatter(C):
    """The plain segment sum against `jnp.zeros(...).at[seg].add(...,
    indices_are_sorted=True)` bit for bit: one run of 10 000 rows, many
    singletons, empty segments, and rows aliased to U - 1 with zero
    payload (as the stores clip them)."""
    rng = np.random.default_rng(3)
    U = 700
    lens = rng.integers(0, 4, U)
    lens[17] = 10_000
    seg = np.repeat(np.arange(U), lens)
    seg = np.concatenate([seg, np.full(300, U - 1)]).astype(np.int32)
    vals = (rng.standard_normal((len(seg), C)) * 50).astype(np.float32)
    vals[-300:] = 0.0
    vals[-300::2] = -0.0
    want = np.asarray(jnp.zeros((U, C), jnp.float32).at[jnp.asarray(seg)].add(
        jnp.asarray(vals), indices_are_sorted=True))
    got = segment_sum_sorted(t(vals), t(seg), U)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(segment_sum_sorted_plain(t(vals), t(seg), U).numpy(), want)


# ---------------------------------------------------------------------------
# the two stores against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(GRIDS))
def test_hash_insert_matches_jax(kind):
    rng = np.random.default_rng(4)
    groups, origin = _groups(kind, rng)
    jcfg, tcfg = jvm.VoxelMapConfig(**HASH[kind]), tvm.VoxelMapConfig(**HASH[kind])
    js = _jax_run(jvm.voxel_map_init, jvm.voxel_map_insert, jcfg, origin, groups)
    ts = _port_run(tvm.voxel_map_init, tvm.voxel_map_insert, tcfg, origin, groups)
    _assert_states_equal(ts, js)
    assert int(ts.n_cells()) == int(js.n_cells()) > 1000
    assert int(ts.n_dropped) == int(ts.n_oob) == 0
    cloud = tvm.voxel_map_centroids(ts, tcfg, 1 << 13)
    want = jvm.voxel_map_centroids(js, jcfg, 1 << 13)
    np.testing.assert_array_equal(cloud.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(cloud.mask.numpy(), np.asarray(want.mask))


@pytest.mark.parametrize("kind", list(GRIDS))
def test_sorted_insert_matches_jax(kind):
    rng = np.random.default_rng(5)
    groups, origin = _groups(kind, rng)
    jcfg, tcfg = jvs.SortedVoxelMapConfig(**SORTED[kind]), tvs.SortedVoxelMapConfig(**SORTED[kind])
    js = _jax_run(jvs.sorted_voxel_map_init, jvs.sorted_voxel_map_insert, jcfg, origin, groups)
    ts = _port_run(tvs.sorted_voxel_map_init, tvs.sorted_voxel_map_insert, tcfg, origin, groups)
    _assert_states_equal(ts, js)
    # the state is capacity + unique_capacity rows wide (voxel_map_sorted.py:39-46)
    assert ts.keys.shape == (tcfg.capacity + tcfg.unique_capacity,)
    assert int(ts.n_cells()) == int(js.n_cells()) > 1000
    np.testing.assert_array_equal(
        tvs.sorted_voxel_map_centroids_numpy(ts), jvs.sorted_voxel_map_centroids_numpy(js))


@pytest.mark.parametrize("case", ["stragglers", "probe_budget"])
def test_hash_nearly_full_table_drops_like_jax(case):
    """A table of 4096 slots filled to ~90%: collision losers go through
    the straggler phase; past its capacity (`stragglers`) or past a short
    probe budget (`probe_budget`) their points are dropped, counted as the
    JAX package counts them."""
    rng = np.random.default_rng(6)
    groups = [_quantized_points(rng, n) for n in (1800, 1900, 2000)]
    kw = dict(GRIDS["quantized"], table_size=1 << 12)
    if case == "stragglers":
        kw.update(straggler_capacity=32)
    else:
        kw.update(max_probes=3)
    jcfg, tcfg = jvm.VoxelMapConfig(**kw), tvm.VoxelMapConfig(**kw)
    origin = np.zeros(3, np.float32)
    js = _jax_run(jvm.voxel_map_init, jvm.voxel_map_insert, jcfg, origin, groups)
    ts = _port_run(tvm.voxel_map_init, tvm.voxel_map_insert, tcfg, origin, groups)
    _assert_states_equal(ts, js)
    assert int(ts.n_dropped) > 0


@pytest.mark.parametrize("case", ["unique_capacity", "capacity", "hash_unique_capacity"])
def test_overflow_counts_match_jax(case):
    """A group touching more cells than `unique_capacity`, and a sorted
    map outgrowing `capacity` (its largest cells cut): the same states and
    the same loud n_dropped as the JAX package."""
    rng = np.random.default_rng(7)
    groups = [_quantized_points(rng, 500) for _ in range(3)]
    origin = np.zeros(3, np.float32)
    if case == "hash_unique_capacity":
        kw = dict(GRIDS["quantized"], table_size=1 << 12, unique_capacity=256)
        js = _jax_run(jvm.voxel_map_init, jvm.voxel_map_insert, jvm.VoxelMapConfig(**kw), origin, groups)
        ts = _port_run(tvm.voxel_map_init, tvm.voxel_map_insert, tvm.VoxelMapConfig(**kw), origin, groups)
    else:
        kw = dict(GRIDS["quantized"], capacity=1 << 13, unique_capacity=256)
        if case == "capacity":
            kw.update(capacity=600, unique_capacity=512)
        js = _jax_run(jvs.sorted_voxel_map_init, jvs.sorted_voxel_map_insert,
                      jvs.SortedVoxelMapConfig(**kw), origin, groups)
        ts = _port_run(tvs.sorted_voxel_map_init, tvs.sorted_voxel_map_insert,
                       tvs.SortedVoxelMapConfig(**kw), origin, groups)
    _assert_states_equal(ts, js)
    assert int(ts.n_dropped) > 0


def test_sorted_equals_hash_and_chunked_equals_stepwise():
    """In the port alone: the sorted and hash stores give the same
    centroids bit for bit, and a chunk of frames the same states as one
    insert a frame."""
    rng = np.random.default_rng(8)
    groups, origin = _quantized_groups(rng)
    hcfg = tvm.VoxelMapConfig(**dict(HASH["quantized"], table_size=1 << 16))
    scfg = tvs.SortedVoxelMapConfig(**SORTED["quantized"])
    hs = _port_run(tvm.voxel_map_init, tvm.voxel_map_insert, hcfg, origin, groups)
    ss = _port_run(tvs.sorted_voxel_map_init, tvs.sorted_voxel_map_insert, scfg, origin, groups)
    assert int(ss.n_cells()) == int(hs.n_cells())
    assert int(hs.n_dropped) == int(ss.n_dropped) == 0
    np.testing.assert_array_equal(
        tvs.sorted_voxel_map_centroids_numpy(ss), tvm.voxel_map_centroids_numpy(hs))
    pts = torch.stack([t(_pad(g)[0]) for g in groups])
    msk = torch.stack([t(_pad(g)[1]) for g in groups])
    for init, chunk, cfg, step in (
        (tvm.voxel_map_init, tvm.voxel_map_insert_chunk, hcfg, hs),
        (tvs.sorted_voxel_map_init, tvs.sorted_voxel_map_insert_chunk, scfg, ss),
    ):
        whole = chunk(init(cfg, origin, CPU), pts, msk, cfg)
        for f in whole._fields:
            assert torch.equal(getattr(whole, f), getattr(step, f)), f


@pytest.mark.parametrize("store", ["hash", "sorted"])
def test_jax_state_continues_in_the_port(store):
    """A JAX store after two groups, carried over by utils/convert and
    given the last two groups in the port, equals the JAX package inserting
    all four."""
    rng = np.random.default_rng(9)
    groups, origin = _quantized_groups(rng)
    if store == "hash":
        jcfg, tcfg = jvm.VoxelMapConfig(**HASH["quantized"]), tvm.VoxelMapConfig(**HASH["quantized"])
        jinit, jins, tins = jvm.voxel_map_init, jvm.voxel_map_insert, tvm.voxel_map_insert
        handover = convert.voxel_map_state_from_numpy
    else:
        kw = SORTED["quantized"]
        jcfg, tcfg = jvs.SortedVoxelMapConfig(**kw), tvs.SortedVoxelMapConfig(**kw)
        jinit, jins, tins = jvs.sorted_voxel_map_init, jvs.sorted_voxel_map_insert, tvs.sorted_voxel_map_insert
        handover = convert.sorted_voxel_map_state_from_numpy
    half = _jax_run(jinit, jins, jcfg, origin, groups[:2])
    port = _port_run(None, tins, tcfg, origin, groups[2:], state=handover(np_tree(half), CPU))
    _assert_states_equal(port, _jax_run(jinit, jins, jcfg, origin, groups))


# ---------------------------------------------------------------------------
# StreamingMapper and the map_data directory
# ---------------------------------------------------------------------------


def _record(module, cfg_cls, store_cfg, groups, origin, **kw):
    mcfg = cfg_cls(cloud_save_rate=3, map_voxel_size=0.25)
    mapper = module.StreamingMapper(mcfg, device_origin=origin, device_config=store_cfg,
                                    device_scan_capacity=1024, device_group=2, **kw)
    for i, g in enumerate(groups):
        for half in (g[: len(g) // 2], g[len(g) // 2:]):
            mapper.add_frame(half, np.asarray([0.1 * i, 0.0, 0.0]), 47.5 + 1e-5 * i, 9.0,
                             412.0 + i, 0.1 * i)
    return mapper, mapper.finalize(use_device=True)


@pytest.mark.parametrize("store", ["hash", "sorted"])
def test_streaming_mapper_matches_jax(store):
    """`finalize(use_device=True)` on the port's store (on the CPU here)
    equals the JAX package's map bit for bit (7 frames in groups of 2: the
    tail group padded), and the tiles, odometry and GPS rows are equal."""
    rng = np.random.default_rng(10)
    groups, origin = _quantized_groups(rng)
    if store == "hash":
        jcfg, tcfg = jvm.VoxelMapConfig(**HASH["quantized"]), tvm.VoxelMapConfig(**HASH["quantized"])
    else:
        jcfg, tcfg = jvs.SortedVoxelMapConfig(**SORTED["quantized"]), tvs.SortedVoxelMapConfig(**SORTED["quantized"])
    jm, jdata = _record(jmap, JMappingConfig, jcfg, groups[:3] + [groups[3][:700]], origin)
    tm, tdata = _record(tmap, MappingConfig, tcfg, groups[:3] + [groups[3][:700]], origin, device="cpu")
    assert isinstance(tm._vm_config, type(tcfg)) and tm._vm_state.keys.device == CPU
    for f in ("map_points", "map_T_global", "altitude_table"):
        np.testing.assert_array_equal(getattr(tdata, f), getattr(jdata, f), err_msg=f)
    assert len(tm.tiles) == len(jm.tiles) == 3
    for a, b in zip(tm.tiles, jm.tiles):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(tm.odom_positions), np.stack(jm.odom_positions))
    np.testing.assert_array_equal(np.stack(tm.gps_rows), np.stack(jm.gps_rows))


def test_streaming_mapper_defaults_to_the_hash_store_and_raises_on_overflow():
    """No `device_config`: the hash store at `map_voxel_size`, as in the
    JAX package; a point outside the grid makes finalize raise."""
    mapper = tmap.StreamingMapper(MappingConfig(map_voxel_size=0.5), device_origin=np.zeros(3),
                                  device_scan_capacity=16, device="cpu")
    assert mapper._vm_config == tvm.VoxelMapConfig(voxel_size=0.5)
    mapper.add_frame(np.asarray([[1.0, 1.0, 1.0], [-5.0, 0.0, 0.0]]), np.zeros(3), 47.5, 9.0, 1.0, 0.0)
    with pytest.raises(ValueError, match="oob=1"):
        mapper.finalize(use_device=True)


def _map_run(rng):
    tiles = [rng.uniform(-5, 5, (200, 3)).astype(np.float32) for _ in range(3)]
    odom = np.zeros((30, 3))
    odom[15:, 0] = 2.0
    gps = np.tile([47.5, 9.0, 412.0, 0.3], (30, 1)) + rng.normal(0, 1e-6, (30, 4))
    return tiles, odom, gps


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_map_data_directory_across_packages(tmp_path, direction):
    """One package writes a map_data directory, the other reads it: the
    same files byte for byte (tiles and text logs), and equal MapData
    arrays, the merged map cached on the first load."""
    tiles, odom, gps = _map_run(np.random.default_rng(11))
    writer, reader = (jmd, tmd) if direction == "jax_to_port" else (tmd, jmd)
    a, b = str(tmp_path / "written"), str(tmp_path / "reference")
    writer.save_map_data(a, tiles, odom, gps)
    reader.save_map_data(b, tiles, odom, gps)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        with open(os.path.join(a, f), "rb") as fa, open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f
    shutil.copytree(a, str(tmp_path / "copy"))
    got = reader.load_map_data(a)
    want = writer.load_map_data(str(tmp_path / "copy"))
    for f in ("map_points", "map_T_global", "altitude_table"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert os.path.exists(os.path.join(a, "map.pcd"))
    cached = reader.load_map_data(a)
    np.testing.assert_array_equal(cached.map_points, got.map_points)

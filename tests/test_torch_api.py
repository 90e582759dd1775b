"""The product's entry points in the PyTorch port against the JAX package:
the geometry helpers, `api.build_map` (the map_data directory and MapData),
`api.localize` from that directory with compass headings in degrees,
`localize_streams` on jittered timestamps, the CLI, and `Localizer.run`'s
debug branch. The port runs on the CPU (device="cpu", the kernels' plain
versions); the JAX package runs its Pallas kernels in interpret mode.

Tolerances: the geometry helpers 1e-6; poses 3e-4 with the valid mask,
ICP iterations and correspondence counts EQUAL (as tests/test_torch_engine.py);
the map_data files byte for byte; the debug PLY point sets within one unit
of their fourth decimal (1e-4 m); the debug run's poses equal, bit for bit,
to the same run without debug."""

import dataclasses
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu import api as japi
from slam_sensor_fusion_tpu.models import localization as jl
from slam_sensor_fusion_tpu.ops import geometry as jgeo
from slam_sensor_fusion_tpu.utils import mapdata as jmapdata
from slam_sensor_fusion_tpu_torch import __main__ as cli
from slam_sensor_fusion_tpu_torch import api as tapi
from slam_sensor_fusion_tpu_torch.examples_selftest import selftest_world
from slam_sensor_fusion_tpu_torch.models import localization as tl
from slam_sensor_fusion_tpu_torch.ops import geometry as tgeo
from slam_sensor_fusion_tpu_torch.utils import mapdata as tmapdata
from torch_parity import jax_config
from torch_world import SLICE_CONFIG

N_FRAMES = 6
SEED = 4
#: the bench's superblock parity engine (K1) at test size: the GPS start,
#: the coarse ladder on frame 1, then one superblock of 4 frames. The
#: brute-force threshold is the selftest's (0.1): frame 1's brute force
#: misses (best score 0.2229) and the rescue ICP (K2) starts from its best
#: candidate, so the scoring's choice of candidate shows in the poses. The
#: acceptable ICP error of 0.1 m (0-3 fine iterations a frame) keeps the
#: plain K1 and K2 quick; it also lets a coarse pose that differs between
#: packages show through, which is what this test is to catch
CONFIG = dataclasses.replace(
    SLICE_CONFIG, superstep=4,
    icp=dataclasses.replace(SLICE_CONFIG.icp, acceptable_mean_error=0.1),
)
DEBUG_FILES = ("cropped_scan_map_frame.ply", "cropped_map.ply", "map.ply", "trajectory.svg",
               "viewer.html")


def _mapping_frames(tiles, n):
    """The mapping run frame by frame: a map-frame tile every 2nd frame."""
    empty = np.zeros((0, 3), np.float32)
    return [tiles[i // 2] if i % 2 == 0 else empty for i in range(n)]


def _jittered(seq, heading):
    """The sequence as raw streams, every timestamp but the scans' jittered
    within the 0.1 s slop (the compass at or before its scan)."""
    rng = np.random.default_rng(1)
    t = np.arange(N_FRAMES) * 0.1
    return tapi.RawStreams(
        scan_t=t, scans=seq.scans, gps_t=t + rng.uniform(-0.03, 0.03, N_FRAMES),
        gps_lat=seq.gps_lat, gps_lon=seq.gps_lon, gps_alt=seq.gps_alt,
        gps_cov_trace=seq.gps_cov_trace, odom_t=t + rng.uniform(-0.03, 0.03, N_FRAMES),
        odom_T_sensor=seq.odom_T_sensor, odom_cov_trace=seq.odom_cov_trace,
        compass_t=t - rng.uniform(0.0, 0.03, N_FRAMES), compass_heading_deg=heading,
    )


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both packages' build_map into a map_data directory each; the JAX
    package's api.localize from its directory on the aligned streams, the
    port's localize_streams on jittered ones (which calls api.localize:
    its arguments are recorded)."""
    seq, tiles, odom_pos, gps_rows = selftest_world(N_FRAMES, SEED)
    frames = _mapping_frames(tiles, N_FRAMES)
    log = (odom_pos, gps_rows[:, 0], gps_rows[:, 1], gps_rows[:, 2], gps_rows[:, 3])
    jdir = str(tmp_path_factory.mktemp("jax") / "map_data")
    tdir = str(tmp_path_factory.mktemp("port") / "map_data")
    jmd = japi.build_map(frames, *log, map_data_path=jdir)
    tmd = tapi.build_map(frames, *log, map_data_path=tdir)
    files = {d: _files(d) for d in (jdir, tdir)}  # before the loads cache the merged map
    heading = 90.0 - np.rad2deg(seq.compass_yaw)
    want = japi.localize(
        scans=seq.scans, odom_T_sensor=seq.odom_T_sensor, gps_lat=seq.gps_lat,
        gps_lon=seq.gps_lon, gps_alt=seq.gps_alt, compass_heading_deg=heading,
        odom_cov_trace=seq.odom_cov_trace, gps_cov_trace=seq.gps_cov_trace,
        map_data_path=jdir, config=jax_config(CONFIG),
    )
    calls = []
    real = tapi.localize

    def spy(**kw):
        calls.append(kw)
        return real(**kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "localize", spy)
        got = tapi.localize_streams(_jittered(seq, heading), map_data_path=tdir, config=CONFIG,
                                    device="cpu")
    return dict(seq=seq, frames=frames, log=log, jdir=jdir, tdir=tdir, jmd=jmd, tmd=tmd,
                files=files, heading=heading, want=want, got=got, calls=calls)


def _files(root):
    out = {}
    for n in sorted(os.listdir(root)):
        with open(os.path.join(root, n), "rb") as f:
            out[n] = f.read()
    return out


def _assert_localized_like(got, want):
    assert got.first_processed_frame == want.first_processed_frame
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_allclose(got.map_T_sensor, want.map_T_sensor, rtol=0, atol=3e-4)
    for name in ("icp_iterations", "n_correspondences", "icp_converged"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("name", ["quat_to_R", "R_to_quat", "wrap_pi", "compass_heading_to_yaw"])
def test_geometry_helpers_match_jax(name):
    rng = np.random.default_rng(0)
    q = _rotations(rng, 64).astype(np.float32)
    inputs = {
        "quat_to_R": q * 3.0,  # normalized first
        # every branch of the four-hypothesis construction: near-identity
        # (trace dominant) and rotations by ~pi about x, y and z
        "R_to_quat": np.concatenate([
            np.asarray(jgeo.quat_to_R(jnp.asarray(q))),
            np.asarray(jgeo.quat_to_R(jnp.asarray(np.array(
                [[1, 0, 0, 0], [0.01, 1, 0, 0], [0.01, 0, 1, 0], [0.01, 0, 0, 1]], np.float32)))),
        ]),
        "wrap_pi": rng.uniform(-20, 20, 256).astype(np.float32),
        "compass_heading_to_yaw": rng.uniform(-360, 720, 256).astype(np.float32),
    }[name]
    want = np.asarray(getattr(jgeo, name)(jnp.asarray(inputs)))
    got = getattr(tgeo, name)(torch.from_numpy(inputs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_build_map_matches_jax(run):
    """The same map_data directory, byte for byte, and the same MapData."""
    want, got = run["files"][run["jdir"]], run["files"][run["tdir"]]
    assert sorted(got) == sorted(want) and len(got) == 3  # a tile, 2 logs
    for name in want:
        assert got[name] == want[name], name
    for f in ("map_points", "map_T_global", "altitude_table"):
        np.testing.assert_array_equal(getattr(run["tmd"], f), getattr(run["jmd"], f), err_msg=f)


def test_localize_matches_jax(run):
    """api.localize from the map_data directory with compass headings in
    degrees (reached through localize_streams), against the JAX package's."""
    got, want = run["got"], run["want"]
    _assert_localized_like(got, want)
    assert got.valid[1:].all()
    err = got.map_T_sensor[got.valid, :3, 3] - run["seq"].true_map_T_sensor[got.valid, :3, 3]
    assert np.sqrt((err ** 2).sum(1).mean()) < 0.15


def test_localize_streams_aligns_every_frame(run):
    """Jitter within the 0.1 s slop aligns every frame to itself: api.localize
    got the streams the JAX package's localize got, in order, on the card's
    default unless asked (here the CPU)."""
    seq, (kw,) = run["seq"], run["calls"]
    assert len(kw["scans"]) == N_FRAMES
    assert all(a is b for a, b in zip(kw["scans"], seq.scans))
    for name, want in [("odom_T_sensor", seq.odom_T_sensor), ("gps_lat", seq.gps_lat),
                       ("gps_lon", seq.gps_lon), ("gps_alt", seq.gps_alt),
                       ("compass_heading_deg", run["heading"]),
                       ("odom_cov_trace", seq.odom_cov_trace),
                       ("gps_cov_trace", seq.gps_cov_trace)]:
        np.testing.assert_array_equal(kw[name], want, err_msg=name)
    assert (kw["map_data_path"], kw["device"], kw["config"]) == (run["tdir"], "cpu", CONFIG)


def _streams_for_build(run):
    odom_pos, lat, lon, alt, yaw = run["log"]
    t = np.arange(N_FRAMES) * 0.1
    odom_T = np.tile(np.eye(4, dtype=np.float32), (N_FRAMES, 1, 1))
    odom_T[:, :3, 3] = odom_pos
    return tapi.RawStreams(
        scan_t=t, scans=run["frames"], gps_t=t, gps_lat=lat, gps_lon=lon, gps_alt=alt,
        gps_cov_trace=np.ones(N_FRAMES), odom_t=t, odom_T_sensor=odom_T,
        odom_cov_trace=np.full(N_FRAMES, 0.03), compass_t=t,
        compass_heading_deg=90.0 - np.rad2deg(yaw),
    )


def test_cli_build_map(run, tmp_path, capsys):
    """`build-map` from a streams file writes the directory api.build_map
    writes, byte for byte (the compass column goes through degrees and
    back, below the log's 8 decimals)."""
    path = str(tmp_path / "streams.npz")
    cli.save_streams(path, _streams_for_build(run))
    out = str(tmp_path / "map_data")
    assert cli.main(["build-map", "--map-data-path", out, "--streams", path]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"map_data_path": out}
    got, want = _files(out), run["files"][run["tdir"]]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_cli_localize_arguments(run, tmp_path, capsys, monkeypatch):
    """`localize`'s plumbing, with localize_streams replaced (the default
    config's full brute-force grid is too slow for the CPU's plain path):
    the streams, map, config and device reach it, and the trajectory file
    holds its four arrays."""
    path = str(tmp_path / "streams.npz")
    streams = _streams_for_build(run)
    cli.save_streams(path, streams)
    calls = []

    def fake(s, **kw):
        calls.append((s, kw))
        return run["got"]

    monkeypatch.setattr(tapi, "localize_streams", fake)
    out = str(tmp_path / "traj.npz")
    argv = ["localize", "--map-data-path", run["tdir"], "--streams", path, "--output", out]
    assert cli.main(argv + ["--map-name", "m2", "--enable-debug",
                            "--max-map-optimization-poses", "7", "--device", "cpu"]) == 0
    s, kw = calls[-1]
    for f in dataclasses.fields(streams):
        a, b = getattr(s, f.name), getattr(streams, f.name)
        if f.name == "scans":
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert (kw["map_data_path"], kw["map_name"], kw["device"]) == (run["tdir"], "m2", "cpu")
    assert kw["config"].enable_debug and kw["config"].max_map_optimization_poses == 7
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == int(run["got"].valid.sum()) and line["output"] == out
    assert set(line["launches"]) >= {"K1", "K2", "K3", "K7"}
    z = np.load(out)
    assert sorted(z.files) == ["icp_error", "icp_iterations", "map_T_sensor", "valid"]
    np.testing.assert_array_equal(z["map_T_sensor"], run["got"].map_T_sensor)
    # the default device is the card
    assert cli.main(argv) == 0
    assert calls[-1][1]["device"] == "cuda" and not calls[-1][1]["config"].enable_debug


def _ply_points(path):
    with open(path) as f:
        lines = f.read().splitlines()
    start = lines.index("end_header") + 1
    n = int(next(l for l in lines if l.startswith("element vertex")).split()[-1])
    pts = np.array([l.split()[:3] for l in lines[start:]], np.float64).reshape(-1, 3)
    assert len(pts) == n
    return pts


def test_debug_branch_matches_jax(run, tmp_path, caplog):
    """enable_debug (localization_node.cpp:348-373): the CALLBACK TOOK logs
    and the timing report, the five files with the JAX run's point sets,
    and poses equal bit for bit to the same run without debug."""
    seq = run["seq"]
    yaw = np.mod(np.deg2rad(90.0 - run["heading"]) + np.pi, 2 * np.pi) - np.pi
    run_args = (seq.scans, seq.odom_T_sensor, seq.gps_lat, seq.gps_lon, seq.gps_alt, yaw,
                seq.odom_cov_trace, seq.gps_cov_trace)
    cfg = dataclasses.replace(CONFIG, enable_debug=True)
    jd, td = tmp_path / "jax", tmp_path / "port"
    jl.Localizer(jmapdata.load_map_data(run["jdir"]), jax_config(cfg)).run(
        *run_args, debug_dir=str(jd))
    with caplog.at_level(logging.INFO, logger="slam_sensor_fusion_tpu_torch"):
        got = tl.Localizer(tmapdata.load_map_data(run["tdir"]), cfg, device="cpu").run(
            *run_args, debug_dir=str(td))
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(run["got"], f.name))
    msgs = [r.getMessage() for r in caplog.records if r.name == "slam_sensor_fusion_tpu_torch"]
    assert any("CALLBACK TOOK" in m for m in msgs), msgs
    assert any("timing report" in m for m in msgs), msgs
    for name in DEBUG_FILES:
        assert (td / name).stat().st_size > 0, name
    for name in DEBUG_FILES[:3]:
        a, b = _ply_points(td / name), _ply_points(jd / name)
        assert a.shape == b.shape and len(a) > 100, name
        # printed to 4 decimals: equal within one unit of the last one
        assert np.abs(np.round(a * 1e4) - np.round(b * 1e4)).max() <= 1, name


def test_debug_off_emits_nothing(run, tmp_path, caplog):
    seq = run["seq"]
    loc = tl.Localizer(run["tmd"], CONFIG, device="cpu")
    with caplog.at_level(logging.INFO, logger="slam_sensor_fusion_tpu_torch"):
        loc.run(seq.scans[:4], seq.odom_T_sensor[:4], seq.gps_lat[:4], seq.gps_lon[:4],
                seq.gps_alt[:4], seq.compass_yaw[:4], seq.odom_cov_trace[:4],
                seq.gps_cov_trace[:4], debug_dir=str(tmp_path))
    assert not any("CALLBACK TOOK" in r.getMessage() for r in caplog.records)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("name", ["write_ply", "write_trajectory_ply", "plot_topdown",
                                  "write_html_viewer"])
def test_viz_writes_the_jax_packages_bytes(run, tmp_path, name):
    from slam_sensor_fusion_tpu.utils import viz as jviz
    from slam_sensor_fusion_tpu_torch.utils import viz as tviz

    poses, pts = run["got"].map_T_sensor, run["tmd"].map_points
    args = {
        "write_ply": (pts[:5000],),
        "write_trajectory_ply": (poses,),
        "plot_topdown": (poses, run["seq"].true_map_T_sensor, pts),
        "write_html_viewer": (pts, poses, run["seq"].true_map_T_sensor, None, None, pts[:300]),
    }[name]
    getattr(jviz, name)(str(tmp_path / "j"), *args)
    getattr(tviz, name)(str(tmp_path / "t"), *args)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def test_roofline_model_matches_jax():
    """The same op and byte counts as the JAX package's model; the shares
    against the H100 data sheet's peaks."""
    from slam_sensor_fusion_tpu.utils import roofline as jroof
    from slam_sensor_fusion_tpu_torch.utils import roofline as troof

    args = dict(pairs_per_frame=40.0, tile_src=1024, tile_tgt=512, live_iters_per_frame=3.5,
                scan_points=4096, target_points=65536, frames_per_sec=1700.0, superstep=8)
    got, want = troof.association_model(**args), jroof.association_model(**args)
    for k in ("assoc_gops_per_frame", "hbm_gbps", "model"):
        assert got[k] == want[k], k
    assert got["achieved_f32_tops"] == want["achieved_vpu_tops"]
    assert got["f32_util_frac"] == round(want["achieved_vpu_tops"] * 1e12 / 67e12, 4)
    assert got["hbm_util_frac"] == round(want["hbm_gbps"] * 1e9 / 3.35e12, 5)
    assert troof.frame_time_budget(1700.0) == jroof.frame_time_budget(1700.0)


def test_profiling(tmp_path):
    """StageTimer's report; trace() writes a chrome trace; summarize_trace
    sums a trace's device operations by name (here a written one: the CPU
    has no device operations)."""
    from slam_sensor_fusion_tpu_torch.utils import profiling

    timer = profiling.StageTimer()
    with timer.stage("a", sync=torch.zeros(1)):
        pass
    with timer.stage("a"):
        pass
    assert set(timer.stages) == {"a"} and timer.report().startswith("TOTAL ")
    assert 0.0 <= timer.last <= timer.stages["a"]

    with profiling.trace(str(tmp_path / "cpu")):
        torch.ones(64).sum()
    assert len(os.listdir(tmp_path / "cpu")) == 1
    assert profiling.summarize_trace(str(tmp_path / "cpu")) == []

    events = [{"ph": "X", "cat": "kernel", "name": "k1", "dur": 1500.0},
              {"ph": "X", "cat": "kernel", "name": "k1", "dur": 500.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 3000.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 9000.0},
              {"ph": "i", "cat": "kernel", "name": "marker"}]
    (tmp_path / "dev").mkdir()
    (tmp_path / "dev" / "t.json").write_text(json.dumps({"traceEvents": events}))
    assert profiling.summarize_trace(str(tmp_path / "dev")) == [
        ("Memcpy HtoD", 3.0, 1), ("k1", 2.0, 2)]
    assert profiling.summarize_trace(str(tmp_path / "dev"), top=1) == [("Memcpy HtoD", 3.0, 1)]
    assert set(profiling.kernel_launches()) == {"K1", "K2", "K3", "K4", "K5", "K6", "K7",
                                                 "voxel_segment_sum", "cumsum_rows",
                                                 "xla_math"}

"""Plain reference of the map-based localizer's steady state, superblock by
superblock, as `run_chunk_fast` computes it (localization_node.cpp:263-374
with the superblock pipeline's per-block re-crop and slack check).

It imports nothing of the program: it derives the map from the raw map
tiles (voxel centroids, the Morton order the map is held in), crops it,
subsamples and crops the scans, and runs every frame's prior (odometry
prediction, covariance-weighted element-wise blend, stochastic gate) and
its lazy point-to-point ICP with a nearest-neighbour search of its own
(a uniform grid of cells over the crop, every candidate within one cell),
in plain PyTorch and NumPy. It starts from the program's start-up pose
(the brute-force search is not re-run; the start is checked against the
truth instead).

`point_dtype` is the precision of the point arithmetic (rebased
coordinates, distances, the Kabsch moments): float32 as configured, or a
lower one for the control. Poses, priors and the 3x3 solve are float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

F32 = np.float32
_BIG = 3.0e38


class Inputs(NamedTuple):
    """What the benchmark made and hands to both sides."""

    tiles: list  # map-frame (n, 3) float32 tensors, the mapping run's scans
    scans: list  # sensor-frame (n, 3) float32 tensors of the replayed frames
    odom: np.ndarray  # (1 + T, 4, 4) float32: frame 0 (start-up), then the replay
    gps: np.ndarray  # (1 + T, 4, 4) float32
    odom_tr: np.ndarray  # (1 + T,)
    gps_tr: np.ndarray  # (1 + T,)
    valid: np.ndarray  # (1 + T,) bool
    startup_pose: np.ndarray  # (4, 4) float32: the program's start-up result
    scan0: torch.Tensor  # sensor-frame (n, 3) float32: the start-up frame


class Frames(NamedTuple):
    """Per-frame outputs, (T, ...) host arrays."""

    pose: np.ndarray  # (T, 4, 4)
    iterations: np.ndarray
    n_corr: np.ndarray
    converged: np.ndarray
    recropped: np.ndarray
    slack_violation: np.ndarray
    icp_error: np.ndarray
    margin: np.ndarray  # distance from the hit threshold of a flipped stop (follow mode)


# --------------------------------------------------------------------------
# map and clouds
# --------------------------------------------------------------------------


def voxel_map(tiles: list, voxel: float) -> torch.Tensor:
    """Voxel centroids of the merged tiles (sums in float64, anchored at
    the data's minimum corner), in the order of their linear voxel ids."""
    pts = torch.cat([t.reshape(-1, 3) for t in tiles]).to(torch.float64)
    ijk = torch.floor((pts - pts.min(dim=0).values) / voxel).to(torch.int64)
    dims = ijk.max(dim=0).values + 1
    lin = (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]
    order = torch.argsort(lin, stable=True)
    lin, pts = lin[order], pts[order]
    first = torch.ones_like(lin, dtype=torch.bool)
    first[1:] = lin[1:] != lin[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    n = int(seg[-1]) + 1
    sums = torch.zeros((n, 3), dtype=torch.float64, device=pts.device).index_add_(0, seg, pts)
    cnt = torch.zeros(n, dtype=torch.float64, device=pts.device).index_add_(
        0, seg, torch.ones_like(seg, dtype=torch.float64))
    return (sums / cnt[:, None]).to(torch.float32)


def _spread(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_sorted(p: torch.Tensor) -> torch.Tensor:
    """Points in Z-order of 10-bit codes over their box, stable."""
    lo = p.min(dim=0).values
    extent = torch.clamp(p.max(dim=0).values - lo, min=1e-6)
    q = torch.clamp(((p - lo) / extent * 1024.0).to(torch.int64), 0, 1023)
    code = _spread(q[:, 0]) | (_spread(q[:, 1]) << 1) | (_spread(q[:, 2]) << 2)
    return p[torch.argsort(code, stable=True)]


def crop(points: torch.Tensor, center: torch.Tensor, radius: float, cap: int) -> torch.Tensor:
    """Points within `radius` of `center`, in their order, the first `cap`."""
    d = points - center
    keep = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] <= radius * radius
    return points[keep][:cap]


def scan_points(scan: torch.Tensor, step: int, radius: float) -> torch.Tensor:
    """Every `step`-th point in scan order, within `radius` of the sensor."""
    if scan.shape[0] >= step:
        scan = scan[::step]
    return scan[(scan * scan).sum(dim=1) <= radius * radius]


# --------------------------------------------------------------------------
# nearest neighbours
# --------------------------------------------------------------------------

_OFFS = torch.tensor([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)])


class Grid:
    """The crop's points bucketed in cubic cells a little wider than the
    gate radius, so every point within the gate of a query lies in the 27
    cells around it."""

    def __init__(self, tgt32: torch.Tensor, tgt: torch.Tensor, gate_sq: float):
        self.h = 1.01 * math.sqrt(gate_sq)
        self.dev = tgt32.device
        ijk = torch.floor(tgt32 / self.h).to(torch.int64)
        self.lo = ijk.min(dim=0).values - 1
        self.dims = ijk.max(dim=0).values - self.lo + 2
        key = self._lin(ijk - self.lo)
        self.order = torch.argsort(key, stable=True)  # ties keep crop order
        self.keys = key[self.order]
        self.tgt = tgt[self.order]
        self.offs = _OFFS.to(self.dev)

    def _lin(self, c):
        return (c[..., 0] * self.dims[1] + c[..., 1]) * self.dims[2] + c[..., 2]

    def nearest(self, q32: torch.Tensor, q: torch.Tensor):
        """(best d2 (N,) float32, index into the crop of the nearest point,
        the earliest in crop order on exact ties; -1 where no candidate)."""
        N = q.shape[0]
        c = torch.floor(q32 / self.h).to(torch.int64) - self.lo
        c = torch.minimum(torch.maximum(c, torch.ones_like(c)), self.dims - 2)
        nk = self._lin(c[:, None, :] + self.offs[None]).reshape(-1)
        a = torch.searchsorted(self.keys, nk, right=False)
        b = torch.searchsorted(self.keys, nk, right=True)
        cnt = b - a
        rep = torch.repeat_interleave(torch.arange(nk.numel(), device=self.dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        tj = a[rep] + torch.arange(rep.numel(), device=self.dev) - first[rep]
        qi = rep // 27
        diff = self.tgt[tj] - q[qi]
        d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] + diff[:, 2] * diff[:, 2]).float()
        best = torch.full((N,), _BIG, dtype=torch.float32, device=self.dev)
        best = best.scatter_reduce(0, qi, d2, "amin")
        hit = d2 == best[qi]
        crop_idx = self.order[tj]
        win = torch.full((N,), 1 << 62, dtype=torch.int64, device=self.dev)
        win = win.scatter_reduce(0, qi[hit], crop_idx[hit], "amin")
        return best, torch.where(win == (1 << 62), -1, win)


# --------------------------------------------------------------------------
# the 3x3 solve (float32 scalars)
# --------------------------------------------------------------------------


def _adj_t_over_det(X):
    a, b, c = X[0]
    d, e, f = X[1]
    g, h, i = X[2]
    A, B, C = e * i - f * h, f * g - d * i, d * h - e * g
    D, E, F = c * h - b * i, a * i - c * g, b * g - a * h
    G, H, I = b * f - c * e, c * d - a * f, a * e - b * d
    det = a * A + b * B + c * C
    cof = np.array([[A, B, C], [D, E, F], [G, H, I]], F32)
    with np.errstate(all="ignore"):
        return cof / det, det


def polar(H) -> tuple[np.ndarray, bool]:
    """Orthogonal polar factor by 8 Newton steps from H / |H|_F; not ok
    for a (near-)singular H."""
    ss = F32((H * H).sum())
    X = (H / np.sqrt(max(ss, F32(1e-20)))).astype(F32)
    _, det0 = _adj_t_over_det(X)
    ok = abs(det0) > 1e-6
    for _ in range(8):
        XiT, det = _adj_t_over_det(X)
        if abs(det) > 1e-12:
            X = (F32(0.5) * (X + XiT)).astype(F32)
    return X, bool(ok and np.isfinite(X).all())


def kabsch_step(W, Ss, St, Mst):
    Wc = max(W, F32(1.0))
    cs, ct = (Ss / Wc).astype(F32), (St / Wc).astype(F32)
    Hm = (Mst - W * np.outer(cs, ct)).astype(F32)
    R, ok = polar(Hm.T.copy())
    _, detH = _adj_t_over_det(Hm)
    return R, (ct - R @ cs).astype(F32), ok, detH


# --------------------------------------------------------------------------
# one frame: prior and lazy ICP
# --------------------------------------------------------------------------


def inv_T(T):
    out = np.eye(4, dtype=F32)
    out[:3, :3] = T[:3, :3].T
    out[:3, 3] = -(T[:3, :3].T @ T[:3, 3])
    return out


def rigid(R, t):
    out = np.eye(4, dtype=F32)
    out[:3, :3], out[:3, 3] = R, t
    return out


class Filter:
    """The stochastic gate's transition queue (stochastic_filter.cpp)."""

    def __init__(self, cfg: dict):
        self.Q = cfg["queue_size"]
        self.cfg = cfg
        self.trans = np.tile(np.eye(4, dtype=F32), (self.Q, 1, 1))
        self.count = 0
        self.prev = np.eye(4, dtype=F32)
        w = np.exp(np.arange(self.Q, dtype=F32) - F32(self.Q)).astype(F32)
        self.w = (w / w.sum()).astype(F32)

    def pushed(self, pose) -> "Filter":
        f = Filter.__new__(Filter)
        f.__dict__.update(self.__dict__)
        t = inv_T(self.prev) @ pose
        if self.count < self.Q:
            f.trans = self.trans.copy()
            f.trans[self.count] = t
        else:
            f.trans = np.concatenate([self.trans[1:], t[None]])
        f.count, f.prev = min(self.count + 1, self.Q), pose
        return f

    def gate(self, prev_pose, pose):
        c = self.cfg
        preds = np.einsum("ij,qjk->qik", prev_pose, self.trans)
        xyz = preds[:, :3, 3]
        mean = (self.w[:, None] * xyz).sum(axis=0)
        mad = (self.w[:, None] * np.abs(xyz - mean)).sum(axis=0)
        mad = np.clip(mad, c["min_distance_per_scan"], c["max_distance_per_scan"] / 3.0)
        z = 0.0 if self.count < self.Q else float((np.abs(pose[:3, 3] - mean) / mad).max())
        if z > c["z_score_threshold"]:
            return np.einsum("q,qij->ij", self.w,
                             np.einsum("qij,jk->qik", self.trans, prev_pose)).astype(F32)
        return pose


def icp_lazy(src32, grid: Grid, tgt, R, t, icp: dict, dtype, force: int | None = None):
    """The reference's lazy ICP (icp_point_to_point.cpp:185-254) in the
    rebased frame: associate at the prior; the alive set only shrinks; a
    plateau that is not a hit re-associates. With `force` the hit test is
    replaced by "`force` steps taken", so the run follows a program that
    stopped after `force` steps. Returns (R, t, err, n_corr, iterations,
    the mean error of each pass)."""
    gate, acc, eps = icp["max_correspondence_dist_sq"], icp["acceptable_mean_error"], \
        icp["transformation_epsilon"]
    src = src32.to(dtype)

    def moved(R, t):
        Rd = torch.from_numpy(R).to(src32.device)
        td = torch.from_numpy(t).to(src32.device)
        p32 = src32 @ Rd.T + td
        p = (src @ Rd.to(dtype).T + td.to(dtype)) if dtype != torch.float32 else p32
        return p32, p

    def assoc(R, t):
        p32, p = moved(R, t)
        d2, win = grid.nearest(p32, p)
        return d2, tgt[win.clamp(min=0)]

    def moments(R, t, txyz, w):
        _, p = moved(R, t)
        wd = w.to(dtype)
        d = p - txyz
        vals = torch.cat([
            w.float().sum()[None],
            (p * wd[:, None]).float().sum(dim=0),
            (txyz * wd[:, None]).float().sum(dim=0),
            ((p * wd[:, None]).T @ txyz).float().reshape(9),
            (wd * torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]))
            .float().sum()[None],
        ]).cpu().numpy().astype(F32)
        return vals[0], vals[1:4], vals[4:7], vals[7:16].reshape(3, 3), vals[16]

    R, t = R.astype(F32), t.astype(F32)
    d2, txyz = assoc(R, t)
    alive = d2 < gate
    n_corr = int(alive.sum())
    live = n_corr >= icp["min_correspondences"]
    err_prev, iters, passes = F32(_BIG), 0, []
    for _ in range(icp["num_iterations"]):
        if not live:
            break
        W, Ss, St, Mst, Eabs = moments(R, t, txyz, alive)
        err = F32(Eabs / max(W, F32(1.0)))
        passes.append(float(err))
        hit = err < acc if force is None else iters >= force
        if not hit and abs(err_prev - err) < eps:
            d2, txyz = assoc(R, t)
            alive = alive & (d2 < gate)
            W, Ss, St, Mst, _ = moments(R, t, txyz, alive)
        Rs, ts, ok, _ = kabsch_step(W, Ss, St, Mst)
        stop = hit or not ok
        if not stop:
            R, t = (Rs @ R).astype(F32), (Rs @ t + ts).astype(F32)
            iters += 1
        err_prev = err
        live = not stop
    return R, t, err_prev, n_corr, iters, passes


def flip_margin(passes: list, ref_iters: int, prog_iters: int, acc: float) -> float:
    """How far from the hit threshold the reference's mean error stood at
    the pass where the program decided otherwise (0 where they agree): a
    stop or a step that rounding alone can flip reads about 1e-8 m."""
    if prog_iters == ref_iters:
        return 0.0
    if prog_iters < ref_iters:  # the program hit first
        return passes[prog_iters] - acc if prog_iters < len(passes) else math.inf
    return acc - passes[ref_iters] if ref_iters < len(passes) else math.inf


# --------------------------------------------------------------------------
# start-up: brute force, then the rescue ICP on a miss
# --------------------------------------------------------------------------


def sample_to_capacity(points: torch.Tensor, cap: int) -> torch.Tensor:
    """An even stride over the points when they exceed `cap`, all of them
    otherwise, in their order."""
    n = points.shape[0]
    idx = (torch.arange(cap, device=points.device) * n) // cap
    keep = idx < n
    keep[1:] &= idx[1:] != idx[:-1]
    return points[idx[keep]]


def outward(rng: float, step: float) -> np.ndarray:
    """0, -0, -s, s, -2s, 2s, ... (brute_force_alignment.cpp:160-179)."""
    vals, i = [], 0
    while i < rng / (2.0 * step) + 1.0:
        vals += [-i * step, i * step]
        i += 1
    return np.asarray(vals, F32)


def rot_z(yaw: torch.Tensor) -> torch.Tensor:
    c, s_ = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, -s_, z, s_, c, z, z, z, o], dim=-1).reshape(yaw.shape + (3, 3))


def brute_force(src: torch.Tensor, tgt: torch.Tensor, guess: np.ndarray, bf: dict,
                chunk: int = 64):
    """The first candidate in nesting order (x, y, z, yaw) whose mean
    squared nearest distance (float64) is under the threshold, else the
    best: (success, pose (4, 4) float32)."""
    dev = src.device
    X, Y, Z, W = np.meshgrid(outward(bf["x_range"], bf["x_step"]),
                             outward(bf["y_range"], bf["y_step"]),
                             outward(bf["z_range"], bf["z_step"]),
                             outward(bf["yaw_range"], bf["yaw_step"]), indexing="ij")
    offs = torch.from_numpy(np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1)).to(dev)
    yaws = torch.from_numpy(W.ravel()).to(dev)
    g = torch.from_numpy(guess).to(dev)
    cand = torch.zeros((offs.shape[0], 4, 4), dtype=torch.float32, device=dev)
    cand[:, :3, :3], cand[:, :3, 3], cand[:, 3, 3] = rot_z(yaws), offs, 1.0
    cand = g @ cand
    t64 = (tgt - g[:3, 3]).to(torch.float64)
    tn = (t64 * t64).sum(dim=1)
    best_i, best_s = 0, math.inf
    for c0 in range(0, cand.shape[0], chunk):
        T = cand[c0:c0 + chunk]
        p = (torch.einsum("kij,nj->kni", T[:, :3, :3], src) + T[:, None, :3, 3] - g[:3, 3])
        p = p.reshape(-1, 3).to(torch.float64)
        d2 = (p * p).sum(dim=1)[:, None] - 2.0 * (p @ t64.T) + tn[None]
        score = d2.amin(dim=1).clamp(min=0.0).reshape(T.shape[0], -1).mean(dim=1)
        hits = torch.nonzero(score < bf["mean_error_threshold"]).flatten()
        if hits.numel():
            return True, cand[c0 + int(hits[0])].cpu().numpy()
        j = int(torch.argmin(score))
        if float(score[j]) < best_s:
            best_i, best_s = c0 + j, float(score[j])
    return False, cand[best_i].cpu().numpy()


def kabsch_svd(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor):
    """Weighted Kabsch by SVD, the reflection fixed on V's last column
    (icp_point_to_point.cpp:112-159)."""
    wsum = max(float(w.sum()), 1e-12)
    cs = (p * w[:, None]).sum(dim=0) / wsum
    ct = (q * w[:, None]).sum(dim=0) / wsum
    H = (((p - cs) * w[:, None]).T @ (q - ct)).cpu().numpy().astype(F32)
    U, _, Vh = np.linalg.svd(H)
    V = Vh.T.copy()
    if np.linalg.det(V @ U.T) < 0:
        V[:, 2] *= -1
    R = (V @ U.T).astype(F32)
    return R, (ct.cpu().numpy() - R @ cs.cpu().numpy()).astype(F32)


def icp_rescue(src: torch.Tensor, tgt: torch.Tensor, T0: np.ndarray, icp: dict):
    """The rescue ICP (icp_point_to_point.cpp:185-254 with SVD Kabsch) from
    T0 in the frame rebased on T0's translation: (converged, pose)."""
    gate, acc, eps = icp["max_correspondence_dist_sq"], icp["acceptable_mean_error"], \
        icp["transformation_epsilon"]
    dev = src.device
    c = T0[:3, 3].copy()
    cd = torch.from_numpy(c).to(dev)
    rb = tgt - cd
    grid = Grid(rb, rb, gate)
    R0 = torch.from_numpy(T0[:3, :3].copy()).to(dev)
    pts = src @ R0.T + (torch.from_numpy(T0[:3, 3].copy()).to(dev) - cd)

    def assoc(pts):
        d2, win = grid.nearest(pts, pts)
        return d2 < gate, rb[win.clamp(min=0)]

    alive, corr = assoc(pts)
    enough = int(alive.sum()) >= icp["min_correspondences"]
    R, t = T0[:3, :3].astype(F32), (T0[:3, 3] - c).astype(F32)
    last, i, done = F32(_BIG), 0, not enough
    err = last
    while i < icp["num_iterations"] and not done:
        w = alive.float()
        d = pts - corr
        err = F32(float((w * torch.sqrt((d * d).sum(dim=1))).sum()) / max(float(w.sum()), 1.0))
        hit = err < acc
        if not hit and abs(last - err) < eps:
            now, corr_new = assoc(pts)
            alive = alive & now
            corr = torch.where(alive[:, None], corr_new, corr)
        Rs, ts = kabsch_svd(pts, corr, alive.float())
        if not hit:
            R, t = (Rs @ R).astype(F32), (Rs @ t + ts).astype(F32)
            pts = pts @ torch.from_numpy(Rs).to(dev).T + torch.from_numpy(ts).to(dev)
            i += 1
        last = err
        done = hit
    if not enough:
        return False, T0
    return bool(last < acc), rigid(R, t + c)


def startup(scan0: torch.Tensor, mp: torch.Tensor, gps0: np.ndarray, cfg: dict):
    """One coarse attempt on frame 0 (localization_node.cpp:200-261): the
    map cropped around the GPS fix, the brute-force clouds (the crop by
    distance from the fix, every 3rd point, the floor removed, sampled to
    capacity; the scan's crop without its floor, sampled), brute force
    around the fix, the rescue ICP on a miss. Returns (success, pose)."""
    cap, radius = cfg["capacity"], cfg["cloud_crop_radius"]
    dev = mp.device
    sc = scan0[:: cfg["scan_subsample_step"]] if scan0.shape[0] >= cfg["scan_subsample_step"] \
        else scan0
    sc = morton_sorted(sc)[: cap["scan"]]
    sc = sc[(sc[:, 0] * sc[:, 0] + sc[:, 1] * sc[:, 1] + sc[:, 2] * sc[:, 2]) <= radius * radius]
    center = torch.from_numpy(gps0[:3, 3].copy()).to(dev)
    cm = crop(mp, center, radius, cap["cropped_map"])
    d = cm - center
    cm = cm[torch.argsort(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2], stable=True)]
    step = cfg["brute_force_map_subsample_step"]
    if cm.shape[0] >= step:
        cm = cm[::step]
    bf_map = sample_to_capacity(cm[cm[:, 2] > 0.0], cap["bf_target"])
    bf_scan = sample_to_capacity(sc[sc[:, 2] > 0.0], cap["bf_source"])
    ok, T = brute_force(bf_scan, bf_map, gps0.astype(F32), cfg["brute_force"])
    if ok:
        return True, T
    return icp_rescue(bf_scan, bf_map, T, cfg["rescue_icp"])


# --------------------------------------------------------------------------
# the replay
# --------------------------------------------------------------------------


def prepared_map(tiles: list, cfg: dict) -> torch.Tensor:
    """The map as the localizer holds it: voxel centroids, every
    `map_subsample_step`-th, in Z-order."""
    mp = voxel_map(tiles, cfg["map_voxel_size"])[:: cfg["map_subsample_step"]]
    return morton_sorted(mp)


def run(inp: Inputs, cfg: dict, point_dtype=torch.float32, mp=None, follow=None,
        frames: range | None = None) -> Frames:
    """The replayed frames, superblock by superblock, from the start-up
    state: pose = the program's start-up pose, odometry reference = frame
    0's, the map cropped around frame 0's GPS fix, an empty filter queue,
    the start-up slack.

    Without `follow` the reference runs free on its own poses (the
    control, in the program's place). With `follow` = (poses (T + 1, 4,
    4), iterations (T + 1,)) of the program, indexed by frame, it follows
    the program step by step: every prior, the filter queue, the crops and
    the slack check come from the program's previous poses, and each frame
    of `frames` gets its own ICP from that prior (run to the program's
    step count where the reference's own hit test decides otherwise, its
    `margin` saying how near the threshold that decision was). Frames
    before `frames` are only followed, not registered."""
    loc, icp, cap = cfg, cfg["icp"], cfg["capacity"]
    dev = inp.tiles[0].device
    K = loc["superstep"]
    radius, acc = loc["cloud_crop_radius"], icp["acceptable_mean_error"]
    if mp is None:
        mp = prepared_map(inp.tiles, cfg)
    T = len(inp.scans)
    if T % K:
        raise ValueError(f"{T} frames is not a whole number of superblocks of {K}")
    frames = frames or range(1, T + 1)

    def recrop(center):
        c32 = torch.from_numpy(center).to(dev)
        rebased = crop(mp, c32, radius, cap["cropped_map"]) - c32
        return rebased, center

    pose = inp.startup_pose.astype(F32)
    odom_prev = inp.odom[0]
    ref_T = inp.gps[0]
    tgt32, center = recrop(ref_T[:3, 3].copy())
    grid = None
    filt = Filter(cfg["filter"])
    extra = F32(loc["startup_slack"])
    out = {k: [] for k in Frames._fields}
    for b0 in range(1, frames.stop, K):
        ks = range(b0, b0 + K)
        valid = inp.valid[b0:b0 + K]
        pred = [pose @ (inv_T(odom_prev) @ inp.odom[k]) for k in ks]
        any_valid = bool(valid.any())
        end_dist = float(np.linalg.norm(pred[-1][:3, 3] - ref_T[:3, 3]))
        need = (end_dist > loc["ref_frame_distance"] or tgt32.shape[0] == 0) and any_valid
        if need:
            ref_T = pred[K // 2]
            tgt32, center = recrop(ref_T[:3, 3].copy())
            grid = None
        tot = inp.odom_tr[b0:b0 + K] + inp.gps_tr[b0:b0 + K]
        og, gg = inp.gps_tr[b0:b0 + K] / tot, inp.odom_tr[b0:b0 + K] / tot
        pull = np.array([gg[j] * np.linalg.norm(inp.gps[k][:3, 3] - pred[j][:3, 3])
                         if valid[j] else 0.0 for j, k in enumerate(ks)], F32)
        pull = np.maximum.accumulate(pull) + extra
        for j, k in enumerate(ks):
            odom_pred = pose @ (inv_T(odom_prev) @ inp.odom[k])
            prior = (og[j] * odom_pred + gg[j] * inp.gps[k]).astype(F32)
            filt_new = filt.pushed(prior)
            prior = filt_new.gate(pose, prior)
            Rg, tg = prior[:3, :3].copy(), prior[:3, 3].copy()
            if k in frames:
                it = nc = 0
                conv, err, margin, mine = False, 0.0, 0.0, rigid(Rg, tg)
                if valid[j]:
                    if grid is None:
                        tgt = tgt32.to(point_dtype)
                        grid = Grid(tgt32, tgt, icp["max_correspondence_dist_sq"])
                    src = scan_points(inp.scans[k - 1], loc["scan_subsample_step"], radius)
                    R, t, err, nc, it, passes = icp_lazy(src, grid, tgt, Rg, tg - center, icp,
                                                         point_dtype)
                    hit = err < acc
                    if follow is not None and follow[1][k] != it:
                        margin = flip_margin(passes, it, int(follow[1][k]), acc)
                        R, t, err, _, n, _ = icp_lazy(src, grid, tgt, Rg, tg - center, icp,
                                                      point_dtype, force=int(follow[1][k]))
                        hit = n < icp["num_iterations"] or err < acc
                    enough = nc >= icp["min_correspondences"]
                    mine = rigid(R, t + center) if enough else rigid(Rg, tg)
                    conv = bool(enough and hit)
                    it = it if enough else 0
                slack = float(np.linalg.norm(prior[:3, 3] - pred[j][:3, 3]))
                budget = loc["slack_base"] + loc["superstep_slack"] * j + pull[j]
                out["pose"].append(mine)
                out["iterations"].append(it)
                out["n_corr"].append(nc)
                out["converged"].append(conv)
                out["recropped"].append(bool(need and j == 0))
                out["slack_violation"].append(bool(valid[j] and slack > budget))
                out["icp_error"].append(float(err))
                out["margin"].append(margin)
                if follow is None and valid[j]:
                    pose = mine
            if follow is not None:
                pose = follow[0][k].astype(F32)
            if valid[j]:
                odom_prev, filt = inp.odom[k], filt_new
        if any_valid:
            extra = F32(0.0)
    return Frames(*[np.asarray(out[k]) for k in Frames._fields])

"""Offline visualization exports — the rviz-config equivalent (SURVEY C15);
a NumPy copy of the JAX package's `utils/viz.py` (the same bytes out).

No ROS/rviz on the card's host; instead the engine exports standard
artifacts for any viewer:

* `write_ply` — map clouds / scans as ASCII PLY (MeshLab, CloudCompare);
* `write_trajectory_ply` — a pose track as colored points;
* `plot_topdown` — a self-contained SVG of the top-down trajectory vs
  ground truth over the map footprint (no plotting dependency);
* `write_html_viewer` — a self-contained interactive 3-D viewer.
"""

from __future__ import annotations

import numpy as np


def write_ply(path: str, points: np.ndarray, color=(180, 180, 180)) -> None:
    points = np.asarray(points, np.float32).reshape(-1, 3)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(points)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        r, g, b = color
        for p in points:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")


def write_trajectory_ply(path: str, poses: np.ndarray, color=(255, 40, 40)) -> None:
    """Poses (T, 4, 4) -> their translations as a colored PLY track."""
    write_ply(path, np.asarray(poses)[:, :3, 3], color)


def _polyline(xy: np.ndarray, sx, sy, style: str) -> str:
    pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in xy)
    return f'<polyline fill="none" {style} points="{pts}"/>'


def plot_topdown(
    path: str,
    est_poses: np.ndarray,
    gt_poses: np.ndarray | None = None,
    map_points: np.ndarray | None = None,
    size: int = 900,
) -> None:
    """Write a standalone SVG: map footprint (gray), ground truth (black),
    estimate (red). Dependency-free."""
    est = np.asarray(est_poses)[:, :3, 3]
    all_xy = [est[:, :2]]
    if gt_poses is not None:
        all_xy.append(np.asarray(gt_poses)[:, :3, 3][:, :2])
    if map_points is not None:
        mp = np.asarray(map_points)
        if len(mp) > 20000:
            mp = mp[:: len(mp) // 20000 + 1]
        all_xy.append(mp[:, :2])
    xy = np.concatenate(all_xy)
    lo = xy.min(axis=0) - 2
    hi = xy.max(axis=0) + 2
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1e-6))
    margin = 20

    def sx(x):
        return margin + (x - lo[0]) / span * (size - 2 * margin)

    def sy(y):
        return size - margin - (y - lo[1]) / span * (size - 2 * margin)

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}" '
        f'viewBox="0 0 {size} {size}"><rect width="100%" height="100%" fill="white"/>'
    ]
    if map_points is not None:
        for x, y in mp[:, :2]:
            parts.append(
                f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="0.7" fill="#cccccc"/>'
            )
    if gt_poses is not None:
        parts.append(
            _polyline(
                np.asarray(gt_poses)[:, :3, 3][:, :2], sx, sy,
                'stroke="#222222" stroke-width="1.5"',
            )
        )
    parts.append(
        _polyline(est[:, :2], sx, sy, 'stroke="#d62728" stroke-width="1.5"')
    )
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("".join(parts))


_HTML_VIEWER_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>slam-sensor-fusion-tpu viewer</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:12px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px 10px;
      border-radius:4px;line-height:1.6}
 #hud label{display:block;cursor:pointer}
 canvas{display:block}
</style></head><body>
<div id="hud">
 <b>slam-sensor-fusion-tpu</b><br>
 drag: orbit &middot; shift-drag: pan &middot; wheel: zoom<br>
 <span id="layers"></span>
 <input id="t" type="range" min="0" max="0" value="0" style="width:160px">
 <span id="ti"></span>
</div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; const resize = () => { W = cv.width = innerWidth; H = cv.height = innerHeight; };
addEventListener('resize', () => { resize(); draw(); }); resize();
let yaw = 0.7, pitch = 0.9, dist = DATA.extent * 2.2, cx = DATA.center;
let panX = 0, panY = 0;
const layers = {};
for (const k of Object.keys(DATA.clouds).concat(Object.keys(DATA.tracks))) {
  layers[k] = true;
  const l = document.createElement('label');
  l.innerHTML = `<input type="checkbox" checked> ${k}`;
  l.firstChild.onchange = e => { layers[k] = e.target.checked; draw(); };
  document.getElementById('layers').appendChild(l);
}
const tSlider = document.getElementById('t');
const maxT = Math.max(0, ...Object.values(DATA.tracks).map(t => t.length - 1));
tSlider.max = maxT; tSlider.value = maxT;
tSlider.oninput = () => { draw(); };
function proj(p) {
  const sy = Math.sin(yaw), cyw = Math.cos(yaw), sp = Math.sin(pitch), cp = Math.cos(pitch);
  const x = p[0] - cx[0], y = p[1] - cx[1], z = p[2] - cx[2];
  const x1 = cyw * x + sy * y, y1 = -sy * x + cyw * y;
  const y2 = cp * y1 + sp * z, z2 = -sp * y1 + cp * z;
  const s = (0.8 * Math.min(W, H)) / dist;
  return [W / 2 + x1 * s + panX, H / 2 - z2 * s + panY, y2];
}
function draw() {
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, W, H);
  for (const [name, c] of Object.entries(DATA.clouds)) {
    if (!layers[name]) continue;
    ctx.fillStyle = c.color;
    const pts = c.points;
    for (let i = 0; i < pts.length; i++) {
      const q = proj(pts[i]);
      ctx.fillRect(q[0], q[1], c.size, c.size);
    }
  }
  const tEnd = +tSlider.value;
  document.getElementById('ti').textContent = ` frame ${tEnd}/${maxT}`;
  for (const [name, tr] of Object.entries(DATA.tracks)) {
    if (!layers[name]) continue;
    ctx.strokeStyle = tr.color; ctx.lineWidth = 2; ctx.beginPath();
    const n = Math.min(tEnd + 1, tr.length);
    for (let i = 0; i < n; i++) {
      const q = proj(tr.xyz[i]);
      if (i === 0) ctx.moveTo(q[0], q[1]); else ctx.lineTo(q[0], q[1]);
    }
    ctx.stroke();
    if (n > 0) {  // pose marker (axes) at the slider frame
      const i = n - 1, q0 = proj(tr.xyz[i]);
      if (tr.axes) {
        const ax = tr.axes[i];
        for (const [a, col] of [[0, '#f44'], [1, '#4f4'], [2, '#48f']]) {
          const tip = proj([tr.xyz[i][0] + ax[a][0], tr.xyz[i][1] + ax[a][1],
                            tr.xyz[i][2] + ax[a][2]]);
          ctx.strokeStyle = col; ctx.beginPath();
          ctx.moveTo(q0[0], q0[1]); ctx.lineTo(tip[0], tip[1]); ctx.stroke();
        }
      }
      ctx.fillStyle = tr.color; ctx.beginPath();
      ctx.arc(q0[0], q0[1], 4, 0, 7); ctx.fill();
    }
  }
}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) { panX += dx; panY += dy; }
  else { yaw += dx * 0.008; pitch = Math.max(0.05, Math.min(1.5, pitch + dy * 0.008)); }
  drag = [e.clientX, e.clientY, drag[2]]; draw();
});
addEventListener('wheel', e => { dist *= e.deltaY > 0 ? 1.1 : 0.9; draw(); });
draw();
</script></body></html>
"""


def write_html_viewer(
    path: str,
    map_points: np.ndarray | None = None,
    est_poses: np.ndarray | None = None,
    gt_poses: np.ndarray | None = None,
    gps_poses: np.ndarray | None = None,
    odom_poses: np.ndarray | None = None,
    scan_points: np.ndarray | None = None,
    max_points: int = 60000,
) -> None:
    """Self-contained interactive 3D viewer — the live-visualization
    equivalent of the reference's rviz config (visualizer.rviz: map +
    scan clouds, fine/GPS/odometry pose displays). One HTML file, zero
    dependencies: canvas orbit/pan/zoom, per-display toggles, a frame
    slider that scrubs the pose tracks (the "live" axis of an offline
    replay). Open in any browser.
    """
    import json as _json

    clouds: dict = {}
    tracks: dict = {}

    def decimate(pts):
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        if len(pts) > max_points:
            pts = pts[:: len(pts) // max_points + 1]
        return pts

    if map_points is not None and len(map_points):
        clouds["map"] = {
            "points": decimate(map_points).round(3).tolist(),
            "color": "#555", "size": 1,
        }
    if scan_points is not None and len(scan_points):
        clouds["scan"] = {
            "points": decimate(scan_points).round(3).tolist(),
            "color": "#fa0", "size": 2,
        }

    def track(poses, color, with_axes=False, axis_len=2.0):
        poses = np.asarray(poses, np.float32)
        xyz = poses[:, :3, 3]
        entry = {
            "xyz": xyz.round(3).tolist(),
            "length": len(xyz),
            "color": color,
        }
        if with_axes:
            entry["axes"] = (poses[:, :3, :3].transpose(0, 2, 1) * axis_len).round(
                3
            ).tolist()
        return entry

    if est_poses is not None and len(est_poses):
        tracks["map_T_sensor (fine)"] = track(est_poses, "#f33", with_axes=True)
    if gt_poses is not None and len(gt_poses):
        tracks["ground truth"] = track(gt_poses, "#eee")
    if gps_poses is not None and len(gps_poses):
        tracks["map_T_sensor_gps"] = track(gps_poses, "#3af")
    if odom_poses is not None and len(odom_poses):
        tracks["odom_T_sensor"] = track(odom_poses, "#3f6")

    all_xyz = [np.asarray(c["points"]) for c in clouds.values() if c["points"]]
    all_xyz += [np.asarray(t["xyz"]) for t in tracks.values()]
    if all_xyz:
        xyz = np.concatenate(all_xyz)
        center = xyz.mean(axis=0)
        extent = float(max(np.abs(xyz - center).max(), 1.0))
    else:
        center, extent = np.zeros(3), 10.0

    data = {
        "clouds": clouds,
        "tracks": tracks,
        "center": center.round(3).tolist(),
        "extent": round(extent, 3),
    }
    with open(path, "w") as f:
        f.write(_HTML_VIEWER_TEMPLATE.replace("__DATA__", _json.dumps(data)))

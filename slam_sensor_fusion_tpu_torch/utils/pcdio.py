"""PCD point-cloud file IO (binary + ascii), plus the reference's text logs.

Replaces pcl::io::loadPCDFile / savePCDFileBinary
(global_map_frames_manager.cpp:101,148; map_data_save_node.cpp:74) and the
two text log formats (map_data_save_node.cpp:84-98):

  odometry_positions.txt  header "tx ty tz",  rows "%g %g %g"
  gps_imu_poses.txt       header "lat lon alt y", rows fixed 8-decimals

A native C++ fast path for binary PCD parsing lives in csrc/ (utils/native
loads it via ctypes); this module is the always-available pure-Python
implementation and the fallback. A copy of the JAX package's
`utils/pcdio.py`.
"""

from __future__ import annotations

import os

import numpy as np

_HEADER_FIELDS = (
    "VERSION",
    "FIELDS",
    "SIZE",
    "TYPE",
    "COUNT",
    "WIDTH",
    "HEIGHT",
    "VIEWPOINT",
    "POINTS",
    "DATA",
)


def write_pcd(path: str, points: np.ndarray, binary: bool = True) -> None:
    """Write an (n, 3) float32 cloud as PCD (x y z)."""
    points = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    n = points.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(points.tobytes())
        else:
            np.savetxt(f, points, fmt="%.8g")


def read_pcd(path: str) -> np.ndarray:
    """Read a PCD file; returns the (n, 3) xyz float32 columns.

    Supports binary and ascii DATA with arbitrary extra fields (xyz
    extracted); binary_compressed is not supported (the reference never
    writes it).
    """
    with open(path, "rb") as f:
        header: dict[str, list[str]] = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, *vals = line.split()
            if key in _HEADER_FIELDS:
                header[key] = vals
            if key == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0]

        np_types = []
        names = []
        for fld, sz, ty, ct in zip(fields, sizes, types, counts):
            base = {"F": "f", "I": "i", "U": "u"}[ty] + str(sz)
            for c in range(ct):
                names.append(fld if ct == 1 else f"{fld}_{c}")
                np_types.append(base)
        dtype = np.dtype({"names": names, "formats": np_types})

        if mode == "binary":
            raw = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
        elif mode == "ascii":
            raw = np.loadtxt(f, dtype=dtype, max_rows=n)
            raw = np.atleast_1d(raw)
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")

    out = np.empty((n, 3), np.float32)
    for i, axis in enumerate(("x", "y", "z")):
        out[:, i] = raw[axis].astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# Reference text log formats
# ---------------------------------------------------------------------------

ODOM_HEADER = "tx ty tz"
GPS_HEADER = "lat lon alt y"


def write_odometry_positions(path: str, positions: np.ndarray) -> None:
    """odometry_positions.txt (map_data_save_node.cpp:24-25,84-88)."""
    positions = np.asarray(positions, np.float64).reshape(-1, 3)
    with open(path, "w") as f:
        f.write(ODOM_HEADER + "\n")
        for p in positions:
            f.write(f"{p[0]:g} {p[1]:g} {p[2]:g}\n")


def read_odometry_positions(path: str) -> np.ndarray:
    """Parse odometry_positions.txt, skipping the header line
    (global_map_frames_manager.cpp:8-33)."""
    if not os.path.exists(path):
        return np.zeros((0, 3))
    return np.atleast_2d(np.loadtxt(path, skiprows=1, ndmin=2))


def write_gps_imu_poses(path: str, rows: np.ndarray) -> None:
    """gps_imu_poses.txt with fixed 8-decimal precision
    (map_data_save_node.cpp:92-98)."""
    rows = np.asarray(rows, np.float64).reshape(-1, 4)
    with open(path, "w") as f:
        f.write(GPS_HEADER + "\n")
        for r in rows:
            f.write(f"{r[0]:.8f} {r[1]:.8f} {r[2]:.8f} {r[3]:.8f}\n")


def read_gps_imu_poses(path: str) -> np.ndarray:
    """Parse gps_imu_poses.txt (global_map_frames_manager.cpp:35-67)."""
    if not os.path.exists(path):
        return np.zeros((0, 4))
    return np.atleast_2d(np.loadtxt(path, skiprows=1, ndmin=2))

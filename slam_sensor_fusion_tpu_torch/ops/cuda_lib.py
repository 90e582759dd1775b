"""Build and load the package's CUDA kernels (csrc/*.cu) at first use.

One `nvcc` per source, all started together, compiles each kernel to an
object; one more links them into a shared library with a plain C
interface, loaded through ctypes: seconds, against minutes for a build
that includes PyTorch's headers. The library lands in `_build/` inside the
package (listed in .gitignore) and is rebuilt whenever a source is newer
than it. Nothing here runs at import time: a host without a card
or a CUDA toolkit imports the package and runs the plain versions.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
LIB = os.path.join(BUILD, "libsfk.so")

#: -fmad=false: no fused multiply-add contraction, so distances and moment
#: sums round like the plain PyTorch versions (eager torch never fuses).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-lineinfo",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: the widest source tile the registration kernels take (K1-K7; the JAX
#: package's stress configuration and its autosize rule use 4096)
MAX_TILE_SRC = 4096

_lib: ctypes.CDLL | None = None
#: seconds the last build in this process took (0.0 before any build)
build_seconds = 0.0
#: nvcc's output of the last build (ptxas register and shared-memory use)
build_log = ""


def _sources() -> list[str]:
    return sorted(
        glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into _build/libsfk.so unless it is current."""
    global build_seconds, build_log
    srcs = _sources()
    newest = max(os.path.getmtime(s) for s in srcs)
    if not force and os.path.exists(LIB) and os.path.getmtime(LIB) >= newest:
        return LIB
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    cus = [s for s in srcs if s.endswith(".cu")]
    objs = [os.path.join(BUILD, f"{os.path.basename(s)[:-3]}.{os.getpid()}.o") for s in cus]
    tmp = f"{LIB}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(cus, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [s for s, p in zip(cus, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs],
            capture_output=True, text=True,
        )
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    build_seconds = time.perf_counter() - t0
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, LIB)  # atomic: a concurrent loader sees old or new, whole
    return LIB


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build())
        _declare(_lib)
    return _lib


def _declare(so: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    so.sfk_pair_nn.argtypes = [P] * 5 + [I] * 4 + [P] * 6
    so.sfk_pair_nn.restype = I
    so.sfk_pair_nn_grid.argtypes = [I] * 2 + [P] * 3
    so.sfk_pair_nn_grid.restype = I
    so.sfk_superblock_fine.argtypes = [P] * 27 + [I] * 6 + [P, P]
    so.sfk_superblock_fine.restype = I
    so.sfk_superblock_grid.argtypes = [I] * 3 + [P] * 3
    so.sfk_superblock_grid.restype = I
    so.sfk_icp_fused.argtypes = [P] * 12 + [I] * 3 + [P, P]
    so.sfk_icp_fused.restype = I
    so.sfk_icp_grid.argtypes = [I] * 2 + [P] * 3
    so.sfk_icp_grid.restype = I
    so.sfk_p2p_fused.argtypes = [P] * 13 + [I] * 3 + [P, P]
    so.sfk_p2p_fused.restype = I
    so.sfk_p2p_grid.argtypes = [I] * 2 + [P] * 3
    so.sfk_p2p_grid.restype = I
    so.sfk_p2p_associate.argtypes = [P] * 10 + [I] * 4 + [P]
    so.sfk_p2p_associate.restype = I
    so.sfk_p2p_assoc_grid.argtypes = [I] * 2 + [P] * 3
    so.sfk_p2p_assoc_grid.restype = I
    so.sfk_p2p_gn_cluster.argtypes = [I] * 2 + [P] * 3
    so.sfk_p2p_gn_cluster.restype = I
    so.sfk_p2p_gn_corr.argtypes = [P] * 6 + [I] * 2 + [P, P]
    so.sfk_p2p_gn_corr.restype = I
    so.sfk_lio_superblock.argtypes = [P] * 27 + [I] * 6 + [P, P]
    so.sfk_lio_superblock.restype = I
    so.sfk_lio_grid.argtypes = [I] * 2 + [P] * 3
    so.sfk_lio_grid.restype = I
    so.sfk_segment_sum_sorted.argtypes = [P] * 2 + [I] * 3 + [P, P]
    so.sfk_segment_sum_sorted.restype = I
    L = ctypes.c_longlong
    so.sfk_cumsum_rows.argtypes = [P, I, I, P, P, L, P]
    so.sfk_cumsum_rows.restype = I
    so.sfk_cumsum_scratch_floats.argtypes = [I, I]
    so.sfk_cumsum_scratch_floats.restype = L
    so.sfk_xla_math.argtypes = [I, P, P, P, P, P, P] + [L] * 11 + [P]
    so.sfk_xla_math.restype = I
    so.sfk_xla_ew.argtypes = [I, P, P, P, I, P, P, L, P]
    so.sfk_xla_ew.restype = I
    so.sfk_xla_ew_strided.argtypes = [I, P, P, P, P, P] + [L] * 17 + [P]
    so.sfk_xla_ew_strided.restype = I
    for counter in (so.sfk_xla_math_kernel_launches, so.sfk_cumsum_kernel_launches):
        counter.argtypes = []
        counter.restype = L


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


#: int32 words of a grid kernel's control block (csrc/grid_assoc.cuh `Ctl`)
CTL_WORDS = 16


def control_block(device: torch.device) -> torch.Tensor:
    """The control block a cooperative grid kernel's leader publishes its
    rounds in; the kernel writes it before it reads it."""
    return torch.empty(CTL_WORDS, dtype=torch.int32, device=device)


def grid_shape(fn, *shape: int, keys=("blocks", "threads", "per_sm")) -> dict:
    """Ask a `sfk_*_grid` launcher for the grid it launches: blocks, threads
    a block and the blocks a multiprocessor could hold (or the three values
    named by `keys`)."""
    out = [ctypes.c_int(0) for _ in range(3)]
    check(fn(*shape, *[ctypes.byref(o) for o in out]), fn.__name__)
    return dict(zip(keys, (o.value for o in out)))


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tile_src(what: str, TM: int) -> None:
    """The registration kernels' one tile-shape rule (K1-K7 on the card):
    a source tile of 32 to MAX_TILE_SRC rows in steps of 32 (whole warps);
    raise otherwise."""
    if not (32 <= TM <= MAX_TILE_SRC and TM % 32 == 0):
        raise ValueError(f"{what}: tile_src {TM} must be a multiple of 32 from 32 to "
                         f"{MAX_TILE_SRC}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` and `shape` on
    `device` (what a kernel reads through a raw pointer)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")

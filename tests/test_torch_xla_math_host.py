"""csrc/xla_math.cu built for the host CPU (g++, its CUDA intrinsics mapped
to the C library's `fma` / `fmaf`, one thread running every grid-stride
item and block), driven through the port's own wrappers, against the plain
versions bit for bit: the kernel's arithmetic and the wrappers' shapes,
strides and packing are checked without a card. Imports nothing of JAX.
The kernel on the card is held to the same plain versions by
tests/test_torch_cuda.py and chip_smoke.py's phase 15."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu_torch.ops import cuda_lib
from slam_sensor_fusion_tpu_torch.ops import xla_math as xm
from torch_lio_world import XLA_MATH_CASES, xla_math_cases

#: what the CUDA source needs of the CUDA toolkit, for a host build
_SHIM = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __launch_bounds__(x)
#define __restrict__
struct Dim3 { unsigned x, y, z; };
static const Dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1}, gridDim{1, 1, 1};
static inline void __syncthreads() {}
static inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
static inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
static inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
static inline int32_t __float_as_int(float f) { int32_t u; memcpy(&u, &f, 4); return u; }
static inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
static inline float __int_as_float(int32_t u) { float f; memcpy(&f, &u, 4); return f; }
"""

_ENTRY = r"""
extern "C" void host_xla_math(int fn, const float* a, const float* b, const float* c, int mask,
                              float* o0, float* o1, float* o2, long long n,
                              const long long* params) {
  Params prm = {};
  for (int k = 0; k < 10; ++k) prm.v[k] = params[k];
  xla_math_kernel(fn, a, b, c, mask, o0, o1, o2, n, prm);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/xla_math.cu's kernel compiled for the host, as a ctypes function
    (skips where there is no g++). No contraction (-ffp-contract=off): each
    float operation rounds once, as under nvcc's -fmad=false."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    src = open(os.path.join(cuda_lib.CSRC, "xla_math.cu")).read()
    src = src.replace("#include <cuda_runtime.h>", _SHIM)
    src = src[: src.index("}  // namespace")] + "}  // namespace\n" + _ENTRY
    d = tmp_path_factory.mktemp("xla_math_host")
    (d / "xla_math_host.cpp").write_text(src)
    lib = d / "libxla_math_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fno-fast-math", "-shared",
                    "-fPIC", "-o", str(lib), str(d / "xla_math_host.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    P = ctypes.c_void_p
    so.host_xla_math.argtypes = [ctypes.c_int, P, P, P, ctypes.c_int, P, P, P, ctypes.c_longlong, P]
    return so.host_xla_math


def _route_to_host(host_kernel, monkeypatch) -> None:
    """Route the port's float32 CPU tensors to the host-built kernel through
    `xla_math.launch`, as CUDA tensors go to the card's."""

    def launch(fn, ins, outs, n=0, params=(), mask=0):
        if n == 0 and fn not in ("propagate", "dead_reckon"):
            return
        ptr = [x.data_ptr() for x in ins] + [None] * (3 - len(ins))
        optr = [x.data_ptr() for x in outs] + [None] * (3 - len(outs))
        host_kernel(xm.FN[fn], *ptr, mask, *optr, n, (ctypes.c_longlong * 10)(*params))
        xm.xla_math.launches += 1

    monkeypatch.setattr(xm, "on_card", lambda x: x.dtype == torch.float32)
    monkeypatch.setattr(xm, "launch", launch)


def _same(got, want) -> None:
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        same = (g.view(torch.int32) == w.view(torch.int32)) | (g.isnan() & w.isnan())
        assert bool(same.all()), f"{int((~same).sum())} of {g.numel()} differ"


def _elementwise_inputs(fn: str, n: int = 1 << 16) -> list[torch.Tensor]:
    """Angles, magnitudes of 1e-8 to 1e6 ([-1, 1] for acos), random bits and
    the special values; a permutation for each further operand."""
    rng = np.random.default_rng(5)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-39, 1.17e-38, np.inf, -np.inf, np.nan,
                        1.0, -1.0, 0.78539816, 120.0, -120.0, 119.99999, 3.4e38, 2.0**-12],
                       np.float32)
    if fn == "acos":
        a = rng.uniform(-1.0, 1.0, n)
    else:
        a = np.concatenate([rng.uniform(-np.pi, np.pi, n // 2),
                            np.sign(rng.normal(size=n // 2)) * 10.0 ** rng.uniform(-8, 6, n // 2)])
    bits = rng.integers(0, 2**32, n // 2, dtype=np.uint64).astype(np.uint32).view(np.float32)
    x = np.concatenate([special, a.astype(np.float32), bits])
    k = {"atan2": 2, "fma": 3}.get(fn, 1)
    return [torch.from_numpy(x)] + [torch.from_numpy(rng.permutation(x)) for _ in range(k - 1)]


@pytest.mark.parametrize("fn", ["sincos", "atan2", "acos", "fma"])
def test_host_kernel_elementwise_bits_equal_plain(host_kernel, monkeypatch, fn):
    """The elementwise functions on seeded sweeps with the special values,
    and with each operand of one element read as a scalar."""
    ins = _elementwise_inputs(fn)
    want = xm._PLAIN[fn](*ins)
    _route_to_host(host_kernel, monkeypatch)
    before = xm.xla_math.launches
    _same(xm.xla_math(fn, *ins), want)
    assert xm.xla_math.launches == before + 1
    for j in range(len(ins)) if fn in ("atan2", "fma") else ():
        one = [a[:1] if i == j else a for i, a in enumerate(ins)]
        _same(xm.xla_math(fn, *one), xm._PLAIN[fn](*one))


@pytest.mark.parametrize("name", XLA_MATH_CASES)
def test_host_kernel_composites_bits_equal_plain(host_kernel, monkeypatch, name):
    """Each composite function through its wrapper, one launch a call."""
    call, ins = xla_math_cases()[name]
    want = call(*ins)  # the plain version
    _route_to_host(host_kernel, monkeypatch)
    before = xm.xla_math.launches
    got = call(*ins)
    assert xm.xla_math.launches == before + 1
    _same(got, want)

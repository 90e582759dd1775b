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
struct alignas(16) float4 { float x, y, z, w; };
static inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
static inline void __syncthreads() {}
static inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
static inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
static inline float __fsqrt_rn(float a) { return std::sqrt(a); }
static inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
static inline int32_t __float_as_int(float f) { int32_t u; memcpy(&u, &f, 4); return u; }
static inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
static inline float __int_as_float(int32_t u) { float f; memcpy(&f, &u, 4); return f; }
"""

#: host entry points over the source's kernels, each run as one thread that
#: takes every grid-stride item (the card's launchers are CUDA-only)
_ENTRY = r"""
template <bool V>
static void ew(int fn, const float* a, const float* b, const float* c, int mask, float* o0,
               float* o1, long long n) {
  switch (fn) {
    case kSinCos: xm_ew<kSinCos, V>(a, b, c, mask, o0, o1, n); break;
    case kAtan2: xm_ew<kAtan2, V>(a, b, c, mask, o0, o1, n); break;
    case kAcos: xm_ew<kAcos, V>(a, b, c, mask, o0, o1, n); break;
    default: xm_ew<kFma, V>(a, b, c, mask, o0, o1, n); break;
  }
}

extern "C" void host_ew(int fn, const float* a, const float* b, const float* c, int mask,
                        float* o0, float* o1, long long n, int vec) {
  if (vec) ew<true>(fn, a, b, c, mask, o0, o1, n);
  else ew<false>(fn, a, b, c, mask, o0, o1, n);
}

extern "C" void host_ew_strided(int fn, const float* a, const float* b, const float* c,
                                float* o0, float* o1, long long n, const long long* v) {
  Bcast bc;
  for (int k = 0; k < 4; ++k) {
    bc.d[k] = v[k];
    for (int j = 0; j < 3; ++j) bc.s[j][k] = v[4 + 4 * j + k];
  }
  switch (fn) {
    case kSinCos: xm_ew_strided<kSinCos>(a, b, c, o0, o1, n, bc); break;
    case kAtan2: xm_ew_strided<kAtan2>(a, b, c, o0, o1, n, bc); break;
    case kAcos: xm_ew_strided<kAcos>(a, b, c, o0, o1, n, bc); break;
    default: xm_ew_strided<kFma>(a, b, c, o0, o1, n, bc); break;
  }
}

extern "C" void host_xla_math(int fn, const float* a, const float* b, const float* c,
                              float* o0, float* o1, float* o2, long long n,
                              const long long* p) {
  Params prm = {};
  for (int k = 0; k < 10; ++k) prm.v[k] = p[k];
  switch (fn) {
    case kPropagate: xm_propagate(a, b, c, o0, (int)p[0]); break;
    case kDeadReckon: xm_dead_reckon(a, b, c, o0, o1, (int)p[0], (int)p[1]); break;
    case kNorm2: xm_norm2(a, o0, n); break;
    case kMm: xm_mm<false>(a, b, o0, n, prm); break;
    case kMmLanes: xm_mm<true>(a, b, o0, n, prm); break;
    case kSo3Exp: xm_batch<kSo3Exp>(a, b, c, o0, o1, o2, n, p[0], p[1]); break;
    case kSo3Log: xm_batch<kSo3Log>(a, b, c, o0, o1, o2, n, p[0], p[1]); break;
    case kSe3Exp: xm_batch<kSe3Exp>(a, b, c, o0, o1, o2, n, p[0], p[1]); break;
    case kSe3Log: xm_batch<kSe3Log>(a, b, c, o0, o1, o2, n, p[0], p[1]); break;
    case kDeskew: xm_batch<kDeskew>(a, b, c, o0, o1, o2, n, p[0], p[1]); break;
    case kCellNormals: xm_batch<kCellNormals>(a, b, c, o0, o1, o2, n, p[0], p[1]); break;
    default: break;  // the elementwise functions launch through host_ew
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/xla_math.cu's kernels compiled for the host, as a ctypes library
    (skips where there is no g++). No contraction (-ffp-contract=off): each
    float operation rounds once, as under nvcc's -fmad=false."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's source for the host")
    src = open(os.path.join(cuda_lib.CSRC, "xla_math.cu")).read()
    src = src.replace("#include <cuda_runtime.h>", _SHIM)
    src = src[: src.index("}  // namespace")] + _ENTRY + "}  // namespace\n"
    src = src.replace("namespace {", "namespace xm {", 1) + "using namespace xm;\n"
    d = tmp_path_factory.mktemp("xla_math_host")
    (d / "xla_math_host.cpp").write_text(src)
    lib = d / "libxla_math_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fno-fast-math", "-shared",
                    "-fPIC", "-o", str(lib), str(d / "xla_math_host.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    P, L = ctypes.c_void_p, ctypes.c_longlong
    so.host_ew.argtypes = [ctypes.c_int, P, P, P, ctypes.c_int, P, P, L, ctypes.c_int]
    so.host_ew_strided.argtypes = [ctypes.c_int, P, P, P, P, P, L, P]
    so.host_xla_math.argtypes = [ctypes.c_int, P, P, P, P, P, P, L, P]
    return so


#: the elementwise launches the host kernel took: (function, path) where the
#: path is "vec" (16-byte), "scalar" or "strided"
EW_PATHS: list = []


def _route_to_host(host_kernel, monkeypatch) -> None:
    """Route the port's float32 CPU tensors to the host-built kernels through
    `xla_math.launch` and `xla_math._launch_ew`, as CUDA tensors go to the
    card's: the same packing of pointers, masks, shapes and strides."""

    def launch(fn, ins, outs, n=0, params=()):
        if n == 0 and fn not in ("propagate", "dead_reckon"):
            return
        ptr = [x.data_ptr() for x in ins] + [None] * (3 - len(ins))
        optr = [x.data_ptr() for x in outs] + [None] * (3 - len(outs))
        p = (ctypes.c_longlong * 10)(*params)
        host_kernel.host_xla_math(xm.FN[fn], *ptr, *optr, n, p)
        xm._count(fn)

    def launch_ew(fn, ins, outs, shape):
        n = outs[0].numel()
        if n == 0:
            return
        o1 = outs[1].data_ptr() if len(outs) > 1 else None
        ptr = [x.data_ptr() for x in ins] + [None] * (3 - len(ins))
        mask = sum(1 << j for j, x in enumerate(ins) if x.numel() == 1)
        if all(x.numel() == 1 or (x.shape == shape and x.is_contiguous()) for x in ins):
            streamed = [x.data_ptr() for x in ins if x.numel() > 1] + [o.data_ptr() for o in outs]
            vec = n >= 4 and all(q % 16 == 0 for q in streamed)
            EW_PATHS.append((fn, "vec" if vec else "scalar"))
            host_kernel.host_ew(xm.FN[fn], *ptr, mask, outs[0].data_ptr(), o1, n, int(vec))
        else:
            pad = 4 - len(shape)
            strides = [[0] * pad + list(x.expand(shape).stride()) for x in ins]
            strides += [[0] * 4] * (3 - len(ins))
            v = [1] * pad + list(shape) + strides[0] + strides[1] + strides[2]
            EW_PATHS.append((fn, "strided"))
            host_kernel.host_ew_strided(xm.FN[fn], *ptr, outs[0].data_ptr(), o1, n,
                                        (ctypes.c_longlong * 16)(*v))
        xm._count(fn)

    monkeypatch.setattr(xm, "on_card", lambda x: x.dtype == torch.float32)
    monkeypatch.setattr(xm, "launch", launch)
    monkeypatch.setattr(xm, "_launch_ew", launch_ew)


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


@pytest.mark.parametrize("fn", ["sincos", "atan2", "acos", "fma"])
def test_host_kernel_launch_paths_bits_equal_plain(host_kernel, monkeypatch, fn):
    """Each elementwise function through the three launch paths, bit-equal
    to the plain version: 16-byte accesses (contiguous, aligned operands),
    one value a thread (views one element off the alignment) and broadcast
    strides (operands of shapes (64, 1), (64, 64) and (64,), read in place)."""
    ins = _elementwise_inputs(fn, n=4096)
    k = len(ins)
    shapes = [(64, 1), (64, 64), (64,)][:k] if k > 1 else [(64, 64)]
    cases = {
        "vec": ins,
        "scalar": [a[1:] for a in ins],
        "strided": [a[: int(np.prod(s))].reshape(s) for a, s in zip(ins, shapes)],
    }
    if k == 1:  # one operand: a transposed view takes the strides
        cases["strided"] = [cases["strided"][0].T]
    wants = {path: xm._PLAIN[fn](*args) for path, args in cases.items()}
    _route_to_host(host_kernel, monkeypatch)
    for path, args in cases.items():
        del EW_PATHS[:]
        _same(xm.xla_math(fn, *args), wants[path])
        assert EW_PATHS == [(fn, path)], (path, EW_PATHS)


def test_launch_path_rejects_other_dtypes_and_devices(host_kernel, monkeypatch):
    """The lean launch path still checks each operand: another dtype or
    another device raises before anything is launched."""
    _route_to_host(host_kernel, monkeypatch)
    x = torch.ones(8)
    before = xm.xla_math.launches
    with pytest.raises(ValueError, match="torch.float64 on cpu, expected float32"):
        xm.xla_math("fma", x, x.double(), x)
    with pytest.raises(ValueError, match="on meta"):
        xm.xla_math("atan2", x, torch.ones(8, device="meta"))
    assert xm.xla_math.launches == before

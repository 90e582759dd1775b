"""XLA's float32 elementwise math on the CPU, bit for bit, on both devices.

The JAX package's LIO path runs under `jax.jit` on the CPU, where XLA
evaluates float32 transcendentals and contracts products into sums in its
own way. The port must round as it does, or near ties in the fixed
association turn an ulp into millimetres (ROADMAP §3):

- `sin` / `cos` become the `llvm.sin.f32` / `llvm.cos.f32` intrinsics,
  i.e. calls to glibc's `sinf` / `cosf` (or `sincosf` where both take one
  argument), which are not correctly rounded. On an x86-64 host with FMA
  glibc runs its FMA build: float64 polynomials with every product-sum
  fused, the argument reduced by pi/2 with one fused multiply-add below
  |x| < 120 and with a 192-bit table of 4/pi past it.
- `atan2` is a call to glibc's `atan2f`: float32 fdlibm, no FMA.
- `arccos(x)` is rewritten by XLA as `atan2(sqrt((1 - x) * (1 + x)), x)`.
- XLA runs with denormals-are-zero and flush-to-zero: a subnormal
  quotient or square root reads as 0.
- `sqrt` is correctly rounded (torch's CPU sqrt, MKL's, is not always).
- Products feeding sums are contracted into fused multiply-adds inside a
  fusion: a sum of three squares is `fma(z, z, fma(y, y, x * x))`, a small
  product the same chain along k, Rodrigues' `I + a K + b K^2` two fmas an
  entry. Which product is fused depends on the fusion, so each caller
  picks the form its JAX counterpart's jitted code has.
- Larger matrix products go to a library GEMM with its own order of
  addition (`mm_lanes`).

The constants and the order of operations below were read off the host's
libm (`objdump -d` of `sinf`, `cosf`, `sincosf`, `atan2f`, `atanf` and the
tables they load) and off XLA's optimized HLO of the JAX functions;
tests/test_torch_xla_math.py holds each function to the JAX package's
jitted results bit for bit.

On float32 CPU tensors every function here runs its plain version
(float64 and float32 tensor ops, fused multiply-adds emulated exactly). On
float32 CUDA tensors `sincosf` / `sinf` / `cosf`, `atan2f`, `acosf`,
`fma32`, `norm2`, `mm3`, `mv3` and `mm_lanes` launch csrc/xla_math.cu once,
bit-equal to the plain versions; so do the composite functions that
ops/geometry, ops/deskew, ops/point_to_plane, models/ekf and models/lio
build of these, through `launch` (each its own function of the kernel:
so3_exp, so3_log, se3_exp, se3_log, deskew, the cell normals, the IMU
propagation, the dead reckoning), so the LIO host path issues one launch
where torch issued one or more. A tensor of another dtype on the card, or
on another device, raises. `sqrtf`, `dot3`, `sumsq3`, `cross3` and
`rodrigues` are tensor ops (their `fma32` launches on the card); the
composite kernels inline them. Float64 tensors, which only a
double-precision reference passes, take torch's own functions.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from slam_sensor_fusion_tpu_torch.ops import cuda_lib

_F64 = torch.float64
_INF = float("inf")

# --------------------------------------------------------------------------
# exact fused multiply-adds
# --------------------------------------------------------------------------


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """s = RN(a + b) and its exact error e: a + b = s + e."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_odd(s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The float64 value s + e rounded to odd, given s = RN(s + e): s where
    it is exact or odd, else its neighbour toward e."""
    inexact = (e != 0) & (e == e)  # a NaN error: s is +-inf or NaN
    even = (s.view(torch.int64) & 1) == 0
    step = torch.nextafter(s, torch.where(e > 0, _INF, -_INF).to(s.dtype))
    return torch.where(inexact & even, step, s)


_SPLIT = 134217729.0  # 2^27 + 1: Veltkamp's split of a float64 into 26 + 27 bits


def _two_prod(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """p = RN(a * b) and its exact error (Dekker): a * b = p + e."""
    p = a * b
    ca, cb = _SPLIT * a, _SPLIT * b
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """RN(a * b + c) in float64, exactly (Boldo and Melquiond's emulation:
    the exact product, a TwoSum with c, the two errors added rounded to
    odd, then one rounding). Finite operands away from overflow and
    underflow, which is what the sincos polynomials give it."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _round_odd(*_two_sum(tl, ul))


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """RN(a * b + c) for float32 tensors (broadcast), exactly, as XLA's
    contracted products round: CUDA tensors launch csrc/xla_math.cu
    (`__fmaf_rn`), CPU tensors run `fma32_plain`. Float64 operands (a
    reference computed in double) take the plain a * b + c."""
    if _F64 in (a.dtype, b.dtype, c.dtype):
        return a * b + c
    return xla_math("fma", a, b, c)


def fma32_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The exact float32 fma on the CPU: the product is exact in float64,
    and the sum rounded there is rounded once more to float32. That second
    rounding is exact unless the float64 sum is inexact and lands on a
    float32 tie (or in the subnormal range; an exact zero is exact): those
    elements are rounded to odd in float64 first (2 + 24 bits make the
    second rounding exact)."""
    p = a.to(_F64) * b.to(_F64)
    c64 = c.to(_F64)
    s = p + c64
    bits = s.view(torch.int64)
    risky = ((bits & 0x1FFFFFFF) == 0x10000000) | ((s.abs() < 2.0**-125) & (s != 0))
    if bool(risky.any()):
        s = torch.where(risky, _round_odd(*_two_sum(p, c64)), s)
    return s.to(torch.float32)


def sqrtf(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt correctly rounded, as XLA's is. On the CPU, torch's sqrt
    calls MKL's vector library, which is not always correctly rounded: on
    its first call from several threads at once it has rounded one thread's
    share of a float64 tensor 2^-36 apart. So a CPU tensor takes numpy's
    sqrt (the processor's IEEE square root, one thread), and a CUDA tensor
    the card's float64 sqrt (53 bits make the second rounding exact). A
    subnormal input reads as 0, as under XLA's denormals-are-zero. A
    float64 tensor takes torch's sqrt."""
    if x.dtype == _F64:
        return torch.sqrt(x)
    x = _flush(x)
    if x.device.type == "cpu":
        a = x.numpy()
        out = np.empty_like(a)
        with np.errstate(invalid="ignore"):
            np.sqrt(a, out=out)
        return torch.from_numpy(out)
    return torch.sqrt(x.to(_F64)).to(x.dtype)


def dot3(ax, ay, az, bx, by, bz) -> torch.Tensor:
    """a.b as XLA contracts it: fma(az, bz, fma(ay, by, ax * bx))."""
    return fma32(az, bz, fma32(ay, by, ax * bx))


def sumsq3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x^2 + y^2 + z^2 as XLA's reduction contracts it."""
    return dot3(x, y, z, x, y, z)


def norm2(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 over the last axis of (..., 3), as `sumsq3`; one launch on the
    card."""
    if on_card(p):
        out = torch.empty(p.shape[:-1], dtype=torch.float32, device=p.device)
        launch("norm2", [rows(p, 3)], [out], n=out.numel())
        return out
    return sumsq3(p[..., 0], p[..., 1], p[..., 2])


def cross3(a: tuple, b: tuple) -> tuple:
    """a x b of component tuples, each component x y - u v as XLA
    contracts it: fma(x, y, -(u v))."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    return (fma32(a1, b2, -(a2 * b1)), fma32(a2, b0, -(a0 * b2)), fma32(a0, b1, -(a1 * b0)))


def mm3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., M, K) @ (..., K, N) for the small products XLA's CPU compiler
    emits inline (3x3, 4x4): each entry the fma chain along k from k = 0.
    One launch on the card."""
    if _F64 not in (A.dtype, B.dtype) and on_card(A):
        return _mm_card(A, B, lanes=False)
    acc = A[..., :, 0, None] * B[..., None, 0, :]
    for k in range(1, A.shape[-1]):
        acc = fma32(A[..., :, k, None], B[..., None, k, :], acc)
    return acc


def mv3(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., M, K) @ (..., K) as XLA's CPU compiler emits small
    matrix-vector products inline: the fma chain along k from k = 0. One
    launch on the card."""
    if _F64 not in (A.dtype, v.dtype) and on_card(A):
        return _mm_card(A, v[..., None], lanes=False)[..., 0]
    acc = A[..., 0] * v[..., None, 0]
    for k in range(1, A.shape[-1]):
        acc = fma32(A[..., k], v[..., None, k], acc)
    return acc


def mm_lanes(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., M, K) @ (..., K, N) as XLA's CPU library GEMM adds it at the
    EKF's shapes (15 x 15, 15 x 6): four lanes k = l, l + 4, ... below
    K - K % 4, each an fma chain from its first product, reduced as
    (l0 + l1) + (l2 + l3); the last K % 4 products added in order without
    contraction, then to it. The lanes run side by side; one launch on the
    card."""
    if _F64 not in (A.dtype, B.dtype) and on_card(A):
        return _mm_card(A, B, lanes=True)
    K = A.shape[-1]
    main = K - K % 4
    out = None
    if main:
        # a[..., l, m, t] = A[..., m, 4 t + l], b[..., l, t, n] = B[..., 4 t + l, n]
        a = A[..., :main].unflatten(-1, (main // 4, 4)).movedim(-1, -3)
        b = B[..., :main, :].unflatten(-2, (main // 4, 4)).movedim(-2, -3)
        acc = a[..., 0, None] * b[..., None, 0, :]
        for t in range(1, main // 4):
            acc = fma32(a[..., t, None], b[..., None, t, :], acc)
        out = (acc[..., 0, :, :] + acc[..., 1, :, :]) + (acc[..., 2, :, :] + acc[..., 3, :, :])
    tail = None
    for k in range(main, K):
        prod = A[..., :, k, None] * B[..., None, k, :]
        tail = prod if tail is None else tail + prod
    if out is None:
        return tail
    return out if tail is None else out + tail


def rodrigues(a: torch.Tensor, b: torch.Tensor, K: torch.Tensor, KK: torch.Tensor) -> torch.Tensor:
    """I + a K + b KK for (...) scalars a, b and (..., 3, 3) K, KK, as XLA
    fuses it: fma(b, KK, fma(a, K, I)) an entry."""
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return fma32(b[..., None, None], KK, fma32(a[..., None, None], K, eye))


# --------------------------------------------------------------------------
# glibc's sinf / cosf / sincosf (FMA build)
# --------------------------------------------------------------------------

_h = float.fromhex
#: 2/pi scaled by 2^24 (the quadrant lands in bits 24..31), pi/2
_HPI_INV = _h("0x1.45f306dc9c883p+23")
_HPI = _h("0x1.921fb54442d18p+0")
#: 2 pi 2^-64: one unit of the large reduction's 2.62 fixed point
_PI63 = _h("0x1.921fb54442d18p-62")
#: sin polynomial x + S1 x^3 + (S2 + S3 x^2) x^5
_S1, _S2, _S3 = (_h("-0x1.555545995a603p-3"), _h("0x1.1107605230bc4p-7"),
                 _h("-0x1.994eb3774cf24p-13"))
#: cos polynomial (C0 + C1 x^2) + C2 x^4 + (C3 + C4 x^2) x^6; the second
#: table (quadrants 2 and 3) negates it
_C = (1.0, _h("-0x1.ffffffd0c621cp-2"), _h("0x1.55553e1068f19p-5"),
      _h("-0x1.6c087e89a359dp-10"), _h("0x1.99343027bf8c3p-16"))
#: the sign of sin by quadrant
_SIGN = (1.0, -1.0, -1.0, 1.0)
#: 4/pi in 24 words of 32 bits, read in overlapping windows
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415, 0x4e441529,
    0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd,
    0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43,
    0x993c4390, 0x3c439041,
)
_M32 = 0xFFFFFFFF


def _sin_poly(xs: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    x3 = x2 * xs
    s1 = fma64(x2, torch.full_like(x2, _S3), torch.full_like(x2, _S2))
    x5 = x3 * x2
    s = fma64(x3, torch.full_like(x3, _S1), xs)
    return fma64(s1, x5, s)


def _cos_poly(x2: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    sg = torch.where(neg, -1.0, 1.0).to(_F64)
    c0, c1, c2, c3, c4 = (sg * c for c in _C)
    x4 = x2 * x2
    c1 = fma64(x2, c1, c0)
    c2_ = fma64(x2, c4, c3)
    x6 = x2 * x4
    c = fma64(x4, c2, c1)
    return fma64(c2_, x6, c)


def _reduce_large(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """glibc's reduction of |y| >= 120 (bits: the float32's bits as int64 in
    [0, 2^32)): the 2.62 fixed-point product of the mantissa with a 96-bit
    window of 4/pi, in 32-bit halves so no int64 operation overflows.
    Returns (r in float64, n)."""
    table = torch.tensor(_INV_PIO4, dtype=torch.int64, device=bits.device)
    idx = (bits >> 26) & 15
    shift = (bits >> 23) & 7
    m = (((bits & 0xFFFFFF) | 0x800000) << shift) & _M32  # < 2^31
    res0 = (m * table[idx]) & _M32
    res1 = m * table[idx + 4]  # < 2^63
    res2 = m * table[idx + 8]
    lo = (res2 >> 32) + (res1 & _M32)
    hi = (res0 + (res1 >> 32) + (lo >> 32)) & _M32
    lo = lo & _M32
    n = ((hi + (1 << 29)) & _M32) >> 30
    hi = (hi - (n << 30)) & _M32
    signed = torch.where(hi >= (1 << 31), hi, hi)
    r = (signed * (1 << 32) + lo).to(_F64) * _PI63
    return r, n


def sincosf_plain(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """glibc's (sinf(y), cosf(y)) for a float32 tensor (any shape), bit for
    bit: every element computed along every branch, then selected."""
    y = y.contiguous()
    bits = y.view(torch.int32).to(torch.int64) & _M32
    top = (bits >> 20) & 0x7FF
    small = top < 0x3F4  # |y| < pi/4
    tiny = top < 0x398  # |y| < 2^-12
    medium = ~small & (top < 0x42F)  # |y| < 120
    finite = top < 0x7F8
    x = y.to(_F64)

    # |y| < pi/4: the polynomials on y itself, the first table
    x2s = x * x
    sin_s = _sin_poly(x, x2s)
    cos_s = _cos_poly(x2s, torch.zeros_like(small))

    # |y| < 120: one fused multiply-add by pi/2, the quadrant from a
    # truncating conversion of y 2^24 2/pi
    xm = torch.where(medium, x, 0.0)
    nm = ((xm * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    rm = fma64(-nm.to(_F64), torch.full_like(xm, _HPI), xm)
    qm = nm.to(torch.int64) & 3

    # |y| >= 120: the table reduction, the sign folded into the quadrant
    rl, nl = _reduce_large(torch.where(medium | small | ~finite, 0x43000000, bits))
    ql = (nl + (bits >> 31)) & 3

    r = torch.where(medium, rm, rl)
    q = torch.where(medium, qm, ql)
    odd = torch.where(medium, nm.to(torch.int64), nl) & 1 == 1
    sign = torch.tensor(_SIGN, dtype=_F64, device=y.device)[q]
    x2 = r * r
    sin_r = _sin_poly(r * sign, x2)
    cos_r = _cos_poly(x2, (q & 2) == 2)
    sin_big = torch.where(odd, cos_r, sin_r)
    cos_big = torch.where(odd, sin_r, cos_r)

    sin = torch.where(small, torch.where(tiny, x, sin_s), sin_big).to(torch.float32)
    cos = torch.where(small, torch.where(tiny, 1.0, cos_s), cos_big).to(torch.float32)
    nan = torch.full_like(sin, float("nan"))
    return torch.where(finite, sin, nan), torch.where(finite, cos, nan)




# --------------------------------------------------------------------------
# glibc's atan2f (float32 fdlibm, no FMA) and XLA's arccos
# --------------------------------------------------------------------------


def _f32(bits: int) -> float:
    """The float32 with these bits, as a Python float."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


_ATAN_HI = [_f32(b) for b in (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)]
_ATAN_LO = [_f32(b) for b in (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)]
_AT = [_f32(b) for b in (0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38,
                         0x3DBA2E6E, 0xBD9D8795, 0x3D886B35,
                         0xBD6EF16B, 0x3D4BDA59, 0xBD15A221,
                         0x3C8569D7)]
_PI = _f32(0x40490FDB)
_PI_O_2 = _f32(0x3FC90FDB)
_PI_O_4 = _f32(0x3F490FDB)
_PI_LO = _f32(0xB3BBBD2E)
_TINY = 1.0e-30


def _atanf_plain(x: torch.Tensor) -> torch.Tensor:
    """glibc's atanf (fdlibm) for a float32 tensor."""
    f32 = torch.float32
    hx = x.contiguous().view(torch.int32)
    ix = hx & 0x7FFFFFFF

    def c(v):
        return torch.tensor(v, dtype=f32, device=x.device)

    ax = x.abs()
    # argument reduction, id -1 .. 3
    r0 = (c(2.0) * ax - c(1.0)) / (c(2.0) + ax)
    r1 = (ax - c(1.0)) / (ax + c(1.0))
    r2 = (ax - c(1.5)) / (c(1.0) + c(1.5) * ax)
    r3 = c(-1.0) / ax
    id_ = torch.where(ix < 0x3EE00000, -1,
                      torch.where(ix < 0x3F300000, 0,
                                  torch.where(ix < 0x3F980000, 1,
                                              torch.where(ix < 0x401C0000, 2, 3))))
    xr = torch.where(id_ == -1, x,
                     torch.where(id_ == 0, r0,
                                 torch.where(id_ == 1, r1, torch.where(id_ == 2, r2, r3))))
    z = xr * xr
    w = z * z
    s1 = c(_AT[10])
    for k in (8, 6, 4, 2, 0):
        s1 = s1 * w + c(_AT[k])
    s1 = s1 * z
    s2 = c(_AT[9])
    for k in (7, 5, 3, 1):
        s2 = s2 * w + c(_AT[k])
    s2 = s2 * w
    xs = xr * (s1 + s2)
    small = xr - xs
    idc = id_.clamp(min=0)
    hi = torch.tensor(_ATAN_HI, dtype=f32, device=x.device)[idc]
    lo = torch.tensor(_ATAN_LO, dtype=f32, device=x.device)[idc]
    big = hi - ((xs - lo) - xr)
    big = torch.where(hx < 0, -big, big)
    out = torch.where(id_ == -1, small, big)
    # |x| < 2^-29: x itself; |x| >= 2^25: +-(atanhi[3] + atanlo[3]); NaN: x + x
    out = torch.where(ix < 0x31000000, x, out)
    huge = c(_ATAN_HI[3]) + c(_ATAN_LO[3])
    out = torch.where(ix >= 0x4C000000, torch.where(hx > 0, huge, -huge), out)
    return torch.where(ix > 0x7F800000, x + x, out)


def _flush(v: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to zero of their sign (DAZ / FTZ)."""
    sub = (v.view(torch.int32) & 0x7FFFFFFF) < 0x00800000
    return torch.where(sub, v * 0.0, v)


def atan2f_plain(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """glibc's atan2f(y, x) for float32 tensors of one shape, bit for bit."""
    f32 = torch.float32
    y, x = torch.broadcast_tensors(y, x)
    y, x = y.contiguous(), x.contiguous()
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF

    def c(v):
        return torch.tensor(v, dtype=f32, device=x.device)

    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)
    pi_lo_neg = c(-_PI_LO)
    # the general case: atan(|y / x|) placed in its quadrant. XLA runs with
    # denormals-are-zero and flush-to-zero set, and so does the division
    # in the libm it calls: a subnormal operand reads as 0, a subnormal
    # quotient becomes 0 (so atan2(1e-40, 1e-39) is 0 / 0, a NaN)
    k = (iy - ix) >> 23
    z = _atanf_plain(_flush((_flush(y) / _flush(x))).abs())
    z = torch.where(k > 60, c(_PI_O_2) - c(-0.5 * _PI_LO), z)
    z = torch.where((hx < 0) & (k < -60), c(0.0), z)
    gen = torch.where(m == 0, z,
                      torch.where(m == 1, -z,
                                  torch.where(m == 2, c(_PI) - (z + pi_lo_neg),
                                              (z + pi_lo_neg) - c(_PI))))
    out = gen
    # y is +-inf (x finite)
    out = torch.where(iy == 0x7F800000,
                      torch.where(hy < 0, c(-_PI_O_2) - c(_TINY), c(_PI_O_2) + c(_TINY)), out)
    # x is +-inf
    inf_inf = torch.where(m == 0, c(_PI_O_4) + c(_TINY),
                          torch.where(m == 1, c(-_PI_O_4) - c(_TINY),
                                      torch.where(m == 2, c(3.0) * c(_PI_O_4) + c(_TINY),
                                                  c(-3.0) * c(_PI_O_4) - c(_TINY))))
    inf_fin = torch.where(m == 0, c(0.0),
                          torch.where(m == 1, c(-0.0),
                                      torch.where(m == 2, c(_PI) + c(_TINY),
                                                  c(-_PI) - c(_TINY))))
    out = torch.where(ix == 0x7F800000, torch.where(iy == 0x7F800000, inf_inf, inf_fin), out)
    # x is +-0
    out = torch.where(ix == 0,
                      torch.where(hy < 0, c(-_PI_O_2) - c(_TINY), c(_PI_O_2) + c(_TINY)), out)
    # y is +-0
    y0 = torch.where(m <= 1, y, torch.where(m == 2, c(_PI) + c(_TINY), c(-_PI) - c(_TINY)))
    out = torch.where(iy == 0, y0, out)
    # x == 1.0: atanf(y)
    out = torch.where(hx == 0x3F800000, _atanf_plain(y), out)
    return torch.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, out)


def acosf_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's arccos: atan2f(sqrt((1 - x) * (1 + x)), x)."""
    one = torch.ones((), dtype=torch.float32, device=x.device)
    return atan2f_plain(sqrtf((one - x) * (x + one)), x)


# --------------------------------------------------------------------------
# the dispatching entry points
# --------------------------------------------------------------------------

#: the kernel's function selector (csrc/xla_math.cu `Fn`): the elementwise
#: functions, then the composite ones, each one launch a call
FN = {"sincos": 0, "atan2": 1, "acos": 2, "fma": 3, "norm2": 4, "mm": 5, "mm_lanes": 6,
      "so3_exp": 7, "so3_log": 8, "se3_exp": 9, "se3_log": 10, "deskew": 11,
      "cell_normals": 12, "propagate": 13, "dead_reckon": 14}

_PLAIN = {"acos": acosf_plain, "sincos": sincosf_plain, "atan2": atan2f_plain,
          "fma": fma32_plain}
_TORCH64 = {"acos": torch.acos, "atan2": torch.atan2,
            "sincos": lambda a: (torch.sin(a), torch.cos(a)), "fma": lambda a, b, c: a * b + c}


def on_card(x: torch.Tensor) -> bool:
    """Whether `x` takes csrc/xla_math.cu: a float32 CUDA tensor. CPU
    tensors, and float64 ones (a reference computed in double), take the
    plain versions; a tensor of another dtype on the card, or on another
    device, raises."""
    if x.device.type == "cpu" or x.dtype == _F64:
        return False
    if x.device.type != "cuda":
        raise ValueError(f"xla_math: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"xla_math: dtype {x.dtype} on the card, expected float32")
    return True


def _count(fn: str) -> None:
    xla_math.launches += 1
    xla_math.launches_by[fn] = xla_math.launches_by.get(fn, 0) + 1


def launch(fn: str, ins: list[torch.Tensor], outs: list[torch.Tensor], n: int = 0,
           params: tuple = ()) -> None:
    """One launch of csrc/xla_math.cu's composite function `fn` on float32
    CUDA tensors: up to three inputs, read as the function's comment in the
    source says (contiguous, or through the strides in `params`), written
    into up to three outputs; `n` items of the grid-stride functions. The
    elementwise functions launch through `xla_math`."""
    dev = outs[0].device
    for j, x in enumerate(list(ins) + list(outs)):
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"xla_math {fn}: operand {j} is {x.dtype} on {x.device}, "
                             f"expected float32 on {dev}")
    if n == 0 and fn not in ("propagate", "dead_reckon"):
        return
    ptr = [x.data_ptr() for x in ins] + [None] * (3 - len(ins))
    optr = [x.data_ptr() for x in outs] + [None] * (3 - len(outs))
    err = cuda_lib.lib().sfk_xla_math(FN[fn], *ptr, *optr, n, *params,
                                      *_ZEROS[len(params):], cuda_lib.stream_ptr(outs[0]))
    cuda_lib.check(err, f"xla_math {fn}")
    _count(fn)


#: the unused integer arguments of a launch
_ZEROS = (0,) * 10
_F32 = torch.float32


def _launch_ew(fn: str, ins, outs, shape) -> None:
    """One launch of the elementwise function `fn`: contiguous operands of
    the output's shape and single elements (read as scalars) through
    `sfk_xla_ew`, others through their broadcast strides (no copy)."""
    n = outs[0].numel()
    if n == 0:
        return
    o1 = outs[1].data_ptr() if len(outs) > 1 else None
    ptr = [x.data_ptr() for x in ins] + [None] * (3 - len(ins))
    mask, flat = 0, True
    for j, x in enumerate(ins):
        if x.numel() == 1:
            mask |= 1 << j
        elif x.shape != shape or not x.is_contiguous():
            flat = False
    lib, stream = cuda_lib.lib(), cuda_lib.stream_ptr(outs[0])
    if flat:
        err = lib.sfk_xla_ew(FN[fn], *ptr, mask, outs[0].data_ptr(), o1, n, stream)
    else:
        if len(shape) > 4:
            raise ValueError(f"xla_math {fn}: {len(shape)} broadcast dimensions, at most 4")
        pad = 4 - len(shape)
        strides = [[0] * pad + list(x.expand(shape).stride()) for x in ins]
        strides += [[0] * 4] * (3 - len(ins))
        err = lib.sfk_xla_ew_strided(FN[fn], *ptr, outs[0].data_ptr(), o1, n,
                                     *([1] * pad + list(shape)), *strides[0], *strides[1],
                                     *strides[2], stream)
    cuda_lib.check(err, f"xla_math {fn}")
    _count(fn)


def xla_math(fn: str, *ins: torch.Tensor):
    """The elementwise function `fn` ("sincos" -> (sin, cos); "acos" (x),
    "atan2" (y, x) and "fma" (a, b, c; a * b + c rounded once) -> one
    tensor) on float32 tensors of shapes that broadcast, in XLA-on-CPU's
    bits. CPU tensors run the plain versions; CUDA tensors launch
    csrc/xla_math.cu once; any other device, or a CUDA tensor of another
    dtype, raises. Float64 tensors (a reference computed in double) take
    torch's own functions."""
    x0 = ins[0]
    if x0.dtype == _F64:
        return _TORCH64[fn](*ins)
    if not on_card(x0):
        return _PLAIN[fn](*ins)
    dev, shape = x0.device, x0.shape
    for x in ins[1:]:
        if x.device != dev or x.dtype != _F32:
            raise ValueError(f"xla_math {fn}: an operand is {x.dtype} on {x.device}, "
                             f"expected float32 on {dev}")
        if x.shape != shape:
            shape = torch.broadcast_shapes(shape, x.shape)
    out = torch.empty(shape, dtype=_F32, device=dev)
    if fn == "sincos":
        outs = (out, torch.empty(shape, dtype=_F32, device=dev))
        _launch_ew(fn, ins, outs, shape)
        return outs
    _launch_ew(fn, ins, (out,), shape)
    return out


#: the values of the state csrc/xla_math.cu's IMU functions read and write:
#: p (3), v (3), R (9), bg (3), ba (3), P (225)
IMU_STATE = 246

#: kernel launches made by `launch` and `xla_math` (CUDA tensors only): in
#: all, and by function
xla_math.launches = 0
xla_math.launches_by = {}


def sincosf(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return xla_math("sincos", y)


def sinf(y: torch.Tensor) -> torch.Tensor:
    return sincosf(y)[0]


def cosf(y: torch.Tensor) -> torch.Tensor:
    return sincosf(y)[1]


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return xla_math("atan2", y, x)


def acosf(x: torch.Tensor) -> torch.Tensor:
    return xla_math("acos", x)


def rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """`x` (..., width) as contiguous (n, width) rows, for the kernel's
    functions that read a batch item's values in a row."""
    return x.reshape(-1, width).contiguous()


def _mm_card(A: torch.Tensor, B: torch.Tensor, lanes: bool) -> torch.Tensor:
    """A @ B on the card in one launch, each operand read through its
    strides (a transposed view is not copied)."""
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    M, K = A.shape[-2:]
    N = B.shape[-1]
    A3 = A.expand(batch + (M, K)).reshape(-1, M, K)
    B3 = B.expand(batch + (K, N)).reshape(-1, K, N)
    out = torch.empty(batch + (M, N), dtype=torch.float32, device=A.device)
    launch("mm_lanes" if lanes else "mm", [A3, B3], [out], n=out.numel(),
           params=(M, K, N, *A3.stride(), *B3.stride()))
    return out

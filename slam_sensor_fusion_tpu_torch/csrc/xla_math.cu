// xla_math: the LIO host path's float32 arithmetic in the bits XLA gives it
// on the CPU: sin / cos, atan2, arccos and fused multiply-adds, and the
// functions built of them (so3_exp / so3_log, se3_exp / se3_log, deskew,
// the cell normals' eigen-solve, the small matrix products, the EKF's IMU
// propagation and the block loop's dead reckoning), one launch a call.
//
// Not a port of a Pallas kernel. The JAX package's LIO path runs under
// jax.jit on the CPU, where XLA turns sin / cos into calls to glibc's sinf /
// cosf (sincosf where both take one argument), atan2 into glibc's atan2f,
// and arccos(x) into atan2(sqrt((1 - x) (1 + x)), x), all under
// denormals-are-zero and flush-to-zero, and contracts products into sums
// as fused multiply-adds. glibc's sinf / cosf are not correctly rounded,
// and CUDA's differ from them, so the port computes the same algorithm
// here: ops/xla_math.py and the modules that call it hold the plain
// versions (float64 and float32 tensor ops, fused multiply-adds emulated
// exactly) and the constants, read off the host's libm; this kernel equals
// them bit for bit.
//
//   sinf / cosf (glibc's FMA build): in double, |y| < pi/4 straight to the
//   polynomials, |y| < 120 reduced by pi/2 with one fma, past it a 2.62
//   fixed-point product with a 96-bit window of 4/pi; every product-sum of
//   the polynomials one fma, spelled __fma_rn (the library builds with
//   -fmad=false, so nothing else is fused).
//   atan2f: float32 fdlibm as glibc 2.36 has it, no fma; the quotient y / x
//   read and written with subnormals flushed, as XLA's MXCSR does.
//   fma: __fmaf_rn, the one rounding of a * b + c that XLA's contracted
//   products take (the plain version rounds to odd in float64 first).
//   The composite functions: the plain versions' operations in their order,
//   each float32 product, sum and quotient rounded once (-fmad=false, IEEE
//   division and square root), each contracted product __fmaf_rn.
//
// Kernels: one for each function (template instances), so each has its own
// registers, launch bounds and no other function's stack or shared memory:
//   xm_ew<fn, vec>: sincos, atan2, acos, fma on contiguous operands, an
//     operand of one element read as a scalar (bit j of `scalar_mask` for
//     operand j); with vec, four values a thread through 16-byte loads and
//     stores when every streamed operand and output is 16-byte aligned;
//   xm_ew_strided<fn>: the same on operands that broadcast, each read
//     through its strides into the output's (up to 4) dimensions, so the
//     wrapper copies nothing;
//   xm_norm2, xm_mm<lanes>: an output entry a thread;
//   xm_batch<fn>: so3 / se3, deskew and the cell normals, a batch item (or
//     a point) a thread;
//   xm_propagate: one block, a thread an entry of the 15 x 15 covariance
//     products and thread 0 the mean, over the packet's samples in order;
//   xm_dead_reckon: one thread's chain.
// fdlibm's atan tables are selects and every device helper is inlined, so
// no table sits in local memory.
//
// What bounds it on an H100: the bytes (4 to 40 a value in, 4 to 64 out) at
// 3.35 TB/s; ~80 double operations a sincos at the card's 34 TFLOP/s of
// float64 take less time than its 12 bytes. The propagation and the dead
// reckoning are chains of dependent operations: their floor is latency,
// not bandwidth.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Fn {
  kSinCos = 0, kAtan2 = 1, kAcos = 2, kFma = 3, kNorm2 = 4, kMm = 5, kMmLanes = 6,
  kSo3Exp = 7, kSo3Log = 8, kSe3Exp = 9, kSe3Log = 10, kDeskew = 11, kCellNormals = 12,
  kPropagate = 13, kDeadReckon = 14
};

// the integer arguments of a launch (shapes and strides; see each function)
struct Params {
  long long v[10];
};

__constant__ uint32_t kInvPio4[24] = {
    0xa2u,       0xa2f9u,     0xa2f983u,   0xa2f9836eu, 0xf9836e4eu, 0x836e4e44u,
    0x6e4e4415u, 0x4e441529u, 0x441529fcu, 0x1529fc27u, 0x29fc2757u, 0xfc2757d1u,
    0x2757d1f5u, 0x57d1f534u, 0xd1f534ddu, 0xf534ddc0u, 0x34ddc0dbu, 0xddc0db62u,
    0xc0db6295u, 0xdb629599u, 0x6295993cu, 0x95993c43u, 0x993c4390u, 0x3c439041u};

// glibc's __sincosf_table (ops/xla_math.py: _HPI_INV, _HPI, _S*, _C*)
constexpr double kHpiInv = 0x1.45f306dc9c883p+23;
constexpr double kHpi = 0x1.921fb54442d18p+0;
constexpr double kPi63 = 0x1.921fb54442d18p-62;
constexpr double kS1 = -0x1.555545995a603p-3, kS2 = 0x1.1107605230bc4p-7,
                 kS3 = -0x1.994eb3774cf24p-13;
constexpr double kC0 = 1.0, kC1 = -0x1.ffffffd0c621cp-2, kC2 = 0x1.55553e1068f19p-5,
                 kC3 = -0x1.6c087e89a359dp-10, kC4 = 0x1.99343027bf8c3p-16;

// the plain versions' constants as float32 (XLA's divisions by constants
// are products with these)
constexpr float kThird = (float)(1.0 / 3.0), kSixth = (float)(1.0 / 6.0),
                kTwelfth = (float)(1.0 / 12.0), kT24 = (float)(1.0 / 24.0),
                kT120 = (float)(1.0 / 120.0), kTwoPiO3 = (float)(2.0943951023931953);

__device__ __forceinline__ double sin_poly(double xs, double x2) {
  const double x3 = x2 * xs;
  const double s1 = __fma_rn(x2, kS3, kS2);
  const double x5 = x3 * x2;
  const double s = __fma_rn(x3, kS1, xs);
  return __fma_rn(s1, x5, s);
}

__device__ __forceinline__ double cos_poly(double x2, bool neg) {
  const double g = neg ? -1.0 : 1.0;
  const double x4 = x2 * x2;
  const double c1 = __fma_rn(x2, g * kC1, g * kC0);
  const double c2 = __fma_rn(x2, g * kC4, g * kC3);
  const double x6 = x2 * x4;
  const double c = __fma_rn(x4, g * kC2, c1);
  return __fma_rn(c2, x6, c);
}

// glibc's reduction of |y| >= 120: the residue in units of pi/2, in double
__device__ __forceinline__ double reduce_large(uint32_t xi, int* np) {
  const uint32_t* arr = &kInvPio4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  xi = (xi & 0xffffff) | 0x800000;
  xi <<= shift;
  uint64_t res0 = (uint64_t)(uint32_t)(xi * arr[0]);
  const uint64_t res1 = (uint64_t)xi * arr[4];
  const uint64_t res2 = (uint64_t)xi * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  *np = (int)n;
  return (double)(int64_t)res0 * kPi63;
}

__device__ __forceinline__ void sincosf_xla(float y, float* sp, float* cp) {
  const uint32_t bits = __float_as_uint(y);
  const uint32_t top = (bits >> 20) & 0x7ff;
  const double x = (double)y;
  if (top < 0x3f4) {  // |y| < pi/4
    if (top < 0x398) {  // |y| < 2^-12
      *sp = y;
      *cp = 1.0f;
      return;
    }
    const double x2 = x * x;
    *sp = (float)sin_poly(x, x2);
    *cp = (float)cos_poly(x2, false);
    return;
  }
  if (top >= 0x7f8) {  // inf or NaN
    *sp = *cp = __int_as_float(0x7fc00000);
    return;
  }
  double r;
  int n, q;
  if (top < 0x42f) {  // |y| < 120
    n = (((int)(x * kHpiInv)) + 0x800000) >> 24;
    r = __fma_rn(-(double)n, kHpi, x);
    q = n & 3;
  } else {
    r = reduce_large(bits, &n);
    q = (n + (int)(bits >> 31)) & 3;
  }
  const double sign = (q == 1 || q == 2) ? -1.0 : 1.0;
  const double x2 = r * r;
  const double s = sin_poly(r * sign, x2);
  const double c = cos_poly(x2, (q & 2) != 0);
  const bool odd = n & 1;
  *sp = (float)(odd ? c : s);
  *cp = (float)(odd ? s : c);
}

__device__ __forceinline__ float sinf_xla(float y) {
  float s, c;
  sincosf_xla(y, &s, &c);
  return s;
}

__device__ __forceinline__ float cosf_xla(float y) {
  float s, c;
  sincosf_xla(y, &s, &c);
  return c;
}

// ---- atan2f: float32 fdlibm (glibc 2.36), no fma ----

__device__ __forceinline__ float f32(uint32_t b) { return __uint_as_float(b); }

__device__ __forceinline__ float flush(float v) {
  return (__float_as_uint(v) & 0x7fffffffu) < 0x00800000u ? v * 0.0f : v;
}

// atanhi / atanlo of fdlibm indexed by id 0..3: selects, so no table sits
// in local memory
__device__ __forceinline__ float atan_hi(int id) {
  return id == 0 ? f32(0x3eed6338u) : id == 1 ? f32(0x3f490fdau)
       : id == 2 ? f32(0x3f7b985eu) : f32(0x3fc90fdau);
}
__device__ __forceinline__ float atan_lo(int id) {
  return id == 0 ? f32(0x31ac3769u) : id == 1 ? f32(0x33222168u)
       : id == 2 ? f32(0x33140fb4u) : f32(0x33a22168u);
}

// fdlibm's atanf without branches on the value: every element takes one
// division (the argument reduction's, its operands chosen by the range id),
// the polynomial and the range's constants, then the special ranges by
// selects; the same operations on each element as fdlibm's branches take,
// so the same bits, and a warp of mixed ranges does not diverge
__device__ __forceinline__ float atanf_xla(float x) {
  const int32_t hx = __float_as_int(x);
  const int32_t ix = hx & 0x7fffffff;
  const float ax = fabsf(x);
  const int id = ix < 0x3ee00000 ? -1   // |x| < 0.4375
                 : ix < 0x3f300000 ? 0  // < 0.6875
                 : ix < 0x3f980000 ? 1  // < 1.1875
                 : ix < 0x401c0000 ? 2  // < 2.4375
                 : 3;
  const float num = id == 0 ? 2.0f * ax - 1.0f : id == 1 ? ax - 1.0f : id == 2 ? ax - 1.5f : -1.0f;
  const float den = id == 0 ? 2.0f + ax : id == 1 ? ax + 1.0f : id == 2 ? 1.0f + 1.5f * ax : ax;
  const float xr = id < 0 ? x : num / den;
  const float z = xr * xr;
  const float w = z * z;
  float s1 = f32(0x3c8569d7u);
  s1 = s1 * w + f32(0x3d4bda59u);
  s1 = s1 * w + f32(0x3d886b35u);
  s1 = s1 * w + f32(0x3dba2e6eu);
  s1 = s1 * w + f32(0x3e124925u);
  s1 = s1 * w + f32(0x3eaaaaabu);
  s1 = s1 * z;
  float s2 = f32(0xbd15a221u);
  s2 = s2 * w + f32(0xbd6ef16bu);
  s2 = s2 * w + f32(0xbd9d8795u);
  s2 = s2 * w + f32(0xbde38e38u);
  s2 = s2 * w + f32(0xbe4ccccdu);
  s2 = s2 * w;
  const float xs = xr * (s1 + s2);
  const int idc = id < 0 ? 0 : id;
  const float r = atan_hi(idc) - ((xs - atan_lo(idc)) - xr);
  float out = id < 0 ? xr - xs : (hx < 0 ? -r : r);
  out = ix < 0x31000000 ? x : out;  // |x| < 2^-29
  const float h = atan_hi(3) + atan_lo(3);
  out = ix >= 0x4c000000 ? (ix > 0x7f800000 ? x + x : (hx > 0 ? h : -h)) : out;  // |x| >= 2^25
  return out;
}

__device__ __forceinline__ float atan2f_xla(float y, float x) {
  const float pi = f32(0x40490fdbu), pi_o_2 = f32(0x3fc90fdbu), pi_o_4 = f32(0x3f490fdbu);
  const float pi_lo_neg = f32(0x33bbbd2eu), half_pi_lo_neg = f32(0x333bbd2eu), tiny = 1.0e-30f;
  const int32_t hx = __float_as_int(x), hy = __float_as_int(y);
  const int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return x + y;
  if (hx == 0x3f800000) return atanf_xla(y);
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);
  if (iy == 0) {
    if (m <= 1) return y;
    return m == 2 ? pi + tiny : -pi - tiny;
  }
  if (ix == 0) return hy < 0 ? -pi_o_2 - tiny : pi_o_2 + tiny;
  if (ix == 0x7f800000) {
    if (iy == 0x7f800000) {
      switch (m) {
        case 0: return pi_o_4 + tiny;
        case 1: return -pi_o_4 - tiny;
        case 2: return 3.0f * pi_o_4 + tiny;
        default: return -3.0f * pi_o_4 - tiny;
      }
    }
    switch (m) {
      case 0: return 0.0f;
      case 1: return -0.0f;
      case 2: return pi + tiny;
      default: return -pi - tiny;
    }
  }
  if (iy == 0x7f800000) return hy < 0 ? -pi_o_2 - tiny : pi_o_2 + tiny;
  const int k = (iy - ix) >> 23;
  float z;
  if (k > 60)
    z = pi_o_2 - half_pi_lo_neg;
  else if (hx < 0 && k < -60)
    z = 0.0f;
  else
    z = atanf_xla(fabsf(flush(flush(y) / flush(x))));
  switch (m) {
    case 0: return z;
    case 1: return -z;
    case 2: return pi - (z + pi_lo_neg);
    default: return (z + pi_lo_neg) - pi;
  }
}

// correctly rounded, as (float)sqrt((double)v) is; a subnormal reads as 0
__device__ __forceinline__ float sqrtf_xla(float v) { return __fsqrt_rn(flush(v)); }

__device__ __forceinline__ float acosf_xla(float v) {
  return atan2f_xla(sqrtf_xla((1.0f - v) * (v + 1.0f)), v);
}

// ---- the plain versions' small pieces (ops/xla_math.py, ops/geometry.py) ----

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// torch.maximum: NaN wins
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

// sumsq3 / dot3: fma(z, z', fma(y, y', x x'))
__device__ __forceinline__ float dot3f(const float* a, const float* b) {
  return __fmaf_rn(a[2], b[2], __fmaf_rn(a[1], b[1], a[0] * b[0]));
}

// cross3: each component fma(x, y, -(u v))
__device__ __forceinline__ void cross3f(const float* a, const float* b, float* o) {
  o[0] = __fmaf_rn(a[1], b[2], -(a[2] * b[1]));
  o[1] = __fmaf_rn(a[2], b[0], -(a[0] * b[2]));
  o[2] = __fmaf_rn(a[0], b[1], -(a[1] * b[0]));
}

// geometry.skew, its zeros +0.0
__device__ __forceinline__ void skew3(const float* v, float* K) {
  K[0] = 0.0f; K[1] = -v[2]; K[2] = v[1];
  K[3] = v[2]; K[4] = 0.0f; K[5] = -v[0];
  K[6] = -v[1]; K[7] = v[0]; K[8] = 0.0f;
}

// mm3 of row-major 3 x 3 matrices: the fma chain along k from k = 0
__device__ __forceinline__ void mm3f(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = __fmaf_rn(A[3 * i + 2], B[6 + j],
                               __fmaf_rn(A[3 * i + 1], B[3 + j], A[3 * i] * B[j]));
}

// mv3: the fma chain along k from k = 0
__device__ __forceinline__ void mv3f(const float* A, const float* v, float* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = __fmaf_rn(A[3 * i + 2], v[2], __fmaf_rn(A[3 * i + 1], v[1], A[3 * i] * v[0]));
}

// rodrigues: I + a K + b KK as fma(b, KK, fma(a, K, I)) an entry
__device__ __forceinline__ void rodrigues3(float a, float b, const float* K, const float* KK,
                                           float* R) {
  for (int e = 0; e < 9; ++e) R[e] = __fmaf_rn(b, KK[e], __fmaf_rn(a, K[e], e % 4 ? 0.0f : 1.0f));
}

// geometry.so3_exp
__device__ __forceinline__ void so3_exp3(const float* w, float* R) {
  const float th2 = dot3f(w, w);
  const float th = sqrtf_xla(clamp_min(th2, 1e-24f));
  float s, c;
  sincosf_xla(th, &s, &c);
  const bool big = th2 > 1e-12f;
  const float a = big ? s / th : 1.0f - th2 * kSixth;
  const float b = big ? (1.0f - c) / th2 : 0.5f - th2 * kT24;
  float K[9], KK[9];
  skew3(w, K);
  mm3f(K, K, KK);
  rodrigues3(a, b, K, KK, R);
}

// geometry.so3_log of a 3 x 3 read with row stride rs
__device__ __forceinline__ void so3_log3(const float* R, int rs, float* phi) {
  const float tr = (R[0] + R[rs + 1]) + R[2 * rs + 2];
  const float cos_t = clamp2((tr - 1.0f) * 0.5f, -1.0f, 1.0f);
  const float th = acosf_xla(cos_t);
  const float v0 = R[2 * rs + 1] - R[rs + 2];
  const float v1 = R[2] - R[2 * rs];
  const float v2 = R[rs] - R[1];
  const float scale = th > 1e-6f ? th / (2.0f * sinf_xla(clamp_min(th, 1e-12f))) : 0.5f;
  phi[0] = v0 * scale;
  phi[1] = v1 * scale;
  phi[2] = v2 * scale;
}

// geometry.se3_exp: xi = [rho, phi] -> a row-major 4 x 4
__device__ __forceinline__ void se3_exp4(const float* xi, float* T) {
  const float* rho = xi;
  const float* phi = xi + 3;
  float R[9];
  so3_exp3(phi, R);
  const float th2 = dot3f(phi, phi);
  const float th = sqrtf_xla(clamp_min(th2, 1e-24f));
  float K[9], KK[9], V[9], t[3];
  skew3(phi, K);
  float s, c;
  sincosf_xla(th, &s, &c);
  const bool big = th2 > 1e-12f;
  const float b = big ? (1.0f - c) / th2 : 0.5f - th2 * kT24;
  const float cc = big ? (th - s) / (th2 * th) : kSixth - th2 * kT120;
  mm3f(K, K, KK);
  rodrigues3(b, cc, K, KK, V);
  mv3f(V, rho, t);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) T[4 * i + j] = R[3 * i + j];
    T[4 * i + 3] = t[i];
  }
  T[12] = 0.0f; T[13] = 0.0f; T[14] = 0.0f; T[15] = 1.0f;
}

// deskew.se3_log of a row-major 4 x 4 -> [rho, phi]
__device__ __forceinline__ void se3_log4(const float* T, float* xi) {
  float phi[3];
  so3_log3(T, 4, phi);
  const float th2 = dot3f(phi, phi);
  const float th = sqrtf_xla(clamp_min(th2, 1e-24f));
  float K[9], KK[9], V[9];
  skew3(phi, K);
  float s, c;
  sincosf_xla(th, &s, &c);
  const float a = th2 > 1e-12f ? (1.0f - th * s / (2.0f * (1.0f - c))) / th2 : kTwelfth;
  mm3f(K, K, KK);
  rodrigues3(-0.5f, a, K, KK, V);
  const float t[3] = {T[3], T[7], T[11]};
  mv3f(V, t, xi);
  xi[3] = phi[0];
  xi[4] = phi[1];
  xi[5] = phi[2];
}

// deskew.deskew of one point p at normalized time tau, by the twist xi
__device__ __forceinline__ void deskew_point(const float* p, float tau, const float* xi, float* o) {
  const float* rho = xi;
  const float* phi = xi + 3;
  const float th0 = sqrtf_xla(clamp_min(dot3f(phi, phi), 1e-24f));
  const float k[3] = {phi[0] / th0, phi[1] / th0, phi[2] / th0};
  const float s = tau - 1.0f;
  const float th = s * th0;
  float sn, cs;
  sincosf_xla(th, &sn, &cs);
  const bool small = fabsf(th) < 1e-4f;
  const float d = small ? 1.0f : th;
  const float A = small ? 0.5f * th : (1.0f - cs) / d;
  const float B = small ? th * th * kSixth : (th - sn) / d;
  float kxp[3], kkp[3], kxr[3], kkr[3];
  cross3f(k, p, kxp);
  cross3f(k, kxp, kkp);
  const float omc = 1.0f - cs;
  // k x rho and k x (k x rho) as deskew._kxr_kkr: (k x rho)_x is
  // fma(-k2, rho1, k1 rho2) where the translation and (k x (k x rho))_y
  // take it, the first form in (k x (k x rho))_z
  const float kxr_xa = __fmaf_rn(k[1], rho[2], -(k[2] * rho[1]));
  kxr[0] = __fmaf_rn(-k[2], rho[1], k[1] * rho[2]);
  kxr[1] = __fmaf_rn(k[2], rho[0], -(k[0] * rho[2]));
  kxr[2] = __fmaf_rn(k[0], rho[1], -(k[1] * rho[0]));
  kkr[0] = __fmaf_rn(k[1], kxr[2], -(k[2] * kxr[1]));
  kkr[1] = __fmaf_rn(k[2], kxr[0], -(k[0] * kxr[2]));
  kkr[2] = __fmaf_rn(k[0], kxr[1], -(k[1] * kxr_xa));
  const float sA = s * A, sB = s * B;
  for (int i = 0; i < 3; ++i) {
    const float rp = __fmaf_rn(omc, kkp[i], __fmaf_rn(sn, kxp[i], p[i]));
    const float t = __fmaf_rn(sB, kkr[i], __fmaf_rn(s, rho[i], sA * kxr[i]));
    o[i] = rp + t;
  }
}

// point_to_plane.estimate_normals_cells from a point's cell moments (count,
// sums, xx yy zz xy xz yz): the covariance, then _smallest_eigvec3
__device__ __forceinline__ void cell_normal(const float* seg, float* vec, float* lam_min_o, float* lam_mid_o) {
  const float c = clamp_min(seg[0], 1.0f);
  const float mx = seg[1] / c, my = seg[2] / c, mz = seg[3] / c;
  const float eps = 1e-9f;
  const float a00 = __fmaf_rn(-mx, mx, seg[4] / c) + eps;
  const float a11 = __fmaf_rn(-my, my, seg[5] / c) + eps;
  const float a22 = __fmaf_rn(-mz, mz, seg[6] / c) + eps;
  const float a01 = __fmaf_rn(-mx, my, seg[7] / c) + 0.0f;
  const float a02 = __fmaf_rn(-mx, mz, seg[8] / c) + 0.0f;
  const float a12 = __fmaf_rn(-my, mz, seg[9] / c) + 0.0f;
  // as the plain version: p's fusion and the determinant's contract
  // sum(a_ij^2) apart, the cosine's argument is one fma, x01's lam_min
  // adds the trace's third last
  const float tr = (a00 + a11) + a22;
  const float q = tr * kThird;
  const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  const float s1 = __fmaf_rn(b22, b22, __fmaf_rn(b00, b00, b11 * b11));
  const float s01 = __fmaf_rn(a01, a01, a02 * a02);
  const float p = sqrtf_xla(clamp_min(__fmaf_rn(__fmaf_rn(a12, a12, s01), kThird, s1 * kSixth), 1e-30f));
  const float p2 = clamp_min(__fmaf_rn(s01 + a12 * a12, kThird, s1 * kSixth), 1e-30f);
  const float detB =
      __fmaf_rn(a02, __fmaf_rn(a01, a12, -(b11 * a02)),
                __fmaf_rn(b00, __fmaf_rn(b11, b22, -(a12 * a12)),
                          -(a01 * __fmaf_rn(a01, b22, -(a12 * a02))))) /
      (p2 * p);
  const float r = clamp2(detB * 0.5f, -1.0f, 1.0f);
  const float acr = acosf_xla(r);
  const float p_2 = p * 2.0f;
  const float cos_min = cosf_xla(__fmaf_rn(acr, kThird, kTwoPiO3));
  const float lam_max = __fmaf_rn(p_2, cosf_xla(acr * kThird), q);
  const float lam_min = __fmaf_rn(p_2, cos_min, q);
  const float lam_mid = (3.0f * q - lam_max) - lam_min;
  const float lam_01 = __fmaf_rn(tr, kThird, p_2 * cos_min);
  const float d0[3] = {a00 - lam_01, a01, a02};
  const float d1[3] = {a01, a11 - lam_01, a12};
  const float c0[3] = {a00 - lam_min, a01, a02};
  const float c1[3] = {a01, a11 - lam_min, a12};
  const float c2[3] = {a02, a12, a22 - lam_min};
  float x01[3], x02[3], x12[3];
  cross3f(d0, d1, x01);
  cross3f(c0, c2, x02);
  cross3f(c1, c2, x12);
  const float n01 = dot3f(x01, x01), n02 = dot3f(x02, x02), n12 = dot3f(x12, x12);
  const float* best = (n01 >= n02 && n01 >= n12) ? x01 : (n02 >= n12 ? x02 : x12);
  const float nrm = sqrtf_xla(maximum(n01, maximum(n02, n12)));
  const float den = clamp_min(sqrtf_xla(dot3f(best, best)), 1e-20f);
  const bool ok = nrm > 1e-20f;
  vec[0] = ok ? best[0] / den : 0.0f;
  vec[1] = ok ? best[1] / den : 0.0f;
  vec[2] = ok ? best[2] / den : 1.0f;
  *lam_min_o = lam_min;
  *lam_mid_o = lam_mid;
}

// one entry of A @ B, its row of A and column of B read with strides ak and
// bk: the fma
// chain along k (xla_math.mm3), or the library GEMM's four lanes and plain
// tail (xla_math.mm_lanes)
__device__ __forceinline__ float mm_entry(const float* A, long long ak, const float* B, long long bk, int K,
                          bool lanes) {
  if (!lanes) {
    float acc = A[0] * B[0];
    for (int k = 1; k < K; ++k) acc = __fmaf_rn(A[k * ak], B[k * bk], acc);
    return acc;
  }
  const int main = K - K % 4;
  float out = 0.0f;
  if (main) {
    float acc[4];
    for (int l = 0; l < 4; ++l) {
      acc[l] = A[l * ak] * B[l * bk];
      for (int k = l + 4; k < main; k += 4) acc[l] = __fmaf_rn(A[k * ak], B[k * bk], acc[l]);
    }
    out = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }
  if (main == K) return out;
  float tail = A[main * ak] * B[main * bk];
  for (int k = main + 1; k < K; ++k) tail = tail + A[k * ak] * B[k * bk];
  return main ? out + tail : tail;
}

// ---- the IMU chains: ekf.propagate_batch and lio._dead_reckon ----
// state: p (3), v (3), R (9), bg (3), ba (3), P (225); imu rows: gyro (3),
// accel (3), dt; consts: g_w (3), q_rate (15)
constexpr int kStateLen = 246;

// the mean of one sample, in place: a_w = R f + g_w, p, v by fmas, R R(w dt)
__device__ __forceinline__ void mean_step(float* p, float* v, float* R, const float* f, const float* w,
                          float dt, const float* g_w) {
  float a_w[3], wd[3], dR[9], Rn[9];
  mv3f(R, f, a_w);
  for (int i = 0; i < 3; ++i) a_w[i] = a_w[i] + g_w[i];
  const float hdt = dt * 0.5f;
  for (int i = 0; i < 3; ++i) {
    p[i] = __fmaf_rn(a_w[i] * hdt, dt, __fmaf_rn(v[i], dt, p[i]));
    v[i] = __fmaf_rn(a_w[i], dt, v[i]);
    wd[i] = w[i] * dt;
  }
  so3_exp3(wd, dR);
  mm3f(R, dR, Rn);
  for (int e = 0; e < 9; ++e) R[e] = Rn[e];
}

// one block: ekf.propagate over the packet's n samples, a sample with
// dt > 0 applied (else a no-op, the plain version's select)
__device__ void propagate_block(const float* state, const float* imu, const float* consts,
                                float* out, int n) {
  __shared__ float sp[3], sv[3], sR[9], sP[225], sF[225], sFP[225];
  __shared__ float sdt;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < 225; e += nt) sP[e] = state[21 + e];
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) {
      sp[i] = state[i];
      sv[i] = state[3 + i];
    }
    for (int e = 0; e < 9; ++e) sR[e] = state[6 + e];
  }
  const float* bg = state + 15;
  const float* ba = state + 18;
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const float* row = imu + 7 * k;
    const float dt = row[6];
    if (!(dt > 0.0f)) continue;  // every thread reads the same dt
    if (tid == 0) {
      sdt = dt;
      float w[3], f[3], nw[3], S[9], mR[9], RS[9], Fr[9];
      for (int i = 0; i < 3; ++i) {
        w[i] = row[i] - bg[i];
        f[i] = row[3 + i] - ba[i];
      }
      // F: eye15, then the blocks in the plain version's order
      for (int e = 0; e < 225; ++e) sF[e] = e % 16 ? 0.0f : 1.0f;
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) sF[15 * i + 3 + j] = (i == j ? 1.0f : 0.0f) * dt;
      skew3(f, S);
      for (int e = 0; e < 9; ++e) mR[e] = -sR[e];
      mm3f(mR, S, RS);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          sF[15 * (3 + i) + 6 + j] = RS[3 * i + j] * dt;
          sF[15 * (3 + i) + 12 + j] = mR[3 * i + j] * dt;
          sF[15 * (6 + i) + 9 + j] = -(i == j ? 1.0f : 0.0f) * dt;
        }
      for (int i = 0; i < 3; ++i) nw[i] = -w[i] * dt;
      so3_exp3(nw, Fr);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) sF[15 * (6 + i) + 6 + j] = Fr[3 * i + j];
    }
    __syncthreads();
    // F P, then (F P) F^T + diag(q dt), the library GEMM's order
    for (int e = tid; e < 225; e += nt) {
      const int m = e / 15, c = e % 15;
      sFP[e] = mm_entry(sF + 15 * m, 1, sP + c, 15, 15, true);
    }
    __syncthreads();
    for (int e = tid; e < 225; e += nt) {
      const int m = e / 15, c = e % 15;
      const float x = mm_entry(sFP + 15 * m, 1, sF + 15 * c, 1, 15, true);
      sP[e] = x + (m == c ? consts[3 + m] * sdt : 0.0f);
    }
    if (tid == 0) {
      float w[3], f[3];
      for (int i = 0; i < 3; ++i) {
        w[i] = row[i] - bg[i];
        f[i] = row[3 + i] - ba[i];
      }
      mean_step(sp, sv, sR, f, w, dt, consts);
    }
    __syncthreads();
  }
  for (int e = tid; e < 225; e += nt) out[21 + e] = sP[e];
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) {
      out[i] = sp[i];
      out[3 + i] = sv[i];
      out[15 + i] = bg[i];
      out[18 + i] = ba[i];
    }
    for (int e = 0; e < 9; ++e) out[6 + e] = sR[e];
  }
}

// one thread: lio._dead_reckon over K frames of Ki samples, the poses at
// each frame's end (Rs (K, 9), ts (K, 3)); no sample is skipped
__device__ void dead_reckon(const float* state, const float* imu, const float* consts,
                            float* Rs, float* ts, int K, int Ki) {
  float p[3], v[3], R[9];
  for (int i = 0; i < 3; ++i) {
    p[i] = state[i];
    v[i] = state[3 + i];
  }
  for (int e = 0; e < 9; ++e) R[e] = state[6 + e];
  const float* bg = state + 15;
  const float* ba = state + 18;
  for (int k = 0; k < K; ++k) {
    for (int j = 0; j < Ki; ++j) {
      const float* row = imu + 7 * (k * Ki + j);
      float w[3], f[3];
      for (int i = 0; i < 3; ++i) {
        w[i] = row[i] - bg[i];
        f[i] = row[3 + i] - ba[i];
      }
      mean_step(p, v, R, f, w, row[6], consts);
    }
    for (int e = 0; e < 9; ++e) Rs[9 * k + e] = R[e];
    for (int i = 0; i < 3; ++i) ts[3 * k + i] = p[i];
  }
}

// ---- the kernels: one for each function (a template instance each), so
// each has its own registers, launch bounds and shared memory ----

constexpr int kThreads = 256;

template <int FN>
__device__ __forceinline__ void ew_apply(float a, float b, float c, float* r0, float* r1) {
  if constexpr (FN == kSinCos) {
    sincosf_xla(a, r0, r1);
  } else if constexpr (FN == kAtan2) {
    *r0 = atan2f_xla(a, b);
  } else if constexpr (FN == kAcos) {
    *r0 = acosf_xla(a);
  } else {  // kFma
    *r0 = __fmaf_rn(a, b, c);
  }
}

__device__ __forceinline__ float4 load4(const float* __restrict__ p, long long q) {
  return reinterpret_cast<const float4*>(p)[q];
}

// an elementwise function on contiguous operands, an operand of one element
// read as a scalar (bit j of `mask` for operand j); with VEC four elements a
// thread through 16-byte loads and stores (every operand and output aligned
// to 16 bytes), the last n % 4 one a thread
template <int FN, bool VEC>
__global__ void __launch_bounds__(kThreads)
    xm_ew(const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ c,
          int mask, float* __restrict__ o0, float* __restrict__ o1, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float sa = (mask & 1) ? a[0] : 0.0f;
  const float sb = (FN == kAtan2 || FN == kFma) && (mask & 2) ? b[0] : 0.0f;
  const float sc = FN == kFma && (mask & 4) ? c[0] : 0.0f;
  long long done = 0;
  if constexpr (VEC) {
    const long long n4 = n >> 2;
    for (long long q = t; q < n4; q += stride) {
      const float4 va = (mask & 1) ? make_float4(sa, sa, sa, sa) : load4(a, q);
      float4 vb = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vc = vb;
      if constexpr (FN == kAtan2 || FN == kFma) vb = (mask & 2) ? make_float4(sb, sb, sb, sb) : load4(b, q);
      if constexpr (FN == kFma) vc = (mask & 4) ? make_float4(sc, sc, sc, sc) : load4(c, q);
      float4 r0, r1;
      ew_apply<FN>(va.x, vb.x, vc.x, &r0.x, &r1.x);
      ew_apply<FN>(va.y, vb.y, vc.y, &r0.y, &r1.y);
      ew_apply<FN>(va.z, vb.z, vc.z, &r0.z, &r1.z);
      ew_apply<FN>(va.w, vb.w, vc.w, &r0.w, &r1.w);
      reinterpret_cast<float4*>(o0)[q] = r0;
      if constexpr (FN == kSinCos) reinterpret_cast<float4*>(o1)[q] = r1;
    }
    done = n4 << 2;
  }
  for (long long i = done + t; i < n; i += stride) {
    const float va = (mask & 1) ? sa : a[i];
    float vb = 0.0f, vc = 0.0f;
    if constexpr (FN == kAtan2 || FN == kFma) vb = (mask & 2) ? sb : b[i];
    if constexpr (FN == kFma) vc = (mask & 4) ? sc : c[i];
    float r0, r1;
    ew_apply<FN>(va, vb, vc, &r0, &r1);
    o0[i] = r0;
    if constexpr (FN == kSinCos) o1[i] = r1;
  }
}

// the shapes and strides of an elementwise call whose operands broadcast:
// the output's dimensions (row-major, padded in front with 1) and each
// operand's strides into them (0 along a broadcast dimension)
struct Bcast {
  long long d[4];
  long long s[3][4];
};

template <int FN>
__global__ void __launch_bounds__(kThreads)
    xm_ew_strided(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ c, float* __restrict__ o0, float* __restrict__ o1,
                  long long n, Bcast bc) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    long long rest = i, off[3] = {0, 0, 0};
    for (int k = 3; k >= 0; --k) {
      const long long idx = rest % bc.d[k];
      rest /= bc.d[k];
      for (int j = 0; j < 3; ++j) off[j] += idx * bc.s[j][k];
    }
    float vb = 0.0f, vc = 0.0f;
    if constexpr (FN == kAtan2 || FN == kFma) vb = b[off[1]];
    if constexpr (FN == kFma) vc = c[off[2]];
    float r0, r1;
    ew_apply<FN>(a[off[0]], vb, vc, &r0, &r1);
    o0[i] = r0;
    if constexpr (FN == kSinCos) o1[i] = r1;
  }
}

// |p|^2 of (n, 3) rows
__global__ void __launch_bounds__(kThreads)
    xm_norm2(const float* __restrict__ a, float* __restrict__ o0, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    o0[i] = dot3f(a + 3 * i, a + 3 * i);
}

// one entry of a batched A @ B a thread; v: M, K, N, then the strides of A
// (batch, m, k) and of B (batch, k, n)
template <bool LANES>
__global__ void __launch_bounds__(kThreads)
    xm_mm(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ o0,
          long long n, Params prm) {
  const long long* v = prm.v;
  const long long M = v[0], N = v[2];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long bi = i / (M * N), m = (i / N) % M, nn = i % N;
    o0[i] = mm_entry(a + bi * v[3] + m * v[4], v[5], b + bi * v[6] + nn * v[8], v[7], (int)v[1],
                     LANES);
  }
}

// a composite function, a batch item (or a point) a thread
template <int FN>
__global__ void __launch_bounds__(kThreads)
    xm_batch(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ c, float* __restrict__ o0, float* __restrict__ o1,
             float* __restrict__ o2, long long n, long long p0, long long p1) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if constexpr (FN == kSo3Exp) {
      so3_exp3(a + 3 * i, o0 + 9 * i);
    } else if constexpr (FN == kSo3Log) {
      so3_log3(a + 9 * i, 3, o0 + 3 * i);
    } else if constexpr (FN == kSe3Exp) {
      se3_exp4(a + 6 * i, o0 + 16 * i);
    } else if constexpr (FN == kSe3Log) {
      se3_log4(a + 16 * i, o0 + 6 * i);
    } else if constexpr (FN == kDeskew) {
      // p0: points a frame, p1: the twists' batch stride (0: one twist)
      deskew_point(a + 3 * i, b[i], c + (i / p0) * p1, o0 + 3 * i);
    } else {  // kCellNormals
      cell_normal(a + 10 * i, o0 + 3 * i, o1 + i, o2 + i);
    }
  }
}

// the two serial chains: one block for the IMU packet's propagation, one
// thread for the block's dead reckoning
__global__ void __launch_bounds__(kThreads)
    xm_propagate(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ c, float* __restrict__ o0, int n) {
  propagate_block(a, b, c, o0, n);
}

__global__ void __launch_bounds__(32)
    xm_dead_reckon(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ c, float* __restrict__ o0, float* __restrict__ o1,
                   int K, int Ki) {
  if (threadIdx.x == 0) dead_reckon(a, b, c, o0, o1, K, Ki);
}

}  // namespace

namespace {

// kernels this library launched (sfk_xla_math_kernel_launches)
long long g_launches = 0;

int launched() {
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++g_launches;
  return (int)e;
}

int grid_for(long long items) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  return (int)(blocks < 132LL * 16 ? blocks : 132LL * 16);
}

template <int FN>
int launch_ew(const float* a, const float* b, const float* c, int mask, float* o0, float* o1,
              long long n, cudaStream_t stream) {
  // 16-byte access needs every streamed operand and output aligned
  uintptr_t any = (uintptr_t)o0 | (uintptr_t)(FN == kSinCos ? o1 : o0);
  if (!(mask & 1)) any |= (uintptr_t)a;
  if ((FN == kAtan2 || FN == kFma) && !(mask & 2)) any |= (uintptr_t)b;
  if (FN == kFma && !(mask & 4)) any |= (uintptr_t)c;
  if ((any & 15) == 0 && n >= 4)
    xm_ew<FN, true><<<grid_for((n + 3) / 4), kThreads, 0, stream>>>(a, b, c, mask, o0, o1, n);
  else
    xm_ew<FN, false><<<grid_for(n), kThreads, 0, stream>>>(a, b, c, mask, o0, o1, n);
  return launched();
}

template <int FN>
int launch_ew_strided(const float* a, const float* b, const float* c, float* o0, float* o1,
                      long long n, const Bcast& bc, cudaStream_t stream) {
  xm_ew_strided<FN><<<grid_for(n), kThreads, 0, stream>>>(a, b, c, o0, o1, n, bc);
  return launched();
}

template <int FN>
int launch_batch(const float* a, const float* b, const float* c, float* o0, float* o1, float* o2,
                 long long n, long long p0, long long p1, cudaStream_t stream) {
  xm_batch<FN><<<grid_for(n), kThreads, 0, stream>>>(a, b, c, o0, o1, o2, n, p0, p1);
  return launched();
}

bool needs(int fn, const float* a, const float* b, const float* c, float* o1, float* o2) {
  const bool imu = fn == kPropagate || fn == kDeadReckon;
  const bool two_in =
      fn == kAtan2 || fn == kFma || fn == kMm || fn == kMmLanes || fn == kDeskew || imu;
  const bool three_in = fn == kFma || fn == kDeskew || imu;
  return a != nullptr && !(two_in && b == nullptr) && !(three_in && c == nullptr) &&
         !((fn == kSinCos || fn == kCellNormals || fn == kDeadReckon) && o1 == nullptr) &&
         !(fn == kCellNormals && o2 == nullptr);
}

}  // namespace

// The elementwise functions on contiguous operands (bit j of scalar_mask:
// operand j is one element, read as a scalar).
extern "C" int sfk_xla_ew(int fn, const float* a, const float* b, const float* c,
                          int scalar_mask, float* out0, float* out1, long long n,
                          cudaStream_t stream) {
  if (fn < kSinCos || fn > kFma || out0 == nullptr || !needs(fn, a, b, c, out1, out0))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  switch (fn) {
    case kSinCos: return launch_ew<kSinCos>(a, b, c, scalar_mask, out0, out1, n, stream);
    case kAtan2: return launch_ew<kAtan2>(a, b, c, scalar_mask, out0, out1, n, stream);
    case kAcos: return launch_ew<kAcos>(a, b, c, scalar_mask, out0, out1, n, stream);
    default: return launch_ew<kFma>(a, b, c, scalar_mask, out0, out1, n, stream);
  }
}

// The elementwise functions on operands that broadcast: the output's 4
// dimensions (d0 outermost) and each operand's 4 strides into them.
extern "C" int sfk_xla_ew_strided(int fn, const float* a, const float* b, const float* c,
                                  float* out0, float* out1, long long n, long long d0,
                                  long long d1, long long d2, long long d3, long long a0,
                                  long long a1, long long a2, long long a3, long long b0,
                                  long long b1, long long b2, long long b3, long long c0,
                                  long long c1, long long c2, long long c3, cudaStream_t stream) {
  if (fn < kSinCos || fn > kFma || out0 == nullptr || !needs(fn, a, b, c, out1, out0) ||
      d0 <= 0 || d1 <= 0 || d2 <= 0 || d3 <= 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const Bcast bc = {{d0, d1, d2, d3}, {{a0, a1, a2, a3}, {b0, b1, b2, b3}, {c0, c1, c2, c3}}};
  switch (fn) {
    case kSinCos: return launch_ew_strided<kSinCos>(a, b, c, out0, out1, n, bc, stream);
    case kAtan2: return launch_ew_strided<kAtan2>(a, b, c, out0, out1, n, bc, stream);
    case kAcos: return launch_ew_strided<kAcos>(a, b, c, out0, out1, n, bc, stream);
    default: return launch_ew_strided<kFma>(a, b, c, out0, out1, n, bc, stream);
  }
}

// The composite functions (norm2 and past it; the elementwise ones launch
// through sfk_xla_ew or sfk_xla_ew_strided), their integer arguments
// p0..p9 (shapes and strides).
extern "C" int sfk_xla_math(int fn, const float* a, const float* b, const float* c,
                            float* out0, float* out1, float* out2, long long n,
                            long long p0, long long p1, long long p2, long long p3,
                            long long p4, long long p5, long long p6, long long p7,
                            long long p8, long long p9, cudaStream_t stream) {
  if (fn <= kFma || fn > kDeadReckon || out0 == nullptr || !needs(fn, a, b, c, out1, out2))
    return (int)cudaErrorInvalidValue;
  if (fn == kPropagate) {
    xm_propagate<<<1, kThreads, 0, stream>>>(a, b, c, out0, (int)p0);
    return launched();
  }
  if (fn == kDeadReckon) {
    xm_dead_reckon<<<1, 32, 0, stream>>>(a, b, c, out0, out1, (int)p0, (int)p1);
    return launched();
  }
  if (n <= 0) return 0;
  if (fn == kNorm2) {
    xm_norm2<<<grid_for(n), kThreads, 0, stream>>>(a, out0, n);
    return launched();
  }
  if (fn == kMm || fn == kMmLanes) {
    const Params prm = {{p0, p1, p2, p3, p4, p5, p6, p7, p8, p9}};
    if (fn == kMm)
      xm_mm<false><<<grid_for(n), kThreads, 0, stream>>>(a, b, out0, n, prm);
    else
      xm_mm<true><<<grid_for(n), kThreads, 0, stream>>>(a, b, out0, n, prm);
    return launched();
  }
  switch (fn) {
    case kSo3Exp: return launch_batch<kSo3Exp>(a, b, c, out0, out1, out2, n, p0, p1, stream);
    case kSo3Log: return launch_batch<kSo3Log>(a, b, c, out0, out1, out2, n, p0, p1, stream);
    case kSe3Exp: return launch_batch<kSe3Exp>(a, b, c, out0, out1, out2, n, p0, p1, stream);
    case kSe3Log: return launch_batch<kSe3Log>(a, b, c, out0, out1, out2, n, p0, p1, stream);
    case kDeskew: return launch_batch<kDeskew>(a, b, c, out0, out1, out2, n, p0, p1, stream);
    default:
      return launch_batch<kCellNormals>(a, b, c, out0, out1, out2, n, p0, p1, stream);
  }
}

// The kernels this library has launched since it was loaded: a call's
// launches are the difference across it.
extern "C" long long sfk_xla_math_kernel_launches() { return g_launches; }

"""ops/xla_math against the JAX package's jitted float32 math on the CPU, bit
for bit (atol=0): glibc's sinf / cosf / sincosf and atan2f as XLA calls
them, XLA's arccos rewrite, the correctly rounded sqrt, and the fused
multiply-add chains XLA makes of a sum of three squares, a 3x3 product, a
3x3 matrix-vector product, Rodrigues' I + a K + b K^2 and a cross product.

Each sweep is ~2^18 seeded float32 values a function: angles in [-pi, pi],
magnitudes of 1e-8 to 1e6 of either sign ([-1, 1] for acos), random bit
patterns (subnormals, infinities, NaNs among them) and the special values;
NaN matches NaN. XLA runs with denormals-are-zero and flush-to-zero, so
atan2(1e-40, 1e-39) is NaN and sqrt(1e-40) is 0 on both sides. Also: K2's
plain version gives the same bits through the moved fma helper
(`xla_math.dot3`) as through its former float64 formula."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu.ops import geometry as jg
from slam_sensor_fusion_tpu_torch.ops import nn_pallas as tnn
from slam_sensor_fusion_tpu_torch.ops import xla_math as xm
from torch_world import K2_CASES, k2_case


N = 1 << 18
SPECIAL = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-39, -3e-39, 1.17e-38, np.inf, -np.inf, np.nan,
                    1.0, -1.0, 0.78539816, 120.0, -120.0, 119.99999, 3.4e38, 2.0**-12, 2.0**-29,
                    2.0**25, 1e6, -1e6], np.float32)


def _sweep(seed: int, unit: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = (N - SPECIAL.size) // 3
    bits = rng.integers(0, 2**32, q, dtype=np.uint64).astype(np.uint32).view(np.float32)
    if unit:
        a = rng.uniform(-1.0, 1.0, 2 * q)
    else:
        a = np.concatenate([rng.uniform(-np.pi, np.pi, q),
                            np.sign(rng.normal(size=q)) * 10.0 ** rng.uniform(-8, 6, q)])
    return np.concatenate([SPECIAL, a.astype(np.float32), bits])


def _same(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), f"{int((~same).sum())} of {same.size} differ"


@pytest.mark.parametrize("fn", ["sin", "cos", "sincos"])
def test_sin_cos_equal_xla(fn):
    y = _sweep(1)
    ref = jax.jit(lambda a: (jnp.sin(a), jnp.cos(a)))(y)
    if fn == "sincos":
        for g, w in zip(xm.sincosf(torch.from_numpy(y)), ref):
            _same(g, w)
    else:
        _same(getattr(xm, f"{fn}f")(torch.from_numpy(y)), ref[fn == "cos"])


def test_atan2_equals_xla():
    rng = np.random.default_rng(2)
    y = _sweep(2)
    x = rng.permutation(y)
    # the special values against each other, every pair
    yy, xx = np.meshgrid(SPECIAL, SPECIAL)
    y, x = np.concatenate([y, yy.ravel()]), np.concatenate([x, xx.ravel()])
    _same(xm.atan2f(torch.from_numpy(y), torch.from_numpy(x)), jax.jit(jnp.arctan2)(y, x))


def test_acos_equals_xla():
    x = np.concatenate([_sweep(3, unit=True), _sweep(4)[: N // 8]])
    _same(xm.acosf(torch.from_numpy(x)), jax.jit(jnp.arccos)(x))


def test_sqrt_equals_xla():
    x = np.abs(_sweep(5))
    _same(xm.sqrtf(torch.from_numpy(x)), jax.jit(jnp.sqrt)(x))


def test_fma_chains_equal_xla():
    """sumsq3 / norm2, fma32, mm3, mv3, cross3 and rodrigues against the
    jitted JAX expressions they stand for (the product sums are contracted
    by XLA's CPU compiler)."""
    rng = np.random.default_rng(6)
    w = (rng.normal(size=(N // 4, 3)) * 10.0 ** rng.uniform(-4, 1, (N // 4, 1))).astype(np.float32)
    tw = torch.from_numpy(w)
    _same(xm.norm2(tw), jax.jit(lambda v: jnp.sum(v * v, axis=-1))(w))
    a, b, c = (rng.normal(size=N // 4).astype(np.float32) for _ in range(3))
    _same(xm.fma32(*map(torch.from_numpy, (a, b, c))),
          np.float32(a.astype(np.float64) * b + c))  # the exact product, one rounding
    A = rng.normal(size=(N // 16, 3, 3)).astype(np.float32)
    B = rng.normal(size=(N // 16, 3, 3)).astype(np.float32)
    tA, tB = torch.from_numpy(A), torch.from_numpy(B)
    _same(xm.mm3(tA, tB), jax.jit(lambda p, q: p @ q)(A, B))
    _same(xm.mv3(tA, tB[:, 0]), jax.jit(lambda p, q: jnp.einsum("...ij,...j->...i", p, q))(A, B[:, 0]))
    u, v = w[: N // 16], w[N // 16: N // 8]
    got = torch.stack(xm.cross3(torch.from_numpy(u).unbind(-1), torch.from_numpy(v).unbind(-1)), -1)
    _same(got, jax.jit(jnp.cross)(u, v))
    # Rodrigues as so3_exp's fusion has it
    K = jg.skew(jnp.asarray(w[: N // 16]))
    s = rng.uniform(-1, 1, (2, N // 16)).astype(np.float32)
    ref = jax.jit(lambda a, b, K: jnp.eye(3) + a[:, None, None] * K + b[:, None, None] * (K @ K))(
        s[0], s[1], K)
    tK = torch.from_numpy(np.array(K))
    _same(xm.rodrigues(torch.from_numpy(s[0]), torch.from_numpy(s[1]), tK, xm.mm3(tK, tK)), ref)


@pytest.mark.parametrize("case", ["False", "True"])
def test_k2_plain_keeps_its_bits_through_the_moved_helper(case, monkeypatch):
    """K2's plain version (the reference of K2_DIGEST's kernel) gives the
    same d2, idx and xyz through `xla_math.dot3` (exact fma) as through the
    float64 product-sum it used before, on K2's cases at the bench's tiles
    with and without exact ties (the wide-tile cases add only time)."""
    ties, n_tiles, TM = K2_CASES[case]
    args = k2_case(0, ties, torch.device("cpu"), n_tiles, TM)
    got = tnn.pair_nn_plain(*args)

    def former(ax, ay, az, bx, by, bz):
        p = ax * bx
        p = (ay.double() * by.double() + p.double()).float()
        return (az.double() * bz.double() + p.double()).float()

    monkeypatch.setattr(xm, "dot3", former)
    for g, w in zip(got, tnn.pair_nn_plain(*args)):
        assert torch.equal(g, w)


def test_kernel_wrappers_refuse_other_devices():
    """CPU tensors run the plain versions; a device that is neither CPU nor
    CUDA raises (no quiet fallback)."""
    with pytest.raises(ValueError):
        xm.sinf(torch.ones(4, device="meta"))

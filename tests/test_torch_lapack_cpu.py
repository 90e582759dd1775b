"""The port's CPU LAPACK calls (ops/lapack_cpu) against the JAX package's:
`inv`, `solve` and `eigh` of float32 CPU tensors bit-equal to the jitted
`jnp.linalg.inv`, `solve` and `eigh`, at the LIO's shapes ((3, 3), (6, 6))
and batched, for a non-symmetric input to `eigh` (jax symmetrizes it), for
singular matrices (no raise; the bits of jaxlib's inf and NaN) and for
isotropic cells. jaxlib calls scipy's LAPACK and BLAS on the CPU, and so
does the port, in the same process: the bits are equal by construction,
and these tests hold the call sequence (getrf, the pivots, the two trsm,
the symmetrization, syevd on the lower triangle) to it. A tensor on any
other device raises, and the callers' dispatch sends it to `torch.linalg`
instead (a meta tensor stands in for the card's here)."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu_torch.models import ekf as te
from slam_sensor_fusion_tpu_torch.ops import lapack_cpu as lc
from slam_sensor_fusion_tpu_torch.ops import point_to_plane as tp
from torch_parity import t

_inv = jax.jit(jnp.linalg.inv)
_solve = jax.jit(jnp.linalg.solve)
_eigh = jax.jit(jnp.linalg.eigh)


def _bits_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def _matrices(seed: int, shape: tuple, spd: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, shape).astype(np.float32)
    if spd:  # as the Kalman updates' innovation covariances are
        a = (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(shape[-1])).astype(np.float32)
    return a


@pytest.mark.parametrize("shape", [(3, 3), (6, 6), (16, 16), (8, 6, 6), (2, 5, 3, 3)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("spd", [False, True], ids=["general", "spd"])
def test_inv_bits_equal_jax(shape, spd):
    for seed in range(10):
        a = _matrices(seed, shape, spd)
        _bits_equal(lc.inv(t(a)), _inv(a))


@pytest.mark.parametrize("a_shape, b_shape", [((6, 6), (6,)), ((3, 3), (3,)), ((6, 6), (6, 2)),
                                              ((5, 6, 6), (6,)), ((4, 3, 3), (4, 3, 2))],
                         ids=["6", "3", "6x2", "batch-vector", "batch-matrix"])
def test_solve_bits_equal_jax(a_shape, b_shape):
    for seed in range(10):
        a = _matrices(seed, a_shape, spd=seed % 2 == 1)
        b = np.random.default_rng(100 + seed).normal(0, 1, b_shape).astype(np.float32)
        _bits_equal(lc.solve(t(a), t(b)), _solve(a, b))


@pytest.mark.parametrize("shape", [(200, 3, 3), (3, 3), (6, 6), (2, 7, 3, 3)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sym", [True, False], ids=["symmetric", "nonsymmetric"])
def test_eigh_bits_equal_jax(shape, sym):
    """Values and vectors, signs included; a non-symmetric input is
    symmetrized first, as `jnp.linalg.eigh` does by default."""
    a = _matrices(7, shape, spd=sym)
    w, v = lc.eigh(t(a))
    w_j, v_j = _eigh(a)
    _bits_equal(w, w_j)
    _bits_equal(v, v_j)


def test_eigh_repeated_matrices_solved_once_bit_equal():
    """The estimators' many empty cells (the same matrix) and -0.0 against
    +0.0 entries, which must not share a solve."""
    a = np.tile(np.eye(3, dtype=np.float32) * np.float32(1e-9), (300, 1, 1))
    a[::7] = _matrices(8, (43, 3, 3), spd=True)
    a[1, 0, 1] = a[1, 1, 0] = np.float32(-0.0)
    w, v = lc.eigh(t(a))
    w_j, v_j = _eigh(a)
    _bits_equal(w, w_j)
    _bits_equal(v, v_j)


_SINGULAR = {
    "zeros-6": np.zeros((6, 6), np.float32),
    "ones-3": np.ones((3, 3), np.float32),
    "zero-pivot-6": np.diag(np.float32([1, 2, 0, 3, 4, 5])),
    "rank1-6": np.outer(np.arange(1, 7), np.arange(1, 7)).astype(np.float32),
    "rank2-3": np.float32([[1, 2, 3], [2, 4, 6], [1, 0, 1]]),
}


@pytest.mark.parametrize("name", list(_SINGULAR))
def test_singular_follows_jax_not_torch(name):
    """jaxlib does not raise on an exactly singular matrix (its LU has a
    zero pivot; the triangular solves give inf and NaN); torch's CPU `inv`
    does. The port returns jaxlib's bits."""
    a = _SINGULAR[name]
    b = np.arange(1, a.shape[0] + 1, dtype=np.float32)
    want = np.asarray(_inv(a))
    assert not np.isfinite(want).all()
    _bits_equal(lc.inv(t(a)), want)
    _bits_equal(tp._inv(t(a)), want)
    _bits_equal(te._inv(t(a)), want)
    _bits_equal(lc.solve(t(a), t(b)), _solve(a, b))
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.inv(t(a))


@pytest.mark.parametrize("scale", [1e-9, 1.0, 0.0])
def test_eigh_isotropic_cell(scale):
    """An isotropic cell (the estimators' regularized empty cell is 1e-9 I):
    jaxlib's eigenvectors, the identity's columns, bit for bit."""
    a = np.eye(3, dtype=np.float32) * np.float32(scale)
    w, v = lc.eigh(t(a))
    w_j, v_j = _eigh(a)
    _bits_equal(w, w_j)
    _bits_equal(v, v_j)
    _bits_equal(tp._eigh(t(a[None]))[1], np.asarray(v_j)[None])


def test_off_cpu_raises_and_callers_dispatch():
    """A tensor on another device (a meta tensor here, for want of a card)
    raises in the module, which copies nothing off it; the callers send it
    to torch.linalg, as they send a CUDA tensor."""
    a = torch.eye(3, device="meta")
    for call in (lambda: lc.inv(a), lambda: lc.solve(a, a[0]), lambda: lc.eigh(a)):
        with pytest.raises(ValueError, match="only CPU tensors"):
            call()
    assert tp._inv(a).device.type == "meta"
    assert te._inv(a).device.type == "meta"
    assert tp._solve(a, a[0]).device.type == "meta"
    assert tp._eigh(a[None])[1].device.type == "meta"
    with pytest.raises(ValueError, match="expected float32"):
        lc.inv(torch.eye(3, dtype=torch.float64))


def test_port_imports_without_scipy():
    """scipy is imported inside the module's functions only: the port's
    entry points import without it."""
    code = ("import sys; import slam_sensor_fusion_tpu_torch.api, "
            "slam_sensor_fusion_tpu_torch.models.lio, slam_sensor_fusion_tpu_torch.ops.lapack_cpu; "
            "assert 'scipy' not in sys.modules and 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


def test_pose_covariance_from_jtj_inverse_bits_equal_jax():
    """The GN covariance's inverse, as `pose_covariance_from_jtj` takes it:
    (JtJ + 1e-6 I)^-1 of an ill-conditioned JtJ (a corridor), bit-equal."""
    rng = np.random.default_rng(5)
    J = rng.normal(0, 1, (400, 6)).astype(np.float32)
    J[:, 1] *= 3e-3
    A = (J.T @ J).astype(np.float32) + np.float32(1e-6) * np.eye(6, dtype=np.float32)
    _bits_equal(tp._inv(t(A)), _inv(A))

"""The port's prefix sum in XLA's order (ops/ordered_scan) against
`jnp.cumsum` on the CPU, bit for bit.

The JAX package takes the cell normals' moments from `jnp.cumsum`
(ops/point_to_plane.py:333), which XLA on the CPU computes as a blocked
scan of 16-row blocks (each from +0.0), a recursive scan of the block
totals and an exclusive prefix added to each block. `cumsum_rows_plain`
adds in that order, so the bits are EQUAL, -0.0 rows included (XLA's
+0.0 start turns a leading -0.0 into +0.0, but a scan of one row is
returned as it is): a jaxlib that changes the order fails here first. The lengths cover one row, a partial block, one
block, a block and a row, 16 blocks and either side of it, 16^3 + 1 rows
and 4096 blocks + 3 rows (4 levels of totals)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_sensor_fusion_tpu_torch.ops import ordered_scan as os_
from torch_parity import t

_jax_cumsum = jax.jit(lambda a: jnp.cumsum(a, axis=0))


def _moments(N, seed):
    """(N, 10) float32 moments as the cell-normal estimator builds them
    (count, sums, products) from a masked cloud at world coordinates
    around (-140, 60, -2) m: masked rows give x * 0 = -0.0, and the first
    rows are masked, so the scan starts on -0.0."""
    rng = np.random.default_rng(seed)
    p = (rng.normal(0.0, 12.0, (N, 3)) + [-140.0, 60.0, -2.0]).astype(np.float32)
    w = (rng.uniform(size=N) < 0.7).astype(np.float32)
    w[: min(N, 5)] = 0.0
    x, y, z = p[:, 0] * w, p[:, 1] * w, p[:, 2] * w
    return np.stack([w, x, y, z, x * p[:, 0], y * p[:, 1], z * p[:, 2],
                     x * p[:, 1], x * p[:, 2], y * p[:, 2]], axis=1).astype(np.float32)


@pytest.mark.parametrize("N", [1, 15, 16, 17, 255, 256, 257, 4097, 65539])
def test_cumsum_rows_plain_bits_equal_jnp_cumsum(N):
    mom = _moments(N, N)
    assert np.signbit(mom[:, 1:4][mom[:, 0] == 0]).any()  # -0.0 rows present
    want = np.asarray(_jax_cumsum(jnp.asarray(mom)))
    got = os_.cumsum_rows_plain(t(mom))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # the leading -0.0 rows give +0.0, unless the scan is of one row
    assert np.signbit(got.numpy()[:5]).any() == (N == 1)
    # torch.cumsum adds in another order (float64 on the CPU)
    if N >= 4097:
        assert not np.array_equal(torch.cumsum(t(mom), dim=0).numpy(), want)


def test_cumsum_rows_dispatch():
    """CPU tensors run the plain version, in their own dtype; a device
    without a kernel, or a tensor that is not (N, C), raises."""
    mom = _moments(300, 1)
    x = t(mom)
    assert torch.equal(os_.cumsum_rows(x).view(torch.int32),
                       os_.cumsum_rows_plain(x).view(torch.int32))
    got = os_.cumsum_rows(x.double())
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.cumsum(mom.astype(np.float64), axis=0),
                               rtol=1e-12, atol=1e-9)
    assert os_.cumsum_rows(x[:0]).shape == (0, 10)
    with pytest.raises(ValueError, match="unsupported device"):
        os_.cumsum_rows(x.to("meta"))
    with pytest.raises(ValueError, match="expected"):
        os_.cumsum_rows(x[:, 0])
    # the kernel's chunks and scratch are the library's own
    # (tests/test_torch_ordered_scan_host.py)

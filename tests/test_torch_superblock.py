"""K1 (the whole-superblock fine loop, ops/superblock_fused.superblock_fine)
of the PyTorch port against the JAX Pallas kernel in interpret mode, in
parity (lazy ICP) and fast (fresh ICP) modes, with one invalid frame, and
at source tilings the JAX package's configurations use past 8 tiles of at
most 1024 rows (more tiles; one tile wider than 1024 rows).

Both get the same inputs: one real superblock of the small test world,
staged by the port's prologue. Poses, priors, odometry predictions and the
state carry agree to 3e-4 (the JAX package's own kernel-vs-scan bound,
tests/test_superblock_kernel.py); iterations, correspondence counts, the
converged flags and the queue count are EQUAL."""

import jax.numpy as jnp
import numpy as np
import pytest

from slam_sensor_fusion_tpu.ops.superblock_fused import superblock_fine as j_superblock_fine
from slam_sensor_fusion_tpu_torch.ops.superblock_fused import superblock_fine
from torch_parity import jax_config
from torch_world import compare_superblock, superblock_args


@pytest.mark.parametrize(
    "mode, src_tiles",
    [("parity", None), ("fast", None), ("parity", (16, 128)), ("parity", (1, 2048))],
    ids=["parity", "fast", "parity-16x128", "parity-1x2048"],
)
def test_superblock_plain_matches_jax_kernel(mode, src_tiles):
    """The test world's 2048-point cropped scan in 8 source tiles of 256,
    and re-tiled past the register layout of the port's kernel: 16 tiles
    of 128, and one tile of 2048 rows."""
    cfg, args = superblock_args(mode, src_tiles=src_tiles)
    got = superblock_fine(*args, cfg)  # CPU tensors -> the plain version
    want = j_superblock_fine(
        *[jnp.asarray(x.numpy()) for x in args], jax_config(cfg), interpret=True
    )
    valid = args[4].numpy()
    compare_superblock([np.asarray(x) for x in want], [x.numpy() for x in got], valid)
    # frames converge within the block: the comparison is not vacuous
    assert got[3][:, 1].max() > 1


def test_superblock_rejects_malformed_inputs():
    """The wrapper checks every input's dtype, shape and layout before it
    dispatches (a kernel reads raw pointers)."""
    cfg, args = superblock_args("parity")
    bad = list(args)
    bad[0] = args[0].transpose(2, 3)  # non-contiguous pages
    with pytest.raises(ValueError, match="src_pages"):
        superblock_fine(*bad, cfg)
    bad = list(args)
    bad[9] = args[9].double()
    with pytest.raises(ValueError, match="pose"):
        superblock_fine(*bad, cfg)
    bad = list(args)
    bad[11] = args[11][:2]
    with pytest.raises(ValueError, match="filt_trans"):
        superblock_fine(*bad, cfg)

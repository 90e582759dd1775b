"""The registration kernels' one tile-shape rule (ops/cuda_lib.check_tile_src):
on the card each of K1-K7's wrappers takes a source tile of 32 to 4096 rows
in steps of 32 and raises past that, with the limit in the message. The
rule is a plain function, so it is pinned here on the CPU (where the
wrappers run their plain versions, which take any width); each wrapper is
held to call it. Imports nothing of JAX."""

import inspect

import pytest

from slam_sensor_fusion_tpu_torch.ops import (
    cuda_lib,
    icp_fused,
    lio_superblock_fused,
    nn_pallas,
    p2p_fused,
    superblock_fused,
)

#: each kernel's wrapper: the name its errors carry, and the function that
#: validates its tensors (K1's public wrapper hands them to `_superblock_fine`)
WRAPPERS = {
    "K1": ("superblock_fine", superblock_fused._superblock_fine),
    "K2": ("pair_nn", nn_pallas.pair_nn),
    "K3": ("_fused_core", icp_fused._fused_core),
    "K4": ("_p2p_core", p2p_fused._p2p_core),
    "K5": ("_p2p_associate", p2p_fused._p2p_associate),
    "K6": ("_p2p_gn_corr", p2p_fused._p2p_gn_corr),
    "K7": ("lio_superblock", lio_superblock_fused.lio_superblock),
}


def _body(fn) -> str:
    """A module-level function's source, up to the next top-level
    definition."""
    src = inspect.getsource(inspect.getmodule(fn))
    start = src.index(f"\ndef {fn.__name__}(")
    ends = [i for i in (src.find("\ndef ", start + 1), src.find("\nclass ", start + 1)) if i > 0]
    return src[start:min(ends, default=len(src))]


def _checks_the_rule(fn) -> bool:
    src = _body(fn)
    if "cuda_lib.check_tile_src(" in src:
        return True
    # K4-K6 validate through p2p_fused._check
    return "_check(" in src and "cuda_lib.check_tile_src(" in _body(p2p_fused._check)


@pytest.mark.parametrize("width", ["32..4096", 4128, 4097, 16])
@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_tile_rule(kernel, width):
    assert cuda_lib.MAX_TILE_SRC == 4096
    name, fn = WRAPPERS[kernel]
    assert _checks_the_rule(fn)
    if width == "32..4096":
        for TM in range(32, cuda_lib.MAX_TILE_SRC + 1, 32):
            cuda_lib.check_tile_src(name, TM)
    else:
        with pytest.raises(ValueError, match=rf"{name}: tile_src {width} .*4096"):
            cuda_lib.check_tile_src(name, width)

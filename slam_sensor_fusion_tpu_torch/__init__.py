"""slam_sensor_fusion_tpu_torch — the localization engine on PyTorch and CUDA.

A port of `slam_sensor_fusion_tpu` (the JAX package beside it, which stays
the reference) to PyTorch on an NVIDIA H100. Plain tensor code is PyTorch;
the JAX package's Pallas kernels on the ported path are hand-written CUDA
C++ for `sm_90a` under `csrc/`, built with `nvcc` at first use
(ops/cuda_lib.py). Each kernel has a plain PyTorch version beside it that runs
for CPU tensors and that the tests and `chip_smoke.py` compare against.

Layout mirrors the JAX package, with the same module and function names:
  api.py    build_map / localize / localize_streams, the product's entry
            points; __main__.py the CLI (localize, build-map, selftest);
            examples_selftest.py the synthetic end-to-end selftest
  ops/      geometry, cloud ops, Morton tiles, pair lists, K2 (nn_pallas),
            K1 (superblock_fused), K3 (icp_fused), K4-K6 (p2p_fused), K7
            (lio_superblock_fused), stochastic filter, brute force, ICP,
            point-to-plane GN, deskew, the device voxel stores and their
            segment sum (voxel_segsum)
  models/   host map build and StreamingMapper, localization (startup,
            per-frame engine, Localizer.run and its debug branch), the
            superblock pipeline, the EKF and LIO loops, online sessions
  parallel/ the multi-device layer on torch.distributed: the mesh, the
            localization and LIO fleets, the sharded brute force, the
            map-sharded ICP and registration, the sharded voxel store
  utils/    config tree, synthetic world, KITTI loader, autosize, map_data
            I/O, profiling, viz, roofline, state conversion from the JAX
            package's arrays
  csrc/     the CUDA sources of the kernels

The package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"

import torch as _torch

# Numerics policy (ARCHITECTURE §7): poses compose hundreds of small rigid
# transforms, so every float32 matmul and convolution runs in full float32.
# TF32 keeps ~3 decimal digits and would drift the trajectory by metres.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from slam_sensor_fusion_tpu_torch.utils.config import (  # noqa: E402, F401
    ICPConfig,
    BruteForceConfig,
    StochasticFilterConfig,
    LocalizationConfig,
    MappingConfig,
)

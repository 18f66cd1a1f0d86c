"""lidar_slam_tpu_torch — the PyTorch / CUDA port of ``lidar_slam_tpu``.

The JAX package (``lidar_slam_tpu``) stays the reference. This package
mirrors its layout (``geom``, ``io``, ``ops``, ``models.registration``,
``pipeline``) with plain functions on torch tensors, and replaces each
Pallas TPU kernel on the ported path with a kernel written by hand for
NVIDIA Hopper (``csrc/``, built with nvcc at first use and bound through
ctypes; see ``ops/cuda``). It imports neither ``jax`` nor
``lidar_slam_tpu``.

Ported so far: NDT scan-to-map tracking (``pipeline.front_end``: voxel
downsample -> coarse-to-fine NDT alignment -> keyframe static weighting ->
incremental voxel-Gaussian map maintenance) and its one kernel, the fused
NDT score/gradient/Hessian reduction.
"""

import torch

# Registration math is precision-bound, not FLOP-bound, and the moment sums
# of the map are catastrophically sensitive to reduced-precision products.
# Pin full float32 for matmuls and convolutions (TF32 keeps ~3 decimal
# digits); this mirrors the f32 pin of the JAX package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def device(name=None) -> torch.device:
    """The torch device to run on.

    `name=None` picks the first CUDA device when one is present, else the
    CPU. An explicit CUDA name never falls back: it raises when CUDA is not
    available.
    """
    if name is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    return dev

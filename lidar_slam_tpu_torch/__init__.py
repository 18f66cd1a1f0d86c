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
incremental voxel-Gaussian map maintenance), where each clamped-Newton
alignment is one launch of the ``ndt_newton`` kernel and the fused NDT
score/gradient/Hessian reduction (K1) serves single evaluations and the
line-search host loop, with the stat gather by key of ``gather="onehot"``
(K3); and the A-LOAM front end (``pipeline.aloam``: feature extraction ->
frame-to-frame odometry -> scan-to-map mapping -> map fold) with exact
gated k-NN over a bucket grid (K2); the mapping back half, map matching,
the command-line entry point (`python3 -m lidar_slam_tpu_torch mapping
| matching | inspect`, `cli.py`) from KITTI files on disk, and the
multi-rank layer (``parallel``: point-, keyframe-, edge- and node-sharded
paths over torch.distributed ranks, `mapping --mesh-devices N`).

Entry points run on the card: ``device(None)`` is CUDA and raises without
it; the CPU is used only when a caller passes ``device="cpu"``.
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

    `name=None` means the first CUDA device. Nothing falls back to the CPU:
    without CUDA, `None` and every CUDA name raise, and the CPU is used only
    when the caller asks for it (`device="cpu"`, as the CPU tests do).
    """
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    return dev

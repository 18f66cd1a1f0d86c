"""The yardstick's copy of the program bench's NDT work count: the same
bytes and FLOPs as the bench's `ndt_work` on the bench's own operating
point (bench.py's scan-match frame 0 against its 20-keyframe map on the
256 x 256 x 64 grid), and so the bound PERF.md's kernel table gives for
one evaluation there: 0.00018 ms at direct7, 0.00017 at radius27."""

import numpy as np
import pytest
import torch

from slam_bench import roofline


@pytest.fixture(scope="module")
def workload():
    from lidar_slam_tpu_torch import bench

    return bench.build_workload("cpu")


@pytest.mark.parametrize("stencil,bound_ms", [("direct7", 0.00018), ("radius27", 0.00017)])
def test_ndt_work_is_the_bench_count(workload, stencil, bound_ms):
    from lidar_slam_tpu_torch import bench
    from lidar_slam_tpu_torch.ops.cuda import ndt_newton

    cfg = bench.ndt_config(stencil=stencil)
    ndt_map, frame, pts, msk, w, pose6 = bench._frame0(cfg, workload)
    out = torch.zeros(ndt_newton.NOUT)
    out[:3] = torch.as_tensor(pose6[:3])
    out[ndt_newton.ROTATION] = torch.eye(3).reshape(-1)  # pose6's angles are 0
    call = dict(points=frame.points, mask=frame.mask, weights=frame.get_weights(), index=ndt_map.index,
                packed=ndt_map.packed, origin=ndt_map.origin, out=out, dims=ndt_map.dims,
                resolution=ndt_map.resolution, stencil=stencil, d2=cfg.gauss_params()[1])
    assert roofline.ndt_work(call) == bench.ndt_work(frame, ndt_map, [pose6], cfg)
    least_s, _ = roofline.bound(*roofline.ndt_work(call))
    assert abs(least_s * 1e3 - bound_ms) < 0.000005

    # a launch that reports 9 iterations needs 10 evaluations' FLOPs and the bytes once
    out[ndt_newton.ITERATIONS] = 9
    b9, f9 = roofline.ndt_work(call)
    b0, f0 = bench.ndt_work(frame, ndt_map, [pose6], cfg)
    assert b9 == b0 and f9 == 10 * f0
    assert np.isclose(roofline.PEAK_FP32, 67e12) and np.isclose(roofline.PEAK_BYTES, 3.35e12)

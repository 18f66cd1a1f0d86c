"""Point-NN fitness score in PyTorch (port of
lidar_slam_tpu/models/registration/fitness.py): the PCL getFitnessScore the
reference's loop closing gates on, the mean squared distance from each
posed source point to its nearest target point.

Exact brute force over every target point, as the JAX package computes it:
the squared distance factors as |q|^2 - 2 q.t + |t|^2, the cross term one
[Nq, 3] @ [3, chunk] matmul per target chunk (TF32 stays off: the package
pins full float32 matmuls), with a running minimum. The form loses float32
precision far from the origin; the port keeps it, as the reference does.
Squared distances clamp at max_radius^2, and masked-out targets never win.
"""

from __future__ import annotations

import torch

from ...ops.pointcloud import PointCloud


def point_nn_fitness_score(target: PointCloud, source: PointCloud, pose, max_radius: float = 2.0,
                           chunk: int = 2048) -> torch.Tensor:
    """Mean squared NN distance from the source points posed by `pose`
    [4, 4] (host or on the clouds' device) to the target points. Returns a
    0-dim float32 tensor on the clouds' device (no host read)."""
    dev = source.points.device
    T = torch.as_tensor(pose, dtype=torch.float32).to(dev, non_blocking=True)
    xp = source.points @ T[:3, :3].T + T[:3, 3]
    xp = torch.where(source.mask[:, None], xp, 0.0)
    qq = torch.sum(xp * xp, dim=-1)

    tp = torch.where(target.mask[:, None], target.points, 0.0)
    tt = torch.where(target.mask, torch.sum(tp * tp, dim=-1), torch.inf)
    m = source.mask.to(torch.float32)
    if dev.type == "cpu":
        # masked-out rows add nothing: on the CPU, where finding them reads
        # no device, they are dropped before the distance matrix
        xp, qq, m = xp[source.mask], qq[source.mask], m[source.mask]
        tp, tt = tp[target.mask], tt[target.mask]
    d2 = torch.full_like(qq, torch.inf)
    for s in range(0, tp.shape[0], chunk):
        # (|q|^2 - 2 q.t) + |t|^2 with the cross term's scale and first add
        # in the matmul's epilogue: [Nq, chunk], two passes over it
        d2c = torch.addmm(qq[:, None], xp, tp[s : s + chunk].T, alpha=-2.0)
        d2c += tt[None, s : s + chunk]
        d2 = torch.minimum(d2, torch.amin(d2c, dim=1))
    # guard against tiny negative residue at d ~ 0, then clamp
    d2 = torch.clamp(torch.clamp(d2, min=0.0), max=max_radius * max_radius)
    return torch.sum(d2 * m) / torch.clamp(torch.sum(m), min=1.0)

"""SO(3)/SE(3) utilities on torch tensors (port of lidar_slam_tpu/geom/se3.py).

Poses are 4x4 homogeneous float32 matrices. Functions are batched over
leading dims where noted and safe at the identity (Taylor guards).
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def so3_hat(w):
    """Skew-symmetric matrix of w: hat(w) @ v == cross(w, v). Batched."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(K):
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(w):
    """Rodrigues formula: axis-angle vector [..., 3] -> rotation [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    use_taylor = theta2 < _EPS
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        use_taylor,
        0.5 - theta2 / 24.0,
        (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS * _EPS),
    )
    K = so3_hat(w)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R):
    """Rotation [..., 3, 3] -> axis-angle vector [..., 3] (theta < pi - eps)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    ) * 0.5
    small = theta < 1e-4
    scale = torch.where(
        small,
        1.0 + theta * theta / 6.0,
        theta / torch.where(small, torch.ones_like(theta), torch.sin(theta)),
    )
    return v * scale[..., None]


def se3_exp(xi):
    """Twist [..., 6] (rho, phi) -> 4x4 transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    use_taylor = theta2 < _EPS
    b = torch.where(
        use_taylor,
        0.5 - theta2 / 24.0,
        (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS * _EPS),
    )
    c = torch.where(
        use_taylor,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS * _EPS * _EPS),
    )
    K = so3_hat(phi)
    V = _eye_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return make_pose(R, t)


def se3_log(T):
    """4x4 transform -> twist [..., 6] (rho, phi)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    use_taylor = theta2 < _EPS
    K = so3_hat(phi)
    cot_term = torch.where(
        use_taylor,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / torch.clamp(theta2, min=_EPS * _EPS))
        - (1.0 + torch.cos(theta)) / torch.clamp(2.0 * theta * torch.sin(theta), min=_EPS),
    )
    Vinv = _eye_like(K) - 0.5 * K + cot_term[..., None, None] * (K @ K)
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, phi], dim=-1)


def euler_xyz_to_matrix(rx, ry, rz):
    """R = Rx(rx) @ Ry(ry) @ Rz(rz) — the Eigen eulerAngles(0,1,2) convention
    the NDT pose parameterization uses."""
    ca, sa = torch.cos(rx), torch.sin(rx)
    cb, sb = torch.cos(ry), torch.sin(ry)
    cc, sc = torch.cos(rz), torch.sin(rz)
    row0 = torch.stack([cb * cc, -cb * sc, sb], dim=-1)
    row1 = torch.stack([ca * sc + sa * sb * cc, ca * cc - sa * sb * sc, -sa * cb], dim=-1)
    row2 = torch.stack([sa * sc - ca * sb * cc, sa * cc + ca * sb * sc, ca * cb], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_euler_xyz(R):
    """Inverse of euler_xyz_to_matrix -> (rx, ry, rz), for a torch tensor
    or a numpy array (whose result stays numpy, of its dtype)."""
    if isinstance(R, torch.Tensor):
        asin, clip, atan2 = torch.arcsin, torch.clamp, torch.atan2
    else:
        asin, clip, atan2 = np.arcsin, np.clip, np.arctan2
    ry = asin(clip(R[..., 0, 2], -1.0, 1.0))
    rx = atan2(-R[..., 1, 2], R[..., 2, 2])
    rz = atan2(-R[..., 0, 1], R[..., 0, 0])
    return rx, ry, rz


def make_pose(R, t):
    """Assemble [..., 4, 4] from [..., 3, 3] and [..., 3]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.eye(4, dtype=R.dtype, device=R.device).expand(batch + (4, 4)).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def pose_inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_pose(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T, points):
    """Apply a [4, 4] (or batched) transform to [..., N, 3] points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]

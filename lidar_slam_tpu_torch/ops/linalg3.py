"""Closed-form batched 3x3 linear solves (port of lidar_slam_tpu/ops/linalg3.py).

The plane fits of A-LOAM mapping (A n = -1, laserMapping.cpp:643-688) solve
one tiny system per query point; the adjugate (Cramer) form is a handful of
elementwise ops and never synchronises with the host, where a batched LU
would check its pivots.
"""

from __future__ import annotations

import torch


def solve3(A, b, eps: float = 1e-12):
    """Solve A x = b for batched 3x3 A ([..., 3, 3]) and b ([..., 3]) via the
    adjugate. Singular systems (|det| <= eps) return 0 — callers gate on
    their own validity checks."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]

    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02

    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10

    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = c00 * b0 + c10 * b1 + c20 * b2
    x1 = c01 * b0 + c11 * b1 + c21 * b2
    x2 = c02 * b0 + c12 * b1 + c22 * b2
    x = torch.stack([x0, x1, x2], dim=-1)
    safe = torch.abs(det) > eps
    return torch.where(safe[..., None], x / torch.where(safe, det, 1.0)[..., None], 0.0)

"""Closed-form symmetric 3x3 eigendecomposition, batched (port of
lidar_slam_tpu/ops/eigh3.py): trigonometric (Cardano) eigenvalues, then
cross-product eigenvectors with pivoting."""

from __future__ import annotations

import torch

_EPS = 1e-12


def _eigenvalues(A):
    """Eigenvalues of symmetric [..., 3, 3], ascending [..., 3]."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))

    inv_p = 1.0 / p
    c00, c11, c22 = b00 * inv_p, b11 * inv_p, b22 * inv_p
    c01, c02, c12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    half_det = 0.5 * (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    half_det = torch.clamp(half_det, -1.0, 1.0)

    angle = torch.arccos(half_det) / 3.0
    two_thirds_pi = 2.0943951023931953
    beta2 = torch.cos(angle) * 2.0
    beta0 = torch.cos(angle + two_thirds_pi) * 2.0
    beta1 = -(beta0 + beta2)

    isotropic = p2 < 6.0 * _EPS
    ev0 = torch.where(isotropic, q, q + p * beta0)
    ev1 = torch.where(isotropic, q, q + p * beta1)
    ev2 = torch.where(isotropic, q, q + p * beta2)
    return torch.stack([ev0, ev1, ev2], dim=-1)


def _eigenvector(A, lam):
    """Eigenvector for eigenvalue lam: the cross product of the two most
    independent rows of (A - lam I)."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.argmax(torch.stack([n01, n02, n12], dim=-1), dim=-1)
    cands = torch.stack([c01, c02, c12], dim=-2)
    idx = best[..., None, None].expand(best.shape + (1, 3))
    v = torch.gather(cands, -2, idx)[..., 0, :]
    norm = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=_EPS))
    return v / norm


def sym_eigh3(A):
    """Eigendecomposition of a batch of symmetric 3x3 matrices.

    Returns (evals [..., 3] ascending, evecs [..., 3, 3] with evecs[..., :, k]
    the k-th eigenvector); identity basis when fully degenerate.
    """
    evals = _eigenvalues(A)
    v0 = _eigenvector(A, evals[..., 0])
    v2 = _eigenvector(A, evals[..., 2])
    v1 = torch.linalg.cross(v2, v0)
    n1 = torch.sqrt(torch.clamp(torch.sum(v1 * v1, dim=-1, keepdim=True), min=_EPS))
    v1 = v1 / n1

    a_norm = torch.sqrt(torch.sum(A * A, dim=(-2, -1)))
    spread = evals[..., 2] - evals[..., 0]
    degen = spread <= 1e-9 * torch.clamp(a_norm, min=1.0)
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    evecs = torch.stack([v0, v1, v2], dim=-1)
    evecs = torch.where(degen[..., None, None], eye, evecs)
    return evals, evecs

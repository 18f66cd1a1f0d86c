"""Scan Context place-recognition descriptor and retrieval in PyTorch (port
of lidar_slam_tpu/models/scan_context.py).

A 20-ring x 60-sector polar max-height descriptor (makeScancontext), a
ring-key candidate retrieval over the whole history in one batched op, and
the column-shift (yaw) aligned distance over all 60 shifts at once. The
binning is one `scatter_reduce(..., "amax")` from -inf: a max does not
depend on the order it is taken in, so the descriptor is exact.

Ties are broken as XLA breaks them: the ring-key candidates by a stable
sort (lowest index first among equal distances, as `lax.top_k`), the best
shift and candidate by `argmin` (the first minimum).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import device as _default_device


@dataclasses.dataclass(frozen=True)
class ScanContextConfig:
    """Constants from scan_context.h:85-102; the JAX package's fields."""

    num_rings: int = 20
    num_sectors: int = 60
    max_radius: float = 80.0
    lidar_height: float = 2.0
    num_exclude_recent: int = 50
    num_candidates: int = 10
    dist_threshold: float = 0.5  # SC_DIST_THRES


def make_scancontext(points, mask, cfg: ScanContextConfig = ScanContextConfig()):
    """The [rings, sectors] max-z descriptor of points [N, 3] / mask [N] on
    their device. Empty bins are 0."""
    r = torch.linalg.norm(points[:, :2], dim=-1)
    theta = torch.atan2(points[:, 1], points[:, 0])  # [-pi, pi]
    theta = torch.where(theta < 0, theta + 2 * math.pi, theta)
    z = points[:, 2] + cfg.lidar_height

    ok = mask & (r < cfg.max_radius) & (r > 1e-3)
    ring = torch.clamp((r / cfg.max_radius * cfg.num_rings).to(torch.int32), 0, cfg.num_rings - 1)
    sector = torch.clamp((theta / (2 * math.pi) * cfg.num_sectors).to(torch.int32), 0, cfg.num_sectors - 1)
    n_bins = cfg.num_rings * cfg.num_sectors
    bins = torch.where(ok, ring * cfg.num_sectors + sector, n_bins).long()  # overflow bin

    z = torch.where(ok, z, -math.inf)
    desc = torch.full((n_bins + 1,), -math.inf, dtype=z.dtype, device=z.device)
    desc = desc.scatter_reduce(0, bins, z, "amax")[:-1]
    desc = torch.where(torch.isfinite(desc), desc, 0.0)
    return desc.reshape(cfg.num_rings, cfg.num_sectors)


def ring_key(desc):
    """Row means (makeRingkeyFromScancontext)."""
    return torch.mean(desc, dim=-1)


def sector_key(desc):
    """Column means (makeSectorkeyFromScancontext)."""
    return torch.mean(desc, dim=-2)


def sc_distance(desc_a, desc_b):
    """Min over all column shifts of the mean column-wise cosine distance
    (distanceBtnScanContext), for all shifts at once. `desc_b` may carry
    leading batch dims. Returns (distance, best shift)."""
    ns = desc_a.shape[-1]
    ar = torch.arange(ns, device=desc_a.device)
    idx = (ar[None, :] + ar[:, None]) % ns  # [shift, col]
    shifted = desc_b[..., idx].movedim(-3, -2)  # [..., shift, nr, col]: b[:, (col + shift) % ns]
    num = torch.sum(desc_a * shifted, dim=-2)  # [..., shift, col]
    na = torch.linalg.norm(desc_a, dim=0)  # [col]
    nb = torch.linalg.norm(shifted, dim=-2)  # [..., shift, col]
    valid = (na > 1e-9) & (nb > 1e-9)
    cos = torch.where(valid, num / torch.clamp(na * nb, min=1e-9), 0.0)
    n_valid = torch.clamp(torch.sum(valid, dim=-1), min=1)
    dist = 1.0 - torch.sum(cos, dim=-1) / n_valid  # [..., shift]
    best = torch.argmin(dist, dim=-1)
    return torch.gather(dist, -1, best[..., None])[..., 0], best


def detect_loop(query_desc, query_rk, history_desc, history_rk, history_valid,
                cfg: ScanContextConfig = ScanContextConfig()):
    """Top-`num_candidates` ring-key neighbours, the full SC distance on
    each, the best accepted under the threshold (detectLoopClosureID).
    Returns device tensors (loop index int32, -1 if none; distance; yaw
    shift in sectors, int32)."""
    d_rk = torch.linalg.norm(history_rk - query_rk[None, :], dim=-1)
    d_rk = torch.where(history_valid, d_rk, math.inf)
    cand = torch.sort(d_rk, stable=True).indices[: cfg.num_candidates]
    dists, shifts = sc_distance(query_desc, history_desc[cand])
    dists = torch.where(torch.isfinite(d_rk[cand]), dists, math.inf)
    best = torch.argmin(dists).reshape(1)
    ok = dists[best] < cfg.dist_threshold
    return (torch.where(ok, cand[best], -1).to(torch.int32)[0], dists[best][0],
            shifts[best].to(torch.int32)[0])


class SCManager:
    """Descriptor store (makeAndSaveScancontextAndKeys + detectLoopClosureID
    API). The history lives on `device` (the card unless the caller passes
    device="cpu") and each `add` writes its row in place; capacity grows by
    doubling. `descs` is a host mirror refreshed lazily, for PNG export and
    persistence; `detect` reads its three result scalars in one copy."""

    def __init__(self, cfg: ScanContextConfig = ScanContextConfig(), capacity: int = 4096, device=None):
        self.cfg = cfg
        self.capacity = capacity
        self.device = _default_device(device)
        self._descs_dev = torch.zeros((capacity, cfg.num_rings, cfg.num_sectors), device=self.device)
        self._rk_dev = torch.zeros((capacity, cfg.num_rings), device=self.device)
        self._descs_host = np.zeros((capacity, cfg.num_rings, cfg.num_sectors), np.float32)
        self._host_count = 0  # rows of the host mirror that are current
        self.count = 0

    @property
    def descs(self) -> np.ndarray:
        if self._host_count < self.count:
            self._descs_host[self._host_count : self.count] = (
                self._descs_dev[self._host_count : self.count].cpu().numpy()
            )
            self._host_count = self.count
        return self._descs_host

    @property
    def ring_keys(self) -> np.ndarray:
        return self._rk_dev[: self.count].cpu().numpy()

    def _grow(self) -> None:
        self.descs  # flush the host mirror before growing
        self._descs_dev = torch.cat([self._descs_dev, torch.zeros_like(self._descs_dev)])
        self._rk_dev = torch.cat([self._rk_dev, torch.zeros_like(self._rk_dev)])
        self._descs_host = np.concatenate([self._descs_host, np.zeros_like(self._descs_host)])
        self.capacity *= 2

    def add(self, points, mask):
        """Append the descriptor of one cloud (host arrays or tensors).
        Returns it as a tensor on the manager's device (no host read)."""
        if self.count >= self.capacity:
            self._grow()
        pts = torch.as_tensor(points, dtype=torch.float32).to(self.device, non_blocking=True)
        msk = torch.as_tensor(mask, dtype=torch.bool).to(self.device, non_blocking=True)
        desc = make_scancontext(pts, msk, self.cfg)
        self._descs_dev[self.count] = desc
        self._rk_dev[self.count] = ring_key(desc)
        self.count += 1
        return desc

    def load_history(self, descs) -> None:
        """Replace the history by the descriptors `descs` [K, rings, sectors]."""
        while self.capacity < descs.shape[0]:
            self._grow()
        k = descs.shape[0]
        descs = torch.as_tensor(descs, dtype=torch.float32).to(self.device)
        self._descs_dev[:k] = descs
        self._rk_dev[:k] = ring_key(descs)
        self.count = k
        self._host_count = 0

    def save_descriptor_png(self, index: int, path: str) -> None:
        """Write descriptor `index` as a grayscale PNG (the per-keyframe image
        dump of loop_closing.cpp:136-137)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        d = self.descs[index]
        hi = max(float(d.max()), 1e-6)
        plt.imsave(path, d / hi, cmap="gray", vmin=0.0, vmax=1.0)

    def detect(self):
        """Loop candidate for the most recent descriptor, searched among the
        first count - num_exclude_recent. Returns (index or -1, distance,
        yaw_rad) as host numbers."""
        if self.count < 2:
            return -1, float("inf"), 0.0
        q = self.count - 1
        hi = max(0, self.count - self.cfg.num_exclude_recent)
        if hi == 0:
            return -1, float("inf"), 0.0
        valid = torch.arange(self.capacity, device=self.device) < hi
        idx, dist, shift = detect_loop(self._descs_dev[q], self._rk_dev[q], self._descs_dev, self._rk_dev,
                                       valid, self.cfg)
        idx, dist, shift = torch.stack([idx.double(), dist.double(), shift.double()]).cpu().tolist()
        return int(idx), float(dist), shift * 2.0 * np.pi / self.cfg.num_sectors

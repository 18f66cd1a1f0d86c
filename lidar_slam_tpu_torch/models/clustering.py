"""Scan-Line-Run (SLR) clustering in PyTorch (port of
lidar_slam_tpu/models/clustering.py).

Re-design of slr_clustering_node (src/apps/slr_clustering_node.cpp:83-660):
non-ground points are clustered by "runs" of consecutive close points
within a scan line (th_run) merged across adjacent scan lines (th_merge).
As in the JAX package, the reference's sequential two-pass label/merge is
connected components over an explicit neighbour graph (ring predecessor,
ring successor, nearest point of the ring above within th_merge), solved
by a fixed number of minimum-label sweeps of gathers: no host read.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SLRConfig:
    n_scans: int = 64
    th_run: float = 0.5  # same-line run distance gate
    th_merge: float = 1.0  # cross-line merge gate
    propagate_iters: int = 64  # label sweeps (>= graph diameter in rings)
    azimuth_window: int = 8  # cross-ring search half-window (bins)


def slr_cluster(points, mask, ring, n_azimuth: int, cfg: SLRConfig = SLRConfig()):
    """Cluster an ORGANIZED sweep (ring-major, n_azimuth points per ring).

    points [n_scans * n_azimuth, 3] in ring-major azimuth order, mask [N]
    validity, ring [N] ring ids. Returns labels [N] int32: a cluster's id
    (its smallest member index), -1 for invalid points."""
    n = points.shape[0]
    dev = points.device
    idx = torch.arange(n, device=dev)
    ring = ring.long()

    # same-ring run links (find_runs_): consecutive azimuth neighbours
    nxt = torch.roll(idx, -1)
    same_ring_n = (ring[nxt] == ring) & mask & mask[nxt]
    link_next = same_ring_n & (torch.linalg.norm(points[nxt] - points, dim=-1) < cfg.th_run)
    prv = torch.roll(idx, 1)
    link_prev = torch.roll(link_next, 1)

    # cross-ring merge links (update_labels_): nearest in-window point of
    # the ring above
    offsets = torch.arange(-cfg.azimuth_window, cfg.azimuth_window + 1, device=dev)
    cand = (idx - n_azimuth)[:, None] + offsets[None, :]
    cand_ok = (cand >= 0) & (cand < n)
    cand = torch.clamp(cand, 0, n - 1)
    cand_ok = cand_ok & mask[cand] & (ring[cand] == ring[:, None] - 1) & mask[:, None]
    d_up = torch.linalg.norm(points[cand] - points[:, None, :], dim=-1)
    d_up = torch.where(cand_ok, d_up, torch.inf)
    d_min, j_up = torch.min(d_up, dim=-1)  # the first of equal minima, as argmin
    best_up = torch.gather(cand, 1, j_up[:, None])[:, 0]
    link_up = torch.isfinite(d_min) & (d_min < cfg.th_merge)
    down_seg = torch.where(link_up, best_up, n)  # down-links: the transpose of the up-links

    # min-label propagation over the graph, with pointer jumping
    labels = torch.where(mask, idx, n)
    for _ in range(cfg.propagate_iters):
        l_next = torch.where(link_next, labels[nxt], n)
        l_prev = torch.where(link_prev, labels[prv], n)
        l_up = torch.where(link_up, labels[best_up], n)
        l_down = torch.full((n + 1,), n, dtype=labels.dtype, device=dev).scatter_reduce(
            0, down_seg, torch.where(link_up, labels, n), "amin")[:-1]
        new = torch.minimum(torch.minimum(labels, l_next), torch.minimum(l_prev, torch.minimum(l_up, l_down)))
        labels = torch.minimum(new, new[torch.clamp(new, 0, n - 1)])
    return torch.where(mask, labels, -1).to(torch.int32)


def cluster_sizes(labels, num_segments: int):
    """Histogram of cluster sizes [num_segments] int32 (for filtering small
    clusters); labels at or past num_segments are dropped, as in the JAX
    package's segment_sum."""
    keep = (labels >= 0) & (labels < num_segments)
    out = torch.zeros(num_segments, dtype=torch.int32, device=labels.device)
    return out.scatter_add(0, torch.where(keep, labels, 0).long(), keep.to(torch.int32))

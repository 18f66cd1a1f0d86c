"""A-LOAM scan registration: edge/planar feature extraction, in PyTorch (port
of lidar_slam_tpu/pipeline/aloam/feature_extraction.py; see there for the
mapping to scanRegistration.cpp).

Fixed shapes throughout: one stable sort of the points by ring, curvature
over +-5 ring neighbours, one sort by (sector, curvature) that compacts each
sector's best corner and flat candidates into a small dense table, then the
greedy pick-and-suppress rounds on that table for all sectors at once. Every
scatter writes duplicates only into a dropped overflow slot, so the result
does not depend on the order a scatter applies its writes. Nothing here
synchronises with the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ...ops.pointcloud import PointCloud, voxel_downsample


@dataclasses.dataclass(frozen=True)
class FeatureExtractionConfig:
    """The same fields and defaults as the JAX package's config."""

    n_scans: int = 64
    min_range: float = 5.0  # MINIMUM_RANGE (KITTI launch: 5)
    scan_period: float = 0.1
    curvature_threshold: float = 0.1
    sharp_per_sector: int = 2
    less_sharp_per_sector: int = 20
    flat_per_sector: int = 4
    n_sectors: int = 6
    less_flat_leaf: float = 0.2  # downSizeFilter leaf (scanRegistration.cpp:389)
    suppress_gap_sq: float = 0.05
    capacity: int = 131072  # padded input size
    max_sharp: int = 1024
    max_less_sharp: int = 8192
    max_flat: int = 2048
    max_less_flat: int = 32768


@dataclasses.dataclass
class ScanFeatures:
    """The five output clouds of scanRegistration (+ring/time channels)."""

    sharp: PointCloud
    less_sharp: PointCloud
    flat: PointCloud
    less_flat: PointCloud
    full: PointCloud  # ring-ordered full cloud
    sharp_ring: torch.Tensor
    less_sharp_ring: torch.Tensor
    flat_ring: torch.Tensor
    less_flat_ring: torch.Tensor
    sharp_time: torch.Tensor
    less_sharp_time: torch.Tensor
    flat_time: torch.Tensor
    less_flat_time: torch.Tensor
    capped: torch.Tensor = None  # [] int32: selected rows the four caps (max_sharp ... max_less_flat) cut off


_i32 = torch.int32


def _ring_id(points, n_scans: int):
    """Elevation-angle ring formulas (scanRegistration.cpp:169-205).
    Returns (ring int32, valid bool)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    angle = torch.rad2deg(torch.atan2(z, torch.sqrt(x * x + y * y)))
    if n_scans == 16:
        ring = torch.round((angle + 15.0) / 2.0).to(_i32)
        ok = (ring >= 0) & (ring < 16)
    elif n_scans == 32:
        ring = torch.round((angle + 92.0 / 3.0) * 3.0 / 4.0).to(_i32)
        ok = (ring >= 0) & (ring < 32)
    elif n_scans == 64:
        upper = angle >= -8.83
        ring = torch.where(
            upper,
            torch.floor((2.0 - angle) * 3.0 + 0.5).to(_i32),
            32 + torch.floor((-8.83 - angle) * 2.0 + 0.5).to(_i32),
        )
        # reference keeps angle in [-24.33, 2] and rings < 50 (scanRegistration.cpp:193-202)
        ok = (angle <= 2.0) & (angle >= -24.33) & (ring >= 0) & (ring < 50)
    else:
        raise ValueError(f"unsupported n_scans {n_scans}")
    return ring, ok


def _relative_time(points, mask, scan_period: float):
    """Azimuth-fraction relative time (scanRegistration.cpp:206-246):
    orientation unwrapped against the first valid point's."""
    ori = -torch.atan2(points[:, 1], points[:, 0])
    # first / last valid point (argmax returns the first maximum); 1-element
    # index tensors keep the lookup on the device
    m = mask.to(_i32)
    first = torch.argmax(m).reshape(1)
    last = points.shape[0] - 1 - torch.argmax(torch.flip(m, (0,))).reshape(1)
    start_ori = ori[first]
    end_ori = ori[last] + 2 * math.pi
    span = end_ori - start_ori
    span = torch.where(span > 3 * math.pi, span - 2 * math.pi, span)
    span = torch.where(span < math.pi, span + 2 * math.pi, span)
    o = ori - start_ori
    o = torch.where(o < 0, o + 2 * math.pi, o)
    rel = torch.clamp(o / torch.clamp(span, min=1e-6), 0.0, 1.0)
    return rel * scan_period


def _segment_count(ids, ones, n: int):
    """Integer per-segment sums of `ones` over `ids` in [0, n) (exact)."""
    return torch.zeros(n, dtype=_i32, device=ids.device).scatter_add_(0, ids.long(), ones)


def _exclusive_cumsum(counts):
    return torch.cumsum(counts, dim=0, dtype=_i32) - counts


def _scatter_rows(size: int, dest, values, fill=0):
    """A [size, ...] tensor with values written at `dest`; `dest == size`
    is the dropped overflow slot, the only one written more than once."""
    out = torch.full((size + 1, *values.shape[1:]), fill, dtype=values.dtype, device=values.device)
    out[dest.long()] = values
    return out[:size]


def _compact_topk(points, ring, time, sel_mask, cap: int):
    """Gather selected points into a fixed-size cloud (mask-compact, stable
    order) via cumsum + scatter."""
    idx = torch.cumsum(sel_mask.to(_i32), dim=0, dtype=_i32) - 1
    dest = torch.where(sel_mask & (idx < cap), idx, cap)  # overflow slot dropped
    pts = _scatter_rows(cap, dest, points)
    rng = _scatter_rows(cap, dest, ring)
    tim = _scatter_rows(cap, dest, time)
    total = torch.clamp(torch.sum(sel_mask.to(_i32)), max=cap)
    ok = torch.arange(cap, device=points.device) < total
    return (
        PointCloud(points=torch.where(ok[:, None], pts, 0.0), mask=ok),
        torch.where(ok, rng, 0),
        torch.where(ok, tim, 0.0),
    )


def extract_features(points, mask, cfg: FeatureExtractionConfig = FeatureExtractionConfig()) -> ScanFeatures:
    n = cfg.capacity
    dev = points.device
    points = points[:n]
    mask = mask[:n]

    r2 = torch.sum(points * points, dim=-1)
    mask = mask & (r2 >= cfg.min_range**2) & torch.all(torch.isfinite(points), dim=-1)

    ring, ring_ok = _ring_id(points, cfg.n_scans)
    mask = mask & ring_ok
    ring = torch.where(mask, ring, cfg.n_scans)  # invalid -> overflow ring
    rel_time = _relative_time(points, mask, cfg.scan_period)

    # ring-major stable order (original azimuth order preserved within ring)
    order = torch.sort(ring, stable=True).indices
    pts = points[order]
    msk = mask[order]
    rng_s = ring[order]
    tim = rel_time[order]

    # curvature over +-5 neighbours in ring order (:256-266); invalid at ring
    # boundaries and near invalid points
    acc = -10.0 * pts
    nb_ok = msk
    for k in list(range(-5, 0)) + list(range(1, 6)):
        acc = acc + torch.roll(pts, -k, 0)
        nb_ok = nb_ok & torch.roll(msk, -k, 0) & (torch.roll(rng_s, -k, 0) == rng_s)
    curv = torch.sum(acc * acc, dim=-1)
    feat_ok = nb_ok  # points whose whole neighbourhood is same-ring & valid

    # per-ring rank -> equal-count sectors (sp/ep arithmetic, :280-292)
    ones = msk.to(_i32)
    cum = torch.cumsum(ones, dim=0, dtype=_i32) - ones
    ring_counts = _segment_count(rng_s, ones, cfg.n_scans + 1)
    ring_start = _exclusive_cumsum(ring_counts)
    rank = cum - ring_start[rng_s.long()]
    cnt = torch.clamp(ring_counts[rng_s.long()], min=1)
    sector = torch.clamp(torch.div(cfg.n_sectors * rank, cnt, rounding_mode="floor"), 0, cfg.n_sectors - 1)
    seg = rng_s * cfg.n_sectors + sector  # [n] sector id
    n_segs = (cfg.n_scans + 1) * cfg.n_sectors

    # suppression reach: a pick at ring position p blocks p+l (l <= reach_f[p])
    # and p-l (l <= reach_b[p]) — consecutive-gap chain unbroken and same ring
    # (the cloudNeighborPicked marking loop, scanRegistration.cpp:319-342)
    nxt = torch.roll(pts, -1, 0)
    gap_ok_fwd = torch.sum((nxt - pts) ** 2, dim=-1) <= cfg.suppress_gap_sq  # gap (i, i+1)
    gap_ok_bwd = torch.roll(gap_ok_fwd, 1, 0)  # gap (i-1, i)
    run_f = torch.ones_like(msk)
    run_b = torch.ones_like(msk)
    reach_f = torch.zeros(n, dtype=_i32, device=dev)
    reach_b = torch.zeros(n, dtype=_i32, device=dev)
    for l in range(1, 6):
        run_f = run_f & torch.roll(gap_ok_fwd, -(l - 1), 0) & (torch.roll(rng_s, -l, 0) == rng_s)
        reach_f = reach_f + run_f
        run_b = run_b & torch.roll(gap_ok_bwd, l - 1, 0) & (torch.roll(rng_s, l, 0) == rng_s)
        reach_b = reach_b + run_b

    # candidate compaction: ONE ascending sort by (sector, curvature). Flat
    # candidates are each sector block's head, corner candidates its tail.
    eligible = msk & feat_ok
    curv_nn = torch.clamp(curv, min=0.0)  # non-negative: the bit pattern is monotone
    curv_bits = curv_nn.view(_i32)
    seg_or = torch.where(eligible, seg, n_segs)
    # lexicographic (seg asc, curv asc) via two stable int32 sorts
    o1 = torch.sort(curv_bits, stable=True).indices
    order = o1[torch.sort(seg_or[o1], stable=True).indices]

    elig_counts = _segment_count(seg_or, eligible.to(_i32), n_segs + 1)
    blk_start = _exclusive_cumsum(elig_counts)
    blk_end = blk_start + elig_counts
    seg_sorted = seg_or[order]
    curv_sorted = curv_nn[order]
    pos_in_sort = torch.arange(n, dtype=_i32, device=dev)
    rank_asc = pos_in_sort - blk_start[seg_sorted.long()]
    rank_desc = blk_end[seg_sorted.long()] - 1 - pos_in_sort

    n_rings = cfg.n_scans + 1
    M_c = 256  # >= 20 picks x (1 pick + 10 suppressed) + cross-sector margin
    M_f = 320  # flats also absorb suppression from the 20 corner picks

    def compact_candidates(cand_ok, rank, m):
        """[n_rings, n_sectors, m] table of ring positions (int32, -1 = empty)."""
        dest = torch.where(cand_ok & (rank < m), seg_sorted * m + rank, n_segs * m)
        tbl = _scatter_rows(n_segs * m, dest, order.to(_i32), fill=-1)
        return tbl.reshape(n_rings, cfg.n_sectors, m)

    in_seg = seg_sorted < n_segs
    corner_cand = compact_candidates(in_seg & (curv_sorted > cfg.curvature_threshold), rank_desc, M_c)
    flat_cand = compact_candidates(in_seg & (curv_sorted < cfg.curvature_threshold), rank_asc, M_f)

    def cand_attr(cand_pos, attr, fill):
        safe = torch.clamp(cand_pos, min=0).long()
        return torch.where(cand_pos >= 0, attr[safe], fill)

    def suppressed(cand_pos, ppos, plf, plb, include_self: bool):
        """[R, S, M]: candidates within a pick's reach (picks [R, P])."""
        d = cand_pos[:, :, :, None] - ppos[:, None, None, :]
        hit = ((d > 0) & (d <= plf[:, None, None, :])) | ((d < 0) & (-d <= plb[:, None, None, :]))
        if include_self:
            hit = hit | (d == 0)
        return torch.any((ppos[:, None, None, :] >= 0) & hit, dim=-1)

    def greedy_rounds(cand_pos, alive, k: int):
        """k rounds: per sector take the first alive candidate (the table is
        already best-first), then block ring neighbours within its reach —
        the vectorized greedy loop (scanRegistration.cpp:293-385)."""
        lf = cand_attr(cand_pos, reach_f, 0)
        lb = cand_attr(cand_pos, reach_b, 0)
        picks, oks = [], []
        for _ in range(k):
            has = torch.any(alive, dim=-1)  # [R, S]
            fi = torch.argmax(alive.to(torch.uint8), dim=-1, keepdim=True)

            def take(a):
                return torch.gather(a, -1, fi)[..., 0]

            ppos = torch.where(has, take(cand_pos), -1)
            # picks of all sectors of the SAME ring can suppress a candidate
            # (reach never crosses rings); d == 0 removes the pick itself
            alive = alive & ~suppressed(cand_pos, ppos, take(lf), take(lb), include_self=True)
            picks.append(ppos)
            oks.append(has)
        return torch.stack(picks), torch.stack(oks)  # [k, R, S]

    cpick_pos, cpick_ok = greedy_rounds(corner_cand, corner_cand >= 0, cfg.less_sharp_per_sector)

    # corner picks suppress flat candidates (shared cloudNeighborPicked state)
    cp = cpick_pos.transpose(0, 1).reshape(n_rings, -1)  # [R, k*S]
    alive_f = (flat_cand >= 0) & ~suppressed(
        flat_cand, cp, cand_attr(cp, reach_f, 0), cand_attr(cp, reach_b, 0), include_self=False
    )
    fpick_pos, fpick_ok = greedy_rounds(flat_cand, alive_f, cfg.flat_per_sector)

    def scatter_sel(pick_pos, pick_ok):
        p = pick_pos.reshape(-1)
        ok = pick_ok.reshape(-1)
        dest = torch.where(ok & (p >= 0), p, n)
        return _scatter_rows(n, dest, torch.ones_like(p, dtype=torch.bool), fill=False)

    sharp_sel = scatter_sel(cpick_pos[: cfg.sharp_per_sector], cpick_ok[: cfg.sharp_per_sector])
    less_sharp_sel = scatter_sel(cpick_pos, cpick_ok)
    flat_sel = scatter_sel(fpick_pos, fpick_ok)
    # everything not picked as corner is less-flat (:371-378), incl. flats
    less_flat_sel = msk & ~less_sharp_sel

    sharp, sharp_ring, sharp_time = _compact_topk(pts, rng_s, tim, sharp_sel, cfg.max_sharp)
    lsharp, lsharp_ring, lsharp_time = _compact_topk(pts, rng_s, tim, less_sharp_sel, cfg.max_less_sharp)
    flat, flat_ring, flat_time = _compact_topk(pts, rng_s, tim, flat_sel, cfg.max_flat)
    lflat_cloud, lflat_ring, _ = _compact_topk(pts, rng_s, tim, less_flat_sel, cfg.max_less_flat)
    capped = sum(torch.clamp(sel.sum(dtype=_i32) - cap, min=0) for sel, cap in (
        (sharp_sel, cfg.max_sharp), (less_sharp_sel, cfg.max_less_sharp), (flat_sel, cfg.max_flat),
        (less_flat_sel, cfg.max_less_flat)))
    # less-flat is voxel-downsampled (:386-394). The ring id rides the weight
    # channel through the centroid reduction — the same approximation as
    # PCL's intensity-averaging of scanID in the reference.
    lflat_cloud.weights = lflat_ring.to(torch.float32)
    lflat = voxel_downsample(lflat_cloud, cfg.less_flat_leaf, out_capacity=cfg.max_less_flat)
    lflat_ring = torch.round(lflat.get_weights()).to(_i32)

    return ScanFeatures(
        sharp=sharp,
        less_sharp=lsharp,
        flat=flat,
        less_flat=PointCloud(points=lflat.points, mask=lflat.mask),
        full=PointCloud(points=pts, mask=msk),
        sharp_ring=sharp_ring,
        less_sharp_ring=lsharp_ring,
        flat_ring=flat_ring,
        less_flat_ring=lflat_ring,
        sharp_time=sharp_time,
        less_sharp_time=lsharp_time,
        flat_time=flat_time,
        less_flat_time=torch.zeros(cfg.max_less_flat, dtype=torch.float32, device=dev),
        capped=capped,
    )

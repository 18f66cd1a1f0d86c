"""The plain reference of the A-LOAM mapping deployment, and its judge.

Plain PyTorch in float64 on any device, with both TF32 switches off. It
imports nothing of the program: from the benchmark's own sweeps and the
program's outputs it works out again what A-LOAM's state held, and judges
the outputs against it. Written from the published A-LOAM
(HKUST-Aerial-Robotics/A-LOAM: scanRegistration.cpp, laserOdometry.cpp,
laserMapping.cpp, lidarFactor.hpp):

- `features`: scanRegistration's rings from the elevation formula, the
  curvature over +-5 neighbours of a ring, six sectors a ring between its
  sp/ep bounds, and in each sector, by curvature, up to 2 sharp and 20
  less-sharp corners (> 0.1) and 4 flats (< 0.1), each pick marking its
  neighbours within 5 rows whose gaps stay under 0.05 m^2; less-flat is
  every sector row not picked as a corner, voxel-filtered at 0.2 m ring by
  ring.
- `odometry`: laserOdometry's correspondences (the nearest previous
  less-sharp point and the nearest in a ring within NEARBY_SCAN of its
  own; the nearest previous less-flat point, the nearest other one in its
  ring and the nearest in an adjacent ring, all under
  DISTANCE_SQ_THRESHOLD) and its Huber(0.1) least squares, 2 rounds of 4
  Gauss-Newton steps.
- `scan_to_map`: laserMapping's correspondences (5 nearest map points under
  1 m^2: a line where the largest eigenvalue is over 3 times the next, a
  plane A n = -1 whose five points lie within 0.2 of it) and its Huber
  least squares, 2 rounds of 4 steps. The five are searched exactly among
  the map points in the 27 cubes of 1 m around the query's (`knn_within`):
  a query whose fifth lies farther has no factor either way.
- `fold`: the stacks (less-sharp at the line resolution, less-flat at the
  plane resolution, voxel-filtered in the sensor frame) added to the maps
  at the pose and the maps voxel-filtered again, cropped to the box of
  `crop_radius_m` around the sensor.

Departures, each small beside the limits (PERF.md gives the readings): a
ring-64 sweep keeps rings below 50, as the program and the package it
ports do, where scanRegistration keeps ring 50 too (`scanID > 50` removes);
the maps are one cloud each, filtered whole, where laserMapping keeps
21 x 21 x 11 cubes of 50 m, filters each cube on its own and matches
against the 5 x 5 x 3 cubes around the sensor (on the benchmark's
corridor the window holds every map point within the sensor's range, and
no map leaves the +-150 m box); ceres' Levenberg-Marquardt steps over a
quaternion are plain Gauss-Newton steps over a rotation vector.

The judge: SLAM is stateful, so the reference follows the program frame
by frame from what the program gave out. It rebuilds the maps from its
own features of every earlier sweep folded at the program's poses, and
for each window frame runs its float64 scan-to-map solve from the
program's pose. A pose the program refined as A-LOAM does sits at the
cost's minimum, so the solve hardly moves it; any other pose moves. The
gap (`map_gap`) is how far the solve moves the sweep's points where the
map sees them: the RMS, over the factors found at the program's pose, of
each point's move along its plane's normal or across its line. (The
pose's own move is no measure: along the corridor the cost is nearly
flat, and a solve there drifts by millimetres from any pose, its own
result too.) The judge reports the gap's median, 90th percentile and
largest (`aloam_gap_*`) and the share of window frames whose gap passes
`gap_threshold` (`aloam_over_share`).
Loop edges and pose-graph solves are judged as the NDT deployment's are,
with reference/ndt_mapping.py's maps, score gap and float64 LM; the
program's counters give `aloam_capped` and `aloam_map_evicted_in_window`.

Besides the program's outputs ("program"), the judge can put stand-ins in
the program's place over the same frames (VARIANTS): "control", the
reference's own scan-to-map solve from the constant-velocity guess with
its residuals and Jacobians in bfloat16, one precision below the
configuration's float32, and its loop alignments and pose-graph solve as
reference/ndt_mapping.py's control; "unchanged", every pose the guess and
every loop edge and solve its input; "sparse", every 11th window frame's
pose given out 5 cm off along x.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_bench.reference import ndt_mapping as ndt

F64 = torch.float64
GAP_LEVER_M = 10.0  # pose_gap: translation + this lever times the rotation angle
MAX_RING = 50  # rings kept: 0 .. MAX_RING - 1 (see the departures)
CURVATURE = 0.1
PICK_GAP_SQ = 0.05
NEIGHBOURS = 5
SECTORS = 6
LESS_FLAT_LEAF = 0.2
HUBER = 0.1
KNN_CHUNK = 2048


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- scanRegistration -------------------------------------------------------------------------------
def ring_of(p: torch.Tensor, n_scans: int):
    """(ring [N] int64, kept [N] bool) of sensor points p [N, 3]: the
    elevation formula of scanRegistration.cpp for 16, 32 and 64 rings."""
    angle = torch.rad2deg(torch.atan(p[:, 2] / torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)))
    if n_scans == 16:
        ring = torch.trunc((angle + 15.0) / 2.0 + 0.5).to(torch.int64)
        ok = (ring >= 0) & (ring < 16)
    elif n_scans == 32:
        ring = torch.trunc((angle + 92.0 / 3.0) * 3.0 / 4.0).to(torch.int64)
        ok = (ring >= 0) & (ring < 32)
    elif n_scans == 64:
        ring = torch.where(angle >= -8.83, torch.trunc((2.0 - angle) * 3.0 + 0.5),
                           32 + torch.trunc((-8.83 - angle) * 2.0 + 0.5)).to(torch.int64)
        ok = (angle <= 2.0) & (angle >= -24.33) & (ring >= 0) & (ring < MAX_RING)
    else:
        raise ValueError(f"scan_line {n_scans}: 16, 32 or 64")
    return ring, ok


def voxel_centroids(points: torch.Tensor, leaf: float, group=None):
    """Centroids [V, 3] of the points in each world-aligned cube of `leaf`
    (and each value 0-63 of `group`, where given), with each voxel's group."""
    cells = torch.floor(points / leaf).to(torch.int64)
    if group is None:
        c = cells + (1 << 20)
        key = (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]
    else:
        c = cells + (1 << 18)
        key = (group << 57) | (c[:, 0] << 38) | (c[:, 1] << 19) | c[:, 2]
    uniq, inv = torch.unique(key, return_inverse=True)
    n = torch.zeros(len(uniq), dtype=F64, device=points.device).index_add_(0, inv, torch.ones_like(inv, dtype=F64))
    sums = torch.zeros((len(uniq), 3), dtype=F64, device=points.device).index_add_(0, inv, points.to(F64))
    return sums / n[:, None], (uniq >> 57 if group is not None else None)


def features(raw, n_scans: int, min_range: float, device) -> dict:
    """scanRegistration on one sweep (host float32 [N, 3], ring by ring):
    float64 clouds `sharp`, `less_sharp`, `flat`, `less_flat` [n, 3] on
    `device`, each with its rings (`<name>_ring`)."""
    p = torch.as_tensor(np.asarray(raw), device=device).to(F64)
    p = p[torch.all(torch.isfinite(p), dim=-1)]
    p = p[torch.sum(p * p, dim=-1) >= min_range * min_range]
    ring, ok = ring_of(p, n_scans)
    p, ring = p[ok], ring[ok]
    order = torch.sort(ring, stable=True).indices
    p, ring = p[order], ring[order]
    n = len(p)
    curv = torch.zeros(n, dtype=F64, device=device)
    if n > 2 * NEIGHBOURS:
        diff = -2.0 * NEIGHBOURS * p[NEIGHBOURS:n - NEIGHBOURS]
        for k in range(-NEIGHBOURS, NEIGHBOURS + 1):
            if k:
                diff = diff + p[NEIGHBOURS + k:n - NEIGHBOURS + k]
        curv[NEIGHBOURS:n - NEIGHBOURS] = torch.sum(diff * diff, dim=-1)
    gap = torch.zeros(n, dtype=F64, device=device)
    gap[1:] = torch.sum((p[1:] - p[:-1]) ** 2, dim=-1)  # gap[i]: between rows i - 1 and i
    counts = torch.bincount(ring, minlength=n_scans).tolist()
    curv_l, gap_l = curv.tolist(), gap.tolist()
    picked = [False] * n
    label = [0] * n  # 2 sharp, 1 less sharp, -1 flat
    in_sector = [False] * n

    def mark(i):
        picked[i] = True
        for lo in range(1, NEIGHBOURS + 1):
            if i + lo >= n or gap_l[i + lo] > PICK_GAP_SQ:
                break
            picked[i + lo] = True
        for lo in range(1, NEIGHBOURS + 1):
            if i - lo < 0 or gap_l[i - lo + 1] > PICK_GAP_SQ:
                break
            picked[i - lo] = True

    start = 0
    for r in range(n_scans):
        s_ind, e_ind = start + NEIGHBOURS, start + counts[r] - NEIGHBOURS - 1
        start += counts[r]
        if e_ind - s_ind < 6:
            continue
        for j in range(SECTORS):
            sp = s_ind + (e_ind - s_ind) * j // SECTORS
            ep = s_ind + (e_ind - s_ind) * (j + 1) // SECTORS - 1
            rows = sorted(range(sp, ep + 1), key=curv_l.__getitem__)
            for i in range(sp, ep + 1):
                in_sector[i] = True
            largest = 0
            for i in reversed(rows):
                if not picked[i] and curv_l[i] > CURVATURE:
                    largest += 1
                    if largest <= 2:
                        label[i] = 2
                    elif largest <= 20:
                        label[i] = 1
                    else:
                        break
                    mark(i)
            smallest = 0
            for i in rows:
                if not picked[i] and curv_l[i] < CURVATURE:
                    label[i] = -1
                    smallest += 1
                    if smallest >= 4:
                        break
                    mark(i)
    lab = torch.tensor(label, dtype=torch.int64, device=device)
    sector = torch.tensor(in_sector, dtype=torch.bool, device=device)
    out = {}
    for name, sel in (("sharp", lab == 2), ("less_sharp", lab >= 1), ("flat", lab == -1)):
        out[name], out[f"{name}_ring"] = p[sel], ring[sel]
    lf = sector & (lab <= 0)
    out["less_flat"], out["less_flat_ring"] = voxel_centroids(p[lf], LESS_FLAT_LEAF, group=ring[lf])
    return out


def stacks(f: dict, line_res: float, plane_res: float) -> tuple:
    """laserMapping's corner and surf stacks: less-sharp and less-flat
    voxel-filtered at the line and plane resolutions (sensor frame)."""
    return voxel_centroids(f["less_sharp"], line_res)[0], voxel_centroids(f["less_flat"], plane_res)[0]


def fold(map_pts: torch.Tensor, stack: torch.Tensor, T: np.ndarray, leaf: float, crop: float) -> torch.Tensor:
    """The map after adding `stack` at the world pose T: filtered at `leaf`
    and cropped to the box of `crop` around the sensor."""
    Tt = torch.as_tensor(np.asarray(T, np.float64), device=stack.device)
    pts = torch.cat([map_pts, stack @ Tt[:3, :3].T + Tt[:3, 3]])
    pts = pts[torch.all(torch.abs(pts - Tt[:3, 3]) <= crop, dim=-1)]
    return voxel_centroids(pts, leaf)[0]


# -- least squares ----------------------------------------------------------------------------------
def knn(table: torch.Tensor, q: torch.Tensor, k: int):
    """(d2 [Q, k], index [Q, k]) of the k nearest rows of `table` to each
    query, exact, ascending; +inf where the table holds fewer."""
    if len(table) == 0 or len(q) == 0:
        return (torch.full((len(q), k), math.inf, dtype=F64, device=q.device),
                torch.zeros((len(q), k), dtype=torch.int64, device=q.device))
    d2s, idxs = [], []
    kk = min(k, len(table))
    for s in range(0, len(q), KNN_CHUNK):
        qc = q[s:s + KNN_CHUNK]
        d2 = torch.sum((qc[:, None, :] - table[None, :, :]) ** 2, dim=-1) if len(table) <= 64 else \
            torch.cdist(qc, table) ** 2
        _, idx = torch.topk(d2, kk, dim=1, largest=False)
        exact = torch.sum((table[idx] - qc[:, None, :]) ** 2, dim=-1)
        exact, o = torch.sort(exact, dim=1)
        d2s.append(exact)
        idxs.append(torch.gather(idx, 1, o))
    d2, idx = torch.cat(d2s), torch.cat(idxs)
    if kk < k:
        d2 = torch.cat([d2, torch.full((len(q), k - kk), math.inf, dtype=F64, device=q.device)], dim=1)
        idx = torch.cat([idx, torch.zeros((len(q), k - kk), dtype=torch.int64, device=q.device)], dim=1)
    return d2, idx


STENCIL = torch.tensor([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)])


def knn_within(table: torch.Tensor, q: torch.Tensor, k: int, radius: float):
    """`knn` where only neighbours closer than `radius` count: the rows of
    `table` in the 27 cubes of edge `radius` around each query's are
    searched exactly, so the k nearest are exact wherever the k-th lies
    within `radius`, and the k-th reads at least `radius` where it does
    not."""
    dev = q.device
    if len(table) == 0 or len(q) == 0:
        return knn(table[:0], q, k)

    def pack(cells):
        c = cells + (1 << 20)
        return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]

    key = pack(torch.floor(table / radius).to(torch.int64))
    key, order = torch.sort(key)
    cand = pack(torch.floor(q / radius).to(torch.int64)[:, None, :] + STENCIL.to(dev)[None])  # [Q, 27]
    lo = torch.searchsorted(key, cand)
    count = torch.searchsorted(key, cand, right=True) - lo
    width = max(int(count.max()), 1)
    j = torch.arange(width, device=dev)
    rows = order[torch.clamp(lo[..., None] + j, max=len(table) - 1)].reshape(len(q), -1)  # [Q, 27 * width]
    d2 = torch.sum((table[rows] - q[:, None, :]) ** 2, dim=-1)
    d2 = torch.where((j < count[..., None]).reshape(len(q), -1), d2, torch.inf)
    if d2.shape[1] < k:
        d2 = torch.nn.functional.pad(d2, (0, k - d2.shape[1]), value=math.inf)
        rows = torch.nn.functional.pad(rows, (0, k - rows.shape[1]))
    d2, pos = torch.topk(d2, k, dim=1, largest=False)
    return d2, torch.gather(rows, 1, pos)


def _exp_so3(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + math.sin(th) / th * K + (1 - math.cos(th)) / th ** 2 * (K @ K)


def _hat(v: torch.Tensor) -> torch.Tensor:
    """[N, 3] -> [N, 3, 3] cross-product matrices."""
    z = torch.zeros_like(v[:, 0])
    return torch.stack([torch.stack([z, -v[:, 2], v[:, 1]], -1), torch.stack([v[:, 2], z, -v[:, 0]], -1),
                        torch.stack([-v[:, 1], v[:, 0], z], -1)], 1)


def gn_step(T: np.ndarray, edges, planes, dtype=F64) -> np.ndarray:
    """One Gauss-Newton step of the Huber(0.1) least squares from the world
    pose T: `edges` (sensor points, a, b) with the residual
    (x - a) x (x - b) / |a - b|, `planes` (sensor points, n, d) with n.x + d,
    x the point at the pose moved by (dt, dw): x + dt + dw x (x - t).
    Residuals and Jacobians in `dtype`, the 6 x 6 solve in float64."""
    dev = edges[0].device
    Tt = torch.as_tensor(np.asarray(T, np.float64), device=dev).to(dtype)
    R, t = Tt[:3, :3], Tt[:3, 3]
    e_p, a, b = (x.to(dtype) for x in edges)
    s_p, nrm, d = (x.to(dtype) for x in planes)
    L = torch.linalg.norm(a - b, dim=-1, keepdim=True)

    def moved(pts):
        """(x [N, 3], dx/d(dt, dw) [N, 3, 6]) at the pose."""
        body = pts @ R.T
        eye = torch.eye(3, dtype=dtype, device=dev).expand(len(pts), 3, 3)
        return body + t, torch.cat([eye, -_hat(body)], dim=-1)

    xe, dxe = moved(e_p)
    xs, dxs = moved(s_p)
    rows = [torch.linalg.cross(xe - a, xe - b) / L, (torch.sum(nrm * xs, dim=-1) + d)[:, None]]
    jac = [_hat((b - a) / L) @ dxe, nrm[:, None, :] @ dxs]
    w = [torch.linalg.norm(r, dim=-1) for r in rows]
    w = [torch.where(n <= HUBER, torch.ones_like(n), HUBER / torch.clamp(n, min=1e-30)) for n in w]
    H = sum(torch.einsum("n,nri,nrj->ij", wi, J, J) for wi, J in zip(w, jac))
    g = sum(torch.einsum("n,nri,nr->i", wi, J, r) for wi, J, r in zip(w, jac, rows))
    H, g = H.to(F64).cpu().numpy(), g.to(F64).cpu().numpy()
    delta = -np.linalg.solve(H + 1e-9 * np.eye(6), g)
    out = np.asarray(T, np.float64).copy()
    out[:3, :3] = _exp_so3(delta[3:]) @ out[:3, :3]
    out[:3, 3] += delta[:3]
    return out


def _at(T: np.ndarray, pts: torch.Tensor) -> torch.Tensor:
    Tt = torch.as_tensor(np.asarray(T, np.float64), device=pts.device)
    return pts @ Tt[:3, :3].T + Tt[:3, 3]


def map_correspondences(corner_map, surf_map, corner, surf, T: np.ndarray) -> tuple:
    """laserMapping's factors at the world pose T: (edges, planes) as
    gn_step takes them."""
    d2, idx = knn_within(corner_map, _at(T, corner), 5, 1.0)
    ok = d2[:, 4] < 1.0
    nn = corner_map[idx[ok]]
    cen = nn.mean(dim=1)
    dd = nn - cen[:, None]
    ev, vec = torch.linalg.eigh(torch.einsum("nki,nkj->nij", dd, dd) / 5.0)
    line = ev[:, 2] > 3.0 * ev[:, 1]
    direction = vec[:, :, 2][line]
    edges = (corner[ok][line], cen[line] + 0.1 * direction, cen[line] - 0.1 * direction)
    d2, idx = knn_within(surf_map, _at(T, surf), 5, 1.0)
    ok = d2[:, 4] < 1.0
    nn = surf_map[idx[ok]]
    A = nn
    n_raw = torch.linalg.lstsq(A, -torch.ones(A.shape[:2] + (1,), dtype=F64, device=A.device)).solution[..., 0]
    inv_norm = 1.0 / torch.linalg.norm(n_raw, dim=-1)
    n_hat = n_raw * inv_norm[:, None]
    fit = torch.all(torch.abs(torch.einsum("nki,ni->nk", nn, n_hat) + inv_norm[:, None]) <= 0.2, dim=-1)
    planes = (surf[ok][fit], n_hat[fit], inv_norm[fit])
    return edges, planes


def _residuals(T: np.ndarray, edges, planes) -> torch.Tensor:
    """The factors' residuals at the world pose T, [n_edges + n_planes, 3]
    (a plane's in the first column, zeros in the other two)."""
    e_p, a, b = edges
    s_p, nrm, d = planes
    xe, xs = _at(T, e_p), _at(T, s_p)
    re = torch.linalg.cross(xe - a, xe - b) / torch.linalg.norm(a - b, dim=-1, keepdim=True)
    rs = torch.sum(nrm * xs, dim=-1) + d
    return torch.cat([re, torch.nn.functional.pad(rs[:, None], (0, 2))])


def scan_to_map(corner_map, surf_map, corner, surf, T0: np.ndarray, outer: int = 2, steps: int = 4,
                dtype=F64, first=None) -> np.ndarray:
    """laserMapping's refinement from the world pose T0: `outer` rounds of
    correspondences, each followed by `steps` Gauss-Newton steps (`first`:
    the factors at T0, where they are already found)."""
    T = np.asarray(T0, np.float64)
    for k in range(outer):
        edges, planes = first if k == 0 and first is not None else map_correspondences(
            corner_map, surf_map, corner, surf, T)
        for _ in range(steps):
            T = gn_step(T, edges, planes, dtype)
    return T


def map_gap(corner_map, surf_map, corner, surf, T: np.ndarray, outer: int, steps: int) -> float:
    """How far the float64 scan-to-map solve from T moves the points where
    the map sees them: the RMS over the factors found at T of the change of
    each factor's residual between T and the solve's pose (m), i.e. of each
    point's move along its plane's normal or across its line. A pose at the
    cost's minimum gives 0; a move along a direction no factor constrains
    (along a bare corridor) counts nothing."""
    T = np.asarray(T, np.float64)
    if not np.all(np.isfinite(T)):
        return math.inf
    edges, planes = map_correspondences(corner_map, surf_map, corner, surf, T)
    if len(edges[0]) + len(planes[0]) == 0:
        return math.inf
    T_star = scan_to_map(corner_map, surf_map, corner, surf, T, outer, steps, first=(edges, planes))
    moved = torch.linalg.norm(_residuals(T, edges, planes) - _residuals(T_star, edges, planes), dim=-1)
    return float(torch.sqrt(torch.mean(moved * moved)))


def odometry_correspondences(prev: dict, cur: dict, T: np.ndarray, dist_sq: float = 25.0,
                             nearby: float = 2.5) -> tuple:
    """laserOdometry's factors of the current sweep's sharp and flat points
    at the relative pose T against the previous sweep's less-sharp and
    less-flat clouds: (edges, planes) as gn_step takes them, each plane
    given as its unit normal n and d = -n.a."""
    q = _at(T, cur["sharp"])
    d2, idx = knn(prev["less_sharp"], q, 1)
    ok = d2[:, 0] < dist_sq
    ring_a = prev["less_sharp_ring"][idx[:, 0]] if len(prev["less_sharp"]) else idx[:, 0]
    ring = prev["less_sharp_ring"]
    all_d2 = torch.sum((q[:, None, :] - prev["less_sharp"][None]) ** 2, dim=-1)
    other = (ring[None] != ring_a[:, None]) & (torch.abs(ring[None] - ring_a[:, None]) <= nearby) & (all_d2 < dist_sq)
    d2b = torch.where(other, all_d2, torch.inf)
    jb = torch.argmin(d2b, dim=1) if d2b.shape[1] else idx[:, 0]
    ok = ok & torch.isfinite(torch.amin(d2b, dim=1) if d2b.shape[1] else d2[:, 0])
    ls = prev["less_sharp"]
    edges = (cur["sharp"][ok], ls[idx[ok, 0]], ls[jb[ok]])

    q = _at(T, cur["flat"])
    lf, ring = prev["less_flat"], prev["less_flat_ring"]
    planes_p, planes_n, planes_d = [], [], []
    for s in range(0, len(q), KNN_CHUNK):
        qc = q[s:s + KNN_CHUNK]
        all_d2 = torch.sum((qc[:, None, :] - lf[None]) ** 2, dim=-1)
        ja = torch.argmin(all_d2, dim=1)
        da = torch.gather(all_d2, 1, ja[:, None])[:, 0]
        ra = ring[ja]
        not_a = torch.arange(len(lf), device=q.device)[None] != ja[:, None]
        gate = not_a & (all_d2 < dist_sq)
        same = gate & (ring[None] == ra[:, None])
        adj = gate & (ring[None] != ra[:, None]) & (torch.abs(ring[None] - ra[:, None]) <= nearby)
        d_same, d_adj = torch.where(same, all_d2, torch.inf), torch.where(adj, all_d2, torch.inf)
        jb, jc = torch.argmin(d_same, dim=1), torch.argmin(d_adj, dim=1)
        ok = (da < dist_sq) & torch.isfinite(torch.amin(d_same, dim=1)) & torch.isfinite(torch.amin(d_adj, dim=1))
        a, b, c = lf[ja[ok]], lf[jb[ok]], lf[jc[ok]]
        nrm = torch.linalg.cross(a - b, a - c)
        nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True)
        planes_p.append(cur["flat"][s:s + KNN_CHUNK][ok])
        planes_n.append(nrm)
        planes_d.append(-torch.sum(nrm * a, dim=-1))
    planes = (torch.cat(planes_p), torch.cat(planes_n), torch.cat(planes_d)) if planes_p else \
        tuple(torch.zeros((0, 3) if k < 2 else (0,), dtype=F64, device=q.device) for k in range(3))
    return edges, planes


def odometry(prev: dict, cur: dict, T0: np.ndarray, outer: int = 2, steps: int = 4, dtype=F64) -> np.ndarray:
    """laserOdometry's relative pose (current sweep in the previous one's
    frame) from T0: `outer` rounds of correspondences, `steps` steps each."""
    T = np.asarray(T0, np.float64)
    for _ in range(outer):
        edges, planes = odometry_correspondences(prev, cur, T)
        for _ in range(steps):
            T = gn_step(T, edges, planes, dtype)
    return T


def pose_gap(A: np.ndarray, B: np.ndarray) -> float:
    """How far the pose B moves a point GAP_LEVER_M from the sensor against
    A, bounded by the translation plus the lever times the angle."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    c = np.clip((np.trace(A[:3, :3].T @ B[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.linalg.norm(A[:3, 3] - B[:3, 3]) + GAP_LEVER_M * math.acos(c))


# -- the judge --------------------------------------------------------------------------------------
VARIANTS = ("program", "control", "unchanged", "sparse")


def _shift(dx: float) -> np.ndarray:
    T = np.eye(4)
    T[0, 3] = dx
    return T


def judge(rec, drive, config: dict, device, window: list, variants: tuple = ("program",)) -> dict:
    """The judge's numbers for a run, one dict a variant (VARIANTS): over
    every window frame whose pose came out (`window`), the median, 90th
    percentile and largest gap of the float64 scan-to-map solve from the
    variant's pose, and the share over `gap_threshold`; the loop edges and
    the window's last solve as reference/ndt_mapping.py judges them; and
    the program's counters `aloam_capped` and `aloam_map_evicted_in_window`
    (None where the program kept none)."""
    _no_tf32()
    a = config["cli_config"]["aloam"]
    j = config["judge"]
    dev = torch.device(device)
    P = np.stack(rec.poses).astype(np.float64)
    win = set(window)
    last = max(window) if window else -1
    maps = [torch.zeros((0, 3), dtype=F64, device=dev), torch.zeros((0, 3), dtype=F64, device=dev)]
    leaves = (a["mapping"]["line_res"], a["mapping"]["plane_res"])
    steps = (a["mapping"]["outer_iters"], a["mapping"]["gn_iters"])
    gaps = {v: [] for v in variants}
    n_w = 0
    for f in range(last + 1):
        f_raw = drive.frame(f)["points"]
        stack = stacks(features(f_raw, a["features"]["n_scans"], a["features"]["min_range"], dev), *leaves)
        if f in win:
            gap = lambda T: map_gap(maps[0], maps[1], *stack, T, *steps)  # noqa: E731
            program = gap(P[f])
            guess = P[f - 1] @ np.linalg.inv(P[f - 2]) @ P[f - 1]
            for v in variants:
                if v == "program" or (v == "sparse" and n_w % 11 != 10):
                    gaps[v].append(program)
                elif v == "sparse":
                    gaps[v].append(gap(P[f] @ _shift(0.05)))
                elif v == "unchanged":
                    gaps[v].append(gap(guess))
                else:
                    gaps[v].append(gap(scan_to_map(maps[0], maps[1], *stack, guess, *steps, torch.bfloat16)))
            n_w += 1
        for k in range(2):
            maps[k] = fold(maps[k], stack[k], P[f], leaves[k], j["crop_radius_m"])
    out = {v: {} for v in variants}
    for v in variants:
        if gaps[v]:
            g = np.asarray(gaps[v])
            q = {"median": np.percentile(g, 50), "p90": np.percentile(g, 90), "max": g.max()}
            # a quantile between two infinite gaps (a solve that left the finite poses) reads inf, not nan
            out[v].update({f"aloam_gap_{k}": float(x) if np.isfinite(x) else math.inf for k, x in q.items()})
            out[v]["aloam_over_share"] = float(np.mean(g > j["gap_threshold"]))
    _loops_and_solves(rec, drive, config, dev, win, variants, out)
    counters = getattr(rec, "counters", None) or {}
    for v in variants:
        for name in ("aloam_capped", "aloam_map_evicted_in_window"):
            out[v][name] = None if name not in counters else float(counters[name])
    return out


def _loops_and_solves(rec, drive, config: dict, dev, win: set, variants: tuple, out: dict) -> None:
    """reference/ndt_mapping.py's judgement of the window's loop edges (the
    score gap at the accepted pose in the verification submap) and of its
    last pose-graph solve (chi2 over the float64 LM's least), with the loop
    edges a window lap and the solves judged, into `out`."""
    j, lc = config["judge"], config["cli_config"]["loop_closing"]
    nd = j["loop_ndt"]
    d1, d2 = ndt.gauss_params(nd["resolution"], nd["outlier_ratio"])
    gap = lambda m, src, T: ndt.score_gap(m, src, T, d1, d2, j["reach_m"], j["reach_rad"])  # noqa: E731
    kp = [np.asarray(p, np.float32) for _, p in rec.keyframes]
    kf_frames = [f for f, _ in rec.keyframes]
    cache = {}

    def stored(k):
        if k not in cache:
            pts = torch.as_tensor(drive.frame(kf_frames[k])["points"], device=dev)
            cache[k] = ndt.downsample(pts[torch.all(torch.isfinite(pts), dim=-1)], j["store_leaf"],
                                      j["store_capacity"])
        return cache[k]

    loop_gaps = {v: [] for v in variants}
    in_window = [lp for lp in rec.loops if lp["frame"] in win]
    for lp in in_window:
        i0, i1, ext = lp["index0"], lp["index1"], lc["extend_frame_num"]
        sub = torch.cat([ndt.to_world(kp[k], stored(k)) for k in range(max(0, i0 - ext), min(len(kp), i0 + ext + 1))])
        sub = ndt.downsample(sub, j["loop_map_leaf"], j["loop_submap_capacity"]).to(F64)
        res = nd["resolution"]
        origin_cells = torch.floor(sub.min(dim=0).values / res - 1.0).to(torch.int64)
        m = ndt.NDTMap(sub, res, j["min_points_per_voxel"], grid=(origin_cells, tuple(j["loop_grid"])),
                       cap=j["max_compact_voxels"])
        scan = ndt.downsample(stored(i1), j["loop_scan_leaf"], j["loop_scan_capacity"])
        program = gap(m, scan, kp[i0] @ lp["relative"])
        for v in variants:
            if v in ("program", "sparse"):
                loop_gaps[v].append(program)
            elif v == "unchanged":
                loop_gaps[v].append(gap(m, scan, kp[i1]))
            else:
                T = ndt.align(m, scan, kp[i1], d1, d2, torch.bfloat16, nd["trans_eps"], nd["max_iter"],
                              nd["step_size"])
                loop_gaps[v].append(gap(m, scan, T))
    for v in variants:
        if loop_gaps[v]:
            out[v]["loop_gap_p90"] = float(np.percentile(loop_gaps[v], 90))
        out[v]["loops_per_lap"] = len(in_window) / drive.laps

    solves = [s for s in rec.solves if s["frame"] in win and "poses" in s]
    if solves:
        s = solves[-1]
        n, m_loops = s["nodes"], s["loops"]
        gnss = [drive.frame(f)["gnss_position"] for f in kf_frames[:n]]
        loops = [(lp["index0"], lp["index1"], lp["relative"]) for lp in rec.loops[:m_loops]]
        g = ndt.graph_of(n, kp, gnss, loops, j["back_end"])
        best_P, best = g.solve(kp[:n])
        for v in variants:
            got = {"control": lambda: [ndt._bf16(p) for p in best_P],
                   "unchanged": lambda: kp[:n]}.get(v, lambda: list(s["poses"][:n]))()
            out[v]["solve_chi2_excess"] = g.chi2(got) / best - 1.0
    for v in variants:
        out[v]["solves_judged"] = len(solves)

"""The plain reference of the NDT mapping deployment, and its judge.

Plain PyTorch in float64 on any device. It imports nothing of the program:
it works out again, from the benchmark's own sweeps and the program's
outputs, what the program's state held, and judges the outputs against it.

SLAM is stateful, so the reference follows the program step by step from
what the program gave out. For each frame it judges, it takes the
program's poses of the frames before (outputs) to place the keyframes, and
rebuilds from the raw sweeps what the program derived: the preprocessed
frame (finite returns, 0.5 m voxel centroids), the keyframe clouds (0.5 m
again, at most `keyframe_capacity` voxels in key order) and the local NDT
map of the last `local_frame_num` keyframes that the program's deferred
map maintenance had applied (1 m world-aligned voxels, at least
`min_points_per_voxel` points, eigenvalues inflated to 1 % of the largest).
It then evaluates the NDT score at the program's pose, with the radius27
neighbourhood, the Gaussian-mixture constants and gates of the
configuration, and looks within reach (5 cm, 5 mrad) for a pose that
scores higher: the Newton ascent step, clamped, and its halvings. A pose
the program aligned as the configuration states sits at the score's
maximum, so nothing within reach scores much higher; any other pose does.
The share by which the best pose within reach scores higher is the gap.
(The Newton step's length itself is no measure: along the corridor the
score is nearly flat, and a step there runs to decimetres on any pose.) A
few frames a window, where the front end's Newton loop stops short or a
U-turn lands it in another basin, read gaps of 0.1 and more run after run,
so the judge reports the median, the 90th percentile and the largest; the
configuration's `limits` compare the 90th percentile and the share of
frames whose gap passes `gap_threshold`, which a fault on a few frames in
a hundred moves where the percentile does not.

Loop edges are judged the same way against the verification submap (the
stored clouds of +-`extend_frame_num` keyframes around the older keyframe,
0.3 m centroids, the loop grid and its voxel cap), at the pose the
program accepted. A pose-graph solve is judged by its chi2 against the
least chi2 of the same graph (odometry edges, GNSS priors and the loop
edges inserted so far, node 0 fixed), which the reference reaches by its
own Levenberg-Marquardt from the odometry.

Departures, each small beside the limits (PERF.md gives the readings):
every map point weighs 1 (the program weighs the ~600 truck returns of a
keyframe by its detector-box matching); the tracking grid's bounds are not
applied (its 256 x 256 x 64 m extent holds every voxel a frame reaches);
the covariances are inverted through an exact eigendecomposition, where
the program's closed form skews the bases of tight and pole voxels.

The judge also counts what the window did: loop edges accepted a window
lap, and in-window solves it could judge (the configuration's `floors`), so
that a program that stops closing loops or solving is not correct.

Besides the program's outputs ("program"), the judge can put stand-ins in
the program's place over the same frames (VARIANTS): "control", the
reference's own alignments and solve computed in bfloat16, one precision
below the configuration's float32; "unchanged", every alignment returning
its start and the solve its input; "sparse", every 11th window frame's
pose given out 5 cm off along x.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
RADIUS27 = torch.tensor([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)])


# -- clouds ---------------------------------------------------------------------------------------
def downsample(points: torch.Tensor, leaf: float, capacity: int) -> torch.Tensor:
    """Voxel centroids of `points` [N, 3] (finite rows): cells of `leaf`
    counted from the cloud's least corner (x, y clipped to 2047, z to 510),
    in x-major key order, the first `capacity` voxels kept."""
    cells = torch.floor(points.to(torch.float32) / np.float32(leaf)).to(torch.int64)
    rel = cells - cells.amin(dim=0)
    rel = torch.stack([rel[:, 0].clamp(0, 2047), rel[:, 1].clamp(0, 2047), rel[:, 2].clamp(0, 510)], dim=-1)
    key = (rel[:, 0] << 20) | (rel[:, 1] << 9) | rel[:, 2]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    n = min(len(uniq), capacity)
    keep = inv < n
    sums = torch.zeros((n, 3), dtype=F64, device=points.device).index_add_(0, inv[keep], points[keep].to(F64))
    cnt = torch.zeros(n, dtype=F64, device=points.device).index_add_(0, inv[keep],
                                                                     torch.ones_like(inv[keep], dtype=F64))
    return (sums / cnt[:, None]).to(torch.float32)


def preprocess(raw: np.ndarray, leaf: float, capacity: int, device) -> torch.Tensor:
    pts = torch.as_tensor(raw, device=device)
    pts = pts[torch.all(torch.isfinite(pts), dim=-1)]
    return downsample(pts, leaf, capacity)


def to_world(T: np.ndarray, pts: torch.Tensor) -> torch.Tensor:
    T = torch.as_tensor(np.asarray(T, np.float64), device=pts.device)
    return pts.to(F64) @ T[:3, :3].T + T[:3, 3]


# -- NDT maps -------------------------------------------------------------------------------------
class NDTMap:
    """Voxel Gaussians of world points at `res`: sorted int64 keys of
    world-aligned cells, means [V, 3] and inverse covariances [V, 3, 3]."""

    OFF = 1 << 20

    def __init__(self, pts: torch.Tensor, res: float, min_points: int, grid=None, cap: int = None):
        dev = pts.device
        cells = torch.floor(pts / res).to(torch.int64)
        if grid is not None:
            origin_cells, dims = grid
            rel = cells - origin_cells
            inb = torch.all((rel >= 0) & (rel < torch.as_tensor(dims, device=dev)), dim=-1)
            pts, cells, rel = pts[inb], cells[inb], rel[inb]
            order_key = (rel[:, 0] * dims[1] + rel[:, 1]) * dims[2] + rel[:, 2]
        key = self.pack(cells)
        uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
        v = len(uniq)
        n = torch.zeros(v, dtype=F64, device=dev).index_add_(0, inv, torch.ones_like(inv, dtype=F64))
        corner = self.unpack(uniq).to(F64) * res
        rel = pts - corner[inv]
        s1 = torch.zeros((v, 3), dtype=F64, device=dev).index_add_(0, inv, rel)
        s2 = torch.zeros((v, 3, 3), dtype=F64, device=dev).index_add_(0, inv, rel[:, :, None] * rel[:, None, :])
        mean_rel = s1 / n[:, None]
        cov = (s2 / n[:, None, None] - mean_rel[:, :, None] * mean_rel[:, None, :]) * ((n - 1.0) / n)[:, None, None]
        occupied = n >= min_points
        if cap is not None and grid is not None:
            # the program packs at most `cap` occupied voxels, in flat-id order of its grid
            first = torch.full((v,), 2**62, dtype=torch.int64, device=dev).scatter_reduce_(0, inv, order_key, "amin")
            rank = torch.empty(v, dtype=torch.int64, device=dev)
            occ_idx = torch.nonzero(occupied)[:, 0]
            order = occ_idx[torch.argsort(first[occ_idx])]
            rank.fill_(2**62)
            rank[order] = torch.arange(len(order), device=dev)
            occupied = occupied & (rank < cap)
        evals, evecs = torch.linalg.eigh(cov)
        nondegen = (evals[:, 0] >= 0.0) & (evals[:, 2] > 0.0)
        ev = torch.maximum(evals, 0.01 * evals[:, 2:3]).clamp(min=1e-12)
        icov = (evecs / ev[:, None, :]) @ evecs.transpose(1, 2)
        ok = occupied & nondegen
        self.res = res
        self.keys = uniq[ok]
        self.mean = (corner + mean_rel)[ok]
        self.icov = icov[ok]

    @classmethod
    def pack(cls, cells):
        c = cells + cls.OFF
        return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]

    @classmethod
    def unpack(cls, key):
        m = (1 << 21) - 1
        return torch.stack([(key >> 42) & m, (key >> 21) & m, key & m], dim=-1) - cls.OFF

    def pairs(self, xp: torch.Tensor):
        """(point index, voxel index) of every radius27 neighbour of the
        points xp [N, 3] that holds a Gaussian."""
        cells = torch.floor(xp / self.res).to(torch.int64)
        cand = self.pack(cells[:, None, :] + RADIUS27.to(xp.device)[None])  # [N, 27]
        pos = torch.searchsorted(self.keys, cand).clamp(max=len(self.keys) - 1)
        hit = self.keys[pos] == cand
        pi, si = torch.nonzero(hit, as_tuple=True)
        return pi, pos[pi, si]


def gauss_params(resolution: float, outlier_ratio: float) -> tuple:
    """Magnusson's Gaussian-mixture constants d1, d2 (eq. 6.8)."""
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / resolution**3
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
    return d1, d2


def _rot(w):
    """exp([w]x) of a [3] rotation vector, differentiable at 0."""
    th2 = torch.sum(w * w)
    K = torch.zeros((3, 3), dtype=w.dtype, device=w.device)
    K = K.index_put((torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([1, 2, 0, 2, 0, 1])),
                    torch.stack([-w[2], w[1], w[2], -w[0], -w[1], w[0]]))
    a = 1.0 - th2 / 6.0 + th2 * th2 / 120.0
    b = 0.5 - th2 / 24.0 + th2 * th2 / 720.0
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * K + b * (K @ K)


def _pairs_in_reach(ndt: NDTMap, xp: torch.Tensor):
    pi, vi = ndt.pairs(xp)
    e = xp[pi] - ndt.mean[vi]
    near = torch.sum(e * e, dim=-1) <= ndt.res * ndt.res
    return pi[near], vi[near]


def _score(x, mu, ic, d1, d2):
    """The NDT score of (point, voxel) pairs: -d1 exp(-d2/2 e' icov e)
    summed over the pairs that pass the d2 exp <= 1 gate."""
    e = x - mu
    md = torch.einsum("ni,nij,nj->n", e, ic, e)
    ex = torch.exp(-0.5 * d2 * md)
    ok = (d2 * ex <= 1.0) & torch.isfinite(ex)
    return -d1 * torch.sum(torch.where(ok, ex, torch.zeros_like(ex)))


def moved(T: np.ndarray, delta: np.ndarray) -> np.ndarray:
    """T moved by delta: translation delta[:3] (m), rotation delta[3:] (rad)
    about the sensor, in world axes."""
    out = np.asarray(T, np.float64).copy()
    out[:3, :3] = _rot(torch.as_tensor(np.asarray(delta[3:], np.float64))).numpy() @ out[:3, :3]
    out[:3, 3] += delta[:3]
    return out


def score_at(ndt: NDTMap, src: torch.Tensor, T: np.ndarray, d1: float, d2: float, dtype=F64) -> float:
    """The NDT score of sensor points `src` at the world pose T, the pairs
    in reach found at T, computed in `dtype`."""
    Tt = torch.as_tensor(np.asarray(T, np.float64), device=src.device)
    xp = src.to(F64) @ Tt[:3, :3].T + Tt[:3, 3]
    pi, vi = _pairs_in_reach(ndt, xp)
    return float(_score(xp[pi].to(dtype), ndt.mean[vi].to(dtype), ndt.icov[vi].to(dtype), d1, d2))


def score_derivatives(ndt: NDTMap, src: torch.Tensor, T: np.ndarray, d1: float, d2: float, dtype=F64) -> tuple:
    """Gradient [6] and Hessian [6, 6] (float64, host) of the NDT score of
    sensor points `src` at the world pose T, over `moved`'s perturbation,
    computed in `dtype`, the pairs in reach fixed at T."""
    dev = src.device
    Tt = torch.as_tensor(np.asarray(T, np.float64), device=dev)
    body = src.to(F64) @ Tt[:3, :3].T  # the points about the sensor, in world axes
    pi, vi = _pairs_in_reach(ndt, body + Tt[:3, 3])
    b, t0 = body[pi].to(dtype), Tt[:3, 3].to(dtype)
    mu, ic = ndt.mean[vi].to(dtype), ndt.icov[vi].to(dtype)

    def score(delta):
        return _score(b @ _rot(delta[3:]).T + t0 + delta[:3], mu, ic, d1, d2)

    z = torch.zeros(6, dtype=dtype, device=dev)
    g = torch.func.grad(score)(z).to(F64).cpu().numpy()
    H = torch.func.hessian(score)(z).to(F64).cpu().numpy()
    return g, 0.5 * (H + H.T)


def ascent_step(g: np.ndarray, H: np.ndarray) -> np.ndarray:
    """The Newton step towards the score's maximum, -(H - mu I)^-1 g, its
    Hessian shifted by mu until negative definite where it is not."""
    w = np.linalg.eigvalsh(H)
    mu = max(0.0, w[-1]) + 1e-6 * np.abs(w).max()
    return -np.linalg.solve(H - mu * np.eye(6), g)


def _clamped(d: np.ndarray, trans: float, rot: float) -> np.ndarray:
    scale = min(1.0, trans / max(np.linalg.norm(d[:3]), 1e-300), rot / max(np.linalg.norm(d[3:]), 1e-300))
    return d * scale


def score_gap(ndt: NDTMap, src: torch.Tensor, T: np.ndarray, d1: float, d2: float, trans: float,
              rot: float) -> float:
    """How much higher the score is found within `trans` m and `rot` rad of
    T than at T, as a share of the score at T: the Newton ascent step,
    clamped, and its halvings. A pose at the score's maximum gives 0."""
    s0 = score_at(ndt, src, T, d1, d2)
    d = _clamped(ascent_step(*score_derivatives(ndt, src, T, d1, d2)), trans, rot)
    best = max(score_at(ndt, src, moved(T, d * f), d1, d2) for f in (1.0, 0.5, 0.25, 0.125))
    return max(best - s0, 0.0) / abs(s0)


def align(ndt: NDTMap, src: torch.Tensor, T0: np.ndarray, d1: float, d2: float, dtype, trans_eps: float,
          max_iter: int, step_size: float) -> np.ndarray:
    """Newton's method on the NDT score from T0, its derivatives in `dtype`,
    each step clamped to `step_size` m and rad, until a step moves less than
    trans_eps or max_iter: the control's alignment."""
    T = np.asarray(T0, np.float64)
    for _ in range(max_iter):
        d = _clamped(ascent_step(*score_derivatives(ndt, src, T, d1, d2, dtype)), step_size, step_size)
        T = moved(T, d)
        if np.linalg.norm(d[:3]) < trans_eps:
            break
    return T.astype(np.float32)


# -- the pose graph -------------------------------------------------------------------------------
def _hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def so3_log(R):
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = math.acos(c)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return 0.5 * w if th < 1e-8 else th / (2.0 * math.sin(th)) * w


def se3_log(T):
    """(rho, phi) of a 4x4 transform."""
    phi = so3_log(T[:3, :3])
    th2 = float(phi @ phi)
    K = _hat(phi)
    if th2 < 1e-10:
        cot = 1.0 / 12.0 + th2 / 720.0
    else:
        th = math.sqrt(th2)
        cot = 1.0 / th2 - (1.0 + math.cos(th)) / (2.0 * th * math.sin(th))
    Vinv = np.eye(3) - 0.5 * K + cot * (K @ K)
    return np.concatenate([Vinv @ T[:3, 3], phi])


def se3_exp(xi):
    rho, phi = xi[:3], xi[3:]
    th = np.linalg.norm(phi)
    K = _hat(phi)
    if th < 1e-8:
        R, V = np.eye(3) + K, np.eye(3) + 0.5 * K
    else:
        R = np.eye(3) + math.sin(th) / th * K + (1 - math.cos(th)) / th**2 * (K @ K)
        V = np.eye(3) + (1 - math.cos(th)) / th**2 * K + (th - math.sin(th)) / th**3 * (K @ K)
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, V @ rho
    return T


class PoseGraph:
    """Nodes, SE(3) edges r = log(Z^-1 Ti^-1 Tj) and XYZ priors r = t_i - z,
    each weighed by its information (1 / sigma) as chi2 = sum info r^2;
    node 0 fixed."""

    def __init__(self, n, edges, priors):
        self.n, self.edges, self.priors = n, edges, priors

    def chi2(self, P) -> float:
        total = 0.0
        for i, j, Z, info in self.edges:
            r = se3_log(np.linalg.inv(Z) @ np.linalg.inv(P[i]) @ P[j])
            total += float(np.sum(info * r * r))
        for i, z, info in self.priors:
            r = P[i][:3, 3] - z
            total += float(np.sum(info * r * r))
        return total

    def solve(self, P0, iterations: int = 50) -> tuple:
        """Levenberg-Marquardt with numeric Jacobians of right perturbations,
        from P0; returns (poses, chi2)."""
        from scipy.sparse import coo_matrix
        from scipy.sparse.linalg import spsolve

        P = [np.asarray(p, np.float64) for p in P0]
        chi, lam, eps = self.chi2(P), 1e-4, 1e-6
        for _ in range(iterations):
            rows, cols, vals, b = [], [], [], np.zeros(6 * self.n)
            blocks = {}

            def add(a, c, M):
                blocks[(a, c)] = blocks.get((a, c), 0.0) + M

            for i, j, Z, info in self.edges:
                Zinv = np.linalg.inv(Z)
                r0 = se3_log(Zinv @ np.linalg.inv(P[i]) @ P[j])
                Ji, Jj = np.zeros((6, 6)), np.zeros((6, 6))
                for k in range(6):
                    d = np.zeros(6)
                    d[k] = eps
                    Ji[:, k] = (se3_log(Zinv @ np.linalg.inv(P[i] @ se3_exp(d)) @ P[j]) - r0) / eps
                    Jj[:, k] = (se3_log(Zinv @ np.linalg.inv(P[i]) @ P[j] @ se3_exp(d)) - r0) / eps
                W = np.diag(info)
                for a, Ja in ((i, Ji), (j, Jj)):
                    b[6 * a:6 * a + 6] += Ja.T @ W @ r0
                    for c, Jc in ((i, Ji), (j, Jj)):
                        add(a, c, Ja.T @ W @ Jc)
            for i, z, info in self.priors:
                r0 = P[i][:3, 3] - z
                J = np.hstack([P[i][:3, :3], np.zeros((3, 3))])
                b[6 * i:6 * i + 6] += J.T @ (info * r0)
                add(i, i, J.T @ np.diag(info) @ J)
            for (a, c), M in blocks.items():
                if a == 0 or c == 0:
                    continue
                rr, cc = np.meshgrid(np.arange(6) + 6 * a, np.arange(6) + 6 * c, indexing="ij")
                rows.append(rr.ravel())
                cols.append(cc.ravel())
                vals.append(M.ravel())
            H = coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                           shape=(6 * self.n, 6 * self.n)).tocsr()
            H = H[6:, 6:]
            diag = H.diagonal()
            improved = False
            while lam < 1e8:
                dx = spsolve((H + coo_matrix((lam * np.maximum(diag, 1e-12), (np.arange(len(diag)),) * 2),
                                             shape=H.shape)).tocsc(), -b[6:])
                Q = [P[0]] + [P[k] @ se3_exp(dx[6 * (k - 1):6 * k]) for k in range(1, self.n)]
                c2 = self.chi2(Q)
                if c2 < chi:
                    rel = (chi - c2) / chi
                    P, chi, lam, improved = Q, c2, lam / 2.0, True
                    break
                lam *= 2.0
            if not improved or rel < 1e-10:
                break
        return P, chi


def graph_of(n: int, key_poses, gnss, loops, cfg: dict) -> PoseGraph:
    """The back end's graph over its first n keyframes: odometry edges
    between consecutive keyframes, a GNSS prior at each and `loops` (index0,
    index1, relative pose); information 1 / sigma in float32 as configured."""
    info = lambda s: (np.float32(1.0) / np.asarray(s, np.float32)).astype(np.float64)  # noqa: E731
    odo, loop, gn = info(cfg["odom_edge_noise"]), info(cfg["close_loop_noise"]), info(cfg["gnss_noise"])
    K = [np.asarray(p, np.float32) for p in key_poses[:n]]
    edges = [(i - 1, i, (np.linalg.inv(K[i - 1]) @ K[i]).astype(np.float64), odo) for i in range(1, n)]
    edges += [(a, b, np.asarray(Z, np.float64), loop) for a, b, Z in loops]
    priors = [(i, np.asarray(gnss[i], np.float64), gn) for i in range(n)]
    return PoseGraph(n, edges, priors)


# -- the judge ------------------------------------------------------------------------------------
def front_end_keyframes(poses, gate: float) -> list:
    """The frames at which the front end makes a keyframe: the first, then
    each whose position is more than `gate` (L1) from the last keyframe's."""
    out, last = [0], np.asarray(poses[0], np.float32)[:3, 3]
    for i in range(1, len(poses)):
        p = np.asarray(poses[i], np.float32)[:3, 3]
        if np.abs(p - last).sum() > np.float32(gate):
            out.append(i)
            last = p
    return out


def _bf16(T):
    return torch.as_tensor(np.asarray(T, np.float32)).to(torch.bfloat16).to(torch.float64).numpy()


def _quantiles(name: str, values) -> dict:
    v = np.asarray(values, np.float64)
    return {f"{name}_median": float(np.median(v)), f"{name}_p90": float(np.percentile(v, 90)),
            f"{name}_max": float(v.max())}


VARIANTS = ("program", "control", "unchanged", "sparse")


def judge(rec, drive, config: dict, device, window: list, variants: tuple = ("program",)) -> dict:
    """The judge's numbers for a run, one dict a variant (VARIANTS): over
    every frame whose pose came out in the window (`window`), the median,
    90th percentile and largest `score_gap` at the variant's pose (how much
    better a pose within reach scores) and the share over `gap_threshold`;
    the same over the loop edges accepted in the window, at the accepted
    pose; for the window's last solve, its chi2 over the graph's least (less
    1); the loop edges accepted a window lap, and the window's solves with
    their record. The configuration's `limits` and `floors` say which are
    compared."""
    j = config["judge"]
    fe, lc = config["cli_config"]["front_end"], config["cli_config"]["loop_closing"]
    nd = fe["ndt"]
    d1, d2 = gauss_params(nd["resolution"], nd["outlier_ratio"])
    dev = torch.device(device)
    P = np.stack(rec.poses)
    kfs = front_end_keyframes(P, fe["key_frame_distance"])
    raw = lambda i: drive.frame(i)["points"]  # noqa: E731
    kf_cache, store_cache = {}, {}
    gap = lambda ndt, src, T: score_gap(ndt, src, T, d1, d2, j["reach_m"], j["reach_rad"])  # noqa: E731
    bf16_align = lambda ndt, src, T0: align(ndt, src, T0, d1, d2, torch.bfloat16, nd["trans_eps"],  # noqa: E731
                                            nd["max_iter"], nd["step_size"])

    def frame_cloud(i):
        return preprocess(raw(i), fe["frame_leaf"], j["frame_capacity"], dev)

    def kf_cloud(i):
        if i not in kf_cache:
            kf_cache[i] = to_world(P[i], downsample(frame_cloud(i), fe["frame_leaf"], j["keyframe_capacity"]))
        return kf_cache[i]

    out = {v: {} for v in variants}
    gaps = {v: [] for v in variants}
    maps = {}
    for n_f, f in enumerate(window):
        applied = tuple([k for k in kfs if k == 0 or k <= f - 2][-fe["local_frame_num"]:])
        if applied not in maps:
            maps.clear()
            maps[applied] = NDTMap(torch.cat([kf_cloud(k) for k in applied]), fe["ndt"]["resolution"],
                                   j["min_points_per_voxel"])
            for k in list(kf_cache):
                if k < applied[0]:
                    del kf_cache[k]
        ndt, src = maps[applied], frame_cloud(f)
        guess = P[f - 1] @ np.linalg.inv(P[f - 2]) @ P[f - 1]
        program = gap(ndt, src, P[f])
        for v in variants:
            if v == "program" or (v == "sparse" and n_f % 11 != 10):
                gaps[v].append(program)
            elif v == "sparse":
                gaps[v].append(gap(ndt, src, P[f] @ _shift(0.05)))
            elif v == "unchanged":
                gaps[v].append(gap(ndt, src, guess))
            else:
                gaps[v].append(gap(ndt, src, bf16_align(ndt, src, guess)))
    for v in variants:
        if gaps[v]:
            out[v].update(_quantiles("track_gap", gaps[v]))
            out[v]["track_over_share"] = float(np.mean(np.asarray(gaps[v]) > j["gap_threshold"]))

    kp = [np.asarray(p, np.float32) for _, p in rec.keyframes]
    kf_frames = [f for f, _ in rec.keyframes]
    win = set(window)

    def stored(k):
        if k not in store_cache:
            pts = torch.as_tensor(raw(kf_frames[k]), device=dev)
            store_cache[k] = downsample(pts[torch.all(torch.isfinite(pts), dim=-1)], j["store_leaf"],
                                        j["store_capacity"])
        return store_cache[k]

    loop_gaps = {v: [] for v in variants}
    in_window = [lp for lp in rec.loops if lp["frame"] in win]
    for lp in in_window:
        i0, i1, ext = lp["index0"], lp["index1"], lc["extend_frame_num"]
        sub = torch.cat([to_world(kp[k], stored(k)) for k in range(max(0, i0 - ext), min(len(kp), i0 + ext + 1))])
        sub = downsample(sub, j["loop_map_leaf"], j["loop_submap_capacity"]).to(F64)
        res = j["loop_resolution"]
        origin_cells = torch.floor(sub.min(dim=0).values / res - 1.0).to(torch.int64)
        ndt = NDTMap(sub, res, j["min_points_per_voxel"], grid=(origin_cells, tuple(j["loop_grid"])),
                     cap=j["max_compact_voxels"])
        scan = downsample(stored(i1), j["loop_scan_leaf"], j["loop_scan_capacity"])
        program = gap(ndt, scan, kp[i0] @ lp["relative"])
        for v in variants:
            if v in ("program", "sparse"):
                loop_gaps[v].append(program)
            elif v == "unchanged":
                loop_gaps[v].append(gap(ndt, scan, kp[i1]))
            else:
                loop_gaps[v].append(gap(ndt, scan, bf16_align(ndt, scan, kp[i1])))
    for v in variants:
        if loop_gaps[v]:
            out[v].update(_quantiles("loop_gap", loop_gaps[v]))
        out[v]["loops_per_lap"] = len(in_window) / drive.laps

    solves = [s for s in rec.solves if s["frame"] in win and "poses" in s]
    if solves:
        s = solves[-1]
        n, m = s["nodes"], s["loops"]
        gnss = [drive.frame(f)["gnss_position"] for f in kf_frames[:n]]
        loops = [(lp["index0"], lp["index1"], lp["relative"]) for lp in rec.loops[:m]]
        g = graph_of(n, kp, gnss, loops, config["judge"]["back_end"])
        best_P, best = g.solve(kp[:n])
        for v in variants:
            got = {"control": lambda: [_bf16(p) for p in best_P],
                   "unchanged": lambda: kp[:n]}.get(v, lambda: list(s["poses"][:n]))()
            out[v]["solve_chi2_excess"] = g.chi2(got) / best - 1.0
    for v in variants:
        out[v]["solves_judged"] = len(solves)
    return out


def _shift(dx: float) -> np.ndarray:
    T = np.eye(4)
    T[0, 3] = dx
    return T

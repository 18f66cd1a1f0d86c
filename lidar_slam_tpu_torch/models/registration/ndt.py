"""NDT registration with per-voxel static weights, in PyTorch (port of
lidar_slam_tpu/models/registration/ndt.py).

Map side: the dense voxel-Gaussian map is kept as running per-voxel moment
sums (`NDTMapSums`) and conditioned into an `NDTMap` whose layout is what
the derivative kernel reads: a dense `[V]` int32 `index` into a compact
`[C+1, 16]` `packed` stats table, with the occupied voxels' flat ids in
ascending `keys`.

Align side: with the fused gather, the Newton solver and no line-search
iterations (every tracking configuration), the whole clamped-Newton
alignment is one launch of the `ndt_newton` kernel (`ops/cuda/
ndt_newton.py`) on CUDA tensors, or its plain PyTorch version on CPU
tensors, and one copy of its result to the host: the counterpart of the
JAX package's device `lax.while_loop`. Every other configuration runs the
loop on the HOST (`ndt_align_host_loop`): each derivative evaluation is one
reduction (kernel K1, `ops/cuda/ndt_fused.py`, or its plain version) plus
one device-to-host copy of its 32 sums, and the 6x6 LDL^T solve, the step
clamp, the More-Thuente line search, the convergence test and the pose
update run in float32 numpy.

Pose parameterization as in the reference: p = (tx, ty, tz, roll, pitch,
yaw) with R = Rx(roll) Ry(pitch) Rz(yaw).

The map's `origin` is a host (CPU) float32 [3] tensor: every consumer
needs it on the host (kernel launch arguments, the recenter shift, voxel
offsets), so keeping it there costs no synchronisation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ...geom.se3 import euler_xyz_to_matrix, make_pose, matrix_to_euler_xyz
from ...ops.cuda import ndt_newton as _newton
from ...ops.cuda.ndt_gather import assert_keys_ascend
from ...ops.cuda.ndt_fused import ndt_reduce_fused, ndt_reduce_plain, unpack_results
from ...ops.eigh3 import sym_eigh3
from ...ops.pointcloud import PointCloud, scatter_sum

_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class NDTConfig:
    """Static NDT parameters; the same fields and defaults as the JAX
    package's NDTConfig (see there for the reasoning behind each default).

    `fused_window` and `fused_tile` size the TPU kernel's key windows and
    tiles. The Hopper kernel gathers directly and reads neither; they stay
    so that configurations carry over field for field.
    """

    resolution: float = 1.0
    step_size: float = 0.1
    trans_eps: float = 0.01
    max_iter: int = 30
    outlier_ratio: float = 0.55
    min_points_per_voxel: int = 6
    grid_dims: Tuple[int, int, int] = (256, 256, 64)
    max_compact_voxels: int = 65536
    # 'radius27' = 3x3x3 stencil gated by |centroid - x'| <= resolution;
    # 'direct7' = centre + 6 face neighbours, ungated
    stencil: str = "radius27"
    # 'two_level' = the plain PyTorch reduction on any device; 'fused' and
    # 'auto' = the kernels on CUDA tensors (ndt_newton for a whole Newton
    # alignment, K1 for one evaluation), their plain versions on CPU tensors;
    # 'onehot' = the plain reduction with its stats fetched by key through
    # kernel K3 (its plain version on CPU tensors)
    gather: str = "two_level"
    dense_stats: bool = True
    fused_window: int = 2048
    fused_tile: int = 1024
    weight_derivatives: bool = True
    max_step_iterations: int = 0
    solver: str = "newton"
    score_rel_tol: float = 0.0
    point_chunk: int = 8192

    def resolve_gather(self, device) -> str:
        """The derivative path for tensors on `device`: 'fused' on CUDA
        for gather in ('fused', 'auto'), else the requested path."""
        if self.gather == "auto":
            return "fused" if torch.device(device).type == "cuda" else "two_level"
        if self.gather not in ("fused", "two_level", "onehot"):
            raise ValueError(f"unknown gather mode {self.gather!r}")
        return self.gather

    def gauss_params(self) -> Tuple[float, float]:
        """Gaussian-mixture d1/d2 (eq. 6.8, Magnusson 2009)."""
        c1 = 10.0 * (1.0 - self.outlier_ratio)
        c2 = self.outlier_ratio / (self.resolution**3)
        d3 = -math.log(c2)
        d1 = -math.log(c1 + c2) - d3
        d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
        return d1, d2


@dataclasses.dataclass
class NDTMap:
    """Dense voxel-Gaussian map. `packed` rows (64 B):
    [0:3] mean, [3] staticvalue, [4:10] icov upper triangle
    (xx, xy, xz, yy, yz, zz), [10] valid, [11] count, [12:16] pad.

    Invariant: `keys` ascend in unsigned order. The occupied voxels' flat
    ids rise strictly, then -1 (0xFFFFFFFF unsigned) fills the tail, so
    compact row j is the j-th key in that order and K3 looks ids up with no
    sort (`ndt_gather.gather_stats_sorted`). `finalize_ndt_sums` and
    `_pack_rows` build keys so and assert it on the device
    (`ndt_gather.assert_keys_ascend`, no host sync);
    `convert.ndt_map_from_numpy` checks it on the host."""

    origin: torch.Tensor  # [3] host float32 grid min corner (metres)
    count: torch.Tensor  # [V] float32
    mean: torch.Tensor  # [V, 3] ([1, 3] placeholder when dense_stats=False)
    icov: torch.Tensor  # [V, 3, 3]
    staticvalue: torch.Tensor  # [V]
    valid: torch.Tensor  # [V] bool
    index: torch.Tensor  # [V] int32 -> row in `packed` (sentinel = last row)
    packed: torch.Tensor  # [C+1, 16]; the last row is the zero sentinel
    keys: torch.Tensor  # [C+1] int32 flat voxel id per compact row (-1 unused)
    dims: Tuple[int, int, int]
    resolution: float = 1.0


@dataclasses.dataclass
class NDTResult:
    pose: torch.Tensor  # [4, 4] host float32
    # score / n_valid_points: on the host from ndt_newton, on the points'
    # device from the host loop (no extra synchronisation either way)
    trans_probability: torch.Tensor
    score: float
    iterations: int
    converged: bool
    gradient: torch.Tensor  # [6] host, at the solution
    hessian: torch.Tensor  # [6, 6] host, at the solution
    # The kernels gather directly, so no derivative term is ever dropped: always 0.
    # Kept so callers keep the exactness check of the JAX package.
    unresolved: float = 0.0


@dataclasses.dataclass
class NDTMapSums:
    """Running per-voxel moment sums — the incremental form of the NDT map.

    Second moments are relative to each point's own voxel corner, and voxel
    assignment uses the absolute lattice, exactly as in the JAX package (see
    its docstring for why). `origin` must be a multiple of `resolution`.
    """

    origin: torch.Tensor  # [3] host float32, a lattice multiple
    count: torch.Tensor  # [V] float32 points per voxel (exact integers)
    psum: torch.Tensor  # [V, 3] sum of (p - voxel corner)
    ppsum: torch.Tensor  # [V, 6] sym sum of outer(p - corner): xx xy xz yy yz zz
    wsum: torch.Tensor  # [V] sum of static weights
    dims: Tuple[int, int, int]
    resolution: float = 1.0


def _host_origin(origin) -> torch.Tensor:
    if isinstance(origin, torch.Tensor):
        origin = origin.detach().cpu()
    return torch.as_tensor(np.asarray(origin, np.float32).reshape(3))


def _to(x, dev) -> torch.Tensor:
    """A small host constant on `dev` without a stream synchronisation."""
    return torch.as_tensor(x).to(dev, non_blocking=True)


def _origin_cells(origin: torch.Tensor, res: float) -> np.ndarray:
    return np.round(origin.numpy() / _f32(res)).astype(np.int32)


def _flat_vid(coords, dims):
    return (coords[..., 0] * dims[1] + coords[..., 1]) * dims[2] + coords[..., 2]


def empty_ndt_sums(origin, config: NDTConfig, device=None) -> NDTMapSums:
    dims = tuple(config.grid_dims)
    v = dims[0] * dims[1] * dims[2]
    return NDTMapSums(
        origin=_host_origin(origin),
        count=torch.zeros(v, dtype=torch.float32, device=device),
        psum=torch.zeros((v, 3), dtype=torch.float32, device=device),
        ppsum=torch.zeros((v, 6), dtype=torch.float32, device=device),
        wsum=torch.zeros(v, dtype=torch.float32, device=device),
        dims=dims,
        resolution=config.resolution,
    )


def scatter_to_sums(
    sums: NDTMapSums, points, mask, weights=None, sign: float = 1.0, signs=None
) -> NDTMapSums:
    """Accumulate (sign=+1) or remove (sign=-1) a cloud's voxel moments.

    `signs` ([N], ±1) overrides `sign` per point, so one concatenated
    evict+add cloud takes one pass over the dense outputs. Out-of-bounds
    and non-finite points are skipped symmetrically on add and evict.
    Returns new sums; the inputs are not modified.
    """
    dims = sums.dims
    dev = sums.count.device
    res = sums.resolution
    if weights is None:
        weights = torch.ones(points.shape[:-1], dtype=torch.float32, device=dev)

    finite = torch.all(torch.isfinite(points), dim=-1)
    safe_pts = torch.where(finite[:, None], points, 0.0)
    cell_abs = torch.floor(safe_pts / res).to(torch.int32)
    coords = cell_abs - _to(_origin_cells(sums.origin, res), dev)
    inb = torch.all((coords >= 0) & (coords < _to(np.asarray(dims, np.int32), dev)), dim=-1)
    ok = mask & inb & finite
    vid = _flat_vid(coords, dims).long()
    s = torch.as_tensor(signs, dtype=torch.float32, device=dev) if signs is not None else float(sign)
    okf = ok.to(torch.float32) * s

    rel = safe_pts - cell_abs.to(torch.float32) * res
    rel = torch.where(ok[:, None], rel, 0.0)
    rx, ry, rz = rel[:, 0], rel[:, 1], rel[:, 2]
    outer6 = torch.stack([rx * rx, rx * ry, rx * rz, ry * ry, ry * rz, rz * rz], dim=-1)

    return dataclasses.replace(
        sums,
        count=scatter_sum(sums.count, vid, okf, ok),
        psum=scatter_sum(sums.psum, vid, rel * okf[:, None], ok),
        ppsum=scatter_sum(sums.ppsum, vid, outer6 * okf[:, None], ok),
        wsum=scatter_sum(sums.wsum, vid, weights * okf, ok),
    )


def coarsen_ndt_sums(sums: NDTMapSums) -> NDTMapSums:
    """The 2x-resolution sums from the fine sums in one dense pass.

    Every coarse voxel is a 2x2x2 block of fine voxels, and the corner-
    relative moments shift in closed form under d = fine_corner -
    coarse_corner (d in {0, res}^3):
        count' = count    psum' = psum + count d
        ppsum' = ppsum + d psum^T + psum d^T + count d d^T
    Written as reshapes and sums (the JAX package does the z pair-sum as a
    matmul for the TPU). Requires the fine origin on the 2*res lattice.
    """
    d0, d1, d2 = sums.dims
    assert d0 % 2 == 0 and d1 % 2 == 0 and d2 % 2 == 0
    r = float(sums.resolution)

    def zpairs(a):
        return a.reshape(d0, d1, d2 // 2, 2)

    def zred(a):  # sum of each z pair
        return zpairs(a).sum(dim=-1)

    def zredw(a):  # the odd-z (dz = res) member only
        return zpairs(a)[..., 1]

    cnt, ws = sums.count, sums.wsum
    px, py, pz = sums.psum[:, 0], sums.psum[:, 1], sums.psum[:, 2]
    xx, xy, xz = sums.ppsum[:, 0], sums.ppsum[:, 1], sums.ppsum[:, 2]
    yy, yz, zz = sums.ppsum[:, 3], sums.ppsum[:, 4], sums.ppsum[:, 5]

    C, Cw = zred(cnt), zredw(cnt)
    PX, PY, PZ = zred(px), zred(py), zred(pz)
    PZs = PZ + r * Cw
    XZs = zred(xz) + r * zredw(px)
    YZs = zred(yz) + r * zredw(py)
    ZZs = zred(zz) + 2.0 * r * zredw(pz) + r * r * Cw
    XXz, XYz, YYz, Wz = zred(xx), zred(xy), zred(yy), zred(ws)

    def s4(a):  # x/y parity slices
        return (a[0::2, 0::2], a[0::2, 1::2], a[1::2, 0::2], a[1::2, 1::2])

    C4, Cw4 = s4(C), s4(Cw)
    PX4, PY4, PZ4 = s4(PX), s4(PY), s4(PZ)
    OX = (0.0, 0.0, 1.0, 1.0)
    OY = (0.0, 1.0, 0.0, 1.0)

    def red(z4, extra=lambda i: 0.0):
        out = 0.0
        for i in range(4):
            out = out + z4[i] + extra(i)
        return out

    cnt_c = red(s4(C))
    ws_c = red(s4(Wz))
    px_c = red(s4(PX), lambda i: OX[i] * r * C4[i])
    py_c = red(s4(PY), lambda i: OY[i] * r * C4[i])
    pz_c = red(s4(PZs))
    xx_c = red(s4(XXz), lambda i: OX[i] * (2.0 * r * PX4[i] + r * r * C4[i]))
    yy_c = red(s4(YYz), lambda i: OY[i] * (2.0 * r * PY4[i] + r * r * C4[i]))
    xy_c = red(
        s4(XYz),
        lambda i: OX[i] * r * PY4[i] + OY[i] * r * PX4[i] + OX[i] * OY[i] * r * r * C4[i],
    )
    xz_c = red(s4(XZs), lambda i: OX[i] * r * (PZ4[i] + r * Cw4[i]))
    yz_c = red(s4(YZs), lambda i: OY[i] * r * (PZ4[i] + r * Cw4[i]))
    zz_c = red(s4(ZZs))

    return NDTMapSums(
        origin=sums.origin,
        count=cnt_c.reshape(-1),
        psum=torch.stack([px_c, py_c, pz_c], dim=-1).reshape(-1, 3),
        ppsum=torch.stack([xx_c, xy_c, xz_c, yy_c, yz_c, zz_c], dim=-1).reshape(-1, 6),
        wsum=ws_c.reshape(-1),
        dims=(d0 // 2, d1 // 2, d2 // 2),
        resolution=r * 2.0,
    )


def recenter_ndt_sums(sums: NDTMapSums, new_origin) -> NDTMapSums:
    """Shift the window to a new lattice-multiple origin: new[i] =
    old[i + shift], cells that leave the window are dropped and new cells
    are zero. The shift is computed on the host (the origin lives there)."""
    dims = sums.dims
    new_origin = _host_origin(new_origin)
    shift = np.round((new_origin.numpy() - sums.origin.numpy()) / _f32(sums.resolution)).astype(np.int64)
    dst = tuple(slice(max(-int(s), 0), d - max(int(s), 0)) for s, d in zip(shift, dims))
    src = tuple(slice(max(int(s), 0), d + min(int(s), 0)) for s, d in zip(shift, dims))

    def shift_dense(a):
        g = a.reshape(dims[0], dims[1], dims[2], -1)
        out = torch.zeros_like(g)
        if all(sl.stop > sl.start for sl in dst):
            out[dst] = g[src]
        return out.reshape(a.shape)

    return dataclasses.replace(
        sums,
        origin=new_origin,
        count=shift_dense(sums.count),
        psum=shift_dense(sums.psum),
        ppsum=shift_dense(sums.ppsum),
        wsum=shift_dense(sums.wsum),
    )


def _cov_from_moments(rel, pp, n):
    """Sample covariance (VoxelGrid.cpp:292-295) from corner-relative mean
    `rel` [R, 3] and mean outer products `pp` [R, 6]."""
    cov = torch.stack(
        [
            pp[:, 0] - rel[:, 0] * rel[:, 0],
            pp[:, 1] - rel[:, 0] * rel[:, 1],
            pp[:, 2] - rel[:, 0] * rel[:, 2],
            pp[:, 1] - rel[:, 0] * rel[:, 1],
            pp[:, 3] - rel[:, 1] * rel[:, 1],
            pp[:, 4] - rel[:, 1] * rel[:, 2],
            pp[:, 2] - rel[:, 0] * rel[:, 2],
            pp[:, 4] - rel[:, 1] * rel[:, 2],
            pp[:, 5] - rel[:, 2] * rel[:, 2],
        ],
        dim=-1,
    ).reshape(-1, 3, 3)
    return cov * ((n - 1.0) / n)[:, None, None]


def _moments_from_sums(origin, count_raw, psum, ppsum, wsum, dims, resolution: float, vid_start: int = 0):
    """Per-voxel (count, mean, cov, staticvalue) from running moment sums,
    strictly elementwise, so it runs on a voxel slab given that slab's rows
    and its first flat voxel id `vid_start` (the sharded map build,
    parallel/sharded_ndt.py). The same expressions as finalize_ndt_sums'
    compact rows, so a voxel's values do not depend on where it is computed."""
    res = float(resolution)
    dev = count_raw.device
    count = torch.clamp(count_raw, min=0.0)
    count = torch.where(count < 0.5, 0.0, count)
    n = torch.clamp(count, min=1.0)
    rel = psum / n[:, None]
    idx = vid_start + torch.arange(count.shape[0], dtype=torch.int32, device=dev)
    cz = idx % dims[2]
    cy = (idx // dims[2]) % dims[1]
    cx = idx // (dims[1] * dims[2])
    oc = _to(_origin_cells(_host_origin(origin), res), dev)
    corner = (oc[None, :] + torch.stack([cx, cy, cz], dim=-1)).to(torch.float32) * res
    return count, corner + rel, _cov_from_moments(rel, ppsum / n[:, None], n), wsum / n


def finalize_ndt_sums(sums: NDTMapSums, config: NDTConfig) -> NDTMap:
    """Condition the running sums into an NDTMap, compact-first: the dense
    work is a count clean-up, one cumsum and a searchsorted; moments,
    covariances and the eigendecomposition touch only the compact rows."""
    dims = sums.dims
    v = dims[0] * dims[1] * dims[2]
    res = float(sums.resolution)
    cap = config.max_compact_voxels
    dev = sums.count.device
    oc = _to(_origin_cells(sums.origin, res), dev)

    count = torch.clamp(sums.count, min=0.0)
    count = torch.where(count < 0.5, 0.0, count)
    n = torch.clamp(count, min=1.0)

    def corner_of(vid):
        cz = vid % dims[2]
        cy = (vid // dims[2]) % dims[1]
        cx = vid // (dims[1] * dims[2])
        return (oc[None, :] + torch.stack([cx, cy, cz], dim=-1)).to(torch.float32) * res

    if config.dense_stats:
        idx = torch.arange(v, dtype=torch.int32, device=dev)
        mean = corner_of(idx) + sums.psum / n[:, None]
        staticvalue = sums.wsum / n
    else:
        mean = torch.zeros((1, 3), dtype=torch.float32, device=dev)
        staticvalue = torch.zeros(1, dtype=torch.float32, device=dev)

    occupied = count >= float(config.min_points_per_voxel)
    # dtype: int32 cumsum would otherwise promote to int64
    csum = torch.cumsum(occupied.to(torch.int32), dim=0, dtype=torch.int32)
    pos = csum - 1
    in_cap = occupied & (pos < cap)
    index = torch.where(in_cap, pos, cap).to(torch.int32)
    # keys[j] = flat vid of the j-th occupied voxel = the first vid whose
    # inclusive cumsum reaches j + 1
    j = torch.arange(cap + 1, dtype=torch.int32, device=dev)
    total = torch.clamp(csum[-1], max=cap)
    keys = torch.searchsorted(csum, j + 1, side="left", out_int32=True)
    keys = torch.where(j < total, keys, -1)
    chas = keys >= 0
    cvid = torch.clamp(keys, min=0).long()

    c_count = torch.where(chas, count[cvid], 0.0)
    c_n = torch.clamp(c_count, min=1.0)
    c_rel = sums.psum[cvid] / c_n[:, None]
    c_cov = _cov_from_moments(c_rel, sums.ppsum[cvid] / c_n[:, None], c_n)
    c_mean = torch.where(chas[:, None], corner_of(cvid.to(torch.int32)) + c_rel, 0.0)
    c_sv = torch.where(chas, sums.wsum[cvid] / c_n, 0.0)

    c_rows, c_icov, c_valid = _condition_rows(c_count, c_mean, c_cov, c_sv, config)
    c_valid = c_valid & chas
    c_rows = torch.where(chas[:, None], c_rows, 0.0)
    c_rows[:, 10] = c_valid.to(torch.float32)
    c_rows[cap] = 0.0  # zero sentinel row (valid flag 0)
    c_icov = torch.where(c_valid[:, None, None], c_icov, 0.0)

    if config.dense_stats:
        # sentinel rows go to the extra row v, which is sliced off
        svid = torch.where(chas, cvid, v)
        icov = torch.zeros((v + 1, 3, 3), dtype=torch.float32, device=dev)
        icov[svid] = c_icov
        valid = torch.zeros(v + 1, dtype=torch.bool, device=dev)
        valid[svid] = c_valid
        icov, valid = icov[:v], valid[:v]
    else:
        icov = torch.zeros((1, 3, 3), dtype=torch.float32, device=dev)
        valid = torch.zeros(1, dtype=torch.bool, device=dev)
    assert_keys_ascend(keys)
    return NDTMap(
        origin=sums.origin,
        count=count,
        mean=mean,
        icov=icov,
        staticvalue=staticvalue,
        valid=valid,
        index=index,
        packed=c_rows.contiguous(),
        keys=keys,
        dims=dims,
        resolution=config.resolution,
    )


def build_ndt_map(cloud: PointCloud, config: NDTConfig, origin=None) -> NDTMap:
    """Scatter a target cloud into per-voxel Gaussians (empty sums + one
    scatter + finalize). Without `origin`, the grid corner is the masked
    minimum snapped to the lattice with one cell of margin."""
    res = config.resolution
    pts, mask = cloud.points, cloud.mask
    if origin is None:
        mn = torch.where(mask[:, None], pts, 1e9).amin(dim=0).cpu()
        origin = torch.floor(mn / res - 1.0) * res
    sums = empty_ndt_sums(origin, config, device=pts.device)
    sums = scatter_to_sums(sums, pts, mask, cloud.get_weights())
    return finalize_ndt_sums(sums, config)


def _pack_rows(origin, rows, dims, config: NDTConfig, icov_lower=None) -> NDTMap:
    """The NDTMap of conditioned dense rows [V, 16] (`_condition_rows` of
    every voxel): the occupied voxels (count >= min_points_per_voxel, at
    most max_compact_voxels of them) packed in ascending flat id, as
    finalize_ndt_sums packs its compact rows; a degenerate occupied voxel
    keeps its row with a 0 valid flag. With config.dense_stats the dense
    views come from the rows themselves (count, mean, staticvalue, valid and
    the icov upper triangle; `icov_lower` [V, 3] gives the (1,0), (2,0),
    (2,1) entries). The sharded map build's global step."""
    v = dims[0] * dims[1] * dims[2]
    cap = config.max_compact_voxels
    dev = rows.device
    count = rows[:, 11]
    occupied = count >= float(config.min_points_per_voxel)
    csum = torch.cumsum(occupied.to(torch.int32), dim=0, dtype=torch.int32)
    pos = csum - 1
    in_cap = occupied & (pos < cap)
    index = torch.where(in_cap, pos, cap).to(torch.int32)
    j = torch.arange(cap + 1, dtype=torch.int32, device=dev)
    keys = torch.searchsorted(csum, j + 1, side="left", out_int32=True)
    keys = torch.where(j < torch.clamp(csum[-1], max=cap), keys, -1)
    chas = keys >= 0
    packed = torch.where(chas[:, None], rows[torch.clamp(keys, min=0).long()], 0.0)
    packed[cap] = 0.0  # zero sentinel row (valid flag 0)
    if config.dense_stats:
        valid = (rows[:, 10] > 0.5) & in_cap
        u, lo = rows[:, 4:10], icov_lower
        icov = torch.stack([u[:, 0], u[:, 1], u[:, 2], lo[:, 0], u[:, 3], u[:, 4], lo[:, 1], lo[:, 2], u[:, 5]],
                           dim=-1).reshape(v, 3, 3)
        icov = torch.where(valid[:, None, None], icov, 0.0)
        mean, staticvalue = rows[:, 0:3], rows[:, 3]
    else:
        mean = torch.zeros((1, 3), dtype=torch.float32, device=dev)
        staticvalue = torch.zeros(1, dtype=torch.float32, device=dev)
        icov = torch.zeros((1, 3, 3), dtype=torch.float32, device=dev)
        valid = torch.zeros(1, dtype=torch.bool, device=dev)
    assert_keys_ascend(keys)
    return NDTMap(
        origin=_host_origin(origin), count=count, mean=mean, icov=icov, staticvalue=staticvalue, valid=valid,
        index=index, packed=packed.contiguous(), keys=keys, dims=tuple(dims), resolution=config.resolution,
    )


def _condition_rows(count, mean, cov, staticvalue, config: NDTConfig):
    """Per-voxel covariance conditioning -> (rows [R, 16], icov, valid):
    degenerate voxels (negative / zero eigenvalues) are invalid, small
    eigenvalues are inflated to 1% of the largest (VoxelGrid.cpp:303-318)."""
    r = count.shape[0]
    evals, evecs = sym_eigh3(cov)
    enough = count >= float(config.min_points_per_voxel)
    nondegen = (evals[:, 0] >= 0.0) & (evals[:, 2] > 0.0)
    min_ev = 0.01 * evals[:, 2]
    evc = torch.maximum(evals, min_ev[:, None])
    inv_ev = 1.0 / torch.clamp(evc, min=1e-12)
    scaled = evecs * inv_ev[:, None, :]
    icov = torch.sum(scaled[:, :, None, :] * evecs[:, None, :, :], dim=-1)

    valid = enough & nondegen
    icov = torch.where(valid[:, None, None], icov, 0.0)
    rows = torch.cat(
        [
            mean,
            staticvalue[:, None],
            icov[:, 0, 0:3],
            icov[:, 1, 1:3],
            icov[:, 2, 2:3],
            valid[:, None].to(torch.float32),
            count[:, None],
            torch.zeros((r, 4), dtype=torch.float32, device=count.device),
        ],
        dim=-1,
    )
    return rows, icov, valid


# ---------------------------------------------------------------------------
# align side: the ndt_newton kernel, or host-side pose coefficients, K1
# evaluations and the host Newton loop


def _pose_coefficients(pose):
    """R [3, 3], jang [3(angle), 3(row), 3(dot with x)] and hang [3, 3,
    3(component), 3(dot with x)] of the pose [6]: the rotation Rx Ry Rz
    (se3.euler_xyz_to_matrix) and the eight j_ang and fifteen h_ang vectors
    of computeAngleDerivatives (NormalDistributionsTransform.cpp:525-645),
    angles below 1e-4 snapped to exactly 0 there (cpp:528-548). The
    expressions are `ndt_newton.coefficient_terms`, the kernel's own.

    Host-side float32 numpy on purpose: it runs once per Newton evaluation
    on the host, where ~100 torch CPU scalar ops would cost more than the
    kernel itself."""
    p = np.asarray(pose, _f32).reshape(6)
    rot, snapped = [], []
    for a in p[3:6]:
        c, s = np.cos(a), np.sin(a)
        rot += [c, s]
        snapped += [_f32(1.0), _f32(0.0)] if abs(a) < _newton.ANGLE_SNAP else [c, s]
    R, J, H = _newton.coefficient_terms(rot, snapped, _f32(0.0))
    # J[(3r + a) * 3 + j] = jang[a, r, j]; H[(3k + r) * 3 + j] = hang[a_k, b_k, r, j]
    jang = np.asarray(J, _f32).reshape(3, 3, 3).transpose(1, 0, 2)
    hang = np.asarray(H, _f32).reshape(6, 3, 3)[np.asarray(_newton.PAIR_OF)]
    return np.asarray(R, _f32).reshape(3, 3), jang, hang


def _angle_jacobian_tensors(pose):
    """jang, hang of `_pose_coefficients`."""
    return _pose_coefficients(pose)[1:]


def _pose_to_matrix(pose) -> torch.Tensor:
    p = torch.as_tensor(np.asarray(pose, _f32))
    return make_pose(euler_xyz_to_matrix(p[3], p[4], p[5]), p[:3])


def _matrix_to_pose(T) -> np.ndarray:
    """(tx, ty, tz, roll, pitch, yaw) of a [4, 4] pose, host float32 (on a
    numpy array, se3.matrix_to_euler_xyz takes microseconds)."""
    if isinstance(T, torch.Tensor):
        T = T.detach().cpu().numpy()
    T = np.asarray(T, _f32)
    return np.asarray([*T[:3, 3], *matrix_to_euler_xyz(T[:3, :3])], _f32)


def _reduce(ndt_map: NDTMap, points, mask, weights, pose, config: NDTConfig, compute_hessian=True):
    """The [32] derivative sums at host pose `pose` [6], on the points' device."""
    gather = config.resolve_gather(points.device)
    d1, d2 = config.gauss_params()
    R, jang, hang = _pose_coefficients(pose)
    args = (points, mask, weights, ndt_map.index, ndt_map.packed, ndt_map.origin,
            R, np.asarray(pose, _f32)[:3], jang, hang)
    kw = dict(
        dims=ndt_map.dims, resolution=ndt_map.resolution, d1=float(_f32(d1)), d2=float(_f32(d2)),
        stencil=config.stencil, weight_derivatives=config.weight_derivatives,
    )
    if gather == "fused":
        return ndt_reduce_fused(*args, **kw)
    keys = ndt_map.keys if gather == "onehot" else None
    return ndt_reduce_plain(*args, compute_hessian=compute_hessian, chunk=config.point_chunk, keys=keys, **kw)


def ndt_derivatives(
    ndt_map: NDTMap,
    points,
    mask,
    pose,
    config: NDTConfig,
    compute_hessian: bool = True,
    weights=None,
    return_unresolved: bool = False,
):
    """Score, gradient [6] and Hessian [6, 6] of the weighted NDT objective
    at `pose` [6] (computeDerivatives, NormalDistributionsTransform.cpp:
    391-445), as host tensors (one synchronising copy of the 32 sums).
    With return_unresolved=True, appends the exactness counter (always 0)."""
    if weights is None:
        weights = torch.ones(points.shape[:-1], dtype=torch.float32, device=points.device)
    if isinstance(pose, torch.Tensor):
        pose = pose.detach().cpu().numpy()
    sums = _reduce(ndt_map, points, mask, weights, pose, config, compute_hessian)
    score, grad, hess, unresolved = (torch.as_tensor(v) for v in unpack_results(sums.cpu().numpy()))
    if not compute_hessian:
        hess = torch.zeros_like(hess)
    if return_unresolved:
        return score, grad, hess, unresolved
    return score, grad, hess


def _solve_newton(hessian, gradient) -> np.ndarray:
    """delta = -H^-1 g by the unrolled 6x6 LDL^T (`ndt_newton.ldlt_solve`,
    the operation order the kernel follows too), host float32 (the
    reference's SVD solve agrees for a nonsingular symmetric H; LDL^T also
    handles the indefinite iterations NDT produces). Near-singular pivots
    give huge or non-finite deltas, which newton_align treats as converged."""
    with np.errstate(all="ignore"):
        x = _newton.ldlt_solve(np.asarray(hessian, _f32), np.asarray(gradient, _f32), _f32(1.0))
    return np.asarray(x, _f32)


def _psi(a, phi_a, phi_0, d_phi_0, mu):
    return phi_a - phi_0 - mu * d_phi_0 * a


def _d_psi(d_phi_a, d_phi_0, mu):
    return d_phi_a - mu * d_phi_0


def _trial_value_selection(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t):
    """More-Thuente trial value selection, 4 cases (trialValueSelectionMT,
    NormalDistributionsTransform.cpp:762-838), on host float32 scalars."""
    eps = _f32(1e-12)

    def safe(v):
        return eps if abs(v) < eps else v

    with np.errstate(all="ignore"):
        dal = a_t - a_l
        sdal = safe(dal)
        z1 = _f32(3.0) * (f_t - f_l) / sdal - g_t - g_l
        w1 = np.sqrt(np.maximum(z1 * z1 - g_t * g_l, _f32(0.0)))
        a_c = a_l + dal * (w1 - g_l - z1) / safe(g_t - g_l + _f32(2.0) * w1)
        a_q = a_l - _f32(0.5) * dal * g_l / safe(g_l - (f_l - f_t) / sdal)
        a_s = a_l - dal / safe(g_l - g_t) * g_l
        if f_t > f_l:
            return a_c if abs(a_c - a_l) < abs(a_q - a_l) else _f32(0.5) * (a_q + a_c)
        if g_t * g_l < 0.0:
            return a_c if abs(a_c - a_t) >= abs(a_s - a_t) else a_s
        if abs(g_t) <= abs(g_l):
            a_t_next = a_c if abs(a_c - a_t) < abs(a_s - a_t) else a_s
            bound = a_t + _f32(0.66) * (a_u - a_t)
            return np.minimum(bound, a_t_next) if a_t > a_l else np.maximum(bound, a_t_next)
        dau = a_t - a_u
        sdau = safe(dau)
        z4 = _f32(3.0) * (f_t - f_u) / sdau - g_t - g_u
        w4 = np.sqrt(np.maximum(z4 * z4 - g_t * g_u, _f32(0.0)))
        return a_u + dau * (w4 - g_u - z4) / safe(g_t - g_u + _f32(2.0) * w4)


def _update_interval(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t):
    """updateIntervalMT (cpp:841-874): new bounds + converged flag."""
    if f_t > f_l:
        return a_l, f_l, g_l, a_t, f_t, g_t, False
    if g_t * (a_l - a_t) > 0.0:
        return a_t, f_t, g_t, a_u, f_u, g_u, False
    if g_t * (a_l - a_t) < 0.0:
        return a_t, f_t, g_t, a_l, f_l, g_l, False
    return a_t, f_t, g_t, a_u, f_u, g_u, True


def _solve_damped(hess_l, grad_l, lam):
    """The LM step of L = -score: (H_L + lam diag(max(|diag H_L|, 1e-6)))
    delta = -g_L, host float32, and whether it failed (a non-finite step,
    or a singular system, is replaced by 0). `solve_ex` reports a singular
    system in `info` instead of raising."""
    H = torch.as_tensor(np.asarray(hess_l, _f32))
    g = torch.as_tensor(np.asarray(grad_l, _f32))
    damp = torch.diag(torch.clamp(torch.abs(torch.diag(H)), min=1e-6) * float(lam))
    delta, info = torch.linalg.solve_ex(H + damp, -g)
    delta = delta.numpy()
    bad = bool(info != 0) or not np.all(np.isfinite(delta))
    return (np.zeros(6, _f32) if bad else delta.astype(_f32)), bad


def lm_align(derivs, init_pose, config: NDTConfig, n_valid_points) -> NDTResult:
    """Levenberg-Marquardt on L(p) = -score, the host loop form of the JAX
    package's lm_align: a full damped-Newton trial step per iteration, one
    derivative evaluation at the trial pose (accepted if its score rises,
    lambda / 3 down to 1e-7; rejected otherwise, lambda * 9), until a small
    accepted step at small lambda, max_iter iterations or lambda reaching
    1e6. With the fused gather on the card each evaluation is one K1 launch
    and one copy of its 32 sums. `derivs` as for newton_align."""
    lam_max = _f32(1e6)
    p = _matrix_to_pose(init_pose)
    score, grad, hess, unres = derivs(p, True)
    lam = _f32(1e-4)
    it, converged = 0, False
    while not converged and it < config.max_iter and lam < lam_max:
        delta, bad = _solve_damped(-hess, -grad, lam)
        p_t = (p + delta).astype(_f32)
        s_t, g_t, h_t, u_t = derivs(p_t, True)
        accept = bool(np.isfinite(s_t)) and s_t > score and not bad
        if accept:
            p, score, grad, hess = p_t, s_t, g_t, h_t
        # converged only when the undamped model agrees: small step at small
        # lambda (a high-lambda tiny step is the damping, not the optimum)
        converged = accept and np.linalg.norm(delta) < _f32(config.trans_eps) and lam <= _f32(1e-2)
        lam = np.maximum(lam / _f32(3.0), _f32(1e-7)) if accept else lam * _f32(9.0)
        unres = max(unres, u_t)
        it += 1

    n_valid = torch.clamp(torch.as_tensor(n_valid_points).to(torch.float32), min=1.0)
    return NDTResult(
        pose=_pose_to_matrix(p),
        trans_probability=float(score) / n_valid,
        score=float(score),
        iterations=it,
        converged=bool(converged),
        gradient=torch.as_tensor(grad),
        hessian=torch.as_tensor(hess),
        unresolved=float(unres),
    )


def newton_align(derivs, init_pose, config: NDTConfig, n_valid_points) -> NDTResult:
    """Clamped-Newton iteration over p = (t, roll, pitch, yaw) with the
    (optionally zero-iteration) More-Thuente step-length rule — the host
    loop form of the JAX package's newton_align (computeTransformation,
    NormalDistributionsTransform.cpp:310-389). With solver="lm" it
    dispatches to lm_align (same interface), as the JAX package does.

    `derivs(pose6, need_hessian) -> (score, grad [6], hess [6, 6],
    unresolved)` returns host float32 values; each call is one device
    evaluation plus one synchronising copy.
    """
    if config.solver == "lm":
        return lm_align(derivs, init_pose, config, n_valid_points)
    mu = _f32(1.0e-4)
    nu = _f32(0.9)
    step_min = _f32(config.trans_eps / 2.0)
    step_max = _f32(config.step_size)
    trans_eps = _f32(config.trans_eps)

    p = _matrix_to_pose(init_pose)
    score, grad, hess, unres = derivs(p, True)

    def line_search(p, direction, step_init, score, grad):
        phi_0 = -score
        d_phi_0 = -np.dot(grad, direction)
        if d_phi_0 > 0.0:  # not a descent direction: flip it
            direction = -direction
            d_phi_0 = -d_phi_0
        a_t = np.clip(step_init, step_min, step_max)

        if config.max_step_iterations > 0:

            def eval_phi(a):
                s, g, _, _ = derivs(p + a * direction, False)
                return -s, -np.dot(g, direction)

            phi_t, d_phi_t = eval_phi(a_t)
            psi_t = _psi(a_t, phi_t, phi_0, d_phi_0, mu)
            d_psi_t = _d_psi(d_phi_t, d_phi_0, mu)
            f_l = _psi(_f32(0.0), phi_0, phi_0, d_phi_0, mu)
            g_l = _d_psi(d_phi_0, d_phi_0, mu)
            a_l, a_u, f_u, g_u = _f32(0.0), _f32(0.0), f_l, g_l
            open_i, conv, it = True, False, 0
            while (
                not conv
                and it < config.max_step_iterations
                and not (psi_t <= 0.0 and d_phi_t <= -nu * d_phi_0)
            ):
                f_t = psi_t if open_i else phi_t
                g_t = d_psi_t if open_i else d_phi_t
                a_new = _trial_value_selection(a_l, f_l, g_l, a_u, f_u, g_u, a_t, f_t, g_t)
                a_new = np.clip(a_new, step_min, step_max)
                phi_t, d_phi_t = eval_phi(a_new)
                psi_t = _psi(a_new, phi_t, phi_0, d_phi_0, mu)
                d_psi_t = _d_psi(d_phi_t, d_phi_0, mu)
                if open_i and psi_t <= 0.0 and d_psi_t >= 0.0:
                    f_l = f_l + (phi_0 - mu * d_phi_0 * a_l)
                    g_l = g_l + mu * d_phi_0
                    f_u = f_u + (phi_0 - mu * d_phi_0 * a_u)
                    g_u = g_u + mu * d_phi_0
                    open_i = False
                f_sel = psi_t if open_i else phi_t
                g_sel = d_psi_t if open_i else d_phi_t
                a_l, f_l, g_l, a_u, f_u, g_u, conv = _update_interval(
                    a_l, f_l, g_l, a_u, f_u, g_u, a_new, f_sel, g_sel
                )
                a_t = a_new
                it += 1

        p_new = (p + a_t * direction).astype(_f32)
        s, g, h, u = derivs(p_new, True)
        return a_t, p_new, s, g, h, u

    it = 0
    converged = False
    while not converged and it <= config.max_iter:
        delta = _solve_newton(hess, grad)
        dnorm = np.linalg.norm(delta)
        if dnorm == 0.0 or not np.isfinite(dnorm):
            # degenerate step (e.g. the all-zero Hessian of an empty map):
            # keep the pose, stop
            converged = True
        else:
            alpha, p_new, s, g, h, u = line_search(p, delta / dnorm, dnorm, score, grad)
            converged = it >= 1 and abs(alpha) < trans_eps
            if config.score_rel_tol > 0:
                plateau = it >= 3 and abs(s - score) < config.score_rel_tol * max(abs(score), 1e-6)
                converged = converged or plateau
            p, score, grad, hess = p_new, s, g, h
            unres = max(unres, u)
        it += 1

    n_valid = torch.clamp(torch.as_tensor(n_valid_points).to(torch.float32), min=1.0)
    return NDTResult(
        pose=_pose_to_matrix(p),
        trans_probability=float(score) / n_valid,
        score=float(score),
        iterations=it,
        converged=bool(converged),
        gradient=torch.as_tensor(grad),
        hessian=torch.as_tensor(hess),
        unresolved=float(unres),
    )


def ndt_align(
    ndt_map: NDTMap,
    source: PointCloud,
    init_pose,
    config: NDTConfig = NDTConfig(),
) -> NDTResult:
    """Align a source cloud to the NDT map starting from init_pose [4, 4].

    With the fused gather, solver="newton" and max_step_iterations == 0 the
    whole alignment is one `ndt_newton` call on the source's device (the
    kernel on CUDA tensors, its plain version on CPU tensors) and one copy
    of its result to the host; otherwise the host loop runs. Neither needs
    the points sorted (the JAX package's sort_points_by_vid)."""
    if not takes_newton_kernel(config, source.points.device):
        return ndt_align_host_loop(ndt_map, source, init_pose, config)
    return newton_result(ndt_newton_align(ndt_map, source, init_pose, config).cpu().numpy())


def takes_newton_kernel(config: NDTConfig, device) -> bool:
    """Whether `ndt_align` runs as one `ndt_newton` call on `device`: the
    fused gather, the Newton solver and no line-search iterations. Every
    other configuration (solver="lm" among them) takes the host loop."""
    return (
        config.resolve_gather(device) == "fused"
        and config.solver == "newton"
        and config.max_step_iterations == 0
    )


def ndt_newton_align(ndt_map: NDTMap, source: PointCloud, init_pose, config: NDTConfig) -> torch.Tensor:
    """The alignment of `ndt_align` for a configuration that takes the
    kernel: one `ndt_newton` call, whose [NOUT] result stays on the source's
    device (no host read; `newton_result` unpacks a host copy)."""
    pts = source.points
    d1, d2 = config.gauss_params()
    pose0 = torch.from_numpy(_matrix_to_pose(init_pose)).to(pts.device, non_blocking=True)
    return _newton.ndt_newton(
        pts, source.mask, source.get_weights(), ndt_map.index, ndt_map.packed, ndt_map.origin, pose0,
        dims=ndt_map.dims, resolution=ndt_map.resolution, d1=float(_f32(d1)), d2=float(_f32(d2)),
        stencil=config.stencil, weight_derivatives=config.weight_derivatives, max_iter=config.max_iter,
        trans_eps=config.trans_eps, step_size=config.step_size, score_rel_tol=config.score_rel_tol,
    )


def newton_pose(out) -> torch.Tensor:
    """The [4, 4] pose of an `ndt_newton` result on its device: the kernel's
    final rotation and translation."""
    T = torch.eye(4, dtype=torch.float32, device=out.device)
    T[:3, :3] = out[_newton.ROTATION].reshape(3, 3)
    T[:3, 3] = out[_newton.POSE][:3]
    return T


def newton_result(out: np.ndarray) -> NDTResult:
    """The NDTResult of a host copy of an `ndt_newton` result."""
    score, grad, hess, _ = unpack_results(np.concatenate([out[_newton.SCORE:_newton.HESS.stop], [0.0]]))
    pose = np.eye(4, dtype=_f32)
    pose[:3, :3] = out[_newton.ROTATION].reshape(3, 3)
    pose[:3, 3] = out[_newton.POSE][:3]
    return NDTResult(
        pose=torch.from_numpy(pose),
        trans_probability=torch.as_tensor(score / max(out[_newton.N_VALID], _f32(1.0))),
        score=float(score),
        iterations=int(out[_newton.ITERATIONS]),
        converged=bool(out[_newton.CONVERGED]),
        gradient=torch.as_tensor(grad),
        hessian=torch.as_tensor(hess),
        unresolved=float(out[_newton.UNRESOLVED]),
    )


def ndt_align_host_loop(
    ndt_map: NDTMap,
    source: PointCloud,
    init_pose,
    config: NDTConfig = NDTConfig(),
) -> NDTResult:
    """`ndt_align` with the Newton loop on the host: each derivative
    evaluation is one reduction on the source's device and one copy of its
    32 sums to the host."""
    pts, mask, w = source.points, source.mask, source.get_weights()

    def derivs(pose, need_hessian):
        sums = _reduce(ndt_map, pts, mask, w, pose, config, need_hessian)
        return unpack_results(sums.cpu().numpy())

    return newton_align(derivs, init_pose, config, source.num_valid())


def sort_points_by_vid(ndt_map: NDTMap, pts, mask, w, init_pose):
    """Points, mask and weights reordered by each point's voxel id under
    `init_pose` [4, 4] (masked points last), stably: the JAX package sorts
    so that its TPU kernel's tiles are spatially coherent. The port's
    kernels gather directly and need no order; ndt_align and the sharded
    paths do not sort."""
    dev = pts.device
    T0 = _to(np.array(init_pose, _f32), dev)
    xp0 = pts @ T0[:3, :3].T + T0[:3, 3]
    cell0 = torch.floor((xp0 - _to(ndt_map.origin, dev)) / ndt_map.resolution).to(torch.int32)
    hi = _to(np.asarray(ndt_map.dims, np.int32) - 1, dev)
    cell0 = torch.minimum(torch.clamp(cell0, min=0), hi)
    vid0 = torch.where(mask, _flat_vid(cell0, ndt_map.dims), 2**30)
    order = torch.sort(vid0, stable=True).indices
    return pts[order], mask[order], w[order]


def ndt_fitness_score(ndt_map: NDTMap, source: PointCloud, pose, config: NDTConfig, max_range: float = 4.0):
    """Mean distance from the transformed source points to the nearest
    occupied voxel centroid (getFitnessScore, NormalDistributionsTransform.
    cpp:940-965; nearest-voxel search VoxelGrid.cpp:483-543), a scalar
    tensor on the source's device (inf when no point has a centroid within
    max_range). The stencil covers ceil(max_range / resolution) cells per
    axis, at most 8 (17^3 offsets), over chunks of points sized as the JAX
    package sizes them. Reads the map's dense `count` and `mean`: a map
    built with dense_stats=False has no dense means and raises."""
    dims = ndt_map.dims
    v = dims[0] * dims[1] * dims[2]
    if ndt_map.mean.shape[0] != v:
        raise ValueError(
            "ndt_fitness_score reads the map's dense voxel means: build the map with dense_stats=True"
        )
    dev = source.points.device
    res = ndt_map.resolution
    r_cells = max(1, min(8, int(math.ceil(max_range / config.resolution))))
    ax = torch.arange(-r_cells, r_cells + 1, dtype=torch.int32)
    stencil = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1).reshape(-1, 3).to(dev)
    dims_t = _to(np.asarray(dims, np.int32), dev)
    origin = _to(ndt_map.origin, dev)

    T = _to(pose, dev).to(torch.float32)
    xp = source.points @ T[:3, :3].T + T[:3, 3]
    chunk = int(max(512, min(4096, (1 << 22) // int(stencil.shape[0]))))
    sums, counts = [], []
    for s in range(0, xp.shape[0], chunk):
        x, m = xp[s:s + chunk], source.mask[s:s + chunk]
        cell = torch.floor((x - origin) / res).to(torch.int32)
        cand = cell[:, None, :] + stencil[None, :, :]
        inb = torch.all((cand >= 0) & (cand < dims_t), dim=-1)
        vid = torch.where(inb, _flat_vid(cand.long(), dims), 0)
        occupied = (ndt_map.count[vid] > 0) & inb
        d = torch.sqrt(torch.sum((x[:, None, :] - ndt_map.mean[vid]) ** 2, dim=-1))
        dmin = torch.amin(torch.where(occupied, d, torch.inf), dim=-1)
        use = m & (dmin < max_range)
        sums.append(torch.sum(torch.where(use, dmin, 0.0)))
        counts.append(torch.sum(use.to(torch.float32)))
    total = torch.sum(torch.stack(counts))
    return torch.where(total > 0, torch.sum(torch.stack(sums)) / torch.clamp(total, min=1.0), torch.inf)

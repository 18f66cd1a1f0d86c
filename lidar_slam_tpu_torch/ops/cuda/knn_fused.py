"""K2: exact gated k-NN over a bucket grid, neighbour features returned.

`window_knn` replaces the Pallas TPU kernel
`lidar_slam_tpu/ops/pallas/knn_fused.py::window_knn` with the hand-written
Hopper kernel `csrc/knn_fused.cu`: one launch that reads the grid's own
arrays (sorted points, `point_idx`, the CSR `cell_starts` / `cell_counts`)
and the caller's `extras`, and writes the result tensors. A query is served
by a group of `lanes` threads that walks its 3x3x3 cell stencil; the source
says what bounds it. On a CUDA tensor the wrapper launches that kernel or
raises; on a CPU tensor, and only there, it runs `knn_exact_plain`, the
plain PyTorch version: the stencil gather of `ops/hashgrid.py::knn_query`
without its `bucket_k` cut.

Both select, for each valid query, the k smallest of (d2, sorted-row
index) among the grid's valid points with d2 <= max_radius**2 (float32),
d2 being (dx*dx + dy*dy) + dz*dz. They return the JAX function's dict:
idx (int32), dist, ok, pts, extras ([Q, k, E] float32, when given) and
unresolved, which is always 0: the stencil covers every in-gate neighbour
when cell_size >= max_radius, which both paths require.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..hashgrid import BucketGrid, _flat_cell_id, clip_to_grid, in_bounds, sq_dist, stencil_offsets
from . import build

KS = (5, 8)  # the k the kernel compiles in (csrc/knn_fused.cu)
LANES = (16, 32)  # the lanes per query it compiles in (PERF.md, K2's lane sweep)
EXTRA_DTYPES = (torch.int32, torch.float32)  # extras are read in the caller's dtype

# Kernel launches since the last reset. Incremented only where the CUDA
# kernel is launched, never on the plain path.
launches = 0


class _Params(ctypes.Structure):
    """ctypes mirror of `KnnParams` in csrc/knn_fused.cu."""

    _fields_ = [
        ("cell_size", ctypes.c_float),
        ("r2", ctypes.c_float),
        ("dims", ctypes.c_int * 3),
        ("nq", ctypes.c_int),
        ("n_extra", ctypes.c_int),
        ("extras_int", ctypes.c_int),
    ]


def default_lanes(cell_size: float) -> int:
    """Lanes per query, from what the host knows (no sync): a warp where a
    cell holds hundreds of points (odometry's 5 m cells of raw features),
    16 on 1 m cells of a voxel-downsampled map (mapping's, a few to ~20 rows
    a stencil column). PERF.md, K2's lane sweep on an H100, has the times
    behind the rule."""
    return 32 if cell_size >= 2.5 else 16


def _gate_r2(grid: BucketGrid, max_radius) -> float:
    if grid.cell_size < float(np.float32(max_radius)):
        raise ValueError(
            f"cell_size {grid.cell_size} < max_radius {max_radius}: the 3x3x3 stencil "
            "would not cover every in-gate neighbour"
        )
    return float(np.float32(float(max_radius) ** 2))


def _extras_2d(grid: BucketGrid, extras):
    """`extras` ([N] or [N, E], original order) as [N, E]; checks its dtype
    and length."""
    if extras is None:
        return None
    if extras.dtype not in EXTRA_DTYPES:
        raise ValueError(f"extras has dtype {extras.dtype}, expected one of {EXTRA_DTYPES}")
    ex = extras[:, None] if extras.ndim == 1 else extras
    if ex.ndim != 2 or ex.shape[0] != grid.points.shape[0]:
        raise ValueError(f"extras has shape {tuple(extras.shape)}, expected [{grid.points.shape[0]}] or [N, E]")
    return ex


def _select_plain(grid: BucketGrid, queries, query_mask, k: int, r2: float, chunk: int = 256):
    """Plain selection: (d2 [Q, k], +inf where no neighbour; sorted row
    [Q, k] int64). The bucket width is the largest cell count (one host
    sync, allowed in the plain version only)."""
    dev = queries.device
    dims = grid.dims
    v = dims[0] * dims[1] * dims[2]
    n_t = grid.points.shape[0]
    bucket = max(int(grid.cell_counts.max()), 1)
    offsets = stencil_offsets(dev)
    j = torch.arange(bucket, dtype=torch.int32, device=dev)

    qmask = query_mask & torch.all(torch.isfinite(queries), dim=-1)
    qsafe = torch.where(qmask[:, None], queries, 0.0)
    out_d2, out_row = [], []
    for s in range(0, queries.shape[0], chunk):
        qc, mc = qsafe[s:s + chunk], qmask[s:s + chunk]
        c = qc.shape[0]
        # the query's cell, clipped to the grid (in float: no integer overflow)
        cell = clip_to_grid(torch.floor((qc - grid.origin) / grid.cell_size), dims).to(torch.int32)
        cand = cell[:, None, :] + offsets[None, :, :]  # [C, 27, 3]
        in_b = in_bounds(cand, dims)
        flat = torch.clamp(_flat_cell_id(cand, dims), 0, v - 1).long()
        counts = torch.where(in_b & mc[:, None], grid.cell_counts[flat], 0)
        rows = torch.clamp(grid.cell_starts[flat][:, :, None] + j, 0, n_t - 1).long()  # [C, 27, B]
        # candidates come in ascending row order (stencil cells ascend in
        # flat id), so a stable sort of d2 orders by (d2, row)
        d2 = sq_dist(grid.points[rows], qc[:, None, None, :])
        ok = (j < counts[:, :, None]) & (d2 <= r2)
        d2 = torch.where(ok, d2, torch.inf).reshape(c, -1)
        top_d2, pos = torch.sort(d2, dim=-1, stable=True)
        out_d2.append(top_d2[:, :k])
        out_row.append(torch.gather(rows.reshape(c, -1), 1, pos[:, :k]))
    if not out_d2:
        return torch.zeros((0, k), device=dev), torch.zeros((0, k), dtype=torch.int64, device=dev)
    return torch.cat(out_d2), torch.cat(out_row)


def knn_exact_plain(grid: BucketGrid, queries, query_mask, k: int, max_radius: float, extras=None):
    """Plain PyTorch version of K2 (any device): `window_knn`'s dict. The
    neighbours' original indices, coordinates and extras are read through
    `point_idx` for the k winners only."""
    r2 = _gate_r2(grid, max_radius)
    ex = _extras_2d(grid, extras)
    d2, row = _select_plain(grid, queries, query_mask, k, r2)
    ok = torch.isfinite(d2)
    idx = torch.where(ok, grid.point_idx[row], 0)
    res = {
        "idx": idx,
        "dist": torch.sqrt(d2),
        "ok": ok,
        "pts": torch.where(ok[..., None], grid.points[row], 0.0),
        "unresolved": torch.zeros((), dtype=torch.float32, device=queries.device),
    }
    if ex is not None:
        res["extras"] = torch.where(ok[..., None], ex[idx.long()].to(torch.float32), 0.0)
    return res


def _library() -> ctypes.CDLL:
    lib = build.load("knn_fused")
    if lib.knn_fused_launch.argtypes is None:
        lib.knn_fused_launch.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int,
        ] + [ctypes.c_void_p] * 7
        lib.knn_fused_launch.restype = ctypes.c_int
    return lib


def window_knn(grid: BucketGrid, queries, query_mask, k: int, max_radius: float, extras=None,
               lanes: int | None = None):
    """K2 (replaces ops/pallas/knn_fused.py::window_knn): exact gated k-NN of
    `queries` [Q, 3] (`query_mask` [Q] bool) against `grid`, with each
    neighbour's coordinates and `extras` ([N] or [N, E] int32 or float32 per
    target point, in original order) returned. CUDA tensors launch the
    Hopper kernel once (no host sync, no copy); CPU tensors take the plain
    version. `lanes` per query (default `default_lanes(grid.cell_size)`)
    picks the kernel's variant; every variant returns the same result."""
    global launches
    dev = queries.device
    if dev.type == "cpu":
        return knn_exact_plain(grid, queries, query_mask, k, max_radius, extras)
    if dev.type != "cuda":
        raise ValueError(f"window_knn: unsupported device {dev}")
    if k not in KS:
        raise ValueError(f"k = {k}: the kernel is compiled for k in {KS}")
    lanes = default_lanes(grid.cell_size) if lanes is None else lanes
    if lanes not in LANES:
        raise ValueError(f"lanes = {lanes}: the kernel is compiled for {LANES}")
    r2 = _gate_r2(grid, max_radius)
    q = queries.shape[0]
    n = grid.points.shape[0]
    v = grid.dims[0] * grid.dims[1] * grid.dims[2]
    build.check_tensor("queries", queries, torch.float32, dev, (q, 3))
    build.check_tensor("query_mask", query_mask, torch.bool, dev, (q,))
    build.check_tensor("grid points", grid.points, torch.float32, dev, (n, 3))
    build.check_tensor("point_idx", grid.point_idx, torch.int32, dev, (n,))
    build.check_tensor("cell_starts", grid.cell_starts, torch.int32, dev, (v,))
    build.check_tensor("cell_counts", grid.cell_counts, torch.int32, dev, (v,))
    build.check_tensor("origin", grid.origin, torch.float32, dev, (3,))
    ex = _extras_2d(grid, extras)
    n_extra = 0
    if ex is not None:
        build.check_tensor("extras", ex, ex.dtype, dev)
        n_extra = ex.shape[1]

    res = {
        "idx": torch.empty((q, k), dtype=torch.int32, device=dev),
        "dist": torch.empty((q, k), dtype=torch.float32, device=dev),
        "ok": torch.empty((q, k), dtype=torch.bool, device=dev),
        "pts": torch.empty((q, k, 3), dtype=torch.float32, device=dev),
        "unresolved": torch.empty((), dtype=torch.float32, device=dev),
    }
    if ex is not None:
        res["extras"] = torch.empty((q, k, n_extra), dtype=torch.float32, device=dev)
    if q == 0:
        res["unresolved"].zero_()
        return res
    params = _Params(grid.cell_size, r2, (ctypes.c_int * 3)(*grid.dims), q, n_extra,
                     int(ex is not None and ex.dtype == torch.int32))
    out_ex = res["extras"].data_ptr() if ex is not None else None
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knn_fused_launch(
            grid.points.data_ptr(), grid.point_idx.data_ptr(), grid.cell_starts.data_ptr(),
            grid.cell_counts.data_ptr(), grid.origin.data_ptr(), queries.data_ptr(), query_mask.data_ptr(),
            None if ex is None else ex.data_ptr(), ctypes.byref(params), k, lanes,
            res["idx"].data_ptr(), res["dist"].data_ptr(), res["ok"].data_ptr(), res["pts"].data_ptr(),
            out_ex, res["unresolved"].data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"knn_fused kernel launch failed: cudaError {err}")
    launches += 1
    return res

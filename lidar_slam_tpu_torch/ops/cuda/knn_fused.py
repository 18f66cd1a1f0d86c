"""K2: exact gated k-NN over a bucket grid, neighbour features returned.

`window_knn` replaces the Pallas TPU kernel
`lidar_slam_tpu/ops/pallas/knn_fused.py::window_knn` with the hand-written
Hopper kernel `csrc/knn_fused.cu` (each query walks its 3x3x3 cell stencil
through the grid's CSR arrays; the source says what bounds it). On a CUDA
tensor it launches that kernel or raises; on a CPU tensor, and only there,
it runs `knn_exact_plain`, the plain PyTorch version: the stencil gather of
`ops/hashgrid.py::knn_query` without its `bucket_k` cut.

Both select, for each valid query, the k smallest of (d2, sorted-row
index) among the grid's valid points with d2 <= max_radius**2 (float32),
d2 being (dx*dx + dy*dy) + dz*dz. They return the JAX function's dict:
idx, dist, ok, pts, extras (when given) and unresolved, which is always 0:
the stencil covers every in-gate neighbour when cell_size >= max_radius,
which both paths require.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..hashgrid import BucketGrid, _flat_cell_id, clip_to_grid, in_bounds, sq_dist, stencil_offsets
from . import build

FEATURES = 8  # feature-table row: x, y, z, valid, original index, extras (<= 3), pad
KS = (5, 8)  # the k the kernel compiles in (csrc/knn_fused.cu)

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
    ]


def _gate_r2(grid: BucketGrid, max_radius) -> float:
    if grid.cell_size < float(np.float32(max_radius)):
        raise ValueError(
            f"cell_size {grid.cell_size} < max_radius {max_radius}: the 3x3x3 stencil "
            "would not cover every in-gate neighbour"
        )
    return float(np.float32(float(max_radius) ** 2))


def feature_table(grid: BucketGrid, extras=None):
    """The [N, 8] float32 feature rows in sorted-row order, and the number
    of extra columns (`extras` [N] or [N, E], E <= 3, in original order)."""
    cols = [
        grid.points,
        grid.valid[:, None].to(torch.float32),
        grid.point_idx[:, None].to(torch.float32),
    ]
    n_extra = 0
    if extras is not None:
        ex = extras.to(torch.float32)
        if ex.ndim == 1:
            ex = ex[:, None]
        n_extra = ex.shape[1]
        if n_extra > FEATURES - 5:
            raise ValueError(f"at most {FEATURES - 5} extra columns, got {n_extra}")
        cols.append(ex[grid.point_idx.long()])
    pad = FEATURES - 5 - n_extra
    if pad:
        cols.append(grid.points.new_zeros((grid.points.shape[0], pad)))
    return torch.cat(cols, dim=1).contiguous(), n_extra


def _unpack(out, n_extra: int, with_extras: bool):
    """[Q, k, 9] rows (features, d2; d2 = inf where no neighbour) -> dict."""
    d2 = out[..., FEATURES]
    ok = torch.isfinite(d2)
    res = {
        "idx": torch.where(ok, out[..., 4].to(torch.int32), 0),
        "dist": torch.sqrt(d2),
        "ok": ok,
        "pts": out[..., 0:3],
        "unresolved": torch.zeros((), dtype=torch.float32, device=out.device),
    }
    if with_extras:
        res["extras"] = out[..., 5:5 + n_extra]
    return res


def _select_plain(grid: BucketGrid, table, queries, query_mask, k: int, r2: float, chunk: int = 256):
    """Plain selection: [Q, k, 9] rows. The bucket width is the largest
    cell count (one host sync, allowed in the plain version only)."""
    dev = queries.device
    dims = grid.dims
    v = dims[0] * dims[1] * dims[2]
    n_t = table.shape[0]
    bucket = max(int(grid.cell_counts.max()), 1)
    offsets = stencil_offsets(dev)
    j = torch.arange(bucket, dtype=torch.int32, device=dev)

    qmask = query_mask & torch.all(torch.isfinite(queries), dim=-1)
    qsafe = torch.where(qmask[:, None], queries, 0.0)
    out = []
    for s in range(0, queries.shape[0], chunk):
        qc, mc = qsafe[s:s + chunk], qmask[s:s + chunk]
        c = qc.shape[0]
        # the query's cell, clipped to the grid (in float: no integer overflow)
        cell = clip_to_grid(torch.floor((qc - grid.origin) / grid.cell_size), dims).to(torch.int32)
        cand = cell[:, None, :] + offsets[None, :, :]  # [C, 27, 3]
        in_b = in_bounds(cand, dims)
        flat = torch.clamp(_flat_cell_id(cand, dims), 0, v - 1).long()
        counts = torch.where(in_b & mc[:, None], grid.cell_counts[flat], 0)
        rows = torch.clamp(grid.cell_starts[flat][:, :, None] + j, 0, n_t - 1)  # [C, 27, B]
        # candidates come in ascending row order (stencil cells ascend in
        # flat id), so a stable sort of d2 orders by (d2, row)
        d2 = sq_dist(table[rows.long(), 0:3], qc[:, None, None, :])
        ok = (j < counts[:, :, None]) & (d2 <= r2)
        d2 = torch.where(ok, d2, torch.inf).reshape(c, -1)
        top_d2, pos = torch.sort(d2, dim=-1, stable=True)
        top_d2 = top_d2[:, :k]
        row = torch.gather(rows.reshape(c, -1), 1, pos[:, :k]).long()
        found = torch.isfinite(top_d2)
        feats = torch.where(found[..., None], table[row], 0.0)
        out.append(torch.cat([feats, top_d2[..., None]], dim=-1))
    if not out:
        return table.new_zeros((0, k, FEATURES + 1))
    return torch.cat(out)


def knn_exact_plain(grid: BucketGrid, queries, query_mask, k: int, max_radius: float, extras=None):
    """Plain PyTorch version of K2 (any device): `window_knn`'s dict."""
    r2 = _gate_r2(grid, max_radius)
    table, n_extra = feature_table(grid, extras)
    return _unpack(_select_plain(grid, table, queries, query_mask, k, r2), n_extra, extras is not None)


def _library() -> ctypes.CDLL:
    lib = build.load("knn_fused")
    if lib.knn_fused_launch.argtypes is None:
        lib.knn_fused_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.knn_fused_launch.restype = ctypes.c_int
    return lib


def window_knn(grid: BucketGrid, queries, query_mask, k: int, max_radius: float, extras=None):
    """K2 (replaces ops/pallas/knn_fused.py::window_knn): exact gated k-NN of
    `queries` [Q, 3] (`query_mask` [Q] bool) against `grid`, with each
    neighbour's coordinates and `extras` ([N] or [N, E] per target point,
    in original order) returned. CUDA tensors launch the Hopper kernel;
    CPU tensors take the plain version."""
    global launches
    dev = queries.device
    if dev.type == "cpu":
        return knn_exact_plain(grid, queries, query_mask, k, max_radius, extras)
    if dev.type != "cuda":
        raise ValueError(f"window_knn: unsupported device {dev}")
    if k not in KS:
        raise ValueError(f"k = {k}: the kernel is compiled for k in {KS}")
    r2 = _gate_r2(grid, max_radius)
    q = queries.shape[0]
    v = grid.dims[0] * grid.dims[1] * grid.dims[2]
    build.check_tensor("queries", queries, torch.float32, dev, (q, 3))
    build.check_tensor("query_mask", query_mask, torch.bool, dev, (q,))
    build.check_tensor("cell_starts", grid.cell_starts, torch.int32, dev, (v,))
    build.check_tensor("cell_counts", grid.cell_counts, torch.int32, dev, (v,))
    build.check_tensor("origin", grid.origin, torch.float32, dev, (3,))
    build.check_tensor("grid points", grid.points, torch.float32, dev)
    if extras is not None:
        build.check_tensor("extras", extras, extras.dtype, dev)
    table, n_extra = feature_table(grid, extras)
    if table.data_ptr() % 16:
        raise ValueError("the feature table must be 16-byte aligned")

    out = torch.empty((q, k, FEATURES + 1), dtype=torch.float32, device=dev)
    if q == 0:
        return _unpack(out, n_extra, extras is not None)
    params = _Params(grid.cell_size, r2, (ctypes.c_int * 3)(*grid.dims), q)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knn_fused_launch(
            table.data_ptr(), grid.cell_starts.data_ptr(), grid.cell_counts.data_ptr(),
            grid.origin.data_ptr(), queries.data_ptr(), query_mask.data_ptr(), ctypes.byref(params),
            k, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"knn_fused kernel launch failed: cudaError {err}")
    launches += 1
    return _unpack(out, n_extra, extras is not None)

"""The work one `window_knn` launch (kernel K2) needs, for its roofline.

A frozen copy of the program's own count (chip_smoke.py's `knn_work`), so
that a later edit to the program does not move the yardstick, written so
that it issues device work only and never waits on the card: the queries
read once (xyz and mask), the cell ranges (start, count) of the distinct
stencil cells the valid queries touch, 12 B of xyz for each row of those
cells, the original index and extras of the neighbours found, the outputs
(idx, dist, ok, pts, extras) written once; and 8 fp32 FLOPs a candidate
row of a query's stencil ((dx*dx + dy*dy) + dz*dz). The least time is
`roofline.bound` of the two, on the peaks of roofline.py.
"""

from __future__ import annotations

import torch

FLOPS_CANDIDATE = 8  # d2 = (dx*dx + dy*dy) + dz*dz: 3 sub, 3 mul, 2 add
STENCIL = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


def work(grid, queries, query_mask, k: int, n_extra: int, found) -> torch.Tensor:
    """(bytes, FLOPs) of one launch on `grid` (the bucket grid's
    `cell_counts`, `origin`, `cell_size`, `dims`) for `queries` [Q, 3],
    `query_mask` [Q], `k` neighbours with `n_extra` extra columns each, and
    the launch's `found` [Q, k] (its result's `ok`): an int64 [2] tensor on
    the queries' device, computed without a host sync."""
    dev = queries.device
    dims = tuple(int(d) for d in grid.dims)
    v = dims[0] * dims[1] * dims[2]
    ok = query_mask & torch.all(torch.isfinite(queries), dim=-1)
    q = torch.where(ok[:, None], queries, grid.origin)
    cell = torch.floor((q - grid.origin) / grid.cell_size)
    cell = torch.stack([torch.clamp(cell[:, i], 0, dims[i] - 1) for i in range(3)], dim=-1).to(torch.int64)
    cand = cell[:, None, :] + torch.tensor(STENCIL, dtype=torch.int64, device=dev)[None]
    inside = ok[:, None] & torch.all(cand >= 0, dim=-1) & (cand[..., 0] < dims[0]) & (cand[..., 1] < dims[1]) & (
        cand[..., 2] < dims[2])
    flat = torch.where(inside, (cand[..., 0] * dims[1] + cand[..., 1]) * dims[2] + cand[..., 2], v)
    counts = torch.cat([grid.cell_counts.to(torch.int64), torch.zeros(1, dtype=torch.int64, device=dev)])
    touched = torch.zeros(v + 1, dtype=torch.bool, device=dev)
    touched[flat.reshape(-1)] = True
    touched[v] = False
    nq = queries.shape[0]
    n_found = found.sum(dtype=torch.int64)
    n_bytes = (nq * 13 + touched.sum(dtype=torch.int64) * 8 + (counts * touched).sum() * 12
               + n_found * (4 + 4 * n_extra) + nq * k * (21 + 4 * n_extra))
    flops = counts[flat].sum() * FLOPS_CANDIDATE
    return torch.stack([n_bytes, flops])

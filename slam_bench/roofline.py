"""The yardstick's peaks and the work an NDT alignment needs.

Peaks of one H100 SXM from NVIDIA's data sheet, at its 700 W limit: HBM
bytes/s and fp32 FLOP/s outside the tensor cores. `ndt_work` counts what
one `ndt_newton` launch needs on its own inputs, as the program's bench
counts an NDT evaluation (a frozen copy, so that a later edit to the
program does not move the yardstick): each source row read once, each
index word and stats row touched once, the pose and the result once, and
per evaluation 24 FLOPs a valid point, 37 a (point, valid voxel) pair, 5
more for the radius27 gate and 413 for an accepted pair. The pairs are
counted at the launch's final pose for each of its evaluations (the
iterations it reports, plus the one at the start), and the rows it touches
there, so a launch's work is never counted above what it needed.
"""

from __future__ import annotations

import numpy as np
import torch

PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
FLOPS_POINT, FLOPS_VALID, FLOPS_GATE, FLOPS_ACCEPTED = 24, 37, 5, 413

# the kernel's result layout (ops/cuda/ndt_newton.py): translation, iterations, row-major rotation
_T, _ITER, _ROT = slice(0, 3), 34, slice(38, 47)
STENCIL_OFFSETS = {
    "direct7": np.asarray([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.int32),
    "radius27": np.stack([g.ravel() for g in np.meshgrid(*(np.arange(-1, 2),) * 3, indexing="ij")],
                         axis=-1).astype(np.int32),
}


def bound(n_bytes: float, flops: float) -> tuple:
    """(least seconds, what sets it): the larger of bytes over the HBM rate
    and fp32 FLOPs over the fp32 peak."""
    b, f = n_bytes / PEAK_BYTES, flops / PEAK_FP32
    return (b, "bytes") if b >= f else (f, "operations")


def ndt_work(call: dict) -> tuple:
    """(bytes, FLOPs) of one recorded `ndt_newton` launch: its points, mask,
    index, packed stats, origin, dims, resolution, d2, stencil and result."""
    out = call["out"].detach().to("cpu", torch.float64)
    dev = call["points"].device
    R = out[_ROT].reshape(3, 3).to(dev, torch.float32)
    t = out[_T].to(dev, torch.float32)
    evaluations = int(out[_ITER]) + 1
    res = float(call["resolution"])
    dims = torch.as_tensor(call["dims"], device=dev)
    valid = call["mask"] & torch.all(torch.isfinite(call["points"]), dim=-1)
    x = call["points"][valid]
    offsets = torch.as_tensor(STENCIL_OFFSETS[call["stencil"]], device=dev)
    origin = torch.as_tensor(np.asarray(call["origin"].cpu() if torch.is_tensor(call["origin"]) else call["origin"],
                                        np.float32), device=dev).reshape(3)
    xp = x @ R.T + t
    cell = torch.floor((xp - origin) / res).to(torch.int64)
    cand = torch.minimum(torch.maximum(cell, torch.full_like(cell, -2)), dims + 1)[:, None] + offsets
    inb = torch.all((cand >= 0) & (cand < dims), dim=-1)
    vid = ((cand[..., 0] * int(dims[1]) + cand[..., 1]) * int(dims[2]) + cand[..., 2])[inb]
    row = call["index"][vid].long()
    pk = call["packed"][row]
    on_valid = pk[:, 10] > 0.5
    e = xp[:, None, :].expand(-1, offsets.shape[0], 3)[inb] - pk[:, 0:3]
    gate = on_valid
    if call["stencil"] == "radius27":
        gate = gate & (torch.sum(e * e, dim=-1) <= res * res)
    ix = pk[:, 4:10]
    q = torch.stack([ix[:, 0] * e[:, 0] + ix[:, 1] * e[:, 1] + ix[:, 2] * e[:, 2],
                     ix[:, 1] * e[:, 0] + ix[:, 3] * e[:, 1] + ix[:, 4] * e[:, 2],
                     ix[:, 2] * e[:, 0] + ix[:, 4] * e[:, 1] + ix[:, 5] * e[:, 2]], dim=-1)
    d2 = float(np.float32(call["d2"]))
    exd = d2 * torch.exp(-0.5 * d2 * torch.sum(q * e, dim=-1))
    accepted = gate & (exd <= 1.0) & (exd >= 0.0) & torch.isfinite(exd)
    n_valid_voxel = int(on_valid.sum())
    flops = evaluations * (x.shape[0] * FLOPS_POINT + n_valid_voxel * FLOPS_VALID
                           + (n_valid_voxel * FLOPS_GATE if call["stencil"] == "radius27" else 0)
                           + int(accepted.sum()) * FLOPS_ACCEPTED)
    n_bytes = (call["mask"].numel() + int(valid.sum()) * 16 + torch.unique(vid).numel() * 4
               + torch.unique(row).numel() * 48 + (6 + 48) * 4)
    return n_bytes, flops

"""K1: the fused NDT score / gradient / Hessian reduction.

`ndt_reduce_fused` replaces the Pallas TPU kernel
`lidar_slam_tpu/ops/pallas/ndt_fused.py::ndt_reduce_fused` with the
hand-written Hopper kernel `csrc/ndt_fused.cu` (one launch: a grid-stride
loop over (point, stencil offset) pairs, direct two-level gather, fixed-
order block partials summed by the last block to finish; the source says
what bounds it). On a CUDA tensor it launches that kernel or raises; on a
CPU tensor, and only there, it runs `ndt_reduce_plain`, the plain PyTorch
version of the same function (the XLA `two_level` math of
`lidar_slam_tpu/models/registration/ndt.py::ndt_derivatives`, chunked over
points). Both return the kernel's [32] layout: score, gradient[6], the 21
upper-triangular Hessian entries (row-major, i <= j), `unresolved` (always
0: the direct gather never drops a term) and 3 pad.

This one-evaluation form serves `ndt_derivatives` and the host loop of the
More-Thuente line search; the clamped-Newton alignment runs whole on the
card (`ndt_newton.py`). Pose coefficients (R, t and the angle-derivative
tensors jang [3, 3, 3], hang [3, 3, 3, 3] of `_angle_jacobian_tensors`) are
host values for the kernel, which receives them by value as launch
arguments; the plain version also takes them as tensors on the points'
device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .ndt_gather import gather_stats_sorted

NOUT = 32
UNRESOLVED = 28
UPPER = [(i, j) for i in range(6) for j in range(i, 6)]
_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
_PAIR_A = [a for a, _ in _PAIRS]
_PAIR_B = [b for _, b in _PAIRS]

# The stencils the kernel compiles in (csrc/ndt_fused.cu: Stencil<7>, <27>),
# in the reference's order (ndt.py: _stencil7, _stencil27).
STENCIL_OFFSETS = {
    "direct7": np.asarray(
        [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.int32
    ),
    "radius27": np.stack(
        [g.ravel() for g in np.meshgrid(*(np.arange(-1, 2),) * 3, indexing="ij")], axis=-1
    ).astype(np.int32),
}

# Kernel launches since the last reset. Incremented only where the CUDA
# kernel is launched, never on the plain path.
launches = 0


class _Params(ctypes.Structure):
    """ctypes mirror of `NdtFusedParams` in csrc/ndt_fused.cu."""

    _fields_ = [
        ("R", ctypes.c_float * 9),
        ("t", ctypes.c_float * 3),
        ("J", ctypes.c_float * 27),
        ("H", ctypes.c_float * 54),
        ("origin", ctypes.c_float * 3),
        ("res", ctypes.c_float),
        ("res2", ctypes.c_float),
        ("d1", ctypes.c_float),
        ("d2", ctypes.c_float),
        ("dims", ctypes.c_int * 3),
        ("n", ctypes.c_int),
        ("weight_derivatives", ctypes.c_int),
    ]


_NPARAM = 105
assert ctypes.sizeof(_Params) == 4 * _NPARAM


def _host(name, a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"{name} must be a host tensor, got one on {a.device}")
        a = a.numpy()
    return np.asarray(a, np.float32)


def _pack_params(origin, R, t, jang, hang, dims, resolution, d1, d2, n, weight_derivatives) -> _Params:
    buf = np.zeros(_NPARAM, np.float32)
    buf[0:9] = _host("R", R).reshape(9)
    buf[9:12] = _host("t", t).reshape(3)
    # J[(3r + a) * 3 + j] = jang[a, r, j]
    buf[12:39] = _host("jang", jang).transpose(1, 0, 2).reshape(27)
    # H[(3k + r) * 3 + j] = hang[a_k, b_k, r, j]
    buf[39:93] = _host("hang", hang)[_PAIR_A, _PAIR_B].reshape(54)
    buf[93:96] = _host("origin", origin).reshape(3)
    buf[96] = resolution
    buf[97] = float(resolution) ** 2
    buf[98] = d1
    buf[99] = d2
    buf[100:105].view(np.int32)[:] = (*dims, n, int(bool(weight_derivatives)))
    return _Params.from_buffer_copy(buf)


def _const(name, a, dev) -> torch.Tensor:
    """A small constant on `dev`: a tensor already there is used as it is,
    a host value is copied without a stream synchronisation."""
    if isinstance(a, torch.Tensor) and a.device == dev:
        return a.to(torch.float32)
    return torch.as_tensor(_host(name, a)).to(dev, non_blocking=True)


def _flat_vid(coords, dims):
    return (coords[..., 0] * dims[1] + coords[..., 1]) * dims[2] + coords[..., 2]


def ndt_reduce_plain(
    points, mask, weights, index, packed, origin, R, t, jang, hang, *,
    dims, resolution, d1, d2, stencil, weight_derivatives,
    compute_hessian: bool = True, chunk: int = 8192, keys=None,
):
    """Plain PyTorch version of K1 (any device): returns the [32] sums.

    The stats rows come through the dense `index`, or, when the map's
    compact-row `keys` are given, by key through K3 (the JAX package's
    `gather="onehot"` fetch; the rows fetched are the same). Map keys hold
    NDTMap's order, so K3 takes its presorted entry: one launch a chunk."""
    dev = points.device
    R, t, jang, hang, origin_t = (
        _const(k, a, dev) for k, a in (("R", R), ("t", t), ("jang", jang), ("hang", hang), ("origin", origin))
    )
    offsets = torch.as_tensor(STENCIL_OFFSETS[stencil]).to(dev, non_blocking=True)
    dims_t = torch.as_tensor(dims, dtype=torch.int32).to(dev, non_blocking=True)
    gate_radius = stencil == "radius27"
    res = float(resolution)
    eye = torch.eye(3, dtype=torch.float32, device=dev)

    # non-finite points are masked out entirely (and zeroed, so no NaN
    # survives a 0 * NaN product)
    mask = mask & torch.all(torch.isfinite(points), dim=-1)
    pts = torch.where(mask[:, None], points, 0.0)

    out = torch.zeros(NOUT, dtype=torch.float32, device=dev)
    iu = torch.triu_indices(6, 6, device=dev)
    for s in range(0, pts.shape[0], chunk):
        x, m, pw = pts[s:s + chunk], mask[s:s + chunk], weights[s:s + chunk]
        xp = x @ R.T + t
        cell = torch.floor((xp - origin_t) / res).to(torch.int32)
        cand = cell[:, None, :] + offsets[None, :, :]  # [C, S, 3]
        inb = torch.all((cand >= 0) & (cand < dims_t), dim=-1)
        vid = torch.where(inb, _flat_vid(cand, dims), 0)
        if keys is None:
            pk = packed[index[vid.long()].long()]  # [C, S, 16]
        else:
            pk = gather_stats_sorted(keys, packed, torch.where(inb, vid, -2))
        mu = pk[..., 0:3]
        sv = pk[..., 3]
        ixx, ixy, ixz = pk[..., 4], pk[..., 5], pk[..., 6]
        iyy, iyz, izz = pk[..., 7], pk[..., 8], pk[..., 9]

        e = xp[:, None, :] - mu
        gate = (pk[..., 10] > 0.5) & inb & m[:, None]
        if gate_radius:
            gate = gate & (torch.sum(e * e, dim=-1) <= res * res)
        ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
        q = torch.stack(
            [ixx * ex + ixy * ey + ixz * ez, ixy * ex + iyy * ey + iyz * ez, ixz * ex + iyz * ey + izz * ez],
            dim=-1,
        )
        md = torch.sum(q * e, dim=-1)
        expt = torch.exp(-0.5 * d2 * md)
        exd = d2 * expt
        gate = gate & (exd <= 1.0) & (exd >= 0.0) & torch.isfinite(exd)
        expt = torch.where(gate, expt, 0.0)
        gf = gate.to(torch.float32)

        out[0] += torch.sum(gf * sv * pw[:, None] * (-d1) * expt)
        dw = sv * pw[:, None] if weight_derivatives else pw[:, None].expand_as(sv)
        f = gf * dw * d1 * d2 * expt  # [C, S]

        jrot = torch.einsum("arj,cj->cra", jang, x)  # Jrot[c, r, a]
        J = torch.cat([eye.expand(x.shape[0], 3, 3), jrot], dim=-1)  # [C, 3, 6]
        qJ = torch.einsum("csk,ckp->csp", q, J)
        out[1:7] += torch.einsum("cs,csp->p", f, qJ)

        if compute_hessian:
            h1 = -d2 * torch.einsum("cs,csi,csj->ij", f, qJ, qJ)
            cinv = torch.stack(
                [
                    torch.stack([ixx, ixy, ixz], dim=-1),
                    torch.stack([ixy, iyy, iyz], dim=-1),
                    torch.stack([ixz, iyz, izz], dim=-1),
                ],
                dim=-2,
            )  # [C, S, 3, 3]
            cJ = torch.einsum("csik,ckp->csip", cinv, J)
            h3 = torch.einsum("cs,cki,cskj->ij", f, J, cJ)
            hrot = torch.einsum("abrk,ck->cabr", hang, x)
            h2r = torch.einsum("cs,csr,cabr->ab", f, q, hrot)
            hess = h1 + h3
            hess[3:, 3:] += h2r
            out[7:28] += hess[iu[0], iu[1]]
    return out


def _library() -> ctypes.CDLL:
    lib = build.load("ndt_fused")
    if lib.ndt_fused_launch.argtypes is None:
        lib.ndt_fused_blocks.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ndt_fused_blocks.restype = ctypes.c_int
        lib.ndt_fused_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ndt_fused_launch.restype = ctypes.c_int
    return lib


def ndt_reduce_fused(
    points, mask, weights, index, packed, origin, R, t, jang, hang, *,
    dims, resolution, d1, d2, stencil, weight_derivatives,
):
    """K1 (replaces ops/pallas/ndt_fused.py::ndt_reduce_fused): the [32]
    sums for `points` [N, 3] (raw, untransformed), `mask` [N] bool,
    `weights` [N], against the map's dense `index` [V] int32 and packed
    stats `packed` [C+1, 16]. CUDA tensors launch the Hopper kernel; CPU
    tensors take the plain version."""
    global launches
    dev = points.device
    if dev.type == "cpu":
        return ndt_reduce_plain(
            points, mask, weights, index, packed, origin, R, t, jang, hang,
            dims=dims, resolution=resolution, d1=d1, d2=d2, stencil=stencil,
            weight_derivatives=weight_derivatives,
        )
    if dev.type != "cuda":
        raise ValueError(f"ndt_reduce_fused: unsupported device {dev}")
    if stencil not in STENCIL_OFFSETS:
        raise ValueError(f"unknown stencil {stencil!r}")
    n = points.shape[0]
    n_off = len(STENCIL_OFFSETS[stencil])
    if n * n_off >= 2**31:
        raise ValueError(f"ndt_reduce_fused: {n} points x {n_off} offsets overflow the kernel's int pair index")
    build.check_tensor("points", points, torch.float32, dev, (n, 3))
    build.check_tensor("mask", mask, torch.bool, dev, (n,))
    build.check_tensor("weights", weights, torch.float32, dev, (n,))
    build.check_tensor("index", index, torch.int32, dev, (dims[0] * dims[1] * dims[2],))
    build.check_tensor("packed", packed, torch.float32, dev)
    if packed.ndim != 2 or packed.shape[1] != 16 or packed.data_ptr() % 16:
        raise ValueError("packed must be a 16-byte aligned [C+1, 16] table")

    params = _pack_params(origin, R, t, jang, hang, dims, resolution, d1, d2, n, weight_derivatives)
    lib = _library()
    with torch.cuda.device(dev):
        blocks = lib.ndt_fused_blocks(n, n_off)
        if blocks < 1:
            raise RuntimeError("ndt_reduce_fused: the card's occupancy query failed")
        # the [28, blocks] partials, then the last-block ticket: scratch of
        # this call alone (the launch zeroes the ticket on its stream), so
        # launches on other streams or in a graph never share a ticket
        scratch = torch.empty(28 * blocks + 1, dtype=torch.float32, device=dev)
        out = torch.empty(NOUT, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndt_fused_launch(
            points.data_ptr(), mask.data_ptr(), weights.data_ptr(), index.data_ptr(),
            packed.data_ptr(), ctypes.byref(params), n_off, blocks,
            scratch.data_ptr(), scratch[28 * blocks:].data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"ndt_fused kernel launch failed: cudaError {err}")
    launches += 1
    return out


def unpack_results(sums):
    """[32] host sums -> (score, grad [6], hess [6, 6], unresolved), float32 numpy."""
    sums = np.asarray(sums, np.float32)
    hess = np.zeros((6, 6), np.float32)
    for u, (i, j) in enumerate(UPPER):
        hess[i, j] = hess[j, i] = sums[7 + u]
    return sums[0], sums[1:7].copy(), hess, sums[UNRESOLVED]

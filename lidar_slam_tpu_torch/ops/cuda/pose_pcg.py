"""The pose graph's block-Jacobi PCG, one linear solve a launch.

Replaces no Pallas kernel: the JAX package's PCG is a `lax.while_loop`
inside its jitted LM (lidar_slam_tpu/models/graph_optimizer.py), one
device program; here it is the hand-written Hopper kernel
`csrc/pose_pcg.cu`, which `optimize_pose_graph` launches once an LM
iteration where the graph lies on a CUDA device and the solve is PCG. The
plain version is `models/graph_optimizer.py::_solve_pcg`, which the CPU
path and the edge-sharded solve (whose `all_sum` sits between a step's
matvec and its dot products) run.

- `incidence` builds the node-ordered incidence lists the kernel sums by,
  once a solve, on any device: a stable sort, no host read.
- `pose_pcg` launches the kernel on CUDA tensors and raises on anything
  else: another device, a dtype, shape or layout it does not take.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# Kernel launches since the last reset. Incremented only where the CUDA
# kernel is launched.
launches = 0


def incidence(edge_ij, edge_valid, prior_node, prior_valid, n: int):
    """The node sums' order: `order` [2E + P] int32 codes, e for edge e at
    its node i, E + e at its node j, 2E + p for prior p, grouped by node;
    `offsets` [n + 1] int32, node v's codes at order[offsets[v]:offsets[v +
    1]]. A node lists the valid edges where it is i, then those where it is
    j, then its valid priors, each group in input order; rows whose
    `edge_valid` or `prior_valid` is false are left out (they sort past
    every node). On the graph's device, with no host read."""
    i, j = edge_ij[:, 0], edge_ij[:, 1]
    key = torch.cat([torch.where(edge_valid, i, n), torch.where(edge_valid, j, n),
                     torch.where(prior_valid, prior_node, n)]).to(torch.int32)
    sorted_key, order = torch.sort(key, stable=True)
    nodes = torch.arange(n + 1, dtype=torch.int32, device=key.device)
    offsets = torch.searchsorted(sorted_key, nodes).to(torch.int32)
    return order.to(torch.int32), offsets


class _Args(ctypes.Structure):
    """csrc/pose_pcg.cu: PosePcgArgs."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "Hii", "Hjj", "Hij", "bi", "bj", "Hp", "bp", "edge_ij", "order", "offsets", "free_mask", "lam",
        "active_steps", "x", "iscratch", "fscratch")] + [
        ("n", ctypes.c_int), ("n_edges", ctypes.c_int), ("n_priors", ctypes.c_int), ("iters", ctypes.c_int),
        ("tol2", ctypes.c_float)]


def _library() -> ctypes.CDLL:
    lib = build.load("pose_pcg")
    if lib.pose_pcg_launch.argtypes is None:
        lib.pose_pcg_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.pose_pcg_launch.restype = ctypes.c_int
    return lib


def pose_pcg(asm, edge_ij, lists, lam, pcg_tol: float, pcg_iters: int, active_steps=None):
    """x [N, 6] solving (H + lam I) x = b on the free nodes, H and b summed
    from `asm` (models/graph_optimizer.py::_assemble: Hii, Hjj, Hij [E, 6,
    6], bi, bj [E, 6], Hp [P, 6, 6], bp [P, 6], free [N] bool) over `lists`
    (`incidence` of the same graph); `edge_ij` [E, 2] int32; `lam` a 0-dim
    float32 tensor; `pcg_iters` steps at most, fewer where the relative
    residual falls to `pcg_tol`. `active_steps`, a 0-dim float32 tensor or
    None, gains the steps that worked. One kernel launch on CUDA tensors,
    no host read; any other device raises (the plain version is
    `_solve_pcg`)."""
    global launches
    dev = lam.device
    if dev.type != "cuda":
        raise ValueError(f"pose_pcg: the kernel runs on a CUDA device, not {dev} (the plain version is _solve_pcg)")
    n = int(asm["n"])
    n_edges, n_priors = edge_ij.shape[0], asm["Hp"].shape[0]
    order, offsets = lists
    f32 = torch.float32
    for name, shape in (("Hii", (n_edges, 6, 6)), ("Hjj", (n_edges, 6, 6)), ("Hij", (n_edges, 6, 6)),
                        ("bi", (n_edges, 6)), ("bj", (n_edges, 6)), ("Hp", (n_priors, 6, 6)), ("bp", (n_priors, 6))):
        build.check_tensor(name, asm[name], f32, dev, shape)
    build.check_tensor("free", asm["free"], torch.bool, dev, (n,))
    build.check_tensor("edge_ij", edge_ij, torch.int32, dev, (n_edges, 2))
    build.check_tensor("order", order, torch.int32, dev, (2 * n_edges + n_priors,))
    build.check_tensor("offsets", offsets, torch.int32, dev, (n + 1,))
    build.check_tensor("lam", lam, f32, dev, ())
    if active_steps is not None:
        build.check_tensor("active_steps", active_steps, f32, dev, ())
    if 108 * n >= 2**31 or 2 * n_edges + n_priors >= 2**30:
        raise ValueError(f"pose_pcg: {n} nodes, {n_edges} edges, {n_priors} priors overflow the kernel's int indexes")
    x = torch.empty((n, 6), dtype=f32, device=dev)
    iscratch = torch.empty(4 * n + 2 * (2 * n_edges + n_priors), dtype=torch.int32, device=dev)
    fscratch = torch.empty(108 * n, dtype=f32, device=dev)
    args = _Args(*(t.data_ptr() for t in (asm["Hii"], asm["Hjj"], asm["Hij"], asm["bi"], asm["bj"], asm["Hp"],
                                           asm["bp"], edge_ij, order, offsets, asm["free"], lam)),
                 None if active_steps is None else active_steps.data_ptr(),
                 *(t.data_ptr() for t in (x, iscratch, fscratch)),
                 n, n_edges, n_priors, int(pcg_iters), float(pcg_tol) ** 2)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.pose_pcg_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose_pcg kernel launch failed: cudaError {err}")
    launches += 1
    return x

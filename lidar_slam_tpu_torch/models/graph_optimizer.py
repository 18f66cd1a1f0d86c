"""SE(3) pose-graph optimization in PyTorch (port of
lidar_slam_tpu/models/graph_optimizer.py).

The same Levenberg-Marquardt over fixed-capacity edge arrays as the JAX
package (g2o `lm_var` with optional Huber weights): batched analytic edge
and typed-prior residuals and Jacobians, then one of two linear solvers,
chosen on the graph's capacity as the JAX package chooses:

- ``dense``: the 6N x 6N normal matrix, assembled by a fixed-order block
  scatter, factored by `torch.linalg.cholesky_ex` and solved by
  `cholesky_solve`;
- ``pcg``: matrix-free block-Jacobi preconditioned CG on edge-wise matvecs;
  on a CUDA device one launch of the hand-written kernel
  `ops/cuda/pose_pcg.py` an LM iteration, elsewhere `_solve_pcg`.

Every per-node sum is `ops.pointcloud.scatter_sum`, or in the kernel a sum
over incidence lists; both add in the same order on every run (no
`index_add` float atomics), so a solve on the card repeats to the bit. On
the CPU a solve runs on one torch thread, so it gives the one-thread bits
at any thread count (chi2, the PCG's dot products and LAPACK's blocked
Cholesky split their work, and so their rounding, among torch's threads).

Host synchronisation: the JAX optimizer is one device program, an LM
`lax.while_loop` around a PCG `lax.while_loop`. Here the PCG is one kernel
launch that stops where the JAX loop's condition fails or, in
`_solve_pcg`, runs its `pcg_iters` steps with the state frozen by
`torch.where` once that condition fails, which gives the while-loop's
result; neither reads anything on the host. The LM loop reads one 4-float
tensor (its done flag and the statistics) per iteration; the
factorizations use the `_ex` forms, which check nothing on the host.

Node parameterization: right perturbation T <- T exp(delta), delta =
(rho, phi); fixed nodes are clamped.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import device as _default_device
from ..geom.se3 import matrix_to_quat, pose_inverse, se3_exp, se3_log, so3_hat
from ..ops.cuda import pose_pcg
from ..ops.pointcloud import one_torch_thread, scatter_sum
from ..utils import watchdog


@dataclasses.dataclass(frozen=True)
class GraphOptimizerConfig:
    """The same fields and defaults as the JAX package's config."""

    max_iterations: int = 512
    # 'auto': dense while 6 * capacity <= dense_limit, PCG beyond
    solver: str = "auto"  # 'auto' | 'dense' | 'pcg'
    dense_limit: int = 4096
    lm_lambda_init: float = 1e-4
    lm_lambda_factor: float = 2.0
    chi2_rel_tol: float = 1e-6
    robust_kernel: str = "none"  # 'none' | 'huber'
    robust_delta: float = 1.0
    pcg_iters: int = 100
    pcg_tol: float = 1e-6


@dataclasses.dataclass
class PoseGraph:
    """Fixed-capacity pose graph: the JAX PoseGraph's fields as tensors on
    one device. Unary priors are typed: 0 = XYZ translation, 1 = quaternion
    orientation; both have 3-dim residuals."""

    poses: torch.Tensor  # [N, 4, 4] float32
    node_valid: torch.Tensor  # [N] bool
    node_fixed: torch.Tensor  # [N] bool
    edge_ij: torch.Tensor  # [E, 2] int32 (i, j)
    edge_meas: torch.Tensor  # [E, 4, 4]  Z_ij ~ T_i^-1 T_j
    edge_info: torch.Tensor  # [E, 6] diagonal information (trans, rot)
    edge_valid: torch.Tensor  # [E] bool
    prior_node: torch.Tensor  # [P] int32
    prior_xyz: torch.Tensor  # [P, 3] (prior_type 0)
    prior_info: torch.Tensor  # [P, 3]
    prior_valid: torch.Tensor  # [P] bool
    prior_quat: torch.Tensor  # [P, 4] (w, x, y, z), w >= 0 (prior_type 1)
    prior_type: torch.Tensor  # [P] int32

    @staticmethod
    def empty(max_nodes: int, max_edges: int, max_priors: int, device=None) -> "PoseGraph":
        return PoseGraphBuilder(max_nodes, max_edges, max_priors, device=device).to_graph()


def _adjoint(T):
    """SE(3) adjoint [..., 6, 6] acting on (rho, phi)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    top = torch.cat([R, so3_hat(t) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _ad_se3(xi):
    """se(3) 'little adjoint' ad_xi [..., 6, 6]."""
    ph = so3_hat(xi[..., 3:])
    rh = so3_hat(xi[..., :3])
    top = torch.cat([ph, rh], dim=-1)
    bot = torch.cat([torch.zeros_like(ph), ph], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _inv_right_jacobian(r):
    """Jr^{-1}(r) ~ I + ad(r)/2 + ad(r)^2/12 (2nd order; residuals are small)."""
    ad = _ad_se3(r)
    eye = torch.eye(6, dtype=r.dtype, device=r.device).expand(ad.shape)
    return eye + 0.5 * ad + (1.0 / 12.0) * (ad @ ad)


def _edge_residuals_jacobians(graph: PoseGraph):
    """r = log(Z^-1 T_i^-1 T_j); J_j = Jr^{-1}(r); J_i = -Jr^{-1}(r) Adj(T_j^-1 T_i)."""
    Ti = graph.poses[graph.edge_ij[:, 0]]
    Tj = graph.poses[graph.edge_ij[:, 1]]
    A = pose_inverse(Ti) @ Tj
    r = se3_log(pose_inverse(graph.edge_meas) @ A)  # [E, 6]
    Jr_inv = _inv_right_jacobian(r)
    return r, -(Jr_inv @ _adjoint(pose_inverse(A))), Jr_inv


def _prior_residuals_jacobians(graph: PoseGraph):
    """Type 0 (GNSS XYZ): r = t_i - z, J = [R_i, 0]. Type 1 (orientation):
    r = vec(q(R_i)) - vec(q_meas), both with w >= 0, J = [0, (w I + v^)/2]
    under the right perturbation."""
    Ti = graph.poses[graph.prior_node]
    Ri = Ti[:, :3, :3]
    zeros33 = torch.zeros_like(Ri)

    r_xyz = Ti[:, :3, 3] - graph.prior_xyz
    J_xyz = torch.cat([Ri, zeros33], dim=-1)  # [P, 3, 6]

    q = matrix_to_quat(Ri)
    r_quat = q[:, 1:4] - graph.prior_quat[:, 1:4]
    eye3 = torch.eye(3, dtype=q.dtype, device=q.device).expand(zeros33.shape)
    Jq = 0.5 * (q[:, 0, None, None] * eye3 + so3_hat(q[:, 1:4]))
    J_quat = torch.cat([zeros33, Jq], dim=-1)

    isq = (graph.prior_type == 1)[:, None]
    return torch.where(isq, r_quat, r_xyz), torch.where(isq[..., None], J_quat, J_xyz)


def _robust_weight(chi2_e, cfg: GraphOptimizerConfig):
    if cfg.robust_kernel == "huber":
        d2 = cfg.robust_delta**2
        return torch.where(chi2_e <= d2, 1.0, torch.sqrt(d2 / torch.clamp(chi2_e, min=1e-12)))
    return torch.ones_like(chi2_e)


def graph_chi2(graph: PoseGraph, cfg: GraphOptimizerConfig = GraphOptimizerConfig()):
    """Total weighted chi2, a 0-dim tensor on the graph's device."""
    r, _, _ = _edge_residuals_jacobians(graph)
    ce = torch.sum(r * r * graph.edge_info, dim=-1)
    ce = ce * _robust_weight(ce, cfg) * graph.edge_valid
    rp, _ = _prior_residuals_jacobians(graph)
    cp = torch.sum(rp * rp * graph.prior_info, dim=-1) * graph.prior_valid
    return torch.sum(ce) + torch.sum(cp)


def _assemble(graph: PoseGraph, cfg: GraphOptimizerConfig):
    """Per-edge weighted J^T Lambda J / J^T Lambda r blocks and the free-node
    mask, shared by the dense and PCG paths."""
    r, Ji, Jj = _edge_residuals_jacobians(graph)
    lam = graph.edge_info
    ce = torch.sum(r * r * lam, dim=-1)
    w = _robust_weight(ce, cfg) * graph.edge_valid

    LJi = lam[:, :, None] * Ji
    LJj = lam[:, :, None] * Jj
    rp, Jp = _prior_residuals_jacobians(graph)
    wp = graph.prior_valid.to(torch.float32)
    LJp = graph.prior_info[:, :, None] * Jp
    return dict(
        Hii=torch.einsum("e,eki,ekj->eij", w, Ji, LJi),
        Hjj=torch.einsum("e,eki,ekj->eij", w, Jj, LJj),
        Hij=torch.einsum("e,eki,ekj->eij", w, Ji, LJj),
        bi=torch.einsum("e,eki,ek->ei", w, Ji, lam * r),
        bj=torch.einsum("e,eki,ek->ei", w, Jj, lam * r),
        Hp=torch.einsum("p,pki,pkj->pij", wp, Jp, LJp),
        bp=torch.einsum("p,pki,pk->pi", wp, Jp, graph.prior_info * rp),
        i=graph.edge_ij[:, 0].long(), j=graph.edge_ij[:, 1].long(), pn=graph.prior_node.long(),
        free=graph.node_valid & ~graph.node_fixed, n=graph.poses.shape[0],
    )


def _segment_sum(values, index, n):
    """jax.ops.segment_sum in a fixed order: rows of `values` summed by
    `index` into n rows."""
    keep = torch.ones(index.shape, dtype=torch.bool, device=index.device)
    return scatter_sum(values.new_zeros((n, *values.shape[1:])), index, values, keep)


def _diag_blocks(asm):
    """Block diagonal of H, [N, 6, 6]."""
    n = asm["n"]
    return (_segment_sum(asm["Hii"], asm["i"], n) + _segment_sum(asm["Hjj"], asm["j"], n)
            + _segment_sum(asm["Hp"], asm["pn"], n))


def _gradient(asm):
    n = asm["n"]
    b = (_segment_sum(asm["bi"], asm["i"], n) + _segment_sum(asm["bj"], asm["j"], n)
         + _segment_sum(asm["bp"], asm["pn"], n))
    return b * asm["free"][:, None]


def _matvec(asm, lam_lm, x):
    """y = (H + lam_lm I) x without materializing H. x: [N, 6]."""
    xi, xj = x[asm["i"]], x[asm["j"]]
    yi = torch.einsum("eij,ej->ei", asm["Hii"], xi) + torch.einsum("eij,ej->ei", asm["Hij"], xj)
    yj = torch.einsum("eij,ej->ei", asm["Hjj"], xj) + torch.einsum("eji,ej->ei", asm["Hij"], xi)
    n = asm["n"]
    y = _segment_sum(yi, asm["i"], n) + _segment_sum(yj, asm["j"], n)
    y = y + _segment_sum(torch.einsum("pij,pj->pi", asm["Hp"], x[asm["pn"]]), asm["pn"], n)
    y = y + lam_lm * x
    return y * asm["free"][:, None]


def _solve_dense(asm, lam_lm, b):
    """(H + lam I) x = b on the free nodes, H materialized as [6N, 6N].

    H is assembled block by block: each edge's Hii, Hjj, Hij and Hij^T and
    each prior's block land in their [N * N] block cell through one
    fixed-order scatter (the JAX package contracts a one-hot stacked
    Jacobian on the MXU instead; the blocks and their sums are the same).
    A failed factorization gives a non-finite step, as the JAX package's
    NaN Cholesky does, which the LM loop rejects."""
    n = asm["n"]
    n6 = n * 6
    i, j, pn = asm["i"], asm["j"], asm["pn"]
    blocks = torch.cat([asm["Hii"], asm["Hjj"], asm["Hij"], asm["Hij"].transpose(1, 2), asm["Hp"]])
    cells = torch.cat([i * n + i, j * n + j, i * n + j, j * n + i, pn * n + pn])
    H = _segment_sum(blocks, cells, n * n).reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(n6, n6)

    free6 = asm["free"].to(torch.float32).repeat_interleave(6)
    H = H * free6[:, None] * free6[None, :]
    # clamped nodes + LM damping keep the system SPD
    H = H + torch.diag(1.0 - free6) + lam_lm * torch.eye(n6, device=H.device)
    rhs = (b * asm["free"][:, None]).reshape(n6, 1)
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(rhs, L)
    return torch.where(info == 0, x, torch.nan).reshape(n, 6)


def _solve_pcg(asm, lam_lm, b, cfg: GraphOptimizerConfig, reduce=None, active_steps=None):
    """Block-Jacobi preconditioned CG on the matrix-free operator: the JAX
    package's while-loop, run for its `pcg_iters` steps with the state
    frozen once its condition (relative residual above pcg_tol) fails: no
    host read on any device. `reduce` completes the node sums of a shard
    of the edges (the edge-sharded solve's all_sum), as the JAX sharded
    solve psums the diagonal blocks and each matvec. `active_steps`, where
    given, is a 0-dim device count to which each step adds whether it
    worked (one op a step)."""
    reduce = reduce or (lambda t: t)
    D = reduce(_diag_blocks(asm)) + (lam_lm + 1e-8) * torch.eye(6, device=b.device)
    Dinv = torch.linalg.inv_ex(D).inverse
    free = asm["free"][:, None]

    def precond(v):
        return torch.einsum("nij,nj->ni", Dinv, v) * free

    b = b * free
    x, r = torch.zeros_like(b), b
    p = precond(r)
    rz = torch.sum(r * p)
    b2 = torch.clamp(torch.sum(b * b), min=1e-30)
    for _ in range(cfg.pcg_iters):
        active = torch.sum(r * r) / b2 > cfg.pcg_tol**2
        if active_steps is not None:
            active_steps.add_(active)
        # (H p) summed over the shards, then the damping: (H + lam I) p
        Ap = reduce(_matvec(asm, 0.0, p)) + lam_lm * p * free
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        rz_new = torch.sum(r_new * z)
        p_new = z + rz_new / torch.clamp(rz, min=1e-30) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
    return x


def _apply_update(poses, delta, free):
    """T_i <- T_i exp(-delta_i) on free nodes (the step solves H d = g with
    g the +gradient)."""
    return torch.where(free[:, None, None], poses @ se3_exp(-delta), poses)


def uses_dense(cfg: GraphOptimizerConfig, capacity: int) -> bool:
    """The JAX package's solver rule, on the graph's node capacity."""
    return cfg.solver == "dense" or (cfg.solver == "auto" and capacity * 6 <= cfg.dense_limit)


def optimize_pose_graph(
    graph: PoseGraph, cfg: GraphOptimizerConfig = GraphOptimizerConfig()
) -> Tuple[PoseGraph, dict]:
    """Levenberg-Marquardt with variable lambda (g2o `lm_var` semantics).
    Returns (optimized graph on its device, stats as host numbers). One
    host read per LM iteration: the done flag, with chi2 and lambda.

    On a CUDA device the PCG is the hand-written kernel
    (ops/cuda/pose_pcg.py), one launch an LM iteration, summing over
    incidence lists built once a solve; on the CPU it is `_solve_pcg`.

    Under an active run (utils.watchdog) the solve is the `pose_graph` span,
    counting `lm_iterations` and, for the PCG, `pcg_steps` (`pcg_iters` an
    iteration, the JAX loop's budget), `pcg_active_steps` (the steps that
    worked, summed on the device and read with the iterations' own host
    read) and `pcg_launches` (the kernel's launches)."""
    with watchdog.span("pose_graph"):
        dense = uses_dense(cfg, graph.poses.shape[0])
        kernel = not dense and graph.poses.device.type == "cuda"
        active_steps = None
        if not dense and watchdog.active_run() is not None:
            active_steps = torch.zeros((), dtype=torch.float32, device=graph.poses.device)
        if kernel:  # the node sums' order, once a solve
            lists = pose_pcg.incidence(graph.edge_ij, graph.edge_valid, graph.prior_node, graph.prior_valid,
                                       graph.poses.shape[0])
        launches = pose_pcg.launches

        def step(poses, lam):
            asm = _assemble(dataclasses.replace(graph, poses=poses), cfg)
            if kernel:
                return pose_pcg.pose_pcg(asm, graph.edge_ij, lists, lam, cfg.pcg_tol, cfg.pcg_iters, active_steps)
            b = _gradient(asm)
            return _solve_dense(asm, lam, b) if dense else _solve_pcg(asm, lam, b, cfg, active_steps=active_steps)

        with one_torch_thread() if graph.poses.device.type == "cpu" else contextlib.nullcontext():
            poses, stats = levenberg_marquardt(
                graph.poses, graph.node_valid & ~graph.node_fixed, step,
                lambda poses: graph_chi2(dataclasses.replace(graph, poses=poses), cfg), cfg,
                active_steps=active_steps,
            )
        watchdog.count("lm_iterations", stats["iterations"])
        if active_steps is not None:
            watchdog.count("pcg_steps", stats["iterations"] * cfg.pcg_iters)
            watchdog.count("pcg_active_steps", stats.pop("pcg_active_steps"))
            watchdog.count("pcg_launches", pose_pcg.launches - launches)
        return dataclasses.replace(graph, poses=poses), stats


def levenberg_marquardt(poses, free, step, chi2_of, cfg: GraphOptimizerConfig, active_steps=None):
    """The LM loop shared by every pose-graph solver: `step(poses, lam)`
    gives the update [N, 6] of the damped system, `chi2_of(poses)` the
    total chi2 (0-dim, on the device); a step is kept if chi2 falls (lambda
    / factor), else dropped (lambda * factor), until a small relative change
    after a kept step, lambda above 1e6 or max_iterations. One host read an
    iteration. Returns (poses, stats as host numbers). `active_steps`, a
    0-dim device count that `step` adds to, rides on that read and comes
    back as stats["pcg_active_steps"]."""
    chi2_0 = chi2_of(poses)
    chi2 = chi2_0
    lam = torch.full((), cfg.lm_lambda_init, dtype=torch.float32, device=chi2.device)
    done = torch.zeros((), dtype=torch.bool, device=chi2.device)

    def read():
        extra = [] if active_steps is None else [active_steps]
        return torch.stack([done.to(torch.float32), chi2_0, chi2, lam] + extra).cpu().numpy()

    it, host = 0, None
    while it < cfg.max_iterations:
        new_poses = _apply_update(poses, step(poses, lam), free)
        new_chi2 = chi2_of(new_poses)
        accept = new_chi2 < chi2
        chi2_out = torch.where(accept, new_chi2, chi2)
        lam_out = torch.where(accept, lam / cfg.lm_lambda_factor, lam * cfg.lm_lambda_factor)
        rel = torch.abs(chi2 - chi2_out) / torch.clamp(chi2, min=1e-12)
        done = (accept & (rel < cfg.chi2_rel_tol)) | (lam_out > 1e6)
        poses = torch.where(accept, new_poses, poses)
        chi2, lam = chi2_out, lam_out
        it += 1
        host = read()  # the iteration's one host read
        if host[0]:
            break
    if host is None:
        host = read()
    stats = {"chi2_before": float(host[1]), "chi2_after": float(host[2]), "iterations": it, "lambda": float(host[3])}
    if active_steps is not None:
        stats["pcg_active_steps"] = int(host[4])
    return poses, stats


def _grow(arr: np.ndarray, fill=None) -> np.ndarray:
    """Double an array's leading dimension."""
    n = arr.shape[0]
    out = np.zeros((2 * n,) + arr.shape[1:], arr.dtype)
    out[:n] = arr
    if fill is not None:
        out[n:] = fill
    return out


class PoseGraphBuilder:
    """Host-side incremental builder mirroring the G2oGraphOptimizer API
    (AddSe3Node / AddSe3Edge / AddSe3PriorXYZEdge /
    AddSe3PriorQuaternionEdge / Optimize). Capacities grow by doubling when
    exceeded. The graph is solved on `device` (the card unless the caller
    passes device="cpu")."""

    def __init__(self, max_nodes: int = 2048, max_edges: int = 4096, max_priors: int = 2048, device=None):
        self.device = _default_device(device)
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        self.max_priors = max_priors
        self._poses = np.tile(np.eye(4, dtype=np.float32), (max_nodes, 1, 1))
        self._node_valid = np.zeros(max_nodes, bool)
        self._node_fixed = np.zeros(max_nodes, bool)
        self._edge_ij = np.zeros((max_edges, 2), np.int32)
        self._edge_meas = np.tile(np.eye(4, dtype=np.float32), (max_edges, 1, 1))
        self._edge_info = np.ones((max_edges, 6), np.float32)
        self._edge_valid = np.zeros(max_edges, bool)
        self._prior_node = np.zeros(max_priors, np.int32)
        self._prior_xyz = np.zeros((max_priors, 3), np.float32)
        self._prior_info = np.ones((max_priors, 3), np.float32)
        self._prior_valid = np.zeros(max_priors, bool)
        self._prior_quat = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (max_priors, 1))
        self._prior_type = np.zeros(max_priors, np.int32)
        self.n_nodes = 0
        self.n_edges = 0
        self.n_priors = 0

    def _ensure_node(self):
        if self.n_nodes >= self.max_nodes:
            self._poses = _grow(self._poses, np.eye(4, dtype=np.float32))
            self._node_valid = _grow(self._node_valid)
            self._node_fixed = _grow(self._node_fixed)
            self.max_nodes *= 2

    def _ensure_edge(self):
        if self.n_edges >= self.max_edges:
            self._edge_ij = _grow(self._edge_ij)
            self._edge_meas = _grow(self._edge_meas, np.eye(4, dtype=np.float32))
            self._edge_info = _grow(self._edge_info, 1.0)
            self._edge_valid = _grow(self._edge_valid)
            self.max_edges *= 2

    def _ensure_prior(self):
        if self.n_priors >= self.max_priors:
            self._prior_node = _grow(self._prior_node)
            self._prior_xyz = _grow(self._prior_xyz)
            self._prior_info = _grow(self._prior_info, 1.0)
            self._prior_valid = _grow(self._prior_valid)
            self._prior_quat = _grow(self._prior_quat, np.asarray([1.0, 0, 0, 0], np.float32))
            self._prior_type = _grow(self._prior_type)
            self.max_priors *= 2

    def add_se3_node(self, pose, fixed: bool = False) -> int:
        self._ensure_node()
        i = self.n_nodes
        self._poses[i] = np.asarray(pose, np.float32)
        self._node_valid[i] = True
        self._node_fixed[i] = fixed
        self.n_nodes += 1
        return i

    def add_se3_edge(self, i: int, j: int, measurement, noise=None) -> None:
        """`noise` is the per-DOF sigma vector; information = 1/noise as in
        CalculateSe3EdgeInformationMatrix (g2o_graph_optimizer.cpp:142-150)."""
        self._ensure_edge()
        e = self.n_edges
        self._edge_ij[e] = (i, j)
        self._edge_meas[e] = np.asarray(measurement, np.float32)
        if noise is not None:
            self._edge_info[e] = 1.0 / np.asarray(noise, np.float32)
        self._edge_valid[e] = True
        self.n_edges += 1

    def add_se3_prior_xyz_edge(self, node: int, xyz, noise=None) -> None:
        self._ensure_prior()
        p = self.n_priors
        self._prior_node[p] = node
        self._prior_xyz[p] = np.asarray(xyz, np.float32)
        if noise is not None:
            self._prior_info[p] = 1.0 / np.asarray(noise, np.float32)
        self._prior_valid[p] = True
        self._prior_type[p] = 0
        self.n_priors += 1

    def add_se3_prior_quat_edge(self, node: int, quat_wxyz, noise=None) -> None:
        """Orientation prior; `quat_wxyz` is normalized and sign-normalized
        to w >= 0 as setMeasurement does; `noise` the 3 residual sigmas."""
        self._ensure_prior()
        p = self.n_priors
        q = np.asarray(quat_wxyz, np.float32)
        q = q / max(np.linalg.norm(q), 1e-12)
        if q[0] < 0.0:
            q = -q
        self._prior_node[p] = node
        self._prior_quat[p] = q
        if noise is not None:
            self._prior_info[p] = 1.0 / np.asarray(noise, np.float32)
        self._prior_valid[p] = True
        self._prior_type[p] = 1
        self.n_priors += 1

    def to_graph(self) -> PoseGraph:
        # a copy of each host array, uploaded with no stream synchronisation
        return PoseGraph(**{f.name: torch.tensor(getattr(self, "_" + f.name)).to(self.device, non_blocking=True)
                            for f in dataclasses.fields(PoseGraph)})

    def optimize(self, cfg: GraphOptimizerConfig = GraphOptimizerConfig()):
        """Solve, and copy the valid nodes' poses back to the host (one read)."""
        graph, stats = optimize_pose_graph(self.to_graph(), cfg)
        self._poses[: self.n_nodes] = graph.poses[: self.n_nodes].cpu().numpy()
        return graph, stats

    def get_pose(self, i: int) -> np.ndarray:
        return self._poses[i].copy()

    def node_poses(self) -> np.ndarray:
        """A copy of the host poses of the nodes added so far, [n_nodes, 4, 4]."""
        return self._poses[: self.n_nodes].copy()

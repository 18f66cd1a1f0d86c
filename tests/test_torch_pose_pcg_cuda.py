"""The pose graph's PCG kernel (csrc/pose_pcg.cu) against its plain
version, `_solve_pcg`, on an NVIDIA GPU. Every test here needs the card and
skips without one; the file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_pose_pcg_cuda.py

The graphs are the back end's at the end of a shuttle drive
(`bench.shuttle_graph`: a 540-node chain, 90 loop edges, a GNSS prior on
every node) at the back end's capacities (2 048 nodes, 4 096 edges, 2 048
priors), so most rows are padding; one grown to 4 096 nodes.

Tolerance: the kernel sums in another order than the plain version (its
matvec takes each node's diagonal part as the summed block D_n p_n, and
every sum and dot product runs in its own fixed order), so after 100
float32 steps the two differ by the float32 rounding the iteration
carries, not by a fixed number of ulps. Both are held to the plain
version run in float64 on the same blocks: the kernel's error there is at
most three times the float32 plain version's own, plus 1e-6 of the
largest |x|. (A CPU emulation of the kernel's arithmetic read 0.6-1.2x
the plain version's error on these graphs, 6e-7 to 4e-5 of the largest
|x|.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.bench import shuttle_graph
from lidar_slam_tpu_torch.models import graph_optimizer as G
from lidar_slam_tpu_torch.ops.cuda import pose_pcg
from lidar_slam_tpu_torch.parallel import make_mesh, optimize_pose_graph_sharded
from lidar_slam_tpu_torch.utils import watchdog

pytestmark = pytest.mark.cuda

CFG = G.GraphOptimizerConfig(max_iterations=100)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA code with no CPU mode")
    return torch.device("cuda")


def _graph(dev, n=540, caps=(2048, 4096, 2048), seed=0):
    b = G.PoseGraphBuilder(*caps, device=dev)
    shuttle_graph(b, np.random.default_rng(seed), n=n)
    return b.to_graph()


def _system(graph, lam, lm_steps=0):
    """The blocks of `graph` after `lm_steps` LM iterations, and lam."""
    if lm_steps:
        graph, _ = G.optimize_pose_graph(graph, dataclasses.replace(CFG, max_iterations=lm_steps))
    asm = G._assemble(graph, CFG)
    return graph, asm, torch.full((), lam, dtype=torch.float32, device=graph.poses.device)


def _lists(graph):
    return pose_pcg.incidence(graph.edge_ij, graph.edge_valid, graph.prior_node, graph.prior_valid,
                              graph.poses.shape[0])


def _solve_both(graph, asm, lam, cfg=CFG):
    """(kernel x, its steps, plain x, its steps, plain x in float64)."""
    ck = torch.zeros((), device=lam.device)
    cp = torch.zeros((), device=lam.device)
    xk = pose_pcg.pose_pcg(asm, graph.edge_ij, _lists(graph), lam, cfg.pcg_tol, cfg.pcg_iters, ck)
    xp = G._solve_pcg(asm, lam, G._gradient(asm), cfg, active_steps=cp)
    asm64 = {k: (v.double() if torch.is_tensor(v) and v.is_floating_point() else v) for k, v in asm.items()}
    x64 = G._solve_pcg(asm64, lam.double(), G._gradient(asm64), cfg)
    return xk, int(ck), xp, int(cp), x64


def _check_x(xk, xp, x64):
    scale = float(x64.abs().max())
    err_k = float((xk.double() - x64).abs().max())
    err_p = float((xp.double() - x64).abs().max())
    assert torch.isfinite(xk).all()
    assert err_k <= 3.0 * err_p + 1e-6 * scale, (err_k, err_p, scale)


@pytest.mark.parametrize("lam,lm_steps", [(1e-4, 0), (1e-4, 3), (0.1, 0), (10.0, 3)])
def test_kernel_matches_plain(dev, lam, lm_steps):
    graph, asm, lam_t = _system(_graph(dev), lam, lm_steps)
    xk, sk, xp, sp, x64 = _solve_both(graph, asm, lam_t)
    _check_x(xk, xp, x64)
    assert sk == sp
    free = asm["free"]
    assert torch.equal(xk[~free], torch.zeros_like(xk[~free]))


def test_two_launches_equal_bits(dev):
    graph, asm, lam = _system(_graph(dev), 1e-4, 2)
    lists = _lists(graph)
    a = pose_pcg.pose_pcg(asm, graph.edge_ij, lists, lam, CFG.pcg_tol, CFG.pcg_iters)
    b = pose_pcg.pose_pcg(asm, graph.edge_ij, lists, lam, CFG.pcg_tol, CFG.pcg_iters)
    assert torch.equal(a, b)


@pytest.mark.parametrize("lam,tol", [(100.0, 1e-3), (100.0, 1e-4), (1e4, 1e-4)])
def test_working_steps_at_a_reachable_tolerance(dev, lam, tol):
    """At these damping factors the relative residual reaches pcg_tol in
    4-30 steps (at lam 1e-4 even 1e-2 takes all 100 on this graph), so both
    stop early. The counts are equal, or one apart where the residual sits
    at pcg_tol: then the plain version's residual after the shorter count
    lies within a factor of 2 of it."""
    cfg = dataclasses.replace(CFG, pcg_tol=tol)
    graph, asm, lam = _system(_graph(dev), lam, 1)
    xk, sk, xp, sp, x64 = _solve_both(graph, asm, lam, cfg)
    assert sk < cfg.pcg_iters and sp < cfg.pcg_iters
    if sk == sp:
        _check_x(xk, xp, x64)
    else:
        assert abs(sk - sp) == 1, (sk, sp)
        m = min(sk, sp)
        b = G._gradient(asm)
        x = G._solve_pcg(asm, lam, b, dataclasses.replace(cfg, pcg_iters=m))
        r = b - (G._matvec(asm, 0.0, x) + lam * x * asm["free"][:, None])
        ratio = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
        assert 0.5 * cfg.pcg_tol <= ratio <= 2.0 * cfg.pcg_tol, (sk, sp, ratio)


def test_grown_graph(dev):
    """2 100 nodes and priors: the builder doubles to 4 096 nodes, 4 096
    priors; the kernel still matches."""
    graph = _graph(dev, n=2100)
    assert graph.poses.shape[0] == 4096 and graph.prior_node.shape[0] == 4096
    graph, asm, lam = _system(graph, 1e-4, 1)
    xk, sk, xp, sp, x64 = _solve_both(graph, asm, lam)
    _check_x(xk, xp, x64)
    assert sk == sp


def test_optimize_launches_once_an_iteration(dev):
    graph = _graph(dev)
    run = watchdog.RunHealth()
    before = pose_pcg.launches
    with run.active():
        out, stats = G.optimize_pose_graph(graph, dataclasses.replace(CFG, max_iterations=6))
    assert pose_pcg.launches - before == stats["iterations"]
    (sp,) = [s for s in run.spans() if s.name == "pose_graph"]
    assert sp.counts["pcg_launches"] == sp.counts["lm_iterations"] == stats["iterations"]
    assert stats["chi2_after"] < 0.05 * stats["chi2_before"]


def test_sharded_solve_launches_none(dev):
    graph = _graph(dev)
    before = pose_pcg.launches
    _, stats = optimize_pose_graph_sharded(graph, dataclasses.replace(CFG, max_iterations=3, solver="pcg"),
                                           make_mesh(1, device=dev))
    torch.cuda.synchronize()
    assert stats["iterations"] > 0 and pose_pcg.launches == before


def test_wrapper_rejects_bad_inputs(dev):
    graph, asm, lam = _system(_graph(dev), 1e-4)
    lists = _lists(graph)

    def call(asm=asm, edge_ij=graph.edge_ij, lists=lists, lam=lam):
        return pose_pcg.pose_pcg(asm, edge_ij, lists, lam, CFG.pcg_tol, CFG.pcg_iters)

    with pytest.raises(ValueError):
        call(lam=lam.cpu())
    with pytest.raises(ValueError):
        call(asm={**asm, "Hij": asm["Hij"].double()})
    with pytest.raises(ValueError):
        call(asm={**asm, "Hii": asm["Hii"].transpose(1, 2)})
    with pytest.raises(ValueError):
        call(asm={**asm, "bp": asm["bp"][:-1]})
    with pytest.raises(ValueError):
        call(edge_ij=graph.edge_ij.long())
    with pytest.raises(ValueError):
        call(lists=(lists[0], lists[1][:-1]))

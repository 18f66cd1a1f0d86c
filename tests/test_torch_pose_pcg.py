"""The pose graph's PCG kernel (ops/cuda/pose_pcg.py) on the CPU: the
incidence lists it sums by, the arithmetic of its matvec in those lists'
order, and the routing that keeps the CPU solve on `_solve_pcg`. The
kernel itself runs only on the card (tests/test_torch_pose_pcg_cuda.py)."""

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch import cli
from lidar_slam_tpu_torch.bench import circle_graph, shuttle_graph
from lidar_slam_tpu_torch.config import load_config
from lidar_slam_tpu_torch.models import graph_optimizer as G
from lidar_slam_tpu_torch.ops.cuda import pose_pcg
from lidar_slam_tpu_torch.utils import watchdog


def _shuttle():
    b = G.PoseGraphBuilder(512, 256, 256, device="cpu")
    shuttle_graph(b, np.random.default_rng(0), n=150, loops=12, lap=40)
    return b.to_graph()


def _circle():
    b = G.PoseGraphBuilder(64, 80, 8, device="cpu")
    circle_graph(b, 50, 20.0, np.random.default_rng(1))
    return b.to_graph()


def _holes():
    """Invalid rows between valid ones, repeated node pairs, a node with
    several edges on each side and several priors, a fixed node inside."""
    b = G.PoseGraphBuilder(16, 16, 8, device="cpu")
    rng = np.random.default_rng(2)
    for k in range(10):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [k, 0.1 * k, 0.0]
        b.add_se3_node(T, fixed=k in (0, 6))
    for i, j in ((0, 1), (1, 2), (2, 3), (3, 1), (3, 4), (4, 5), (5, 6), (6, 7), (7, 8), (8, 9), (1, 3), (9, 3)):
        Z = np.eye(4, dtype=np.float32)
        Z[:3, 3] = [j - i, 0.0, 0.0] + rng.normal(0, 0.05, 3)
        b.add_se3_edge(i, j, Z, noise=[0.5, 0.5, 0.5, 0.01, 0.01, 0.01])
    for node in (3, 3, 5, 0, 9):
        b.add_se3_prior_xyz_edge(node, [node, 0.0, 0.0], noise=[2.0, 2.0, 2.0])
    b.add_se3_prior_quat_edge(3, [1.0, 0.0, 0.0, 0.0], noise=[0.1, 0.1, 0.1])
    g = b.to_graph()
    g.edge_valid[[2, 7, 13]] = False  # 13 is padding already
    g.prior_valid[[1, 4]] = False
    return g


GRAPHS = {"shuttle": _shuttle, "circle": _circle, "holes": _holes}


def _lists(g):
    return pose_pcg.incidence(g.edge_ij, g.edge_valid, g.prior_node, g.prior_valid, g.poses.shape[0])


@pytest.mark.parametrize("name", GRAPHS)
def test_incidence_lists_the_valid_rows_in_input_order(name):
    g = GRAPHS[name]()
    order, offsets = _lists(g)
    n, n_edges = g.poses.shape[0], g.edge_ij.shape[0]
    ij, ev = g.edge_ij.numpy(), g.edge_valid.numpy()
    pn, pv = g.prior_node.numpy(), g.prior_valid.numpy()
    assert order.dtype == offsets.dtype == torch.int32 and offsets.shape == (n + 1,)
    for v in range(n):
        want = ([e for e in range(n_edges) if ev[e] and ij[e, 0] == v]
                + [n_edges + e for e in range(n_edges) if ev[e] and ij[e, 1] == v]
                + [2 * n_edges + p for p in range(len(pn)) if pv[p] and pn[p] == v])
        assert order[offsets[v]:offsets[v + 1]].tolist() == want, v
    assert int(offsets[0]) == 0 and int(offsets[-1]) == 2 * int(ev.sum()) + int(pv.sum())


@pytest.mark.parametrize("name", GRAPHS)
def test_sums_in_list_order_are_the_segment_sums(name):
    """Each group (edges as i, as j, priors) summed from 0 in the lists'
    order gives `_segment_sum`'s bits on every free node; the three
    together give the diagonal blocks and the gradient."""
    g = GRAPHS[name]()
    asm = G._assemble(g, G.GraphOptimizerConfig())
    order, offsets = _lists(g)
    n, ne = asm["n"], g.edge_ij.shape[0]
    groups = {"i": (asm["Hii"], asm["bi"], asm["i"]), "j": (asm["Hjj"], asm["bj"], asm["j"]),
              "pn": (asm["Hp"], asm["bp"], asm["pn"])}
    plain = {k: (G._segment_sum(H, idx, n), G._segment_sum(bv, idx, n)) for k, (H, bv, idx) in groups.items()}
    D = G._diag_blocks(asm)
    grad = G._gradient(asm)
    free = asm["free"].numpy()
    assert free.sum() > 0
    for v in np.nonzero(free)[0]:
        acc = {k: (torch.zeros(6, 6), torch.zeros(6)) for k in groups}
        for code in order[offsets[v]:offsets[v + 1]].tolist():
            k, row = ("i", code) if code < ne else ("j", code - ne) if code < 2 * ne else ("pn", code - 2 * ne)
            H, bv, _ = groups[k]
            acc[k] = (acc[k][0] + H[row], acc[k][1] + bv[row])
        for k in groups:
            assert torch.equal(acc[k][0], plain[k][0][v]) and torch.equal(acc[k][1], plain[k][1][v]), (v, k)
        total_D = acc["i"][0] + acc["j"][0] + acc["pn"][0]
        total_b = acc["i"][1] + acc["j"][1] + acc["pn"][1]
        torch.testing.assert_close(total_D, D[v], rtol=1e-6, atol=1e-6 * float(D[v].abs().max()))
        torch.testing.assert_close(total_b, grad[v], rtol=1e-6, atol=1e-6 * float(grad[v].abs().max()))


@pytest.mark.parametrize("name", GRAPHS)
def test_list_matvec_is_the_plain_matvec(name):
    """The kernel's matvec: D_n p_n plus, over the node's edge entries,
    Hij p_j (as i) or Hij^T p_i (as j), skipping fixed neighbours; the
    plain `_matvec` within float32 rounding, on a p that is 0 off the free
    nodes (as the PCG's is)."""
    g = GRAPHS[name]()
    asm = G._assemble(g, G.GraphOptimizerConfig())
    order, offsets = _lists(g)
    ne = g.edge_ij.shape[0]
    free = asm["free"]
    p = torch.as_tensor(np.random.default_rng(3).normal(size=(asm["n"], 6)).astype(np.float32)) * free[:, None]
    D = G._diag_blocks(asm)
    ij = g.edge_ij.long()
    y = torch.zeros_like(p)
    for v in torch.nonzero(free).flatten().tolist():
        acc = D[v] @ p[v]
        for code in order[offsets[v]:offsets[v + 1]].tolist():
            if code >= 2 * ne:
                break  # the priors follow the edges; their blocks are in D
            e, as_j = (code, False) if code < ne else (code - ne, True)
            other = int(ij[e, 0] if as_j else ij[e, 1])
            if not free[other]:
                continue
            acc = acc + (asm["Hij"][e].T if as_j else asm["Hij"][e]) @ p[other]
        y[v] = acc
    want = G._matvec(asm, 0.0, p)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_cpu_solve_never_launches():
    g = _shuttle()
    run = watchdog.RunHealth()
    before = pose_pcg.launches
    with run.active():
        _, stats = G.optimize_pose_graph(g, G.GraphOptimizerConfig(max_iterations=3, solver="pcg", pcg_iters=10))
    assert pose_pcg.launches == before and stats["iterations"] == 3
    (sp,) = [s for s in run.spans() if s.name == "pose_graph"]
    assert sp.counts["pcg_launches"] == 0 and sp.counts["lm_iterations"] == 3


def test_wrapper_refuses_cpu_tensors():
    g = _circle()
    asm = G._assemble(g, G.GraphOptimizerConfig())
    with pytest.raises(ValueError, match="CUDA"):
        pose_pcg.pose_pcg(asm, g.edge_ij, _lists(g), torch.zeros(()), 1e-6, 10)


def test_mapping_builds_the_kernel_where_it_solves_on_cuda():
    cfg = load_config(None)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert "pose_pcg" in cli._path_kernels([cfg.loop_closing.ndt], cuda, pose_graph=True)
    assert "pose_pcg" not in cli._path_kernels([cfg.front_end.ndt], cuda)
    assert cli._path_kernels([cfg.loop_closing.ndt], cpu, pose_graph=True) == []

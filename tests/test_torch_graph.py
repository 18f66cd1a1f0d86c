"""Parity of the port's SE(3) additions and pose-graph optimizer with the JAX
package.

The graphs are `test_graph_optimizer.build_noisy_loop`'s, built once by the
JAX builder and carried across with `convert.pose_graph_from_numpy`, so both
packages solve the same arrays. Tolerances: residuals, Jacobians and steps
to float32 rounding of reordered sums (stated per test); an optimized graph
to 1e-4 in every pose entry and 1e-4 relative in chi2. The LM iteration
counts are not compared: near convergence an accept or reject turns on
float32 noise in chi2 (the JAX package itself differs by solver there).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.geom import se3 as jse3
from lidar_slam_tpu.models import graph_optimizer as jg

from lidar_slam_tpu_torch import convert
from lidar_slam_tpu_torch import geom as tgeom
from lidar_slam_tpu_torch.models import graph_optimizer as tg

from test_graph_optimizer import build_noisy_loop

POSE_ATOL = 1e-4
CHI2_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch's small CPU ops run faster on one thread than on a pool that
    parallel test workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(graph):
    return {f.name: np.asarray(getattr(graph, f.name)) for f in dataclasses.fields(jg.PoseGraph)}


def _port(graph):
    return convert.pose_graph_from_numpy(_fields(graph), device="cpu")


def _np(x):
    return x.detach().cpu().numpy()


def _rotations():
    """Random rotations, plus one for each Shepperd pivot: near the identity
    (trace), and a half turn about x, y and z (the diagonal entry)."""
    rng = np.random.default_rng(0)
    R = np.array(jse3.so3_exp(jnp.asarray(rng.normal(0, 1.2, (32, 3)).astype(np.float32))))
    axes = np.float32([[0.05, 0.02, -0.01], [3.1, 0.1, 0.05], [0.1, 3.1, -0.05], [0.05, -0.1, 3.1]])
    return np.concatenate([R, np.asarray(jse3.so3_exp(jnp.asarray(axes)))]).astype(np.float32)


class TestSE3Additions:
    def test_matrix_to_quat_all_pivots(self):
        R = _rotations()
        m = R
        pivots = np.stack([np.trace(m, axis1=1, axis2=2), m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                           m[:, 1, 1] - m[:, 0, 0] - m[:, 2, 2], m[:, 2, 2] - m[:, 0, 0] - m[:, 1, 1]], -1)
        assert set(np.argmax(pivots[-4:], axis=1)) == {0, 1, 2, 3}
        qj = np.asarray(jse3.matrix_to_quat(jnp.asarray(R)))
        qt = _np(tgeom.matrix_to_quat(torch.as_tensor(R)))
        np.testing.assert_allclose(qt, qj, atol=1e-6)
        assert np.all(qt[:, 0] >= 0.0)
        np.testing.assert_allclose(_np(tgeom.quat_to_matrix(torch.as_tensor(qt))),
                                   np.asarray(jse3.quat_to_matrix(jnp.asarray(qj))), atol=1e-6)
        np.testing.assert_allclose(_np(tgeom.quat_to_matrix(torch.as_tensor(qt))), R, atol=2e-6)

    def test_euler_zyx_and_compose(self):
        rng = np.random.default_rng(1)
        ang = rng.uniform(-1.2, 1.2, size=(3, 32)).astype(np.float32)
        Rj = np.array(jse3.euler_zyx_to_matrix(*(jnp.asarray(a) for a in ang)))
        Rt = _np(tgeom.euler_zyx_to_matrix(*(torch.as_tensor(a) for a in ang)))
        np.testing.assert_allclose(Rt, Rj, atol=1e-6)
        for a_t, a_j, a in zip(tgeom.matrix_to_euler_zyx(torch.as_tensor(Rj)),
                               jse3.matrix_to_euler_zyx(jnp.asarray(Rj)), ang):
            np.testing.assert_allclose(_np(a_t), np.asarray(a_j), atol=1e-5)
            np.testing.assert_allclose(_np(a_t), a, atol=1e-4)
        T = np.array(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.5, (2, 8, 6)).astype(np.float32))))
        np.testing.assert_allclose(_np(tgeom.pose_compose(torch.as_tensor(T[0]), torch.as_tensor(T[1]))),
                                   np.asarray(jse3.pose_compose(jnp.asarray(T[0]), jnp.asarray(T[1]))), atol=1e-6)


def _loop_with_quat_priors():
    """build_noisy_loop with GNSS priors, a loop edge and orientation priors
    on every other node."""
    builder, gt, _ = build_noisy_loop(n=20, drift=0.03, with_loop=True, with_gnss=True)
    for i in range(0, 20, 2):
        q = np.asarray(jse3.matrix_to_quat(jnp.asarray(gt[i][:3, :3])))
        builder.add_se3_prior_quat_edge(i, q, noise=[0.05, 0.05, 0.05])
    return builder


class TestResidualsAndSteps:
    @pytest.mark.parametrize("kernel", ["none", "huber"])
    def test_residuals_jacobians_chi2(self, kernel):
        """Edge and typed-prior residuals and Jacobians (atol 2e-5) and chi2
        (rtol 1e-5)."""
        g = _loop_with_quat_priors().to_graph()
        t = _port(g)
        for jf, tf in ((jg._edge_residuals_jacobians, tg._edge_residuals_jacobians),
                       (jg._prior_residuals_jacobians, tg._prior_residuals_jacobians)):
            for a, b in zip(jf(g), tf(t)):
                np.testing.assert_allclose(_np(b), np.asarray(a), atol=2e-5)
        cfg_j = jg.GraphOptimizerConfig(robust_kernel=kernel, robust_delta=0.05)
        cfg_t = tg.GraphOptimizerConfig(robust_kernel=kernel, robust_delta=0.05)
        np.testing.assert_allclose(float(tg.graph_chi2(t, cfg_t)), float(jg.graph_chi2(g, cfg_j)), rtol=1e-5)

    def test_assembly_and_both_steps(self):
        """Gradient and block diagonal (atol 1e-4 against entries up to
        ~1e3), and the dense and PCG steps from the same blocks (atol 1e-4)."""
        g = _loop_with_quat_priors().to_graph()
        t = _port(g)
        cfg_j, cfg_t = jg.GraphOptimizerConfig(), tg.GraphOptimizerConfig()
        aj, at = jg._assemble(g, cfg_j), tg._assemble(t, cfg_t)
        bj, bt = jg._gradient(aj), tg._gradient(at)
        np.testing.assert_allclose(_np(bt), np.asarray(bj), atol=1e-4)
        np.testing.assert_allclose(_np(tg._diag_blocks(at)), np.asarray(jg._diag_blocks(aj)), atol=1e-4)
        lam = 1e-3
        x = np.float32(np.random.default_rng(2).normal(size=bj.shape))
        np.testing.assert_allclose(_np(tg._matvec(at, lam, torch.as_tensor(x))),
                                   np.asarray(jg._matvec(aj, lam, jnp.asarray(x))), atol=1e-3, rtol=1e-5)
        dj = np.asarray(jg._solve_dense(aj, jnp.float32(lam), bj))
        dt = _np(tg._solve_dense(at, torch.tensor(lam), bt))
        np.testing.assert_allclose(dt, dj, atol=1e-4)
        pj = np.asarray(jg._solve_pcg(aj, jnp.float32(lam), bj, cfg_j))
        pt = _np(tg._solve_pcg(at, torch.tensor(lam), bt, cfg_t))
        np.testing.assert_allclose(pt, pj, atol=1e-4)
        np.testing.assert_allclose(pt, dt, atol=1e-3)

    def test_solver_rule_is_on_capacity(self):
        cfg = tg.GraphOptimizerConfig()
        assert tg.uses_dense(cfg, 682) and not tg.uses_dense(cfg, 683)
        assert not tg.uses_dense(cfg, 2048)  # the back end's default capacity takes PCG
        assert tg.uses_dense(tg.GraphOptimizerConfig(solver="dense"), 2048)
        assert not tg.uses_dense(tg.GraphOptimizerConfig(solver="pcg"), 8)


def _outlier_loop():
    builder, _, _ = build_noisy_loop(n=24, drift=0.015, seed=5)
    bad = np.eye(4, dtype=np.float32)
    bad[:3, 3] = [5.0, -3.0, 1.0]
    builder.add_se3_edge(5, 15, bad, noise=[0.5, 0.5, 0.5, 0.1, 0.1, 0.1])
    return builder


GRAPHS = {
    "dense": (lambda: build_noisy_loop(n=20, drift=0.02, seed=3)[0], dict(max_iterations=30, solver="dense")),
    "pcg": (lambda: build_noisy_loop(n=20, drift=0.02, seed=3)[0], dict(max_iterations=30, solver="pcg")),
    "huber_outlier": (_outlier_loop, dict(max_iterations=40, robust_kernel="huber", robust_delta=1.0)),
    "gnss_quat_priors": (_loop_with_quat_priors, dict(max_iterations=50)),
}


@pytest.mark.parametrize("case", GRAPHS)
def test_optimize_matches_reference(case):
    make, cfg = GRAPHS[case]
    builder = make()
    g = builder.to_graph()
    jo, js = jg.optimize_pose_graph(g, jg.GraphOptimizerConfig(**cfg))
    to, ts = tg.optimize_pose_graph(_port(g), tg.GraphOptimizerConfig(**cfg))
    assert float(js["chi2_after"]) < float(js["chi2_before"])
    np.testing.assert_allclose(ts["chi2_before"], float(js["chi2_before"]), rtol=1e-6)
    np.testing.assert_allclose(ts["chi2_after"], float(js["chi2_after"]), rtol=CHI2_RTOL)
    np.testing.assert_allclose(_np(to.poses), np.asarray(jo.poses), atol=POSE_ATOL)
    assert 0 < ts["iterations"] <= cfg["max_iterations"]
    for name, leaf in _fields(g).items():  # only the poses move
        if name != "poses":
            np.testing.assert_array_equal(_np(getattr(to, name)), leaf)


def test_builder_grows_and_matches_reference():
    """Both builders grow by doubling from the same calls and hold the same
    arrays; the port's grown graph solves to chi2 ~ 0, as the JAX test's."""
    T = np.eye(4, dtype=np.float32)
    builders = (jg.PoseGraphBuilder(max_nodes=4, max_edges=4, max_priors=2),
                tg.PoseGraphBuilder(max_nodes=4, max_edges=4, max_priors=2, device="cpu"))
    for b in builders:
        for i in range(10):
            b.add_se3_node(T, fixed=(i == 0))
        for i in range(9):
            b.add_se3_edge(i, i + 1, T, noise=[1, 1, 1, 1, 1, 1])
        for i in range(5):
            b.add_se3_prior_xyz_edge(i, T[:3, 3], noise=[1, 1, 1])
        b.add_se3_prior_quat_edge(6, [-1.0, 0.0, 0.0, 0.0], noise=[1, 1, 1])
    jb, tb = builders
    assert (tb.max_nodes, tb.max_edges, tb.max_priors) == (16, 16, 8) == (jb.max_nodes, jb.max_edges, jb.max_priors)
    want = _fields(jb.to_graph())
    got = tb.to_graph()
    for name, leaf in want.items():
        assert _np(getattr(got, name)).dtype == leaf.dtype, name
        np.testing.assert_array_equal(_np(getattr(got, name)), leaf)
    _, stats = tb.optimize(tg.GraphOptimizerConfig())
    assert stats["chi2_after"] < 1e-6
    np.testing.assert_array_equal(tb.node_poses(), np.tile(T, (10, 1, 1)))


@pytest.mark.parametrize("nodes,solver,iterations", [(366, "dense", 3), (6144, "pcg", 2)])
def test_solve_does_not_follow_thread_count(nodes, solver, iterations):
    """bench.py's circle graph solved at one torch thread and at eight:
    the same poses to the bit and the same LM iterations and chi2. A CPU
    solve runs on one thread whatever the setting: at eight, LAPACK's
    blocked Cholesky (6N = 2 196 rows) and the PCG's dot products (6N =
    36 864 entries, past the size torch sums on one thread) split their
    work, and their rounding, among the threads."""
    from lidar_slam_tpu_torch.bench import circle_graph

    builder = tg.PoseGraphBuilder(max_nodes=nodes, max_edges=nodes, max_priors=16, device="cpu")
    circle_graph(builder, nodes, 50.0, np.random.default_rng(0))
    graph = builder.to_graph()
    cfg = tg.GraphOptimizerConfig(max_iterations=iterations, solver=solver)
    runs = []
    for threads in (1, 8):
        torch.set_num_threads(threads)
        try:
            out, stats = tg.optimize_pose_graph(graph, cfg)
        finally:
            torch.set_num_threads(1)
        runs.append((_np(out.poses), stats))
    (p1, s1), (p8, s8) = runs
    assert s1 == s8 and s1["chi2_after"] < s1["chi2_before"]
    np.testing.assert_array_equal(p1, p8)


def test_pose_graph_from_numpy_keeps_every_leaf():
    g = _loop_with_quat_priors().to_graph()
    fields = {name: leaf.copy() for name, leaf in _fields(g).items()}
    t = convert.pose_graph_from_numpy(fields, device="cpu")
    for name, leaf in fields.items():
        got = getattr(t, name)
        assert got.device.type == "cpu" and got.dtype == torch.from_numpy(leaf).dtype
        np.testing.assert_array_equal(_np(got), leaf)
    fields["poses"][0, 0, 0] = 7.0  # the port's graph holds its own copy
    assert float(t.poses[0, 0, 0]) != 7.0

"""The port's whole-alignment Newton kernel (`ops/cuda/ndt_newton.py`) on
the CPU: its pose math against the host functions and the JAX package,
its plain version against the JAX package's ndt_align and the port's host
loop, and the routing of ndt_align.

Inputs are made with numpy from a seed; the JAX side runs on the CPU (its
fused Pallas kernel in interpret mode). The CUDA kernel itself is held
against `ndt_newton_plain` on the card by tests/test_torch_cuda.py.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu.models.registration import ndt as jndt
from lidar_slam_tpu.ops import PointCloud as JCloud

from lidar_slam_tpu_torch.models.registration import ndt as tndt
from lidar_slam_tpu_torch.ops import PointCloud as TCloud
from lidar_slam_tpu_torch.ops.cuda import ndt_fused, ndt_newton

import test_torch_cuda
import test_torch_ndt
from test_torch_ndt import CFG_J, CFG_T, ORIGIN, make_scene, port_map_of

CSRC = Path(__file__).resolve().parents[1] / "lidar_slam_tpu_torch" / "csrc"
POSES = [
    [0.1, -0.2, 0.3, 0.2, -0.4, 0.7],
    [0.0, 0.0, 0.0, 5e-5, -0.3, 1e-5],  # two angles under the 1e-4 snap
    [1.5, 2.0, -0.5, -9.9e-5, 1e-4, -3.0],  # at the snap's edge, and a large yaw
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
]
ULP1 = np.spacing(np.float32(1.0))  # one float32 ulp at the scale of a sine


def _packed(R, t, jang, hang):
    """Pose coefficients in the kernel's layout (`_pack_params`' first 93)."""
    p = ndt_fused._pack_params(np.zeros(3), R, t, jang, hang, (1, 1, 1), 1.0, 1.0, 1.0, 1, True)
    return np.frombuffer(bytes(p), np.float32)[:93]


def _host_packed(pose):
    """The host loop's coefficients for `pose`."""
    pose = np.asarray(pose, np.float32)
    R, jang, hang = tndt._pose_coefficients(pose)
    return _packed(R, pose[:3], jang, hang)


@pytest.mark.parametrize("pose", POSES)
def test_pose_coefficients_match_host_and_reference(pose):
    """The kernel's pose math in torch float32 against the host loop's
    (`_pose_coefficients`) in `_pack_params`' layout: within one float32 ulp
    (the two libraries' sin and cos may round differently), and equal to
    the bit when both take numpy's sines and cosines. JAX's angle tensors
    agree to the 1e-6 of test_torch_ndt.py."""
    pose = np.asarray(pose, np.float32)
    host = _host_packed(pose)
    torch_coef = ndt_newton.pose_coefficients(torch.as_tensor(pose))
    np.testing.assert_allclose(_packed(*torch_coef), host, rtol=0, atol=ULP1)

    c, s = np.cos(pose[3:]), np.sin(pose[3:])
    small = np.abs(pose[3:]) < np.float32(ndt_newton.ANGLE_SNAP)
    cs, ss = np.where(small, np.float32(1), c), np.where(small, np.float32(0), s)
    rot = (c[0], s[0], c[1], s[1], c[2], s[2])
    R, J, H = ndt_newton.coefficient_terms(rot, (cs[0], ss[0], cs[1], ss[1], cs[2], ss[2]), np.float32(0))
    np.testing.assert_array_equal(np.float32(R + list(pose[:3]) + J + H), host)

    R_t, _, jang_t, hang_t = torch_coef
    jj, jh = jndt._angle_jacobian_tensors(jnp.asarray(pose))
    np.testing.assert_allclose(jang_t.numpy(), np.asarray(jj), atol=1e-6)
    np.testing.assert_allclose(hang_t.numpy(), np.asarray(jh), atol=1e-6)
    T = np.asarray(jndt._pose_to_matrix(jnp.asarray(pose)))
    np.testing.assert_allclose(R_t.numpy(), T[:3, :3], atol=1e-6)


class _Sym:
    """A scalar that records the CUDA expression of what is done to it."""

    def __init__(self, e):
        self.e = e

    def __mul__(self, o):
        return _Sym(f"__fmul_rn({self.e}, {o.e})")

    def __add__(self, o):
        return _Sym(f"__fadd_rn({self.e}, {o.e})")

    def __sub__(self, o):
        return _Sym(f"__fsub_rn({self.e}, {o.e})")

    def __neg__(self):
        return _Sym(f"-{self.e}")


def test_kernel_source_has_the_coefficient_terms():
    """csrc/ndt_newton.cu computes the pose coefficients with exactly the
    expressions of `coefficient_terms`, each product and sum rounded on its
    own, in the kernel's layout (the CUDA side has no CPU mode, so the
    texts are compared)."""
    rot = [_Sym(n) for n in ("ca", "sa", "cb", "sb", "cc", "sc")]
    ang = [_Sym(n) for n in ("cx", "sx", "cy", "sy", "cz", "sz")]
    R, J, H = ndt_newton.coefficient_terms(rot, ang, _Sym("0.0f"))
    want = [f"c[{k} + {i}] = {e.e};" for k, terms in (("kR", R), ("kJ", J), ("kH", H)) for i, e in enumerate(terms)]
    src = (CSRC / "ndt_newton.cu").read_text()
    block = src[src.index("// BEGIN coefficient_terms"):src.index("// END coefficient_terms")]
    got = [ln.strip() for ln in block.splitlines()[1:] if ln.strip()]
    assert got == want
    # the snap, the cosines and sines, and t follow the same definitions
    for ln in ("cosf(p[3]), sa = sinf(p[3])", "fabsf(p[3]) < 1e-4f", "cx = snap_x ? 1.0f : ca, sx = snap_x ? 0.0f : sa",
               "c[kT + 0] = p[0];"):
        assert ln in src, ln
    assert float(re.search(r"fabsf\(p\[4\]\) < ([0-9.e-]+)f", src).group(1)) == ndt_newton.ANGLE_SNAP


def test_ldlt_solve_on_torch_scalars():
    """The LDL^T on torch scalars (the plain version's) and on numpy
    scalars (the host loop's) follow one operation order: equal to the bit
    in float32, and both match the JAX package's _solve_newton."""
    rng = np.random.default_rng(0)
    for _ in range(4):
        A = rng.normal(size=(6, 6)).astype(np.float32)
        H = (A @ A.T - 2.0 * np.eye(6)).astype(np.float32)  # indefinite
        g = rng.normal(size=6).astype(np.float32)
        t = torch.stack(ndt_newton.ldlt_solve(torch.as_tensor(H), torch.as_tensor(g), 1.0)).numpy()
        np.testing.assert_array_equal(t, tndt._solve_newton(H, g))
        np.testing.assert_allclose(t, np.asarray(jndt._solve_newton(jnp.asarray(H), jnp.asarray(g))),
                                   rtol=1e-4, atol=1e-5)
    z = torch.stack(ndt_newton.ldlt_solve(torch.zeros(6, 6), torch.zeros(6), 1.0))
    assert not torch.isfinite(z).all()  # the empty map's degenerate step


def _fused_setup(stencil, max_iter=30, score_rel_tol=0.0):
    """test_torch_ndt.py's TestAlignSide._fused_setup (tests/test_ndt.py::
    TestFusedKernel's scene: map, weighted source, perturbed guess) with
    the configurations of both packages."""
    kw = dict(stencil=stencil, max_compact_voxels=2048, max_iter=max_iter, score_rel_tol=score_rel_tol)
    cfg_j = dataclasses.replace(CFG_J, **kw)
    cfg_t = dataclasses.replace(CFG_T, gather="fused", **kw)
    _, jm, src, w, guess = test_torch_ndt.TestAlignSide._fused_setup(None, cfg_j, cfg_t)
    return cfg_j, cfg_t, jm, src, w, guess


@pytest.mark.parametrize("stencil", ["direct7", "radius27"])
def test_plain_matches_reference_align(stencil):
    """ndt_align through ndt_newton's plain version against the JAX
    package's ndt_align (max_step_iterations = 0), weighted source, on the
    JAX map carried over: the same optimum, atol 5e-3 (test_align_parity)."""
    cfg_j, cfg_t, jm, src, w, guess = _fused_setup(stencil)
    rj = jndt.ndt_align(jm, JCloud.from_points(src, weights=w), jnp.asarray(guess), cfg_j)
    rt = tndt.ndt_align(port_map_of(jm), TCloud.from_points(src, weights=w), torch.as_tensor(guess), cfg_t)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=5e-3)
    assert rt.unresolved == 0.0 and rt.converged
    np.testing.assert_allclose(rt.score, float(rj.score), rtol=1e-3)
    np.testing.assert_allclose(float(rt.trans_probability), float(rj.trans_probability), rtol=1e-3)


@pytest.mark.parametrize(
    "stencil,max_iter,score_rel_tol,iterations",
    [("direct7", 30, 0.0, 7), ("radius27", 30, 0.0, 7), ("direct7", 2, 0.0, 3), ("radius27", 30, 1e-2, 6)],
)
def test_plain_matches_host_loop(stencil, max_iter, score_rel_tol, iterations):
    """ndt_newton_plain against the port's host newton_align on the same
    map and weighted source: the same iteration count and flags, the pose
    within 1e-5, the score, gradient and Hessian at it to float32 rounding
    (the sums are the same function; only the pose math's sin and cos may
    round differently, and at the optimum the gradient moves by the
    Hessian, up to ~2e7 here, times the pose difference). Covers the
    iteration cap (max_iter 2: 3 iterations, not converged) and the score
    plateau (6 iterations where 7 converge)."""
    _, cfg, jm, src, w, guess = _fused_setup(stencil, max_iter, score_rel_tol)
    m, cloud = port_map_of(jm), TCloud.from_points(src, weights=w)
    plain = tndt.ndt_align(m, cloud, torch.as_tensor(guess), cfg)
    host = tndt.ndt_align_host_loop(m, cloud, torch.as_tensor(guess), cfg)
    assert plain.iterations == host.iterations == iterations
    assert plain.converged == host.converged == (max_iter > 2)
    np.testing.assert_allclose(plain.pose.numpy(), host.pose.numpy(), atol=1e-5)
    np.testing.assert_allclose(plain.score, host.score, rtol=1e-5)
    h = np.abs(host.hessian.numpy()).max()
    np.testing.assert_allclose(plain.gradient.numpy(), host.gradient.numpy(), rtol=0, atol=1e-5 * h)
    np.testing.assert_allclose(plain.hessian.numpy(), host.hessian.numpy(), rtol=1e-4, atol=1e-5 * h)
    np.testing.assert_allclose(float(plain.trans_probability), float(host.trans_probability), rtol=1e-5)


@pytest.mark.parametrize("stencil,orders", [("direct7", range(3)), ("radius27", range(3, 9))])
def test_plain_order_sensitivity(stencil, orders, capsys):
    """Why tests/test_torch_cuda.py holds the kernel to trans_eps, not
    1e-4, on its 5000-point scene from its far start (the second of
    NEWTON_POSES, 14-16 iterations): ndt_newton_plain alone, given the same
    points in another order, so that its float32 sums round otherwise,
    stops elsewhere: some order tried moves the pose by more than the
    1e-4 a near start is held to (by 0.6-5 mm), and every order stays within
    trans_eps and two iterations. The test pins torch to one CPU thread:
    the map build gives the same stats at any thread count (scatter_sum's
    fixed-order CPU path), but the plain version's own torch reductions
    split their sums by thread count, so the readings (printed, pytest -s)
    would follow the thread count a test worker was given, and at some
    counts no order tried moves the pose past 1e-4."""
    N = ndt_newton
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m, src, mask, w = test_torch_cuda._inputs(torch.device("cpu"))
        args, kw = test_torch_cuda._newton_call(m, src, mask, w, test_torch_cuda.NEWTON_POSES[1], stencil)
        base = N.ndt_newton_plain(*args, **kw).numpy()
        readings = []
        for seed in orders:
            perm = torch.as_tensor(np.random.default_rng(seed).permutation(len(src)))
            o = N.ndt_newton_plain(src[perm], mask[perm], w[perm], *args[3:], **kw).numpy()
            readings.append((int(o[N.ITERATIONS]), float(np.abs(o[N.POSE] - base[N.POSE]).max())))
    finally:
        torch.set_num_threads(threads)
    with capsys.disabled():
        print(f"\n[order sensitivity {stencil}] plain {int(base[N.ITERATIONS])} iterations; reordered "
              f"(iterations, max |pose - plain|): {readings}")
    assert all(o[1] <= kw["trans_eps"] and abs(o[0] - base[N.ITERATIONS]) <= 2 for o in readings), readings
    assert max(o[1] for o in readings) > 1e-4, readings


def test_empty_map_keeps_the_guess():
    m = tndt.finalize_ndt_sums(tndt.empty_ndt_sums(ORIGIN, CFG_T), CFG_T)
    guess = torch.eye(4)
    guess[:3, 3] = torch.tensor([0.5, -0.25, 0.125])
    src = TCloud.from_points(make_scene(3, 20, seed=0))
    r = tndt.ndt_align(m, src, guess, dataclasses.replace(CFG_T, gather="fused"))
    np.testing.assert_allclose(r.pose.numpy(), guess.numpy(), atol=1e-6)
    assert r.converged and r.iterations == 1 and r.score == 0.0


def test_align_routes_to_plain_on_cpu(monkeypatch):
    """On CPU tensors ndt_align takes ndt_newton's plain version for the
    fused Newton configuration, and the host loop for every other one,
    solver="lm" among them, whose every evaluation goes through K1's
    wrapper (its plain version here); no kernel is launched either way."""
    calls = []
    plain = ndt_newton.ndt_newton_plain
    monkeypatch.setattr(ndt_newton, "ndt_newton_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    host = []
    loop = tndt.ndt_align_host_loop
    monkeypatch.setattr(tndt, "ndt_align_host_loop", lambda *a, **k: host.append(1) or loop(*a, **k))
    _, cfg, jm, src, w, guess = _fused_setup("direct7")
    m, cloud, g = port_map_of(jm), TCloud.from_points(src, weights=w), torch.as_tensor(guess)
    before = (ndt_newton.launches, ndt_fused.launches)
    r = tndt.ndt_align(m, cloud, g, cfg)
    assert calls == [1] and host == [] and r.converged
    for other in (dict(gather="auto"), dict(gather="two_level"), dict(max_step_iterations=3)):
        tndt.ndt_align(m, cloud, g, dataclasses.replace(cfg, **other))
    assert calls == [1] and host == [1, 1, 1]
    k1 = []
    k1_plain = ndt_fused.ndt_reduce_plain
    monkeypatch.setattr(ndt_fused, "ndt_reduce_plain", lambda *a, **k: k1.append(1) or k1_plain(*a, **k))
    lm = tndt.ndt_align(m, cloud, g, dataclasses.replace(cfg, solver="lm"))
    assert calls == [1] and host == [1, 1, 1, 1] and len(k1) == lm.iterations + 1 >= 2
    np.testing.assert_allclose(lm.pose.numpy(), r.pose.numpy(), atol=5e-3)
    assert (ndt_newton.launches, ndt_fused.launches) == before


def test_wrapper_output_layout():
    """ndt_newton's [NOUT] result on CPU tensors: the layout ndt_align
    unpacks, with the masked-in count and a trace of the evaluated poses."""
    _, cfg, jm, src, w, guess = _fused_setup("direct7")
    m = port_map_of(jm)
    mask = np.ones(len(src), bool)
    mask[:24] = False
    d1, d2 = cfg.gauss_params()
    pose0 = torch.as_tensor(tndt._matrix_to_pose(guess))
    trace = []
    out = ndt_newton.ndt_newton_plain(
        torch.as_tensor(src), torch.as_tensor(mask), torch.as_tensor(w), m.index, m.packed, m.origin, pose0,
        dims=m.dims, resolution=m.resolution, d1=float(np.float32(d1)), d2=float(np.float32(d2)), stencil="direct7",
        weight_derivatives=True, max_iter=30, trans_eps=cfg.trans_eps, step_size=cfg.step_size, score_rel_tol=0.0,
        trace=trace,
    )
    assert out.shape == (ndt_newton.NOUT,) and out.dtype == torch.float32
    assert out[ndt_newton.N_VALID] == len(src) - 24 and out[ndt_newton.UNRESOLVED] == 0.0
    assert out[ndt_newton.CONVERGED] == 1.0 and len(trace) == int(out[ndt_newton.ITERATIONS]) + 1
    np.testing.assert_array_equal(trace[0], pose0.numpy())
    np.testing.assert_array_equal(trace[-1], out[ndt_newton.POSE].numpy())
    R = ndt_newton.pose_coefficients(out[ndt_newton.POSE])[0]
    np.testing.assert_array_equal(out[ndt_newton.ROTATION].numpy(), R.reshape(9).numpy())
    np.testing.assert_allclose(R.numpy(), tndt._pose_to_matrix(out[ndt_newton.POSE].numpy())[:3, :3].numpy(),
                               rtol=0, atol=ULP1)
    assert not out[ndt_newton.ROTATION.stop:].any()

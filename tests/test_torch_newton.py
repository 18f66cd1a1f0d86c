"""The port's whole-alignment Newton kernel (`ops/cuda/ndt_newton.py`) on
the CPU: its pose math against the host functions and the JAX package,
its plain version against the JAX package's ndt_align and the port's host
loop, and the routing of ndt_align.

Inputs are made with numpy from a seed; the JAX side runs on the CPU (its
fused Pallas kernel in interpret mode). The CUDA kernel itself is held
against `ndt_newton_plain` on the card by tests/test_torch_cuda.py.
"""

import ctypes
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


# Each kernel's pose math: the function that includes coefficient_terms.cuh, and the lines beside it
# that define the fragment's inputs. ndt_reduce.cuh's one-thread pose_coefficients (K1), and
# ndt_newton.cu's coefficient table, whose codes one warp evaluates, a coefficient a lane.
COEFFICIENT_FRAGMENT = "coefficient_terms.cuh"
COEFFICIENT_SOURCES = {
    "ndt_reduce.cuh": ("void pose_coefficients(", (
        "cosf(p[3]), sa = sinf(p[3])", "fabsf(p[3]) < 1e-4f", "cx = snap_x ? 1.0f : ca, sx = snap_x ? 0.0f : sa",
        "c[kT + 0] = p[0];")),
    "ndt_newton.cu": ("constexpr Table table() {", (
        "const float ang = p[3 + min(lane >> 1, 2u)];", "sincosf(ang, &sv, &cv);",
        "const float trig = lane & 1u ? sv : cv;", "fabsf(p[3]) < 1e-4f",
        "v = s & 1u ? 0.0f : 1.0f;  // cx = snap_x ? 1 : ca", "if (k >= kT && k < kJ) v = p[k - kT];",
        "const Sym ca{0}, sa{1}, cb{2}, sb{3}, cc{4}, sc{5}, cx{6}, sx{7}, cy{8}, sy{9}, cz{10}, sz{11};")),
}


@pytest.mark.parametrize("source", sorted(COEFFICIENT_SOURCES))
def test_kernel_source_has_the_coefficient_terms(source):
    """The kernels' device pose math has exactly the expressions of
    `coefficient_terms`, each product and sum rounded on its own, in the
    kernel's layout (the CUDA side has no CPU mode, so the texts are
    compared): the text that ndt_reduce.cuh's pose_coefficients (run by
    ndt_fused.cu for a pose on the card) and ndt_newton.cu's table (its
    warp's coefficient codes) each include, once, inside that function."""
    rot = [_Sym(n) for n in ("ca", "sa", "cb", "sb", "cc", "sc")]
    ang = [_Sym(n) for n in ("cx", "sx", "cy", "sy", "cz", "sz")]
    R, J, H = ndt_newton.coefficient_terms(rot, ang, _Sym("0.0f"))
    want = [f"c[{k} + {i}] = {e.e};" for k, terms in (("kR", R), ("kJ", J), ("kH", H)) for i, e in enumerate(terms)]
    function, definitions = COEFFICIENT_SOURCES[source]
    src = (CSRC / source).read_text()
    include = f'#include "{COEFFICIENT_FRAGMENT}"\n'
    assert src.count(include) == 1
    begin = src.index(function)
    assert begin < src.index(include) < src.index("\n}\n", begin)
    src = src.replace(include, (CSRC / COEFFICIENT_FRAGMENT).read_text())
    assert src.count("// BEGIN coefficient_terms") == 1
    block = src[src.index("// BEGIN coefficient_terms"):src.index("// END coefficient_terms")]
    got = [ln.strip() for ln in block.splitlines()[1:] if ln.strip()]
    assert got == want
    # the snap, the cosines and sines, and t follow the same definitions
    for ln in definitions:
        assert ln in src, ln
    assert float(re.search(r"fabsf\(p\[4\]\) < ([0-9.e-]+)f", src).group(1)) == ndt_newton.ANGLE_SNAP


class _Code:
    """A coefficient term as ndt_newton.cu's table codes it: 0, a product of
    factors taken from the left, or the sum or difference of two products;
    a factor is one of the 12 symbols (cosines and sines, then the snapped
    ones), perhaps negated."""

    def __init__(self, op="product", factors=()):
        self.op, self.factors = op, list(factors)

    def __mul__(self, o):
        assert self.op == "product" and len(self.factors) < 3 and o.op == "product" and len(o.factors) == 1
        return _Code("product", self.factors + o.factors)

    def __add__(self, o):
        return _Code("sum", [self.factors, o.factors])

    def __sub__(self, o):
        return _Code("difference", [self.factors, o.factors])

    def __neg__(self):
        (sym, neg), = self.factors
        return _Code("product", [(sym, not neg)])


def _evaluate_code(code, values):
    """The warp's evaluation of one coded term on float32 `values` [12]:
    ((f0 * f1) * f2) op ((f3 * f4) * f5), missing factors 1."""
    def prod(factors):
        f = [(-values[s] if neg else values[s]) for s, neg in factors] + [np.float32(1.0)] * (3 - len(factors))
        return (f[0] * f[1]) * f[2]

    if code.op == "zero":
        return np.float32(0.0)
    if code.op == "product":
        return prod(code.factors)
    p1, p2 = prod(code.factors[0]), prod(code.factors[1])
    return p1 + p2 if code.op == "sum" else p1 - p2


@pytest.mark.parametrize("pose", POSES + [[3.0, -1.0, 2.0, -1.2, 0.9, 2.5]])
def test_warp_coefficient_codes_keep_the_bits(pose):
    """ndt_newton.cu's warp evaluates every coefficient in one generic form,
    ((f0 * f1) * f2) op ((f3 * f4) * f5) with the missing factors 1, from
    its coded term: in float32 each coefficient has the bits of its own
    expression in `coefficient_terms` (a product by 1 is exact)."""
    pose = np.asarray(pose, np.float32)
    c, s = np.cos(pose[3:]), np.sin(pose[3:])
    small = np.abs(pose[3:]) < np.float32(ndt_newton.ANGLE_SNAP)
    cs, ss = np.where(small, np.float32(1), c), np.where(small, np.float32(0), s)
    rot = (c[0], s[0], c[1], s[1], c[2], s[2])
    ang = (cs[0], ss[0], cs[1], ss[1], cs[2], ss[2])
    with np.errstate(all="ignore"):
        want = ndt_newton.coefficient_terms(rot, ang, np.float32(0))
    codes = ndt_newton.coefficient_terms([_Code("product", [(i, False)]) for i in range(6)],
                                         [_Code("product", [(6 + i, False)]) for i in range(6)], _Code("zero"))
    values = np.asarray(rot + ang, np.float32)
    for w_terms, c_terms in zip(want, codes):
        got = np.asarray([_evaluate_code(k, values) for k in c_terms], np.float32)
        np.testing.assert_array_equal(got.view(np.int32), np.asarray(w_terms, np.float32).view(np.int32))


def test_wrapper_scratch_and_params_match_the_kernel():
    """The wrapper's ctypes `_Params`, stamp layout and scratch sizes are the
    kernel's: the fields of NdtNewtonParams (and ndt::GridConsts) in order,
    kStampHead / kStampsPerEval, and the launch's documented scratch."""
    newton = (CSRC / "ndt_newton.cu").read_text()
    reduce = (CSRC / "ndt_reduce.cuh").read_text()

    def fields(src, struct):
        body = re.search(r"struct " + struct + r" \{(.*?)\n\};", src, re.S).group(1)
        out = []
        for ln in body.splitlines():
            m = re.match(r"\s*(float|int|ndt::GridConsts) (.*?);", ln)
            if m:
                for name in m.group(2).split(","):
                    name = name.strip()
                    if m.group(1) == "ndt::GridConsts":
                        out += fields(reduce, "GridConsts")
                        continue
                    arr = re.match(r"(\w+)\[(\d+)\]", name)
                    ctype = ctypes.c_float if m.group(1) == "float" else ctypes.c_int
                    out.append((arr.group(1), ctype * int(arr.group(2))) if arr else (name, ctype))
        return out

    want = fields(newton, "NdtNewtonParams")
    got = list(ndt_newton._Params._fields_)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert all(ctypes.sizeof(a) == ctypes.sizeof(b) and getattr(a, "_type_", a) == getattr(b, "_type_", b)
               for (_, a), (_, b) in zip(got, want))
    assert ctypes.sizeof(ndt_newton._Params) == 4 * sum(ctypes.sizeof(t) // 4 for _, t in want)
    head, per = (int(re.search(rf"{k} = (\d+)", newton).group(1)) for k in ("kStampHead", "kStampsPerEval"))
    assert (ndt_newton.STAMP_HEAD, ndt_newton.STAMPS_PER_EVAL) == (head, per)
    assert ndt_newton.stamp_slots(30) == head + per * 32
    # ndt_newton_launch: compact max(n, 1) * 4 floats, counts 2 * blocks ints, partials 2 * 28 * blocks
    # floats, out 48 floats
    for n, blocks in ((0, 264), (32768, 264), (1531, 528)):
        sizes = {k: (int(np.prod(shape)), dtype) for k, (shape, dtype) in ndt_newton.scratch_shapes(n, blocks).items()}
        assert sizes == {"compact": (max(n, 1) * 4, torch.float32), "counts": (2 * blocks, torch.int32),
                         "partials": (2 * 28 * blocks, torch.float32), "out": (48, torch.float32)}
    assert int(re.search(r"kNOut = (\d+)", newton).group(1)) == ndt_newton.NOUT
    # two evaluations' stamps: the phases of each, the first from the loop's entry
    st = np.zeros(ndt_newton.stamp_slots(3), np.int64)
    st[:3] = (2, 100, 250)
    st[3:15] = np.arange(260, 380, 10)
    setup, spans = ndt_newton.split(st)
    assert setup == 150.0 and spans.shape == (2, len(ndt_newton.SPLIT))
    np.testing.assert_array_equal(spans, [[10, 10, 10, 10, 10, 10], [10, 10, 10, 10, 10, 10]])
    with pytest.raises(ValueError):  # stamps are the kernel's: no plain version records them
        ndt_newton.ndt_newton(*[torch.zeros(1)] * 7, dims=(1, 1, 1), resolution=1.0, d1=1.0, d2=1.0,
                              stencil="direct7", weight_derivatives=True, max_iter=3, trans_eps=0.01,
                              step_size=0.1, score_rel_tol=0.0, stamps=torch.zeros(st.size, dtype=torch.int64))


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
    trans_eps and two iterations. The map build (scatter_sum) and the
    plain reduction give their one-thread sums at any CPU thread count, so
    the readings (printed, pytest -s) do not follow the thread count a test
    worker was given."""
    N = ndt_newton
    m, src, mask, w = test_torch_cuda._inputs(torch.device("cpu"))
    args, kw = test_torch_cuda._newton_call(m, src, mask, w, test_torch_cuda.NEWTON_POSES[1], stencil)
    base = N.ndt_newton_plain(*args, **kw).numpy()
    readings = []
    for seed in orders:
        perm = torch.as_tensor(np.random.default_rng(seed).permutation(len(src)))
        o = N.ndt_newton_plain(src[perm], mask[perm], w[perm], *args[3:], **kw).numpy()
        readings.append((int(o[N.ITERATIONS]), float(np.abs(o[N.POSE] - base[N.POSE]).max())))
    with capsys.disabled():
        print(f"\n[order sensitivity {stencil}] plain {int(base[N.ITERATIONS])} iterations; reordered "
              f"(iterations, max |pose - plain|): {readings}")
    assert all(o[1] <= kw["trans_eps"] and abs(o[0] - base[N.ITERATIONS]) <= 2 for o in readings), readings
    assert max(o[1] for o in readings) > 1e-4, readings


@pytest.mark.parametrize("stencil", ["direct7", "radius27"])
def test_plain_sums_do_not_follow_thread_count(stencil):
    """ndt_reduce_plain's [32] sums are the same bits at 1, 2 and 8 CPU
    threads, on 5000 points in three chunks (the far start's pose, where
    the Hessian sums reach ~1e6), and the bits of each chunk's sums on one
    thread added in chunk order."""
    m, src, mask, w = test_torch_cuda._inputs(torch.device("cpu"))
    pose = torch.as_tensor(np.asarray(test_torch_cuda.NEWTON_POSES[1], np.float32))
    d1, d2 = test_torch_cuda.CFG.gauss_params()
    kw = dict(dims=m.dims, resolution=m.resolution, d1=float(np.float32(d1)), d2=float(np.float32(d2)),
              stencil=stencil, weight_derivatives=True, chunk=2048)
    args = (src, mask, w, m.index, m.packed, m.origin, *ndt_newton.pose_coefficients(pose))
    threads = torch.get_num_threads()
    sums = []
    try:
        for n in (1, 2, 8):
            torch.set_num_threads(n)
            sums.append(ndt_fused.ndt_reduce_plain(*args, **kw).numpy())
    finally:
        torch.set_num_threads(threads)
    assert np.abs(sums[0][7:28]).max() > 1e5
    for s in sums[1:]:
        np.testing.assert_array_equal(s, sums[0])
    torch.set_num_threads(1)
    try:
        parts = [ndt_fused.ndt_reduce_plain(*(a[i:i + 2048] for a in args[:3]), *args[3:], **kw)
                 for i in range(0, len(src), 2048)]
    finally:
        torch.set_num_threads(threads)
    chained = torch.zeros(32)
    for p in parts:
        chained += p
    np.testing.assert_array_equal(sums[0], chained.numpy())


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

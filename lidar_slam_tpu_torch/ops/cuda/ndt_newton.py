"""The whole clamped-Newton NDT alignment in one launch.

`ndt_newton` replaces the Pallas TPU kernel
`lidar_slam_tpu/ops/pallas/ndt_fused.py::ndt_reduce_fused` together with
the `lax.while_loop` of `lidar_slam_tpu/models/registration/ndt.py::
newton_align` that calls it, for `solver="newton"` with
`max_step_iterations == 0`: the hand-written Hopper kernel
`csrc/ndt_newton.cu` keeps the pose on the card, evaluates the NDT score,
gradient and Hessian, solves the 6x6 LDL^T, clamps the step and tests
convergence until the loop ends (the source says what bounds it). On a
CUDA tensor it launches that kernel or raises; on a CPU tensor, and only
there, it runs `ndt_newton_plain`, the same iteration in torch ops.

Both return one [NOUT] float32 tensor on the points' device, in the layout
of the slices below: the final pose (tx, ty, tz, roll, pitch, yaw), score,
gradient[6] and the 21 upper-triangular Hessian entries at it, the
iteration count, the converged flag, `unresolved` (always 0), the count of
masked-in source points and the final pose's rotation matrix (row-major,
from the same pose math). Its caller copies it to the host once.

The pose math (R, t and the angle-derivative coefficients) is written
once, in `coefficient_terms`: torch evaluates it for the plain version,
numpy for the host loop, and the CUDA source holds the same
expressions term for term, with every product and sum rounded on its own
(`__fmul_rn`, `__fadd_rn`), as PyTorch's separate ops are
(tests/test_torch_newton.py compares the texts).

A launch can also record where an evaluation's time goes: pass `stamps`
(an int64 tensor of `stamp_slots(max_iter)` entries) and read it with
`split` (chip_smoke.py phase 4 and chip_newton.py print it).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .ndt_fused import STENCIL_OFFSETS, UPPER, _host, ndt_reduce_plain

POSE = slice(0, 6)
SCORE = 6
GRAD = slice(7, 13)
HESS = slice(13, 34)  # the 21 upper-triangular entries, row-major (ndt_fused.UPPER)
ITERATIONS = 34
CONVERGED = 35
UNRESOLVED = 36
N_VALID = 37
ROTATION = slice(38, 47)
NOUT = 48  # + 1 pad

# Angles below this snap to exactly 0 in the derivative coefficients
# (computeAngleDerivatives, NormalDistributionsTransform.cpp:528-548).
ANGLE_SNAP = 1e-4

# Kernel launches since the last reset. Incremented only where the CUDA
# kernel is launched, never on the plain path.
launches = 0

# PAIR_OF[a][b]: the index of _pack_params' Hessian pair (a, b), pairs 00 01 02 11 12 22
PAIR_OF = [[0, 1, 2], [1, 3, 4], [2, 4, 5]]


def coefficient_terms(rot, ang, zero):
    """The pose coefficients R[9], J[27], H[54] in `_pack_params`' layout
    (csrc/ndt_reduce.cuh), as expressions in the cosines and sines of the
    pose angles: `rot` = (ca, sa, cb, sb, cc, sc) of roll, pitch and yaw
    for R, `ang` = the same snapped at ANGLE_SNAP for J and H. Works on any
    scalars with * + - and unary -: torch here, numpy in the host loop
    (`ndt.py::_pose_coefficients`), and the CUDA source holds the same
    expressions."""
    ca, sa, cb, sb, cc, sc = rot
    cx, sx, cy, sy, cz, sz = ang
    R = [
        cb * cc, -cb * sc, sb,
        ca * sc + sa * sb * cc, ca * cc - sa * sb * sc, -sa * cb,
        sa * sc - ca * sb * cc, sa * cc + ca * sb * sc, ca * cb,
    ]
    z3 = [zero, zero, zero]
    j_a = [-sx * sz + cx * sy * cz, -sx * cz - cx * sy * sz, -cx * cy]
    j_b = [cx * sz + sx * sy * cz, cx * cz - sx * sy * sz, -sx * cy]
    j_c = [-sy * cz, sy * sz, cy]
    j_d = [sx * cy * cz, -sx * cy * sz, sx * sy]
    j_e = [-cx * cy * cz, cx * cy * sz, -cx * sy]
    j_f = [-cy * sz, -cy * cz, zero]
    j_g = [cx * cz - sx * sy * sz, -cx * sz - sx * sy * cz, zero]
    j_h = [sx * cz + cx * sy * sz, cx * sy * cz - sx * sz, zero]
    jang = [[z3, j_a, j_b], [j_c, j_d, j_e], [j_f, j_g, j_h]]  # [angle a][row r][j]

    h_a2 = [-cx * sz - sx * sy * cz, -cx * cz + sx * sy * sz, sx * cy]
    h_a3 = [-sx * sz + cx * sy * cz, -cx * sy * sz - sx * cz, -cx * cy]
    h_b2 = [cx * cy * cz, -cx * cy * sz, cx * sy]
    h_b3 = [sx * cy * cz, -sx * cy * sz, sx * sy]
    h_c2 = [-sx * cz - cx * sy * sz, sx * sz - cx * sy * cz, zero]
    h_c3 = [cx * cz - sx * sy * sz, -sx * sy * cz - cx * sz, zero]
    h_d1 = [-cy * cz, cy * sz, sy]
    h_d2 = [-sx * sy * cz, sx * sy * sz, sx * cy]
    h_d3 = [cx * sy * cz, -cx * sy * sz, -cx * cy]
    h_e1 = [sy * sz, sy * cz, zero]
    h_e2 = [-sx * cy * sz, -sx * cy * cz, zero]
    h_e3 = [cx * cy * sz, cx * cy * cz, zero]
    h_f1 = [-cy * cz, cy * sz, zero]
    h_f2 = [-cx * sz - sx * sy * cz, -cx * cz + sx * sy * sz, zero]
    h_f3 = [-sx * sz + cx * sy * cz, -cx * sy * sz - sx * cz, zero]
    hpair = [  # [pair k][row r][j], pairs 00 01 02 11 12 22
        [z3, h_a2, h_a3], [z3, h_b2, h_b3], [z3, h_c2, h_c3],
        [h_d1, h_d2, h_d3], [h_e1, h_e2, h_e3], [h_f1, h_f2, h_f3],
    ]
    J = [jang[a][r][j] for r in range(3) for a in range(3) for j in range(3)]
    H = [hpair[k][r][j] for k in range(6) for r in range(3) for j in range(3)]
    return R, J, H


def pose_coefficients(p):
    """R [3, 3], t [3], jang [3, 3, 3] and hang [3, 3, 3, 3] of the pose
    p [6] (float32 tensor, any device), in torch float32 ops: the math the
    kernel does on the card at every evaluation."""
    p = p.to(torch.float32)
    ang = p[3:6]
    c, s = torch.cos(ang), torch.sin(ang)
    small = ang.abs() < ANGLE_SNAP
    cs, ss = torch.where(small, 1.0, c), torch.where(small, 0.0, s)
    rot = (c[0], s[0], c[1], s[1], c[2], s[2])
    snapped = (cs[0], ss[0], cs[1], ss[1], cs[2], ss[2])
    R, J, H = coefficient_terms(rot, snapped, torch.zeros((), dtype=torch.float32, device=p.device))
    # J[(3r + a) * 3 + j] = jang[a, r, j]; H[(3k + r) * 3 + j] = hang[a_k, b_k, r, j]
    jang = torch.stack(J).reshape(3, 3, 3).transpose(0, 1)
    hk = torch.stack(H).reshape(6, 3, 3)
    hang = hk[torch.as_tensor(PAIR_OF, device=p.device)]
    return torch.stack(R).reshape(3, 3), p[:3], jang, hang


def ldlt_solve(H, g, one):
    """delta = -H^-1 g by the unrolled, unpivoted 6x6 LDL^T of the JAX
    package's _solve_newton, in its operation order, on any scalars: H [6, 6]
    and g [6] indexable, `one` the 1 of their type. Returns 6 scalars.
    Near-singular pivots give huge or non-finite steps; the Newton loop
    treats a non-finite or zero step norm as converged."""
    n = 6
    L = [[None] * n for _ in range(n)]
    D = [None] * n
    for j in range(n):
        s = H[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k] * D[k]
        D[j] = s
        inv_d = one / s
        for i in range(j + 1, n):
            t = H[i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k] * D[k]
            L[i][j] = t * inv_d
    y = [None] * n
    for i in range(n):
        t = -g[i]
        for k in range(i):
            t = t - L[i][k] * y[k]
        y[i] = t
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i] / D[i]
        for k in range(i + 1, n):
            t = t - L[k][i] * x[k]
        x[i] = t
    return x


def _hessian(upper):
    """[21] upper-triangular entries -> symmetric [6, 6]."""
    idx = torch.as_tensor(UPPER, device=upper.device)
    h = torch.zeros((6, 6), dtype=upper.dtype, device=upper.device)
    h[idx[:, 0], idx[:, 1]] = upper
    h[idx[:, 1], idx[:, 0]] = upper
    return h


def ndt_newton_plain(
    points, mask, weights, index, packed, origin, pose0, *,
    dims, resolution, d1, d2, stencil, weight_derivatives,
    max_iter, trans_eps, step_size, score_rel_tol, trace=None,
):
    """Plain PyTorch version of `ndt_newton` (any device): the host loop
    `newton_align` for max_step_iterations == 0, with the pose math in
    torch float32 (`pose_coefficients`), the sums of `ndt_reduce_plain`
    and the LDL^T on torch scalars. It synchronises with the host at every
    iteration. `trace`, when a list, receives each evaluated pose as a host
    float32 [6] array (for counting the work of an alignment)."""
    dev = points.device
    red = dict(dims=dims, resolution=resolution, d1=d1, d2=d2, stencil=stencil,
               weight_derivatives=weight_derivatives)

    def evaluate(p):
        if trace is not None:
            trace.append(p.cpu().numpy())
        R, t, jang, hang = pose_coefficients(p)
        return ndt_reduce_plain(points, mask, weights, index, packed, origin, R, t, jang, hang, **red)

    step_min = float(np.float32(trans_eps / 2.0))
    step_max = float(np.float32(step_size))
    eps = float(np.float32(trans_eps))
    p = torch.as_tensor(pose0, dtype=torch.float32).to(dev)
    sums = evaluate(p)
    it, converged = 0, False
    while not converged and it <= max_iter:
        grad = sums[1:7]
        delta = torch.stack(ldlt_solve(_hessian(sums[7:28]), grad, 1.0))
        dnorm = torch.sqrt(torch.sum(delta * delta))
        if not bool(torch.isfinite(dnorm) & (dnorm != 0.0)):
            converged = True  # degenerate step: keep the pose, stop
        else:
            direction = delta / dnorm
            flip = -torch.sum(grad * direction) > 0.0  # not a descent direction
            direction = torch.where(flip, -direction, direction)
            alpha = torch.clamp(dnorm, step_min, step_max)
            p_new = p + alpha * direction
            new = evaluate(p_new)
            converged = it >= 1 and bool(alpha.abs() < eps)
            if score_rel_tol > 0:
                plateau = it >= 3 and bool(
                    (new[0] - sums[0]).abs() < score_rel_tol * torch.clamp(sums[0].abs(), min=1e-6)
                )
                converged = converged or plateau
            p, sums = p_new, new
        it += 1
    tail = torch.as_tensor([it, float(converged), 0.0], dtype=torch.float32).to(dev)
    n_valid = mask.sum(dtype=torch.int32).to(torch.float32).reshape(1)
    R = pose_coefficients(p)[0].reshape(9)
    return torch.cat([p, sums[:28], tail, n_valid, R, torch.zeros(NOUT - ROTATION.stop, device=dev)])


class _Params(ctypes.Structure):
    """ctypes mirror of `NdtNewtonParams` in csrc/ndt_newton.cu."""

    _fields_ = [
        ("origin", ctypes.c_float * 3),
        ("res", ctypes.c_float),
        ("res2", ctypes.c_float),
        ("d1", ctypes.c_float),
        ("d2", ctypes.c_float),
        ("dims", ctypes.c_int * 3),
        ("weight_derivatives", ctypes.c_int),
        ("n", ctypes.c_int),
        ("max_iter", ctypes.c_int),
        ("trans_eps", ctypes.c_float),
        ("step_min", ctypes.c_float),
        ("step_max", ctypes.c_float),
        ("score_rel_tol", ctypes.c_float),
    ]


assert ctypes.sizeof(_Params) == 4 * 17

# The kernel's optional phase stamps (csrc/ndt_newton.cu: kStampHead,
# kStampsPerEval): [0] the evaluations, [1] kernel entry, [2] loop entry,
# then for each evaluation the %globaltimer (ns) at the end of each SPLIT
# phase, in order; the first phase starts at the previous evaluation's end.
STAMP_HEAD = 3
STAMPS_PER_EVAL = 6
SPLIT = (
    "gathers",  # block 0's thread 0 through its (point, offset) pairs
    "block_reduce",  # block 0's other warps done, its 28 sums reduced and stored
    "last_block",  # until the last block of the grid has stored its sums
    "barrier",  # from there until block 0 is past the grid barrier
    "partials",  # the [28, G] table summed (in clusters) and the sums in hand
    "step_pose",  # the Newton step on one thread, the next pose's coefficients on a warp
)
assert len(SPLIT) == STAMPS_PER_EVAL


def stamp_slots(max_iter: int) -> int:
    """int64 slots of a launch's stamps: at most max_iter + 2 evaluations."""
    return STAMP_HEAD + STAMPS_PER_EVAL * (int(max_iter) + 2)


def split(stamps) -> tuple[float, np.ndarray]:
    """One stamped launch's (ns from kernel entry to loop entry, [E, 6] ns of
    each evaluation's SPLIT phases)."""
    s = np.asarray(stamps.cpu() if isinstance(stamps, torch.Tensor) else stamps, np.int64)
    n_eval = int(s[0])
    ends = s[STAMP_HEAD:STAMP_HEAD + STAMPS_PER_EVAL * n_eval].reshape(n_eval, STAMPS_PER_EVAL)
    starts = np.concatenate([s[2:3], ends[:-1, -1]])
    bounds = np.column_stack([starts, ends])
    return float(s[2] - s[1]), np.diff(bounds, axis=1).astype(np.float64)


def scratch_shapes(n: int, blocks: int) -> dict:
    """The launch's scratch and result tensors (shape, dtype) for n source
    rows on a grid of `blocks`: the compacted rows, the blocks' row counts,
    the double-buffered [28, blocks] partials table and the result."""
    return {
        "compact": ((max(n, 1), 4), torch.float32),
        "counts": ((2 * blocks,), torch.int32),
        "partials": ((2, 28, blocks), torch.float32),
        "out": ((NOUT,), torch.float32),
    }


def _library() -> ctypes.CDLL:
    lib = build.load("ndt_newton")
    if lib.ndt_newton_launch.argtypes is None:
        lib.ndt_newton_grid.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.ndt_newton_grid.restype = ctypes.c_int
        lib.ndt_newton_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int,
        ] + [ctypes.c_void_p] * 6
        lib.ndt_newton_launch.restype = ctypes.c_int
        lib.ndt_pose_coefficients_launch.argtypes = [ctypes.c_void_p] * 3
        lib.ndt_pose_coefficients_launch.restype = ctypes.c_int
    return lib


GRID_FIELDS = ("blocks", "cluster", "clusters", "blocks_per_sm", "sms")


def grid(n_off: int) -> dict:
    """The kernel's persistent grid on the current card for `n_off` stencil
    offsets: blocks (as many as can be resident at once), the cluster size,
    the clusters resident at once, blocks per SM and SMs."""
    shape = (ctypes.c_int * len(GRID_FIELDS))()
    err = _library().ndt_newton_grid(n_off, shape)
    if err != 0:
        raise RuntimeError(f"ndt_newton: the card's occupancy query failed: cudaError {err}")
    return dict(zip(GRID_FIELDS, shape))


def ndt_newton(
    points, mask, weights, index, packed, origin, pose0, *,
    dims, resolution, d1, d2, stencil, weight_derivatives,
    max_iter, trans_eps, step_size, score_rel_tol, stamps=None,
):
    """The clamped-Newton alignment of `points` [N, 3] (raw, untransformed),
    `mask` [N] bool and `weights` [N] against the map's dense `index` [V]
    int32 and packed stats `packed` [C+1, 16], from the pose `pose0` [6] on
    the points' device. CUDA tensors launch the Hopper kernel (one
    cooperative launch, no host synchronisation); CPU tensors take the
    plain version. `stamps`, CUDA only: an int64 tensor of
    `stamp_slots(max_iter)` entries, which the launch zeroes and the kernel
    fills with its phase times (`split`); the result is the same.
    Returns the [NOUT] result on the points' device."""
    global launches
    dev = points.device
    kw = dict(dims=dims, resolution=resolution, d1=d1, d2=d2, stencil=stencil,
              weight_derivatives=weight_derivatives, max_iter=max_iter, trans_eps=trans_eps,
              step_size=step_size, score_rel_tol=score_rel_tol)
    if dev.type == "cpu" and stamps is None:
        return ndt_newton_plain(points, mask, weights, index, packed, origin, pose0, **kw)
    if dev.type != "cuda":
        raise ValueError(f"ndt_newton: unsupported device {dev}" + (" for stamps" if dev.type == "cpu" else ""))
    if stencil not in STENCIL_OFFSETS:
        raise ValueError(f"unknown stencil {stencil!r}")
    n = points.shape[0]
    n_off = len(STENCIL_OFFSETS[stencil])
    if n * n_off >= 2**31:
        raise ValueError(f"ndt_newton: {n} points x {n_off} offsets overflow the kernel's int pair index")
    build.check_tensor("points", points, torch.float32, dev, (n, 3))
    build.check_tensor("mask", mask, torch.bool, dev, (n,))
    build.check_tensor("weights", weights, torch.float32, dev, (n,))
    build.check_tensor("index", index, torch.int32, dev, (dims[0] * dims[1] * dims[2],))
    build.check_tensor("packed", packed, torch.float32, dev)
    build.check_tensor("pose0", pose0, torch.float32, dev, (6,))
    if packed.ndim != 2 or packed.shape[1] != 16 or packed.data_ptr() % 16:
        raise ValueError("packed must be a 16-byte aligned [C+1, 16] table")
    if stamps is not None:
        build.check_tensor("stamps", stamps, torch.int64, dev, (stamp_slots(max_iter),))

    params = _Params(
        (ctypes.c_float * 3)(*_host("origin", origin).reshape(3)), float(resolution), float(resolution) ** 2, d1, d2,
        (ctypes.c_int * 3)(*dims), int(bool(weight_derivatives)), n, int(max_iter),
        float(np.float32(trans_eps)), float(np.float32(trans_eps / 2.0)), float(np.float32(step_size)),
        float(np.float32(score_rel_tol)),
    )
    lib = _library()
    with torch.cuda.device(dev):
        blocks = grid(n_off)["blocks"]
        t = {name: torch.empty(shape, dtype=dtype, device=dev) for name, (shape, dtype) in scratch_shapes(n, blocks).items()}
        if stamps is not None:
            stamps.zero_()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ndt_newton_launch(
            points.data_ptr(), mask.data_ptr(), weights.data_ptr(), index.data_ptr(), packed.data_ptr(),
            pose0.data_ptr(), ctypes.byref(params), n_off, blocks, t["compact"].data_ptr(), t["counts"].data_ptr(),
            t["partials"].data_ptr(), t["out"].data_ptr(), 0 if stamps is None else stamps.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"ndt_newton kernel launch failed: cudaError {err}")
    launches += 1
    return t["out"]


def device_pose_coefficients(p):
    """The kernel's own pose math on the card: the [93] coefficients
    (R, t, J, H in `_pack_params`' layout) of the pose p [6], computed on
    one warp by the device function every block of `ndt_newton` runs. For
    checking it against `pose_coefficients`; needs a CUDA tensor."""
    if p.device.type != "cuda":
        raise ValueError("device_pose_coefficients runs only on the card")
    build.check_tensor("p", p, torch.float32, p.device, (6,))
    out = torch.empty(93, dtype=torch.float32, device=p.device)
    with torch.cuda.device(p.device):
        err = _library().ndt_pose_coefficients_launch(
            p.data_ptr(), out.data_ptr(), torch.cuda.current_stream(p.device).cuda_stream
        )
    if err != 0:
        raise RuntimeError(f"ndt_pose_coefficients kernel launch failed: cudaError {err}")
    return out

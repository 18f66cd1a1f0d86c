#!/usr/bin/env python3
"""Split the gap between the port's one-rank and two-rank local maps: the
JAX package's one- and two-device maps of the same keyframes.

    python3 chip_smoke.py --parallel-out build/local_maps.npz      # the port, on a GPU
    JAX_PLATFORMS=cpu python3 parallel_witness.py build/local_maps.npz

chip_smoke.py's phase 19 builds a 20-keyframe local map with
sharded_build_local_map at two ranks and holds it against build_ndt_map's
(one rank) through one alignment from the same guess. `--parallel-out`
saves the keyframes, the grid corner, the frame and guess, both of the
port's maps (keys and packed rows) and the port's alignment on each. This
script builds, on two virtual CPU devices, the JAX build_ndt_map and the
JAX sharded_build_local_map at one device and at two (the keyframes in
the JAX layout, contiguous shards, and in the port's, strided shards),
aligns on each from the same guess, and prints:

- JAX's own one- versus two-device alignment gap beside the port's;
- the port's two-rank map against JAX's two-device map (the port's
  shards) entry by entry: keys, counts and means exactly or within
  MEAN_TOL; the inverse covariances within tests/test_parallel.py's rtol
  and atol plus ROADMAP C.3's float32 term for tight voxels,
  2^-23 x 3 res^2 x |icov|^2; every voxel beyond that counted as a
  pole-like voxel when two of its eigenvalues coincide to float32
  precision (unresolved_pair), else held to the reference's own float32
  sensitivity there (conditioning_spread: the JAX conditioning of the
  voxel's float64 sums, moved by float32 rounding);
- the same comparison between JAX's own maps and between the port's.

The verdict: "port" when the port's two-rank map leaves that bound at a
voxel that is not pole-like by more than the reference's own sensitivity,
or its keys, counts or means differ; otherwise "reference" when JAX's own one- versus two-device
alignment gap exceeds trans_eps as the port's does, "no gap" when the
port's does not, "undecided" when only the port's does. Imports nothing
of the port; needs no GPU.
"""

import os

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2").strip()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

RTOL, ATOL = 2e-3, 2e-2  # tests/test_parallel.py's tolerances on a sharded map's inverse covariances
MEAN_TOL = 1e-4  # chip_smoke.py MAP_TOL["mean"], m
EPS32 = 2.0 ** -23
TRIALS = 64  # moved copies of a voxel's sums in conditioning_spread


def icov_bound(ref, res):
    """Per entry of [R, 6] reference icov rows: atol + rtol |ref| + the
    float32 term 2^-23 x 3 res^2 x max|icov row|^2 of a voxel's
    corner-relative moments cancelling (ROADMAP C.3)."""
    big = np.abs(ref).max(axis=1, keepdims=True)
    return ATOL + RTOL * np.abs(ref) + EPS32 * 3.0 * res * res * big * big


def compare(a_keys, a_packed, b_keys, b_packed, res):
    """Map a against map b (the reference), row by row of their keys:
    {keys equal, count gap, mean gap, icov entries beyond icov_bound, the
    voxel ids of those and their largest gaps, the largest icov gap}."""
    same = np.array_equal(a_keys, b_keys)
    used = b_keys >= 0
    a, b = a_packed[used].astype(np.float64), b_packed[used].astype(np.float64)
    if not same:
        common, ia, ib = np.intersect1d(a_keys[a_keys >= 0], b_keys[used], return_indices=True)
        a, b = a_packed[a_keys >= 0][ia].astype(np.float64), b_packed[used][ib].astype(np.float64)
    ids = b_keys[used] if same else common
    d = np.abs(a[:, 4:10] - b[:, 4:10])
    beyond = d > icov_bound(b[:, 4:10], res)
    rows = np.flatnonzero(beyond.any(axis=1))
    return dict(keys_equal=same, voxels=len(ids), count_gap=float(np.abs(a[:, 11] - b[:, 11]).max(initial=0.0)),
                mean_gap=float(np.abs(a[:, 0:3] - b[:, 0:3]).max(initial=0.0)),
                icov_gap=float(d.max(initial=0.0)), beyond_entries=int(beyond.sum()), beyond_ids=ids[rows],
                beyond_gap=np.where(beyond, d - icov_bound(b[:, 4:10], res), 0.0)[rows].max(axis=1))


def conditioning_spread(ids, sums64, cfg, trials=TRIALS, seed=0):
    """The reference's own float32 sensitivity at each voxel: its float64
    sums [V, 11] through the JAX package's moments and conditioning
    (`_moments_from_sums`, `_condition_rows`: eigh3 and the clamp), `trials`
    times with every psum and ppsum entry moved by the rounding bound of a
    float32 sum of `count` terms (relative count x 2^-24) and every
    covariance entry by one rounding of its cancelling subtraction (2^-24
    of the second moment it starts from), random signs: what another
    summation order and another compiler's arithmetic may do to the same
    voxel. Per voxel, the largest move of an inverse-covariance entry from
    the unmoved sums' (its largest entry where the valid flag flips)."""
    import jax.numpy as jnp

    from lidar_slam_tpu.models.registration.ndt import _condition_rows, _moments_from_sums

    if len(ids) == 0:
        return np.zeros(0)
    rows = sums64[ids]
    n = rows[:, 0]
    rng = np.random.default_rng(seed)
    scale = n[None, :, None] * EPS32 / 2.0
    moved = np.repeat(rows[None], trials + 1, axis=0)
    moved[1:, :, 1:10] *= 1.0 + scale * rng.uniform(-1.0, 1.0, (trials, len(ids), 9))
    flat = jnp.asarray(moved.reshape(-1, 11), jnp.float32)
    count, mean, cov, sv = _moments_from_sums(jnp.zeros(3), flat[:, 0], flat[:, 1:4], flat[:, 4:10], flat[:, 10],
                                              (1, 1, flat.shape[0]), 1.0)
    pp = np.abs(moved[..., 4:10] / n[None, :, None])[..., [0, 1, 2, 1, 3, 4, 2, 4, 5]].reshape(-1, 3, 3)
    jitter = rng.uniform(-1.0, 1.0, pp.shape) * pp * EPS32 / 2.0
    jitter = (jitter + jitter.transpose(0, 2, 1)) / 2.0
    jitter[: len(ids)] = 0.0  # the unmoved copy
    cov = cov + jnp.asarray(jitter, jnp.float32)
    packed = np.asarray(_condition_rows(count, mean, cov, sv, cfg)[0], np.float64).reshape(trials + 1, len(ids), 16)
    move = np.abs(packed[1:, :, 4:10] - packed[0][None, :, 4:10]).max(axis=(0, 2))
    flips = np.any(packed[1:, :, 10] != packed[0][None, :, 10], axis=0)
    return np.where(flips, np.abs(packed[:, :, 4:10]).max(axis=(0, 2)), move)


def unresolved_pair(ids, sums64):
    """Whether two of each voxel's covariance eigenvalues (float64, from
    its float64 sums) lie closer than sqrt(2^-23) of the spread: the
    closed-form eigh3 places such a pair's eigenvalue only to about that in
    float32, so its eigenvectors, and the inverse covariance in their
    plane, are noise (a pole's voxel: ROADMAP C.3)."""
    out = np.zeros(len(ids), bool)
    for k, vid in enumerate(ids):
        n = sums64[vid, 0]
        rel, pp = sums64[vid, 1:4] / n, sums64[vid, 4:10] / n
        c = np.empty((3, 3))
        for e, (i, j) in enumerate([(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]):
            c[i, j] = c[j, i] = pp[e] - rel[i] * rel[j]
        ev = np.linalg.eigvalsh(c)
        out[k] = min(ev[1] - ev[0], ev[2] - ev[1]) <= np.sqrt(EPS32) * (ev[2] - ev[0])
    return out


def float64_sums(s, dims, res):
    """The keyframes' voxel sums [V, 11] in float64 (front_end_witness's
    rebuild: world points and corner-relative moments from the float32
    inputs)."""
    from front_end_witness import float64_window

    kfs = [dict(points=p, mask=m & ok, weights=w, pose=T)
           for p, m, w, T, ok in zip(s["kf_points"], s["kf_mask"], s["kf_weights"], s["kf_poses"], s["kf_valid"])]
    return float64_window(kfs, len(kfs), s["origin"], dims, res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("maps", help="the .npz that chip_smoke.py --parallel-out wrote")
    ap.add_argument("--json", help="also write the numbers to this file")
    args = ap.parse_args(argv)
    import dataclasses

    import jax
    import jax.numpy as jnp

    from lidar_slam_tpu.models.registration import NDTConfig, build_ndt_map, ndt_align
    from lidar_slam_tpu.ops.pointcloud import PointCloud
    from lidar_slam_tpu.parallel import make_mesh, sharded_build_local_map

    from front_end_witness import jax_map

    t0 = time.perf_counter()
    if len(jax.devices()) < 2:
        raise RuntimeError("needs two JAX devices (--xla_force_host_platform_device_count=2)")
    s = np.load(args.maps)
    fields = json.loads(str(s["ndt"]))
    fields["grid_dims"] = tuple(fields["grid_dims"])
    cfg = dataclasses.replace(NDTConfig(**fields), gather="two_level")
    dims, res = cfg.grid_dims, float(cfg.resolution)
    kf = [jnp.asarray(s[k]) for k in ("kf_points", "kf_mask", "kf_weights", "kf_poses", "kf_valid")]
    origin = jnp.asarray(s["origin"])
    k = kf[0].shape[0]
    strided = np.concatenate([np.arange(0, k, 2), np.arange(1, k, 2)])  # the port's rank 0 rows, then rank 1's

    P, M, W, T, V = (np.asarray(a) for a in kf)
    world = np.einsum("kij,kpj->kpi", T[:, :3, :3], P) + T[:, None, :3, 3]
    flat = PointCloud(points=jnp.asarray(world.reshape(-1, 3)), mask=jnp.asarray((M & V[:, None]).reshape(-1)),
                      weights=jnp.asarray(W.reshape(-1)))
    maps = {
        "JAX build_ndt_map": build_ndt_map(flat, cfg, origin=origin),
        "JAX 1 device": sharded_build_local_map(*kf, origin, cfg, make_mesh(1)),
        "JAX 2 devices": sharded_build_local_map(*kf, origin, cfg, make_mesh(2)),
        "JAX 2 devices, the port's shards": sharded_build_local_map(*(a[strided] for a in kf), origin, cfg,
                                                                     make_mesh(2)),
    }
    for name in ("one_rank", "two_ranks"):
        maps[f"port {name.replace('_', ' ')}"] = jax_map(s["origin"], s[f"{name}_keys"], s[f"{name}_packed"], dims, res)
    frame = PointCloud(points=jnp.asarray(s["frame_points"]), mask=jnp.asarray(s["frame_mask"]))
    poses, out = {}, {"maps": {}}
    for name, m in maps.items():
        r = ndt_align(m, frame, jnp.asarray(s["guess"]), cfg)
        poses[name] = np.asarray(r.pose, np.float64)
        out["maps"][name] = dict(converged=bool(r.converged), iterations=int(r.iterations))
    for name in ("one_rank", "two_ranks"):
        poses[f"the port's alignment on its {name.replace('_', '-')} map"] = np.float64(s[f"{name}_pose"])

    def gap(a, b):
        """(translation distance, rotation angle) between two poses, as
        chip_smoke.py's pose_gap measures them."""
        pa, pb = poses[a], poses[b]
        m = pa[:3, :3].T @ pb[:3, :3]
        axis = np.asarray([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]]) / 2.0
        return float(np.linalg.norm(pa[:3, 3] - pb[:3, 3])), float(np.arcsin(min(1.0, np.linalg.norm(axis))))

    card = gap("the port's alignment on its two-ranks map", "the port's alignment on its one-rank map")
    jax_gap = gap("JAX 2 devices", "JAX build_ndt_map")
    out["gaps"] = {
        "port on the card, two ranks - one rank": card,
        "JAX, 2 devices - build_ndt_map": jax_gap,
        "JAX, 1 device - build_ndt_map": gap("JAX 1 device", "JAX build_ndt_map"),
        "JAX, 2 devices (the port's shards) - build_ndt_map": gap("JAX 2 devices, the port's shards",
                                                                   "JAX build_ndt_map"),
        "JAX on the port's maps, two ranks - one rank": gap("port two ranks", "port one rank"),
        "JAX on the port's one-rank map - the port's alignment there": gap(
            "port one rank", "the port's alignment on its one-rank map"),
    }
    print(f"{k} keyframes, {int(s['frame_mask'].sum())} frame points; alignments from the same guess "
          f"(translation m, rotation rad; trans_eps {cfg.trans_eps}):")
    for name, (dt, dr) in out["gaps"].items():
        print(f"  {name}: {dt:.5f} m, {dr:.2e} rad")
    for name, r in out["maps"].items():
        print(f"  {name}: converged {r['converged']}, {r['iterations']} iterations")

    sums64 = float64_sums(s, dims, res)
    packed = {n: (np.asarray(m.keys), np.asarray(m.packed)) for n, m in maps.items()}
    out["entries"] = {}
    for a, b in (("port two ranks", "JAX 2 devices, the port's shards"), ("port two ranks", "JAX 2 devices"),
                 ("port one rank", "JAX build_ndt_map"), ("JAX 2 devices", "JAX build_ndt_map"),
                 ("port two ranks", "port one rank")):
        c = compare(*packed[a], *packed[b], res)
        ids, over = c.pop("beyond_ids"), c.pop("beyond_gap")
        pole = unresolved_pair(ids, sums64)
        unexplained = (over > conditioning_spread(ids, sums64, cfg)) & ~pole
        c.update(beyond_voxels=len(ids), pole_like=int(pole.sum()), unexplained=int(unexplained.sum()),
                 unexplained_ids=ids[unexplained].tolist())
        out["entries"][f"{a} - {b}"] = c
        print(f"  {a} against {b}: keys {'equal' if c['keys_equal'] else 'DIFFER'} ({c['voxels']} voxels), counts "
              f"{c['count_gap']:.1e}, means {c['mean_gap']:.2e} m; icov largest |diff| {c['icov_gap']:.4g}, "
              f"{c['beyond_entries']} entries in {c['beyond_voxels']} voxels beyond rtol {RTOL} + atol {ATOL} + "
              f"the float32 term: {c['pole_like']} of those voxels with an eigenvalue pair unresolved in float32, "
              f"{c['unexplained']} of the rest beyond the reference's own float32 sensitivity there")
    port_vs_jax = out["entries"]["port two ranks - JAX 2 devices, the port's shards"]
    maps_ok = (port_vs_jax["keys_equal"] and port_vs_jax["count_gap"] == 0.0 and port_vs_jax["mean_gap"] <= MEAN_TOL
               and port_vs_jax["unexplained"] == 0)
    if not maps_ok:
        out["verdict"] = "port"
    elif max(card) <= cfg.trans_eps:
        out["verdict"] = "no gap"
    else:
        out["verdict"] = "reference" if max(jax_gap) > cfg.trans_eps else "undecided"
    print(f"verdict: {out['verdict']}: JAX's own one- versus two-device gap {jax_gap[0]:.5f} m beside the card's "
          f"{card[0]:.5f} m; the port's two-rank map {'within' if maps_ok else 'NOT within'} the bound of JAX's "
          f"two-device map and the reference's own float32 sensitivity ({time.perf_counter() - t0:.1f} s)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

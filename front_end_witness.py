#!/usr/bin/env python3
"""Split a frame the port's front end lost: the JAX package on the port's
own inputs, map history and all.

    python3 endurance.py --replay-front-end 497 --before 497 --record REC.npz \\
        --device cuda --state-out build/front_end_state.npz      # on a GPU
    JAX_PLATFORMS=cpu python3 front_end_witness.py build/front_end_state.npz

endurance.py's replay saves the port's front end at the start of the lost
frame (save_front_end_state): the frame's preprocessed points, the
motion-model guess, the port's coarse and fine poses from it, the coarse
and fine maps, the fine running sums, and the inputs of every incremental
map update before the frame. This script prints:

1. the JAX coarse-then-fine alignment (the two `ndt_align` calls of
   `lidar_slam_tpu/pipeline/front_end.py::_track_step`) from the port's
   guess on the port's maps and points: its frame-to-frame motion error
   beside the port's;
2. the JAX `_incremental_map_update` replayed over the port's keyframe
   inputs from an empty map, its fine sums against the port's voxel by
   voxel (counts exactly; psum and ppsum by their largest gap; the
   conditioned inverse covariances by their largest relative gap and the
   voxels off by more than ICOV_OFF), and both against a float64 numpy
   rebuild of the keyframe window the map holds;
3. the JAX alignment from the port's guess on the JAX replay's maps;

and, beside them, the JAX alignment on maps conditioned from the float64
rebuild (the window with no add/evict history), the JAX preprocessing of
the frame's sweep against the port's, and (4) the knife edge: the JAX
alignment on each of the three maps from eight guesses 1 mm or 1 mrad
off the port's. The verdict, VERDICTS' rules:
"reference" when (1) and (3) lose the frame too and the port's sums sit at
most SUMS_RATIO times as far from the float64 rebuild as JAX's; "port
alignment" when (1) holds the frame; "port map" when the port's sums sit
farther than that. Exits 1 when the port did not lose the frame (every
number is printed all the same). Imports nothing of the port; needs no
GPU.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

LOST_STEP = 0.3  # m, a frame-to-frame motion error that counts a frame as lost (endurance.py's)
HOLD_STEP = 0.05  # m, a motion error under which an alignment holds the frame
SUMS_RATIO = 2.0  # the port's distance to the float64 sums over JAX's, at most, for a reference behaviour
ICOV_OFF = 0.10  # relative gap of a voxel's inverse covariance counted as off
PROBE_STEP = (1e-3, 1e-3)  # m and rad: the guesses of the knife-edge probe

VERDICTS = {
    "reference": "a reference behaviour: the JAX package loses the frame on the port's inputs and on its own "
                 "replayed maps, and the port's sums are no farther from float64 than JAX's",
    "port alignment": "the port's alignment: JAX holds the frame on the port's own inputs",
    "port map": "the port's map maintenance: its sums sit farther from float64 than JAX's",
    "undecided": "none of the rules holds",
    "no loss": "the port did not lose the frame: nothing to split",
}


def front_end_config(text):
    """The JAX FrontEndConfig of a config file's text."""
    from lidar_slam_tpu.config import load_config

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "config.yaml")
        with open(path, "w") as f:
            f.write(text)
        return load_config(path).front_end


def jax_map(origin, keys, packed, dims, resolution):
    """A JAX NDTMap of saved compact rows, enough for the two_level
    alignment: the dense index is the keys' row numbers (the sentinel row
    elsewhere), the dense views are placeholders as under dense_stats=False."""
    import jax.numpy as jnp

    from lidar_slam_tpu.models.registration.ndt import NDTMap

    v = int(np.prod(dims))
    cap = len(keys) - 1
    index = np.full(v, cap, np.int32)
    used = keys >= 0
    index[keys[used]] = np.flatnonzero(used)
    return NDTMap(origin=jnp.asarray(origin, jnp.float32), count=jnp.zeros(1), mean=jnp.zeros((1, 3)),
                  icov=jnp.zeros((1, 3, 3)), staticvalue=jnp.zeros(1), valid=jnp.zeros(1, bool),
                  index=jnp.asarray(index), packed=jnp.asarray(packed), keys=jnp.asarray(keys),
                  dims=tuple(int(d) for d in dims), resolution=float(resolution))


def motion_error(prev, pose, gt_prev, gt):
    """|the frame-to-frame translation - the truth's|, m."""
    step = np.linalg.inv(np.float64(prev)) @ np.float64(pose)
    true = np.linalg.inv(np.float64(gt_prev)) @ np.float64(gt)
    return float(np.linalg.norm(step[:3, 3] - true[:3, 3]))


def align(fine_map, coarse_map, points, mask, guess, cfg):
    """_track_step's coarse-then-fine alignment of a preprocessed frame:
    (coarse pose, fine pose, fine iterations)."""
    import jax.numpy as jnp

    from lidar_slam_tpu.models.registration import ndt_align
    from lidar_slam_tpu.ops.pointcloud import PointCloud
    from lidar_slam_tpu.pipeline.front_end import coarse_tracking_cfg

    frame = PointCloud(points=jnp.asarray(points), mask=jnp.asarray(mask))
    c = ndt_align(coarse_map, frame, jnp.asarray(guess), coarse_tracking_cfg(cfg.ndt))
    f = ndt_align(fine_map, frame, c.pose, cfg.ndt)
    return np.asarray(c.pose), np.asarray(f.pose), int(f.iterations)


def keyframes(s):
    """The saved update inputs, one dict a keyframe, padded to capacity."""
    cap = int(s["kf_capacity"])
    masks = np.unpackbits(s["kf_mask"], axis=1, count=cap).astype(bool)
    pts, w, at = s["kf_points"], s["kf_weights"], 0
    out = []
    for j, m in enumerate(masks):
        n = int(m.sum())
        p = np.zeros((cap, 3), np.float32)
        ww = np.ones(cap, np.float32)
        p[m], ww[m] = pts[at:at + n], w[at:at + n]
        at += n
        out.append(dict(points=p, mask=m, weights=ww, pose=s["kf_pose"][j], origin=s["kf_origin"][j],
                        evicts=bool(s["kf_evicts"][j])))
    return out


def replay_maps(kfs, cfg):
    """The JAX incremental map over the keyframes from an empty map, as
    FrontEnd._insert_keyframe feeds it (keyframe j evicts keyframe j - K
    of the K-slot window): (fine sums, fine map, coarse map)."""
    import jax.numpy as jnp

    from lidar_slam_tpu.models.registration import empty_ndt_sums
    from lidar_slam_tpu.pipeline.front_end import _incremental_map_update, coarse_tracking_cfg

    fine_cfg = dataclasses.replace(cfg.ndt, dense_stats=False)
    coarse_cfg = coarse_tracking_cfg(cfg.ndt)
    k, cap = cfg.local_frame_num, len(kfs[0]["mask"])
    fs = empty_ndt_sums(kfs[0]["origin"], fine_cfg)
    cs = empty_ndt_sums(kfs[0]["origin"], coarse_cfg)
    world = {}
    fm = cm = None
    for j, kf in enumerate(kfs):
        if kf["evicts"] != (j >= k):
            raise ValueError(f"keyframe {j}: the port's update {'evicted' if kf['evicts'] else 'did not evict'}")
        old = kfs[j - k] if j >= k else None
        o = jnp.asarray(kf["origin"])
        fs, cs, world[j % k], fm, cm = _incremental_map_update(
            fs, cs, world.get(j % k, jnp.zeros((cap, 3), jnp.float32)),
            jnp.asarray(old["mask"] if old else np.zeros(cap, bool)),
            jnp.asarray(old["weights"] if old else np.ones(cap, np.float32)),
            jnp.asarray(kf["points"]), jnp.asarray(kf["mask"]), jnp.asarray(kf["weights"]),
            jnp.asarray(kf["pose"]), o, o, fine_cfg, coarse_cfg)
    return fs, fm, cm


def sums_of(fs):
    """[V, 11] host array of JAX sums: count, psum, ppsum, wsum."""
    return np.concatenate([np.asarray(fs.count)[:, None], np.asarray(fs.psum), np.asarray(fs.ppsum),
                           np.asarray(fs.wsum)[:, None]], axis=1)


def float64_window(kfs, k, origin, dims, res):
    """The window's K keyframes scattered into float64 sums [V, 11] on the
    grid at `origin` (world points and corner-relative moments in float64
    from the float32 inputs)."""
    v = int(np.prod(dims))
    out = np.zeros((v, 11))
    oc = np.round(np.float64(origin) / res).astype(np.int64)
    for kf in kfs[-k:]:
        T = np.float64(kf["pose"])
        p = np.float64(kf["points"][kf["mask"]]) @ T[:3, :3].T + T[:3, 3]
        cell = np.floor(p / res).astype(np.int64)
        c = cell - oc
        inb = np.all((c >= 0) & (c < np.asarray(dims)), axis=1)
        rel = (p - cell * res)[inb]
        vid = ((c[inb, 0] * dims[1] + c[inb, 1]) * dims[2] + c[inb, 2])
        x, y, z = rel.T
        cols = [np.ones(len(vid)), x, y, z, x * x, x * y, x * z, y * y, y * z, z * z, np.float64(kf["weights"][kf["mask"]][inb])]
        for i, col in enumerate(cols):
            out[:, i] += np.bincount(vid, weights=col, minlength=v)
    return out


def sums_gaps(a, b, rows):
    """Largest |a - b| of psum and of ppsum over `rows`."""
    d = np.abs(a[rows] - b[rows])
    return float(d[:, 1:4].max(initial=0.0)), float(d[:, 4:10].max(initial=0.0))


def icov_rows(keys, packed):
    """{voxel id: icov upper triangle [6]} of a map's valid compact rows."""
    ok = (keys >= 0) & (packed[:, 10] > 0.5)
    return keys[ok], packed[ok, 4:10].astype(np.float64)


def float64_icov(sums, cfg):
    """The window's conditioned inverse covariances in float64 (the
    reference's conditioning with numpy's eigh): (voxel ids, upper [R, 6])."""
    n = sums[:, 0]
    vid = np.flatnonzero(n >= cfg.ndt.min_points_per_voxel)
    n = n[vid]
    rel, pp = sums[vid, 1:4] / n[:, None], sums[vid, 4:10] / n[:, None]
    iu = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    cov = np.zeros((len(vid), 3, 3))
    for c, (i, j) in enumerate(iu):
        cov[:, i, j] = cov[:, j, i] = pp[:, c] - rel[:, i] * rel[:, j]
    cov *= ((n - 1.0) / n)[:, None, None]
    ev, V = np.linalg.eigh(cov)
    ok = (ev[:, 0] >= 0.0) & (ev[:, 2] > 0.0)
    ev = np.maximum(ev, 0.01 * ev[:, 2:3])
    icov = np.einsum("rik,rk,rjk->rij", V, 1.0 / np.maximum(ev, 1e-12), V)
    return vid[ok], np.stack([icov[ok, i, j] for i, j in iu], axis=1)


def icov_gap(a, b):
    """Voxels valid in both of (ids, upper) a and b (b the reference): the
    largest relative gap max|a - b| / max|b|, the count off by more than
    ICOV_OFF, how many were compared and how many are valid in one only."""
    common, ia, ib = np.intersect1d(a[0], b[0], return_indices=True)
    rel = np.abs(a[1][ia] - b[1][ib]).max(axis=1) / np.maximum(np.abs(b[1][ib]).max(axis=1), 1e-30)
    one_side = len(a[0]) + len(b[0]) - 2 * len(common)
    return float(rel.max(initial=0.0)), int((rel > ICOV_OFF).sum()), len(common), one_side


def probe_guesses(guess):
    """The guess moved by PROBE_STEP along x, y and z and in yaw, each way."""
    out = []
    for axis in range(4):
        for sign in (-1.0, 1.0):
            g = np.float64(guess).copy()
            if axis < 3:
                g[axis, 3] += sign * PROBE_STEP[0]
            else:
                a = sign * PROBE_STEP[1]
                g[:3, :3] = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]]) @ g[:3, :3]
            out.append(g.astype(np.float32))
    return out


def verdict(e_jax_port, e_jax_jax, ratio):
    if e_jax_port >= LOST_STEP and e_jax_jax >= LOST_STEP and ratio <= SUMS_RATIO:
        return "reference"
    if e_jax_port < HOLD_STEP:
        return "port alignment"
    if ratio > SUMS_RATIO:
        return "port map"
    return "undecided"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("state", help="the .npz that endurance.py --replay-front-end --state-out wrote")
    ap.add_argument("--json", help="also write the numbers to this file")
    args = ap.parse_args(argv)
    import jax.numpy as jnp

    from lidar_slam_tpu.models.registration import finalize_ndt_sums
    from lidar_slam_tpu.models.registration.ndt import NDTMapSums
    from lidar_slam_tpu.models.registration import coarsen_ndt_sums
    from lidar_slam_tpu.pipeline.front_end import _preprocess, coarse_tracking_cfg

    from endurance_witness import drive_sweeps

    t0 = time.perf_counter()
    s = np.load(args.state)
    cfg = front_end_config(str(s["config"]))
    frame = int(s["frame"])
    prev, gt_prev, gt = s["poses"][0], s["gt"][0], s["gt"][1]
    err = lambda pose: motion_error(prev, pose, gt_prev, gt)  # noqa: E731
    if not np.array_equal(s["poses"][1], s["fine_pose"]):
        raise ValueError("the saved fine pose is not the pose the port's front end returned")
    out = {"frame": frame, "port": err(s["fine_pose"])}
    print(f"frame {frame}: the port's motion error {out['port']:.4f} m"
          + ("" if out["port"] >= LOST_STEP else f", under {LOST_STEP} m: the port holds this frame"))

    # the sweep, preprocessed by the JAX package, against the port's frame
    pts, mask, _ = drive_sweeps(str(s["drive"]))(frame, gt)
    raw = np.zeros((cfg.raw_capacity, 3), np.float32)
    n = min(int(mask.sum()), cfg.raw_capacity)
    raw[:n] = pts[mask][:n]
    jf = _preprocess(jnp.asarray(raw), jnp.arange(cfg.raw_capacity) < n, cfg.frame_capacity, cfg.frame_leaf)
    same_mask = np.array_equal(np.asarray(jf.mask), s["frame_mask"])
    pre_gap = float(np.abs(np.asarray(jf.points) - s["frame_points"])[s["frame_mask"]].max()) if same_mask else None
    out.update(preprocess_same_mask=same_mask, preprocess_gap=pre_gap)
    print(f"frame {frame}: {int(s['frame_mask'].sum())} preprocessed points; the JAX preprocessing of the same "
          f"sweep: {'the same mask' if same_mask else 'ANOTHER mask'}"
          + (f", points within {pre_gap:.3e} m" if same_mask else ""))

    # 1. the JAX alignment on the port's maps and points from the port's guess
    port_maps = [jax_map(s[f"{n}_origin"], s[f"{n}_keys"], s[f"{n}_packed"], s[f"{n}_dims"], s[f"{n}_resolution"])
                 for n in ("fine", "coarse")]
    c1, f1, it1 = align(*port_maps, s["frame_points"], s["frame_mask"], s["guess"], cfg)
    out["jax_on_port"] = err(f1)
    out["jax_on_port_coarse_gap"] = float(np.linalg.norm(c1[:3, 3] - s["coarse_pose"][:3, 3]))
    print(f"1. JAX coarse-then-fine alignment on the port's maps and points, from the port's guess: motion error "
          f"{out['jax_on_port']:.4f} m ({it1} fine iterations) beside the port's {out['port']:.4f} m; coarse poses "
          f"{out['jax_on_port_coarse_gap']:.3e} m apart, fine poses {np.linalg.norm(f1[:3, 3] - s['fine_pose'][:3, 3]):.3e} m")

    # 2. the JAX incremental map over the port's keyframes, and a float64 rebuild of the window
    t1 = time.perf_counter()
    kfs = keyframes(s)
    fs, fm, cm = replay_maps(kfs, cfg)
    replay_s = time.perf_counter() - t1
    dims, res = tuple(int(d) for d in s["sums_dims"]), float(s["sums_resolution"])
    v = int(np.prod(dims))
    if not np.array_equal(np.asarray(fs.origin), s["sums_origin"]):
        raise ValueError(f"the JAX replay's grid corner {np.asarray(fs.origin)} is not the port's {s['sums_origin']}")
    port = np.zeros((v, 11), np.float32)
    port[s["sums_vid"]] = s["sums"]
    jax_s = sums_of(fs)
    f64 = float64_window(kfs, cfg.local_frame_num, s["sums_origin"], dims, res)
    count_diff = int((port[:, 0] != jax_s[:, 0]).sum())
    agree = np.flatnonzero((port[:, 0] == jax_s[:, 0]) & (jax_s[:, 0] == f64[:, 0])
                           & np.any((port != 0) | (jax_s != 0) | (f64 != 0), axis=1))
    pj = sums_gaps(port, jax_s, agree)
    p64, j64 = sums_gaps(port, f64, agree), sums_gaps(jax_s, f64, agree)
    ratio = max(p64[0] / max(j64[0], 1e-30), p64[1] / max(j64[1], 1e-30))
    rms = lambda a: float(np.sqrt(np.mean((a[agree, 1:10] - f64[agree, 1:10]) ** 2)))  # noqa: E731
    out.update(keyframes=len(kfs), replay_s=replay_s, count_diff=count_diff,
               count_diff_f64=int((jax_s[:, 0] != f64[:, 0]).sum()), voxels_compared=len(agree),
               residue_voxels=int(np.sum(np.any(jax_s[agree, 1:10] != 0, axis=1) & (f64[agree, 0] == 0))),
               psum_gap=pj[0], ppsum_gap=pj[1], port_f64=p64, jax_f64=j64, ratio=ratio,
               port_f64_rms=rms(port), jax_f64_rms=rms(jax_s))
    print(f"2. the JAX incremental map over the port's {len(kfs)} keyframe updates from an empty map ({replay_s:.1f} s): "
          f"counts differ in {count_diff} voxels (JAX against float64: {out['count_diff_f64']}); over the "
          f"{len(agree)} voxels whose counts all agree ({out['residue_voxels']} of them empty in float64 but "
          f"holding residues): port - JAX largest |psum| {pj[0]:.3e}, |ppsum| {pj[1]:.3e}")
    print(f"   against the float64 rebuild of the {cfg.local_frame_num}-keyframe window: port |psum| {p64[0]:.3e}, "
          f"|ppsum| {p64[1]:.3e} (rms {out['port_f64_rms']:.3e}); JAX |psum| {j64[0]:.3e}, |ppsum| {j64[1]:.3e} "
          f"(rms {out['jax_f64_rms']:.3e}); the port's distance over JAX's {ratio:.3f}")
    port_icov = icov_rows(s["fine_keys"], s["fine_packed"])
    jax_icov = icov_rows(np.asarray(fm.keys), np.asarray(fm.packed))
    # the window's float64 sums rounded once to float32: maps with no add/evict history
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    ideal_sums = NDTMapSums(origin=fs.origin, count=f32(f64[:, 0]), psum=f32(f64[:, 1:4]), ppsum=f32(f64[:, 4:10]),
                            wsum=f32(f64[:, 10]), dims=dims, resolution=res)
    ideal = finalize_ndt_sums(ideal_sums, dataclasses.replace(cfg.ndt, dense_stats=False))
    ideal_icov = icov_rows(np.asarray(ideal.keys), np.asarray(ideal.packed))
    exact = float64_icov(f64, cfg)
    for name, a, b in (("port - JAX", port_icov, jax_icov), ("port - float64", port_icov, exact),
                       ("JAX - float64", jax_icov, exact), ("float64 sums in float32, JAX conditioning - float64",
                                                           ideal_icov, exact)):
        g = icov_gap(a, b)
        out[f"icov {name}"] = g
        print(f"   icov {name}: largest relative gap {g[0]:.3e}, {g[1]} of {g[2]} voxels off by more than "
              f"{ICOV_OFF:.0%}, {g[3]} valid in one only")

    # 3. the JAX alignment on its own replayed maps, and on the window's maps without history
    _, f3, it3 = align(fm, cm, s["frame_points"], s["frame_mask"], s["guess"], cfg)
    out["jax_on_jax"] = err(f3)
    ideal_coarse = finalize_ndt_sums(coarsen_ndt_sums(ideal_sums), coarse_tracking_cfg(cfg.ndt))
    _, f4, it4 = align(ideal, ideal_coarse, s["frame_points"], s["frame_mask"], s["guess"], cfg)
    out["jax_on_float64_window"] = err(f4)
    print(f"3. JAX alignment on its own replayed maps, from the port's guess: motion error {out['jax_on_jax']:.4f} m "
          f"({it3} fine iterations); on maps of the float64 window (no add/evict history): {out['jax_on_float64_window']:.4f} m "
          f"({it4})")
    # the knife edge: the same alignments from guesses PROBE_STEP off the port's
    maps3 = {"port": port_maps, "JAX replay": (fm, cm), "float64 window": (ideal, ideal_coarse)}
    probes = {name: [err(align(*m, s["frame_points"], s["frame_mask"], g, cfg)[1]) for g in probe_guesses(s["guess"])]
              for name, m in maps3.items()}
    out["probes"] = probes
    print(f"4. from {len(probes['port'])} guesses {PROBE_STEP[0] * 1e3:g} mm or {PROBE_STEP[1] * 1e3:g} mrad off the "
          f"port's (x, y, z, yaw, each way), JAX loses the frame on "
          + ", ".join(f"{name}'s maps in {sum(e >= LOST_STEP for e in v)} (motion errors {min(v):.4f}-{max(v):.4f} m)"
                      for name, v in probes.items()))
    out["verdict"] = verdict(out["jax_on_port"], out["jax_on_jax"], ratio) if out["port"] >= LOST_STEP else "no loss"
    print(f"verdict: {out['verdict']}: {VERDICTS[out['verdict']]} ({time.perf_counter() - t0:.1f} s)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 1 if out["verdict"] == "no loss" else 0


if __name__ == "__main__":
    sys.exit(main())

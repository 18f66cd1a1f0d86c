#!/usr/bin/env python3
"""Hold the port's A-LOAM step, as the card ran it, to the JAX package's
step on the same state and sweep.

    python3 endurance.py --front-end aloam --aloam-states auto --states-out STATES.npz   # on a GPU
    JAX_PLATFORMS=cpu python3 aloam_witness.py STATES.npz

endurance.py keeps, for a few frames of its A-LOAM run, the port's
AloamState before the frame, the frame's padded sweep, the port's pose
and the port's state after the frame (save_aloam_states). For each such
frame this script runs the JAX `aloam_step`
(lidar_slam_tpu/pipeline/aloam/pipeline.py) on the port's state and
sweep, at the configurations the run used (the JAX CLI's `_AloamFrontEnd`
ones, lidar_slam_tpu/cli.py:244-256, for a run at the CLI's widths; the
script says whether they are) with knn="xla" on the CPU, and prints:

1. the pose gap to the port's (m and rad) and the odometry's (T_world),
   and both packages' frame-to-frame motion errors;
2. the features: JAX's extract_features against the port's, which the
   state after the frame holds (less-sharp and less-flat clouds and their
   rings): the same masks, the largest point gap;
3. the maps: JAX's map_update of the port's maps with the stacks of the
   port's features at the port's pose, against the port's new maps (the
   same masks, so the same counts, and points within MAP_TOL; a map whose
   fold offers more voxels than its capacity departs by the fold's rule,
   which is no failure: the port keeps the voxels nearest the sensor,
   laserMapping's window first, where JAX keeps the first in key order,
   map_verdict); and JAX's
   own step's maps (counts and largest gap, reported); and how many points
   of each map before the frame lie within NEAR_M of the step's guess.

The sweep's rows on the 64-ring formula's edges (RING_EDGES: the
simulator's beams 0, 32 and 63 sit exactly on them) are kept, dropped or
given a ring by the last bit of each library's float32 atan2, so the
features are compared on the sweep with those rows turned NUDGE_DEG to
the side the port's rounding put them (edge_nudge; the file holds the
port's ring and validity of every row): the same masks and rings, points
within the move. The maps are compared apart from the features and the
pose: JAX's fold of the port's own features at the port's pose.

A frame whose pose gap is over POSE_TOL is split (VERDICTS):
"reference" when the JAX step on the port's state loses the frame too (a
frame-to-frame motion error over LOST_STEP); "ring edges" when JAX on the
moved sweep comes within POSE_TOL; "neighbour sets" when JAX on the moved
sweep with its bucket caps raised to hold the fullest cell (knn_query
then exact, as K2 is at any table size) does; "knife edge" when that
exact step, from guesses 1 mm or 1 mrad off the port's state's (PROBES),
moves at least as far as the port is from it (a step the reference
itself does not pin down); "port" otherwise. Exits 1
when a frame is "port" or a feature or map check fails. Imports nothing
of the port; needs no GPU.
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

POSE_TOL = 5e-3  # m and rad: the port's A-LOAM parity tolerance (tests/test_torch_aloam.py)
MAP_TOL = 1e-4  # m: map points (tests/test_torch_aloam.py's map_update parity)
LOST_STEP = 0.3  # m, a frame-to-frame motion error that counts a frame as lost (endurance.py's)
CANDIDATE_BYTES = 256 * 2**20  # bound of one knn_query chunk's candidate tensor in the exact rerun
# the 64-ring formula's edges, deg (scanRegistration.cpp:188-202): the top kept at <= 2, the upper formula at
# >= -8.83, the bottom kept at >= -24.33; hdl64_elevations puts beams 0, 32 and 63 on them
RING_EDGES = (2.0, -8.83, -24.33)
EDGE_DEG = 1e-5  # a row whose float64 elevation is this close to an edge sits on it
NUDGE_DEG = 1e-4  # how far edge_nudge turns such a row, well past float32 rounding (~2.4e-7 deg at 2 deg)
NEAR_M = 25.0  # m: the map points counted around the step's guess (horizontal distance)


def _probe(axis, step):
    T = np.eye(4, dtype=np.float32)
    if axis < 3:
        T[axis, 3] = step
    else:
        T[:2, :2] = [[np.cos(step), -np.sin(step)], [np.sin(step), np.cos(step)]]
    return T


# the knife-edge probe's guesses: 1 mm along each axis and 1 mrad of yaw, each way
PROBES = [_probe(a, sgn * 1e-3) for a in range(4) for sgn in (1.0, -1.0)]

VERDICTS = {
    "within": "within POSE_TOL of the JAX step",
    "reference": "a reference behaviour: the JAX step on the port's state loses the frame too",
    "ring edges": "a reference behaviour: rows on the ring formula's edges, which each library's float32 rounding "
                  "puts on either side; with them moved to the port's side JAX comes within POSE_TOL",
    "neighbour sets": "the neighbour sets differ: JAX's knn_query keeps at most bucket_k points a cell, K2 every "
                      "one; JAX with caps that hold every cell comes within POSE_TOL of the port",
    "knife edge": "a reference behaviour: the JAX step with exact neighbour sets moves as far as the port is "
                  "from it for a guess 1 mm or 1 mrad off",
    "port": "the port's step: JAX, with exact neighbour sets too, holds the frame elsewhere",
}


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def configs(text):
    """The JAX (feature extraction, odometry, mapping) configs of a states
    file's JSON, knn="xla", and whether they are the JAX CLI's."""
    from lidar_slam_tpu import cli as jcli
    from lidar_slam_tpu.pipeline import aloam as ja

    c = json.loads(text)
    fe = ja.FeatureExtractionConfig(**_tuples(c["feature_extraction"]))
    odo = ja.AloamOdometryConfig(**_tuples(c["odometry"]))
    mp = ja.AloamMappingConfig(**_tuples(c["mapping"]))
    cli = jcli._AloamFrontEnd(capacity=fe.capacity)
    is_cli = (fe, odo, mp) == (cli.fe_cfg, cli.odo_cfg, cli.map_cfg)
    return fe, dataclasses.replace(odo, knn="xla"), dataclasses.replace(mp, knn="xla"), is_cli


def jax_state(z, prefix, j):
    """The JAX AloamState of row j of a states file's `prefix` leaves, in the
    JAX field order (the file's `fields`)."""
    import jax.numpy as jnp

    from lidar_slam_tpu.ops.pointcloud import PointCloud
    from lidar_slam_tpu.pipeline.aloam.pipeline import AloamState

    names = [str(f) for f in z["fields"]]
    if tuple(names) != tuple(f.name for f in dataclasses.fields(AloamState)):
        raise ValueError(f"the file's fields {names} are not the JAX AloamState's")
    leaves = {}
    for name in names:
        if f"{prefix}{name}_points" in z.files:
            leaves[name] = PointCloud(points=jnp.asarray(z[f"{prefix}{name}_points"][j]),
                                      mask=jnp.asarray(z[f"{prefix}{name}_mask"][j]))
        else:
            leaves[name] = jnp.asarray(z[f"{prefix}{name}"][j])
    return AloamState(**leaves)


def pose_gap(a, b):
    """(translation m, rotation rad) between two [4, 4] poses."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): exact where the trace's arccos loses small angles
    s = np.linalg.norm(a[:3, :3] - b[:3, :3]) / (2.0 * np.sqrt(2.0))
    return float(np.linalg.norm(a[:3, 3] - b[:3, 3])), float(2.0 * np.arcsin(min(s, 1.0)))


def motion_error(prev, pose, gt_prev, gt):
    """The frame-to-frame motion error against the truth's, m."""
    step = lambda a, b: (np.linalg.inv(np.asarray(a, np.float64)) @ np.asarray(b, np.float64))[:3, 3]  # noqa: E731
    return float(np.linalg.norm(step(prev, pose) - step(gt_prev, gt)))


def map_verdict(same: bool, gap: float, jax_count: int, capacity: int) -> str:
    """A map's check: "equal" (the same mask, points within MAP_TOL), "the
    fold's rule" where JAX's fold filled the capacity (it offered at least
    as many voxels: past capacity the port keeps those nearest the sensor,
    JAX the first in key order), "differs" otherwise."""
    if same and gap <= MAP_TOL:
        return "equal"
    return "the fold's rule" if jax_count >= capacity else "differs"


def cloud_gap(mask_a, pts_a, mask_b, pts_b):
    """(the same masks, the largest point gap over the masked rows)."""
    mask_a, mask_b = np.asarray(mask_a, bool), np.asarray(mask_b, bool)
    if mask_a.shape != mask_b.shape or not np.array_equal(mask_a, mask_b):
        return False, None
    d = np.abs(np.asarray(pts_a, np.float64)[mask_a] - np.asarray(pts_b, np.float64)[mask_b])
    return True, float(d.max()) if d.size else 0.0


def fullest_cell(cloud, cell, dims):
    """The most points one cell of a bucket grid over `cloud` holds."""
    from lidar_slam_tpu.ops.hashgrid import build_bucket_grid

    return int(np.asarray(build_bucket_grid(cloud, cell, dims).cell_counts).max())


def exact_configs(state, odo, mp):
    """odo and mp with bucket_k raised to the fullest cell of the grids the
    step builds from this state (the previous features', the maps'), and
    chunks that keep a chunk's candidates under CANDIDATE_BYTES."""
    ko = max(odo.bucket_k, fullest_cell(state.prev_less_sharp, odo.grid_cell, odo.grid_dims),
             fullest_cell(state.prev_less_flat, odo.grid_cell, odo.grid_dims))
    km = max(mp.bucket_k, fullest_cell(state.corner_map, mp.grid_cell, mp.grid_dims),
             fullest_cell(state.surf_map, mp.grid_cell, mp.grid_dims))
    chunk = lambda k, c: int(max(64, min(c, CANDIDATE_BYTES // (27 * k * 16))))  # noqa: E731
    return (dataclasses.replace(odo, bucket_k=ko, chunk=chunk(ko, odo.chunk)),
            dataclasses.replace(mp, bucket_k=km, chunk=chunk(km, mp.chunk)), ko, km)


def edge_nudge(points, mask, port_ring, port_ok, n_scans):
    """The sweep with every valid row that sits on an edge of the 64-ring
    formula (its float64 elevation within EDGE_DEG of RING_EDGES) turned
    NUDGE_DEG in elevation, range and azimuth kept, to the side the port's
    rounding put it: inside for a row the port kept at the top or bottom
    edge, outside for one it dropped; above -8.83 for a row it gave the
    upper formula's ring, below for the lower's. Returns (points, rows
    moved, largest move in m)."""
    p = np.asarray(points, np.float64)
    h = np.hypot(p[:, 0], p[:, 1])
    el = np.degrees(np.arctan2(p[:, 2], h))
    side = np.zeros(len(p))
    if n_scans == 64:
        top, split, bottom = RING_EDGES
        on = lambda e: np.asarray(mask, bool) & (np.abs(el - e) < EDGE_DEG)  # noqa: E731
        side = np.where(on(top), np.where(port_ok, -1.0, 1.0), side)
        side = np.where(on(split), np.where(port_ring >= 33, 1.0, -1.0), side)
        side = np.where(on(bottom), np.where(port_ok, 1.0, -1.0), side)
    moved = np.flatnonzero(side)
    out = np.asarray(points, np.float32).copy()
    if len(moved):
        r = np.linalg.norm(p[moved], axis=1)
        e = np.radians(el[moved] + side[moved] * NUDGE_DEG)
        k = r * np.cos(e) / np.maximum(h[moved], 1e-12)
        out[moved] = np.stack([p[moved, 0] * k, p[moved, 1] * k, r * np.sin(e)], axis=1).astype(np.float32)
    gap = float(np.linalg.norm(out[moved].astype(np.float64) - p[moved], axis=1).max()) if len(moved) else 0.0
    return out, len(moved), gap


def feature_gaps(f, z, j):
    """JAX's features `f` against the port's (the state after the frame)."""
    out = {}
    for name in ("less_sharp", "less_flat"):
        cloud = getattr(f, name)
        same, gap = cloud_gap(cloud.mask, cloud.points, z[f"after_prev_{name}_mask"][j],
                              z[f"after_prev_{name}_points"][j])
        rings = np.array_equal(np.asarray(getattr(f, f"{name}_ring")), z[f"after_prev_{name}_ring"][j])
        out[name] = {"same_mask": same, "gap": gap, "same_rings": rings, "points": int(np.asarray(cloud.mask).sum())}
    return out


def witness_frame(z, j, fe, odo, mp):
    """Frame row j: every number the docstring lists, and its verdict."""
    import jax.numpy as jnp

    from lidar_slam_tpu.ops.pointcloud import PointCloud
    from lidar_slam_tpu.pipeline import aloam as ja
    from lidar_slam_tpu.pipeline.aloam import mapping as jmapping

    t0 = time.perf_counter()
    state = jax_state(z, "before_", j)
    raw, mask = z["points"][j], jnp.asarray(z["mask"][j])
    port_pose = z["T_map"][j]
    prev, gp, g = z["pose_prev"][j], z["gt_prev"][j], z["gt"][j]
    out = {"frame": int(z["frames"][j]), "reason": str(z["reasons"][j])}

    def step(points, o=odo, m=mp, with_pose=False, nudge_guess=None):
        s = state
        if nudge_guess is not None:  # the mapping step's guess T_map_odom @ T_world, moved in the map frame
            s = state.replace(T_map_odom=jnp.asarray(nudge_guess @ np.asarray(state.T_map_odom), jnp.float32))
        new, T_map, T_world = ja.aloam_step(s, jnp.asarray(points), mask, fe, o, m)
        T_map = np.asarray(T_map)
        out = {"pose_gap": pose_gap(T_map, port_pose), "odometry_gap": pose_gap(T_world, z["after_T_world"][j]),
               "motion_error": motion_error(prev, T_map, gp, g)}
        return (out, T_map) if with_pose else (out, new)

    out["raw"], new = step(raw)
    out["motion_error_port"] = motion_error(prev, port_pose, gp, g)
    out["features_raw"] = feature_gaps(ja.extract_features(jnp.asarray(raw), mask, fe), z, j)
    nudged, n_moved, moved_m = edge_nudge(raw, z["mask"][j], z["port_ring"][j], z["port_ring_ok"][j], fe.n_scans)
    out["edge_rows"], out["edge_move"] = n_moved, moved_m
    out["features"] = feature_gaps(ja.extract_features(jnp.asarray(nudged), mask, fe), z, j)

    # the fold alone: JAX's stacks of the port's own features, folded at the port's pose
    port_feats = [PointCloud(points=jnp.asarray(z[f"after_prev_{k}_points"][j]),
                             mask=jnp.asarray(z[f"after_prev_{k}_mask"][j])) for k in ("less_sharp", "less_flat")]
    stacks = jmapping.downsample_stacks(*port_feats, mp)
    at_port = jmapping.map_update(state.corner_map, state.surf_map, *stacks, jnp.asarray(port_pose), mp)
    maps = {}
    for name, mine, own in (("corner", at_port[0], new.corner_map), ("surf", at_port[1], new.surf_map)):
        pm, pp = z[f"after_{name}_map_mask"][j], z[f"after_{name}_map_points"][j]
        same, gap = cloud_gap(mine.mask, mine.points, pm, pp)
        own_same, own_gap = cloud_gap(own.mask, own.points, pm, pp)
        n_jax = int(np.asarray(mine.mask).sum())
        maps[name] = {"port": int(pm.sum()), "jax_at_port_pose": n_jax, "same_mask": same,
                      "gap": gap, "verdict": map_verdict(same, gap, n_jax, len(pm)),
                      "jax_step": int(np.asarray(own.mask).sum()), "jax_step_same_mask": own_same,
                      "jax_step_gap": own_gap}
    out["maps"] = maps
    # what the step matched against near the sensor: a full map's fold drops its largest-x voxels
    guess = np.asarray(z["before_T_map_odom"][j], np.float64) @ np.asarray(z["after_T_world"][j], np.float64)
    out["near"] = {name: int(np.sum(z[f"before_{name}_map_mask"][j] & (np.linalg.norm(
        z[f"before_{name}_map_points"][j][:, :2] - guess[:2, 3], axis=1) <= NEAR_M))) for name in ("corner", "surf")}

    within = lambda r: max(r["pose_gap"]) <= POSE_TOL  # noqa: E731
    if within(out["raw"]):
        out["verdict"] = "within"
    elif out["raw"]["motion_error"] > LOST_STEP:
        out["verdict"] = "reference"
    else:
        out["nudged"] = step(nudged)[0]
        if within(out["nudged"]):
            out["verdict"] = "ring edges"
        else:
            odo_x, mp_x, ko, km = exact_configs(state, odo, mp)
            exact, T_x = step(nudged, odo_x, mp_x, with_pose=True)
            out["exact"] = {**exact, "bucket_k_odometry": ko, "bucket_k_mapping": km}
            if within(out["exact"]):
                out["verdict"] = "neighbour sets"
            else:
                # the knife edge: how far the exact-neighbour step moves for a guess 1 mm or 1 mrad off
                spread = [pose_gap(step(nudged, odo_x, mp_x, with_pose=True, nudge_guess=d)[1], T_x)
                          for d in PROBES]
                out["knife_edge"] = [max(g[0] for g in spread), max(g[1] for g in spread)]
                gap = pose_gap(T_x, port_pose)
                edge = gap[0] <= out["knife_edge"][0] and gap[1] <= out["knife_edge"][1]
                out["verdict"] = "knife edge" if edge else "port"
    feat_tol = out["edge_move"] + 1e-6
    out["checks_ok"] = all(v["same_mask"] and v["gap"] <= feat_tol and v["same_rings"]
                           for v in out["features"].values()) and all(
        v["verdict"] != "differs" for v in maps.values())
    out["seconds"] = time.perf_counter() - t0
    return out


def print_frame(w):
    say = lambda s: print(f"[frame {w['frame']}] {s}", flush=True)  # noqa: E731
    run = lambda r: (f"pose gap {r['pose_gap'][0]:.3e} m, {r['pose_gap'][1]:.3e} rad; odometry (T_world) gap "  # noqa: E731
                     f"{r['odometry_gap'][0]:.3e} m, {r['odometry_gap'][1]:.3e} rad; motion error "
                     f"{r['motion_error']:.4f} m")
    say(f"kept as: {w['reason']}; witnessed in {w['seconds']:.1f} s")
    say(f"the JAX step on the port's state and sweep: {run(w['raw'])} (the port's {w['motion_error_port']:.4f} m; "
        f"POSE_TOL {POSE_TOL})")
    feats = lambda fs: "; ".join(f"{k} {v['points']} points, same mask {v['same_mask']}, same rings "  # noqa: E731
                                 f"{v['same_rings']}, largest gap {v['gap']}" for k, v in fs.items())
    say(f"features, the sweep as it is: {feats(w['features_raw'])}")
    say(f"features, {w['edge_rows']} rows on the ring formula's edges moved {NUDGE_DEG} deg to the port's side "
        f"(at most {w['edge_move']:.2e} m): {feats(w['features'])}")
    for name, v in w["maps"].items():
        say(f"{name} map: port {v['port']}, JAX's fold of the port's features at the port's pose "
            f"{v['jax_at_port_pose']} (same mask {v['same_mask']}, largest gap {v['gap']}; MAP_TOL {MAP_TOL}: "
            f"{v['verdict']}); JAX's "
            f"own step {v['jax_step']} (same mask {v['jax_step_same_mask']}, largest gap {v['jax_step_gap']})")
    say(f"map points within {NEAR_M} m of the step's guess: corner {w['near']['corner']}, surf {w['near']['surf']}")
    if "nudged" in w:
        say(f"the JAX step on the moved sweep: {run(w['nudged'])}")
    if "exact" in w:
        x = w["exact"]
        say(f"the JAX step on the moved sweep with bucket_k {x['bucket_k_odometry']} (odometry) and "
            f"{x['bucket_k_mapping']} (mapping): {run(x)}")
    if "knife_edge" in w:
        say(f"that step from {len(PROBES)} guesses 1 mm or 1 mrad off: up to {w['knife_edge'][0]:.3e} m, "
            f"{w['knife_edge'][1]:.3e} rad from its own pose")
    say(f"verdict: {w['verdict']}: {VERDICTS[w['verdict']]}; feature and map checks "
        f"{'held' if w['checks_ok'] else 'FAILED'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("states", help="the .npz that endurance.py --states-out wrote")
    ap.add_argument("--frames", help="comma-separated frames of the file to witness (default: all)")
    ap.add_argument("--json", metavar="F", help="write every number as JSON")
    args = ap.parse_args(argv)
    z = np.load(args.states)
    fe, odo, mp, is_cli = configs(str(z["configs"]))
    frames = [int(f) for f in z["frames"]]
    want = frames if args.frames is None else [int(f) for f in args.frames.split(",")]
    which = "the JAX CLI's (lidar_slam_tpu/cli.py _AloamFrontEnd)" if is_cli else "NOT the JAX CLI's"
    print(f"{len(frames)} frames kept {frames}; configurations {which}, sweeps of {fe.capacity} rows, knn xla",
          flush=True)
    out = []
    for j, f in enumerate(frames):
        if f in want:
            out.append(witness_frame(z, j, fe, odo, mp))
            print_frame(out[-1])
    bad = [w["frame"] for w in out if w["verdict"] == "port" or not w["checks_ok"]]
    print(f"verdicts: { {w['frame']: w['verdict'] for w in out} }; "
          + (f"FAILED at frames {bad}" if bad else "every frame within POSE_TOL or split"), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"cli_configs": is_cli, "frames": out}, f)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""A cell small enough for the CPU: the shuttle mix on a 60 m corridor with
16 384-row sweeps, and the NDT mapping configuration at the program's
small synthetic widths (configs/synthetic_small.yaml's), with loops found
by GNSS after 8 keyframes so that a lap closes some, and one window lap at
any test's length."""

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(kind, name):
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def config() -> dict:
    c = copy.deepcopy(_load("configs", "kitti_hdl64_ndt"))
    c["sweep"].update(rows=8192, max_range_m=40.0)
    fe = c["cli_config"]["front_end"]
    fe["ndt"].update(grid_dims=[96, 96, 24], max_iter=25, point_chunk=2048)
    fe.update(frame_capacity=8192, keyframe_capacity=8192, raw_capacity=16384, local_frame_num=10)
    # a solve every third keyframe, so that every window holds some
    c["cli_config"]["back_end"].update(optimize_step_with_loop=1, optimize_step_with_key_frame=3,
                                       optimize_step_with_gnss=3, max_nodes=256, max_edges=512, max_priors=256)
    c["cli_config"]["loop_closing"] = {
        "loop_method": "gps", "loop_step": 1, "diff_num": 8, "detect_area": 6.0, "extend_frame_num": 1,
        "fitness_score_limit": 0.35, "submap_capacity": 16384, "scan_capacity": 8192,
        "ndt": {"resolution": 1.0, "grid_dims": [96, 96, 24], "point_chunk": 2048, "max_iter": 25}}
    # the small cell's own limits, from its own readings on the CPU (one recording; PERF.md): track_gap_p90 0.0195
    # sound, 0.0748 with the control in the program's place; track_over_share 0.054 sound, 0.141 with every 11th
    # pose 5 cm off, 0.217 with the control
    c["limits"] = {"track_gap_p90": 0.03, "track_over_share": 0.1, "loop_gap_p90": 0.03, "solve_chi2_excess": 0.001}
    c["floors"] = {"loops_per_lap": 1, "solves_judged": 1}
    c["judge"].update(gap_threshold=0.05, frame_capacity=8192, keyframe_capacity=8192, loop_submap_capacity=16384,
                      loop_scan_capacity=8192, loop_grid=[96, 96, 24])
    return c


def mix() -> dict:
    m = copy.deepcopy(_load("traffic", "shuttle"))
    m["world"].update(length_m=60.0, density=20.0,
                      trucks=[[[10.0, 0.0, 1.0], 0.0, [0.8, 0.0]], [[50.0, 0.0, 1.0], 3.141592653589793, [-0.8, 0.0]]])
    m["route"].update(x0_m=5.0, leg_m=16.0, turn_radius_m=1.5, setup_laps=1, nominal_frames_per_s=1.0)
    return m

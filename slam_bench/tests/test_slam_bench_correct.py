"""`correct` on the small cell: a sound run passes; the reference in
bfloat16 put in the program's place fails by the same rule, over the same
frames; and a run with the timed path broken underneath fails, once for
each fault the cell can have (a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced; the
cell runs on one chip, so it has no exchange between chips to leave out),
and once for work left out of the window (no loop accepted)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from slam_bench import harness
from slam_bench.tests import small

SEED = 2**32 + 99
SECONDS = 16.0


def run(variants=()):
    with _one_thread():
        return harness.run_cell("ndt_mapping.shuttle", SEED, SECONDS, False, "cpu", config=small.config(),
                                mix=small.mix(), variants=variants)[0]


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def patched(module, name, make):
    base = getattr(module, name)
    setattr(module, name, make(base))
    try:
        yield
    finally:
        setattr(module, name, base)


def test_sound_run_is_correct_and_the_control_is_not():
    res = run(variants=("control", "unchanged", "sparse"))
    assert res["correct"], res["checks"]
    assert res["variants"]["program"]["correct"]
    for v in ("control", "unchanged", "sparse"):
        assert not res["variants"][v]["correct"], (v, res["variants"][v])


def test_state_returned_unchanged_fails():
    """Every alignment returns the pose it was started from."""
    import lidar_slam_tpu_torch.pipeline.front_end as fe

    def make(base):
        def align(ndt_map, frame, guess, cfg, *a, **k):
            r = base(ndt_map, frame, guess, cfg, *a, **k)
            return dataclasses.replace(r, pose=torch.as_tensor(np.asarray(guess, np.float32)))
        return align

    with patched(fe, "ndt_align", make):
        assert not run()["correct"]


def test_half_the_batch_left_out_fails():
    """Each pose-graph solve sees every other edge and prior only."""
    import lidar_slam_tpu_torch.models.graph_optimizer as go

    def make(base):
        def solve(graph, cfg=go.GraphOptimizerConfig()):
            half = lambda v: v & (torch.arange(v.shape[0], device=v.device) % 2 == 0)  # noqa: E731
            return base(dataclasses.replace(graph, edge_valid=half(graph.edge_valid),
                                            prior_valid=half(graph.prior_valid)), cfg)
        return solve

    with patched(go, "optimize_pose_graph", make):
        res = run()
    assert not res["correct"] and res["checks"]["solve_chi2_excess"]["value"] > 1.0


def test_answer_altered_where_produced_fails():
    """The front end gives out every eleventh pose 5 cm off along x (an
    offset on every pose alike is a change of frame, which no judge of
    the outputs can tell from the truth's)."""
    import lidar_slam_tpu_torch.pipeline as pipeline

    def make(base):
        class Altered(base):
            calls = 0

            def update(self, *a, **k):
                pose, kf = super().update(*a, **k)
                Altered.calls += 1
                if Altered.calls % 11 == 0:
                    pose = pose.copy()
                    pose[0, 3] += 0.05
                return pose, kf
        return Altered

    with patched(pipeline, "FrontEnd", make):
        res = run()
    limit = small.config()["limits"]["track_over_share"]
    assert not res["correct"] and res["checks"]["track_over_share"]["value"] > limit, res["checks"]


def test_no_loop_accepted_fails():
    """Loop verification rejects every candidate: the window's loop edges and
    the solves they start are left out."""
    import lidar_slam_tpu_torch.pipeline as pipeline

    def make(base):
        class Rejecting(base):
            def update(self, *a, **k):
                super().update(*a, **k)
                return None
        return Rejecting

    with patched(pipeline, "LoopClosing", make):
        res = run()
    assert not res["correct"] and res["checks"]["loops_per_lap"]["value"] == 0.0, res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the small cell through the card's kernels")
    return "cuda"


@pytest.mark.cuda
def test_small_cell_on_the_card(card):
    res = harness.run_cell("ndt_mapping.shuttle", SEED, SECONDS, False, card, config=small.config(),
                           mix=small.mix(), variants=("control",))[0]
    assert res["correct"], res["checks"]
    assert not res["variants"]["control"]["correct"], res["variants"]["control"]

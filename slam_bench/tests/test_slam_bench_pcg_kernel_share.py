"""pcg_kernel_share's arithmetic on views with known `pose_graph` spans:
with the program's `pcg_launches` counter, without it (a program that has
no kernel), and with nothing to read."""

import pytest

from slam_bench.tests.test_slam_bench_trace_metrics import FRAMES, FakeRun, front_ends, program, reader, span, view


def test_share_of_iterations_that_launched_the_kernel():
    spans = front_ends(FRAMES) + [
        span("pose_graph", 10, 60.0, 160.0, {"lm_iterations": 4, "pcg_launches": 4}),
        span("pose_graph", 11, 200.0, 500.0, {"lm_iterations": 6, "pcg_launches": 3}),
        span("pose_graph", None, 900.0, 5000.0, {"lm_iterations": 100, "pcg_launches": 0}),  # after the loop
    ]
    with program(FakeRun(spans)):
        assert reader("pcg_kernel_share")(view(FRAMES)) == pytest.approx(100.0 * 7 / 10)


def test_every_iteration_launched():
    spans = front_ends(FRAMES) + [span("pose_graph", 10, 60.0, 160.0, {"lm_iterations": 5, "pcg_launches": 5}),
                                  span("pose_graph", 11, 200.0, 300.0, {"lm_iterations": 2, "pcg_launches": 2})]
    with program(FakeRun(spans)):
        assert reader("pcg_kernel_share")(view(FRAMES)) == pytest.approx(100.0)


@pytest.mark.parametrize("counts", [
    {"lm_iterations": 4, "pcg_steps": 400, "pcg_active_steps": 100},  # the parent: no such counter
    {"lm_iterations": 0, "pcg_launches": 0},  # no iteration to share
])
def test_nothing_to_read(counts):
    spans = front_ends(FRAMES) + [span("pose_graph", 10, 60.0, 160.0, counts)]
    with program(FakeRun(spans)):
        assert reader("pcg_kernel_share")(view(FRAMES)) is None
    with program(None):
        assert reader("pcg_kernel_share")(view(FRAMES)) is None

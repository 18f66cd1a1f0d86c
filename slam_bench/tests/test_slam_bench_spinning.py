"""The traffic generator's two sensors: the draw sensor's drive is the one
it was before the spinning sensor came, to the bit; a spinning sweep is a
ring-major panorama of one return a beam direction, the least range in
each cell, that A-LOAM's ring formula reads back ring for ring."""

import hashlib
import math

import numpy as np
import pytest

from slam_bench.tests import small
from slam_bench.traffic.generator import Spinning, Surfaces, Truck, _spinning_sweep, corridor, make_drive, route

# sha256 over every frame's points, boxes, GNSS and truth of the small mix's traced drive under the draw
# sensor at 2 048 rows, recorded before the spinning sensor was added
DRAW_DIGEST = "73c2d2dd216d32c0edb89b2af5907235fa296d5408f19e25efeca31ffae6dd7f"

HDL64 = [2.0 - k / 3.0 for k in range(32)] + [-8.83 - k / 2.0 for k in range(32)]
SMALL_BEAMS = list(np.linspace(2.0, -22.0, 16))


def digest(d) -> str:
    h = hashlib.sha256()
    for i in range(d.n):
        for a in (d.points[i], d.bboxes[i], d.gnss[i], d.truth[i]):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def spinning(beams, bins) -> dict:
    return {**small.config()["sweep"], "sensor": "spinning", "elevations_deg": beams, "azimuth_bins": bins,
            "rows": len(beams) * bins}


def dense_mix(density=400.0) -> dict:
    m = small.mix()
    m["world"]["density"] = density
    return m


def one_sweep(sweep, mix, frame, dropout=None):
    """(the sweep's returns, their cells, every surface sample in the
    sensor frame, which of them are the trucks') at `frame` of the mix's
    route, on the CPU."""
    w = mix["world"]
    world = corridor(w["length_m"], w["width_m"], w["density"], w["world_seed"])
    trucks = [Truck(tuple(c), float(h), tuple(v)) for c, h, v in w["trucks"]]
    surfaces = Surfaces.of(world, trucks, w["density"], "cpu")
    T = route(mix["route"]).poses[frame]
    t, seed = frame / sweep["rate_hz"], int(mix["recording_seed"])
    pts, _, cell = _spinning_sweep(surfaces, T, t, seed, frame, Spinning.of(sweep), sweep["max_range_m"],
                                   sweep["min_range_m"], sweep["noise_m"],
                                   sweep["dropout"] if dropout is None else dropout)
    sides = surfaces.near(float(T[0, 3]), math.inf, t, seed, frame)[len(world):].numpy()
    seen = np.concatenate([world.astype(np.float64), sides])
    Tinv = np.linalg.inv(T.astype(np.float64))
    return pts, cell.numpy(), seen @ Tinv[:3, :3].T + Tinv[:3, 3], np.arange(len(seen)) >= len(world)


@pytest.mark.parametrize("sensor", [None, "draw"])
def test_the_draw_sensor_is_unchanged(sensor):
    sweep = {**small.config()["sweep"], "rows": 2048}
    if sensor is not None:
        sweep["sensor"] = sensor
    assert digest(make_drive(small.mix(), sweep, "cpu", 10.0, trace=True)) == DRAW_DIGEST


def test_hdl64_returns_keep_to_their_rings():
    """Each return lies on its ring's beam, well inside the elevation gate,
    and A-LOAM's 64-ring formula (scanRegistration.cpp) gives its ring
    back."""
    bins = 128
    pts, cell, _, _ = one_sweep(spinning(HDL64, bins), dense_mix(), 40)
    assert len(pts) > 2000
    ring = cell // bins
    p = pts.astype(np.float64)
    angle = np.rad2deg(np.arctan2(p[:, 2], np.hypot(p[:, 0], p[:, 1])))
    assert np.max(np.abs(angle - np.asarray(HDL64)[ring])) < 1e-3 < Spinning(tuple(HDL64), bins).gate
    formula = np.where(angle >= -8.83, np.floor((2.0 - angle) * 3.0 + 0.5),
                       32 + np.floor((-8.83 - angle) * 2.0 + 0.5)).astype(np.int64)
    assert np.array_equal(formula, ring)
    assert len(np.unique(ring)) > 40


def test_returns_come_ring_by_ring_in_azimuth_order():
    bins = 256
    pts, cell, _, _ = one_sweep(spinning(SMALL_BEAMS, bins), dense_mix(), 12)
    assert np.all(np.diff(cell) > 0)  # ring-major, one return a cell
    ring = cell // bins
    az = np.arctan2(pts[:, 1].astype(np.float64), pts[:, 0])
    for r in np.unique(ring):
        a = az[ring == r]
        assert np.all(np.diff(a) > 0)
        # each return sits in the middle of its azimuth bin
        mid = ((cell[ring == r] % bins) + 0.5) / bins * 2 * math.pi - math.pi
        assert np.max(np.abs(a - mid)) < 1e-5


@pytest.mark.parametrize("frame", [12, 40])
def test_each_return_is_the_nearest_surface_of_its_cell(frame):
    """Occlusion: a return's range is, within the noise, the least range of
    the world's and the trucks' samples in its cell (a brute-force minimum
    a cell), and every cell that holds a sample returns."""
    sweep = spinning(SMALL_BEAMS, 256)
    pts, cell, local, truck = one_sweep(sweep, dense_mix(), frame, dropout=0.0)
    beams = np.asarray(SMALL_BEAMS)
    r = np.linalg.norm(local, axis=1)
    el = np.rad2deg(np.arctan2(local[:, 2], np.hypot(local[:, 0], local[:, 1])))
    ring = np.argmin(np.abs(el[:, None] - beams[None, :]), axis=1)
    b = np.clip(((np.arctan2(local[:, 1], local[:, 0]) + math.pi) / (2 * math.pi) * 256).astype(np.int64), 0, 255)
    seen = ((r >= sweep["min_range_m"]) & (r <= sweep["max_range_m"])
            & (np.abs(el - beams[ring]) <= Spinning(tuple(SMALL_BEAMS), 256).gate))
    least = np.full(len(beams) * 256, np.inf)
    np.minimum.at(least, ring[seen] * 256 + b[seen], r[seen])
    without_trucks = np.full_like(least, np.inf)
    keep = seen & ~truck
    np.minimum.at(without_trucks, ring[keep] * 256 + b[keep], r[keep])
    hit = np.flatnonzero(np.isfinite(least))
    assert np.array_equal(cell, hit)
    assert np.max(np.abs(np.linalg.norm(pts.astype(np.float64), axis=1) - least[hit])) < 6 * sweep["noise_m"]
    # the trucks stand in front of what lies behind them
    assert np.sum(least[hit] < without_trucks[hit] - 0.5) > 20


def test_one_mix_one_spinning_drive():
    sweep = spinning(SMALL_BEAMS, 128)
    a = make_drive(dense_mix(100.0), sweep, "cpu", 1.0)
    b = make_drive(dense_mix(100.0), sweep, "cpu", 1.0)
    other = dense_mix(100.0)
    other["recording_seed"] += 1
    c = make_drive(other, sweep, "cpu", 1.0)
    assert digest(a) == digest(b)
    assert np.array_equal(a.truth, c.truth) and all(np.array_equal(x, y) for x, y in zip(a.bboxes, c.bboxes))
    assert not np.array_equal(a.gnss, c.gnss)
    assert all(len(x) != len(y) or not np.array_equal(x, y) for x, y in zip(a.points, c.points))
    assert all(0 < len(p) <= sweep["rows"] for p in a.points)


@pytest.mark.parametrize("rows", [16 * 128 - 1, 16 * 128 + 16])
def test_rows_must_be_rings_by_bins(rows):
    sweep = {**spinning(SMALL_BEAMS, 128), "rows": rows}
    with pytest.raises(ValueError, match="rings"):
        make_drive(dense_mix(20.0), sweep, "cpu", 1.0)


def test_an_unknown_sensor_is_refused():
    with pytest.raises(ValueError, match="unknown sensor"):
        make_drive(small.mix(), {**small.config()["sweep"], "sensor": "solid_state"}, "cpu", 1.0)

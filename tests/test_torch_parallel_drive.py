"""The port's front end with its alignments point-sharded over ranks
(`front_end_drive(mesh=)`) against the JAX package's `front_end_drive(
mesh=)` at the same mesh size and against the port's own single-rank
drive, plain and with detector boxes, on tests/test_parallel.py's drives
(frames, capacities and configuration as there).

The JAX side runs in the pytest process on conftest's virtual CPU devices
(make_mesh(2), make_mesh(4)); the port's side in 2 and 4 gloo ranks on the
CPU, both drives in one launch per world size (a module-scoped fixture),
each rank on one torch thread, each launch with its own timeout. The
ranks import only the port.

Tolerances are test_parallel.py's (:181-280): keyframe flags equal,
positions within 8e-2 m (the sums add in another order on every layout and
the difference compounds along the pose chain), and within 0.35 m of the
truth.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_slam_tpu import parallel as jpar
from lidar_slam_tpu.io import SyntheticWorld, make_trajectory, simulate_scan
from lidar_slam_tpu.models.registration import NDTConfig as JNDTConfig
from lidar_slam_tpu.pipeline import front_end as jfe

from lidar_slam_tpu_torch.models.registration import NDTConfig as TNDTConfig
from lidar_slam_tpu_torch.parallel.launch import call_each, launch
from lidar_slam_tpu_torch.pipeline import front_end as tfe

WORLDS = (2, 4)
LAUNCH_TIMEOUT = 400.0  # s a launch of both drives
LAYOUT_TOL = 8e-2  # m, test_parallel.py:227-228
TRUTH_TOL = 0.35  # m, test_parallel.py:230
DRIVES = {
    # name: (frames, max_iter, local_frame_num, corridor seed, moving box)
    "plain": (8, 25, 10, 11, False),
    "bboxes": (6, 20, 8, 13, True),
}


def _configs(name):
    _, max_iter, local_n, _, _ = DRIVES[name]
    ndt = dict(resolution=1.0, grid_dims=(96, 96, 24), point_chunk=2048, max_iter=max_iter)
    kw = dict(frame_capacity=8192, keyframe_capacity=8192, local_frame_num=local_n)
    return jfe.FrontEndConfig(ndt=JNDTConfig(**ndt), **kw), tfe.FrontEndConfig(ndt=TNDTConfig(**ndt), **kw)


def _frames(name):
    """test_parallel.py's drive: (truth, raw points, masks, boxes or None,
    box flags or None), numpy."""
    n, _, _, seed, moving = DRIVES[name]
    cfg_j, _ = _configs(name)
    world = SyntheticWorld.corridor(length=40, seed=seed, curve=0.0)
    if moving:
        world.add_moving_box([12.0, 2.0, 1.0], [4.0, 1.8, 1.6], 0.0, [-1.0, 0.0], n_points=300)
    gt = make_trajectory(n, speed=1.0)
    cap, nb = cfg_j.raw_capacity, cfg_j.max_bboxes
    pts_seq = np.zeros((n, cap, 3), np.float32)
    msk_seq = np.zeros((n, cap), bool)
    box_seq = np.zeros((n, nb, 8), np.float32)
    bok_seq = np.zeros((n, nb), bool)
    for i in range(n):
        t, s = (float(i), 60 + i) if moving else (i * 0.1, 40 + i)
        pts, mask, bboxes = simulate_scan(world, gt[i], t=t, max_range=30.0, n_points=8192, seed=s)
        pts_seq[i, : len(pts)] = pts
        msk_seq[i, : len(pts)] = mask
        k = min(len(bboxes), nb)
        box_seq[i, :k] = bboxes[:k]
        bok_seq[i, :k] = True
    if not moving:
        return gt, pts_seq, msk_seq, None, None
    return gt, pts_seq, msk_seq, box_seq, bok_seq


def _port_args(name, data):
    gt, pts, msk, box, bok = data
    _, cfg_t = _configs(name)
    st = tfe.init_front_end_drive(cfg_t, init_pose=gt[0], device="cpu")
    boxes = () if box is None else (torch.as_tensor(box), torch.as_tensor(bok))
    return (st, torch.as_tensor(pts), torch.as_tensor(msk), cfg_t, *boxes)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    return {name: _frames(name) for name in DRIVES}


@pytest.fixture(scope="module")
def port(frames):
    """{world: {drive: (poses, is_kf, unresolved)}} from one launch a world."""
    calls = [("lidar_slam_tpu_torch.pipeline.front_end:front_end_drive", _port_args(name, frames[name]), {})
             for name in DRIVES]
    out = {}
    for world in WORLDS:
        res = launch(call_each, world, args=(calls,), device="cpu", timeout=LAUNCH_TIMEOUT)
        out[world] = {name: r[1:] for name, r in zip(DRIVES, res)}
    return out


@pytest.mark.parametrize("name", list(DRIVES))
@pytest.mark.parametrize("world", WORLDS)
def test_drive_matches_reference(world, name, frames, port):
    """The sharded drive against JAX's sharded drive at the same mesh size
    and against the port's single-rank drive: the same keyframes, poses
    within LAYOUT_TOL, every frame within TRUTH_TOL of the truth."""
    poses, kfs, unres = port[world][name]
    gt, pts, msk, box, bok = frames[name]
    assert float(unres.max()) == 0.0
    cfg_j, _ = _configs(name)
    boxes = () if box is None else (jnp.asarray(box), jnp.asarray(bok))
    st = jfe.init_front_end_drive(cfg_j, init_pose=gt[0])
    _, poses_j, kfs_j, _ = jfe.front_end_drive(st, jnp.asarray(pts), jnp.asarray(msk), cfg_j, *boxes,
                                               mesh=jpar.make_mesh(world))
    _, poses_t, kfs_t, _ = tfe.front_end_drive(*_port_args(name, frames[name]))
    got = poses.numpy()[:, :3, 3]
    for ref, ref_kf in ((np.asarray(poses_j), np.asarray(kfs_j)), (poses_t.numpy(), kfs_t.numpy())):
        assert kfs.numpy().tolist() == ref_kf.tolist()
        np.testing.assert_allclose(got, ref[:, :3, 3], atol=LAYOUT_TOL)
    assert float(np.linalg.norm(got - gt[:, :3, 3], axis=1).max()) < TRUTH_TOL

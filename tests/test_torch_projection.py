"""The port's multiview projection (``instancerefer_tpu_torch/data/
projection.py``) against the JAX package's numpy one
(``instancerefer_tpu/data/projection.py``), on the CPU.

A synthetic room of surface points, float32 poses around it (as
``load_pose`` reads them) and, for each pose, the depth frame the points
render to with a z-buffer, so that the occlusion test keeps the visible
points.  Both sides get the same numpy inputs.  The correspondence indices
must be equal exactly (both compute the geometry in float64 and round the
same way), and so must the back-projected features and both fusers'
results.
"""

import numpy as np
import pytest
import torch

from instancerefer_tpu.data import projection as jproj

from instancerefer_tpu_torch.data import projection as proj

INTRINSICS = np.array([[37.01983, 0, 20], [0, 38.52470, 15.5], [0, 0, 1.0]])


def helpers():
    return (jproj.ProjectionHelper(INTRINSICS, 0.1, 4.0, (41, 32), 0.05),
            proj.ProjectionHelper(INTRINSICS, 0.1, 4.0, (41, 32), 0.05, "cpu"))


@pytest.fixture(scope="module")
def frames():
    """Points [N, 3] float32, then (pose, depth) for 12 poses inside the
    room and one that looks out of it (no correspondence)."""
    rng = np.random.default_rng(0)
    points = proj.room_scene(rng, 6000)
    _, helper = helpers()
    out = []
    for _ in range(12):
        eye = rng.uniform([1.0, 1.0, 1.2], [5.0, 4.0, 1.8])
        pose = proj.look_at(eye, rng.uniform([0.0, 0.0, 0.0], [6.0, 5.0, 1.5]))
        out.append((pose, proj.zbuffer_depth(points, pose, helper).numpy()))
    away = proj.look_at((3.0, 2.5, 10.0), (3.0, 2.6, 20.0))  # above the room, looking up
    out.append((away, np.full((32, 41), 2.0, np.float32)))
    return points, out


def test_indices_equal_exactly(frames):
    points, poses = frames
    jh, th = helpers()
    n_covered, n_none = 0, 0
    for pose, depth in poses:
        want = jh.compute_projection(points, depth, pose)
        got = th.compute_projection(torch.from_numpy(points), torch.from_numpy(depth),
                                    torch.from_numpy(pose))
        if want is None:
            assert got is None
            n_none += 1
            continue
        for g, w in zip(got, want):
            assert g.dtype == torch.int64
            np.testing.assert_array_equal(g.numpy(), w)
        n_covered += int(want[0][0])
    assert n_none == 1 and n_covered > 0.2 * len(points)


def test_numpy_inputs_and_float32_pose_rounding(frames):
    """numpy arrays go in as they are; a float32 pose is inverted as
    ``np.linalg.inv`` inverts it (in float64, the result rounded to
    float32), a float64 pose in float64."""
    points, poses = frames
    jh, th = helpers()
    pose, depth = poses[0]
    for p in (pose, pose.astype(np.float64) + 1e-9):
        want = jh.compute_projection(points, depth, p)
        got = th.compute_projection(points, depth, p)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_project_equals(frames):
    points, poses = frames
    jh, th = helpers()
    rng = np.random.default_rng(1)
    pose, depth = poses[1]
    ind3, ind2 = jh.compute_projection(points, depth, pose)
    feat = rng.normal(size=(8, 32, 41)).astype(np.float32)
    want = jh.project(feat, ind3, ind2, len(points))
    got = th.project(torch.from_numpy(feat), torch.from_numpy(ind3), torch.from_numpy(ind2),
                     len(points))
    np.testing.assert_array_equal(got.numpy(), want)
    labels = rng.integers(0, 41, size=(32, 41))
    np.testing.assert_array_equal(
        th.project(torch.from_numpy(labels), torch.from_numpy(ind3), torch.from_numpy(ind2),
                   len(points)).numpy(),
        jh.project(labels, ind3, ind2, len(points)))


@pytest.mark.parametrize("mode", ["maxpool", "first"])
def test_fusers_equal(frames, mode):
    """Normal features (half of them negative) fused over every frame, the
    frames that see nothing included."""
    points, poses = frames
    jh, th = helpers()
    rng = np.random.default_rng(2)
    jf = jproj.FrameFeatureFuser(len(points), 16, mode)
    tf = proj.FrameFeatureFuser(len(points), 16, mode, "cpu")
    for pose, depth in poses:
        res = jh.compute_projection(points, depth, pose)
        if res is None:
            continue
        feat = rng.normal(size=(16, 32, 41)).astype(np.float32)
        p = jh.project(feat, *res, len(points)).T
        jf.add(p)
        tf.add(torch.from_numpy(np.ascontiguousarray(p)))
    np.testing.assert_array_equal(tf.result().numpy(), jf.result())
    assert (tf.result() < 0).any()


def test_maxpool_keeps_negatives_and_first_hit():
    for mode, want0 in (("maxpool", [-0.5, -2.0]), ("first", [-1.0, -2.0])):
        tf = proj.FrameFeatureFuser(3, 2, mode, "cpu")
        a = torch.zeros(3, 2)
        a[0] = torch.tensor([-1.0, -2.0])
        tf.add(a)
        b = torch.zeros(3, 2)
        b[0] = torch.tensor([-0.5, -3.0])
        b[1] = torch.tensor([5.0, 6.0])
        tf.add(b)
        out = tf.result()
        assert out[0].tolist() == want0
        assert out[1].tolist() == [5.0, 6.0] and out[2].tolist() == [0.0, 0.0]
    with pytest.raises(ValueError):
        proj.FrameFeatureFuser(3, 2, "mean", "cpu")


def test_scannet_projection_helper_equals():
    for dims in ((41, 32), (328, 256)):
        want = jproj.scannet_projection_helper(dims)
        got = proj.scannet_projection_helper(dims, device="cpu")
        np.testing.assert_array_equal(got.intrinsic.numpy(), want.intrinsic)
        np.testing.assert_array_equal(got.corner_points.numpy(), want.corner_points)
        assert got.image_dims == want.image_dims


def test_skeleton_round_trip_and_zbuffer():
    _, th = helpers()
    p = th.depth_to_skeleton(10, 20, 2.0)
    torch.testing.assert_close(th.skeleton_to_depth(p), torch.tensor([10.0, 20.0, 2.0],
                                                                    dtype=torch.float64))
    near, far = th.depth_to_skeleton(20, 15, 1.0), th.depth_to_skeleton(20, 15, 3.0)
    depth = proj.zbuffer_depth(torch.stack([far, near]), np.eye(4, dtype=np.float32), th)
    assert depth[15, 20] == 1.0 and (depth != 0).sum() == 1  # the nearest point wins

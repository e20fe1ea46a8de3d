"""The port's ``utils/pc_utils.py`` against the JAX package's: every
function on the same inputs and the same generator gives the same arrays
(equal, no tolerance: the code is numpy in both), and every writer the
same bytes."""

import inspect
import os

import numpy as np
import pytest

from instancerefer_tpu.utils import pc_utils as J

from instancerefer_tpu_torch.data import dataset
from instancerefer_tpu_torch.utils import pc_utils as P


def _file(path, write, *args, **kw):
    """The bytes ``write(*args, path, **kw)`` writes."""
    write(*args, path, **kw)
    with open(path, "rb") as f:
        return f.read()


def _boxes(rng, n=3, heading=True):
    b = np.concatenate([rng.normal(size=(n, 3)), rng.uniform(0.2, 2, size=(n, 3))], 1)
    return np.concatenate([b, rng.uniform(-np.pi, np.pi, size=(n, 1)) if heading
                           else np.zeros((n, 1))], 1)


def _jet(x):
    return (x, 1 - x, 0.5 * x, 1.0)


# name -> fn(module, rng, path): the result to compare; inputs drawn from rng
CASES = {
    "rotx": lambda m, rng, path: m.rotx(rng.uniform(-3, 3)),
    "roty": lambda m, rng, path: m.roty(rng.uniform(-3, 3)),
    "rotz": lambda m, rng, path: m.rotz(rng.uniform(-3, 3)),
    "random_sampling": lambda m, rng, path: m.random_sampling(
        rng.normal(size=(50, 4)), 20, return_choices=True, rng=rng),
    "random_sampling_upsample": lambda m, rng, path: m.random_sampling(
        rng.normal(size=(10, 3)), 30, rng=rng),
    "random_sampling_no_replace": lambda m, rng, path: m.random_sampling(
        rng.normal(size=(40, 3)), 40, replace=False, rng=rng),
    "write_ply": lambda m, rng, path: _file(path, m.write_ply, rng.normal(size=(20, 3))),
    "write_ply_rgb": lambda m, rng, path: _file(
        path, m.write_ply_rgb, rng.normal(size=(20, 3)), rng.integers(0, 256, size=(20, 3))),
    "write_obj": lambda m, rng, path: _file(
        path, m.write_obj, rng.normal(size=(12, 3)), rng.integers(0, 12, size=(6, 3))),
    "write_obj_colors": lambda m, rng, path: _file(
        path, m.write_obj, rng.normal(size=(12, 3)).astype(np.float32), None,
        colors=rng.uniform(size=(12, 3)).astype(np.float32)),
    "construct_bbox_corners": lambda m, rng, path: m.construct_bbox_corners(
        rng.normal(size=3), rng.uniform(0.1, 2, size=3)),
    "write_bbox": lambda m, rng, path: _file(path, m.write_bbox, _boxes(rng, 4, heading=False)),
    "point_cloud_to_volume": lambda m, rng, path: m.point_cloud_to_volume(
        rng.uniform(-0.9, 0.9, size=(60, 3)), 12),
    "point_cloud_to_volume_batch": lambda m, rng, path: m.point_cloud_to_volume_batch(
        rng.uniform(-0.9, 0.9, size=(3, 40, 3)), vsize=8),
    "point_cloud_to_volume_batch_unflat": lambda m, rng, path: m.point_cloud_to_volume_batch(
        rng.uniform(-0.9, 0.9, size=(2, 40, 3)), vsize=6, flatten=False),
    "volume_to_point_cloud": lambda m, rng, path: m.volume_to_point_cloud(
        (rng.random((6, 6, 6)) < 0.2).astype(float)),
    "volume_to_point_cloud_empty": lambda m, rng, path: m.volume_to_point_cloud(
        np.zeros((4, 4, 4))),
    "point_cloud_to_volume_v2": lambda m, rng, path: m.point_cloud_to_volume_v2(
        rng.uniform(-0.9, 0.9, size=(200, 3)), 4, num_sample=8, rng=rng),
    "point_cloud_to_volume_v2_batch": lambda m, rng, path: m.point_cloud_to_volume_v2_batch(
        rng.uniform(-0.9, 0.9, size=(2, 100, 3)), vsize=3, num_sample=6, rng=rng),
    "point_cloud_to_image": lambda m, rng, path: m.point_cloud_to_image(
        rng.uniform(-0.9, 0.9, size=(200, 3)), 4, num_sample=8, rng=rng),
    "point_cloud_to_image_batch": lambda m, rng, path: m.point_cloud_to_image_batch(
        rng.uniform(-0.9, 0.9, size=(2, 100, 3)), 3, num_sample=6, rng=rng),
    "rotate_point_cloud": lambda m, rng, path: m.rotate_point_cloud(
        rng.normal(size=(30, 3)), rng=rng),
    "rotate_point_cloud_matrix": lambda m, rng, path: m.rotate_point_cloud(
        rng.normal(size=(30, 3)), rotation_matrix=m.rotz(0.7)),
    "rotate_pc_along_y": lambda m, rng, path: m.rotate_pc_along_y(
        rng.normal(size=(30, 3)), rng.uniform(-3, 3)),
    "bbox_corner_dist_measure": lambda m, rng, path: [m.bbox_corner_dist_measure(
        m.construct_bbox_corners(rng.normal(size=3), s), m.construct_bbox_corners(
            rng.normal(size=3) * 0.3, s * rng.uniform(0.8, 1.2, size=3)))
        for s in rng.uniform(0.5, 2, size=(5, 3))],
    "point_cloud_to_bbox": lambda m, rng, path: m.point_cloud_to_bbox(rng.normal(size=(40, 3))),
    "point_cloud_to_bbox_batch": lambda m, rng, path: m.point_cloud_to_bbox(
        rng.normal(size=(4, 40, 3))),
    "write_oriented_bbox": lambda m, rng, path: _file(path, m.write_oriented_bbox, _boxes(rng)),
    "write_oriented_bbox_camera_coord": lambda m, rng, path: _file(
        path, m.write_oriented_bbox_camera_coord, _boxes(rng)),
    "write_lines_as_cylinders": lambda m, rng, path: (
        m.write_lines_as_cylinders(rng.normal(size=(3, 2, 3)), path, rad=0.01, res=8),
        open(path + ".ply", "rb").read())[1],
    "write_ply_color": lambda m, rng, path: _file(
        path, m.write_ply_color, rng.normal(size=(25, 3)), rng.integers(0, 5, size=25)),
    "write_ply_color_colormap": lambda m, rng, path: _file(
        path, m.write_ply_color, rng.normal(size=(25, 3)), rng.integers(0, 5, size=25),
        num_classes=7, colormap=_jet),
    "point_cloud_to_bev": lambda m, rng, path: m.point_cloud_to_bev(
        rng.uniform(-1, 3, size=(300, 3)), (0, 0), (2, 2), resolution=16),
}


def assert_same(got, want, where="result"):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, bytes):
        assert got == want, where
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), where
        np.testing.assert_array_equal(g, w, err_msg=where)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name, tmp_path):
    results = [CASES[name](m, np.random.default_rng(11), str(tmp_path / side))
               for m, side in ((P, "port"), (J, "jax"))]
    assert_same(*results)


def test_every_function_is_ported():
    """Each public function of the JAX module is in the port's, and a case
    above exercises it."""
    public = {n for n, f in inspect.getmembers(J, inspect.isfunction)
              if not n.startswith("_") and f.__module__ == J.__name__}
    assert public <= set(dir(P))
    covered = {n for n in public if any(c == n or c.startswith(n + "_") for c in CASES)}
    assert covered == public, public - covered


def test_dataset_rotations_come_from_pc_utils():
    assert (dataset.rotx, dataset.roty, dataset.rotz) == (P.rotx, P.roty, P.rotz)
    assert os.path.basename(inspect.getsourcefile(dataset.rotx)) == "pc_utils.py"

"""The benchmark's inputs: ScanRefer-like synthetic scenes and descriptions,
drawn from ``--seed``.  Both sides take them: the program builds its padded
batches from them, the reference (``reference/``) works everything out
again from the same arrays.

``make_scene`` is a copy of the port's ``data/synthetic.make_core_sample``
(random rooms with box-shaped instances, the referred object among
``num_candidates`` instances of one class), with three additions:

* the description's length is given (``description_lengths``), so every
  seed draws the same set of lengths in another order;
* ``max_candidates``: an instance whose drawn class would give the scene
  more than ``max_candidates`` instances of the described class (the
  configuration keeps that many candidates) draws another class instead,
  so that no seed draws a sample the configuration would cut;
* ``multiview``: 128 ENet-like channels per point between rgb and height,
  the input of the reference's ``--use_multiview`` path, as a stand-in for
  the fused ENet features: each point takes one row of a per-scene palette
  of ``MULTIVIEW_PALETTE`` rows, each row max(N(0, 1), 0) (features after a
  ReLU and a max pool).

A traffic file (``traffic/<name>.json``) gives the parameters under
``scene`` and ``lang_len``; ``make_pool`` draws ``pool_batches`` batches of
``batch`` descriptions.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List

import numpy as np

NUM_CLASSES = 18
WORD_DIM = 300  # GloVe's width
MULTIVIEW_DIM = 128
MULTIVIEW_PALETTE = 1024
# the stand-in for ScanNet's mean box size a class, which the size labels
# are encoded against (the port's bench's MEAN_SIZE)
MEAN_SIZE = np.linspace(0.3, 2.0, NUM_CLASSES)[:, None] * np.array([[1.0, 0.9, 0.8]])


@dataclasses.dataclass
class Scene:
    """One description of one scene, as drawn: what ScanRefer's loader
    reads for an annotation before any voxelization or padding.
    ``point_cloud`` and each of ``instance_points`` hold xyz, rgb, the
    multiview channels if any, and height."""

    lang_feat: np.ndarray  # [L, 300]
    lang_len: int
    object_cat: int
    point_cloud: np.ndarray  # [N, F]
    instance_points: List[np.ndarray]  # [1024, F] each
    instance_class: List[int]
    instance_obbs: List[np.ndarray]  # [7] each
    ref_center_label: np.ndarray  # [3]
    ref_size_class_label: int
    ref_size_residual_label: np.ndarray  # [3]
    unique_multiple: int
    scan_idx: int


def random_sampling(points: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` rows, with replacement only where there are fewer."""
    return points[rng.choice(points.shape[0], n, replace=points.shape[0] < n)]


def box_points(rng: np.random.Generator, scene_extent: float, n: int) -> np.ndarray:
    """An instance's ``n`` points: uniform in a box of sides 0.2-0.9 m,
    centred in the room 0.2-1.5 m above the floor."""
    center = rng.uniform(0.5, scene_extent - 0.5, size=3)
    center[2] = rng.uniform(0.2, 1.5)
    size = rng.uniform(0.2, 0.9, size=3)
    return center + rng.uniform(-0.5, 0.5, size=(n, 3)) * size


def make_scene(rng: np.random.Generator, lang_len: int, *, num_points: int,
               num_instances: int, num_candidates: int, points_per_instance: int,
               scene_extent: float, multiview: bool = False, scan_idx: int = 0,
               max_candidates: int = 0) -> Scene:
    """One scene and one description of ``lang_len`` tokens (at most
    ``max_candidates`` instances of the described class where it is not 0)."""
    target_class = int(rng.integers(0, NUM_CLASSES))
    bg = rng.uniform([0, 0, 0], [scene_extent, scene_extent, 0.1], size=(num_points, 3))
    clouds, inst_points, inst_class, inst_obbs = [bg], [], [], []
    for i in range(num_instances):
        cls = target_class if i < num_candidates else int(rng.integers(0, NUM_CLASSES))
        if cls == target_class and i >= num_candidates and max_candidates \
                and inst_class.count(target_class) >= max_candidates:
            cls = (target_class + 1 + int(rng.integers(0, NUM_CLASSES - 1))) % NUM_CLASSES
        pts = box_points(rng, scene_extent, points_per_instance)
        feats = np.concatenate([pts, rng.uniform(-0.5, 0.5, size=(points_per_instance, 3))], 1)
        clouds.append(pts)
        mn, mx = pts.min(0), pts.max(0)  # the box from the points' extent
        inst_obbs.append(np.concatenate([(mn + mx) / 2, mx - mn, [0.0]]).astype(np.float32))
        inst_class.append(cls)
        full = np.concatenate([feats, np.zeros((points_per_instance, 1))], 1).astype(np.float32)
        inst_points.append(random_sampling(full, 1024, rng))
    xyz = np.concatenate(clouds, 0)
    pc = np.concatenate([xyz, rng.uniform(-0.5, 0.5, size=(len(xyz), 3))], 1)
    # height: z over the floor, the 0.99th percentile of z (the reference's
    # quirk: it passes 0.99 to ``np.percentile``)
    floor = np.percentile(pc[:, 2], 0.99)
    point_cloud = np.concatenate([pc, pc[:, 2:3] - floor], 1).astype(np.float32)
    for ip in inst_points:
        ip[:, 6] = ip[:, 2] - floor
    if multiview:
        palette = np.maximum(rng.standard_normal((MULTIVIEW_PALETTE, MULTIVIEW_DIM),
                                                 dtype=np.float32), 0.0)
        point_cloud = _with_multiview(point_cloud, palette, rng)
        inst_points = [_with_multiview(ip, palette, rng) for ip in inst_points]
    gt = inst_obbs[0]
    return Scene(
        lang_feat=rng.standard_normal((lang_len, WORD_DIM), dtype=np.float32),
        lang_len=lang_len, object_cat=target_class, point_cloud=point_cloud,
        instance_points=inst_points, instance_class=inst_class, instance_obbs=inst_obbs,
        ref_center_label=gt[:3].copy(), ref_size_class_label=target_class,
        ref_size_residual_label=(gt[3:6] - MEAN_SIZE[target_class]).astype(np.float32),
        unique_multiple=int(num_candidates > 1), scan_idx=scan_idx)


def _with_multiview(points: np.ndarray, palette: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
    """xyz, rgb, a palette row per point, height."""
    rows = palette[rng.integers(0, len(palette), size=len(points))]
    return np.concatenate([points[:, :6], rows, points[:, 6:]], 1)


def description_lengths(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """``n`` description lengths: the quantiles (i + 0.5) / n of a
    log-normal of this median and log-sigma, rounded and clipped to
    [lo, hi], longest first.  The same for every seed."""
    dist = statistics.NormalDist()
    z = np.array([dist.inv_cdf((i + 0.5) / n) for i in range(n)])
    lengths = np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(int)
    return lengths[::-1].copy()


def pool_lengths(batches: int, batch: int, lang_len: Dict[str, float],
                 rng: np.random.Generator) -> List[np.ndarray]:
    """Each batch's description lengths: ``description_lengths`` dealt in
    turn to the batches (batch j takes the j-th, (j + batches)-th, ...
    longest), so every seed gives the same batches' longest descriptions
    and the same language grids; the seed orders the batches and the
    descriptions within each."""
    lengths = description_lengths(batches * batch, lang_len["median"], lang_len["sigma"],
                                  int(lang_len["min"]), int(lang_len["max"]))
    dealt = [lengths[j::batches] for j in range(batches)]
    return [rng.permutation(dealt[j]) for j in rng.permutation(batches)]


def make_pool(seed: int, traffic: dict, multiview: bool) -> List[List[Scene]]:
    """``traffic["pool_batches"]`` batches of ``traffic["batch"]`` scenes
    from ``seed`` (any integer that numpy's seeding takes)."""
    rng = np.random.default_rng(seed)
    b = int(traffic["batch"])
    return [[make_scene(rng, int(n), multiview=multiview, scan_idx=j * b + i, **traffic["scene"])
             for i, n in enumerate(lengths)]
            for j, lengths in enumerate(pool_lengths(int(traffic["pool_batches"]), b,
                                                     traffic["lang_len"], rng))]

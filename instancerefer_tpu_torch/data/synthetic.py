"""Synthetic ScanRefer-like scenes for tests and the card's smoke run.

The port's copy of ``instancerefer_tpu/data/synthetic.py``: random rooms with
box-shaped instances, drawn from the same numpy generator calls, through the
port's host pipeline (quantize -> pyramids -> padded collation).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from instancerefer_tpu_torch.data.pipeline import (
    BatchSpec,
    CoreSample,
    collate,
    compute_height_feature,
    pad_sample,
    random_sampling,
)

TEST_SPEC = BatchSpec(
    max_tokens=24,
    max_instances=16,
    max_candidates=4,
    scene_caps=(512, 256, 128, 64, 32),
    inst_caps=(512, 256, 128, 64, 32),
)


def make_core_sample(
    rng: np.random.Generator,
    *,
    num_points: int = 2000,
    num_instances: int = 6,
    points_per_instance: int = 256,
    target_class: int | None = None,
    num_candidates: int = 3,
    scene_extent: float = 4.0,
    scan_idx: int = 0,
    mean_size_arr: np.ndarray | None = None,
    target_rule: str = "first",
) -> CoreSample:
    """``target_rule``: 'first' (arbitrary target — chance-level task) or
    'largest' (the referred object is always the biggest same-class instance —
    a signal the attribute encoder can learn, used by convergence checks)."""
    target_class = int(rng.integers(0, 18)) if target_class is None else target_class

    # room background
    bg = rng.uniform([0, 0, 0], [scene_extent, scene_extent, 0.1], size=(num_points, 3))
    clouds = [bg]
    inst_points: List[np.ndarray] = []
    inst_class: List[int] = []
    inst_obbs: List[np.ndarray] = []

    for i in range(num_instances):
        cls = target_class if i < num_candidates else int(rng.integers(0, 18))
        center = rng.uniform(0.5, scene_extent - 0.5, size=3)
        center[2] = rng.uniform(0.2, 1.5)
        if target_rule == "largest" and i < num_candidates:
            # candidate 0 is clearly the largest; the rest are small
            size = (
                rng.uniform(0.8, 1.0, size=3) if i == 0 else rng.uniform(0.2, 0.35, size=3)
            )
        else:
            size = rng.uniform(0.2, 0.9, size=3)
        pts = center + (rng.uniform(-0.5, 0.5, size=(points_per_instance, 3))) * size
        feats = np.concatenate(
            [pts, rng.uniform(-0.5, 0.5, size=(points_per_instance, 3))], axis=1
        )
        clouds.append(pts)
        # obb from point min/max as the reference does (lib/dataset.py:219-222)
        mn, mx = pts.min(0), pts.max(0)
        obb = np.concatenate([(mn + mx) / 2, mx - mn, [0.0]]).astype(np.float32)
        inst_obbs.append(obb)
        inst_class.append(cls)
        full = np.concatenate([feats, np.zeros((points_per_instance, 1))], axis=1)
        sampled, _ = random_sampling(full.astype(np.float32), 1024, rng)
        inst_points.append(sampled)

    xyz = np.concatenate(clouds, axis=0)
    rgb = rng.uniform(-0.5, 0.5, size=(len(xyz), 3))
    pc = np.concatenate([xyz, rgb], axis=1)
    height = compute_height_feature(pc)
    point_cloud = np.concatenate([pc, height[:, None]], axis=1).astype(np.float32)

    # height channel for instance points too
    for i, ip in enumerate(inst_points):
        ip[:, 6] = ip[:, 2] - np.percentile(point_cloud[:, 2], 0.99)

    # language: random GloVe-like embeddings
    lang_len = int(rng.integers(3, 20))
    lang_feat = rng.normal(size=(lang_len, 300)).astype(np.float32)

    # referred object = first candidate instance; encode its size against the
    # mean-size codec so param2obb reconstructs the true GT box
    gt = inst_obbs[0]
    if mean_size_arr is not None:
        size_residual = gt[3:6] - mean_size_arr[target_class]
    else:
        size_residual = np.zeros(3, np.float32)
    return CoreSample(
        lang_feat=lang_feat,
        lang_len=lang_len,
        object_cat=target_class,
        point_cloud=point_cloud,
        instance_points=inst_points,
        instance_class=inst_class,
        instance_obbs=inst_obbs,
        ref_center_label=gt[:3],
        ref_size_class_label=target_class,
        ref_size_residual_label=size_residual.astype(np.float32),
        unique_multiple=int(num_candidates > 1),
        object_id=0,
        ann_id=0,
        scan_idx=scan_idx,
    )


def make_batch(
    batch_size: int,
    spec: BatchSpec = TEST_SPEC,
    seed: int = 0,
    *,
    num_points: int = 2000,
    num_instances: int = 6,
    num_candidates: int = 3,
    mean_size_arr: np.ndarray | None = None,
    target_rule: str = "first",
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    samples = []
    for b in range(batch_size):
        core = make_core_sample(
            rng,
            num_points=num_points,
            num_instances=num_instances,
            num_candidates=num_candidates,
            scan_idx=b,
            mean_size_arr=mean_size_arr,
            target_rule=target_rule,
        )
        samples.append(pad_sample(core, spec))
    return collate(samples, spec)


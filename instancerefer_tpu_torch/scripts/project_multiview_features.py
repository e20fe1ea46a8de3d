"""Project per-frame ENet features onto scene points -> one HDF5 database.

Counterpart of the JAX package's ``scripts/project_multiview_features.py``
(the reference's C20): for every scene, its frames' 32 x 41 depth maps and
camera poses give 3D <-> 2D correspondences (frustum culling and the
occlusion test, ``data/projection.py``); the 128-channel features are
back-projected onto the points and fused across frames (``--maxpool``, else
the first covering frame), and ``--out`` gets one [N, 128] float32 dataset
per scene.

    python -m instancerefer_tpu_torch.scripts.project_multiview_features --maxpool \\
        --scannet_data data/scannet/pointgroup_data \\
        --frames data/scanrefer/frames_square \\
        --features data/scanrefer/enet_features \\
        --out data/enet_feats_maxpool.hdf5 [--device cpu]

The projection and fusion run on the card unless ``--device cpu`` is
given; ``h5py`` and ``imageio`` are imported only where a file is written
or read.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from instancerefer_tpu_torch.data.projection import FrameFeatureFuser, ProjectionHelper
from instancerefer_tpu_torch.scripts.compute_multiview_features import (
    resize_crop_image, scene_list, torch_device,
)

# 41 x 32 feature-resolution intrinsics (the reference's :28-29)
INTRINSICS = [[37.01983, 0, 20, 0], [0, 38.52470, 15.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
DEPTH_DIMS = (41, 32)  # (W, H)


def projector(device) -> ProjectionHelper:
    return ProjectionHelper(np.array(INTRINSICS)[:3, :3], 0.1, 4.0, DEPTH_DIMS, 0.05, device)


def load_pose(filename: str) -> np.ndarray:
    lines = open(filename).read().splitlines()
    if len(lines) != 4:
        raise ValueError(f"{filename}: a pose has 4 lines, not {len(lines)}")
    return np.array([[float(v) for v in line.split()] for line in lines], np.float32)


def load_depth(path: str, image_dims=DEPTH_DIMS) -> np.ndarray:
    """[H, W] float32 meters from a 16-bit millimetre PNG."""
    from imageio.v2 import imread

    return resize_crop_image(imread(path), image_dims).astype(np.float32) / 1000.0


def scene_points(scannet_data: str, scene_id: str, device) -> Optional[torch.Tensor]:
    """The scene's original (unaligned) vertices [N, 3], the frame the
    cameras live in; None without a vertex file."""
    path = os.path.join(scannet_data, scene_id + "_vert.npy")
    if not os.path.exists(path):
        return None
    return torch.from_numpy(np.ascontiguousarray(np.load(path)[:, :3])).to(device)


def frame_ids(frames: str, scene_id: str) -> List[str]:
    return [f.split(".")[0] for f in sorted(os.listdir(os.path.join(frames, scene_id, "color")))]


def frame_projection(proj: ProjectionHelper, frames: str, scene_id: str, frame_id: str, points):
    """The frame's (indices_3d, indices_2d), or None."""
    base = os.path.join(frames, scene_id)
    depth = load_depth(os.path.join(base, "depth", frame_id + ".png"))
    pose = load_pose(os.path.join(base, "pose", frame_id + ".txt"))
    return proj.compute_projection(points, depth, pose)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="multiview feature projection (PyTorch)")
    parser.add_argument("--maxpool", action="store_true",
                        help="max-pool overlapping points (else first-hit)")
    parser.add_argument("--scannet_data", type=str, default="data/scannet/pointgroup_data")
    parser.add_argument("--frames", type=str, default="data/scanrefer/frames_square")
    parser.add_argument("--features", type=str, default="data/scanrefer/enet_features")
    parser.add_argument("--out", type=str, default="data/enet_feats_maxpool.hdf5")
    parser.add_argument("--scene_list", type=str, default="")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    device = torch_device(args.device)
    import h5py

    proj = projector(device)
    with h5py.File(args.out, "w", libver="latest") as database:
        print("projecting multiview features to point cloud...")
        for scene_id in scene_list(args.frames, args.scene_list):
            points = scene_points(args.scannet_data, scene_id, device)
            if points is None:
                print(f"skipping {scene_id}: no vertex file")
                continue
            ids = frame_ids(args.frames, scene_id)
            print(f"processing {scene_id} ({len(ids)} frames)...")
            fuser = FrameFeatureFuser(len(points), 128, "maxpool" if args.maxpool else "first",
                                      device)
            for frame_id in ids:
                indices = frame_projection(proj, args.frames, scene_id, frame_id, points)
                if indices is None:
                    continue
                feat = torch.from_numpy(np.load(
                    os.path.join(args.features, scene_id, frame_id + ".npy"))).to(device)
                fuser.add(proj.project(feat, *indices, len(points)).T)
            database.create_dataset(scene_id, data=fuser.result().cpu().numpy())
    print("done!")


if __name__ == "__main__":
    main()

"""Project ENet label maps onto scene points by majority vote, as a PLY.

Counterpart of the JAX package's ``scripts/project_multiview_labels.py``
(the reference's C21, a debugging aid): the full ENet (features and
classifier) labels each frame's pixels with an nyu40 class at the 32 x 41
feature resolution; the labels are back-projected onto the scene's points
(``data/projection.py``), fused by majority vote (``--maxpool``, else the
first covering frame), and each scene is written as a label-colored PLY.

    python -m instancerefer_tpu_torch.scripts.project_multiview_labels --maxpool \\
        --scannet_data data/scannet/pointgroup_data \\
        --frames data/scanrefer/frames_square --out outputs/projections \\
        [--weights scannetv2_enet.pth] [--device cpu]

On the card unless ``--device cpu`` is given; ``imageio`` is imported only
where a frame is read.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from instancerefer_tpu_torch.models.enet import NUM_CLASSES, normalize_frame
from instancerefer_tpu_torch.scripts.compute_multiview_features import (
    FRAME_DIMS, load_image, load_model, scene_list, torch_device,
)
from instancerefer_tpu_torch.scripts.project_multiview_features import (
    DEPTH_DIMS, frame_ids, frame_projection, projector, scene_points,
)
from instancerefer_tpu_torch.utils.pc_utils import write_ply_rgb

# NYU40 color palette (standard ScanNet visualization colors)
NYU40_COLORS = np.array(
    [
        (0, 0, 0), (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
        (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40), (197, 176, 213),
        (148, 103, 189), (196, 156, 148), (23, 190, 207), (178, 76, 76), (247, 182, 210),
        (66, 188, 102), (219, 219, 141), (140, 57, 197), (202, 185, 52), (51, 176, 203),
        (200, 54, 131), (92, 193, 61), (78, 71, 183), (172, 114, 82), (255, 127, 14),
        (91, 163, 138), (153, 98, 156), (140, 153, 101), (158, 218, 229), (100, 125, 154),
        (178, 127, 135), (120, 185, 128), (146, 111, 194), (44, 160, 44), (112, 128, 144),
        (96, 207, 209), (227, 119, 194), (213, 92, 176), (94, 106, 211), (82, 84, 163),
        (100, 85, 144),
    ],
    dtype=np.uint8,
)


def frame_labels(model, image: np.ndarray, device) -> torch.Tensor:
    """[H, W, 3] frame in [0, 1] -> [32, 41] int64 nyu40 labels: the argmax
    of the logits resized to the depth maps' 32 x 41 as the JAX script's
    ``jax.image.resize(..., "linear")`` does (the identity at 256 x 328
    frames; antialiased when it shrinks)."""
    x = normalize_frame(torch.from_numpy(image).to(device)).permute(2, 0, 1)[None].contiguous()
    with torch.no_grad():
        logits = model(x)[0]
    size = (DEPTH_DIMS[1], DEPTH_DIMS[0])
    if tuple(logits.shape[2:]) != size:
        logits = F.interpolate(logits, size=size, mode="bilinear", align_corners=False,
                               antialias=True)
    return logits[0].argmax(0)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="multiview label projection (PyTorch)")
    parser.add_argument("--maxpool", action="store_true",
                        help="majority vote across frames (else first-hit)")
    parser.add_argument("--scannet_data", type=str, default="data/scannet/pointgroup_data")
    parser.add_argument("--frames", type=str, default="data/scanrefer/frames_square")
    parser.add_argument("--out", type=str, default="outputs/projections")
    parser.add_argument("--weights", type=str, default="", help="the reference ENet .pth")
    parser.add_argument("--scene_list", type=str, default="")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    device = torch_device(args.device)
    model = load_model(args.weights, device)
    proj = projector(device)
    os.makedirs(args.out, exist_ok=True)
    for scene_id in scene_list(args.frames, args.scene_list):
        points = scene_points(args.scannet_data, scene_id, device)
        if points is None:
            continue
        ids = frame_ids(args.frames, scene_id)
        print(f"processing {scene_id} ({len(ids)} frames)...")
        n_points = len(points)
        votes = torch.zeros(n_points, NUM_CLASSES, dtype=torch.int32, device=device)
        first = torch.zeros(n_points, dtype=torch.long, device=device)
        for frame_id in ids:
            indices = frame_projection(proj, args.frames, scene_id, frame_id, points)
            if indices is None:
                continue
            image = load_image(os.path.join(args.frames, scene_id, "color", frame_id + ".jpg"),
                               FRAME_DIMS)
            lab = proj.project(frame_labels(model, image, device), *indices, n_points)[0]
            covered = torch.zeros(n_points, dtype=torch.bool, device=device)
            covered[indices[0][1:1 + int(indices[0][0])]] = True
            rows = torch.nonzero(covered)[:, 0]
            votes[rows, lab[rows]] += 1
            newly = covered & (first == 0)
            first[newly] = lab[newly]
        final = (votes.argmax(1) if args.maxpool else first).cpu().numpy()
        out_path = os.path.join(args.out, f"{scene_id}.ply")
        write_ply_rgb(points.cpu().numpy(), NYU40_COLORS[np.clip(final, 0, 40)], out_path)
        print(f"  wrote {out_path}")
    print("done!")


if __name__ == "__main__":
    main()

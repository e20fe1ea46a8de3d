"""ENet over ScanNet frames -> one [128, 32, 41] feature array per frame.

Counterpart of the JAX package's ``scripts/compute_multiview_features.py``
(the reference's C19): loads each scene's color frames, resized to 256 x
328, runs the ENet feature pass (``models/enet.Enet.features``) in batches
and writes ``{out}/{scene_id}/{frame_id}.npy``.

    python -m instancerefer_tpu_torch.scripts.compute_multiview_features \\
        --frames data/scanrefer/frames_square --out data/scanrefer/enet_features \\
        [--weights scannetv2_enet.pth] [--device cpu]

``--weights`` is the reference's ENet state_dict, loaded strictly
(``utils/convert.load_enet``); without it the network keeps its random
initialisation (seed 0), which serves for plumbing, not for real features.
The pass runs in float32 with TF32 off, as the reference computes it, on
the card unless ``--device cpu`` is given.  ``imageio`` is imported only
where a frame is read.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

FRAME_DIMS = (328, 256)  # (W, H) of the frames ENet reads


def torch_device(name: str) -> torch.device:
    """``cuda`` (the default of the multiview scripts; it needs a card, and
    TF32 is turned off there: the scripts compute in float32) or ``cpu``."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def resize_crop_image(image: np.ndarray, new_dims) -> np.ndarray:
    """Nearest resize to the new height, then a center crop to the new
    width (the reference's :41-50)."""
    h, w = image.shape[:2]
    new_w, new_h = new_dims
    if (w, h) == (new_w, new_h):
        return image
    resize_w = int(np.floor(new_h * float(w) / float(h)))
    ys = (np.arange(new_h) * (h / new_h)).astype(int).clip(0, h - 1)
    xs = (np.arange(resize_w) * (w / resize_w)).astype(int).clip(0, w - 1)
    image = image[ys][:, xs]
    x0 = max((resize_w - new_w) // 2, 0)
    return image[:, x0:x0 + new_w]


def load_image(path: str, image_dims) -> np.ndarray:
    """[H, W, 3] float32 in [0, 1]."""
    from imageio.v2 import imread

    return resize_crop_image(imread(path), image_dims).astype(np.float32) / 255.0


def load_model(weights: str, device: torch.device):
    from instancerefer_tpu_torch.models.enet import Enet
    from instancerefer_tpu_torch.utils.convert import load_enet

    if weights:
        model = load_enet(weights)
    else:
        torch.manual_seed(0)
        model = Enet()
    return model.eval().to(device)


def frame_features(model, images: np.ndarray, device: torch.device) -> np.ndarray:
    """[B, H, W, 3] frames in [0, 1] -> [B, 128, H/8, W/8] float32."""
    from instancerefer_tpu_torch.models.enet import normalize_frame

    x = normalize_frame(torch.from_numpy(images).to(device)).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        return model.features(x).cpu().numpy()


def scene_list(frames: str, listing: str) -> List[str]:
    if listing:
        return sorted(set(open(listing).read().splitlines()))
    return sorted(os.listdir(frames))


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="ENet multiview features (PyTorch)")
    parser.add_argument("--frames", type=str, default="data/scanrefer/frames_square")
    parser.add_argument("--out", type=str, default="data/scanrefer/enet_features")
    parser.add_argument("--weights", type=str, default="", help="the reference ENet .pth")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--scene_list", type=str, default="")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    device = torch_device(args.device)
    model = load_model(args.weights, device)
    for scene_id in scene_list(args.frames, args.scene_list):
        color_dir = os.path.join(args.frames, scene_id, "color")
        if not os.path.isdir(color_dir):
            continue
        frames = sorted(os.listdir(color_dir), key=lambda f: int(f.split(".")[0]))
        out_dir = os.path.join(args.out, scene_id)
        os.makedirs(out_dir, exist_ok=True)
        print(f"{scene_id}: {len(frames)} frames")
        for i in range(0, len(frames), args.batch):
            chunk = frames[i:i + args.batch]
            images = np.stack([load_image(os.path.join(color_dir, f), FRAME_DIMS) for f in chunk])
            for f, feat in zip(chunk, frame_features(model, images, device)):
                np.save(os.path.join(out_dir, f"{f.split('.')[0]}.npy"), feat)
    print("done!")


if __name__ == "__main__":
    main()

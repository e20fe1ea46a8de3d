"""Dump prepared scene npys to OBJ for manual inspection, the port's
counterpart of the JAX package's ``scripts/visualize.py`` (reference
``data/scannet/visualize.py``): writes ``{scene_id}_vert.obj`` /
``{scene_id}_aligned_vert.obj`` with vertex colors, plus optionally the
instance boxes as an OBJ mesh, the same bytes as the JAX script.

    python -m instancerefer_tpu_torch.scripts.visualize --scene scene0000_00 \\
        --data data/scannet/pointgroup_data --out outputs/viz [--boxes]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from instancerefer_tpu_torch.utils.pc_utils import write_bbox, write_obj


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Returns the paths written."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene", type=str, required=True)
    parser.add_argument("--data", type=str, default="data/scannet/pointgroup_data")
    parser.add_argument("--out", type=str, default="outputs/viz")
    parser.add_argument("--boxes", action="store_true", help="also dump instance boxes")
    args = parser.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    written = []
    for suffix in ("vert", "aligned_vert"):
        path = os.path.join(args.data, f"{args.scene}_{suffix}.npy")
        if not os.path.exists(path):
            print(f"missing {path}")
            continue
        verts = np.load(path)
        out = os.path.join(args.out, f"{args.scene}_{suffix}.obj")
        write_obj(verts[:, :3], None, out, colors=verts[:, 3:6] / 255.0)
        print(f"wrote {out}")
        written.append(out)

    if args.boxes:
        path = os.path.join(args.data, f"{args.scene}_aligned_bbox.npy")
        if os.path.exists(path):
            boxes = np.load(path)
            obbs = np.concatenate(
                [boxes[:, :6], np.zeros((len(boxes), 1))], axis=1
            )
            out = os.path.join(args.out, f"{args.scene}_bbox.obj")
            write_bbox(obbs, out)
            print(f"wrote {out}")
            written.append(out)
    return written


if __name__ == "__main__":
    main()

"""ScanNet data preparation CLI, the port's counterpart of the JAX
package's ``scripts/prepare_data.py`` (reference
``data/scannet/prepare_data.py``): every scan of the split's list ->
the per-scene npy files the dataset reads (``data/prepare.py``).

    python -m instancerefer_tpu_torch.scripts.prepare_data --split train \\
        --scannet_path data/scannet/scans/ \\
        --pointgroupinst_path PointGroupInst/ \\
        --output_path data/scannet/pointgroup_data \\
        --meta_path data/scannet/meta_data [--device cpu]

The normals, the alignment and the boxes are computed on the card unless
``--device cpu`` is given; each scan's line gives its ms of parsing, device
work and saving.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from instancerefer_tpu_torch.data.prepare import batch_export


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser("Data Preparation")
    parser.add_argument("--split", type=str, default="train",
                        choices=["train", "val", "test"])
    parser.add_argument("--scannet_path", type=str, default="data/scannet/scans/")
    parser.add_argument("--pointgroupinst_path", type=str, default="PointGroupInst/")
    parser.add_argument("--output_path", type=str, default="data/scannet/pointgroup_data")
    parser.add_argument("--meta_path", type=str, default="data/scannet/meta_data")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    return batch_export(args.split, args.scannet_path, args.pointgroupinst_path,
                        args.output_path, args.meta_path, device=args.device)


if __name__ == "__main__":
    main()

"""ScanNet 18-class dataset configuration.

The port's copy of ``instancerefer_tpu/data/scannet_config.py``, itself a
port of reference ``data/scannet/model_util_scannet.py:85-181``
(``ScannetDatasetConfig``): the 18-class taxonomy, nyu40->class mapping and
mean box sizes.  The class list and nyu40 id set are embedded (they are fixed
constants of the benchmark); the nyu40id->class map and mean sizes are loaded
from user-supplied ScanNet metadata when available (``scannetv2-labels.combined.tsv``
and ``scannet_reference_means.npz``, which ship with ScanNet/ScanRefer), with
deterministic fallbacks so synthetic/test runs need no external files.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np

TYPE2CLASS = {
    "cabinet": 0, "bed": 1, "chair": 2, "sofa": 3, "table": 4, "door": 5,
    "window": 6, "bookshelf": 7, "picture": 8, "counter": 9, "desk": 10,
    "curtain": 11, "refrigerator": 12, "shower curtain": 13, "toilet": 14,
    "sink": 15, "bathtub": 16, "others": 17,
}
# exclude wall (1), floor (2), ceiling (22)
NYU40IDS = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 23,
     24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40]
)

# Fixed nyu40-id -> 18-class map for the ids whose nyu40 label names are
# themselves class names (the canonical mapping the tsv produces); everything
# else maps to "others".  Derived from the NYU40 label list:
#   3 cabinet, 4 bed, 5 chair, 6 sofa, 7 table, 8 door, 9 window, 10 bookshelf,
#   11 picture, 12 counter, 14 desk, 16 curtain, 24 refrigerator,
#   28 shower curtain, 33 toilet, 34 sink, 36 bathtub.
_CANONICAL_NYU40ID2CLASS = {
    3: 0, 4: 1, 5: 2, 6: 3, 7: 4, 8: 5, 9: 6, 10: 7, 11: 8, 12: 9, 14: 10,
    16: 11, 24: 12, 28: 13, 33: 14, 34: 15, 36: 16,
}


class ScannetDatasetConfig:
    def __init__(
        self,
        meta_dir: Optional[str] = None,
        mean_size_path: Optional[str] = None,
    ):
        self.type2class = dict(TYPE2CLASS)
        self.class2type = {v: k for k, v in self.type2class.items()}
        self.nyu40ids = NYU40IDS
        self.num_class = len(self.type2class)
        self.num_heading_bin = 1
        self.num_size_cluster = len(self.type2class)

        tsv = os.path.join(meta_dir, "scannetv2-labels.combined.tsv") if meta_dir else None
        if tsv and os.path.exists(tsv):
            self.nyu40id2class = self._nyu40id2class_from_tsv(tsv)
        else:
            self.nyu40id2class = {
                int(i): _CANONICAL_NYU40ID2CLASS.get(int(i), self.type2class["others"])
                for i in self.nyu40ids
            }

        msp = mean_size_path or (
            os.path.join(meta_dir, "scannet_reference_means.npz") if meta_dir else None
        )
        if msp and os.path.exists(msp):
            self.mean_size_arr = np.load(msp)["arr_0"]
        else:
            # deterministic placeholder sizes for synthetic/test runs
            self.mean_size_arr = np.linspace(0.3, 2.0, self.num_size_cluster)[
                :, None
            ] * np.array([[1.0, 0.9, 0.8]])
        self.type_mean_size = {
            self.class2type[i]: self.mean_size_arr[i] for i in range(self.num_size_cluster)
        }

    def _nyu40id2class_from_tsv(self, tsv_path: str) -> Dict[int, int]:
        """Reads the ScanNet combined-labels tsv the same way the reference does
        (``model_util_scannet.py:104-119``): column 4 = nyu40 id, column 7 =
        nyu40 class name."""
        out: Dict[int, int] = {}
        names = set(self.type2class)
        ids = set(int(i) for i in self.nyu40ids)
        with open(tsv_path, newline="") as f:
            rows = list(csv.reader(f, delimiter="\t"))
        for row in rows[1:]:
            nyu40_id = int(row[4])
            nyu40_name = row[7]
            if nyu40_id in ids:
                out[nyu40_id] = self.type2class.get(
                    nyu40_name if nyu40_name in names else "others",
                    self.type2class["others"],
                )
        return out

    def raw2label_from_tsv(self, tsv_path: str) -> Dict[str, int]:
        """raw category name -> 18-class id (``lib/dataset.py:302-320``)."""
        out: Dict[str, int] = {}
        names = set(self.type2class)
        with open(tsv_path, newline="") as f:
            rows = list(csv.reader(f, delimiter="\t"))
        for row in rows[1:]:
            raw_name, nyu40_name = row[1], row[7]
            out[raw_name] = self.type2class[nyu40_name] if nyu40_name in names \
                else self.type2class["others"]
        return out

    # obb codec (model_util_scannet.py:121-181); ScanNet boxes are axis-aligned
    def class2angle_batch(self, pred_cls, residual, to_label_format=True):
        return np.zeros(np.shape(pred_cls)[0])

    def class2size_batch(self, pred_cls, residual):
        return self.mean_size_arr[pred_cls] + residual

    def param2obb_batch(self, center, heading_class, heading_residual, size_class, size_residual):
        heading = self.class2angle_batch(heading_class, heading_residual)
        size = self.class2size_batch(size_class, size_residual)
        obb = np.zeros((np.shape(heading_class)[0], 7))
        obb[:, 0:3] = center
        obb[:, 3:6] = size
        obb[:, 6] = heading * -1
        return obb

"""Point-cloud file output: the port's own copy of ``write_ply_rgb`` from
``instancerefer_tpu/utils/pc_utils.py``."""

from __future__ import annotations

import numpy as np


def write_ply_rgb(points: np.ndarray, colors: np.ndarray, filename: str) -> None:
    """Colored points [N, 3] and colors [N, 3] (uint8 0-255) as an ascii PLY."""
    points = np.asarray(points)
    colors = np.asarray(colors).astype(np.uint8)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")

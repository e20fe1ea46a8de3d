"""Axis-aligned 3D box math, counterpart of ``instancerefer_tpu/ops/boxes.py``
(ScanNet boxes have heading 0, so IoU is the min/max AABB IoU)."""

from __future__ import annotations

import torch

# corner order of the reference's construct_bbox_corners
_CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
            (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))


def obb_to_minmax(obb):
    """[..., 7] (cx, cy, cz, dx, dy, dz, heading=0) -> (min, max), [..., 3] each."""
    center, half = obb[..., 0:3], obb[..., 3:6] * 0.5
    return center - half, center + half


def box3d_iou_aabb(obb1, obb2, eps: float = 1e-8):
    """Axis-aligned IoU, broadcasting over leading dims; a zero box has IoU 0."""
    mn1, mx1 = obb_to_minmax(obb1)
    mn2, mx2 = obb_to_minmax(obb2)
    inter = (torch.minimum(mx1, mx2) - torch.maximum(mn1, mn2)).clamp(min=0).prod(-1)
    vol1 = (mx1 - mn1).prod(-1)
    vol2 = (mx2 - mn2).prod(-1)
    return inter / (vol1 + vol2 - inter + eps)


def get_3d_box_corners(obb):
    """[..., 7] -> [..., 8, 3] corners."""
    mn, mx = obb_to_minmax(obb)
    lohi = torch.stack([mn, mx], dim=-2)  # [..., 2, 3]
    return torch.stack(
        [torch.stack([lohi[..., ix, 0], lohi[..., iy, 1], lohi[..., iz, 2]], -1)
         for ix, iy, iz in _CORNERS],
        dim=-2,
    )


def param2obb(center, heading_class, heading_residual, size_class, size_residual,
              mean_size_arr):
    """[..., 3] center, size class and residual -> [..., 7] obb (heading 0)."""
    size = mean_size_arr[size_class] + size_residual
    heading = center.new_zeros(center.shape[:-1] + (1,))
    return torch.cat([center, size.to(center.dtype), heading], dim=-1)
